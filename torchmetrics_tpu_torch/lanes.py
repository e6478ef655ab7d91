"""Multi-session lanes: one round advances thousands of independent metric states.

One ``Metric`` instance equals one logical stream, so a service tracking
per-user, per-model or per-slice metrics for N concurrent sessions would pay
N updates a step. This module stacks N independent copies of a metric's
state along a leading **lane axis** and advances every session of a round
at once::

    laned = LanedMetric(MulticlassAccuracy(num_classes=10), capacity=1024)
    laned.update_sessions([("user-7", (logits_a, target_a)),
                           ("user-42", (logits_b, target_b))])
    laned.lane_values()          # {"user-7": ..., "user-42": ...}
    laned.compute()              # all-lane aggregate

Mechanics
    The router packs incoming ``(session_id, batch)`` pairs into rounds (at
    most one batch per session a round), stacks the rows of a round along a
    new leading row axis in a staging slab sized by the power-of-two bucket
    ladder (``ops/ingest.py``), stamps each row with the lane its session was
    admitted to, and uploads the live rows. Inside the round's update::

        gathered = states.index_select(0, lanes)         # (rows, *field)
        new      = inner.functional_update_rows(gathered, *batch)
        states   = states.index_copy(0, lanes, new)      # a new tensor

    Where the JAX package runs ``jax.vmap(inner.functional_update)`` and
    scatters with ``mode="drop"`` (padding rows carry the sentinel lane
    ``== capacity``), the port writes the row axis out: rows whose lane is the
    sentinel (padding, or a row the admission screen diverted) are cut off
    before the update, so the scatter only ever names live lanes, each once.
    The counting family (stat scores, confusion matrices) advances a round
    with ONE row-folded ``bincount`` launch per row chunk
    (``ops/fused_classification.py``), shared by every member of a laned
    collection; every other inner metric runs an exact per-row loop. Updates
    replace state tensors, never write into them, as everywhere in the port,
    so snapshots and compute groups may hold references.

Lifecycle
    ``admit``/``evict``/``reset_session`` manage the session-to-lane
    directory (lowest free lane first, as in the JAX package, so the same
    traffic gives the same directory in both); eviction and reset reinstall
    lane defaults through a masked select; ``evict_idle`` reclaims idle lanes.
    Capacity grows by power-of-two lane buckets.

Reads
    ``lane_values`` computes every lane at once: ``torch.func.vmap`` of the
    inner ``functional_compute`` where the inner metric declares
    ``lane_compute = "vmap"`` (classification's stat scores and confusion
    matrices: plain tensor operations), else a per-lane loop. ``compute``
    folds the active lanes per declared reduction through
    ``parallel.sync.reduction_identity``.

Fault containment
    ``on_lane_fault="quarantine"|"reset"|"evict"|"raise"`` makes the LANE the
    unit of failure (``quarantine.py``): admission screening at the pack, a
    row screen fused into the update (a row whose updated state is not
    finite keeps its lane's old rows and counts in ``lane_health``), lane
    quarantine with degraded reads, a per-session circuit breaker, and a
    round rollback when a dispatch failure is attributed to one session.

Telemetry: ``tm_tpu.lanes.dispatch``, ``tm_tpu.lanes.pack`` and
``tm_tpu.lanes.quarantine`` spans, the ``lanes.*`` counters, gauges and
histograms, and faults in the ``lanes`` flight domain, all named as in the
JAX package.

Metrics whose inner state includes list ("cat") accumulators cannot carry a
lane axis; those run an exact per-lane loop on the host (the eager mode):
every lifecycle and correctness guarantee holds, only the batched round does
not.

Windowed lanes
    ``LanedMetric(WindowedMetric(m))`` (or ``collection.windowed(W).laned(N)``)
    stacks the window axis under the lane axis: state ``(lanes, W, *field)``
    and one ``window_head`` clock per lane. A round gathers only each row's
    open slot, viewing the ring as ``(lanes * W, ...)`` and taking row
    ``lane * W + slot`` (the slot from the lane's device head, or from the
    round's stamped window ``k``), runs the inner metric's own row-batched
    update on those rows (the counting family's one row-folded ``bincount``
    launch) and writes them back out of place. ``update_sessions(window=k)``
    admits each session against its own clock (a host mirror of the heads,
    so admission reads no device state); ``advance_windows`` retires every
    lane's next slot at once, the slots computed on the device from the
    heads; ``advance_lane_windows`` moves one lane's clock (skew).

Deferred lanes
    ``make_deferred_lane_step(laned, mesh=S)`` stacks the lane axis inside
    the shard: state ``(S, lanes, *field)`` (``(S, lanes, W, *field)``
    windowed). The JAX package places the shard axis on a mesh and steps it
    in ``shard_map``; the port has no mesh, so ``mesh`` is the number of
    shards this process stacks (None: one shard a rank) and a dispatch's
    rows split into S equal contiguous slices, one a shard, as ``shard_map``
    splits them over devices. The shard is folded into the lane index (row
    lane ``l`` of shard ``s`` updates flat lane ``s * lanes + l``), so a
    round is still ONE row-batched update, the counting family's one
    row-folded ``bincount`` launch. ``reduce`` folds the shard axis per
    declared reduction (the clock by ``max``) and, in a process group, syncs
    across ranks; ``install_reduced`` hands the per-lane states to the read
    paths. A sharded laned export restores through ``load_state``, which
    folds it.
"""
from __future__ import annotations

import json
import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.metric import Metric, resolve_device
from torchmetrics_tpu_torch.parallel.sync import live_window_mask, reduction_identity
from torchmetrics_tpu_torch.quarantine import (
    DegradedValue,
    LaneGuard,
    LaneStateMirror,
    row_spec_majority,
    screen_row,
)
from torchmetrics_tpu_torch.utils.exceptions import LaneFaultError, StateCorruptionError, TorchMetricsUserError
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_warn
from torchmetrics_tpu_torch.windows import (
    WindowedMetric,
    _blob_bytes,
    _decode_json_blob,
    _encode_json_blob,
    _late_verdict,
    _now_us,
)

__all__ = [
    "DEFAULT_CAPACITY",
    "DegradedValue",
    "DeferredLaneStep",
    "LaneGuard",
    "LaneRound",
    "LaneTable",
    "LanedCollection",
    "LanedMetric",
    "lane_capacity_bucket",
    "make_deferred_lane_step",
]

#: lane-count buckets are powers of two with this floor (the bucket ladder
#: of ``ops/ingest.py``)
LANE_FLOOR = 8

DEFAULT_CAPACITY = 8

def lane_capacity_bucket(n: int) -> int:
    """Smallest power-of-two lane capacity holding ``n`` sessions (floor 8).

    >>> [lane_capacity_bucket(n) for n in (1, 8, 9, 1000, 1024, 1025)]
    [8, 8, 16, 1024, 1024, 2048]
    """
    n = int(n)
    if n <= LANE_FLOOR:
        return LANE_FLOOR
    return 1 << (n - 1).bit_length()


class LaneTable:
    """Host-side session-to-lane directory shared by every laned member.

    Pure bookkeeping, no device state. ``allocate`` hands out the lowest free
    lane, ``release`` returns it, and per-lane ``last_seen`` timestamps drive
    idle reclamation. One table may be shared across the members of a
    :class:`LanedCollection`, so a session occupies the SAME lane index in
    every member's stacked state.
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = int(capacity)
        self.sessions: Dict[Any, int] = {}
        self.lane_session: List[Optional[Any]] = [None] * self.capacity
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))  # pop() -> lowest
        self.last_seen: List[float] = [0.0] * self.capacity
        self.stats: Dict[str, int] = {"admissions": 0, "evictions": 0, "resets": 0, "grows": 0}

    @property
    def active(self) -> int:
        return len(self.sessions)

    @property
    def free(self) -> int:
        return len(self._free)

    def lane_of(self, session_id: Any) -> int:
        try:
            return self.sessions[session_id]
        except KeyError:
            raise KeyError(f"unknown session {session_id!r} (admit it first or route via update_sessions)")

    def allocate(self, session_id: Any) -> int:
        if session_id in self.sessions:
            return self.sessions[session_id]
        if not self._free:
            raise TorchMetricsUserError(
                f"lane table is full ({self.active}/{self.capacity} lanes); grow capacity first"
            )
        lane = self._free.pop()
        self.sessions[session_id] = lane
        self.lane_session[lane] = session_id
        self.last_seen[lane] = time.monotonic()
        self.stats["admissions"] += 1
        return lane

    def release(self, session_id: Any) -> int:
        lane = self.lane_of(session_id)
        del self.sessions[session_id]
        self.lane_session[lane] = None
        self._free.append(lane)
        self.stats["evictions"] += 1
        return lane

    def touch(self, lanes: Iterable[int]) -> None:
        now = time.monotonic()
        for lane in lanes:
            self.last_seen[lane] = now

    def idle_sessions(self, idle_s: float) -> List[Any]:
        cutoff = time.monotonic() - float(idle_s)
        return [sid for sid, lane in self.sessions.items() if self.last_seen[lane] < cutoff]

    def grow(self, new_capacity: int) -> None:
        new_capacity = int(new_capacity)
        if new_capacity <= self.capacity:
            raise ValueError(f"grow target {new_capacity} <= current capacity {self.capacity}")
        self._free = list(range(new_capacity - 1, self.capacity - 1, -1)) + self._free
        self.lane_session.extend([None] * (new_capacity - self.capacity))
        self.last_seen.extend([0.0] * (new_capacity - self.capacity))
        self.capacity = new_capacity
        self.stats["grows"] += 1

    def active_mask(self) -> List[bool]:
        mask = [False] * self.capacity
        for lane in self.sessions.values():
            mask[lane] = True
        return mask

    # --------------------------------------------------------- serialisation
    def to_json(self) -> Dict[str, Any]:
        """JSON-serialisable directory (the JAX package's layout). Non-string
        session ids are tagged so ints and bools restore exactly; other
        hashables restore as their repr string."""
        entries = []
        for sid, lane in sorted(self.sessions.items(), key=lambda kv: kv[1]):
            if isinstance(sid, str):
                entries.append(["s", sid, lane])
            elif isinstance(sid, bool):
                entries.append(["b", int(sid), lane])
            elif isinstance(sid, int):
                entries.append(["i", sid, lane])
            else:
                entries.append(["r", repr(sid), lane])
        return {"directory_version": 1, "capacity": self.capacity, "sessions": entries}

    @classmethod
    def from_json(cls, payload: Dict[str, Any]) -> "LaneTable":
        capacity = int(payload["capacity"])
        table = cls(capacity)
        for kind, sid, lane in payload.get("sessions", []):
            lane = int(lane)
            if not 0 <= lane < capacity:
                raise obs.flighted(StateCorruptionError(
                    f"lane directory maps session {sid!r} to lane {lane}, outside capacity {capacity}"
                ), domain="lanes")
            if table.lane_session[lane] is not None:
                raise obs.flighted(StateCorruptionError(
                    f"lane directory maps two sessions to lane {lane} ({table.lane_session[lane]!r}, {sid!r})"
                ), domain="lanes")
            if kind == "i":
                sid = int(sid)
            elif kind == "b":
                sid = bool(sid)
            table.sessions[sid] = lane
            table.lane_session[lane] = sid
            table._free.remove(lane)
            table.last_seen[lane] = time.monotonic()
        return table


def _encode_directory(table: LaneTable) -> np.ndarray:
    return _encode_json_blob(table.to_json())


def _decode_directory(blob: Any) -> LaneTable:
    try:
        return LaneTable.from_json(json.loads(_blob_bytes(blob).decode("utf-8")))
    except StateCorruptionError:
        raise
    except Exception as err:
        raise obs.flighted(
            StateCorruptionError(f"lane directory blob is unreadable ({type(err).__name__}: {err})"), domain="lanes"
        ) from err


class _ScreenSlowPath(Exception):
    """Internal: a round failed the fast uniform-layout screen assumptions."""


def _is_float(value: Any) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_floating_point()
    return np.issubdtype(np.asarray(value).dtype, np.floating)


def _all_finite(value: Any) -> bool:
    if isinstance(value, torch.Tensor):
        return bool(torch.isfinite(value).all())
    return bool(np.isfinite(value).all())


def _rows_finite(rows: Dict[str, Any]) -> bool:
    """Finite check over one lane's rows (the fault path's validation)."""
    return all(not _is_float(v) or _all_finite(v) for v in rows.values())


def _eager_state_finite(state: Dict[str, Any]) -> bool:
    """Finite scan of one eager-mode lane state (the eager analogue of the
    fused ``lane_health`` scan; it only runs when a fault policy is active)."""
    for v in state.values():
        for leaf in v if isinstance(v, list) else [v]:
            if _is_float(leaf) and not _all_finite(leaf):
                return False
    return True


def _tree_index(value: Any, i: int) -> Any:
    """Element ``i`` of the leading axis of every tensor in a result tree."""
    if isinstance(value, torch.Tensor):
        return value[i]
    if isinstance(value, dict):
        return {k: _tree_index(v, i) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_tree_index(v, i) for v in value)
    return value


def _detached(value: Any) -> Any:
    """A copy of a result tree that shares no storage with it: a last-good
    value must not pin the stacked state (or the batched compute) a view of
    one row would keep alive."""
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, dict):
        return {k: _detached(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_detached(v) for v in value)
    return value


def _divert_screened_rows(
    guard: LaneGuard,
    apply_action: Callable[[Any, str, LaneFaultError], None],
    current: List[Tuple[Any, Tuple[Any, ...]]],
    lanes: List[int],
    reasons: List[Optional[str]],
    sentinel: int,
) -> List[int]:
    """Apply admission-screen verdicts to one packed round: a rejected row's
    lane is swapped for the sentinel (the row is cut off before the update)
    and the fault is logged against its session. Returns the lane list."""
    out = list(lanes)
    for i, reason in enumerate(reasons):
        if reason is None:
            continue
        sid = current[i][0]
        out[i] = sentinel
        action = guard.record_fault(sid, "admission", reason)
        apply_action(
            sid,
            action,
            LaneFaultError(
                f"admission screening rejected a row for session {sid!r}: {reason}",
                session_id=sid,
                where="admission",
            ),
        )
        if action != "evict":
            # counted AFTER any quarantine-time last-good capture, so the
            # diverted offer itself registers as staleness (updates_behind)
            guard.note_diverted(sid)
    return out


class LaneRound:
    """One round's lane ids as the laned update takes them: the host copy
    the router stamped (so the live rows are known without a device read)
    and, when uploaded, the device copy. ``lanes.py`` cuts the sentinel rows
    off here, once a round: every member of a laned collection receives the
    same cut tensors, so their counts share one kernel launch.

    ``numpy.asarray(round)`` gives the host ids (int32)."""

    __slots__ = ("host", "device_ids", "_memo")

    def __init__(self, host: Any, device_ids: Optional[torch.Tensor] = None) -> None:
        self.host = np.asarray(host, dtype=np.int32).reshape(-1)
        self.device_ids = device_ids
        self._memo: Dict[Any, Any] = {}

    @classmethod
    def of(cls, lane_ids: Any) -> "LaneRound":
        """A round from whatever the low-level ``update`` was given: a round,
        a tensor (read back once), a numpy array or a list."""
        if isinstance(lane_ids, LaneRound):
            return lane_ids
        if isinstance(lane_ids, torch.Tensor):
            device_ids = lane_ids if lane_ids.device.type != "cpu" else None
            return cls(lane_ids.detach().cpu().numpy(), device_ids)
        return cls(np.asarray(lane_ids))

    def __array__(self, dtype: Any = None, copy: Any = None) -> np.ndarray:
        return self.host if dtype is None else self.host.astype(dtype)

    def __len__(self) -> int:
        return int(self.host.shape[0])

    def live_positions(self, capacity: int) -> np.ndarray:
        """Row positions whose lane is in ``[0, capacity)``."""
        return np.flatnonzero((self.host >= 0) & (self.host < capacity))

    def live_rows(self, capacity: int, args: Tuple[Any, ...], device: torch.device) -> Tuple[torch.Tensor, Tuple[Any, ...]]:
        """``(lanes, args)`` restricted to the live rows: the int64 lane index
        on ``device`` and each argument's live rows. A live prefix is a view;
        rows diverted in the middle of the round cost one gather. Memoised on
        the identity of ``args``."""
        key = (int(capacity), device) + tuple(id(a) for a in args)
        hit = self._memo.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], args)):
            return hit[1]
        n_rows = len(self)
        for a in args:
            if not isinstance(a, torch.Tensor) or a.ndim < 1 or a.shape[0] != n_rows:
                shape = tuple(a.shape) if isinstance(a, torch.Tensor) else type(a).__name__
                raise ValueError(f"every batch leaf of a laned round carries {n_rows} rows; got {shape}")
        live = self.live_positions(capacity)
        n = int(live.size)
        if n == n_rows or (n and int(live[-1]) == n - 1):  # every row, or a prefix of them
            ids = self.device_ids if self.device_ids is not None else None
            if ids is None:
                lanes = torch.as_tensor(self.host[:n].astype(np.int64)).to(device)
            else:
                lanes = ids[:n].to(torch.int64)
            cut = args if n == n_rows else tuple(a[:n] for a in args)
        else:
            if self.device_ids is None:
                lanes = torch.as_tensor(self.host[live].astype(np.int64)).to(device)
            else:
                pos = torch.as_tensor(live.astype(np.int64)).to(self.device_ids.device)
                lanes = self.device_ids.index_select(0, pos).to(torch.int64)
            pos_dev = torch.as_tensor(live.astype(np.int64)).to(device)
            cut = tuple(a.index_select(0, pos_dev) for a in args)
        result = (lanes, cut)
        self._memo[key] = (tuple(args), result)
        return result


def _pack_rounds(items: Iterable[Tuple[Any, Tuple[Any, ...]]]) -> List[List[Tuple[Any, Tuple[Any, ...]]]]:
    """Split (session_id, batch) pairs into rounds with at most ONE batch per
    session each: a round scatters every row to a distinct lane, so a
    session sending two batches in one call updates sequentially across
    rounds."""
    rounds: List[List[Tuple[Any, Tuple[Any, ...]]]] = []
    seen: List[set] = []
    for sid, batch in items:
        if not isinstance(batch, tuple):
            batch = (batch,)
        for i, used in enumerate(seen):
            if sid not in used:
                rounds[i].append((sid, batch))
                used.add(sid)
                break
        else:
            rounds.append([(sid, batch)])
            seen.append({sid})
    return rounds


def _host_leaf(leaf: Any) -> np.ndarray:
    """One row leaf as a host array (a device tensor is copied back)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _stack_rows(batches: List[Tuple[Any, ...]]) -> Tuple[np.ndarray, ...]:
    """The plain pack: per-session rows stacked into one ``(rows, *row)``
    host array per argument (no padding rows). Rows should arrive as host
    arrays (the service-ingestion shape); device rows pay a copy back."""
    n_leaves = len(batches[0])
    if any(len(b) != n_leaves for b in batches):
        raise ValueError("every session batch in a dispatch must have the same number of leaves")
    out = []
    for leaf_idx in range(n_leaves):
        rows = [_host_leaf(b[leaf_idx]) for b in batches]
        shapes = {r.shape for r in rows}
        if len(shapes) != 1:
            raise ValueError(
                f"per-session batches in one dispatch must share shapes; leaf {leaf_idx}"
                f" has {sorted(shapes)}; send differently-shaped traffic in separate"
                " update_sessions calls"
            )
        out.append(np.stack(rows, axis=0))
    return tuple(out)


def _stack_rows_screened(
    batches: List[Tuple[Any, ...]],
    kind_memo: Optional[Dict[Any, Any]] = None,
) -> Tuple[Optional[Tuple[np.ndarray, ...]], List[Optional[str]]]:
    """:func:`_stack_rows` with admission screening: every row is validated
    (leaf count, per-leaf shape, dtype KIND, finiteness of float leaves) and
    the per-row rejection reason (or None) is returned beside the stacked
    leaves. Rejected rows are replaced by a conforming row so the stack stays
    uniform; the router cuts them off by their sentinel lane. The fast path
    is one ``np.isfinite`` over each stacked float leaf."""
    n = len(batches)
    reasons: List[Optional[str]] = [None] * n
    n_leaves = len(batches[0])
    memo_key = n_leaves
    memo_ref = kind_memo.get(memo_key) if kind_memo is not None else None
    if memo_ref is not None and len(memo_ref) != n_leaves:
        memo_ref = None
    # FAST PATH: every row conforms (the common round)
    if not any(len(b) != n_leaves for b in batches):
        try:
            out = []
            memo_new: List[Any] = []
            for leaf_idx in range(n_leaves):
                rows = [_host_leaf(b[leaf_idx]) for b in batches]
                ref = memo_ref[leaf_idx] if memo_ref is not None else None
                if ref is None or not all(r.dtype == ref for r in rows):
                    kinds = {r.dtype.kind for r in rows}
                    # KIND-level check: exact-width drift (int32 against int64)
                    # is promotion, not corruption; np.stack upcasts
                    if len(kinds) != 1 or rows[0].dtype.kind not in "fiub":
                        raise _ScreenSlowPath()
                memo_new.append(rows[0].dtype)
                stacked = np.stack(rows, axis=0)  # raises on ragged shapes -> slow path
                if stacked.dtype.kind == "f":
                    finite = np.isfinite(stacked.reshape(n, -1)).all(axis=1)
                    if not finite.all():
                        for i in np.flatnonzero(~finite):
                            if reasons[i] is None:
                                reasons[i] = f"leaf {leaf_idx} carries non-finite values"
                out.append(stacked)
            if kind_memo is not None:
                kind_memo[memo_key] = tuple(memo_new)
            return tuple(out), reasons
        except Exception as err:  # any deviant (ragged, mixed, garbage row)
            rank_zero_debug(f"_stack_rows_screened: round fell to the per-row screen ({err!r})")
            reasons = [None] * n
            if kind_memo is not None:
                kind_memo.pop(memo_key, None)
    # SLOW PATH: at least one deviant row. Majority-vote the round's layout so
    # one malformed session cannot redefine it, and screen each row against it
    counts: Dict[int, int] = {}
    for b in batches:
        counts[len(b)] = counts.get(len(b), 0) + 1
    n_leaves = max(counts, key=lambda k: (counts[k], -k))
    arrs: List[Optional[List[np.ndarray]]] = []
    for i, b in enumerate(batches):
        if len(b) != n_leaves:
            reasons[i] = f"row has {len(b)} leaves, round expects {n_leaves}"
            arrs.append(None)
            continue
        try:
            leaves = [_host_leaf(leaf) for leaf in b]
            bad_kind = next((a for a in leaves if a.dtype.kind not in "fiub"), None)
            if bad_kind is not None:
                reasons[i] = f"row carries non-numeric dtype {bad_kind.dtype}"
                arrs.append(None)
            else:
                arrs.append(leaves)
        except Exception as err:
            rank_zero_debug(f"_stack_rows_screened: row {i} not array-like ({type(err).__name__}: {err})")
            reasons[i] = f"row is not array-like ({type(err).__name__})"
            arrs.append(None)
    if all(a is None for a in arrs):
        return None, reasons  # nothing stackable: the router diverts the whole round
    spec = row_spec_majority([a for a in arrs if a is not None], n_leaves=n_leaves)
    candidates = sum(1 for a in arrs if a is not None)
    for i, a in enumerate(arrs):
        if a is None or reasons[i] is not None or spec is None:
            continue
        reason = screen_row(tuple(a), spec, check_finite=False)
        if reason is not None:
            reasons[i] = reason
            arrs[i] = None
    kept_n = sum(1 for i, a in enumerate(arrs) if a is not None and reasons[i] is None)
    if kept_n * 2 <= candidates:
        # no STRICT majority layout: legitimately mixed traffic, not one
        # malformed session; keep the unscreened contract (raise)
        raise ValueError(
            "per-session batches in one dispatch must share shapes/layout; no"
            " majority layout exists; send differently-shaped traffic in"
            " separate update_sessions calls"
        )
    out = []
    for leaf_idx in range(n_leaves):
        rows = [a[leaf_idx] if a is not None else None for a in arrs]
        live = [r for r in rows if r is not None]
        if not live:
            return None, reasons
        template = live[0]
        stacked = np.stack([r if r is not None else template for r in rows], axis=0)
        if stacked.dtype.kind == "f":
            finite = np.isfinite(stacked.reshape(n, -1)).all(axis=1)
            for i in np.flatnonzero(~finite):
                if reasons[i] is None:
                    reasons[i] = f"leaf {leaf_idx} carries non-finite values"
        out.append(stacked)
    return tuple(out), reasons


def _route_rounds(host: Any, items: Union[Dict[Any, Any], Iterable[Tuple[Any, Any]]]) -> int:
    """THE router round loop, shared by :class:`LanedMetric` and
    :class:`LanedCollection` (each provides the small ``_router_*`` adapter
    surface).

    Ingest (``ops/ingest.py``): each round's rows are written in place into a
    reusable staging slab and, for multi-round traffic, round k+1's screen
    and pack run on the ingest worker while round k's upload and update are
    in flight. Screening verdicts are applied and lane ids stamped on THIS
    thread at dispatch time, so guard actions and admissions never race the
    worker. Backpressure (busy ring, full queue, layout deviants, eager lane
    mode) degrades to the inline pack; rounds are consumed strictly in
    order, so a round is never dropped or reordered, and every lane stays
    bit-equal to the plain pack's."""
    from torchmetrics_tpu_torch.ops import ingest

    if isinstance(items, dict):
        items = list(items.items())
    rounds = _pack_rounds(items)
    guard: LaneGuard = host._router_guard()
    device: torch.device = host.device
    staged = ingest.pipeline_enabled() and host._router_pipelinable()
    ring = ingest.get_ring() if staged else None
    pipeline = ingest.get_pipeline() if staged and len(rounds) > 1 else None
    tickets: List[Optional[Any]] = [None] * len(rounds)

    def stage(k: int) -> None:
        # pre-pack round k on the ingest worker under the CURRENT round's
        # upload and update; lane ids and screen verdicts are NOT staged, so
        # the worker only ever touches the round's row data
        if pipeline is None or tickets[k] is not None:
            return
        round_items = rounds[k]
        tickets[k] = ingest.pack_async(
            pipeline,
            ring,
            [b for _, b in round_items],
            len(round_items),
            ingest.bucket_size(len(round_items)),
            screen=bool(guard.active and guard.screen),
        )

    if pipeline is not None:
        stage(1)  # round 0 packs inline; its update hides round 1's pack
    try:
        return _run_rounds(host, rounds, tickets, stage, ring, device)
    except BaseException:
        # a round raised: packs staged for later rounds were never consumed,
        # so their slabs (never uploaded from) go back to the ring
        for ticket in tickets:
            if ticket is None:
                continue
            try:
                packed = ticket.take(timeout=30.0)
            except BaseException as err:  # the staged pack's own failure: nothing to release
                rank_zero_debug(f"lanes: unconsumed staged pack failed ({type(err).__name__}: {err})")
                continue
            if packed is not None and packed.slab.busy:
                ring.release(packed.slab)
        raise


def _run_rounds(
    host: Any,
    rounds: List[List[Tuple[Any, Tuple[Any, ...]]]],
    tickets: List[Optional[Any]],
    stage: Callable[[int], None],
    ring: Any,
    device: torch.device,
) -> int:
    """The body of :func:`_route_rounds`: every round in order, with the
    guard's containment loop."""
    from torchmetrics_tpu_torch.ops import ingest

    table: LaneTable = host._router_table()
    guard: LaneGuard = host._router_guard()
    members: List[Tuple[str, "LanedMetric"]] = host._router_members()
    dispatches = 0
    for k, round_items in enumerate(rounds):
        if guard.active:
            guard.begin_round()
        excluded: set = set()
        first_attempt = True
        while True:
            current = [(sid, b) for sid, b in round_items if sid not in excluded]
            if not current:
                break
            lanes = [host._router_admit(sid) for sid, _ in current]
            rows = len(current)
            bucket = ingest.bucket_size(rows)
            sentinel = host.capacity  # out of range: the row is cut off
            screen = bool(guard.active and guard.screen)
            packed = None
            if first_attempt and tickets[k] is not None:
                # blocks for the worker's HOST pack only (already overlapped
                # with the previous round); pack errors re-raise here, exactly
                # where the inline pack would have raised them
                packed = tickets[k].take()
                tickets[k] = None  # consumed: the slab is this round's now
                if packed is not None:
                    obs.counter_inc("lanes.pipelined_rounds")
            if packed is None and ring is not None:
                packed = ingest.pack_inline(ring, [b for _, b in current], rows, bucket, screen)
                if packed is not None:
                    obs.counter_inc("lanes.inline_packs")
            if packed is not None:
                batch = None  # uploaded from the slab below, after lane stamping
                reasons = packed.reasons
            elif screen:
                with obs.span(obs.SPAN_PACK, histogram="lanes.pack_us", staged=False):
                    batch, reasons = _stack_rows_screened([b for _, b in current], kind_memo=host._router_kind_memo())
            else:
                with obs.span(obs.SPAN_PACK, histogram="lanes.pack_us", staged=False):
                    batch = _stack_rows([b for _, b in current])
                reasons = None
            if screen:
                lanes = _divert_screened_rows(guard, host._apply_fault_action, current, lanes, reasons, sentinel)
            live = [lane for lane in lanes if lane != sentinel]
            if not live:
                if packed is not None:
                    ring.release(packed.slab)
                break  # the whole round was diverted: nothing to dispatch
            if first_attempt and k + 1 < len(rounds):
                stage(k + 1)  # overlap window: upload + update of this round
            baselines: Dict[str, Any] = {}
            for slot, m in members:
                baselines[slot] = m._fetch_round_baseline(live) if guard.active else None
            try:
                with ingest.dispatch_scope(packed.slab if packed is not None else None, ring, device):
                    if packed is not None:
                        ids_dev, batch_dev = ingest.stamp_and_upload(packed, lanes, sentinel, device)
                    else:
                        with obs.span(obs.SPAN_PACK, histogram="lanes.upload_us", phase="upload", rows=rows):
                            ids_dev = ingest.upload(torch.as_tensor(np.asarray(lanes, dtype=np.int32)), device)
                            batch_dev = tuple(ingest.upload(torch.from_numpy(a), device) for a in batch)
                        obs.counter_inc("lanes.h2d_bytes", int(sum(a.nbytes for a in batch) + rows * 4))
                    host._router_dispatch(LaneRound(lanes, ids_dev), batch_dev, rows, bucket)
            except LaneFaultError as err:
                culprit = getattr(err, "session_id", None)
                if not guard.active or culprit is None or culprit not in {s for s, _ in current}:
                    raise
                # lane-granular containment: restore the round's touched lanes
                # to their pre-round rows, fault the attributed session, and
                # re-dispatch the round WITHOUT it; the other lanes sharing the
                # round still get their step
                for slot, m in members:
                    m._rollback_round(live, baselines[slot])
                action = guard.record_fault(culprit, "dispatch", str(err))
                host._apply_fault_action(culprit, action, err)
                if action != "evict":
                    guard.note_diverted(culprit)  # the rolled-back offer is traffic the lane missed
                excluded.add(culprit)
                first_attempt = False  # retries repack inline from `current`
                continue
            table.touch(live)
            obs.counter_inc("lanes.dispatches")
            obs.counter_inc("lanes.rows", len(live))
            dispatches += 1
            break
    return dispatches


def _route_windowed(host: Any, k: int, items: Union[Dict[Any, Any], Iterable[Tuple[Any, Any]]]) -> int:
    """Event-time routing for windowed lanes, shared by :class:`LanedMetric`
    and :class:`LanedCollection`: each session is admitted against its OWN
    lane clock (the host mirror, so no device read), events past the
    watermark are dropped with a breadcrumb, and the kept rows go through
    the ordinary round loop stamped with window ``k``."""
    win = host._windowed_inner()
    pairs = list(items.items()) if isinstance(items, dict) else list(items)
    kept: List[Tuple[Any, Any]] = []
    for sid, batch in pairs:
        lane = host._router_admit(sid)
        clock = int(host._window_clocks()[lane])  # re-read: an admit may have grown the lanes
        if k > clock:
            raise TorchMetricsUserError(
                f"window {k} is ahead of lane clock {clock} for session {sid!r};"
                " advance the window before routing events into it"
            )
        if not _late_verdict(k, clock, win.window, win.lateness, {"session": str(sid)}):
            continue
        if k < clock:
            close_us = host._window_close_us().get(k)
            if close_us is not None:
                obs.histogram_observe("windows.lateness_us", max(0, _now_us() - close_us))
        kept.append((sid, batch))
    if not kept:
        return 0
    host.__dict__["_round_window"] = k
    try:
        return _route_rounds(host, kept)
    finally:
        host.__dict__.pop("_round_window", None)


def _retired_slots(heads: torch.Tensor, window: int) -> torch.Tensor:
    """``(lanes, W)`` one-hot of each lane's slot ``head % W``, on the device."""
    slots = torch.arange(window, device=heads.device)
    return slots.unsqueeze(0) == torch.remainder(heads.to(torch.int64), window).unsqueeze(1)


#: why the captured executor steps aside for a laned metric
LANED_STEP_ASIDE = (
    "laned state: the lane router's rounds choose the launches on the host;"
    " its captured dispatch comes with ROADMAP Queue A item 4c"
)


class LanedMetric(Metric):
    """N independent copies of ``inner``'s state advanced together.

    Args:
        inner: the metric to lane. A detached clone is held; the wrapper only
            ever calls its pure ``functional_update_rows`` and
            ``functional_compute``. The laned metric lives on its device
            (``device=`` naming another raises).
        capacity: initial lane capacity, rounded up the power-of-two lane
            bucket ladder (floor 8).
        max_capacity: hard ceiling for automatic growth (``None``: unbounded).
        table: a shared :class:`LaneTable` (``LanedCollection`` passes one so
            every member agrees on the session-to-lane assignment).
        on_lane_fault: per-session fault policy: ``None`` (default, guard
            off), ``"raise"``, ``"quarantine"``, ``"reset"`` or ``"evict"``.
        breaker_threshold / breaker_window: the per-session circuit breaker:
            K faults within W router rounds escalate quarantine or reset to
            evict.
        unquarantine_after: clean probes that re-admit a quarantined session.
        admission_screen: per-row shape, dtype and finiteness screening in the
            router before the upload (default: on whenever a policy is set).
        guard: a shared :class:`~torchmetrics_tpu_torch.quarantine.LaneGuard`
            (``LanedCollection`` passes one, like ``table``); overrides the
            policy arguments above.
        kwargs: forwarded to :class:`~torchmetrics_tpu_torch.Metric`.
            ``reduce="deferred"`` marks locally accumulated lane states as
            owing their reduction (see :func:`make_deferred_lane_step`).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> from torchmetrics_tpu_torch.lanes import LanedMetric
        >>> laned = LanedMetric(SumMetric(device="cpu"), capacity=8)
        >>> laned.update_sessions([("a", torch.tensor([1.0, 2.0])), ("b", torch.tensor([4.0, 9.0]))])
        1
        >>> {k: float(v) for k, v in sorted(laned.lane_values().items())}
        {'a': 3.0, 'b': 13.0}
        >>> float(laned.compute())  # all-lane aggregate
        16.0
    """

    full_state_update: Optional[bool] = False

    _LANE_DIR_KEY = "_lane_directory"
    _QUARANTINE_KEY = "_lane_quarantine"
    _RESERVED_STATE_KEYS = Metric._RESERVED_STATE_KEYS + (_LANE_DIR_KEY, _QUARANTINE_KEY, "_lanes")

    #: wrapper-owned per-lane bookkeeping states riding next to the inner
    #: fields: committed-update counts and the fused row screen's per-lane
    #: poisoned-update counter
    _LANE_AUX_FIELDS = ("lane_updates", "lane_health")

    def __init__(
        self,
        inner: Metric,
        capacity: int = DEFAULT_CAPACITY,
        max_capacity: Optional[int] = None,
        table: Optional[LaneTable] = None,
        on_lane_fault: Optional[str] = None,
        breaker_threshold: int = 3,
        breaker_window: int = 32,
        unquarantine_after: int = 2,
        admission_screen: Optional[bool] = None,
        guard: Optional[LaneGuard] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(inner, Metric):
            raise ValueError(f"LanedMetric wraps a Metric, got {type(inner).__name__}")
        if isinstance(inner, LanedMetric):
            raise ValueError("LanedMetric cannot wrap another LanedMetric")
        if kwargs.get("reduce") not in (None, "step", "deferred"):
            raise ValueError(f"reduce must be 'step' or 'deferred', got {kwargs['reduce']!r}")
        asked = kwargs.get("device")
        if asked is not None and resolve_device(asked) != inner.device:
            raise ValueError(
                f"LanedMetric: `device={asked}` differs from the inner metric's device {inner.device};"
                " a laned metric lives on its inner metric's device"
            )
        kwargs["device"] = inner.device
        super().__init__(**kwargs)
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        inner = inner.clone()
        self.__dict__["_inner"] = inner
        self.max_capacity = None if max_capacity is None else lane_capacity_bucket(max_capacity)
        capacity = lane_capacity_bucket(capacity)
        if self.max_capacity is not None and capacity > self.max_capacity:
            raise ValueError(f"capacity {capacity} exceeds max_capacity {self.max_capacity}")
        # list ("cat") accumulators cannot stack a lane axis: the exact host
        # per-lane loop (the eager mode)
        self.__dict__["_compiled_lanes"] = not any(isinstance(v, list) for v in inner._defaults.values())
        if isinstance(inner, WindowedMetric) and not inner._compiled_windows:
            # an eager windowed inner declares no tensor state: the lane axis
            # would stack nothing and every session would share one ring
            raise TorchMetricsUserError(
                "LanedMetric needs a compiled ring to stack the lane axis over;"
                f" {type(inner.inner).__name__} fell back to eager per-window state"
                " (list/'cat'/custom reductions)"
            )
        self.__dict__["_table"] = table if table is not None else LaneTable(capacity)
        if table is not None and table.capacity != capacity:
            capacity = table.capacity  # a shared table wins: members must agree
        # lane fault containment: the guard holds policy, breaker, quarantine
        # and last-good bookkeeping; a LanedCollection passes ONE shared guard
        self.__dict__["_guard"] = guard if guard is not None else LaneGuard(
            policy=on_lane_fault,
            breaker_threshold=breaker_threshold,
            breaker_window=breaker_window,
            unquarantine_after=unquarantine_after,
            screen=admission_screen,
        )
        self.__dict__["_guard_slot"] = ""  # collection members get their name
        self.__dict__["_lane_mirror"] = LaneStateMirror()
        self.__dict__["_health_seen"] = np.zeros((capacity,), np.int64)
        if self._compiled_lanes:
            for name, default in inner._defaults.items():
                self.add_state(
                    name,
                    self._stacked_default(default, capacity),
                    dist_reduce_fx=inner._reductions[name],
                    dtype=default.dtype,
                )
            self.add_state("lane_updates", torch.zeros((capacity,), dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("lane_health", torch.zeros((capacity,), dtype=torch.int32), dist_reduce_fx="sum")
        else:
            self.__dict__["_lane_states"] = [inner.init_state() for _ in range(capacity)]
            self.__dict__["_lane_counts"] = [0] * capacity
            self.__dict__["_lane_health_counts"] = [0] * capacity
        obs.gauge_set("lanes.capacity", self.capacity)

    # ------------------------------------------------------------- properties
    @property
    def inner(self) -> Metric:
        """The wrapped (detached) metric."""
        return self.__dict__["_inner"]

    @property
    def capacity(self) -> int:
        return self.__dict__["_table"].capacity

    @property
    def sessions(self) -> Dict[Any, int]:
        """Live session-to-lane assignments (a copy)."""
        return dict(self.__dict__["_table"].sessions)

    @property
    def lane_status(self) -> Dict[str, Any]:
        """Occupancy, lifecycle counters and execution mode (``compiled``:
        stacked lane states; False for the eager per-lane loop)."""
        table: LaneTable = self.__dict__["_table"]
        guard: LaneGuard = self.__dict__["_guard"]
        return {
            "capacity": table.capacity,
            "active": table.active,
            "free": table.free,
            "max_capacity": self.max_capacity,
            "compiled": self._compiled_lanes,
            "policy": guard.policy,
            "quarantined": len(guard.quarantined),
            **table.stats,
            **dict(guard.stats),
        }

    @property
    def guard(self) -> LaneGuard:
        """The lane fault-containment registry."""
        return self.__dict__["_guard"]

    def quarantine_table(self) -> List[Dict[str, Any]]:
        """The per-session fault, quarantine and staleness table."""
        table: LaneTable = self.__dict__["_table"]
        return self.__dict__["_guard"].table(lane_of=dict(table.sessions))

    @staticmethod
    def _stacked_default(default: torch.Tensor, capacity: int) -> torch.Tensor:
        """``default`` repeated along a new lane axis (a broadcast view)."""
        return default.unsqueeze(0).expand((capacity,) + tuple(default.shape))

    def _inner_fields(self) -> List[str]:
        return list(self.inner._defaults)

    def _executor_step_aside(self) -> Optional[str]:
        return LANED_STEP_ASIDE

    # ------------------------------------------------------------ update path
    def update(self, lane_ids: Any, *args: Any, window: Optional[int] = None) -> None:
        """Advance the lanes named by ``lane_ids`` with the row-stacked batch.

        ``lane_ids`` names one lane per row (a :class:`LaneRound`, an int
        tensor or array); every batch leaf carries a matching leading row
        axis. Rows whose lane is out of range (the router's sentinel
        ``== capacity``) never land anywhere. ``window`` (windowed inner
        only) routes every row into that ABSOLUTE window's ring slot instead
        of each lane's open one; :meth:`update_sessions` passes it after the
        watermark admitted the round. Prefer :meth:`update_sessions`, which
        packs, admits and stamps sessions for you.
        """
        rnd = LaneRound.of(lane_ids)
        if self._compiled_lanes:
            self._update_compiled(rnd, args, window)
        else:
            if window is not None:
                raise TorchMetricsUserError("explicit-window routing needs compiled (fixed-shape) lane states")
            self._update_eager(rnd, args)

    def _update_compiled(
        self, rnd: LaneRound, args: Tuple[Any, ...], window: Optional[int] = None, capacity: Optional[int] = None
    ) -> None:
        """The batched round on the states in ``self._state``; ``capacity``
        overrides the lane count (the deferred step's ``shards * lanes``)."""
        inner = self.inner
        lanes, rows_args = rnd.live_rows(self.capacity if capacity is None else int(capacity), args, self._device)
        if lanes.numel() == 0:
            return
        if isinstance(inner, WindowedMetric):
            # only each row's open slot: row lane * W + slot of the ring
            # viewed as (lanes * W, ...), updated by the inner metric's own
            # row-batched update
            w = inner.window
            fields = inner._inner_fields()
            if window is None:
                slots = torch.remainder(self._state["window_head"].index_select(0, lanes).to(torch.int64), w)
            else:
                slots = int(window) % w
            index = lanes * w + slots
            states = {f: self._state[f].flatten(0, 1) for f in fields}
            row_metric = inner.inner
        else:
            if window is not None:
                raise TorchMetricsUserError(
                    f"update(window=...) needs a windowed inner metric, got {type(inner).__name__};"
                    " build with LanedMetric(metric.windowed(W))"
                )
            fields = self._inner_fields()
            index = lanes
            states = {f: self._state[f] for f in fields}
            row_metric = inner
        gathered = {f: v.index_select(0, index) for f, v in states.items()}
        with obs.device_span(obs.SPAN_UPDATE, suffix=type(inner).__name__):
            updated = row_metric.functional_update_rows(gathered, *rows_args)
        # per-lane health scan, fused into the round: a row whose updated
        # state carries NaN/Inf counts in its lane's poisoned-update counter;
        # the host attributes faults by diffing it at the next read point
        row_bad = None
        for f in fields:
            v = updated[f]
            if v.is_floating_point():
                bad = ~torch.isfinite(v).reshape(v.shape[0], -1).all(dim=1)
                row_bad = bad if row_bad is None else (row_bad | bad)
        landed = None
        if row_bad is not None and self.__dict__["_guard"].active:
            # the row screen (guard active): a poisoned row keeps its lane's
            # last clean rows, containment by construction
            keep = ~row_bad
            for f in fields:
                m = keep.reshape((-1,) + (1,) * (updated[f].ndim - 1))
                updated[f] = torch.where(m, updated[f].to(gathered[f].dtype), gathered[f])
            landed = keep.to(torch.int32)
        for f in fields:
            written = states[f].index_copy(0, index, updated[f].to(states[f].dtype))
            self._state[f] = written.view(self._state[f].shape)
        if landed is None:
            landed = torch.ones(lanes.shape, dtype=torch.int32, device=lanes.device)
        # committed counts follow the rows that landed; the health counter
        # follows every live row, so screened rows are attributed
        self._state["lane_updates"] = self._state["lane_updates"].index_add(0, lanes, landed)
        if row_bad is not None:
            self._state["lane_health"] = self._state["lane_health"].index_add(0, lanes, row_bad.to(torch.int32))

    def _update_eager(self, rnd: LaneRound, args: Tuple[Any, ...]) -> None:
        inner = self.inner
        lanes = self.__dict__["_lane_states"]
        counts = self.__dict__["_lane_counts"]
        cap = self.capacity
        # staged then committed: an inner update raising mid-round leaves
        # every lane exactly as it was
        pending: Dict[int, Any] = {}
        for i, lane in enumerate(int(x) for x in rnd.host):
            if not 0 <= lane < cap:
                continue  # the sentinel: the row never lands anywhere
            row = tuple(leaf[i] for leaf in args)
            pending[lane] = inner.functional_update(pending.get(lane, lanes[lane]), *row)
        guard_active = self.__dict__["_guard"].active
        health = self.__dict__["_lane_health_counts"]
        for lane, st in pending.items():
            if guard_active and not _eager_state_finite(st):
                # the eager row screen: the poisoned pending state is never
                # committed, and counts in the lane's health counter
                health[lane] += 1
                continue
            lanes[lane] = st
            counts[lane] += 1

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        raise TorchMetricsUserError(
            "LanedMetric has no single-stream forward; route traffic through"
            " update_sessions((session_id, batch), ...) and read lane_values()/compute()"
        )

    # ----------------------------------------------------------------- router
    def update_sessions(
        self,
        items: Union[Dict[Any, Any], Iterable[Tuple[Any, Any]]],
        window: Optional[int] = None,
    ) -> int:
        """Pack ``(session_id, batch)`` traffic into laned rounds.

        ``items`` is a dict or an iterable of pairs; each batch is a tuple of
        per-session arrays (or a single array), best host numpy arrays.
        Unknown sessions are admitted (growing capacity by power-of-two
        buckets when full), and one update advances every session of a
        round; a session appearing k times spans k rounds. The rows of a
        round share a shape: send differently-shaped traffic in separate
        calls. Returns the number of rounds dispatched.

        ``window`` (windowed inner only) stamps the traffic with an
        event-time window index: each session is admitted against its own
        lane clock, events older than the lateness bound are dropped with a
        ``window_late_drop`` breadcrumb, and admitted late events land in
        their still-open ring slot.

        Guard-active rounds run under the shared read mutex, so an
        asynchronous read's scan-and-attribute step never interleaves with
        the round's guard and state mutations.
        """
        with self._read_mutex():
            if window is None:
                return _route_rounds(self, items)
            return _route_windowed(self, int(window), items)

    # ------------------------------------------------ shared-router adapters
    def _router_table(self) -> LaneTable:
        return self.__dict__["_table"]

    def _router_guard(self) -> LaneGuard:
        return self.__dict__["_guard"]

    def _router_members(self) -> List[Tuple[str, "LanedMetric"]]:
        return [("", self)]

    def _router_admit(self, session_id: Any) -> int:
        return self._admit_for_update(session_id)

    def _router_pipelinable(self) -> bool:
        return self._compiled_lanes

    def _router_kind_memo(self) -> Dict[Any, Any]:
        return self.__dict__.setdefault("_screen_kind_memo", {})

    def _router_dispatch(self, lane_ids: LaneRound, batch: Tuple[Any, ...], rows: int, bucket: int) -> None:
        k = self.__dict__.get("_round_window")
        with obs.span(obs.SPAN_LANES, owner=type(self.inner).__name__, histogram="lanes.dispatch_us", rows=rows, bucket=bucket):
            if k is None:
                self.update(lane_ids, *batch)
            else:
                self.update(lane_ids, *batch, window=k)

    # ----------------------------------------------------------- window rings
    def _windowed_inner(self) -> WindowedMetric:
        inner = self.inner
        if not isinstance(inner, WindowedMetric):
            raise TorchMetricsUserError(
                "window operations need a windowed inner metric;"
                f" got {type(inner).__name__}; build with LanedMetric(metric.windowed(W))"
            )
        return inner

    def _window_clocks(self) -> np.ndarray:
        """Host mirror of the per-lane window clocks, int64 ``(capacity,)``.

        It decides watermark admission only (the device ``window_head`` is
        the clock that sync, checkpoints and reads use); any out-of-band
        mutation drops it and the next use reads the heads back once. So a
        round and an advance on a warm mirror read nothing from the device."""
        clocks = self.__dict__.get("_window_clocks_host")
        if clocks is None:
            self._windowed_inner()
            clocks = self._state["window_head"].cpu().numpy().astype(np.int64)
            self.__dict__["_window_clocks_host"] = clocks
        return clocks

    def advance_windows(self, n: int = 1) -> None:
        """Close the open window on EVERY lane, ``n`` times. Each lane's
        retiring slot comes from its own head, on the device: one masked
        select a field returns those slots to the defaults in a new ring
        (out of place, so its cost grows with W)."""
        win = self._windowed_inner()
        for _ in range(int(n)):
            with obs.span(obs.SPAN_WINDOWS, owner=type(win.inner).__name__, histogram="windows.advance_us", window=win.window, lanes=self.capacity):
                clocks = self._window_clocks()  # materialised BEFORE the device bump
                heads = self._state["window_head"] + 1
                self._retire(_retired_slots(heads, win.window), heads)
                clocks += 1
                self._window_close_stamp(int(clocks.max()) - 1, win)
            obs.counter_inc("windows.advanced")

    def advance_lane_windows(self, lane: int, n: int = 1) -> None:
        """Close the open window on ONE lane ``n`` times (clock skew: a
        session whose stream runs ahead closes its windows early while the
        other lanes stay put)."""
        win = self._windowed_inner()
        lane = int(lane)
        for _ in range(int(n)):
            clocks = self._window_clocks()
            one = torch.arange(self.capacity, device=self._device) == lane
            heads = self._state["window_head"] + one.to(self._state["window_head"].dtype)
            self._retire(_retired_slots(heads, win.window) & one.unsqueeze(1), heads)
            clocks[lane] += 1
            self._window_close_stamp(int(clocks.max()) - 1, win)
            obs.counter_inc("windows.advanced")

    def _follow_advance(self, n: int, lane: Optional[int] = None) -> None:
        """A compute-group follower's advance (every lane, or ``lane``): its
        clock mirror and close stamps move, and its ring, which is its
        leader's, is pointed at the leader's new ring afterwards."""
        win = self._windowed_inner()
        for _ in range(int(n)):
            clocks = self._window_clocks()
            if lane is None:
                clocks += 1
            else:
                clocks[int(lane)] += 1
            self._window_close_stamp(int(clocks.max()) - 1, win)
            obs.counter_inc("windows.advanced")
        self._computed = None
        self.__dict__["_lane_mirror"].invalidate()

    def _retire(self, mask: torch.Tensor, heads: torch.Tensor) -> None:
        """Reset the ring slots ``mask`` names (``(lanes, W)``) to the
        defaults and install the new heads: new tensors, nothing in place."""
        for f in self.inner._inner_fields():
            v = self._state[f]
            self._state[f] = torch.where(mask.reshape(tuple(mask.shape) + (1,) * (v.ndim - 2)), self._defaults[f], v)
        self._state["window_head"] = heads
        self._computed = None
        self.__dict__["_lane_mirror"].invalidate()

    def window_spec(self) -> Dict[str, Any]:
        """The ring for manifests: W, lateness, the fleet's latest clock, the
        open head slot at that clock, and every lane's clock."""
        win = self._windowed_inner()
        clocks = self._window_clocks()
        clock = int(clocks.max())
        return {
            "window": win.window,
            "lateness": win.lateness,
            "clock": clock,
            "head": clock % win.window,
            "compiled": True,
            "lane_clocks": [int(c) for c in clocks],
        }

    def _window_close_us(self) -> Dict[int, int]:
        return self.__dict__.setdefault("_win_close_us", {})

    def _window_close_stamp(self, closed: int, win: WindowedMetric) -> None:
        closes = self._window_close_us()
        closes[closed] = _now_us()
        horizon = closed - int(win.lateness) - 1
        for k in [k for k in closes if k < horizon]:
            closes.pop(k, None)

    # ------------------------------------------------------ fault containment
    def _apply_fault_action(self, sid: Any, action: str, err: LaneFaultError) -> None:
        """Execute a resolved ``on_lane_fault`` action for one session. A
        collection member delegates to its owning LanedCollection, so
        eviction and reset span every member sharing the lane."""
        owner = self.__dict__.get("_fault_owner")
        if owner is not None:
            owner._apply_fault_action(sid, action, err)
            return
        table: LaneTable = self.__dict__["_table"]
        guard: LaneGuard = self.__dict__["_guard"]
        if action == "raise":
            raise err
        if action == "evict":
            if sid in table.sessions:
                self.evict(sid)
            guard.forget(sid)
        elif action == "reset":
            if sid in table.sessions:
                self.reset_session(sid)
        elif action == "quarantine":
            self._quarantine_session(sid)

    def _quarantine_session(self, sid: Any) -> None:
        guard: LaneGuard = self.__dict__["_guard"]
        lane = self.__dict__["_table"].sessions.get(sid)
        if lane is not None:
            self._quarantine_restore_lane(sid, lane)
        guard.quarantine(sid)

    def _quarantine_restore_lane(self, sid: Any, lane: int) -> None:
        """Member-local quarantine hygiene: make sure the quarantined lane
        holds clean rows (the row screen usually guarantees it already), and
        capture a last-good value so degraded reads have one to serve."""
        guard: LaneGuard = self.__dict__["_guard"]
        slot = self.__dict__.get("_guard_slot", "")
        with obs.span(obs.SPAN_QUARANTINE, owner=type(self.inner).__name__, lane=lane):
            committed, health = self._ensure_lane_clean(lane)
            if not guard.has_last_good(sid, slot=slot):
                value = _detached(self._lane_value(lane))
                guard.capture_last_good(sid, value, committed=committed, health=health, slot=slot)

    def _health_seen_of(self, lane: int) -> int:
        seen = self.__dict__.get("_health_seen")
        return int(seen[lane]) if seen is not None and lane < len(seen) else 0

    def _degraded_read(
        self,
        sid: Any,
        lane: int,
        committed_now: Optional[int] = None,
        health_now: Optional[int] = None,
    ) -> DegradedValue:
        guard: LaneGuard = self.__dict__["_guard"]
        slot = self.__dict__.get("_guard_slot", "")
        if committed_now is None:
            committed_now = self._lane_update_count(lane)
        if health_now is None:
            health_now = self._health_seen_of(lane)
        dv = guard.degraded(sid, committed_now, health_now, slot=slot)
        if dv is not None:
            return dv
        # no cached value (a quarantine restored from a checkpoint): serve
        # the current (clean) lane state as last-good
        value = _detached(self._lane_value(lane))
        guard.capture_last_good(sid, value, committed=committed_now, health=health_now, slot=slot)
        dv = guard.degraded(sid, committed_now, health_now, slot=slot)
        if dv is None:
            raise RuntimeError(f"degraded read of session {sid!r} found no last-good value right after capturing one")
        return dv

    def _lane_value(self, lane: int) -> Any:
        """One lane's raw compute value (no health scan, no degraded logic)."""
        inner = self.inner
        if not self._compiled_lanes:
            return inner.functional_compute(self.__dict__["_lane_states"][lane])
        return inner.functional_compute({f: self._state[f][lane] for f in self._inner_fields()})

    def _lane_counts_host(self) -> np.ndarray:
        """Host copy of the per-lane committed-update counters, fetched once
        per guard-active read point."""
        if not self._compiled_lanes:
            return np.asarray(self.__dict__["_lane_counts"], dtype=np.int64)
        return self._state["lane_updates"].cpu().numpy()

    def _lane_update_count(self, lane: int) -> int:
        return int(self._lane_counts_host()[lane])

    def _fetch_round_baseline(self, lanes: Sequence[int]) -> Dict[str, Any]:
        """The touched lanes' pre-round rows, the round's lane-granular
        rollback source. The JAX package fetches those rows to the host every
        guarded round; the port holds the pre-round state tensors by
        reference instead (updates replace state tensors, never write into
        them), so the baseline costs no copy and a rollback gathers the rows
        on the device."""
        if not self._compiled_lanes:
            states = self.__dict__["_lane_states"]
            counts = self.__dict__["_lane_counts"]
            health = self.__dict__["_lane_health_counts"]
            return {
                lane: (
                    {k: (list(v) if isinstance(v, list) else v) for k, v in states[lane].items()},
                    counts[lane],
                    health[lane],
                )
                for lane in lanes
            }
        return {f: self._state[f] for f in self._inner_fields() + list(self._LANE_AUX_FIELDS)}

    def _rollback_round(self, lanes: Sequence[int], baseline: Optional[Dict[str, Any]]) -> None:
        """Restore every lane touched by a failed round to its pre-round rows
        (``baseline`` is the round's :meth:`_fetch_round_baseline`)."""
        if baseline is None:
            return
        if not self._compiled_lanes:
            states = self.__dict__["_lane_states"]
            counts = self.__dict__["_lane_counts"]
            health = self.__dict__["_lane_health_counts"]
            for lane in lanes:
                entry = baseline.get(lane)
                if entry is not None:
                    states[lane] = {k: (list(v) if isinstance(v, list) else v) for k, v in entry[0].items()}
                    counts[lane], health[lane] = entry[1], entry[2]
            self._computed = None
            return
        idx = torch.as_tensor(list(lanes), dtype=torch.int64, device=self._device)
        self._restore_lane_rows(list(lanes), {f: v.index_select(0, idx) for f, v in baseline.items()})

    def _ensure_lane_clean(self, lane: int) -> Tuple[int, int]:
        """Guarantee ``lane`` holds finite rows. The row screen keeps a
        guarded lane clean by construction, so the fast path is a check; when
        poison did land (corruption outside the update), the lane restores
        from the recovery mirror's rows, or a masked reset as the last
        resort. Returns the ``(committed, health)`` counters the lane
        reflects: the staleness anchors of a last-good capture."""
        stash = self.__dict__.get("_pending_capture_health") or {}
        if not self._compiled_lanes:
            if _eager_state_finite(self.__dict__["_lane_states"][lane]):
                anchor = stash.get(lane, self.__dict__["_lane_health_counts"][lane])
                return int(self.__dict__["_lane_counts"][lane]), int(anchor)
            self._reset_lane_indices([lane])
            self.__dict__["_lane_health_counts"][lane] = 0
            return 0, 0
        fields = self._inner_fields() + list(self._LANE_AUX_FIELDS)
        current = {f: self._state[f][lane] for f in fields}
        if _rows_finite(current):
            anchor = stash.get(lane, int(current["lane_health"]))
            return int(current["lane_updates"]), int(anchor)
        rows = self.__dict__["_lane_mirror"].rows([lane])
        if rows is not None:
            row = {f: np.asarray(v)[0] for f, v in rows.items()}
            if _rows_finite(row):
                self._restore_lane_rows([lane], {f: torch.as_tensor(v[None]).to(self._device) for f, v in row.items()})
                self.__dict__["_health_seen"][lane] = int(row["lane_health"])
                return int(row["lane_updates"]), int(row["lane_health"])
        self._reset_lane_indices([lane])
        return 0, 0

    def _restore_lane_rows(self, lanes: Sequence[int], rows: Dict[str, Any]) -> None:
        """Scatter ``rows`` back into the stacked state at ``lanes``; other
        lanes never observe it."""
        idx = torch.as_tensor(list(lanes), dtype=torch.int64, device=self._device)
        for f in self._inner_fields() + list(self._LANE_AUX_FIELDS):
            if f in rows:
                self._state[f] = self._state[f].index_copy(0, idx, rows[f].to(self._state[f].dtype))
        self._computed = None
        self.__dict__["_lane_mirror"].patch_rows(lanes, rows)

    def _read_mutex(self) -> Any:
        """The lock serialising the async read's scan-and-attribute step
        against router and lifecycle mutations, shared across a
        LanedCollection's members the way the guard is. A null context while
        no fault policy is active."""
        guard: LaneGuard = self.__dict__["_guard"]
        if not guard.active:
            return nullcontext()
        from torchmetrics_tpu_torch.ops.async_read import guard_lock

        return guard_lock(guard)

    def _scan_lane_health(self, health_host: Optional[np.ndarray] = None) -> None:
        """Read-point poison attribution: diff the fused ``lane_health``
        counters against the last scan and apply the fault policy to newly
        poisoned lanes. One host read of the counters per read point, none
        per round. ``health_host`` is the async read's pre-fetched copy (a
        stale pre-grow copy skips the scan)."""
        guard: LaneGuard = self.__dict__["_guard"]
        if not guard.active:
            return
        table: LaneTable = self.__dict__["_table"]
        with self._read_mutex():
            if health_host is not None:
                health = health_host
                if health.shape != (self.capacity,):
                    return  # stale pre-grow snapshot: a live read attributes
            elif self._compiled_lanes:
                health = self._state["lane_health"].cpu().numpy()
            else:
                health = np.asarray(self.__dict__["_lane_health_counts"])
            seen = self.__dict__.get("_health_seen")
            if seen is None or np.shape(seen) != health.shape:
                seen = np.zeros_like(health)
            newly = np.flatnonzero(health > seen)
            self.__dict__["_health_seen"] = health.astype(np.int64).copy()
            # anchors for any last-good capture this scan triggers: the
            # PRE-fault health count, so the quarantining poisoned update
            # itself counts as traffic the served value misses
            self.__dict__["_pending_capture_health"] = {int(lane): int(seen[int(lane)]) for lane in newly}
            try:
                for lane in newly:
                    sid = table.lane_session[int(lane)]
                    if sid is None:
                        continue
                    action = guard.record_fault(
                        sid, "device", f"non-finite update in lane {int(lane)} (health={int(health[lane])})"
                    )
                    self._apply_fault_action(
                        sid,
                        action,
                        LaneFaultError(
                            f"lane {int(lane)} (session {sid!r}) produced a non-finite update",
                            session_id=sid,
                            lane=int(lane),
                            where="device",
                        ),
                    )
            finally:
                self.__dict__.pop("_pending_capture_health", None)
            if guard.quarantined:
                # probation: committed updates since the last scan with no new
                # fault are clean probes
                counts = self._lane_counts_host()
                newly_set = {int(lane) for lane in newly}
                for sid in list(guard.quarantined):
                    lane = table.sessions.get(sid)
                    if lane is None:
                        continue
                    guard.probe_progress(sid, int(counts[lane]), faulted=lane in newly_set)

    def _admit_for_update(self, session_id: Any) -> int:
        lane = self.__dict__["_table"].sessions.get(session_id)
        return lane if lane is not None else self.admit(session_id)

    # -------------------------------------------------------------- lifecycle
    def admit(self, session_id: Any) -> int:
        """Allocate a lane to ``session_id`` (growing capacity if needed);
        returns the lane index. Idempotent for known sessions."""
        with self._read_mutex():
            table: LaneTable = self.__dict__["_table"]
            if session_id in table.sessions:
                return table.sessions[session_id]
            if table.free == 0:
                self.grow()
            lane = table.allocate(session_id)
            self._computed = None
            obs.counter_inc("lanes.admissions")
            obs.gauge_set("lanes.occupancy", table.active)
            return lane

    def evict(self, session_id: Any) -> int:
        """Reclaim ``session_id``'s lane: its state returns to the defaults
        and the lane to the free pool."""
        with self._read_mutex():
            table: LaneTable = self.__dict__["_table"]
            lane = table.release(session_id)
            self._reset_lane_indices([lane])
            self.__dict__["_guard"].forget(session_id)
            self._computed = None
            obs.counter_inc("lanes.evictions")
            obs.gauge_set("lanes.occupancy", table.active)
            return lane

    def evict_idle(self, idle_s: float) -> List[Any]:
        """Evict every session idle longer than ``idle_s`` seconds; returns
        the evicted session ids."""
        idle = self.__dict__["_table"].idle_sessions(idle_s)
        for sid in idle:
            self.evict(sid)
        return idle

    def reset_session(self, session_id: Any) -> None:
        """Reset one session's accumulated state to defaults WITHOUT releasing
        its lane."""
        with self._read_mutex():
            table: LaneTable = self.__dict__["_table"]
            self._reset_lane_indices([table.lane_of(session_id)])
            table.stats["resets"] += 1
            self._computed = None
            obs.counter_inc("lanes.resets")

    def _reset_lane_indices(self, lanes: Sequence[int]) -> None:
        self.__dict__["_lane_mirror"].invalidate()  # an out-of-band state mutation
        self.__dict__.pop("_window_clocks_host", None)  # the head resets with the lane
        if not self._compiled_lanes:
            inner = self.inner
            for lane in lanes:
                self.__dict__["_lane_states"][lane] = inner.init_state()
                self.__dict__["_lane_counts"][lane] = 0
                self.__dict__["_lane_health_counts"][lane] = 0
            return
        mask = torch.zeros(self.capacity, dtype=torch.bool)
        mask[list(lanes)] = True
        mask = mask.to(self._device)
        for f in self._inner_fields() + list(self._LANE_AUX_FIELDS):
            v = self._state[f]
            m = mask.reshape((-1,) + (1,) * (v.ndim - 1))
            self._state[f] = torch.where(m, self._defaults[f], v)
        seen = self.__dict__.get("_health_seen")
        if seen is not None:
            for lane in lanes:
                if lane < len(seen):
                    seen[lane] = 0

    def reset(self) -> None:
        """Reset EVERY lane's state to defaults. Session-to-lane assignments
        are kept (a service reset clears accumulators, not its routing)."""
        super().reset()
        self.__dict__["_lane_mirror"].invalidate()
        self.__dict__.pop("_window_clocks_host", None)
        self.__dict__.pop("_win_close_us", None)
        self.__dict__["_health_seen"] = np.zeros((self.capacity,), np.int64)
        if not self._compiled_lanes:
            inner = self.inner
            self.__dict__["_lane_states"] = [inner.init_state() for _ in range(self.capacity)]
            self.__dict__["_lane_counts"] = [0] * self.capacity
            self.__dict__["_lane_health_counts"] = [0] * self.capacity

    # ----------------------------------------------------------------- growth
    def grow(self, new_capacity: Optional[int] = None) -> int:
        """Grow lane capacity to ``new_capacity`` (default: the next
        power-of-two bucket). Existing lanes keep their state bit for bit;
        new lanes hold defaults."""
        with self._read_mutex():
            table: LaneTable = self.__dict__["_table"]
            target = lane_capacity_bucket(table.capacity + 1 if new_capacity is None else new_capacity)
            if target <= table.capacity:
                return table.capacity
            if self.max_capacity is not None and target > self.max_capacity:
                raise TorchMetricsUserError(
                    f"cannot grow lanes to {target}: max_capacity={self.max_capacity}"
                    f" (active sessions: {table.active})"
                )
            self._grow_state(target)
            table.grow(target)
            obs.counter_inc("lanes.grows")
            obs.gauge_set("lanes.capacity", target)
            return target

    def _grow_state(self, target: int) -> None:
        old = self.capacity
        self.__dict__["_lane_mirror"].invalidate()
        self.__dict__.pop("_window_clocks_host", None)
        seen = self.__dict__.get("_health_seen")
        grown_seen = np.zeros((target,), np.int64)
        if seen is not None:
            grown_seen[: min(old, len(seen))] = np.asarray(seen)[: min(old, len(seen))]
        self.__dict__["_health_seen"] = grown_seen
        self._computed = None
        if not self._compiled_lanes:
            inner = self.inner
            self.__dict__["_lane_states"].extend(inner.init_state() for _ in range(target - old))
            self.__dict__["_lane_counts"].extend([0] * (target - old))
            self.__dict__["_lane_health_counts"].extend([0] * (target - old))
            return
        for f, default in self.inner._defaults.items():
            stacked = self._stacked_default(default, target)
            self._defaults[f] = stacked
            self._state[f] = torch.cat([self._state[f], stacked[old:]], dim=0)
        for aux in self._LANE_AUX_FIELDS:
            self._defaults[aux] = torch.zeros((target,), dtype=torch.int32, device=self._device)
            self._state[aux] = torch.cat([self._state[aux], self._defaults[aux][old:]])

    def remap_capacity(self, new_capacity: int) -> int:
        """Rehouse every active session into a table of ``new_capacity``
        lanes. Deterministic: sessions in ascending old-lane order receive new
        lanes in ascending order, so two replicas remapping the same
        directory agree on every assignment. Shrinking below occupancy evicts
        the overflow (the sessions in the HIGHEST old lanes) with a warning
        naming the count. Returns the new (bucketed) capacity."""
        with self._read_mutex():
            target = lane_capacity_bucket(int(new_capacity))
            if self.max_capacity is not None and target > self.max_capacity:
                raise TorchMetricsUserError(f"cannot remap lanes to {target}: max_capacity={self.max_capacity}")
            table: LaneTable = self.__dict__["_table"]
            if target == table.capacity:
                return target
            housed = sorted(table.sessions.items(), key=lambda kv: kv[1])
            evicted = housed[target:]
            housed = housed[:target]
            if evicted:
                obs.counter_inc("lanes.elastic_evictions", len(evicted))
                rank_zero_warn(
                    f"{type(self).__name__}: remapping {table.capacity} -> {target} lanes"
                    f" shrinks below occupancy ({len(housed) + len(evicted)} active);"
                    f" evicting {len(evicted)} session(s): "
                    + ", ".join(repr(sid) for sid, _ in evicted[:8])
                    + ("..." if len(evicted) > 8 else "")
                )
            new_table = LaneTable(target)
            old_idx, new_idx = [], []
            for sid, old_lane in housed:
                new_lane = new_table.allocate(sid)
                new_table.last_seen[new_lane] = table.last_seen[old_lane]
                old_idx.append(old_lane)
                new_idx.append(new_lane)
            inner = self.inner
            if self._compiled_lanes:
                old_rows = torch.as_tensor(old_idx, dtype=torch.int64, device=self._device)
                new_rows = torch.as_tensor(new_idx, dtype=torch.int64, device=self._device)
                for f, default in inner._defaults.items():
                    stacked = self._stacked_default(default, target)
                    rehoused = stacked.clone()
                    if old_idx:
                        rehoused = rehoused.index_copy(0, new_rows, self._state[f].index_select(0, old_rows))
                    self._defaults[f] = stacked
                    self._state[f] = rehoused
                for aux in self._LANE_AUX_FIELDS:
                    zeros = torch.zeros((target,), dtype=torch.int32, device=self._device)
                    rehoused = zeros.clone()
                    if old_idx:
                        rehoused = rehoused.index_copy(0, new_rows, self._state[aux].index_select(0, old_rows))
                    self._defaults[aux] = zeros
                    self._state[aux] = rehoused
            else:
                states = self.__dict__["_lane_states"]
                counts = self.__dict__["_lane_counts"]
                health = self.__dict__["_lane_health_counts"]
                new_states = [inner.init_state() for _ in range(target)]
                new_counts, new_health = [0] * target, [0] * target
                for o, n in zip(old_idx, new_idx):
                    new_states[n], new_counts[n], new_health[n] = states[o], counts[o], health[o]
                self.__dict__["_lane_states"] = new_states
                self.__dict__["_lane_counts"] = new_counts
                self.__dict__["_lane_health_counts"] = new_health
            seen = np.zeros((target,), np.int64)
            old_seen = self.__dict__.get("_health_seen")
            if old_seen is not None and old_idx:
                seen[np.asarray(new_idx)] = np.asarray(old_seen)[np.asarray(old_idx)]
            self.__dict__["_health_seen"] = seen
            self.__dict__["_table"] = new_table
            self.__dict__["_lane_mirror"].invalidate()
            self.__dict__.pop("_window_clocks_host", None)
            self._computed = None
            guard: LaneGuard = self.__dict__["_guard"]
            if guard.active:
                # re-validate against the rehoused directory: records of
                # evicted sessions must not pin a fresh session's lane
                guard.load_json(guard.to_json(), known_sessions=set(new_table.sessions))
            obs.counter_inc("lanes.remaps")
            obs.gauge_set("lanes.capacity", target)
            obs.gauge_set("lanes.occupancy", new_table.active)
            return target

    def prewarm_growth(self, batch_specs: Any, rows: Union[int, Sequence[int]], levels: int = 1) -> Dict[str, Any]:
        """The JAX package precompiles the update executables of the next
        capacity rungs here. Laned updates do not run through the port's
        captured executor yet (ROADMAP Queue A item 4c), so nothing is built
        ahead and the report says so, as the JAX package's does when
        compile-ahead is off."""
        report: Dict[str, Any] = {"warmed": 0, "already_warm": 0, "skipped": [], "rungs": []}
        if not self._compiled_lanes:
            report["skipped"].append("eager lane mode (list states): nothing to compile")
            return report
        report["skipped"].append(LANED_STEP_ASIDE)
        return report

    # ------------------------------------------------------------- read paths
    def _active_mask(self) -> torch.Tensor:
        """Lanes contributing to the all-lane aggregate: active sessions
        MINUS quarantined ones (a quarantined session's state must not leak
        into the aggregate while it serves degraded reads)."""
        table: LaneTable = self.__dict__["_table"]
        guard: LaneGuard = self.__dict__["_guard"]
        mask = table.active_mask()
        if guard.active and guard.quarantined:
            for sid in guard.quarantined:
                lane = table.sessions.get(sid)
                if lane is not None:
                    mask[lane] = False
        return torch.tensor(mask, dtype=torch.bool).to(self._device)

    def compute(self) -> Any:
        """All-lane aggregate: fold the ACTIVE (non-quarantined) lanes per
        declared reduction (inactive lanes contribute the family's identity
        element, ``parallel.sync.reduction_identity``), then the inner
        compute."""
        self._scan_lane_health()
        inner = self.inner
        table: LaneTable = self.__dict__["_table"]
        if table.active == 0:
            return inner.functional_compute(inner.init_state())
        if not self._compiled_lanes:
            folded = self._fold_eager()
            return inner.functional_compute(folded if folded is not None else inner.init_state())
        folded = self._fold_lanes({f: self._state[f] for f in self._inner_fields()}, self._active_mask())
        return inner.functional_compute(folded)

    def _fold_lanes(self, states: Dict[str, Any], mask: torch.Tensor) -> Dict[str, Any]:
        inner = self.inner
        n_active = torch.clamp(mask.sum(), min=1)
        out: Dict[str, Any] = {}
        for f, v in states.items():
            fx = inner._reductions.get(f)
            if callable(fx) or fx in ("cat", None):
                # custom reductions have no derivable identity; "cat"/None on
                # array states stack per contributor
                raise TorchMetricsUserError(
                    f"all-lane aggregate is undefined for {fx!r} reduction on field {f!r};"
                    " read per-lane values via lane_values()"
                )
            ident = reduction_identity(fx, v.dtype).to(v.device)
            masked = torch.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), v, ident)
            if fx == "sum":
                out[f] = masked.sum(0, dtype=v.dtype)
            elif fx == "mean":
                out[f] = masked.sum(0, dtype=v.dtype) / n_active.to(v.dtype)
            elif fx == "max":
                out[f] = torch.amax(masked, 0)
            else:
                out[f] = torch.amin(masked, 0)
        return out

    def _fold_eager(self) -> Optional[Dict[str, Any]]:
        inner = self.inner
        table: LaneTable = self.__dict__["_table"]
        guard: LaneGuard = self.__dict__["_guard"]
        lanes = sorted(
            lane for sid, lane in table.sessions.items() if not (guard.active and guard.is_quarantined(sid))
        )
        folded = None
        for lane in lanes:
            st = self.__dict__["_lane_states"][lane]
            folded = st if folded is None else inner.merge_states(folded, st)
        return folded

    def _lane_route(self) -> str:
        """How :meth:`lane_values` computes: ``"vmap"`` (one batched compute
        over the stacked states), ``"loop"`` (lane by lane) or ``"eager"``
        (the eager mode's per-lane states)."""
        inner = self.inner
        if not self._compiled_lanes:
            return "eager"
        if isinstance(inner, WindowedMetric):
            if "_compute_fn" in inner.__dict__:
                return "loop"
            inner = inner.inner
        if inner.lane_compute == "vmap" and "_compute_fn" not in inner.__dict__:
            return "vmap"
        return "loop"

    def _values_by_lane(self, lanes: Sequence[int]) -> Callable[[int], Any]:
        """A lookup of each named lane's compute value, computed at once."""
        inner = self.inner
        route = self._lane_route()
        if route == "eager":
            vals = {lane: inner.functional_compute(self.__dict__["_lane_states"][lane]) for lane in lanes}
            return vals.__getitem__
        states = {f: self._state[f] for f in self._inner_fields()}
        if isinstance(inner, WindowedMetric) and route == "vmap":
            # each lane's ring folded with its own clock, then the vmapped
            # compute of the metric inside the ring
            states = inner._fold_windows(states, live_window_mask(states["window_head"], inner.window))
            inner = inner.inner
        with obs.span(obs.SPAN_COMPUTE, suffix=f"Laned{type(self.inner).__name__}", route=route):
            if route == "vmap":
                stacked = torch.func.vmap(inner.functional_compute)(states)
                return lambda lane: _tree_index(stacked, lane)
            vals = {lane: inner.functional_compute({f: v[lane] for f, v in states.items()}) for lane in lanes}
        return vals.__getitem__

    def lane_values(self) -> Dict[Any, Any]:
        """Per-lane ``compute()`` for every active session, computed at once
        (see :meth:`_lane_route`). Quarantined sessions serve their last-good
        value as a :class:`~torchmetrics_tpu_torch.quarantine.DegradedValue`;
        healthy reads refresh the last-good cache."""
        self._scan_lane_health()
        table: LaneTable = self.__dict__["_table"]
        guard: LaneGuard = self.__dict__["_guard"]
        slot = self.__dict__.get("_guard_slot", "")
        if not table.sessions:
            return {}
        value_of = self._values_by_lane(sorted(table.sessions.values()))
        counts = self._lane_counts_host() if guard.active else None
        out: Dict[Any, Any] = {}
        for sid, lane in table.sessions.items():
            if guard.active and guard.is_quarantined(sid):
                out[sid] = self._degraded_read(
                    sid, lane, committed_now=int(counts[lane]), health_now=self._health_seen_of(lane)
                )
                continue
            value = value_of(lane)
            if guard.active:
                guard.capture_last_good(
                    sid, _detached(value), committed=int(counts[lane]), health=self._health_seen_of(lane), slot=slot
                )
            out[sid] = value
        return out

    def compute_session(self, session_id: Any) -> Any:
        """One session's ``compute()`` value, or its last-good
        :class:`~torchmetrics_tpu_torch.quarantine.DegradedValue` while the
        session is quarantined."""
        self._scan_lane_health()
        table: LaneTable = self.__dict__["_table"]
        guard: LaneGuard = self.__dict__["_guard"]
        lane = table.lane_of(session_id)
        if guard.active and guard.is_quarantined(session_id):
            return self._degraded_read(session_id, lane)
        value = self._lane_value(lane)
        if guard.active:
            guard.capture_last_good(
                session_id,
                _detached(value),
                committed=self._lane_update_count(lane),
                health=self._health_seen_of(lane),
                slot=self.__dict__.get("_guard_slot", ""),
            )
        return value

    # ----------------------------------------------------- asynchronous reads
    def _read_inner_clone(self) -> Metric:
        """Detached clone of ``inner`` for the read worker's compute (the live
        inner swaps its state during a compute, so the worker never uses it)."""
        cached = self.__dict__.get("_inner_clone_cache")
        if cached is None:
            cached = self.inner.clone()
            self.__dict__["_inner_clone_cache"] = cached
        return cached

    def _prepare_async_read(self) -> Callable[[], Any]:
        """Lane-aware asynchronous aggregate read: the caller snapshots the
        stacked state by reference (updates replace tensors) plus the
        submission-time lane membership and records an event on its stream;
        the worker fetches the fused ``lane_health`` counters, runs the
        scan-and-attribute step under the shared read mutex (quarantine
        decisions land on the LIVE guard, as a blocking read's scan would),
        folds the snapshot over the surviving lanes and computes on a
        detached inner clone. Eager-mode metrics and initialised
        ``torch.distributed`` worlds read inline."""
        from torchmetrics_tpu_torch.ops import async_read as _async

        cached = self._computed
        if cached is not None:
            event = _async.submission_event(cached)
            return lambda: (_async.wait_submitted(event), cached)[1]
        if not self._compiled_lanes or bool(self.distributed_available_fn()):
            obs.counter_inc("reads.inline_compute")
            value = self.compute()
            event = _async.submission_event(value)
            return lambda: (_async.wait_submitted(event), value)[1]
        table: LaneTable = self.__dict__["_table"]
        snapshot = self._state_snapshot()
        flags = self._capture_read_flags()
        mask_list = list(table.active_mask())
        sessions_map = dict(table.sessions)
        active_n = table.active
        inner_clone = self._read_inner_clone()
        event = _async.submission_event(snapshot)

        def body() -> Any:
            _async.wait_submitted(event)
            return self._async_laned_job(snapshot, flags, mask_list, sessions_map, active_n, inner_clone)

        return body

    def _async_laned_job(
        self,
        snapshot: Dict[str, Any],
        flags: Dict[str, Any],
        mask_list: List[bool],
        sessions_map: Dict[Any, int],
        active_n: int,
        inner_clone: Metric,
    ) -> Any:
        """WORKER-SIDE: health scan (locked), masked fold, inner compute,
        materialise, guarded cache write-back."""
        from torchmetrics_tpu_torch.ops import async_read as _async

        guard: LaneGuard = self.__dict__["_guard"]
        if guard.active:
            health = _async.fetch_host(snapshot["lane_health"])
            with self._read_mutex():
                self._scan_lane_health(health_host=health)
                quarantined = set(guard.quarantined)
        else:
            quarantined = set()
        if active_n == 0:
            value = inner_clone.functional_compute(inner_clone.init_state())
        else:
            mask = list(mask_list)
            for sid in quarantined:
                if sid in sessions_map:
                    mask[sessions_map[sid]] = False
            device_mask = torch.tensor(mask, dtype=torch.bool).to(self._device)
            folded = self._fold_lanes({f: snapshot[f] for f in self._inner_fields()}, device_mask)
            value = inner_clone.functional_compute(folded)
        value = _async.materialize(value)
        if (
            self.__dict__.get("_update_count") == flags["count"]
            and flags["cache"]
            and self.__dict__.get("_computed") is None
        ):
            self.__dict__["_computed"] = value
            if self.__dict__.get("_update_count") != flags["count"]:
                self.__dict__["_computed"] = None  # an update landed mid-write
        return value

    # ------------------------------------------------------------- durability
    def _export_extras(self) -> Dict[str, Any]:
        """Host metadata a snapshot carries beside the array states."""
        out = {self._LANE_DIR_KEY: _encode_directory(self.__dict__["_table"])}
        guard: LaneGuard = self.__dict__["_guard"]
        if guard.active:
            out[self._QUARANTINE_KEY] = _encode_json_blob(guard.to_json())
        return out

    def state(self) -> Dict[str, Any]:
        """Stacked state export carrying the session-to-lane directory under
        the reserved ``"_lane_directory"`` key (a uint8 JSON blob the snapshot
        store persists as an ordinary leaf) and, with a fault policy, the
        quarantine records under ``"_lane_quarantine"``, so
        ``save_state``/``restore_state`` round-trip routing as well as
        accumulators (in the JAX package's layout)."""
        if self._compiled_lanes:
            out = super().state()
            out.update(self._export_extras())
            return out
        table: LaneTable = self.__dict__["_table"]
        out = {
            f"lane_{i:05d}": {**self.__dict__["_lane_states"][i], self._STATE_COUNT_KEY: self.__dict__["_lane_counts"][i]}
            for i in range(table.capacity)
        }
        out["_lanes"] = dict(self._export_extras())
        return out

    def load_state(
        self,
        state: Dict[str, Any],
        update_count: Optional[int] = None,
        validate: str = "strict",
        check_finite: bool = False,
        sharded: Optional[bool] = None,
        target_capacity: Optional[int] = None,
    ) -> None:
        """Install a laned export: re-registers capacity from the carried
        directory, routes through the inherited validated restore, then
        verifies every lane (directory within capacity, no double-assigned
        lanes, non-negative per-lane counts; ``check_finite=True`` names
        poisoned lanes). ``target_capacity`` remaps the restored directory
        into that capacity afterwards (:meth:`remap_capacity`). A sharded
        (deferred) export, ``(S, lanes, *field)``, is validated per shard and
        folded at once (lane counts and health sum across shards, window
        clocks take the max)."""
        if not isinstance(state, dict):
            raise obs.flighted(
                StateCorruptionError(f"{type(self).__name__}: state must be a dict, got {type(state).__name__}"),
                domain="lanes",
            )
        state = dict(state)
        if sharded is None:
            sharded = state.get(self._STATE_SHARDS_KEY) is not None
        if sharded and not self._compiled_lanes:
            raise TorchMetricsUserError("a sharded laned state needs fixed-shape lane states (no list/'cat' states)")
        if not self._compiled_lanes:
            self._load_state_eager(state, validate=validate, check_finite=check_finite)
            if target_capacity is not None and lane_capacity_bucket(int(target_capacity)) != self.capacity:
                self.remap_capacity(target_capacity)
            return
        blob = state.pop(self._LANE_DIR_KEY, None)
        table = _decode_directory(blob) if blob is not None else None
        qblob = state.pop(self._QUARANTINE_KEY, None)
        cap = self._infer_capacity(state, sharded=bool(sharded))
        if "lane_health" not in state and "lane_updates" in state:
            # a checkpoint without the fused health counter: lanes were never
            # attributed, so a zero counter is the exact restore
            updates = state["lane_updates"]
            state["lane_health"] = torch.zeros_like(updates) if isinstance(updates, torch.Tensor) else np.zeros_like(np.asarray(updates))
        if table is not None and validate != "off" and table.capacity != cap:
            raise obs.flighted(StateCorruptionError(
                f"{type(self).__name__}: lane directory says capacity {table.capacity} but state"
                f" arrays carry {cap} lanes"
            ), domain="lanes")
        if cap != self.capacity:
            self._respec_capacity(cap)
        super().load_state(state, update_count=update_count, validate=validate, check_finite=False, sharded=bool(sharded))
        self._fold_pending()
        if table is not None:
            self.__dict__["_table"] = table
        self._validate_lanes(check_finite=check_finite, mode=validate)
        self._restore_guard(qblob)
        if target_capacity is not None and lane_capacity_bucket(int(target_capacity)) != self.capacity:
            self.remap_capacity(target_capacity)
        obs.gauge_set("lanes.capacity", self.capacity)
        obs.gauge_set("lanes.occupancy", self.__dict__["_table"].active)

    def _restore_guard(self, qblob: Any) -> None:
        """Re-arm the fault guard from a checkpointed quarantine blob (records
        of sessions absent from the restored directory are dropped) and
        re-seed the health baseline from the restored ``lane_health``
        counters, so historical faults are not attributed again."""
        guard: LaneGuard = self.__dict__["_guard"]
        table: LaneTable = self.__dict__["_table"]
        if qblob is not None:
            guard.load_json(
                _decode_json_blob(qblob, f"{type(self).__name__} quarantine state", domain="lanes"),
                known_sessions=set(table.sessions),
            )
        if self._compiled_lanes:
            self.__dict__["_health_seen"] = self._state["lane_health"].cpu().numpy().astype(np.int64)
        else:
            self.__dict__["_health_seen"] = np.asarray(self.__dict__["_lane_health_counts"], dtype=np.int64)
        self.__dict__["_lane_mirror"].invalidate()
        self.__dict__.pop("_window_clocks_host", None)  # the restored heads are the clocks now
        self.__dict__.pop("_win_close_us", None)

    def _infer_capacity(self, state: Dict[str, Any], sharded: bool = False) -> int:
        axis = 1 if sharded else 0
        for f in self._inner_fields() + ["lane_updates"]:
            v = state.get(f)
            if v is None:
                continue
            shape = np.shape(v) if not isinstance(v, torch.Tensor) else tuple(v.shape)
            if len(shape) > axis:
                return int(shape[axis])
        raise obs.flighted(StateCorruptionError(f"{type(self).__name__}: no state field carries a lane axis"), domain="lanes")

    def _respec_capacity(self, capacity: int) -> None:
        """Re-register the stacked defaults (and fresh states) at
        ``capacity``: the restore path's analogue of :meth:`grow`, also used
        to shrink back to a smaller checkpoint's layout."""
        for f, default in self.inner._defaults.items():
            stacked = self._stacked_default(default, capacity)
            self._defaults[f] = stacked
            self._state[f] = stacked.clone()
        for aux in self._LANE_AUX_FIELDS:
            self._defaults[aux] = torch.zeros((capacity,), dtype=torch.int32, device=self._device)
            self._state[aux] = torch.zeros((capacity,), dtype=torch.int32, device=self._device)
        self.__dict__["_lane_mirror"].invalidate()
        self.__dict__.pop("_window_clocks_host", None)
        self.__dict__["_health_seen"] = np.zeros((capacity,), np.int64)
        table: LaneTable = self.__dict__["_table"]
        if capacity != table.capacity:
            self.__dict__["_table"] = LaneTable(capacity)

    def _validate_lanes(self, check_finite: bool, mode: str) -> None:
        """Per-lane restore validation."""
        table: LaneTable = self.__dict__["_table"]
        if mode != "off":
            if table.capacity != self.capacity:
                raise obs.flighted(StateCorruptionError(
                    f"{type(self).__name__}: directory capacity {table.capacity} != state capacity {self.capacity}"
                ), domain="lanes")
            for aux in self._LANE_AUX_FIELDS:
                counts = self._state[aux]
                if counts.ndim != 1 or counts.shape[0] != self.capacity:
                    raise obs.flighted(StateCorruptionError(
                        f"{type(self).__name__}: {aux} has shape {tuple(counts.shape)}, expected ({self.capacity},)"
                    ), domain="lanes")
                bad = np.flatnonzero(counts.cpu().numpy() < 0)
                if bad.size:
                    raise obs.flighted(StateCorruptionError(
                        f"{type(self).__name__}: negative per-lane {aux} counts in lane(s) {[int(b) for b in bad[:8]]}"
                    ), domain="lanes")
        if check_finite:
            # a poisoned lane is NAMED instead of failing the whole array
            for f in self._inner_fields():
                v = self._state[f]
                if not v.is_floating_point():
                    continue
                lane_ok = torch.isfinite(v).reshape(v.shape[0], -1).all(dim=1)
                if not bool(lane_ok.all()):
                    bad = [int(i) for i in np.flatnonzero(~lane_ok.cpu().numpy())]
                    raise obs.flighted(StateCorruptionError(
                        f"{type(self).__name__}: sharded field {f!r} contains non-finite values"
                        f" in shard(s) {bad} (check_finite=True rejects NaN/Inf accumulators)"
                    ), domain="checkpoint")

    def _load_state_eager(self, state: Dict[str, Any], validate: str, check_finite: bool) -> None:
        inner = self.inner
        lanes_meta = state.pop("_lanes", None)
        blob = (lanes_meta or {}).get(self._LANE_DIR_KEY)
        table = _decode_directory(blob) if blob is not None else None
        lane_keys = sorted(k for k in state if isinstance(k, str) and k.startswith("lane_"))
        if not lane_keys:
            raise obs.flighted(StateCorruptionError(f"{type(self).__name__}: export holds no lane_* states"), domain="lanes")
        capacity = len(lane_keys)
        if table is not None and validate != "off" and table.capacity != capacity:
            raise obs.flighted(StateCorruptionError(
                f"{type(self).__name__}: lane directory says capacity {table.capacity} but export holds {capacity} lanes"
            ), domain="lanes")
        staged, counts = [], []
        for key in lane_keys:
            sub = dict(state[key])
            count = int(np.asarray(sub.get(self._STATE_COUNT_KEY, 0)))
            try:
                checked = inner.validate_state(sub, mode=validate, check_finite=check_finite)
            except StateCorruptionError as err:
                raise obs.flighted(StateCorruptionError(f"{type(self).__name__}: {key}: {err}"), domain="lanes") from err
            staged.append({f: (list(v) if isinstance(v, (list, tuple)) else v) for f, v in checked.items() if f in inner._defaults})
            counts.append(count)
        self.__dict__["_lane_states"] = staged
        self.__dict__["_lane_counts"] = counts
        self.__dict__["_lane_health_counts"] = [0] * capacity
        if table is not None:
            self.__dict__["_table"] = table
        elif capacity != self.capacity:
            self.__dict__["_table"] = LaneTable(capacity)
        self._computed = None
        self._update_count = self._restored_count(None, fallback=max(counts) if counts else 1)
        self._restore_guard((lanes_meta or {}).get(self._QUARANTINE_KEY))

    # --------------------------------------------------------------- plumbing
    #: process-local bookkeeping a copy or pickle never carries
    _TRANSIENT_KEYS = Metric._TRANSIENT_KEYS + (
        "_pending_capture_health",
        "_fault_owner",
        "_inner_clone_cache",
        "_screen_kind_memo",
        "_window_clocks_host",
        "_win_close_us",
    )

    def __getstate__(self) -> Dict[str, Any]:
        out = super().__getstate__()
        # the recovery mirror chains off this process's commit stream
        out["_lane_mirror"] = LaneStateMirror()
        return out

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self.__dict__.setdefault("_guard", LaneGuard())
        self.__dict__.setdefault("_guard_slot", "")
        self.__dict__.setdefault("_lane_mirror", LaneStateMirror())
        self.__dict__.setdefault("_health_seen", np.zeros((self.capacity,), np.int64))

    def __repr__(self) -> str:
        table: LaneTable = self.__dict__["_table"]
        return f"LanedMetric({type(self.inner).__name__}, capacity={table.capacity}, active={table.active})"


class LanedCollection:
    """Session lanes over a whole metric suite: every member is a
    :class:`LanedMetric` sharing ONE session-to-lane table and ONE fault
    guard, and a round of traffic advances all of them through one
    collection update. Members whose stacked states agree share a compute
    group, and the counting family's members share one ``bincount`` launch a
    round (one per row chunk).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MaxMetric, SumMetric
        >>> from torchmetrics_tpu_torch.lanes import LanedCollection
        >>> lc = LanedCollection({"s": SumMetric(device="cpu"), "m": MaxMetric(device="cpu")}, capacity=8)
        >>> lc.update_sessions([("a", torch.tensor([1.0, 2.0])), ("b", torch.tensor([5.0, 7.0]))])
        1
        >>> {k: float(v) for k, v in sorted(lc.lane_values()["a"].items())}
        {'m': 2.0, 's': 3.0}
    """

    def __init__(
        self,
        metrics: Any,
        capacity: int = DEFAULT_CAPACITY,
        max_capacity: Optional[int] = None,
        on_lane_fault: Optional[str] = None,
        breaker_threshold: int = 3,
        breaker_window: int = 32,
        unquarantine_after: int = 2,
        admission_screen: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        from torchmetrics_tpu_torch.collections import MetricCollection
        from torchmetrics_tpu_torch.windows import WindowedCollection

        if isinstance(metrics, MetricCollection):
            metrics = {name: m for name, m in metrics.items(keep_base=True)}
        elif isinstance(metrics, WindowedCollection):
            # lane the windowed members: the window axis under the lane axis,
            # every ring advancing in lockstep
            metrics = dict(metrics.items())
        elif isinstance(metrics, Metric):
            metrics = {type(metrics).__name__: metrics}
        elif not isinstance(metrics, dict):
            named: Dict[str, Metric] = {}
            for m in metrics:
                name = type(m).__name__
                if name in named:
                    raise ValueError(f"Encountered two metrics both named {name}")
                named[name] = m
            metrics = named
        if not metrics:
            raise ValueError("LanedCollection needs at least one metric")
        devices = {m.device for m in metrics.values()}
        if len(devices) != 1:
            raise ValueError(f"LanedCollection members must share one device, got {sorted(map(str, devices))}")
        capacity = lane_capacity_bucket(capacity)
        self._table = LaneTable(capacity)
        # ONE guard across the suite (like the shared table): a faulting
        # session is quarantined in every member at once
        self._guard = LaneGuard(
            policy=on_lane_fault,
            breaker_threshold=breaker_threshold,
            breaker_window=breaker_window,
            unquarantine_after=unquarantine_after,
            screen=admission_screen,
        )
        self._members: Dict[str, LanedMetric] = {
            name: LanedMetric(m, capacity=capacity, max_capacity=max_capacity, table=self._table, guard=self._guard, **kwargs)
            for name, m in metrics.items()
        }
        for name, member in self._members.items():
            member.__dict__["_guard_slot"] = name  # distinct last-good caches
            # fault actions route through the collection: eviction and reset
            # must span every member sharing the lane
            member.__dict__["_fault_owner"] = self
        self._device = next(iter(devices))
        self.collection = MetricCollection(dict(self._members), device=self._device)
        self.max_capacity = None if max_capacity is None else lane_capacity_bucket(max_capacity)

    # ------------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def capacity(self) -> int:
        return self._table.capacity

    @property
    def sessions(self) -> Dict[Any, int]:
        return dict(self._table.sessions)

    @property
    def lane_status(self) -> Dict[str, Any]:
        return {
            "capacity": self._table.capacity,
            "active": self._table.active,
            "free": self._table.free,
            "max_capacity": self.max_capacity,
            "members": sorted(self._members),
            "policy": self._guard.policy,
            "quarantined": len(self._guard.quarantined),
            **self._table.stats,
            **dict(self._guard.stats),
        }

    @property
    def guard(self) -> LaneGuard:
        """The suite-wide lane fault-containment registry."""
        return self._guard

    def quarantine_table(self) -> List[Dict[str, Any]]:
        """The per-session fault, quarantine and staleness table for the suite."""
        return self._guard.table(lane_of=dict(self._table.sessions))

    @property
    def executor_status(self) -> Dict[str, Any]:
        return self.collection.executor_status

    @property
    def update_count(self) -> int:
        return self.collection.update_count

    def keys(self) -> Iterable[str]:
        return self._members.keys()

    def __getitem__(self, name: str) -> LanedMetric:
        return self._members[name]

    # ----------------------------------------------------------------- router
    def _read_mutex(self) -> Any:
        """Shared lock for the suite (one guard, one lock, every member)."""
        if not self._guard.active:
            return nullcontext()
        from torchmetrics_tpu_torch.ops.async_read import guard_lock

        return guard_lock(self._guard)

    def update_sessions(
        self,
        items: Union[Dict[Any, Any], Iterable[Tuple[Any, Any]]],
        window: Optional[int] = None,
    ) -> int:
        """Pack ``(session_id, batch)`` traffic and advance EVERY member with
        one collection update a round (see :meth:`LanedMetric.update_sessions`).
        Returns the number of rounds. ``window`` (windowed members only)
        stamps the traffic with an event-time window index; the watermark
        admits each session once for the suite, whose members advance their
        rings in lockstep."""
        with self._read_mutex():
            if window is None:
                return _route_rounds(self, items)
            return _route_windowed(self, int(window), items)

    def _windowed_named(self) -> List[Tuple[str, LanedMetric]]:
        return [(name, m) for name, m in self._members.items() if isinstance(m.inner, WindowedMetric)]

    def _first_windowed(self) -> LanedMetric:
        members = [m for _, m in self._windowed_named()]
        if not members:
            raise TorchMetricsUserError(
                "window operations need at least one windowed member;"
                " build with MetricCollection(...).windowed(W).laned(capacity)"
            )
        return members[0]

    def _windowed_inner(self) -> WindowedMetric:
        return self._first_windowed().inner

    def _window_clocks(self) -> np.ndarray:
        """The suite's lane clocks: the members advance in lockstep, so the
        first windowed member's mirror speaks for all."""
        return self._first_windowed()._window_clocks()

    def _window_close_us(self) -> Dict[int, int]:
        return self._first_windowed()._window_close_us()

    def window_spec(self) -> Dict[str, Any]:
        """The suite's ring (see :meth:`LanedMetric.window_spec`)."""
        return self._first_windowed().window_spec()

    def advance_windows(self, n: int = 1) -> None:
        """Close the open window on every lane of EVERY windowed member: the
        suite's rings stay in lockstep (one clock, many metrics)."""
        with self._read_mutex():
            self._first_windowed()  # raises without a windowed member
            followers = self.collection._compute_group_followers()
            for name, m in self._windowed_named():
                if name in followers:
                    m._follow_advance(n)
                else:
                    m.advance_windows(n)
            self._realias_groups()

    def advance_lane_windows(self, lane: int, n: int = 1) -> None:
        """Per-lane window advance (clock skew) in every windowed member, so
        the suite's lane clocks stay coherent."""
        with self._read_mutex():
            self._first_windowed()  # raises without a windowed member
            followers = self.collection._compute_group_followers()
            for name, m in self._windowed_named():
                if name in followers:
                    m._follow_advance(n, lane)
                else:
                    m.advance_lane_windows(lane, n)
            self._realias_groups()

    # ------------------------------------------------ shared-router adapters
    def _router_table(self) -> LaneTable:
        return self._table

    def _router_guard(self) -> LaneGuard:
        return self._guard

    def _router_members(self) -> List[Tuple[str, LanedMetric]]:
        return list(self._members.items())

    def _router_admit(self, session_id: Any) -> int:
        return self.admit(session_id)

    def _router_pipelinable(self) -> bool:
        return all(m._compiled_lanes for m in self._members.values())

    def _router_kind_memo(self) -> Dict[Any, Any]:
        return self.__dict__.setdefault("_screen_kind_memo", {})

    def _router_dispatch(self, lane_ids: LaneRound, batch: Tuple[Any, ...], rows: int, bucket: int) -> None:
        k = self.__dict__.get("_round_window")
        with obs.span(obs.SPAN_LANES, owner="LanedCollection", histogram="lanes.dispatch_us", rows=rows, bucket=bucket):
            if k is None:
                self.collection.update(lane_ids, *batch)
            else:
                self.collection.update(lane_ids, *batch, window=k)

    def _apply_fault_action(self, sid: Any, action: str, err: LaneFaultError) -> None:
        """Suite-wide ``on_lane_fault`` action: eviction and reset span every
        member through the shared table; quarantine restores the session's
        lane in each member and registers it once in the shared guard."""
        if action == "raise":
            raise err
        if action == "evict":
            if sid in self._table.sessions:
                self.evict(sid)
            self._guard.forget(sid)
        elif action == "reset":
            if sid in self._table.sessions:
                self.reset_session(sid)
        elif action == "quarantine":
            lane = self._table.sessions.get(sid)
            if lane is not None:
                for m in self._members.values():
                    m._quarantine_restore_lane(sid, lane)
            self._guard.quarantine(sid)

    # -------------------------------------------------------------- lifecycle
    def _realias_groups(self) -> None:
        """Point compute-group followers at their leader's (grown, reset or
        restored) stacked state again."""
        if self.collection._groups_checked:
            self.collection._compute_groups_create_state_ref()

    def admit(self, session_id: Any) -> int:
        with self._read_mutex():
            if session_id in self._table.sessions:
                return self._table.sessions[session_id]
            if self._table.free == 0:
                self._grow_impl()
            lane = self._table.allocate(session_id)
            for m in self._members.values():
                m._computed = None
            obs.counter_inc("lanes.admissions")
            obs.gauge_set("lanes.occupancy", self._table.active)
            return lane

    def evict(self, session_id: Any) -> int:
        with self._read_mutex():
            lane = self._table.release(session_id)
            for m in self._members.values():
                m._reset_lane_indices([lane])
                m._computed = None
            self._realias_groups()
            self._guard.forget(session_id)
            obs.counter_inc("lanes.evictions")
            obs.gauge_set("lanes.occupancy", self._table.active)
            return lane

    def evict_idle(self, idle_s: float) -> List[Any]:
        idle = self._table.idle_sessions(idle_s)
        for sid in idle:
            self.evict(sid)
        return idle

    def reset_session(self, session_id: Any) -> None:
        with self._read_mutex():
            lane = self._table.lane_of(session_id)
            for m in self._members.values():
                m._reset_lane_indices([lane])
                m._computed = None
            self._realias_groups()
            self._table.stats["resets"] += 1
            obs.counter_inc("lanes.resets")

    def reset(self) -> None:
        with self._read_mutex():
            self.collection.reset()

    def grow(self, new_capacity: Optional[int] = None) -> int:
        with self._read_mutex():
            return self._grow_impl(new_capacity)

    def _grow_impl(self, new_capacity: Optional[int] = None) -> int:
        target = lane_capacity_bucket(self._table.capacity + 1 if new_capacity is None else new_capacity)
        if target <= self._table.capacity:
            return self._table.capacity
        if self.max_capacity is not None and target > self.max_capacity:
            raise TorchMetricsUserError(f"cannot grow lanes to {target}: max_capacity={self.max_capacity}")
        for m in self._members.values():
            m._grow_state(target)
        self._table.grow(target)
        self._realias_groups()
        obs.counter_inc("lanes.grows")
        obs.gauge_set("lanes.capacity", target)
        return target

    # ------------------------------------------------------------- read paths
    def compute(self) -> Dict[str, Any]:
        """All-lane aggregate per member (the collection's renamed dict)."""
        return self.collection.compute()

    def compute_async(self) -> Any:
        """Non-blocking :meth:`compute`: one future resolving to every
        member's all-lane aggregate; member snapshots are taken now, health
        scans and quarantine exclusions applied on the read worker under the
        shared read mutex."""
        return self.collection.compute_async()

    def lane_values(self) -> Dict[Any, Dict[str, Any]]:
        """``{session_id: {member_name: value}}`` for every active session."""
        per_member = {name: m.lane_values() for name, m in self._members.items()}
        return {sid: {name: vals[sid] for name, vals in per_member.items()} for sid in self._table.sessions}

    def compute_session(self, session_id: Any) -> Dict[str, Any]:
        return {name: m.compute_session(session_id) for name, m in self._members.items()}

    # ------------------------------------------------------------- durability
    def state(self) -> Dict[str, Any]:
        return self.collection.state()

    def state_spec(self) -> Dict[str, Any]:
        return self.collection.state_spec()

    def load_state(
        self,
        states: Dict[str, Any],
        update_count: Optional[int] = None,
        validate: str = "strict",
        check_finite: bool = False,
        sharded: Optional[bool] = None,
        target_capacity: Optional[int] = None,
    ) -> None:
        """Restore every member, then re-link them onto ONE shared table
        (each member's restore decoded its own directory copy).
        ``target_capacity`` remaps the restored directory afterwards."""
        self.collection.load_state(
            states, update_count=update_count, validate=validate, check_finite=check_finite, sharded=sharded
        )
        self._relink_tables()
        self._realias_groups()
        if target_capacity is not None and lane_capacity_bucket(int(target_capacity)) != self.capacity:
            self.remap_capacity(target_capacity)

    def _relink_tables(self) -> None:
        tables = [m.__dict__["_table"] for m in self._members.values()]
        first = tables[0]
        for t in tables[1:]:
            if t.sessions != first.sessions or t.capacity != first.capacity:
                raise obs.flighted(StateCorruptionError(
                    "restored members disagree on the session->lane directory;"
                    " the snapshot does not describe one coherent laned collection"
                ), domain="lanes")
        self._table = first
        for m in self._members.values():
            m.__dict__["_table"] = first

    def remap_capacity(self, new_capacity: int) -> int:
        """Rehouse every member into ``new_capacity`` lanes (deterministic,
        so every member computes the SAME assignment), then re-link them onto
        one shared table. Returns the new (bucketed) capacity."""
        target = self.capacity
        for m in self._members.values():
            target = m.remap_capacity(new_capacity)
        self._relink_tables()
        self._realias_groups()
        return target

    def add_update_observer(self, callback: Callable[[Any], None]) -> Callable[[], None]:
        return self.collection.add_update_observer(callback)

    def __setstate__(self, state: Dict[str, Any]) -> None:
        # a copy's members route their fault actions through the copy
        # (``LanedMetric.__getstate__`` drops the link to the original)
        self.__dict__.update(state)
        for member in self._members.values():
            member.__dict__["_fault_owner"] = self

    def __repr__(self) -> str:
        return f"LanedCollection({sorted(self._members)}, capacity={self._table.capacity}, active={self._table.active})"


# ---------------------------------------------------------------------------
# the deferred (sharded) lane layout: the lane axis stacks inside the shard
# ---------------------------------------------------------------------------


class DeferredLaneStep:
    """Laned accumulation over S stacked shards with no collective until
    the read point: state ``(S, lanes, *field)``, each dispatch's rows split
    into S equal contiguous slices (one a shard), and :meth:`reduce` applying
    each declared reduction across shards once. Built by
    :func:`make_deferred_lane_step`; the laned metric must hold fixed-shape
    lane states. Every method returns new tensors (the states passed in are
    read, never written), so ``donate`` has nothing to release."""

    def __init__(self, laned: LanedMetric, mesh: Any = None, axis_name: str = "batch", donate: bool = True) -> None:
        if not laned._compiled_lanes:
            raise TorchMetricsUserError("deferred lane accumulation needs fixed-shape lane states (no list/'cat' states)")
        if mesh is not None and (not isinstance(mesh, int) or isinstance(mesh, bool) or mesh < 1):
            raise ValueError(f"mesh is the number of stacked shards on this process (a positive int or None), got {mesh!r}")
        self._laned = laned
        self.num_shards = 1 if mesh is None else int(mesh)
        self._axis = axis_name
        self._donate = donate

    def init_states(self) -> Dict[str, torch.Tensor]:
        """Fresh sharded laned states, ``(S, lanes, *field)``."""
        return self._laned.init_sharded_state(self.num_shards)

    def _flat(self, states: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        s = self.num_shards
        return {k: v.reshape((s * v.shape[1],) + tuple(v.shape[2:])) for k, v in states.items()}

    def _stacked(self, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        s = self.num_shards
        return {k: v.reshape((s, v.shape[0] // s) + tuple(v.shape[1:])) for k, v in flat.items()}

    def _shard_round(self, lane_ids: Any) -> LaneRound:
        """The round with each row's shard folded into its lane: row r of a
        dispatch of R rows belongs to shard ``r // (R / S)``; a live lane
        ``l`` becomes ``shard * lanes + l``, a sentinel stays out of range.
        Memoised on the caller's round, so the members of a laned collection
        stepping the same round share its cut rows (and their count)."""
        rnd = LaneRound.of(lane_ids)
        cap, s = self._laned.capacity, self.num_shards
        key = ("deferred_shards", s, cap)
        hit = rnd._memo.get(key)
        if hit is not None:
            return hit
        rows = len(rnd)
        if rows % s:
            raise ValueError(f"a deferred round's {rows} rows must split evenly over {s} shards")
        ids = rnd.host.astype(np.int64)
        shard = np.arange(rows, dtype=np.int64) // max(1, rows // s)
        live = (ids >= 0) & (ids < cap)
        combined = LaneRound(np.where(live, ids + shard * cap, s * cap).astype(np.int32))
        rnd._memo[key] = combined
        return combined

    def local_step(self, states: Dict[str, torch.Tensor], lane_ids: Any, *batch: Any, window: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One dispatch: every shard's rows land in that shard's lane copies
        (one row-batched update for all of them). ``window`` (windowed inner
        only) routes every row into that absolute window's ring slot."""
        laned = self._laned
        rnd = self._shard_round(lane_ids)
        if window is not None and isinstance(window, torch.Tensor):
            window = int(window)
        flat = self._flat(states)
        saved = laned._state
        with obs.span(obs.SPAN_LANES, owner=type(laned.inner).__name__, deferred=True):
            object.__setattr__(laned, "_state", dict(flat))
            try:
                laned._update_compiled(rnd, tuple(batch), window, capacity=self.num_shards * laned.capacity)
                out = {k: laned._state[k] for k in flat}
            finally:
                object.__setattr__(laned, "_state", saved)
        laned._mark_unreduced()
        return self._stacked(out)

    def advance_windows(self, states: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Close the open window of every lane of every shard: each copy of
        the clock moves by one and its retiring slot returns to the
        defaults (every shard holds the same clocks, so they stay in
        agreement without a collective)."""
        laned = self._laned
        win = laned._windowed_inner()
        flat = self._flat(states)
        with obs.span(obs.SPAN_WINDOWS, owner=type(win.inner).__name__, histogram="windows.advance_us", window=win.window, deferred=True):
            heads = flat["window_head"] + 1
            mask = _retired_slots(heads, win.window)
            out = dict(flat)
            for f in win._inner_fields():
                v = flat[f]
                default = laned._defaults[f][:1]  # one lane's (W, ...) ring of defaults
                out[f] = torch.where(mask.reshape(tuple(mask.shape) + (1,) * (v.ndim - 2)), default, v)
            out["window_head"] = heads
        obs.counter_inc("windows.advanced")
        return self._stacked(out)

    def reduce(self, states: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The one deferred reduction: fold the shard axis per declared
        reduction (and sync across ranks in a process group), returning
        per-lane states ``(lanes, *field)``."""
        laned = self._laned
        with obs.span(obs.SPAN_REDUCE, owner=type(laned.inner).__name__, kind="lanes"):
            return laned.reduce_sharded_state(states)

    def install_reduced(self, states: Dict[str, torch.Tensor]) -> None:
        """Install reduced per-lane states into the laned metric so its read
        paths (``lane_values``/``compute``/checkpoints) serve them."""
        laned = self._laned
        new_state = dict(laned._state)
        new_state.update({k: v for k, v in states.items() if k in laned._defaults})
        object.__setattr__(laned, "_state", new_state)
        laned.__dict__["_reduced"] = True
        laned.__dict__["_pending_shards"] = None
        laned.__dict__["_lane_mirror"].invalidate()
        laned.__dict__.pop("_window_clocks_host", None)
        laned._computed = None


def make_deferred_lane_step(laned: LanedMetric, mesh: Any = None, axis_name: str = "batch", donate: bool = True) -> DeferredLaneStep:
    """The deferred-reduction lane loop for ``laned`` over ``mesh`` stacked
    shards (None: one shard a rank); see :class:`DeferredLaneStep`."""
    return DeferredLaneStep(laned, mesh, axis_name, donate)
