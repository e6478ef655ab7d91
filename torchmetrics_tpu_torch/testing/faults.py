"""Fault injection for the port's runtime layers (the subset of the JAX
package's ``testing/faults.py`` that injects into them).

Each primitive injects exactly one fault, deterministically, on one host,
so the containment guarantees are asserted, not assumed:

- :func:`raise_in_update` / :func:`raise_in_compute`: raise inside the
  metric body, optionally after the state was written (the half-applied
  update the transactional wrapper must roll back).
- :func:`corrupt_state`: damage a state dict (shape/dtype/structure/NaN)
  the way a torn resume checkpoint would (drives ``load_state(validate=...)``).
- :func:`torn_write`: truncate, zero or bit-flip a snapshot FILE the way a
  crash mid-write presents (drives ``restore_state``'s torn-write detection
  and rotating fallback).
- :func:`preempt_after`: raise a simulated preemption after the n-th
  COMMITTED update (drives autosave and kill/restore tests).
- :func:`shrink_world` / :func:`grow_world`: make the checkpoint layer's
  world probe report another device count, as after a restart on another
  machine (drives ``restore_state``'s topology gate).
- :func:`pause_async_reads`: park the read pipeline's worker, so reads stay
  in flight (drives back-pressure and staleness tests).
- :func:`poison_batch` / :func:`poison_session`: NaN or Inf in one
  session's rows of every laned round (drives the lane containment
  guarantees: every OTHER lane stays bit-equal to a fault-free run).
- :func:`fail_lane_dispatch`: an attributed ``LaneFaultError`` from inside
  the laned update, after the real update ran (drives the round rollback).
- :func:`skew_clock` / :func:`late_event`: run one lane's window clock
  ahead, or deliver one session's batch some windows late (drives the
  windowed lanes' per-session watermark: admitted within the lateness
  bound, dropped with a breadcrumb past it).
- :func:`flip_state_bits` / :func:`skew_replica`: flip bits of a live
  state leaf in place, or of one shard row of a stacked tree (drives the
  integrity audits, ``integrity.py``).
- :func:`corrupt_delta_payload`, :func:`drop_delta`,
  :func:`duplicate_delta`, :func:`delay_delta`, :func:`partition_leaf`,
  :func:`kill_aggregator`: transport faults at the fleet uplink's
  ``Uplink.transmit`` seam and a dead aggregator (drives the exactly-once
  delta protocol, ``fleet/``).

All context managers restore the patched seam on exit, including when the
body raises. They are process-local and not thread-safe (they patch module
and instance attributes): use them from one test thread.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, Generator, Optional

import numpy as np
import torch


class FaultInjected(RuntimeError):
    """Default exception raised by the injection primitives, distinct from
    anything the framework raises itself."""


class PreemptionInjected(BaseException):
    """Raised by :func:`preempt_after`: a BaseException (like the
    ``SystemExit``/``KeyboardInterrupt`` a real SIGTERM path produces), so
    recovery code catching ``Exception`` cannot swallow the simulated kill."""


# --------------------------------------------------------------- metric body

@contextmanager
def raise_in_update(metric: Any, exc: Optional[BaseException] = None, after_mutation: bool = True) -> Generator[None, None, None]:
    """Make ``metric``'s update body raise.

    With ``after_mutation=True`` (default) the real update body runs first,
    so the live state is already written when the exception fires: the
    half-applied case the transactional wrapper must roll back.
    ``after_mutation=False`` raises before touching anything. The patch
    takes the ``_update_fn`` seam, shared by ``update``, ``forward`` and
    ``functional_update``.
    """
    orig = metric._update_fn
    error = exc if exc is not None else FaultInjected("injected update failure")

    def failing(*args: Any, **kwargs: Any) -> None:
        if after_mutation:
            orig(*args, **kwargs)
        raise error

    metric.__dict__["_update_fn"] = failing
    try:
        yield
    finally:
        metric.__dict__.pop("_update_fn", None)


@contextmanager
def raise_in_compute(metric: Any, exc: Optional[BaseException] = None) -> Generator[None, None, None]:
    """Make ``metric``'s compute body raise (the ``_compute_fn`` seam, shared
    by ``compute`` and ``functional_compute``)."""
    error = exc if exc is not None else FaultInjected("injected compute failure")

    def failing(*args: Any, **kwargs: Any) -> Any:
        raise error

    metric.__dict__["_compute_fn"] = failing
    try:
        yield
    finally:
        metric.__dict__.pop("_compute_fn", None)


# --------------------------------------------------------------------- inputs

def poison_batch(*arrays: Any, mode: str = "nan", frac: float = 0.25, seed: int = 0) -> tuple:
    """Corrupt a fraction of every floating-point array's entries with NaN
    (``mode="nan"``) or +/-Inf (``mode="inf"``); integer arrays (labels) pass
    through untouched. Deterministic in ``seed``, and the same entries as the
    JAX package's ``poison_batch`` for the same inputs. Returns numpy arrays
    for numpy (or list) inputs and tensors on the input's device for tensors.

    >>> import numpy as np
    >>> (x,) = poison_batch(np.zeros(8, np.float32), frac=0.5, seed=1)
    >>> int(np.isnan(x).sum())
    4
    """
    if mode not in ("nan", "inf"):
        raise ValueError(f"mode must be 'nan' or 'inf', got {mode!r}")
    rng = np.random.RandomState(seed)
    out = []
    for arr in arrays:
        tensor = isinstance(arr, torch.Tensor)
        a = arr.detach().cpu().numpy().copy() if tensor else np.array(arr)
        if not np.issubdtype(a.dtype, np.floating):
            out.append(arr)
            continue
        flat = a.reshape(-1)
        k = max(1, int(round(frac * flat.size)))
        idx = rng.choice(flat.size, size=min(k, flat.size), replace=False)
        if mode == "nan":
            flat[idx] = np.nan
        else:
            flat[idx] = np.where(rng.rand(len(idx)) < 0.5, np.inf, -np.inf)
        a = flat.reshape(a.shape)
        out.append(torch.from_numpy(a).to(arr.device) if tensor else a)
    return tuple(out)


# -------------------------------------------------------------------- lanes

@contextmanager
def poison_session(
    laned: Any, session_id: Any, mode: str = "nan", frac: float = 0.25, seed: int = 0
) -> Generator[None, None, None]:
    """Corrupt ONLY ``session_id``'s rows in every ``update_sessions`` round
    on ``laned`` (a ``LanedMetric`` or ``LanedCollection``): the
    one-bad-session scenario the lane isolation property is asserted
    against. ``mode``/``frac``/``seed`` are :func:`poison_batch`'s."""
    orig = laned.update_sessions

    def poisoned(items: Any, **kwargs: Any) -> int:
        items = list(items.items()) if isinstance(items, dict) else list(items)
        out = []
        for sid, batch in items:
            if sid == session_id:
                was_tuple = isinstance(batch, tuple)
                leaves = batch if was_tuple else (batch,)
                leaves = poison_batch(*leaves, mode=mode, frac=frac, seed=seed)
                batch = leaves if was_tuple else leaves[0]
            out.append((sid, batch))
        return orig(out, **kwargs)

    laned.__dict__["update_sessions"] = poisoned
    try:
        yield
    finally:
        if laned.__dict__.get("update_sessions") is poisoned:
            del laned.__dict__["update_sessions"]


@contextmanager
def fail_lane_dispatch(
    laned: Any, session_id: Any, fail_n: Optional[int] = None, exc: Optional[BaseException] = None
) -> Generator[None, None, None]:
    """Raise an attributed ``LaneFaultError(session_id)`` from inside the
    laned update whenever a round holds that session's lane, AFTER the real
    update ran (the committed-then-faulted worst case). The router's
    containment must roll the touched lanes back and re-dispatch the round
    without the culprit. ``fail_n=k`` faults only the first k hits; ``None``
    faults every one."""
    from torchmetrics_tpu_torch.utils.exceptions import LaneFaultError

    collection = getattr(laned, "collection", None)
    target = collection if collection is not None else laned
    orig = target.update
    remaining = {"n": fail_n}

    def should_fail(lane_ids: Any) -> bool:
        lane = laned.sessions.get(session_id)
        if lane is None or lane not in np.asarray(lane_ids).reshape(-1):
            return False
        if remaining["n"] is not None:
            if remaining["n"] <= 0:
                return False
            remaining["n"] -= 1
        return True

    def failing(lane_ids: Any, *args: Any, **kwargs: Any) -> Any:
        hit = should_fail(lane_ids)
        out = orig(lane_ids, *args, **kwargs)
        if hit:
            raise exc if exc is not None else LaneFaultError(
                f"injected lane dispatch failure for session {session_id!r}",
                session_id=session_id,
                where="dispatch",
            )
        return out

    target.__dict__["update"] = failing
    try:
        yield
    finally:
        target.__dict__.pop("update", None)


# -------------------------------------------------------------------- world

# ------------------------------------------------------------- window clocks

def skew_clock(laned: Any, lane: int, by: int = 1) -> int:
    """Run ONE lane's window clock ``by`` windows AHEAD of the others: the
    per-session event-time drift scenario (a session whose stream runs fast
    closes its windows early). The skew is real ring state (the lane's
    retiring slots return to their defaults), so it is deliberately not
    undone. Returns the lane's new clock."""
    laned.advance_lane_windows(int(lane), int(by))
    return int(laned._window_clocks()[int(lane)])


def late_event(laned: Any, session_id: Any, batch: Any, age: int = 1) -> int:
    """Deliver ``batch`` for ``session_id`` stamped ``age`` windows behind
    the session's CURRENT lane clock: the watermark's fault primitive.
    Within the lateness bound the event must land in its still-open ring
    slot; beyond it the watermark must drop it with a ``window_late_drop``
    breadcrumb and count ``windows.dropped_late``. Returns the number of
    rounds dispatched (0: dropped)."""
    lane = laned._router_admit(session_id)
    clock = int(laned._window_clocks()[lane])
    k = clock - int(age)
    if k < 0:
        raise ValueError(f"cannot inject an event {age} windows late: lane clock is only {clock}")
    return laned.update_sessions({session_id: batch}, window=k)


@contextmanager
def _resized_world(to: int) -> Generator[Dict[str, Any], None, None]:
    """Shared body of :func:`shrink_world`/:func:`grow_world`: patch the
    checkpoint layer's world probe to report ``to`` devices; yields the
    world it reports."""
    from torchmetrics_tpu_torch.io import checkpoint as checkpoint_mod

    if to < 1:
        raise ValueError(f"a resized world holds at least one device, got {to}")
    orig = checkpoint_mod._world_topology

    def patched() -> Dict[str, Any]:
        out = dict(orig())
        out["device_count"] = int(to)
        return out

    checkpoint_mod._world_topology = patched
    try:
        yield patched()
    finally:
        checkpoint_mod._world_topology = orig


@contextmanager
def shrink_world(to: int) -> Generator[Dict[str, Any], None, None]:
    """Simulate a restart on a SMALLER world: snapshots saved (and restores
    attempted) inside the context see ``to`` devices, so a snapshot whose
    layout is bound to more hits ``restore_state``'s topology gate
    (:class:`~torchmetrics_tpu_torch.utils.exceptions.TopologyMismatchError`).
    Composes with :func:`preempt_after` and :func:`torn_write`."""
    with _resized_world(to) as world:
        yield world


@contextmanager
def grow_world(to: int) -> Generator[Dict[str, Any], None, None]:
    """Simulate a restart on a BIGGER world (the same seam as :func:`shrink_world`)."""
    with _resized_world(to) as world:
        yield world


# -------------------------------------------------------------------- reads

@contextmanager
def pause_async_reads(max_s: float = 30.0) -> Generator[threading.Event, None, None]:
    """Park the async read pipeline's worker (``ops/async_read.py``) on a
    barrier job, so every read submitted INSIDE the context stays in flight
    until the context exits (or ``max_s`` elapses, a safety valve so a
    crashed test cannot wedge the worker for the rest of the suite). Yields
    the release event; set it to unpark early."""
    from torchmetrics_tpu_torch.ops.async_read import get_pipeline

    release = threading.Event()

    def barrier() -> None:
        release.wait(max_s)

    get_pipeline().submit(barrier, owner="faults.pause_async_reads")
    try:
        yield release
    finally:
        release.set()


# -------------------------------------------------------------- checkpoints

def corrupt_state(state: Dict[str, Any], mode: str = "nan", field: Optional[str] = None, seed: int = 0) -> Dict[str, Any]:
    """A damaged copy of a state dict, the way a torn or bit-flipped resume
    checkpoint presents. The input is never modified.

    Modes (``field`` picks the victim; default: the first eligible tensor):

    - ``"shape"``: the field gains a bogus leading dim.
    - ``"dtype"``: the field is cast float <-> int.
    - ``"structure"``: the field's key is deleted.
    - ``"nan"``: a random entry of a float field becomes NaN.
    """
    if mode not in ("shape", "dtype", "structure", "nan"):
        raise ValueError(f"mode must be one of shape/dtype/structure/nan, got {mode!r}")
    out = {k: (list(v) if isinstance(v, list) else v) for k, v in state.items()}
    candidates = [k for k, v in state.items() if isinstance(v, torch.Tensor) and k != "_update_count"]
    if mode == "nan":
        candidates = [k for k in candidates if state[k].is_floating_point()]
    if field is not None:
        if field not in state:
            raise KeyError(f"field {field!r} not in state")
        candidates = [field]
    if not candidates:
        raise ValueError(f"state has no tensor field eligible for mode {mode!r}")
    victim = candidates[0]
    value = state[victim]
    if mode == "shape":
        out[victim] = torch.stack([value, value])
    elif mode == "dtype":
        out[victim] = value.to(torch.int32) if value.is_floating_point() else value.to(torch.float32)
    elif mode == "structure":
        del out[victim]
    else:
        flat = value.detach().clone().reshape(-1)
        flat[int(np.random.RandomState(seed).randint(0, flat.numel()))] = float("nan")
        out[victim] = flat.reshape(value.shape)
    return out


def torn_write(path: Any, mode: str = "truncate", frac: float = 0.5, seed: int = 0) -> None:
    """Damage a snapshot FILE in place, the way storage failures present:

    - ``"truncate"`` (default): keep only the first ``frac`` of the bytes (a
      crash mid-write that somehow reached the final name, e.g. a copied
      partial file);
    - ``"zero"``: overwrite the last ``1 - frac`` of the bytes with zeros,
      same length (storage that acknowledged before persisting);
    - ``"flip"``: flip one random byte (media bit rot, caught by the
      per-leaf sha256).

    Deterministic in ``seed``. ``restore_state`` must detect the damage
    (typed ``CheckpointCorruptionError``), never install it.
    """
    path = os.fspath(path)
    if mode not in ("truncate", "zero", "flip"):
        raise ValueError(f"mode must be truncate/zero/flip, got {mode!r}")
    if not 0 <= frac < 1:
        raise ValueError(f"frac must be in [0, 1), got {frac}")
    with open(path, "rb") as fh:
        data = fh.read()
    if not data:
        raise ValueError(f"{path} is empty; nothing to tear")
    if mode == "truncate":
        damaged = data[: max(1, int(len(data) * frac))]
    elif mode == "zero":
        cut = max(1, int(len(data) * frac))
        damaged = data[:cut] + b"\x00" * (len(data) - cut)
    else:
        idx = np.random.RandomState(seed).randint(0, len(data))
        damaged = data[:idx] + bytes([data[idx] ^ 0xFF]) + data[idx + 1:]
    # deliberately NOT atomic: the damaged bytes stay under the real name,
    # as the failure would leave them
    with open(path, "wb") as fh:
        fh.write(damaged)


@contextmanager
def preempt_after(metric: Any, n_updates: int, exc: Optional[BaseException] = None) -> Generator[None, None, None]:
    """Simulate a preemption arriving after the ``n_updates``-th COMMITTED
    top-level update/forward on ``metric`` (a ``Metric`` or
    ``MetricCollection``).

    The raise comes from the post-commit observer seam, so the state is
    consistent (exactly n updates applied), as for a signal delivered
    between steps. Raises :class:`PreemptionInjected`. Observers run in
    attach order: attach an Autosaver first if the last update should still
    be autosaved before the kill.
    """
    if n_updates < 1:
        raise ValueError(f"n_updates must be >= 1, got {n_updates}")
    error = exc if exc is not None else PreemptionInjected(f"injected preemption after update {n_updates}")
    seen = {"n": 0}

    def observer(_obj: Any) -> None:
        seen["n"] += 1
        if seen["n"] == n_updates:
            raise error

    detach = metric.add_update_observer(observer)
    try:
        yield
    finally:
        detach()


# -------------------------------------------------------- silent corruption

#: bit counts up to which positions come from numpy's ``choice`` without
#: replacement, the JAX package's draw, which permutes every position; past
#: it (a leaf above 32 MB) distinct ``randint`` draws from the same seed
_PERMUTATION_BITS = 1 << 28


def _bit_positions(total: int, n_bits: int, seed: int) -> np.ndarray:
    """``min(n_bits, total)`` distinct flat bit positions out of ``total``,
    deterministic in ``seed``: the JAX package's positions (``_flip_bits_host``)
    up to :data:`_PERMUTATION_BITS`."""
    rng = np.random.RandomState(seed)
    size = min(int(n_bits), total)
    if total <= _PERMUTATION_BITS:
        return rng.choice(total, size=size, replace=False)
    picked: list = []
    while len(picked) < size:
        pos = int(rng.randint(0, total, dtype=np.int64))
        if pos not in picked:
            picked.append(pos)
    return np.asarray(picked, dtype=np.int64)


def _flip_bits_host(arr: np.ndarray, n_bits: int, seed: int) -> tuple:
    """Flip ``n_bits`` distinct random bits of ``arr``'s raw bytes; returns
    the damaged copy and the flat bit positions hit (the JAX package's
    ``_flip_bits_host`` bit for bit)."""
    out = np.array(arr)
    raw = out.reshape(-1).view(np.uint8)
    if raw.size == 0:
        raise ValueError("cannot flip bits of an empty array")
    positions = _bit_positions(raw.size * 8, n_bits, seed)
    for pos in positions:
        raw[pos // 8] ^= np.uint8(1 << (pos % 8))
    return out, [int(p) for p in positions]


def _flip_tensor_bits_(t: torch.Tensor, n_bits: int, seed: int) -> list:
    """Flip ``n_bits`` distinct bits of a contiguous tensor IN PLACE, through
    a byte view on its own device (the positions of :func:`_flip_bits_host`
    for the same bytes); returns the flat bit positions hit."""
    if not t.is_contiguous():
        raise ValueError("cannot flip bits of a non-contiguous tensor in place")
    raw = t.view(-1).view(torch.uint8) if t.numel() else t.new_empty(0, dtype=torch.uint8)
    if raw.numel() == 0:
        raise ValueError("cannot flip bits of an empty array")
    positions = _bit_positions(raw.numel() * 8, n_bits, seed)
    masks: Dict[int, int] = {}
    for pos in positions:
        byte = int(pos) // 8
        masks[byte] = masks.get(byte, 0) ^ (1 << (int(pos) % 8))
    idx = torch.tensor(sorted(masks), dtype=torch.int64, device=t.device)
    mask = torch.tensor([masks[b] for b in sorted(masks)], dtype=torch.uint8, device=t.device)
    raw.index_put_((idx,), torch.bitwise_xor(raw.index_select(0, idx), mask))
    return [int(p) for p in positions]


def _leaves(tree: Any) -> list:
    """The leaves of a state tree in the JAX package's flattening order
    (``integrity._walk``: sorted dict keys, sequence positions)."""
    from torchmetrics_tpu_torch.integrity import _walk

    out: list = []
    _walk(tree, "", out)
    return [leaf for _, leaf in out]


def _replace_leaf(tree: Any, index: int, new: Any) -> Any:
    """A copy of ``tree`` (dicts, lists and tuples rebuilt) with its
    ``index``-th leaf, in :func:`_leaves`' order, replaced by ``new``."""
    counter = [0]

    def rebuild(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            rebuilt = {key: rebuild(node[key]) for key in sorted(node)}
            return {k: rebuilt[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rebuild(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(el) for el in node)
        i = counter[0]
        counter[0] += 1
        return new if i == index else node

    return rebuild(tree)


def flip_state_bits(target: Any, field: Optional[str] = None, n_bits: int = 1, seed: int = 0) -> Any:
    """Silent data corruption: flip ``n_bits`` random bits of one state
    leaf's raw bytes, the faulty-core or DMA-corruption signature the
    integrity layer (``integrity.py``) exists to catch. No shape, dtype or
    NaN tell: only the bits change. Deterministic in ``seed``, with the JAX
    package's flat bit positions.

    ``target`` is either a live ``Metric`` (the victim tensor's bits are
    flipped IN PLACE, on its device, through a byte view, so every alias of
    it, a compute group's followers included, sees the flip; returns an info
    dict with the victim ``field`` and the flat ``bits`` hit) or a plain
    state tree, e.g. a deferred loop's carried states (never modified;
    returns ``(flipped_copy, info)``). ``field`` picks the victim leaf of a
    Metric (default: the first tensor field); a tree flips its first array
    leaf in the JAX package's flattening order.
    """
    if hasattr(target, "_state") and isinstance(getattr(target, "_state"), dict):
        state = target._state
        candidates = [
            k for k, v in state.items()
            if not isinstance(v, (list, tuple)) and hasattr(v, "dtype") and k != "_update_count"
        ]
        if field is not None:
            if field not in state:
                raise KeyError(f"field {field!r} not in state")
            candidates = [field]
        if not candidates:
            raise ValueError("metric state has no array field to corrupt")
        victim = candidates[0]
        bits = _flip_tensor_bits_(state[victim], n_bits, seed)
        target.__dict__["_computed"] = None  # a cached read would mask the flip
        return {"field": victim, "bits": bits}

    leaves = _leaves(target)
    idx = next((i for i, leaf in enumerate(leaves) if hasattr(leaf, "dtype") and hasattr(leaf, "shape")), None)
    if idx is None:
        raise ValueError("tree has no array leaf to corrupt")
    value = leaves[idx]
    if isinstance(value, torch.Tensor):
        flipped = value.detach().clone().contiguous()
        bits = _flip_tensor_bits_(flipped, n_bits, seed)
    else:
        flipped, bits = _flip_bits_host(np.asarray(value), n_bits, seed)
    return _replace_leaf(target, idx, flipped), {"leaf_index": idx, "bits": bits}


def skew_replica(states: Any, shard: int = 0, n_bits: int = 1, seed: int = 0) -> tuple:
    """Replica drift: flip ``n_bits`` bits in exactly ONE shard row of the
    first stacked array leaf of ``states`` (a deferred loop's carried tree);
    every other shard keeps the true bits, as one drifting device presents.
    The per-shard fingerprint audit must name this shard. Returns
    ``(skewed_copy, info)``; the input is never modified."""
    leaves = _leaves(states)
    idx = next(
        (
            i for i, leaf in enumerate(leaves)
            if hasattr(leaf, "dtype") and len(getattr(leaf, "shape", ())) >= 1 and leaf.shape[0] > shard
        ),
        None,
    )
    if idx is None:
        raise ValueError(f"states has no stacked array leaf with a shard {shard}")
    value = leaves[idx]
    if isinstance(value, torch.Tensor):
        skewed = value.detach().clone().contiguous()
        bits = _flip_tensor_bits_(skewed[shard], n_bits, seed)
    else:
        skewed = np.array(value)
        skewed[shard], bits = _flip_bits_host(skewed[shard], n_bits, seed)
    return _replace_leaf(states, idx, skewed), {"leaf_index": idx, "shard": int(shard), "bits": bits}


# -------------------------------------------------------------- fleet uplink

@contextmanager
def corrupt_delta_payload(leaf: Any, n: int = 1, seed: int = 0) -> Generator[Dict[str, int], None, None]:
    """Corrupt the first ``n`` of ``leaf``'s deltas IN FLIGHT at the
    ``Uplink.transmit`` seam: a bit flips in the payload after the exporter
    stamped its checksum (``fleet/delta.py`` ``payload_checksum``), as a
    relay or serialisation fault presents. The receiving ledger must
    hash-mismatch, drop without merging, quarantine the leaf and heal through
    the full resync it asks for. The sender's outbox copy is never touched.
    Yields counters (``corrupted``)."""
    import copy
    import dataclasses

    from torchmetrics_tpu_torch.fleet import transport as transport_mod

    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    orig = transport_mod.Uplink.transmit
    counters = {"corrupted": 0}
    rng = np.random.RandomState(seed)

    def damaged(payload: Any) -> Any:
        out = copy.deepcopy(payload)

        def walk(value: Any) -> bool:
            if isinstance(value, dict):
                return any(walk(v) for v in value.values())
            if isinstance(value, (list, tuple)):
                return any(walk(v) for v in value)
            if isinstance(value, np.ndarray) and value.size:
                raw = value.reshape(-1).view(np.uint8)
                pos = int(rng.randint(0, raw.size * 8))
                raw[pos // 8] ^= np.uint8(1 << (pos % 8))
                return True
            return False

        if not walk(out):
            raise ValueError(f"delta payload for {leaf!r} has no array to corrupt")
        return out

    def patched(self: Any, node_id: str, delta: Any) -> Any:
        if delta.leaf == leaf and counters["corrupted"] < n:
            counters["corrupted"] += 1
            delta = dataclasses.replace(delta, payload=damaged(delta.payload))
        return orig(self, node_id, delta)

    transport_mod.Uplink.transmit = patched
    try:
        yield counters
    finally:
        transport_mod.Uplink.transmit = orig


@contextmanager
def drop_delta(leaf: Any, n: int = 1) -> Generator[Dict[str, int], None, None]:
    """Lose the first ``n`` delivery ATTEMPTS of ``leaf``'s deltas at the
    ``Uplink.transmit`` seam (each retry consumes one: ``n`` past the retry
    budget fails a whole ``send`` and the outbox keeps the delta). The
    exactly-once ledger plus the outbox re-ship must converge bit for bit.
    Yields counters (``dropped``)."""
    from torchmetrics_tpu_torch.fleet import transport as transport_mod

    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    orig = transport_mod.Uplink.transmit
    counters = {"dropped": 0}

    def patched(self: Any, node_id: str, delta: Any) -> Any:
        if delta.leaf == leaf and counters["dropped"] < n:
            counters["dropped"] += 1
            raise ConnectionError(f"injected drop of {leaf!r} epoch {delta.epoch}")
        return orig(self, node_id, delta)

    transport_mod.Uplink.transmit = patched
    try:
        yield counters
    finally:
        transport_mod.Uplink.transmit = orig


@contextmanager
def duplicate_delta(leaf: Any) -> Generator[Dict[str, int], None, None]:
    """Deliver every one of ``leaf``'s deltas TWICE (an ack lost on the way
    back causes a re-send of an applied epoch). The ledger must drop the
    duplicate idempotently. Yields counters (``duplicated``)."""
    from torchmetrics_tpu_torch.fleet import transport as transport_mod

    orig = transport_mod.Uplink.transmit
    counters = {"duplicated": 0}

    def patched(self: Any, node_id: str, delta: Any) -> Any:
        ack = orig(self, node_id, delta)
        if delta.leaf == leaf:
            counters["duplicated"] += 1
            orig(self, node_id, delta)  # second delivery; its ack is discarded
        return ack

    transport_mod.Uplink.transmit = patched
    try:
        yield counters
    finally:
        transport_mod.Uplink.transmit = orig


@contextmanager
def delay_delta(leaf: Any, epochs: int = 2) -> Generator[Dict[str, Any], None, None]:
    """Hold ``leaf``'s NEXT delta back and inject it only after ``epochs``
    later deliveries from that leaf went through: a genuine reorder at the
    ledger (the successors wait in the pending buffer until the gap fills).
    The hold answers with a synthetic ack (``durable_epoch=0``, so the outbox
    keeps everything), as a transport that took the bytes and sat on them.
    Yields counters (``held_epoch``, ``delivered_late``)."""
    from torchmetrics_tpu_torch.fleet import transport as transport_mod

    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    orig = transport_mod.Uplink.transmit
    held: Dict[str, Any] = {"delta": None, "node": None, "later": 0}
    counters: Dict[str, Any] = {"held_epoch": None, "delivered_late": False}

    def synthetic(node_id: str, delta: Any) -> Dict[str, Any]:
        return {"leaf": delta.leaf, "applied_epoch": delta.epoch, "durable_epoch": 0, "needs_full": False, "node": node_id}

    def patched(self: Any, node_id: str, delta: Any) -> Any:
        if delta.leaf != leaf or counters["delivered_late"]:
            return orig(self, node_id, delta)
        if held["delta"] is None:
            held["delta"], held["node"] = delta, node_id
            counters["held_epoch"] = delta.epoch
            return synthetic(node_id, delta)
        if delta.epoch == held["delta"].epoch:
            return synthetic(node_id, delta)  # a re-ship of the held epoch: keep holding
        ack = orig(self, node_id, delta)
        held["later"] += 1
        if held["later"] >= epochs:
            orig(self, held["node"], held["delta"])  # the late, out-of-order arrival
            counters["delivered_late"] = True
        return ack

    transport_mod.Uplink.transmit = patched
    try:
        yield counters
    finally:
        transport_mod.Uplink.transmit = orig


@contextmanager
def partition_leaf(leaf: Any, epochs: int = 3) -> Generator[Dict[str, Any], None, None]:
    """Black-hole every delivery from ``leaf`` until ``epochs`` DISTINCT
    epochs have tried the uplink: the network-partition signature (the leaf
    keeps exporting into its outbox, possibly tripping its breaker, then
    rejoins and re-ships the backlog in order). Partitions within the
    watermark converge by replay, longer ones through quarantine and the
    ``needs_full`` resync. Yields counters (``dropped_epochs``)."""
    from torchmetrics_tpu_torch.fleet import transport as transport_mod

    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    orig = transport_mod.Uplink.transmit
    seen: set = set()
    counters: Dict[str, Any] = {"dropped_epochs": seen}

    def patched(self: Any, node_id: str, delta: Any) -> Any:
        if delta.leaf == leaf and len(seen) < epochs:
            seen.add(delta.epoch)
            raise ConnectionError(f"injected partition of {leaf!r} (epoch {delta.epoch})")
        return orig(self, node_id, delta)

    transport_mod.Uplink.transmit = patched
    try:
        yield counters
    finally:
        transport_mod.Uplink.transmit = orig


@contextmanager
def kill_aggregator(aggregator: Any) -> Generator[None, None, None]:
    """Take an aggregator down for the context: every ``receive`` raises
    ``ConnectionError`` (the transport failure the uplink retries, breakers
    on and outboxes absorb). Revives on exit; call ``Fleet.failover`` INSIDE
    the context to drive the successor path instead."""
    aggregator.kill()
    try:
        yield
    finally:
        aggregator.revive()
