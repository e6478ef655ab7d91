"""Per-session blast-radius containment for session lanes, and degraded reads.

One laned round advances thousands of sessions' states together; this
module makes failure containment match that granularity, so the unit of
failure is the LANE, not the round:

- :class:`LaneGuard`: the host-side quarantine registry. A per-session fault
  log with a sliding-window circuit breaker (K faults in W rounds escalate to
  eviction), ``on_lane_fault`` policy resolution (``"raise"``,
  ``"quarantine"``, ``"reset"``, ``"evict"``), clean-probe re-admission, the
  per-session last-good cache behind degraded reads, and a JSON round trip
  so quarantine state rides the checkpoint (a restore re-arms the breakers).
- :class:`DegradedValue`: what a degraded read serves, the last-good value
  plus staleness metadata. Also returned by ``Metric.compute()`` under
  ``on_sync_failure="last_good"`` when the cross-process reduce fails.
- :class:`LaneStateMirror`: an incremental host mirror of a stacked lane
  state, folded forward with only the rows the previous round touched (one
  device gather and one copy to the host of those rows).
- Admission screening helpers (:func:`row_spec_majority`,
  :func:`screen_row`, :func:`screen_slab_leaf`): per-row shape, dtype-kind
  and finiteness checks over host numpy rows, backing the router's screen at
  the pack, so a malformed or NaN row is diverted instead of dispatched.

The names, policies, counters (``lanes.*``), breadcrumbs and the JSON layout
are the JAX package's (``torchmetrics_tpu/quarantine.py``), so a quarantine
blob either package writes restores in the other. Everything here is host
bookkeeping; the device side (the row screen fused into the laned update,
``lane_health``) lives in ``lanes.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

__all__ = [
    "DegradedValue",
    "LANE_FAULT_POLICIES",
    "LaneGuard",
    "LaneStateMirror",
    "row_spec_majority",
    "screen_row",
    "screen_slab_leaf",
]

#: valid ``on_lane_fault`` policies (``None`` disables the guard entirely:
#: the behaviour without containment)
LANE_FAULT_POLICIES = (None, "raise", "quarantine", "reset", "evict")


class DegradedValue(NamedTuple):
    """A degraded read: the last-good value plus staleness metadata.

    ``value`` is the most recent healthy result; ``updates_behind`` counts
    the updates offered to the owner since the value was captured (how stale
    it is); ``age_updates`` is the owner's update count at capture (how much
    data the value reflects). ``coverage`` and ``staleness`` are kept for the
    shape of the JAX package's fleet-scope reads and stay None here.
    """

    value: Any
    updates_behind: int
    age_updates: int
    coverage: Optional[float] = None
    staleness: Optional[Dict[str, Any]] = None


def _encode_sid(sid: Any) -> List[Any]:
    """Tag a session id for the JSON round trip (as ``LaneTable.to_json``)."""
    if isinstance(sid, str):
        return ["s", sid]
    if isinstance(sid, bool):
        return ["b", int(sid)]
    if isinstance(sid, int):
        return ["i", sid]
    return ["r", repr(sid)]


def _decode_sid(tagged: Sequence[Any]) -> Any:
    kind, sid = tagged
    if kind == "i":
        return int(sid)
    if kind == "b":
        return bool(sid)
    return sid


class LaneGuard:
    """Host-side lane fault registry: policy, breaker, probes, last-good cache.

    One guard serves one laned object (a ``LanedMetric``, or, shared, every
    member of a ``LanedCollection``, the way members share one ``LaneTable``).
    It never touches device state: the owning router reports faults, diverted
    rows and clean probes in, and reads policy actions and degraded values
    out.

    Args:
        policy: ``on_lane_fault``: ``None`` (guard inactive), ``"raise"`` (a
            lane fault raises ``LaneFaultError``), ``"quarantine"`` (divert
            the session, serve last-good reads, probe it back in),
            ``"reset"`` (zero the lane, keep serving) or ``"evict"`` (drop the
            session outright).
        breaker_threshold: K, the faults within the sliding window that trip
            the per-session circuit breaker (escalating quarantine or reset to
            evict).
        breaker_window: W, the sliding window, in router rounds.
        unquarantine_after: N clean probes that re-admit a quarantined
            session. A probe is a committed clean update.
        screen: host admission screening (per-row shape, dtype-kind and
            finiteness over the stacked round before dispatch); default on.

    Example:
        >>> from torchmetrics_tpu_torch.quarantine import LaneGuard
        >>> guard = LaneGuard(policy="quarantine", breaker_threshold=2)
        >>> _ = guard.begin_round()
        >>> guard.record_fault("a", "admission", "leaf 0 carries non-finite values")
        'quarantine'
        >>> _ = guard.begin_round()
        >>> guard.record_fault("a", "admission", "again")
        'evict'
    """

    def __init__(
        self,
        policy: Optional[str] = None,
        breaker_threshold: int = 3,
        breaker_window: int = 32,
        unquarantine_after: int = 2,
        screen: Optional[bool] = None,
    ) -> None:
        if policy not in LANE_FAULT_POLICIES:
            raise ValueError(f"on_lane_fault must be one of {LANE_FAULT_POLICIES}, got {policy!r}")
        if int(breaker_threshold) < 1:
            raise ValueError(f"breaker_threshold must be >= 1, got {breaker_threshold}")
        if int(breaker_window) < 1:
            raise ValueError(f"breaker_window must be >= 1, got {breaker_window}")
        if int(unquarantine_after) < 1:
            raise ValueError(f"unquarantine_after must be >= 1, got {unquarantine_after}")
        self.policy = policy
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_window = int(breaker_window)
        self.unquarantine_after = int(unquarantine_after)
        self.screen = bool(screen) if screen is not None else True
        self.round = 0
        self.fault_rounds: Dict[Any, List[int]] = {}
        self.fault_total: Dict[Any, int] = {}
        self.last_fault: Dict[Any, Dict[str, Any]] = {}
        self.quarantined: Dict[Any, Dict[str, Any]] = {}
        self.diverted: Dict[Any, int] = {}
        self.last_good: Dict[Any, Dict[str, Any]] = {}
        self.stats: Dict[str, int] = {
            "faults": 0,
            "quarantines": 0,
            "unquarantines": 0,
            "breaker_trips": 0,
            "diverted_rows": 0,
            "degraded_reads": 0,
        }

    # --------------------------------------------------------------- plumbing
    @property
    def active(self) -> bool:
        return self.policy is not None

    def begin_round(self) -> int:
        self.round += 1
        return self.round

    def note_diverted(self, session_id: Any, rows: int = 1) -> None:
        """A router-diverted row, counted per session so degraded-read
        staleness includes traffic the session offered but never dispatched.
        The healthy path keeps no per-row host bookkeeping (committed counts
        come from the ``lane_updates``/``lane_health`` states at read points)."""
        self.diverted[session_id] = self.diverted.get(session_id, 0) + int(rows)
        self.stats["diverted_rows"] += int(rows)
        obs.counter_inc("lanes.diverted_rows", int(rows))

    # ----------------------------------------------------------------- faults
    def record_fault(self, session_id: Any, where: str, reason: str) -> str:
        """Log a fault against ``session_id`` and resolve the action to take:
        the configured policy, escalated to ``"evict"`` when the breaker trips
        (``breaker_threshold`` faults within the last ``breaker_window``
        rounds). A fault during probation also resets the clean-probe count."""
        prev = self.last_fault.get(session_id)
        window = self.fault_rounds.setdefault(session_id, [])
        # two collection members attributing the SAME event (one poisoned
        # round seen by each member's health scan) count as one fault
        if not (prev is not None and prev["round"] == self.round and prev["where"] == where):
            self.stats["faults"] += 1
            obs.counter_inc("lanes.faults")
            self.fault_total[session_id] = self.fault_total.get(session_id, 0) + 1
            window.append(self.round)
        cutoff = self.round - self.breaker_window
        while window and window[0] <= cutoff:
            window.pop(0)
        self.last_fault[session_id] = {"round": self.round, "where": where, "reason": reason}
        obs.fault_breadcrumb(
            "lane_fault",
            domain="lanes",
            data={"session": repr(session_id), "where": where, "reason": reason, "round": self.round},
        )
        probation = self.quarantined.get(session_id)
        if probation is not None:
            probation["clean_probes"] = 0
        action = self.policy or "raise"
        if action in ("quarantine", "reset") and len(window) >= self.breaker_threshold:
            action = "evict"
            self.stats["breaker_trips"] += 1
            obs.counter_inc("lanes.breaker_trips")
            obs.fault_breadcrumb(
                "lane_breaker_trip",
                domain="lanes",
                data={"session": repr(session_id), "faults_in_window": len(window), "round": self.round},
            )
        return action

    def breaker_state(self, session_id: Any) -> str:
        """``"open"`` (tripped this window), ``"probation"`` (quarantined),
        or ``"closed"``."""
        window = [r for r in self.fault_rounds.get(session_id, []) if r > self.round - self.breaker_window]
        if len(window) >= self.breaker_threshold:
            return "open"
        if session_id in self.quarantined:
            return "probation"
        return "closed"

    # ------------------------------------------------------------- quarantine
    def is_quarantined(self, session_id: Any) -> bool:
        return session_id in self.quarantined

    def quarantine(self, session_id: Any) -> None:
        if session_id in self.quarantined:
            return
        self.quarantined[session_id] = {"since_round": self.round, "clean_probes": 0}
        self.stats["quarantines"] += 1
        obs.counter_inc("lanes.quarantined")
        obs.gauge_set("lanes.quarantine", len(self.quarantined))

    def unquarantine(self, session_id: Any) -> None:
        if self.quarantined.pop(session_id, None) is not None:
            self.stats["unquarantines"] += 1
            obs.counter_inc("lanes.unquarantined")
            obs.gauge_set("lanes.quarantine", len(self.quarantined))

    def probe_progress(self, session_id: Any, committed_now: int, faulted: bool) -> bool:
        """Advance a quarantined session's probation from the lane's commit
        counter: every committed update since the last scan with no new fault
        is one clean probe. A new fault resets the probe count. Returns True
        when the session is (now) out of quarantine."""
        rec = self.quarantined.get(session_id)
        if rec is None:
            return True
        committed_now = int(committed_now)
        anchor = rec.setdefault("anchor_committed", committed_now)
        if faulted:
            rec["clean_probes"] = 0
            rec["anchor_committed"] = committed_now
            return False
        if committed_now > anchor:
            rec["clean_probes"] += committed_now - anchor
            rec["anchor_committed"] = committed_now
        if rec["clean_probes"] >= self.unquarantine_after:
            self.unquarantine(session_id)
            return True
        return False

    def forget(self, session_id: Any) -> None:
        """Drop every record of ``session_id`` (it was evicted)."""
        for store in (
            self.fault_rounds,
            self.fault_total,
            self.last_fault,
            self.quarantined,
            self.diverted,
            self.last_good,
        ):
            store.pop(session_id, None)
        obs.gauge_set("lanes.quarantine", len(self.quarantined))

    # ---------------------------------------------------------- degraded reads
    def capture_last_good(
        self,
        session_id: Any,
        value: Any,
        committed: int,
        health: int = 0,
        slot: str = "",
    ) -> None:
        """Cache ``value`` as the session's last-good read, anchored on the
        lane's counters at capture: ``committed`` (``lane_updates``) and
        ``health`` (``lane_health``), plus the router's diverted count.
        ``slot`` namespaces the cache so collection members sharing one guard
        keep distinct values per metric."""
        self.last_good.setdefault(session_id, {})[slot] = {
            "value": value,
            "committed": int(committed),
            "health": int(health),
            "diverted": self.diverted.get(session_id, 0),
            "round": self.round,
        }

    def has_last_good(self, session_id: Any, slot: str = "") -> bool:
        return slot in self.last_good.get(session_id, {})

    def staleness(
        self, session_id: Any, committed_now: int, health_now: int = 0, slot: str = ""
    ) -> Optional[Tuple[int, int]]:
        """``(updates_behind, age_updates)`` of the cached value against the
        lane's current counters, or None without a cache entry."""
        rec = self.last_good.get(session_id, {}).get(slot)
        if rec is None:
            return None
        behind = (
            max(0, int(committed_now) - rec["committed"])
            + max(0, int(health_now) - rec["health"])
            + max(0, self.diverted.get(session_id, 0) - rec["diverted"])
        )
        return behind, rec["committed"]

    def degraded(
        self, session_id: Any, committed_now: int, health_now: int = 0, slot: str = ""
    ) -> Optional[DegradedValue]:
        """The degraded read for ``session_id``, or None when no last-good
        value has been captured yet."""
        rec = self.last_good.get(session_id, {}).get(slot)
        staleness = self.staleness(session_id, committed_now, health_now, slot)
        if rec is None or staleness is None:
            return None
        self.stats["degraded_reads"] += 1
        obs.counter_inc("lanes.degraded_reads")
        obs.histogram_observe("reads.staleness_age_updates", staleness[0])
        return DegradedValue(value=rec["value"], updates_behind=staleness[0], age_updates=staleness[1])

    # ------------------------------------------------------------ diagnostics
    def table(self, lane_of: Optional[Dict[Any, int]] = None) -> List[Dict[str, Any]]:
        """The quarantine table: one row per session the guard has ever
        faulted, quarantined, or cached a value for (sessions with no history
        are omitted)."""
        sids = set(self.fault_total) | set(self.quarantined) | set(self.last_good)
        rows = []
        for sid in sids:
            slots = self.last_good.get(sid, {})
            # the age summary reports the FRESHEST cached slot: the best value
            # a degraded read could currently serve
            age = max((rec["committed"] for rec in slots.values()), default=None)
            rows.append(
                {
                    "session": sid,
                    "lane": (lane_of or {}).get(sid),
                    "faults": self.fault_total.get(sid, 0),
                    "last_fault": self.last_fault.get(sid),
                    "breaker": self.breaker_state(sid),
                    "quarantined": sid in self.quarantined,
                    "clean_probes": self.quarantined.get(sid, {}).get("clean_probes"),
                    "diverted_rows": self.diverted.get(sid, 0),
                    "last_good_age_updates": age,
                }
            )
        rows.sort(key=lambda r: (-int(r["quarantined"]), -r["faults"], repr(r["session"])))
        return rows

    # ---------------------------------------------------------- serialisation
    def to_json(self) -> Dict[str, Any]:
        """JSON state the checkpoint carries: the round clock, per-session
        fault windows and totals and quarantine records, so a restore re-arms
        breakers exactly. Last-good values are process-local tensors and are
        not serialised: a restored process re-caches on its first healthy
        read."""
        sessions = []
        sids = set(self.fault_total) | set(self.quarantined) | set(self.diverted)
        for sid in sids:
            sessions.append(
                [
                    _encode_sid(sid),
                    {
                        "faults": self.fault_total.get(sid, 0),
                        "window": list(self.fault_rounds.get(sid, [])),
                        "last_fault": self.last_fault.get(sid),
                        "quarantined": self.quarantined.get(sid),
                        "diverted": self.diverted.get(sid, 0),
                    },
                ]
            )
        return {"guard_version": 1, "round": self.round, "sessions": sessions}

    def load_json(self, payload: Dict[str, Any], known_sessions: Optional[set] = None) -> None:
        """Re-arm from a checkpointed :meth:`to_json` payload. The policy and
        thresholds stay as constructed; records for sessions absent from
        ``known_sessions`` (the restored directory) are dropped, since a
        quarantine entry for a lane the snapshot does not hold would pin a
        ghost session forever."""
        self.round = int(payload.get("round", 0))
        self.fault_rounds.clear()
        self.fault_total.clear()
        self.last_fault.clear()
        self.quarantined.clear()
        self.diverted.clear()
        self.last_good.clear()
        for tagged, rec in payload.get("sessions", []):
            sid = _decode_sid(tagged)
            if known_sessions is not None and sid not in known_sessions:
                continue
            if rec.get("faults"):
                self.fault_total[sid] = int(rec["faults"])
            window = [int(r) for r in rec.get("window", [])]
            if window:
                self.fault_rounds[sid] = window
            if rec.get("last_fault") is not None:
                self.last_fault[sid] = dict(rec["last_fault"])
            if rec.get("quarantined") is not None:
                self.quarantined[sid] = dict(rec["quarantined"])
            if rec.get("diverted"):
                self.diverted[sid] = int(rec["diverted"])
        obs.gauge_set("lanes.quarantine", len(self.quarantined))


# ---------------------------------------------------------------------------
# admission screening helpers (host numpy rows)
# ---------------------------------------------------------------------------


def _kind(dtype: Any) -> str:
    return np.dtype(dtype).kind


def row_spec_majority(
    batches: Sequence[Tuple[Any, ...]], n_leaves: Optional[int] = None
) -> Optional[List[Tuple[Tuple[int, ...], str]]]:
    """The round's reference row layout by majority vote: per-leaf
    ``(shape, dtype-kind)`` agreed by most rows (leaf COUNT by majority
    first). Majority, not the first row, so one malformed session cannot
    redefine the round's shape and fault everyone else. None when no usable
    row exists. ``n_leaves`` skips the leaf-count vote when the caller
    already resolved it."""
    if n_leaves is None:
        counts: Dict[int, int] = {}
        for b in batches:
            counts[len(b)] = counts.get(len(b), 0) + 1
        if not counts:
            return None
        n_leaves = max(counts, key=lambda k: (counts[k], -k))
    elif not batches:
        return None
    votes: List[Dict[Tuple[Tuple[int, ...], str], int]] = [{} for _ in range(n_leaves)]
    for b in batches:
        if len(b) != n_leaves:
            continue
        try:
            for i, leaf in enumerate(b):
                arr = np.asarray(leaf)
                key = (tuple(arr.shape), _kind(arr.dtype))
                votes[i][key] = votes[i].get(key, 0) + 1
        except Exception as err:  # an un-arrayable leaf casts no vote; screen_row names it
            rank_zero_debug(f"row_spec_majority: row cast no vote ({type(err).__name__}: {err})")
            continue
    spec = []
    for leaf_votes in votes:
        if not leaf_votes:
            return None
        spec.append(max(leaf_votes, key=lambda k: leaf_votes[k]))
    return spec


def screen_row(
    batch: Tuple[Any, ...], spec: List[Tuple[Tuple[int, ...], str]], check_finite: bool = True
) -> Optional[str]:
    """Validate ONE session's row against the round spec; None when clean,
    else the rejection reason. Checks leaf count, per-leaf shape, dtype KIND
    (float against int against bool: exact-width drift is promotion, not
    corruption) and, for float leaves, finiteness."""
    if len(batch) != len(spec):
        return f"row has {len(batch)} leaves, round expects {len(spec)}"
    for i, (leaf, (shape, kind)) in enumerate(zip(batch, spec)):
        try:
            arr = np.asarray(leaf)
        except Exception as err:
            # the returned reason IS the record: it lands in the guard's fault
            # log and the lane_fault breadcrumb
            rank_zero_debug(f"screen_row: leaf {i} not array-like ({type(err).__name__}: {err})")
            return f"leaf {i} is not array-like ({type(err).__name__})"
        if tuple(arr.shape) != shape:
            return f"leaf {i} has shape {tuple(arr.shape)}, round expects {shape}"
        if _kind(arr.dtype) != kind:
            return f"leaf {i} has dtype kind {_kind(arr.dtype)!r}, round expects {kind!r}"
        if check_finite and _kind(arr.dtype) == "f" and not bool(np.isfinite(arr).all()):
            return f"leaf {i} carries non-finite values"
    return None


def screen_slab_leaf(stacked: np.ndarray, rows: int, leaf_idx: int, reasons: List[Optional[str]]) -> None:
    """The vectorised finite screen run directly against one staging-slab
    leaf (``ops/ingest.py``): ONE ``np.isfinite`` over the slab's live
    region, no per-row Python work. Shape and dtype conformance were proven
    by the in-place slab write, so finiteness is the only check left, and the
    rejection reasons match the inline screen verbatim."""
    if stacked.dtype.kind != "f":
        return
    finite = np.isfinite(stacked[:rows].reshape(rows, -1)).all(axis=1)
    if not finite.all():
        for i in np.flatnonzero(~finite):
            if reasons[i] is None:
                reasons[i] = f"leaf {leaf_idx} carries non-finite values"


# ---------------------------------------------------------------------------
# incremental recovery mirror
# ---------------------------------------------------------------------------


def _host_copy(value: Any) -> np.ndarray:
    """A fresh host array of one state leaf."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True).numpy()
    return np.array(value)


class _MirrorRecovery:
    """The recovery reference for one laned round: a view onto the owning
    :class:`LaneStateMirror`, whose contents equal the full pre-round state
    until the next snapshot folds it forward."""

    __slots__ = ("_mirror",)

    def __init__(self, mirror: "LaneStateMirror") -> None:
        self._mirror = mirror

    def as_state(self, device: Any = None) -> Dict[str, Any]:
        """The mirrored state as tensors on ``device`` (default the CPU). A
        restore means the round died, so the next snapshot rebuilds fully."""
        data = self._mirror._mirror or {}
        out = {k: torch.from_numpy(np.array(v)).to(device or "cpu") for k, v in data.items()}
        self._mirror._count = None
        self._mirror._pending = None
        return out

    def materialize(self) -> Optional[Dict[str, Any]]:
        """A detached host copy of the mirrored state (a host-to-host copy,
        no device sync); None when the mirror is cold."""
        data = self._mirror._mirror
        if data is None:
            return None
        return {k: np.array(v) for k, v in data.items()}


class LaneStateMirror:
    """Incremental host mirror of a stacked lane state.

    Invariant: right after :meth:`snapshot` returns, the mirror equals the
    metric's full state as of the PREVIOUS committed round, the exact
    pre-round state of the round about to run. It gets there incrementally:
    each snapshot folds in only the rows the previous round touched (their
    post-commit values, read through one device gather and one copy to the
    host), so the per-round host cost is O(rows x state), not
    O(capacity x state).

    A full rebuild (one capacity-sized copy) happens only when the
    incremental chain is provably broken: first use, a commit that bypassed
    the snapshot (detected by the update counter), or a layout change
    (growth or restore, detected by shape).
    """

    def __init__(self) -> None:
        self._mirror: Optional[Dict[str, np.ndarray]] = None
        self._pending: Optional[np.ndarray] = None  # lanes touched by the last snapshot's round
        self._count: Optional[int] = None  # update_count at the last snapshot
        self.stats = {"rebuilds": 0, "incremental": 0}

    def invalidate(self) -> None:
        self._mirror = None
        self._pending = None
        self._count = None

    def _chain_intact(self, state: Dict[str, Any], update_count: int) -> bool:
        if self._mirror is None or self._count is None:
            return False
        if update_count != self._count + 1:
            return False  # a commit happened without a snapshot: the mirror is stale
        for k, v in state.items():
            ref = self._mirror.get(k)
            if ref is None or tuple(ref.shape) != tuple(v.shape) or ref.dtype != _host_dtype(v):
                return False
        return True

    def snapshot(
        self,
        state: Dict[str, Any],
        lane_ids: Any,
        update_count: int,
        capacity: int,
        known_rows: Optional[Tuple[Any, Dict[str, np.ndarray]]] = None,
    ) -> _MirrorRecovery:
        """Bring the mirror up to the pre-round state and register this
        round's touched lanes for the next fold. ``known_rows`` is
        ``(lanes, {field: rows})``, current rows the caller already holds on
        the host: pending lanes covered by it fold without a device fetch."""
        touched = np.asarray(lane_ids).reshape(-1)
        touched = np.unique(touched[(touched >= 0) & (touched < capacity)])
        if self._chain_intact(state, int(update_count)):
            pending = self._pending
            if pending is not None and pending.size:
                missing = pending
                if known_rows is not None:
                    known_lanes, known_vals = known_rows
                    known_lanes = np.asarray(known_lanes).reshape(-1)
                    if set(self._mirror) <= set(known_vals):
                        pos = {int(lane): i for i, lane in enumerate(known_lanes)}
                        hit = np.asarray([pos.get(int(lane), -1) for lane in pending])
                        covered = pending[hit >= 0]
                        if covered.size:
                            src = hit[hit >= 0]
                            for k in self._mirror:
                                self._mirror[k][covered] = _host_copy(known_vals[k])[src]
                        missing = pending[hit < 0]
                if missing.size:
                    for k, v in state.items():
                        idx = torch.as_tensor(missing, dtype=torch.int64, device=v.device)
                        self._mirror[k][missing] = _host_copy(v.index_select(0, idx))
            self.stats["incremental"] += 1
        else:
            self._mirror = {k: _host_copy(v) for k, v in state.items()}
            self.stats["rebuilds"] += 1
        self._pending = touched
        self._count = int(update_count)
        return _MirrorRecovery(self)

    def verify(self, state: Dict[str, Any], update_count: int) -> bool:
        """Bit-exact coherence audit of the mirror against the live state it
        claims to equal, valid while the update count still matches the last
        snapshot's. A diverged mirror is invalidated (the next snapshot pays
        one full rebuild instead of serving corrupt rollback rows) with a
        breadcrumb. Returns False on divergence. Blocking: call it from
        audits and read points, not the round loop."""
        if self._mirror is None or self._count != int(update_count):
            return True  # cold or out of phase: nothing coherent to audit
        from torchmetrics_tpu_torch.integrity import host_leaf_fingerprint

        bad = None
        for k, ref in self._mirror.items():
            live = state.get(k)
            if live is None or tuple(ref.shape) != tuple(live.shape):
                bad = k
                break
            if not np.array_equal(host_leaf_fingerprint(ref), host_leaf_fingerprint(_host_copy(live))):
                bad = k
                break
        if bad is None:
            return True
        self.invalidate()
        obs.counter_inc("integrity.mirror_rebuilds")
        obs.fault_breadcrumb(
            "mirror_divergence",
            domain="integrity",
            data={"mirror": "LaneStateMirror", "field": bad, "update_count": int(update_count)},
        )
        return False

    def rows(self, lanes: Sequence[int]) -> Optional[Dict[str, np.ndarray]]:
        """Pre-round rows for ``lanes`` (valid between :meth:`snapshot` and
        the next one), the lane-granular rollback source. None when cold."""
        if self._mirror is None:
            return None
        idx = np.asarray(list(lanes), dtype=np.int64)
        return {k: v[idx].copy() for k, v in self._mirror.items()}

    def patch_rows(self, lanes: Sequence[int], rows: Dict[str, Any]) -> None:
        """Fold an out-of-band lane-row mutation (a quarantine rollback) into
        the mirror so it keeps matching the live state without a full
        rebuild. No-op when cold; fields absent from ``rows`` invalidate."""
        if self._mirror is None:
            return
        if set(self._mirror) - set(rows):
            self.invalidate()
            return
        idx = np.asarray(list(lanes), dtype=np.int64)
        for k, v in self._mirror.items():
            v[idx] = _host_copy(rows[k])


def _host_dtype(value: Any) -> np.dtype:
    """The numpy dtype a host copy of ``value`` carries."""
    if isinstance(value, torch.Tensor):
        return torch.empty((), dtype=value.dtype).numpy().dtype
    return np.asarray(value).dtype
