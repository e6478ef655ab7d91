"""Runtime state-integrity auditing: bit-exact fingerprints over live state
(the port of the JAX package's ``integrity.py``).

Snapshots are checksummed at rest, but live device state, host recovery
mirrors and in-flight fleet deltas need their own coverage: a flipped bit
from a faulty core, an aliasing bug, or a replica that drifts after a reduce
would otherwise be served, snapshotted and shipped as truth. This module is
the detection layer.

Fingerprint contract
--------------------

A leaf fingerprint is two ``uint32`` words over the leaf's raw bits: every
element read as 32-bit words (1- and 2-byte dtypes zero-extend through
their unsigned view, 8-byte dtypes split into two words, ``bool`` is 0/1),
folded with XOR (word 0) and the wrapping sum mod 2**32 (word 1). Both
folds are order-insensitive, so the host (numpy) fold, the device fold and
the JAX package's fold agree bit for bit, shards fold independently, and
identical bits give identical fingerprints with no float tolerance while any
single flipped bit changes the XOR word.

On the card the fold of a whole state tree is ONE launch of the port's
``fingerprint`` kernel (``ops/fingerprint.py``, ``csrc/fingerprint.cu``):
a capture enqueues it on the caller's stream with an event, and the next
audit or read waits on that event and fetches its 8 bytes a leaf. The JAX package fetches the state and folds
on the host; the words are the same. A host copy of the state is taken (in
stream order, into pinned memory) only under ``snapshots=True``, which
``"restore"`` needs; no capture keeps a reference to the device state.

Audit surfaces (one policy knob: ``on_divergence="raise"|"degraded"|"restore"``)
-------------------------------------------------------------------------------

- **chain**: :class:`IntegrityAuditor` rides the committed-update observer
  seam; on a cadence it records the fingerprints (and, by default, a host
  copy) of the just-committed state, and an audit or a read re-fingerprints
  the live state: while the update count has not moved, the bits must match.
- **replica**: the stacked shards of an ``expand_canonical`` install must
  hold replicated families bit-identical and a sum field's extra shards the
  exact identity (:func:`expanded_divergences`). :func:`replica_divergences`
  compares per-device copies of one replicated array within a process; a
  port process holds one copy on one card, so it finds none (see its note).
- **mirror**: a host recovery mirror (``quarantine.LaneStateMirror``)
  verifies itself against the device state it claims to equal and
  invalidates instead of serving corrupt rollback rows.

Divergences raise :class:`~torchmetrics_tpu_torch.utils.exceptions.StateDivergenceError`
(flighted, ``integrity`` domain), serve the last-good value as a
:class:`~torchmetrics_tpu_torch.quarantine.DegradedValue`, or restore from
the auditor's verified host copy or the shard shadow.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.utils.exceptions import StateDivergenceError

__all__ = [
    "INTEGRITY_POLICIES",
    "Divergence",
    "IntegrityReport",
    "IntegrityAuditor",
    "DeferredIntegrity",
    "fingerprint_digest",
    "device_fingerprints",
    "device_shard_fingerprints",
    "host_fingerprints",
    "host_leaf_fingerprint",
    "replica_divergences",
    "expanded_divergences",
]

#: valid ``on_divergence`` policies: the same triple as ``on_shard_loss``
INTEGRITY_POLICIES = ("raise", "degraded", "restore")

#: reserved state() keys that are bookkeeping, not audited bits
_RESERVED_KEYS = ("_update_count", "_sharded_shards", "_window_meta")


# ---------------------------------------------------------------------------
# The leaf walk: the JAX package's keys (``jax.tree_util.keystr``)
# ---------------------------------------------------------------------------

def _is_arrayish(leaf: Any) -> bool:
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype")


def _walk(node: Any, prefix: str, out: List[Tuple[str, Any]]) -> None:
    """Append ``(keystr, leaf)`` in ``jax.tree_util``'s flattening order:
    dict keys sorted (``['k']``), list and tuple positions (``[0]``),
    namedtuple fields (``.name``); ``None`` is an empty subtree."""
    if node is None:
        return
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], f"{prefix}[{key!r}]", out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for name in node._fields:
            _walk(getattr(node, name), f"{prefix}.{name}", out)
    elif isinstance(node, (list, tuple)):
        for i, el in enumerate(node):
            _walk(el, f"{prefix}[{i}]", out)
    else:
        out.append((prefix, node))


def _array_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """Stable ``(path, leaf)`` pairs of the array leaves of a state tree
    (reserved bookkeeping keys and Python scalars are skipped), keyed as the
    JAX package keys them, so a fingerprint map or digest of the same bits
    is the same in both packages."""
    if isinstance(tree, dict):
        tree = {k: v for k, v in tree.items() if k not in _RESERVED_KEYS}
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return [(key, leaf) for key, leaf in out if _is_arrayish(leaf)]


# ---------------------------------------------------------------------------
# Fingerprint primitives: device (the fingerprint kernel) and host (numpy)
# ---------------------------------------------------------------------------

def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous()
    return torch.from_numpy(np.ascontiguousarray(leaf))


def _shard_rows(leaf: torch.Tensor) -> List[torch.Tensor]:
    """A stacked leaf's rows along its leading axis (a 0-d leaf is one)."""
    shards = leaf.shape[0] if leaf.dim() else 1
    return list(leaf.reshape(shards, -1).unbind(0)) if shards else []


def _tree_fold(tree: Any, per_shard: bool) -> Tuple[List[str], List[int], torch.Tensor]:
    """ONE fingerprint dispatch over every array leaf of ``tree`` (every
    shard row under ``per_shard``): the keys, each leaf's row count, and the
    packed ``(rows, 2)`` uint32 output on the leaves' device (enqueued, not
    awaited)."""
    from torchmetrics_tpu_torch.ops.fingerprint import fingerprint_segments

    keys: List[str] = []
    counts: List[int] = []
    segments: List[torch.Tensor] = []
    for key, leaf in _array_leaves(tree):
        t = _as_tensor(leaf)
        rows = _shard_rows(t) if per_shard else [t]
        keys.append(key)
        counts.append(len(rows))
        segments.extend(rows)
    return keys, counts, fingerprint_segments(segments)


def _unpack(keys: List[str], counts: List[int], packed: Any, per_shard: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    row = 0
    for key, n in zip(keys, counts):
        out[key] = packed[row:row + n] if per_shard else packed[row]
        row += n
    return out


def _fetch_words(packed: torch.Tensor) -> np.ndarray:
    """The packed fingerprint words on the host (a few bytes a leaf)."""
    return packed.view(torch.int32).cpu().numpy().view(np.uint32)


def device_fingerprints(tree: Any) -> Dict[str, torch.Tensor]:
    """Fingerprint every array leaf of ``tree`` in ONE dispatch (one launch
    of the fingerprint kernel on the card); returns ``{path: uint32[2]}`` of
    tensors on the leaves' device (enqueued, not awaited)."""
    keys, counts, packed = _tree_fold(tree, per_shard=False)
    return _unpack(keys, counts, packed, per_shard=False)


def device_shard_fingerprints(tree: Any) -> Dict[str, torch.Tensor]:
    """Per-shard fingerprints (``{path: uint32[num_shards, 2]}``) of a
    stacked state tree, every row of every leaf in ONE dispatch."""
    keys, counts, packed = _tree_fold(tree, per_shard=True)
    return _unpack(keys, counts, packed, per_shard=True)


def _host_fold(tree: Any, per_shard: bool = False) -> Dict[str, np.ndarray]:
    """The fold of ``tree`` fetched to the host: one dispatch and one copy
    of 8 bytes a leaf (a shard row)."""
    keys, counts, packed = _tree_fold(tree, per_shard)
    return _unpack(keys, counts, _fetch_words(packed), per_shard)


def host_leaf_fingerprint(arr: Any) -> np.ndarray:
    """``uint32[2]`` = (XOR, wrapping sum) over the leaf's 32-bit words, on
    the host (numpy), bit for bit the device fold.

    Leaves of 4 or 8 bytes an element are read as uint32 words (an 8-byte
    element gives two); 1- and 2-byte elements (and bools) are widened to
    one word each. A tensor is read through its host copy (a dtype numpy
    lacks, as bfloat16, through the same-width integer view).

    >>> host_leaf_fingerprint(np.array([1, 2, 3], np.int32)).tolist()
    [0, 6]
    """
    a = np.ascontiguousarray(_host_array(arr))
    if a.dtype == np.bool_:
        u = a.astype(np.uint32).reshape(-1)
    elif a.dtype.itemsize >= 4:
        u = a.reshape(-1).view(np.uint32)
    else:
        narrow = np.uint8 if a.dtype.itemsize == 1 else np.uint16
        u = a.reshape(-1).view(narrow).astype(np.uint32)
    if u.size == 0:
        return np.zeros((2,), np.uint32)
    xor = np.bitwise_xor.reduce(u)
    total = np.sum(u, dtype=np.uint32)
    return np.array([xor, total], np.uint32)


_NUMPY_LACKS = {torch.bfloat16: torch.int16, torch.uint16: torch.int16, torch.uint32: torch.int32}


def _host_array(value: Any) -> Any:
    """A host array of ``value``: tensors copied to numpy (dtypes numpy lacks
    through their same-width integer view), anything else as it is."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        view = _NUMPY_LACKS.get(t.dtype)
        if view is not None:
            t = t.view(view)
        return t.cpu().numpy()
    return value


def host_fingerprints(tree: Any) -> Dict[str, np.ndarray]:
    """Host-side fingerprints of an already-fetched state tree."""
    return {key: host_leaf_fingerprint(leaf) for key, leaf in _array_leaves(tree)}


def fingerprint_digest(fps: Dict[str, Any]) -> str:
    """Deterministic hex digest of a fingerprint map: sha256 over the sorted
    ``path:xor:sum`` lines (the JAX package's digest for the same map)."""
    lines = []
    for key in sorted(fps):
        words = np.ascontiguousarray(_fp_host(fps[key])).reshape(-1)
        lines.append(f"{key}:" + ":".join(str(int(w)) for w in words))
    return hashlib.sha256("\n".join(lines).encode("utf-8")).hexdigest()


def _fp_host(fp: Any) -> np.ndarray:
    if isinstance(fp, torch.Tensor):
        return _fetch_words(fp.contiguous())
    return np.asarray(fp)


# ---------------------------------------------------------------------------
# Replica-agreement checks
# ---------------------------------------------------------------------------

class Divergence(NamedTuple):
    """One detected disagreement, with attribution for the flight record."""

    surface: str                    # "chain" | "replica" | "mirror" | "restore"
    field: str                      # leaf path within the audited tree
    shard: Optional[int]            # replica/shard index when one is implicated
    expected: Tuple[int, ...]       # fingerprint words believed correct
    observed: Tuple[int, ...]       # fingerprint words actually found


class IntegrityReport(NamedTuple):
    """Outcome of one audit pass."""

    ok: bool
    checked: int                    # array leaves fingerprint-compared
    divergences: Tuple[Divergence, ...]
    update_count: Optional[int]     # count the audited bits belong to
    policy: str
    action: str                     # "none" | "degraded" | "restored" | "stale_baseline"
    restored_states: Any = None     # fresh states when a deferred restore fired


def _fp_words(fp: Any) -> Tuple[int, ...]:
    return tuple(int(w) for w in np.ascontiguousarray(_fp_host(fp)).reshape(-1))


def replica_divergences(tree: Any) -> List[Divergence]:
    """Bit-compare the per-device copies of every replicated array leaf of
    ``tree`` held by this process.

    In the JAX package one process may hold a fully replicated array on
    several devices, and this compares those copies. A port process holds
    one copy of a leaf on one card, so every leaf is single-copy and nothing
    is compared: the result is always ``[]``, as the JAX package's is for a
    single-device leaf. Copies on other ranks are NOT gathered here: an
    audit runs on the read pipeline's worker and at reads that ranks need not
    make together, where a collective would deadlock or run out of step."""
    return []


def _repeated_fp(element_fp: np.ndarray, count: int) -> np.ndarray:
    """The fingerprint of ``count`` copies of one element (``element_fp`` its
    own): XOR cancels in pairs, the sum multiplies."""
    xor = int(element_fp[0]) if count % 2 else 0
    return np.array([xor, (int(element_fp[1]) * count) % (1 << 32)], np.uint32)


def expanded_divergences(states: Dict[str, Any], reductions: Dict[str, Any]) -> List[Divergence]:
    """Verify the ``expand_canonical`` install invariant on a stacked state
    (``parallel/reshard.py``): replicated families (mean/max/min) must be
    bit-identical across shards, and a sum field's shards 1..S-1 must hold
    the exact reduction identity. Valid right after an expand or restore:
    the first local step legitimately de-replicates. One fingerprint
    dispatch over every row of every checked field, then 8 bytes a row to
    the host."""
    from torchmetrics_tpu_torch.parallel.sync import reduction_identity

    checked = {}
    for name, value in states.items():
        if name in _RESERVED_KEYS or not _is_arrayish(value) or len(getattr(value, "shape", ())) < 1:
            continue
        if reductions.get(name) in ("sum", "mean", "max", "min"):
            checked[name] = value
    rows = _host_fold(checked, per_shard=True)
    out: List[Divergence] = []
    for name, value in checked.items():
        fx = reductions.get(name)
        shard_fps = rows[f"[{name!r}]"]
        if fx == "sum":
            t = _as_tensor(value)
            ident = reduction_identity(fx, t.dtype).reshape(1)
            expected = _repeated_fp(host_leaf_fingerprint(ident), t[0].numel())
        else:
            expected = shard_fps[0]
        for shard in range(1, len(shard_fps)):
            if not np.array_equal(shard_fps[shard], expected):
                out.append(Divergence("replica", name, shard, _fp_words(expected), _fp_words(shard_fps[shard])))
    return out


def _compare_fps(surface: str, expected: Dict[str, Any], observed: Dict[str, Any]) -> Tuple[int, List[Divergence]]:
    """Compare two fingerprint maps over their shared keys (a leaf present on
    one side only, a grown cat buffer, a reshaped field, is structural
    change, not bit corruption, and is skipped)."""
    checked = 0
    out: List[Divergence] = []
    for key in expected:
        if key not in observed:
            continue
        exp = np.ascontiguousarray(_fp_host(expected[key]))
        got = np.ascontiguousarray(_fp_host(observed[key]))
        if exp.shape != got.shape:
            continue
        checked += 1
        if not np.array_equal(exp, got):
            shard = None
            if exp.ndim == 2:  # per-shard map: attribute the first offending shard
                for i in range(exp.shape[0]):
                    if not np.array_equal(exp[i], got[i]):
                        shard = i
                        break
            out.append(Divergence(surface, key, shard, _fp_words(exp), _fp_words(got)))
    return checked, out


def _host_async(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` enqueued on the caller's stream: into pinned
    memory without waiting for the card (ready once the caller's event is),
    or a plain clone on the CPU."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _host_copy_async(tree: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`_host_async` of a state dict's tensors (list states
    element-wise): the host copy ``"restore"`` reinstalls, taken in stream
    order right behind the update it records."""
    return {k: ([_host_async(el) for el in v] if isinstance(v, list) else _host_async(v)) for k, v in tree.items()}


class _Parked:
    """The newest capture not yet installed as the audit baseline.

    A capture enqueues its fold (and, under ``snapshots=True``, the state's
    copy to pinned host memory) and an event, all on the caller's stream,
    and parks here; the next audit or read installs the newest parked
    capture as the baseline: it waits on the event (long passed by then)
    and fetches the fold's 8 bytes a leaf. A capture superseded before that
    is dropped unread: only the newest count can be audited. No
    read-pipeline job runs for a capture: a worker woken for every capture
    contends with the step loop for the interpreter, which made an audited
    update slower than parking does."""

    def __init__(self, install: Callable[[Tuple], Any]) -> None:
        self._install = install
        self._lock = threading.Lock()
        self._capture: Optional[Tuple] = None

    def park(self, capture: Tuple) -> None:
        with self._lock:
            self._capture = capture

    def install(self) -> None:
        """Install the parked capture, if any, on the calling thread."""
        with self._lock:
            capture, self._capture = self._capture, None
        if capture is not None:
            self._install(capture)


def _on_device(host_state: Dict[str, Any], device: Any) -> Dict[str, Any]:
    """A host copy's state fields back on ``device`` (list states
    element-wise), bookkeeping keys left out."""
    return {
        k: ([el.to(device) for el in v] if isinstance(v, list) else v.to(device))
        for k, v in host_state.items() if k not in _RESERVED_KEYS
    }


def _flight_divergence(report: "IntegrityReport", owner: str) -> StateDivergenceError:
    first = report.divergences[0]
    return obs.flighted(
        StateDivergenceError(
            f"{owner}: state integrity audit found {len(report.divergences)} divergent"
            f" leaf/replica fingerprint(s); first: {first.surface} surface, leaf"
            f" {first.field!r}"
            + (f", shard {first.shard}" if first.shard is not None else "")
            + f" (expected {first.expected}, observed {first.observed})",
            surface=first.surface,
            field=first.field,
            shard=first.shard,
            expected=first.expected,
            observed=first.observed,
        ),
        domain="integrity",
        owner=owner,
        divergences=len(report.divergences),
        update_count=report.update_count,
    )


def _record_divergence(report: "IntegrityReport", owner: str) -> None:
    first = report.divergences[0]
    obs.counter_inc("integrity.divergences", len(report.divergences))
    obs.fault_breadcrumb(
        "integrity_divergence",
        domain="integrity",
        data={
            "owner": owner,
            "surface": first.surface,
            "field": first.field,
            "shard": first.shard,
            "divergences": len(report.divergences),
            "update_count": report.update_count,
            "policy": report.policy,
        },
    )


# ---------------------------------------------------------------------------
# The metric-attached auditor (chain, replica and mirror surfaces)
# ---------------------------------------------------------------------------

class IntegrityAuditor:
    """Cadence-driven bit-exact audits of one live metric or collection member.

    Attach to any :class:`~torchmetrics_tpu_torch.Metric`::

        auditor = IntegrityAuditor(metric, every_n_updates=8,
                                   on_divergence="restore").attach()

    After every ``every_n_updates``-th committed top-level update (the
    observer seam the Autosaver rides) the just-committed state is
    *captured*: one fingerprint launch (and, under ``snapshots=True``, the
    state's copy to pinned host memory) and an event are enqueued on the
    caller's stream, and the capture is parked; the next audit or read
    waits on the event, fetches 8 bytes a leaf and installs the newest
    parked capture as the baseline ``(update_count, fingerprints[, host
    copy])``. The step
    loop never waits, and no capture holds the device state.

    An :meth:`audit` (explicit, or at every read while attached:
    ``compute``/``compute_async`` verify before serving) re-fingerprints the
    live state; while the update count still equals the baseline's, the bits
    MUST match (the **chain** surface). On divergence ``on_divergence``
    resolves like ``on_shard_loss``:

    - ``"raise"``: a flighted :class:`StateDivergenceError` (``integrity``
      flight domain);
    - ``"degraded"``: the last-good computed value is served as a
      :class:`~torchmetrics_tpu_torch.quarantine.DegradedValue` (reads only;
      an explicit audit records and reports). The auditor keeps that value
      itself, from the metric's compute observers, and never lets it share
      storage with the state, which a flip corrupts in place: under
      ``snapshots=True`` such tensors are cloned; under ``snapshots=False``
      a value that shares storage with the state (a confusion matrix or a
      sum returned as it is) is not kept, and the read escalates to
      ``"raise"``;
    - ``"restore"``: the baseline host copy is reinstalled through
      ``load_state`` at the same update count (nothing is lost) and the read
      proceeds on the verified bits; requires ``snapshots=True``.

    ``snapshots=False`` keeps fingerprints only (for states too large to
    mirror on the host or copy on the card); ``"restore"`` then escalates
    to ``"raise"``.
    Corruption is caught while the update count has not moved past the last
    capture: ``every_n_updates=1`` (the default) covers every gap between
    updates.
    """

    def __init__(
        self,
        metric: Any,
        every_n_updates: int = 1,
        on_divergence: str = "raise",
        snapshots: bool = True,
    ) -> None:
        if on_divergence not in INTEGRITY_POLICIES:
            raise ValueError(f"on_divergence must be one of {INTEGRITY_POLICIES}, got {on_divergence!r}")
        if every_n_updates < 1:
            raise ValueError(f"every_n_updates must be >= 1, got {every_n_updates}")
        self.metric = metric
        self.every_n_updates = every_n_updates
        self.on_divergence = on_divergence
        self.snapshots = snapshots
        self.stats: Dict[str, Any] = {
            "captures": 0,
            "audits": 0,
            "divergences": 0,
            "degraded_serves": 0,
            "restores": 0,
            "stale_baselines": 0,
            "last_divergence": None,
        }
        self._since = 0
        self._lock = threading.Lock()
        #: (update_count, {path: uint32[2]}, host state copy or None)
        self._baseline: Optional[Tuple[int, Dict[str, np.ndarray], Optional[Dict[str, Any]]]] = None
        self._parked = _Parked(self._install)
        #: (update_count, value) of the last good compute, under "degraded"
        self._last_good: Optional[Tuple[int, Any]] = None
        self._detach_fns: List[Callable[[], None]] = []

    # ------------------------------------------------------------- attachment
    def attach(self) -> "IntegrityAuditor":
        """Observe committed updates and hook the read points (idempotent)."""
        if not self._detach_fns:
            self._detach_fns.append(self.metric.add_update_observer(self._on_update))
            if self.on_divergence == "degraded":
                self._detach_fns.append(self.metric.add_compute_observer(self._on_compute))
            self.metric.__dict__["_integrity_auditor"] = self
        return self

    def detach(self) -> None:
        for fn in self._detach_fns:
            fn()
        self._detach_fns.clear()
        if self.metric.__dict__.get("_integrity_auditor") is self:
            del self.metric.__dict__["_integrity_auditor"]

    def _on_update(self, _obj: Any) -> None:
        self._since += 1
        if self._since >= self.every_n_updates:
            self._since = 0
            self.capture()

    # ---------------------------------------------------------------- capture
    def capture(self, wait: bool = False) -> Any:
        """Record the committed state's fingerprints (and host copy) as the
        audit baseline. The caller enqueues one fold (and, under
        ``snapshots=True``, the state's copy to pinned host memory) and an
        event, and parks the capture; the next audit or read installs it
        (``wait=True``: at once, returning its count). No reference to the
        state is kept."""
        from torchmetrics_tpu_torch.ops.async_read import submission_event

        state = self.metric._copy_state_dict()
        count = int(self.metric._update_count)
        self.stats["captures"] += 1
        obs.counter_inc("integrity.captures")
        with obs.span(obs.SPAN_INTEGRITY, suffix=type(self.metric).__name__):
            keys, counts, packed = _tree_fold(state, per_shard=False)
            host_state = _host_copy_async(state) if self.snapshots else None
            self._parked.park((count, keys, counts, packed, host_state, submission_event(packed)))
        if wait:
            self._parked.install()
            return self.baseline_count
        return None

    def _install(self, capture: Tuple) -> int:
        """Wait for a parked capture's copies and install it as the baseline
        (a newer baseline is never replaced by an older capture)."""
        from torchmetrics_tpu_torch.ops.async_read import wait_submitted

        count, keys, counts, packed, host_state, event = capture
        wait_submitted(event)
        fps = _unpack(keys, counts, _fetch_words(packed), per_shard=False)
        with self._lock:
            if self._baseline is None or count >= self._baseline[0]:
                self._baseline = (count, fps, host_state)
        return count

    @property
    def baseline_count(self) -> Optional[int]:
        self._parked.install()
        with self._lock:
            return self._baseline[0] if self._baseline else None

    # ------------------------------------------------------------------ audit
    def audit(self, wait: bool = True) -> Any:
        """Verify the live state against the baseline (chain surface), the
        replica surface and any attached recovery mirror.

        ``wait=True`` (default) runs inline: an explicit audit is a
        deliberate blocking read, like ``compute()``. ``wait=False`` submits
        the verification to the read pipeline and returns a
        :class:`~torchmetrics_tpu_torch.ops.async_read.MetricFuture`
        resolving to the :class:`IntegrityReport` (or raising, under
        ``"raise"``)."""
        from torchmetrics_tpu_torch.ops.async_read import get_pipeline, submission_event, wait_submitted

        state = self.metric._copy_state_dict()
        count = int(self.metric._update_count)
        if wait:
            with obs.span(obs.SPAN_INTEGRITY, suffix=type(self.metric).__name__, histogram="integrity.audit_us"):
                report = self._verify(state, count)
                return self._apply_policy(report, serve_degraded=False)
        event = submission_event(state)

        def job() -> Any:
            wait_submitted(event)
            return self._apply_policy(self._verify(state, count), serve_degraded=False)

        with obs.span(obs.SPAN_INTEGRITY, suffix=type(self.metric).__name__):
            return get_pipeline().submit(job, owner="IntegrityAuditor.audit")

    def _verify(self, state: Dict[str, Any], count: int) -> IntegrityReport:
        """Fingerprint ``state`` and compare (worker-side or explicit-audit
        context: the 8-byte fetches are deliberate here)."""
        self.stats["audits"] += 1
        obs.counter_inc("integrity.audits")
        divergences: List[Divergence] = list(replica_divergences(state))
        # mirror surface: a recovery mirror claiming to equal this state must
        # fingerprint-match it; a divergent one invalidates itself, so the
        # next snapshot rebuilds instead of serving corrupt rollback rows
        for name in ("_lane_mirror", "_class_mirror"):
            mirror = self.metric.__dict__.get(name)
            if mirror is not None and hasattr(mirror, "verify"):
                if not mirror.verify(state, count):
                    self.stats["mirror_rebuilds"] = self.stats.get("mirror_rebuilds", 0) + 1
        checked = 0
        action = "none"
        self._parked.install()
        with self._lock:
            baseline = self._baseline
        if baseline is not None and baseline[0] == count:
            checked, chain = _compare_fps("chain", baseline[1], _host_fold(state))
            divergences.extend(chain)
        elif baseline is not None:
            # the count moved since the last capture: the chain baseline is
            # stale (legitimate updates landed)
            self.stats["stale_baselines"] += 1
            action = "stale_baseline"
        ok = not divergences
        if not ok:
            self.stats["divergences"] += len(divergences)
            self.stats["last_divergence"] = divergences[0]._asdict()
        return IntegrityReport(
            ok=ok,
            checked=checked,
            divergences=tuple(divergences),
            update_count=count,
            policy=self.on_divergence,
            action=action,
        )

    # ----------------------------------------------------- policy resolution
    def _apply_policy(self, report: IntegrityReport, serve_degraded: bool) -> Any:
        """Resolve a divergent report per ``on_divergence``: the report
        (possibly action-updated), a DegradedValue for read paths, or a
        raise. Clean reports pass through."""
        if report.ok:
            return report
        owner = type(self.metric).__name__
        _record_divergence(report, owner)
        policy = self.on_divergence
        if policy == "restore":
            restored = self._try_restore(report)
            if restored is not None:
                return restored
            policy = "raise"  # no verified snapshot to restore from
        if policy == "degraded":
            self.stats["degraded_serves"] += 1
            obs.counter_inc("integrity.degraded_serves")
            if serve_degraded:
                served = self._degraded_value(report)
                if served is not None:
                    return served
                raise _flight_divergence(report, owner)  # nothing cached to serve
            return report._replace(action="degraded")
        raise _flight_divergence(report, owner)

    def _degraded_value(self, report: IntegrityReport) -> Any:
        from torchmetrics_tpu_torch.quarantine import DegradedValue

        with self._lock:
            last_good = self._last_good
        if last_good is None:
            return None
        count, value = last_good
        live = int(self.metric._update_count)
        obs.histogram_observe("reads.staleness_age_updates", live - count)
        return DegradedValue(value=value, updates_behind=live - count, age_updates=count)

    def _try_restore(self, report: IntegrityReport) -> Optional[IntegrityReport]:
        """Reinstall the verified baseline host copy (same update count:
        nothing is lost); also invalidates any attached recovery mirror so a
        diverged mirror never survives as a future restore source."""
        with self._lock:
            baseline = self._baseline
        if baseline is None or baseline[2] is None or baseline[0] != report.update_count:
            return None
        count, _fps, host_state = baseline
        try:
            self.metric.load_state(_on_device(host_state, self.metric.device), update_count=count)
        except Exception as err:  # noqa: BLE001 - a failed restore escalates to raise
            obs.fault_breadcrumb(
                "integrity_restore_failed",
                domain="integrity",
                data={"owner": type(self.metric).__name__, "error": f"{type(err).__name__}: {err}"},
            )
            return None
        for name in ("_lane_mirror", "_class_mirror"):
            mirror = self.metric.__dict__.get(name)
            if mirror is not None and hasattr(mirror, "invalidate"):
                mirror.invalidate()  # a diverged mirror must not survive as a restore source
        self.stats["restores"] += 1
        obs.counter_inc("integrity.restores")
        obs.fault_breadcrumb(
            "integrity_restored",
            domain="integrity",
            data={"owner": type(self.metric).__name__, "update_count": count},
        )
        return report._replace(action="restored")

    # ------------------------------------------------------------ read hooks
    def _on_compute(self, count: int, value: Any) -> None:
        """Compute observer: keep ``value`` as the last-good read, in a form
        that shares no storage with the live state (a compute may return a
        state tensor itself, and state is corrupted in place). Under
        ``snapshots=True`` such tensors are cloned. Under ``snapshots=False``
        (states too large to copy) such a value is not kept, so a divergent
        read raises rather than serve bits the corruption reached."""
        storages = {
            t.untyped_storage().data_ptr()
            for v in self.metric._copy_state_dict().values()
            for t in (v if isinstance(v, list) else [v])
            if isinstance(t, torch.Tensor)
        }
        shared = False

        def detach(v: Any) -> Any:
            nonlocal shared
            if isinstance(v, torch.Tensor):
                if v.untyped_storage().data_ptr() not in storages:
                    return v
                shared = True
                return v.clone() if self.snapshots else v
            if isinstance(v, dict):
                return {k: detach(el) for k, el in v.items()}
            if isinstance(v, (list, tuple)) and not hasattr(v, "_fields"):
                return type(v)(detach(el) for el in v)
            return v

        kept = detach(value)
        with self._lock:
            self._last_good = None if shared and not self.snapshots else (count, kept)

    def verify_read(self) -> Any:
        """Read-point hook (``Metric.compute``): verify before serving.
        Returns None when the read may proceed (clean, stale baseline, or a
        completed restore), or a DegradedValue the read should serve."""
        from torchmetrics_tpu_torch.quarantine import DegradedValue

        state = self.metric._copy_state_dict()
        count = int(self.metric._update_count)
        with obs.span(obs.SPAN_INTEGRITY, suffix=type(self.metric).__name__, histogram="integrity.audit_us"):
            report = self._verify(state, count)
            if report.ok:
                return None
            resolved = self._apply_policy(report, serve_degraded=True)
        return resolved if isinstance(resolved, DegradedValue) else None

    def wrap_async_read(self, body: Callable[[], Any], snapshot: Dict[str, Any], flags: Dict[str, Any]) -> Callable[[], Any]:
        """Wrap a ``compute_async`` worker body: the submission-time snapshot
        is verified ON THE WORKER before the read resolves, so the future
        carries the outcome a blocking read would have (raise, degraded,
        restored) without blocking the submitting thread. The caller's body
        waits on the submission event before the returned body runs."""
        count = int(flags["count"])
        with self._lock:
            last_good = self._last_good  # as of submission

        def verified_body() -> Any:
            with obs.span(obs.SPAN_INTEGRITY, suffix=type(self.metric).__name__):
                report = self._verify(snapshot, count)
            if report.ok:
                return body()
            owner = type(self.metric).__name__
            _record_divergence(report, owner)
            if self.on_divergence == "restore":
                with self._lock:
                    baseline = self._baseline
                if baseline is not None and baseline[2] is not None and baseline[0] == count:
                    # swap the corrupt references for the verified host copy
                    # in place, on the metric's device: the body reads
                    # `snapshot` when it installs it
                    snapshot.clear()
                    snapshot.update(_on_device(baseline[2], self.metric.device))
                    self.stats["restores"] += 1
                    obs.counter_inc("integrity.restores")
                    self._try_restore(report)  # heal the live state too, if unmoved
                    return body()
            if self.on_divergence == "degraded":
                self.stats["degraded_serves"] += 1
                obs.counter_inc("integrity.degraded_serves")
                from torchmetrics_tpu_torch.quarantine import DegradedValue

                if last_good is not None:
                    good_count, value = last_good
                    return DegradedValue(value=value, updates_behind=count - good_count, age_updates=good_count)
            raise _flight_divergence(report, owner)

        return verified_body


# ---------------------------------------------------------------------------
# The deferred-loop auditor (per-shard chain over externally carried states)
# ---------------------------------------------------------------------------

class DeferredIntegrity:
    """Per-shard fingerprint audits of a deferred epoch loop's stacked state.

    The deferred layout carries state OUTSIDE any metric object, so the
    auditor rides the step's commit seam instead of the observer: every
    ``every_n_steps`` committed local steps, ONE dispatch fingerprints every
    shard of every leaf (``uint32[S, 2]`` a leaf) and the fetch rides the
    read pipeline. :meth:`audit` re-fingerprints the carried states and,
    while the step count has not moved, every shard's bits must match: a flip
    in ANY shard names the shard it hit. ``on_divergence="restore"``
    reinstalls the step's shard shadow through ``step.recover()`` and hands
    back fresh states. The step is duck-typed: ``steps``, ``shadow`` and
    ``recover()``.
    """

    def __init__(self, step: Any, every_n_steps: int = 8, on_divergence: str = "raise") -> None:
        if on_divergence not in INTEGRITY_POLICIES:
            raise ValueError(f"on_divergence must be one of {INTEGRITY_POLICIES}, got {on_divergence!r}")
        if every_n_steps < 1:
            raise ValueError(f"every_n_steps must be >= 1, got {every_n_steps}")
        self._step = step
        self.every_n_steps = every_n_steps
        self.on_divergence = on_divergence
        self.stats: Dict[str, Any] = {
            "captures": 0,
            "audits": 0,
            "divergences": 0,
            "restores": 0,
            "stale_baselines": 0,
            "last_divergence": None,
        }
        self._lock = threading.Lock()
        self._last_capture_step = -1
        #: (step_count, {path: uint32[S, 2]})
        self._baseline: Optional[Tuple[int, Dict[str, np.ndarray]]] = None
        self._parked = _Parked(self._install)

    def due(self, steps: int) -> bool:
        return steps - self._last_capture_step >= self.every_n_steps

    # ---------------------------------------------------------------- capture
    def observe(self, states: Any, steps: int) -> None:
        """Commit-seam tick: enqueue the per-shard fold (the step loop never
        waits) and park it for the next audit."""
        from torchmetrics_tpu_torch.ops.async_read import submission_event

        self._last_capture_step = steps
        self.stats["captures"] += 1
        obs.counter_inc("integrity.captures")
        with obs.span(obs.SPAN_INTEGRITY, suffix="DeferredCollectionStep"):
            keys, counts, packed = _tree_fold(states, per_shard=True)
            self._parked.park((steps, keys, counts, packed, submission_event(packed)))

    def _install(self, capture: Tuple) -> int:
        from torchmetrics_tpu_torch.ops.async_read import wait_submitted

        steps, keys, counts, packed, event = capture
        wait_submitted(event)
        host = _unpack(keys, counts, _fetch_words(packed), per_shard=True)
        with self._lock:
            if self._baseline is None or steps >= self._baseline[0]:
                self._baseline = (steps, host)
        return steps

    @property
    def baseline_steps(self) -> Optional[int]:
        self._parked.install()
        with self._lock:
            return self._baseline[0] if self._baseline else None

    # ------------------------------------------------------------------ audit
    def audit(self, states: Any) -> IntegrityReport:
        """Verify the carried ``states`` against the last captured per-shard
        fingerprints (blocking by contract, like ``reduce``). On divergence:
        ``"raise"`` throws flighted; ``"degraded"`` records and reports;
        ``"restore"`` reinstalls the shard shadow (``step.recover()``) and
        returns the fresh states in ``report.restored_states``."""
        self.stats["audits"] += 1
        obs.counter_inc("integrity.audits")
        steps = int(getattr(self._step, "steps", 0))
        self._parked.install()
        with self._lock:
            baseline = self._baseline
        with obs.span(obs.SPAN_INTEGRITY, suffix="DeferredCollectionStep", histogram="integrity.audit_us"):
            divergences: List[Divergence] = []
            checked = 0
            action = "none"
            if baseline is not None and baseline[0] == steps:
                checked, divergences = _compare_fps("chain", baseline[1], _host_fold(states, per_shard=True))
            elif baseline is not None:
                self.stats["stale_baselines"] += 1
                action = "stale_baseline"
        ok = not divergences
        report = IntegrityReport(
            ok=ok,
            checked=checked,
            divergences=tuple(divergences),
            update_count=steps,
            policy=self.on_divergence,
            action=action,
        )
        if ok:
            return report
        self.stats["divergences"] += len(divergences)
        self.stats["last_divergence"] = divergences[0]._asdict()
        _record_divergence(report, "DeferredCollectionStep")
        if self.on_divergence == "restore" and getattr(self._step, "shadow", None) is not None:
            if getattr(self._step.shadow, "snapshot", lambda: None)() is not None:
                fresh = self._step.recover()
                self.stats["restores"] += 1
                obs.counter_inc("integrity.restores")
                obs.fault_breadcrumb(
                    "integrity_restored",
                    domain="integrity",
                    data={"owner": "DeferredCollectionStep", "steps": steps},
                )
                return report._replace(action="restored", restored_states=fresh)
        if self.on_divergence == "degraded":
            obs.counter_inc("integrity.degraded_serves")
            return report._replace(action="degraded")
        raise _flight_divergence(report, "DeferredCollectionStep")
