"""Captured dispatch for the eager stateful API (``Metric.update``/``forward``
and ``MetricCollection``'s).

The port's counterpart of the JAX package's donated-state executor. There,
every eager ``update``/``forward`` of an eligible metric becomes one jitted
executable with the state donated. Here, every cache key

    (call kind, input structure, shape bucket, dtypes, state layout)

becomes a CUDA graph, captured once and replayed: the whole update, a
collection's every compute group, is one launch from the host.

Static buffers
    A graph reads and writes fixed addresses, while the rest of the port
    replaces state tensors out of place and hands them out by reference
    (rollback snapshots, compute-group followers, pending reads). So the
    executor keeps two state slots of its own and captures each key twice,
    one graph each way: the graph of slot ``d`` reads slot ``d``, writes its
    update into slot ``1 - d``, and the live state then IS slot ``1 - d``. The
    slot a call read is never written by that call, which is also its
    recovery reference: a failed replay leaves the live state as it was, on
    the device, with no copy and no host sync.

    A slot is never handed to anyone while it can still be written. Every
    by-reference read of the live state (an attribute, ``metric_state``,
    ``state()``, a compute, an asynchronous read's snapshot, an integrity
    capture or a checkpoint) first swaps the slot tensors it would hand out
    for copies (``Metric._escape_state``) and marks the state escaped; the
    next call copies the live state back into its slot before it replays
    (``copied_calls``). In a steady update loop no call copies
    (``donated_calls``, the JAX package's name).

Inputs
    Each key owns static input buffers; a call copies its tensors in (with
    the padding rows written as copies of row 0; a tensor that already is
    the buffer the graph reads is not copied) and fills the static scalars
    (the valid row count, a forward's update count).

Warm before capture
    A key's first call runs its body eagerly, on the same card kernels and
    the caller's stream, and serves the call with that result: the
    kernels' libraries are built and their attributes set before the
    capture. Then both graphs are captured into the executor's private
    graph pool on the device's one capture stream, which every executor
    shares and replays on (``capture_error_mode="thread_local"``, so the
    read pipeline's worker may sync meanwhile). A per-device lock holds
    one capture or one replay on that stream at a time, whichever thread
    asks (a background warmup captures beside the caller's replays).
    Kernel launch counters count no capture: each graph records the
    launches it holds and adds them at every replay.

Shape bucketing
    A batch size that repeats (the same size as the call before, or one
    already keyed so) gets an exact key, up to :data:`_EXACT_SIZES` sizes an
    executor; any other size, a ragged last batch or traffic whose size
    varies call after call, pads up the ladder of :func:`bucket_size` as in
    the JAX package (padding rows are copies of the batch's first row) and
    the padding's contribution is subtracted inside the body for ``"sum"``
    states. The first padded call also runs the eager body on the unpadded
    batch and compares; a mismatch turns bucketing off for good. (The JAX
    package pads every call of a size off the ladder: its ``padded_calls``
    and ``probes`` count more for a steady size that is no power of two.)

Eager keys
    On the card an update key's second replay is timed (its whole host
    path, and its input copies and replay on the device; a replay whose
    call overlapped an asynchronous read in flight, whose worker shares
    the host, is not judged, and the next one is timed, up to
    :data:`_VERDICT_DEFERRALS` times), and the key's
    next :data:`_EAGER_TRIALS` calls step aside to time the eager path on
    the same batch shape (host and device). When the replay did not take
    at most :data:`_KEEP_SHARE` of the faster eager call's time (each the larger of its
    host time and its host time before launching plus its launches' span
    on the stream), the key runs eagerly from then on (a later call with
    the same input shapes steps aside before any key is built), its graphs and static inputs freed, and
    ``executor_stats(...)["eager"]`` counts such keys (``keys``) and the
    calls served eagerly (``calls``: the trials and after) and says why
    (``reasons``).

Where no graph can be captured (a metric on the CPU), the same bookkeeping
runs with the body called directly in place of a replay: keys, the ladder,
padding, probes, slots, escapes, copies, stats and containment.
"""
from __future__ import annotations

import gc
import os
import sys
import threading
import time
import weakref
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.ops import compile_cache, launch_counts
from torchmetrics_tpu_torch.ops.compile_cache import PROFILE_VERSION, _dtype_name, dummy_from_spec, spec_of_call
from torchmetrics_tpu_torch.ops.async_read import last_read_done_ns, pending_reads
from torchmetrics_tpu_torch.utils.exceptions import DispatchStallError, TorchMetricsUserError
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_warn

ENV_FLAG = "TORCHMETRICS_TPU_EXECUTOR"

_BUCKET_FLOOR = 8
#: batch sizes off the ladder an executor keys exactly (more go up the ladder)
_EXACT_SIZES = 4
#: a key keeps its graphs only when its timed replay took at most this
#: share of its faster eager trial's time: one replay is timed, and a tie is
#: not worth the static copies and the pool
_KEEP_SHARE = 0.9
#: replays a key's verdict passes over while asynchronous reads are in
#: flight; after that the key keeps replaying unjudged
_VERDICT_DEFERRALS = 8
#: eager trials a judged key takes (the first eager call after replays may
#: still allocate its temporaries: the faster one counts)
_EAGER_TRIALS = 2
_FUSABLE_REDUCTIONS = ("sum", "max", "min")
_PROFILE_CAP = 64


def executor_enabled_default() -> bool:
    """Global default from the environment (``TORCHMETRICS_TPU_EXECUTOR``, on)."""
    return os.environ.get(ENV_FLAG, "1").strip().lower() not in ("0", "false", "off", "no")


def bucket_size(n: int) -> int:
    """Next rung of the geometric bucket ladder: powers of two, floor 8.

    >>> [bucket_size(n) for n in (1, 8, 9, 100, 1024)]
    [8, 8, 16, 128, 1024]
    """
    n = int(n)
    if n <= _BUCKET_FLOOR:
        return _BUCKET_FLOOR
    return 1 << (n - 1).bit_length()


class _DispatchFailure(Exception):
    """Internal: a WARM dispatch failed. The live state is intact (the slot
    the call read was not written); the entry point propagates ``original``
    instead of re-running the batch eagerly, which would count it twice."""

    def __init__(self, original: BaseException) -> None:
        super().__init__(str(original))
        self.original = original


class _CaptureFailed(Exception):
    """Internal: a fresh key's eager run succeeded and its capture did not.
    Carries the eager result, which serves the call."""

    def __init__(self, original: BaseException, result: Any) -> None:
        super().__init__(str(original))
        self.original = original
        self.result = result


# ----------------------------------------------------------------- pytrees
#
# A call's (args, kwargs) and a state tree flatten to leaves plus a hashable
# structure: tuples, lists and dicts (keys sorted, so keyword order never
# splits the cache) are nodes, None is an empty node, anything else a leaf.

_LEAF = "*"


def _flatten_into(obj: Any, leaves: List[Any]) -> Any:
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return ("t", tuple(_flatten_into(o, leaves) for o in obj))
    if isinstance(obj, list):
        return ("l", tuple(_flatten_into(o, leaves) for o in obj))
    if isinstance(obj, dict):
        keys = tuple(sorted(obj, key=str))
        return ("d", keys, tuple(_flatten_into(obj[k], leaves) for k in keys))
    if obj is None:
        return ("n",)
    leaves.append(obj)
    return _LEAF


def tree_flatten(obj: Any) -> Tuple[List[Any], Any]:
    leaves: List[Any] = []
    return leaves, _flatten_into(obj, leaves)


def _unflatten_from(spec: Any, it: Iterator[Any]) -> Any:
    if spec == _LEAF:
        return next(it)
    kind = spec[0]
    if kind == "t":
        return tuple(_unflatten_from(s, it) for s in spec[1])
    if kind == "l":
        return [_unflatten_from(s, it) for s in spec[1]]
    if kind == "d":
        return {k: _unflatten_from(s, it) for k, s in zip(spec[1], spec[2])}
    return None


def tree_unflatten(spec: Any, leaves: Sequence[Any]) -> Any:
    return _unflatten_from(spec, iter(leaves))


# --------------------------------------------------------------- contexts


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _in_transform() -> bool:
    peek = getattr(getattr(torch._C, "_functorch", None), "peek_interpreter_stack", None)
    return peek is not None and peek() is not None


def _trace_clean() -> bool:
    """False inside the caller's own CUDA graph capture or a ``torch.func``
    transform (``lane_values``' vmaps): there the executor steps aside for
    the call (``skipped_calls``) and the eager body runs."""
    return not _capturing() and not _in_transform()


# ------------------------------------------------------------------ leaves


def _classify_leaves(leaves: Sequence[Any]) -> Optional[tuple]:
    """Per-leaf signature, or None when a leaf cannot be a static buffer.

    Python ``bool`` leaves key on their VALUE and stay Python values (flag
    arguments keep driving control flow). A tensor keys on its shape, dtype
    and device. Any other leaf (a Python number a graph would bake in, a
    numpy array, a tensor that needs a gradient) makes the call ineligible.
    """
    sig: List[Any] = []
    for leaf in leaves:
        if type(leaf) is bool:
            sig.append(("static_bool", leaf))
        elif isinstance(leaf, torch.Tensor) and not leaf.requires_grad:
            sig.append((tuple(leaf.shape), leaf.dtype, leaf.device))
        else:
            return None
    return tuple(sig)


def _split_static_bools(leaves: Sequence[Any]) -> Tuple[List[Any], Tuple[Tuple[int, bool], ...]]:
    """(tensor leaves, ((index, value), ...)): bools stay out of the buffers."""
    dyn: List[Any] = []
    spec: List[Tuple[int, bool]] = []
    for i, leaf in enumerate(leaves):
        if type(leaf) is bool:
            spec.append((i, leaf))
        else:
            dyn.append(leaf)
    return dyn, tuple(spec)


def _merge_static_bools(dyn: Sequence[Any], spec: Tuple[Tuple[int, bool], ...], total: int) -> List[Any]:
    fixed = dict(spec)
    it = iter(dyn)
    return [fixed[i] if i in fixed else next(it) for i in range(total)]


def _common_batch_dim(leaves: Sequence[Any]) -> Optional[int]:
    """The shared leading dim of every >=1-d tensor leaf, if one exists."""
    dims = {int(leaf.shape[0]) for leaf in leaves if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1}
    if len(dims) != 1:
        return None
    return dims.pop()


def _pad_leaves(leaves: Sequence[Any], batched: Sequence[bool], pad_to: int) -> List[Any]:
    """Pad each batched leaf's leading dim to ``pad_to`` with copies of row 0."""
    out: List[Any] = []
    for leaf, is_batched in zip(leaves, batched):
        n = int(leaf.shape[0]) if is_batched else pad_to
        if n == pad_to:
            out.append(leaf)
        else:
            out.append(torch.cat([leaf, leaf[:1].expand((pad_to - n,) + tuple(leaf.shape[1:]))]))
    return out


def _row0_leaves(leaves: Sequence[Any], batched: Sequence[bool]) -> List[Any]:
    return [leaf[:1] if is_batched else leaf for leaf, is_batched in zip(leaves, batched)]


def _states_close(a: Dict[str, Any], b: Dict[str, Any], fields: Any) -> bool:
    for k in fields:
        x, y = a[k], b[k]
        if tuple(x.shape) != tuple(y.shape):
            return False
        if x.is_floating_point():
            if not torch.allclose(x, y.to(x.dtype), rtol=1e-4, atol=1e-6, equal_nan=True):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def _values_close(a: Any, b: Any) -> bool:
    la, ta = tree_flatten(a)
    lb, tb = tree_flatten(b)
    if ta != tb or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            if tuple(x.shape) != tuple(y.shape):
                return False
            if x.is_floating_point() or y.is_floating_point():
                if not torch.allclose(x.to(torch.float64), y.to(torch.float64), rtol=1e-4, atol=1e-6, equal_nan=True):
                    return False
            elif not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _subtract_pad_contribution(
    metric: Any, updated: Dict[str, Any], defaults: Dict[str, Any], row0_args: tuple, row0_kwargs: dict, extra: Any
) -> Dict[str, Any]:
    """Remove the padding rows' contribution from an updated state.

    ``extra`` (a 0-d tensor) is the number of padded rows, each a copy of the
    batch's first row. For per-sample-additive ``"sum"`` states the padding
    adds exactly ``extra * (update(init, row0) - default)``; duplicated real
    rows never change a ``max``/``min`` state. The first padded call probes
    that the update is additive (see the module docstring).
    """
    d1 = metric.functional_update(dict(defaults), *row0_args, **row0_kwargs)
    out: Dict[str, Any] = {}
    for field in metric._defaults:
        if metric._reductions.get(field) == "sum":
            contrib = d1[field] - defaults[field]
            out[field] = updated[field] - contrib * extra.to(contrib.dtype)
        else:
            out[field] = updated[field]
    return out


def _new_stats() -> Dict[str, Any]:
    return {
        "calls": 0,          # calls the executor served (a replay, or a fresh key's run)
        "compiles": 0,       # distinct cache keys built (a capture each on the card)
        "cache_hits": 0,     # calls served by a captured key
        "padded_calls": 0,   # calls that padded a ragged batch up the ladder
        "donated_calls": 0,  # calls that replayed over the live slot as it stood
        "copied_calls": 0,   # calls that copied the live state in first (escaped/shared/fresh key)
        "probes": 0,         # eager oracle runs validating padded execution
        "skipped_calls": 0,  # per-call ineligibility (a capture, a transform, odd inputs)
        "dispatch_failures": 0,   # warm-dispatch failures propagated to the caller
        "recovery_restores": 0,   # live states kept at their pre-call slot after a failure
        "dispatch_retries": 0,    # warm failures re-attempted after the restore (io/retry.py)
        # the compile cache (ops/compile_cache.py)
        "disk_hits": 0,           # keys built ahead of their first call from the owner's stored profile
        "disk_stores": 0,         # store writes adding a new key's spec to the owner's entry
        "disk_evictions": 0,      # stored entries dropped because a spec's capture disagreed with its record
        "background_compiles": 0, # cold keys captured on the worker and swapped in
        "eager_misses": 0,        # calls served eagerly while their key's capture ran on the worker
        "compile_us_total": 0.0,  # wall time of fresh keys' dispatches: the eager run and the capture
        "warmup": 0,              # keys built through the warmup API
    }


@contextmanager
def _active(metrics: Sequence[Any]) -> Iterator[None]:
    """The executor's own bodies read the slots: no escape while they run."""
    for m in metrics:
        m.__dict__["_exec_active"] = m.__dict__.get("_exec_active", 0) + 1
    try:
        yield
    finally:
        for m in metrics:
            m.__dict__["_exec_active"] -= 1


# ---------------------------------------------------------------- dispatch


class _Entry:
    """One cache key: its body and, on the card, its two graphs, the
    figures of its first (eager) run and of its timed replay, and why it
    runs eagerly (``eager_reason``) once a replay lost to that run. A key
    captured over a detached copy of its owner keeps that copy
    (``owner_copy``) for as long as its graphs: they read the copy's
    tensors (its defaults, a curve's sorted thresholds)."""

    __slots__ = (
        "body", "graphs", "inputs", "scalars", "values", "launches", "replays", "timed", "replay_host_us", "replay_pre_us",
        "trial", "best_eager", "eager_reason", "desc", "timed_at", "owner_copy",
    )

    def __init__(self, body: Callable) -> None:
        self.body = body
        self.owner_copy: Any = None
        self.graphs: List[Any] = []
        self.inputs: List[torch.Tensor] = []
        self.scalars: List[torch.Tensor] = []
        self.values: List[Any] = []
        #: (counter module, attribute, launches a replay adds) of each counter a replay moves
        self.launches: List[Tuple[Any, str, int]] = []
        self.replays = 0
        #: the replay to time (0: none is)
        self.timed_at = 2
        #: the timed replay's (copy start, replay start, end) events and the
        #: host ns of the first; its whole call's host time and the host time
        #: before the copies; then its eager trials still due and the faster
        #: one's figures (us, host us, host us before launching, span us)
        self.timed: Any = None
        self.replay_host_us = 0.0
        self.replay_pre_us = 0.0
        self.trial = 0
        self.best_eager: Optional[Tuple[float, float, float, float]] = None
        self.eager_reason: Optional[str] = None
        self.desc = ""


class _Call:
    """One call's inputs: the tensor leaves (unpadded), the padding plan, the
    scalars (Python ints) the body reads as 0-d int32 tensors; for a padded
    call on a fresh key where :attr:`_Dispatcher.eager_fresh_padded`,
    ``eager``: the unpadded eager update that serves it (see
    :meth:`_Dispatcher.run_fresh`); for a warmup, ``state``: the zero state
    a fresh key's eager run reads in place of the live slot."""

    __slots__ = ("leaves", "batched", "n", "bucket", "scalars", "eager", "state")

    def __init__(self, leaves: List[Any], batched: Optional[Tuple[bool, ...]], n: Optional[int], bucket: Optional[int], scalars: List[int]) -> None:
        self.leaves = leaves
        self.batched = batched
        self.n = n
        self.bucket = bucket
        self.scalars = scalars
        self.eager: Optional[Callable[[], Any]] = None
        self.state: Any = None

    def padded_leaves(self) -> List[Any]:
        if self.batched is None:
            return list(self.leaves)
        return _pad_leaves(self.leaves, self.batched, self.bucket)


#: the capture stream of each CUDA device, shared by every executor
_CAPTURE_STREAMS: Dict[int, Any] = {}
#: the lock of each CUDA device's capture stream
_DEVICE_LOCKS: Dict[int, Any] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()

#: the allocator's entry points that release a failed capture's hold on its
#: graph pool (:meth:`_Dispatcher._release_failed_capture`); private to torch
#: (checked on torch 2.11, CUDA 12.8)
_POOL_RELEASE = ("_cuda_endAllocateToPool", "_cuda_releasePool")


def _capture_stream(device: torch.device) -> Any:
    """The device's one capture stream (call it holding the device's lock).
    Every executor captures and replays on it, so the buffers libraries
    allocate once a stream (cuBLAS workspaces) exist for one stream, not one
    an executor, where each would pin a segment of the caching allocator.
    Work queued on a capturing stream from any thread joins the graph being
    captured, so the device's lock (:func:`_device_lock`) keeps every
    capture and every replay on it apart."""
    stream = _CAPTURE_STREAMS.get(device.index)
    if stream is None:
        stream = _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return stream


def _device_lock(device: torch.device) -> Any:
    """The lock held around every capture and every replay on the device's
    capture stream, by every executor and thread."""
    with _DEVICE_LOCKS_GUARD:
        lock = _DEVICE_LOCKS.get(device.index)
        if lock is None:
            lock = _DEVICE_LOCKS[device.index] = threading.RLock()
        return lock


class _Dispatcher:
    """The state slots, the cache of keys and the way a key runs: captured
    graphs replayed on the card, the body called directly elsewhere."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.graphs = device.type == "cuda"
        if self.graphs:
            missing = [name for name in _POOL_RELEASE if not hasattr(torch._C, name)]
            if missing:
                raise RuntimeError(
                    f"this torch ({torch.__version__}) lacks torch._C.{' and torch._C.'.join(missing)}, which release"
                    " a failed capture's graph pool; without them every later free would be deferred for the rest"
                    " of the process"
                )
        self.lock = _device_lock(device) if self.graphs else None
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        #: a graph of one tiny fill, captured into the pool before the first
        #: key and kept as long as the dispatcher (:meth:`_capture_anchor`)
        self.anchor: Any = None
        #: the order of a padded call on a fresh key. On the card (True) the
        #: eager update on the batch as given serves it, so the call
        #: launches what the eager path does, and the key's first replay
        #: probes; off it (False) JAX's order: the eager oracle, then the
        #: padded body, whose counters the CPU tests hold to JAX's. Either
        #: order runs on either device (``test_card_order_of_a_fresh_padded_key``)
        self.eager_fresh_padded = self.graphs
        #: whether a key's timed replay is judged against its eager run (the
        #: card tests of replay mechanics turn it off)
        self.judging = True
        self.entries: Dict[Any, _Entry] = {}
        #: the entry whose timed replay waits for :meth:`judge`
        self.pending_verdict: Optional[_Entry] = None
        self.slots: Optional[List[List[torch.Tensor]]] = None
        self.spec: Any = None
        self.cur = 0
        self.slot_ids: frozenset = frozenset()
        #: the longest a replay waited for the device's lock (ns): a
        #: capture on another thread holds it
        self.lock_wait_ns_max = 0

    # ------------------------------------------------------------ slots
    def ensure_slots(self, state_tree: Any, flat: Optional[Tuple[List[Any], Any]] = None) -> None:
        """Two slots shaped like ``state_tree`` (``flat``: its
        :func:`tree_flatten`, when the caller has it); a new layout drops
        every key."""
        leaves, spec = tree_flatten(state_tree) if flat is None else flat
        if self.slots is not None and spec == self.spec and all(
            s.shape == v.shape and s.dtype == v.dtype for s, v in zip(self.slots[0], leaves)
        ):
            return
        self.entries.clear()
        self.slots = [[torch.empty_like(v, memory_format=torch.contiguous_format) for v in leaves] for _ in range(2)]
        self.spec = spec
        self.cur = 0
        self.slot_ids = frozenset(id(t) for slot in self.slots for t in slot)

    def slot_tree(self, d: int) -> Any:
        return tree_unflatten(self.spec, self.slots[d])

    def load(self, state_tree: Any, leaves: Optional[List[Any]] = None) -> None:
        """Copy the live state into the current slot (tensors already there,
        or views of them, stay)."""
        for dst, src in zip(self.slots[self.cur], tree_flatten(state_tree)[0] if leaves is None else leaves):
            if dst is not src and (dst.data_ptr() != src.data_ptr() or dst.stride() != src.stride()):
                dst.copy_(src)

    def install_fresh(self, state_tree: Any) -> Any:
        """A fresh key's eager result becomes the current slot's content."""
        self.load(state_tree)
        return self.slot_tree(self.cur)

    def commit(self) -> Any:
        """After a replay: the slot it wrote is the live state."""
        self.cur ^= 1
        return self.slot_tree(self.cur)

    def static_bytes(self) -> int:
        total = sum(t.numel() * t.element_size() for slot in (self.slots or []) for t in slot)
        for entry in self.entries.values():
            total += sum(t.numel() * t.element_size() for t in entry.inputs + entry.scalars)
        return total

    def pool_bytes(self) -> int:
        """Bytes of the private graph pool's segments (0 off the card)."""
        if not self.graphs:
            return 0
        pool = tuple(self.pool)
        return sum(
            int(seg["total_size"]) for seg in torch.cuda.memory_snapshot() if tuple(seg.get("segment_pool_id", ())) == pool
        )

    # --------------------------------------------------------- running
    def _scalar_tensors(self, values: List[int]) -> List[torch.Tensor]:
        return [torch.tensor(v, dtype=torch.int32, device=self.device) for v in values]

    def run_fresh(self, entry: _Entry, call: _Call, metrics: Sequence[Any], body: Optional[Callable] = None) -> Any:
        """A fresh key: run its body eagerly on the live slot, on the
        caller's stream as the eager path does (the kernels' libraries are
        built and their attributes set before the capture), then capture
        its graphs on the card. Returns the body's ``(state, value)``, which
        serves the call. A padded call with ``call.eager`` runs it, the
        update on the unpadded batch, in place of the padded body; the
        graphs are captured at the padded shapes. ``body`` (default the
        entry's) is what runs and is captured: a background capture runs a
        detached copy's, whose ``metrics`` it names."""
        body = entry.body if body is None else body
        state = self.slot_tree(self.cur) if call.state is None else call.state
        with _active(metrics):
            if call.eager is not None:
                new_state, value = call.eager()
            else:
                new_state, value = body(state, self._scalar_tensors(call.scalars), *call.padded_leaves())
        self._check_layout(new_state)
        result = (new_state, self._detached(value))
        if self.graphs:
            try:
                self._capture(entry, call, metrics, body)
            except Exception as err:
                raise _CaptureFailed(err, result) from err
        return result

    def _check_layout(self, new_state: Any) -> None:
        """A state whose shape or dtype an update changes cannot live in
        fixed slots: the executor steps aside for it."""
        new_leaves, spec = tree_flatten(new_state)
        if spec != self.spec:
            raise RuntimeError("the update changed the state's structure; fixed state slots cannot follow it")
        for dst, src in zip(self.slots[0], new_leaves):
            if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
                raise RuntimeError(
                    "the update changed a state's shape or dtype"
                    f" ({tuple(dst.shape)} {dst.dtype} -> {tuple(getattr(src, 'shape', ()))} {getattr(src, 'dtype', None)});"
                    " fixed state slots cannot follow it"
                )

    def _capture(self, entry: _Entry, call: _Call, metrics: Sequence[Any], body: Callable) -> None:
        from torchmetrics_tpu_torch.ops.kernels import shared_scope

        inputs = [
            torch.empty(((call.bucket,) + tuple(x.shape[1:])) if is_batched else tuple(x.shape), dtype=x.dtype, device=x.device)
            for x, is_batched in zip(call.leaves, call.batched or (False,) * len(call.leaves))
        ]
        scalars = [torch.zeros((), dtype=torch.int32, device=self.device) for _ in call.scalars]
        graphs, values = [], []
        with self.lock, launch_counts.capture_scope() as recorded:
            # no cyclic collection inside a capture: a collected graph's
            # destruction is not permitted while the stream captures. Under
            # the lock, so a capture waiting for another never reads the
            # other's switch as its own. The scope takes this thread's
            # launches out of the counts (a capture launches nothing), and
            # only this thread's: another's eager launches meanwhile stay
            collecting = gc.isenabled()
            gc.disable()
            try:
                stream = _capture_stream(self.device)
                stream.wait_stream(torch.cuda.current_stream(self.device))
                if self.anchor is None:
                    self.anchor = self._capture_anchor(stream)
                for d in (0, 1):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.stream(stream), _active(metrics):
                        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                        try:
                            with shared_scope():
                                new_state, value = body(self.slot_tree(d), scalars, *inputs)
                                self._write_slot(1 - d, new_state)
                        except BaseException:
                            try:
                                graph.capture_end()
                            except Exception as end_err:  # the capture is invalid: keep the first error
                                rank_zero_debug(f"torchmetrics_tpu_torch executor: capture_end after a failure: {end_err}")
                                self._release_failed_capture()
                            raise
                        graph.capture_end()
                    graphs.append(graph)
                    values.append(value)
            finally:
                if collecting:
                    gc.enable()
        entry.graphs, entry.inputs, entry.scalars, entry.values = graphs, inputs, scalars, values
        entry.launches = [(sys.modules[name], attr, n // 2) for (name, attr), n in sorted(recorded.items())]

    def _capture_anchor(self, stream: Any) -> Any:
        """The pool's anchor. Every graph holds the pool it was captured into,
        in the device's and the host's caching allocators, and gives it back
        when freed; a capture into a pool that no graph holds fails their
        assertion ``use_count > 0``. A key judged eager frees its graphs, so
        without the anchor a dispatcher whose keys had all gone eager could
        capture no later key. It keeps the pool's segments (its 2 MB one and
        those freed keys leave) until the dispatcher goes."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                torch.zeros(1, device=self.device)
            finally:
                graph.capture_end()
        return graph

    def _release_failed_capture(self) -> None:
        """A capture whose end failed (the capture was invalidated) may
        leave the caching allocator routing to the pool and counting a
        capture underway, which defers every later free for good (the
        reserved memory then only grows), and it leaves no graph to hand
        the pool back. End the routing (a no-op error where it already
        ended) and release this capture's hold on the pool. The failed end
        also skips the default CUDA generator's capture epilogue, which
        leaves its state capturing, and every later draw from it raises
        ("Offset increment outside graph capture"): the generator takes a
        fresh state with the same seed and offset."""
        index, pool = self.device.index, tuple(self.pool)
        try:
            torch._C._cuda_endAllocateToPool(index, pool)
        except RuntimeError:  # the failed end had already stopped the routing
            pass
        torch._C._cuda_releasePool(index, pool)
        generator = torch.cuda.default_generators[index]
        generator.graphsafe_set_state(generator.clone_state())
        if torch.cuda.is_current_stream_capturing():
            # the stream never left its capture: no later capture may use it
            _CAPTURE_STREAMS.pop(index, None)

    def _write_slot(self, d: int, new_state: Any) -> None:
        self._check_layout(new_state)
        for dst, src in zip(self.slots[d], tree_flatten(new_state)[0]):
            if dst is not src:
                dst.copy_(src)

    def run_warm(self, entry: _Entry, call: _Call, metrics: Sequence[Any]) -> Any:
        """A captured key: copy the inputs in and replay the graph that reads
        the live slot (on the card), or call the body and write the other
        slot (off it). Returns ``(state in the other slot, value)``; nothing
        is committed until :meth:`commit`."""
        d = self.cur
        if not self.graphs:
            with _active(metrics):
                new_state, value = entry.body(self.slot_tree(d), self._scalar_tensors(call.scalars), *call.padded_leaves())
                self._write_slot(1 - d, new_state)
            return self.slot_tree(1 - d), self._detached(value)
        entry.replays += 1
        timed = self.judging and entry.replays == entry.timed_at  # the first replay may still set up
        if timed and pending_reads():
            self.defer_verdict(entry)
            timed = False
        if timed:
            events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(3))
            events[0].record()
            t_copy_ns = time.perf_counter_ns()
        for buf, x, is_batched in zip(entry.inputs, call.leaves, call.batched or (False,) * len(call.leaves)):
            n = int(x.shape[0]) if is_batched else None
            if n is None or n == buf.shape[0]:
                if x.data_ptr() != buf.data_ptr() or x.stride() != buf.stride():
                    buf.copy_(x)
            else:
                buf[:n].copy_(x)
                buf[n:].copy_(x[:1].expand((buf.shape[0] - n,) + tuple(x.shape[1:])))
        for buf, v in zip(entry.scalars, call.scalars):
            buf.fill_(v)
        caller = torch.cuda.current_stream(self.device)
        t_wait_ns = time.perf_counter_ns()
        with self.lock:
            waited_ns = time.perf_counter_ns() - t_wait_ns
            if waited_ns > self.lock_wait_ns_max:
                self.lock_wait_ns_max = waited_ns
            stream = _capture_stream(self.device)
            if timed:
                events[1].record(caller)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                entry.graphs[d].replay()
            caller.wait_stream(stream)
        if timed:
            events[2].record(caller)
            entry.timed = (events, t_copy_ns)
            self.pending_verdict = entry
        for m, attr, n in entry.launches:
            launch_counts.add(m, attr, n)
        value = entry.values[d]
        return self.slot_tree(1 - d), (None if value is None else self._detached(value, always=True))

    @staticmethod
    def defer_verdict(entry: _Entry) -> None:
        """Time the key's next replay in place of this one (none after
        :data:`_VERDICT_DEFERRALS` such replays)."""
        entry.timed = None
        entry.timed_at = entry.replays + 1 if entry.replays < 2 + _VERDICT_DEFERRALS else 0

    @staticmethod
    def note_trial(entry: _Entry, eager_host_us: float, eager_pre_us: float, e_start: Any, e_end: Any) -> None:
        """Keep an eager trial's figures where it is the key's faster one. A
        call takes the larger of its host time and its host time before its
        first launch plus its launches' span on the stream."""
        e_end.synchronize()
        span_us = e_start.elapsed_time(e_end) * 1e3
        figures = (max(eager_host_us, eager_pre_us + span_us), eager_host_us, eager_pre_us, span_us)
        if entry.best_eager is None or figures[0] < entry.best_eager[0]:
            entry.best_eager = figures

    def judge(self, entry: _Entry) -> Optional[str]:
        """After a key's eager trials: why it runs eagerly from now on (its
        graphs and static inputs freed), or None to keep replaying: the
        timed replay (its input copies and the replay on the stream) against
        the faster eager trial, each as :meth:`note_trial` reckons a call."""
        (c_start, r_start, r_end), _ = entry.timed
        entry.timed = None
        copy_us = c_start.elapsed_time(r_start) * 1e3
        replay_us = r_start.elapsed_time(r_end) * 1e3
        eager_us, eager_host_us, eager_pre_us, eager_span_us = entry.best_eager
        captured_us = max(entry.replay_host_us, entry.replay_pre_us + copy_us + replay_us)
        if captured_us <= _KEEP_SHARE * eager_us:
            return None
        entry.eager_reason = (
            f"{entry.desc}: the replay took {captured_us:.0f} us, over {_KEEP_SHARE:.0%} of the eager call's"
            f" (host {entry.replay_host_us:.0f}, of which"
            f" {entry.replay_pre_us:.0f} before its input copies {copy_us:.0f} and replay {replay_us:.0f} of device time)"
            f" against the faster of {_EAGER_TRIALS} eager calls' {eager_us:.0f} us (host {eager_host_us:.0f}, of which"
            f" {eager_pre_us:.0f} before its launches, which spanned {eager_span_us:.0f})"
        )
        entry.graphs, entry.inputs, entry.scalars, entry.values = [], [], [], []
        entry.owner_copy = None
        return entry.eager_reason

    def _detached(self, value: Any, always: bool = False) -> Any:
        """A batch value the caller may keep: graph outputs and slot tensors
        are copied, so nothing handed out is ever written by a replay."""
        if value is None:
            return None
        leaves, spec = tree_flatten(value)
        return tree_unflatten(
            spec,
            [
                v.clone() if isinstance(v, torch.Tensor) and (always or id(v) in self.slot_ids) else v
                for v in leaves
            ],
        )


class WarmupHandle:
    """Handle for a background :meth:`warmup` run: ``wait()`` joins the
    thread and returns the report dict; ``done`` polls."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._report: Optional[Dict[str, Any]] = None
        self._error: Optional[BaseException] = None

    def _run(self, body: Callable, jobs: Any, ladder: bool) -> None:
        try:
            self._report = body(jobs, ladder)
        except BaseException as err:  # surfaced on wait(), never lost
            self._error = err
            rank_zero_debug(f"torchmetrics_tpu_torch warmup thread failed: {type(err).__name__}: {err}")

    @property
    def done(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return None
        if self._error is not None:
            raise self._error
        return self._report


# ------------------------------------------------------------ shape specs


def _concrete_warmup_leaf(leaf: Any, device: torch.device) -> Any:
    """Example leaf -> zeros of its shape and dtype on ``device`` (a tensor,
    a ``"meta"`` tensor standing for a shape and dtype); bools pass."""
    if isinstance(leaf, torch.Tensor):
        return torch.zeros(tuple(leaf.shape), dtype=leaf.dtype, device=device)
    return leaf


def _normalize_warmup_specs(batch_specs: Any, device: torch.device) -> List[Tuple[tuple, dict]]:
    """One spec or a sequence of specs; each an args tuple (optionally an
    ``(args_tuple, kwargs_dict)`` pair) of tensors or meta tensors. Returns
    zero-filled ``(args, kwargs)`` on ``device``."""
    if isinstance(batch_specs, tuple) and batch_specs and not isinstance(batch_specs[0], (tuple, list)):
        batch_specs = [batch_specs]
    out: List[Tuple[tuple, dict]] = []
    for spec in batch_specs:
        if isinstance(spec, (tuple, list)) and len(spec) == 2 and isinstance(spec[0], (tuple, list)) and isinstance(spec[1], dict):
            args, kwargs = tuple(spec[0]), dict(spec[1])
        elif isinstance(spec, (tuple, list)):
            args, kwargs = tuple(spec), {}
        else:
            args, kwargs = (spec,), {}
        out.append(
            (
                tuple(_concrete_warmup_leaf(a, device) for a in args),
                {k: _concrete_warmup_leaf(v, device) for k, v in kwargs.items()},
            )
        )
    return out


class _KeyPlan:
    """What builds one key away from its call: the key, the function that
    makes its body (``build(target)``: over the live owner, or over a
    detached copy), the owner's zero state, a :class:`_Call` over zero
    dummies, the spec a store records (``spec``: the manifest's, plus
    ``"exact"``; None when the call is not replayable) and, for a stored
    spec, its record."""

    __slots__ = ("key", "build", "zero_state", "call", "spec", "record")

    def __init__(self, key: Any, build: Callable[[Any], Callable], zero_state: Callable[[], Any], call: _Call, spec: Optional[Dict[str, Any]]) -> None:
        self.key = key
        self.build = build
        self.zero_state = zero_state
        self.call = call
        self.spec = spec
        self.record: Dict[str, Any] = {}


def _store_spec(kind: str, args: tuple, kwargs: dict, padded: bool) -> Optional[Dict[str, Any]]:
    """A key's spec as the store records it: the manifest's spec of the
    call, and whether its batch was keyed exactly or padded up the ladder."""
    spec = spec_of_call(kind, args, kwargs)
    return None if spec is None else dict(spec, exact=not padded)


def _spec_id(record: Dict[str, Any]) -> str:
    """A stored spec's identity (its launches aside), the same before and
    after a JSON round trip."""
    import json

    return json.dumps({k: record.get(k) for k in ("kind", "args", "kwargs", "exact")}, sort_keys=True)


def _launch_record(entry: _Entry) -> Dict[str, int]:
    """The launches one replay of a key makes, by counter (none off the card)."""
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{attr}": int(n) for m, attr, n in entry.launches}


# ------------------------------------------------------------------- base


class _ExecutorBase:
    """Shared cache, stats and containment plumbing of the metric and
    collection executors."""

    def __init__(self) -> None:
        self.stats = _new_stats()
        # global telemetry aggregation (obs/registry.py): weak, summed only
        # when telemetry_snapshot() asks
        obs.register_executor(self)
        self.disabled_reason: Optional[str] = None
        self._static_reason_cached: Any = ()  # sentinel: not yet computed
        self._pad_validated = False
        self._bucketing_ok = True
        self._profile: Dict[str, Dict[str, Any]] = {}
        self._profile_keys: set = set()
        self._dispatcher: Optional[_Dispatcher] = None
        self._state_sig_memo: Any = None
        #: batch sizes keyed exactly, and the size of the call before
        self._exact_sizes: set = set()
        self._last_n: Optional[int] = None
        #: keys found slower than their eager call (run eagerly since),
        #: the calls served eagerly (their trials and after), and why
        self._eager: Dict[str, Any] = {"keys": 0, "calls": 0, "reasons": []}
        #: the eager trial under way: (entry, its call's host start ns, host
        #: ns at its start event, the start event); the running call's start
        #: and its inputs' cheap signature (:func:`_call_sig`)
        self._trial: Any = None
        self._call_t0_ns = 0
        self._call_sig: Any = None
        #: the cheap signatures of the calls whose keys run eagerly: such a
        #: call steps aside before any key is built
        self._eager_sigs: set = set()
        #: the update count(s) one committed update behind the live state
        #: whose slot the last replay read (:func:`latest_recovery_snapshot`);
        #: None after any call that did not replay
        self._last_recovery: Any = None
        # one dispatch or warmup of this executor at a time (its slots and
        # keys); the device's lock keeps captures and replays apart
        self._lock = threading.RLock()
        # the compile cache: the background override (None: the
        # environment's default), the keys whose capture is on the worker,
        # whether the owner's stored profile was read, and its records as
        # this executor knows them (spec id -> record)
        self._bg_compile: Optional[bool] = None
        self._pending_keys: set = set()
        self._pending_lock = threading.Lock()
        self._store_checked = False
        self._stored: Dict[str, Dict[str, Any]] = {}

    def _owner_name(self) -> str:
        return type(self).__name__

    def _device(self) -> torch.device:
        raise NotImplementedError

    def _members(self) -> List[Any]:
        """Every metric whose state the bodies read (escape suppression)."""
        raise NotImplementedError

    def _owner_desc(self) -> str:
        """Cross-process identity of the owner's computation (its store entry)."""
        raise NotImplementedError

    def _clone_owner(self) -> Tuple[Any, List[Any]]:
        """A detached copy of the owner (its executors off) and its metrics,
        for a capture off the live thread: a body swaps its metric's state
        while it runs, so a worker never runs the live owner's."""
        raise NotImplementedError

    def _plan_for(self, kind: str, args: tuple, kwargs: dict, mode: str) -> Any:
        """The :class:`_KeyPlan` of a call of ``kind`` on zero dummies shaped
        like ``args``/``kwargs`` (keyed as ``mode``), or why none can be built."""
        raise NotImplementedError

    def dispatcher(self) -> _Dispatcher:
        if self._dispatcher is None:
            self._dispatcher = _Dispatcher(self._device())
        return self._dispatcher

    def _disable(self, reason: str) -> None:
        """Fall back to the eager path for good, RECORDING why (surfaced by
        ``executor_status`` and :func:`executor_stats`, logged once)."""
        if self.disabled_reason is None:
            rank_zero_debug(
                f"torchmetrics_tpu_torch executor disabled for {self._owner_name()}: {reason}"
                " (eager fallback; see Metric.executor_status)"
            )
            obs.fault_breadcrumb("executor_disabled", domain="dispatch", data={"owner": self._owner_name(), "reason": reason})
        self.disabled_reason = reason

    def _restore(self, metric: Any) -> None:
        """After a failed donated dispatch: the live state still is the slot
        the call read, which the call never wrote; the next call copies."""
        self.stats["recovery_restores"] += 1
        metric.__dict__["_state_escaped"] = True

    def _guarded_dispatch(
        self, primary: Callable[[], Any], retry_call: Callable[[], Any], fresh: bool, restore: Callable[[], None]
    ) -> Any:
        """Run a dispatch under the stall watchdog with transient-failure
        retries (``io/retry.py``). A fresh key's failure propagates raw (the
        sticky eager fallback upstream); a warm failure restores, retries up
        to ``TORCHMETRICS_TPU_DISPATCH_RETRIES`` times and raises
        :class:`_DispatchFailure`. A :class:`DispatchStallError` is never
        retried."""
        from torchmetrics_tpu_torch.io.retry import (
            RetryPolicy,
            backoff_delays,
            default_dispatch_deadline,
            default_dispatch_retries,
            stall_watchdog,
        )

        deadline = default_dispatch_deadline()

        def once(call: Callable[[], Any]) -> Any:
            if deadline is None:
                return call()
            with stall_watchdog(deadline, what=f"captured dispatch for {self._owner_name()}", status=self.stats_dict):
                return call()

        try:
            return once(primary)
        except Exception as err:
            if fresh or isinstance(err, _CaptureFailed):
                raise
            restore()
            self.stats["dispatch_failures"] += 1
            retries = default_dispatch_retries()
            if retries and not isinstance(err, DispatchStallError):
                for delay in backoff_delays(RetryPolicy(max_retries=retries)):
                    time.sleep(delay)
                    self.stats["dispatch_retries"] += 1
                    try:
                        return once(retry_call)
                    except DispatchStallError as stalled:
                        err = stalled
                        break
                    except Exception as again:
                        rank_zero_debug(
                            f"torchmetrics_tpu_torch executor: retry dispatch for {self._owner_name()}"
                            f" failed again ({type(again).__name__}: {again})"
                        )
                        err = again
            raise _DispatchFailure(err)

    def _get_fn(
        self, key: Any, builder: Callable[[], Callable], plan: Optional[Callable[[], "_KeyPlan"]] = None
    ) -> Tuple[Optional[Callable[..., Any]], bool]:
        """Resolve ``key`` to its dispatch callable ``fn(call) -> (state,
        value)`` and whether the key is fresh (built now; ``compiles``).
        ``(None, False)`` for a key that runs eagerly: one judged so, or a
        cold key whose capture runs on the worker (``plan``: the key's
        :class:`_KeyPlan`, for the worker; ``eager_misses``)."""
        disp = self.dispatcher()
        if not self._store_checked:
            self.consult_store()
        entry = disp.entries.get(key)
        if entry is not None and (entry.eager_reason is not None or entry.trial):
            if entry.trial:  # time this call's eager path (see :meth:`eager_done`)
                entry.trial -= 1
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                self._trial = (entry, self._call_t0_ns, time.perf_counter_ns(), start, self._call_sig)
            self._step_aside()
            return None, False
        if entry is not None and (entry.graphs or not disp.graphs):
            self.stats["cache_hits"] += 1
            members = self._members()
            return (lambda call: disp.run_warm(entry, call, members)), False
        if plan is not None:
            with self._pending_lock:
                pending = key in self._pending_keys
            if pending or (self.background_enabled() and compile_cache.compile_ahead_enabled() and self._submit_build(plan(), "background")):
                self._eager_miss()
                return None, False
        entry = disp.entries[key] = _Entry(builder())
        entry.desc = _describe_key(key)
        self.stats["compiles"] += 1
        members = self._members()
        return (lambda call: disp.run_fresh(entry, call, members)), True

    def _judge_replay(self, t0_ns: int) -> None:
        """After an update whose replay was timed: keep the whole call's
        host time; the key's next call is its eager trial."""
        disp = self._dispatcher
        entry = None if disp is None else disp.pending_verdict
        if entry is None:
            return
        disp.pending_verdict = None
        if pending_reads() or last_read_done_ns() >= t0_ns:  # a read ran beside this call
            disp.defer_verdict(entry)
            return
        entry.replay_host_us = (time.perf_counter_ns() - t0_ns) / 1e3
        entry.replay_pre_us = (entry.timed[1] - t0_ns) / 1e3
        entry.trial = _EAGER_TRIALS

    def _steps_aside_at_once(self, args: tuple, kwargs: dict) -> bool:
        """Whether this update's inputs are those of a key that runs
        eagerly: it steps aside before any key is built (``eager["calls"]``)."""
        self._call_sig = sig = _call_sig(args, kwargs) if self._dispatcher is not None and self._dispatcher.graphs else None
        if sig is None or sig not in self._eager_sigs:
            return False
        self._step_aside()
        return True

    def _step_aside(self) -> None:
        """A call the eager path serves: counted, and every member's state
        marked escaped (the eager update replaces the slot tensors)."""
        self._eager["calls"] += 1
        for m in self._members():
            m.__dict__["_state_escaped"] = True

    def _eager_miss(self) -> None:
        """A cold key's call the eager path serves while the worker captures
        the key: counted, and every member's state marked escaped."""
        self.stats["eager_misses"] += 1
        for m in self._members():
            m.__dict__["_state_escaped"] = True

    def _forget_forward_timing(self) -> None:
        """Forward keys are not judged: drop a timed replay's figures."""
        if self._dispatcher is not None:
            self._dispatcher.pending_verdict = None

    def eager_done(self) -> None:
        """The caller's eager path finished the call this executor stepped
        aside from: if it was a key's eager trial, note it, and after the
        key's last trial judge the key (:meth:`_Dispatcher.judge`)."""
        trial, self._trial = self._trial, None
        if trial is None:
            return
        entry, t0_ns, t_start_ns, start, trial_sig = trial
        host_us = (time.perf_counter_ns() - t0_ns) / 1e3
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._dispatcher.note_trial(entry, host_us, (t_start_ns - t0_ns) / 1e3, start, end)
        if entry.trial:
            return
        reason = self._dispatcher.judge(entry)
        if reason is not None:
            self._eager["keys"] += 1
            self._eager["reasons"].append(reason)
            if trial_sig is not None:
                self._eager_sigs.add(trial_sig)
            rank_zero_debug(f"torchmetrics_tpu_torch executor: {self._owner_name()} runs a key eagerly: {reason}")

    def _exact_batch(self, n: int, mode: str) -> bool:
        """Whether a batch of ``n`` rows gets an exact key (no padding).
        ``mode``: ``"call"`` (traffic: a size that repeats the call
        before's, or one already keyed exactly), ``"steady"`` (a warmup's
        spec: the traffic's size) or ``"ladder"`` (a warmup's rung or a
        manifest's shape: the JAX package's ladder)."""
        if bucket_size(n) == n:
            exact = True
        elif mode == "ladder":
            exact = False
        else:
            exact = n in self._exact_sizes
            if not exact and (mode == "steady" or n == self._last_n) and len(self._exact_sizes) < _EXACT_SIZES:
                self._exact_sizes.add(n)
                exact = True
        if mode == "call":
            self._last_n = n
        return exact

    def _timed_dispatch(self, fresh: bool, primary: Callable, retry_call: Callable, restore: Callable) -> Any:
        t_cold_ns = time.perf_counter_ns() if fresh else None
        with obs.span(obs.SPAN_DISPATCH, suffix=self._owner_name(), histogram="executor.dispatch_us", cold=fresh):
            out = self._guarded_dispatch(primary, retry_call, fresh, restore)
        if t_cold_ns is not None:
            t_now_ns = time.perf_counter_ns()
            self.stats["compile_us_total"] += (t_now_ns - t_cold_ns) / 1e3
            obs.record_span(obs.SPAN_COMPILE, t_cold_ns, t_now_ns, {"owner": self._owner_name()})
        return out

    def _prepare_leaves(self, leaves: List[Any], bucketable: bool, mode: str = "call"):
        """(signature, padding plan) of a call's leaves, or None when the call
        is ineligible. ``mode`` as :meth:`_exact_batch`."""
        sig = _classify_leaves(leaves)
        if sig is None:
            return None
        n = _common_batch_dim(leaves)
        bucket, padded, batched = None, False, None
        if n is not None and n > 0 and bucketable and not self._exact_batch(n, mode):
            bucket = bucket_size(n)
            padded = bucket != n
        if padded:
            with obs.span(obs.SPAN_PAD, n=int(n), bucket=int(bucket)):
                batched = tuple(isinstance(l, torch.Tensor) and l.ndim >= 1 and int(l.shape[0]) == n for l in leaves)
                sig = tuple(
                    ((bucket,) + s[0][1:],) + s[1:] if b else s for s, b in zip(sig, batched)
                )
        dyn, bool_spec = _split_static_bools(leaves)
        dyn_batched = None if batched is None else tuple(b for b, l in zip(batched, leaves) if type(l) is not bool)
        return sig, dyn, dyn_batched, bucket, n, padded, bool_spec, len(leaves)

    # ------------------------------------------------------- shape profile
    def _record_profile(self, key: Any, kind: str, args: tuple, kwargs: dict) -> None:
        if key in self._profile_keys:
            return
        self._profile_keys.add(key)
        if len(self._profile) >= _PROFILE_CAP:
            return
        spec = spec_of_call(kind, args, kwargs)
        if spec is None:
            return
        self._profile.setdefault(repr(sorted(spec.items(), key=lambda kv: kv[0])), spec)

    def shape_profile(self) -> Dict[str, Any]:
        """Replayable manifest of every (bounded) distinct call shape this
        executor has served: feed it to ``warmup_from_manifest``."""
        return {"profile_version": PROFILE_VERSION, "owner": self._owner_name(), "specs": list(self._profile.values())}

    # -------------------------------------------------------------- warmup
    def _warmup_one(self, kind: str, args: tuple, kwargs: dict, mode: str) -> str:
        raise NotImplementedError

    def _warmup_bucketable(self) -> bool:
        raise NotImplementedError

    def _ladder_variants(self, args: tuple, kwargs: dict) -> List[Tuple[tuple, dict]]:
        """The spec itself plus one padded representative per rung at or
        below its bucket, so an epoch's ragged last batch lands warm too."""
        out = [(args, kwargs)]
        spec = spec_of_call("x", args, kwargs)
        if spec is None or not self._warmup_bucketable():
            return out
        dims = {s["shape"][0] for s in list(spec["args"]) + list(spec["kwargs"].values()) if s.get("shape")}
        if len(dims) != 1:
            return out
        n = dims.pop()
        if n <= 0:
            return out
        rung, top = _BUCKET_FLOOR, bucket_size(n)
        while rung <= top:
            size = max(1, rung - 1)
            if size != n:
                resized = {
                    "args": [dict(s, shape=[size] + s["shape"][1:]) if s.get("shape") and s["shape"][0] == n else s for s in spec["args"]],
                    "kwargs": {
                        k: dict(s, shape=[size] + s["shape"][1:]) if s.get("shape") and s["shape"][0] == n else s
                        for k, s in spec["kwargs"].items()
                    },
                }
                out.append(dummy_from_spec(resized, self._device()))
            rung <<= 1
        return out

    def warmup(self, batch_specs: Any, forward: bool = False, ladder: bool = True, background: bool = False) -> Any:
        """Build the keys ``batch_specs``-shaped traffic will hit, ahead of it.

        ``batch_specs``: one spec or a sequence of specs, each a tuple of
        example tensors or ``"meta"`` tensors (optionally ``(args, kwargs)``).
        Zero-filled dummies run through a zero state; the live state is never
        touched. ``ladder=True`` also builds one padded representative per
        rung; ``background=True`` runs on a daemon thread and returns a
        :class:`WarmupHandle`, else the report dict.
        """
        jobs = [("update", a, k, "steady") for a, k in _normalize_warmup_specs(batch_specs, self._device())]
        if forward:
            jobs += [("forward", a, k, mode) for _, a, k, mode in list(jobs)]
        return self._launch_warmup(jobs, ladder, background)

    def warmup_from_manifest(self, manifest: Any, background: bool = False) -> Any:
        """Replay a shape-profile manifest (the dict :meth:`shape_profile`
        returns, or a path ``save_shape_profile`` wrote): builds exactly the
        call shapes recorded, no ladder."""
        if isinstance(manifest, (str, os.PathLike)):
            manifest = compile_cache.load_shape_manifest(os.fspath(manifest))
        if not isinstance(manifest, dict) or not isinstance(manifest.get("specs"), list):
            raise ValueError("manifest has no 'specs' list")
        jobs = []
        for spec in manifest["specs"]:
            args, kwargs = dummy_from_spec(spec, self._device())
            jobs.append((spec.get("kind", "update"), args, kwargs, "ladder"))
        return self._launch_warmup(jobs, ladder=False, background=background)

    def _launch_warmup(self, jobs: List[Tuple[str, tuple, dict, str]], ladder: bool, background: bool) -> Any:
        if not background:
            return self._run_warmup(jobs, ladder)
        handle = WarmupHandle()
        thread = threading.Thread(target=handle._run, args=(self._run_warmup, jobs, ladder), name="tm_tpu_warmup", daemon=True)
        handle._thread = thread
        thread.start()
        return handle

    def _run_warmup(self, jobs: List[Tuple[str, tuple, dict, str]], ladder: bool) -> Dict[str, Any]:
        """Build each job's key (a warmup spec is the traffic's steady size,
        a manifest's shape and every rung go up the ladder)."""
        t0 = time.perf_counter()
        report: Dict[str, Any] = {"warmed": 0, "already_warm": 0, "skipped": []}
        for kind, args, kwargs, mode in jobs:
            variants = self._ladder_variants(args, kwargs) if ladder else [(args, kwargs)]
            for i, (v_args, v_kwargs) in enumerate(variants):
                try:
                    outcome = self._warmup_one(kind, v_args, v_kwargs, mode if i == 0 else "ladder")
                except Exception as err:  # warmup never takes the loop down
                    outcome = f"{kind}: {type(err).__name__}: {err}"
                    rank_zero_debug(f"torchmetrics_tpu_torch warmup: {self._owner_name()}: {outcome}")
                if outcome == "warmed":
                    report["warmed"] += 1
                elif outcome == "already_warm":
                    report["already_warm"] += 1
                else:
                    report["skipped"].append(outcome)
        report["seconds"] = round(time.perf_counter() - t0, 3)
        return report

    def _dispatch_warmup(self, plan: "_KeyPlan") -> str:
        """Shared tail of the warmup paths: build ``plan``'s key (its eager
        run on a zero state and zero dummies, discarded, and its capture);
        the live state is never read or written. The owner's stored profile
        is read first, as at a first call."""
        disp = self.dispatcher()
        if not self._store_checked:
            self.consult_store()
        if plan.key in disp.entries:
            return "already_warm"
        t0 = time.perf_counter()
        with obs.span(obs.SPAN_WARMUP, owner=self._owner_name()), self._lock:
            disp.ensure_slots(plan.zero_state())
            entry = self._build_key(plan)
            disp.entries[plan.key] = entry
            self.stats["compiles"] += 1
        self.stats["warmup"] += 1
        self.stats["compile_us_total"] += (time.perf_counter() - t0) * 1e6
        self._schedule_store(plan.spec, entry)
        return "warmed"

    # ----------------------------------------------------- the compile cache
    def background_enabled(self) -> bool:
        """Whether cold keys capture on the background worker (the
        instance's override, else ``TORCHMETRICS_TPU_BG_COMPILE``)."""
        if self._bg_compile is not None:
            return self._bg_compile
        return compile_cache.background_compile_default()

    def set_background_compile(self, enabled: Optional[bool]) -> None:
        """Override stall-free background captures for this executor (None
        restores the environment's default)."""
        self._bg_compile = enabled

    def _backend(self) -> str:
        return compile_cache.backend_fingerprint(self._device())

    def store_desc(self) -> str:
        """The owner's full description: its store entry's key."""
        return "|".join((compile_cache.toolchain_fingerprint(), self._backend(), self._owner_desc()))

    def _build_key(self, plan: "_KeyPlan", clone: Any = None) -> _Entry:
        """Build ``plan``'s key: its body's eager run on a zero state and
        zero dummies (discarded), then its capture on the card. With
        ``clone`` (``(owner, metrics)`` of :meth:`_clone_owner`) the copy's
        body runs and is captured, and the live owner is never touched; the
        entry then holds the copy, whose tensors its graphs read. The entry
        is returned, not installed."""
        entry = _Entry(plan.build(None))
        entry.desc = _describe_key(plan.key)
        body, members = (entry.body, self._members()) if clone is None else (plan.build(clone[0]), clone[1])
        entry.owner_copy = clone
        plan.call.state = plan.zero_state()
        try:
            self.dispatcher().run_fresh(entry, plan.call, members, body)
        except _CaptureFailed as failed:
            raise failed.original
        return entry

    def consult_store(self) -> None:
        """Read the owner's stored profile (once) and build every key it
        records ahead of its first call: each on the worker when background
        captures are on, else inline (each built key a ``disk_hits``). A
        record whose capture makes other launches than it recorded evicts
        the entry (:meth:`_evict_store`)."""
        if self._store_checked:
            return
        self._store_checked = True
        if not compile_cache.compile_ahead_enabled():
            return
        with obs.span(obs.SPAN_CACHE_LOAD, owner=self._owner_name()):
            profile = compile_cache.load_profile(self.store_desc(), backend=self._backend())
        if profile is None:
            return
        records = [r for r in profile["specs"] if isinstance(r, dict)]
        self._stored = {_spec_id(r): r for r in records}
        disp = self.dispatcher()
        for record in records:
            try:
                plan = self._plan_for(
                    record.get("kind", "update"), *dummy_from_spec(record, self._device()),
                    "steady" if record.get("exact") else "ladder",
                )
            except Exception as err:  # a record this owner cannot key is skipped
                plan = f"{type(err).__name__}: {err}"
            if isinstance(plan, str):
                rank_zero_debug(f"torchmetrics_tpu_torch compile cache: {self._owner_name()} skips a stored spec ({plan})")
                continue
            plan.record = record
            with self._pending_lock:
                pending = plan.key in self._pending_keys
            if plan.key in disp.entries or pending:
                continue
            with self._lock:
                disp.ensure_slots(plan.zero_state())
            if self.background_enabled() and self._submit_build(plan, "store"):
                continue
            with self._lock:
                try:
                    entry = self._build_key(plan)
                except Exception as err:  # the call that needs the key builds it
                    rank_zero_debug(f"torchmetrics_tpu_torch compile cache: a stored spec did not build ({err})")
                    continue
                if not self._install_built(plan, entry, "store"):
                    return

    def _install_built(self, plan: "_KeyPlan", entry: _Entry, why: str) -> bool:
        """Install a key built ahead of its call (call holding the
        executor's lock). A stored record whose launches disagree with the
        capture's evicts the entry and the key is not installed (False):
        its call judges it afresh."""
        if why == "store" and _launch_record(entry) != plan.record.get("launches", {}):
            self._evict_store(plan.record, entry)
            return False
        self.dispatcher().entries[plan.key] = entry
        if why == "store":
            self.stats["disk_hits"] += 1
        else:
            self.stats["compiles"] += 1
            self.stats["background_compiles"] += 1
        return True

    def _evict_store(self, record: Dict[str, Any], entry: _Entry) -> None:
        """A stored spec whose capture made other launches than it recorded:
        the entry is wrong. Delete it; the executor's keys are judged afresh
        and stored anew."""
        compile_cache.evict_entry(self.store_desc())
        self._stored = {}
        self.stats["disk_evictions"] += 1
        detail = f"recorded {record.get('launches', {})}, captured {_launch_record(entry)}"
        obs.fault_breadcrumb("disk_entry_evicted", domain="compile", data={"owner": self._owner_name(), "error": detail})
        rank_zero_warn(
            f"torchmetrics_tpu_torch compile cache: a stored spec of {self._owner_name()} captured other launches"
            f" than its record ({detail}); entry evicted, building fresh"
        )

    def _submit_build(self, plan: "_KeyPlan", why: str) -> bool:
        """Build ``plan``'s key on the worker, over a detached copy of the
        owner, and swap it in (``why``: ``"background"`` for a cold key, its
        call served eagerly meanwhile; ``"store"`` for a stored spec). False
        when it cannot go there (a full queue, an owner that cannot be
        copied): the caller builds inline."""
        with self._pending_lock:
            if plan.key in self._pending_keys:
                return True
            self._pending_keys.add(plan.key)
        disp = self.dispatcher()
        try:
            clone = self._clone_owner()
        except Exception as err:
            rank_zero_debug(
                f"torchmetrics_tpu_torch executor: {self._owner_name()} cannot be copied for a background capture"
                f" ({type(err).__name__}: {err}); building inline"
            )
            with self._pending_lock:
                self._pending_keys.discard(plan.key)
            return False
        slots = disp.slots

        def job() -> None:
            t0 = time.perf_counter()
            try:
                with obs.span(obs.SPAN_COMPILE, owner=self._owner_name(), background=True):
                    entry = self._build_key(plan, clone)
            except Exception as err:
                with self._pending_lock:
                    self._pending_keys.discard(plan.key)
                self._disable(f"background capture failed: {type(err).__name__}: {err}")
                return
            with self._lock:
                with self._pending_lock:
                    self._pending_keys.discard(plan.key)
                current = self._dispatcher is disp and disp.slots is slots and self.disabled_reason is None
                if not current or plan.key in disp.entries or not self._install_built(plan, entry, why):
                    return
                self.stats["compile_us_total"] += (time.perf_counter() - t0) * 1e6
            if why == "background":
                self._schedule_store(plan.spec, entry)

        # the enqueue span is the flow source the worker's capture links back to
        with obs.span(obs.SPAN_COMPILE, owner=self._owner_name(), phase="enqueue"):
            submitted = compile_cache.get_worker().submit(job)
        if not submitted:
            with self._pending_lock:
                self._pending_keys.discard(plan.key)
        return submitted

    def _schedule_store(self, spec: Optional[Dict[str, Any]], entry: Optional[_Entry]) -> None:
        """Add a newly built key's spec, with the launches one replay of it
        makes, to the owner's entry: a store job on the worker
        (``disk_stores``), up to :data:`_PROFILE_CAP` specs."""
        if spec is None or entry is None or not compile_cache.compile_ahead_enabled():
            return
        record = dict(spec, launches=_launch_record(entry))
        sid = _spec_id(record)
        if sid in self._stored or len(self._stored) >= _PROFILE_CAP:
            return
        self._stored[sid] = record
        desc, backend, owner, owner_desc = self.store_desc(), self._backend(), self._owner_name(), self._owner_desc()

        def job() -> None:
            with obs.span(obs.SPAN_CACHE_STORE, owner=owner):
                current = compile_cache.load_profile(desc, backend=backend)
                specs = [] if current is None else [r for r in current["specs"] if isinstance(r, dict)]
                known = {_spec_id(r) for r in specs}
                if sid in known:
                    return
                path = compile_cache.store_profile(desc, {"owner": owner_desc, "specs": specs + [record]}, backend=backend)
            if path is not None:
                self.stats["disk_stores"] += 1

        with obs.span(obs.SPAN_CACHE_STORE, owner=owner, phase="enqueue"):
            compile_cache.get_worker().submit(job)

    def stats_dict(self) -> Dict[str, Any]:
        out = dict(self.stats)
        out["disabled_reason"] = self.disabled_reason
        out["fallback_reason"] = self.disabled_reason
        out["bucketing_enabled"] = self._bucketing_ok
        disp = self._dispatcher
        out["cached_executables"] = 0 if disp is None else len(disp.entries)
        out["background_enabled"] = self.background_enabled()
        with self._pending_lock:
            out["pending_background"] = len(self._pending_keys)
        out["profile_entries"] = len(self._profile)
        out["captured"] = disp is not None and disp.graphs
        out["eager"] = {"keys": self._eager["keys"], "calls": self._eager["calls"], "reasons": list(self._eager["reasons"])}
        return out

    def static_bytes(self) -> int:
        """Bytes of the executor's state slots and static inputs."""
        return 0 if self._dispatcher is None else self._dispatcher.static_bytes()

    def device_lock_wait_us_max(self) -> float:
        """The longest a replay of this executor waited for the device's
        lock (µs): a capture on another thread held it."""
        return 0.0 if self._dispatcher is None else self._dispatcher.lock_wait_ns_max / 1e3

    def graph_pool_bytes(self) -> int:
        """Bytes the private graph pool holds (a memory-snapshot walk: call it
        off the hot path)."""
        return 0 if self._dispatcher is None else self._dispatcher.pool_bytes()


def _call_sig(args: tuple, kwargs: dict) -> Optional[tuple]:
    """A call's inputs as their shapes and dtypes (bools by value), or None
    for inputs other than tensors and bools (a cheap stand-in for its key)."""
    out: List[Any] = []
    for v in list(args) + [kwargs[k] for k in sorted(kwargs)]:
        if isinstance(v, torch.Tensor):
            out.append((tuple(v.shape), v.dtype))
        elif type(v) is bool:
            out.append(v)
        else:
            return None
    return tuple(out) + tuple(sorted(kwargs))


def _describe_key(key: Any) -> str:
    """A key as its call kind and its tensor leaves' shapes and dtypes."""
    sigs = next((part for part in key if isinstance(part, tuple) and part and all(isinstance(s, tuple) for s in part)), ())
    shapes = ", ".join(
        f"{list(s[0])} {s[1]}" if len(s) == 3 else repr(s[1]) for s in sigs if isinstance(s, tuple) and s
    )
    return f"{'forward' if key[0] == 'f' else 'update'}({shapes})"


def _zero_state(metric: Any) -> Dict[str, Any]:
    return {k: torch.zeros_like(v) for k, v in metric._defaults.items()}


def _config_desc(metric: Any) -> str:
    """A metric's configuration as its public attributes of plain values
    (``num_classes``, ``average``, ``ignore_index``, ...), sorted."""

    def plain(v: Any) -> bool:
        if isinstance(v, (tuple, list)):
            return all(plain(x) for x in v)
        return v is None or isinstance(v, (bool, int, float, str))

    return ",".join(f"{k}={v!r}" for k, v in sorted(vars(metric).items()) if not k.startswith("_") and plain(v))


def _identity_desc(metric: Any) -> str:
    """A metric's ``_executor_identity`` as a suffix of its description
    (nothing for a metric whose class, state and configuration say it all)."""
    ident = metric._executor_identity()
    return f"|{ident}" if ident else ""


# ----------------------------------------------------------------- metric


class MetricExecutor(_ExecutorBase):
    """Per-``Metric`` executor: captured update and forward over two state slots."""

    def __init__(self, metric: Any, plain_functional: bool, plain_forward: bool) -> None:
        super().__init__()
        # weak: the metric owns its executor, and a metric is no reference
        # cycle (``del`` frees its state and its graphs at once)
        self._metric_ref = weakref.ref(metric)
        self._plain_functional = plain_functional
        self._plain_forward = plain_forward

    @property
    def _metric(self) -> Any:
        return self._metric_ref()

    def _owner_name(self) -> str:
        return type(self._metric).__name__

    def _device(self) -> torch.device:
        return self._metric.device

    def _members(self) -> List[Any]:
        return [self._metric]

    # ----------------------------------------------------------- eligibility
    def _static_reason(self) -> Optional[str]:
        if self._static_reason_cached != ():
            return self._static_reason_cached
        m = self._metric
        reason = m._executor_step_aside()
        if reason is not None:
            pass
        elif not self._plain_functional:
            reason = "functional_update/functional_compute overridden"
        elif getattr(m, "executor_compatible", True) is False:
            reason = "metric declares executor_compatible=False"
        elif not m._defaults:
            reason = "no registered states"
        elif any(isinstance(v, list) for v in m._defaults.values()):
            reason = "list states change pytree structure every update"
        elif getattr(m, "compute_on_cpu", False):
            reason = "compute_on_cpu moves states host-side after update"
        elif getattr(m, "validate_args", None) is True:
            reason = "validate_args=True needs concrete input checks"
        else:
            hook = getattr(m, "_executor_traceable", None)
            if callable(hook) and not hook():
                reason = "metric declares itself untraceable"
        self._static_reason_cached = reason
        return reason

    def usable(self) -> bool:
        return self.disabled_reason is None and self._static_reason() is None

    def stats_dict(self) -> Dict[str, Any]:
        out = super().stats_dict()
        if out["disabled_reason"] is None:
            out["disabled_reason"] = self._static_reason()
        out["fallback_reason"] = out["disabled_reason"]
        return out

    def bucketable(self) -> bool:
        if not self._bucketing_ok:
            return False
        m = self._metric
        if getattr(m, "_executor_bucketable", True) is False:
            return False
        for field, fx in m._reductions.items():
            if fx not in _FUSABLE_REDUCTIONS:
                return False
            if fx == "sum" and m._defaults[field].dtype == torch.bool:
                return False
        return True

    def _state_sig(self) -> Tuple[Any, ...]:
        """The state layout, a part of every key; memoized per
        ``_state_layout_version`` (``_defaults`` change only with it)."""
        m = self._metric
        ver = getattr(m, "_state_layout_version", 0)
        if self._state_sig_memo is None or self._state_sig_memo[0] != ver:
            self._state_sig_memo = (ver, (ver, tuple((k, tuple(v.shape), str(v.dtype)) for k, v in m._defaults.items())))
            self._eager_sigs.clear()  # a new layout: its keys are judged anew
        return self._state_sig_memo[1]

    def _live_state(self) -> Dict[str, Any]:
        m = self._metric
        return {k: m._state[k] for k in m._defaults}

    # ---------------------------------------------------- the compile cache
    def _owner_desc(self) -> str:
        """The metric's class and its module's source hash, its registered
        state (name, dtype, shape, reduction), its configuration (the public
        scalar attributes) and what else its keys compute over (a windowed
        wrapper's inner metric and ring size: ``_executor_identity``)."""
        m = self._metric
        cls = type(m)
        fields = ",".join(f"{k}:{_dtype_name(v.dtype)}:{tuple(v.shape)}:{m._reductions.get(k)}" for k, v in m._defaults.items())
        return (
            f"{cls.__module__}.{cls.__qualname__}@{compile_cache.source_hash(sys.modules.get(cls.__module__) or cls)}"
            f"|{fields}|cfg={_config_desc(m)}{_identity_desc(m)}"
        )

    def _clone_owner(self) -> Tuple[Any, List[Any]]:
        import copy

        clone = copy.deepcopy(self._metric)
        clone.__dict__["_executor_enabled"] = False
        return clone, [clone]

    def _plan(self, kind: str, prep: tuple, spec: Optional[Dict[str, Any]]) -> Any:
        """The :class:`_KeyPlan` of a prepared call (:meth:`_prepare`), or why
        it has none."""
        treedef, sig, dyn, batched, bucket, n, padded, bool_spec, n_leaves = prep
        m = self._metric
        scalars = [n] if padded else []
        if kind == "update":
            key = ("u", treedef, sig, batched, bucket if padded else None, self._state_sig())

            def build(target: Any = None) -> Callable:
                return self._build_update(treedef, batched, bucket, padded, bool_spec, n_leaves, target)

        elif kind == "forward":
            if not self._plain_forward or m.dist_sync_on_step:
                return "forward: not fusable (custom forward or dist_sync_on_step)"
            variant = "reduce" if m.full_state_update is False else "full"
            key = ("f", variant, treedef, sig, batched, bucket if padded else None, self._state_sig())
            scalars = [0] + scalars

            def build(target: Any = None) -> Callable:
                return self._build_forward(treedef, batched, bucket, padded, variant, bool_spec, n_leaves, target)

        else:
            return f"{kind}: unknown warmup kind"
        call = _Call([torch.zeros_like(x) for x in dyn], batched, n, bucket, scalars)
        return _KeyPlan(key, build, lambda: _zero_state(self._metric), call, spec)

    def _plan_for(self, kind: str, args: tuple, kwargs: dict, mode: str) -> Any:
        if not self.usable():
            return f"{kind}: executor unusable ({self.disabled_reason or self._static_reason()})"
        prep = self._prepare(args, kwargs, mode)
        if prep is None:
            return f"{kind}: inputs not executor-eligible"
        return self._plan(kind, prep, _store_spec(kind, args, kwargs, prep[6]))

    # -------------------------------------------------------------- bodies
    def _build_update(
        self, treedef: Any, batched: Any, bucket: Any, padded: bool, bool_spec: tuple, n_leaves: int, target: Any = None
    ) -> Callable:
        ref = self._metric_ref if target is None else (lambda: target)
        defaults = dict(ref()._defaults)

        def body(state, scalars, *dyn):
            m = ref()
            leaves = _merge_static_bools(dyn, bool_spec, n_leaves)
            args, kwargs = tree_unflatten(treedef, leaves)
            g = m.functional_update(state, *args, **kwargs)
            if padded:
                r_args, r_kwargs = tree_unflatten(treedef, _row0_leaves(leaves, _full_batched(batched, bool_spec, n_leaves)))
                g = _subtract_pad_contribution(m, g, defaults, r_args, r_kwargs, bucket - scalars[0])
            return {k: g[k] for k in m._defaults}, None

        return body

    def _build_forward(
        self, treedef: Any, batched: Any, bucket: Any, padded: bool, variant: str, bool_spec: tuple, n_leaves: int,
        target: Any = None,
    ) -> Callable:
        ref = self._metric_ref if target is None else (lambda: target)
        defaults = dict(ref()._defaults)

        def body(state, scalars, *dyn):
            m = ref()
            count = scalars[0]
            leaves = _merge_static_bools(dyn, bool_spec, n_leaves)
            args, kwargs = tree_unflatten(treedef, leaves)
            bs = m.functional_update(dict(defaults), *args, **kwargs)
            if padded:
                r_args, r_kwargs = tree_unflatten(treedef, _row0_leaves(leaves, _full_batched(batched, bool_spec, n_leaves)))
                bs = _subtract_pad_contribution(m, bs, defaults, r_args, r_kwargs, bucket - scalars[1])
            value = m.functional_compute(bs)
            if variant == "reduce":
                new_state = m.merge_states(state, bs, counts=(count, 1))
            else:
                new_state = m.functional_update(state, *args, **kwargs)
                if padded:
                    new_state = _subtract_pad_contribution(m, new_state, defaults, r_args, r_kwargs, bucket - scalars[1])
            return {k: new_state[k] for k in m._defaults}, value

        return body

    # -------------------------------------------------------------- shared
    def _prepare(self, args: tuple, kwargs: dict, mode: str = "call"):
        leaves, treedef = tree_flatten((tuple(args), dict(kwargs)))
        prep = self._prepare_leaves(leaves, self.bucketable(), mode)
        if prep is None:
            return None
        return (treedef,) + prep

    def _eligible_now(self) -> bool:
        """Per call: the fault harness's update seam runs eagerly."""
        return "_update_fn" not in self._metric.__dict__

    # --------------------------------------------------------------- warmup
    def _warmup_bucketable(self) -> bool:
        return self.bucketable()

    def _warmup_one(self, kind: str, args: tuple, kwargs: dict, mode: str) -> str:
        plan = self._plan_for(kind, args, kwargs, mode)
        return plan if isinstance(plan, str) else self._dispatch_warmup(plan)

    # ---------------------------------------------------------------- entry
    def run_update(self, args: tuple, kwargs: dict) -> bool:
        """Run ``update`` through the executor; False -> the caller runs the
        eager body (nothing was applied).

        A FRESH key's failure is a build problem: the executor steps aside
        for good and the eager body serves. A WARM replay's failure leaves
        the live state at its pre-call slot and the original error
        propagates (no eager re-run of the batch)."""
        self._last_recovery = None
        if not self.usable():
            return False
        if not _trace_clean() or not self._eligible_now():
            self.stats["skipped_calls"] += 1
            return False
        if self._steps_aside_at_once(args, kwargs):
            return False
        t0_ns = self._call_t0_ns = time.perf_counter_ns()
        self._trial = None  # a trial whose eager path never finished is dropped
        if self._dispatcher is not None:
            self._dispatcher.pending_verdict = None  # nor is a failed call's timed replay judged
        try:
            with self._lock:
                handled = self._run_update(args, kwargs)
                self._judge_replay(t0_ns)
                return handled
        except _DispatchFailure as df:
            raise df.original
        except DispatchStallError:
            raise
        except Exception as err:  # sticky: a metric that cannot capture stays eager
            self._disable(f"{type(err).__name__}: {err}")
            return False

    def _commit(self, new_state: Dict[str, Any], fresh: bool) -> None:
        m = self._metric
        disp = self._dispatcher
        state = disp.install_fresh(new_state) if fresh else disp.commit()
        object.__setattr__(m, "_state", dict(state))
        m.__dict__["_state_escaped"] = False
        m.__dict__["_slot_ids"] = disp.slot_ids

    def _run_update(self, args: tuple, kwargs: dict) -> bool:
        prep = self._prepare(args, kwargs)
        if prep is None:
            self.stats["skipped_calls"] += 1
            return False
        treedef, sig, dyn, batched, bucket, n, padded, bool_spec, n_leaves = prep
        m = self._metric
        key = ("u", treedef, sig, batched, bucket if padded else None, self._state_sig())
        self._record_profile(key, "update", args, kwargs)
        state = self._live_state()
        disp = self.dispatcher()
        flat = tree_flatten(state)
        disp.ensure_slots(state, flat)
        fn, fresh = self._get_fn(
            key, lambda: self._build_update(treedef, batched, bucket, padded, bool_spec, n_leaves),
            lambda: self._plan("update", prep, _store_spec("update", args, kwargs, padded)),
        )
        if fn is None:
            return False
        need_copy = fresh or m._state_escaped or m._state_shared
        disp.load(state, flat[0])
        call = _Call(dyn, batched, n, bucket, [n] if padded else [])

        def update_unpadded():
            with _active([m]):
                return m.functional_update(state, *args, **kwargs)

        if fresh and padded and disp.eager_fresh_padded:
            call.eager = lambda: (update_unpadded(), None)
        padded_run = padded and call.eager is None
        do_probe = padded_run and not self._pad_validated
        oracle = update_unpadded() if do_probe else None

        try:
            new_state, _ = self._timed_dispatch(
                fresh, lambda: fn(call), lambda: fn(call), lambda: self._restore(m) if not need_copy else None
            )
        except _CaptureFailed as failed:
            # the eager result serves: the update on the batch as given where
            # it ran (a probe), else the key's eager run
            self._disable(f"capture failed: {type(failed.original).__name__}: {failed.original}")
            served = failed.result[0] if oracle is None else oracle
            object.__setattr__(m, "_state", {k: served[k] for k in m._defaults})
            m.__dict__["_state_escaped"] = True
            return True
        if padded_run:
            self.stats["padded_calls"] += 1
        if do_probe:
            self.stats["probes"] += 1
            if _states_close(new_state, oracle, m._defaults):
                self._pad_validated = True
            else:
                # bucketing is numerically unsafe for this metric: discard the
                # padded result (nothing was committed) and dispatch unpadded
                self._bucketing_ok = False
                return self._run_update(args, kwargs)
        self.stats["calls"] += 1
        self.stats["copied_calls" if need_copy else "donated_calls"] += 1
        self._commit(new_state, fresh)
        if fresh:
            self._schedule_store(_store_spec("update", args, kwargs, padded), disp.entries.get(key))
        else:
            self._last_recovery = int(m._update_count) - 1
        return True

    def run_forward(self, args: tuple, kwargs: dict) -> Tuple[bool, Any]:
        """Run ``forward`` as one ``(state, batch) -> (state', value)``
        dispatch. Returns ``(handled, batch_value)``."""
        m = self._metric
        self._last_recovery = None
        if not self.usable() or not self._plain_forward or m.dist_sync_on_step:
            return False, None
        if not _trace_clean() or not self._eligible_now() or "_compute_fn" in m.__dict__:
            self.stats["skipped_calls"] += 1
            return False, None
        try:
            with self._lock:
                try:
                    return self._run_forward(args, kwargs)
                finally:
                    self._forget_forward_timing()
        except _DispatchFailure as df:
            raise df.original
        except DispatchStallError:
            raise
        except Exception as err:
            self._disable(f"{type(err).__name__}: {err}")
            return False, None

    def _forward_oracle(self, variant: str, state: Dict[str, Any], args: tuple, kwargs: dict, count: int):
        m = self._metric
        with _active([m]):
            bs = m.functional_update(m.functional_init(), *args, **kwargs)
            value = m.functional_compute(bs)
            if variant == "reduce":
                new_state = m.merge_states(state, bs, counts=(torch.tensor(count, dtype=torch.int32, device=m.device), 1))
            else:
                new_state = m.functional_update(state, *args, **kwargs)
        return new_state, value

    def _run_forward(self, args: tuple, kwargs: dict):
        prep = self._prepare(args, kwargs)
        if prep is None:
            self.stats["skipped_calls"] += 1
            return False, None
        treedef, sig, dyn, batched, bucket, n, padded, bool_spec, n_leaves = prep
        m = self._metric
        variant = "reduce" if m.full_state_update is False else "full"
        key = ("f", variant, treedef, sig, batched, bucket if padded else None, self._state_sig())
        self._record_profile(key, "forward", args, kwargs)
        state = self._live_state()
        disp = self.dispatcher()
        disp.ensure_slots(state)
        fn, fresh = self._get_fn(
            key, lambda: self._build_forward(treedef, batched, bucket, padded, variant, bool_spec, n_leaves),
            lambda: self._plan("forward", prep, _store_spec("forward", args, kwargs, padded)),
        )
        if fn is None:
            return False, None
        count = int(m._update_count)
        need_copy = fresh or m._state_escaped or m._state_shared
        disp.load(state)
        call = _Call(dyn, batched, n, bucket, [count] + ([n] if padded else []))
        if fresh and padded and disp.eager_fresh_padded:
            call.eager = lambda: self._forward_oracle(variant, state, args, kwargs, count)
        padded_run = padded and call.eager is None
        do_probe = padded_run and not self._pad_validated
        oracle = self._forward_oracle(variant, state, args, kwargs, count) if do_probe else None

        try:
            new_state, value = self._timed_dispatch(
                fresh, lambda: fn(call), lambda: fn(call), lambda: self._restore(m) if not need_copy else None
            )
        except _CaptureFailed as failed:
            self._disable(f"capture failed: {type(failed.original).__name__}: {failed.original}")
            new_state, value = failed.result if oracle is None else oracle
            object.__setattr__(m, "_state", {k: new_state[k] for k in m._defaults})
            m.__dict__["_state_escaped"] = True
            self._finish_forward(m)
            return True, value
        if padded_run:
            self.stats["padded_calls"] += 1
        if do_probe:
            self.stats["probes"] += 1
            if _states_close(new_state, oracle[0], m._defaults) and _values_close(value, oracle[1]):
                self._pad_validated = True
            else:
                self._bucketing_ok = False
                return self._run_forward(args, kwargs)
        self.stats["calls"] += 1
        self.stats["copied_calls" if need_copy else "donated_calls"] += 1
        self._commit(new_state, fresh)
        self._finish_forward(m)
        if fresh:
            self._schedule_store(_store_spec("forward", args, kwargs, padded), disp.entries.get(key))
        else:
            self._last_recovery = int(m._update_count) - 1
        return True, value

    @staticmethod
    def _finish_forward(m: Any) -> None:
        m._update_count += 1
        m._computed = None
        m._to_sync = m.sync_on_compute
        m._should_unsync = True


def _full_batched(batched: Optional[Tuple[bool, ...]], bool_spec: tuple, n_leaves: int) -> List[bool]:
    """The padding plan over every leaf (bools are never batched)."""
    return _merge_static_bools(list(batched or ()), tuple((i, False) for i, _ in bool_spec), n_leaves)


# ------------------------------------------------------------- collection


class CollectionExecutor(_ExecutorBase):
    """Captured executor for a ``MetricCollection``: one replay updates (or
    forwards) EVERY compute group. Engages once the groups are resolved and
    while every group leader is eligible; otherwise the collection runs its
    per-group loop, where each leader may use its own executor."""

    def __init__(self, collection: Any) -> None:
        super().__init__()
        self._coll_ref = weakref.ref(collection)  # weak, as MetricExecutor's

    @property
    def _coll(self) -> Any:
        return self._coll_ref()

    def _owner_name(self) -> str:
        return f"MetricCollection[{', '.join(self._coll._modules)}]"

    def _device(self) -> torch.device:
        return self._coll.device

    def _members(self) -> List[Any]:
        return list(self._coll._modules.values())

    # ----------------------------------------------------------- eligibility
    def _leaders(self):
        coll = self._coll
        return [(cg[0], coll._modules[cg[0]], cg) for cg in coll._groups.values()]

    def _leader_executors(self):
        out = []
        for name, m, cg in self._leaders():
            ex = m._get_executor()
            if ex is None or not ex.usable():
                return None
            if any(self._coll._modules[x].__dict__.get("_executor_enabled") is False for x in cg):
                return None
            out.append((name, m, cg, ex))
        return out

    def bucketable(self, leader_execs) -> bool:
        return self._bucketing_ok and all(ex.bucketable() for _, _, _, ex in leader_execs)

    def _kwarg_names(self, m: Any, kwargs: dict) -> Tuple[str, ...]:
        return tuple(sorted(m._filter_kwargs(**kwargs)))

    def _forward_unfusable_reason(self, leader_execs) -> Optional[str]:
        """Why the fused forward cannot engage, or None when every group
        qualifies (all members ``full_state_update=False``, no per-step
        sync, the base compute)."""
        from torchmetrics_tpu_torch.metric import Metric

        coll = self._coll
        for _name, _m0, cg, ex in leader_execs:
            if not ex._plain_forward:
                return "a group leader overrides functional_forward/merge_states"
            for member in cg:
                mm = coll._modules[member]
                if mm.full_state_update is not False or mm.dist_sync_on_step:
                    return f"member {member!r} needs full_state_update or per-step sync"
                if type(mm).functional_compute is not Metric.functional_compute:
                    return f"member {member!r} overrides functional_compute"
        return None

    def _state_sig(self, leader_execs: Any = None) -> Tuple[Any, ...]:
        """Per leader, as :meth:`MetricExecutor._state_sig` (``leader_execs``:
        :meth:`_leader_executors`, when the caller has it)."""
        leaders = self._leaders() if leader_execs is None else [(name, m, cg) for name, m, cg, _ in leader_execs]
        vers = tuple((name, getattr(m, "_state_layout_version", 0)) for name, m, _ in leaders)
        if self._state_sig_memo is None or self._state_sig_memo[0] != vers:
            sig = tuple(
                (name, ver, tuple((k, tuple(v.shape), str(v.dtype)) for k, v in m._defaults.items()))
                for (name, ver), (_, m, _) in zip(vers, leaders)
            )
            self._state_sig_memo = (vers, sig)
            self._eager_sigs.clear()  # a new layout: its keys are judged anew
        return self._state_sig_memo[1]

    def _live_states(self, leader_execs) -> Dict[str, Dict[str, Any]]:
        return {name: {k: m._state[k] for k in m._defaults} for name, m, _, _ in leader_execs}

    # ---------------------------------------------------- the compile cache
    def _owner_desc(self) -> str:
        """Every member's class and module source hash, grouped by leader,
        each leader's registered state and every member's configuration."""
        coll = self._coll
        parts = []
        for name, m, cg in self._leaders():
            members = ",".join(
                f"{mn}={type(coll._modules[mn]).__qualname__}"
                f"@{compile_cache.source_hash(sys.modules.get(type(coll._modules[mn]).__module__) or type(coll._modules[mn]))}"
                f"[{_config_desc(coll._modules[mn])}{_identity_desc(coll._modules[mn])}]"
                for mn in cg
            )
            fields = ",".join(f"{k}:{_dtype_name(v.dtype)}:{tuple(v.shape)}:{m._reductions.get(k)}" for k, v in m._defaults.items())
            parts.append(f"{name}:[{members}]|{fields}")
        return "Collection{" + ";".join(parts) + "}"

    def _clone_owner(self) -> Tuple[Any, List[Any]]:
        import copy

        clone = copy.deepcopy(self._coll)
        clone.__dict__["_executor_enabled"] = False
        for mm in clone._modules.values():
            mm.__dict__["_executor_enabled"] = False
        return clone, list(clone._modules.values())

    def _plan(self, kind: str, prep: tuple, kwargs: dict, leader_execs: Any, spec: Optional[Dict[str, Any]]) -> Any:
        """The :class:`_KeyPlan` of a prepared call, or why it has none."""
        treedef, sig, dyn, batched, bucket, n, padded, bool_spec, n_leaves = prep
        kw_map = {name: self._kwarg_names(m, kwargs) for name, m, _ in self._leaders()}
        kw_key = tuple(sorted(kw_map.items()))
        if kind == "update":
            key = ("u", treedef, sig, batched, bucket if padded else None, kw_key, self._state_sig(leader_execs))
            scalars = [n] if padded else []

            def build(target: Any = None) -> Callable:
                return self._build_update(treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves, target)

        elif kind == "forward":
            reason = self._forward_unfusable_reason(leader_execs)
            if reason is not None:
                return f"forward: {reason}"
            key = ("f", treedef, sig, batched, bucket if padded else None, kw_key, self._state_sig())
            scalars = [0] * len(leader_execs) + ([n] if padded else [])

            def build(target: Any = None) -> Callable:
                return self._build_forward(treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves, target)

        else:
            return f"{kind}: unknown warmup kind"
        leaders = [(name, m) for name, m, _, _ in leader_execs]
        call = _Call([torch.zeros_like(x) for x in dyn], batched, n, bucket, scalars)
        return _KeyPlan(key, build, lambda: {name: _zero_state(m) for name, m in leaders}, call, spec)

    def _plan_for(self, kind: str, args: tuple, kwargs: dict, mode: str) -> Any:
        if self.disabled_reason is not None:
            return f"{kind}: executor disabled ({self.disabled_reason})"
        leader_execs = self._leader_executors()
        if leader_execs is None:
            return f"{kind}: a compute-group leader is not executor-eligible"
        prep = self._prepare(args, kwargs, leader_execs, mode)
        if prep is None:
            return f"{kind}: inputs not executor-eligible"
        return self._plan(kind, prep, kwargs, leader_execs, _store_spec(kind, args, kwargs, prep[6]))

    # -------------------------------------------------------------- bodies
    def _build_update(self, treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves, target: Any = None) -> Callable:
        ref = self._coll_ref if target is None else (lambda: target)
        specs = [(name, kw_map[name], dict(m._defaults)) for name, m, _ in self._leaders()]

        def body(states, scalars, *dyn):
            from torchmetrics_tpu_torch.ops.kernels import shared_scope

            coll = ref()
            leaves = _merge_static_bools(dyn, bool_spec, n_leaves)
            args, kwargs = tree_unflatten(treedef, leaves)
            if padded:
                r_args, r_kwargs = tree_unflatten(treedef, _row0_leaves(leaves, _full_batched(batched, bool_spec, n_leaves)))
                extra = bucket - scalars[0]
            out = {}
            with shared_scope():  # the leaders share one counting launch
                for leader, kw_names, defaults in specs:
                    m = coll._modules[leader]
                    g = m.functional_update(states[leader], *args, **{k: kwargs[k] for k in kw_names})
                    if padded:
                        g = _subtract_pad_contribution(m, g, defaults, r_args, {k: r_kwargs[k] for k in kw_names}, extra)
                    out[leader] = {k: g[k] for k in m._defaults}
            return out, None

        return body

    def _build_forward(self, treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves, target: Any = None) -> Callable:
        ref = self._coll_ref if target is None else (lambda: target)
        specs = [(name, tuple(cg), kw_map[name], dict(m._defaults)) for name, m, cg in self._leaders()]

        def body(states, scalars, *dyn):
            from torchmetrics_tpu_torch.ops.kernels import shared_scope

            coll = ref()
            counts = dict(zip([s[0] for s in specs], scalars))
            leaves = _merge_static_bools(dyn, bool_spec, n_leaves)
            args, kwargs = tree_unflatten(treedef, leaves)
            if padded:
                r_args, r_kwargs = tree_unflatten(treedef, _row0_leaves(leaves, _full_batched(batched, bool_spec, n_leaves)))
                extra = bucket - scalars[len(specs)]
            new_states, values = {}, {}
            with shared_scope():
                for leader, members, kw_names, defaults in specs:
                    m = coll._modules[leader]
                    bs = m.functional_update(dict(defaults), *args, **{k: kwargs[k] for k in kw_names})
                    if padded:
                        bs = _subtract_pad_contribution(m, bs, defaults, r_args, {k: r_kwargs[k] for k in kw_names}, extra)
                    merged = m.merge_states(states[leader], bs, counts=(counts[leader], 1))
                    new_states[leader] = {k: merged[k] for k in m._defaults}
                    for name in members:
                        values[name] = coll._modules[name].functional_compute(bs)
            return new_states, values

        return body

    # -------------------------------------------------------------- shared
    def _prepare(self, args: tuple, kwargs: dict, leader_execs, mode: str = "call"):
        leaves, treedef = tree_flatten((tuple(args), dict(kwargs)))
        prep = self._prepare_leaves(leaves, self.bucketable(leader_execs), mode)
        if prep is None:
            return None
        return (treedef,) + prep

    def _group_need_copy(self, cg: Sequence[str], fresh: bool) -> bool:
        mods = self._coll._modules
        return fresh or any(mods[name]._state_escaped for name in cg)

    def _install(self, leader: str, new_state: Dict[str, Any], cg: Sequence[str], bump_count: bool) -> None:
        mods = self._coll._modules
        m0 = mods[leader]
        object.__setattr__(m0, "_state", dict(new_state))
        if bump_count:
            m0._update_count += 1
            m0._mark_unreduced()
        m0._computed = None
        ids = self._dispatcher.slot_ids
        for name in cg:
            mm = mods[name]
            mm.__dict__["_state_escaped"] = False
            mm.__dict__["_state_shared"] = True
            mm.__dict__["_slot_ids"] = ids

    def _restore_groups(self, donated) -> None:
        """After a failed dispatch: every donated group keeps its pre-call
        slot; followers still alias it."""
        mods = self._coll._modules
        for _name, m, cg in donated:
            self._restore(m)
            for member in cg[1:]:
                mods[member].__dict__["_state_escaped"] = True

    def _commit_all(self, new_states: Dict[str, Any], fresh: bool, leader_execs) -> None:
        disp = self._dispatcher
        states = disp.install_fresh(new_states) if fresh else disp.commit()
        for name, _, cg, _ in leader_execs:
            self._install(name, states[name], cg, bump_count=True)

    def _note_recovery(self, fresh: bool, leader_execs) -> None:
        """After a replay, each leader's count one committed update behind."""
        if not fresh:
            self._last_recovery = {name: int(m._update_count) - 1 for name, m, _, _ in leader_execs}

    def _serve_eagerly(self, new_states: Dict[str, Any], leader_execs) -> None:
        """A fresh key whose capture failed: its eager result serves the call."""
        for name, m0, cg, _ in leader_execs:
            object.__setattr__(m0, "_state", dict(new_states[name]))
            m0._update_count += 1
            m0._mark_unreduced()
            m0._computed = None
            for member in cg:
                self._coll._modules[member].__dict__["_state_escaped"] = True

    # --------------------------------------------------------------- warmup
    def _warmup_bucketable(self) -> bool:
        leader_execs = self._leader_executors()
        return leader_execs is not None and self.bucketable(leader_execs)

    def _warmup_one(self, kind: str, args: tuple, kwargs: dict, mode: str) -> str:
        plan = self._plan_for(kind, args, kwargs, mode)
        return plan if isinstance(plan, str) else self._dispatch_warmup(plan)

    # ---------------------------------------------------------------- entry
    def run_update(self, args: tuple, kwargs: dict) -> bool:
        self._last_recovery = None
        if self.disabled_reason is not None:
            return False
        if not _trace_clean():
            self.stats["skipped_calls"] += 1
            return False
        leader_execs = self._leader_executors()
        if leader_execs is None:
            return False
        if any("_update_fn" in self._coll._modules[name].__dict__ for _, _, cg, _ in leader_execs for name in cg):
            self.stats["skipped_calls"] += 1
            return False
        if self._steps_aside_at_once(args, kwargs):
            return False
        t0_ns = self._call_t0_ns = time.perf_counter_ns()
        self._trial = None  # a trial whose eager path never finished is dropped
        if self._dispatcher is not None:
            self._dispatcher.pending_verdict = None  # nor is a failed call's timed replay judged
        try:
            with self._lock:
                handled = self._run_update(args, kwargs, leader_execs)
                self._judge_replay(t0_ns)
                return handled
        except _DispatchFailure as df:
            raise df.original
        except DispatchStallError:
            raise
        except Exception as err:
            self._disable(f"{type(err).__name__}: {err}")
            return False

    def _donation(self, leader_execs, fresh: bool):
        copied, donated = False, []
        for name, m, cg, _ in leader_execs:
            if self._group_need_copy(cg, fresh):
                copied = True
            else:
                donated.append((name, m, cg))
        return copied, donated

    def _run_update(self, args: tuple, kwargs: dict, leader_execs) -> bool:
        prep = self._prepare(args, kwargs, leader_execs)
        if prep is None:
            self.stats["skipped_calls"] += 1
            return False
        treedef, sig, dyn, batched, bucket, n, padded, bool_spec, n_leaves = prep
        kw_map = {name: self._kwarg_names(m, kwargs) for name, m, _, _ in leader_execs}
        key = ("u", treedef, sig, batched, bucket if padded else None, tuple(sorted(kw_map.items())), self._state_sig(leader_execs))
        self._record_profile(key, "update", args, kwargs)
        states = self._live_states(leader_execs)
        disp = self.dispatcher()
        flat = tree_flatten(states)
        disp.ensure_slots(states, flat)
        fn, fresh = self._get_fn(
            key, lambda: self._build_update(treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves),
            lambda: self._plan("update", prep, kwargs, leader_execs, _store_spec("update", args, kwargs, padded)),
        )
        if fn is None:
            return False
        copied, donated = self._donation(leader_execs, fresh)
        disp.load(states, flat[0])
        call = _Call(dyn, batched, n, bucket, [n] if padded else [])

        def update_unpadded():
            from torchmetrics_tpu_torch.ops.kernels import shared_scope

            with _active(self._members()), shared_scope():
                return {
                    name: {k: g[k] for k in m._defaults}
                    for name, m, _, _ in leader_execs
                    for g in (m.functional_update(states[name], *args, **m._filter_kwargs(**kwargs)),)
                }

        if fresh and padded and disp.eager_fresh_padded:
            call.eager = lambda: (update_unpadded(), None)
        padded_run = padded and call.eager is None
        do_probe = padded_run and not self._pad_validated
        oracle = update_unpadded() if do_probe else None

        try:
            new_states, _ = self._timed_dispatch(fresh, lambda: fn(call), lambda: fn(call), lambda: self._restore_groups(donated))
        except _CaptureFailed as failed:
            self._disable(f"capture failed: {type(failed.original).__name__}: {failed.original}")
            self._serve_eagerly(failed.result[0] if oracle is None else oracle, leader_execs)
            return True
        if padded_run:
            self.stats["padded_calls"] += 1
        if do_probe:
            self.stats["probes"] += 1
            if all(_states_close(new_states[name], oracle[name], m._defaults) for name, m, _, _ in leader_execs):
                self._pad_validated = True
            else:
                self._bucketing_ok = False
                return self._run_update(args, kwargs, leader_execs)
        self.stats["calls"] += 1
        self.stats["copied_calls" if copied else "donated_calls"] += 1
        self._commit_all(new_states, fresh, leader_execs)
        self._note_recovery(fresh, leader_execs)
        if fresh:
            self._schedule_store(_store_spec("update", args, kwargs, padded), disp.entries.get(key))
        return True

    def run_forward(self, args: tuple, kwargs: dict) -> Optional[Dict[str, Any]]:
        """Fused forward for the WHOLE collection, or None to fall back."""
        self._last_recovery = None
        if self.disabled_reason is not None:
            return None
        if not _trace_clean():
            self.stats["skipped_calls"] += 1
            return None
        leader_execs = self._leader_executors()
        if leader_execs is None or self._forward_unfusable_reason(leader_execs) is not None:
            return None
        mods = self._coll._modules
        if any("_update_fn" in mods[name].__dict__ or "_compute_fn" in mods[name].__dict__ for _, _, cg, _ in leader_execs for name in cg):
            self.stats["skipped_calls"] += 1
            return None
        try:
            with self._lock:
                try:
                    return self._run_forward(args, kwargs, leader_execs)
                finally:
                    self._forget_forward_timing()
        except _DispatchFailure as df:
            raise df.original
        except DispatchStallError:
            raise
        except Exception as err:
            self._disable(f"{type(err).__name__}: {err}")
            return None

    def _run_forward(self, args: tuple, kwargs: dict, leader_execs):
        prep = self._prepare(args, kwargs, leader_execs)
        if prep is None:
            self.stats["skipped_calls"] += 1
            return None
        treedef, sig, dyn, batched, bucket, n, padded, bool_spec, n_leaves = prep
        coll = self._coll
        kw_map = {name: self._kwarg_names(m, kwargs) for name, m, _ in self._leaders()}
        key = ("f", treedef, sig, batched, bucket if padded else None, tuple(sorted(kw_map.items())), self._state_sig())
        self._record_profile(key, "forward", args, kwargs)
        states = self._live_states(leader_execs)
        disp = self.dispatcher()
        disp.ensure_slots(states)
        fn, fresh = self._get_fn(
            key, lambda: self._build_forward(treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves),
            lambda: self._plan("forward", prep, kwargs, leader_execs, _store_spec("forward", args, kwargs, padded)),
        )
        if fn is None:
            return None
        copied, donated = self._donation(leader_execs, fresh)
        disp.load(states)
        counts = [int(m._update_count) for _, m, _, _ in leader_execs]
        call = _Call(dyn, batched, n, bucket, counts + ([n] if padded else []))

        def forward_unpadded():
            from torchmetrics_tpu_torch.ops.kernels import shared_scope

            new_states, values = {}, {}
            with _active(self._members()), shared_scope():
                for (name, m, cg, _), count in zip(leader_execs, counts):
                    bs = m.functional_update(m.functional_init(), *args, **m._filter_kwargs(**kwargs))
                    merged = m.merge_states(states[name], bs, counts=(torch.tensor(count, dtype=torch.int32, device=m.device), 1))
                    new_states[name] = {k: merged[k] for k in m._defaults}
                    for member in cg:
                        values[member] = coll._modules[member].functional_compute(bs)
            return new_states, values

        if fresh and padded and disp.eager_fresh_padded:
            call.eager = forward_unpadded
        padded_run = padded and call.eager is None
        do_probe = padded_run and not self._pad_validated
        oracle = forward_unpadded() if do_probe else None

        try:
            new_states, values = self._timed_dispatch(fresh, lambda: fn(call), lambda: fn(call), lambda: self._restore_groups(donated))
        except _CaptureFailed as failed:
            self._disable(f"capture failed: {type(failed.original).__name__}: {failed.original}")
            served = failed.result if oracle is None else oracle
            self._serve_eagerly(served[0], leader_execs)
            return dict(served[1])
        if padded_run:
            self.stats["padded_calls"] += 1
        if do_probe:
            self.stats["probes"] += 1
            ok = all(_states_close(new_states[name], oracle[0][name], m._defaults) for name, m, _, _ in leader_execs)
            if ok and _values_close(values, oracle[1]):
                self._pad_validated = True
            else:
                self._bucketing_ok = False
                return self._run_forward(args, kwargs, leader_execs)
        self.stats["calls"] += 1
        self.stats["copied_calls" if copied else "donated_calls"] += 1
        self._commit_all(new_states, fresh, leader_execs)
        self._note_recovery(fresh, leader_execs)
        if fresh:
            self._schedule_store(_store_spec("forward", args, kwargs, padded), disp.entries.get(key))
        return dict(values)


# ---------------------------------------------------------------------------
# the synced step and the deferred collection step
# ---------------------------------------------------------------------------


def make_value_packer(example_values: Any) -> Tuple[Callable[[Any], Dict[str, torch.Tensor]], Callable[[Dict[str, Any]], Any]]:
    """Build ``(pack, unpack)`` for a fixed values tree.

    ``pack`` concatenates every tensor leaf of a values tree into one flat
    tensor per dtype (a collection's N values then read back in one
    device-to-host copy per dtype, not N); ``unpack`` (host side) copies
    each flat tensor to the host once and restores the tree with numpy
    leaves.

    >>> pack, unpack = make_value_packer({"a": torch.tensor(1.0), "b": torch.ones(2, 2), "n": torch.tensor(3)})
    >>> sorted(pack({"a": torch.tensor(1.0), "b": torch.ones(2, 2), "n": torch.tensor(3)}))
    ['float32', 'int64']
    >>> unpack(pack({"a": torch.tensor(1.0), "b": torch.ones(2, 2), "n": torch.tensor(3)}))["b"].shape
    (2, 2)
    """
    leaves, spec = tree_flatten(example_values)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    order: Dict[str, List[int]] = {}
    for i, leaf in enumerate(leaves):
        order.setdefault(_dtype_name(leaf.dtype), []).append(i)

    def pack(tree: Any) -> Dict[str, torch.Tensor]:
        lv = tree_flatten(tree)[0]
        return {dt: torch.cat([lv[i].reshape(-1) for i in idxs]) for dt, idxs in order.items()}

    def unpack(packed: Dict[str, Any]) -> Any:
        import numpy as np

        out: List[Any] = [None] * len(shapes)
        for dt, idxs in order.items():
            flat = packed[dt]
            flat = flat.detach().cpu().numpy() if isinstance(flat, torch.Tensor) else np.asarray(flat)
            off = 0
            for i in idxs:
                size = int(np.prod(shapes[i])) if shapes[i] else 1
                out[i] = flat[off:off + size].reshape(shapes[i])
                off += size
        return tree_unflatten(spec, out)

    return pack, unpack


def _world_of(collection: Any) -> bool:
    """Whether a member syncs across ranks (an initialised process group)."""
    return any(m.distributed_available_fn() for m in collection._modules.values())


def _check_process_group(process_group: Any) -> None:
    if isinstance(process_group, str):
        raise TypeError(
            f"the port syncs over a process group, not a named mesh axis: got {process_group!r}"
            " (pass a torch.distributed group, or None for the world)"
        )


def make_synced_collection_step(collection: Any, process_group: Any = None, pack_values: bool = True, reduce: str = "step"):
    """The fused ``(states, *batch) -> (states', packed_values)`` synced step.

    One call runs every compute group's update, one ``functional_sync`` of
    the whole collection over ``process_group`` (one collective per
    reduction and dtype across every group, in an initialised process group;
    the JAX package takes a mesh axis name here) and every member's compute,
    and packs the values per dtype (:func:`make_value_packer`). Returns
    ``(step, unpack)``; ``unpack`` (host side) restores the values dict.

    With ``reduce="deferred"`` the per-step sync disappears and the return
    is ``(local_step, reduce_step, unpack)``: ``local_step`` accumulates one
    shard's slice of a stacked state (leading shard axis of 1, as one
    shard of ``collection.init_sharded_states`` gives) with no collective,
    and ``reduce_step(stacked_states) -> packed_values`` folds the shard axis
    and applies every declared ``dist_reduce_fx`` once: the read point.
    :func:`make_deferred_collection_step` drives the pair for you.
    """
    _check_process_group(process_group)
    if reduce == "deferred":
        local_step, reduce_step, _fold, unpack = _make_deferred_bodies(collection, process_group, pack_values)
        return local_step, reduce_step, unpack
    if reduce != "step":
        raise ValueError(f"reduce must be 'step' or 'deferred', got {reduce!r}")
    box: Dict[str, Any] = {}

    def step(states: Any, *args: Any, **kwargs: Any) -> Tuple[Any, Any]:
        st = collection.functional_update(states, *args, **kwargs)
        synced = collection.functional_sync(st, process_group) if _world_of(collection) else st
        values = collection.functional_compute(synced)
        if pack_values:
            if "pack" not in box:
                box["pack"], box["unpack"] = make_value_packer(values)
            values = box["pack"](values)
        return st, values

    def unpack(packed: Any) -> Any:
        return box["unpack"](packed) if pack_values else packed

    return step, unpack


def _make_deferred_bodies(collection: Any, process_group: Any, pack_values: bool, baseline_box: Optional[Dict[str, Any]] = None):
    """``(local_step, reduce_step, fold_step, unpack)``, the deferred
    policy's plain bodies. ``local_step`` takes one shard's slice (leading
    axis 1); ``reduce_step`` and ``fold_step`` the whole stack.
    ``baseline_box`` may carry a ``"baseline"`` canonical tree (an elastic
    restore's or a shard-loss recovery's) that the read point merges with
    the freshly folded value per the declared reductions
    (``parallel/reshard.py:merge_folded``)."""
    from torchmetrics_tpu_torch.parallel.reshard import merge_folded
    from torchmetrics_tpu_torch.parallel.sync import reshard_local_state, unshard_local_state

    box: Dict[str, Any] = {}

    def local_step(states: Any, *args: Any, **kwargs: Any) -> Any:
        return reshard_local_state(collection.functional_update(unshard_local_state(states), *args, **kwargs))

    def fold_step(states: Any) -> Any:
        return collection.reduce_sharded_states(states, process_group)

    def _merged(states: Any) -> Any:
        folded = fold_step(states)
        baseline = (baseline_box or {}).get("baseline")
        if baseline is None:
            return folded
        return {
            leader: merge_folded(baseline[leader], sub, collection._modules[leader]._reductions) if leader in baseline else sub
            for leader, sub in folded.items()
        }

    def reduce_step(states: Any) -> Any:
        values = collection.functional_compute(_merged(states))
        if pack_values:
            if "pack" not in box:
                box["pack"], box["unpack"] = make_value_packer(values)
            values = box["pack"](values)
        return values

    def unpack(packed: Any) -> Any:
        return box["unpack"](packed) if pack_values else packed

    return local_step, reduce_step, fold_step, unpack


def _shard_slices(x: Any, dim: Optional[int], num_shards: int, what: str) -> List[Any]:
    """Shard ``s`` of ``x``: rows ``[s*N/S, (s+1)*N/S)`` along ``dim`` (the
    slice ``shard_map`` over the axis gives device ``s``), or the whole of
    ``x`` for every shard when ``dim`` is None or ``x`` is no tensor."""
    if dim is None or not isinstance(x, torch.Tensor):
        return [x] * num_shards
    rows = int(x.shape[dim])
    if rows % num_shards:
        raise ValueError(f"{what}'s {rows} rows along dim {dim} must split evenly over {num_shards} shards")
    k = rows // num_shards
    return [x.narrow(dim, s * k, k) for s in range(num_shards)]


class DeferredCollectionStep:
    """Deferred-reduction drivers for one collection over ``num_shards``
    shards stacked on this process (built by
    :func:`make_deferred_collection_step`).

    State is stacked per shard (a leading shard axis on every field); the
    step loop pays no collective, and every declared ``dist_reduce_fx``
    runs once, at the read point:

    - :meth:`init_states`: fresh stacked states on the collection's device;
    - :meth:`local_step`: ``(states, *batch) -> states'``, every shard's
      slice of the batch into its own shard, one CUDA graph replay on the
      card (a key's first call runs eagerly, then two graphs are captured,
      one a state slot, as the captured executor does);
    - :meth:`local_epoch`: ``(states, *stacked) -> states'``, a chunk of T
      steps (leading axis = steps) unrolled in one captured graph, keyed
      by T: the port's ``lax.scan``;
    - :meth:`reduce` / :meth:`reduce_async`: the fold, one
      ``functional_sync`` in a process group, the carried baseline's merge,
      every compute and the packing, run eagerly (once an epoch).

    With ``donate=True`` a step reads the slot it was handed and writes the
    other one: the tree it returns is that slot, and the tree it was
    handed is spent. Handing a spent tree back raises
    :class:`~torchmetrics_tpu_torch.utils.exceptions.TorchMetricsUserError`
    (the JAX package raises on a deleted buffer). With ``donate=False``
    every call returns fresh tensors and never writes what it was given.

    Elastic topology: :meth:`restore_states` (a snapshot saved on any shard
    count becomes a carried baseline; fresh accumulators go back on),
    :meth:`attach_shadow` (a bounded-lag host shadow of the folded reduce,
    and the ``on_shard_loss`` policies ``"raise"``, ``"degraded"`` and
    ``"restore"``), :meth:`attach_integrity` (per-shard fingerprint
    audits), :meth:`export_canonical` and :meth:`export_delta` (the
    checkpoint and fleet surfaces).
    """

    def __init__(
        self,
        collection: Any,
        mesh: Any,
        axis_name: str,
        pack_values: bool,
        batch_specs: Any,
        donate: bool,
        process_group: Any = None,
    ) -> None:
        if mesh is not None and (not isinstance(mesh, int) or isinstance(mesh, bool) or mesh < 1):
            raise ValueError(
                f"mesh is the number of shards stacked on this process (a positive int or None), got {mesh!r};"
                " the port has no device mesh: a rank stacks its shards and syncs over a process group"
            )
        _check_process_group(process_group)
        self._coll = collection
        self.num_shards = 1 if mesh is None else int(mesh)
        self._axis = axis_name
        self._batch_specs = None if batch_specs is None else tuple(batch_specs)
        self._donate = donate
        self._group = process_group
        #: the carried canonical baseline on the collection's device (the
        #: read point merges it) and on the host (the shadow and the exports)
        self._baseline_box: Dict[str, Any] = {}
        self._baseline_host: Optional[Dict[str, Dict[str, Any]]] = None
        self._baseline_version = 0
        self._local_body, self._reduce_body, self._fold_body, self._unpack = _make_deferred_bodies(
            collection, process_group, pack_values, self._baseline_box
        )
        self._compiled: Dict[Any, Callable] = {}
        self._disp: Optional[_Dispatcher] = None
        #: the leaves of the tree the last donating step handed out
        self._handed: Optional[List[torch.Tensor]] = None
        #: committed local steps (one a batch; an epoch adds its length)
        self._steps = 0
        self._shadow: Optional[Any] = None
        self._on_shard_loss = "raise"
        self._recovered_states: Optional[Any] = None
        self._integrity: Optional[Any] = None
        self.stats: Dict[str, Any] = {
            "calls": 0, "compiles": 0, "cache_hits": 0, "donated_calls": 0, "copied_calls": 0,
            "skipped_calls": 0, "capture_us_total": 0.0,
        }
        #: the keys whose capture failed (they run eagerly: ``skipped_calls``)
        self.capture_failures: List[str] = []

    # ------------------------------------------------------------ layout
    def _dim(self, i: int) -> Optional[int]:
        """The dim a batch argument splits along (None: every shard sees it all)."""
        if self._batch_specs is None:
            return 0
        spec = self._batch_specs[i] if i < len(self._batch_specs) else None
        if spec is None:
            return None
        return 0 if isinstance(spec, str) else int(spec)

    def init_states(self) -> Dict[str, Dict[str, Any]]:
        """Fresh stacked states (``(S, *field)`` a field) on the collection's device."""
        return self._coll.init_sharded_states(self.num_shards)

    def _dispatcher(self) -> _Dispatcher:
        if self._disp is None:
            self._disp = _Dispatcher(self._coll.device)
            self._disp.judging = False  # a chunk of shard updates is one replay, always
        return self._disp

    def _get(self, key: Any, builder: Callable[[], Callable]) -> Callable:
        """The dispatch seam: every call resolves its callable here
        (``testing.faults.drop_shard`` patches it)."""
        fn = self._compiled.get(key)
        if fn is None:
            fn = self._compiled[key] = builder()
        return fn

    # ------------------------------------------------------------ bodies
    def _one_step(self, states: Any, shard_args: List[tuple]) -> Any:
        """Every shard's update of one step: shard ``s`` takes its slice of
        the state and ``shard_args[s]``; the results stack back."""
        parts = []
        for s, args in enumerate(shard_args):
            local = {leader: {k: v.narrow(0, s, 1) for k, v in sub.items()} for leader, sub in states.items()}
            parts.append(self._local_body(local, *args))  # its own fusion scope: one count a shard
        return {
            leader: {k: torch.cat([p[leader][k] for p in parts]) if len(parts) > 1 else parts[0][leader][k] for k in sub}
            for leader, sub in states.items()
        }

    def _step_args(self, batch: tuple) -> List[tuple]:
        per_arg = [_shard_slices(x, self._dim(i), self.num_shards, f"argument {i}") for i, x in enumerate(batch)]
        return [tuple(a[s] for a in per_arg) for s in range(self.num_shards)]

    def _epoch_args(self, stacked: tuple) -> List[List[tuple]]:
        steps = int(stacked[0].shape[0]) if stacked else 0
        out = []
        for t in range(steps):
            out.append(self._step_args(tuple(x[t] if isinstance(x, torch.Tensor) else x for x in stacked)))
        return out

    # ----------------------------------------------------------- dispatch
    def _dispatch(self, kind: str, states: Any, batch: tuple, body: Callable[[Any, tuple], Any]) -> Any:
        """Run ``body(states, batch)`` as one captured key over the step's two
        state slots (the body called directly off the card)."""
        leaves, treedef = tree_flatten(tuple(batch))
        sig = _classify_leaves(leaves)
        if sig is None or not _trace_clean():
            self.stats["skipped_calls"] += 1
            out = body(states, batch)
            return out if self._donate else {k: dict(v) for k, v in out.items()}
        disp = self._dispatcher()
        state_leaves, _ = tree_flatten(states)
        disp.ensure_slots(states)
        handed = self._handed
        donated = handed is not None and len(handed) == len(state_leaves) and all(v is h for v, h in zip(state_leaves, handed))
        if not donated:
            # a tree handed out earlier lives in a slot that a later step wrote
            slot_ptrs = {t.data_ptr() for slot in disp.slots for t in slot}
            if any(isinstance(v, torch.Tensor) and v.data_ptr() in slot_ptrs for v in state_leaves):
                raise TorchMetricsUserError(
                    "these deferred states were donated to an earlier step and are spent (their slot has been written"
                    " since); pass the states the last step returned, or build the step with donate=False"
                )
        if not donated and handed is not None:
            # the tree the last step handed out lives in the slot this call
            # loads: move it to storage of its own (it stays valid, as an
            # undonated output does in the JAX package)
            for t in handed:
                t.set_(t.clone())
            self._handed = None
        live = disp.slots[disp.cur]
        dyn, bool_spec = _split_static_bools(leaves)
        key = (kind, self.num_shards, treedef, sig, disp.spec, tuple((tuple(t.shape), t.dtype) for t in live))
        entry = disp.entries.get(key)
        if entry is not None and entry.eager_reason is not None:  # its capture failed: the same kernels, eagerly
            self.stats["skipped_calls"] += 1
            return body(states, batch)
        fresh = entry is None or (disp.graphs and not entry.graphs)
        if fresh:
            def run(st: Any, scalars: Any, *xs: Any) -> Tuple[Any, None]:
                return body(st, tree_unflatten(treedef, _merge_static_bools(xs, bool_spec, len(leaves)))), None

            entry = disp.entries[key] = _Entry(run)
            entry.desc = _describe_key(key)
            self.stats["compiles"] += 1
        else:
            self.stats["cache_hits"] += 1
        disp.load(states)
        call = _Call(dyn, None, None, None, [])
        if fresh:
            t0 = time.perf_counter_ns()
            try:
                new_state, _ = disp.run_fresh(entry, call, [])
            except _CaptureFailed as failed:
                # the key's eager run serves this call; the key runs eagerly from now on
                entry.eager_reason = f"capture failed: {type(failed.original).__name__}: {failed.original}"
                self.capture_failures.append(f"{entry.desc}: {entry.eager_reason}")
                rank_zero_debug(f"torchmetrics_tpu_torch deferred step: {self.capture_failures[-1]}")
                return failed.result[0]
            disp._write_slot(1 - disp.cur, new_state)
            self.stats["capture_us_total"] += (time.perf_counter_ns() - t0) / 1e3
        else:
            disp.run_warm(entry, call, [])
        disp.cur ^= 1
        self.stats["calls"] += 1
        self.stats["donated_calls" if donated else "copied_calls"] += 1
        if not self._donate:
            return {leader: {k: v.clone() for k, v in sub.items()} for leader, sub in disp.slot_tree(disp.cur).items()}
        # new tensors on the live slot's storage: only this tree donates to
        # the next step; any earlier one, though it may share the slot, is
        # spent
        self._handed = [
            torch.empty(0, dtype=t.dtype, device=t.device).set_(t.untyped_storage(), t.storage_offset(), t.size(), t.stride())
            for t in disp.slots[disp.cur]
        ]
        return tree_unflatten(disp.spec, self._handed)

    def _run_guarded(self, key: Any, builder: Callable[[], Callable], states: Any, batch: tuple) -> Any:
        from torchmetrics_tpu_torch.utils.exceptions import ShardLossError

        fn = self._get(key, builder)
        try:
            with obs.span(obs.SPAN_DISPATCH, suffix=type(self._coll).__name__, histogram="executor.dispatch_us"):
                return fn(states, *batch)
        except ShardLossError as err:
            if self._on_shard_loss != "restore" or self._shadow is None:
                raise obs.flighted(
                    err, domain="shadow", kind="shard_loss", shard=getattr(err, "shard", None), policy=self._on_shard_loss
                )
            # reinstall the bounded-lag shadow and re-apply THIS batch on the
            # fresh accumulators: the run loses at most updates_behind steps
            fresh = self.recover()
            with obs.span(obs.SPAN_DISPATCH, suffix=type(self._coll).__name__, histogram="executor.dispatch_us"):
                return fn(fresh, *batch)

    def local_step(self, states: Any, *batch: Any) -> Any:
        """One step: shard ``s`` accumulates slice ``s`` of every sharded
        argument (``batch_specs``; default: each along dim 0), with no
        collective. One CUDA graph replay on the card."""

        me = weakref.proxy(self)  # what the cache and the graphs' bodies keep: no cycle holds the graphs

        def build() -> Callable:
            return lambda st, *b: me._dispatch("local", st, b, lambda s_, b_: me._one_step(s_, me._step_args(b_)))

        out = self._run_guarded(("local", len(batch)), build, states, batch)
        self._steps += 1
        self._tick_shadow(out)
        self._tick_integrity(out)
        return out

    def local_epoch(self, states: Any, *stacked: Any) -> Any:
        """A chunk of T steps (every argument's leading axis is steps; the
        batch dim follows) unrolled in one captured graph keyed by T. The
        step count advances by T."""

        me = weakref.proxy(self)

        def epoch(st: Any, chunk: tuple) -> Any:
            for args in me._epoch_args(chunk):
                st = me._one_step(st, args)
            return st

        def build() -> Callable:
            return lambda st, *b: me._dispatch("epoch", st, b, epoch)

        out = self._run_guarded(("epoch", len(stacked)), build, states, stacked)
        self._steps += int(stacked[0].shape[0]) if stacked else 0
        self._tick_shadow(out)
        self._tick_integrity(out)
        return out

    # --------------------------------------------------------- read point
    def reduce(self, states: Any) -> Any:
        """The read point: fold, one sync in a process group, the baseline's
        merge, every compute; host values (numpy leaves) when packing."""
        from torchmetrics_tpu_torch.utils.exceptions import ShardLossError

        def build() -> Callable:
            return self._reduce_body

        fn = self._get(("reduce", self._baseline_version), build)
        try:
            with obs.span(obs.SPAN_REDUCE):
                return self._unpack(fn(states))
        except ShardLossError as err:
            return self._serve_shard_loss(err)

    def reduce_async(self, states: Any) -> Any:
        """Non-blocking :meth:`reduce`: the read point's kernels are enqueued
        on the caller's stream here (before any later step's replay, which
        waits on that stream), and a
        :class:`~torchmetrics_tpu_torch.ops.async_read.MetricFuture`
        resolves to the unpacked values on the read pipeline's worker. Its
        outputs are fresh tensors, never a slot."""
        from torchmetrics_tpu_torch.ops.async_read import MetricFuture, get_pipeline, materialize, submission_event, wait_submitted
        from torchmetrics_tpu_torch.utils.exceptions import ShardLossError

        def build() -> Callable:
            return self._reduce_body

        fn = self._get(("reduce", self._baseline_version), build)
        with obs.span(obs.SPAN_COMPUTE_ASYNC, suffix="DeferredCollectionStep"):
            try:
                packed = fn(states)
            except ShardLossError as err:
                future = MetricFuture(owner="DeferredCollectionStep.reduce")
                try:
                    future._finish(self._serve_shard_loss(err), None)
                except Exception as served:  # the raise policy: the future carries it
                    future._finish(None, served)
                return future
            event = submission_event(packed)

            def job() -> Any:
                wait_submitted(event)
                return self._unpack(materialize(packed))

            return get_pipeline().submit(job, owner="DeferredCollectionStep.reduce")

    # ------------------------------------------------------ elastic topology
    def _fold_fn(self) -> Callable:
        """The shadow's fold: the read point's fold and sync, returning the
        reduced states (fresh tensors, never a slot)."""
        return self._get("shadow_fold", lambda: self._fold_body)

    def _tick_shadow(self, states: Any) -> None:
        shadow = self._shadow
        if shadow is None or not shadow.due(self._steps):
            return
        folded = self._fold_fn()(states)  # enqueued; the pipeline worker waits for it
        shadow.observe(folded, self._steps, baseline=self._baseline_host)

    def attach_shadow(self, every_n_steps: int = 8, on_shard_loss: str = "degraded") -> Any:
        """Keep a bounded-lag host shadow of the folded reduce (refreshed on
        the read pipeline every ``every_n_steps`` committed steps) and
        resolve :class:`~torchmetrics_tpu_torch.utils.exceptions.ShardLossError`
        per ``on_shard_loss``: ``"raise"`` propagates, ``"degraded"`` serves
        the shadow as a ``DegradedValue``, ``"restore"`` reinstalls it and
        continues. Returns the
        :class:`~torchmetrics_tpu_torch.parallel.reshard.ShardShadow`; it
        trails the live steps by at most ``every_n_steps - 1`` plus any
        refresh in flight."""
        from torchmetrics_tpu_torch.parallel.reshard import SHARD_LOSS_POLICIES, ShardShadow

        if on_shard_loss not in SHARD_LOSS_POLICIES:
            raise ValueError(f"on_shard_loss must be one of {SHARD_LOSS_POLICIES}, got {on_shard_loss!r}")

        coll = self._coll

        def reductions_of() -> Dict[str, Dict[str, Any]]:
            return {leader: coll._modules[leader]._reductions for leader in coll.state_spec()}

        self._shadow = ShardShadow(reductions_of, every_n_steps=every_n_steps)
        self._on_shard_loss = on_shard_loss
        return self._shadow

    def _tick_integrity(self, states: Any) -> None:
        integrity = self._integrity
        if integrity is None or not integrity.due(self._steps):
            return
        integrity.observe(states, self._steps)

    def attach_integrity(self, every_n_steps: int = 8, on_divergence: str = "raise") -> Any:
        """Audit the carried stacked states on a cadence (``integrity.py``):
        every ``every_n_steps``-th committed step captures per-shard
        fingerprints, and :meth:`~torchmetrics_tpu_torch.integrity.DeferredIntegrity.audit`
        verifies the states against them while the step count has not
        moved, naming the shard a flip hit. ``on_divergence="restore"``
        reinstalls the shard shadow (:meth:`recover`): attach one first."""
        from torchmetrics_tpu_torch.integrity import DeferredIntegrity

        self._integrity = DeferredIntegrity(weakref.proxy(self), every_n_steps=every_n_steps, on_divergence=on_divergence)
        return self._integrity

    @property
    def integrity(self) -> Any:
        return self._integrity

    @property
    def shadow(self) -> Any:
        return self._shadow

    @property
    def steps(self) -> int:
        """Committed local steps since construction (or the last restore)."""
        return self._steps

    @property
    def baseline(self) -> Any:
        """The carried canonical baseline of an elastic restore or a
        recovery (None on the straight-through path)."""
        return self._baseline_box.get("baseline")

    def _set_baseline(self, canonical: Any) -> None:
        import numpy as np

        device = self._coll.device
        self._baseline_box["baseline"] = {
            leader: {f: torch.as_tensor(v).to(device) if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v), device=device)
                     for f, v in sub.items()}
            for leader, sub in canonical.items()
        }
        self._baseline_host = {
            leader: {f: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for f, v in sub.items()}
            for leader, sub in canonical.items()
        }
        self._baseline_version += 1  # a new baseline is never served by a stale read point

    def restore_states(self, states: Any, step_count: Optional[int] = None, stacked: Optional[bool] = None) -> Any:
        """Reinstall checkpointed deferred state saved on any shard count.

        ``states`` is leader-keyed: a stacked layout (detected by the
        reserved ``"_sharded_shards"`` mark; ``stacked=`` overrides) or an
        already-canonical value. The fold goes through
        ``parallel/reshard.py``; the canonical value becomes the carried
        baseline merged at every read, and fresh identity accumulators for
        this step's shards are returned. ``step_count`` re-anchors the
        staleness clock."""
        from torchmetrics_tpu_torch.parallel.reshard import fold_canonical

        count_key, shards_key = "_update_count", "_sharded_shards"
        canonical: Dict[str, Dict[str, Any]] = {}
        for leader, sub in states.items():
            reds = self._coll._modules[leader]._reductions
            is_stacked = stacked
            if is_stacked is None:
                is_stacked = isinstance(sub, dict) and sub.get(shards_key) is not None
            # a restore replaces any carried baseline: the snapshot is the
            # whole accumulation (export_canonical folds a live baseline in)
            canonical[leader] = fold_canonical(sub, reds) if is_stacked else {
                k: v for k, v in sub.items() if k not in (count_key, shards_key)
            }
        obs.counter_inc("shards.elastic_restores")
        self._set_baseline(canonical)
        if step_count is not None:
            self._steps = int(step_count)
        if self._shadow is not None:
            self._shadow.seed(canonical, self._steps)
        return self.init_states()

    def export_canonical(self, states: Any, precision: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
        """The whole accumulation as one canonical host tree: the live
        stacked ``states`` folded, the carried baseline merged in (what a
        checkpoint persists once a baseline exists). Blocks on the fold's
        device-to-host copy: a save point, not the step loop.

        ``precision="quantized"`` returns each leader in the block-quantized
        wire format (``parallel.quantized``; each leader's
        ``sync_quant_bits``/``sync_quant_block``), the fleet uplink's shape.
        Checkpoints stay exact (``None``)."""
        import numpy as np

        from torchmetrics_tpu_torch.parallel.quantized import encode_canonical
        from torchmetrics_tpu_torch.parallel.reshard import merge_folded

        if precision not in (None, "exact", "quantized"):
            raise ValueError(f"precision must be None, 'exact' or 'quantized', got {precision!r}")

        def host(v: Any) -> Any:
            return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

        folded = self._fold_fn()(states)
        baseline = self._baseline_host
        out: Dict[str, Dict[str, Any]] = {}
        for leader, sub in folded.items():
            values = {f: host(v) for f, v in sub.items()}
            if baseline is not None and leader in baseline:
                values = {
                    f: host(v) for f, v in merge_folded(baseline[leader], values, self._coll._modules[leader]._reductions).items()
                }
            if precision == "quantized":
                m = self._coll._modules[leader]
                obs.counter_inc("sync.quantized_reduces")
                values = encode_canonical(values, bits=getattr(m, "sync_quant_bits", 8), block_size=getattr(m, "sync_quant_block", 256))
            out[leader] = values
        return out

    def canonical_reductions(self) -> Dict[str, Dict[str, Any]]:
        """Per-leader reduction maps of the :meth:`export_canonical` fold (a
        fleet exporter cuts deltas with them, an aggregator merges them)."""
        return {leader: dict(self._coll._modules[leader]._reductions) for leader in self._coll._modules}

    def export_delta(self, states: Any, baseline: Optional[Dict[str, Any]] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(canonical, payload)``: the exact canonical fold and, per leader
        and field, what changed since ``baseline`` (a previous call's
        canonical; None: everything). Ship the payload, keep the canonical
        as the next call's baseline (``fleet.delta_since``)."""
        from torchmetrics_tpu_torch.fleet.delta import delta_since

        canonical = self.export_canonical(states)
        reductions = self.canonical_reductions()
        payload: Dict[str, Dict[str, Any]] = {}
        for leader, sub in canonical.items():
            prev = baseline.get(leader) if baseline is not None else None
            payload[leader] = delta_since(sub, prev, reductions[leader])
        return canonical, payload

    def recover(self) -> Any:
        """Reinstall the shadow's last completed refresh as the carried
        baseline and return fresh accumulators (the ``"restore"`` action).
        Raises when no refresh has completed yet."""
        snap = None if self._shadow is None else self._shadow.snapshot()
        if snap is None:
            raise RuntimeError(
                "shard-loss recovery requested but no shadow refresh has completed;"
                " attach_shadow() earlier or lower every_n_steps"
            )
        canonical, shadow_steps = snap
        obs.counter_inc("shards.shadow_restores")
        obs.fault_breadcrumb(
            "shard_loss_restore",
            domain="shadow",
            data={"shadow_steps": shadow_steps, "live_steps": self._steps, "updates_behind": max(0, self._steps - shadow_steps)},
        )
        self._set_baseline(canonical)
        self._steps = int(shadow_steps)
        self._shadow.seed(canonical, self._steps)
        fresh = self.init_states()
        self._recovered_states = fresh
        return fresh

    def take_recovered_states(self) -> Any:
        """Pop the fresh states a read-point recovery installed (None when
        none happened since the last call)."""
        out, self._recovered_states = self._recovered_states, None
        return out

    def _serve_shard_loss(self, err: BaseException) -> Any:
        """Resolve a ShardLossError at the read point per ``on_shard_loss``."""
        from torchmetrics_tpu_torch.quarantine import DegradedValue

        shadow = self._shadow
        snap = None if shadow is None else shadow.snapshot()
        if self._on_shard_loss == "raise" or snap is None:
            raise obs.flighted(err, domain="shadow", kind="shard_loss", shard=getattr(err, "shard", None), policy=self._on_shard_loss)
        canonical, shadow_steps = snap
        behind = max(0, self._steps - shadow_steps)
        obs.gauge_set("shards.shadow_age_updates", behind)
        obs.histogram_observe("shards.shadow_staleness_updates", behind)
        obs.counter_inc("shards.degraded_reads")
        obs.fault_breadcrumb(
            "shard_loss_degraded",
            domain="shadow",
            data={"shard": getattr(err, "shard", None), "policy": self._on_shard_loss, "updates_behind": behind},
        )
        if self._on_shard_loss == "restore":
            self.recover()
        device = self._coll.device
        values = self._coll.functional_compute(
            {k: {f: torch.as_tensor(v, device=device) for f, v in sub.items()} for k, sub in canonical.items()}
        )
        return DegradedValue(value=values, updates_behind=behind, age_updates=shadow_steps)

    # -------------------------------------------------------------- memory
    def static_bytes(self) -> int:
        """Bytes of the step's state slots and static inputs."""
        return 0 if self._disp is None else self._disp.static_bytes()

    def graph_pool_bytes(self) -> int:
        """Bytes of the step's private graph pool (a memory-snapshot walk)."""
        return 0 if self._disp is None else self._disp.pool_bytes()


def make_deferred_collection_step(
    collection: Any,
    mesh: Any = None,
    axis_name: str = "batch",
    pack_values: bool = True,
    batch_specs: Any = None,
    donate: bool = True,
    process_group: Any = None,
) -> DeferredCollectionStep:
    """The deferred-reduction epoch loop for ``collection``.

    ``mesh`` is the number of shards stacked on this process (None: 1; a
    rank of a data-parallel job stacks its own and the read point syncs
    over ``process_group``); ``axis_name`` is metadata only. Returns a
    :class:`DeferredCollectionStep` whose ``local_step`` and
    ``local_epoch`` accumulate with no collective, the states donated, and
    whose ``reduce`` applies every ``dist_reduce_fx`` once. ``batch_specs``
    gives each batch argument's split: the dim its rows shard along (0 by
    default) or None for an argument every shard sees whole.

    >>> import torch
    >>> from torchmetrics_tpu_torch import MetricCollection
    >>> from torchmetrics_tpu_torch.aggregation import SumMetric
    >>> coll = MetricCollection({"total": SumMetric(device="cpu")}, device="cpu")
    >>> step = make_deferred_collection_step(coll, mesh=2)
    >>> states = step.local_step(step.init_states(), torch.arange(4.0))
    >>> float(step.reduce(states)["total"])
    6.0
    """
    return DeferredCollectionStep(collection, mesh, axis_name, pack_values, batch_specs, donate, process_group)


def latest_recovery_snapshot(obj: Any) -> Optional[Tuple[int, Dict[str, Any]]]:
    """The state exactly one committed update behind the live state, shaped
    like a ``state()`` export: the Autosaver's free checkpoint source.

    The JAX package keeps a host copy before every donating call; the port
    keeps none: its recovery reference is the state slot the last replay
    read, which no later call has written yet. This copies that slot to the
    host, ordered on the capture stream under the device's lock (no replay
    can write it meanwhile), and marks nothing escaped (the next call
    copies nothing in). Returns ``(update_count, export)`` with the
    reserved ``"_update_count"`` key(s) embedded and numpy leaves (a
    collection's export is leader-keyed, its count the largest), or None
    when the slot is not exactly one committed update behind: no replay
    yet, the last call ran eagerly (or did not commit), or the live state
    escaped (was read or set by reference) since.
    """
    import numpy as np

    ex = getattr(obj, "_executor_obj", None)
    rec = getattr(ex, "_last_recovery", None)
    disp = getattr(ex, "_dispatcher", None)
    if rec is None or disp is None or disp.slots is None:
        return None
    count_key = "_update_count"
    if isinstance(ex, CollectionExecutor):
        coll = ex._coll
        for cg in coll._groups.values():
            if cg[0] not in rec or int(coll._modules[cg[0]]._update_count) != rec[cg[0]] + 1:
                return None
            if any(coll._modules[name]._state_escaped for name in cg):
                return None
    else:
        m = ex._metric
        if int(m._update_count) != rec + 1 or m._state_escaped:
            return None
    read = disp.slots[1 - disp.cur]
    with disp.lock if disp.lock is not None else nullcontext():
        if disp.graphs:
            with torch.cuda.stream(_capture_stream(disp.device)):
                host = [t.cpu() for t in read]  # ordered after the last replay, which read this slot
        else:
            host = [t.clone() for t in read]
    tree = tree_unflatten(disp.spec, [t.numpy() for t in host])
    if isinstance(ex, CollectionExecutor):
        export = {leader: dict(sub, **{count_key: int(rec[leader])}) for leader, sub in tree.items()}
        return max(int(c) for c in rec.values()), export
    return int(rec), dict(tree, **{count_key: int(rec)})


def executor_stats(obj: Any) -> Dict[str, Any]:
    """Executor instrumentation for a ``Metric`` or ``MetricCollection``:
    zeroed stats before the executor engaged (or when it is off); the keys
    of this module's ``_new_stats`` plus the diagnosis keys."""
    ex = getattr(obj, "_executor_obj", None)
    if ex is None:
        out = _new_stats()
        out.update(
            disabled_reason=None, fallback_reason=None, bucketing_enabled=True, cached_executables=0,
            background_enabled=False, pending_background=0, profile_entries=0, captured=False,
            eager={"keys": 0, "calls": 0, "reasons": []},
        )
        return out
    return ex.stats_dict()
