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
    the padding rows written as copies of row 0) and fills the static
    scalars (the valid row count, a forward's update count).

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
    As in the JAX package: a ragged batch pads up the ladder of
    :func:`bucket_size` (padding rows are copies of the batch's first row)
    and the padding's contribution is subtracted inside the body for
    ``"sum"`` states. The first padded call also runs the eager body on the
    unpadded batch and compares; a mismatch turns bucketing off for good.

Where no graph can be captured (a metric on the CPU), the same bookkeeping
runs with the body called directly in place of a replay: keys, the ladder,
padding, probes, slots, escapes, copies, stats and containment.
"""
from __future__ import annotations

import gc
import os
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.utils.exceptions import DispatchStallError
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

ENV_FLAG = "TORCHMETRICS_TPU_EXECUTOR"

#: version of :meth:`_ExecutorBase.shape_profile` manifests (the JAX package's)
PROFILE_VERSION = 1

_BUCKET_FLOOR = 8
_FUSABLE_REDUCTIONS = ("sum", "max", "min")
_PROFILE_CAP = 64

#: the kernel launch counters a replay adds to: (module, attribute)
_LAUNCH_COUNTERS = (
    ("bincount", "launches"),
    ("binned_curve", "launches"),
    ("topk_kernel", "launches"),
    ("ssim_kernel", "launches"),
    ("sqrtm_kernel", "launches"),
    ("sqrtm_kernel", "calls"),
    ("fingerprint", "launches"),
)


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
            sig.append((tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""), str(leaf.device)))
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
        # the compile-ahead layer's keys (a later port of ops/compile_cache.py)
        "disk_hits": 0,
        "disk_stores": 0,
        "disk_evictions": 0,
        "background_compiles": 0,
        "eager_misses": 0,
        "compile_us_total": 0.0,  # wall time of fresh keys' dispatches: the eager run and the capture
        "warmup": 0,              # keys built through the warmup API
    }


# ---------------------------------------------------------- launch counts


_COUNTER_MODULES: List[Tuple[Any, str]] = []


def _counter_modules() -> List[Tuple[Any, str]]:
    if not _COUNTER_MODULES:
        import importlib

        _COUNTER_MODULES.extend((importlib.import_module(f"torchmetrics_tpu_torch.ops.{mod}"), attr) for mod, attr in _LAUNCH_COUNTERS)
    return _COUNTER_MODULES


def _read_counters(mods: List[Tuple[Any, str]]) -> List[int]:
    return [int(getattr(m, attr)) for m, attr in mods]


def _write_counters(mods: List[Tuple[Any, str]], values: List[int]) -> None:
    for (m, attr), v in zip(mods, values):
        setattr(m, attr, v)


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
    """One cache key: its body and, on the card, its two graphs."""

    __slots__ = ("body", "graphs", "inputs", "scalars", "values", "launches")

    def __init__(self, body: Callable) -> None:
        self.body = body
        self.graphs: List[Any] = []
        self.inputs: List[torch.Tensor] = []
        self.scalars: List[torch.Tensor] = []
        self.values: List[Any] = []
        self.launches: List[int] = []


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
        #: the order of a padded call on a fresh key. On the card (True) the
        #: eager update on the batch as given serves it, so the call
        #: launches what the eager path does, and the key's first replay
        #: probes; off it (False) JAX's order: the eager oracle, then the
        #: padded body, whose counters the CPU tests hold to JAX's. Either
        #: order runs on either device (``test_card_order_of_a_fresh_padded_key``)
        self.eager_fresh_padded = self.graphs
        self.entries: Dict[Any, _Entry] = {}
        self.slots: Optional[List[List[torch.Tensor]]] = None
        self.spec: Any = None
        self.cur = 0
        self.slot_ids: frozenset = frozenset()

    # ------------------------------------------------------------ slots
    def ensure_slots(self, state_tree: Any) -> None:
        """Two slots shaped like ``state_tree``; a new layout drops every key."""
        leaves, spec = tree_flatten(state_tree)
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

    def load(self, state_tree: Any) -> None:
        """Copy the live state into the current slot (tensors already there stay)."""
        for dst, src in zip(self.slots[self.cur], tree_flatten(state_tree)[0]):
            if dst is not src:
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

    def run_fresh(self, entry: _Entry, call: _Call, metrics: Sequence[Any]) -> Any:
        """A fresh key: run its body eagerly on the live slot, on the
        caller's stream as the eager path does (the kernels' libraries are
        built and their attributes set before the capture), then capture
        its graphs on the card. Returns the body's ``(state, value)``, which
        serves the call. A padded call with ``call.eager`` runs it, the
        update on the unpadded batch, in place of the padded body; the
        graphs are captured at the padded shapes."""
        state = self.slot_tree(self.cur) if call.state is None else call.state
        with _active(metrics):
            if call.eager is not None:
                new_state, value = call.eager()
            else:
                new_state, value = entry.body(state, self._scalar_tensors(call.scalars), *call.padded_leaves())
        self._check_layout(new_state)
        result = (new_state, self._detached(value))
        if self.graphs:
            try:
                self._capture(entry, call, metrics)
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

    def _capture(self, entry: _Entry, call: _Call, metrics: Sequence[Any]) -> None:
        from torchmetrics_tpu_torch.ops.kernels import shared_scope

        inputs = [
            torch.empty(((call.bucket,) + tuple(x.shape[1:])) if is_batched else tuple(x.shape), dtype=x.dtype, device=x.device)
            for x, is_batched in zip(call.leaves, call.batched or (False,) * len(call.leaves))
        ]
        scalars = [torch.zeros((), dtype=torch.int32, device=self.device) for _ in call.scalars]
        mods = _counter_modules()
        graphs, values = [], []
        with self.lock:
            # no cyclic collection inside a capture: a collected graph's
            # destruction is not permitted while the stream captures. Under
            # the lock, so a capture waiting for another never reads the
            # other's switch as its own
            collecting = gc.isenabled()
            gc.disable()
            before = _read_counters(mods)
            try:
                stream = _capture_stream(self.device)
                stream.wait_stream(torch.cuda.current_stream(self.device))
                for d in (0, 1):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.stream(stream), _active(metrics):
                        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                        try:
                            with shared_scope():
                                new_state, value = entry.body(self.slot_tree(d), scalars, *inputs)
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
                after = _read_counters(mods)
            finally:
                _write_counters(mods, before)  # a capture launches nothing
                if collecting:
                    gc.enable()
        entry.graphs, entry.inputs, entry.scalars, entry.values = graphs, inputs, scalars, values
        entry.launches = [(a - b) // 2 for a, b in zip(after, before)]

    def _release_failed_capture(self) -> None:
        """A capture whose end failed (the capture was invalidated) may
        leave the caching allocator routing to the pool and counting a
        capture underway, which defers every later free for good (the
        reserved memory then only grows), and it leaves no graph to hand
        the pool back. End the routing (a no-op error where it already
        ended) and release this capture's hold on the pool."""
        index, pool = self.device.index, tuple(self.pool)
        try:
            torch._C._cuda_endAllocateToPool(index, pool)
        except RuntimeError:  # the failed end had already stopped the routing
            pass
        torch._C._cuda_releasePool(index, pool)
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
        for buf, x, is_batched in zip(entry.inputs, call.leaves, call.batched or (False,) * len(call.leaves)):
            n = int(x.shape[0]) if is_batched else None
            if n is None or n == buf.shape[0]:
                buf.copy_(x)
            else:
                buf[:n].copy_(x)
                buf[n:].copy_(x[:1].expand((buf.shape[0] - n,) + tuple(x.shape[1:])))
        for buf, v in zip(entry.scalars, call.scalars):
            buf.fill_(v)
        caller = torch.cuda.current_stream(self.device)
        with self.lock:
            stream = _capture_stream(self.device)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                entry.graphs[d].replay()
            caller.wait_stream(stream)
        mods = _counter_modules()
        _write_counters(mods, [c + n for c, n in zip(_read_counters(mods), entry.launches)])
        return self.slot_tree(1 - d), self._detached(entry.values[d], always=True)

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


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def spec_of_call(kind: str, args: tuple, kwargs: dict) -> Optional[Dict[str, Any]]:
    """JSON-able description of one call's input shapes, or None when it
    cannot be replayed from a manifest (nested structures, other leaves).
    The JAX package's format: ``{"kind", "args": [...], "kwargs": {...}}``,
    a leaf ``{"shape", "dtype"}`` or ``{"bool"}``."""

    def leaf(v: Any) -> Optional[Dict[str, Any]]:
        if type(v) is bool:
            return {"bool": v}
        if isinstance(v, torch.Tensor):
            return {"shape": [int(s) for s in v.shape], "dtype": _dtype_name(v.dtype)}
        return None

    arg_specs = [leaf(a) for a in args]
    kw_specs = {k: leaf(v) for k, v in kwargs.items()}
    if any(s is None for s in arg_specs) or any(s is None for s in kw_specs.values()):
        return None
    return {"kind": kind, "args": arg_specs, "kwargs": kw_specs}


def dummy_from_spec(spec: Dict[str, Any], device: torch.device) -> Tuple[tuple, dict]:
    """Zero-filled ``(args, kwargs)`` on ``device`` matching a recorded spec."""

    def leaf(s: Dict[str, Any]) -> Any:
        if "bool" in s:
            return bool(s["bool"])
        return torch.zeros(tuple(s["shape"]), dtype=getattr(torch, s["dtype"]), device=device)

    return tuple(leaf(s) for s in spec.get("args", ())), {k: leaf(s) for k, s in spec.get("kwargs", {}).items()}


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
        # one dispatch or warmup of this executor at a time (its slots and
        # keys); the device's lock keeps captures and replays apart
        self._lock = threading.RLock()

    def _owner_name(self) -> str:
        return type(self).__name__

    def _device(self) -> torch.device:
        raise NotImplementedError

    def _members(self) -> List[Any]:
        """Every metric whose state the bodies read (escape suppression)."""
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

    def _get_fn(self, key: Any, builder: Callable[[], Callable]) -> Tuple[Callable[..., Any], bool]:
        """Resolve ``key`` to its dispatch callable ``fn(call) -> (state,
        value)`` and whether the key is fresh (built now; ``compiles``)."""
        disp = self.dispatcher()
        entry = disp.entries.get(key)
        if entry is not None and (entry.graphs or not disp.graphs):
            self.stats["cache_hits"] += 1
            members = self._members()
            return (lambda call: disp.run_warm(entry, call, members)), False
        entry = disp.entries[key] = _Entry(builder())
        self.stats["compiles"] += 1
        members = self._members()
        return (lambda call: disp.run_fresh(entry, call, members)), True

    def _timed_dispatch(self, fresh: bool, primary: Callable, retry_call: Callable, restore: Callable) -> Any:
        t_cold_ns = time.perf_counter_ns() if fresh else None
        with obs.span(obs.SPAN_DISPATCH, suffix=self._owner_name(), histogram="executor.dispatch_us", cold=fresh):
            out = self._guarded_dispatch(primary, retry_call, fresh, restore)
        if t_cold_ns is not None:
            t_now_ns = time.perf_counter_ns()
            self.stats["compile_us_total"] += (t_now_ns - t_cold_ns) / 1e3
            obs.record_span(obs.SPAN_COMPILE, t_cold_ns, t_now_ns, {"owner": self._owner_name()})
        return out

    def _prepare_leaves(self, leaves: List[Any], bucketable: bool):
        """(signature, padding plan) of a call's leaves, or None when the call
        is ineligible."""
        sig = _classify_leaves(leaves)
        if sig is None:
            return None
        n = _common_batch_dim(leaves)
        bucket, padded, batched = None, False, None
        if n is not None and n > 0 and bucketable:
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
    def _warmup_one(self, kind: str, args: tuple, kwargs: dict) -> str:
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
        jobs = [("update", a, k) for a, k in _normalize_warmup_specs(batch_specs, self._device())]
        if forward:
            jobs += [("forward", a, k) for _, a, k in list(jobs)]
        return self._launch_warmup(jobs, ladder, background)

    def warmup_from_manifest(self, manifest: Dict[str, Any], background: bool = False) -> Any:
        """Replay a shape-profile manifest (the dict :meth:`shape_profile`
        returns): builds exactly the call shapes recorded, no ladder."""
        if not isinstance(manifest, dict) or not isinstance(manifest.get("specs"), list):
            raise ValueError("manifest has no 'specs' list")
        jobs = []
        for spec in manifest["specs"]:
            args, kwargs = dummy_from_spec(spec, self._device())
            jobs.append((spec.get("kind", "update"), args, kwargs))
        return self._launch_warmup(jobs, ladder=False, background=background)

    def _launch_warmup(self, jobs: List[Tuple[str, tuple, dict]], ladder: bool, background: bool) -> Any:
        if not background:
            return self._run_warmup(jobs, ladder)
        handle = WarmupHandle()
        thread = threading.Thread(target=handle._run, args=(self._run_warmup, jobs, ladder), name="tm_tpu_warmup", daemon=True)
        handle._thread = thread
        thread.start()
        return handle

    def _run_warmup(self, jobs: List[Tuple[str, tuple, dict]], ladder: bool) -> Dict[str, Any]:
        t0 = time.perf_counter()
        report: Dict[str, Any] = {"warmed": 0, "already_warm": 0, "skipped": []}
        for kind, args, kwargs in jobs:
            for v_args, v_kwargs in self._ladder_variants(args, kwargs) if ladder else [(args, kwargs)]:
                try:
                    outcome = self._warmup_one(kind, v_args, v_kwargs)
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

    def _dispatch_warmup(self, key: Any, builder: Callable[[], Callable], state_tree: Any, call: _Call) -> str:
        """Shared tail of the warmup paths: build ``key``, its eager run on
        a zero state and zero dummies (discarded), and capture it; the live
        state is never read or written."""
        disp = self.dispatcher()
        if key in disp.entries:
            return "already_warm"
        t0 = time.perf_counter()
        with obs.span(obs.SPAN_WARMUP, owner=self._owner_name()), self._lock:
            disp.ensure_slots(state_tree)
            call.state = state_tree
            fn, _ = self._get_fn(key, builder)
            try:
                fn(call)
            except _CaptureFailed as failed:
                disp.entries.pop(key, None)
                raise failed.original
        self.stats["warmup"] += 1
        self.stats["compile_us_total"] += (time.perf_counter() - t0) * 1e6
        return "warmed"

    def stats_dict(self) -> Dict[str, Any]:
        out = dict(self.stats)
        out["disabled_reason"] = self.disabled_reason
        out["fallback_reason"] = self.disabled_reason
        out["bucketing_enabled"] = self._bucketing_ok
        disp = self._dispatcher
        out["cached_executables"] = 0 if disp is None else len(disp.entries)
        out["background_enabled"] = False
        out["pending_background"] = 0
        out["profile_entries"] = len(self._profile)
        out["captured"] = disp is not None and disp.graphs
        return out

    def static_bytes(self) -> int:
        """Bytes of the executor's state slots and static inputs."""
        return 0 if self._dispatcher is None else self._dispatcher.static_bytes()

    def graph_pool_bytes(self) -> int:
        """Bytes the private graph pool holds (a memory-snapshot walk: call it
        off the hot path)."""
        return 0 if self._dispatcher is None else self._dispatcher.pool_bytes()


def _zero_state(metric: Any) -> Dict[str, Any]:
    return {k: torch.zeros_like(v) for k, v in metric._defaults.items()}


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
        return self._state_sig_memo[1]

    def _live_state(self) -> Dict[str, Any]:
        m = self._metric
        return {k: m._state[k] for k in m._defaults}

    # -------------------------------------------------------------- bodies
    def _build_update(self, treedef: Any, batched: Any, bucket: Any, padded: bool, bool_spec: tuple, n_leaves: int) -> Callable:
        ref = self._metric_ref
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

    def _build_forward(self, treedef: Any, batched: Any, bucket: Any, padded: bool, variant: str, bool_spec: tuple, n_leaves: int) -> Callable:
        ref = self._metric_ref
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
    def _prepare(self, args: tuple, kwargs: dict):
        leaves, treedef = tree_flatten((tuple(args), dict(kwargs)))
        prep = self._prepare_leaves(leaves, self.bucketable())
        if prep is None:
            return None
        return (treedef,) + prep

    def _eligible_now(self) -> bool:
        """Per call: the fault harness's update seam runs eagerly."""
        return "_update_fn" not in self._metric.__dict__

    # --------------------------------------------------------------- warmup
    def _warmup_bucketable(self) -> bool:
        return self.bucketable()

    def _warmup_one(self, kind: str, args: tuple, kwargs: dict) -> str:
        m = self._metric
        if not self.usable():
            return f"{kind}: executor unusable ({self.disabled_reason or self._static_reason()})"
        prep = self._prepare(args, kwargs)
        if prep is None:
            return f"{kind}: inputs not executor-eligible"
        treedef, sig, dyn, batched, bucket, n, padded, bool_spec, n_leaves = prep
        scalars = [n] if padded else []
        if kind == "update":
            key = ("u", treedef, sig, batched, bucket if padded else None, self._state_sig())

            def build():
                return self._build_update(treedef, batched, bucket, padded, bool_spec, n_leaves)

        elif kind == "forward":
            if not self._plain_forward or m.dist_sync_on_step:
                return "forward: not fusable (custom forward or dist_sync_on_step)"
            variant = "reduce" if m.full_state_update is False else "full"
            key = ("f", variant, treedef, sig, batched, bucket if padded else None, self._state_sig())
            scalars = [0] + scalars

            def build():
                return self._build_forward(treedef, batched, bucket, padded, variant, bool_spec, n_leaves)

        else:
            return f"{kind}: unknown warmup kind"
        return self._dispatch_warmup(key, build, _zero_state(m), _Call(dyn, batched, n, bucket, scalars))

    # ---------------------------------------------------------------- entry
    def run_update(self, args: tuple, kwargs: dict) -> bool:
        """Run ``update`` through the executor; False -> the caller runs the
        eager body (nothing was applied).

        A FRESH key's failure is a build problem: the executor steps aside
        for good and the eager body serves. A WARM replay's failure leaves
        the live state at its pre-call slot and the original error
        propagates (no eager re-run of the batch)."""
        if not self.usable():
            return False
        if not _trace_clean() or not self._eligible_now():
            self.stats["skipped_calls"] += 1
            return False
        try:
            with self._lock:
                return self._run_update(args, kwargs)
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
        disp.ensure_slots(state)
        fn, fresh = self._get_fn(key, lambda: self._build_update(treedef, batched, bucket, padded, bool_spec, n_leaves))
        need_copy = fresh or m._state_escaped or m._state_shared
        disp.load(state)
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
        return True

    def run_forward(self, args: tuple, kwargs: dict) -> Tuple[bool, Any]:
        """Run ``forward`` as one ``(state, batch) -> (state', value)``
        dispatch. Returns ``(handled, batch_value)``."""
        m = self._metric
        if not self.usable() or not self._plain_forward or m.dist_sync_on_step:
            return False, None
        if not _trace_clean() or not self._eligible_now() or "_compute_fn" in m.__dict__:
            self.stats["skipped_calls"] += 1
            return False, None
        try:
            with self._lock:
                return self._run_forward(args, kwargs)
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
            key, lambda: self._build_forward(treedef, batched, bucket, padded, variant, bool_spec, n_leaves)
        )
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

    def _state_sig(self) -> Tuple[Any, ...]:
        """Per leader, as :meth:`MetricExecutor._state_sig`."""
        leaders = self._leaders()
        vers = tuple((name, getattr(m, "_state_layout_version", 0)) for name, m, _ in leaders)
        if self._state_sig_memo is None or self._state_sig_memo[0] != vers:
            sig = tuple(
                (name, ver, tuple((k, tuple(v.shape), str(v.dtype)) for k, v in m._defaults.items()))
                for (name, ver), (_, m, _) in zip(vers, leaders)
            )
            self._state_sig_memo = (vers, sig)
        return self._state_sig_memo[1]

    def _live_states(self, leader_execs) -> Dict[str, Dict[str, Any]]:
        return {name: {k: m._state[k] for k in m._defaults} for name, m, _, _ in leader_execs}

    # -------------------------------------------------------------- bodies
    def _build_update(self, treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves) -> Callable:
        ref = self._coll_ref
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

    def _build_forward(self, treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves) -> Callable:
        ref = self._coll_ref
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
    def _prepare(self, args: tuple, kwargs: dict, leader_execs):
        leaves, treedef = tree_flatten((tuple(args), dict(kwargs)))
        prep = self._prepare_leaves(leaves, self.bucketable(leader_execs))
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

    def _warmup_one(self, kind: str, args: tuple, kwargs: dict) -> str:
        if self.disabled_reason is not None:
            return f"{kind}: executor disabled ({self.disabled_reason})"
        leader_execs = self._leader_executors()
        if leader_execs is None:
            return f"{kind}: a compute-group leader is not executor-eligible"
        prep = self._prepare(args, kwargs, leader_execs)
        if prep is None:
            return f"{kind}: inputs not executor-eligible"
        treedef, sig, dyn, batched, bucket, n, padded, bool_spec, n_leaves = prep
        kw_map = {name: self._kwarg_names(m, kwargs) for name, m, _ in self._leaders()}
        kw_key = tuple(sorted(kw_map.items()))
        zero = {name: _zero_state(m) for name, m, _, _ in leader_execs}
        if kind == "update":
            key = ("u", treedef, sig, batched, bucket if padded else None, kw_key, self._state_sig())
            scalars = [n] if padded else []

            def build():
                return self._build_update(treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves)

        elif kind == "forward":
            reason = self._forward_unfusable_reason(leader_execs)
            if reason is not None:
                return f"forward: {reason}"
            key = ("f", treedef, sig, batched, bucket if padded else None, kw_key, self._state_sig())
            scalars = [0] * len(leader_execs) + ([n] if padded else [])

            def build():
                return self._build_forward(treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves)

        else:
            return f"{kind}: unknown warmup kind"
        return self._dispatch_warmup(key, build, zero, _Call(dyn, batched, n, bucket, scalars))

    # ---------------------------------------------------------------- entry
    def run_update(self, args: tuple, kwargs: dict) -> bool:
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
        try:
            with self._lock:
                return self._run_update(args, kwargs, leader_execs)
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
        kw_map = {name: self._kwarg_names(m, kwargs) for name, m, _ in self._leaders()}
        key = ("u", treedef, sig, batched, bucket if padded else None, tuple(sorted(kw_map.items())), self._state_sig())
        self._record_profile(key, "update", args, kwargs)
        states = self._live_states(leader_execs)
        disp = self.dispatcher()
        disp.ensure_slots(states)
        fn, fresh = self._get_fn(key, lambda: self._build_update(treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves))
        copied, donated = self._donation(leader_execs, fresh)
        disp.load(states)
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
        return True

    def run_forward(self, args: tuple, kwargs: dict) -> Optional[Dict[str, Any]]:
        """Fused forward for the WHOLE collection, or None to fall back."""
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
                return self._run_forward(args, kwargs, leader_execs)
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
        fn, fresh = self._get_fn(key, lambda: self._build_forward(treedef, batched, bucket, padded, kw_map, bool_spec, n_leaves))
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
        return dict(values)


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
        )
        return out
    return ex.stats_dict()
