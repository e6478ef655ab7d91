"""Stateful ``Metric`` core on PyTorch.

The same design as the JAX package's ``metric.py``: a metric's state is a
dict of tensors (or lists of tensors for growing states) declared with
:meth:`Metric.add_state`, and the familiar stateful object is a thin shell
over pure functions of that state::

    state = metric.functional_init()
    state = metric.functional_update(state, *batch)     # (state, batch) -> state'
    value = metric.functional_compute(state)            # state -> value
    state = metric.merge_states(a, b)                   # per declared reduction

Attributes named in ``add_state`` are routed into the live state dict, so a
subclass reads and assigns ``self.tp = self.tp + tp`` like any attribute.

Device: state lives on the card unless the caller asks otherwise. With
``device=None`` (the default) it is placed on the current CUDA device, and
construction raises when there is none; ``device="cpu"`` opts out. An update
whose input tensors lie on another device raises instead of copying.

State dtypes follow the JAX package, which runs with 64-bit types off: a
Python or 64-bit integer default becomes int32, a float default float32.

Updates replace state tensors rather than mutating them in place. The
transactional snapshot of :meth:`update` and :meth:`forward` therefore holds
plain references, and compute-group followers can share their leader's
tensors. The one writer in place is the captured executor
(``ops/executor.py``, on by default for a metric on the card): its state
slots are never handed out, because every by-reference read first swaps the
slot tensors it would hand out for copies (:meth:`Metric._escape_state`).

Cross-process sync runs on ``torch.distributed`` (``parallel/sync.py``):
:meth:`sync` is a no-op when no process group is initialised; with one, it
reduces every state across the metric's ``process_group`` (default: the
world) per its declared reduction, into fresh tensors, so a follower's
shared state and :meth:`unsync`'s cache are never written. ``compute``
syncs first unless ``sync_on_compute=False``.
"""
from __future__ import annotations

import copy
import functools
import inspect
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.parallel.class_shard import (
    CLASS_SHARDABLE_REDUCTIONS,
    STATE_SHARDINGS,
    ClassShardLayout,
    default_class_shards,
    default_state_sharding,
    identity_pad_value,
    shard_layout,
    stack_dense,
)
from torchmetrics_tpu_torch.parallel.quantized import DEFAULT_BITS, DEFAULT_BLOCK, SYNC_PRECISIONS, default_sync_precision
from torchmetrics_tpu_torch.parallel.sync import (
    REDUCE_POLICIES,
    SYNC_FAILURE_POLICIES,
    default_reduce_policy,
    default_sync_timeout,
    fold_sharded_states,
    init_sharded_states,
    sync_states,
)
from torchmetrics_tpu_torch.quarantine import DegradedValue
from torchmetrics_tpu_torch.utils.checks import _check_same_device
from torchmetrics_tpu_torch.utils.data import _flatten, _squeeze_if_scalar
from torchmetrics_tpu_torch.utils.exceptions import StateCorruptionError, TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Reduction = Union[str, Callable[[torch.Tensor], torch.Tensor], None]


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device metric state lives on: the current CUDA device unless the
    caller names another one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: metric state lives on the GPU by default;"
                ' pass device="cpu" to keep it on the CPU'
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def distributed_available() -> bool:
    """Default world check: an initialised ``torch.distributed`` process group."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _as_state_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` with the JAX package's 32-bit default dtypes."""
    t = torch.as_tensor(value)
    if t.dtype == torch.int64:
        t = t.to(torch.int32)
    elif t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device)


class _BoundPerAccess:
    """A metric class's own ``update`` or ``compute``, wrapped in ``body``
    (the transaction, or the cached and synced compute) afresh on every
    access through an instance. Nothing is stored on the instance, so a
    metric is no reference cycle: ``del m`` frees its state at once, without
    a pass of the cyclic garbage collector. Through the class, or through
    ``super()`` from an override, it is the plain function."""

    def __init__(self, func: Callable, body: Callable) -> None:
        functools.update_wrapper(self, func)
        self.func, self.body = func, body
        sig = inspect.signature(func)
        self.signature = sig.replace(parameters=list(sig.parameters.values())[1:])
        self._outermost: Dict[type, bool] = {}

    def _is_outermost(self, cls: type) -> bool:
        """Whether ``cls``'s attribute lookup finds this wrapper (not an override's)."""
        found = self._outermost.get(cls)
        if found is None:
            owner = next(k for k in cls.__mro__ if self.__name__ in k.__dict__)
            found = self._outermost[cls] = owner.__dict__[self.__name__] is self
        return found

    def __get__(self, obj: Any, objtype: Optional[type] = None) -> Callable:
        if obj is None:
            return self.func
        if not self._is_outermost(type(obj)):
            return self.func.__get__(obj, objtype)
        func, body = self.func, self.body

        @functools.wraps(func)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            return body(obj, func, *args, **kwargs)

        wrapped_func.__signature__ = self.signature
        return wrapped_func


#: the metrics (and collections) whose update or forward is running on this
#: thread, outermost first
_CALLS = threading.local()


@contextmanager
def _metric_call(owner: Any) -> Generator[None, None, None]:
    """Mark ``owner``'s update or forward as running on this thread."""
    stack = getattr(_CALLS, "stack", None)
    if stack is None:
        stack = _CALLS.stack = []
    stack.append(owner)
    try:
        yield
    finally:
        stack.pop()


def _called_from_another(metric: Any) -> bool:
    """Whether ``metric`` is updated from inside another metric's (a
    wrapper's, a composition's) or a collection's call: its own executor
    then steps aside, as the caller drives it."""
    stack = getattr(_CALLS, "stack", None)
    return bool(stack) and any(owner is not metric for owner in stack)


def _transactional_update(self: "Metric", update: Callable, *args: Any, **kwargs: Any) -> None:
    with _metric_call(self):
        _transactional_update_body(self, update, *args, **kwargs)


def _transactional_update_body(self: "Metric", update: Callable, *args: Any, **kwargs: Any) -> None:
    # transactional contract: any exception out of this call leaves
    # (_state, _update_count, _computed) exactly as they were before it
    _check_same_device(self._device, args, kwargs, type(self).__name__)
    # a sharded restore folds first, so the update runs on the reduced
    # layout; the committed fold is itself a valid pre-call state
    self._fold_pending()
    pre_count, pre_computed = self._update_count, self._computed
    pre_reduced = self.__dict__.get("_reduced", True)
    # the count moves BEFORE the cache clears: the async read's cache
    # write-back checks the count around its write (ops/async_read.py)
    self._update_count += 1
    self._computed = None
    ex = self._get_executor()
    if ex is not None:
        args, kwargs = self._executor_inputs(args, kwargs)
        try:
            with obs.span(obs.SPAN_UPDATE, suffix=type(self).__name__):
                handled = ex.run_update(args, kwargs)
        except BaseException:
            # the executor left the live state at its pre-call slot; only
            # the bookkeeping unwinds
            self._update_count, self._computed = pre_count, pre_computed
            self.__dict__["_reduced"] = pre_reduced
            raise
        if handled:
            self._mark_unreduced()
            self._notify_update()
            return
    snapshot = self._state_snapshot()
    patched = self.__dict__.get("_update_fn")  # the fault harness's seam (testing/faults.py)
    try:
        with obs.span(obs.SPAN_UPDATE, suffix=type(self).__name__):
            if patched is None:
                update(self, *args, **kwargs)
            else:
                patched(*args, **kwargs)
    except TypeError as err:
        self._rollback(snapshot, pre_count, pre_computed, reduced=pre_reduced)
        if "got an unexpected keyword argument" in str(err) or "positional argument" in str(err):
            raise TypeError(f"Encountered an error while calling `update` of {type(self).__name__}: {err}") from err
        raise
    except BaseException:
        self._rollback(snapshot, pre_count, pre_computed, reduced=pre_reduced)
        raise
    if ex is not None:
        ex.eager_done()  # the eager trial of a captured key, if this was one
    self._mark_unreduced()
    # post-commit: an observer raising here (a simulated preemption) does
    # not unwind the committed update
    self._notify_update()


def _cached_compute(self: "Metric", compute: Callable, *args: Any, **kwargs: Any) -> Any:
    if self._update_count == 0:
        rank_zero_warn(
            f"The ``compute`` method of metric {type(self).__name__}"
            " was called before the ``update`` method which may lead to errors,"
            " as metric states have not yet been updated.",
            UserWarning,
        )
    if self._computed is not None:
        return self._computed
    self._escape_state()  # a value may be a state tensor itself: never a slot the executor writes
    self._fold_pending()  # a sharded restore: fold before the sync and compute
    auditor = self.__dict__.get("_integrity_auditor")
    if auditor is not None:
        # the read-point integrity audit (integrity.py), before the sync:
        # verify the bits before serving them; a divergence raises,
        # restores the verified baseline in place, or hands back the
        # last-good value to serve as a DegradedValue, per on_divergence
        served = auditor.verify_read()
        if served is not None:
            return served
    self.__dict__.pop("_serve_last_good", None)
    patched = self.__dict__.get("_compute_fn")  # the fault harness's seam (testing/faults.py)
    with self.sync_context(
        dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync
    ), obs.span(obs.SPAN_COMPUTE, suffix=type(self).__name__):
        if self.__dict__.pop("_serve_last_good", False):
            # the sync just failed under on_sync_failure="last_good":
            # serve the cached value with its staleness (never cached
            # as _computed: it is stale by definition)
            count, cached = self.__dict__["_last_good_compute"]
            behind = int(self._update_count) - count
            obs.histogram_observe("reads.staleness_age_updates", behind)
            return DegradedValue(value=cached, updates_behind=behind, age_updates=count)
        value = compute(self, *args, **kwargs) if patched is None else patched(*args, **kwargs)
        value = _squeeze_if_scalar(value)
    if self.compute_with_cache:
        self._computed = value
    if self._last_sync_ok:
        # only values whose sync (if any) succeeded are last-good reads
        if self.on_sync_failure == "last_good":
            # kept only where this policy serves it: a compute may return a
            # state tensor itself (a sum, a confusion matrix), and a kept
            # value would hold a replaced state's memory past the next update
            self.__dict__["_last_good_compute"] = (int(self._update_count), value)
        self._notify_compute(int(self._update_count), value)
    return value


#: the sync-precision knobs a read clone takes from its metric at every read
_PRECISION_KNOBS = ("sync_precision", "sync_quant_bits", "sync_quant_block")

def _ready(event: Any, value: Any) -> Any:
    """WORKER-SIDE: wait for the submitting stream, then return ``value``."""
    from torchmetrics_tpu_torch.ops.async_read import wait_submitted

    wait_submitted(event)
    return value


class Metric:
    """Base class for all metrics.

    Subclasses declare states in ``__init__`` via :meth:`add_state`, implement
    ``update(self, ...)`` assigning those states, and ``compute(self)``
    returning the metric value.

    Args:
        kwargs: common keyword arguments:

            - ``device``: where state lives; ``None`` (default) is the current
              CUDA device and raises without one, ``"cpu"`` opts out.
            - ``dist_sync_on_step``: sync state when computing the batch value
              in ``forward``.
            - ``distributed_available_fn``: override the world check.
            - ``sync_on_compute``: sync state automatically in ``compute``
              (default True).
            - ``compute_with_cache``: cache the result of ``compute`` (default
              True).
            - ``process_group``: the ``torch.distributed`` group states sync
              across (default None: the world).
            - ``dist_sync_fn``: ``fn(value, reduction, group) -> value``
              replacing the built-in sync for every state.
            - ``sync_timeout``: seconds each collective of a sync may take
              before it raises ``SyncTimeoutError`` (default
              ``TORCHMETRICS_TPU_SYNC_TIMEOUT``, else unbounded). Under
              NCCL a timed-out collective leaves the communicator in an
              unknown state and PyTorch's watchdog may abort the process,
              so there a timeout is a cue to checkpoint and exit: the
              ``"local"`` and ``"retry"`` policies are meant for gloo.
            - ``on_sync_failure``: ``"raise"`` (default; local state intact),
              ``"local"`` (warn on rank zero, compute on this process's state,
              ``last_sync_ok`` False), ``"retry"`` (re-run the sync with
              capped exponential backoff, ``io/retry.py``) or
              ``"last_good"`` (serve the last value whose sync succeeded as a
              ``DegradedValue``). A fault on one rank only leaves the
              collectives out of step whatever the policy (the peers have
              moved on): the policies assume every rank sees the failure.
            - ``sync_retries``: re-attempts under ``"retry"`` (default
              ``TORCHMETRICS_TPU_SYNC_RETRIES``, else 3).
            - ``reduce``: ``"step"`` or ``"deferred"`` (default
              ``TORCHMETRICS_TPU_REDUCE``, else ``"step"``). Deferred state
              accumulates locally, in the stacked layout of
              :meth:`init_sharded_state` when the caller steps shards, and
              is reduced once at the read point; it excludes
              ``dist_sync_on_step``. :attr:`deferred_pending` says whether a
              reduction is still owed.
            - ``sync_precision``: ``"exact"`` or ``"quantized"`` (default
              ``TORCHMETRICS_TPU_SYNC_PRECISION``, else ``"exact"``): float
              sum/mean/max/min states sync as int codes with per-block
              scales (``parallel/quantized.py``); integer and bool states
              always sync exactly. ``sync_quant_bits`` (8 or 16, default 8)
              and ``sync_quant_block`` (default 256) shape the codes.
            - ``state_sharding``: ``"replicated"`` or ``"class_axis"``
              (default ``TORCHMETRICS_TPU_STATE_SHARDING``, else
              ``"replicated"``): eligible states (fixed-shape, rank >= 1,
              sum/mean/max/min) live as ``(class_shards, ceil(C / S), ...)``
              stacks (``parallel/class_shard.py``). ``class_shards``
              defaults to the number of CUDA devices for a metric on the
              card and to 1 on the CPU.
            - ``executor``: run eager ``update``/``forward`` through the
              captured executor (``ops/executor.py``). ``None`` (default)
              follows ``TORCHMETRICS_TPU_EXECUTOR`` (on) for a metric on the
              card and is off on the CPU, where no graph can be captured;
              ``True`` on the CPU runs the executor's bookkeeping with direct
              calls; ``False`` is the eager path.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import Metric
        >>> class SumAbsError(Metric):
        ...     def __init__(self, **kwargs):
        ...         super().__init__(**kwargs)
        ...         self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        ...     def update(self, preds, target):
        ...         self.total = self.total + (preds - target).abs().sum()
        ...     def compute(self):
        ...         return self.total
        >>> metric = SumAbsError(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0]), torch.tensor([1.5, 2.5]))
        >>> float(metric.compute())
        1.0
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None

    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None

    def __init__(self, **kwargs: Any) -> None:
        # internal bookkeeping set up *before* anything routes through __setattr__
        object.__setattr__(self, "_state", {})
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Reduction] = {}
        #: declared per-state sync_precision overrides (None: the metric's policy)
        self._sync_precisions: Dict[str, Optional[str]] = {}
        #: RESOLVED per-state placement and the layout of every class_axis field
        self._state_shardings: Dict[str, str] = {}
        self._class_layouts: Dict[str, ClassShardLayout] = {}
        self._device = resolve_device(kwargs.pop("device", None))

        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(f"Expected keyword argument `dist_sync_on_step` to be an `bool` but got {self.dist_sync_on_step}")
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or distributed_available
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError(f"Expected keyword argument `dist_sync_fn` to be an callable function but got {self.dist_sync_fn}")
        self.sync_timeout = kwargs.pop("sync_timeout", None)
        if self.sync_timeout is None:
            self.sync_timeout = default_sync_timeout()
        elif not isinstance(self.sync_timeout, (int, float)) or isinstance(self.sync_timeout, bool) or self.sync_timeout <= 0:
            raise ValueError(f"Expected keyword argument `sync_timeout` to be a positive number of seconds but got {self.sync_timeout}")
        self.on_sync_failure = kwargs.pop("on_sync_failure", "raise")
        if self.on_sync_failure not in SYNC_FAILURE_POLICIES:
            raise ValueError(
                f"Expected keyword argument `on_sync_failure` to be one of {SYNC_FAILURE_POLICIES}"
                f" but got {self.on_sync_failure}"
            )
        self.sync_retries = kwargs.pop("sync_retries", None)
        if self.sync_retries is not None and (
            not isinstance(self.sync_retries, int) or isinstance(self.sync_retries, bool) or self.sync_retries < 0
        ):
            raise ValueError(f"Expected keyword argument `sync_retries` to be a non-negative int but got {self.sync_retries}")
        self._last_sync_ok = True
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}")
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if not isinstance(self.compute_with_cache, bool):
            raise ValueError(f"Expected keyword argument `compute_with_cache` to be a `bool` but got {self.compute_with_cache}")
        self.reduce_policy = kwargs.pop("reduce", None)
        if self.reduce_policy is None:
            self.reduce_policy = default_reduce_policy()
        elif self.reduce_policy not in REDUCE_POLICIES:
            raise ValueError(f"Expected keyword argument `reduce` to be one of {REDUCE_POLICIES} but got {self.reduce_policy}")
        if self.reduce_policy == "deferred" and self.dist_sync_on_step:
            raise ValueError(
                "`reduce='deferred'` defers every collective to compute()/sync() and cannot"
                " be combined with `dist_sync_on_step=True` (a per-step sync IS the step policy)"
            )
        self.sync_precision = kwargs.pop("sync_precision", None)
        if self.sync_precision is None:
            self.sync_precision = default_sync_precision()
        elif self.sync_precision not in SYNC_PRECISIONS:
            raise ValueError(f"Expected keyword argument `sync_precision` to be one of {SYNC_PRECISIONS} but got {self.sync_precision}")
        self.sync_quant_bits = kwargs.pop("sync_quant_bits", None)
        if self.sync_quant_bits is None:
            self.sync_quant_bits = DEFAULT_BITS
        elif self.sync_quant_bits not in (8, 16) or isinstance(self.sync_quant_bits, bool):
            raise ValueError(f"Expected keyword argument `sync_quant_bits` to be 8 or 16 but got {self.sync_quant_bits}")
        self.sync_quant_block = kwargs.pop("sync_quant_block", None)
        if self.sync_quant_block is None:
            self.sync_quant_block = DEFAULT_BLOCK
        elif not isinstance(self.sync_quant_block, int) or isinstance(self.sync_quant_block, bool) or self.sync_quant_block < 1:
            raise ValueError(f"Expected keyword argument `sync_quant_block` to be a positive int but got {self.sync_quant_block}")
        self.state_sharding = kwargs.pop("state_sharding", None)
        if self.state_sharding is None:
            self.state_sharding = default_state_sharding()
        elif self.state_sharding not in STATE_SHARDINGS:
            raise ValueError(f"Expected keyword argument `state_sharding` to be one of {STATE_SHARDINGS} but got {self.state_sharding}")
        self.class_shards = kwargs.pop("class_shards", None)
        if self.class_shards is None:
            self.class_shards = default_class_shards(self._device)
        elif not isinstance(self.class_shards, int) or isinstance(self.class_shards, bool) or self.class_shards < 1:
            raise ValueError(f"Expected keyword argument `class_shards` to be a positive int but got {self.class_shards}")
        # deferred-reduction bookkeeping: _reduced is False while locally
        # accumulated state owes its reduction; _pending_shards is the shard
        # count of an installed stacked state awaiting its fold
        self._reduced = True
        self._pending_shards: Optional[int] = None
        self._executor_enabled = kwargs.pop("executor", None)
        if self._executor_enabled is not None and not isinstance(self._executor_enabled, bool):
            raise ValueError(f"Expected keyword argument `executor` to be a `bool` but got {self._executor_enabled}")
        # captured-dispatch bookkeeping (ops/executor.py), the executor built
        # lazily: _state_escaped means the live state may not be the
        # executor's current slot (the next call copies it in first),
        # _state_shared that a collection's compute group aliases it
        self._executor_obj: Optional[Any] = None
        self._state_escaped = True
        self._state_shared = False
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._update_signature = inspect.signature(self.update)
        self._computed: Any = None
        self._update_count: int = 0
        self._to_sync = self.sync_on_compute
        self._should_unsync = True
        self._cache: Optional[Dict[str, Any]] = None
        self._is_synced = False

    # ------------------------------------------------------------------ states
    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, List],
        dist_reduce_fx: Reduction = None,
        *,
        dtype: Optional[torch.dtype] = None,
        sync_precision: Optional[str] = None,
        state_sharding: Optional[str] = None,
    ) -> None:
        """Register a metric state.

        ``default`` is either a tensor (fixed-shape accumulator, placed on the
        metric's device) or an empty list (growing accumulator).
        ``dist_reduce_fx`` in {"sum","mean","max","min","cat", None, callable}
        declares how the state merges across batches (``forward``) and
        processes. ``dtype`` keeps a tensor default in that dtype instead of
        the JAX package's 32-bit one (an exact int64 count).

        ``sync_precision`` overrides the metric's policy for THIS state
        (``"exact"`` or ``"quantized"``; None inherits). Integer and bool
        states sync exactly whatever is declared.

        ``state_sharding`` places THIS state: ``"class_axis"`` stores it as
        the ``(class_shards, ceil(C / S), *rest)`` stack of
        ``parallel/class_shard.py`` (the padded tail rows hold the
        reduction's identity), ``"replicated"`` pins the dense layout, None
        inherits the metric's policy. Only fixed-shape tensors of rank >= 1
        with ``dist_reduce_fx`` in {"sum","mean","max","min"} are eligible:
        an explicit ``"class_axis"`` on anything else raises, while an
        inherited policy leaves an ineligible state replicated.
        """
        if not isinstance(default, (list, int, float, np.ndarray, torch.Tensor)):
            raise ValueError("state variable must be a tensor or an empty list")
        if isinstance(default, list) and default:
            raise ValueError("state variable must be a tensor or an *empty* list (any data must be appended via update)")
        if dist_reduce_fx not in ("sum", "mean", "cat", "min", "max", None) and not callable(dist_reduce_fx):
            raise ValueError(
                "`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None],"
                f" got {dist_reduce_fx!r}"
            )
        if sync_precision is not None and sync_precision not in SYNC_PRECISIONS:
            raise ValueError(f"`sync_precision` must be None or one of {SYNC_PRECISIONS}, got {sync_precision!r}")
        if state_sharding is not None and state_sharding not in STATE_SHARDINGS:
            raise ValueError(f"`state_sharding` must be None or one of {STATE_SHARDINGS}, got {state_sharding!r}")
        if not isinstance(default, list):
            default = _as_state_tensor(default, self._device) if dtype is None else torch.as_tensor(
                default, dtype=dtype, device=self._device
            )
        # class-axis placement, resolved once at declaration
        eligible = not isinstance(default, list) and default.ndim >= 1 and dist_reduce_fx in CLASS_SHARDABLE_REDUCTIONS
        if state_sharding == "class_axis" and not eligible:
            kind = "list" if isinstance(default, list) else f"rank-{default.ndim} array"
            raise ValueError(
                f"state {name!r}: state_sharding='class_axis' requires a fixed-shape array"
                f" state of rank >= 1 with dist_reduce_fx in {CLASS_SHARDABLE_REDUCTIONS};"
                f" got a {kind} with dist_reduce_fx={dist_reduce_fx!r}"
            )
        resolved = state_sharding
        if resolved is None:
            policy = self.__dict__.get("state_sharding", "replicated")
            resolved = "class_axis" if (policy == "class_axis" and eligible) else "replicated"
        if resolved == "class_axis":
            layout = shard_layout(int(default.shape[0]), int(self.class_shards))
            pad = identity_pad_value(dist_reduce_fx, default.dtype)
            corner = default[(0,) * default.ndim]
            if all(st == 0 for st in default.stride()) and corner.item() == pad:
                # a broadcast of the identity (a zero count matrix passed as an
                # expanded scalar): the stacked default stays a broadcast too,
                # so only the live state holds memory
                default = corner.expand((layout.num_shards, layout.shard_size) + tuple(default.shape[1:]))
            else:
                default = stack_dense(default, layout, pad_value=pad)
            self._class_layouts[name] = layout
            obs.counter_inc("shards.class_sharded_states")
        else:
            self._class_layouts.pop(name, None)
        self._state_shardings[name] = resolved
        self._sync_precisions[name] = sync_precision
        self._defaults[name] = default
        self._reductions[name] = dist_reduce_fx
        self._state[name] = [] if isinstance(default, list) else default.clone()

    def __getattr__(self, name: str) -> Any:
        # only called when normal lookup fails
        d = self.__dict__
        state = d.get("_state")
        if state is not None and name in state:
            # handed out by reference: the next executor call copies first,
            # and a tensor of the executor's slots is swapped for a copy
            d["_state_escaped"] = True
            value = state[name]
            if id(value) in d.get("_slot_ids", ()) and not d.get("_exec_active"):
                value = state[name] = value.clone()
            return value
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("higher_is_better", "is_differentiable", "full_state_update", "plot_lower_bound", "plot_upper_bound", "plot_legend_name"):
            raise RuntimeError(f"Can't change const `{name}`.")
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            state[name] = value
            self.__dict__["_state_escaped"] = True
            return
        object.__setattr__(self, name, value)

    def _escape_state(self) -> Dict[str, Any]:
        """Prepare the live state to be held by reference past the next
        update: every tensor of the executor's slots in it is swapped for a
        copy (a slot is written again two calls later), and the state is
        marked escaped, so the executor copies it back in first. Returns the
        live state dict. Inside the executor's own bodies it only marks."""
        d = self.__dict__
        d["_state_escaped"] = True
        state = d["_state"]
        slots = d.get("_slot_ids")
        if slots and not d.get("_exec_active"):
            for k, v in state.items():
                if id(v) in slots:
                    state[k] = v.clone()
        return state

    def _escaped_snapshot(self) -> Dict[str, Any]:
        """:meth:`_state_snapshot` of a state held past the next update."""
        self._escape_state()
        return self._state_snapshot()

    @property
    def metric_state(self) -> Dict[str, Any]:
        """Current (live) state values."""
        state = self._escape_state()
        return {attr: state[attr] for attr in self._defaults}

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def device(self) -> torch.device:
        """The device the metric's state lives on."""
        return self._device

    # ------------------------------------------------------------- update path
    def _state_snapshot(self) -> Dict[str, Any]:
        """Shallow copy of the live state (the transaction's rollback target
        and the functional API's result): updates replace tensors, so
        references suffice; list states are list-copied."""
        return {k: (list(v) if isinstance(v, list) else v) for k, v in self._state.items()}

    def _rollback(self, state: Dict[str, Any], update_count: int, computed: Any, reduced: Optional[bool] = None) -> None:
        """Reinstall a pre-call snapshot after a failed update/forward
        (``reduced`` restores the deferred-reduction flag taken with it)."""
        obs.counter_inc("rollback.count")
        object.__setattr__(self, "_state", state)
        self.__dict__["_state_escaped"] = True  # whoever saw the failure may hold these
        self.__dict__["_update_count"] = update_count
        self.__dict__["_computed"] = computed
        if reduced is not None:
            self.__dict__["_reduced"] = reduced

    # ------------------------------------------------- class-axis placement
    def _class_layout(self, name: str) -> Optional[ClassShardLayout]:
        """The :class:`~torchmetrics_tpu_torch.parallel.class_shard.ClassShardLayout`
        of a class-sharded field, or None when ``name`` is replicated."""
        return self.__dict__.get("_class_layouts", {}).get(name)

    def _sync_qspecs(self) -> Dict[str, Optional[Tuple[int, int]]]:
        """The RESOLVED per-state quantization: field -> None (exact) or
        ``(bits, block)``. The ``add_state`` override wins, else the
        metric's ``sync_precision``; a non-float tensor state is always
        exact."""
        d = self.__dict__
        policy = d.get("sync_precision", "exact")
        overrides = d.get("_sync_precisions", {})
        bits, block = int(d.get("sync_quant_bits", DEFAULT_BITS)), int(d.get("sync_quant_block", DEFAULT_BLOCK))
        out: Dict[str, Optional[Tuple[int, int]]] = {}
        for name, default in self._defaults.items():
            resolved = overrides.get(name) or policy
            if resolved != "quantized" or (not isinstance(default, list) and not default.is_floating_point()):
                out[name] = None
            else:
                out[name] = (bits, block)
        return out

    def _adopt_class_layouts(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Re-split incoming class-axis fields into THIS metric's layout.

        A snapshot may carry a field dense (saved by a replicated twin) or
        stacked for another shard count; both re-split exactly (gather to
        dense, trim, re-stack). In the other direction a stacked field
        arriving at a replicated field of a shardable reduction is gathered
        back to dense. Other shapes pass through for :meth:`validate_state`
        to judge; only the exact ``(d, ceil(C / d), *rest)`` geometry heals.
        """
        if not isinstance(state, dict):
            return state

        def stacked(shape: Tuple[int, ...], num_classes: int, rest: Tuple[int, ...]) -> bool:
            # any shard count d gives (d, ceil(C / d), *rest)
            return len(shape) == 2 + len(rest) and shape[2:] == rest and shape[0] >= 1 and shape[1] == -(-num_classes // shape[0])

        layouts = self.__dict__.get("_class_layouts") or {}
        out = dict(state)
        for name, policy in (self.__dict__.get("_state_shardings") or {}).items():
            if policy != "replicated" or name in layouts:
                continue
            fx = self._reductions.get(name)
            value = out.get(name)
            default = self._defaults.get(name)
            if fx not in CLASS_SHARDABLE_REDUCTIONS or not isinstance(value, torch.Tensor) or default.ndim < 1:
                continue
            num_classes, rest = int(default.shape[0]), tuple(default.shape[1:])
            shape = tuple(value.shape)
            if stacked(shape, num_classes, rest):
                out[name] = value.reshape((shape[0] * shape[1],) + rest)[:num_classes]
        for name, layout in layouts.items():
            value = out.get(name)
            if not isinstance(value, torch.Tensor):
                continue
            rest = tuple(self._defaults[name].shape[2:])
            shape = tuple(value.shape)
            if shape == (layout.num_shards, layout.shard_size) + rest:
                continue
            pad = identity_pad_value(self._reductions.get(name), value.dtype)
            if shape == (layout.num_classes,) + rest:
                out[name] = stack_dense(value, layout, pad_value=pad)
            elif stacked(shape, layout.num_classes, rest):
                dense = value.reshape((shape[0] * shape[1],) + rest)[: layout.num_classes]
                out[name] = stack_dense(dense, layout, pad_value=pad)
        return out

    # --------------------------------------------------- deferred reduction
    @property
    def deferred_pending(self) -> bool:
        """True while local state still owes its deferred reduction: the
        ``reduce="deferred"`` policy holds unreduced updates, or a stacked
        state was installed (``load_state(..., sharded=True)``) and not yet
        folded."""
        if self.__dict__.get("_pending_shards") is not None:
            return True
        return self.__dict__.get("reduce_policy") == "deferred" and not self.__dict__.get("_reduced", True)

    def _fold_pending(self) -> None:
        """Fold an installed stacked state into the reduced layout: the
        on-demand reduce that keeps update/compute/sync right after a
        sharded restore."""
        if self.__dict__.get("_pending_shards") is None:
            return
        t0 = time.perf_counter()
        with obs.span(obs.SPAN_REDUCE, owner=type(self).__name__, kind="fold_pending"):
            folded = fold_sharded_states({k: self._state[k] for k in self._defaults}, self._reductions)
        new_state = dict(self._state)
        new_state.update(folded)
        object.__setattr__(self, "_state", new_state)
        self.__dict__["_state_escaped"] = True
        self.__dict__["_pending_shards"] = None
        self.__dict__["_last_reduce_us"] = round((time.perf_counter() - t0) * 1e6, 1)

    def _mark_unreduced(self) -> None:
        """Record that state now holds locally accumulated values (a no-op
        outside the deferred policy)."""
        if self.__dict__.get("reduce_policy") == "deferred":
            self.__dict__["_reduced"] = False

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        _wrap_methods(cls)

    @property
    def _update_fn(self) -> Callable:
        """The class's own ``update``, without the transaction (or the body
        the fault harness installed in its place, ``testing/faults.py``)."""
        return self.__dict__.get("_update_fn") or type(self).update.__get__(self)

    @property
    def _compute_fn(self) -> Callable:
        """The class's own ``compute``, without the cache and the sync (or
        the body the fault harness installed in its place)."""
        return self.__dict__.get("_compute_fn") or type(self).compute.__get__(self)

    def update(self, *_: Any, **__: Any) -> None:  # overridden by subclass; wrapped by _BoundPerAccess
        raise NotImplementedError

    def compute(self) -> Any:  # overridden by subclass; wrapped by _BoundPerAccess
        raise NotImplementedError

    # ----------------------------------------------------------- forward paths
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate into global state AND return the batch value.

        The internal updates of a forward notify no update observer (their
        intermediate states hold one batch only); one notification follows
        the committed forward."""
        self.__dict__["_forward_depth"] = self.__dict__.get("_forward_depth", 0) + 1
        try:
            with _metric_call(self):
                batch_val = self._forward_impl(*args, **kwargs)
        finally:
            self.__dict__["_forward_depth"] -= 1
        self._notify_update()
        return batch_val

    def _forward_impl(self, *args: Any, **kwargs: Any) -> Any:
        ex = self._get_executor()
        if ex is not None:
            _check_same_device(self._device, args, kwargs, type(self).__name__)
            self._fold_pending()  # a sharded restore: fold before merging batches
            handled, batch_val = ex.run_forward(args, kwargs)
            if handled:
                self._mark_unreduced()
                return batch_val
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """2x update strategy, transactional: any exception restores the
        pre-call accumulated state."""
        pre_state = self._escaped_snapshot()
        pre_count, pre_computed = self._update_count, self._computed
        try:
            self.update(*args, **kwargs)
            _update_count = self._update_count
            self._to_sync = self.dist_sync_on_step
            cache = self._escaped_snapshot()
            self._computed = None
            self.reset()
            self.update(*args, **kwargs)
            batch_val = self.compute()
            # restore context
            self._update_count = _update_count
            self._state = cache
        except BaseException:
            self._rollback(pre_state, pre_count, pre_computed)
            raise
        finally:
            self._to_sync = self.sync_on_compute
            self._should_unsync = True
        self._computed = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """1x update + state-merge strategy, transactional: a raise from the
        batch update, the batch compute or the merge restores the pre-call
        global state and count."""
        global_state = self._escaped_snapshot()
        _update_count = self._update_count
        pre_computed = self._computed
        self.reset()
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        try:
            self.update(*args, **kwargs)
            batch_val = self.compute()
            self._update_count = _update_count + 1
            self._reduce_states(global_state)
        except BaseException:
            self._rollback(global_state, _update_count, pre_computed)
            raise
        finally:
            self._to_sync = self.sync_on_compute
            self._should_unsync = True
        self._computed = None
        return batch_val

    def _reduce_states(self, incoming_state: Dict[str, Any]) -> None:
        """Merge incoming (global) state into current (batch) state."""
        for attr in self._defaults:
            local_state = self._state[attr]
            global_state = incoming_state[attr]
            reduce_fn = self._reductions[attr]
            if reduce_fn == "sum":
                reduced = global_state + local_state
            elif reduce_fn == "mean":
                reduced = ((self._update_count - 1) * global_state + local_state) / self._update_count
            elif reduce_fn == "max":
                reduced = torch.maximum(global_state, local_state)
            elif reduce_fn == "min":
                reduced = torch.minimum(global_state, local_state)
            elif reduce_fn == "cat":
                if isinstance(global_state, list) or isinstance(local_state, list):
                    reduced = list(global_state) + list(local_state)
                else:
                    reduced = torch.cat([torch.atleast_1d(global_state), torch.atleast_1d(local_state)])
            elif reduce_fn is None and isinstance(global_state, torch.Tensor):
                reduced = torch.stack([global_state, local_state])
            elif reduce_fn is None and isinstance(global_state, list):
                reduced = _flatten([global_state, local_state])
            elif callable(reduce_fn):
                reduced = reduce_fn(torch.stack([global_state, local_state]))
            else:
                reduced = global_state
            self._state[attr] = reduced

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    # ------------------------------------------------------------------- sync
    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
        process_group: Any = None,
    ) -> None:
        """Reduce states across processes per their declared reductions.

        A no-op without an initialised process group (``distributed_available``,
        default the metric's ``distributed_available_fn``). Otherwise the
        states sync across ``process_group`` (default the metric's; None is
        the world) under ``sync_timeout`` and ``on_sync_failure``, or through
        ``dist_sync_fn`` when one is given. The pre-sync state is kept for
        :meth:`unsync`; a failed sync leaves the live state as it was.
        """
        if self._is_synced and should_sync:
            raise TorchMetricsUserError("The Metric has already been synced.")
        self._fold_pending()  # a sharded restore: fold the shards before the collectives
        distributed_available = distributed_available or self.distributed_available_fn
        if not should_sync or not distributed_available():
            return
        group = process_group if process_group is not None else self.process_group
        self._cache = self._escaped_snapshot()
        t0 = time.perf_counter()
        try:
            with obs.span(obs.SPAN_REDUCE, owner=type(self).__name__, kind="sync"):
                dist_sync_fn = dist_sync_fn or self.dist_sync_fn
                if dist_sync_fn is not None:
                    self._state = {k: dist_sync_fn(v, self._reductions.get(k), group) for k, v in self._state.items()}
                else:
                    self._sync_bounded(group)
        except BaseException:
            self._cache = None
            raise
        self._is_synced = True
        # the state now holds reduced values; unsync restores the flag
        self.__dict__["_reduced_pre_sync"] = self.__dict__.get("_reduced", True)
        self.__dict__["_reduced"] = True
        self.__dict__["_last_reduce_us"] = round((time.perf_counter() - t0) * 1e6, 1)

    def _sync_bounded(self, group: Any) -> None:
        """The built-in sync under ``sync_timeout`` and ``on_sync_failure``:
        ``"raise"`` propagates with the local state intact; ``"local"`` keeps
        the local state with a rank-zero warning (``last_sync_ok`` False);
        ``"retry"`` re-runs the whole sync with capped exponential backoff
        before it propagates; ``"last_good"`` has ``compute`` serve the last
        value whose sync succeeded, or degrades like ``"local"`` without one."""

        def sync_all() -> Dict[str, Any]:
            return self._sync_states(self._state, self._reductions, group)

        try:
            if self.on_sync_failure == "retry":
                from torchmetrics_tpu_torch.io.retry import RetryPolicy, call_with_retries, default_sync_retries

                retries = self.sync_retries if self.sync_retries is not None else default_sync_retries()
                synced = call_with_retries(
                    sync_all, RetryPolicy(max_retries=retries), what=f"sync of {type(self).__name__}"
                )
            else:
                synced = sync_all()
        except Exception as err:
            if self.on_sync_failure not in ("local", "last_good"):
                raise
            self._last_sync_ok = False
            if self.on_sync_failure == "last_good" and self.__dict__.get("_last_good_compute") is not None:
                self.__dict__["_serve_last_good"] = True
                obs.counter_inc("sync.degraded_last_good")
                obs.fault_breadcrumb(
                    "sync_degraded_last_good",
                    domain="sync",
                    data={"metric": type(self).__name__, "error": f"{type(err).__name__}: {err}"},
                )
                rank_zero_warn(
                    f"Sync of {type(self).__name__} failed ({type(err).__name__}: {err});"
                    " serving the last-good value per on_sync_failure='last_good'"
                    " (staleness metadata attached).",
                    TorchMetricsUserWarning,
                )
                return
            obs.counter_inc("sync.degraded_local")
            obs.fault_breadcrumb(
                "sync_degraded_local",
                domain="sync",
                data={"metric": type(self).__name__, "error": f"{type(err).__name__}: {err}"},
            )
            rank_zero_warn(
                f"Sync of {type(self).__name__} failed ({type(err).__name__}: {err});"
                f" degrading to local-only state per on_sync_failure={self.on_sync_failure!r}."
                " Values computed this step cover THIS process's data only.",
                TorchMetricsUserWarning,
            )
            return
        self._state = synced
        self._last_sync_ok = True

    @property
    def last_sync_ok(self) -> bool:
        """False when the most recent sync degraded to local-only state
        (``on_sync_failure="local"`` or ``"last_good"``); True after any
        successful sync."""
        return self._last_sync_ok

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the pre-sync local state."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise TorchMetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise TorchMetricsUserError("The internal cache should exist to unsync the Metric.")
        self._state = self._cache
        self._cache = None
        self._is_synced = False
        self.__dict__["_reduced"] = self.__dict__.pop("_reduced_pre_sync", True)

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
        process_group: Any = None,
    ) -> Generator[None, None, None]:
        """Sync on entry, restore on exit (the unsync runs in a ``finally``,
        so a failing body cannot strand the metric in the synced state)."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            should_sync=should_sync,
            distributed_available=distributed_available,
            process_group=process_group,
        )
        try:
            yield
        finally:
            self.unsync(should_unsync=self._is_synced and should_unsync)

    # ------------------------------------------------------ update observers
    def add_update_observer(self, callback: Callable[["Metric"], None]) -> Callable[[], None]:
        """Register ``callback(metric)`` to fire after every COMMITTED
        top-level ``update``/``forward``: the autosave trigger point
        (``io/checkpoint.py``). A forward's internal updates, whose
        intermediate states hold one batch only, never notify, so an
        observer always sees a consistent accumulated state. Returns a
        zero-argument detach function."""
        observers = self.__dict__.setdefault("_update_observers", [])
        observers.append(callback)

        def detach() -> None:
            current = self.__dict__.get("_update_observers")
            if current is not None and callback in current:
                current.remove(callback)

        return detach

    def attach_integrity(self, every_n_updates: int = 1, on_divergence: str = "raise", snapshots: bool = True) -> Any:
        """Attach a bit-exact state-integrity auditor (``integrity.py``)
        riding the committed-update observer seam: every
        ``every_n_updates``-th commit captures the state's fingerprints (one
        fold on the card, fetched on the read pipeline: the step loop never
        waits), and every read verifies the live bits against them before
        serving. ``on_divergence`` picks the policy (``"raise"``,
        ``"degraded"`` or ``"restore"``: the ``on_shard_loss`` triple);
        ``snapshots=False`` keeps fingerprints only (no host copy, so
        ``"restore"`` escalates to ``"raise"``, and so does ``"degraded"``
        where the computed value shares the state's storage). Returns the attached
        :class:`~torchmetrics_tpu_torch.integrity.IntegrityAuditor`
        (``auditor.detach()`` removes it; also :attr:`integrity`)."""
        from torchmetrics_tpu_torch.integrity import IntegrityAuditor

        existing = self.__dict__.get("_integrity_auditor")
        if existing is not None:
            existing.detach()
        return IntegrityAuditor(
            self, every_n_updates=every_n_updates, on_divergence=on_divergence, snapshots=snapshots
        ).attach()

    @property
    def integrity(self) -> Any:
        """The attached :class:`~torchmetrics_tpu_torch.integrity.IntegrityAuditor`
        (None when :meth:`attach_integrity` was never called)."""
        return self.__dict__.get("_integrity_auditor")

    def add_compute_observer(self, callback: Callable[[int, Any], None]) -> Callable[[], None]:
        """Register ``callback(update_count, value)`` to fire after every
        compute whose sync (if any) succeeded, blocking or resolved on the
        read pipeline's worker: the last-good value a ``"degraded"``
        integrity auditor keeps (``integrity.py``). Returns a zero-argument
        detach function."""
        observers = self.__dict__.setdefault("_compute_observers", [])
        observers.append(callback)

        def detach() -> None:
            current = self.__dict__.get("_compute_observers")
            if current is not None and callback in current:
                current.remove(callback)

        return detach

    def _notify_compute(self, count: int, value: Any) -> None:
        observers = self.__dict__.get("_compute_observers")
        if observers:
            for callback in tuple(observers):
                callback(count, value)

    def _notify_update(self) -> None:
        """Fire update observers, at top level only (not inside forward's
        internal updates)."""
        if self.__dict__.get("_forward_depth", 0):
            return
        observers = self.__dict__.get("_update_observers")
        if observers:
            for callback in tuple(observers):
                callback(self)

    # -------------------------------------------------- captured dispatch
    def _executor_on(self) -> bool:
        """The resolved ``executor=``: the argument, else the environment's
        default for a metric on the card and off on the CPU."""
        enabled = self.__dict__.get("_executor_enabled")
        if enabled is not None:
            return enabled
        from torchmetrics_tpu_torch.ops.executor import executor_enabled_default

        return self._device.type == "cuda" and executor_enabled_default()

    def _get_executor(self) -> Any:
        """The lazily built captured executor, or None when it is off or the
        call comes from inside another metric's call or a collection's whose
        executor is on (a wrapper's children, a collection's members): the
        caller drives them, and their own graphs would not replay."""
        if not self._executor_on() or _called_from_another(self):
            return None
        ex = self.__dict__.get("_executor_obj")
        if ex is None:
            from torchmetrics_tpu_torch.ops.executor import MetricExecutor

            cls = type(self)
            ex = MetricExecutor(
                self,
                plain_functional=(
                    cls.functional_update is Metric.functional_update and cls.functional_compute is Metric.functional_compute
                ),
                plain_forward=cls.functional_forward is Metric.functional_forward and cls.merge_states is Metric.merge_states,
            )
            object.__setattr__(self, "_executor_obj", ex)
        return ex

    def _executor_step_aside(self) -> Optional[str]:
        """Why the executor steps aside for this instance whatever its
        inputs, or None. A replay reruns no Python, so state that lives
        elsewhere or launches chosen by host values step aside."""
        if self.__dict__.get("_class_layouts"):
            return "class-axis-sharded state: its captured dispatch comes with ROADMAP Queue A item 4b"
        reason = self._async_inline_reason()
        if reason is not None:
            return f"{reason}, whose state a replay would not follow"
        return None

    def _executor_identity(self) -> str:
        """What the computation of this instance's keys depends on beyond its
        class, state and public configuration (a wrapper's inner metric),
        joined to its description in the compile cache; empty by default."""
        return ""

    def _executor_inputs(self, args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
        """A call's inputs as the executor keys them (a wrapper turns a
        Python number it would bake into a graph into a device tensor);
        unchanged by default."""
        return args, kwargs

    @property
    def executor_status(self) -> Dict[str, Any]:
        """Whether (and why not) this instance runs through the captured
        executor, in the JAX package's schema: ``enabled`` (the resolved
        ``executor=``), ``engaged`` (a call ran through it),
        ``fallback_reason`` (why it stepped aside), ``stats``
        (:func:`~torchmetrics_tpu_torch.ops.executor.executor_stats`), the
        deferred keys and ``kernels``, the kernel seam's gate log
        (process-wide)."""
        from torchmetrics_tpu_torch.ops.executor import executor_stats
        from torchmetrics_tpu_torch.ops.kernels import gate_snapshot

        enabled = self._executor_on()
        stats = executor_stats(self)
        return {
            "enabled": enabled,
            "engaged": stats["calls"] > 0,
            "fallback_reason": None if enabled is False else stats.get("fallback_reason"),
            "deferred_pending": self.deferred_pending,
            "last_reduce_us": self.__dict__.get("_last_reduce_us"),
            "stats": stats,
            "kernels": gate_snapshot(),
        }

    def warmup(self, batch_specs: Any, forward: bool = False, ladder: bool = True, background: bool = False) -> Any:
        """Build the executor keys this metric's traffic will need, ahead of
        it: one example batch or a sequence of them, tuples of tensors or
        ``"meta"`` tensors (only shapes and dtypes matter; zero dummies run
        and are discarded, the live state is never touched). ``ladder=True``
        also builds one padded representative per bucket rung;
        ``forward=True`` the forward keys too; ``background=True`` runs on a
        daemon thread and returns a ``WarmupHandle``. Returns the report
        ``{"warmed", "already_warm", "skipped", "seconds"}``."""
        ex = self._get_executor()
        if ex is None:
            return {"warmed": 0, "already_warm": 0, "skipped": ["executor disabled"], "seconds": 0.0}
        return ex.warmup(batch_specs, forward=forward, ladder=ladder, background=background)

    def warmup_from_manifest(self, manifest: Any, background: bool = False) -> Any:
        """Build exactly the call shapes a :meth:`shape_profile` manifest
        recorded: the dict, or a path :meth:`save_shape_profile` wrote (the
        JAX package's manifests load too)."""
        ex = self._get_executor()
        if ex is None:
            return {"warmed": 0, "already_warm": 0, "skipped": ["executor disabled"], "seconds": 0.0}
        return ex.warmup_from_manifest(manifest, background=background)

    def shape_profile(self) -> Dict[str, Any]:
        """Replayable manifest of the call shapes this metric's executor has
        served, for :meth:`warmup_from_manifest` in a later process."""
        ex = self._get_executor()
        if ex is None:
            from torchmetrics_tpu_torch.ops.executor import PROFILE_VERSION

            return {"profile_version": PROFILE_VERSION, "owner": type(self).__name__, "specs": []}
        return ex.shape_profile()

    def save_shape_profile(self, path: str) -> str:
        """Atomically write :meth:`shape_profile` as JSON at ``path`` (for
        :meth:`warmup_from_manifest` in a later process)."""
        from torchmetrics_tpu_torch.ops.compile_cache import save_shape_manifest

        return save_shape_manifest(path, self.shape_profile())

    def set_background_compile(self, enabled: Optional[bool]) -> None:
        """Override stall-free background captures for this instance: a cold
        executor key's call is served by the eager update while its capture
        runs on the compile worker, and a later call finds it swapped in.
        ``None`` restores the ``TORCHMETRICS_TPU_BG_COMPILE`` default."""
        ex = self._get_executor()
        if ex is not None:
            ex.set_background_compile(enabled)

    # ----------------------------------------------------- asynchronous reads
    #
    # compute_async() (ops/async_read.py): the blocking tail of a read runs
    # on the read pipeline's worker against a by-reference snapshot of the
    # live state (updates replace tensors, never write into them), after the
    # worker waited on a CUDA event recorded on the caller's stream at
    # submission. The worker computes on a cached detached clone, because a
    # compute on the live object swaps its state and races every update.

    def _read_clone(self) -> "Metric":
        """The detached clone the worker computes on (cached; rebuilt when the
        declared state layout changes). Only its code and declared metadata
        matter: every read installs a fresh state snapshot before running."""
        sig = tuple(
            (k, "list") if isinstance(v, list) else (k, str(v.dtype), tuple(v.shape))
            for k, v in self._defaults.items()
        )
        cached = self.__dict__.get("_read_clone_cache")
        if cached is not None and cached[0] == sig:
            return cached[1]
        clone = copy.deepcopy(self)
        clone.__dict__["_executor_enabled"] = False  # reads never dispatch through an executor
        self.__dict__["_read_clone_cache"] = (sig, clone)
        return clone

    def _async_inline_reason(self) -> Optional[str]:
        """Why this metric's reads must resolve inline (None: fully async).

        A metric holding CHILD metrics (wrappers, compositional metrics)
        keeps state outside ``_state``, so a snapshot-and-clone read would
        serve the children's state as of the clone's creation. Those metrics
        compute on the calling thread; the future still resolves through the
        pipeline."""
        cached = self.__dict__.get("_async_inline_reason_c", "?")
        if cached != "?":
            return cached
        reason = None
        for k, v in self.__dict__.items():
            if k in ("_state", "_defaults", "_read_clone_cache"):
                continue
            if isinstance(v, Metric):
                reason = f"holds child metric under attribute {k!r}"
                break
            if isinstance(v, (list, tuple)) and any(isinstance(el, Metric) for el in v):
                reason = f"holds child metrics under attribute {k!r}"
                break
            if isinstance(v, dict) and any(isinstance(el, Metric) for el in v.values()):
                reason = f"holds child metrics under attribute {k!r}"
                break
        self.__dict__["_async_inline_reason_c"] = reason
        return reason

    def _capture_read_flags(self) -> Dict[str, Any]:
        """Submission-time bookkeeping a read job needs (the committed count,
        the last-good cache, sync intent), captured so caller-side changes
        after submission cannot bleed into an in-flight read."""
        d = self.__dict__
        return {
            "count": int(d.get("_update_count", 0)),
            "last_good": d.get("_last_good_compute"),
            "to_sync": d.get("_to_sync", True),
            "cache": bool(d.get("compute_with_cache", True)),
            "reduced": d.get("_reduced", True),
            "pending_shards": d.get("_pending_shards"),
            # the sync policy as of submission: the cached clone keeps
            # the knobs it was copied with
            "precision": tuple(d.get(k) for k in _PRECISION_KNOBS),
        }

    def compute_async(self) -> Any:
        """Non-blocking :meth:`compute`: returns a
        :class:`~torchmetrics_tpu_torch.ops.async_read.MetricFuture` resolving
        to exactly what a blocking ``compute()`` would return for the state
        as of THIS call (bit for bit, with the same ``on_sync_failure``
        policies, ``DegradedValue`` serving and errors, re-raised by
        ``future.result()``). Updating, resetting or loading the metric
        before the future resolves is safe: the future serves the
        submission-time value."""
        from torchmetrics_tpu_torch.ops import async_read as _async

        owner = type(self).__name__
        with obs.span(obs.SPAN_COMPUTE_ASYNC, suffix=owner):
            body = self._prepare_async_read()
            return _async.get_pipeline().submit(body, owner=owner, submitted_count=int(self._update_count))

    def _prepare_async_read(self) -> Callable[[], Any]:
        """The caller-side half of one asynchronous compute: snapshot what
        must stay consistent, record the submission event, and return the
        worker-side body. Collections compose member bodies into one job
        through this seam."""
        from torchmetrics_tpu_torch.ops.async_read import submission_event

        cached = self._computed
        if cached is not None:
            event = submission_event(cached)
            return lambda: _ready(event, cached)
        reason = self._async_inline_reason()
        if reason is not None:
            obs.counter_inc("reads.inline_compute")
            value = self.compute()  # inline fallback: blocking semantics on the caller
            event = submission_event(value)
            return lambda: _ready(event, value)
        snapshot = self._escaped_snapshot()  # by reference: no later update writes these
        flags = self._capture_read_flags()
        clone = self._read_clone()
        event = submission_event(snapshot)
        job: Callable[[], Any] = lambda: self._async_compute_job(clone, snapshot, flags)  # noqa: E731
        auditor = self.__dict__.get("_integrity_auditor")
        if auditor is not None:
            # verify the submission-time snapshot ON THE WORKER before the
            # read resolves (integrity.py): the future carries the outcome a
            # blocking read would have, and the caller never waits
            job = auditor.wrap_async_read(job, snapshot, flags)

        def body() -> Any:
            _ready(event, None)
            return job()

        return body

    def _install_read_snapshot(self, clone: "Metric", snapshot: Dict[str, Any], flags: Dict[str, Any]) -> None:
        """WORKER-SIDE: stage a submission-time snapshot into the read clone
        so its ``compute`` replays blocking semantics against it (one worker
        thread: the clone is used serially)."""
        object.__setattr__(clone, "_state", dict(snapshot))
        d = clone.__dict__
        d["_update_count"] = flags["count"]
        d["_computed"] = None
        d["_is_synced"] = False
        d["_cache"] = None
        d["_last_sync_ok"] = True
        d["_last_good_compute"] = flags["last_good"]
        d.pop("_serve_last_good", None)
        d["_to_sync"] = flags["to_sync"]
        d["_should_unsync"] = True
        d["_reduced"] = flags.get("reduced", True)
        d["_pending_shards"] = flags.get("pending_shards")
        for knob, value in zip(_PRECISION_KNOBS, flags.get("precision", ())):
            d[knob] = value

    def _async_compute_job(self, clone: "Metric", snapshot: Dict[str, Any], flags: Dict[str, Any]) -> Any:
        """WORKER-SIDE: the read body (sync per policy, compute, wait for
        the worker's stream), then the guarded cache write-back. The clone
        drops the snapshot afterwards, so no tensor outlives its read."""
        from torchmetrics_tpu_torch.ops.async_read import materialize

        self._install_read_snapshot(clone, snapshot, flags)
        try:
            value = materialize(clone.compute())
        finally:
            object.__setattr__(clone, "_state", {})
            clone.__dict__["_computed"] = None
        self._writeback_read_result(clone, flags, value)
        return value

    def _writeback_read_result(self, clone: "Metric", flags: Dict[str, Any], value: Any) -> None:
        """WORKER-SIDE cache coherence: a resolved read refreshes the live
        compute cache and last-good/sync bookkeeping ONLY while the live
        metric still sits at the submission-time count. An update bumps the
        count before it clears the cache, and the count is checked again
        after the write, so a concurrent update always wins."""
        if self.__dict__.get("_update_count") != flags["count"]:
            return
        self.__dict__["_last_sync_ok"] = clone.__dict__.get("_last_sync_ok", True)
        last_good = clone.__dict__.get("_last_good_compute")
        if last_good is not None:
            self.__dict__["_last_good_compute"] = last_good
        if clone.__dict__.get("_last_sync_ok", True) and not isinstance(value, DegradedValue):
            # the clone keeps no observers: the live metric's see the value
            self._notify_compute(flags["count"], value)
        if flags["cache"] and not isinstance(value, DegradedValue) and self.__dict__.get("_computed") is None:
            self.__dict__["_computed"] = value
            if self.__dict__.get("_update_count") != flags["count"]:
                self.__dict__["_computed"] = None  # an update landed mid-write: drop the stale cache

    def sync_async(self, process_group: Any = None) -> Any:
        """Non-blocking read-side :meth:`sync`: a
        :class:`~torchmetrics_tpu_torch.ops.async_read.MetricFuture` resolving
        to the SYNCED state dict (what :meth:`state` exports after a blocking
        ``sync()``) for the state as of this call. The live metric is never
        touched: the worker syncs a detached clone holding a by-reference
        snapshot, under ``sync_timeout`` and ``on_sync_failure``; failures
        surface through ``future.result()``. Every rank must call it in the
        same order as its other collectives."""
        from torchmetrics_tpu_torch.ops import async_read as _async

        owner = type(self).__name__
        with obs.span(obs.SPAN_COMPUTE_ASYNC, suffix=owner, kind="sync"):
            body = self._prepare_async_sync(process_group)
            return _async.get_pipeline().submit(body, owner=owner, submitted_count=int(self._update_count))

    def _prepare_async_sync(self, process_group: Any = None) -> Callable[[], Any]:
        """Caller-side half of one asynchronous sync (see :meth:`_prepare_async_read`)."""
        from torchmetrics_tpu_torch.ops.async_read import materialize, submission_event

        self._fold_pending()
        reason = self._async_inline_reason()
        if reason is not None:
            obs.counter_inc("reads.inline_compute")
            with self.sync_context(should_sync=True, should_unsync=True, process_group=process_group):
                out = self.state()  # inline fallback: blocking semantics on the caller
            event = submission_event(out)
            return lambda: _ready(event, materialize(out))
        snapshot = self._escaped_snapshot()
        flags = self._capture_read_flags()
        clone = self._read_clone()
        event = submission_event(snapshot)

        def body() -> Any:
            _ready(event, None)
            return self._async_sync_job(clone, snapshot, flags, process_group)

        return body

    def _async_sync_job(self, clone: "Metric", snapshot: Dict[str, Any], flags: Dict[str, Any], process_group: Any) -> Dict[str, Any]:
        """WORKER-SIDE: the bounded sync on the snapshot through the clone,
        then the materialised state export."""
        from torchmetrics_tpu_torch.ops.async_read import materialize

        self._install_read_snapshot(clone, snapshot, flags)
        try:
            clone.sync(should_sync=True, process_group=process_group)
            out = materialize(clone.state())
        finally:
            object.__setattr__(clone, "_state", {})
            clone.__dict__["_cache"] = None
            clone.__dict__["_is_synced"] = False
        if self.__dict__.get("_update_count") == flags["count"]:
            self.__dict__["_last_sync_ok"] = clone.__dict__.get("_last_sync_ok", True)
        return out

    # ------------------------------------------------------- pure / functional
    #: reserved state key carrying the update count through state()/load_state
    _STATE_COUNT_KEY = "_update_count"

    #: reserved state key marking a sharded export (value = shard count),
    #: set by state() while a sharded restore awaits its fold
    _STATE_SHARDS_KEY = "_sharded_shards"

    #: export keys that are no state field (a collection's layout match skips
    #: them): the count, the shard mark and a windowed metric's ring meta
    _RESERVED_STATE_KEYS: Tuple[str, ...] = (_STATE_COUNT_KEY, "_sharded_shards", "_window_meta")

    #: reductions under which a state's shape is invariant across updates and
    #: merges — the only fields whose shape `validate="strict"` can check
    _SHAPE_INVARIANT_REDUCTIONS = ("sum", "mean", "max", "min")

    def _copy_state_dict(self) -> Dict[str, Any]:
        """The live declared states as a fresh dict (tensors by reference,
        none of them the executor's slots), without the count key."""
        return self._escaped_snapshot()

    @staticmethod
    def _restored_count(update_count: Optional[int], fallback: int = 1) -> int:
        """The restore policy for ``load_state``'s update count: the explicit
        value when given, else ``fallback`` (default exactly 1: a restored
        state counts as updated). Wrappers whose exported state carries its
        own count (MinMax, Running) pass that count as ``fallback``."""
        return int(update_count) if update_count is not None else int(fallback)

    def state(self) -> Dict[str, Any]:
        """The live state as a dict, with the update count under the reserved
        key ``"_update_count"`` so :meth:`load_state` round-trips it."""
        out = self._escaped_snapshot()
        out[self._STATE_COUNT_KEY] = int(self._update_count)
        shards = self.__dict__.get("_pending_shards")
        if shards is not None:
            out[self._STATE_SHARDS_KEY] = int(shards)
        return out

    def state_spec(self) -> Dict[str, Any]:
        """Declared layout of the state (JSON-serialisable; dtype names as in
        the JAX package, e.g. ``"int32"``)::

            {"spec_version": 1, "class": <type name>, "count_key": "_update_count",
             "fields": {name: {"kind": "array"|"list", "shape": tuple|None,
                               "dtype": str|None, "reduction": str|None,
                               "shape_invariant": bool}}}

        A class-sharded field also carries ``"state_sharding": "class_axis"``,
        ``"num_classes"`` and ``"class_shards"`` (its shape is the stacked
        one); a replicated field's spec has no such keys.
        """
        fields: Dict[str, Any] = {}
        for name, default in self._defaults.items():
            fx = self._reductions.get(name)
            reduction = fx if isinstance(fx, str) else ("custom" if callable(fx) else None)
            if isinstance(default, list):
                fields[name] = {
                    "kind": "list", "shape": None, "dtype": None,
                    "reduction": reduction, "shape_invariant": False,
                }
            else:
                fields[name] = {
                    "kind": "array",
                    "shape": tuple(int(d) for d in default.shape),
                    "dtype": _dtype_name(default.dtype),
                    "reduction": reduction,
                    "shape_invariant": fx in self._SHAPE_INVARIANT_REDUCTIONS,
                }
                layout = self._class_layout(name)
                if layout is not None:
                    fields[name]["state_sharding"] = "class_axis"
                    fields[name]["num_classes"] = int(layout.num_classes)
                    fields[name]["class_shards"] = int(layout.num_shards)
        return {
            "spec_version": 1,
            "class": type(self).__name__,
            "count_key": self._STATE_COUNT_KEY,
            "fields": fields,
        }

    def validate_state(
        self, state: Dict[str, Any], mode: str = "strict", check_finite: bool = False, sharded: bool = False
    ) -> Dict[str, Any]:
        """Check a state dict against :meth:`state_spec` and return it.

        - ``"strict"``: every declared field present as a tensor of the
          declared dtype on the metric's device, with the declared shape for
          shape-invariant fields;
        - ``"cast"``: like strict, but converts arrays, dtypes and devices
          instead of raising (shape and structure problems still raise);
        - ``"off"``: no checks.

        ``check_finite=True`` also rejects NaN/Inf in float fields.
        ``sharded=True`` checks the stacked layout instead: every tensor
        field carries a leading shard axis, the same count in all of them,
        and no list state may appear. Raises :class:`StateCorruptionError`.
        """
        if mode not in ("strict", "cast", "off"):
            raise ValueError(f"validate must be 'strict', 'cast' or 'off', got {mode!r}")
        if not isinstance(state, dict):
            raise StateCorruptionError(f"{type(self).__name__}: state must be a dict, got {type(state).__name__}")
        owner = type(self).__name__
        out: Dict[str, Any] = dict(state)
        shard_counts: Dict[str, int] = {}
        for name, fs in self.state_spec()["fields"].items():
            if name not in state:
                raise StateCorruptionError(f"{owner}: state is missing declared field {name!r}")
            values = state[name]
            is_list = isinstance(values, (list, tuple))
            if sharded:
                if fs["kind"] == "list" or is_list:
                    raise StateCorruptionError(f"{owner}: field {name!r} is a list state; list states cannot carry a shard axis")
                if not isinstance(values, torch.Tensor) or values.ndim < 1:
                    raise StateCorruptionError(f"{owner}: sharded field {name!r} carries no shard axis")
                shard_counts[name] = int(values.shape[0])
                if mode != "off":
                    fs = dict(fs, shape=(int(values.shape[0]),) + tuple(fs["shape"]))
            if (fs["kind"] == "list") != is_list and mode != "off":
                raise StateCorruptionError(
                    f"{owner}: field {name!r} is a{' list' if fs['kind'] == 'list' else 'n array'} state"
                    f" but the restored value is a {type(values).__name__}"
                )
            checked = []
            for value in values if is_list else [values]:
                if mode != "off":
                    value = self._validate_field(name, value, fs, mode)
                if check_finite and isinstance(value, torch.Tensor) and value.is_floating_point():
                    if not bool(torch.isfinite(value).all()):
                        raise StateCorruptionError(
                            f"{owner}: field {name!r} contains non-finite values"
                            " (check_finite=True rejects NaN/Inf accumulators)"
                        )
                checked.append(value)
            out[name] = checked if is_list else checked[0]
        if sharded and len(set(shard_counts.values())) > 1:
            raise StateCorruptionError(f"{owner}: sharded fields disagree on the shard count: {shard_counts}")
        return out

    def _validate_field(self, name: str, value: Any, fs: Dict[str, Any], mode: str) -> torch.Tensor:
        owner = type(self).__name__
        if not isinstance(value, torch.Tensor):
            if mode == "strict":
                raise StateCorruptionError(
                    f"{owner}: field {name!r} is a {type(value).__name__}, not a tensor"
                    " (use validate='cast' to convert)"
                )
            value = torch.tensor(np.asarray(value))
        if fs["shape_invariant"] and tuple(value.shape) != fs["shape"]:
            raise StateCorruptionError(
                f"{owner}: field {name!r} has shape {tuple(value.shape)} but this"
                f" metric's state layout requires {fs['shape']}"
            )
        want_dtype = value.dtype if fs["dtype"] is None else getattr(torch, fs["dtype"])
        if value.dtype != want_dtype or value.device != self._device:
            if mode == "strict":
                raise StateCorruptionError(
                    f"{owner}: field {name!r} is {_dtype_name(value.dtype)} on {value.device} but this"
                    f" metric's state is {_dtype_name(want_dtype)} on {self._device}"
                    " (use validate='cast' to convert)"
                )
            value = value.to(device=self._device, dtype=want_dtype)
        return value

    def load_state(
        self,
        state: Dict[str, Any],
        update_count: Optional[int] = None,
        validate: str = "strict",
        check_finite: bool = False,
        sharded: Optional[bool] = None,
    ) -> None:
        """Install a state dict as the live state (inverse of :meth:`state`).

        ``update_count`` restores the number of updates the state represents;
        when omitted, the count the state carries under ``"_update_count"`` is
        used, else exactly 1. ``validate``/``check_finite`` as in
        :meth:`validate_state`; on any failure the live state is untouched.

        ``sharded=True`` installs a stacked state (a leading shard axis on
        every field, the deferred layout); it is kept as is and folded per
        the declared reductions on demand, at the next update, compute or
        sync. ``None`` (default) detects it from the ``"_sharded_shards"``
        key a sharded :meth:`state` export carries. A class-axis field
        re-splits a dense or differently sharded value into this metric's
        class layout first.
        """
        if sharded is None:
            sharded = isinstance(state, dict) and state.get(self._STATE_SHARDS_KEY) is not None
        if not sharded:
            state = self._adopt_class_layouts(state)
        state = self.validate_state(state, mode=validate, check_finite=check_finite, sharded=bool(sharded))
        carried = state.get(self._STATE_COUNT_KEY)
        if update_count is None and carried is not None:
            update_count = int(carried)
        staged: Dict[str, Any] = {}
        for k in self._defaults:
            if k not in state:
                raise StateCorruptionError(f"state missing field {k!r}")
            v = state[k]
            staged[k] = list(v) if isinstance(v, (list, tuple)) else v
        num_shards = None
        if sharded:
            num_shards = next((int(v.shape[0]) for v in staged.values() if isinstance(v, torch.Tensor) and v.ndim >= 1), None)
            if num_shards is None:
                raise StateCorruptionError(f"{type(self).__name__}: sharded=True but no array field carries a shard axis")
        self._state.update(staged)
        self.__dict__["_state_escaped"] = True  # the caller holds what was installed
        self._computed = None
        self._update_count = int(update_count) if update_count is not None else 1
        self.__dict__["_pending_shards"] = num_shards
        if sharded:
            self.__dict__["_reduced"] = False

    def init_state(self) -> Dict[str, Any]:
        """A fresh default state (the pure analogue of ``reset``)."""
        return {k: ([] if isinstance(v, list) else v.clone()) for k, v in self._defaults.items()}

    def functional_init(self) -> Dict[str, Any]:
        """Alias of :meth:`init_state`, the name shared with ``MetricCollection``."""
        return self.init_state()

    # ------------------------------------------------- sharded (deferred) API
    def init_sharded_state(self, num_shards: int) -> Dict[str, Any]:
        """A fresh state in the deferred layout: every field gains a leading
        shard axis of ``num_shards``. Step shard ``s`` with
        ``functional_update({k: v[s] ...}, *batch)`` and reduce with
        :meth:`reduce_sharded_state`."""
        if any(isinstance(v, list) for v in self._defaults.values()):
            raise TorchMetricsUserError(
                f"{type(self).__name__} holds list states, which cannot carry a shard axis;"
                " deferred sharded accumulation needs fixed-shape states"
            )
        return init_sharded_states(self.init_state(), num_shards)

    def sharded_state_spec(self, axis_name: Optional[str] = None) -> Dict[str, Any]:
        """Per field, the axis of the deferred layout the shard axis occupies:
        always 0 (the leading axis). The JAX package returns a
        ``PartitionSpec`` tree for ``shard_map``; the port has no mesh, and
        this keeps the name and the tree shape (``axis_name`` is accepted
        for the same signature and ignored)."""
        return {k: 0 for k in self._defaults}

    def reduce_sharded_state(self, state: Dict[str, Any], process_group: Any = None) -> Dict[str, Any]:
        """The deferred read point for this metric: fold the local shard axis
        of every field per its declared reduction, then, in an initialised
        process group, sync across the ranks (one rank standing for one
        mesh device of the JAX package) through :meth:`functional_sync`:
        ``dist_sync_fn``, the quantized policy and the reserved count key
        apply as there."""
        fields = {k: v for k, v in state.items() if k not in self._RESERVED_STATE_KEYS}
        folded = fold_sharded_states(fields, self._reductions)
        if not self.distributed_available_fn():
            return folded
        return self.functional_sync(folded, process_group)

    def reshard_state(self, state: Dict[str, Any], to_num_shards: int) -> Dict[str, Any]:
        """Re-split this metric's stacked sharded state onto ``to_num_shards``
        shards through ``parallel/reshard.py``: exact for sum/mean/max/min;
        ``cat``/``None``/callable fields raise ``TopologyMismatchError``."""
        from torchmetrics_tpu_torch.parallel.reshard import ShardLayout, layout_of, reshard_states

        return reshard_states(state, layout_of(state), ShardLayout(int(to_num_shards)), self._reductions)

    def _with_state(self, state: Dict[str, Any], fn: Callable[[], Any]) -> Any:
        """Run ``fn`` with ``state`` swapped in as the live state."""
        saved = self._state
        try:
            object.__setattr__(
                self,
                "_state",
                {k: (list(v) if isinstance(v, list) else v) for k, v in state.items() if k != self._STATE_COUNT_KEY},
            )
            return fn()
        finally:
            object.__setattr__(self, "_state", saved)

    def functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update: ``(state, batch) -> state'``; the live state is untouched."""
        _check_same_device(self._device, args, kwargs, type(self).__name__)

        def run() -> Dict[str, Any]:
            self._update_fn(*args, **kwargs)
            return self._state_snapshot()

        return self._with_state(state, run)

    def functional_compute(self, state: Dict[str, Any]) -> Any:
        """Pure compute: ``state -> value``."""
        return self._with_state(state, lambda: _squeeze_if_scalar(self._compute_fn()))

    #: how a laned read computes every lane's value at once (``lanes.py``):
    #: ``"vmap"`` runs :meth:`functional_compute` under ``torch.func.vmap``
    #: over the stacked states (a compute of plain tensor operations, with no
    #: host read or data-dependent branch); ``"loop"`` computes lane by lane
    lane_compute: str = "loop"

    def functional_update_rows(self, states: Dict[str, Any], *args: Any) -> Dict[str, Any]:
        """Row-batched pure update: every state leaf and every argument carry
        a leading row axis R, and row r of the result is
        ``functional_update(row r of states, *row r of args)``. The session
        lanes (``lanes.py``) advance a round of sessions through it, where the
        JAX package runs ``jax.vmap(functional_update)``.

        This default is an exact per-row loop (its kernel launches are
        counted as the rows' own). The counting family (stat scores and the
        confusion matrices) overrides it with one row-folded ``bincount``
        launch per row chunk.
        """
        rows = int(args[0].shape[0]) if args else int(next(iter(states.values())).shape[0])
        obs.counter_inc("lanes.rows_looped", rows)
        out = [
            self.functional_update({k: v[r] for k, v in states.items()}, *(a[r] for a in args))
            for r in range(rows)
        ]
        return {k: torch.stack([o[k] for o in out]) for k in states}

    def _own_update_is(self, cls: type) -> bool:
        """Whether this instance updates with ``cls``'s own ``update`` (no
        subclass override, no fault-harness body): the condition for a
        row-batched override on ``cls`` to stand for the per-row loop."""
        if "_update_fn" in self.__dict__:
            return False
        return next(k for k in type(self).__mro__ if "update" in k.__dict__) is cls

    def laned(self, capacity: int = 8, max_capacity: Optional[int] = None, **kwargs: Any) -> Any:
        """A :class:`~torchmetrics_tpu_torch.lanes.LanedMetric` stacking N
        independent copies of this metric's state along a lane axis, one
        round advancing every active session (``lanes.py``). The wrapper
        holds a detached clone; this instance is untouched."""
        from torchmetrics_tpu_torch.lanes import LanedMetric

        return LanedMetric(self, capacity=capacity, max_capacity=max_capacity, **kwargs)

    def windowed(self, window: int = 8, lateness: int = 0, **kwargs: Any) -> Any:
        """A :class:`~torchmetrics_tpu_torch.windows.WindowedMetric` stacking
        W per-window copies of this metric's state along a ring axis:
        tumbling and sliding windows with watermark-bounded late events
        (``windows.py``). The wrapper holds a detached clone; this instance
        is untouched. Compose with lanes as ``metric.windowed(W).laned(capacity)``:
        the window axis under the lane axis."""
        from torchmetrics_tpu_torch.windows import WindowedMetric

        return WindowedMetric(self, window=window, lateness=lateness, **kwargs)

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast the floating-point states and their defaults to ``dst_type``;
        integer and bool states keep theirs (the reference library's API).
        The cast tensors are new ones: nothing is written in place."""

        def cast(v: Any) -> Any:
            return v.to(dst_type) if isinstance(v, torch.Tensor) and v.is_floating_point() else v

        for k, v in self._state.items():
            self._state[k] = [cast(el) for el in v] if isinstance(v, list) else cast(v)
        self.__dict__["_state_escaped"] = True
        self._defaults = {k: ([cast(el) for el in v] if isinstance(v, list) else cast(v)) for k, v in self._defaults.items()}
        return self

    def functional_forward(
        self, state: Dict[str, Any], *args: Any, update_count: Optional[int] = None, **kwargs: Any
    ) -> tuple:
        """Pure forward: ``(state, batch) -> (state', batch_value)``.

        For ``"mean"``-reduced states pass ``update_count`` (updates already
        merged into ``state``) so the running mean is count-weighted.
        """
        batch_state = self.functional_update(self.functional_init(), *args, **kwargs)
        batch_value = self.functional_compute(batch_state)
        counts = (update_count, 1) if update_count is not None else None
        return self.merge_states(state, batch_state, counts=counts), batch_value

    def functional_sync(self, state: Dict[str, Any], process_group: Any = None) -> Dict[str, Any]:
        """Pure sync: ``state -> state`` reduced across ``process_group``
        (default the metric's; None is the world), honouring ``dist_sync_fn``.

        The reserved ``"_update_count"`` key a :meth:`state` export carries is
        not a declared state: it is stripped before the collectives and
        re-attached summed across ranks (an int64 tensor riding in the
        int64 ``sum`` group), the number of updates merged world-wide.
        """
        group = process_group if process_group is not None else self.process_group
        state = dict(state)
        count = state.pop(self._STATE_COUNT_KEY, None)
        reductions = dict(self._reductions)
        if count is not None:
            state[self._STATE_COUNT_KEY] = torch.as_tensor(count, dtype=torch.int64, device=self._device)
            reductions[self._STATE_COUNT_KEY] = "sum"
        if self.dist_sync_fn is not None:
            return {k: self.dist_sync_fn(v, reductions.get(k), group) for k, v in state.items()}
        return self._sync_states(state, reductions, group)

    def _sync_states(self, state: Dict[str, Any], reductions: Dict[str, Reduction], group: Any) -> Dict[str, Any]:
        """The built-in collectives of :meth:`sync` and :meth:`functional_sync`
        (``parallel/sync.py``); a metric whose list states must keep their
        entries apart overrides it."""
        return sync_states(
            state, reductions, group, timeout=self.sync_timeout, device=self._device, qspecs=self._sync_qspecs()
        )

    def merge_states(
        self, a: Dict[str, Any], b: Dict[str, Any], counts: Optional[Tuple[int, int]] = None
    ) -> Dict[str, Any]:
        """Merge two states per declared reductions; ``counts`` weighs "mean"
        states by the number of updates each side accumulated."""
        na, nb = counts if counts is not None else (1, 1)
        out: Dict[str, Any] = {}
        for attr in self._defaults:
            fx = self._reductions[attr]
            va, vb = a[attr], b[attr]
            if fx == "sum":
                out[attr] = va + vb
            elif fx == "mean":
                out[attr] = (na * va + nb * vb) / (na + nb)
            elif fx == "max":
                out[attr] = torch.maximum(va, vb)
            elif fx == "min":
                out[attr] = torch.minimum(va, vb)
            elif fx == "cat":
                if isinstance(va, list) or isinstance(vb, list):
                    out[attr] = list(va) + list(vb)
                else:
                    out[attr] = torch.cat([torch.atleast_1d(va), torch.atleast_1d(vb)])
            elif fx is None and isinstance(va, list):
                out[attr] = list(va) + list(vb)
            elif callable(fx):
                out[attr] = fx(torch.stack([va, vb]))
            else:
                out[attr] = torch.stack([torch.atleast_1d(va), torch.atleast_1d(vb)])
        return out

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Restore default states."""
        self._update_count = 0
        self._computed = None
        self._state.update(self.init_state())
        self.__dict__["_state_escaped"] = True
        self._cache = None
        self._is_synced = False
        self.__dict__["_reduced"] = True
        self.__dict__["_pending_shards"] = None

    def clone(self) -> "Metric":
        """Deep copy of the metric."""
        return copy.deepcopy(self)

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move states and defaults to ``device`` (an explicit, caller-asked copy)."""
        self._device = resolve_device(device)

        def move(v: Any) -> Any:
            return [el.to(self._device) for el in v] if isinstance(v, list) else v.to(self._device)

        self._state.update({k: move(v) for k, v in self._state.items()})
        self._defaults = {k: move(v) for k, v in self._defaults.items()}
        self.__dict__["_state_escaped"] = True
        self.__dict__["_executor_obj"] = None  # its slots and graphs live on the old device
        return self

    # -------------------------------------------------------------- utilities
    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Filter kwargs to those accepted by this metric's update."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        filtered_kwargs = {
            k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)
        }
        if any(v.kind == inspect.Parameter.VAR_KEYWORD for v in _sign_params.values()):
            filtered_kwargs = kwargs
        return filtered_kwargs

    def __hash__(self) -> int:
        # identity: ``__eq__`` builds a CompositionalMetric, and hashing the
        # state would wait for the device
        return object.__hash__(self)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    # ----------------------------------------------------------- pickling
    #: per-instance attributes a copy or pickle never carries: observers
    #: (autosavers, fault hooks), the fault harness's seams, the async-read
    #: caches and the integrity auditor
    _TRANSIENT_KEYS = (
        "_update_observers", "_compute_observers", "_update_fn", "_compute_fn", "_read_clone_cache",
        "_async_inline_reason_c",
        "_integrity_auditor",  # holds a lock and a reference to the live metric
        "_slot_ids", "_exec_active",  # the executor's bookkeeping, process-local
    )

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state.pop("_update_signature", None)  # re-created in __setstate__
        for key in self._TRANSIENT_KEYS:
            state.pop(key, None)
        # captured graphs and their slots are process-local: a copy or an
        # unpickled metric builds its own executor
        state["_executor_obj"] = None
        state["_state_escaped"] = True
        state["_state_shared"] = False
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        for key, default in (("_executor_obj", None), ("_executor_enabled", None), ("_state_escaped", True), ("_state_shared", False)):
            self.__dict__.setdefault(key, default)
        self._update_signature = inspect.signature(self.update)

    def __deepcopy__(self, memo: Optional[dict] = None) -> "Metric":
        cls = self.__class__
        new_obj = cls.__new__(cls)
        memo = {} if memo is None else memo
        memo[id(self)] = new_obj
        if self.__dict__.get("process_group") is not None:
            memo[id(self.process_group)] = self.process_group  # a group is shared, never copied
        new_obj.__setstate__(copy.deepcopy(self.__getstate__(), memo))
        return new_obj

    # ------------------------------------------------------------- plotting
    def plot(self, *args: Any, **kwargs: Any) -> Any:
        """Plot a value (by default ``compute()``): a point, a point per
        class, or a line over a list of values (``utils/plot.py``); needs
        matplotlib. ``ax`` draws into an existing axes."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = args[0] if args else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=kwargs.get("ax"),
            higher_is_better=self.higher_is_better,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
            name=type(self).__name__,
        )

    def _plot(self, val: Any = None, ax: Any = None) -> Any:
        """The plain value plot, for overrides that choose what to plot."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=ax,
            higher_is_better=self.higher_is_better,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            name=type(self).__name__,
        )

    # --------------------------------------------------- composition algebra
    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.logical_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)

    def __iter__(self):
        raise NotImplementedError("Metrics does not support iteration.")


def _neg(x: torch.Tensor) -> torch.Tensor:
    return -torch.abs(x)


def _wrap_methods(cls: type) -> None:
    """Wrap the ``update`` and ``compute`` that ``cls`` itself defines."""
    for name, body in (("update", _transactional_update), ("compute", _cached_compute)):
        func = cls.__dict__.get(name)
        if inspect.isfunction(func):
            setattr(cls, name, _BoundPerAccess(func, body))


_wrap_methods(Metric)


class CompositionalMetric(Metric):
    """Composition of two metrics (or a metric and a scalar) by an elementwise op.

    Fans update/forward/reset out to the child metrics and applies
    ``op`` to their compute results; it lives on its first metric operand's
    device and its own sync is a no-op (children sync themselves).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy, BinaryPrecision
        >>> combo = BinaryAccuracy(device="cpu") + BinaryPrecision(device="cpu")
        >>> combo.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> round(float(combo.compute()), 4)
        1.0
    """

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, torch.Tensor, None],
        metric_b: Union[Metric, float, int, torch.Tensor, None],
    ) -> None:
        owner = metric_a if isinstance(metric_a, Metric) else metric_b
        super().__init__(device=owner.device)
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)

    def _operand(self, value: Any) -> Any:
        if isinstance(value, (int, float, np.ndarray)) and not isinstance(value, bool):
            return _as_state_tensor(value, self._device)
        return value

    def sync(self, *args: Any, **kwargs: Any) -> None:
        pass

    def unsync(self, *args: Any, **kwargs: Any) -> None:
        pass

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            return None
        if val_b is None:
            if isinstance(self.metric_b, Metric):
                return None
            return self.op(val_a)
        return self.op(val_a, val_b)

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def __repr__(self) -> str:
        _op_metrics = f"(\n  {self.op.__name__ if hasattr(self.op, '__name__') else 'op'}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"
        return self.__class__.__name__ + _op_metrics
