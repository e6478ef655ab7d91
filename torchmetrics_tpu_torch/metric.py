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
tensors; the states of this slice are at most a 1000 x 1000 count matrix, so
an in-place add would save one small allocation per update.

Cross-process sync is not ported yet: :meth:`sync` is a no-op when
``torch.distributed`` is not initialised and raises ``NotImplementedError``
when it is.
"""
from __future__ import annotations

import copy
import functools
import inspect
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_device
from torchmetrics_tpu_torch.utils.data import _flatten, _squeeze_if_scalar
from torchmetrics_tpu_torch.utils.exceptions import StateCorruptionError, TorchMetricsUserError
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
        self._device = resolve_device(kwargs.pop("device", None))

        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(f"Expected keyword argument `dist_sync_on_step` to be an `bool` but got {self.dist_sync_on_step}")
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or distributed_available
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}")
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if not isinstance(self.compute_with_cache, bool):
            raise ValueError(f"Expected keyword argument `compute_with_cache` to be a `bool` but got {self.compute_with_cache}")
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._update_signature = inspect.signature(self.update)
        self._update_fn: Callable = self.update  # raw bound method (pre-wrap)
        self._compute_fn: Callable = self.compute
        self.update: Callable = self._wrap_update(self.update)
        self.compute: Callable = self._wrap_compute(self.compute)
        self._computed: Any = None
        self._update_count: int = 0
        self._to_sync = self.sync_on_compute
        self._should_unsync = True
        self._is_synced = False

    # ------------------------------------------------------------------ states
    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, List],
        dist_reduce_fx: Reduction = None,
    ) -> None:
        """Register a metric state.

        ``default`` is either a tensor (fixed-shape accumulator, placed on the
        metric's device) or an empty list (growing accumulator).
        ``dist_reduce_fx`` in {"sum","mean","max","min","cat", None, callable}
        declares how the state merges across batches (``forward``) and
        processes.
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
        if not isinstance(default, list):
            default = _as_state_tensor(default, self._device)
        self._defaults[name] = default
        self._reductions[name] = dist_reduce_fx
        self._state[name] = [] if isinstance(default, list) else default.clone()

    def __getattr__(self, name: str) -> Any:
        # only called when normal lookup fails
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            return state[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("higher_is_better", "is_differentiable", "full_state_update", "plot_lower_bound", "plot_upper_bound", "plot_legend_name"):
            raise RuntimeError(f"Can't change const `{name}`.")
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            state[name] = value
            return
        object.__setattr__(self, name, value)

    @property
    def metric_state(self) -> Dict[str, Any]:
        """Current (live) state values."""
        return {attr: self._state[attr] for attr in self._defaults}

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

    def _rollback(self, state: Dict[str, Any], update_count: int, computed: Any) -> None:
        """Reinstall a pre-call snapshot after a failed update/forward."""
        object.__setattr__(self, "_state", state)
        self.__dict__["_update_count"] = update_count
        self.__dict__["_computed"] = computed

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            # transactional contract: any exception out of this call leaves
            # (_state, _update_count, _computed) exactly as they were before it
            _check_same_device(self._device, args, kwargs, type(self).__name__)
            pre_count, pre_computed = self._update_count, self._computed
            self._update_count += 1
            self._computed = None
            snapshot = self._state_snapshot()
            try:
                self._update_fn(*args, **kwargs)
            except TypeError as err:
                self._rollback(snapshot, pre_count, pre_computed)
                if "got an unexpected keyword argument" in str(err) or "positional argument" in str(err):
                    raise TypeError(
                        f"Encountered an error while calling `update` of {type(self).__name__}: {err}"
                    ) from err
                raise
            except BaseException:
                self._rollback(snapshot, pre_count, pre_computed)
                raise

        return wrapped_func

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {type(self).__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            with self.sync_context(should_sync=self._to_sync, should_unsync=self._should_unsync):
                value = _squeeze_if_scalar(self._compute_fn(*args, **kwargs))
            if self.compute_with_cache:
                self._computed = value
            return value

        return wrapped_func

    def update(self, *_: Any, **__: Any) -> None:  # overridden by subclass; rebound in __init__
        raise NotImplementedError

    def compute(self) -> Any:  # overridden by subclass; rebound in __init__
        raise NotImplementedError

    # ----------------------------------------------------------- forward paths
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate into global state AND return the batch value."""
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """2x update strategy, transactional: any exception restores the
        pre-call accumulated state."""
        pre_state = self._state_snapshot()
        pre_count, pre_computed = self._update_count, self._computed
        try:
            self.update(*args, **kwargs)
            _update_count = self._update_count
            self._to_sync = self.dist_sync_on_step
            cache = self._state_snapshot()
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
        global_state = self._state_snapshot()
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
    def sync(self, should_sync: bool = True, distributed_available: Optional[Callable] = None) -> None:
        """All-reduce states across processes per declared reductions.

        Not ported yet: a no-op in a single process (no initialised
        ``torch.distributed`` group), ``NotImplementedError`` otherwise.
        """
        if self._is_synced and should_sync:
            raise TorchMetricsUserError("The Metric has already been synced.")
        distributed_available = distributed_available or self.distributed_available_fn
        if not should_sync or not distributed_available():
            return
        raise NotImplementedError(
            f"{type(self).__name__}: cross-process state sync over torch.distributed is not"
            " ported yet; build the metric with sync_on_compute=False to compute per process"
        )

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore pre-sync local state (nothing to restore while sync is a no-op)."""
        if should_unsync and not self._is_synced:
            raise TorchMetricsUserError("The Metric has already been un-synced.")

    @contextmanager
    def sync_context(self, should_sync: bool = True, should_unsync: bool = True) -> Generator[None, None, None]:
        """Sync on entry, restore on exit (the unsync runs in a ``finally``)."""
        self.sync(should_sync=should_sync)
        try:
            yield
        finally:
            self.unsync(should_unsync=self._is_synced and should_unsync)

    # ------------------------------------------------------- pure / functional
    #: reserved state key carrying the update count through state()/load_state
    _STATE_COUNT_KEY = "_update_count"

    #: reductions under which a state's shape is invariant across updates and
    #: merges — the only fields whose shape `validate="strict"` can check
    _SHAPE_INVARIANT_REDUCTIONS = ("sum", "mean", "max", "min")

    def state(self) -> Dict[str, Any]:
        """The live state as a dict, with the update count under the reserved
        key ``"_update_count"`` so :meth:`load_state` round-trips it."""
        out = self._state_snapshot()
        out[self._STATE_COUNT_KEY] = int(self._update_count)
        return out

    def state_spec(self) -> Dict[str, Any]:
        """Declared layout of the state (JSON-serialisable; dtype names as in
        the JAX package, e.g. ``"int32"``)::

            {"spec_version": 1, "class": <type name>, "count_key": "_update_count",
             "fields": {name: {"kind": "array"|"list", "shape": tuple|None,
                               "dtype": str|None, "reduction": str|None,
                               "shape_invariant": bool}}}
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
        return {
            "spec_version": 1,
            "class": type(self).__name__,
            "count_key": self._STATE_COUNT_KEY,
            "fields": fields,
        }

    def validate_state(self, state: Dict[str, Any], mode: str = "strict", check_finite: bool = False) -> Dict[str, Any]:
        """Check a state dict against :meth:`state_spec` and return it.

        - ``"strict"``: every declared field present as a tensor of the
          declared dtype on the metric's device, with the declared shape for
          shape-invariant fields;
        - ``"cast"``: like strict, but converts arrays, dtypes and devices
          instead of raising (shape and structure problems still raise);
        - ``"off"``: no checks.

        ``check_finite=True`` also rejects NaN/Inf in float fields. Raises
        :class:`StateCorruptionError`.
        """
        if mode not in ("strict", "cast", "off"):
            raise ValueError(f"validate must be 'strict', 'cast' or 'off', got {mode!r}")
        if not isinstance(state, dict):
            raise StateCorruptionError(f"{type(self).__name__}: state must be a dict, got {type(state).__name__}")
        owner = type(self).__name__
        out: Dict[str, Any] = dict(state)
        for name, fs in self.state_spec()["fields"].items():
            if name not in state:
                raise StateCorruptionError(f"{owner}: state is missing declared field {name!r}")
            values = state[name]
            is_list = isinstance(values, (list, tuple))
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
    ) -> None:
        """Install a state dict as the live state (inverse of :meth:`state`).

        ``update_count`` restores the number of updates the state represents;
        when omitted, the count the state carries under ``"_update_count"`` is
        used, else exactly 1. ``validate``/``check_finite`` as in
        :meth:`validate_state`; on any failure the live state is untouched.
        """
        state = self.validate_state(state, mode=validate, check_finite=check_finite)
        carried = state.get(self._STATE_COUNT_KEY)
        if update_count is None and carried is not None:
            update_count = int(carried)
        staged: Dict[str, Any] = {}
        for k in self._defaults:
            if k not in state:
                raise StateCorruptionError(f"state missing field {k!r}")
            v = state[k]
            staged[k] = list(v) if isinstance(v, (list, tuple)) else v
        self._state.update(staged)
        self._computed = None
        self._update_count = int(update_count) if update_count is not None else 1

    def init_state(self) -> Dict[str, Any]:
        """A fresh default state (the pure analogue of ``reset``)."""
        return {k: ([] if isinstance(v, list) else v.clone()) for k, v in self._defaults.items()}

    def functional_init(self) -> Dict[str, Any]:
        """Alias of :meth:`init_state`, the name shared with ``MetricCollection``."""
        return self.init_state()

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
        self._is_synced = False

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
    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        # the wrapped bound methods are re-created in __setstate__
        for key in ("update", "compute", "_update_fn", "_compute_fn", "_update_signature"):
            state.pop(key, None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._update_fn = type(self).update.__get__(self)
        self._compute_fn = type(self).compute.__get__(self)
        self._update_signature = inspect.signature(self._update_fn)
        object.__setattr__(self, "update", self._wrap_update(self._update_fn))
        object.__setattr__(self, "compute", self._wrap_compute(self._compute_fn))

    def __deepcopy__(self, memo: Optional[dict] = None) -> "Metric":
        cls = self.__class__
        new_obj = cls.__new__(cls)
        if memo is not None:
            memo[id(self)] = new_obj
        new_obj.__setstate__(copy.deepcopy(self.__getstate__(), memo))
        return new_obj

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
