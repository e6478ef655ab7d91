"""Streaming windowed metric state: W per-window sub-states on a ring axis.

Always-on monitoring asks time-scoped questions ("accuracy over the last N
hours", tumbling per-interval aggregates, late events under a watermark)
that one growing accumulator cannot answer. As in the JAX package, this
module stacks **W per-window sub-states along a leading ring axis** and
keeps a monotonic window clock:

- **The clock.** ``window_head`` (an int32 state under ``max``) names the
  open window on the device. As in the JAX package, an update reads its
  slot there (``window_head % W``, a 0-d int64 tensor) and an advance its
  retiring slot (``(window_head + 1) % W``), so no slot is a host value a
  captured graph would bake in: the captured executor (``ops/executor.py``)
  serves every slot with one key a call shape, and no update or advance
  reads the device. The host mirror :attr:`WindowedMetric.clock` decides
  watermark admission, ``head_slot``, ``live_windows``, ``window_spec`` and
  the close stamps. The two part only where the JAX package's do: an eager
  ``forward`` resets the metric for its batch, which rewinds the host clock
  (the device clock comes back through the merge); a captured forward
  keeps it.
- **Updates and advances write the ring out of place.** The JAX package
  writes the open slot in place (``.at[slot].set`` on a donated buffer),
  so its advance costs the same for every W. The port's invariant is the
  opposite: updates replace state tensors and never write into them, which
  compute-group followers, the transactional snapshot, the lane guard's
  round baseline and asynchronous read snapshots all rely on. So an update
  reads the slot's row (``index_select``) and builds a new ring around its
  new row (one ``index_copy`` a field), and an advance a new ring whose
  retiring slot holds the defaults: both copy the whole ring, and their
  cost grows with W. A late update takes its window as a 0-d integer
  tensor on the metric's device, a value and not a shape of its key.
- **Sliding reads fold the live ring**: slots not opened yet are masked to
  the reduction identity and the window axis collapses in one reduction
  (``parallel.sync.fold_window_slots``): ``sum``/``mean`` segments add,
  ``max``/``min`` take the extremum, bit-exact to accumulating the live
  windows from scratch.
- **Watermarks**: ``update_window(k, batch)`` routes a late event into its
  still-open window while ``clock - k <= lateness``; older events are
  dropped with a ``window_late_drop`` breadcrumb in the ``windows`` flight
  domain and counted (``windows.dropped_late``), never silently. Late
  admits count ``windows.late_events`` and observe ``windows.lateness_us``.
- **Window-aligned asynchronous reads**: ``compute_async()`` snapshots the
  ring by reference and pins the submission-time clock, so a read
  submitted at window k's close resolves bit-exact to window k's close
  however far the ring advances before the worker runs it.

Composition: ``LanedMetric(WindowedMetric(m))`` stacks the window axis under
the lane axis, state ``(lanes, W, *field)``, and one laned round updates
each row's open slot (``lanes.py``); ``LanedMetric.advance_windows()``
rotates every lane's ring at once. Under the deferred layout the ring stacks
inside the shard: ``init_sharded_state(S)`` gives ``(S, W, *field)`` (and
``(S, lanes, W, *field)`` laned, ``lanes.DeferredLaneStep``), every shard
keeps its own copy of the clock, and the fold takes the clock by ``max``
(the shards agree, so it is exact) and each field by its reduction. A
sharded windowed export restores through ``load_state``, which folds it.
The wrapper syncs with the inner metric's ``sync_precision``,
``sync_quant_bits`` and ``sync_quant_block`` unless told otherwise.

Metrics holding list (``cat``) accumulators, ``None`` or callable
reductions have no identity-masked fold: they run an exact eager
per-window path (a list of W inner states), with a warning.

Telemetry: the ``tm_tpu.windows.advance`` span and its ``windows.advance_us``
histogram, the counters ``windows.advanced``, ``windows.late_events`` and
``windows.dropped_late``, the histogram ``windows.lateness_us``; all named
as in the JAX package.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.metric import Metric, _ready, resolve_device
from torchmetrics_tpu_torch.parallel.sync import fold_window_slots, live_window_mask
from torchmetrics_tpu_torch.utils.exceptions import StateCorruptionError, TorchMetricsUserError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "DEFAULT_WINDOW",
    "WINDOW_ELIGIBLE_REDUCTIONS",
    "WindowedCollection",
    "WindowedMetric",
    "window_eligible",
]

DEFAULT_WINDOW = 8

#: reduction families whose states can carry a ring axis: fixed-shape tensors
#: with an identity-masked fold (``parallel.sync.fold_window_slots``).
#: ``cat``/None/callables fall back to the eager per-window path with a warning.
WINDOW_ELIGIBLE_REDUCTIONS = ("sum", "mean", "max", "min")


def window_eligible(defaults: Dict[str, Any], reductions: Dict[str, Any]) -> bool:
    """Whether a metric's declared states can stack a ring axis: every state
    a fixed-shape tensor under a ``sum``/``mean``/``max``/``min`` reduction
    (the :data:`WINDOW_ELIGIBLE_REDUCTIONS` families)."""
    for name, default in defaults.items():
        if isinstance(default, list):
            return False
        if reductions.get(name) not in WINDOW_ELIGIBLE_REDUCTIONS:
            return False
    return True


def _encode_json_blob(payload: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(json.dumps(payload, sort_keys=True).encode("utf-8"), dtype=np.uint8).copy()


def _blob_bytes(blob: Any) -> bytes:
    """The bytes of a uint8 blob leaf (numpy, a list, or a tensor on any device)."""
    if isinstance(blob, torch.Tensor):
        blob = blob.detach().cpu().numpy()
    return np.asarray(blob, dtype=np.uint8).tobytes()


def _decode_json_blob(blob: Any, what: str, domain: str = "windows") -> Dict[str, Any]:
    """A uint8 JSON blob leaf decoded; an unreadable one raises
    ``StateCorruptionError``, flighted in ``domain``."""
    try:
        return json.loads(_blob_bytes(blob).decode("utf-8"))
    except Exception as err:
        raise obs.flighted(
            StateCorruptionError(f"{what} blob is unreadable ({type(err).__name__}: {err})"), domain=domain
        ) from err


def _now_us() -> int:
    return time.monotonic_ns() // 1000


def _slot_index(clock: torch.Tensor, window: int) -> torch.Tensor:
    """The ring slot of window ``clock`` (a 0-d integer tensor) as the
    one-element int64 index the ring's index operations take, on the
    clock's device: no host read, no host value."""
    return torch.remainder(clock.to(torch.int64), window).reshape(1)


def _ring_row(ring: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The row of ``ring`` at the slot ``index`` names (a copy)."""
    return ring.index_select(0, index).squeeze(0)


def _with_row(ring: torch.Tensor, index: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """A new ring equal to ``ring`` with ``row`` in the slot ``index``
    names (one out-of-place ``index_copy``; nothing written into ``ring``)."""
    return ring.index_copy(0, index, row.to(ring.dtype).unsqueeze(0))


def _late_verdict(k: int, clock: int, window: int, lateness: int, data: Dict[str, Any]) -> bool:
    """The watermark for an event stamped window ``k`` at ``clock``: raises
    for a future window; False (counted, with a breadcrumb) for one older
    than ``lateness`` or recycled; True to admit (a late admit counted)."""
    if k > clock:
        raise TorchMetricsUserError(f"window {k} is ahead of the clock ({clock}); advance() opens windows")
    age = clock - k
    if age > lateness or age >= window:
        obs.counter_inc("windows.dropped_late")
        obs.fault_breadcrumb(
            "window_late_drop",
            domain="windows",
            data={**data, "window": k, "clock": clock, "age": age, "lateness": lateness},
        )
        return False
    if age > 0:
        obs.counter_inc("windows.late_events")
    return True


class WindowedMetric(Metric):
    """W per-window sub-states of ``inner`` stacked on a ring axis.

    Args:
        inner: the metric to window. A detached clone is held; the wrapper
            only calls its pure ``functional_update``/``functional_compute``.
            The windowed metric lives on its device (``device=`` naming
            another raises).
        window: number of ring slots W (the sliding window's span, in windows).
        lateness: watermark bound, in windows: an event for window ``k`` is
            admitted while ``clock - k <= lateness`` (and its slot is live);
            older events are dropped with a breadcrumb. ``0 <= lateness < window``.
        kwargs: forwarded to :class:`~torchmetrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> from torchmetrics_tpu_torch.windows import WindowedMetric
        >>> win = WindowedMetric(SumMetric(device="cpu"), window=4)
        >>> win.update(torch.tensor([1.0, 2.0]))
        >>> win.advance()  # returns the new window clock
        1
        >>> win.update(torch.tensor([10.0]))
        >>> float(win.compute())  # sliding aggregate over the live ring
        13.0
        >>> float(win.compute_window(0)), float(win.compute_window(1))
        (3.0, 10.0)
    """

    full_state_update: Optional[bool] = False

    #: the executor never pads a windowed call, as in the JAX package: a
    #: padding row, a copy of row 0, lands in the slot's own sub-state
    _executor_bucketable = False

    #: reserved state key carrying the ring geometry and the host clock
    #: through state()/load_state as a uint8 JSON blob leaf
    _WINDOW_META_KEY = "_window_meta"

    #: the wrapper's own state beside the ring-stacked inner fields: the
    #: monotonic window clock, folded by ``max`` across ranks and lanes
    _WINDOW_AUX_FIELDS = ("window_head",)

    _TRANSIENT_KEYS = Metric._TRANSIENT_KEYS + ("_inner_clone_cache",)

    def __init__(self, inner: Metric, window: int = DEFAULT_WINDOW, lateness: int = 0, **kwargs: Any) -> None:
        if not isinstance(inner, Metric):
            raise ValueError(f"WindowedMetric wraps a Metric, got {type(inner).__name__}")
        if isinstance(inner, WindowedMetric):
            raise ValueError("WindowedMetric cannot wrap another WindowedMetric")
        from torchmetrics_tpu_torch.lanes import LanedMetric

        if isinstance(inner, LanedMetric):
            raise ValueError(
                "window the metric first, then lane it: LanedMetric(WindowedMetric(m))"
                " stacks the window axis under the lane axis"
            )
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        lateness = int(lateness)
        if not 0 <= lateness < window:
            raise ValueError(f"lateness must satisfy 0 <= lateness < window={window}, got {lateness}")
        asked = kwargs.get("device")
        if asked is not None and resolve_device(asked) != inner.device:
            raise ValueError(
                f"WindowedMetric: `device={asked}` differs from the inner metric's device {inner.device};"
                " a windowed metric lives on its inner metric's device"
            )
        kwargs["device"] = inner.device
        # the wrapper's collectives ship the inner states stacked on a ring
        # axis: inherit the inner sync precision unless overridden
        for knob in ("sync_precision", "sync_quant_bits", "sync_quant_block"):
            kwargs.setdefault(knob, inner.__dict__.get(knob))
        super().__init__(**kwargs)
        inner = inner.clone()
        self.__dict__["_inner"] = inner
        self.window = window
        self.lateness = lateness
        compiled = window_eligible(inner._defaults, inner._reductions)
        self.__dict__["_compiled_windows"] = compiled
        if compiled:
            for name, default in inner._defaults.items():
                self.add_state(
                    name,
                    self._stacked_default(default, window),
                    dist_reduce_fx=inner._reductions[name],
                    dtype=default.dtype,
                    sync_precision=inner._sync_precisions.get(name),
                )
            self.add_state("window_head", torch.zeros((), dtype=torch.int32), dist_reduce_fx="max")
        else:
            rank_zero_warn(
                f"{type(inner).__name__} holds list/'cat'/custom-reduction state —"
                " no compiled ring axis exists for it; WindowedMetric falls back to"
                " the exact eager per-window path (O(1) advance still holds, the"
                " single-dispatch speedup does not; see docs/STREAMING.md)"
            )
            self.__dict__["_window_states"] = [inner.init_state() for _ in range(window)]
            self.__dict__["_window_counts"] = [0] * window
        self.__dict__["_host_clock"] = 0
        self.__dict__["_close_times_us"] = {}

    # ------------------------------------------------------------- properties
    @property
    def inner(self) -> Metric:
        """The wrapped (detached) metric."""
        return self.__dict__["_inner"]

    @property
    def clock(self) -> int:
        """The monotonic index of the OPEN window (the host mirror of
        ``window_head``: watermark admission and slot addressing read it, so
        the hot path never reads the device clock)."""
        return self.__dict__["_host_clock"]

    @property
    def head_slot(self) -> int:
        """Ring slot housing the open window (``clock % window``)."""
        return self.__dict__["_host_clock"] % self.window

    @property
    def live_windows(self) -> Tuple[int, int]:
        """Inclusive ``(oldest, newest)`` absolute indices of live windows."""
        clock = self.__dict__["_host_clock"]
        return (max(0, clock - self.window + 1), clock)

    def window_spec(self) -> Dict[str, Any]:
        """Ring geometry and clock, as checkpoint manifests carry them
        (``io/checkpoint.py``'s ``windows`` block)."""
        clock = self.__dict__["_host_clock"]
        return {
            "window": self.window,
            "lateness": self.lateness,
            "clock": clock,
            "head": clock % self.window,
            "compiled": self._compiled_windows,
        }

    @property
    def _compiled_windows(self) -> bool:
        return self.__dict__["_compiled_windows"]

    @staticmethod
    def _stacked_default(default: torch.Tensor, window: int) -> torch.Tensor:
        """``default`` repeated along a new ring axis (a broadcast view)."""
        return default.unsqueeze(0).expand((window,) + tuple(default.shape))

    def _inner_fields(self) -> List[str]:
        return list(self.inner._defaults)

    def _executor_step_aside(self) -> Optional[str]:
        """None for a compiled ring: the inner metric under ``_inner`` is a
        template whose functional update runs over a ring row, holding none
        of the wrapper's state, so no replay misses a state of its own. A
        class-axis ring still steps aside (ROADMAP Queue A item 4b); the
        eager per-window path has no registered state, which the executor
        names."""
        if self.__dict__.get("_class_layouts"):
            return super()._executor_step_aside()
        return None

    def _executor_identity(self) -> str:
        """The inner metric (its class, its module's source hash and its
        configuration) and the ring size: a windowed key runs the INNER
        metric's update on a ring row, so two wrappers of equal stacked
        state over different inner metrics never share a stored entry (the
        JAX package's ``_executor_identity`` and ``_trace_config``)."""
        import sys

        from torchmetrics_tpu_torch.ops import compile_cache
        from torchmetrics_tpu_torch.ops.executor import _config_desc

        inner = self.inner
        cls = type(inner)
        mod = sys.modules.get(cls.__module__)
        return (
            f"inner={cls.__module__}.{cls.__qualname__}@{compile_cache.source_hash(mod or cls)}"
            f"[{_config_desc(inner)}]{inner._executor_identity()}|windows={self.window}"
        )

    def _window_clock(self, window: Any) -> torch.Tensor:
        """A late update's window as a 0-d integer tensor on the metric's
        device (a Python number becomes one by a fill, which reads nothing
        back)."""
        if isinstance(window, torch.Tensor):
            return window
        return torch.full((), int(window), dtype=torch.int64, device=self._device)

    def _executor_inputs(self, args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
        """A compiled ring's ``window=`` number as a 0-d device tensor."""
        window = kwargs.get("window")
        if window is None or isinstance(window, torch.Tensor) or not self._compiled_windows:
            return args, kwargs
        return args, {**kwargs, "window": self._window_clock(window)}

    # ------------------------------------------------------------ update path
    def update(self, *args: Any, window: Any = None, **kwargs: Any) -> None:
        """Advance the OPEN window's sub-state with one batch.

        ``window`` (normally left None) targets an explicit ABSOLUTE window
        index instead: the late-event path, for which callers use
        :meth:`update_window`, which enforces the watermark and passes it as
        a 0-d integer tensor on the metric's device (an int is converted).
        The slot is read on the device: ``window_head % W`` or ``window % W``."""
        inner = self.inner
        if not self._compiled_windows:
            k = self.__dict__["_host_clock"] if window is None else int(window)
            slot = k % self.window
            # staged then committed: a raising inner update leaves the window as it was
            staged = inner.functional_update(self.__dict__["_window_states"][slot], *args, **kwargs)
            self.__dict__["_window_states"][slot] = staged
            self.__dict__["_window_counts"][slot] += 1
            return
        fields = self._inner_fields()
        clock = self._state["window_head"] if window is None else self._window_clock(window)
        index = _slot_index(clock, self.window)
        row = {f: _ring_row(self._state[f], index) for f in fields}
        with obs.device_span(obs.SPAN_UPDATE, suffix=type(inner).__name__):
            new_row = inner.functional_update(row, *args, **kwargs)
        for f in fields:
            self._state[f] = _with_row(self._state[f], index, new_row[f])

    def _admit(self, k: int) -> bool:
        """The watermark verdict for window ``k`` at this clock (counted, a
        dropped event with its breadcrumb; a late admit observes how long
        after its window's close it came)."""
        clock = self.__dict__["_host_clock"]
        admitted = _late_verdict(k, clock, self.window, self.lateness, {})
        if admitted and k < clock:
            close = self.__dict__["_close_times_us"].get(k)
            if close is not None:
                obs.histogram_observe("windows.lateness_us", _now_us() - close)
        return admitted

    def update_window(self, k: int, *args: Any, **kwargs: Any) -> bool:
        """Route a batch into ABSOLUTE window ``k``, enforcing the watermark.

        Returns True when the batch landed. An event older than the lateness
        bound (or whose slot was recycled) is DROPPED with a fault breadcrumb
        and the ``windows.dropped_late`` counter: degraded and loud, never an
        exception. Events for future windows raise: only :meth:`advance`
        moves the clock."""
        k = int(k)
        if not self._admit(k):
            return False
        self.update(*args, window=k, **kwargs)
        return True

    # ----------------------------------------------------------- ring advance
    def advance(self, n: int = 1) -> int:
        """Close the open window and open the next, ``n`` times: the head
        moves on and the retiring slot returns to its defaults, in a new
        ring (the slot ``(window_head + 1) % W`` computed on the device; no
        device read). It runs outside the captured executor, as the JAX
        package's advance is a jit of its own, and marks the state escaped,
        so the executor's next call copies the new ring in. Returns the new
        clock."""
        for _ in range(int(n)):
            self._advance_once()
        return self.__dict__["_host_clock"]

    def _advance_once(self, ring: bool = True) -> None:
        """One advance; ``ring=False`` moves only the clock and the close
        stamps, for a compute-group follower whose ring is its leader's and
        is pointed at the leader's new one after the advance."""
        clock = self.__dict__["_host_clock"]
        with obs.span(obs.SPAN_WINDOWS, suffix=type(self.inner).__name__, histogram="windows.advance_us", window=self.window):
            if ring and self._compiled_windows:
                head = self._state["window_head"] + 1
                index = _slot_index(head, self.window)
                for f in self._inner_fields():
                    self._state[f] = _with_row(self._state[f], index, self._defaults[f][0])
                self._state["window_head"] = head
                self.__dict__["_state_escaped"] = True
            elif ring:
                slot = (clock + 1) % self.window
                self.__dict__["_window_states"][slot] = self.inner.init_state()
                self.__dict__["_window_counts"][slot] = 0
        self.__dict__["_host_clock"] = clock + 1
        closes = self.__dict__["_close_times_us"]
        closes[clock] = _now_us()
        horizon = clock - self.lateness - 1
        for old in [w for w in closes if w < horizon]:
            closes.pop(old)
        self._computed = None
        obs.counter_inc("windows.advanced")

    # ------------------------------------------------------------- read paths
    def compute(self) -> Any:
        """Sliding aggregate over the live ring: dead slots masked to the
        reduction identity, live slots folded (``fold_window_slots``) with
        the device clock, then the inner compute."""
        inner = self.inner
        if not self._compiled_windows:
            folded = self._fold_eager()
            return inner.functional_compute(folded if folded is not None else inner.init_state())
        return inner.functional_compute(self._fold_windows(self._state, live_window_mask(self._state["window_head"], self.window)))

    def _fold_windows(self, states: Dict[str, Any], live: torch.Tensor) -> Dict[str, Any]:
        reductions = self.inner._reductions
        return {f: fold_window_slots(states[f], reductions[f], live) for f in self._inner_fields()}

    def _fold_eager(self) -> Optional[Dict[str, Any]]:
        inner = self.inner
        lo, hi = self.live_windows
        folded, count = None, 0
        for k in range(lo, hi + 1):
            slot = k % self.window
            st = self.__dict__["_window_states"][slot]
            c = self.__dict__["_window_counts"][slot]
            if folded is None:
                folded, count = st, c
            else:
                # the count-weighted merge reproduces the running-mean formula
                # for "mean" states; other families ignore the counts
                folded = inner.merge_states(folded, st, counts=(max(count, 1), max(c, 1)))
                count += c
        return folded

    def compute_window(self, k: int) -> Any:
        """One window's ``compute()`` value, valid while its slot is live
        (``clock - window < k <= clock``). The row is a copy, so a value
        held past later updates keeps its own (the live ring may be the
        captured executor's slot, which a later replay writes)."""
        k = int(k)
        clock = self.__dict__["_host_clock"]
        if not clock - self.window < k <= clock:
            raise TorchMetricsUserError(f"window {k} is not live (clock={clock}, ring holds the last {self.window})")
        inner = self.inner
        slot = k % self.window
        if not self._compiled_windows:
            return inner.functional_compute(self.__dict__["_window_states"][slot])
        return inner.functional_compute({f: self._state[f][slot].clone() for f in self._inner_fields()})

    # ----------------------------------------------------- asynchronous reads
    def _read_inner_clone(self) -> Metric:
        """Detached clone of ``inner`` for the read worker's compute (the
        live inner swaps its state during a compute)."""
        cached = self.__dict__.get("_inner_clone_cache")
        if cached is None:
            cached = self.inner.clone()
            self.__dict__["_inner_clone_cache"] = cached
        return cached

    def _prepare_async_read(self) -> Callable[[], Any]:
        """Window-aligned asynchronous read: the caller snapshots the ring by
        reference (updates and advances replace it, never write into it; a
        tensor of the executor's slots is swapped for a copy first) and pins
        the submission-time clock, so the worker folds exactly the windows
        live at submission. Eager rings and initialised ``torch.distributed``
        worlds read inline."""
        from torchmetrics_tpu_torch.ops import async_read as _async

        cached = self._computed
        if cached is not None:
            event = _async.submission_event(cached)
            return lambda: _ready(event, cached)
        if not self._compiled_windows or bool(self.distributed_available_fn()):
            obs.counter_inc("reads.inline_compute")
            value = self.compute()
            event = _async.submission_event(value)
            return lambda: _ready(event, value)
        snapshot = self._escaped_snapshot()
        flags = self._capture_read_flags()
        clock = self.__dict__["_host_clock"]
        inner_clone = self._read_inner_clone()
        event = _async.submission_event(snapshot)

        def body() -> Any:
            _async.wait_submitted(event)
            return self._async_window_job(snapshot, flags, clock, inner_clone)

        return body

    def _async_window_job(self, snapshot: Dict[str, Any], flags: Dict[str, Any], clock: int, inner_clone: Metric) -> Any:
        """WORKER-SIDE: fold the pinned-clock ring snapshot, compute on the
        detached inner clone, materialise, guarded cache write-back."""
        from torchmetrics_tpu_torch.ops import async_read as _async

        folded = self._fold_windows(snapshot, live_window_mask(clock, self.window, device=self._device))
        value = _async.materialize(inner_clone.functional_compute(folded))
        if (
            self.__dict__.get("_update_count") == flags["count"]
            and flags["cache"]
            and self.__dict__.get("_host_clock") == clock
            and self.__dict__.get("_computed") is None
        ):
            self.__dict__["_computed"] = value
            if self.__dict__.get("_update_count") != flags["count"]:
                self.__dict__["_computed"] = None  # an update landed mid-write
        return value

    # ------------------------------------------------------------- durability
    def _window_meta_blob(self) -> np.ndarray:
        return _encode_json_blob({"window": self.window, "lateness": self.lateness, "clock": self.__dict__["_host_clock"]})

    def state(self) -> Dict[str, Any]:
        """State export carrying the ring geometry and the host clock under
        the reserved ``"_window_meta"`` key (a uint8 JSON blob the snapshot
        store persists as an ordinary leaf), in the JAX package's layout."""
        if self._compiled_windows:
            out = super().state()
        else:
            out = {
                f"window_{i:05d}": {**self.__dict__["_window_states"][i], self._STATE_COUNT_KEY: self.__dict__["_window_counts"][i]}
                for i in range(self.window)
            }
        out[self._WINDOW_META_KEY] = self._window_meta_blob()
        return out

    def load_state(
        self,
        state: Dict[str, Any],
        update_count: Optional[int] = None,
        validate: str = "strict",
        check_finite: bool = False,
        sharded: Optional[bool] = None,
    ) -> None:
        """Install a windowed export: the meta blob re-anchors the clock and
        is checked against this instance's ring size (a W=64 snapshot never
        installs into a W=8 ring). A sharded (deferred) export, ``(S, W,
        *field)`` with one clock a shard, is validated per shard and folded
        at once (the clock by ``max``)."""
        if not isinstance(state, dict):
            raise obs.flighted(
                StateCorruptionError(f"{type(self).__name__}: state must be a dict, got {type(state).__name__}"),
                domain="windows",
            )
        if sharded is None:
            sharded = state.get(self._STATE_SHARDS_KEY) is not None
        if sharded and not self._compiled_windows:
            raise TorchMetricsUserError("a sharded windowed state needs a compiled (fixed-shape) ring")
        state = dict(state)
        blob = state.pop(self._WINDOW_META_KEY, None)
        meta = _decode_json_blob(blob, f"{type(self).__name__} window meta") if blob is not None else None
        if meta is not None and validate != "off" and int(meta.get("window", self.window)) != self.window:
            raise obs.flighted(
                StateCorruptionError(
                    f"{type(self).__name__}: snapshot carries a {meta['window']}-slot ring,"
                    f" this instance is configured for {self.window}"
                ),
                domain="windows",
            )
        if self._compiled_windows:
            super().load_state(state, update_count=update_count, validate=validate, check_finite=check_finite, sharded=bool(sharded))
            self._fold_pending()
        else:
            self._load_state_eager(state, validate=validate, check_finite=check_finite)
        if meta is not None:
            clock = int(meta.get("clock", 0))
        elif self._compiled_windows:
            clock = int(self._state["window_head"].max())
        else:
            clock = 0
        self.__dict__["_host_clock"] = clock
        self.__dict__["_close_times_us"] = {}

    def _load_state_eager(self, state: Dict[str, Any], validate: str, check_finite: bool) -> None:
        inner = self.inner
        keys = sorted(k for k in state if isinstance(k, str) and k.startswith("window_"))
        if len(keys) != self.window:
            raise obs.flighted(
                StateCorruptionError(f"{type(self).__name__}: export holds {len(keys)} window states, expected {self.window}"),
                domain="windows",
            )
        staged, counts = [], []
        for key in keys:
            sub = dict(state[key])
            count = int(sub.get(self._STATE_COUNT_KEY, 0))
            try:
                checked = inner.validate_state(sub, mode=validate, check_finite=check_finite)
            except StateCorruptionError as err:
                raise obs.flighted(StateCorruptionError(f"{type(self).__name__}: {key}: {err}"), domain="windows") from err
            staged.append({f: (list(v) if isinstance(v, (list, tuple)) else v) for f, v in checked.items() if f in inner._defaults})
            counts.append(count)
        self.__dict__["_window_states"] = staged
        self.__dict__["_window_counts"] = counts
        self._computed = None
        self._update_count = self._restored_count(None, fallback=max(counts) if counts else 1)

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Reset every ring slot to defaults AND rewind the clock to 0."""
        super().reset()
        self.__dict__["_host_clock"] = 0
        self.__dict__["_close_times_us"] = {}
        if not self._compiled_windows:
            inner = self.inner
            self.__dict__["_window_states"] = [inner.init_state() for _ in range(self.window)]
            self.__dict__["_window_counts"] = [0] * self.window

    def to(self, device: Union[str, torch.device]) -> "WindowedMetric":
        """Move the ring, the inner metric and any eager window states."""
        super().to(device)
        self.inner.to(self._device)
        self.__dict__.pop("_inner_clone_cache", None)
        if not self._compiled_windows:
            self.__dict__["_window_states"] = [
                {k: ([el.to(self._device) for el in v] if isinstance(v, list) else v.to(self._device)) for k, v in st.items()}
                for st in self.__dict__["_window_states"]
            ]
        return self

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self.__dict__.setdefault("_host_clock", 0)
        self.__dict__.setdefault("_close_times_us", {})

    def __repr__(self) -> str:
        return (
            f"WindowedMetric({type(self.inner).__name__}, window={self.window},"
            f" clock={self.__dict__['_host_clock']}, lateness={self.lateness})"
        )


class WindowedCollection:
    """Windowed state over a whole metric suite: every member is a
    :class:`WindowedMetric` sharing one clock, advanced together. The
    members sit in one :class:`~torchmetrics_tpu_torch.MetricCollection`, so
    compute groups and the shared counting launch apply to a windowed update
    as to a plain one, late batches included (:meth:`update_window`).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MaxMetric, SumMetric
        >>> from torchmetrics_tpu_torch.windows import WindowedCollection
        >>> wc = WindowedCollection({"s": SumMetric(device="cpu"), "m": MaxMetric(device="cpu")}, window=4)
        >>> wc.update(torch.tensor([1.0, 5.0]))
        >>> _ = wc.advance()
        >>> wc.update(torch.tensor([2.0]))
        >>> {k: float(v) for k, v in sorted(wc.compute().items())}
        {'m': 5.0, 's': 8.0}
    """

    def __init__(
        self,
        metrics: Union[Dict[str, Metric], Sequence[Metric], Metric, Any],
        window: int = DEFAULT_WINDOW,
        lateness: int = 0,
        **kwargs: Any,
    ) -> None:
        from torchmetrics_tpu_torch.collections import MetricCollection

        if isinstance(metrics, MetricCollection):
            metrics = {name: m for name, m in metrics.items(keep_base=True)}
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
            raise ValueError("WindowedCollection needs at least one metric")
        devices = {m.device for m in metrics.values()}
        if len(devices) != 1:
            raise ValueError(f"WindowedCollection members must share one device, got {sorted(map(str, devices))}")
        self.window = int(window)
        self.lateness = int(lateness)
        self._members: Dict[str, WindowedMetric] = {
            name: WindowedMetric(m, window=window, lateness=lateness, **kwargs) for name, m in metrics.items()
        }
        # ``executor=`` reaches the members and the collection, whose
        # executor runs every member's windowed update as one dispatch
        self.collection = MetricCollection(
            dict(self._members), device=next(iter(devices)), executor=kwargs.get("executor")
        )

    @property
    def device(self) -> torch.device:
        """The members' device (a snapshot restores its leaves there)."""
        return self.collection.device

    @property
    def clock(self) -> int:
        return self._first().clock

    def keys(self) -> Iterable[str]:
        return self._members.keys()

    def items(self) -> Iterable[Any]:
        return self._members.items()

    def __getitem__(self, name: str) -> WindowedMetric:
        return self._members[name]

    def laned(self, capacity: int = 1024, **kwargs: Any) -> Any:
        """A :class:`~torchmetrics_tpu_torch.lanes.LanedCollection` over the
        windowed members: per-session rings sharing one session table,
        advancing in lockstep."""
        from torchmetrics_tpu_torch.lanes import LanedCollection

        return LanedCollection(self, capacity=capacity, **kwargs)

    def window_spec(self) -> Dict[str, Any]:
        return {"window": self.window, "lateness": self.lateness, "clock": self.clock, "head": self.clock % self.window}

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Advance every member's open window with one collection update (a
        ``window=`` given as a number goes in as a 0-d tensor on the device,
        so every window shares one captured key)."""
        _, kwargs = self._first()._executor_inputs(args, kwargs)
        self.collection.update(*args, **kwargs)

    def _first(self) -> WindowedMetric:
        return next(iter(self._members.values()))

    def update_window(self, k: int, *args: Any, **kwargs: Any) -> bool:
        """Route a late batch into window ``k`` for every member; returns
        whether it landed. The watermark's verdict depends on the shared
        clock only, so every member agrees; each member counts it (as in the
        JAX package, which walks the members). An admitted batch goes
        through ONE collection update: one update per compute group and one
        counting launch shared through the fusion scope, as for an on-time
        batch; a dropped one launches nothing."""
        k = int(k)
        verdicts = [m._admit(k) for m in self._members.values()]
        if not all(verdicts):
            return False
        self.update(*args, window=k, **kwargs)
        return True

    def advance(self, n: int = 1) -> int:
        """Advance every member's clock; returns the new shared clock. Each
        distinct ring is written once: a compute-group follower moves only
        its clock, then points at its leader's new ring (and is marked
        escaped with it: the executor's next call copies the ring in)."""
        followers = self.collection._compute_group_followers()
        for name, m in self._members.items():
            if name in followers and m._compiled_windows:
                for _ in range(int(n)):
                    m._advance_once(ring=False)
            else:
                m.advance(n)
        if followers:
            self.collection._compute_groups_create_state_ref()
            for name in followers:
                self._members[name].__dict__["_state_escaped"] = True
        return self.clock

    def compute(self) -> Dict[str, Any]:
        return self.collection.compute()

    def compute_async(self) -> Any:
        return self.collection.compute_async()

    def compute_window(self, k: int) -> Dict[str, Any]:
        return {name: m.compute_window(k) for name, m in self._members.items()}

    def reset(self) -> None:
        self.collection.reset()

    def state(self) -> Dict[str, Any]:
        return self.collection.state()

    def load_state(self, states: Dict[str, Any], **kwargs: Any) -> None:
        self.collection.load_state(states, **kwargs)

    def __repr__(self) -> str:
        return f"WindowedCollection({sorted(self._members)}, window={self.window}, clock={self.clock})"
