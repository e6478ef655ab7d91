"""Host-side span tracer: a lock-cheap ring buffer aligned with profiler traces.

One primitive wraps every hot seam of the runtime::

    with span(SPAN_UPDATE, suffix="MulticlassAccuracy"):
        update(...)

A :func:`span` enters a ``torch.profiler.record_function`` range under the
same name while a PyTorch profiler is recording, so host spans line up with
the device kernels in its trace; when tracing is on and CUDA is initialised
it also pushes an NVTX range (``torch.cuda.nvtx``) for external profilers.
When tracing is enabled (``TORCHMETRICS_TPU_TRACE=1`` or
:func:`set_tracing`) it records a ``(name, t_start_ns, t_end_ns, attrs)``
event into a bounded ring buffer that the exporters (``obs/export.py``)
drain off the hot path. The ring keeps the NEWEST events when it wraps
(oldest are dropped and counted), so a post-incident export shows the steps
closest to the incident.

Cost model (the tracer must never be the thing it measures):

- every flag off: one object, one attribute read and one C call that asks
  whether a profiler is recording; no annotation is entered.
- telemetry on, tracing off (the default): two ``perf_counter_ns`` reads
  and a lock-free deque append, only for spans whose name maps to a flight
  domain (``obs/flight.py``) or that declare a histogram.
- tracing on: the above plus the causal-id bookkeeping, the NVTX range on
  the card and one locked ring append.
- device work is never timed by blocking the caller: :func:`observe_ready`
  records a CUDA event on the caller's current stream and a background
  thread waits on that event, so the recorded span covers enqueue to
  completion without synchronising the caller's stream.

Naming: the ``SPAN_*`` constants below are the single source of truth for
both host spans and in-range device annotations (:func:`device_span`), and
keep the JAX package's ``tm_tpu.*`` names, so traces of the two packages
read alike.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from torchmetrics_tpu_torch.obs import flight as _flight

#: master telemetry switch (counters + gauges + breadcrumbs); default ON
TELEMETRY_ENV = "TORCHMETRICS_TPU_TELEMETRY"
#: span ring-buffer recording; default OFF
TRACE_ENV = "TORCHMETRICS_TPU_TRACE"
#: ring capacity in events (default 65536; newest events win on wrap)
TRACE_BUFFER_ENV = "TORCHMETRICS_TPU_TRACE_BUFFER"

_DEFAULT_CAPACITY = 65536

# --------------------------------------------------------------- span names
# The JAX package's canonical span names, kept verbatim. The executor's
# (dispatch, compile, cache, warmup, pad) and the later layers' (reshard,
# fleet, integrity) are emitted by nothing in the port yet; the exported
# formats keep them.
SPAN_DISPATCH = "tm_tpu.dispatch"          # compiled executor dispatch (per owner)
SPAN_UPDATE = "tm_tpu.update"              # metric update body
SPAN_COMPUTE = "tm_tpu.compute"            # metric compute
SPAN_REDUCE = "tm_tpu.reduce"              # sync / reduce
SPAN_PAD = "tm_tpu.pad"                    # ragged-batch bucket padding
SPAN_COMPILE = "tm_tpu.compile"            # trace+compile
SPAN_CACHE_LOAD = "tm_tpu.cache.load"      # persistent executable load
SPAN_CACHE_STORE = "tm_tpu.cache.store"    # background executable store
SPAN_SYNC_GATHER = "tm_tpu.sync.gather"    # bounded cross-process collectives
SPAN_CKPT_SAVE = "tm_tpu.checkpoint.save"      # atomic snapshot write
SPAN_CKPT_RESTORE = "tm_tpu.checkpoint.restore"  # snapshot load + validate
SPAN_AUTOSAVE = "tm_tpu.autosave"          # Autosaver tick (the hot-path half)
SPAN_WARMUP = "tm_tpu.warmup"              # warmup API precompiles
SPAN_EXPORT = "tm_tpu.export"              # telemetry export itself
SPAN_LANES = "tm_tpu.lanes.dispatch"       # lane-batched multi-session dispatch
SPAN_QUARANTINE = "tm_tpu.lanes.quarantine"  # lane fault containment
SPAN_COMPUTE_ASYNC = "tm_tpu.compute_async"  # async-read submission (caller-side half)
SPAN_RESHARD = "tm_tpu.reshard"            # elastic N->M re-split
SPAN_KERNEL = "tm_tpu.kernel"              # backend-dispatched kernel body
SPAN_READ_RESOLVE = "tm_tpu.read.resolve"  # read-pipeline worker: one job's blocking tail
SPAN_SHADOW = "tm_tpu.shadow.refresh"      # shard-shadow refresh
SPAN_PACK = "tm_tpu.lanes.pack"            # ingest slab pack
SPAN_CLASS_ROUTE = "tm_tpu.class_route"    # class-axis shard routing
SPAN_FLEET_SHIP = "tm_tpu.fleet.ship"      # fleet leaf uplink
SPAN_FLEET_MERGE = "tm_tpu.fleet.merge"    # fleet aggregator merge
SPAN_WINDOWS = "tm_tpu.windows.advance"    # streaming ring advance (windows.advance_us)
SPAN_INTEGRITY = "tm_tpu.integrity.audit"  # state-integrity audit

#: every canonical span name, for docs/tests
SPAN_NAMES = (
    SPAN_DISPATCH,
    SPAN_UPDATE,
    SPAN_COMPUTE,
    SPAN_REDUCE,
    SPAN_PAD,
    SPAN_COMPILE,
    SPAN_CACHE_LOAD,
    SPAN_CACHE_STORE,
    SPAN_SYNC_GATHER,
    SPAN_CKPT_SAVE,
    SPAN_CKPT_RESTORE,
    SPAN_AUTOSAVE,
    SPAN_WARMUP,
    SPAN_EXPORT,
    SPAN_LANES,
    SPAN_QUARANTINE,
    SPAN_COMPUTE_ASYNC,
    SPAN_RESHARD,
    SPAN_KERNEL,
    SPAN_READ_RESOLVE,
    SPAN_SHADOW,
    SPAN_PACK,
    SPAN_CLASS_ROUTE,
    SPAN_FLEET_SHIP,
    SPAN_FLEET_MERGE,
    SPAN_WINDOWS,
    SPAN_INTEGRITY,
)


def _env_on(name: str, default: str) -> bool:
    return os.environ.get(name, default).strip().lower() not in ("0", "false", "off", "no")


class _Flags:
    """Resolved telemetry flags; the environment is read once (and on
    :func:`set_telemetry`/:func:`set_tracing` with None), never per span."""

    __slots__ = ("telemetry", "tracing")

    def __init__(self) -> None:
        self.refresh()

    def refresh(self) -> None:
        self.telemetry = _env_on(TELEMETRY_ENV, "1")
        self.tracing = self.telemetry and _env_on(TRACE_ENV, "0")


_flags = _Flags()

#: whether a torch profiler is recording (a C call, no allocation)
_profiler_enabled = torch._C._autograd._profiler_enabled


def telemetry_enabled() -> bool:
    """Whether counters/gauges/breadcrumbs record (``TORCHMETRICS_TPU_TELEMETRY``)."""
    return _flags.telemetry


def tracing_enabled() -> bool:
    """Whether spans record into the ring buffer (``TORCHMETRICS_TPU_TRACE``)."""
    return _flags.tracing


def set_telemetry(enabled: Optional[bool]) -> None:
    """Override the master telemetry switch (None restores the env default).
    Turning telemetry off also stops span recording."""
    if enabled is None:
        _flags.refresh()
    else:
        _flags.telemetry = bool(enabled)
        if not enabled:
            _flags.tracing = False


def set_tracing(enabled: Optional[bool]) -> None:
    """Override span recording (None restores the env default). Tracing only
    engages while telemetry itself is on."""
    if enabled is None:
        _flags.tracing = _flags.telemetry and _env_on(TRACE_ENV, "0")
    else:
        _flags.tracing = bool(enabled) and _flags.telemetry


class SpanEvent(NamedTuple):
    """One completed host-side span. Times are ``time.perf_counter_ns`` values
    (monotonic, process-local); exporters convert to µs.

    ``trace_id`` groups every span of one logical operation across threads
    (a ``compute_async`` submission and its worker-side replay share one),
    ``span_id``/``parent_id`` form the in-trace tree, and ``flow_src`` (set
    on the first span a worker opens under a reopened :class:`TraceContext`)
    carries ``(src_span_id, src_tid, src_t_ns)`` of the submitting side, from
    which the exporter emits the Perfetto flow-event pair."""

    name: str
    t_start_ns: int
    t_end_ns: int
    tid: int
    attrs: Optional[Dict[str, Any]]
    trace_id: int = 0
    span_id: int = 0
    parent_id: int = 0
    flow_src: Optional[Tuple[int, int, int]] = None

    @property
    def duration_us(self) -> float:
        return (self.t_end_ns - self.t_start_ns) / 1e3


# ------------------------------------------------------------ causal context
#: process-wide id source for trace/span ids (next() is atomic under the GIL)
_ids = itertools.count(1)


def _next_id() -> int:
    return next(_ids)


class TraceContext(NamedTuple):
    """A submission-side capture that rides a job object across threads:
    ``trace_id`` the logical operation, ``span_id`` the span open at capture
    (the flow source), ``tid``/``t_ns`` where and when it was captured.
    Capture with :func:`capture_context`, reopen with :func:`use_context`."""

    trace_id: int
    span_id: int
    tid: int
    t_ns: int


class _TraceTLS(threading.local):
    """Per-thread causal state: the ambient trace id, the open-span stack,
    and the pending flow source a reopened context plants for the first
    worker-side span to consume."""

    def __init__(self) -> None:
        self.trace_id = 0
        self.stack: List[int] = []
        self.flow_src: Optional[Tuple[int, int, int]] = None


_trace_tls = _TraceTLS()


def capture_context() -> Optional[TraceContext]:
    """Capture the current thread's causal position for a cross-thread
    handoff (None when tracing is off). Outside any span a fresh trace id is
    minted so the worker side still groups under one trace."""
    if not _flags.tracing:
        return None
    tls = _trace_tls
    return TraceContext(
        tls.trace_id or _next_id(),
        tls.stack[-1] if tls.stack else 0,
        threading.get_ident(),
        time.perf_counter_ns(),
    )


@contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Reopen a captured :class:`TraceContext` on THIS thread: spans opened
    inside inherit the submitter's ``trace_id`` (parented under the
    submitting span), and the first of them records the flow source.
    ``use_context(None)`` is a no-op."""
    if ctx is None or not _flags.tracing:
        yield
        return
    tls = _trace_tls
    prev = (tls.trace_id, tls.stack, tls.flow_src)
    tls.trace_id = ctx.trace_id
    tls.stack = [ctx.span_id] if ctx.span_id else []
    tls.flow_src = (ctx.span_id, ctx.tid, ctx.t_ns) if ctx.span_id else None
    try:
        yield
    finally:
        tls.trace_id, tls.stack, tls.flow_src = prev


def current_trace_id() -> int:
    """The ambient trace id on this thread (0 outside any span/context)."""
    return _trace_tls.trace_id


#: installed by obs/registry.py at import (avoids a module cycle): spans
#: constructed with ``histogram="name"`` feed their duration here
_HISTOGRAM_SINK: Optional[Callable[[str, float], None]] = None


class _Ring:
    """Bounded span store: fixed capacity, newest events displace oldest.
    One lock guards (buffer, head, totals), held only for the append or
    copy; formatting and file IO happen outside, in the exporters."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        # re-entrant: a signal handler's spans may land while the main
        # thread holds the lock
        self._lock = threading.RLock()
        self._buf: List[Optional[SpanEvent]] = [None] * self.capacity
        self._head = 0          # next write slot
        self._size = 0          # live events in the buffer
        self.total_recorded = 0
        self.total_dropped = 0  # overwritten before any drain saw them

    def append(self, ev: SpanEvent) -> None:
        with self._lock:
            if self._size == self.capacity:
                self.total_dropped += 1
            else:
                self._size += 1
            self._buf[self._head] = ev
            self._head = (self._head + 1) % self.capacity
            self.total_recorded += 1

    def _ordered(self) -> List[SpanEvent]:
        start = (self._head - self._size) % self.capacity
        return [self._buf[(start + i) % self.capacity] for i in range(self._size)]  # type: ignore[misc]

    def snapshot(self) -> List[SpanEvent]:
        with self._lock:
            return self._ordered()

    def drain(self) -> List[SpanEvent]:
        with self._lock:
            out = self._ordered()
            self._buf = [None] * self.capacity
            self._head = 0
            self._size = 0
            return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "buffered": self._size,
                "capacity": self.capacity,
                "recorded_total": self.total_recorded,
                "dropped_total": self.total_dropped,
            }


def _default_capacity() -> int:
    raw = os.environ.get(TRACE_BUFFER_ENV, "").strip()
    if not raw:
        return _DEFAULT_CAPACITY
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{TRACE_BUFFER_ENV} must be an integer event count, got {raw!r}")
    return value if value > 0 else _DEFAULT_CAPACITY


_ring = _Ring(_default_capacity())


def reset_ring(capacity: Optional[int] = None) -> None:
    """Replace the ring (tests / capacity changes); buffered events are lost."""
    global _ring
    _ring = _Ring(capacity if capacity is not None else _default_capacity())


def peek_events() -> List[SpanEvent]:
    """Buffered spans, oldest to newest, WITHOUT clearing the ring."""
    return _ring.snapshot()


def drain_events() -> List[SpanEvent]:
    """Remove and return all buffered spans, oldest to newest."""
    return _ring.drain()


def ring_stats() -> Dict[str, Any]:
    """Ring occupancy/drop counters plus the resolved flag."""
    out = _ring.stats()
    out["enabled"] = _flags.tracing
    return out


def record_span(
    name: str,
    t_start_ns: int,
    t_end_ns: int,
    attrs: Optional[Dict[str, Any]] = None,
    ctx: Optional[TraceContext] = None,
) -> None:
    """Record a pre-timed span (the :func:`observe_ready` observer and tests
    use this). ``ctx`` threads the causal ids of a submission-side
    :func:`capture_context` through."""
    if _flags.tracing:
        if ctx is not None:
            _ring.append(
                SpanEvent(
                    name, t_start_ns, t_end_ns, threading.get_ident(), attrs,
                    ctx.trace_id, _next_id(), ctx.span_id,
                    (ctx.span_id, ctx.tid, ctx.t_ns) if ctx.span_id else None,
                )
            )
        else:
            _ring.append(SpanEvent(name, t_start_ns, t_end_ns, threading.get_ident(), attrs))


def _annotation(name: str) -> Any:
    """The profiler-facing range of a span, or None when nothing records:
    ``record_function`` while a torch profiler runs, an NVTX range on the
    card while tracing is on."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    if _flags.tracing and torch.cuda.is_initialized():
        return _NvtxRange(name)
    return None


class _NvtxRange:
    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc: Any) -> None:
        torch.cuda.nvtx.range_pop()


class span:
    """Host-side span: a profiler range while one records, a ring event when
    tracing, a flight record (telemetry on) for seams with a flight domain,
    causal ids riding every traced event.

    ``with span(SPAN_REDUCE): ...`` or ``with span(SPAN_UPDATE, suffix=name)``
    (rendered ``tm_tpu.update/Name``). Keyword attrs ride into the Chrome
    trace's ``args``; ``histogram="some.metric_us"`` feeds the span's
    duration into that registry histogram (telemetry on only).
    """

    __slots__ = (
        "name", "attrs", "_ann", "_t0", "_sid", "_trace_id", "_parent",
        "_flow", "_owns_trace", "_domain", "_hist",
    )

    def __init__(
        self,
        name: str,
        suffix: Optional[str] = None,
        histogram: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        self._domain = _flight.DOMAIN_OF_SPAN.get(name)
        self._hist = histogram
        self.name = f"{name}/{suffix}" if suffix else name
        self.attrs = attrs or None
        self._ann = None
        self._t0 = 0
        self._sid = 0

    def __enter__(self) -> "span":
        ann = _annotation(self.name)
        if ann is not None:
            ann.__enter__()
            self._ann = ann
        f = _flags
        if f.tracing:
            self._t0 = time.perf_counter_ns()
            tls = _trace_tls
            self._sid = _next_id()
            self._parent = tls.stack[-1] if tls.stack else 0
            self._owns_trace = not tls.trace_id
            if self._owns_trace:
                tls.trace_id = _next_id()
            self._trace_id = tls.trace_id
            self._flow = tls.flow_src
            tls.flow_src = None
            tls.stack.append(self._sid)
        elif f.telemetry and (
            (self._domain is not None and _flight.enabled()) or self._hist is not None
        ):
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0:
            t1 = time.perf_counter_ns()
            attrs = self.attrs
            if exc_type is not None:
                attrs = dict(attrs or ())
                attrs["error"] = exc_type.__name__
            trace_id = 0
            if self._sid:
                tls = _trace_tls
                if tls.stack and tls.stack[-1] == self._sid:
                    tls.stack.pop()
                if self._owns_trace:
                    tls.trace_id = 0
                trace_id = self._trace_id
                if _flags.tracing:
                    _ring.append(
                        SpanEvent(
                            self.name, self._t0, t1, threading.get_ident(), attrs,
                            trace_id, self._sid, self._parent, self._flow,
                        )
                    )
            if _flags.telemetry:
                dur_us = (t1 - self._t0) / 1e3
                if self._domain is not None and _flight.enabled():
                    _flight.record(
                        self._domain, self.name, dur_us, trace_id=trace_id,
                        error=exc_type.__name__ if exc_type is not None else None,
                    )
                if self._hist is not None and _HISTOGRAM_SINK is not None:
                    _HISTOGRAM_SINK(self._hist, dur_us)
            self._t0 = 0
            self._sid = 0
        ann = self._ann
        if ann is not None:
            self._ann = None
            return ann.__exit__(exc_type, exc, tb)
        return None


def device_span(name: str, suffix: Optional[str] = None) -> Any:
    """The device-side range of a canonical span name: a ``record_function``
    range around the device work while a torch profiler records (its
    kernels then nest under the name in the trace), else a no-op. Using the
    constant keeps the device-side name equal to the host-side
    :class:`span` name for the same seam."""
    full = f"{name}/{suffix}" if suffix else name
    if _profiler_enabled():
        return torch.profiler.record_function(full)
    return nullcontext()


# ------------------------------------------------------- async device timing
def _first_tensor(value: Any) -> Optional[torch.Tensor]:
    """The first tensor in a tensor, dict, list or tuple (depth first)."""
    if isinstance(value, torch.Tensor):
        return value
    items = value.values() if isinstance(value, dict) else value if isinstance(value, (list, tuple)) else ()
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class _ReadyObserver:
    """One daemon thread that waits on CUDA events SO THE CALLER NEVER DOES:
    :func:`observe_ready` records an event on the caller's current stream
    and enqueues it; the observer waits on the event here and records the
    enqueue-to-completion span. A bounded queue sheds observations (counted
    in ``dropped``) instead of back-pressuring the caller."""

    def __init__(self, maxsize: int = 256) -> None:
        self._jobs: Any = queue.Queue(maxsize=maxsize)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.dropped = 0

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="tm_tpu_obs_ready", daemon=True)
                self._thread.start()

    def _run(self) -> None:
        while True:
            name, t0, event, attrs, ctx = self._jobs.get()
            try:
                event.synchronize()
                record_span(name, t0, time.perf_counter_ns(), attrs, ctx=ctx)
            except Exception as err:
                # an unobservable event is not an incident; record the
                # attempt so the trace shows the observation was shed
                from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

                rank_zero_debug(f"tm_tpu obs ready-observer: {name} unobservable ({type(err).__name__}: {err})")
                record_span(name, t0, time.perf_counter_ns(), {**(attrs or {}), "error": type(err).__name__}, ctx=ctx)
            finally:
                self._jobs.task_done()

    def submit(self, name: str, t0: int, event: Any, attrs: Optional[Dict[str, Any]]) -> bool:
        self._ensure_thread()
        try:
            self._jobs.put_nowait((name, t0, event, attrs, capture_context()))
            return True
        except queue.Full:
            self.dropped += 1
            return False

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait for queued observations (tests/exporters); True when done."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._jobs.unfinished_tasks == 0:
                return True
            time.sleep(0.002)
        return False


_ready_observer = _ReadyObserver()


def observe_ready(name: str, value: Any, **attrs: Any) -> Any:
    """Time device work WITHOUT blocking the caller: returns ``value`` at
    once. For a CUDA tensor (the first tensor in ``value``), a CUDA event is
    recorded on the caller's current stream of that tensor's device and a
    background observer waits on it, then records the enqueue-to-completion
    span. A CPU value's work is done when it is returned, so its span closes
    at once. No-op when tracing is off."""
    if not _flags.tracing:
        return value
    t0 = time.perf_counter_ns()
    tensor = _first_tensor(value)
    if tensor is None or tensor.device.type != "cuda":
        record_span(name, t0, time.perf_counter_ns(), attrs or None, ctx=capture_context())
        return value
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensor.device))
    _ready_observer.submit(name, t0, event, attrs or None)
    return value


def flush_ready_observations(timeout: float = 10.0) -> bool:
    """Wait for pending :func:`observe_ready` observations to land in the ring."""
    return _ready_observer.flush(timeout)
