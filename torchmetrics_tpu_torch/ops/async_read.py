"""Asynchronous reads: the pipeline behind ``compute_async()``.

A blocking ``compute()`` serialises the step loop on the compute's device
work and the device-to-host reads it makes. ``compute_async()`` moves that
tail off the loop:

- **``MetricFuture``**: what ``compute_async()`` returns, a thread-safe
  future resolving to exactly the value the matching blocking call would
  have produced from the state at submission time (or raising exactly the
  error it would have raised, ``on_sync_failure`` policies and
  :class:`~torchmetrics_tpu_torch.quarantine.DegradedValue` serving
  included). The resolved value is ready: the worker waited for its device
  work, so reading it costs no wait on the caller's streams.
- **``ReadPipeline``**: one daemon worker thread and a bounded queue running
  the blocking tail of every read. A full queue runs the job inline on the
  calling thread (counted, ``reads.inline_fallback``) rather than dropping
  it: a read produces a value someone waits on.

Consistency. The caller-side half snapshots the live state by reference:
the port's updates replace state tensors and never write into them, so the
references are a consistent snapshot for free while the step loop's next
update writes fresh tensors. Worker-side evaluation runs on a cached
detached clone of the metric, because a compute on the live object from
another thread would race every concurrent update.

Streams. In PyTorch, work issued from the worker thread runs on that
thread's current stream, the default one, while the caller may update on
another stream. So the submission records a CUDA event on the caller's
current stream (:func:`submission_event`), and the worker waits on that
event (:func:`wait_submitted`) before it reads the snapshot; the snapshot's
tensors stay referenced by the job until its reads are done, so the caching
allocator cannot hand their memory to the caller's stream early. The worker
waits for its own stream (:func:`materialize`) before the future resolves.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional

import torch

from torchmetrics_tpu_torch.obs.tracer import _first_tensor
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

__all__ = [
    "MetricFuture",
    "ReadPipeline",
    "drain_pipeline",
    "fetch_host",
    "get_pipeline",
    "materialize",
    "pending_reads",
    "submission_event",
    "wait_submitted",
]

#: bounded depth of the read queue; a full queue degrades the submitting call
#: to an inline (blocking) read instead of stalling or dropping
QUEUE_MAXSIZE_ENV = "TORCHMETRICS_TPU_READ_QUEUE"
DEFAULT_QUEUE_MAXSIZE = 256


class MetricFuture:
    """Handle to one in-flight asynchronous read.

    Resolves to exactly what the matching blocking call would have returned
    for the state at submission time, or raises exactly the error it would
    have raised (``result()`` re-raises it; ``exception()`` returns it).
    """

    def __init__(self, owner: str = "", submitted_count: Optional[int] = None) -> None:
        self.owner = owner
        #: the owner's committed update count at submission: the value this
        #: future resolves to reflects exactly this many updates
        self.submitted_count = submitted_count
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._callbacks: list = []
        self._lock = threading.Lock()

    def done(self) -> bool:
        """True once the read resolved (value or error); never blocks."""
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until resolved (or ``timeout`` seconds); True when done."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        """The read's value; blocks until resolved. Raises the read's error
        if it failed, or ``TimeoutError`` when ``timeout`` expires first."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"asynchronous read of {self.owner or 'metric'} did not resolve within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        """The error the read failed with (None on success); blocks like :meth:`result`."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"asynchronous read of {self.owner or 'metric'} did not resolve within {timeout}s")
        return self._error

    @property
    def degraded(self) -> bool:
        """True when the resolved value is a ``DegradedValue`` (False while pending)."""
        from torchmetrics_tpu_torch.quarantine import DegradedValue

        return self.done() and self._error is None and isinstance(self._value, DegradedValue)

    def add_done_callback(self, fn: Callable[["MetricFuture"], None]) -> None:
        """Run ``fn(future)`` when the read resolves (at once if it has).
        Callbacks run on the worker thread; their exceptions are logged and
        swallowed (a monitoring hook must not kill reads)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn: Callable[["MetricFuture"], None]) -> None:
        try:
            fn(self)
        except Exception as err:
            rank_zero_debug(f"MetricFuture done-callback failed: {type(err).__name__}: {err}")

    def _finish(self, value: Any, error: Optional[BaseException]) -> None:
        with self._lock:
            self._value = value
            self._error = error
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            self._run_callback(fn)

    def __repr__(self) -> str:
        state = "pending"
        if self.done():
            state = "error" if self._error is not None else ("degraded" if self.degraded else "done")
        return f"MetricFuture(owner={self.owner!r}, {state})"


# ---------------------------------------------------- stream-ordered waiting

def submission_event(value: Any) -> Optional[torch.cuda.Event]:
    """CALLER-SIDE: a CUDA event recorded on the caller's current stream of
    the first tensor in ``value`` (None when that is not a CUDA tensor). Every
    write the caller has enqueued into ``value`` precedes it."""
    tensor = _first_tensor(value)
    if tensor is None or tensor.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensor.device))
    return event


def wait_submitted(event: Optional[torch.cuda.Event]) -> None:
    """WORKER-SIDE: block this thread until the submitting stream reached
    ``event`` (nothing to wait for on the CPU)."""
    if event is not None:
        event.synchronize()


def materialize(value: Any) -> Any:
    """WORKER-SIDE ONLY: wait until the device work behind ``value`` is done.

    The worker's kernels run on its thread's current stream of the device
    ``value`` lives on; synchronising that stream makes reading any leaf a
    copy, not a wait. Returns ``value`` unchanged."""
    tensor = _first_tensor(value)
    if tensor is not None and tensor.device.type == "cuda":
        torch.cuda.current_stream(tensor.device).synchronize()
    return value


def fetch_host(value: torch.Tensor) -> Any:
    """WORKER-SIDE ONLY: one tensor's device-to-host copy, as numpy."""
    return value.detach().cpu().numpy()


# ---------------------------------------------------------------- the worker

class ReadPipeline:
    """One daemon thread + bounded queue draining asynchronous reads.

    ``submit`` never blocks on the queue: a full queue runs the job INLINE
    on the calling thread (counted), the documented back-pressure mode. Jobs
    run in submission order on a single worker, so a metric's read clone is
    used serially by construction."""

    def __init__(self, maxsize: Optional[int] = None) -> None:
        if maxsize is None:
            try:
                maxsize = int(os.environ.get(QUEUE_MAXSIZE_ENV, "") or DEFAULT_QUEUE_MAXSIZE)
            except ValueError:
                maxsize = DEFAULT_QUEUE_MAXSIZE
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, maxsize))
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {"submitted": 0, "completed": 0, "errors": 0, "degraded": 0, "inline": 0}
        #: ``perf_counter_ns`` when the worker last finished a job (0: never)
        self.last_done_ns = 0

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="tm_tpu_read_pipeline", daemon=True)
                self._thread.start()

    def _execute(self, job: Callable[[], Any], fut: MetricFuture, ctx: Any = None, t_submit_ns: int = 0) -> None:
        """Run one read job: the worker-side half of the causal trace. The
        submission-side trace context is reopened here, so the
        ``tm_tpu.read.resolve`` span (and every span the job opens) carries
        the submitter's trace id with a flow pair back to it. Queue wait and
        end-to-end latency land in the registry histograms (``t_submit_ns``
        is 0 when telemetry was off at submission)."""
        from torchmetrics_tpu_torch import obs
        from torchmetrics_tpu_torch.quarantine import DegradedValue

        if t_submit_ns:
            obs.histogram_observe("reads.queue_wait_us", (time.perf_counter_ns() - t_submit_ns) / 1e3)
        with obs.use_context(ctx):
            try:
                with obs.span(obs.SPAN_READ_RESOLVE, suffix=fut.owner or None):
                    value = job()
            except BaseException as err:  # the future carries it to result()
                self.stats["errors"] += 1
                obs.counter_inc("reads.async_errors")
                rank_zero_debug(f"async read of {fut.owner or 'metric'} failed: {type(err).__name__}: {err}")
                fut._finish(None, err)
                if t_submit_ns:
                    obs.histogram_observe("reads.e2e_latency_us", (time.perf_counter_ns() - t_submit_ns) / 1e3)
                return
        self.stats["completed"] += 1
        if isinstance(value, DegradedValue):
            self.stats["degraded"] += 1
            obs.counter_inc("reads.async_degraded")
            obs.histogram_observe("reads.staleness_age_updates", value.updates_behind)
        obs.counter_inc("reads.async_completed")
        fut._finish(value, None)
        if t_submit_ns:
            obs.histogram_observe("reads.e2e_latency_us", (time.perf_counter_ns() - t_submit_ns) / 1e3)

    def _run(self) -> None:
        from torchmetrics_tpu_torch import obs

        while True:
            job, fut, ctx, t_submit_ns = self._q.get()
            try:
                self._execute(job, fut, ctx, t_submit_ns)
            finally:
                self.last_done_ns = time.perf_counter_ns()  # before the drain can see the job done
                self._q.task_done()
                obs.gauge_set("reads.pending", self._q.unfinished_tasks)

    def submit(self, job: Callable[[], Any], owner: str = "", submitted_count: Optional[int] = None) -> MetricFuture:
        """Enqueue one read; returns its future at once. When the queue is
        full the job runs inline (blocking THIS call). The ambient trace
        context is captured here and reopened on the worker."""
        from torchmetrics_tpu_torch import obs

        fut = MetricFuture(owner=owner, submitted_count=submitted_count)
        ctx = obs.capture_context()
        t_submit_ns = time.perf_counter_ns() if obs.telemetry_enabled() else 0
        self.stats["submitted"] += 1
        obs.counter_inc("reads.async_submitted")
        try:
            self._q.put_nowait((job, fut, ctx, t_submit_ns))
        except queue.Full:
            self.stats["inline"] += 1
            obs.counter_inc("reads.inline_fallback")
            self._execute(job, fut, ctx, t_submit_ns)
            return fut
        obs.gauge_set("reads.pending", self._q.unfinished_tasks)
        self._ensure_thread()
        return fut

    def pending(self) -> int:
        return self._q.unfinished_tasks

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every submitted read resolved; True when the queue
        drained within ``timeout``."""
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True


_PIPELINE: Optional[ReadPipeline] = None
_PIPELINE_LOCK = threading.Lock()


def get_pipeline() -> ReadPipeline:
    """The process-wide read pipeline (created on first use; its thread
    starts with the first queued job)."""
    global _PIPELINE
    with _PIPELINE_LOCK:
        if _PIPELINE is None:
            _PIPELINE = ReadPipeline()
        return _PIPELINE


def drain_pipeline(timeout: float = 60.0) -> bool:
    """Wait for all in-flight asynchronous reads (True when none started)."""
    with _PIPELINE_LOCK:
        pipeline = _PIPELINE
    return True if pipeline is None else pipeline.drain(timeout)


def pending_reads() -> int:
    """Reads submitted but not yet resolved, process-wide."""
    with _PIPELINE_LOCK:
        pipeline = _PIPELINE
    return 0 if pipeline is None else pipeline.pending()


def last_read_done_ns() -> int:
    """``perf_counter_ns`` when the pipeline's worker last finished a read
    (0 when none has)."""
    with _PIPELINE_LOCK:
        pipeline = _PIPELINE
    return 0 if pipeline is None else pipeline.last_done_ns


# -------------------------------------------------- laned read serialisation

#: one RLock per LaneGuard (shared across a LanedCollection's members the way
#: the guard itself is): the read worker's scan-and-attribute step and the
#: lane router's guard and state mutations serialise on it. Held only around
#: host bookkeeping, never around a device wait. Keyed weakly, so a guard
#: stays picklable (a lock never rides a checkpoint).
_GUARD_LOCKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_GUARD_LOCKS_LOCK = threading.Lock()


def guard_lock(guard: Any) -> threading.RLock:
    """The (lazily created) RLock serialising reads and mutations for ``guard``."""
    with _GUARD_LOCKS_LOCK:
        lock = _GUARD_LOCKS.get(guard)
        if lock is None:
            lock = threading.RLock()
            _GUARD_LOCKS[guard] = lock
        return lock
