"""Pipelined lane ingest: the staging-slab ring behind the lane router.

The lane router (``lanes.py``) is the last host-bound stage of a laned
round: every round packs thousands of sessions' rows into one batch per
argument and uploads it before the round's update can run. This module
keeps that host work off the critical path:

- **Staging slabs** (:class:`StagingSlab`): per ``(bucket, arg layout)``
  preallocated host buffers reused round over round. On a machine with a
  card they are pinned (page-locked) tensors, so the upload is a true
  asynchronous copy. Router rows are written in place through a numpy view
  (no per-round stack allocation), the vectorised admission screen runs
  against the slab region directly (:func:`quarantine.screen_slab_leaf`),
  and the lane-id vector rides the same slab. Layout deviants (ragged rows,
  dtype drift, garbage) take the router's plain pack instead, so the slab
  path only ever serves the uniform round.

- **The slab ring** (:class:`SlabRing`): a bounded ring of slabs per layout.
  A ``non_blocking`` copy from pinned memory reads the host buffer when the
  stream reaches the copy, not when ``.to()`` returns, so a slab rewritten
  for round k+1 before round k's copy ran would corrupt round k silently. A
  slab checked out for round k is therefore handed out again only once its
  retire token, a CUDA event recorded on the caller's stream after round k's
  upload AND update were issued, reports done (``event.query()``). A round
  that cannot record that event (an exception mid-round, a rollback)
  :meth:`~SlabRing.discard`\\ s the slab instead of ever reusing it.

- **The pack pipeline** (:class:`IngestPipeline`): one bounded single-worker
  thread (the shape of ``ReadPipeline``) that screens and packs round k+1
  into the next slab while round k's upload and update are in flight. It
  does host work only: lane stamping and the upload stay on the caller's
  thread at dispatch time (:func:`stamp_and_upload`), so an admission or
  eviction between pack and dispatch can never route rows into a reassigned
  lane. Backpressure (full queue, busy ring, layout deviants) degrades to the
  router's inline pack: rounds are consumed strictly in order, so a round is
  never dropped or reordered.

The upload copies only the live rows ``[:rows]`` of each argument and of
the lane-id vector, one ``non_blocking`` copy each on the caller's current
stream; the bucket's padding rows are never uploaded. For a metric on the
CPU the "upload" is an explicit copy (:func:`device_put_aliases_host`), so
no state can alias a reused slab.

The JAX package's executor seam (``notify_dispatched``, which attached a
committed state leaf as the retire token) has no counterpart: laned
updates never run through the captured executor, and the router's
:class:`dispatch_scope` records the event itself after the round's update
was issued.

Flags, as in the JAX package: ``TORCHMETRICS_TPU_INGEST_PIPELINE`` (master
switch, default on; off, the router packs every round with a plain
``np.stack`` and a synchronous copy), ``TORCHMETRICS_TPU_INGEST_RING``
(slabs per layout, default 4) and ``TORCHMETRICS_TPU_INGEST_QUEUE`` (pack
queue depth, default 2). Counters: ``lanes.pipelined_rounds``,
``lanes.inline_packs``, ``lanes.h2d_bytes``; the ``lanes.pack_us``
histogram; worker faults go to the ``lanes`` flight domain.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch import obs
# the executor's bucket ladder: the router sizes its staging slabs by it, so
# rounds of neighbouring row counts share a slab
from torchmetrics_tpu_torch.ops.executor import bucket_size
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

__all__ = [
    "IngestPipeline",
    "PackResult",
    "PackTicket",
    "SlabRing",
    "SlabSpec",
    "StagingSlab",
    "bucket_size",
    "device_put_aliases_host",
    "dispatch_scope",
    "drain_pipeline",
    "get_pipeline",
    "get_ring",
    "pack_async",
    "pack_inline",
    "pipeline_enabled",
    "reset_for_tests",
    "stamp_and_upload",
]

#: pipeline master switch (the inline pack is the degraded mode, not a
#: different semantics: parity is the contract either way)
PIPELINE_ENV = "TORCHMETRICS_TPU_INGEST_PIPELINE"
#: slabs per (bucket, layout) ring entry; depth 1 still works (the worker's
#: acquire waits for retirement), depth >= 2 hides the wait
RING_DEPTH_ENV = "TORCHMETRICS_TPU_INGEST_RING"
DEFAULT_RING_DEPTH = 4
#: bounded pack-queue depth; a full queue degrades the submit to inline
QUEUE_ENV = "TORCHMETRICS_TPU_INGEST_QUEUE"
DEFAULT_QUEUE_MAXSIZE = 2
#: distinct (bucket, layout) ring entries kept before the least recently used
#: one is dropped (its in-flight slabs stay alive through their own references)
MAX_SPECS = 8


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() not in ("0", "false", "off", "no")


def pipeline_enabled() -> bool:
    """Whether the staged pack pipeline may engage (env master switch)."""
    return _env_on(PIPELINE_ENV, "1")


def _ring_depth() -> int:
    try:
        depth = int(os.environ.get(RING_DEPTH_ENV, "") or DEFAULT_RING_DEPTH)
    except ValueError:
        depth = DEFAULT_RING_DEPTH
    return max(1, depth)


def device_put_aliases_host() -> bool:
    """Whether an upload may alias the slab's host memory. Always False in
    the port: a CUDA target receives a copy (``non_blocking`` from pinned
    memory, retired by an event), and a CPU target an explicit clone, so a
    reused slab can never be read through a state or an input. (The JAX
    package probes its backend, which may upload without copying.)"""
    return False


# ------------------------------------------------------------------ the slab


class SlabSpec(NamedTuple):
    """The (bucket, per-arg layout) identity of one slab shape."""

    bucket: int
    leaves: Tuple[Tuple[Tuple[int, ...], str], ...]  # per-arg (row shape, dtype str)


class _SlabFallback(Exception):
    """Internal: the round deviates from the slab layout; the router must
    run its plain pack (the exact parity path)."""


def _torch_dtype(dtype: np.dtype) -> Optional[torch.dtype]:
    """The tensor dtype of a numpy dtype, or None when torch has none."""
    try:
        return torch.from_numpy(np.empty((0,), dtype=dtype)).dtype
    except TypeError:
        return None


def make_spec(batches: Sequence[Tuple[Any, ...]], bucket: int) -> Optional[SlabSpec]:
    """The round's slab layout from its first row; None when the round
    cannot take the slab path (un-arrayable leaves, non-numeric dtypes, a
    dtype torch has no tensor of). Per-row conformance is checked during
    the in-place write; this reads ONE row."""
    if not batches:
        return None
    leaves = []
    try:
        for leaf in batches[0]:
            arr = np.asarray(leaf)
            if arr.dtype.kind not in "fiub" or arr.dtype.hasobject or _torch_dtype(arr.dtype) is None:
                return None
            leaves.append((tuple(arr.shape), arr.dtype.str))
    except Exception as err:  # an un-arrayable first row: the plain pack owns it
        rank_zero_debug(f"ingest: round cannot take the slab path ({type(err).__name__}: {err})")
        return None
    return SlabSpec(int(bucket), tuple(leaves))


class StagingSlab:
    """One preallocated pack target: per-arg ``(bucket, *row)`` host tensors
    (pinned where a card is present) with numpy views the pack writes
    through, plus the lane-id vector riding the same object. Reused round
    over round; the ring hands it out only once its retire tokens report
    done."""

    __slots__ = ("spec", "tensors", "args", "lane_ids_t", "lane_ids", "tokens", "generation", "busy")

    def __init__(self, spec: SlabSpec, pin: Optional[bool] = None) -> None:
        pin = torch.cuda.is_available() if pin is None else pin
        self.spec = spec
        self.tensors: List[torch.Tensor] = [
            torch.zeros((spec.bucket,) + shape, dtype=_torch_dtype(np.dtype(dt)), pin_memory=pin)
            for shape, dt in spec.leaves
        ]
        #: numpy views the pack writes through (same memory as ``tensors``)
        self.args: List[np.ndarray] = [t.numpy() for t in self.tensors]
        self.lane_ids_t = torch.zeros((spec.bucket,), dtype=torch.int32, pin_memory=pin)
        self.lane_ids = self.lane_ids_t.numpy()
        #: CUDA events that must report done before the buffers may be reused
        self.tokens: Tuple[Any, ...] = ()
        #: bumped on every acquire: tests use it to prove reuse (not realloc)
        self.generation = 0
        #: checked out (being packed or awaiting dispatch): not reacquirable
        self.busy = False

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.args) + self.lane_ids.nbytes)


def _tokens_ready(tokens: Tuple[Any, ...]) -> bool:
    """Non-blocking retire check (the inline path's acquire gate)."""
    return all(t.query() for t in tokens)


def _wait_tokens(tokens: Tuple[Any, ...]) -> None:
    """WORKER-SIDE retire wait: block this thread until every token (the
    event recorded after the round that last used the slab) is done. A host
    wait on an event; the worker issues no device work."""
    for t in tokens:
        t.synchronize()


class SlabRing:
    """Bounded ring of :class:`StagingSlab` per layout, LRU across layouts."""

    def __init__(self, depth: Optional[int] = None) -> None:
        self._depth = depth if depth is not None else _ring_depth()
        self._lock = threading.Lock()
        self._slabs: Dict[SlabSpec, List[StagingSlab]] = {}
        self._cursor: Dict[SlabSpec, int] = {}
        self._touch: Dict[SlabSpec, int] = {}
        self._clock = 0
        self.stats: Dict[str, int] = {"allocated": 0, "reused": 0, "busy": 0, "discarded": 0}

    def _entry(self, spec: SlabSpec) -> List[StagingSlab]:
        slabs = self._slabs.get(spec)
        if slabs is None:
            if len(self._slabs) >= MAX_SPECS:
                oldest = min(self._touch, key=self._touch.get)
                del self._slabs[oldest], self._cursor[oldest], self._touch[oldest]
            slabs = []
            self._slabs[spec] = slabs
            self._cursor[spec] = 0
        self._clock += 1
        self._touch[spec] = self._clock
        return slabs

    def _try_acquire(self, spec: SlabSpec, allow_unretired: bool):
        """One locked pass: (slab, wait_tokens). A busy slab (checked out,
        still being packed or awaiting dispatch) is never handed out twice."""
        with self._lock:
            slabs = self._entry(spec)
            n = len(slabs)
            for i in range(n):
                slab = slabs[(self._cursor[spec] + i) % n]
                if slab.busy:
                    continue
                if not slab.tokens or _tokens_ready(slab.tokens):
                    self._cursor[spec] = (self._cursor[spec] + i + 1) % n
                    slab.busy = True
                    slab.tokens = ()
                    slab.generation += 1
                    self.stats["reused" if slab.generation > 1 else "allocated"] += 1
                    return slab, ()
            if n < self._depth:
                slab = StagingSlab(spec)
                slabs.append(slab)
                slab.busy = True
                slab.generation = 1
                self.stats["allocated"] += 1
                return slab, ()
            if not allow_unretired:
                return None, ()
            for i in range(n):  # oldest non-busy slab, unretired: the caller waits
                slab = slabs[(self._cursor[spec] + i) % n]
                if slab.busy:
                    continue
                self._cursor[spec] = (self._cursor[spec] + i + 1) % n
                tokens, slab.tokens = slab.tokens, ()
                slab.busy = True
                slab.generation += 1
                self.stats["reused"] += 1
                return slab, tokens
            return None, ()

    def acquire(self, spec: SlabSpec, block: bool, timeout: float = 30.0) -> Optional[StagingSlab]:
        """The next reusable slab for ``spec``. Non-blocking (``block=False``,
        the router's inline path): None when every slab is still in flight,
        and the caller degrades to the plain pack. Blocking (``block=True``,
        the pack WORKER only): waits for the oldest slab's retire tokens."""
        slab, tokens = self._try_acquire(spec, allow_unretired=block)
        if slab is not None:
            if tokens:
                _wait_tokens(tokens)  # outside the lock: the ring stays concurrent
            return slab
        if not block:
            self.stats["busy"] += 1
            return None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:  # every slab checked out: rare
            time.sleep(0.0005)
            slab, tokens = self._try_acquire(spec, allow_unretired=True)
            if slab is not None:
                if tokens:
                    _wait_tokens(tokens)
                return slab
        self.stats["busy"] += 1
        return None

    def commit(self, slab: StagingSlab, tokens: Tuple[Any, ...]) -> None:
        """Mark ``slab`` in flight behind ``tokens`` (checked at reacquire)."""
        slab.tokens = tuple(tokens)
        slab.busy = False

    def release(self, slab: StagingSlab) -> None:
        """Return an acquired slab unused (nothing was uploaded from it)."""
        slab.tokens = ()
        slab.busy = False

    def discard(self, slab: StagingSlab) -> None:
        """Drop a slab whose consumption cannot be proven (a fault path): it
        is never reused; an in-flight copy keeps its pinned memory alive
        through the caching host allocator, and the ring replaces it lazily."""
        slab.busy = False
        with self._lock:
            for spec, slabs in self._slabs.items():
                if slab in slabs:
                    slabs.remove(slab)
                    self._cursor[spec] = 0
                    break
        self.stats["discarded"] += 1


# ------------------------------------------------------------------ the pack


class PackResult(NamedTuple):
    """A filled slab: the pack product the router stamps lane ids into."""

    slab: StagingSlab
    reasons: Optional[List[Optional[str]]]  # screening verdicts (None = guard off)
    rows: int


def pack_into_slab(
    slab: StagingSlab,
    batches: Sequence[Tuple[Any, ...]],
    rows: int,
    screen: bool,
) -> PackResult:
    """Write ``rows`` per-session rows in place into ``slab`` and, when
    ``screen``, run the vectorised admission screen against the slab region
    directly. Any layout deviation (leaf count, shape, exact dtype) raises
    :class:`_SlabFallback`: the router then runs its plain pack, whose
    majority-vote screen is the single source of truth for mixed or
    malformed rounds."""
    from torchmetrics_tpu_torch.quarantine import screen_slab_leaf

    spec = slab.spec
    n_leaves = len(spec.leaves)
    reasons: Optional[List[Optional[str]]] = [None] * rows if screen else None
    try:
        if any(len(b) != n_leaves for b in batches):
            raise _SlabFallback()
        for leaf_idx in range(n_leaves):
            target = slab.args[leaf_idx]
            dtype = target.dtype
            arrs = [np.asarray(b[leaf_idx]) for b in batches]
            # exact-dtype conformance per row BEFORE the copy: np.stack's out=
            # would silently same-kind-cast (float64 rows narrowed into a
            # float32 slab), where the plain pack promotes the whole stack
            if not all(a.dtype == dtype for a in arrs):
                raise _SlabFallback()
            # one C-level copy straight into the slab region (raises on ragged
            # shapes, which fall back); no per-round stack allocation
            np.stack(arrs, axis=0, out=target[:rows])
    except _SlabFallback:
        raise
    except Exception as err:  # ragged or un-arrayable rows: the plain pack owns them
        rank_zero_debug(f"ingest: slab pack fell back ({type(err).__name__}: {err})")
        raise _SlabFallback() from err
    if screen:
        for leaf_idx in range(n_leaves):
            screen_slab_leaf(slab.args[leaf_idx], rows, leaf_idx, reasons)
    return PackResult(slab, reasons, rows)


class PackTicket:
    """Future for one staged pack. ``take()`` blocks for the worker's HOST
    work only, re-raises the pack's error exactly as the inline pack would
    have raised it, and returns None when the round fell back to the plain
    pack (or the worker did not answer in time)."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Optional[PackResult] = None
        self._error: Optional[BaseException] = None

    def _finish(self, value: Optional[PackResult], error: Optional[BaseException]) -> None:
        self._value = value
        self._error = error
        self._event.set()

    def take(self, timeout: Optional[float] = 60.0) -> Optional[PackResult]:
        if not self._event.wait(timeout):
            return None  # a wedged worker degrades to the inline pack
        if self._error is not None:
            raise self._error
        return self._value


class IngestPipeline:
    """One daemon worker + bounded queue packing round k+1 under round k.

    ``submit`` never blocks: a full queue returns None and the router packs
    inline (rounds are consumed in submission order either way, so no round
    is dropped or reordered). The worker reopens the submitter's trace
    context, so the pack span links back to the router's slice."""

    def __init__(self, maxsize: Optional[int] = None) -> None:
        if maxsize is None:
            try:
                maxsize = int(os.environ.get(QUEUE_ENV, "") or DEFAULT_QUEUE_MAXSIZE)
            except ValueError:
                maxsize = DEFAULT_QUEUE_MAXSIZE
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, maxsize))
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {"submitted": 0, "completed": 0, "fallbacks": 0, "errors": 0, "full": 0}

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="tm_tpu_ingest_pack", daemon=True)
                self._thread.start()

    def _run(self) -> None:
        while True:
            job, ticket, ctx = self._q.get()
            try:
                self._execute(job, ticket, ctx)
            finally:
                self._q.task_done()

    def _execute(self, job: Callable[[], Optional[PackResult]], ticket: PackTicket, ctx: Any) -> None:
        with obs.use_context(ctx):
            try:
                with obs.span(obs.SPAN_PACK, histogram="lanes.pack_us", staged=True):
                    value = job()
            except _SlabFallback:
                self.stats["fallbacks"] += 1
                ticket._finish(None, None)
                return
            except BaseException as err:
                # the router re-raises this exactly where the inline pack would
                # have raised; the flight ring keeps the worker-side window
                self.stats["errors"] += 1
                rank_zero_debug(f"ingest: staged pack failed ({type(err).__name__}: {err})")
                obs.flighted(err, domain="lanes")
                ticket._finish(None, err)
                return
        self.stats["completed"] += 1
        ticket._finish(value, None)

    def submit(self, job: Callable[[], Optional[PackResult]]) -> Optional[PackTicket]:
        ticket = PackTicket()
        ctx = obs.capture_context()
        try:
            self._q.put_nowait((job, ticket, ctx))
        except queue.Full:
            self.stats["full"] += 1
            return None
        self.stats["submitted"] += 1
        self._ensure_thread()
        return ticket

    def pending(self) -> int:
        return self._q.unfinished_tasks

    def drain(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.001)
        return True


# ------------------------------------------------------- process-wide plumbing

_PIPELINE: Optional[IngestPipeline] = None
_RING: Optional[SlabRing] = None
_GLOBAL_LOCK = threading.Lock()


def get_pipeline() -> IngestPipeline:
    global _PIPELINE
    with _GLOBAL_LOCK:
        if _PIPELINE is None:
            _PIPELINE = IngestPipeline()
        return _PIPELINE


def get_ring() -> SlabRing:
    global _RING
    with _GLOBAL_LOCK:
        if _RING is None:
            _RING = SlabRing()
        return _RING


def drain_pipeline(timeout: float = 60.0) -> bool:
    """Wait for in-flight packs (tests, shutdown flushes; no-op when idle)."""
    with _GLOBAL_LOCK:
        pipeline = _PIPELINE
    return True if pipeline is None else pipeline.drain(timeout)


def reset_for_tests() -> None:
    """Drop the process-wide pipeline and ring (tests only): in-flight slabs
    stay alive through their own references; the next round rebuilds both."""
    global _PIPELINE, _RING
    with _GLOBAL_LOCK:
        _PIPELINE = None
        _RING = None


# ------------------------------------------------------- router-facing surface


def pack_async(
    pipeline: IngestPipeline,
    ring: SlabRing,
    batches: Sequence[Tuple[Any, ...]],
    rows: int,
    bucket: int,
    screen: bool,
) -> Optional[PackTicket]:
    """Stage one round's pack on the worker; None when the round cannot take
    the slab path (layout) or the queue is full (backpressure: inline)."""
    spec = make_spec(batches, bucket)
    if spec is None:
        return None

    def job() -> Optional[PackResult]:
        slab = ring.acquire(spec, block=True)  # worker-side retire wait
        if slab is None:  # every slab checked out past the timeout: degrade
            raise _SlabFallback()
        try:
            return pack_into_slab(slab, batches, rows, screen)
        except BaseException:
            ring.release(slab)  # a partially written slab goes straight back
            raise

    # the enqueue half of the causal pair: the ambient context is captured
    # inside this span, so the worker-side pack span links back to it
    with obs.span(obs.SPAN_PACK, phase="enqueue"):
        return pipeline.submit(job)


def pack_inline(
    ring: SlabRing,
    batches: Sequence[Tuple[Any, ...]],
    rows: int,
    bucket: int,
    screen: bool,
) -> Optional[PackResult]:
    """The router-thread pack into a slab (the backpressure degradation and
    the single-round steady path). Never blocks: a busy ring or a layout
    deviant returns None and the caller runs the plain pack."""
    spec = make_spec(batches, bucket)
    if spec is None:
        return None
    slab = ring.acquire(spec, block=False)
    if slab is None:
        return None
    try:
        with obs.span(obs.SPAN_PACK, histogram="lanes.pack_us", staged=False):
            return pack_into_slab(slab, batches, rows, screen)
    except _SlabFallback:
        ring.release(slab)
        return None
    except BaseException:
        ring.release(slab)
        raise


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One host tensor on ``device``: a ``non_blocking`` copy on the current
    stream for a card, an explicit clone on the CPU (never an alias)."""
    if device.type == "cpu":
        return host.clone()
    return host.to(device, non_blocking=True)


def stamp_and_upload(
    packed: PackResult, lanes: Sequence[int], sentinel: int, device: torch.device
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Stamp the (possibly sentinel-diverted) lane ids into the slab's id
    vector, ALWAYS on the router thread at dispatch time, so an admission or
    eviction between pack and dispatch can never route rows into a
    reassigned lane; then upload the slab's live rows: one copy per argument
    plus the id vector, on the caller's current stream. Padding rows are
    never uploaded. The slab stays checked out until :class:`dispatch_scope`
    commits it behind its retire event."""
    slab = packed.slab
    rows = packed.rows
    slab.lane_ids[:rows] = list(lanes)
    slab.lane_ids[rows:] = np.int32(sentinel)
    with obs.span(obs.SPAN_PACK, histogram="lanes.upload_us", phase="upload", rows=rows):
        ids_dev = upload(slab.lane_ids_t[:rows], device)
        batch = tuple(upload(t[:rows], device) for t in slab.tensors)
    obs.counter_inc("lanes.h2d_bytes", int(sum(t[:rows].nbytes for t in slab.tensors) + rows * 4))
    return ids_dev, batch


class dispatch_scope:
    """Retires one round's slab. The router wraps the round's upload and
    update in ``with dispatch_scope(slab, ring, device):``; on a clean exit
    the slab goes back to the ring behind a CUDA event recorded on the
    current stream after the update was issued (no event on the CPU, whose
    work is done when the call returns). A round that raised cannot prove
    the slab was fully consumed, so the slab is discarded, never reused. A
    ``None`` slab (the plain pack) makes the scope a no-op."""

    __slots__ = ("_slab", "_ring", "_device")

    def __init__(self, slab: Optional[StagingSlab], ring: Optional[SlabRing] = None, device: Any = None) -> None:
        self._slab = slab
        self._ring = ring
        self._device = torch.device(device) if device is not None else torch.device("cpu")

    def __enter__(self) -> "dispatch_scope":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        slab = self._slab
        if slab is None:
            return
        ring = self._ring if self._ring is not None else get_ring()
        if exc_type is not None:
            ring.discard(slab)
            return
        tokens: Tuple[Any, ...] = ()
        if self._device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
            tokens = (event,)
        ring.commit(slab, tokens)
