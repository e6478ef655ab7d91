"""Counter/gauge/histogram registry and diagnostics dump: the one stats surface.

- **Process-global counters/gauges** (:func:`counter_inc` / :func:`gauge_set`)
  for the seams: sync timeouts and degradations, rollbacks, checkpoint
  saves/restores, autosave ticks, async reads. Counters are monotonic;
  gauges are last-write-wins. The names are the JAX package's.
- **Executor aggregation**: every captured executor (``ops/executor.py``)
  registers with :func:`register_executor` at construction, so
  :func:`telemetry_snapshot` sums the live executors' stats into
  ``executor.*`` counters.
- **Async-read telemetry**: the read pipeline (``ops/async_read.py``) counts
  ``reads.async_submitted`` / ``reads.async_completed`` /
  ``reads.async_degraded`` / ``reads.async_errors`` / ``reads.inline_fallback``
  and keeps the ``reads.pending`` gauge at the current in-flight depth.
- **Lane and window telemetry**: the session lanes (``lanes.py``) count
  ``lanes.*`` (dispatches, rows, admissions, ``rows_looped``, ...); the
  streaming windows (``windows.py``) count ``windows.advanced``,
  ``windows.late_events`` and ``windows.dropped_late`` and observe the
  histograms ``windows.advance_us`` (the ``tm_tpu.windows.advance`` span)
  and ``windows.lateness_us``; a dropped late event leaves a
  ``window_late_drop`` breadcrumb in the ``windows`` flight domain.
- **Breadcrumbs** (:func:`breadcrumb`): a bounded trail of fault-path
  records that :func:`dump_diagnostics` surfaces.

Everything respects the master switch (``TORCHMETRICS_TPU_TELEMETRY=0`` makes
:func:`counter_inc`/:func:`breadcrumb` no-ops); snapshot/dump always work so a
disabled process can still report "telemetry was off". Every duration key
ends in ``_us`` (microseconds).
"""
from __future__ import annotations

import bisect
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torchmetrics_tpu_torch.obs import flight as _flight
from torchmetrics_tpu_torch.obs import tracer as _tracer

_BREADCRUMB_CAP = 256

#: re-entrant: a preemption handler (io/checkpoint.py) runs on the main thread
#: between bytecodes, possibly while that thread holds this lock, and counts
_lock = threading.RLock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_breadcrumbs: List[Dict[str, Any]] = []
_histograms: Dict[str, "_Histogram"] = {}
#: executors register here at construction; weak so
#: a dropped metric releases its executor and its stats leave the global view
_executors: "weakref.WeakSet" = weakref.WeakSet()


# ---------------------------------------------------------------- histograms
#: default bucket ladder for host-side latency instruments, in MICROSECONDS —
#: spans two clock ticks through multi-second stalls (the JAX package's table)
LATENCY_BUCKETS_US: Tuple[float, ...] = (
    50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10_000.0, 25_000.0,
    50_000.0, 100_000.0, 250_000.0, 500_000.0, 1_000_000.0, 5_000_000.0,
)
#: default bucket ladder for staleness-age instruments, in COMMITTED UPDATES —
#: powers of two matching the shadow/lane cadence knobs (every_n_steps,
#: breaker windows) so "how stale was the degraded value" reads off directly
AGE_BUCKETS_UPDATES: Tuple[float, ...] = (
    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 1024.0,
)


class _Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics: bucket ``i``
    counts observations ``<= buckets[i]``, one overflow slot for +Inf, plus
    running sum/count). Mutated under the registry lock."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]) -> None:
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(b):
            raise ValueError(f"histogram buckets must be non-empty and ascending, got {b}")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # last slot: > buckets[-1] (+Inf)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1


def default_buckets(name: str) -> Tuple[float, ...]:
    """Bucket table for a histogram created without an explicit one: ``_us``
    names get the latency ladder, staleness-age names (``updates``/``age``/
    ``behind``) the power-of-two update ladder."""
    if name.endswith("_us"):
        return LATENCY_BUCKETS_US
    if any(tok in name for tok in ("updates", "age", "behind")):
        return AGE_BUCKETS_UPDATES
    return LATENCY_BUCKETS_US


def histogram_observe(name: str, value: float, buckets: Optional[Sequence[float]] = None) -> None:
    """Record one observation into the named fixed-bucket histogram (created
    on first observation; ``buckets`` overrides :func:`default_buckets` then).
    No-op when telemetry is off. Histograms replace last-value gauges for
    anything distributional — read latency, queue wait, staleness age —
    because a gauge scraped every 15s hides everything between scrapes."""
    if not _tracer.telemetry_enabled():
        return
    with _lock:
        hist = _histograms.get(name)
        if hist is None:
            hist = _Histogram(buckets if buckets is not None else default_buckets(name))
            _histograms[name] = hist
        hist.observe(float(value))


def histograms_snapshot() -> Dict[str, Dict[str, Any]]:
    """Every histogram as ``{"buckets", "counts", "sum", "count"}`` (counts
    are per-bucket, NOT cumulative; the Prometheus exporter cumulates)."""
    with _lock:
        return {
            name: {
                "buckets": list(h.buckets),
                "counts": list(h.counts),
                "sum": h.sum,
                "count": h.count,
            }
            for name, h in _histograms.items()
        }


def counter_inc(name: str, value: float = 1) -> None:
    """Bump a monotonic process-global counter (no-op when telemetry is off).

    ``value`` must be >= 0 — counters only move forward; use a gauge for
    anything that can fall.
    """
    if not _tracer.telemetry_enabled():
        return
    if value < 0:
        raise ValueError(f"counter {name!r} increment must be >= 0, got {value}")
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def gauge_set(name: str, value: float) -> None:
    """Set a last-write-wins gauge (no-op when telemetry is off)."""
    if not _tracer.telemetry_enabled():
        return
    with _lock:
        _gauges[name] = value


def breadcrumb(kind: str, data: Optional[Dict[str, Any]] = None) -> None:
    """Append a fault-path record to the bounded diagnostic trail.

    The stall watchdog, disk-cache evictions, sync degradations, and autosave
    failures all route through here; :func:`dump_diagnostics` returns the
    trail newest-last. Bounded at 256 entries — a crash loop cannot grow it
    without bound."""
    if not _tracer.telemetry_enabled():
        return
    entry = {"time_unix": time.time(), "kind": kind, "data": data or {}}
    with _lock:
        _breadcrumbs.append(entry)
        if len(_breadcrumbs) > _BREADCRUMB_CAP:
            del _breadcrumbs[: len(_breadcrumbs) - _BREADCRUMB_CAP]


def register_executor(executor: Any) -> None:
    """The seam an executor registers with at construction: adds it to the
    weak aggregation set. Never raises: observability must not break
    dispatch."""
    try:
        _executors.add(executor)
    except TypeError:  # unweakrefable test double: stats just stay local to it
        pass


def _aggregate_executor_stats() -> Dict[str, float]:
    """Sum numeric stats across live executors into ``executor.<stat>`` keys.

    Reads racing concurrent increments see values at most one step stale —
    fine for monotonic counters; no lock is taken on the executors' side."""
    agg: Dict[str, float] = {}
    instances = 0
    for ex in list(_executors):
        stats = getattr(ex, "stats", None)
        if not isinstance(stats, dict):
            continue
        instances += 1
        for k, v in stats.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                agg[f"executor.{k}"] = agg.get(f"executor.{k}", 0) + v
    if instances:
        agg["executor.instances"] = instances
    return agg


def reset(
    counters: bool = True,
    gauges: bool = True,
    breadcrumbs: bool = True,
    histograms: bool = True,
) -> None:
    """Zero the global registry (tests/bench isolation). Executor-local stats
    are owned by their instances and are NOT touched."""
    with _lock:
        if counters:
            _counters.clear()
        if gauges:
            _gauges.clear()
        if breadcrumbs:
            del _breadcrumbs[:]
        if histograms:
            _histograms.clear()


def counters_snapshot() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def telemetry_snapshot(obj: Any = None) -> Dict[str, Any]:
    """The unified stats surface.

    ``telemetry_snapshot()`` — process-global: explicit counters, gauges,
    the ``executor.*`` aggregate summed over every live executor, and span
    ring occupancy. ``telemetry_snapshot(metric_or_collection)`` — one
    instance: its ``executor_status`` flattened into the same ``counters``
    shape (``executor.calls``, ``executor.disk_hits``, …) plus the
    deferred-reduction observables, so dashboards read one schema whether
    they watch a process or a metric.

    Counters are monotonic over the life of the process (or instance); take
    two snapshots and subtract for a per-interval view.
    """
    if obj is not None:
        status = obj.executor_status
        stats = status.get("stats", {})
        counters = {
            f"executor.{k}": v
            for k, v in stats.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        return {
            "scope": type(obj).__name__,
            "counters": counters,
            "enabled": status.get("enabled"),
            "engaged": status.get("engaged"),
            "fallback_reason": status.get("fallback_reason"),
            "deferred_pending": status.get("deferred_pending"),
            "last_reduce_us": status.get("last_reduce_us"),
            "telemetry_enabled": _tracer.telemetry_enabled(),
        }
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
    counters.update(_aggregate_executor_stats())
    return {
        "scope": "process",
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms_snapshot(),
        "spans": _tracer.ring_stats(),
        "telemetry_enabled": _tracer.telemetry_enabled(),
    }


def dump_diagnostics(obj: Any = None) -> Dict[str, Any]:
    """Everything an operator needs in one dict: the telemetry snapshot, the
    breadcrumb trail (newest last), the flight rings, the resolved
    ``TORCHMETRICS_TPU_*`` environment, and toolchain versions (torch, its
    CUDA, and the card's name where there is one). Always works, even with
    telemetry off: it then reports that fact."""
    import torch

    env = {k: v for k, v in sorted(os.environ.items()) if k.startswith("TORCHMETRICS_TPU_")}
    with _lock:
        crumbs = list(_breadcrumbs)
    versions: Dict[str, Any] = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
    }
    try:
        from torchmetrics_tpu_torch import __version__ as _pkg_version

        versions["torchmetrics_tpu_torch"] = _pkg_version
    except (ImportError, AttributeError):
        versions["torchmetrics_tpu_torch"] = None
    out = {
        "time_unix": time.time(),
        "telemetry": telemetry_snapshot(obj),
        "breadcrumbs": crumbs,
        "flight": _flight.snapshot(),
        "env": env,
        "versions": versions,
    }
    # laned objects (LanedMetric, LanedCollection) carry a per-session fault,
    # quarantine and staleness table: a stalled-session report is one call
    quarantine_table = getattr(obj, "quarantine_table", None)
    if callable(quarantine_table):
        try:
            out["lane_quarantine"] = quarantine_table()
        except Exception as err:  # diagnostics must not raise past a broken probe
            from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

            rank_zero_debug(f"dump_diagnostics: quarantine_table probe failed ({err})")
            out["lane_quarantine"] = {"error": f"{type(err).__name__}: {err}"}
    return out


# spans constructed with ``histogram=`` feed their duration through this hook;
# installed here (not imported by the tracer) to keep tracer -> registry
# dependency-free while the obs package always wires it at import
_tracer._HISTOGRAM_SINK = histogram_observe
