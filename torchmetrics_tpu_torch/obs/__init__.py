"""torchmetrics_tpu_torch.obs: the runtime observability surface.

The JAX package's ``obs`` on PyTorch, with the same names, span names,
counter names and environment flags:

- **Span tracer** (``tracer``): :func:`span` wraps the runtime's hot seams
  (update, compute, reduce, sync, checkpoint save/restore, autosave ticks,
  async reads) with a ring-buffer event when ``TORCHMETRICS_TPU_TRACE`` is
  on, a flight record while telemetry is on, and a
  ``torch.profiler.record_function`` range while a profiler records.
  :func:`observe_ready` times device completion from a CUDA event without
  synchronising the caller's stream.
- **Counter/gauge registry** (``registry``): :func:`telemetry_snapshot`,
  :func:`counter_inc` / :func:`gauge_set` / :func:`histogram_observe`,
  :func:`breadcrumb` + :func:`dump_diagnostics` for the fault paths. Gated by
  ``TORCHMETRICS_TPU_TELEMETRY`` (default on).
- **Flight recorder** (``flight``): per-domain rings of recent span records
  and the flight blobs typed faults carry (``TORCHMETRICS_TPU_FLIGHT``,
  ``TORCHMETRICS_TPU_FLIGHT_BUFFER``, ``TORCHMETRICS_TPU_FLIGHT_DIR``).
- **Exporters** (``export``): Chrome trace-event JSON
  (:func:`write_chrome_trace`), Prometheus text (:func:`prometheus_text`) and
  a :class:`PeriodicExporter`, all writing through the atomic-IO primitive.
"""
from torchmetrics_tpu_torch.obs.flight import (  # noqa: F401
    DOMAIN_OF_SPAN,
    DOMAINS,
    FLIGHT_BUFFER_ENV,
    FLIGHT_DIR_ENV,
    FLIGHT_ENV,
    fault_breadcrumb,
    flighted,
    persist_flight,
    reset_flight,
    set_flight,
)
from torchmetrics_tpu_torch.obs.flight import blob as flight_blob  # noqa: F401
from torchmetrics_tpu_torch.obs.flight import enabled as flight_enabled  # noqa: F401
from torchmetrics_tpu_torch.obs.flight import note as flight_note  # noqa: F401
from torchmetrics_tpu_torch.obs.flight import snapshot as flight_snapshot  # noqa: F401
from torchmetrics_tpu_torch.obs.tracer import (  # noqa: F401
    SPAN_AUTOSAVE,
    SPAN_CACHE_LOAD,
    SPAN_CACHE_STORE,
    SPAN_CKPT_RESTORE,
    SPAN_CLASS_ROUTE,
    SPAN_CKPT_SAVE,
    SPAN_COMPILE,
    SPAN_COMPUTE,
    SPAN_COMPUTE_ASYNC,
    SPAN_DISPATCH,
    SPAN_EXPORT,
    SPAN_FLEET_MERGE,
    SPAN_FLEET_SHIP,
    SPAN_INTEGRITY,
    SPAN_KERNEL,
    SPAN_LANES,
    SPAN_NAMES,
    SPAN_PACK,
    SPAN_PAD,
    SPAN_QUARANTINE,
    SPAN_READ_RESOLVE,
    SPAN_REDUCE,
    SPAN_RESHARD,
    SPAN_SHADOW,
    SPAN_SYNC_GATHER,
    SPAN_UPDATE,
    SPAN_WARMUP,
    SPAN_WINDOWS,
    TELEMETRY_ENV,
    TRACE_BUFFER_ENV,
    TRACE_ENV,
    SpanEvent,
    TraceContext,
    capture_context,
    current_trace_id,
    device_span,
    drain_events,
    flush_ready_observations,
    observe_ready,
    peek_events,
    record_span,
    reset_ring,
    ring_stats,
    set_telemetry,
    set_tracing,
    span,
    telemetry_enabled,
    tracing_enabled,
    use_context,
)
from torchmetrics_tpu_torch.obs.registry import (  # noqa: F401
    AGE_BUCKETS_UPDATES,
    LATENCY_BUCKETS_US,
    breadcrumb,
    counter_inc,
    counters_snapshot,
    dump_diagnostics,
    gauge_set,
    histogram_observe,
    histograms_snapshot,
    register_executor,
    reset,
    telemetry_snapshot,
)
from torchmetrics_tpu_torch.obs.export import (  # noqa: F401
    PeriodicExporter,
    chrome_trace,
    prometheus_text,
    write_chrome_trace,
    write_prometheus,
)

__all__ = [
    "DOMAINS",
    "SPAN_NAMES",
    "SpanEvent",
    "TraceContext",
    "PeriodicExporter",
    "breadcrumb",
    "capture_context",
    "chrome_trace",
    "counter_inc",
    "counters_snapshot",
    "current_trace_id",
    "device_span",
    "drain_events",
    "dump_diagnostics",
    "fault_breadcrumb",
    "flight_blob",
    "flight_enabled",
    "flight_note",
    "flight_snapshot",
    "flighted",
    "flush_ready_observations",
    "gauge_set",
    "histogram_observe",
    "histograms_snapshot",
    "observe_ready",
    "peek_events",
    "persist_flight",
    "prometheus_text",
    "record_span",
    "register_executor",
    "reset",
    "reset_flight",
    "reset_ring",
    "ring_stats",
    "set_flight",
    "set_telemetry",
    "set_tracing",
    "span",
    "telemetry_enabled",
    "telemetry_snapshot",
    "tracing_enabled",
    "use_context",
    "write_chrome_trace",
    "write_prometheus",
]
