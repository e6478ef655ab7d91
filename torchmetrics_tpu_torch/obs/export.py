"""Telemetry exporters: Chrome trace JSON, Prometheus text, periodic sink.

All exporters run off the hot path: they drain (or snapshot) the span ring
and the counter registry on demand, format outside any lock, and write
through ``io.checkpoint.atomic_write_bytes``, so a preempted export never
leaves a torn file for a scraper to half-parse. The formats are the JAX
package's, event for event and line for line.

- :func:`chrome_trace` / :func:`write_chrome_trace`: trace-event JSON
  (``ph: "X"`` complete events, ``ph: "s"``/``"f"`` flow pairs) loadable in
  Perfetto or ``chrome://tracing``; span attrs land in ``args``.
- :func:`prometheus_text` / :func:`write_prometheus`: text exposition
  (``tm_tpu_*`` families, ``# HELP`` and ``# TYPE`` on every family).
- :class:`PeriodicExporter`: a daemon thread emitting one structured
  snapshot per interval to a callback (default: a debug log line) and
  optionally an atomically replaced JSON file.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from torchmetrics_tpu_torch.obs import registry as _registry
from torchmetrics_tpu_torch.obs import tracer as _tracer
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_warn


# ----------------------------------------------------------- chrome trace
def chrome_trace(
    events: Optional[Sequence[_tracer.SpanEvent]] = None, drain: bool = False
) -> Dict[str, Any]:
    """Buffered spans as a Chrome trace-event JSON object.

    ``drain=True`` removes the events from the ring (the post-run export);
    default peeks without clearing. Timestamps are microseconds on the
    process-local monotonic clock — relative placement is exact, absolute
    wall time is carried once in ``metadata``.
    """
    with _tracer.span(_tracer.SPAN_EXPORT, fmt="chrome_trace"):
        if events is None:
            events = _tracer.drain_events() if drain else _tracer.peek_events()
        trace_events: List[Dict[str, Any]] = []
        pid = os.getpid()
        for ev in events:
            entry: Dict[str, Any] = {
                "name": ev.name,
                "cat": "tm_tpu",
                "ph": "X",
                "ts": ev.t_start_ns / 1e3,
                "dur": max(0.0, (ev.t_end_ns - ev.t_start_ns) / 1e3),
                "pid": pid,
                "tid": ev.tid,
            }
            args = dict(ev.attrs) if ev.attrs else {}
            if ev.trace_id:
                args["trace_id"] = ev.trace_id
                args["span_id"] = ev.span_id
                if ev.parent_id:
                    args["parent_id"] = ev.parent_id
            if args:
                entry["args"] = args
            trace_events.append(entry)
            # a span opened under a reopened TraceContext carries its flow
            # source: emit the Perfetto flow-event pair (ph "s" inside the
            # submitting slice on the submitting thread, ph "f" binding to
            # the worker-side slice) so submit -> worker replay renders as an
            # arrow across thread lanes
            if ev.flow_src:
                src_span, src_tid, src_t_ns = ev.flow_src
                flow_id = ev.span_id or src_span
                flow_args = {"trace_id": ev.trace_id, "from_span": src_span, "to_span": ev.span_id}
                trace_events.append(
                    {
                        "name": "tm_tpu.flow", "cat": "tm_tpu", "ph": "s",
                        "id": flow_id, "ts": src_t_ns / 1e3, "pid": pid,
                        "tid": src_tid, "args": flow_args,
                    }
                )
                trace_events.append(
                    {
                        "name": "tm_tpu.flow", "cat": "tm_tpu", "ph": "f", "bp": "e",
                        "id": flow_id, "ts": ev.t_start_ns / 1e3, "pid": pid,
                        "tid": ev.tid, "args": flow_args,
                    }
                )
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "metadata": {
                "producer": "torchmetrics_tpu_torch.obs",
                "clock": "perf_counter_ns/1e3 (us, monotonic)",
                "exported_unix": time.time(),
            },
        }


def write_chrome_trace(path: str, drain: bool = True) -> str:
    """Atomically write :func:`chrome_trace` JSON at ``path`` (drains the
    ring by default — the end-of-run export). Returns ``path``."""
    from torchmetrics_tpu_torch.io.checkpoint import atomic_write_bytes

    payload = json.dumps(chrome_trace(drain=drain)).encode("utf-8")
    atomic_write_bytes(path, payload)
    return path


# ------------------------------------------------------------- prometheus
def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    return "".join(out)


#: curated # HELP text for the high-traffic series; everything else gets a
#: generated line pointing at the glossary (strict scrapers require HELP and
#: TYPE for EVERY family — bare samples are rejected)
_HELP_TEXT = {
    "reads_e2e_latency_us": "end-to-end async read latency, submit to future resolution (microseconds)",
    "reads_queue_wait_us": "async read queue wait, submit to worker pickup (microseconds)",
    "reads_staleness_age_updates": "staleness of served DegradedValue reads, in committed updates behind",
    "shards_shadow_staleness_updates": "shard-shadow staleness at serve/refresh points, in committed updates",
    "executor_dispatch_us": "host-side compiled dispatch (enqueue) duration (microseconds)",
    "lanes_dispatch_us": "laned multi-session dispatch duration, pack+scatter (microseconds)",
}


def _help_line(metric: str, base: str, kind: str) -> str:
    text = _HELP_TEXT.get(base, f"torchmetrics_tpu {kind} {base} (docs/OBSERVABILITY.md)")
    return f"# HELP {metric} {text}"


def _format_le(value: float) -> str:
    return str(int(value)) if float(value).is_integer() else repr(float(value))


def prometheus_text(snapshot: Optional[Dict[str, Any]] = None) -> str:
    """The counter/gauge/histogram registry in Prometheus text exposition.

    Counters render as ``tm_tpu_<name>_total`` with ``# HELP``/``# TYPE …
    counter``; gauges as ``tm_tpu_<name>``; histograms as the standard
    ``_bucket{le=…}``/``_sum``/``_count`` triple under ``# TYPE … histogram``
    with cumulative bucket counts and a closing ``+Inf`` bucket. Every series
    carries both HELP and TYPE — strict scrapers reject bare samples. Dots in
    registry names become underscores. ``snapshot`` defaults to a fresh
    :func:`~torchmetrics_tpu_torch.obs.telemetry_snapshot`.
    """
    with _tracer.span(_tracer.SPAN_EXPORT, fmt="prometheus"):
        if snapshot is None:
            snapshot = _registry.telemetry_snapshot()
        lines: List[str] = []
        for name, value in sorted(snapshot.get("counters", {}).items()):
            base = _sanitize(name)
            metric = f"tm_tpu_{base}_total"
            lines.append(_help_line(metric, base, "counter"))
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {value}")
        for name, value in sorted(snapshot.get("gauges", {}).items()):
            base = _sanitize(name)
            metric = f"tm_tpu_{base}"
            lines.append(_help_line(metric, base, "gauge"))
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {value}")
        for name, hist in sorted(snapshot.get("histograms", {}).items()):
            base = _sanitize(name)
            metric = f"tm_tpu_{base}"
            lines.append(_help_line(metric, base, "histogram"))
            lines.append(f"# TYPE {metric} histogram")
            cumulative = 0
            for le, count in zip(hist["buckets"], hist["counts"]):
                cumulative += count
                lines.append(f'{metric}_bucket{{le="{_format_le(le)}"}} {cumulative}')
            cumulative += hist["counts"][-1]
            lines.append(f'{metric}_bucket{{le="+Inf"}} {cumulative}')
            lines.append(f"{metric}_sum {hist['sum']}")
            lines.append(f"{metric}_count {hist['count']}")
        spans = snapshot.get("spans") or {}
        for key in ("buffered", "recorded_total", "dropped_total"):
            if key in spans:
                metric = f"tm_tpu_spans_{key}"
                kind = "gauge" if key == "buffered" else "counter"
                lines.append(_help_line(metric, f"spans_{key}", kind))
                lines.append(f"# TYPE {metric} {kind}")
                lines.append(f"{metric} {spans[key]}")
        return "\n".join(lines) + "\n"


def write_prometheus(path: str) -> str:
    """Atomically write :func:`prometheus_text` at ``path`` (node-exporter
    textfile-collector style). Returns ``path``."""
    from torchmetrics_tpu_torch.io.checkpoint import atomic_write_bytes

    atomic_write_bytes(path, prometheus_text().encode("utf-8"))
    return path


# ---------------------------------------------------------- periodic sink
class PeriodicExporter:
    """Structured-log telemetry sink on a daemon thread.

    Every ``interval_s`` the exporter builds one record —
    ``{"time_unix", "telemetry", "span_count"}`` (spans optionally drained so
    the ring never wraps between ticks) — and hands it to ``sink`` (default:
    one debug-log JSON line). ``json_path`` additionally atomically replaces
    a snapshot file each tick, a cheap always-current scrape target.

    The thread is daemon (cannot wedge interpreter exit), a failing sink is
    counted and logged but never raises into the loop, and ``stop()`` joins
    with a bounded wait. Export work shares the ring-drain discipline of the
    other exporters: the recording hot path is never blocked.
    """

    def __init__(
        self,
        interval_s: float = 10.0,
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        json_path: Optional[str] = None,
        drain_spans: bool = True,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = interval_s
        self.sink = sink
        self.json_path = json_path
        self.drain_spans = drain_spans
        self.stats: Dict[str, Any] = {"ticks": 0, "sink_errors": 0, "last_error": None}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _emit(self) -> None:
        record: Dict[str, Any] = {
            "time_unix": time.time(),
            "telemetry": _registry.telemetry_snapshot(),
        }
        if self.drain_spans:
            events = _tracer.drain_events()
            record["span_count"] = len(events)
            by_name: Dict[str, int] = {}
            for ev in events:
                by_name[ev.name] = by_name.get(ev.name, 0) + 1
            record["spans_by_name"] = by_name
        try:
            if self.sink is not None:
                self.sink(record)
            else:
                rank_zero_debug(f"tm_tpu telemetry: {json.dumps(record, default=str)}")
            if self.json_path is not None:
                from torchmetrics_tpu_torch.io.checkpoint import atomic_write_bytes

                atomic_write_bytes(
                    self.json_path, json.dumps(record, default=str).encode("utf-8")
                )
        except Exception as err:  # the sink must never take the process down
            self.stats["sink_errors"] += 1
            self.stats["last_error"] = f"{type(err).__name__}: {err}"
            rank_zero_warn(f"tm_tpu telemetry sink failed: {type(err).__name__}: {err}")
        self.stats["ticks"] += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._emit()

    def start(self) -> "PeriodicExporter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="tm_tpu_obs_export", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, final_emit: bool = True, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if final_emit:
            self._emit()
