"""Fault flight recorder: the always-on black box behind every typed fault.

The span ring (``obs/tracer.py``) is opt-in (``TORCHMETRICS_TPU_TRACE=1``),
so on its own a fault's breadcrumb would capture only *what* broke, never the
seconds of history before it. This module keeps that history:

- **Per-domain rings, always on** (with telemetry; ``TORCHMETRICS_TPU_FLIGHT``
  opts out): every :func:`~torchmetrics_tpu_torch.obs.tracer.span` on a hot
  seam lands a compact record (name, duration, trace id, thread, error) in its
  domain's bounded deque, newest-wins, ``TORCHMETRICS_TPU_FLIGHT_BUFFER``
  records per domain (default 64). Recording is a ``deque(maxlen=N)``
  append under the GIL, with no lock. Kernel-seam decisions
  (``ops/kernels.py``) ride the ``kernels`` domain via :func:`note`.
- **Flight blobs on fault paths**: :func:`flighted` wraps a typed error at
  its raise site (``raise flighted(CheckpointCorruptionError(...),
  domain="checkpoint")``), recording a breadcrumb whose ``flight`` blob
  carries the domain's recent records plus the counter deltas since the
  previous blob (:func:`blob`). :func:`fault_breadcrumb` is the same surface
  for faults that degrade instead of raising (degraded syncs, failed
  autosaves).
- **Persistence on fatal paths**: :func:`persist_flight` writes the full
  snapshot through ``io.checkpoint.atomic_write_bytes``.

The domains and the span-to-domain map are the JAX package's, verbatim.
Nothing in here may raise into a fault path, and nothing here imports the
tracer or the registry at module scope (the tracer imports THIS module for
the span-to-domain map; registry access is lazy, on the cold blob path).
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

#: opt-out switch for the flight recorder (default ON alongside telemetry);
#: span timing for flight records is skipped entirely when off
FLIGHT_ENV = "TORCHMETRICS_TPU_FLIGHT"
#: per-domain ring capacity in records (default 64; newest records win)
FLIGHT_BUFFER_ENV = "TORCHMETRICS_TPU_FLIGHT_BUFFER"
#: directory fatal-path flight dumps land in (default: the system temp dir)
FLIGHT_DIR_ENV = "TORCHMETRICS_TPU_FLIGHT_DIR"

_DEFAULT_CAPACITY = 64
#: most records a single breadcrumb blob carries per domain (the breadcrumb
#: trail is bounded at 256 entries; blobs must not blow its memory bound)
_BLOB_MAX_EVENTS = 32

#: the async/fault domains, one ring each (the JAX package's; the port
#: records into read, autosave, dispatch, sync, lanes, checkpoint and kernels)
DOMAINS = (
    "read",        # async read pipeline: submit halves + worker resolution
    "compile",     # foreground/background compile, disk-cache load/store, warmup
    "autosave",    # Autosaver ticks + their background writes
    "shadow",      # shard-shadow refresh + shard-loss recovery
    "dispatch",    # compiled executor dispatch + bucket padding
    "sync",        # deferred reduce, in-trace sync, bounded multi-host gather
    "lanes",       # laned dispatch + quarantine containment
    "checkpoint",  # snapshot save/restore/validate
    "reshard",     # elastic N->M re-splits
    "kernels",     # backend gate decisions (ops/kernels.py)
    "fleet",       # cross-process delta uplinks: ship/merge/failover (fleet/)
    "windows",     # streaming window ring: advance, late-event routing, drops
    "integrity",   # state-integrity audits: fingerprint chain, replica drift, mirror/restore verify
)

#: canonical span name -> flight domain (consumed by obs/tracer.span on exit;
#: names absent here — e.g. tm_tpu.export — deliberately leave no flight
#: record). Kept in flight.py so the tracer stays importable without obs.
DOMAIN_OF_SPAN = {
    "tm_tpu.dispatch": "dispatch",
    "tm_tpu.update": "dispatch",
    "tm_tpu.compute": "dispatch",
    "tm_tpu.pad": "dispatch",
    "tm_tpu.reduce": "sync",
    "tm_tpu.sync.gather": "sync",
    "tm_tpu.compile": "compile",
    "tm_tpu.cache.load": "compile",
    "tm_tpu.cache.store": "compile",
    "tm_tpu.warmup": "compile",
    "tm_tpu.checkpoint.save": "checkpoint",
    "tm_tpu.checkpoint.restore": "checkpoint",
    "tm_tpu.autosave": "autosave",
    "tm_tpu.lanes.dispatch": "lanes",
    "tm_tpu.lanes.quarantine": "lanes",
    "tm_tpu.lanes.pack": "lanes",
    "tm_tpu.compute_async": "read",
    "tm_tpu.read.resolve": "read",
    "tm_tpu.reshard": "reshard",
    "tm_tpu.class_route": "reshard",
    "tm_tpu.shadow.refresh": "shadow",
    "tm_tpu.kernel": "kernels",
    "tm_tpu.fleet.ship": "fleet",
    "tm_tpu.fleet.merge": "fleet",
    "tm_tpu.windows.advance": "windows",
    "tm_tpu.integrity.audit": "integrity",
}


def _env_on(name: str, default: str) -> bool:
    return os.environ.get(name, default).strip().lower() not in ("0", "false", "off", "no")


def _capacity() -> int:
    raw = os.environ.get(FLIGHT_BUFFER_ENV, "").strip()
    if not raw:
        return _DEFAULT_CAPACITY
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{FLIGHT_BUFFER_ENV} must be an integer record count, got {raw!r}")
    return value if value > 0 else _DEFAULT_CAPACITY


#: module-level fast flag the tracer reads per span exit (refresh() re-reads env)
_enabled = _env_on(FLIGHT_ENV, "1")

#: one bounded deque per domain; deque.append is atomic under the GIL, so the
#: recording hot path takes no lock (snapshots copy via list(), which is also
#: atomic enough for diagnostics — a racing append costs at most one record)
_rings: Dict[str, Deque[Tuple[float, str, Optional[float], int, int, Optional[str]]]] = {
    d: collections.deque(maxlen=_capacity()) for d in DOMAINS
}

#: counter anchor for windowed deltas: blob() diffs the live counters against
#: the snapshot taken at the PREVIOUS blob (per process, any domain) — the
#: "faulting window" is everything since the last time someone cut a blob
_anchor_lock = threading.Lock()
_counter_anchor: Dict[str, float] = {}


def enabled() -> bool:
    """Whether flight records are being kept (telemetry master AND
    ``TORCHMETRICS_TPU_FLIGHT``)."""
    return _enabled


def set_flight(on: Optional[bool]) -> None:
    """Override the flight-recorder switch (None restores the env default)."""
    global _enabled
    _enabled = _env_on(FLIGHT_ENV, "1") if on is None else bool(on)


def reset_flight(capacity: Optional[int] = None) -> None:
    """Clear every domain ring (tests / capacity changes) and the counter
    anchor; records are lost."""
    global _rings
    cap = capacity if capacity is not None else _capacity()
    _rings = {d: collections.deque(maxlen=max(1, int(cap))) for d in DOMAINS}
    with _anchor_lock:
        _counter_anchor.clear()


def record(
    domain: str,
    name: str,
    duration_us: Optional[float] = None,
    trace_id: int = 0,
    error: Optional[str] = None,
) -> None:
    """Append one record to ``domain``'s ring (the tracer's span-exit feed;
    lock-free, bounded, newest-wins). Unknown domains are dropped — the
    recorder must never raise into a hot seam."""
    ring = _rings.get(domain)
    if ring is not None:
        ring.append(
            (time.time(), name, duration_us, threading.get_ident(), int(trace_id), error)
        )


#: the tracer module, bound at the first note (a module cycle forbids it at import)
_tracer: Any = None


def note(domain: str, name: str, **attrs: Any) -> None:
    """Event-style record with attributes folded into the name — the
    kernel-seam feed (``note("kernels", "bincount", path="cuda", ...)``) and
    any other non-span decision worth replaying after a fault."""
    global _tracer
    if not _enabled:
        return
    if _tracer is None:
        from torchmetrics_tpu_torch.obs import tracer  # lazy: the tracer imports this module

        _tracer = tracer
    if not _tracer.telemetry_enabled():
        return
    detail = ",".join(f"{k}={v}" for k, v in attrs.items())
    record(domain, f"{name}[{detail}]" if detail else name)


def _record_dicts(ring: Deque, limit: int) -> List[Dict[str, Any]]:
    out = []
    for t_unix, name, dur, tid, trace_id, error in list(ring)[-limit:]:
        rec: Dict[str, Any] = {"time_unix": round(t_unix, 6), "name": name}
        if dur is not None:
            rec["duration_us"] = round(dur, 1)
        rec["tid"] = tid
        if trace_id:
            rec["trace_id"] = trace_id
        if error:
            rec["error"] = error
        out.append(rec)
    return out


def _counters_delta() -> Dict[str, float]:
    """Live counters minus the anchor taken at the previous blob; the anchor
    advances so consecutive blobs see disjoint windows."""
    try:
        from torchmetrics_tpu_torch.obs import registry as _registry  # lazy: cold path only

        current = _registry.counters_snapshot()
    except Exception:
        return {}
    with _anchor_lock:
        delta = {
            k: v - _counter_anchor.get(k, 0)
            for k, v in current.items()
            if v != _counter_anchor.get(k, 0)
        }
        _counter_anchor.clear()
        _counter_anchor.update(current)
    return delta


def blob(domain: Optional[str] = None, max_events: int = _BLOB_MAX_EVENTS) -> Dict[str, Any]:
    """The flight blob a fault breadcrumb carries: the domain's recent records
    (all domains when ``domain`` is None), the counter deltas since the
    previous blob, and the capture time. Bounded by construction
    (``max_events`` per domain) so a crash loop cannot grow breadcrumbs
    without bound.

    When the faulting domain's ring is empty — a fault raised INSIDE the very
    span that would have recorded it (the span only lands on exit), or a
    fault before any seam ran — the blob falls back to every domain's
    records: the black box must never come back empty while any history
    exists."""
    events: Any = []
    if domain is not None and domain in _rings:
        events = _record_dicts(_rings[domain], max_events)
    if not events:
        events = {d: _record_dicts(r, max_events) for d, r in _rings.items() if len(r)}
    return {
        "time_unix": time.time(),
        "domain": domain,
        "events": events,
        "counters_delta": _counters_delta(),
    }


def snapshot() -> Dict[str, List[Dict[str, Any]]]:
    """Every domain's buffered records (diagnostics surface; does NOT advance
    the counter-delta anchor)."""
    return {d: _record_dicts(r, r.maxlen or _DEFAULT_CAPACITY) for d, r in _rings.items() if len(r)}


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i and (not name[i - 1].isupper()):
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def fault_breadcrumb(
    kind: str,
    domain: Optional[str] = None,
    data: Optional[Dict[str, Any]] = None,
    persist: bool = False,
) -> None:
    """Breadcrumb-with-flight for faults that degrade instead of raising
    (breaker trips, quarantine, degraded syncs/reads): the standard
    :func:`~torchmetrics_tpu_torch.obs.registry.breadcrumb` plus the ``flight``
    blob of the faulting domain. Never raises."""
    try:
        from torchmetrics_tpu_torch.obs import registry as _registry  # lazy: cold path only
        from torchmetrics_tpu_torch.obs import tracer as _tracer

        if not _tracer.telemetry_enabled():
            return
        payload = dict(data or {})
        payload["flight"] = blob(domain)
        _registry.breadcrumb(kind, payload)
        if persist:
            persist_flight()
    except Exception as err:  # the recorder must never mask the fault itself
        try:
            from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

            rank_zero_debug(f"flight fault_breadcrumb({kind}) failed: {type(err).__name__}: {err}")
        except Exception:
            pass


def flighted(
    exc: BaseException,
    domain: Optional[str] = None,
    kind: Optional[str] = None,
    persist: bool = False,
    **data: Any,
) -> BaseException:
    """Attach the flight recorder to a typed fault at its raise site::

        raise flighted(ShardLossError("shard 3 lost", shard=3), domain="shadow")

    Records a breadcrumb (kind defaults to the snake_cased exception class
    name) whose data carries the error string, any keyword attribution, and
    the ``flight`` blob of the faulting window; ``persist=True`` additionally
    dumps the full recorder to disk (fatal paths — the watchdog). Returns
    ``exc`` unchanged so the raise stays a one-liner, and never raises
    itself."""
    payload: Dict[str, Any] = dict(data)
    payload["error"] = f"{type(exc).__name__}: {exc}"
    fault_breadcrumb(kind or _snake(type(exc).__name__), domain, payload, persist=persist)
    return exc


def persist_flight(path: Optional[str] = None) -> Optional[str]:
    """Durably write the full flight snapshot (every domain, the breadcrumb
    trail, counters) as JSON through ``atomic_write_bytes`` — the fatal-path
    dump an operator reads after the process is gone. Returns the path, or
    None when the write failed (logged, never raised)."""
    import json

    try:
        from torchmetrics_tpu_torch.io.checkpoint import atomic_write_bytes
        from torchmetrics_tpu_torch.obs import registry as _registry

        if path is None:
            import tempfile

            directory = os.environ.get(FLIGHT_DIR_ENV, "").strip() or tempfile.gettempdir()
            path = os.path.join(directory, f"tm_tpu_flight_{os.getpid()}.json")
        doc = {
            "time_unix": time.time(),
            "pid": os.getpid(),
            "flight": snapshot(),
            "counters": _registry.counters_snapshot(),
            "breadcrumbs": _registry.dump_diagnostics().get("breadcrumbs", []),
        }
        atomic_write_bytes(path, json.dumps(doc, default=str).encode("utf-8"))
        _registry.counter_inc("flight.persisted")
        return path
    except Exception as err:  # a failed dump must not mask the fatal fault
        try:
            from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

            rank_zero_warn(f"flight recorder persist failed: {type(err).__name__}: {err}")
        except Exception:
            pass
        return None
