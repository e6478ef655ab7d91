"""The leaf side of the fleet tree: cut epoch-stamped deltas, keep an outbox,
ship without blocking the step loop.

A :class:`LeafExporter` owns one leaf's uplink. Each :meth:`~LeafExporter.export`
reads the source's canonical host state, cuts the per-field delta against the
previous export (``fleet/delta.py`` wire modes), stamps the next epoch and a
payload checksum, and parks the delta in the **outbox**;
:meth:`~LeafExporter.flush` ships the outbox in epoch order. The outbox is
trimmed only up to the aggregator's acked ``durable_epoch`` (the newest
epoch an aggregator snapshot covers), so an aggregator's death never loses
acknowledged state: the untrimmed deltas re-ship to the successor and the
exactly-once ledger drops what its restored snapshot already holds. Loss is
bounded by one export interval.

Sources are plain callables returning ``(state, reductions, update_count)``
with host-numpy state: :func:`metric_source` adapts a live
:class:`~torchmetrics_tpu_torch.Metric` (class-sharded fields gathered
dense on the card before their host copy, growing ``cat`` lists
concatenated), and ``aggregator_source`` (``fleet/aggregator.py``) an
interior aggregator of a multi-level tree.

``ship(wait=False)`` runs the flush on the async read pipeline: the step
loop pays one host copy (rows-sized for deltas) and returns; transport
latency, retries and backoff land on the pipeline's worker.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.fleet.delta import Delta, delta_since, payload_checksum
from torchmetrics_tpu_torch.fleet.transport import Uplink

__all__ = ["LeafExporter", "metric_source"]

Source = Callable[[], Tuple[Dict[str, Any], Dict[str, Any], int]]

#: outbox entries before the exporter collapses to a full resync (an
#: aggregator unreachable this long is told everything anyway; bounding the
#: outbox bounds a leaf's memory)
DEFAULT_OUTBOX_LIMIT = 64


def _host_copy(value: torch.Tensor) -> np.ndarray:
    return value.detach().to("cpu", copy=True).numpy()


def metric_source(metric: Any) -> Source:
    """Adapt a live Metric: its canonical host state (class-sharded fields
    gathered dense, growing ``cat`` lists concatenated, each field one
    device-to-host copy), its reductions and its update count."""
    from torchmetrics_tpu_torch.parallel.class_shard import gather_dense

    def _source() -> Tuple[Dict[str, Any], Dict[str, Any], int]:
        state: Dict[str, Any] = {}
        live = metric.metric_state
        for name in metric._defaults:
            value = live[name]
            layout = metric._class_layout(name)
            if layout is not None:
                value = gather_dense(value, layout)
            if isinstance(value, (list, tuple)):
                state[name] = (
                    _host_copy(torch.cat([torch.atleast_1d(el) for el in value]))
                    if len(value)
                    else np.zeros((0,), dtype=np.float32)
                )
            else:
                state[name] = _host_copy(value)
        return state, dict(metric._reductions), int(metric.update_count)

    return _source


def deferred_source(step: Any, states: Any) -> Source:
    """Adapt a ``DeferredCollectionStep``: its leader-keyed
    ``export_canonical`` fold flattened to ``"leader.field"`` keys (the fleet
    protocol is flat), the reductions likewise, and its committed step
    count. ``states`` is the live stacked states or a zero-argument
    callable returning them (a loop whose states move on every step)."""

    def _source() -> Tuple[Dict[str, Any], Dict[str, Any], int]:
        live = states() if callable(states) else states
        canonical = step.export_canonical(live)
        reductions = step.canonical_reductions()
        flat: Dict[str, Any] = {}
        reds: Dict[str, Any] = {}
        for leader, sub in canonical.items():
            for name, value in sub.items():
                flat[f"{leader}.{name}"] = np.asarray(value)
                reds[f"{leader}.{name}"] = reductions[leader].get(name)
        return flat, reds, int(step.steps)

    return _source


class LeafExporter:
    """One leaf's delta pipeline: read, cut, outbox, (asynchronous) ship.

    ``start_epoch`` is the epoch its clock continues from: a successor link
    takes over a dead one's clock (``Fleet.failover``)."""

    def __init__(
        self,
        leaf: str,
        source: Source,
        uplink: Uplink,
        parent: str,
        interval_updates: int = 1,
        precision: str = "exact",
        bits: int = 8,
        block_size: int = 256,
        outbox_limit: int = DEFAULT_OUTBOX_LIMIT,
        always_full: bool = False,
        start_epoch: int = 0,
    ) -> None:
        if precision not in ("exact", "quantized"):
            raise ValueError(f"precision must be 'exact' or 'quantized', got {precision!r}")
        if interval_updates < 1:
            raise ValueError(f"interval_updates must be >= 1, got {interval_updates}")
        if outbox_limit < 1:
            raise ValueError(f"outbox_limit must be >= 1, got {outbox_limit}")
        self.leaf = leaf
        self.parent = parent
        self.precision = precision
        self.bits = int(bits)
        self.block_size = int(block_size)
        self.interval_updates = int(interval_updates)
        self.outbox_limit = int(outbox_limit)
        self.always_full = bool(always_full)
        self._source = source
        self._uplink = uplink
        self._lock = threading.RLock()
        self._outbox: Dict[int, Delta] = {}
        self._prev: Optional[Dict[str, Any]] = None
        self._epoch = int(start_epoch)
        self._need_full = True  # the first export is always a full install
        self._updates_seen = 0
        self._updates_at_export = 0
        self._inflight: Optional[Any] = None  # MetricFuture of the async flush
        self.stats = {
            "exports": 0,
            "full_exports": 0,
            "acked_epoch": 0,
            "durable_epoch": 0,
            "resyncs_requested": 0,
            "outbox_overflows": 0,
        }

    # ----------------------------------------------------------------- export

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def outbox_size(self) -> int:
        with self._lock:
            return len(self._outbox)

    def mark_resync(self) -> None:
        """Force the next export to be a ``kind="full"`` resync (call after a
        metric reset or any out-of-band state replacement)."""
        with self._lock:
            self._need_full = True

    def export(self) -> Delta:
        """Cut the next epoch's delta from the source and park it in the
        outbox (no transport). The source's host copy here is the deliberate
        per-export copy."""
        from torchmetrics_tpu_torch import obs
        from torchmetrics_tpu_torch.parallel.quantized import encode_canonical

        state, reductions, update_count = self._source()
        host = {k: np.asarray(v) for k, v in state.items()}
        with self._lock:
            self._epoch += 1
            full = self.always_full or self._need_full or self._prev is None
            payload_host = delta_since(host, None if full else self._prev, reductions)
            if self.precision == "quantized":
                wire = encode_canonical(payload_host, bits=self.bits, block_size=self.block_size)
            else:
                wire = encode_canonical(payload_host, qspecs={k: None for k in payload_host})
            delta = Delta(
                leaf=self.leaf,
                epoch=self._epoch,
                base_epoch=0 if full else self._epoch - 1,
                kind="full" if full else "delta",
                payload=wire,
                reductions=dict(reductions),
                update_count=int(update_count),
                created_s=time.time(),
                ctx=obs.capture_context(),
                # the ledger re-hashes before any merge, so in-flight
                # corruption drops and resyncs, never merges
                checksum=payload_checksum(wire),
            )
            self._prev = host
            self._need_full = False
            self._updates_at_export = self._updates_seen
            self._outbox[self._epoch] = delta
            self.stats["exports"] += 1
            if full:
                self.stats["full_exports"] += 1
            if len(self._outbox) > self.outbox_limit:
                # the aggregator missed more history than we keep: drop it
                # all and resync, cheaper than shipping a long-dead backlog
                self._outbox.clear()
                self._need_full = True
                self.stats["outbox_overflows"] += 1
                obs.counter_inc("fleet.outbox_overflows")
        obs.counter_inc("fleet.deltas_exported")
        return delta

    # ------------------------------------------------------------------ flush

    def flush(self) -> Optional[Dict[str, Any]]:
        """Ship the outbox in epoch order; returns the last ack (None when the
        transport is down: the outbox is kept for the next flush)."""
        with self._lock:
            batch = [self._outbox[e] for e in sorted(self._outbox)]
        ack: Optional[Dict[str, Any]] = None
        for delta in batch:
            got = self._uplink.send(self.parent, delta)
            if got is None:
                break  # transport down: later epochs would only buffer as reorders
            ack = got
            with self._lock:
                self.stats["acked_epoch"] = max(self.stats["acked_epoch"], int(got["applied_epoch"]))
                durable = int(got.get("durable_epoch", got["applied_epoch"]))
                self.stats["durable_epoch"] = max(self.stats["durable_epoch"], durable)
                for epoch in [e for e in self._outbox if e <= durable]:
                    del self._outbox[epoch]
                if got.get("needs_full"):
                    # the ledger lost continuity (watermark gap, fresh
                    # successor): everything unacked is moot; resync
                    self._outbox.clear()
                    self._need_full = True
                    self.stats["resyncs_requested"] += 1
                    break
        return ack

    def ship(self, wait: bool = True) -> Optional[Any]:
        """Export and flush. ``wait=False`` cuts the delta inline (one host
        copy) and runs the transport on the async read pipeline, returning
        the in-flight ``MetricFuture``. One flush is in flight at a time:
        while one is pending, new exports wait in the outbox it ships."""
        self.export()
        if wait:
            return self.flush()
        from torchmetrics_tpu_torch.ops.async_read import get_pipeline

        with self._lock:
            if self._inflight is not None and not self._inflight.done():
                return self._inflight
            self._inflight = get_pipeline().submit(self.flush, owner=f"fleet:{self.leaf}")
            return self._inflight

    def step(self, n: int = 1, wait: bool = True) -> Optional[Any]:
        """Count source updates; export and ship every ``interval_updates``."""
        self._updates_seen += int(n)
        if self._updates_seen - self._updates_at_export >= self.interval_updates:
            return self.ship(wait=wait)
        return None

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the in-flight asynchronous flush (if any) resolves."""
        fut = self._inflight
        if fut is None:
            return True
        fut.result(timeout=timeout)
        return True
