"""Fault-tolerant cross-process metric aggregation.

The rest of the port scales metrics within one process world; ``fleet/``
scales them across independent serving processes. Leaf processes
periodically read their state in the topology-neutral canonical form and
ship *deltas*, state since the last acked export, up an aggregator tree to a
global view. Everything here is host numpy, and the wire dicts, checksums,
ledgers and snapshots are the JAX package's (``torchmetrics_tpu/fleet``), so
leaves and aggregators of both packages interoperate:

- :mod:`~torchmetrics_tpu_torch.fleet.topology`: leaf ids and a fanout give
  the aggregator tree (:class:`FleetTopology`).
- :mod:`~torchmetrics_tpu_torch.fleet.delta`: the exactly-once delta
  protocol: per-field wire modes derived from ``(reduction, dtype)``,
  monotonic per-leaf epochs, and the :class:`LeafLedger` that drops
  duplicates, buffers reorders under a watermark and quarantines gaps past
  it.
- :mod:`~torchmetrics_tpu_torch.fleet.transport`: the uplink: capped-backoff
  retries (``io/retry.py``) and a per-leaf circuit breaker.
- :mod:`~torchmetrics_tpu_torch.fleet.leaf`: the :class:`LeafExporter`: cuts
  epoch-stamped deltas from a metric source, keeps an outbox of undurable
  deltas for failover re-ship, and can ship on the async read pipeline.
- :mod:`~torchmetrics_tpu_torch.fleet.aggregator`: per-leaf ledgers, acks,
  atomic snapshots (``io/checkpoint.py``) and failover restore.
- :mod:`~torchmetrics_tpu_torch.fleet.view`: the :class:`GlobalView`: the
  merged fleet value, served as a ``DegradedValue`` carrying the coverage
  fraction and per-leaf staleness whenever a leaf is missing, stale or
  quarantined; and :func:`build_fleet`, which wires a whole tree.

Ship and merge run in ``tm_tpu.fleet.ship`` / ``tm_tpu.fleet.merge`` spans
linked by the context a delta carries, merges feed the
``fleet.aggregation_lag_us`` histogram, and faults land in the ``fleet``
flight-recorder domain.
"""
from torchmetrics_tpu_torch.fleet.aggregator import Aggregator, aggregator_source
from torchmetrics_tpu_torch.fleet.delta import (
    DELTA_KINDS,
    Delta,
    LeafLedger,
    apply_delta,
    delta_since,
    field_mode,
    payload_checksum,
)
from torchmetrics_tpu_torch.fleet.leaf import LeafExporter, metric_source
from torchmetrics_tpu_torch.fleet.topology import FleetTopology
from torchmetrics_tpu_torch.fleet.transport import Uplink
from torchmetrics_tpu_torch.fleet.view import Fleet, GlobalView, build_fleet

__all__ = [
    "Aggregator",
    "DELTA_KINDS",
    "Delta",
    "Fleet",
    "FleetTopology",
    "GlobalView",
    "LeafExporter",
    "LeafLedger",
    "Uplink",
    "aggregator_source",
    "apply_delta",
    "build_fleet",
    "delta_since",
    "field_mode",
    "metric_source",
    "payload_checksum",
]
