"""The aggregator node: per-leaf exactly-once ledgers, acks, and failover.

:meth:`Aggregator.receive` is the uplink's target: it routes each delta to the
sending leaf's :class:`~torchmetrics_tpu_torch.fleet.delta.LeafLedger`, runs
the merge under the trace context the leaf captured at ship time (the
ship-to-merge flow arrow), records the ``fleet.aggregation_lag_us``
histogram, and answers with an ack carrying three numbers the leaf acts on:

- ``applied_epoch``: the ledger's consecutive high-water mark;
- ``durable_epoch``: the newest epoch an aggregator snapshot covers (equal to
  ``applied_epoch`` when snapshotting is off); the leaf trims its outbox
  only up to it, so an aggregator's death never loses acked state;
- ``needs_full``: the ledger lost continuity (watermark gap, fresh
  successor); the leaf drops its outbox and resyncs with a full export.

Snapshots write every ledger through the atomic store
(``io/checkpoint.atomic_write_bytes``: write a temporary, fsync, rename) in
the JAX package's container, byte for byte in layout: a magic line, the
manifest's length, a JSON manifest carrying the payload's sha256, then the
pickled ledgers (builtins and numpy only). A torn write is a typed
:class:`~torchmetrics_tpu_torch.utils.exceptions.CheckpointCorruptionError`,
and a snapshot either package wrote restores in the other.
:meth:`Aggregator.restore` builds the failover successor from the newest
valid snapshot; leaves re-ship everything past each ledger's restored epoch
from their outboxes.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from torchmetrics_tpu_torch.fleet.delta import DEFAULT_WATERMARK, Delta, LeafLedger, to_host
from torchmetrics_tpu_torch.utils.exceptions import CheckpointCorruptionError, FleetProtocolError

__all__ = ["Aggregator", "aggregator_source"]

#: aggregator snapshot file format: magic, manifest length, manifest JSON
#: (carrying the payload's sha256), pickled ledger payload
_MAGIC = b"TMTPUFLEET1\n"
_SNAP_RE = re.compile(r"^fleet-(?P<node>.+)-(?P<seq>\d{8})\.ckpt$")


def _safe_node(node_id: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", node_id)


class Aggregator:
    """One tree node: a ledger per child, a merged subtree view, and an
    atomic snapshot store for failover.

    ``expected_leaves`` pins the child set (a delta from a child it does not
    own is a :class:`FleetProtocolError`); None admits any leaf (a flat
    single-aggregator fleet). ``snapshot_every=N`` snapshots after every N
    applied deltas into ``snapshot_dir``; 0 disables snapshots (acks then
    report ``durable_epoch == applied_epoch``: with nothing to fail over to,
    there is nothing for the outbox to protect).
    """

    def __init__(
        self,
        node_id: str,
        expected_leaves: Optional[Sequence[str]] = None,
        watermark: int = DEFAULT_WATERMARK,
        snapshot_dir: Optional[str] = None,
        snapshot_every: int = 0,
    ) -> None:
        if snapshot_every < 0:
            raise ValueError(f"snapshot_every must be >= 0, got {snapshot_every}")
        if snapshot_every and snapshot_dir is None:
            raise ValueError("snapshot_every > 0 requires a snapshot_dir")
        self.node_id = node_id
        self.watermark = int(watermark)
        self.expected_leaves: Optional[Tuple[str, ...]] = (
            tuple(sorted(expected_leaves)) if expected_leaves is not None else None
        )
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        self._ledgers: Dict[str, LeafLedger] = {}
        self._durable: Dict[str, int] = {}  # leaf -> epoch covered by the last snapshot
        self._alive = True
        self._applied_since_snapshot = 0
        self._snapshot_seq = 0
        self.stats = {"received": 0, "snapshots": 0}

    # ---------------------------------------------------------------- receive

    def receive(self, delta: Delta) -> Dict[str, Any]:
        """The uplink's target: apply ``delta`` through its leaf's ledger and
        ack. Raises ``ConnectionError`` while killed (the transport failure
        the uplink retries and breakers on) and :class:`FleetProtocolError`
        on protocol violations (never retried)."""
        from torchmetrics_tpu_torch import obs

        if not self._alive:
            raise ConnectionError(f"aggregator {self.node_id!r} is down")
        with obs.use_context(delta.ctx):
            with obs.span(obs.SPAN_FLEET_MERGE, leaf=delta.leaf, epoch=delta.epoch, node=self.node_id):
                if self.expected_leaves is not None and delta.leaf not in self.expected_leaves:
                    raise obs.flighted(
                        FleetProtocolError(
                            f"aggregator {self.node_id!r} does not own leaf {delta.leaf!r}"
                            f" (children: {self.expected_leaves})",
                            leaf=delta.leaf,
                            epoch=delta.epoch,
                            node=self.node_id,
                        ),
                        domain="fleet",
                    )
                ledger = self._ledgers.get(delta.leaf)
                if ledger is None:
                    ledger = self._ledgers[delta.leaf] = LeafLedger(delta.leaf, watermark=self.watermark)
                before = ledger.stats["applied"]
                ack = ledger.offer(delta)
                applied = ledger.stats["applied"] - before
                self.stats["received"] += 1
                obs.counter_inc("fleet.deltas_received")
                if applied:
                    obs.counter_inc("fleet.deltas_applied", applied)
                    obs.histogram_observe("fleet.aggregation_lag_us", max(0.0, (time.time() - delta.created_s) * 1e6))
                else:
                    obs.counter_inc("fleet.deltas_dropped")
                if ledger.quarantined and ledger.stats["quarantines"]:
                    obs.fault_breadcrumb(
                        "leaf_quarantined",
                        domain="fleet",
                        data={
                            "leaf": delta.leaf,
                            "node": self.node_id,
                            "applied_epoch": ledger.applied_epoch,
                            "offered_epoch": delta.epoch,
                        },
                    )
                self._applied_since_snapshot += applied
                if self.snapshot_every and self._applied_since_snapshot >= self.snapshot_every:
                    self.snapshot()
                ack["node"] = self.node_id
                ack["durable_epoch"] = self._durable.get(delta.leaf, 0) if self.snapshot_every else ledger.applied_epoch
                return ack

    # ----------------------------------------------------------------- expose

    def ledger(self, leaf: str) -> Optional[LeafLedger]:
        return self._ledgers.get(leaf)

    @property
    def alive(self) -> bool:
        return self._alive

    def kill(self) -> None:
        """Simulate (or effect) this node's death: every receive fails at the
        transport level until :meth:`revive`; leaves keep their outboxes."""
        self._alive = False

    def revive(self) -> None:
        self._alive = True

    def coverage(self) -> Dict[str, Dict[str, Any]]:
        """Per-leaf staleness anchors for the global view: the epoch and
        update counters of what this node has merged."""
        return {
            leaf: {
                "applied_epoch": ledger.applied_epoch,
                "update_count": ledger.update_count,
                "quarantined": ledger.quarantined,
                "needs_full": ledger.needs_full,
                "pending": len(ledger.pending),
            }
            for leaf, ledger in self._ledgers.items()
        }

    def canonical(self) -> Tuple[Optional[Dict[str, np.ndarray]], Dict[str, Any]]:
        """The merged subtree state: per-leaf accumulations folded with
        ``merge_folded`` in SORTED leaf order, the order that makes the
        global value deterministic and bit-exact whatever the arrival
        schedule. Returns ``(state, reductions)`` in host numpy; the state
        is None before any leaf has merged."""
        from torchmetrics_tpu_torch.parallel.reshard import merge_folded

        merged: Optional[Dict[str, Any]] = None
        reductions: Dict[str, Any] = {}
        for leaf in sorted(self._ledgers):
            ledger = self._ledgers[leaf]
            if ledger.acc is None:
                continue
            reductions = ledger.reductions or reductions
            merged = dict(ledger.acc) if merged is None else merge_folded(merged, ledger.acc, reductions)
        if merged is not None:
            merged = {k: to_host(v) for k, v in merged.items()}
        return merged, reductions

    def total_update_count(self) -> int:
        return sum(ledger.update_count for ledger in self._ledgers.values())

    # -------------------------------------------------------------- snapshots

    def snapshot(self) -> str:
        """Persist every ledger through the atomic store; returns the path.
        After a successful write, acks advance ``durable_epoch`` to each
        ledger's applied epoch: the signal leaves trim their outboxes on."""
        from torchmetrics_tpu_torch import obs
        from torchmetrics_tpu_torch.io.checkpoint import atomic_write_bytes

        if self.snapshot_dir is None:
            raise ValueError(f"aggregator {self.node_id!r} has no snapshot_dir")
        os.makedirs(self.snapshot_dir, exist_ok=True)
        with obs.span(obs.SPAN_CKPT_SAVE, node=self.node_id, kind="fleet"):
            payload = pickle.dumps(
                {
                    "node_id": self.node_id,
                    "watermark": self.watermark,
                    "expected_leaves": self.expected_leaves,
                    "ledgers": {leaf: ledger.export() for leaf, ledger in self._ledgers.items()},
                },
                protocol=pickle.HIGHEST_PROTOCOL,
            )
            manifest = json.dumps(
                {
                    "format": "fleet_aggregator",
                    "node_id": self.node_id,
                    "created_unix": time.time(),
                    "payload_len": len(payload),
                    "payload_sha256": hashlib.sha256(payload).hexdigest(),
                },
                sort_keys=True,
            ).encode("utf-8")
            self._snapshot_seq += 1
            path = os.path.join(self.snapshot_dir, f"fleet-{_safe_node(self.node_id)}-{self._snapshot_seq:08d}.ckpt")
            atomic_write_bytes(path, _MAGIC + len(manifest).to_bytes(8, "little") + manifest + payload)
        self._durable = {leaf: ledger.applied_epoch for leaf, ledger in self._ledgers.items()}
        self._applied_since_snapshot = 0
        self.stats["snapshots"] += 1
        obs.counter_inc("fleet.snapshots")
        return path

    @classmethod
    def restore(cls, snapshot_dir: str, node_id: Optional[str] = None, snapshot_every: Optional[int] = None) -> "Aggregator":
        """Build the failover successor from the newest valid snapshot in
        ``snapshot_dir`` (of ``node_id`` when given). Restored ledgers resume
        at their durable epochs; re-shipped unacked deltas land as ordinary
        in-order (or duplicate) offers."""
        from torchmetrics_tpu_torch import obs

        candidates = []
        for name in os.listdir(snapshot_dir):
            m = _SNAP_RE.match(name)
            if m and (node_id is None or m.group("node") == _safe_node(node_id)):
                candidates.append((int(m.group("seq")), name))
        if not candidates:
            raise FileNotFoundError(f"no fleet aggregator snapshot for {node_id or '<any>'} in {snapshot_dir!r}")
        _, name = max(candidates)
        path = os.path.join(snapshot_dir, name)
        with obs.span(obs.SPAN_CKPT_RESTORE, node=node_id or name, kind="fleet"):
            with open(path, "rb") as fh:
                blob = fh.read()
            if not blob.startswith(_MAGIC) or len(blob) < len(_MAGIC) + 8:
                raise obs.flighted(
                    CheckpointCorruptionError(f"fleet snapshot {path!r}: bad magic/truncated header"), domain="fleet"
                )
            off = len(_MAGIC)
            mlen = int.from_bytes(blob[off:off + 8], "little")
            manifest_raw = blob[off + 8:off + 8 + mlen]
            payload = blob[off + 8 + mlen:]
            try:
                manifest = json.loads(manifest_raw)
            except ValueError as err:
                raise obs.flighted(
                    CheckpointCorruptionError(f"fleet snapshot {path!r}: unparseable manifest ({err})"), domain="fleet"
                ) from err
            if len(payload) != manifest.get("payload_len") or hashlib.sha256(payload).hexdigest() != manifest.get(
                "payload_sha256"
            ):
                raise obs.flighted(
                    CheckpointCorruptionError(f"fleet snapshot {path!r}: payload hash mismatch (torn write / bit rot)"),
                    domain="fleet",
                )
            data = pickle.loads(payload)
        agg = cls(
            data["node_id"],
            expected_leaves=data["expected_leaves"],
            watermark=data["watermark"],
            snapshot_dir=snapshot_dir,
            snapshot_every=snapshot_every if snapshot_every is not None else 1,
        )
        for leaf, blob_l in data["ledgers"].items():
            agg._ledgers[leaf] = LeafLedger.restore(blob_l)
        agg._durable = {leaf: ledger.applied_epoch for leaf, ledger in agg._ledgers.items()}
        agg._snapshot_seq = max(c[0] for c in candidates)
        obs.counter_inc("fleet.failovers")
        obs.fault_breadcrumb(
            "aggregator_failover",
            domain="fleet",
            data={"node": data["node_id"], "restored_leaves": len(agg._ledgers), "durable": dict(agg._durable)},
        )
        return agg


def aggregator_source(agg: Aggregator) -> Callable[[], Tuple[Dict[str, Any], Dict[str, Any], int]]:
    """Adapt an interior aggregator as a LeafExporter source for multi-level
    trees: its merged subtree state, reductions and summed update count.
    Interior uplinks ship ``kind="full"`` every epoch (pair this with
    ``LeafExporter(always_full=True)``): a subtree's merged cat fields grow in
    the middle as leaves interleave, so suffix deltas only exist leaf-side."""

    def _source() -> Tuple[Dict[str, Any], Dict[str, Any], int]:
        state, reductions = agg.canonical()
        return state if state is not None else {}, reductions, agg.total_update_count()

    return _source
