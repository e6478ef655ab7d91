"""Degraded global reads and the one-call fleet assembly.

:class:`GlobalView` is the read side of the fleet tree: a healthy read (every
expected leaf merged, no quarantines, aggregator alive) returns the plain
merged state dict, bit-exact to the single-process ``merge_folded`` fold of
the same per-leaf states; anything less is served as a
:class:`~torchmetrics_tpu_torch.quarantine.DegradedValue` whose ``coverage``
is the fraction of expected leaves folded in and whose ``staleness`` anchors
every leaf on its version counters (applied epoch, update count, quarantine
flags): never a silent partial value, never a blocking wait for stragglers.
Degraded reads count ``fleet.degraded_reads``.

:class:`Fleet` / :func:`build_fleet` wire a :class:`FleetTopology` into live
objects: one :class:`~torchmetrics_tpu_torch.fleet.aggregator.Aggregator` per
interior node (children pinned from the topology), a shared
:class:`~torchmetrics_tpu_torch.fleet.transport.Uplink` routing over all of
them, and interior :class:`~torchmetrics_tpu_torch.fleet.leaf.LeafExporter`
links (``always_full=True``: a merged subtree's cat fields grow in the
middle, so suffix deltas only exist leaf-side). ``pump()`` ships every
interior level bottom-up so leaf deltas propagate to the root.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

from torchmetrics_tpu_torch.fleet.aggregator import Aggregator, aggregator_source
from torchmetrics_tpu_torch.fleet.delta import DEFAULT_WATERMARK
from torchmetrics_tpu_torch.fleet.leaf import LeafExporter
from torchmetrics_tpu_torch.fleet.topology import FleetTopology
from torchmetrics_tpu_torch.fleet.transport import Uplink
from torchmetrics_tpu_torch.io.retry import RetryPolicy
from torchmetrics_tpu_torch.quarantine import DegradedValue
from torchmetrics_tpu_torch.utils.exceptions import FleetProtocolError

__all__ = ["Fleet", "GlobalView", "build_fleet"]


class GlobalView:
    """Reads over one aggregator's merged state with an explicit health
    contract.

    ``expected_leaves`` is the full-fleet roster the view is judged against
    (default: the aggregator's pinned children). In a multi-level tree the
    root's own ledgers are keyed by interior nodes, so coverage against the
    LEAF roster needs the bottom-level ledgers too: pass every aggregator of
    the tree as ``anchor_sources`` (``Fleet.view()`` does) and the view
    collects each expected leaf's version counters from the node that owns
    it.
    """

    def __init__(
        self,
        aggregator: Aggregator,
        expected_leaves: Optional[Sequence[str]] = None,
        anchor_sources: Optional[Sequence[Aggregator]] = None,
    ) -> None:
        self.aggregator = aggregator
        roster = expected_leaves if expected_leaves is not None else aggregator.expected_leaves
        self.expected_leaves = tuple(sorted(roster)) if roster is not None else None
        self.anchor_sources = tuple(anchor_sources) if anchor_sources is not None else (aggregator,)

    # ------------------------------------------------------------------ health

    def staleness(self) -> Dict[str, Dict[str, Any]]:
        """Per-leaf version-counter anchors from the ledger that owns each
        leaf, with absent but expected leaves at epoch 0. Restricted to the
        expected roster when one is pinned."""
        anchors: Dict[str, Dict[str, Any]] = {}
        for source in self.anchor_sources:
            for leaf, anchor in source.coverage().items():
                if self.expected_leaves is not None and leaf not in self.expected_leaves:
                    continue
                anchors[leaf] = anchor
        if self.expected_leaves is not None:
            for leaf in self.expected_leaves:
                anchors.setdefault(
                    leaf,
                    {"applied_epoch": 0, "update_count": 0, "quarantined": False, "needs_full": True, "pending": 0},
                )
        return anchors

    def coverage(self) -> float:
        """Fraction of expected leaves with at least one merged epoch (1.0
        when no roster was pinned and anything has merged)."""
        anchors = self.staleness()
        if not anchors:
            return 0.0
        healthy = sum(1 for a in anchors.values() if a["applied_epoch"] > 0)
        return healthy / len(anchors)

    def healthy(self) -> bool:
        """Every expected leaf merged and clean, AND the read aggregator's
        own children merged and clean (in a multi-level tree those are the
        interior links: fresh leaves behind a stalled interior link are still
        a degraded read at the root)."""
        anchors = self.staleness()
        direct = self.aggregator.coverage()
        if self.aggregator.expected_leaves is not None:
            for child in self.aggregator.expected_leaves:
                direct.setdefault(child, {"applied_epoch": 0, "quarantined": False, "needs_full": True})

        def _ok(a: Dict[str, Any]) -> bool:
            return a["applied_epoch"] > 0 and not a["quarantined"] and not a["needs_full"]

        return (
            self.aggregator.alive
            and bool(anchors)
            and all(_ok(a) for a in anchors.values())
            and all(_ok(a) for a in direct.values())
        )

    # -------------------------------------------------------------------- read

    def read(self, allow_degraded: bool = True) -> Any:
        """The global fleet state.

        Healthy: the plain merged state dict (host numpy, bit-exact to the
        single-process fold in sorted leaf order). Anything less (missing or
        quarantined leaves, a dead aggregator) is a :class:`DegradedValue`
        over whatever HAS merged, carrying ``coverage`` and per-leaf
        ``staleness``; with ``allow_degraded=False`` a typed
        :class:`FleetProtocolError` instead. A dead aggregator still serves
        its last merged view (the read is local); only merging stops.
        """
        from torchmetrics_tpu_torch import obs

        state, _ = self.aggregator.canonical()
        anchors = self.staleness()
        if self.healthy() and state is not None:
            return state
        unhealthy = sorted(
            leaf for leaf, a in anchors.items() if a["applied_epoch"] == 0 or a["quarantined"] or a["needs_full"]
        )
        if not allow_degraded:
            raise obs.flighted(
                FleetProtocolError(
                    f"fleet view over {self.aggregator.node_id!r} is degraded"
                    f" (coverage {self.coverage():.2f}, unhealthy leaves: {unhealthy});"
                    " pass allow_degraded=True to read the partial fold",
                    node=self.aggregator.node_id,
                ),
                domain="fleet",
            )
        obs.counter_inc("fleet.degraded_reads")
        return DegradedValue(
            value=state,
            updates_behind=len(unhealthy),
            age_updates=self.aggregator.total_update_count(),
            coverage=self.coverage(),
            staleness=anchors,
        )


class Fleet:
    """A wired tree: one aggregator per interior node, interior uplinks, and
    the root view. Leaf-side exporters are the caller's (they own sources):
    attach them to ``fleet.uplink`` with ``parent=fleet.topology.parent_of(leaf)``
    or let :meth:`leaf_exporter` do it."""

    def __init__(
        self,
        topology: FleetTopology,
        snapshot_dir: Optional[str] = None,
        watermark: int = DEFAULT_WATERMARK,
        policy: Optional[RetryPolicy] = None,
        snapshot_every: int = 0,
        sleep: Any = None,
    ) -> None:
        self.topology = topology
        self.aggregators: Dict[str, Aggregator] = {}
        for node in topology.aggregators:
            self.aggregators[node] = Aggregator(
                node,
                expected_leaves=topology.children_of(node),
                watermark=watermark,
                snapshot_dir=snapshot_dir,
                snapshot_every=snapshot_every,
            )
        self.uplink = Uplink(self._route, policy=policy, sleep=sleep if sleep is not None else time.sleep)
        # interior links: each non-root aggregator ships its merged subtree to
        # its parent as full exports (cat suffix deltas only exist leaf-side)
        self._interior: Dict[str, LeafExporter] = {}
        for node in topology.aggregators:
            parent = topology.parent_of(node)
            if parent is None:
                continue
            self._interior[node] = LeafExporter(
                node, aggregator_source(self.aggregators[node]), self.uplink, parent, always_full=True
            )

    def _route(self, node_id: str) -> Optional[Aggregator]:
        return self.aggregators.get(node_id)

    @property
    def root(self) -> Aggregator:
        return self.aggregators[self.topology.root]

    def leaf_exporter(self, leaf: str, source: Any, **kwargs: Any) -> LeafExporter:
        """A leaf-side exporter wired to this fleet's uplink and the leaf's
        parent in the topology."""
        parent = self.topology.parent_of(leaf)
        if parent is None:
            raise ValueError(f"{leaf!r} is not a leaf of this fleet's topology")
        return LeafExporter(leaf, source, self.uplink, parent, **kwargs)

    def pump(self) -> None:
        """Propagate merged subtree state up every interior link, bottom
        level first (children merge before their parent ships)."""
        for node in self.topology.aggregators:
            exporter = self._interior.get(node)
            if exporter is not None:
                exporter.ship(wait=True)

    def view(self) -> GlobalView:
        """The global read surface: the root aggregator judged against the
        FULL leaf roster, with every tree node contributing leaf anchors."""
        return GlobalView(self.root, expected_leaves=self.topology.leaves, anchor_sources=list(self.aggregators.values()))

    def failover(self, node: str, snapshot_dir: Optional[str] = None) -> Aggregator:
        """Replace ``node`` with a successor restored from its newest
        snapshot. The uplink routes to the successor at once; leaves re-ship
        their undurable outboxes and the restored ledgers drop the
        duplicates: loss is bounded by one export interval."""
        restored = Aggregator.restore(snapshot_dir or self.aggregators[node].snapshot_dir, node_id=node)
        self.aggregators[node] = restored
        if node in self._interior:
            old = self._interior[node]
            # the successor's link continues the dead link's epoch clock: a
            # clock restarted at 0 would have its full exports dropped by the
            # parent's ledger as duplicates until it passed the old one
            self._interior[node] = LeafExporter(
                node, aggregator_source(restored), self.uplink, old.parent, always_full=True, start_epoch=old.epoch
            )
        return restored


def build_fleet(
    topology: FleetTopology,
    snapshot_dir: Optional[str] = None,
    watermark: int = DEFAULT_WATERMARK,
    policy: Optional[RetryPolicy] = None,
    snapshot_every: int = 0,
    sleep: Any = None,
) -> Fleet:
    """Wire ``topology`` into a live in-process fleet (aggregators, a shared
    uplink, interior links)."""
    return Fleet(
        topology, snapshot_dir=snapshot_dir, watermark=watermark, policy=policy, snapshot_every=snapshot_every, sleep=sleep
    )
