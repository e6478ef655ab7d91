"""Fleet tree topology: leaf ids and a fanout give a deterministic aggregator tree.

The tree is pure bookkeeping, node ids and parent/child edges, so the same
description drives an in-process simulation and a deployment where each node
id names a process. Leaves are SORTED before grouping, which makes every merge
downstream deterministic: the global view folds per-leaf state in sorted leaf
order, so the fleet result is bit-exact whatever the delta arrival schedule.

Interior aggregator nodes are named ``agg/L<level>/<index>``; the single top
node is ``agg/root``. A one-leaf fleet still gets a root aggregator: the
global view always reads from an aggregator, never from a leaf directly.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FleetTopology"]


class FleetTopology:
    """The aggregator tree over ``leaves`` with uplink fan-in ``fanout``.

    >>> topo = FleetTopology(["leaf/b", "leaf/a", "leaf/c"], fanout=2)
    >>> topo.leaves
    ('leaf/a', 'leaf/b', 'leaf/c')
    >>> topo.parent_of("leaf/a") == topo.parent_of("leaf/b")
    True
    >>> topo.root
    'agg/root'
    >>> topo.children_of(topo.root)
    ('agg/L1/0', 'agg/L1/1')
    """

    def __init__(self, leaves: Sequence[str], fanout: int = 8) -> None:
        uniq = sorted(set(str(v) for v in leaves))
        if not uniq:
            raise ValueError("FleetTopology needs at least one leaf")
        if len(uniq) != len(leaves):
            raise ValueError("FleetTopology leaf ids must be unique")
        if fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {fanout}")
        self._leaves: Tuple[str, ...] = tuple(uniq)
        self.fanout = int(fanout)
        self._parent: Dict[str, str] = {}
        self._children: Dict[str, Tuple[str, ...]] = {}
        self._levels: List[Tuple[str, ...]] = []

        nodes: List[str] = list(self._leaves)
        level = 0
        while True:
            level += 1
            groups = [nodes[i : i + self.fanout] for i in range(0, len(nodes), self.fanout)]
            last = len(groups) == 1
            parents = ["agg/root" if last else f"agg/L{level}/{i}" for i in range(len(groups))]
            for parent, group in zip(parents, groups):
                self._children[parent] = tuple(group)
                for child in group:
                    self._parent[child] = parent
            self._levels.append(tuple(parents))
            nodes = parents
            if last:
                break

    @property
    def leaves(self) -> Tuple[str, ...]:
        return self._leaves

    @property
    def root(self) -> str:
        return "agg/root"

    @property
    def aggregators(self) -> Tuple[str, ...]:
        """Every interior node, bottom level first (the ship order: a level's
        exporters ship after its children have merged)."""
        return tuple(node for lvl in self._levels for node in lvl)

    @property
    def levels(self) -> Tuple[Tuple[str, ...], ...]:
        return tuple(self._levels)

    def parent_of(self, node: str) -> Optional[str]:
        """The uplink target of ``node`` (None for the root)."""
        return self._parent.get(node)

    def children_of(self, node: str) -> Tuple[str, ...]:
        return self._children.get(node, ())

    def describe(self) -> Dict[str, object]:
        """A JSON-able summary."""
        return {
            "leaves": len(self._leaves),
            "fanout": self.fanout,
            "aggregators": len(self.aggregators),
            "depth": len(self._levels),
        }

    def __repr__(self) -> str:
        d = self.describe()
        return f"FleetTopology(leaves={d['leaves']}, fanout={self.fanout}, depth={d['depth']})"
