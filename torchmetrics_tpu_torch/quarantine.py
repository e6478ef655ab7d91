"""Degraded reads: what a metric serves when its sync failed under
``on_sync_failure="last_good"``."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

__all__ = ["DegradedValue"]


class DegradedValue(NamedTuple):
    """A degraded read: the last-good value plus staleness metadata.

    ``value`` is the most recent result whose sync succeeded;
    ``updates_behind`` counts the updates since it was captured (how stale
    it is); ``age_updates`` is the metric's update count at capture (how
    much data the value reflects). ``coverage`` and ``staleness`` are kept
    for the shape of the JAX package's fleet-scope reads and stay None here.
    """

    value: Any
    updates_behind: int
    age_updates: int
    coverage: Optional[float] = None
    staleness: Optional[Dict[str, Any]] = None
