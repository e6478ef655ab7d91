"""The fleet uplink: delta delivery with retries and a per-leaf breaker.

:meth:`Uplink.transmit` is ONE delivery attempt: the seam the fault
injectors of ``testing/faults.py`` patch (drop, duplicate, delay, partition,
corrupt) and the place a deployment swaps in an RPC stack. :meth:`Uplink.send`
wraps it with the capped-backoff policy of ``io/retry.py`` and a per-leaf
circuit breaker mirroring the lane guard's states (closed, open after
``threshold`` faults in the last ``window`` attempts, probation after
``probe_after`` skipped sends, closed again on a clean probe): a leaf whose
aggregator is down stops burning retry budget on every flush, keeps its
outbox and probes its way back in.

Transport failures (``ConnectionError``, ``OSError``, ``TimeoutError``) are
the ONLY retried class; a :class:`~torchmetrics_tpu_torch.utils.exceptions.FleetProtocolError`
from the receiving ledger propagates at once: re-sending a protocol
violation never fixes it.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Optional, Union

from torchmetrics_tpu_torch.fleet.delta import Delta
from torchmetrics_tpu_torch.io.retry import RetryPolicy, call_with_retries

__all__ = ["Uplink", "UplinkBreaker"]

#: exception classes the uplink treats as transient transport loss
TRANSPORT_ERRORS = (ConnectionError, OSError, TimeoutError)

#: default in-process retry schedule: quick and deterministic (jitter matters
#: for real fleets hammering one recovered aggregator, not in one process)
DEFAULT_POLICY = RetryPolicy(max_retries=2, base_delay=0.005, max_delay=0.05, jitter=0.0)


class UplinkBreaker:
    """Per-leaf circuit breaker over uplink attempts (the lane guard's
    pattern at fleet granularity): ``threshold`` faults within the last
    ``window`` attempts open it; after ``probe_after`` skipped sends one probe
    goes through (probation); a clean probe closes it, a failed one re-opens."""

    def __init__(self, threshold: int = 3, window: int = 16, probe_after: int = 2) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if window < threshold:
            raise ValueError(f"window must be >= threshold, got {window} < {threshold}")
        if probe_after < 1:
            raise ValueError(f"probe_after must be >= 1, got {probe_after}")
        self.threshold = int(threshold)
        self.window = int(window)
        self.probe_after = int(probe_after)
        self._faults: collections.deque = collections.deque(maxlen=int(window))
        self._state = "closed"
        self._skips = 0

    @property
    def state(self) -> str:
        return self._state

    def allow(self) -> bool:
        """May a send go out now? An open breaker skips ``probe_after``
        sends, then lets one probe through."""
        if self._state != "open":
            return True
        self._skips += 1
        if self._skips >= self.probe_after:
            self._state = "probation"
            return True
        return False

    def record(self, ok: bool) -> None:
        if ok:
            if self._state in ("open", "probation"):
                self._faults.clear()
            self._state = "closed"
            self._faults.append(False)
            return
        self._faults.append(True)
        if self._state == "probation" or sum(self._faults) >= self.threshold:
            self._state = "open"
            self._skips = 0


class Uplink:
    """Delivers deltas from leaves to aggregator nodes.

    ``nodes`` maps a node id to a receiver (anything with a
    ``receive(delta)`` returning an ack dict: an
    :class:`~torchmetrics_tpu_torch.fleet.aggregator.Aggregator` in process),
    or is a callable doing that lookup. A deployment replaces
    :meth:`transmit`; everything above it (retry, breaker, counters, spans)
    is transport-agnostic. ``sleep`` is injectable so tests drive the backoff
    clock.
    """

    def __init__(
        self,
        nodes: Union[Dict[str, Any], Callable[[str], Any]],
        policy: Optional[RetryPolicy] = None,
        breaker_threshold: int = 3,
        breaker_window: int = 16,
        probe_after: int = 2,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self._nodes = nodes
        self.policy = policy or DEFAULT_POLICY
        self._breaker_args = (int(breaker_threshold), int(breaker_window), int(probe_after))
        self._breakers: Dict[str, UplinkBreaker] = {}
        self._sleep = sleep
        self.stats = {"sent": 0, "failed": 0, "breaker_skipped": 0, "bytes": 0}

    def _resolve(self, node_id: str) -> Any:
        node = self._nodes(node_id) if callable(self._nodes) else self._nodes.get(node_id)
        if node is None:
            raise ConnectionError(f"fleet uplink: no route to aggregator {node_id!r}")
        return node

    def breaker(self, leaf: str) -> UplinkBreaker:
        br = self._breakers.get(leaf)
        if br is None:
            br = self._breakers[leaf] = UplinkBreaker(*self._breaker_args)
        return br

    def transmit(self, node_id: str, delta: Delta) -> Dict[str, Any]:
        """ONE delivery attempt: the fault-injection and RPC seam."""
        return self._resolve(node_id).receive(delta)

    def send(self, node_id: str, delta: Delta) -> Optional[Dict[str, Any]]:
        """Deliver ``delta`` with retries and breaker accounting.

        Returns the aggregator's ack, or None when the transport is down
        (retry budget spent or breaker open): the caller keeps the delta in
        its outbox and re-ships later, and the exactly-once ledger makes the
        eventual duplicate deliveries harmless."""
        from torchmetrics_tpu_torch import obs
        from torchmetrics_tpu_torch.parallel.quantized import wire_payload_bytes

        br = self.breaker(delta.leaf)
        if not br.allow():
            self.stats["breaker_skipped"] += 1
            obs.counter_inc("fleet.breaker_skipped")
            return None
        with obs.span(obs.SPAN_FLEET_SHIP, leaf=delta.leaf, epoch=delta.epoch, node=node_id):
            try:
                ack = call_with_retries(
                    lambda: self.transmit(node_id, delta),
                    self.policy,
                    retry_on=TRANSPORT_ERRORS,
                    sleep=self._sleep,
                    what=f"fleet uplink {delta.leaf}->{node_id} epoch {delta.epoch}",
                )
            except TRANSPORT_ERRORS as err:
                br.record(False)
                self.stats["failed"] += 1
                obs.counter_inc("fleet.uplink_failures")
                obs.fault_breadcrumb(
                    "uplink_failure",
                    domain="fleet",
                    data={
                        "leaf": delta.leaf,
                        "node": node_id,
                        "epoch": delta.epoch,
                        "error": f"{type(err).__name__}: {err}",
                        "breaker": br.state,
                    },
                )
                return None
        br.record(True)
        self.stats["sent"] += 1
        self.stats["bytes"] += wire_payload_bytes(delta.payload)
        obs.counter_inc("fleet.deltas_shipped")
        return ack
