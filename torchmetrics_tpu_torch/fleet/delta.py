"""The exactly-once fleet delta protocol.

A leaf's uplink payload is a *delta*: its canonical state since the last
export, stamped with a per-leaf monotonic **epoch** counter. The receiving
ledger (:class:`LeafLedger`) applies epochs strictly in order, which turns
the three transport realities into bounded, typed behaviour:

- **duplicate** (epoch <= applied): idempotent drop, counted;
- **reorder / late** (epoch > applied + 1): buffered in a pending window and
  drained the moment the gap fills, counted;
- **gap past the watermark**: the leaf is quarantined and the next ack asks
  for a ``kind="full"`` resync, the path a partitioned leaf takes to rejoin
  and a fresh failover aggregator takes to rebuild a leaf it has no snapshot
  for.

Per-field **wire modes** are DERIVED from ``(dist_reduce_fx, dtype)``, never
shipped, so sender and receiver cannot disagree:

====================  =========  ==============================================
field                 mode       wire carries / ledger applies
====================  =========  ==============================================
sum/mean, integer     add        ``cur - prev`` (exact in int); merged by ``+``
sum/mean, float/bool  replace    full current value; REPLACES the leaf's slot
                                 (float reconstruction ``(a-b)+b`` is not
                                 bit-exact, and a quantized subtractive delta
                                 would accumulate rounding)
max/min               merge      full current value; idempotent max/min merge
cat                   suffix     rows past the previous export's length,
                                 appended in epoch order
====================  =========  ==============================================

The ``add``, ``merge`` and ``suffix`` modes apply through the segment merge
:func:`~torchmetrics_tpu_torch.parallel.reshard.merge_folded`, whose torch
results are handed back as host numpy; ``replace`` fields overlay after it.
Payloads ride the wire format of
:func:`~torchmetrics_tpu_torch.parallel.quantized.encode_canonical` /
``decode_canonical``: exact (raw) by default, block-quantized float codes
under ``precision="quantized"`` (integer fields always exact). Everything
here is host numpy: no fleet array lands on the card. The names, counters,
wire dicts and checksums are the JAX package's, so leaves and aggregators of
both packages interoperate.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from torchmetrics_tpu_torch.utils.exceptions import FleetProtocolError

__all__ = [
    "DELTA_KINDS",
    "Delta",
    "LeafLedger",
    "apply_delta",
    "delta_since",
    "field_mode",
    "payload_checksum",
]

#: delta kinds: ``"delta"`` builds on the previous epoch, ``"full"`` replaces
#: the leaf's whole accumulated state (first export, resync, rejoin)
DELTA_KINDS = ("delta", "full")

#: reductions the fleet protocol can ship (the five canonical families)
FLEET_REDUCTIONS = ("sum", "mean", "max", "min", "cat")

#: epochs a reorder gap may stay open before the leaf is quarantined and a
#: full resync is requested (overridable per ledger and aggregator)
DEFAULT_WATERMARK = 8


@dataclass
class Delta:
    """One uplink payload: a leaf's state movement for exactly one epoch."""

    leaf: str
    epoch: int
    base_epoch: int
    kind: str
    payload: Dict[str, Any]  # encode_canonical wire dict (raw or quantized)
    reductions: Dict[str, Any]
    update_count: int
    created_s: float = field(default_factory=time.time)
    ctx: Optional[Any] = None  # obs.TraceContext captured at ship time
    #: sha256 of the payload, stamped by the exporter at ship time: the
    #: ledger re-hashes before merging, so a delta corrupted in flight DROPS
    #: (quarantine, then a full resync) instead of poisoning the
    #: accumulation. None: a sender that stamps nothing.
    checksum: Optional[str] = None


def payload_checksum(payload: Dict[str, Any]) -> str:
    """Deterministic sha256 over a delta's wire payload: dict keys sorted,
    arrays hashed as ``dtype/shape/raw bytes``, other scalars by ``repr``, so
    sender and receiver (of either package) compute the same digest from the
    same bits, whatever the dict order or array layout."""
    h = hashlib.sha256()

    def feed(value: Any) -> None:
        if isinstance(value, dict):
            h.update(b"{")
            for k in sorted(value, key=str):
                h.update(str(k).encode("utf-8"))
                h.update(b"=")
                feed(value[k])
                h.update(b";")
            h.update(b"}")
        elif isinstance(value, (list, tuple)):
            h.update(b"[")
            for el in value:
                feed(el)
                h.update(b",")
            h.update(b"]")
        elif hasattr(value, "dtype") and hasattr(value, "shape"):
            arr = np.ascontiguousarray(value)
            h.update(f"a:{arr.dtype}:{arr.shape}:".encode("utf-8"))
            h.update(arr.tobytes())
        elif isinstance(value, bytes):
            h.update(b"b:")
            h.update(value)
        elif value is None:
            h.update(b"n")
        else:
            h.update(f"s:{value!r}".encode("utf-8"))

    feed(payload)
    return h.hexdigest()


def field_mode(fx: Any, dtype: Any) -> str:
    """The derived wire mode of a field: ``add`` | ``replace`` | ``merge`` |
    ``suffix`` (the module docstring's table). Raises for reductions the
    fleet cannot carry (``None`` and callables have no cross-process merge)."""
    from torchmetrics_tpu_torch import obs

    if fx == "cat":
        return "suffix"
    if fx in ("max", "min"):
        return "merge"
    if fx in ("sum", "mean"):
        kind = np.dtype(dtype).kind
        return "add" if kind in "iu" else "replace"
    raise obs.flighted(
        FleetProtocolError(
            f"dist_reduce_fx={fx!r} has no derivable fleet wire mode: only the"
            f" {FLEET_REDUCTIONS} families ship across processes"
        ),
        domain="fleet",
    )


def delta_since(cur: Dict[str, Any], prev: Optional[Dict[str, Any]], reductions: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Cut the host-side delta payload of ``cur`` against ``prev`` (the last
    exported canonical state). ``prev=None`` is a full export: every field
    ships its current value. All arithmetic is host numpy: integer
    subtraction is exact, and float fields never subtract."""
    from torchmetrics_tpu_torch import obs

    out: Dict[str, np.ndarray] = {}
    for name, value in cur.items():
        arr = np.asarray(value)
        if prev is None:
            out[name] = np.array(arr)
            continue
        ref = np.asarray(prev[name])
        mode = field_mode(reductions.get(name), arr.dtype)
        if mode == "add":
            out[name] = arr - ref
        elif mode == "suffix":
            base = np.atleast_1d(ref)
            rows = np.atleast_1d(arr)
            if rows.shape[0] < base.shape[0]:
                raise obs.flighted(
                    FleetProtocolError(
                        f"cat field {name!r} shrank ({base.shape[0]} -> {rows.shape[0]} rows)"
                        " between exports: a reset requires a full resync"
                        " (LeafExporter.mark_resync)"
                    ),
                    domain="fleet",
                )
            out[name] = np.array(rows[base.shape[0]:])
        else:  # replace / merge: the full current value
            out[name] = np.array(arr)
    return out


def to_host(value: Any) -> np.ndarray:
    """A merged value as host numpy (``merge_folded`` returns CPU tensors)."""
    if hasattr(value, "numpy") and not isinstance(value, np.ndarray):
        return np.asarray(value.numpy())
    return np.asarray(value)


def apply_delta(acc: Optional[Dict[str, Any]], delta_host: Dict[str, Any], reductions: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Fold one decoded delta payload into a leaf's accumulated canonical
    state. ``add``/``merge``/``suffix`` fields go through the segment merge
    :func:`~torchmetrics_tpu_torch.parallel.reshard.merge_folded` (sum/mean
    add, max/min idempotent, cat append) and come back as host numpy of the
    same dtype; ``replace`` fields overwrite the slot. ``acc=None`` (or a
    full resync) is the identity."""
    from torchmetrics_tpu_torch.parallel.reshard import merge_folded

    if acc is None:
        return {k: np.asarray(v) for k, v in delta_host.items()}
    merge_part: Dict[str, Any] = {}
    replace_part: Dict[str, np.ndarray] = {}
    for name, value in delta_host.items():
        arr = np.asarray(value)
        if field_mode(reductions.get(name), arr.dtype) == "replace":
            replace_part[name] = arr
        else:
            merge_part[name] = arr
    baseline = {k: acc[k] for k in merge_part if k in acc}
    merged = merge_folded(baseline, merge_part, reductions)
    out = dict(acc)
    out.update({k: to_host(v) for k, v in merged.items()})
    out.update(replace_part)
    return out


class LeafLedger:
    """One leaf's exactly-once merge state at an aggregator.

    ``applied_epoch`` is the high-water mark of *consecutively* applied
    epochs; ``acc`` the accumulated canonical state those epochs produced.
    :meth:`offer` is the single entry point: it never raises on transport
    realities (duplicates, reorders and loss show up as counters and acks),
    only on protocol violations (:class:`FleetProtocolError`).
    """

    def __init__(self, leaf: str, watermark: int = DEFAULT_WATERMARK) -> None:
        if watermark < 1:
            raise ValueError(f"watermark must be >= 1, got {watermark}")
        self.leaf = leaf
        self.watermark = int(watermark)
        self.applied_epoch = 0
        self.update_count = 0
        self.acc: Optional[Dict[str, np.ndarray]] = None
        self.reductions: Dict[str, Any] = {}
        self.pending: Dict[int, Delta] = {}
        self.needs_full = False
        self.quarantined = False
        self.last_applied_s: Optional[float] = None
        self.stats = {
            "applied": 0,
            "duplicates": 0,
            "reordered": 0,
            "late_dropped": 0,
            "corrupt_dropped": 0,
            "quarantines": 0,
            "resyncs": 0,
        }

    # ------------------------------------------------------------------ offer

    def offer(self, delta: Delta) -> Dict[str, Any]:
        """Apply, buffer or drop ``delta`` per the exactly-once rules and
        return the ledger's half of the ack (``applied_epoch``, ``needs_full``)."""
        from torchmetrics_tpu_torch import obs

        if delta.leaf != self.leaf:
            raise obs.flighted(
                FleetProtocolError(
                    f"ledger for {self.leaf!r} offered a delta from {delta.leaf!r}", leaf=delta.leaf, epoch=delta.epoch
                ),
                domain="fleet",
            )
        if delta.kind not in DELTA_KINDS:
            raise obs.flighted(
                FleetProtocolError(
                    f"unknown delta kind {delta.kind!r} (expected one of {DELTA_KINDS})",
                    leaf=delta.leaf,
                    epoch=delta.epoch,
                ),
                domain="fleet",
            )
        if delta.epoch < 1:
            raise obs.flighted(
                FleetProtocolError(
                    f"epoch counters are 1-based and monotonic, got {delta.epoch}", leaf=delta.leaf, epoch=delta.epoch
                ),
                domain="fleet",
            )
        if delta.checksum is not None and payload_checksum(delta.payload) != delta.checksum:
            # corrupted in flight: the payload no longer matches the digest
            # the exporter stamped. NEVER merge (an accumulation extended by
            # corrupt bits cannot be repaired by later deltas): drop it and
            # quarantine the leaf, so the next ack demands a full resync. A
            # transport fault, not a protocol violation: no raise (the uplink
            # never retries FleetProtocolError; the resync heals).
            self.needs_full = True
            self.quarantined = True
            self.pending.clear()
            self.stats["corrupt_dropped"] += 1
            self.stats["quarantines"] += 1
            obs.counter_inc("fleet.deltas_corrupt")
            obs.fault_breadcrumb(
                "fleet_delta_corrupt",
                domain="integrity",
                data={"leaf": delta.leaf, "epoch": delta.epoch, "kind": delta.kind, "expected": delta.checksum},
            )
            return {"leaf": self.leaf, "applied_epoch": self.applied_epoch, "needs_full": True}

        if delta.kind == "full":
            if delta.epoch <= self.applied_epoch:
                # a re-shipped resync whose ack was lost: installing it would
                # ROLL BACK every epoch applied since; drop it as a duplicate
                self.stats["duplicates"] += 1
            else:
                # a resync replaces the whole per-leaf accumulation and
                # re-anchors the epoch clock: the rejoin path for partitions,
                # quarantines and leaves a failover successor has no snapshot of
                self._install_full(delta)
                self._drain()
        elif self.needs_full:
            # quarantined: deltas cannot extend an accumulation whose
            # continuity is lost; count and wait for the resync
            self.stats["late_dropped"] += 1
        elif delta.epoch <= self.applied_epoch:
            self.stats["duplicates"] += 1
        elif delta.epoch == self.applied_epoch + 1:
            self._apply(delta)
            self._drain()
        else:
            self.stats["reordered"] += 1
            self.pending[delta.epoch] = delta
            if delta.epoch - self.applied_epoch - 1 > self.watermark:
                # the gap outlived the reorder window: continuity is lost
                self.needs_full = True
                self.quarantined = True
                self.pending.clear()
                self.stats["quarantines"] += 1
        return {"leaf": self.leaf, "applied_epoch": self.applied_epoch, "needs_full": self.needs_full}

    # -------------------------------------------------------------- internals

    def _decode(self, delta: Delta) -> Dict[str, np.ndarray]:
        from torchmetrics_tpu_torch.parallel.quantized import decode_canonical

        return decode_canonical(delta.payload)

    def _install_full(self, delta: Delta) -> None:
        self.acc = self._decode(delta)
        self.reductions = dict(delta.reductions)
        self.applied_epoch = int(delta.epoch)
        self.update_count = int(delta.update_count)
        self.pending = {e: d for e, d in self.pending.items() if e > delta.epoch}
        self.needs_full = False
        self.quarantined = False
        self.last_applied_s = time.time()
        self.stats["resyncs"] += 1
        self.stats["applied"] += 1

    def _apply(self, delta: Delta) -> None:
        self.reductions = dict(delta.reductions)
        self.acc = apply_delta(self.acc, self._decode(delta), self.reductions)
        self.applied_epoch = int(delta.epoch)
        self.update_count = int(delta.update_count)
        self.last_applied_s = time.time()
        self.stats["applied"] += 1

    def _drain(self) -> None:
        while self.applied_epoch + 1 in self.pending:
            self._apply(self.pending.pop(self.applied_epoch + 1))

    # ----------------------------------------------------------------- export

    def export(self) -> Dict[str, Any]:
        """A plain-data view (builtins and numpy only) for aggregator
        snapshots: either package restores it."""
        return {
            "leaf": self.leaf,
            "watermark": self.watermark,
            "applied_epoch": self.applied_epoch,
            "update_count": self.update_count,
            "acc": None if self.acc is None else {k: np.array(v) for k, v in self.acc.items()},
            "reductions": dict(self.reductions),
            "needs_full": self.needs_full,
            "quarantined": self.quarantined,
            "stats": dict(self.stats),
        }

    @classmethod
    def restore(cls, blob: Dict[str, Any]) -> "LeafLedger":
        ledger = cls(blob["leaf"], watermark=blob.get("watermark", DEFAULT_WATERMARK))
        ledger.applied_epoch = int(blob["applied_epoch"])
        ledger.update_count = int(blob["update_count"])
        ledger.acc = blob["acc"]
        ledger.reductions = dict(blob["reductions"])
        ledger.needs_full = bool(blob["needs_full"])
        ledger.quarantined = bool(blob["quarantined"])
        ledger.stats.update(blob.get("stats", {}))
        return ledger
