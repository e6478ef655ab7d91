"""Class-axis state sharding: the layout math and the sparse routing seam.

The counterpart of the JAX package's ``parallel/class_shard.py``. A state
declared dense ``(C, *rest)`` with ``state_sharding="class_axis"`` lives as
a stacked tensor ``(S, shard_size, *rest)``, ``shard_size = ceil(C / S)``:

- shard ``s`` owns dense classes ``[s * shard_size, min((s+1) * shard_size,
  C))`` (:meth:`ClassShardLayout.bounds`);
- the padded tail rows of the last shard hold the reduction identity and
  never receive a contribution, so folds and elementwise merges stay exact;
- the dense value is a reshape plus a trim of the stack
  (:func:`gather_dense`): a view, no arithmetic, no copy.

Routing (:func:`route_scatter_add`). PyTorch's ``index_add`` has no
``mode="drop"``, and an index out of range is a device-side assert on
CUDA, which kills the context. So every contribution nobody owns
(``ignore_index`` holes, labels outside ``[0, C)``, screened rows) is sent
to a SAFE cell, cell 0, with the value 0: it ships, adds nothing and never
reaches an invalid index. The flat cell ``(shard * shard_size + local) *
inner + inner_idx`` is formed in int64 (at 81,313 classes it passes 2^32),
and one out-of-place ``index_add`` on the flattened stack lands every
contribution. Out of place means an update holds the old and the new stack
at once: twice the state at its peak.

Updates add no collective; ``compute`` reads the dense view once.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional, Tuple

import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.parallel.sync import Reduction, reduction_identity
from torchmetrics_tpu_torch.utils.exceptions import TopologyMismatchError

__all__ = [
    "CLASS_SHARDABLE_REDUCTIONS",
    "STATE_SHARDINGS",
    "STATE_SHARDING_ENV",
    "ClassShardLayout",
    "add_dense",
    "default_class_shards",
    "default_state_sharding",
    "gather_dense",
    "identity_pad_value",
    "route_scatter_add",
    "shard_layout",
    "stack_dense",
]

#: valid ``state_sharding`` policies (metric constructor knob / ``add_state`` argument)
STATE_SHARDINGS = ("replicated", "class_axis")

#: process-wide default policy for eligible states
STATE_SHARDING_ENV = "TORCHMETRICS_TPU_STATE_SHARDING"

#: reduction families whose identity pads and elementwise merges keep the
#: stacked class layout exact (the families ``reshard.py`` can re-split)
CLASS_SHARDABLE_REDUCTIONS = ("sum", "mean", "max", "min")


def default_state_sharding() -> str:
    """The process-wide default ``state_sharding`` policy, from
    ``TORCHMETRICS_TPU_STATE_SHARDING`` (``replicated`` when unset). It only
    ever applies to eligible states: fixed-shape tensors of rank >= 1 with a
    reduction in :data:`CLASS_SHARDABLE_REDUCTIONS`."""
    value = os.environ.get(STATE_SHARDING_ENV, "replicated").strip().lower()
    if value not in STATE_SHARDINGS:
        raise ValueError(f"{STATE_SHARDING_ENV} must be one of {STATE_SHARDINGS}, got {value!r}")
    return value


def default_class_shards(device: Optional[torch.device] = None) -> int:
    """Default shard count of a class-axis layout: the number of CUDA devices
    for a metric on the card, 1 on the CPU (the JAX package takes
    ``jax.local_device_count()``, which is 8 on its virtual test mesh)."""
    if device is not None and torch.device(device).type == "cuda":
        return max(1, int(torch.cuda.device_count()))
    return 1


class ClassShardLayout(NamedTuple):
    """One class-sharded field: ``num_classes`` dense rows split into
    ``num_shards`` slices of ``shard_size = ceil(C / S)`` rows, padded to
    ``padded_classes = S * shard_size``."""

    num_classes: int
    num_shards: int

    @property
    def shard_size(self) -> int:
        return -(-self.num_classes // self.num_shards)

    @property
    def padded_classes(self) -> int:
        return self.num_shards * self.shard_size

    def bounds(self, shard: int) -> Tuple[int, int]:
        """Dense class interval ``[start, stop)`` owned by ``shard`` (clipped
        to ``num_classes``; trailing shards past the data own nothing)."""
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard must be in [0, {self.num_shards}), got {shard}")
        start = min(shard * self.shard_size, self.num_classes)
        stop = min(start + self.shard_size, self.num_classes)
        return start, stop


def shard_layout(num_classes: int, num_shards: int) -> ClassShardLayout:
    """Validated :class:`ClassShardLayout` constructor."""
    if int(num_classes) < 1:
        raise ValueError(f"num_classes must be >= 1, got {num_classes}")
    if int(num_shards) < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return ClassShardLayout(int(num_classes), int(num_shards))


def _check_stacked(stacked: torch.Tensor, layout: ClassShardLayout) -> None:
    """Raise when a tensor does not carry ``layout``'s stacked shape, the
    one corruption the reshapes below would otherwise misread."""
    shape = tuple(stacked.shape)
    if len(shape) < 2 or shape[0] != layout.num_shards or shape[1] != layout.shard_size:
        raise obs.flighted(
            TopologyMismatchError(
                f"class-sharded state has shape {shape} but the layout expects"
                f" ({layout.num_shards}, {layout.shard_size}, ...):"
                f" {layout.num_classes} classes over {layout.num_shards} shards"
            ),
            domain="reshard",
        )


def stack_dense(dense: torch.Tensor, layout: ClassShardLayout, pad_value: Any = None) -> torch.Tensor:
    """Split a dense ``(C, *rest)`` tensor into the stacked layout
    ``(S, shard_size, *rest)``, padding the tail with ``pad_value`` (the
    reduction identity for live states; 0 for additive contributions)."""
    if dense.ndim < 1 or dense.shape[0] != layout.num_classes:
        raise obs.flighted(
            TopologyMismatchError(
                f"dense value has shape {tuple(dense.shape)} but the layout expects ({layout.num_classes}, ...)"
            ),
            domain="reshard",
        )
    pad = layout.padded_classes - layout.num_classes
    if pad:
        fill = torch.full((pad,) + tuple(dense.shape[1:]), 0 if pad_value is None else pad_value, dtype=dense.dtype, device=dense.device)
        dense = torch.cat([dense, fill])
    return dense.reshape((layout.num_shards, layout.shard_size) + tuple(dense.shape[1:]))


def gather_dense(stacked: torch.Tensor, layout: ClassShardLayout) -> torch.Tensor:
    """The one read-point gather: stacked ``(S, shard_size, *rest)`` back to
    dense ``(C, *rest)``, a reshape plus a trim (a view of a contiguous
    stack, no copy)."""
    _check_stacked(stacked, layout)
    with obs.device_span(obs.SPAN_CLASS_ROUTE):
        return stacked.reshape((layout.padded_classes,) + tuple(stacked.shape[2:]))[: layout.num_classes]


def route_scatter_add(
    stacked: torch.Tensor,
    class_idx: torch.Tensor,
    values: torch.Tensor,
    inner_idx: Optional[torch.Tensor] = None,
    *,
    layout: ClassShardLayout,
) -> torch.Tensor:
    """Route sparse contributions into the shards that own them; returns a
    new stack (the input is read, never written).

    ``class_idx`` (any shape, flattened) carries one dense class index per
    contribution, ``values`` (the same count) the amount. With ``inner_idx``
    the field's trailing axes are one flattened inner dimension and each
    contribution lands at ``[class, inner]`` (a confusion-matrix cell);
    without it the stack must be ``(S, shard_size)``.

    A contribution whose class lies outside ``[0, num_classes)`` (an
    ``ignore_index`` hole, a screened row, a bad label) lands on cell 0 with
    the value 0: no invalid index ever reaches the scatter. An ``inner_idx``
    outside the inner dimension is dropped the same way.
    """
    _check_stacked(stacked, layout)
    idx = class_idx.reshape(-1).to(torch.int64)
    vals = values.reshape(-1).to(stacked.dtype)
    owned = (idx >= 0) & (idx < layout.num_classes)
    if inner_idx is None:
        if stacked.ndim != 2:
            raise obs.flighted(
                TopologyMismatchError(
                    f"route without inner_idx needs a (S, shard_size) state, got shape {tuple(stacked.shape)}"
                ),
                domain="reshard",
            )
        inner, cell = 1, idx
    else:
        inner = 1
        for d in stacked.shape[2:]:
            inner *= int(d)
        col = inner_idx.reshape(-1).to(torch.int64)
        owned = owned & (col >= 0) & (col < inner)
        # dense class c sits at stacked row c (shard c // shard_size, local
        # c % shard_size): the flat cell is c * inner + col, in int64
        cell = idx * inner + col
    cell = torch.where(owned, cell, torch.zeros_like(cell))
    vals = torch.where(owned, vals, torch.zeros_like(vals))
    obs.counter_inc("shards.routed_updates")
    with obs.device_span(obs.SPAN_CLASS_ROUTE):
        flat = stacked.reshape(-1)
        return flat.index_add(0, cell, vals).reshape(stacked.shape)


def add_dense(stacked: torch.Tensor, dense: torch.Tensor, layout: ClassShardLayout) -> torch.Tensor:
    """Accumulate a DENSE ``(C, *rest)`` additive contribution into the stack
    (the stat-scores family emits dense per-class vectors): zero-pad,
    reshape into the stack, add. Pad rows receive 0."""
    _check_stacked(stacked, layout)
    obs.counter_inc("shards.routed_updates")
    with obs.device_span(obs.SPAN_CLASS_ROUTE):
        return stacked + stack_dense(dense.to(stacked.dtype), layout, pad_value=0)


def identity_pad_value(reduction: Reduction, dtype: torch.dtype) -> Any:
    """The value a live class-sharded state's tail rows carry: the declared
    reduction's identity (0 for sum/mean, -inf/+inf for max/min), as a
    Python scalar."""
    ident = reduction_identity(reduction, dtype)
    return 0 if ident is None else ident.item()
