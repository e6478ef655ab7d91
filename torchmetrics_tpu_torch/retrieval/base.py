"""``RetrievalMetric``: the base of the query-grouped metrics.

State is three growing lists (indexes, preds, target), or with ``capacity=``
four fixed buffers and a sample count. At compute time the ragged per-query
groups become one padded grid, which every metric evaluates as batched
masked tensor expressions (functional/retrieval/_padded.py). State dtypes
are the JAX package's (int32 indexes, float32 preds and targets), so a state
exported there loads here (``utils/convert.py``).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.retrieval._padded import pad_by_query, rank_by_preds
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import compact_readout, compact_scatter, dim_zero_cat


def _retrieval_aggregate(values: torch.Tensor, aggregation: Union[str, Callable], dim: int = 0) -> torch.Tensor:
    """Aggregate per-query values over ``dim``."""
    if aggregation == "mean":
        return values.mean(dim)
    if aggregation == "median":
        # the lower of the two middle values, as torch.median gives; NaN sorts last
        n = values.shape[dim]
        return torch.sort(values, dim=dim).values.select(dim, (n - 1) // 2)
    if aggregation == "min":
        return values.amin(dim)
    if aggregation == "max":
        return values.amax(dim)
    return aggregation(values, dim=dim)


class RetrievalMetric(Metric, ABC):
    """Base for query-grouped metrics.

    ``update`` takes ``(preds, target, indexes)`` of one shape; ``compute``
    groups by query id and aggregates the per-query ``_metric_padded``
    values, resolving queries with no positive target by
    ``empty_target_action`` in {'error', 'skip', 'neg', 'pos'}.

    ``capacity`` keeps fixed ``(capacity,)`` sample buffers instead of
    growing lists: the first ``capacity`` un-ignored samples are kept, and
    compute warns when more arrived.
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    allow_non_binary_target: bool = False

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        aggregation: Union[str, Callable] = "mean",
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        if not (aggregation in ("mean", "median", "min", "max") or callable(aggregation)):
            raise ValueError(
                "Argument `aggregation` must be one of `mean`, `median`, `min`, `max` or a custom callable function"
                f"which takes tensor of values, but got {aggregation}."
            )
        self.aggregation = aggregation

        if capacity is not None and (not isinstance(capacity, int) or capacity < 1):
            raise ValueError(f"Argument `capacity` expected to be a positive integer, got {capacity}")
        self.capacity = capacity
        if capacity is not None:
            self.add_state("indexes_buffer", torch.zeros(capacity, dtype=torch.int32), dist_reduce_fx="cat", state_sharding="replicated")
            self.add_state("preds_buffer", torch.zeros(capacity, dtype=torch.float32), dist_reduce_fx="cat", state_sharding="replicated")
            self.add_state("target_buffer", torch.zeros(capacity, dtype=torch.float32), dist_reduce_fx="cat", state_sharding="replicated")
            self.add_state("valid_buffer", torch.zeros(capacity, dtype=torch.bool), dist_reduce_fx="cat", state_sharding="replicated")
            self.add_state("sample_count", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        else:
            self.add_state("indexes", [], dist_reduce_fx=None, state_sharding="replicated")
            self.add_state("preds", [], dist_reduce_fx=None, state_sharding="replicated")
            self.add_state("target", [], dist_reduce_fx=None, state_sharding="replicated")

    def update(self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor) -> None:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = (torch.as_tensor(x) for x in (indexes, preds, target))
        if indexes.shape != preds.shape or preds.shape != target.shape:
            raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
        if indexes.is_floating_point() or indexes.is_complex() or indexes.dtype == torch.bool:
            raise ValueError("`indexes` must be a tensor of long integers")
        if not preds.is_floating_point():
            raise ValueError("`preds` must be a tensor of floats")

        if self.capacity is not None:
            valid = (
                torch.ones(indexes.numel(), dtype=torch.bool, device=indexes.device)
                if self.ignore_index is None
                else (target != self.ignore_index).reshape(-1)
            )
            # emptiness is judged after ignore_index filtering; one host read
            # for both checks
            t = target.reshape(-1)
            bad = ((t != 0) & (t != 1) & valid).any() if not self.allow_non_binary_target else valid.new_zeros(())
            any_valid, any_bad = torch.stack([valid.any(), bad]).tolist()
            if indexes.numel() == 0 or not any_valid:
                raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
            if any_bad:
                raise ValueError("`target` must contain binary values")
            bufs = (self.indexes_buffer, self.preds_buffer, self.target_buffer, self.valid_buffer)
            (
                (self.indexes_buffer, self.preds_buffer, self.target_buffer, self.valid_buffer),
                self.sample_count,
            ) = compact_scatter(bufs, (indexes, preds, target, valid), valid, self.sample_count)
            return

        indexes, preds, target = indexes.reshape(-1), preds.reshape(-1), target.reshape(-1)
        if self.ignore_index is not None:
            valid = target != self.ignore_index
            indexes, preds, target = indexes[valid], preds[valid], target[valid]
        if indexes.numel() == 0:
            raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
        if not self.allow_non_binary_target and bool(((target != 0) & (target != 1)).any()):
            raise ValueError("`target` must contain binary values")

        self.indexes.append(indexes.to(torch.int32))
        self.preds.append(preds.to(torch.float32))
        self.target.append(target.to(torch.float32))

    _empty_target_kind: str = "positive"  # which class being absent makes a query "empty"

    def _grouped_state(self):
        """Concatenate the state and pack it into the padded per-query grid."""
        if self.capacity is not None:
            indexes, preds, target = compact_readout(
                (self.indexes_buffer, self.preds_buffer, self.target_buffer),
                self.valid_buffer,
                self.sample_count,
                type(self).__name__,
            )
        else:
            indexes = dim_zero_cat(self.indexes)
            preds = dim_zero_cat(self.preds)
            target = dim_zero_cat(self.target)
        return pad_by_query(indexes, preds, target)

    def _empty_mask(self, target_pad: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        """``(Q,)`` mask of the queries with no positive target."""
        return target_pad.sum(-1) == 0

    def _apply_empty_target_action(self, values: torch.Tensor, empty: torch.Tensor) -> Optional[torch.Tensor]:
        """Resolve empty queries by ``empty_target_action``. ``values`` is
        ``(Q,)`` or ``(Q, K)`` (curves). Returns None when 'skip' drops every
        query; callers substitute their zero result."""
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError(
                f"`compute` method was provided with a query with no {self._empty_target_kind} target."
            )
        mask = empty if values.ndim == 1 else empty[:, None]
        if self.empty_target_action == "pos":
            return torch.where(mask, 1.0, values)
        if self.empty_target_action == "neg":
            return torch.where(mask, 0.0, values)
        if self.empty_target_action == "skip":
            keep = ~empty
            if not bool(keep.any()):
                return None
            return values[keep]
        return values

    def compute(self) -> torch.Tensor:
        preds_pad, target_pad, counts = self._grouped_state()
        ranked_preds, ranked_target = rank_by_preds(preds_pad, target_pad)
        values = self._metric_padded(ranked_preds, ranked_target, counts)
        values = self._apply_empty_target_action(values, self._empty_mask(target_pad, counts))
        if values is None:
            return torch.tensor(0.0, device=self.device)
        return _retrieval_aggregate(values, self.aggregation)

    @abstractmethod
    def _metric_padded(
        self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor
    ) -> torch.Tensor:
        """Per-query metric over the ranked padded grid -> ``(num_queries,)``."""
