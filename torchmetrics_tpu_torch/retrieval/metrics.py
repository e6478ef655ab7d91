"""Modular retrieval metrics.

Each subclass binds one padded grid function; ``RetrievalPrecisionRecallCurve``
overrides ``compute`` since it returns curves rather than per-query scalars.
Every example shares these inputs: two queries, the first with one relevant
document of three, the second with one of two.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.retrieval._padded import (
    auroc_padded,
    average_precision_padded,
    fall_out_padded,
    hit_rate_padded,
    ndcg_padded,
    precision_padded,
    precision_recall_curve_padded,
    r_precision_padded,
    rank_by_preds,
    recall_padded,
    reciprocal_rank_padded,
)
from torchmetrics_tpu_torch.functional.retrieval.metrics import _check_top_k
from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric, _retrieval_aggregate


class _TopKRetrievalMetric(RetrievalMetric):
    def __init__(self, top_k: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_top_k(top_k)
        self.top_k = top_k


class RetrievalMAP(_TopKRetrievalMetric):
    """Mean average precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalMAP(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        1.0
    """

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return average_precision_padded(ranked_target, counts, self.top_k)


class RetrievalMRR(_TopKRetrievalMetric):
    """Mean reciprocal rank.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalMRR(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        1.0
    """

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return reciprocal_rank_padded(ranked_target, counts, self.top_k)


class RetrievalPrecision(RetrievalMetric):
    """Precision@k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalPrecision(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        0.4167
    """

    def __init__(self, top_k: Optional[int] = None, adaptive_k: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_top_k(top_k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.top_k = top_k
        self.adaptive_k = adaptive_k

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return precision_padded(ranked_target, counts, self.top_k, self.adaptive_k)


class RetrievalRecall(_TopKRetrievalMetric):
    """Recall@k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecall
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalRecall(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        1.0
    """

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return recall_padded(ranked_target, counts, self.top_k)


class RetrievalFallOut(_TopKRetrievalMetric):
    """Fall-out@k. A query is empty when it has no NEGATIVE target.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalFallOut
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalFallOut(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        1.0
    """

    higher_is_better = False
    _empty_target_kind = "negative"

    def _empty_mask(self, target_pad: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(target_pad.shape[-1], device=target_pad.device)[None, :]
        valid = pos < counts[:, None]
        return ((1.0 - target_pad) * valid).sum(-1) == 0

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return fall_out_padded(ranked_target, counts, self.top_k)


class RetrievalHitRate(_TopKRetrievalMetric):
    """Hit rate@k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalHitRate
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalHitRate(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        1.0
    """

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return hit_rate_padded(ranked_target, counts, self.top_k)


class RetrievalRPrecision(RetrievalMetric):
    """R-precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalRPrecision(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        1.0
    """

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return r_precision_padded(ranked_target, counts)


class RetrievalNormalizedDCG(_TopKRetrievalMetric):
    """nDCG with tie-averaged gains; targets may be graded relevances.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalNormalizedDCG(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        1.0
    """

    allow_non_binary_target = True

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return ndcg_padded(ranked_preds, ranked_target, counts, self.top_k)


class RetrievalAUROC(_TopKRetrievalMetric):
    """Per-query AUROC over the retrieved documents.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalAUROC
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalAUROC(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> round(float(m.compute()), 4)
        1.0
    """

    def __init__(self, top_k: Optional[int] = None, max_fpr: Optional[float] = None, **kwargs: Any) -> None:
        super().__init__(top_k=top_k, **kwargs)
        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
        self.max_fpr = max_fpr

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        if self.max_fpr is not None:
            # the partial AUC needs each query's ROC curve: query by query
            from torchmetrics_tpu_torch.functional.classification.auroc import binary_auroc

            values = []
            for q, n in enumerate(counts.tolist()):
                k = n if self.top_k is None else min(self.top_k, n)
                values.append(
                    binary_auroc(ranked_preds[q, :k], ranked_target[q, :k].to(torch.int32), max_fpr=self.max_fpr)
                )
            return torch.stack(values)
        return auroc_padded(ranked_preds, ranked_target, counts, self.top_k)


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Precision and recall at k = 1..max_k, aggregated over queries.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecisionRecallCurve
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalPrecisionRecallCurve(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> precision, recall, top_k = m.compute()
        >>> [round(v, 4) for v in precision.tolist()], recall.tolist(), top_k.tolist()
        ([1.0, 0.5, 0.3333], [1.0, 1.0, 1.0], [1, 2, 3])
    """

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        aggregation: Union[str, Callable] = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            empty_target_action=empty_target_action, ignore_index=ignore_index, aggregation=aggregation, **kwargs
        )
        if (max_k is not None) and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        self.max_k = max_k
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        preds_pad, target_pad, counts = self._grouped_state()
        _, ranked_target = rank_by_preds(preds_pad, target_pad)
        max_k = self.max_k if self.max_k is not None else int(counts.max())

        precisions, recalls, top_k = precision_recall_curve_padded(ranked_target, counts, max_k, self.adaptive_k)

        empty = self._empty_mask(target_pad, counts)
        precisions = self._apply_empty_target_action(precisions, empty)
        recalls = self._apply_empty_target_action(recalls, empty)
        if precisions is None or recalls is None:
            z = torch.zeros(max_k, device=self.device)
            return z, z, top_k

        precision = _retrieval_aggregate(precisions, self.aggregation, dim=0)
        recall = _retrieval_aggregate(recalls, self.aggregation, dim=0)
        return precision, recall, top_k

    def _metric_padded(self, ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError  # compute() is overridden whole


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The largest recall@k whose precision@k reaches ``min_precision``, and that k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecallAtFixedPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> m = RetrievalRecallAtFixedPrecision(device="cpu")
        >>> m.update(preds, target, indexes=indexes)
        >>> [float(v) for v in m.compute()]
        [1.0, 3.0]
    """

    def __init__(self, min_precision: float = 0.0, max_k: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(max_k=max_k, **kwargs)
        if not isinstance(min_precision, float) or not 0.0 <= min_precision <= 1.0:
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        precisions, recalls, top_k = super().compute()
        ok = precisions >= self.min_precision
        masked_recall = torch.where(ok, recalls, float("-inf"))
        # the largest recall, ties broken by the larger k
        best_recall = masked_recall.amax()
        if not bool(torch.isfinite(best_recall)) or float(best_recall) == 0.0:
            return torch.tensor(0.0, device=self.device), torch.tensor(int(top_k.shape[0]), dtype=torch.int32, device=self.device)
        is_best = masked_recall == best_recall
        best_k = torch.where(is_best, top_k, torch.zeros_like(top_k)).amax()
        return best_recall, best_k
