"""Single-query retrieval functionals.

Each takes 1-D ``preds``/``target`` for ONE query and delegates to the
padded grid functions with a single row, so the functional and modular paths
share one implementation.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _check_retrieval_functional_inputs(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate one query's inputs; returns flat float32 ``(preds, target)``."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.numel() == 0 or preds.ndim == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if not allow_non_binary_target and bool(((target != 0) & (target != 1)).any()):
        raise ValueError("`target` must contain binary values")
    return preds.to(torch.float32).reshape(-1), target.to(torch.float32).reshape(-1)


def _check_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


def _one_row(preds: torch.Tensor, target: torch.Tensor):
    counts = torch.tensor([preds.shape[0]], dtype=torch.int32, device=preds.device)
    ranked_preds, ranked_target = rank_by_preds(preds[None, :], target[None, :])
    return ranked_preds, ranked_target, counts


def retrieval_precision(
    preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None, adaptive_k: bool = False
) -> torch.Tensor:
    """Retrieval precision (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> round(float(retrieval_precision(preds, target)), 4)
        0.4
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    _check_top_k(top_k)
    _, ranked_target, counts = _one_row(preds, target)
    return precision_padded(ranked_target, counts, top_k, adaptive_k)[0]


def retrieval_recall(preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """Retrieval recall (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> round(float(retrieval_recall(preds, target, top_k=2)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_top_k(top_k)
    _, ranked_target, counts = _one_row(preds, target)
    return recall_padded(ranked_target, counts, top_k)[0]


def retrieval_fall_out(preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """Retrieval fall-out (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_fall_out
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> round(float(retrieval_fall_out(preds, target, top_k=2)), 4)
        0.3333
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_top_k(top_k)
    _, ranked_target, counts = _one_row(preds, target)
    return fall_out_padded(ranked_target, counts, top_k)[0]


def retrieval_hit_rate(preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """Retrieval hit rate (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_hit_rate
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> round(float(retrieval_hit_rate(preds, target, top_k=1)), 4)
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_top_k(top_k)
    _, ranked_target, counts = _one_row(preds, target)
    return hit_rate_padded(ranked_target, counts, top_k)[0]


def retrieval_average_precision(
    preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None
) -> torch.Tensor:
    """Retrieval average precision (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> round(float(retrieval_average_precision(preds, target)), 4)
        0.8333
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_top_k(top_k)
    _, ranked_target, counts = _one_row(preds, target)
    return average_precision_padded(ranked_target, counts, top_k)[0]


def retrieval_reciprocal_rank(
    preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None
) -> torch.Tensor:
    """Retrieval reciprocal rank (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, False, False, True])
        >>> round(float(retrieval_reciprocal_rank(preds, target)), 4)
        0.3333
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_top_k(top_k)
    _, ranked_target, counts = _one_row(preds, target)
    return reciprocal_rank_padded(ranked_target, counts, top_k)[0]


def retrieval_r_precision(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Retrieval R-precision (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_r_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> round(float(retrieval_r_precision(preds, target)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _, ranked_target, counts = _one_row(preds, target)
    return r_precision_padded(ranked_target, counts)[0]


def retrieval_normalized_dcg(
    preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None
) -> torch.Tensor:
    """Retrieval normalized DCG with tie-averaged gains (functional interface);
    targets may be graded relevances.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> round(float(retrieval_normalized_dcg(preds, target)), 4)
        0.9599
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    _check_top_k(top_k)
    ranked_preds, ranked_target, counts = _one_row(preds, target)
    return ndcg_padded(ranked_preds, ranked_target, counts, top_k)[0]


def retrieval_auroc(
    preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None, max_fpr: Optional[float] = None
) -> torch.Tensor:
    """Retrieval AUROC over the top k (functional interface); ``max_fpr``
    gives the standardised partial AUC of the classification AUROC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_auroc
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> round(float(retrieval_auroc(preds, target)), 4)
        0.9167
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _check_top_k(top_k)
    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
        # the partial AUC needs the whole ROC curve: the classification AUROC
        from torchmetrics_tpu_torch.functional.classification.auroc import binary_auroc

        k = preds.shape[0] if top_k is None else min(top_k, preds.shape[0])
        order = torch.argsort(-preds, stable=True)[:k]
        return binary_auroc(preds[order], target[order].to(torch.int32), max_fpr=max_fpr)
    ranked_preds, ranked_target, counts = _one_row(preds, target)
    return auroc_padded(ranked_preds, ranked_target, counts, top_k)[0]


def retrieval_precision_recall_curve(
    preds: torch.Tensor, target: torch.Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Retrieval precision and recall at k = 1..max_k (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3])
        >>> target = torch.tensor([False, False, True, False, True])
        >>> precision, recall, top_k = retrieval_precision_recall_curve(preds, target, max_k=3)
        >>> [round(v, 4) for v in precision.tolist()], recall.tolist(), top_k.tolist()
        ([1.0, 0.5, 0.6667], [0.5, 0.5, 1.0], [1, 2, 3])
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if max_k is None:
        max_k = preds.shape[-1]
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    _, ranked_target, counts = _one_row(preds, target)
    precision, recall, topk = precision_recall_curve_padded(ranked_target, counts, max_k, adaptive_k)
    if adaptive_k and max_k > preds.shape[-1]:
        topk = torch.clamp(topk, max=preds.shape[-1])
    return precision[0], recall[0], topk
