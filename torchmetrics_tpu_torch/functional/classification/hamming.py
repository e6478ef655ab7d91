"""Hamming distance, 1 - accuracy (functional interface)."""
from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification._stats_helper import (
    _binary_stats,
    _multiclass_stats,
    _multilabel_stats,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall import _dispatch
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


def _hamming_distance_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> torch.Tensor:
    if average == "binary":
        return 1 - _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        if tp.ndim:
            dim = 0 if multidim_average == "global" else 1
            tp, fp, tn, fn = (s.sum(dim) for s in (tp, fp, tn, fn))
        if multilabel:
            return 1 - _safe_divide(tp + tn, tp + tn + fp + fn)
        return 1 - _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return 1 - _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def binary_hamming_distance(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True):
    """Binary Hamming distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_hamming_distance
        >>> round(float(binary_hamming_distance(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))), 4)
        0.5
    """
    tp, fp, tn, fn = _binary_stats(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_hamming_distance(
    preds, target, num_classes, average="macro", top_k=1, multidim_average="global", ignore_index=None, validate_args=True
):
    """Multiclass Hamming distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_hamming_distance
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_hamming_distance(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.1667
    """
    tp, fp, tn, fn = _multiclass_stats(preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k)


def multilabel_hamming_distance(
    preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global", ignore_index=None, validate_args=True
):
    """Multilabel Hamming distance."""
    tp, fp, tn, fn = _multilabel_stats(preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)


hamming_distance = _dispatch(
    binary_hamming_distance, multiclass_hamming_distance, multilabel_hamming_distance, "hamming_distance"
)
