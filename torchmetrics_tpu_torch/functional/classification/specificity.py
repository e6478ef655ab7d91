"""Specificity, tn / (tn + fp) (functional interface)."""
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


def _specificity_reduce(
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
        return _safe_divide(tn, tn + fp)
    if average == "micro":
        if tp.ndim:
            dim = 0 if multidim_average == "global" else 1
            tn, fp = tn.sum(dim), fp.sum(dim)
        return _safe_divide(tn, tn + fp)
    return _adjust_weights_safe_divide(_safe_divide(tn, tn + fp), average, multilabel, tp, fp, fn, top_k)


def binary_specificity(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True):
    """Binary specificity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_specificity
        >>> round(float(binary_specificity(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))), 4)
        0.5
    """
    tp, fp, tn, fn = _binary_stats(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _specificity_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_specificity(
    preds, target, num_classes, average="macro", top_k=1, multidim_average="global", ignore_index=None, validate_args=True
):
    """Multiclass specificity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_specificity
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_specificity(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.8889
    """
    tp, fp, tn, fn = _multiclass_stats(preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args)
    return _specificity_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k)


def multilabel_specificity(
    preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global", ignore_index=None, validate_args=True
):
    """Multilabel specificity."""
    tp, fp, tn, fn = _multilabel_stats(preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args)
    return _specificity_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)


specificity = _dispatch(binary_specificity, multiclass_specificity, multilabel_specificity, "specificity")
