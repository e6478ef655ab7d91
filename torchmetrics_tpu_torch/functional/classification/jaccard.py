"""Jaccard index / IoU (functional interface)."""
from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification._stats_helper import (
    _binary_stats,
    _multiclass_stats,
    _multilabel_stats,
)
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _jaccard_index_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Jaccard = tp / (tp + fp + fn), class-averaged per ``average``.

    For "macro", classes absent from both preds and target (union == 0) are
    excluded from the mean; an in-range ``ignore_index`` class is excluded
    from every average.
    """
    if average == "binary":
        return _safe_divide(tp, tp + fp + fn)
    keep = torch.ones_like(tp, dtype=torch.bool)
    if ignore_index is not None and tp.ndim >= 1 and 0 <= ignore_index < tp.shape[-1]:
        keep = torch.arange(tp.shape[-1], device=tp.device) != ignore_index
    if average == "micro":
        return _safe_divide((tp * keep).sum(), ((tp + fp + fn) * keep).sum())
    scores = _safe_divide(tp, tp + fp + fn)
    if average in (None, "none"):
        return scores
    if average == "macro":
        present = ((tp + fp + fn) > 0) & keep
        return _safe_divide((scores * present).sum(-1), present.sum(-1))
    weights = (tp + fn).to(torch.float32) * keep
    return _safe_divide((scores * weights).sum(-1), weights.sum(-1))


def binary_jaccard_index(preds, target, threshold=0.5, ignore_index=None, validate_args=True):
    """Binary Jaccard index (functional interface)."""
    tp, fp, tn, fn = _binary_stats(preds, target, threshold, "global", ignore_index, validate_args)
    return _jaccard_index_reduce(tp, fp, tn, fn, average="binary")


def multiclass_jaccard_index(preds, target, num_classes, average="macro", ignore_index=None, validate_args=True):
    """Multiclass Jaccard index (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_jaccard_index
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_jaccard_index(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.6667
    """
    tp, fp, tn, fn = _multiclass_stats(preds, target, num_classes, average, 1, "global", ignore_index, validate_args)
    return _jaccard_index_reduce(tp, fp, tn, fn, average=average, ignore_index=ignore_index)


def multilabel_jaccard_index(preds, target, num_labels, threshold=0.5, average="macro", ignore_index=None, validate_args=True):
    """Multilabel Jaccard index (functional interface)."""
    tp, fp, tn, fn = _multilabel_stats(preds, target, num_labels, threshold, average, "global", ignore_index, validate_args)
    return _jaccard_index_reduce(tp, fp, tn, fn, average=average)


def jaccard_index(
    preds,
    target,
    task,
    threshold=0.5,
    num_classes=None,
    num_labels=None,
    average="macro",
    ignore_index=None,
    validate_args=True,
):
    """Task-dispatching Jaccard index (functional interface)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_jaccard_index(preds, target, num_labels, threshold, average, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
