"""Accuracy (functional interface)."""
from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification._stats_helper import (
    _binary_stats,
    _multiclass_stats,
    _multilabel_stats,
)
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _accuracy_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> torch.Tensor:
    """Reduce stat scores into accuracy."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        if tp.ndim:
            dim = 0 if multidim_average == "global" else 1
            tp, fn, fp, tn = (s.sum(dim) for s in (tp, fn, fp, tn))
        if multilabel:
            return _safe_divide(tp + tn, tp + tn + fp + fn)
        return _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def binary_accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary accuracy (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_accuracy
        >>> round(float(binary_accuracy(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))), 4)
        0.5
    """
    tp, fp, tn, fn = _binary_stats(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass accuracy (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_accuracy
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_accuracy(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.8333
    """
    tp, fp, tn, fn = _multiclass_stats(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k)


def multilabel_accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel accuracy (functional interface)."""
    tp, fp, tn, fn = _multilabel_stats(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)


def accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: Optional[str] = "global",
    top_k: Optional[int] = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task-dispatching accuracy."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_accuracy(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_accuracy(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_accuracy(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
