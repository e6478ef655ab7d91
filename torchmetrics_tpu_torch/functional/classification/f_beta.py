"""F-beta and F1 (functional interface)."""
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


def _fbeta_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> torch.Tensor:
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    if average == "micro":
        if tp.ndim:
            dim = 0 if multidim_average == "global" else 1
            tp, fn, fp = tp.sum(dim), fn.sum(dim), fp.sum(dim)
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    fbeta_score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    return _adjust_weights_safe_divide(fbeta_score, average, multilabel, tp, fp, fn, top_k)


def _check_beta(beta: float) -> None:
    if not isinstance(beta, float) or beta <= 0:
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def binary_fbeta_score(
    preds, target, beta: float, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True
):
    """Binary F-beta score (functional interface)."""
    if validate_args:
        _check_beta(beta)
    tp, fp, tn, fn = _binary_stats(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average="binary", multidim_average=multidim_average)


def multiclass_fbeta_score(
    preds, target, beta: float, num_classes, average="macro", top_k=1, multidim_average="global", ignore_index=None, validate_args=True
):
    """Multiclass F-beta score (functional interface)."""
    if validate_args:
        _check_beta(beta)
    tp, fp, tn, fn = _multiclass_stats(preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average, top_k=top_k)


def multilabel_fbeta_score(
    preds, target, beta: float, num_labels, threshold=0.5, average="macro", multidim_average="global", ignore_index=None, validate_args=True
):
    """Multilabel F-beta score (functional interface)."""
    if validate_args:
        _check_beta(beta)
    tp, fp, tn, fn = _multilabel_stats(preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average, multilabel=True)


def binary_f1_score(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True):
    """Binary F1 score (functional interface)."""
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args)


def multiclass_f1_score(
    preds, target, num_classes, average="macro", top_k=1, multidim_average="global", ignore_index=None, validate_args=True
):
    """Multiclass F1 score (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_f1_score
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_f1_score(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.7778
    """
    return multiclass_fbeta_score(
        preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )


def multilabel_f1_score(
    preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global", ignore_index=None, validate_args=True
):
    """Multilabel F1 score (functional interface)."""
    return multilabel_fbeta_score(
        preds, target, 1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )


def fbeta_score(
    preds,
    target,
    task,
    beta: float = 1.0,
    threshold=0.5,
    num_classes=None,
    num_labels=None,
    average="micro",
    multidim_average="global",
    top_k=1,
    ignore_index=None,
    validate_args=True,
):
    """Task-dispatching F-beta score (functional interface)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_fbeta_score(
            preds, target, beta, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_fbeta_score(
            preds, target, beta, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")


def f1_score(
    preds,
    target,
    task,
    threshold=0.5,
    num_classes=None,
    num_labels=None,
    average="micro",
    multidim_average="global",
    top_k=1,
    ignore_index=None,
    validate_args=True,
):
    """Task-dispatching F1 score (functional interface)."""
    return fbeta_score(
        preds, target, task, 1.0, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args
    )
