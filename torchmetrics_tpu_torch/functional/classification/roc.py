"""ROC curve, built on the precision-recall curve's state."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Curve,
    Thresholds,
    _binary_clf_curve,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _keep_valid,
    _macro_interp_merge,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _per_class_curves,
    _per_label_curves,
    _task_count,
)
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _binary_roc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    thresholds: Optional[torch.Tensor],
    pos_label: int = 1,
) -> Curve:
    """(fpr, tpr, thresholds) with fpr ascending."""
    if thresholds is not None and isinstance(state, torch.Tensor):
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        tns = state[:, 0, 0]
        # binned mode returns exactly T points, no synthetic (0, 0) endpoint
        tpr = _safe_divide(tps, tps + fns).flip(0)
        fpr = _safe_divide(fps, fps + tns).flip(0)
        return fpr, tpr, thresholds.flip(0)
    fps, tps, thresh = _binary_clf_curve(*state)
    # prepend a (0, 0) point at threshold 1.0
    zero = torch.zeros(1, dtype=torch.float64, device=tps.device)
    tps = torch.cat([zero, tps])
    fps = torch.cat([zero, fps])
    thresh = torch.cat([torch.ones(1, dtype=thresh.dtype, device=thresh.device), thresh])
    tpr = torch.nan_to_num(tps / tps[-1]) * (tps[-1] != 0)
    fpr = torch.nan_to_num(fps / fps[-1]) * (fps[-1] != 0)
    return fpr.to(torch.float32), tpr.to(torch.float32), thresh


def binary_roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curve:
    """Binary ROC (functional interface). Returns (fpr, tpr, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_roc
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> [[round(x, 4) for x in v.tolist()] for v in binary_roc(preds, target)]
        [[0.0, 0.0, 0.5, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0, 1.0], [1.0, 0.8, 0.6, 0.3, 0.2]]
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds, ignore_index=ignore_index)
    if state is None:
        state = _keep_valid(preds, target, valid)
    return _binary_roc_compute(state, thresholds)


def _multiclass_roc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_classes: int,
    thresholds: Optional[torch.Tensor],
    average: Optional[str] = None,
):
    if average == "micro":
        return _binary_roc_compute(state, thresholds)
    if thresholds is not None and isinstance(state, torch.Tensor):
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        tns = state[:, :, 0, 0]
        # exactly T points per class, no synthetic (0, 0) endpoint
        tpr = _safe_divide(tps, tps + fns).flip(0).T
        fpr = _safe_divide(fps, fps + tns).flip(0).T
        if average == "macro":
            return _macro_interp_merge(fpr, tpr, thresholds.repeat(num_classes), descending=True)
        return fpr, tpr, thresholds.flip(0)
    fpr, tpr, thresh = _per_class_curves(state, num_classes, _binary_roc_compute)
    if average == "macro":
        return _macro_interp_merge(fpr, tpr, torch.cat(thresh), descending=True)
    return fpr, tpr, thresh


def multiclass_roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Multiclass one-vs-rest ROC (functional interface).

    ``average``: ``"micro"`` one-hot-flattens into a single binary ROC;
    ``"macro"`` interpolation-merges the per-class curves.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_roc
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> result = multiclass_roc(preds, target, num_classes=3, thresholds=5)
        >>> [tuple(v.shape) for v in result]
        [(3, 5), (3, 5), (5,)]
    """
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds, average)
    if state is None:
        state = _keep_valid(preds, target, valid)
    return _multiclass_roc_compute(state, num_classes, thresholds, average)


def _multilabel_roc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    valid: Optional[torch.Tensor] = None,
):
    if thresholds is not None and isinstance(state, torch.Tensor):
        return _multiclass_roc_compute(state, num_labels, thresholds)
    return _per_label_curves(state, num_labels, valid, _binary_roc_compute)


def multilabel_roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Per-label ROC (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_roc
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> result = multilabel_roc(preds, target, num_labels=3, thresholds=5)
        >>> [tuple(v.shape) for v in result]
        [(3, 5), (3, 5), (5,)]
    """
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    if state is None:
        return _multilabel_roc_compute((preds, target), num_labels, None, valid)
    return _multilabel_roc_compute(state, num_labels, thresholds)


def roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """ROC of any task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import roc
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> result = roc(preds, target, task="binary", thresholds=5)
        >>> [tuple(v.shape) for v in result]
        [(5,), (5,), (5,)]
    """
    task = ClassificationTask.from_str(task)
    _task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_roc(preds, target, num_classes, thresholds, ignore_index=ignore_index, validate_args=validate_args)
    return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
