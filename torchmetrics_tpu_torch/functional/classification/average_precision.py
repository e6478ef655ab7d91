"""Average precision, AP = -sum_n (R_{n+1} - R_n) * P_n over the PR curve
built from the shared curve state."""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.auroc import _average_scores, _class_weights
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _keep_valid,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _task_count,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _ap_from_curve(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    """AP over one (precision, recall) curve: -sum(diff(R) * P[:-1])."""
    return -torch.sum(torch.diff(recall) * precision[:-1])


def _binary_average_precision_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    thresholds: Optional[torch.Tensor],
    pos_label: int = 1,
) -> torch.Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return _ap_from_curve(precision, recall)


def binary_average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary average precision (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_average_precision
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> round(float(binary_average_precision(preds, target)), 4)
        0.8333
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds, ignore_index=ignore_index)
    if state is None:
        state = _keep_valid(preds, target, valid)
    return _binary_average_precision_compute(state, thresholds)


def _reduce_average_precision(
    precision: Union[torch.Tensor, List[torch.Tensor]],
    recall: Union[torch.Tensor, List[torch.Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if isinstance(precision, (list, tuple)):
        res = torch.stack([_ap_from_curve(p, r) for p, r in zip(precision, recall)])
    else:  # (C, T+1) rows from the binned mode
        res = -torch.sum(torch.diff(recall, dim=1) * precision[:, :-1], dim=1)
    res = torch.where(torch.isnan(res), torch.zeros_like(res), res)
    return _average_scores(res, average, weights)


def multiclass_average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass one-vs-rest average precision (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_average_precision
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> round(float(multiclass_average_precision(preds, target, num_classes=3)), 4)
        1.0
    """
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    weights = _class_weights(target, valid, num_classes) if average == "weighted" else None
    if state is None:
        state = _keep_valid(preds, target, valid)
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _reduce_average_precision(precision, recall, average, weights)


def multilabel_average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel average precision (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_average_precision
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> round(float(multilabel_average_precision(preds, target, num_labels=3)), 4)
        1.0
    """
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    if average == "micro":
        if state is None:
            flat = _keep_valid(preds.reshape(-1), target.reshape(-1), valid.reshape(-1))
            return _binary_average_precision_compute(flat, None)
        return _binary_average_precision_compute(state.sum(1), thresholds)
    if state is None:
        precision, recall, _ = _multilabel_precision_recall_curve_compute(
            (preds, target), num_labels, None, ignore_index, valid
        )
    else:
        precision, recall, _ = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds)
    weights = (target * valid).sum(0).to(torch.float32)
    return _reduce_average_precision(precision, recall, average, weights)


def average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Average precision of any task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import average_precision
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> round(float(average_precision(preds, target, task="multiclass", num_classes=3)), 4)
        1.0
    """
    task = ClassificationTask.from_str(task)
    _task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_average_precision(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_average_precision(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    return multilabel_average_precision(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
