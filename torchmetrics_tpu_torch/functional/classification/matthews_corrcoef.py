"""Matthews correlation coefficient (functional interface)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

_EPS = float(torch.finfo(torch.float32).eps)


def _matthews_corrcoef_reduce(confmat: torch.Tensor) -> torch.Tensor:
    """The generalised R_k statistic of a (C, C) confusion matrix, in float32
    as the JAX package computes it.

    A multilabel (L, 2, 2) matrix is summed into one binary matrix. The
    degenerate cases follow the reference: binary with no fp and fn gives 1,
    with no tp and tn -1, a zero denominator the eps-regularised estimate;
    multiclass with a zero denominator gives 0.
    """
    if confmat.ndim == 3:
        confmat = confmat.sum(0)
    confmat = confmat.to(torch.float32)
    tk = confmat.sum(1)
    pk = confmat.sum(0)
    c = torch.trace(confmat)
    s = confmat.sum()
    cov_ytyp = c * s - (tk * pk).sum()
    cov_ypyp = s**2 - (pk * pk).sum()
    cov_ytyt = s**2 - (tk * tk).sum()
    denom = cov_ypyp * cov_ytyt
    general = cov_ytyp / torch.sqrt(torch.where(denom == 0, torch.ones_like(denom), denom))
    zero = torch.zeros_like(general)
    if confmat.shape[0] != 2:
        return torch.where(denom == 0, zero, general)

    tn, fp, fn, tp = confmat.reshape(-1)
    # only the zeroed side contributes to the estimate
    a = torch.where((tp == 0) | (tn == 0), tp + tn, zero)
    b = torch.where((fp == 0) | (fn == 0), fp + fn, zero)
    eps_num = math.sqrt(_EPS) * (a - b)
    eps_den = (tp + fp + _EPS) * (tp + fn + _EPS) * (tn + fp + _EPS) * (tn + fn + _EPS)
    mcc = torch.where(denom == 0, eps_num / torch.sqrt(eps_den), general)
    mcc = torch.where((tp + tn != 0) & (fp + fn == 0), torch.ones_like(mcc), mcc)
    return torch.where((tp + tn == 0) & (fp + fn != 0), -torch.ones_like(mcc), mcc)


def binary_matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary Matthews correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_matthews_corrcoef
        >>> round(float(binary_matthews_corrcoef(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))), 4)
        0.0
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_binary_confusion_matrix_update(preds, target, valid))


def multiclass_matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass Matthews correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_matthews_corrcoef
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_matthews_corrcoef(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.7
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _matthews_corrcoef_reduce(_multiclass_confusion_matrix_update(preds, target, valid, num_classes))


def multilabel_matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel Matthews correlation coefficient (the labels' matrices summed)."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_multilabel_confusion_matrix_update(preds, target, valid, num_labels))


def matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task-dispatching Matthews correlation coefficient."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
