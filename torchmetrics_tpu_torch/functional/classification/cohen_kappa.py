"""Cohen's kappa (functional interface)."""
from __future__ import annotations

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
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _check_weights(weights: Optional[str]) -> None:
    if weights not in (None, "linear", "quadratic"):
        raise ValueError(
            "Received an invalid value for argument `weights`, expected one of None, 'linear',"
            f" 'quadratic' but got {weights}"
        )


def _cohen_kappa_reduce(confmat: torch.Tensor, weights: Optional[str] = None) -> torch.Tensor:
    """Kappa of a confusion matrix (float32), unweighted or with 'linear' or
    'quadratic' disagreement weights."""
    _check_weights(weights)
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[-1]
    sum0 = confmat.sum(0, keepdim=True)
    sum1 = confmat.sum(1, keepdim=True)
    expected = sum1 @ sum0 / sum0.sum()
    if weights is None:
        w_mat = 1 - torch.eye(n_classes, device=confmat.device)
    else:
        w_mat = torch.arange(n_classes, dtype=torch.float32, device=confmat.device)
        w_mat = torch.abs(w_mat[:, None] - w_mat[None, :])
        if weights == "quadratic":
            w_mat = w_mat**2
    k = (w_mat * confmat).sum() / (w_mat * expected).sum()
    return 1 - k


def binary_cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary Cohen's kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_cohen_kappa
        >>> round(float(binary_cohen_kappa(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))), 4)
        0.0
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _cohen_kappa_reduce(_binary_confusion_matrix_update(preds, target, valid), weights)


def multiclass_cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass Cohen's kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_cohen_kappa
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_cohen_kappa(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.6364
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _cohen_kappa_reduce(_multiclass_confusion_matrix_update(preds, target, valid, num_classes), weights)


def cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task-dispatching Cohen's kappa (binary or multiclass)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
