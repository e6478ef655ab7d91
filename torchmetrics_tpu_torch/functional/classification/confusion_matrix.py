"""Confusion matrix, normalize in {none, true, pred, all}.

Counting is the flattened-bincount trick; the multiclass and multilabel
forms go through the ``"bincount"`` kernel (ops/bincount.py), ``ignore_index``
is masked by weight.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _plain_confusion_counts,
    _sigmoid_if_logits,
)
from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
from torchmetrics_tpu_torch.utils.checks import _check_same_shape, _unique_values
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

_ALLOWED_NORMALIZE = ("true", "pred", "all", "none", None)


def _confusion_matrix_reduce(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    """Normalize a (..., C, C) confusion matrix."""
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=-1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=-2, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum(dim=(-2, -1), keepdim=True)
        confmat = torch.where(torch.isnan(confmat), torch.zeros_like(confmat), confmat)
    return confmat


def _check_normalize(normalize: Optional[str]) -> None:
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Expected argument `normalize` to be one of {_ALLOWED_NORMALIZE}, but got {normalize}.")


def _check_ignore_index(ignore_index: Optional[int]) -> None:
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _check_binary_values(preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int]) -> None:
    unique_values = _unique_values(target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique_values.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if not preds.is_floating_point():
        unique_p = _unique_values(preds)
        if not unique_p.issubset({0, 1}):
            raise RuntimeError(
                f"Detected the following values in `preds`: {sorted(unique_p)} but expected only 0s and 1s."
            )


# --------------------------------------------------------------------- binary

def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _binary_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    _check_binary_values(preds, target, ignore_index)


def _binary_confusion_matrix_format(
    preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    if preds.is_floating_point():
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    else:
        preds = preds.to(torch.int32)
    if ignore_index is not None:
        valid = target != ignore_index
    else:
        valid = torch.ones_like(target, dtype=torch.bool)
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid


def _binary_confusion_matrix_update(preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    idx = torch.where(valid, target * 2 + preds, -1)
    return _plain_confusion_counts(idx, 4).reshape(2, 2).to(torch.int32)


def _binary_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary confusion matrix (functional interface)."""
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target, valid)
    return _binary_confusion_matrix_compute(confmat, normalize)


# ----------------------------------------------------------------- multiclass

def _multiclass_confusion_matrix_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _multiclass_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
    elif preds.ndim != target.ndim:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be"
                         " (N, ...) and `preds` should be (N, C, ...).")


def _multiclass_confusion_matrix_format(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if preds.ndim == target.ndim + 1:
        preds = preds.argmax(dim=1)
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    if ignore_index is not None:
        valid = target != ignore_index
    else:
        valid = torch.ones_like(target, dtype=torch.bool)
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid


def _multiclass_confusion_matrix_update(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, num_classes: int
) -> torch.Tensor:
    p = torch.clamp(preds.to(torch.int32), 0, num_classes - 1)
    idx = torch.where(valid, target * num_classes + p, torch.full_like(p, -1))  # masked samples dropped
    return weighted_bincount(idx, length=num_classes * num_classes).reshape(num_classes, num_classes)


def _multiclass_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass confusion matrix (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_confusion_matrix
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> multiclass_confusion_matrix(preds, torch.tensor([0, 1, 2, 0]), num_classes=3).tolist()
        [[1, 1, 0], [0, 1, 0], [0, 0, 1]]
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, valid, num_classes)
    return _multiclass_confusion_matrix_compute(confmat, normalize)


# ----------------------------------------------------------------- multilabel

def _multilabel_confusion_matrix_arg_validation(
    num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _multilabel_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )


def _multilabel_confusion_matrix_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if preds.is_floating_point():
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    if ignore_index is not None:
        valid = target != ignore_index
    else:
        valid = torch.ones_like(target, dtype=torch.bool)
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    preds = torch.where(valid, preds, torch.zeros_like(preds))
    return preds, target, valid


def _multilabel_confusion_matrix_update(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, num_labels: int
) -> torch.Tensor:
    label_idx = torch.arange(num_labels, dtype=torch.int32, device=target.device)[None, :]
    idx = label_idx * 4 + target * 2 + preds.to(torch.int32)
    idx = torch.where(valid, idx, torch.full_like(idx, -1))  # masked samples dropped
    return weighted_bincount(idx, length=num_labels * 4).reshape(num_labels, 2, 2)


def _multilabel_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel confusion matrix (functional interface)."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, valid, num_labels)
    return _multilabel_confusion_matrix_compute(confmat, normalize)


def confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task-dispatching confusion matrix (functional interface)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_confusion_matrix(preds, target, num_labels, threshold, normalize, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
