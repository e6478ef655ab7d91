"""Calibration error (ECE with ``norm="l1"``, MCE with ``"max"``, RMS with ``"l2"``).

Binned confidence calibration: the state is the per-bin ``(count,
confidence sum, accuracy sum)``, built with one K = 3 weighted ``bincount``
(the ``bincount`` kernel on the card). Ignored samples take the index -1,
which the count drops, so no update reads back to the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_tensor_validation,
    _check_ignore_index,
    _multiclass_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits, _softmax_if_logits
from torchmetrics_tpu_torch.ops.bincount import weighted_bincount_multi
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel

Bins = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _ce_update_binned(
    confidences: torch.Tensor, accuracies: torch.Tensor, n_bins: int, valid: Optional[torch.Tensor] = None
) -> Bins:
    """One batch's ``(count, conf_sum, acc_sum)`` per fixed equal-width bin;
    samples where ``valid`` is False are left out. The three ``(n_bins,)``
    float32 sums are the whole sufficient statistic of fixed-bin calibration
    error and add across batches."""
    indices = torch.clamp((confidences * n_bins).to(torch.int32), 0, n_bins - 1)
    if valid is not None:
        indices = torch.where(valid, indices, torch.full_like(indices, -1))
    weights = torch.stack([torch.ones_like(confidences), confidences, accuracies.to(confidences.dtype)])
    count, conf, acc = weighted_bincount_multi(indices, weights, n_bins)
    return count, conf, acc


def _ce_compute_binned(bin_count: torch.Tensor, bin_conf: torch.Tensor, bin_acc: torch.Tensor, norm: str = "l1") -> torch.Tensor:
    """Calibration error from the accumulated per-bin sums."""
    prop_bin = bin_count / bin_count.sum()
    conf_bin = _safe_divide(bin_conf, bin_count)
    acc_bin = _safe_divide(bin_acc, bin_count)
    if norm == "l1":
        return ((acc_bin - conf_bin).abs() * prop_bin).sum()
    if norm == "max":
        return torch.max((acc_bin - conf_bin).abs() * (prop_bin > 0))
    if norm == "l2":
        return torch.sqrt(((acc_bin - conf_bin) ** 2 * prop_bin).sum())
    raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")


def _ce_compute(
    confidences: torch.Tensor,
    accuracies: torch.Tensor,
    n_bins: int,
    norm: str = "l1",
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Calibration error of a set of samples, through the same binned
    statistic the modular metric accumulates."""
    return _ce_compute_binned(*_ce_update_binned(confidences, accuracies, n_bins, valid), norm)


def _binary_calibration_error_arg_validation(n_bins: int, norm: str, ignore_index: Optional[int]) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    _check_ignore_index(ignore_index)


def _binary_calibration_error_update(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Bins:
    """(confidences, accuracies, valid) of a binary batch.

    The confidence is the raw positive-class probability and the accuracy
    the raw 0/1 target, not the top-label ``max(p, 1-p)`` convention of the
    multiclass task: binning by p and by ``max(p, 1-p)`` groups samples
    differently."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    preds = _sigmoid_if_logits(preds) if preds.is_floating_point() else preds.to(torch.float32)
    valid = target != ignore_index if ignore_index is not None else torch.ones_like(target, dtype=torch.bool)
    return preds, target == 1, valid


def _multiclass_calibration_error_update(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Bins:
    """(top-label confidences, correctness, valid) of a multiclass batch."""
    preds = _softmax_if_logits(preds.movedim(1, -1).reshape(-1, num_classes), dim=-1)
    target = target.reshape(-1)
    valid = target != ignore_index if ignore_index is not None else torch.ones_like(target, dtype=torch.bool)
    return preds.max(-1).values, preds.argmax(-1) == target, valid


def binary_calibration_error(
    preds: torch.Tensor,
    target: torch.Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary calibration error (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_calibration_error
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> round(float(binary_calibration_error(preds, target)), 4)
        0.425
    """
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    confidences, accuracies, valid = _binary_calibration_error_update(preds, target, ignore_index)
    return _ce_compute(confidences, accuracies, n_bins, norm, valid)


def multiclass_calibration_error(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass (top-label) calibration error (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_calibration_error
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> round(float(multiclass_calibration_error(preds, target, num_classes=3)), 4)
        0.325
    """
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    confidences, accuracies, valid = _multiclass_calibration_error_update(preds, target, num_classes, ignore_index)
    return _ce_compute(confidences, accuracies, n_bins, norm, valid)


def calibration_error(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Calibration error of a binary or multiclass task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import calibration_error
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> round(float(calibration_error(preds, target, task="multiclass", num_classes=3)), 4)
        0.325
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
    return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
