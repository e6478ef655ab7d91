"""Hinge loss: binary, and multiclass in the ``crammer-singer`` and
``one-vs-all`` modes, optionally squared.

Where the JAX package drops ``ignore_index`` samples with a host-side
boolean index, the port zeroes their losses and counts only the valid
samples in the total, so an update never waits for the device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits, _softmax_if_logits
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel

_MODES = ("crammer-singer", "one-vs-all")


def _hinge_loss_compute(measure: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return measure / total


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_hinge_loss_arg_validation(squared: bool, multiclass_mode: str, ignore_index: Optional[int] = None) -> None:
    if multiclass_mode not in _MODES:
        raise ValueError(
            f"Expected argument `multiclass_mode` to be one of 'crammer-singer', 'one-vs-all' but got {multiclass_mode}"
        )
    _binary_hinge_loss_arg_validation(squared, ignore_index)


def _valid(target: torch.Tensor, ignore_index: Optional[int]) -> Optional[torch.Tensor]:
    return None if ignore_index is None else target != ignore_index


def _masked_sum(losses: torch.Tensor, valid: Optional[torch.Tensor], dim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the valid samples' losses, their float32 count)."""
    if valid is None:
        total = torch.tensor(float(losses.shape[0]), dtype=torch.float32, device=losses.device)
    else:
        rows = valid[:, None] if losses.ndim > 1 else valid
        losses = torch.where(rows, losses, torch.zeros_like(losses))
        total = valid.sum(dtype=torch.float32)
    return (losses.sum() if dim is None else losses.sum(dim)), total


def _binary_hinge_loss_format(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten, float32, sigmoid if the scores are logits."""
    return _sigmoid_if_logits(preds.reshape(-1).to(torch.float32)), target.reshape(-1)


def _binary_hinge_loss_update(
    preds: torch.Tensor, target: torch.Tensor, squared: bool, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (sum of the losses, number of samples) over the valid samples."""
    valid = _valid(target, ignore_index)
    margin = 1 - (target * 2 - 1) * preds
    losses = torch.where(margin > 0, margin, torch.zeros_like(margin))
    if squared:
        losses = losses**2
    return _masked_sum(losses, valid)


def binary_hinge_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary hinge loss (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_hinge_loss
        >>> round(float(binary_hinge_loss(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))), 4)
        0.925
    """
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
    preds, target = _binary_hinge_loss_format(preds, target)
    return _hinge_loss_compute(*_binary_hinge_loss_update(preds, target, squared, ignore_index))


def _multiclass_hinge_loss_format(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classes last and flattened to (N, C) float32, softmax if the scores
    are logits."""
    preds = preds.movedim(1, -1).reshape(-1, num_classes).to(torch.float32)
    return _softmax_if_logits(preds, dim=-1), target.reshape(-1)


def _multiclass_hinge_loss_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    squared: bool,
    multiclass_mode: str,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (sum of the losses, number of samples) over the valid
    samples: a scalar sum in ``crammer-singer`` mode, a (C,) one in
    ``one-vs-all``. A target outside [0, C) has no class, as under JAX's
    ``one_hot``."""
    valid = _valid(target, ignore_index)
    target_oh = target[:, None] == torch.arange(num_classes, device=target.device)
    if multiclass_mode == "crammer-singer":
        inf = torch.tensor(float("inf"), dtype=preds.dtype, device=preds.device)
        margin = torch.where(target_oh, preds, -inf).amax(-1) - torch.where(target_oh, -inf, preds).amax(-1)
        losses = torch.where(1 - margin > 0, 1 - margin, torch.zeros_like(margin))
        if squared:
            losses = losses**2
        return _masked_sum(losses, valid)
    t = torch.where(target_oh, 1.0, -1.0)
    margin = 1 - t * preds
    losses = torch.where(margin > 0, margin, torch.zeros_like(margin))
    if squared:
        losses = losses**2
    return _masked_sum(losses, valid, dim=0)


def multiclass_hinge_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass hinge loss (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_hinge_loss
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_hinge_loss(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.625
    """
    if validate_args:
        _multiclass_hinge_loss_arg_validation(squared, multiclass_mode, ignore_index)
    preds, target = _multiclass_hinge_loss_format(preds, target, num_classes)
    return _hinge_loss_compute(
        *_multiclass_hinge_loss_update(preds, target, num_classes, squared, multiclass_mode, ignore_index)
    )


def hinge_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Hinge loss of a binary or multiclass task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import hinge_loss
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(hinge_loss(preds, torch.tensor([0, 1, 2, 0]), task="multiclass", num_classes=3)), 4)
        0.625
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
    return multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args)
