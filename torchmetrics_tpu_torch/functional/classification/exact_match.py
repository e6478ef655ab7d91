"""Exact match: a sample counts only if every one of its elements (multiclass
multidim) or labels (multilabel) matches.

The stat-scores format and validation do the preprocessing; the update is
one ``all`` over a sample's elements, with no host read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoBinary


def _exact_match_reduce(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return _safe_divide(correct, total)


def _int32(value: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=device)


def _multiclass_exact_match_update(
    preds: torch.Tensor, target: torch.Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``preds``/``target`` are (N, ...) label tensors: int32 (correct, total),
    scalars under ``"global"``, per sample under ``"samplewise"``."""
    match = preds == target
    if ignore_index is not None:
        match = match | (target == ignore_index)
    correct = match.reshape(match.shape[0], -1).all(dim=1).to(torch.int32)
    if multidim_average == "global":
        return correct.sum(dtype=torch.int32), _int32(correct.shape[0], correct.device)
    return correct, torch.ones_like(correct)


def multiclass_exact_match(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass exact match (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_exact_match
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(multiclass_exact_match(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.75
    """
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, 1)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    if multidim_average == "global":
        return _exact_match_reduce(correct, total)
    return correct.to(torch.float32)


def _multilabel_exact_match_update(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, num_labels: int, multidim_average: str = "global"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``preds``/``target``/``valid`` are the (N, L, X) stat-scores format: a
    position counts as matched where it matches or is ignored; int32
    (correct, total) over the N x X positions (per sample under
    ``"samplewise"``)."""
    match = (preds == target) | ~valid
    correct = match.reshape(match.shape[0], num_labels, -1).all(dim=1).to(torch.int32)
    if multidim_average == "global":
        return correct.sum(dtype=torch.int32), _int32(correct.numel(), correct.device)
    per_sample = torch.full((correct.shape[0],), correct.shape[1], dtype=torch.int32, device=correct.device)
    return correct.sum(-1, dtype=torch.int32), per_sample


def multilabel_exact_match(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel exact match (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_exact_match
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> round(float(multilabel_exact_match(preds, target, num_labels=3)), 4)
        1.0
    """
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, valid = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    correct, total = _multilabel_exact_match_update(preds, target, valid, num_labels, multidim_average)
    return _exact_match_reduce(correct, total)


def exact_match(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Exact match of a multiclass or multilabel task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import exact_match
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(exact_match(preds, torch.tensor([0, 1, 2, 0]), task="multiclass", num_classes=3)), 4)
        0.75
    """
    task = ClassificationTaskNoBinary.from_str(task)
    if task == ClassificationTaskNoBinary.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
    return multilabel_exact_match(preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args)
