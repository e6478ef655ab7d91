"""Shared validate -> format -> update plumbing for stat-score-derived metrics,
so each derived metric (precision, recall, f-beta, jaccard, accuracy) is just
its reducer."""
from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    Stats,
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)


def _binary_stats(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Stats:
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    return _binary_stat_scores_update(preds, target, valid, multidim_average)


def _multiclass_stats(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Stats:
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    if top_k == 1:
        preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    return _multiclass_stat_scores_update(preds, target, num_classes, top_k, average, multidim_average, ignore_index)


def _multilabel_stats(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Stats:
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, valid = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    return _multilabel_stat_scores_update(preds, target, valid, multidim_average)
