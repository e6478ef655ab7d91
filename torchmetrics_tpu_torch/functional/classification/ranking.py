"""Multilabel ranking metrics: coverage error, label ranking average
precision and label ranking loss.

Average precision and the loss take the tie-aware O(L²) rank: each label's
score against every other label's of its sample. The JAX package has no
kernel for it, and neither has the port: plain torch, with the batch taken
in chunks of rows so that the (rows, L, L) compare stays under
:data:`_CHUNK_ELEMENTS` elements (1,024 rows of 1,000 labels would be 1 G at
once). The per-sample values are concatenated and summed once, so the
chunking leaves the result as one pass gives it.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

#: the most elements of one chunk's (rows, L, L) pairwise compare
_CHUNK_ELEMENTS = 1 << 26


def _multilabel_ranking_format(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, L) float32 scores (sigmoid if logits) and int32 targets, an
    ``ignore_index`` target set to 0."""
    preds = _sigmoid_if_logits(preds.reshape(-1, num_labels).to(torch.float32))
    target = target.reshape(-1, num_labels)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.zeros_like(target), target)
    return preds, target.to(torch.int32)


def _per_sample_chunked(
    preds: torch.Tensor, target: torch.Tensor, fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
) -> torch.Tensor:
    """``fn`` over row chunks whose pairwise compare fits :data:`_CHUNK_ELEMENTS`;
    the per-sample values concatenated."""
    n, num_labels = preds.shape
    rows = max(1, _CHUNK_ELEMENTS // max(1, num_labels * num_labels))
    if n <= rows:
        return fn(preds, target)
    return torch.cat([fn(preds[i : i + rows], target[i : i + rows]) for i in range(0, n, rows)])


def _total(preds: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(preds.shape[0]), dtype=torch.float32, device=preds.device)


def _coverage_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sample, the rank of its lowest-scored relevant label (0 with
    none); float32 (sum, number of samples)."""
    relevant = target == 1
    inf = torch.tensor(float("inf"), dtype=preds.dtype, device=preds.device)
    min_relevant = torch.where(relevant, preds, inf).amin(-1, keepdim=True)
    coverage = (preds >= min_relevant).sum(-1).to(torch.float32)
    coverage = torch.where(relevant.any(-1), coverage, torch.zeros_like(coverage))
    return coverage.sum(), _total(preds)


def _lrap_rows(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    relevant = target == 1
    ge = preds[:, None, :] >= preds[:, :, None]  # [n, l, l'] = preds[l'] >= preds[l]
    rank = ge.sum(-1)  # tie-aware descending 'max' rank, scipy's rankdata(-x, method='max')
    rank_among_relevant = (ge & relevant[:, None, :]).sum(-1)
    score = torch.where(relevant, rank_among_relevant / rank, 0.0)
    n_rel = relevant.sum(-1)
    return torch.where(n_rel > 0, score.sum(-1) / torch.where(n_rel == 0, 1, n_rel), 1.0)


def _label_ranking_average_precision_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sample, the mean over its relevant labels of the share of
    relevant labels among those scored at least as high ('max' ties both
    ways; 1 with no relevant label); float32 (sum, number of samples)."""
    return _per_sample_chunked(preds, target, _lrap_rows).sum(), _total(preds)


def _ranking_loss_rows(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    relevant = target == 1
    n_rel = relevant.sum(-1)
    n_irr = (~relevant).sum(-1)
    ge = preds[:, None, :] >= preds[:, :, None]  # [n, r, i] = preds[i] >= preds[r]
    wrong = (ge & (relevant[:, :, None] & ~relevant[:, None, :])).sum((-2, -1))
    denom = n_rel * n_irr
    return torch.where(denom > 0, wrong / torch.where(denom == 0, 1, denom), 0.0)


def _label_ranking_loss_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sample, the share of (relevant, irrelevant) label pairs that are
    ordered wrongly (the irrelevant one scored at least as high); float32
    (sum, number of samples)."""
    return _per_sample_chunked(preds, target, _ranking_loss_rows).sum(), _total(preds)


def _ranking_functional(update, preds, target, num_labels, ignore_index, validate_args) -> torch.Tensor:
    if validate_args:
        _check_same_shape(preds, target)
    preds, target = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    measure, total = update(preds, target)
    return measure / total


def multilabel_coverage_error(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel coverage error (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_coverage_error
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> round(float(multilabel_coverage_error(preds, target, num_labels=3)), 4)
        1.6667
    """
    return _ranking_functional(_coverage_error_update, preds, target, num_labels, ignore_index, validate_args)


def multilabel_ranking_average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel label ranking average precision (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_ranking_average_precision
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> round(float(multilabel_ranking_average_precision(preds, target, num_labels=3)), 4)
        1.0
    """
    return _ranking_functional(
        _label_ranking_average_precision_update, preds, target, num_labels, ignore_index, validate_args
    )


def multilabel_ranking_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel label ranking loss (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_ranking_loss
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> round(float(multilabel_ranking_loss(preds, target, num_labels=3)), 4)
        0.0
    """
    return _ranking_functional(_label_ranking_loss_update, preds, target, num_labels, ignore_index, validate_args)
