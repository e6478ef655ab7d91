"""Explained variance, with three ways to average outputs."""
from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_shape

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _explained_variance_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The row count and per-output ``Σ(y − ŷ)``, ``Σ(y − ŷ)²``, ``Σy``, ``Σy²`` in float32."""
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    diff = target - preds
    return preds.shape[0], diff.sum(0), (diff * diff).sum(0), target.sum(0), (target * target).sum(0)


def _explained_variance_compute(
    num_obs: Union[int, torch.Tensor],
    sum_error: torch.Tensor,
    sum_squared_error: torch.Tensor,
    sum_target: torch.Tensor,
    sum_squared_target: torch.Tensor,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    """``1 − Var(y − ŷ) / Var(y)`` from the sums (each variance ``E[v²] − E[v]²``
    in float32); a zero error variance scores 1, a nonzero one against a
    constant target 0."""
    diff_avg = sum_error / num_obs
    numerator = sum_squared_error / num_obs - diff_avg * diff_avg
    target_avg = sum_target / num_obs
    denominator = sum_squared_target / num_obs - target_avg * target_avg
    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid = nonzero_numerator & nonzero_denominator
    output_scores = torch.where(
        valid, 1.0 - numerator / torch.where(valid, denominator, torch.ones_like(denominator)), torch.ones_like(diff_avg)
    )
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, torch.zeros_like(output_scores), output_scores)
    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return output_scores.mean()
    if multioutput == "variance_weighted":
        return (denominator / denominator.sum() * output_scores).sum()
    raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")


def explained_variance(
    preds: torch.Tensor, target: torch.Tensor, multioutput: str = "uniform_average"
) -> torch.Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import explained_variance
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(explained_variance(preds, target)), 4)
        0.9572
    """
    if multioutput not in ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")
    return _explained_variance_compute(
        *_explained_variance_update(torch.as_tensor(preds), torch.as_tensor(target)), multioutput
    )
