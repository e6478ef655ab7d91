"""R² score, with the adjusted form and three ways to average outputs."""
from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _r2_score_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Per-output ``Σy²``, ``Σy`` and ``Σ(y − ŷ)²`` in float32, and the row count."""
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            f"Expected both prediction and target to be 1D or 2D tensors, but received tensors with dimension {preds.shape}"
        )
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    sum_obs = target.sum(0)
    sum_squared_obs = (target * target).sum(0)
    residual = ((target - preds) ** 2).sum(0)
    return sum_squared_obs, sum_obs, residual, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    residual: torch.Tensor,
    num_obs: Union[int, torch.Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    """R² from the sums. The total sum of squares is ``Σy² − Σy·ȳ`` in
    float32, as in the JAX package (it cancels when the mean is large
    against the spread). A residual within 1e-4 of 0 scores 1; a residual
    against a constant target (total within 1e-4 of 0) scores 0. The
    count checks run on a Python ``int`` count only."""
    if isinstance(num_obs, int) and num_obs < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    mean_obs = sum_obs / num_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    zero = torch.zeros((), dtype=residual.dtype, device=residual.device)
    cond_rss = ~torch.isclose(residual, zero, atol=1e-4)
    cond_tss = ~torch.isclose(tss, zero, atol=1e-4)
    ones = torch.ones_like(tss)
    raw_scores = torch.where(
        cond_rss & cond_tss,
        1 - residual / torch.where(cond_tss, tss, ones),
        torch.where(cond_rss & ~cond_tss, torch.zeros_like(tss), ones),
    )
    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = raw_scores.mean()
    elif multioutput == "variance_weighted":
        r2 = (tss / tss.sum() * raw_scores).sum()
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )
    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0:
        if isinstance(num_obs, int) and adjusted > num_obs - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
            return r2
        if isinstance(num_obs, int) and adjusted == num_obs - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
            return r2
        return 1 - (1 - r2) * (num_obs - 1) / (num_obs - adjusted - 1)
    return r2


def r2_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    """R² score (coefficient of determination); ``adjusted`` independent
    regressors give the adjusted score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import r2_score
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(r2_score(preds, target)), 4)
        0.9486
    """
    sum_squared_obs, sum_obs, residual, num_obs = _r2_score_update(torch.as_tensor(preds), torch.as_tensor(target))
    return _r2_score_compute(sum_squared_obs, sum_obs, residual, num_obs, adjusted, multioutput)
