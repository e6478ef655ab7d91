"""Pearson correlation from streaming moment states, with the Chan et al.
merge of per-process states.

The moments (means, and the sums of squared and cross deviations) are
float32, as in the JAX package. The count is an exact int64: the JAX
package keeps it in float32, which stops counting exactly past 2**24
samples. Below 2**24 the count converts to float32 exactly, so the moments
are the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: the variance below which the correlation is flagged as unstable
_VARIANCE_WARN_BOUND = float(np.sqrt(np.finfo(np.float32).eps))


def _pearson_corrcoef_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    num_prior: torch.Tensor,
    num_outputs: int,
) -> Moments:
    """Fold a batch into the running moments (a weighted running mean, so
    an empty prior needs no branch); the count stays an integer."""
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    num_obs = preds.shape[0]
    num_total = num_prior.to(torch.int64) + num_obs
    n_prior, n_total = num_prior.to(torch.float32), num_total.to(torch.float32)
    mx_new = (n_prior * mean_x + preds.sum(0)) / n_total
    my_new = (n_prior * mean_y + target.sum(0)) / n_total
    var_x = var_x + ((preds - mx_new) * (preds - mean_x)).sum(0)
    var_y = var_y + ((target - my_new) * (target - mean_y)).sum(0)
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum(0)
    return mx_new, my_new, var_x, var_y, corr_xy, num_total


def _final_aggregation(
    means_x: torch.Tensor,
    means_y: torch.Tensor,
    vars_x: torch.Tensor,
    vars_y: torch.Tensor,
    corrs_xy: torch.Tensor,
    nbs: torch.Tensor,
) -> Moments:
    """Merge per-process moment states stacked on a leading axis (one entry
    a rank), pairwise in rank order (Chan et al.); the cross term
    ``n1·n2/n·Δm²`` folds the shift between the ranks' means into the
    pooled second moments. A rank with no samples adds nothing."""
    if means_x.ndim == 0:
        return means_x, means_y, vars_x, vars_y, corrs_xy, nbs
    if means_x.shape[0] == 1:
        return means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        empty = nb == 0
        n1f, n2f = n1.to(torch.float32), n2.to(torch.float32)
        nbf = torch.where(empty, torch.ones_like(nb), nb).to(torch.float32)
        zero = torch.zeros_like(mx1)
        factor = torch.where(empty, zero, (n1 * n2).to(torch.float32) / nbf)
        dx = mx2 - mx1
        dy = my2 - my1
        mean_x = torch.where(empty, zero, (n1f * mx1 + n2f * mx2) / nbf)
        mean_y = torch.where(empty, zero, (n1f * my1 + n2f * my2) / nbf)
        var_x = vx1 + vx2 + factor * dx * dx
        var_y = vy1 + vy2 + factor * dy * dy
        corr_xy = cxy1 + cxy2 + factor * dx * dy
        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return mx1, my1, vx1, vy1, cxy1, n1


def _pearson_corrcoef_compute(
    var_x: torch.Tensor, var_y: torch.Tensor, corr_xy: torch.Tensor, nb: torch.Tensor
) -> torch.Tensor:
    """The correlation from the second moments; NaN where a variance is
    exactly 0. A variance below ``sqrt(eps)`` warns (one host read, in the
    compute only)."""
    dof = (nb - 1).to(torch.float32)
    var_x = var_x / dof
    var_y = var_y / dof
    corr_xy = corr_xy / dof
    if bool(((var_x < _VARIANCE_WARN_BOUND) | (var_y < _VARIANCE_WARN_BOUND)).any()):
        rank_zero_warn(
            "The variance of predictions or target is close to zero. This can cause instability in Pearson"
            " correlation coefficient, leading to wrong results.",
            UserWarning,
        )
    denom = torch.sqrt(var_x * var_y)
    zero = denom == 0
    corrcoef = torch.where(zero, torch.full_like(denom, float("nan")), corr_xy / torch.where(zero, torch.ones_like(denom), denom))
    return torch.clamp(corrcoef, -1.0, 1.0).squeeze()


def _empty_moments(num_outputs: int, device: torch.device) -> Moments:
    zeros = torch.zeros(num_outputs, dtype=torch.float32, device=device)
    return zeros, zeros, zeros, zeros, zeros, torch.zeros(num_outputs, dtype=torch.int64, device=device)


def pearson_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation coefficient, one per output column of 2-D inputs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearson_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(pearson_corrcoef(preds, target)), 4)
        0.9849
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    d = preds.shape[1] if preds.ndim == 2 else 1
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(
        preds, target, *_empty_moments(d, preds.device), num_outputs=d
    )
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
