"""Rank correlations: Spearman, Kendall and Lin's concordance.

Spearman is Pearson's correlation of tie-averaged ranks. Up to 2**23
samples the ranks and their moments are float32, as in the JAX package
(every average rank, a multiple of 1/2 no larger than 2**23, is exact);
past that they are float64, where JAX's float32 ranks round.

Kendall counts concordant and discordant pairs and ties over the upper
triangle of the pair matrix, one tile of rows at a time, into int64: the
JAX package forms the whole n x n matrix (several GB at n = 15,625) and
counts in int32 (which overflows past n = 65,536). The counts are those
of JAX's dense form bit for bit; tau is formed from them in float64 and
returned in float32.

Lin's concordance comes from Pearson's moment states.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.pearson import (
    _empty_moments,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

#: the largest sample count whose average ranks float32 holds exactly
_FLOAT32_RANK_LIMIT = 1 << 23
#: pairs compared per Kendall tile: each tile holds about six temporaries of
#: this many elements (float32 differences and signs, bool masks), 64 MiB
#: each in float32
_KENDALL_TILE_PAIRS = 1 << 24


def _rank_data_average(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Tie-averaged ranks from 1 (scipy's ``rankdata(method="average")``):
    ``(#less + 1 + #less-or-equal) / 2`` from one sort and two binary searches."""
    sorted_x = torch.sort(x).values
    lo = torch.searchsorted(sorted_x, x, side="left")
    hi = torch.searchsorted(sorted_x, x, side="right")
    return (lo + 1 + hi).to(dtype) / 2.0


def _ranks(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.ndim == 1:
        return _rank_data_average(x, dtype)
    return torch.stack([_rank_data_average(x[:, i].contiguous(), dtype) for i in range(x.shape[1])], dim=1)


def _spearman_corrcoef_compute(preds: torch.Tensor, target: torch.Tensor, eps: float = 1.17e-06) -> torch.Tensor:
    dtype = torch.float32 if preds.shape[0] <= _FLOAT32_RANK_LIMIT else torch.float64
    r_preds, r_target = _ranks(preds, dtype), _ranks(target, dtype)
    preds_diff = r_preds - r_preds.mean(0)
    target_diff = r_target - r_target.mean(0)
    cov = (preds_diff * target_diff).mean(0)
    preds_std = torch.sqrt((preds_diff * preds_diff).mean(0))
    target_std = torch.sqrt((target_diff * target_diff).mean(0))
    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0).squeeze().to(torch.float32)


def spearman_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Spearman's rank correlation, one per output column of 2-D inputs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spearman_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(spearman_corrcoef(preds, target)), 4)
        1.0
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    return _spearman_corrcoef_compute(preds, target)


def _kendall_pair_counts(x: torch.Tensor, y: torch.Tensor, tile_pairs: Optional[int] = None) -> torch.Tensor:
    """int64 ``[concordant, discordant, tied in x, tied in y]`` over the pairs
    ``i < j``, as JAX's dense form counts them (a pair is concordant when
    ``sign(x_j − x_i)·sign(y_j − y_i) > 0``, so NaN counts nowhere).

    Rows go in tiles of about ``tile_pairs / n``; a tile compares its rows
    with the columns from its first row on, so the memory is bounded and
    the work is about half the square."""
    n = x.shape[0]
    rows = max(1, (tile_pairs or _KENDALL_TILE_PAIRS) // max(n, 1))
    counts = torch.zeros(4, dtype=torch.int64, device=x.device)
    index = torch.arange(n, device=x.device)
    for i0 in range(0, n, rows):
        counts += _tile_counts(x, y, index, i0, min(n, i0 + rows))
    return counts


def _tile_counts(x: torch.Tensor, y: torch.Tensor, index: torch.Tensor, i0: int, i1: int) -> torch.Tensor:
    """The counts of rows ``i0:i1`` against the columns from ``i0`` on; the
    tile's temporaries are freed on return, before the next tile's."""
    upper = index[None, i0:] > index[i0:i1, None]
    dx = x[None, i0:] - x[i0:i1, None]
    dy = y[None, i0:] - y[i0:i1, None]
    sign_prod = torch.sign(dx) * torch.sign(dy)
    return torch.stack([
        ((sign_prod > 0) & upper).sum(),
        ((sign_prod < 0) & upper).sum(),
        ((dx == 0) & upper).sum(),
        ((dy == 0) & upper).sum(),
    ])


def _distinct(x: torch.Tensor) -> torch.Tensor:
    return (torch.diff(torch.sort(x).values) != 0).sum() + 1


def _kendall_tau_update(preds: torch.Tensor, target: torch.Tensor, variant: str = "b") -> torch.Tensor:
    """Tau of one column from its pair counts, in float64."""
    concordant, discordant, ties_x, ties_y = _kendall_pair_counts(preds, target).to(torch.float64)
    n = preds.shape[0]
    n0 = n * (n - 1) / 2
    if variant == "a":
        return (concordant - discordant) / n0
    if variant == "b":
        return (concordant - discordant) / torch.sqrt((n0 - ties_x) * (n0 - ties_y))
    # variant c: 2(C − D) / (n²·(m − 1)/m), m the smaller number of distinct values
    m = torch.minimum(_distinct(preds), _distinct(target)).to(torch.float64)
    return 2 * (concordant - discordant) / (n**2 * (m - 1) / m)


def kendall_rank_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    variant: str = "b",
    t_test: bool = False,
    alternative: Optional[str] = "two-sided",
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Kendall's tau (variant ``"a"``, ``"b"`` or ``"c"``), one per output
    column of 2-D inputs; ``t_test=True`` also returns the p-value of the
    normal approximation (``alternative`` ``"two-sided"``, ``"greater"`` or
    ``"less"``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import kendall_rank_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(kendall_rank_corrcoef(preds, target)), 4)
        1.0
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    if variant not in ("a", "b", "c"):
        raise ValueError(f"Argument `variant` is expected to be one of 'a', 'b', 'c' but got {variant}")
    if preds.ndim == 1:
        tau = _kendall_tau_update(preds, target, variant)
    else:
        tau = torch.stack([_kendall_tau_update(preds[:, i], target[:, i], variant) for i in range(preds.shape[1])])
    if not t_test:
        return tau.squeeze().to(torch.float32)
    n = preds.shape[0]
    z = tau / math.sqrt(2 * (2 * n + 5) / (9 * n * (n - 1)))
    if alternative == "two-sided":
        p = 2 * (1 - torch.special.ndtr(z.abs()))
    elif alternative == "greater":
        p = 1 - torch.special.ndtr(z)
    else:
        p = torch.special.ndtr(z)
    return tau.squeeze().to(torch.float32), p.squeeze().to(torch.float32)


def _concordance_corrcoef_compute(
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    nb: torch.Tensor,
) -> torch.Tensor:
    """Lin's concordance ``2ρσxσy / (σx² + σy² + (μx − μy)²)`` from the moment states."""
    pearson = _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
    dof = (nb - 1).to(torch.float32)
    var_x = var_x / dof
    var_y = var_y / dof
    return (2.0 * pearson * torch.sqrt(var_x) * torch.sqrt(var_y)) / (var_x + var_y + (mean_x - mean_y) ** 2)


def concordance_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Lin's concordance correlation coefficient; shape ``(num_outputs,)``,
    so 1-D inputs give shape ``(1,)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import concordance_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> [round(v, 4) for v in concordance_corrcoef(preds, target).tolist()]
        [0.9777]
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    d = preds.shape[1] if preds.ndim == 2 else 1
    moments = _pearson_corrcoef_update(preds, target, *_empty_moments(d, preds.device), num_outputs=d)
    return _concordance_corrcoef_compute(*moments)
