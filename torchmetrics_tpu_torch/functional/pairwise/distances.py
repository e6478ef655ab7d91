"""Pairwise distances and similarities between the rows of ``x`` and ``y``.

Cosine, euclidean and linear are one matrix product each, in full float32
(TF32 off whatever the caller set), as the JAX package writes them.
Manhattan and Minkowski take an elementwise term over every (row, row,
feature) triple: the JAX package broadcasts it to one ``(N, M, D)`` array
(367 GB at DeepFashion In-shop's 14,218 x 12,612 x 512); here it is formed
for a chunk of ``x``'s rows at a time, at most ``_CHUNK_ELEMENTS`` elements
(1 GiB in float32), and summed over the features before the next chunk.
The per-pair sum is the same; only the chunking differs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.basic import _check_minkowski_p
from torchmetrics_tpu_torch.utils.compute import _safe_matmul

#: the largest (rows, M, D) temporary a Manhattan or Minkowski chunk forms
_CHUNK_ELEMENTS = 1 << 28


def _check_input(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """float32 2-D ``x`` and ``y`` with equal widths; without ``y``, ``x``
    against itself with the diagonal zeroed unless asked otherwise."""
    x = torch.as_tensor(x).to(torch.float32)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        y = torch.as_tensor(y).to(torch.float32)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _finish(distance: torch.Tensor, zero_diagonal: bool, reduction: Optional[str]) -> torch.Tensor:
    """Zero the diagonal (a multiply by 0, so NaN stays NaN, as the JAX
    package's ``1 − eye`` mask does) and reduce over the last dimension."""
    if zero_diagonal:
        distance.diagonal().mul_(0)
    if reduction == "mean":
        return distance.mean(-1)
    if reduction == "sum":
        return distance.sum(-1)
    if reduction in (None, "none"):
        return distance
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _chunked_abs_sum(x: torch.Tensor, y: torch.Tensor, exponent: Optional[float] = None) -> torch.Tensor:
    """``Σ_d |x_id − y_jd|`` (or ``Σ_d |x_id − y_jd|^exponent``) for every
    row pair, over chunks of ``x``'s rows."""
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    rows = max(1, _CHUNK_ELEMENTS // max(m * d, 1))
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    for i0 in range(0, n, rows):
        _chunk_abs_sum(x[i0 : i0 + rows], y, exponent, out[i0 : i0 + rows])
    return out


def _chunk_abs_sum(x: torch.Tensor, y: torch.Tensor, exponent: Optional[float], out: torch.Tensor) -> None:
    """One chunk into ``out``; its (rows, M, D) term is freed on return,
    before the next chunk forms its own."""
    term = (x[:, None, :] - y[None, :, :]).abs_()
    if exponent is not None:
        term.pow_(exponent)
    torch.sum(term, dim=-1, out=out)


def pairwise_cosine_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Cosine similarity of every row of ``x`` with every row of ``y``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
        >>> [[round(v, 4) for v in row] for row in pairwise_cosine_similarity(x, y).tolist()]
        [[0.9487, 0.9487, 0.9487], [0.9899, 0.9899, 0.9899]]
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    norm_x = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    norm_y = torch.linalg.vector_norm(y, dim=1, keepdim=True)
    return _finish(_safe_matmul(x / norm_x, (y / norm_y).T), zero_diagonal, reduction)


def pairwise_euclidean_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Euclidean distance of every row of ``x`` to every row of ``y``, as
    ``sqrt(max(|x|² + |y|² − 2 x·y, 0))``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_euclidean_distance
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
        >>> [[round(v, 4) for v in row] for row in pairwise_euclidean_distance(x, y).tolist()]
        [[1.0, 1.0, 2.2361], [3.6056, 2.2361, 1.0]]
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm = (x * x).sum(1, keepdim=True)
    y_norm = (y * y).sum(1)
    distance = x_norm + y_norm - 2 * _safe_matmul(x, y.T)
    return _finish(torch.sqrt(torch.clamp(distance, min=0.0)), zero_diagonal, reduction)


def pairwise_manhattan_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Manhattan (L1) distance of every row of ``x`` to every row of ``y``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_manhattan_distance
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
        >>> pairwise_manhattan_distance(x, y).tolist()
        [[1.0, 1.0, 3.0], [5.0, 3.0, 1.0]]
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _finish(_chunked_abs_sum(x, y), zero_diagonal, reduction)


def pairwise_linear_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Dot product of every row of ``x`` with every row of ``y``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_linear_similarity
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
        >>> pairwise_linear_similarity(x, y).tolist()
        [[3.0, 6.0, 9.0], [7.0, 14.0, 21.0]]
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _finish(_safe_matmul(x, y.T), zero_diagonal, reduction)


def pairwise_minkowski_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    exponent: float = 2.0,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Minkowski distance ``(Σ|x − y|^p)^(1/p)`` of every row of ``x`` to
    every row of ``y``, ``p = exponent >= 1``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_minkowski_distance
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
        >>> [[round(v, 4) for v in row] for row in pairwise_minkowski_distance(x, y, exponent=3).tolist()]
        [[1.0, 1.0, 2.0801], [3.2711, 2.0801, 1.0]]
    """
    _check_minkowski_p(exponent, "exponent")
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _finish(_chunked_abs_sum(x, y, exponent) ** (1.0 / exponent), zero_diagonal, reduction)
