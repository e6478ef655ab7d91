"""Safe-math helpers, written without data-dependent Python branching so a
CUDA caller never waits on the device for them, and the full-float32 scope."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Matrix products and cuDNN convolutions in full float32 (TF32 off)
    inside the block, restored after: SSIM's windowed moments cancel in
    ``E[x²] − μ²`` and FID's covariances in ``Σ x xᵀ − n μ μᵀ``, which TF32's
    ten mantissa bits do not survive."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def _at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """Integer, bool and sub-32-bit float inputs as float32, for accumulation
    (sums of squares overflow float16); float32, float64 and complex inputs
    pass through."""
    x = torch.as_tensor(x)
    if x.is_complex() or (x.is_floating_point() and torch.finfo(x.dtype).bits >= 32):
        return x
    return x.to(torch.float32)


def _safe_divide(num: torch.Tensor, denom: torch.Tensor, zero_division: float = 0.0) -> torch.Tensor:
    """Elementwise num/denom returning ``zero_division`` where denom == 0.

    Integer operands are divided in float32, as the JAX package does with x64
    off; the double ``where`` keeps nan/inf out of the result.
    """
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom)
    if not (num.is_floating_point() or denom.is_floating_point()):
        num = num.to(torch.float32)
        denom = denom.to(torch.float32)
    zero = denom == 0
    quotient = num / torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.full_like(quotient, zero_division), quotient)


def _safe_xlogy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x * log(y)`` with ``0 * log(anything) = 0``, free of nan/inf where
    ``x`` is 0."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    zero = x == 0
    safe_y = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(x * safe_y), x * torch.log(safe_y))


def _safe_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` in full float32 (TF32 off inside, whatever the caller set),
    as the JAX package's ``precision="highest"`` product."""
    with full_float32():
        return torch.matmul(x, y)


def _adjust_weights_safe_divide(
    score: torch.Tensor,
    average: Optional[str],
    is_multilabel: bool,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    top_k: int = 1,
) -> torch.Tensor:
    """Macro/weighted averaging of per-class scores, ignoring absent classes."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
    else:  # macro
        weights = torch.ones_like(score, dtype=torch.float32)
        if not is_multilabel:
            # classes absent from the data carry no weight; with top_k > 1 a
            # class can have fp without true instances, so the absence test
            # drops fp
            absent = (tp + fp + fn == 0) if top_k == 1 else (tp + fn == 0)
            weights = torch.where(absent, torch.zeros_like(weights), weights)
    return _safe_divide(weights * score, weights.sum(-1, keepdim=True)).sum(-1)


def _auc_compute_without_check(x: torch.Tensor, y: torch.Tensor, direction: float, axis: int = -1) -> torch.Tensor:
    """Trapezoidal area under (x, y) assuming x already sorted in ``direction``.

    Along ``axis=-1`` the heights are the means of neighbouring ``y``; along
    another axis the left heights, as in the JAX package."""
    dx = torch.diff(x, dim=axis)
    if axis == -1:
        avg_y = (y[..., :-1] + y[..., 1:]) / 2.0
    else:
        avg_y = torch.narrow(y, axis, 0, y.shape[axis] - 1)
    return (dx * avg_y).sum(axis) * direction


def _auc_compute(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Trapezoidal AUC; optionally sorts by x first. The direction is read
    from the first and last x (a device-side select, no host read)."""
    if reorder:
        order = torch.argsort(x, stable=True)
        x = x[order]
        y = y[order]
    direction = torch.where(x[-1] >= x[0], 1.0, -1.0)
    dx = torch.diff(x)
    avg_y = (y[:-1] + y[1:]) / 2.0
    return (dx * avg_y).sum() * direction


def auc(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Area under the curve (x, y) by the trapezoidal rule.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utils.compute import auc
        >>> round(float(auc(torch.tensor([0.0, 0.5, 1.0]), torch.tensor([0.0, 0.8, 1.0]))), 4)
        0.65
    """
    return _auc_compute(torch.as_tensor(x), torch.as_tensor(y), reorder=reorder)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """1-D linear interpolation with the JAX package's semantics (not
    ``numpy.interp``): the segment of ``x`` is picked by counting how many
    ``xp`` values are ``<= x`` (which also defines the result on an unsorted
    ``xp``, as the macro curve merge feeds it), points past either end follow
    the first or last segment's line, and a zero-width segment divides by 1
    rather than 0.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utils.compute import interp
        >>> interp(torch.tensor([0.25, 0.75]), torch.tensor([0.0, 0.5, 1.0]),
        ...        torch.tensor([0.0, 1.0, 0.0])).tolist()
        [0.5, 0.5]
    """
    dx = xp[1:] - xp[:-1]
    m = (fp[1:] - fp[:-1]) / torch.where(dx == 0, torch.ones_like(dx), dx)
    b = fp[:-1] - m * xp[:-1]
    indices = (x[:, None] >= xp[None, :]).sum(dim=1) - 1
    indices = torch.clamp(indices, 0, m.shape[0] - 1)
    return m[indices] * x + b[indices]
