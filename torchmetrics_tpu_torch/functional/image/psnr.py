"""Peak signal-to-noise ratio (PSNR), and PSNR with a blocking-effect
penalty (PSNR-B)."""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.parallel.sync import reduce
from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


def _psnr_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of squared errors and the observation count, over everything or over ``dim``."""
    if dim is None:
        sum_squared_error = ((preds - target) ** 2).sum()
        return sum_squared_error, torch.tensor(float(target.numel()), device=target.device)
    diff = preds - target
    sum_squared_error = (diff * diff).sum(dim=dim)
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    num_obs = torch.tensor(float(math.prod(target.shape[d] for d in dim_list)), device=target.device)
    return sum_squared_error, num_obs.expand(sum_squared_error.shape)


def _psnr_compute(
    sum_squared_error: torch.Tensor,
    num_obs: torch.Tensor,
    data_range: torch.Tensor,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """PSNR from the sum of squared errors and the count."""
    data_range = torch.as_tensor(data_range, dtype=torch.float32, device=sum_squared_error.device)
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    psnr_vals = psnr_base_e * (10 / torch.log(torch.tensor(base, dtype=torch.float32)).item())
    return reduce(psnr_vals, reduction)


def peak_signal_noise_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: Union[float, Tuple[float, float], None] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """Peak signal-to-noise ratio. ``data_range`` is a float, a
    ``(min, max)`` pair that also clamps both inputs, or None (the target's
    range; not with ``dim``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import peak_signal_noise_ratio
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(peak_signal_noise_ratio(preds, preds * 0.75)), 4)
        14.322
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = torch.tensor(data_range[1] - data_range[0], dtype=torch.float32)
    else:
        data_range = torch.tensor(float(data_range))
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, num_obs, data_range, base=base, reduction=reduction)


def _compute_bef(x: torch.Tensor, block_size: int = 8) -> torch.Tensor:
    """Blocking effect factor of a grayscale ``(B, 1, H, W)`` batch: the
    squared neighbour differences across block boundaries against those
    inside blocks."""
    if x.shape[1] > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {x.shape[1]} channels.")
    height, width = x.shape[2], x.shape[3]
    mask = torch.zeros(width - 1, dtype=torch.bool, device=x.device)
    mask[block_size - 1 : width - 1 : block_size] = True
    vmask = torch.zeros(height - 1, dtype=torch.bool, device=x.device)
    vmask[block_size - 1 : height - 1 : block_size] = True

    d_h = (x[:, :, :, :-1] - x[:, :, :, 1:]) ** 2
    d_v = (x[:, :, :-1, :] - x[:, :, 1:, :]) ** 2
    d_b = (d_h * mask).sum() + (d_v * vmask[:, None]).sum()
    d_bc = (d_h * ~mask).sum() + (d_v * ~vmask[:, None]).sum()

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = math.log2(block_size) / math.log2(min(height, width))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), torch.zeros_like(d_b))


def _psnrb_compute(sum_squared_error: torch.Tensor, bef: torch.Tensor, data_range: torch.Tensor) -> torch.Tensor:
    """PSNR-B from the mean squared error and the blocking effect; a target
    range of 2 or less takes 1 as the peak."""
    mse_b = sum_squared_error + bef
    return torch.where(data_range > 2, 10 * torch.log10(data_range**2 / mse_b), 10 * torch.log10(1.0 / mse_b))


def peak_signal_noise_ratio_with_blocked_effect(
    preds: torch.Tensor,
    target: torch.Tensor,
    block_size: int = 8,
) -> torch.Tensor:
    """PSNR with a blocking-effect penalty, of grayscale images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import peak_signal_noise_ratio_with_blocked_effect
        >>> preds = (torch.arange(1 * 1 * 32 * 32).reshape(1, 1, 32, 32) % 255) / 255.0
        >>> round(float(peak_signal_noise_ratio_with_blocked_effect(preds, preds * 0.75)), 4)
        7.5802
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    data_range = target.max() - target.min()
    mse = ((preds - target) ** 2).sum() / target.numel()
    return _psnrb_compute(mse, _compute_bef(preds, block_size=block_size), data_range)
