"""Pure-tensor image metrics: total variation, UQI, SAM, ERGAS, RMSE-SW, RASE
and SCC.

UQI, RMSE-SW, RASE and SCC take their windowed moments from the
``ssim_windows`` kernel's generic entry (``_separable_window_2d``): UQI
windows its five-plane stack in one call, RMSE-SW one call an update, RASE
two, SCC five a channel. SCC's high-pass filter is a plain convolution in
full float32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.functional.image.utils import (
    _conv2d,
    _gaussian,
    _reflect_pad_2d,
    _separable_window_2d,
    _uniform_filter,
)
from torchmetrics_tpu_torch.parallel.sync import reduce
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


def _float32(*tensors) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(t).to(torch.float32) for t in tensors)


# ------------------------------------------------------------------------- TV
def _total_variation_update(img: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Per-image anisotropic total variation and the image count."""
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {tuple(img.shape)}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    res1 = diff1.abs().sum((1, 2, 3))
    res2 = diff2.abs().sum((1, 2, 3))
    return res1 + res2, img.shape[0]


def total_variation(img: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Total variation of an image batch.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import total_variation
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(total_variation(preds)), 2)
        1288.42
    """
    score, _ = _total_variation_update(*_float32(img))
    if reduction == "sum":
        return score.sum()
    if reduction == "mean":
        return score.mean()
    if reduction in ("none", None):
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


# ------------------------------------------------------------------------ UQI
def universal_image_quality_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Universal image quality index: SSIM's formula without its constants,
    over a gaussian window. The five-plane stack is one kernel call. A
    kernel size of 1 crops the map to nothing (NaN after the mean), as in
    the JAX package.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import universal_image_quality_index
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(universal_image_quality_index(preds, preds * 0.75)), 4)
        0.9216
    """
    preds, target = _float32(preds, target)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    g_h = _gaussian(kernel_size[0], sigma[0], preds.dtype, preds.device)
    g_w = _gaussian(kernel_size[1], sigma[1], preds.dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds_p = _reflect_pad_2d(preds, pad_h, pad_w)
    target_p = _reflect_pad_2d(target, pad_h, pad_w)

    stack = torch.cat([preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p])
    outputs = _separable_window_2d(stack, g_h, g_w)
    b = preds.shape[0]
    mu_pred = outputs[:b]
    mu_target = outputs[b : 2 * b]
    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = torch.clamp(outputs[2 * b : 3 * b] - mu_pred_sq, min=0.0)
    sigma_target_sq = torch.clamp(outputs[3 * b : 4 * b] - mu_target_sq, min=0.0)
    sigma_pred_target = outputs[4 * b :] - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    eps = torch.finfo(sigma_pred_sq.dtype).eps
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower + eps)
    # JAX's ``[..., pad:-pad, ...]``: a pad of 0 leaves nothing
    uqi_idx = uqi_idx[..., pad_h : uqi_idx.shape[-2] - pad_h if pad_h else 0, pad_w : uqi_idx.shape[-1] - pad_w if pad_w else 0]
    return reduce(uqi_idx, reduction)


# ------------------------------------------------------------------------ SAM
def spectral_angle_mapper(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Per-pixel spectral angle over the channel axis, in radians.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spectral_angle_mapper
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(spectral_angle_mapper(preds, preds * 0.75)), 4)
        0.0001
    """
    preds, target = _float32(preds, target)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if preds.shape[1] <= 1:
        raise ValueError(
            f"Expected channel dimension of `preds` and `target` to be larger than 1. Got preds: {preds.shape[1]}."
        )
    dot_product = (preds * target).sum(1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.clamp(dot_product / (preds_norm * target_norm), -1.0, 1.0)
    return reduce(torch.arccos(sam_score), reduction)


# ---------------------------------------------------------------------- ERGAS
def error_relative_global_dimensionless_synthesis(
    preds: torch.Tensor,
    target: torch.Tensor,
    ratio: float = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Relative dimensionless global error in synthesis (ERGAS).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import error_relative_global_dimensionless_synthesis
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(error_relative_global_dimensionless_synthesis(preds, preds * 0.75)), 4)
        9.6476
    """
    preds, target = _float32(preds, target)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)
    diff = preds - target
    rmse_per_band = torch.sqrt((diff * diff).sum(2) / (h * w))
    mean_target = target.mean(2)
    ergas_score = 100 / ratio * torch.sqrt(((rmse_per_band / mean_target) ** 2).sum(1) / c)
    return reduce(ergas_score, reduction)


# -------------------------------------------------------------------- RMSE-SW
def _rmse_sw_single(preds: torch.Tensor, target: torch.Tensor, window_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's summed cropped RMSE value and its RMSE map (one kernel call)."""
    error = (target - preds) ** 2
    rmse_map = torch.sqrt(_uniform_filter(error, window_size))
    crop = round(window_size / 2)  # Python's round, as the JAX package: round(4.5) == 4
    h, w = rmse_map.shape[-2:]
    rmse_val = rmse_map[:, :, crop : h - crop if crop else 0, crop : w - crop if crop else 0].sum(0).mean()
    return rmse_val, rmse_map


def root_mean_squared_error_using_sliding_window(
    preds: torch.Tensor,
    target: torch.Tensor,
    window_size: int = 8,
    return_rmse_map: bool = False,
):
    """Root mean squared error over a sliding window.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import root_mean_squared_error_using_sliding_window
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(root_mean_squared_error_using_sliding_window(preds, preds * 0.75)), 4)
        0.1445
    """
    preds, target = _float32(preds, target)
    _check_same_shape(preds, target)
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    rmse_val, rmse_map = _rmse_sw_single(preds, target, window_size)
    rmse = rmse_val / preds.shape[0]
    if return_rmse_map:
        return rmse, rmse_map.sum(0) / preds.shape[0]
    return rmse


# ----------------------------------------------------------------------- RASE
def relative_average_spectral_error(preds: torch.Tensor, target: torch.Tensor, window_size: int = 8) -> torch.Tensor:
    """Relative average spectral error: 100 over the windowed target mean,
    times the RMS over bands of the sliding-window RMSE (two kernel calls).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import relative_average_spectral_error
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(relative_average_spectral_error(preds, preds * 0.75)), 2)
        2460.4
    """
    preds, target = _float32(preds, target)
    _check_same_shape(preds, target)
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    _, rmse_map = _rmse_sw_single(preds, target, window_size)
    rmse_map = rmse_map.sum(0) / preds.shape[0]  # (C, H, W)
    target_mean = (_uniform_filter(target, window_size) / (window_size**2)).sum(0) / preds.shape[0]
    target_mean = target_mean.mean(0)  # (H, W), the mean over channels
    rase_map = 100 / target_mean * torch.sqrt((rmse_map**2).mean(0))
    crop = round(window_size / 2)
    h, w = rase_map.shape
    return rase_map[crop : h - crop if crop else 0, crop : w - crop if crop else 0].mean()


# ------------------------------------------------------------------------ SCC
def _symmetric_reflect_pad_2d(x: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Symmetric padding ``d c b a | a b c d | d c b a`` by (left, right, top, bottom)."""
    left = torch.flip(x[:, :, :, 0 : pad[0]], dims=(3,))
    right = torch.flip(x[:, :, :, x.shape[3] - pad[1] :], dims=(3,))
    padded = torch.cat([left, x, right], dim=3)
    top = torch.flip(padded[:, :, 0 : pad[2], :], dims=(2,))
    bottom = torch.flip(padded[:, :, padded.shape[2] - pad[3] :, :], dims=(2,))
    return torch.cat([top, padded, bottom], dim=2)


def _signal_convolve_2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """scipy.signal-style 2-D convolution: the kernel flipped, symmetric padding."""
    left = int(math.floor((kernel.shape[3] - 1) / 2))
    right = int(math.ceil((kernel.shape[3] - 1) / 2))
    top = int(math.floor((kernel.shape[2] - 1) / 2))
    bottom = int(math.ceil((kernel.shape[2] - 1) / 2))
    padded = _symmetric_reflect_pad_2d(x, (left, right, top, bottom))
    return _conv2d(padded, torch.flip(kernel, dims=(2, 3)))


def _scc_per_channel(preds: torch.Tensor, target: torch.Tensor, hp_filter: torch.Tensor, window_size: int) -> torch.Tensor:
    """One channel's SCC map, ``preds`` and ``target`` ``(B, 1, H, W)``: five kernel calls."""
    preds_hp = _signal_convolve_2d(preds, hp_filter) * 2.0
    target_hp = _signal_convolve_2d(target, hp_filter) * 2.0

    left = int(math.ceil((window_size - 1) / 2))
    right = int(math.floor((window_size - 1) / 2))
    pp = F.pad(preds_hp, (left, right, left, right))
    tt = F.pad(target_hp, (left, right, left, right))
    uniform = torch.full((window_size,), 1.0 / window_size, dtype=preds.dtype, device=preds.device)
    preds_mean = _separable_window_2d(pp, uniform, uniform)
    target_mean = _separable_window_2d(tt, uniform, uniform)
    preds_var = _separable_window_2d(pp**2, uniform, uniform) - preds_mean**2
    target_var = _separable_window_2d(tt**2, uniform, uniform) - target_mean**2
    cov = _separable_window_2d(tt * pp, uniform, uniform) - target_mean * preds_mean

    preds_var = torch.clamp(preds_var, min=0.0)
    target_var = torch.clamp(target_var, min=0.0)
    den = torch.sqrt(target_var) * torch.sqrt(preds_var)
    zero = den == 0
    return torch.where(zero, torch.zeros_like(cov), cov / torch.where(zero, torch.ones_like(den), den))


def spatial_correlation_coefficient(
    preds: torch.Tensor,
    target: torch.Tensor,
    hp_filter: Optional[torch.Tensor] = None,
    window_size: int = 8,
    reduction: Optional[str] = "mean",
) -> torch.Tensor:
    """Spatial correlation coefficient of the high-pass filtered images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spatial_correlation_coefficient
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(spatial_correlation_coefficient(preds, preds * 0.75)), 4)
        1.0
    """
    preds, target = _float32(preds, target)
    if hp_filter is None:
        hp_filter = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]])
    hp_filter = torch.as_tensor(hp_filter, dtype=torch.float32).to(preds.device)
    if preds.ndim == 3:
        preds = preds[:, None]
        target = target[:, None]
    _check_same_shape(preds, target)
    if not window_size > 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got {window_size}.")
    if window_size > preds.shape[2] or window_size > preds.shape[3]:
        raise ValueError(
            f"Expected `window_size` to be less than or equal to the size of the image."
            f" Got window_size: {window_size} and image size: {preds.shape[2]}x{preds.shape[3]}."
        )
    hp_filter = hp_filter[None, None, :, :]
    per_channel = [
        _scc_per_channel(preds[:, c][:, None], target[:, c][:, None], hp_filter, window_size)
        for c in range(preds.shape[1])
    ]
    scc = torch.cat(per_channel, dim=1)
    if reduction in (None, "none"):
        return scc.mean(dim=(1, 2, 3))
    if reduction == "mean":
        return scc.mean()
    raise ValueError(f"Expected reduction to be one of 'mean', 'none', None but got {reduction}")
