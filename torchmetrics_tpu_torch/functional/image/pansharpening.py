"""Pan-sharpening quality without a reference: spectral distortion
(D_lambda), spatial distortion (D_s) and QNR, all built on UQI.

D_lambda scores every band pair with two UQI calls (two ``ssim_windows``
launches); D_s low-passes the pan image (one launch) and scores each band
with two UQI calls; QNR is both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.functional.image.misc import universal_image_quality_index
from torchmetrics_tpu_torch.functional.image.utils import _uniform_filter
from torchmetrics_tpu_torch.parallel.sync import reduce


def spectral_distortion_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    p: int = 1,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Spectral distortion index: the difference of inter-band UQI between
    the fused and the multispectral image.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spectral_distortion_index
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> round(float(spectral_distortion_index(preds, preds * 0.75)), 4)
        0.0
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    length = preds.shape[1]
    m1 = torch.zeros((length, length), device=preds.device, dtype=preds.dtype)
    m2 = torch.zeros((length, length), device=preds.device, dtype=preds.dtype)
    pairs = [(k, r) for k in range(length) for r in range(k + 1, length)]
    if pairs:
        # every band pair in one UQI call for the target and one for preds
        rows = torch.tensor([k for k, _ in pairs], device=preds.device)
        cols = torch.tensor([r for _, r in pairs], device=preds.device)

        def pair_uqi(x: torch.Tensor) -> torch.Tensor:
            first = x.index_select(1, rows).transpose(0, 1).reshape(-1, 1, *x.shape[2:])
            second = x.index_select(1, cols).transpose(0, 1).reshape(-1, 1, *x.shape[2:])
            return universal_image_quality_index(first, second, reduction="none").reshape(len(pairs), -1).mean(-1)

        m1[rows, cols] = pair_uqi(target)
        m2[rows, cols] = pair_uqi(preds)
        m1 = m1 + m1.T
        m2 = m2 + m2.T
    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (1.0 / (length * (length - 1)) * diff.sum()) ** (1.0 / p)
    return reduce(output, reduction)


def _degrade_pan(pan: torch.Tensor, ms_shape: Tuple[int, int], window_size: int) -> torch.Tensor:
    """The pan image low-passed and resized to the multispectral image's
    size, bilinear with antialiasing when it shrinks (as
    ``jax.image.resize`` does)."""
    pan_degraded = _uniform_filter(pan, window_size=window_size)
    return F.interpolate(pan_degraded, size=tuple(ms_shape), mode="bilinear", align_corners=False, antialias=True)


def _check_pansharpening(preds: torch.Tensor, ms: torch.Tensor, pan: torch.Tensor, norm_order: int, window_size: int) -> None:
    if preds.ndim != 4 or ms.ndim != 4 or pan.ndim != 4:
        raise ValueError(f"Expected `preds`, `ms`, `pan` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if preds.shape[:2] != ms.shape[:2] or preds.shape[:2] != pan.shape[:2]:
        raise ValueError("Expected `preds`, `ms`, `pan` to have the same batch and channel sizes.")
    if preds.shape[-2:] != pan.shape[-2:]:
        raise ValueError("Expected `preds` and `pan` to have the same spatial dimension.")
    if not isinstance(norm_order, int) or norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    if not isinstance(window_size, int) or window_size <= 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got window_size: {window_size}.")
    ms_h, ms_w = ms.shape[-2:]
    if window_size >= ms_h or window_size >= ms_w:
        raise ValueError(f"Expected `window_size` to be smaller than dimension of `ms`. Got window_size: {window_size}.")


def spatial_distortion_index(
    preds: torch.Tensor,
    ms: torch.Tensor,
    pan: torch.Tensor,
    pan_lr: Optional[torch.Tensor] = None,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Spatial distortion index: per band, UQI of the multispectral image
    against the degraded pan image, less UQI of the fused image against the
    pan image.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spatial_distortion_index
        >>> preds = (torch.arange(1 * 3 * 32 * 32).reshape(1, 3, 32, 32) % 255) / 255.0
        >>> float(spatial_distortion_index(preds, preds[:, :, ::4, ::4] * 0.9, preds * 0.95))
        nan
    """
    preds, ms, pan = (torch.as_tensor(x).to(torch.float32) for x in (preds, ms, pan))
    _check_pansharpening(preds, ms, pan, norm_order, window_size)
    pan_degraded = pan_lr if pan_lr is not None else _degrade_pan(pan, ms.shape[-2:], window_size)
    length = preds.shape[1]
    m1 = torch.stack(
        [universal_image_quality_index(ms[:, i : i + 1], pan_degraded[:, i : i + 1]) for i in range(length)]
    )
    m2 = torch.stack([universal_image_quality_index(preds[:, i : i + 1], pan[:, i : i + 1]) for i in range(length)])
    diff = torch.abs(m1 - m2) ** norm_order
    return reduce(diff, reduction) ** (1 / norm_order)


def quality_with_no_reference(
    preds: torch.Tensor,
    ms: torch.Tensor,
    pan: torch.Tensor,
    pan_lr: Optional[torch.Tensor] = None,
    alpha: float = 1,
    beta: float = 1,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Quality with no reference: ``(1 - D_lambda)^alpha · (1 - D_s)^beta``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import quality_with_no_reference
        >>> preds = (torch.arange(1 * 3 * 32 * 32).reshape(1, 3, 32, 32) % 255) / 255.0
        >>> float(quality_with_no_reference(preds, preds[:, :, ::4, ::4] * 0.9, preds * 0.95))
        nan
    """
    if not isinstance(alpha, (int, float)) or alpha < 0:
        raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
    if not isinstance(beta, (int, float)) or beta < 0:
        raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
    d_lambda = spectral_distortion_index(preds, ms, p=1, reduction=reduction)
    d_s = spatial_distortion_index(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
    return (1 - d_lambda) ** alpha * (1 - d_s) ** beta
