"""Pixel-domain visual information fidelity (VIF-p).

Four scales of gaussian windows (17, 9, 5 and 3 taps), each window one call
of the ``ssim_windows`` kernel's generic entry: five moment windows at scale
0, and two downsampling windows plus five moment windows at each later
scale, 26 calls a channel.
"""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.image.utils import _separable_window_2d


def _filter_1d(win_size: int, sigma: float, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """The 1-D factor of VIF's separable gaussian (``outer(g, g)`` is the 2-D
    filter), formed in float64 on the host and rounded, as ``_gaussian``."""
    coords = torch.arange(win_size, dtype=torch.float64) - (win_size - 1) / 2
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).to(dtype=dtype, device=device)


def _vif_per_channel(preds: torch.Tensor, target: torch.Tensor, sigma_n_sq: float) -> torch.Tensor:
    """Per-image VIF of one channel, ``preds`` and ``target`` ``(B, H, W)``."""
    preds = preds[:, None]
    target = target[:, None]
    eps = 1e-10

    preds_vif = torch.zeros(preds.shape[0], device=preds.device)
    target_vif = torch.zeros(preds.shape[0], device=preds.device)
    for scale in range(4):
        n = int(2.0 ** (4 - scale) + 1)
        g1 = _filter_1d(n, n / 5, preds.dtype, preds.device)

        if scale > 0:
            target = _separable_window_2d(target, g1, g1)[:, :, ::2, ::2]
            preds = _separable_window_2d(preds, g1, g1)[:, :, ::2, ::2]

        mu_target = _separable_window_2d(target, g1, g1)
        mu_preds = _separable_window_2d(preds, g1, g1)
        mu_target_sq = mu_target**2
        mu_preds_sq = mu_preds**2
        mu_target_preds = mu_target * mu_preds

        sigma_target_sq = torch.clamp(_separable_window_2d(target**2, g1, g1) - mu_target_sq, min=0.0)
        sigma_preds_sq = torch.clamp(_separable_window_2d(preds**2, g1, g1) - mu_preds_sq, min=0.0)
        sigma_target_preds = _separable_window_2d(target * preds, g1, g1) - mu_target_preds

        g = sigma_target_preds / (sigma_target_sq + eps)
        sigma_v_sq = sigma_preds_sq - g * sigma_target_preds
        zero = torch.zeros_like(g)

        mask = sigma_target_sq < eps
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        sigma_target_sq = torch.where(mask, zero, sigma_target_sq)

        mask = sigma_preds_sq < eps
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.where(mask, zero, sigma_v_sq)

        mask = g < 0
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.clamp(sigma_v_sq, min=eps)

        preds_vif_scale = torch.log10(1.0 + (g**2.0) * sigma_target_sq / (sigma_v_sq + sigma_n_sq))
        preds_vif = preds_vif + preds_vif_scale.sum(dim=(1, 2, 3))
        target_vif = target_vif + torch.log10(1.0 + sigma_target_sq / sigma_n_sq).sum(dim=(1, 2, 3))
    return preds_vif / target_vif


def _check_vif_size(preds: torch.Tensor, target: torch.Tensor) -> None:
    """The four-scale pyramid needs at least 41 pixels a side."""
    if preds.shape[-1] < 41 or preds.shape[-2] < 41:
        raise ValueError(f"Invalid size of preds. Expected at least 41x41, but got {preds.shape[-1]}x{preds.shape[-2]}!")
    if target.shape[-1] < 41 or target.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of target. Expected at least 41x41, but got {target.shape[-1]}x{target.shape[-2]}!"
        )


def visual_information_fidelity(preds: torch.Tensor, target: torch.Tensor, sigma_n_sq: float = 2.0) -> torch.Tensor:
    """Pixel-domain visual information fidelity, averaged over images and channels.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import visual_information_fidelity
        >>> preds = (torch.arange(1 * 3 * 48 * 48).reshape(1, 3, 48, 48) % 255) / 255.0
        >>> round(float(visual_information_fidelity(preds, preds * 0.75)), 4)
        1.7622
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_vif_size(preds, target)
    per_channel = [_vif_per_channel(preds[:, i], target[:, i], sigma_n_sq).mean() for i in range(preds.shape[1])]
    return torch.stack(per_channel).mean() if len(per_channel) > 1 else per_channel[0]
