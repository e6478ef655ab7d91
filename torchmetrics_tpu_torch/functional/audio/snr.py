"""Signal-to-noise ratio family: SNR, SI-SNR and C-SI-SNR, each reducing the
last axis to one value a leading index."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _at_least_float32


def signal_noise_ratio(preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False) -> torch.Tensor:
    """SNR in dB, ``10 log10(||target||² / ||target - preds||²)`` over the last axis.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import signal_noise_ratio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> round(float(signal_noise_ratio(preds, target)), 4)
        20.0
    """
    preds = _at_least_float32(preds)
    target = _at_least_float32(target)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    noise = target - preds
    snr_value = ((target**2).sum(dim=-1) + eps) / ((noise**2).sum(dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SI-SNR: SI-SDR of zero-mean signals.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import scale_invariant_signal_noise_ratio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> round(float(scale_invariant_signal_noise_ratio(preds, target)), 4)
        20.0
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


def complex_scale_invariant_signal_noise_ratio(
    preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False
) -> torch.Tensor:
    """C-SI-SNR of complex spectra ``(..., freq, time)``, or of real ones with
    a trailing real/imaginary axis ``(..., freq, time, 2)``: SI-SDR over the
    flattened spectral axes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import complex_scale_invariant_signal_noise_ratio
        >>> target = torch.stack([torch.cos(torch.arange(20.0)).reshape(4, 5),
        ...                       torch.sin(torch.arange(20.0)).reshape(4, 5)], dim=-1)
        >>> preds = target * 0.9 + 0.01
        >>> round(float(complex_scale_invariant_signal_noise_ratio(preds, target)), 4)
        36.0883
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if preds.is_complex():
        preds = torch.view_as_real(preds)
    if target.is_complex():
        target = torch.view_as_real(target)

    if (preds.ndim < 3 or preds.shape[-1] != 2) or (target.ndim < 3 or target.shape[-1] != 2):
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )

    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)
