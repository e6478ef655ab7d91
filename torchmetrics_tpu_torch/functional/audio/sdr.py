"""Signal-to-distortion ratio family: SDR, SI-SDR and SA-SDR.

SDR projects the estimate onto ``filter_length`` shifts of the reference:
the auto-correlation of the reference and its cross-correlation with the
estimate come from one real FFT each (``torch.fft.rfft``/``irfft`` at a
power-of-two length), the symmetric Toeplitz system is a gather on
``|i - j|``, and all of a batch's systems are solved in one batched
``torch.linalg.solve``. The solve runs in float64 on every device (upstream
TorchMetrics' precision; the JAX package solves in float32 unless
``jax_enable_x64`` is on), and the result comes back in the input's float
dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _at_least_float32


def _symmetric_toeplitz(vector: torch.Tensor) -> torch.Tensor:
    """Symmetric Toeplitz matrices from their first rows, ``(..., L) -> (..., L, L)``:
    a gather on ``|i - j|``."""
    ar = torch.arange(vector.shape[-1], device=vector.device)
    return vector[..., (ar[:, None] - ar[None, :]).abs()]


def _compute_autocorr_crosscorr(target: torch.Tensor, preds: torch.Tensor, corr_len: int) -> tuple:
    """FFT auto-correlation of ``target`` and its cross-correlation with
    ``preds``, the first ``corr_len`` lags of each."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft, dim=-1)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(t_fft.conj() * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> torch.Tensor:
    """SDR in dB after projecting ``preds`` onto ``filter_length`` shifts of
    ``target``; shapes ``(..., time)``, result ``(...,)``.

    ``use_cg_iter`` is accepted and ignored (the batched direct solve serves
    every size). The Toeplitz systems are solved in float64; the residual
    energy ``1 - coh`` is clamped at float64's eps, and the value comes back
    in the input's float dtype (float32 for integer inputs).

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import signal_distortion_ratio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> round(float(signal_distortion_ratio(preds, target)), 4)
        21.6644
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _check_same_shape(preds, target)
    out_dtype = preds.dtype if preds.is_floating_point() else torch.float32
    preds = preds.to(torch.float64)
    target = target.to(torch.float64)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    target = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True).clamp(min=1e-6)
    preds = preds / torch.linalg.vector_norm(preds, dim=-1, keepdim=True).clamp(min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = r_0.clone()
        r_0[..., 0] += load_diag

    sol = torch.linalg.solve(_symmetric_toeplitz(r_0), b[..., None])[..., 0]
    coh = (b * sol).sum(dim=-1)
    ratio = coh / (1 - coh).clamp(min=torch.finfo(torch.float64).eps)
    return (10.0 * torch.log10(ratio)).to(out_dtype)


def scale_invariant_signal_distortion_ratio(
    preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False
) -> torch.Tensor:
    """SI-SDR in dB over the last axis.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
        20.0
    """
    # dB outputs keep float32 at least: float16 sums of squares overflow
    preds = _at_least_float32(preds)
    target = _at_least_float32(target)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    alpha = ((preds * target).sum(dim=-1, keepdim=True) + eps) / ((target**2).sum(dim=-1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = ((target_scaled**2).sum(dim=-1) + eps) / ((noise**2).sum(dim=-1) + eps)
    return 10 * torch.log10(val)


def source_aggregated_signal_distortion_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    scale_invariant: bool = True,
    zero_mean: bool = False,
) -> torch.Tensor:
    """SA-SDR in dB over ``(..., spk, time)`` inputs: one scale for all
    speakers, energies summed over speakers and time.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import source_aggregated_signal_distortion_ratio
        >>> t = torch.arange(0, 0.5, 1 / 800.0)
        >>> target = torch.stack([torch.sin(2 * math.pi * 100 * t), torch.sin(2 * math.pi * 150 * t)])
        >>> preds = target + 0.05 * torch.cos(2 * math.pi * 17 * t)
        >>> round(float(source_aggregated_signal_distortion_ratio(preds, target)), 4)
        26.0254
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(f"The preds and target should have the shape (..., spk, time), but {tuple(preds.shape)} found")

    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    if scale_invariant:
        alpha = ((preds * target).sum(dim=(-2, -1), keepdim=True) + eps) / (
            (target**2).sum(dim=(-2, -1), keepdim=True) + eps
        )
        target = alpha * target

    distortion = target - preds
    val = ((target**2).sum(dim=(-2, -1)) + eps) / ((distortion**2).sum(dim=(-2, -1)) + eps)
    return 10 * torch.log10(val)
