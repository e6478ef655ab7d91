"""Perceptual Evaluation of Speech Quality (PESQ) on the port's own C++
library (``native/pesq.cpp``, built into ``_build/libtm_pesq-<hash>.so``).

The ITU-T P.862 pipeline (level alignment, band-limit filtering, delay
estimation, the Bark-loudness perceptual model and the P.862.1/P.862.2
MOS-LQO mapping) runs on the host in float64, one native call a batch; the
library's header says what it simplifies. There is no pure-Python body:
without the library, the metric raises.
"""
from __future__ import annotations

import numpy as np
import torch

from torchmetrics_tpu_torch import native


def _host_float64(x) -> np.ndarray:
    """One read of ``x`` to a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _out_device(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def perceptual_evaluation_speech_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> torch.Tensor:
    """MOS-LQO of degraded ``preds`` against clean ``target``, shapes
    ``(..., time)``; float32 scores of the batch shape on ``preds``' device.

    The inputs are read to the host once as float64. ``keep_same_device``
    and ``n_processes`` are accepted and change nothing (the scores always
    come back on the input's device; the native call is batched). A signal
    the library refuses (too short) scores NaN, with a ``RuntimeWarning``.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import perceptual_evaluation_speech_quality
        >>> t = torch.arange(0, 1.0, 1 / 8000.0)
        >>> target = torch.sin(2 * math.pi * 440 * t)
        >>> preds = target + 0.1 * torch.sin(2 * math.pi * 555 * t)
        >>> round(float(perceptual_evaluation_speech_quality(preds, target, fs=8000, mode="nb")), 4)
        4.4069
    """
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    if mode == "wb" and fs == 8000:
        raise ValueError("Argument `mode='wb'` requires `fs=16000`")

    device = _out_device(preds)
    preds_np, target_np = _host_float64(preds), _host_float64(target)
    if preds_np.shape != target_np.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, got {preds_np.shape} and {target_np.shape}"
        )

    single = preds_np.ndim == 1
    flat_p = preds_np.reshape(-1, preds_np.shape[-1])
    flat_t = target_np.reshape(-1, target_np.shape[-1])
    scores = native.pesq_batch(flat_t, flat_p, fs, wideband=mode == "wb")
    if scores is None:
        raise ModuleNotFoundError(
            "PESQ needs the port's native library (native/pesq.cpp), which could not be built or loaded;"
            f" there is no pure-Python PESQ. The build said: {native.pesq_build_error()}"
        )
    out = scores[0] if single else scores.reshape(preds_np.shape[:-1])
    return torch.as_tensor(np.asarray(out, dtype=np.float32), device=device)
