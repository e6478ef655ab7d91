"""Image-kernel utilities: gaussian and uniform separable windows, reflection
and scipy-style symmetric padding, the plain convolution and the pooling of
MS-SSIM.

Every 2-D windowed sum goes through the ``ssim_windows`` kernel
(ops/ssim_kernel.py): :func:`_separable_window_2d` (UQI, RMSE-SW, RASE,
SCC, VIF and the pan-sharpening family) takes its generic entry, and the
fused entry reflects indices itself as :func:`_reflect_index` does. The 3-D
window and :func:`_conv2d` are plain PyTorch in full float32, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.ops.ssim_kernel import _WINDOW_GEMM_MAX_DIM, _band_matrix, full_float32, windowed_sum_2d


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """1-D gaussian window of ``kernel_size`` taps, summing to 1: formed in
    float64 on the host and rounded, so every device windows with the same
    taps (a window's moments cancel in ``E[x²] − μ²``, where taps that sum
    to 1 give or take a device's ulp shift every variance alike)."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1, dtype=torch.float64)
    gauss = torch.exp(-torch.pow(dist / sigma, 2) / 2)
    return (gauss / gauss.sum()).to(dtype=dtype, device=device)


def _separable_window_2d(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor) -> torch.Tensor:
    """Valid separable windowed sum of NCHW ``x`` with 1-D taps ``g_h``
    (down) and ``g_w`` (across): one ``ssim_windows`` call over the
    ``(N·C, H, W)`` plane stack, whatever the image size."""
    n, c, h, w = x.shape
    out = windowed_sum_2d(x.reshape(n * c, h, w), g_h, g_w)
    return out.reshape(n, c, out.shape[-2], out.shape[-1]).to(x.dtype)


def _separable_window_3d(x: torch.Tensor, g_d: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor) -> torch.Tensor:
    """Valid separable windowed sum of NCDHW ``x``: three banded products up
    to an edge of ``_WINDOW_GEMM_MAX_DIM``, three 1-D convolutions above it."""
    g_d, g_h, g_w = (g.to(x) for g in (g_d, g_h, g_w))
    with full_float32():
        if max(x.shape[2:]) > _WINDOW_GEMM_MAX_DIM:
            n, c = x.shape[:2]
            out = x.reshape(n * c, 1, *x.shape[2:])
            out = F.conv3d(out, g_d.reshape(1, 1, -1, 1, 1))
            out = F.conv3d(out, g_h.reshape(1, 1, 1, -1, 1))
            out = F.conv3d(out, g_w.reshape(1, 1, 1, 1, -1))
            return out.reshape(n, c, *out.shape[2:])
        bd = _band_matrix(g_d, x.shape[2] - g_d.shape[0] + 1)
        bh = _band_matrix(g_h, x.shape[3] - g_h.shape[0] + 1)
        bw = _band_matrix(g_w, x.shape[4] - g_w.shape[0] + 1)
        out = torch.einsum("ncdhw,de->ncehw", x, bd)
        out = torch.einsum("ncehw,hi->nceiw", out, bh)
        return torch.einsum("nceiw,wj->nceij", out, bw)


def _conv2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain valid convolution of NCHW ``x`` with an OIHW ``kernel``, in full
    float32 (cuDNN would otherwise take TF32 on the card)."""
    with full_float32():
        return F.conv2d(x, kernel.to(x))


def _single_dimension_pad(inputs: torch.Tensor, dim: int, pad: int, outer_pad: int = 0) -> torch.Tensor:
    """Scipy-style symmetric padding of one axis (the edge repeated): the
    first ``pad`` elements reversed before, the last ``pad + outer_pad - 1``
    reversed after."""
    n = inputs.shape[dim]
    before = torch.arange(pad - 1, -1, -1, device=inputs.device)
    after = torch.arange(n - 1, n - pad - outer_pad, -1, device=inputs.device)
    return torch.cat((inputs.index_select(dim, before), inputs, inputs.index_select(dim, after)), dim=dim)


def _reflection_pad_2d(inputs: torch.Tensor, pad: int, outer_pad: int = 0) -> torch.Tensor:
    """Scipy-style symmetric padding of H and W."""
    for dim in (2, 3):
        inputs = _single_dimension_pad(inputs, dim, pad, outer_pad)
    return inputs


def _uniform_filter(inputs: torch.Tensor, window_size: int) -> torch.Tensor:
    """Uniform (box) filter with scipy's padding: an output the size of the input."""
    inputs = _reflection_pad_2d(inputs, window_size // 2, window_size % 2)
    uniform = torch.full((window_size,), 1.0 / window_size, dtype=inputs.dtype, device=inputs.device)
    return _separable_window_2d(inputs, uniform, uniform)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of an axis of length ``n`` reflected by ``pad`` on each
    side, as numpy's ``reflect`` mode gives them for any ``pad``: folded at
    period ``2 (n - 1)``, and the single element repeated when ``n == 1``.
    The fused kernel (``csrc/ssim_windows.cu:reflect``) folds the same way."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _reflect_pad(x: torch.Tensor, pads) -> torch.Tensor:
    """Reflect padding of the last ``len(pads)`` axes (the edge is not
    repeated). ``F.pad`` serves pads shorter than their axis; a longer pad
    reflects as numpy (and so ``jnp.pad``) does, by a gather, as does an
    empty ``x`` (``F.pad`` refuses zero channels)."""
    sizes = x.shape[-len(pads):]
    if x.numel() and all(p < n for p, n in zip(pads, sizes)):
        return F.pad(x, [q for p in reversed(pads) for q in (p, p)], mode="reflect")
    for axis, (p, n) in enumerate(zip(pads, sizes), start=x.ndim - len(pads)):
        x = x.index_select(axis, _reflect_index(n, p, x.device))
    return x


def _reflect_pad_2d(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect padding of the last two axes."""
    return _reflect_pad(x, (pad_h, pad_w))


def _reflect_pad_3d(x: torch.Tensor, pad_d: int, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect padding of the last three axes."""
    return _reflect_pad(x, (pad_d, pad_h, pad_w))


def _avg_pool2d(x: torch.Tensor, kernel: int = 2) -> torch.Tensor:
    """Average pooling of NCHW ``x`` (MS-SSIM's downsampling); an empty
    ``x`` (which ``F.avg_pool2d`` refuses at zero channels) keeps its shape
    rule."""
    if not x.numel():
        return x.new_empty((*x.shape[:-2], x.shape[-2] // kernel, x.shape[-1] // kernel))
    return F.avg_pool2d(x, kernel)
