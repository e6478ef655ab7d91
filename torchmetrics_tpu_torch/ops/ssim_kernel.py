"""Separable windowed sums: the core of SSIM's moment statistics.

SSIM runs its five-plane stack (preds, target, preds², target², preds·target)
through a separable window: a valid cross-correlation with the rank-1 kernel
``outer(g_h, g_w)``. :func:`windowed_sum_2d` computes it for a stack of
``(M, Hp, Wp)`` planes.

Two bodies behind the ``"ssim_windows"`` entry of the dispatch seam
(ops/kernels.py):

- :func:`_windowed_cuda` launches the hand-written Hopper kernel in
  ``csrc/ssim_windows.cu`` (the port of the JAX package's Pallas kernel
  ``ops/ssim_kernel.py:_windowed_pallas``), a direct separable correlation,
  on every CUDA tensor and at every size. It is differentiable in ``x``:
  the backward pass is the same kernel over the zero-padded output gradient
  with reversed taps;
- :func:`_windowed_reference`, the plain PyTorch version: the JAX package's
  two expressions and its switch between them. Up to an edge of
  ``_WINDOW_GEMM_MAX_DIM`` it multiplies by banded matrices (two einsums);
  above it, two 1-D convolutions. It serves CPU tensors and is the oracle
  the kernel is held against on the card, where it runs in full float32
  (TF32 off for both the matrix products and cuDNN).

Taps are constants: no gradient flows to them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.ops import kernels, native
from torchmetrics_tpu_torch.utils.compute import full_float32

#: launches of the CUDA kernel in this process (a plain counter that a run
#: resets and reads to show its main path went through the kernel)
launches = 0

# Above this edge the banded matrices' O(H^2) cost overtakes the 1-D
# convolutions; the plain body keeps the JAX package's switch. The kernel
# has no such cost and serves every size.
_WINDOW_GEMM_MAX_DIM = 2048


def _band_matrix(g: torch.Tensor, out_len: int) -> torch.Tensor:
    """``(out_len + k - 1, out_len)`` banded matrix ``B`` with ``B[o + d, o] = g[d]``:
    ``x_padded @ B`` is the valid 1-D cross-correlation of ``x_padded`` with ``g``."""
    k = g.shape[0]
    rows = torch.arange(out_len + k - 1, device=g.device)[:, None]
    cols = torch.arange(out_len, device=g.device)[None, :]
    d = rows - cols
    return torch.where((d >= 0) & (d < k), g[torch.clamp(d, 0, k - 1)], torch.zeros((), dtype=g.dtype, device=g.device))


def _windowed_reference(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x (M, Hp, Wp)`` -> ``(M, Hp - kh + 1, Wp - kw + 1)``,
    the vertical pass first, as in the JAX package."""
    x = x.to(torch.float32)
    g_h, g_w = g_h.to(x), g_w.to(x)
    with full_float32():
        if max(x.shape[1], x.shape[2]) > _WINDOW_GEMM_MAX_DIM:
            out = F.conv2d(x[:, None], g_h.reshape(1, 1, -1, 1))
            return F.conv2d(out, g_w.reshape(1, 1, 1, -1))[:, 0]
        bh = _band_matrix(g_h, x.shape[1] - g_h.shape[0] + 1)
        bw = _band_matrix(g_w, x.shape[2] - g_w.shape[0] + 1)
        out = torch.einsum("mhw,hi->miw", x, bh)
        return torch.einsum("miw,wj->mij", out, bw)


@functools.lru_cache(maxsize=None)
def _entry() -> Tuple[ctypes._CFuncPtr, int]:
    """The kernel's C entry point, built and typed once, and its tap limit."""
    lib = native.load("ssim_windows")
    launch = lib.tm_ssim_windows
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    lib.tm_ssim_windows_max_taps.restype = ctypes.c_int
    return launch, int(lib.tm_ssim_windows_max_taps())


def _launch(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ssim_windows.cu`` on ``torch.cuda.current_stream()``.

    Takes ``x`` float32 ``(M, Hp, Wp)`` and float32 taps ``g_h (kh,)``,
    ``g_w (kw,)``, all contiguous on one CUDA device, with ``kh <= Hp``,
    ``kw <= Wp`` and at most 65 taps a direction; raises on anything else.
    Returns a fresh float32 ``(M, Hp - kh + 1, Wp - kw + 1)``."""
    global launches
    tensors = (x, g_h, g_w)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssim_windows kernel takes float32 x and taps, got {[str(t.dtype) for t in tensors]}")
    if x.ndim != 3 or g_h.ndim != 1 or g_w.ndim != 1:
        raise ValueError(
            "ssim_windows kernel takes x (M, Hp, Wp) and 1-D taps, got"
            f" {tuple(x.shape)}, {tuple(g_h.shape)} and {tuple(g_w.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssim_windows kernel takes contiguous x and taps")
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"ssim_windows kernel takes x and taps on one CUDA device, got {[str(t.device) for t in tensors]}")
    m, hp, wp = x.shape
    kh, kw = g_h.shape[0], g_w.shape[0]
    if not (1 <= kh <= hp and 1 <= kw <= wp):
        raise ValueError(f"ssim_windows kernel takes 1 <= taps <= plane extent, got {kh} x {kw} taps on {hp} x {wp}")
    launch, max_taps = _entry()
    if kh > max_taps or kw > max_taps:
        raise ValueError(f"ssim_windows kernel takes at most {max_taps} taps a direction, got {kh} x {kw}")
    out = torch.empty((m, hp - kh + 1, wp - kw + 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), g_h.data_ptr(), g_w.data_ptr(), out.data_ptr(), m, hp, wp, kh, kw, stream)
    if err != 0:
        raise RuntimeError(f"ssim_windows kernel launch failed with CUDA error {err}")
    launches += 1
    return out


class _WindowedSum(torch.autograd.Function):
    """The kernel as an autograd node. The input gradient of a valid
    separable correlation is the same correlation of the output gradient,
    zero-padded by ``k - 1`` on each side, with reversed taps."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(g_h, g_w)
        return _launch(x, g_h, g_w)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g_h, g_w = ctx.saved_tensors
        kh, kw = g_h.shape[0], g_w.shape[0]
        padded = F.pad(grad.contiguous(), (kw - 1, kw - 1, kh - 1, kh - 1))
        return _launch(padded, g_h.flip(0).contiguous(), g_w.flip(0).contiguous()), None, None


def _windowed_cuda(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor) -> torch.Tensor:
    """The CUDA body: :func:`_launch` through :class:`_WindowedSum`, so
    ``x``'s gradient runs on the kernel too."""
    return _WindowedSum.apply(x, g_h, g_w)


kernels.register_kernel(
    kernels.KernelSpec(
        name="ssim_windows",
        reference=_windowed_reference,
        cuda=_windowed_cuda,
    )
)


def windowed_sum_2d(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor) -> torch.Tensor:
    """Valid separable windowed sum of a ``(M, Hp, Wp)`` float32 plane stack
    with 1-D taps ``g_h`` (down) and ``g_w`` (across), through the dispatch
    seam: ``(M, Hp - kh + 1, Wp - kw + 1)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.ops.ssim_kernel import windowed_sum_2d
        >>> x = torch.arange(16.0).reshape(1, 4, 4)
        >>> windowed_sum_2d(x, torch.tensor([1.0, 1.0]), torch.tensor([0.5, 0.5])).tolist()
        [[[5.0, 7.0, 9.0], [13.0, 15.0, 17.0], [21.0, 23.0, 25.0]]]
    """
    return kernels.dispatch(
        "ssim_windows",
        x.to(torch.float32).contiguous(),
        g_h.to(device=x.device, dtype=torch.float32).contiguous(),
        g_w.to(device=x.device, dtype=torch.float32).contiguous(),
    )
