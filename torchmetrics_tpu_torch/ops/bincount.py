"""Weighted bincount: the counting core of the classification stack.

Confusion matrices (``num_classes*target + preds`` flattened indices),
stat-scores and calibration histograms all reduce to
``out[k, c] = sum_n w[k, n] * [x[n] == c]`` over K weight rows sharing one
index stream, with negative and out-of-range indices dropped. A weightless
count (``weights=None``, K = 1) counts every in-range index once, as an exact int64 count:
callers with a 0/1 mask fold it into the index (a masked sample is -1)
instead of building a weight row.

Two bodies behind the ``"bincount"`` entry of the dispatch seam
(ops/kernels.py):

- :func:`_wbincount_cuda` launches the hand-written Hopper kernel in
  ``csrc/bincount.cu`` (the port of the JAX package's Pallas kernel
  ``ops/bincount.py:_wbincount_pallas``); it serves every CUDA tensor;
- :func:`_wbincount_reference`, the plain PyTorch version: a masked
  ``index_add_``. It serves CPU tensors and is the oracle the kernel is held
  against on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from torchmetrics_tpu_torch.ops import kernels, native

#: launches of the CUDA kernel in this process (a plain counter that a run
#: resets and reads to show its main path went through the kernel)
launches = 0


def _wbincount_reference(x: torch.Tensor, weights: Optional[torch.Tensor], length: int) -> torch.Tensor:
    """Plain PyTorch version: ``weights (K, N) -> counts (K, length)`` float32,
    or with ``weights=None`` a weightless ``(1, length)`` int64 count of every
    in-range index.

    Masks negative and out-of-range indices (``index_add_`` and
    ``torch.bincount`` raise on them) and scatter-adds the rest. Weightless
    counts add int64 ones, exact at any N. Weighted sums run in float64 and
    round once to float32: a float32 scatter of a million fractional weights
    into a few bins drifts by about 1e-5 relative in itself, more than the
    tolerance the kernel is held to against this oracle."""
    in_range = (x >= 0) & (x < length)
    idx = torch.where(in_range, x, torch.zeros_like(x)).to(torch.int64)
    if weights is None:
        out = torch.zeros((1, int(length)), dtype=torch.int64, device=x.device)
        return out.index_add_(1, idx, in_range.to(torch.int64)[None, :])
    w = weights.to(torch.float64)
    w = torch.where(in_range[None, :], w, torch.zeros_like(w))
    out = torch.zeros((w.shape[0], int(length)), dtype=torch.float64, device=w.device)
    return out.index_add_(1, idx, w).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and typed once."""
    fn = native.load("bincount").tm_wbincount
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _wbincount_cuda(x: torch.Tensor, weights: Optional[torch.Tensor], length: int) -> torch.Tensor:
    """Launch ``csrc/bincount.cu`` on ``torch.cuda.current_stream()``.

    Takes ``x`` int32 ``(N,)`` and ``weights`` float32 ``(K, N)``, or
    ``weights=None`` for a weightless count (K = 1), all contiguous on one
    CUDA device; raises on anything else. Returns a fresh float32
    ``(K, length)``, or int64 ``(1, length)`` weightless, which the launch
    zeroes before it counts; with ``N == 0`` it returns zeros without a
    launch."""
    global launches
    if x.dtype != torch.int32 or (weights is not None and weights.dtype != torch.float32):
        got = "none" if weights is None else weights.dtype
        raise TypeError(f"bincount kernel takes int32 x and float32 weights, got {x.dtype} and {got}")
    if x.ndim != 1 or (weights is not None and (weights.ndim != 2 or weights.shape[1] != x.shape[0])):
        got = None if weights is None else tuple(weights.shape)
        raise ValueError(f"bincount kernel takes x (N,) and weights (K, N), got {tuple(x.shape)} and {got}")
    if not (x.is_contiguous() and (weights is None or weights.is_contiguous())):
        raise ValueError("bincount kernel takes contiguous x and weights")
    if length < 1:
        raise ValueError(f"bincount kernel takes length >= 1, got {length}")
    if x.device.type != "cuda" or (weights is not None and weights.device != x.device):
        got = None if weights is None else weights.device
        raise ValueError(f"bincount kernel takes x and weights on one CUDA device, got {x.device} and {got}")
    k_rows = 1 if weights is None else weights.shape[0]
    dtype = torch.int64 if weights is None else torch.float32
    if x.numel() == 0:
        return torch.zeros((k_rows, int(length)), dtype=dtype, device=x.device)
    out = torch.empty((k_rows, int(length)), dtype=dtype, device=x.device)
    device = x.device.index
    stream = native.current_stream(device)
    err = _entry()(
        x.data_ptr(), None if weights is None else weights.data_ptr(), out.data_ptr(),
        x.numel(), int(length), k_rows, device, stream,
    )
    if err != 0:
        raise RuntimeError(f"bincount kernel launch failed with CUDA error {err}")
    launches += 1
    return out


kernels.register_kernel(
    kernels.KernelSpec(
        name="bincount",
        reference=_wbincount_reference,
        cuda=_wbincount_cuda,
    )
)


def weighted_bincount(x: torch.Tensor, weights: Optional[torch.Tensor] = None, length: int = 0) -> torch.Tensor:
    """``zeros(length).index_add_(x, weights)`` through the dispatch seam,
    dropping negative and out-of-range indices. Returns float32 when
    weighted, int32 otherwise.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
        >>> weighted_bincount(torch.tensor([0, 1, 1, 3]), length=4).tolist()
        [1, 2, 0, 1]
        >>> weighted_bincount(torch.tensor([0, 1, 1, 3]),
        ...                   weights=torch.tensor([0.5, 1.0, 2.0, 0.25]), length=4).tolist()
        [0.5, 3.0, 0.0, 0.25]
    """
    x = x.reshape(-1).to(torch.int32).contiguous()
    if weights is None:
        return kernels.dispatch("bincount", x, None, int(length))[0].to(torch.int32)
    w = weights.reshape(1, -1).to(torch.float32).contiguous()
    return kernels.dispatch("bincount", x, w, int(length))[0]


def weighted_bincount_multi(x: torch.Tensor, weights: torch.Tensor, length: int) -> torch.Tensor:
    """K weighted bincounts sharing one index stream: weights (K, N) -> (K, length),
    one pass over the indices for all K rows (calibration's count/confidence/
    accuracy histograms are the K = 3 use)."""
    x = x.reshape(-1).to(torch.int32)
    weights = weights.to(torch.float32)
    if weights.ndim != 2 or weights.shape[1] != x.shape[0]:
        raise ValueError(f"weights must be (K, N={x.shape[0]}), got {tuple(weights.shape)}")
    return kernels.dispatch("bincount", x.contiguous(), weights.contiguous(), int(length))
