"""PSD matrix square root for FID's trace term.

FID's compute takes ``Tr sqrt(S1 S2)`` through the symmetric identity
``Tr sqrt(S1^1/2 S2 S1^1/2)`` (image/fid.py), whose expensive half is the PSD
square root ``S1^1/2`` of an F x F covariance (F = 2048 at the standard
Inception tap). The coupled Newton–Schulz iteration computes it with matrix
products alone::

    c = max(||A||_F, 1e-30),  Y_0 = A / c,  Z_0 = I
    T_k = (3 I - Z_k Y_k) / 2,  Y_{k+1} = Y_k T_k,  Z_{k+1} = T_k Z_k
    sqrt(A) ~= Y_K sqrt(c)

Bodies behind the ``"fid_sqrtm"`` entry of the dispatch seam (ops/kernels.py):

- :func:`_sqrtm_cuda` launches the hand-written Hopper kernel in
  ``csrc/fid_sqrtm.cu`` (the port of the JAX package's Pallas kernel
  ``ops/sqrtm_kernel.py:_sqrtm_pallas``): ``KERNEL_ITERS`` float64 steps on
  the FP64 tensor cores in 1 + 2 * KERNEL_ITERS launches, float64 in and
  out; it serves every CUDA tensor, at every size;
- :func:`_sqrtm_reference`, the eigh-based PSD-projected square root in
  float32, serves CPU tensors. The JAX package's CPU gate always serves its
  own float32 ``eigh`` body, so the port on the CPU computes what JAX on the
  CPU does;
- :func:`_sqrtm_ns_reference` is the same iteration in plain PyTorch, in
  float64 at ``KERNEL_ITERS`` steps by default: the oracle the kernel is held
  against on the card (at ``NS_ITERS`` float32 steps it is the JAX package's
  Pallas kernel). No metric path calls it.

Why float64, and 22 steps where the JAX package takes 16 in float32. An
eigenvalue p of ``A / ||A||_F`` converges after about
``log(1/p) / (2 log 1.5)`` steps. On a covariance with one dominant mode
(``||A||_F`` near the top eigenvalue, the rest of the spectrum far below)
the float32 iteration stops near 1e-3 of FID whatever its step count
(``chip_smoke.py``'s ``f2048_dominant`` shape: 3.5e-3 at 16 float32 steps
on an H100), while float64 converges: on the same shape and card, 3.2e-4
at 20 float64 steps, 8.9e-5 at 22, 1.5e-5 at 24 (``chip_smoke.py``'s step
sweep). More steps are not free either: rounding leaves eigenvalues of a
rank-deficient covariance just below zero, which the step's scalar map
``p -> p (3 - p)^2 / 4`` grows by 2.25x a step; a rank-999 covariance at
F = 2048 holds at about 2e-7 to 26 steps and drifts from 28. 22 is the
least count with every checked shape within 2.5e-4 of float64.
"""
from __future__ import annotations

import ctypes
import functools
import sys

import torch

from torchmetrics_tpu_torch.ops import kernels, launch_counts, native
from torchmetrics_tpu_torch.utils.compute import full_float32

#: Newton–Schulz steps of the JAX package's float32 kernel
NS_ITERS = 16
#: float64 Newton–Schulz steps of the card's kernel
KERNEL_ITERS = 22

#: launches of the CUDA kernels in this process (1 + 2 * KERNEL_ITERS a
#: call) and calls of the wrapper: plain counters that a run resets and reads
#: to show its main path went through the kernel
launches = 0
calls = 0


def _sqrtm_reference(sigma: torch.Tensor) -> torch.Tensor:
    """The exact body: ``eigh`` in float32, eigenvalues clipped at 0 (PSD
    projection); float32 out."""
    e, v = torch.linalg.eigh(sigma.to(torch.float32))
    return (v * torch.sqrt(torch.clamp(e, min=0.0))) @ v.T


def _sqrtm_ns_reference(
    sigma: torch.Tensor, iters: int = KERNEL_ITERS, dtype: torch.dtype = torch.float64
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the coupled iteration in ``dtype``
    for ``iters`` steps, unpadded, with full-precision products (no TF32);
    the root in ``dtype``."""
    a = sigma.to(dtype)
    eye = torch.eye(a.shape[0], dtype=dtype, device=a.device)
    c = torch.clamp(torch.sqrt(torch.sum(a * a)), min=1e-30)
    y, z = a / c, eye
    with full_float32():
        for _ in range(iters):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
    return y * torch.sqrt(c)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and typed once, and the length of
    its partial-sum buffer."""
    lib = native.load("fid_sqrtm")
    fn = lib.tm_fid_sqrtm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tm_fid_sqrtm_max_partials.restype = ctypes.c_int
    return fn, int(lib.tm_fid_sqrtm_max_partials())


def _sqrtm_cuda(sigma: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/fid_sqrtm.cu`` on ``torch.cuda.current_stream()``.

    Takes a float64 ``(F, F)`` contiguous matrix on a CUDA device; raises on
    anything else. Returns a fresh float64 ``(F, F)``; with ``F == 0`` it
    returns it without a launch. The workspace (4 F^2 doubles and the
    partial sums) comes from PyTorch's allocator on the input's device."""
    if sigma.dtype != torch.float64:
        raise TypeError(f"fid_sqrtm kernel takes a float64 matrix, got {sigma.dtype}")
    if sigma.ndim != 2 or sigma.shape[0] != sigma.shape[1]:
        raise ValueError(f"fid_sqrtm kernel takes a square matrix, got shape {tuple(sigma.shape)}")
    if not sigma.is_contiguous():
        raise ValueError("fid_sqrtm kernel takes a contiguous matrix")
    if sigma.device.type != "cuda":
        raise ValueError(f"fid_sqrtm kernel takes a matrix on a CUDA device, got {sigma.device}")
    n = sigma.shape[0]
    out = torch.empty_like(sigma)
    if n == 0:
        return out
    launch, partials = _entry()
    ws = torch.empty(4 * n * n + partials, dtype=torch.float64, device=sigma.device)
    with torch.cuda.device(sigma.device):
        stream = native.current_stream(sigma.device.index)
        err = launch(sigma.data_ptr(), out.data_ptr(), ws.data_ptr(), n, KERNEL_ITERS, stream)
    if err != 0:
        raise RuntimeError(f"fid_sqrtm kernel launch failed with CUDA error {err}")
    launch_counts.add(sys.modules[__name__], "launches", 1 + 2 * KERNEL_ITERS)
    launch_counts.add(sys.modules[__name__], "calls", 1)
    return out


kernels.register_kernel(
    kernels.KernelSpec(
        name="fid_sqrtm",
        reference=_sqrtm_reference,
        cuda=_sqrtm_cuda,
    )
)


def sqrtm_psd(sigma: torch.Tensor) -> torch.Tensor:
    """``sigma^(1/2)`` of a symmetric PSD matrix through the dispatch seam,
    which is handed the matrix in float64: the float32 ``eigh`` body on the
    CPU (float32 out), the float64 Newton–Schulz kernel on the card (float64
    out).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.ops.sqrtm_kernel import sqrtm_psd
        >>> sqrtm_psd(torch.tensor([[4.0, 0.0], [0.0, 9.0]])).tolist()
        [[2.0, 0.0], [0.0, 3.0]]
    """
    return kernels.dispatch("fid_sqrtm", sigma.to(torch.float64).contiguous())
