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
  ``ops/sqrtm_kernel.py:_sqrtm_pallas``), 16 steps in 33 launches; it serves
  every CUDA tensor, at every size;
- :func:`_sqrtm_reference`, the eigh-based PSD-projected square root, serves
  CPU tensors. The JAX package's CPU gate always serves its own ``eigh``
  body, so the port on the CPU computes what JAX on the CPU does;
- :func:`_sqrtm_ns_reference` is the same 16 steps in plain PyTorch: the
  oracle the kernel is held against on the card. No metric path calls it.

Why 16 steps, as in the JAX package. An eigenvalue p of ``A / ||A||_F``
converges after about ``log(1/p) / (2 log 1.5)`` steps, so 16 steps reach
p >= 2.3e-6. More steps are not safer in float32: on a rank-deficient
covariance rounding leaves eigenvalues just below zero, which the step's
scalar map ``p -> p (3 - p)^2 / 4`` grows by more than 2.25x a step.
``chip_smoke.py`` measures both on an H100: FID from the 16-step root within
2.4e-4 of float64 at F = 64 to 2048, rank-deficient input included, the
reconstruction ``||Y^2 - A|| / ||A||`` least at 16 steps on that input and
NaN from 28; and on a covariance with one dominant mode the float32
iteration stops near 1e-3 of FID whatever the step count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from torchmetrics_tpu_torch.ops import kernels, native
from torchmetrics_tpu_torch.utils.compute import full_float32

#: Newton–Schulz steps, as in the JAX package
NS_ITERS = 16

#: launches of the CUDA kernels in this process (1 + 2 * NS_ITERS a call) and
#: calls of the wrapper: plain counters that a run resets and reads to show
#: its main path went through the kernel
launches = 0
calls = 0


def _sqrtm_reference(sigma: torch.Tensor) -> torch.Tensor:
    """The exact body: ``eigh``, eigenvalues clipped at 0 (PSD projection)."""
    e, v = torch.linalg.eigh(sigma)
    return (v * torch.sqrt(torch.clamp(e, min=0.0))) @ v.T


def _sqrtm_ns_reference(sigma: torch.Tensor, iters: int = NS_ITERS) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the coupled iteration in float32,
    unpadded, with full float32 products (no TF32)."""
    a = sigma.to(torch.float32)
    eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    c = torch.clamp(torch.sqrt(torch.sum(a * a)), min=1e-30)
    y, z = a / c, eye
    with full_float32():
        for _ in range(iters):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
    return (y * torch.sqrt(c)).to(sigma.dtype)


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

    Takes a float32 ``(F, F)`` contiguous matrix on a CUDA device; raises on
    anything else. Returns a fresh float32 ``(F, F)``; with ``F == 0`` it
    returns it without a launch. The workspace (4 F^2 floats and the partial
    sums) comes from PyTorch's allocator on the input's device."""
    global launches, calls
    if sigma.dtype != torch.float32:
        raise TypeError(f"fid_sqrtm kernel takes a float32 matrix, got {sigma.dtype}")
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
    ws = torch.empty(4 * n * n + partials, dtype=torch.float32, device=sigma.device)
    with torch.cuda.device(sigma.device):
        stream = torch.cuda.current_stream(sigma.device).cuda_stream
        err = launch(sigma.data_ptr(), out.data_ptr(), ws.data_ptr(), n, NS_ITERS, stream)
    if err != 0:
        raise RuntimeError(f"fid_sqrtm kernel launch failed with CUDA error {err}")
    launches += 1 + 2 * NS_ITERS
    calls += 1
    return out


kernels.register_kernel(
    kernels.KernelSpec(
        name="fid_sqrtm",
        reference=_sqrtm_reference,
        cuda=_sqrtm_cuda,
    )
)


def sqrtm_psd(sigma: torch.Tensor) -> torch.Tensor:
    """``sigma^(1/2)`` of a symmetric PSD matrix through the dispatch seam:
    the exact ``eigh`` body on the CPU, the Newton–Schulz kernel on the card.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.ops.sqrtm_kernel import sqrtm_psd
        >>> sqrtm_psd(torch.tensor([[4.0, 0.0], [0.0, 9.0]])).tolist()
        [[2.0, 0.0], [0.0, 3.0]]
    """
    return kernels.dispatch("fid_sqrtm", sigma.to(torch.float32).contiguous())
