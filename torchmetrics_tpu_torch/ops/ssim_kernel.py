"""Separable windowed sums and fused SSIM: the core of SSIM's moment statistics.

SSIM runs its five-plane stack (preds, target, preds², target², preds·target)
through a separable window: a valid cross-correlation with the rank-1 kernel
``outer(g_h, g_w)``. The hand-written Hopper kernel in
``csrc/ssim_windows.cu`` (the port of the JAX package's Pallas kernel
``ops/ssim_kernel.py:_windowed_pallas``) has two entries, each behind its
own name in the dispatch seam (ops/kernels.py), both counted in
:data:`launches`:

- ``"ssim_windows"``, :func:`windowed_sum_2d` of a ``(M, Hp, Wp)`` stack.
  :func:`_windowed_cuda` launches the generic entry on every CUDA tensor,
  any tap count (one launch, or two for a window too long for shared
  memory), differentiable in ``x``: the backward pass is the same kernel
  over the zero-padded output gradient with reversed taps.
  :func:`_windowed_reference` is its plain PyTorch version: the JAX
  package's two expressions and its switch between them (banded matrices
  up to an edge of ``_WINDOW_GEMM_MAX_DIM``, two 1-D convolutions above).
- ``"ssim_fused"``, 2-D SSIM without a gradient: :func:`_ssim_fused_cuda`
  launches the fused entry on the unpadded preds and target (reflection,
  products, five windows and the per-pixel formula in one launch; per-image
  sums of SSIM and cs, and the map on request). Its plain version is
  :func:`ssim_chain`: reflect padding, the stack, the plain window, the
  formula and the cropped means.

The plain versions serve CPU tensors and are the oracles the kernel is held
against on the card, where they run in full float32 (TF32 off for both the
matrix products and cuDNN). Taps are constants: no gradient flows to them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.ops import kernels, native
from torchmetrics_tpu_torch.utils.compute import full_float32

#: launches of the CUDA kernel, either entry, in this process (a plain counter
#: that a run resets and reads to show its main path went through the kernel)
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
def _entries() -> Tuple[ctypes._CFuncPtr, ctypes._CFuncPtr, ctypes._CFuncPtr]:
    """The kernel's C entry points (plan, generic, fused), built and typed once."""
    lib = native.load("ssim_windows")
    plan = lib.tm_ssim_plan
    plan.argtypes = [ctypes.c_int] + [ctypes.c_int64] * 7 + [ctypes.c_void_p] * 3
    plan.restype = ctypes.c_int
    windows = lib.tm_ssim_windows
    windows.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    windows.restype = ctypes.c_int
    fused = lib.tm_ssim_fused
    fused.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]
    )
    fused.restype = ctypes.c_int
    return plan, windows, fused


@functools.lru_cache(maxsize=256)
def _plan(
    device: int, fused: bool, planes: int, h: int, w: int, pad_h: int, pad_w: int, kh: int, kw: int
) -> Tuple[int, int, int]:
    """``(launches, partial-sum slots a plane, intermediate floats)`` of one
    call on CUDA device ``device``: one launch, or two through an
    intermediate when the window is too long for the ring in shared memory
    (the kernel plans the same call the same way). Cached: an update calls
    the same few shapes every time."""
    launches, parts, tmp = ctypes.c_int(), ctypes.c_int64(), ctypes.c_int64()
    with torch.cuda.device(device):
        err = _entries()[0](
            int(fused), planes, h, w, pad_h, pad_w, kh, kw, ctypes.byref(launches), ctypes.byref(parts), ctypes.byref(tmp)
        )
    if err != 0:
        raise RuntimeError(f"ssim_windows kernel plan failed with CUDA error {err}")
    return launches.value, parts.value, tmp.value


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a fresh copy where its data does not start on 16 bytes (the
    kernel's vector copies read rows from their aligned-down address)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_cuda(name: str, tensors) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32 tensors, got {[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    first = tensors[0]
    if first.device.type != "cuda" or any(t.device != first.device for t in tensors):
        raise ValueError(f"{name} takes tensors on one CUDA device, got {[str(t.device) for t in tensors]}")


def _launch(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor) -> torch.Tensor:
    """Launch the generic entry of ``csrc/ssim_windows.cu`` on
    ``torch.cuda.current_stream()``.

    Takes ``x`` float32 ``(M, Hp, Wp)`` and float32 taps ``g_h (kh,)``,
    ``g_w (kw,)``, all contiguous on one CUDA device, with ``kh <= Hp`` and
    ``kw <= Wp`` (any tap count); raises on anything else. Returns a fresh
    float32 ``(M, Hp - kh + 1, Wp - kw + 1)``. Counts each kernel launch:
    one, or two for a window too long for shared memory."""
    global launches
    _check_cuda("ssim_windows kernel", (x, g_h, g_w))
    if x.ndim != 3 or g_h.ndim != 1 or g_w.ndim != 1:
        raise ValueError(
            "ssim_windows kernel takes x (M, Hp, Wp) and 1-D taps, got"
            f" {tuple(x.shape)}, {tuple(g_h.shape)} and {tuple(g_w.shape)}"
        )
    m, hp, wp = x.shape
    kh, kw = g_h.shape[0], g_w.shape[0]
    if not (1 <= kh <= hp and 1 <= kw <= wp):
        raise ValueError(f"ssim_windows kernel takes 1 <= taps <= plane extent, got {kh} x {kw} taps on {hp} x {wp}")
    out = torch.empty((m, hp - kh + 1, wp - kw + 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        n, _, tmp_floats = _plan(x.device.index, False, m, hp, wp, 0, 0, kh, kw)
        tmp = torch.empty(tmp_floats, dtype=torch.float32, device=x.device) if tmp_floats else None
        x = _aligned(x)
        stream = native.current_stream(x.device.index)
        err = _entries()[1](
            x.data_ptr(), g_h.data_ptr(), g_w.data_ptr(), out.data_ptr(),
            None if tmp is None else tmp.data_ptr(), m, hp, wp, kh, kw, stream,
        )
    if err != 0:
        raise RuntimeError(f"ssim_windows kernel launch failed with CUDA error {err}")
    launches += n
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


# ------------------------------------------------------------ fused SSIM

Consts = Union[float, torch.Tensor]


def ssim_from_moments(
    outputs: torch.Tensor, b: int, c1: Consts, c2: Consts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSIM map and ``upper / lower`` (cs) from the five windowed moment
    planes ``outputs`` (preds, target, preds², target², preds·target stacked
    along dim 0, ``b`` images each), in the JAX package's order of operations."""
    mu_pred = outputs[:b]
    mu_target = outputs[b : 2 * b]
    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = outputs[2 * b : 3 * b] - mu_pred_sq
    sigma_target_sq = outputs[3 * b : 4 * b] - mu_target_sq
    sigma_pred_target = outputs[4 * b :] - mu_pred_target
    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2
    return ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower), upper / lower


def crop_offsets(pad_h: int, pad_w: int) -> Tuple[int, int]:
    """Rows and columns the per-image means leave out at each border of the
    map: the pads, or none unless both pads are non-zero (the JAX package's
    crop)."""
    return (pad_h, pad_w) if pad_h and pad_w else (0, 0)


def ssim_chain(
    preds: torch.Tensor, target: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor, pad_h: int, pad_w: int,
    c1: Consts, c2: Consts, full_image: bool, window: Callable = _windowed_reference,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """2-D SSIM as a chain of tensor operations: reflect padding, the
    five-plane stack, ``window`` over it (``(M, Hp, Wp)`` planes and the two
    taps), the formula and the cropped means. Returns the per-image SSIM and
    cs, and the SSIM map when ``full_image``. With the plain window it is the
    fused entry's plain version: it serves CPU tensors and is the oracle the
    fused kernel is held against on the card."""
    from torchmetrics_tpu_torch.functional.image.utils import _reflect_pad_2d

    b, c = preds.shape[:2]
    preds_p = _reflect_pad_2d(preds, pad_h, pad_w)
    target_p = _reflect_pad_2d(target, pad_h, pad_w)
    stack = torch.cat([preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p])
    hp, wp = stack.shape[-2:]
    outputs = window(stack.reshape(-1, hp, wp), g_h, g_w)
    outputs = outputs.reshape(5 * b, c, outputs.shape[-2], outputs.shape[-1]).to(preds.dtype)
    ssim_map, cs_map = ssim_from_moments(outputs, b, c1, c2)
    ch, cw = crop_offsets(pad_h, pad_w)
    ho, wo = ssim_map.shape[-2:]

    def mean(x: torch.Tensor) -> torch.Tensor:
        return x[..., ch : ho - ch, cw : wo - cw].flatten(1).mean(-1)

    return mean(ssim_map), mean(cs_map), ssim_map if full_image else None


def _ssim_fused_cuda(
    preds: torch.Tensor, target: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor, pad_h: int, pad_w: int,
    c1: Consts, c2: Consts, full_image: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Launch the fused entry of ``csrc/ssim_windows.cu`` on
    ``torch.cuda.current_stream()``: per-image SSIM and cs of float32
    ``(B, C, H, W)`` preds and target reflected by ``pad_h``, ``pad_w`` and
    windowed by the float32 taps, and the SSIM map when ``full_image``.

    ``c1``, ``c2`` are floats or device scalars (a data-dependent
    ``data_range`` stays on the card). The kernel writes float64 partial sums
    a (plane, block); they are summed here in a fixed order, so the result
    is deterministic. An empty crop gives NaN. Counts each kernel launch."""
    global launches
    _check_cuda("ssim_windows fused kernel", (preds, target, g_h, g_w))
    if preds.ndim != 4 or preds.shape != target.shape or g_h.ndim != 1 or g_w.ndim != 1:
        raise ValueError(
            "ssim_windows fused kernel takes preds and target (B, C, H, W) of one shape and 1-D taps, got"
            f" {tuple(preds.shape)}, {tuple(target.shape)}, {tuple(g_h.shape)} and {tuple(g_w.shape)}"
        )
    b, c, h, w = preds.shape
    kh, kw = g_h.shape[0], g_w.shape[0]
    hp, wp = h + 2 * pad_h, w + 2 * pad_w
    if min(h, w) < 1 or pad_h < 0 or pad_w < 0 or not (1 <= kh <= hp and 1 <= kw <= wp):
        raise ValueError(
            f"ssim_windows fused kernel takes 1 <= taps <= padded extent, got {kh} x {kw} taps on {h} x {w}"
            f" padded by {pad_h}, {pad_w}"
        )
    ho, wo = hp - kh + 1, wp - kw + 1
    ch, cw = crop_offsets(pad_h, pad_w)
    dev = preds.device
    planes = b * c
    consts = None
    if isinstance(c1, torch.Tensor) or isinstance(c2, torch.Tensor):
        consts = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (c1, c2)]).contiguous()
        c1 = c2 = 0.0
    ssim_map = torch.empty((b, c, ho, wo), dtype=torch.float32, device=dev) if full_image else None
    n, parts, tmp_floats = _plan(dev.index, True, planes, h, w, pad_h, pad_w, kh, kw) if planes else (0, 0, 0)
    partials = torch.empty((planes, parts, 2), dtype=torch.float64, device=dev)
    if planes:
        with torch.cuda.device(dev):
            tmp = torch.empty(tmp_floats, dtype=torch.float32, device=dev) if tmp_floats else None
            preds, target = _aligned(preds), _aligned(target)
            err = _entries()[2](
                preds.data_ptr(), target.data_ptr(), g_h.data_ptr(), g_w.data_ptr(),
                None if consts is None else consts.data_ptr(), float(c1), float(c2),
                None if ssim_map is None else ssim_map.data_ptr(), partials.data_ptr(),
                None if tmp is None else tmp.data_ptr(), planes, h, w, pad_h, pad_w, kh, kw, ch, cw,
                native.current_stream(dev.index),
            )
            if err != 0:
                raise RuntimeError(f"ssim_windows fused kernel launch failed with CUDA error {err}")
            launches += n
    count = c * max(ho - 2 * ch, 0) * max(wo - 2 * cw, 0)
    means = (partials.view(b, c * parts, 2).sum(1) / count).to(torch.float32)
    return means[:, 0], means[:, 1], ssim_map


kernels.register_kernel(
    kernels.KernelSpec(
        name="ssim_fused",
        reference=ssim_chain,
        cuda=_ssim_fused_cuda,
    )
)
