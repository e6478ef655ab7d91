"""SSIM and MS-SSIM.

Gaussian (or uniform) windowed statistics over a five-plane stack (preds,
target, preds², target², preds·target). In 2-D, on the ``ssim_windows``
kernel's two entries (ops/ssim_kernel.py), chosen only by whether a gradient
is needed:

- no gradient (``torch.is_grad_enabled()`` is false, or neither input
  requires grad): the fused entry, one launch that reflects, forms the
  products, windows them and evaluates SSIM and cs per pixel, returning
  per-image sums (``"ssim_fused"`` in the dispatch seam);
- a gradient: the chain of reflect padding, the five-plane stack and the
  generic windowed sum (``"ssim_windows"``, whose backward is the kernel
  too), then the formula in PyTorch.

On CPU tensors both run the same plain chain. In 3-D it is plain PyTorch,
as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.utils import _avg_pool2d, _gaussian, _reflect_pad_3d, _separable_window_3d
from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.ops.ssim_kernel import ssim_chain, ssim_from_moments, windowed_sum_2d
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


def _ssim_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape. Got preds: {tuple(preds.shape)}."
        )
    return preds, target


@functools.lru_cache(maxsize=64)
def _window(size: int, sigma: Optional[float], dtype: torch.dtype, device: torch.device, inference: bool) -> torch.Tensor:
    """One axis's window, gaussian of ``sigma`` or uniform (``sigma=None``),
    made once per device: SSIM builds the same few taps every update, and
    each would cost a handful of launches. Cached apart under inference mode,
    whose tensors autograd cannot save."""
    if sigma is None:
        return torch.full((size,), 1.0 / size, dtype=dtype, device=device)
    return _gaussian(size, sigma, dtype, device)


def _ssim_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Union[float, Tuple[float, float], None] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Per-image SSIM of NCHW or NCDHW inputs, and the contrast sensitivity
    or the full SSIM map when asked."""
    is_3d = preds.ndim == 5
    ndims = 3 if is_3d else 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = ndims * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = ndims * [sigma]
    if len(kernel_size) != ndims or len(sigma) != ndims:
        raise ValueError(
            f"`kernel_size` has dimension {ndims} for {'3d' if is_3d else '2d'} images"
            f" but got kernel_size: {kernel_size} and sigma: {sigma}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(preds.max(), target.max()) - torch.minimum(preds.min(), target.min())
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    # Both windows are separable: 1-D passes per axis. As in the JAX package,
    # the GAUSSIAN window's size comes from sigma (int(3.5 * s + 0.5) * 2 + 1
    # per axis) and `kernel_size` sizes only the UNIFORM window; padding and
    # cropping always use the sigma-derived size.
    gauss_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    inference = torch.is_inference_mode_enabled()
    if gaussian_kernel:
        k1d = [_window(k, float(s), preds.dtype, preds.device, inference) for k, s in zip(gauss_size, sigma)]
    else:
        k1d = [_window(k, None, preds.dtype, preds.device, inference) for k in kernel_size]
    if not is_3d:
        pad_h = (gauss_size[0] - 1) // 2
        pad_w = (gauss_size[1] - 1) // 2
        args = (preds.contiguous(), target.contiguous(), k1d[0], k1d[1], pad_h, pad_w, c1, c2, return_full_image)
        if torch.is_grad_enabled() and (preds.requires_grad or target.requires_grad):
            per_image, cs, full = ssim_chain(*args, window=windowed_sum_2d)
        else:
            per_image, cs, full = kernels.dispatch("ssim_fused", *args)
        if return_contrast_sensitivity:
            return per_image, cs
        if return_full_image:
            return per_image, full
        return per_image

    pad_d = (gauss_size[0] - 1) // 2
    pad_h = (gauss_size[1] - 1) // 2
    pad_w = (gauss_size[2] - 1) // 2
    preds_p = _reflect_pad_3d(preds, pad_d, pad_h, pad_w)
    target_p = _reflect_pad_3d(target, pad_d, pad_h, pad_w)
    input_list = torch.cat([preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p])
    outputs = _separable_window_3d(input_list, k1d[0], k1d[1], k1d[2])
    ssim_idx_full_image, cs_full = ssim_from_moments(outputs, preds.shape[0], c1, c2)

    # crop to the unpadded region
    def _crop(x: torch.Tensor) -> torch.Tensor:
        return x[..., pad_d:-pad_d, pad_h:-pad_h, pad_w:-pad_w] if pad_d and pad_h and pad_w else x

    ssim_idx = _crop(ssim_idx_full_image)
    per_image = ssim_idx.reshape(ssim_idx.shape[0], -1).mean(-1)
    if return_contrast_sensitivity:
        cs = _crop(cs_full)
        return per_image, cs.reshape(cs.shape[0], -1).mean(-1)
    if return_full_image:
        return per_image, ssim_idx_full_image
    return per_image


def _reduce(values: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    if reduction == "elementwise_mean":
        return values.mean()
    if reduction == "sum":
        return values.sum()
    return values


def structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Union[float, Tuple[float, float], None] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Structural similarity index measure (SSIM).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import structural_similarity_index_measure
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> target = preds * 0.75
        >>> round(float(structural_similarity_index_measure(preds, target)), 4)
        0.922
    """
    preds, target = _ssim_check_inputs(preds, target)
    out = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )
    similarity, extra = out if isinstance(out, tuple) else (out, None)
    similarity = _reduce(similarity, reduction)
    if extra is not None:
        return similarity, extra
    return similarity


_MS_SSIM_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def multiscale_structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Union[float, Tuple[float, float], None] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = _MS_SSIM_BETAS,
    normalize: Optional[str] = "relu",
) -> torch.Tensor:
    """Multi-scale SSIM over ``len(betas)`` scales, halving the image between scales.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiscale_structural_similarity_index_measure
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> target = preds * 0.75
        >>> round(float(multiscale_structural_similarity_index_measure(preds, target, betas=(0.5, 0.5))), 4)
        0.941
    """
    preds, target = _ssim_check_inputs(preds, target)
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize not in ("relu", "simple", None):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")

    _ks = kernel_size if isinstance(kernel_size, Sequence) else [kernel_size, kernel_size]
    min_size = (_ks[0] - 1) * 2 ** (len(betas) - 1) + 1
    if preds.shape[-1] < min_size or preds.shape[-2] < min_size:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width should be larger than"
            f" {min_size} but got height: {preds.shape[-2]} and width: {preds.shape[-1]}"
        )

    sim_list: List[torch.Tensor] = []
    cs_list: List[torch.Tensor] = []
    p, t = preds, target
    for _ in range(len(betas)):
        sim, cs = _ssim_update(
            p, t, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, return_contrast_sensitivity=True
        )
        sim_list.append(sim)
        cs_list.append(cs)
        p = _avg_pool2d(p, 2)
        t = _avg_pool2d(t, 2)

    mcs_and_ssim = torch.stack(cs_list[:-1] + [sim_list[-1]], dim=0)  # (S, B)
    if normalize == "relu":
        mcs_and_ssim = torch.clamp(mcs_and_ssim, min=0.0)
    elif normalize == "simple":
        mcs_and_ssim = (mcs_and_ssim + 1) / 2
    betas_t = torch.tensor(betas, dtype=mcs_and_ssim.dtype, device=mcs_and_ssim.device)[:, None]
    ms_ssim = torch.prod(mcs_and_ssim**betas_t, dim=0)
    return _reduce(ms_ssim, reduction)
