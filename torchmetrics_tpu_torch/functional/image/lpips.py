"""Learned perceptual image patch similarity (LPIPS): the score over a
pluggable feature stack.

    score(x, y) = sum_k spatial_mean(w_k · (n_k(x) - n_k(y))²)

with ``n_k`` the k-th backbone activation normalised to unit length over
channels and ``w_k`` the k-th lin head's weights (a bias-free 1 x 1
convolution to one channel is a weighted channel sum). The backbones live
in ``models/lpips.py``; the convolutions are plain PyTorch.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.models.lpips import _SCALE, _SHIFT


def _normalize_tensor(feat: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Unit length over the channel axis."""
    return feat / torch.sqrt(eps + torch.sum(feat**2, dim=1, keepdim=True))


def _spatial_average(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, keeping the axes."""
    return x.mean(dim=(2, 3), keepdim=True)


def _scaling_layer(img: torch.Tensor) -> torch.Tensor:
    shift = torch.tensor(_SHIFT, dtype=img.dtype, device=img.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, dtype=img.dtype, device=img.device)[None, :, None, None]
    return (img - shift) / scale


def _valid_img(img: torch.Tensor, normalize: bool) -> bool:
    """``(N, 3, H, W)`` in [0, 1] when ``normalize``, else at least -1 (one host read)."""
    if img.ndim != 4 or img.shape[1] != 3:
        return False
    low, high = torch.stack([img.min(), img.max()]).tolist()
    if normalize:
        return high <= 1.0 and low >= 0.0
    return low >= -1.0


def _lpips_score(
    img1: torch.Tensor,
    img2: torch.Tensor,
    feature_stack: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    lin_weights: Optional[Sequence[torch.Tensor]] = None,
    normalize: bool = False,
) -> torch.Tensor:
    """Per-sample LPIPS scores ``(N,)`` of images in [-1, 1] (in [0, 1] with ``normalize``)."""
    if normalize:
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1
    outs0, outs1 = feature_stack(_scaling_layer(img1)), feature_stack(_scaling_layer(img2))
    if lin_weights is None:
        lin_weights = [None] * len(outs0)
    if len(lin_weights) != len(outs0):
        raise ValueError(f"Got {len(lin_weights)} lin weights for a {len(outs0)}-layer feature stack.")
    total = None
    for f0, f1, w in zip(outs0, outs1, lin_weights):
        diff = (_normalize_tensor(f0) - _normalize_tensor(f1)) ** 2
        if w is None:
            layer = diff.sum(dim=1, keepdim=True)
        else:
            layer = (diff * torch.as_tensor(w).to(diff).reshape(1, -1, 1, 1)).sum(dim=1, keepdim=True)
        layer = _spatial_average(layer)
        total = layer if total is None else total + layer
    return total.reshape(total.shape[0])


def _lpips_update(
    img1: torch.Tensor,
    img2: torch.Tensor,
    net: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    normalize: bool,
) -> Tuple[torch.Tensor, int]:
    """Check the inputs and score the batch; ``net`` always sees [-1, 1] inputs."""
    if not (_valid_img(img1, normalize) and _valid_img(img2, normalize)):
        raise ValueError(
            "Expected both input arguments to be normalized tensors with shape [N, 3, H, W]."
            f" Got input with shape {tuple(img1.shape)} and {tuple(img2.shape)} and values outside the"
            f" expected {[0, 1] if normalize else [-1, 1]} range."
        )
    if normalize:
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1
    loss = torch.as_tensor(net(img1, img2)).reshape(img1.shape[0])
    return loss, img1.shape[0]


def _lpips_compute(sum_scores: torch.Tensor, total, reduction: str = "mean") -> torch.Tensor:
    return sum_scores / total if reduction == "mean" else sum_scores


def learned_perceptual_image_patch_similarity(
    img1: torch.Tensor,
    img2: torch.Tensor,
    net: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    reduction: str = "mean",
    normalize: bool = False,
) -> torch.Tensor:
    """LPIPS between two image batches. ``net(img1, img2) -> (N,)`` scores
    inputs in [-1, 1]: build one with
    :func:`torchmetrics_tpu_torch.models.lpips.lpips_network`, or pass any
    callable.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import learned_perceptual_image_patch_similarity
        >>> img1 = (torch.arange(4 * 3 * 8 * 8).reshape(4, 3, 8, 8) % 255) / 255.0
        >>> net = lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3))
        >>> round(float(learned_perceptual_image_patch_similarity(img1, img1 * 0.7, net=net)), 4)
        0.0297
    """
    if net is None:
        raise ModuleNotFoundError(
            "learned_perceptual_image_patch_similarity requires a `net` callable (img1, img2) -> (N,) scores;"
            " pretrained backbones are not bundled. Build one with torchmetrics_tpu_torch.models.lpips.lpips_network."
        )
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Argument `reduction` must be one of ['mean', 'sum'], got {reduction}")
    loss, total = _lpips_update(torch.as_tensor(img1), torch.as_tensor(img2), net, normalize)
    return _lpips_compute(loss.sum(), total, reduction)
