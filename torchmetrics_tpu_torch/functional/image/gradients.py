"""Finite-difference image gradients: ``dy[i, j] = I[i + 1, j] - I[i, j]``
with a zero last row, ``dx`` likewise with a zero last column."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _image_gradients_validate(img: torch.Tensor) -> None:
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"The `img` expects a value of <Tensor> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dy = F.pad(img[..., 1:, :] - img[..., :-1, :], (0, 0, 0, 1))
    dx = F.pad(img[..., :, 1:] - img[..., :, :-1], (0, 1, 0, 0))
    return dy, dx


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dy, dx)`` of an ``(N, C, H, W)`` image batch.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import image_gradients
        >>> img = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
        >>> dy, dx = image_gradients(img)
        >>> dy[0, 0, :, 0].tolist(), dx[0, 0, 0].tolist()
        ([4.0, 4.0, 4.0, 0.0], [1.0, 1.0, 1.0, 0.0])
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
