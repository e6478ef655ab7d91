"""Modular SSIM and MS-SSIM.

Both stream: a running sum of per-image values and an image count, or with
``reduction="none"``/``None`` a list of per-image values.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.ssim import (
    _ssim_check_inputs,
    _ssim_update,
    multiscale_structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

_VALID_REDUCTIONS = ("elementwise_mean", "sum", "none", None)


def _add_similarity_states(metric: Metric, reduction: Optional[str]) -> None:
    if reduction not in _VALID_REDUCTIONS:
        raise ValueError(f"Argument `reduction` must be one of {_VALID_REDUCTIONS}, but got {reduction}")
    if reduction in ("elementwise_mean", "sum"):
        metric.add_state("similarity", torch.tensor(0.0), dist_reduce_fx="sum")
    else:
        metric.add_state("similarity", [], dist_reduce_fx="cat")
    metric.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")


def _accumulate(metric: Metric, similarity: torch.Tensor, images: int) -> None:
    if metric.reduction in ("elementwise_mean", "sum"):
        metric.similarity = metric.similarity + similarity.sum()
    else:
        metric.similarity.append(similarity)
    metric.total = metric.total + images


def _reduced(metric: Metric) -> torch.Tensor:
    if metric.reduction == "elementwise_mean":
        return metric.similarity / metric.total
    if metric.reduction == "sum":
        return metric.similarity
    return dim_zero_cat(metric.similarity)


class StructuralSimilarityIndexMeasure(Metric):
    """Structural similarity index measure (SSIM).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> target = preds * 0.75
        >>> m = StructuralSimilarityIndexMeasure(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.922
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Union[float, Tuple[float, float], None] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _add_similarity_states(self, reduction)
        if return_contrast_sensitivity or return_full_image:
            self.add_state("image_return", [], dist_reduce_fx="cat")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        out = _ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range, self.k1, self.k2,
            self.return_full_image, self.return_contrast_sensitivity,
        )
        if isinstance(out, tuple):
            similarity, image = out
            self.image_return.append(image)
        else:
            similarity = out
        _accumulate(self, similarity, preds.shape[0])

    def compute(self):
        similarity = _reduced(self)
        if self.return_contrast_sensitivity or self.return_full_image:
            return similarity, dim_zero_cat(self.image_return)
        return similarity


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """Multi-scale SSIM (MS-SSIM).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> target = preds * 0.75
        >>> m = MultiScaleStructuralSimilarityIndexMeasure(betas=(0.5, 0.5), device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.941
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Union[float, Tuple[float, float], None] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _add_similarity_states(self, reduction)
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        similarity = multiscale_structural_similarity_index_measure(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, None, self.data_range,
            self.k1, self.k2, self.betas, self.normalize,
        )
        _accumulate(self, similarity, preds.shape[0])

    def compute(self):
        return _reduced(self)
