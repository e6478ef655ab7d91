"""Modular pure-tensor image metrics: PSNR, PSNR-B, SSIM, MS-SSIM, TV, UQI,
SAM, ERGAS, RMSE-SW, RASE, SCC, VIF, D_lambda, D_s and QNR.

The states are the JAX package's, name for name: running sums and counts
where the metric streams (PSNR, PSNR-B, SSIM, MS-SSIM, TV, RMSE-SW, SCC,
VIF), lists of every image where its compute needs them all (UQI, SAM,
ERGAS, RASE, D_lambda, D_s, QNR), and a list of per-image values under
``reduction="none"``/``None`` or PSNR's ``dim``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.misc import (
    _float32,
    _rmse_sw_single,
    _total_variation_update,
    error_relative_global_dimensionless_synthesis,
    relative_average_spectral_error,
    spatial_correlation_coefficient,
    spectral_angle_mapper,
    universal_image_quality_index,
)
from torchmetrics_tpu_torch.functional.image.pansharpening import (
    quality_with_no_reference,
    spatial_distortion_index,
    spectral_distortion_index,
)
from torchmetrics_tpu_torch.functional.image.psnr import _compute_bef, _psnr_compute, _psnr_update, _psnrb_compute
from torchmetrics_tpu_torch.functional.image.ssim import (
    _ssim_check_inputs,
    _ssim_update,
    multiscale_structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.functional.image.vif import _check_vif_size, _vif_per_channel
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.checks import _check_same_device
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

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


class PeakSignalNoiseRatio(Metric):
    """Peak signal-to-noise ratio. With ``dim``, list states of per-slice
    sums; without ``data_range``, the target's running min and max.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatio
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = PeakSignalNoiseRatio(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        14.322
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        data_range: Union[float, Tuple[float, float], None] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        if dim is None:
            self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        self._clamping = None
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", torch.tensor(float("-inf")), dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            self.data_range = torch.tensor(data_range[1] - data_range[0], dtype=torch.float32, device=self.device)
            self._clamping = data_range
        else:
            self.data_range = torch.tensor(float(data_range), device=self.device)
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _float32(preds, target)
        if self._clamping is not None:
            preds = torch.clamp(preds, *self._clamping)
            target = torch.clamp(target, *self._clamping)
        sum_squared_error, num_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + num_obs
        else:
            self.sum_squared_error.append(sum_squared_error.reshape(-1))
            self.total.append(num_obs.reshape(-1))

    def compute(self) -> torch.Tensor:
        data_range = self.data_range if self.data_range is not None else (self.max_target - self.min_target)
        if self.dim is None:
            sum_squared_error, total = self.sum_squared_error, self.total
        else:
            sum_squared_error, total = dim_zero_cat(self.sum_squared_error), dim_zero_cat(self.total)
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR with a blocking-effect penalty, of grayscale images; the data
    range is the largest target range seen (reduced by ``max``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatioWithBlockedEffect
        >>> preds = (torch.arange(1 * 1 * 32 * 32).reshape(1, 1, 32, 32) % 255) / 255.0
        >>> m = PeakSignalNoiseRatioWithBlockedEffect(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        7.5802
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("bef", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("data_range", torch.tensor(0.0), dist_reduce_fx="max")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _float32(preds, target)
        self.sum_squared_error = self.sum_squared_error + ((preds - target) ** 2).sum()
        self.total = self.total + target.numel()
        self.bef = self.bef + _compute_bef(preds, block_size=self.block_size)
        self.data_range = torch.maximum(self.data_range, target.max() - target.min())

    def compute(self) -> torch.Tensor:
        return _psnrb_compute(self.sum_squared_error / self.total, self.bef, self.data_range)


class TotalVariation(Metric):
    """Total variation of images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import TotalVariation
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = TotalVariation(device="cpu")
        >>> m.update(preds)
        >>> round(float(m.compute()), 2)
        1288.42
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("score", [], dist_reduce_fx="cat")
        else:
            self.add_state("score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_elements", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, img: torch.Tensor) -> None:
        score, num_elements = _total_variation_update(*_float32(img))
        if self.reduction in ("none", None):
            self.score.append(score)
        else:
            self.score = self.score + score.sum()
        self.num_elements = self.num_elements + num_elements

    def compute(self) -> torch.Tensor:
        if self.reduction == "mean":
            return self.score / self.num_elements
        if self.reduction == "sum":
            return self.score
        return dim_zero_cat(self.score)


class _PairListMetric(Metric):
    """Base of the image metrics that keep every (preds, target) pair."""

    is_differentiable = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _float32(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def _cat(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return dim_zero_cat(self.preds), dim_zero_cat(self.target)


class UniversalImageQualityIndex(_PairListMetric):
    """Universal image quality index over every image seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import UniversalImageQualityIndex
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = UniversalImageQualityIndex(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        0.9216
    """

    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction

    def compute(self) -> torch.Tensor:
        preds, target = self._cat()
        return universal_image_quality_index(preds, target, self.kernel_size, self.sigma, self.reduction)


class SpectralAngleMapper(_PairListMetric):
    """Spectral angle mapper over every image seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralAngleMapper
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = SpectralAngleMapper(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        0.0001
    """

    higher_is_better = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 3.142

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction

    def compute(self) -> torch.Tensor:
        preds, target = self._cat()
        return spectral_angle_mapper(preds, target, self.reduction)


class ErrorRelativeGlobalDimensionlessSynthesis(_PairListMetric):
    """ERGAS over every image seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import ErrorRelativeGlobalDimensionlessSynthesis
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        9.6476
    """

    higher_is_better = False
    plot_lower_bound: float = 0.0

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction

    def compute(self) -> torch.Tensor:
        preds, target = self._cat()
        return error_relative_global_dimensionless_synthesis(preds, target, self.ratio, self.reduction)


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """Sliding-window RMSE, streaming: the summed per-batch value and the
    image count.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RootMeanSquaredErrorUsingSlidingWindow
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = RootMeanSquaredErrorUsingSlidingWindow(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        0.1445
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_images", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _float32(preds, target)
        rmse_val, _ = _rmse_sw_single(preds, target, self.window_size)
        self.rmse_val_sum = self.rmse_val_sum + rmse_val
        self.total_images = self.total_images + preds.shape[0]

    def compute(self) -> torch.Tensor:
        return self.rmse_val_sum / self.total_images


class RelativeAverageSpectralError(_PairListMetric):
    """Relative average spectral error over every image seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RelativeAverageSpectralError
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = RelativeAverageSpectralError(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 2)
        2460.4
    """

    higher_is_better = False
    plot_lower_bound: float = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size

    def compute(self) -> torch.Tensor:
        preds, target = self._cat()
        return relative_average_spectral_error(preds, target, self.window_size)


class SpatialCorrelationCoefficient(Metric):
    """Spatial correlation coefficient, streaming: the summed per-image
    values and the image count.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpatialCorrelationCoefficient
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = SpatialCorrelationCoefficient(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(self, hp_filter: Optional[torch.Tensor] = None, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.hp_filter = hp_filter
        self.window_size = window_size
        self.add_state("scc_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        score = spatial_correlation_coefficient(preds, target, self.hp_filter, self.window_size, reduction="none")
        self.scc_score = self.scc_score + score.sum()
        self.total = self.total + score.shape[0]

    def compute(self) -> torch.Tensor:
        return self.scc_score / self.total


class VisualInformationFidelity(Metric):
    """Pixel-domain visual information fidelity, streaming: the summed
    per-image values (the mean over channels) and the image count.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import VisualInformationFidelity
        >>> preds = (torch.arange(2 * 3 * 48 * 48).reshape(2, 3, 48, 48) % 255) / 255.0
        >>> m = VisualInformationFidelity(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        1.7622
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.sigma_n_sq = sigma_n_sq
        self.add_state("vif_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _float32(preds, target)
        _check_vif_size(preds, target)
        channels = preds.shape[1]
        per_channel = [_vif_per_channel(preds[:, i], target[:, i], self.sigma_n_sq) for i in range(channels)]
        vif = torch.stack(per_channel).mean(0) if channels > 1 else per_channel[0]
        self.vif_score = self.vif_score + vif.sum()
        self.total = self.total + preds.shape[0]

    def compute(self) -> torch.Tensor:
        return self.vif_score / self.total


class SpectralDistortionIndex(_PairListMetric):
    """Spectral distortion index (D_lambda) over every image seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralDistortionIndex
        >>> preds = (torch.arange(2 * 3 * 32 * 32).reshape(2, 3, 32, 32) % 255) / 255.0
        >>> m = SpectralDistortionIndex(device="cpu")
        >>> m.update(preds, preds * 0.75)
        >>> round(float(m.compute()), 4)
        0.0
    """

    is_differentiable = True
    higher_is_better = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, p: int = 1, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        allowed_reductions = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reductions:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reductions} but got {reduction}")
        self.reduction = reduction

    def compute(self) -> torch.Tensor:
        preds, target = self._cat()
        return spectral_distortion_index(preds, target, self.p, self.reduction)


class _PanTargetMetric(Metric):
    """Base of D_s and QNR: the fused images and a dict target of the
    multispectral image ``"ms"``, the pan image ``"pan"`` and optionally its
    low-resolution form ``"pan_lr"``, each kept in a list."""

    is_differentiable = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, norm_order: int = 1, window_size: int = 7, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.norm_order = norm_order
        self.window_size = window_size
        self.reduction = reduction
        for name in ("preds", "ms", "pan", "pan_lr"):
            self.add_state(name, [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: Dict[str, torch.Tensor]) -> None:
        if "ms" not in target or "pan" not in target:
            raise ValueError(f"Expected `target` to be a dict with keys 'ms' and 'pan'. Got {list(target)}.")
        _check_same_device(self.device, list(target.values()), {}, type(self).__name__)
        self.preds.extend(_float32(preds))
        for name in ("ms", "pan", "pan_lr"):
            if name in target:
                getattr(self, name).extend(_float32(target[name]))

    def _inputs(self) -> Tuple[torch.Tensor, ...]:
        pan_lr = dim_zero_cat(self.pan_lr) if self.pan_lr else None
        return dim_zero_cat(self.preds), dim_zero_cat(self.ms), dim_zero_cat(self.pan), pan_lr


class SpatialDistortionIndex(_PanTargetMetric):
    """Spatial distortion index (D_s) over every image seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpatialDistortionIndex
        >>> preds = (torch.arange(1 * 3 * 32 * 32).reshape(1, 3, 32, 32) % 255) / 255.0
        >>> m = SpatialDistortionIndex(device="cpu")
        >>> m.update(preds, {"ms": preds[:, :, ::4, ::4] * 0.9, "pan": preds * 0.95})
        >>> float(m.compute())
        nan
    """

    higher_is_better = False

    def compute(self) -> torch.Tensor:
        return spatial_distortion_index(*self._inputs(), self.norm_order, self.window_size, self.reduction)


class QualityWithNoReference(_PanTargetMetric):
    """Quality with no reference (QNR) over every image seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import QualityWithNoReference
        >>> preds = (torch.arange(1 * 3 * 32 * 32).reshape(1, 3, 32, 32) % 255) / 255.0
        >>> m = QualityWithNoReference(device="cpu")
        >>> m.update(preds, {"ms": preds[:, :, ::4, ::4] * 0.9, "pan": preds * 0.95})
        >>> float(m.compute())
        nan
    """

    higher_is_better = True

    def __init__(
        self,
        alpha: float = 1,
        beta: float = 1,
        norm_order: int = 1,
        window_size: int = 7,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(norm_order, window_size, reduction, **kwargs)
        self.alpha = alpha
        self.beta = beta

    def compute(self) -> torch.Tensor:
        return quality_with_no_reference(
            *self._inputs(), self.alpha, self.beta, self.norm_order, self.window_size, self.reduction
        )
