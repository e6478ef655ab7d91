"""Kernel Inception Distance: the unbiased polynomial-kernel MMD between real
and generated features, over random subsets drawn on the host."""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.models.inception import resolve_feature_argument
from torchmetrics_tpu_torch.utils.compute import full_float32
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


def poly_kernel(
    f1: torch.Tensor, f2: torch.Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> torch.Tensor:
    """Polynomial kernel ``(gamma f1 f2ᵀ + coef) ** degree``, ``gamma = 1 / F``
    by default; the product in full float32."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    with full_float32():
        return (f1 @ f2.T * gamma + coef) ** degree


def maximum_mean_discrepancy(k_xx: torch.Tensor, k_xy: torch.Tensor, k_yy: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD estimate from the three kernel matrices."""
    m = k_xx.shape[0]
    kt_xx_sums = k_xx.sum(dim=-1) - torch.diagonal(k_xx)
    kt_yy_sums = k_yy.sum(dim=-1) - torch.diagonal(k_yy)
    k_xy_sums = k_xy.sum(dim=0)
    value = (kt_xx_sums.sum() + kt_yy_sums.sum()) / (m * (m - 1))
    return value - 2 * k_xy_sums.sum() / (m**2)


class KernelInceptionDistance(Metric):
    """KID (polynomial-kernel MMD) over a pluggable feature extractor.

    ``compute`` returns the mean and standard deviation (ddof 1) of the MMD
    over ``subsets`` random subsets of ``subset_size`` real and generated
    samples, drawn by ``np.random.RandomState(42)`` as in the JAX package.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import KernelInceptionDistance
        >>> real = (torch.arange(4 * 3 * 8 * 8).reshape(4, 3, 8, 8) % 255) / 255.0
        >>> fake = real * 0.7
        >>> kid = KernelInceptionDistance(
        ...     feature_extractor=lambda x: x.mean(dim=(2, 3)), subsets=2, subset_size=3, device="cpu")
        >>> kid.update(real, real=True)
        >>> kid.update(fake, real=False)
        >>> mean, std = kid.compute()
        >>> round(float(mean), 4), round(float(std), 4)
        (-0.072, 0.0)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Any = None,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        inception_params: Optional[dict] = None,
        feature_extractor: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.feature_extractor, _ = resolve_feature_argument(
            "KernelInceptionDistance", feature, feature_extractor, inception_params, device=self.device
        )
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        self.normalize = normalize

        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def update(self, imgs: torch.Tensor, real: bool) -> None:
        if self.normalize:  # [0, 1] floats -> uint8, as the network is fed
            imgs = (imgs * 255).to(torch.uint8)
        features = torch.as_tensor(self.feature_extractor(imgs)).to(torch.float32)
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, std) of the MMD over random subsets."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        rng = np.random.RandomState(42)
        device = real_features.device
        kid_scores_ = []
        for _ in range(self.subsets):
            perm = rng.permutation(n_samples_real)
            f_real = real_features[torch.as_tensor(perm[: self.subset_size], device=device)]
            perm = rng.permutation(n_samples_fake)
            f_fake = fake_features[torch.as_tensor(perm[: self.subset_size], device=device)]

            k_11 = poly_kernel(f_real, f_real, self.degree, self.gamma, self.coef)
            k_22 = poly_kernel(f_fake, f_fake, self.degree, self.gamma, self.coef)
            k_12 = poly_kernel(f_real, f_fake, self.degree, self.gamma, self.coef)
            kid_scores_.append(maximum_mean_discrepancy(k_11, k_12, k_22))
        kid_scores = torch.stack(kid_scores_)
        return kid_scores.mean(), kid_scores.std(correction=1)

    def reset(self) -> None:
        if not self.reset_real_features:
            real_features = self._state["real_features"]
            super().reset()
            self._state["real_features"] = real_features
        else:
            super().reset()
