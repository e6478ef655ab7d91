"""Memorization-Informed FID.

MiFID = FID / memorization penalty, where the penalty is the mean minimum
cosine distance between real and generated features, thresholded at
``cosine_distance_eps``. The penalty needs the raw feature sets, so the
states are feature lists (``dist_reduce_fx="cat"``), like KID's.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from torchmetrics_tpu_torch.image.fid import _compute_fid
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.models.inception import resolve_feature_argument
from torchmetrics_tpu_torch.utils.compute import full_float32
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


def _compute_cosine_distance(
    features1: torch.Tensor, features2: torch.Tensor, cosine_distance_eps: float = 0.1
) -> torch.Tensor:
    """Mean minimum cosine distance between two feature sets; 1 where it is
    not below ``cosine_distance_eps``."""
    features1_nozero = features1[torch.sum(features1, dim=1) != 0]
    features2_nozero = features2[torch.sum(features2, dim=1) != 0]

    norm_f1 = features1_nozero / torch.linalg.norm(features1_nozero, dim=1, keepdim=True)
    norm_f2 = features2_nozero / torch.linalg.norm(features2_nozero, dim=1, keepdim=True)

    with full_float32():
        d = 1.0 - torch.abs(norm_f1 @ norm_f2.T)
    mean_min_d = torch.mean(d.min(dim=1).values)
    return torch.where(mean_min_d < cosine_distance_eps, mean_min_d, torch.ones_like(mean_min_d))


def _mifid_compute(
    mu1: torch.Tensor,
    sigma1: torch.Tensor,
    features1: torch.Tensor,
    mu2: torch.Tensor,
    sigma2: torch.Tensor,
    features2: torch.Tensor,
    cosine_distance_eps: float = 0.1,
) -> torch.Tensor:
    """MiFID from the two gaussians and the raw features."""
    fid_value = _compute_fid(mu1, sigma1, mu2, sigma2)
    distance = _compute_cosine_distance(features1, features2, cosine_distance_eps)
    return torch.where(fid_value > 1e-8, fid_value / (distance + 10e-15), torch.zeros_like(fid_value))


def _cov(features: torch.Tensor) -> torch.Tensor:
    """Sample covariance (ddof 1) of (N, F) features, in full float32."""
    centred = features - features.mean(dim=0)
    with full_float32():
        return centred.T @ centred / (features.shape[0] - 1)


class MemorizationInformedFrechetInceptionDistance(Metric):
    """MiFID with a pluggable feature extractor.

    Args:
        feature: an InceptionV3 tap (needs ``inception_params``) or a callable
            mapping an image batch to (N, F) features.
        reset_real_features: if False, real features survive ``reset``.
        normalize: if True, expects float images in [0, 1].
        cosine_distance_eps: the penalty's threshold.
        inception_params: weights of the built-in InceptionV3.
        feature_extractor: explicit spelling of the callable form of ``feature``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MemorizationInformedFrechetInceptionDistance
        >>> real = (torch.arange(4 * 3 * 8 * 8).reshape(4, 3, 8, 8) % 255) / 255.0
        >>> fake = 1.0 - real
        >>> mifid = MemorizationInformedFrechetInceptionDistance(
        ...     feature_extractor=lambda x: x.mean(dim=(2, 3)), device="cpu")
        >>> mifid.update(real, real=True)
        >>> mifid.update(fake, real=False)
        >>> round(float(mifid.compute()), 4)
        0.0033
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Any = None,
        reset_real_features: bool = True,
        normalize: bool = False,
        cosine_distance_eps: float = 0.1,
        inception_params: Optional[dict] = None,
        feature_extractor: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.feature_extractor, _ = resolve_feature_argument(
            "MemorizationInformedFrechetInceptionDistance", feature, feature_extractor, inception_params,
            device=self.device,
        )
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not (isinstance(cosine_distance_eps, float) and 1 > cosine_distance_eps > 0):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.cosine_distance_eps = cosine_distance_eps
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def update(self, imgs: torch.Tensor, real: bool) -> None:
        """Extract and store features."""
        if self.normalize:
            imgs = (imgs * 255).to(torch.uint8)
        features = torch.as_tensor(self.feature_extractor(imgs)).to(torch.float32)
        if features.ndim == 1:
            features = features[None]
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> torch.Tensor:
        """MiFID over the accumulated features."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        return _mifid_compute(
            real_features.mean(dim=0),
            _cov(real_features),
            real_features,
            fake_features.mean(dim=0),
            _cov(fake_features),
            fake_features,
            cosine_distance_eps=self.cosine_distance_eps,
        ).to(torch.float32)

    def reset(self) -> None:
        if not self.reset_real_features:
            value = self.real_features
            super().reset()
            self.real_features = value
        else:
            super().reset()
