"""Fréchet Inception Distance.

States are streaming second-moment sums (feature sum, outer-product sum,
sample count, all ``dist_reduce_fx="sum"``), so the metric merges in O(F²).
Compute forms means and covariances from the sums and takes the Fréchet
distance through a symmetric trace identity whose PSD square root runs on
the ``fid_sqrtm`` kernel (ops/sqrtm_kernel.py) on the card. The JAX package
computes all of it in float32; the port forms the moments and takes the
trace term in float64 around the float32 square root (see
:func:`_fid_from_root`).

The feature network is pluggable: ``feature`` is an InceptionV3 tap (with
``inception_params``) or any callable ``imgs -> (N, F)``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.models.inception import NUM_LOGITS, resolve_feature_argument
from torchmetrics_tpu_torch.ops.sqrtm_kernel import sqrtm_psd
from torchmetrics_tpu_torch.utils.compute import full_float32


def _fid_from_root(
    mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor, sigma2: torch.Tensor, s1h: torch.Tensor
) -> torch.Tensor:
    """Fréchet distance ``|mu1 - mu2|² + Tr S1 + Tr S2 - 2 Tr sqrt(S1 S2)``
    given ``s1h = S1^1/2``, in float64.

    ``Tr sqrt(S1 S2) = Tr sqrt(S1^1/2 S2 S1^1/2)``: the symmetrised inner
    matrix goes through ``eigvalsh`` with negative eigenvalues clipped, which
    keeps a rank-deficient covariance finite. Float64, not float32: a
    float32 ``eigvalsh`` knows each eigenvalue only to about 1e-7 of the
    largest, and the square roots of the hundreds of small eigenvalues of a
    2048-wide covariance in a general basis turn that into errors of up to
    2% of FID (``chip_smoke.py``'s ``fid_sqrtm`` phase reports them).
    """
    mu1, sigma1, mu2, sigma2, s1h = (t.to(torch.float64) for t in (mu1, sigma1, mu2, sigma2, s1h))
    diff = mu1 - mu2
    inner = s1h @ sigma2 @ s1h
    inner = 0.5 * (inner + inner.T)  # re-symmetrise float rounding
    tr_covmean = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(inner), min=0.0)).sum()
    return (diff @ diff) + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean


def _compute_fid(mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """Fréchet distance between two gaussians, float32: the PSD square root
    of ``sigma1`` through the ``fid_sqrtm`` seam (float32), the rest by
    :func:`_fid_from_root`."""
    return _fid_from_root(mu1, sigma1, mu2, sigma2, sqrtm_psd(sigma1)).to(torch.float32)


class FrechetInceptionDistance(Metric):
    """FID with a pluggable feature extractor.

    Args:
        feature: an InceptionV3 tap (64/192/768/2048, needs
            ``inception_params``) or a callable mapping an image batch to
            (N, F) features.
        num_features: feature width F (defines the state shapes); inferred
            from ``feature`` when that is a tap.
        reset_real_features: if False, real-image statistics survive ``reset``.
        normalize: if True, expects float images in [0, 1].
        inception_params: weights of the built-in InceptionV3: a state dict in
            torch-fidelity's names, or the JAX package's parameter tree.
        feature_extractor: explicit spelling of the callable form of ``feature``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance
        >>> real = (torch.arange(4 * 3 * 8 * 8).reshape(4, 3, 8, 8) % 255) / 255.0
        >>> fake = real * 0.7
        >>> fid = FrechetInceptionDistance(
        ...     feature_extractor=lambda x: x.mean(dim=(2, 3)), num_features=3, device="cpu")
        >>> fid.update(real, real=True)
        >>> fid.update(fake, real=False)
        >>> round(float(fid.compute()), 4)
        0.0928
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Any = None,
        num_features: Optional[int] = None,
        reset_real_features: bool = True,
        normalize: bool = False,
        inception_params: Optional[dict] = None,
        feature_extractor: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if feature is None and feature_extractor is None and num_features is not None:
            feature = num_features  # explicit num_features selects the matching tap
        self.feature_extractor, dim = resolve_feature_argument(
            "FrechetInceptionDistance", feature, feature_extractor, inception_params, device=self.device
        )
        resolved = NUM_LOGITS if isinstance(dim, str) else dim
        if num_features is None:
            num_features = resolved if resolved is not None else 2048
        elif resolved is not None and num_features != resolved:
            raise ValueError(
                f"Argument `num_features`={num_features} contradicts the {resolved}-wide tap"
                f" selected by `feature`={feature!r}"
            )
        if not isinstance(num_features, int) or num_features < 1:
            raise ValueError("Argument `num_features` expected to be a positive integer")
        self.num_features = num_features
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        n = num_features
        for side in ("real", "fake"):
            self.add_state(f"{side}_features_sum", torch.zeros(n, dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_cov_sum", torch.zeros((n, n), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_num_samples", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, imgs: torch.Tensor, real: bool) -> None:
        """Accumulate the feature moments of real or generated images."""
        if self.normalize:  # [0, 1] floats -> uint8, as the network is fed
            imgs = (imgs * 255).to(torch.uint8)
        features = torch.as_tensor(self.feature_extractor(imgs)).to(torch.float32)
        if features.ndim == 1:
            features = features[None]
        side = "real" if real else "fake"
        with full_float32():
            cov = features.T @ features
        setattr(self, f"{side}_features_sum", getattr(self, f"{side}_features_sum") + features.sum(0))
        setattr(self, f"{side}_features_cov_sum", getattr(self, f"{side}_features_cov_sum") + cov)
        setattr(self, f"{side}_features_num_samples", getattr(self, f"{side}_features_num_samples") + features.shape[0])

    def compute(self) -> torch.Tensor:
        """FID from the accumulated moments. Means and covariances are formed
        in float64: ``Σ x xᵀ − n μ μᵀ`` cancels most of its float32 sum where
        the features' mean is large against their spread."""
        moments = []
        for side in ("real", "fake"):
            n = getattr(self, f"{side}_features_num_samples").to(torch.float64)
            mean = getattr(self, f"{side}_features_sum").to(torch.float64) / n
            cov_sum = getattr(self, f"{side}_features_cov_sum").to(torch.float64)
            moments += [mean, (cov_sum - n * torch.outer(mean, mean)) / (n - 1)]
        return _compute_fid(*moments)

    def reset(self) -> None:
        if not self.reset_real_features:
            kept = {k: self._state[k] for k in ("real_features_sum", "real_features_cov_sum", "real_features_num_samples")}
            super().reset()
            self._state.update(kept)
        else:
            super().reset()
