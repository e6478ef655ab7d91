"""Inception Score: ``exp(E_x KL(p(y|x) ‖ p(y)))`` over splits of the
samples, from class logits of a pluggable classifier."""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.models.inception import resolve_feature_argument
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.prng import permutation


class InceptionScore(Metric):
    """Inception Score over a pluggable logits extractor.

    ``compute`` shuffles the samples with the permutation JAX draws from
    ``PRNGKey(42)`` (``utils/prng.py``, so each split holds the samples it
    holds in the JAX package), splits them as ``torch.chunk`` would (bounds
    from ``np.linspace``) and returns the mean and standard deviation (ddof 1)
    of the per-split scores.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import InceptionScore
        >>> imgs = (torch.arange(4 * 3 * 8 * 8).reshape(4, 3, 8, 8) % 255) / 255.0
        >>> inception = InceptionScore(
        ...     feature_extractor=lambda x: x.reshape(x.shape[0], -1)[:, :5], splits=2, device="cpu")
        >>> inception.update(imgs)
        >>> mean, std = inception.compute()
        >>> round(float(mean), 4), round(float(std), 4)
        (1.0, 0.0)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Any = None,
        splits: int = 10,
        normalize: bool = False,
        inception_params: Optional[dict] = None,
        feature_extractor: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        # IS reads class logits: the built-in network's default tap is the
        # 1008-class head before its bias
        self.feature_extractor, _ = resolve_feature_argument(
            "InceptionScore", feature, feature_extractor, inception_params,
            default_dim="logits_unbiased", device=self.device,
        )
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Integer input to argument `splits` must be positive")
        self.splits = splits
        self.normalize = normalize
        self.add_state("features", [], dist_reduce_fx="cat")

    def update(self, imgs: torch.Tensor) -> None:
        if self.normalize:  # [0, 1] floats -> uint8, as the network is fed
            imgs = (imgs * 255).to(torch.uint8)
        self.features.append(torch.as_tensor(self.feature_extractor(imgs)).to(torch.float32))

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, std) of the per-split scores."""
        features = dim_zero_cat(self.features)
        n = features.shape[0]
        if n < self.splits:
            raise ValueError(
                f"Expected number of samples to be at least as large as `splits`={self.splits} but got {n}."
            )
        features = features[torch.as_tensor(permutation(42, n), device=features.device)]
        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        # chunk like torch.chunk: all samples covered, uneven tail allowed
        bounds = np.linspace(0, n, self.splits + 1).astype(int)
        kl_means = []
        for k in range(self.splits):
            p = prob[bounds[k] : bounds[k + 1]]
            lp = log_prob[bounds[k] : bounds[k + 1]]
            mean_prob = p.mean(0, keepdim=True)
            kl_ = p * (lp - torch.log(mean_prob))
            kl_means.append(torch.exp(kl_.sum(1).mean()))
        kl = torch.stack(kl_means)
        return kl.mean(), kl.std(correction=1)
