"""PerceptualPathLength: ``update`` registers the generator model,
``compute`` samples, interpolates and scores (no tensor state; every
compute samples afresh)."""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.perceptual_path_length import (
    GeneratorType,
    _perceptual_path_length_validate_arguments,
    _validate_generator_model,
    perceptual_path_length,
)
from torchmetrics_tpu_torch.metric import Metric

__all__ = ["GeneratorType", "PerceptualPathLength"]


class PerceptualPathLength(Metric):
    """Perceptual path length of a generator model.

    Args:
        num_samples: latent pairs sampled at each compute.
        conditional: whether the generator takes labels.
        batch_size: the generator's and the similarity's batch.
        interpolation_method: ``"lerp"``, ``"slerp_any"`` or ``"slerp_unit"``.
        epsilon: the step along the latent path.
        resize: the side the images are resized to before scoring.
        lower_discard, upper_discard: distance quantiles trimmed.
        sim_net: a callable ``(img1, img2) -> (N,)`` or a net type built
            from ``sim_params`` on the metric's device.
        key: the ``torch.Generator`` the latents are drawn with.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PerceptualPathLength
        >>> class ToyGen:
        ...     def sample(self, key, n):
        ...         return torch.randn(n, 4, generator=key)
        ...     def __call__(self, z):
        ...         return 127.5 * (1 + torch.tanh(z[:, :3, None, None] * torch.ones(1, 3, 8, 8)))
        >>> ppl = PerceptualPathLength(num_samples=8, batch_size=4, resize=None, lower_discard=None,
        ...     upper_discard=None, sim_net=lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3)), device="cpu")
        >>> ppl.update(ToyGen())
        >>> mean, std, raw = ppl.compute()
        >>> tuple(raw.shape)
        (8,)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 128,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        resize: Optional[int] = 64,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Union[Callable[[torch.Tensor, torch.Tensor], torch.Tensor], str, None] = "vgg",
        sim_params=None,
        key: Optional[torch.Generator] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _perceptual_path_length_validate_arguments(
            num_samples, conditional, batch_size, interpolation_method, epsilon, resize, lower_discard, upper_discard
        )
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.sim_net = sim_net
        self.sim_params = sim_params
        self.key = key
        self.generator = None

    def update(self, generator) -> None:
        """Register the generator model."""
        _validate_generator_model(generator, self.conditional)
        self.generator = generator

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.generator is None:
            raise RuntimeError("No generator registered; call `update(generator)` first.")
        return perceptual_path_length(
            generator=self.generator,
            num_samples=self.num_samples,
            conditional=self.conditional,
            batch_size=self.batch_size,
            interpolation_method=self.interpolation_method,
            epsilon=self.epsilon,
            resize=self.resize,
            lower_discard=self.lower_discard,
            upper_discard=self.upper_discard,
            sim_net=self.sim_net,
            sim_params=self.sim_params,
            key=self.key,
            device=self.device,
        )
