"""Perceptual path length (PPL) of a generator model.

``PPL = E[D(G(I(z1, z2, t)), G(I(z1, z2, t + eps))) / eps²]`` with ``D`` an
LPIPS-style similarity. The generator is any object with ``sample(key,
num_samples) -> (N, z)`` and ``__call__(z) -> (N, C, H, W)`` images in [0,
255] (and ``num_classes`` with ``__call__(z, labels)`` when
``conditional``). Randomness is explicit: ``key`` is a ``torch.Generator``,
handed to ``sample`` for each of the two latent draws.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utils.compute import full_float32


class GeneratorType:
    """Interface of the generator models (subclassing is optional)."""

    @property
    def num_classes(self) -> int:
        raise NotImplementedError

    def sample(self, key: torch.Generator, num_samples: int) -> torch.Tensor:
        """``(num_samples, z_size)`` latents."""
        raise NotImplementedError


def _validate_generator_model(generator, conditional: bool = False) -> None:
    if not hasattr(generator, "sample"):
        raise NotImplementedError(
            "The generator must have a `sample` method with signature `sample(key: torch.Generator, num_samples: int)"
            " -> Tensor` where the returned tensor has shape `(num_samples, z_size)`."
        )
    if not callable(generator.sample):
        raise ValueError("The generator's `sample` method must be callable.")
    if conditional and not hasattr(generator, "num_classes"):
        raise AttributeError("The generator must have a `num_classes` attribute when `conditional=True`.")
    if conditional and not isinstance(generator.num_classes, int):
        raise ValueError("The generator's `num_classes` attribute must be an integer when `conditional=True`.")


def _perceptual_path_length_validate_arguments(
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 128,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
) -> None:
    if not (isinstance(num_samples, int) and num_samples > 0):
        raise ValueError(f"Argument `num_samples` must be a positive integer, but got {num_samples}.")
    if not isinstance(conditional, bool):
        raise ValueError(f"Argument `conditional` must be a boolean, but got {conditional}.")
    if not (isinstance(batch_size, int) and batch_size > 0):
        raise ValueError(f"Argument `batch_size` must be a positive integer, but got {batch_size}.")
    if interpolation_method not in ["lerp", "slerp_any", "slerp_unit"]:
        raise ValueError(
            f"Argument `interpolation_method` must be one of 'lerp', 'slerp_any', 'slerp_unit',"
            f"got {interpolation_method}."
        )
    if not (isinstance(epsilon, float) and epsilon > 0):
        raise ValueError(f"Argument `epsilon` must be a positive float, but got {epsilon}.")
    if resize is not None and not (isinstance(resize, int) and resize > 0):
        raise ValueError(f"Argument `resize` must be a positive integer or `None`, but got {resize}.")
    if lower_discard is not None and not (isinstance(lower_discard, float) and 0 <= lower_discard <= 1):
        raise ValueError(
            f"Argument `lower_discard` must be a float between 0 and 1 or `None`, but got {lower_discard}."
        )
    if upper_discard is not None and not (isinstance(upper_discard, float) and 0 <= upper_discard <= 1):
        raise ValueError(
            f"Argument `upper_discard` must be a float between 0 and 1 or `None`, but got {upper_discard}."
        )


def _interpolate(
    latents1: torch.Tensor,
    latents2: torch.Tensor,
    epsilon: float = 1e-4,
    interpolation_method: str = "lerp",
) -> torch.Tensor:
    """The point ``epsilon`` of the way from ``latents1`` to ``latents2``:
    linear, or spherical (``slerp_unit`` also projects onto the unit sphere);
    slerp falls back to lerp on zero or collinear latents."""
    eps = 1e-7
    if latents1.shape != latents2.shape:
        raise ValueError("Latents must have the same shape.")
    lerped = latents1 + (latents2 - latents1) * epsilon
    if interpolation_method == "lerp":
        return lerped
    if interpolation_method in ("slerp_any", "slerp_unit"):
        latents1_norm = latents1 / torch.clamp(torch.sqrt((latents1**2).sum(-1, keepdim=True)), min=eps)
        latents2_norm = latents2 / torch.clamp(torch.sqrt((latents2**2).sum(-1, keepdim=True)), min=eps)
        d = (latents1_norm * latents2_norm).sum(-1, keepdim=True)
        mask_zero = (torch.linalg.vector_norm(latents1_norm, dim=-1, keepdim=True) < eps) | (
            torch.linalg.vector_norm(latents2_norm, dim=-1, keepdim=True) < eps
        )
        mask_collinear = (d > 1 - eps) | (d < -1 + eps)
        omega = torch.arccos(torch.clamp(d, -1.0, 1.0))
        denom = torch.clamp(torch.sin(omega), min=eps)
        out = torch.sin((1 - epsilon) * omega) / denom * latents1 + torch.sin(epsilon * omega) / denom * latents2
        out = torch.where(mask_zero | mask_collinear, lerped, out)
        if interpolation_method == "slerp_unit":
            out = out / torch.clamp(torch.sqrt((out**2).sum(-1, keepdim=True)), min=eps)
        return out
    raise ValueError(
        f"Interpolation method {interpolation_method} not supported. Choose from 'lerp', 'slerp_any', 'slerp_unit'."
    )


def _area_resize_matrix(in_size: int, out_size: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Row-stochastic averaging matrix of an area (adaptive average) resize."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = int(math.floor(i * in_size / out_size))
        end = int(math.ceil((i + 1) * in_size / out_size))
        mat[i, start:end] = 1.0 / (end - start)
    return torch.from_numpy(mat).to(device=device, dtype=dtype)


def _resize_tensor(x: torch.Tensor, size: int = 64) -> torch.Tensor:
    """An area resize when both sides are above ``size``, else bilinear,
    antialiased where a side shrinks (as ``jax.image.resize`` does)."""
    h, w = x.shape[-2:]
    if h > size and w > size:
        wh = _area_resize_matrix(h, size, x.dtype, x.device)
        ww = _area_resize_matrix(w, size, x.dtype, x.device)
        with full_float32():
            return torch.einsum("oh,nchw,pw->ncop", wh, x, ww)
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=True)


def perceptual_path_length(
    generator,
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Union[Callable[[torch.Tensor, torch.Tensor], torch.Tensor], str, None] = None,
    sim_params=None,
    key: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Perceptual path length of a generator: the mean and standard
    deviation of the kept distances, and the kept distances.

    ``sim_net``: a callable ``(img1, img2) -> (N,)`` on [-1, 1] inputs, or a
    net type building ``models.lpips.lpips_network`` from ``sim_params`` on
    ``device`` (``None``: the current CUDA device). ``key``: the
    ``torch.Generator`` the latents and labels are drawn with (a fresh one
    seeded 0 on ``device`` when omitted).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import perceptual_path_length
        >>> class ToyGen:
        ...     def sample(self, key, n):
        ...         return torch.randn(n, 4, generator=key)
        ...     def __call__(self, z):
        ...         return 127.5 * (1 + torch.tanh(z[:, :3, None, None] * torch.ones(1, 3, 8, 8)))
        >>> mean, std, _ = perceptual_path_length(
        ...     ToyGen(), num_samples=8, batch_size=4, resize=None, lower_discard=None, upper_discard=None,
        ...     sim_net=lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3)), device="cpu")
        >>> bool(mean > 0), tuple(_.shape)
        (True, (8,))
    """
    _perceptual_path_length_validate_arguments(
        num_samples, conditional, batch_size, interpolation_method, epsilon, resize, lower_discard, upper_discard
    )
    _validate_generator_model(generator, conditional)
    device = resolve_device(device)
    key = key if key is not None else torch.Generator(device).manual_seed(0)

    latent1 = torch.as_tensor(generator.sample(key, num_samples))
    latent2 = torch.as_tensor(generator.sample(key, num_samples))
    latent2 = _interpolate(latent1, latent2, epsilon, interpolation_method=interpolation_method)
    if conditional:
        labels = torch.randint(0, generator.num_classes, (num_samples,), generator=key, device=key.device)

    if callable(sim_net):
        net = sim_net
    elif sim_net in ("alex", "vgg", "squeeze") or sim_net is None:
        if sim_params is None:
            raise ModuleNotFoundError(
                "perceptual_path_length with a net type requires `sim_params` for the built-in LPIPS network;"
                " pretrained backbones are not bundled. Pass a state dict, the JAX package's parameter tree,"
                " or a callable `sim_net`."
            )
        from torchmetrics_tpu_torch.models.lpips import lpips_network

        base_net = lpips_network(sim_net or "vgg", sim_params, device=device)

        def net(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
            if resize is not None:
                img1, img2 = _resize_tensor(img1, resize), _resize_tensor(img2, resize)
            return base_net(img1, img2)

    else:
        raise ValueError(f"sim_net must be a callable or one of 'alex', 'vgg', 'squeeze', got {sim_net}")

    distances = []
    for start in range(0, num_samples, batch_size):
        latents = torch.cat((latent1[start : start + batch_size], latent2[start : start + batch_size]))
        if conditional:
            batch_labels = labels[start : start + batch_size]
            outputs = generator(latents, torch.cat((batch_labels, batch_labels)))
        else:
            outputs = generator(latents)
        out1, out2 = torch.chunk(torch.as_tensor(outputs), 2, dim=0)
        # [0, 255] -> [0, 1] -> [-1, 1], the similarity's domain
        similarity = torch.as_tensor(net(2 * (out1 / 255) - 1, 2 * (out2 / 255) - 1))
        distances.append(similarity.reshape(-1) / epsilon**2)
    dists = torch.cat(distances)

    lower = torch.quantile(dists, lower_discard, interpolation="lower") if lower_discard is not None else 0.0
    upper = torch.quantile(dists, upper_discard, interpolation="lower") if upper_discard is not None else dists.max()
    kept = dists[(dists >= lower) & (dists <= upper)]
    return kept.mean(), kept.std(correction=1), kept
