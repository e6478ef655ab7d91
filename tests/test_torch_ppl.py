"""The port's perceptual path length against the JAX package.

The generator model's ``sample`` returns the same numpy-seeded latents
whatever key or ``torch.Generator`` it is given (the first call one set,
the second another), and it forms its images in float64 before rounding
them to float32, so both packages score the same images up to the float32
rounding of the interpolated latents.

Tolerances: the interpolation and the resize elementwise, atol 1e-6 (the
resize's weights are float32 sums in another order); PPL with a plain
similarity at the default ``epsilon=1e-4``, rtol 1e-4, and 1e-3 for
``slerp_any`` (its coefficients ``sin(epsilon ω) / sin ω`` round
differently in XLA's and ATen's ``sin`` and ``arccos``, by an ulp, which
the division by ``epsilon²`` scales as below); PPL through the
LPIPS network, rtol 1e-4 at ``epsilon=1e-2``. Distances are divided by
``epsilon²``: a float32 rounding ``r`` of a backbone's features becomes an
error of about ``r / epsilon`` in the features' difference, so at 1e-4 two
correct float32 convolutions (the packages sum in another order) differ by
about 1e-3 of the distance, which says nothing about the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional as jax_functional
import torchmetrics_tpu.image as jax_image
import torchmetrics_tpu_torch.functional as functional
import torchmetrics_tpu_torch.image as image
from torchmetrics_tpu.functional.image.perceptual_path_length import _interpolate as jax_interpolate
from torchmetrics_tpu.functional.image.perceptual_path_length import _resize_tensor as jax_resize
from torchmetrics_tpu.models.lpips import init_lpips_params
from torchmetrics_tpu_torch.functional.image.perceptual_path_length import _interpolate, _resize_tensor

Z = 16


class _Gen:
    """``sample`` alternates between two fixed latent sets; images are
    ``255 · sigmoid(z @ w)`` formed in float64, in the package of ``z``."""

    num_classes = 5

    def __init__(self, size, n, seed=0):
        rng = np.random.RandomState(seed)
        self.latents = [rng.randn(n, Z).astype(np.float32) for _ in range(2)]
        self.w = rng.randn(Z, 3 * size * size) / np.sqrt(Z)
        self.size, self.calls = size, 0

    def sample(self, key, num):
        out = self.latents[self.calls % 2][:num]
        self.calls += 1
        return out

    def __call__(self, z, labels=None):
        if labels is not None:
            assert labels.shape == (z.shape[0],) and int(labels.min()) >= 0 and int(labels.max()) < self.num_classes
        z64 = np.asarray(z, dtype=np.float64)
        img = (255 / (1 + np.exp(-(z64 @ self.w)))).reshape(-1, 3, self.size, self.size).astype(np.float32)
        return torch.from_numpy(img) if isinstance(z, torch.Tensor) else jnp.asarray(img)


class _PortGen(_Gen):
    def sample(self, key, num):
        assert isinstance(key, torch.Generator)
        return torch.from_numpy(super().sample(key, num))


def _both(size, n, **kwargs):
    port = functional.perceptual_path_length(_PortGen(size, n), num_samples=n, device="cpu", **kwargs)
    ref = jax_functional.perceptual_path_length(_Gen(size, n), num_samples=n, key=jax.random.PRNGKey(0), **kwargs)
    return port, ref


def _close(port, ref, rtol):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=rtol, atol=0)


def _l1(a, b):
    return (a - b).abs().mean(dim=(1, 2, 3)) if isinstance(a, torch.Tensor) else jnp.abs(a - b).mean(axis=(1, 2, 3))


@pytest.mark.parametrize("method", ["lerp", "slerp_any", "slerp_unit"])
@pytest.mark.parametrize("lower, upper", [(0.01, 0.99), (None, None), (0.2, 0.7)])
def test_ppl_plain_similarity(method, lower, upper):
    _close(*_both(8, 64, batch_size=24, interpolation_method=method, sim_net=_l1, resize=None,
                  lower_discard=lower, upper_discard=upper), rtol=1e-3 if method == "slerp_any" else 1e-4)


def test_ppl_conditional():
    _close(*_both(8, 32, batch_size=10, conditional=True, sim_net=_l1, resize=None), rtol=1e-4)


@pytest.mark.parametrize("net_type, size, method", [("vgg", 16, "lerp"), ("alex", 80, "slerp_unit")])
def test_ppl_lpips(net_type, size, method):
    """The built-in network on converted seeded parameters; 16 x 16 images
    are upsampled to 64, 80 x 80 ones area-resized."""
    tree = init_lpips_params(net_type, jax.random.PRNGKey(1))
    kw = dict(batch_size=8, interpolation_method=method, epsilon=1e-2, resize=64, sim_net=net_type)
    port = functional.perceptual_path_length(
        _PortGen(size, 16), num_samples=16, device="cpu", sim_params=jax.tree_util.tree_map(np.asarray, tree), **kw
    )
    ref = jax_functional.perceptual_path_length(_Gen(size, 16), num_samples=16, key=jax.random.PRNGKey(0), sim_params=tree, **kw)
    _close(port, ref, rtol=1e-4)


def test_ppl_class():
    m_port = image.PerceptualPathLength(num_samples=40, batch_size=16, sim_net=_l1, resize=None, device="cpu")
    m_ref = jax_image.PerceptualPathLength(num_samples=40, batch_size=16, sim_net=_l1, resize=None)
    m_port.update(_PortGen(8, 40))
    m_ref.update(_Gen(8, 40))
    _close(m_port.compute(), m_ref.compute(), rtol=1e-4)


def test_ppl_key_is_handed_to_sample():
    seen = []

    class Gen:
        def sample(self, key, n):
            seen.append(key)
            return torch.randn(n, 4, generator=key)

        def __call__(self, z):
            return 127.5 * (1 + torch.tanh(z[:, :3, None, None] * torch.ones(1, 3, 4, 4)))

    key = torch.Generator().manual_seed(3)
    functional.perceptual_path_length(Gen(), num_samples=6, batch_size=3, resize=None, sim_net=_l1, key=key, device="cpu")
    assert seen == [key, key]


@pytest.mark.parametrize("method", ["lerp", "slerp_any", "slerp_unit"])
def test_interpolate(method):
    rng = np.random.RandomState(2)
    a, b = rng.randn(6, Z).astype(np.float32), rng.randn(6, Z).astype(np.float32)
    a[1] = 0.0  # a zero latent and a collinear pair take the lerp
    b[2] = 3 * a[2]
    for eps in (1e-4, 0.3):
        port = _interpolate(torch.from_numpy(a), torch.from_numpy(b), eps, method)
        ref = jax_interpolate(jnp.asarray(a), jnp.asarray(b), eps, method)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 3, 80, 96), (2, 3, 80, 40), (1, 3, 16, 16), (1, 3, 64, 64)])
def test_resize(shape):
    """Both sides above 64: the area resize; one side above: the
    antialiased bilinear resize; none: the bilinear upsample."""
    x = np.random.RandomState(3).rand(*shape).astype(np.float32)
    np.testing.assert_allclose(_resize_tensor(torch.from_numpy(x), 64).numpy(), np.asarray(jax_resize(jnp.asarray(x), 64)), atol=1e-6)
