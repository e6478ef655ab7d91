"""The port's VIF, D_lambda, D_s and QNR against the JAX package, functional
and class forms, and the pan image's degradation (``_degrade_pan``).

The same seeded numpy images go through both packages on the CPU (windowed
sums through each package's reference body). Tolerances:

- VIF: rtol 1e-4, atol 1e-6. Four scales of float32 windowed moments
  summed in another order; the per-pixel information terms divide by local
  variances that cancel;
- D_lambda, D_s, QNR: rtol 1e-4, atol 1e-5 (UQI's windowed moments, as in
  ``tests/test_torch_image_misc.py``);
- ``_degrade_pan``: atol 1e-5 (``F.interpolate`` with ``antialias=True``
  against ``jax.image.resize``: their triangle kernels' weights are float32
  sums in another order; without antialiasing the two differ by up to 0.46);
- the VIF gradient against ``jax.grad``: rtol 1e-3, atol 1e-8.
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
from torchmetrics_tpu.functional.image.pansharpening import _degrade_pan as jax_degrade_pan
from torchmetrics_tpu_torch.functional.image.pansharpening import _degrade_pan

VIF_RTOL, VIF_ATOL = 1e-4, 1e-6
PAN_RTOL, PAN_ATOL = 1e-4, 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, rtol, atol):
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, equal_nan=True)


def _smooth(rng, shape):
    """A sum of four random low-frequency sinusoids around 0.5 plus noise."""
    yy, xx = np.meshgrid(np.arange(shape[-2]) / shape[-2], np.arange(shape[-1]) / shape[-1], indexing="ij")
    img = np.full(shape, 0.5)
    for _ in range(4):
        phase = rng.uniform(0.5, 3) * yy + rng.uniform(0.5, 3) * xx + rng.uniform(0, 6)
        img = img + rng.uniform(0.05, 0.15, shape[:-2] + (1, 1)) * np.sin(2 * np.pi * phase)
    return np.clip(img + 0.03 * rng.randn(*shape), 0, 1).astype(np.float32)


def _pair(seed, shape):
    rng = np.random.RandomState(seed)
    preds = _smooth(rng, shape)
    return preds, np.clip(preds + 0.05 * rng.randn(*shape), 0, 1).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape, sigma_n_sq", [((2, 3, 48, 50), 2.0), ((1, 2, 41, 63), 0.5)])
def test_vif(shape, sigma_n_sq):
    preds, target = _pair(0, shape)
    port = functional.visual_information_fidelity(*_t(preds, target), sigma_n_sq=sigma_n_sq)
    ref = jax_functional.visual_information_fidelity(*_j(preds, target), sigma_n_sq=sigma_n_sq)
    _close(port, ref, VIF_RTOL, VIF_ATOL)
    m_port = image.VisualInformationFidelity(sigma_n_sq=sigma_n_sq, device="cpu")
    m_ref = jax_image.VisualInformationFidelity(sigma_n_sq=sigma_n_sq)
    for seed in (1, 2):
        batch = _pair(seed, shape)
        m_port.update(*_t(*batch))
        m_ref.update(*_j(*batch))
    _close(m_port.compute(), m_ref.compute(), VIF_RTOL, VIF_ATOL)


@pytest.mark.parametrize("shape", [(1, 1, 40, 48), (1, 1, 48, 40)])
def test_vif_needs_41_pixels(shape):
    preds, target = _pair(3, shape)
    for fn, args in ((functional.visual_information_fidelity, _t(preds, target)),
                     (jax_functional.visual_information_fidelity, _j(preds, target))):
        with pytest.raises(ValueError, match="at least 41x41"):
            fn(*args)
    with pytest.raises(ValueError, match="at least 41x41"):
        image.VisualInformationFidelity(device="cpu").update(*_t(preds, target))


def test_vif_gradient():
    preds, target = _pair(4, (1, 1, 42, 43))
    p = torch.from_numpy(preds).requires_grad_(True)
    functional.visual_information_fidelity(p, torch.from_numpy(target)).backward()
    ref = jax.grad(lambda x: jax_functional.visual_information_fidelity(x, jnp.asarray(target)))(jnp.asarray(preds))
    _close(p.grad, ref, 1e-3, 1e-8)


@pytest.mark.parametrize("p, reduction, bands", [(1, "elementwise_mean", 4), (2, "sum", 3), (3, "none", 2), (1, "elementwise_mean", 1)])
def test_spectral_distortion_index(p, reduction, bands):
    preds, _ = _pair(5, (2, bands, 32, 30))
    ms, _ = _pair(6, (2, bands, 16, 15))
    port = functional.spectral_distortion_index(*_t(preds, ms), p=p, reduction=reduction)
    ref = jax_functional.spectral_distortion_index(*_j(preds, ms), p=p, reduction=reduction)
    _close(port, ref, PAN_RTOL, PAN_ATOL)
    m_port = image.SpectralDistortionIndex(p=p, reduction=reduction, device="cpu")
    m_ref = jax_image.SpectralDistortionIndex(p=p, reduction=reduction)
    for seed in (7, 8):
        batch = (_pair(seed, (2, bands, 24, 24))[0], _pair(seed + 10, (2, bands, 24, 24))[0])
        m_port.update(*_t(*batch))
        m_ref.update(*_j(*batch))
    _close(m_port.compute(), m_ref.compute(), PAN_RTOL, PAN_ATOL)


def _pansharpening_inputs(seed, b=2, c=3, h=32, ratio=4):
    rng = np.random.RandomState(seed)
    pan = _smooth(rng, (b, c, h, h))
    preds = np.clip(pan + 0.05 * rng.randn(b, c, h, h), 0, 1).astype(np.float32)
    ms = np.clip(preds[:, :, ::ratio, ::ratio] * 0.9 + 0.02 * rng.randn(b, c, h // ratio, h // ratio), 0, 1)
    pan_lr = np.clip(pan[:, :, ::ratio, ::ratio] + 0.01 * rng.randn(b, c, h // ratio, h // ratio), 0, 1)
    return preds, ms.astype(np.float32), pan, pan_lr.astype(np.float32)


@pytest.mark.parametrize(
    "norm_order, window_size, reduction, with_lr",
    [(1, 7, "elementwise_mean", False), (2, 3, "sum", False), (1, 5, "none", True), (3, 4, "elementwise_mean", True)],
)
def test_spatial_distortion_index(norm_order, window_size, reduction, with_lr):
    preds, ms, pan, pan_lr = _pansharpening_inputs(9, h=48)
    kw = dict(norm_order=norm_order, window_size=window_size, reduction=reduction)
    lr = pan_lr if with_lr else None
    port = functional.spatial_distortion_index(*_t(preds, ms, pan), None if lr is None else torch.from_numpy(lr), **kw)
    ref = jax_functional.spatial_distortion_index(*_j(preds, ms, pan), None if lr is None else jnp.asarray(lr), **kw)
    _close(port, ref, PAN_RTOL, PAN_ATOL)
    m_port = image.SpatialDistortionIndex(device="cpu", **kw)
    m_ref = jax_image.SpatialDistortionIndex(**kw)
    for seed in (10, 11):
        preds, ms, pan, pan_lr = _pansharpening_inputs(seed, h=48)
        target = {"ms": ms, "pan": pan, **({"pan_lr": pan_lr} if with_lr else {})}
        m_port.update(torch.from_numpy(preds), {k: torch.from_numpy(v) for k, v in target.items()})
        m_ref.update(jnp.asarray(preds), {k: jnp.asarray(v) for k, v in target.items()})
    _close(m_port.compute(), m_ref.compute(), PAN_RTOL, PAN_ATOL)


@pytest.mark.parametrize("alpha, beta, with_lr", [(1, 1, False), (0.5, 2.0, True)])
def test_quality_with_no_reference(alpha, beta, with_lr):
    preds, ms, pan, pan_lr = _pansharpening_inputs(12, h=40)
    lr = pan_lr if with_lr else None
    kw = dict(alpha=alpha, beta=beta)
    port = functional.quality_with_no_reference(*_t(preds, ms, pan), None if lr is None else torch.from_numpy(lr), **kw)
    ref = jax_functional.quality_with_no_reference(*_j(preds, ms, pan), None if lr is None else jnp.asarray(lr), **kw)
    _close(port, ref, PAN_RTOL, PAN_ATOL)
    m_port = image.QualityWithNoReference(device="cpu", **kw)
    m_ref = jax_image.QualityWithNoReference(**kw)
    for seed in (13, 14):
        preds, ms, pan, pan_lr = _pansharpening_inputs(seed, h=40)
        target = {"ms": ms, "pan": pan, **({"pan_lr": pan_lr} if with_lr else {})}
        m_port.update(torch.from_numpy(preds), {k: torch.from_numpy(v) for k, v in target.items()})
        m_ref.update(jnp.asarray(preds), {k: jnp.asarray(v) for k, v in target.items()})
    _close(m_port.compute(), m_ref.compute(), PAN_RTOL, PAN_ATOL)


def test_pan_target_needs_ms_and_pan():
    preds, ms, pan, _ = _pansharpening_inputs(15)
    with pytest.raises(ValueError, match="keys 'ms' and 'pan'"):
        image.QualityWithNoReference(device="cpu").update(torch.from_numpy(preds), {"ms": torch.from_numpy(ms)})


@pytest.mark.parametrize("shape, ms_shape, window_size", [((1, 1, 512, 512), (128, 128), 7), ((1, 2, 128, 32), (64, 64), 5)])
def test_degrade_pan(shape, ms_shape, window_size):
    """Shrinking both sides (WorldView-3's 512 -> 128), and shrinking one
    side while growing the other: the antialiased bilinear resize in both."""
    pan = _smooth(np.random.RandomState(16), shape)
    port = _degrade_pan(torch.from_numpy(pan), ms_shape, window_size)
    ref = jax_degrade_pan(jnp.asarray(pan), ms_shape, window_size)
    _close(port, ref, 0, 1e-5)
