"""The port's TV, UQI, SAM, ERGAS, RMSE-SW, RASE, SCC, PSNR, PSNR-B and image
gradients against the JAX package, functional and class forms.

The same seeded numpy images go through both packages on the CPU (the JAX
package's windowed sums through its reference body, the port's through the
``ssim_windows`` plain body). Tolerances:

- elementwise and summed metrics (TV, SAM, ERGAS, PSNR, PSNR-B, gradients):
  rtol 1e-5, atol 1e-6 (float32 sums in another order);
- windowed metrics (UQI, RMSE-SW, RASE, SCC): rtol 1e-4, atol 1e-5. Their
  moments are float32 products summed in another order, and UQI and SCC
  divide by local variances (``E[x²] − μ²``) that cancel;
- per-pixel maps (``reduction="none"``): UQI atol 2e-4, as the SSIM
  tests' maps (a pixel whose local variance is near zero divides a rounding
  difference by almost nothing); SAM atol 5e-4 (``arccos`` near 1 turns a
  rounding ``d`` of the cosine into an angle error of about ``d`` over the
  angle's sine, and up to ``sqrt(2 d)``, 3.5e-4 for one float32 ulp, at an
  angle near 0);
- the UQI gradient against ``jax.grad``: rtol 1e-3, atol 1e-6 (the
  backward divides by the same variances once more).
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

RTOL, ATOL = 1e-5, 1e-6
WIN_RTOL, WIN_ATOL = 1e-4, 1e-5
UQI_MAP_ATOL, SAM_MAP_ATOL = 2e-4, 5e-4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r, rtol, atol)
        return
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, equal_nan=True)


def _images(seed, shape, scale=1.0):
    """``preds`` and ``target``: a smooth ramp plus noise, and a noisy copy."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, shape[-2]), np.linspace(0, 1, shape[-1]), indexing="ij")
    base = 0.3 + 0.4 * (yy * rng.uniform(0.2, 1.0, shape[:-2] + (1, 1)) + xx * rng.uniform(0.2, 1.0, shape[:-2] + (1, 1)))
    preds = np.clip(base / 1.4 + 0.1 * rng.rand(*shape), 0, 1)
    target = np.clip(preds + 0.05 * rng.randn(*shape), 0, 1)
    return (scale * preds).astype(np.float32), (scale * target).astype(np.float32)


def _both(name, *arrays, **kwargs):
    port = getattr(functional, name)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    ref = getattr(jax_functional, name)(*[jnp.asarray(a) for a in arrays], **kwargs)
    return port, ref


def _classes(name, batches, port_kwargs=None, **kwargs):
    port = getattr(image, name)(device="cpu", **kwargs)
    ref = getattr(jax_image, name)(**kwargs)
    for batch in batches:
        port.update(*[torch.from_numpy(a) for a in batch])
        ref.update(*[jnp.asarray(a) for a in batch])
    return port.compute(), ref.compute()


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_total_variation(reduction):
    preds, _ = _images(0, (3, 2, 17, 23))
    _close(*_both("total_variation", preds, reduction=reduction), rtol=RTOL, atol=1e-4)
    batches = [(_images(s, (2, 3, 12, 9))[0],) for s in (1, 2)]
    _close(*_classes("TotalVariation", batches, reduction=reduction), rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize(
    "kernel_size, sigma, reduction",
    [((11, 11), (1.5, 1.5), "elementwise_mean"), ((7, 5), (1.0, 2.0), "sum"), ((3, 9), (0.8, 1.7), "none")],
)
def test_uqi(kernel_size, sigma, reduction):
    preds, target = _images(3, (2, 3, 24, 28))
    kw = dict(kernel_size=kernel_size, sigma=sigma, reduction=reduction)
    atol = UQI_MAP_ATOL if reduction == "none" else WIN_ATOL
    _close(*_both("universal_image_quality_index", preds, target, **kw), WIN_RTOL, atol)
    batches = [_images(s, (2, 2, 20, 21)) for s in (4, 5)]
    _close(*_classes("UniversalImageQualityIndex", batches, **kw), WIN_RTOL, atol)


def test_uqi_kernel_size_one_is_nan():
    """A kernel size of 1 crops the map to nothing: NaN in both packages."""
    preds, target = _images(6, (1, 2, 16, 16))
    port, ref = _both("universal_image_quality_index", preds, target, kernel_size=(1, 1), sigma=(1.0, 1.0))
    assert np.isnan(_np(ref)) and np.isnan(_np(port))


def test_uqi_gradient():
    preds, target = _images(7, (2, 2, 18, 20))
    p = torch.from_numpy(preds).requires_grad_(True)
    functional.universal_image_quality_index(p, torch.from_numpy(target)).backward()
    ref = jax.grad(lambda x: jax_functional.universal_image_quality_index(x, jnp.asarray(target)))(jnp.asarray(preds))
    _close(p.grad, ref, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam(reduction):
    preds, target = _images(8, (2, 4, 13, 11))
    atol = SAM_MAP_ATOL if reduction == "none" else ATOL
    _close(*_both("spectral_angle_mapper", preds, target, reduction=reduction), RTOL, atol)
    batches = [_images(s, (2, 3, 9, 9)) for s in (9, 10)]
    _close(*_classes("SpectralAngleMapper", batches, reduction=reduction), RTOL, atol)


@pytest.mark.parametrize("ratio, reduction", [(4, "elementwise_mean"), (2, "sum"), (0.5, "none")])
def test_ergas(ratio, reduction):
    preds, target = _images(11, (3, 4, 12, 15))
    _close(*_both("error_relative_global_dimensionless_synthesis", preds, target, ratio=ratio, reduction=reduction))
    batches = [_images(s, (2, 3, 10, 10)) for s in (12, 13)]
    _close(*_classes("ErrorRelativeGlobalDimensionlessSynthesis", batches, ratio=ratio, reduction=reduction))


@pytest.mark.parametrize("window_size", [8, 7, 5, 1])
def test_rmse_sw(window_size):
    """Even and odd windows; a window of 1 crops to nothing (NaN in both)."""
    preds, target = _images(14, (2, 3, 21, 19))
    _close(*_both("root_mean_squared_error_using_sliding_window", preds, target, window_size=window_size), WIN_RTOL, WIN_ATOL)
    port, ref = _both(
        "root_mean_squared_error_using_sliding_window", preds, target, window_size=window_size, return_rmse_map=True
    )
    _close(port, ref, WIN_RTOL, WIN_ATOL)
    batches = [_images(s, (2, 2, 16, 17)) for s in (15, 16)]
    _close(*_classes("RootMeanSquaredErrorUsingSlidingWindow", batches, window_size=window_size), WIN_RTOL, WIN_ATOL)


@pytest.mark.parametrize("window_size", [8, 7, 3])
def test_rase(window_size):
    preds, target = _images(17, (2, 3, 20, 22))
    _close(*_both("relative_average_spectral_error", preds, target, window_size=window_size), WIN_RTOL, WIN_ATOL)
    batches = [_images(s, (2, 3, 16, 16)) for s in (18, 19)]
    _close(*_classes("RelativeAverageSpectralError", batches, window_size=window_size), WIN_RTOL, WIN_ATOL)


@pytest.mark.parametrize("window_size, reduction", [(8, "mean"), (7, "none"), (4, None)])
def test_scc(window_size, reduction):
    preds, target = _images(20, (2, 3, 19, 23))
    _close(*_both("spatial_correlation_coefficient", preds, target, window_size=window_size, reduction=reduction), WIN_RTOL, WIN_ATOL)
    batches = [_images(s, (2, 2, 16, 18)) for s in (21, 22)]
    _close(*_classes("SpatialCorrelationCoefficient", batches, window_size=window_size), WIN_RTOL, WIN_ATOL)


def test_scc_three_dim_input_and_custom_filter():
    preds, target = _images(23, (3, 18, 18))
    hp = np.array([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]], dtype=np.float32)
    port = functional.spatial_correlation_coefficient(torch.from_numpy(preds), torch.from_numpy(target), hp_filter=torch.from_numpy(hp))
    ref = jax_functional.spatial_correlation_coefficient(jnp.asarray(preds), jnp.asarray(target), hp_filter=jnp.asarray(hp))
    _close(port, ref, WIN_RTOL, WIN_ATOL)


@pytest.mark.parametrize(
    "data_range, base, dim, reduction",
    [
        (None, 10.0, None, "elementwise_mean"),
        (1.0, 10.0, None, "elementwise_mean"),
        ((0.2, 0.8), 2.0, None, "elementwise_mean"),
        (1.0, 10.0, 1, "none"),
        (1.0, 10.0, (1, 2), "sum"),
        ((0.1, 0.9), np.e, (2, 3), "elementwise_mean"),
    ],
)
def test_psnr(data_range, base, dim, reduction):
    preds, target = _images(24, (3, 2, 14, 12))
    kw = dict(data_range=data_range, base=base, dim=dim, reduction=reduction)
    _close(*_both("peak_signal_noise_ratio", preds, target, **kw))
    batches = [_images(s, (2, 2, 10, 11)) for s in (25, 26)]
    _close(*_classes("PeakSignalNoiseRatio", batches, **kw))


@pytest.mark.parametrize("block_size, scale", [(8, 1.0), (4, 1.0), (8, 255.0), (3, 255.0)])
def test_psnrb(block_size, scale):
    """Unit-range images take 1 as the peak, 0-255 images their range."""
    preds, target = _images(27, (2, 1, 24, 20), scale)
    _close(*_both("peak_signal_noise_ratio_with_blocked_effect", preds, target, block_size=block_size))
    batches = [_images(s, (2, 1, 16, 24), scale) for s in (28, 29)]
    _close(*_classes("PeakSignalNoiseRatioWithBlockedEffect", batches, block_size=block_size))


def test_psnrb_rejects_colour():
    preds, target = _images(30, (1, 3, 16, 16))
    with pytest.raises(ValueError, match="grayscale"):
        functional.peak_signal_noise_ratio_with_blocked_effect(torch.from_numpy(preds), torch.from_numpy(target))


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 1, 1, 4)])
def test_image_gradients(shape):
    img, _ = _images(31, shape)
    _close(*_both("image_gradients", img))


def test_classes_keep_the_reference_states():
    """State names and reductions are the JAX package's, so sync and the
    compute groups see the same fields."""
    for name, kwargs in [
        ("PeakSignalNoiseRatio", {}), ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": 1}),
        ("PeakSignalNoiseRatioWithBlockedEffect", {}), ("TotalVariation", {}), ("TotalVariation", {"reduction": None}),
        ("UniversalImageQualityIndex", {}), ("SpectralAngleMapper", {}), ("ErrorRelativeGlobalDimensionlessSynthesis", {}),
        ("RootMeanSquaredErrorUsingSlidingWindow", {}), ("RelativeAverageSpectralError", {}),
        ("SpatialCorrelationCoefficient", {}), ("VisualInformationFidelity", {}), ("SpectralDistortionIndex", {}),
        ("SpatialDistortionIndex", {}), ("QualityWithNoReference", {}),
    ]:
        port = getattr(image, name)(device="cpu", **kwargs)
        ref = getattr(jax_image, name)(**kwargs)
        assert port._reductions == ref._reductions, name


def test_image_collection_matches_jax():
    """The slice as a whole: one collection of streaming and list-state
    image metrics (UQI, SAM, ERGAS and RASE share one compute group) over
    two updates, against the JAX package's collection."""
    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu_torch as tm

    def members(ns, **kw):
        return {
            "psnr": ns.PeakSignalNoiseRatio(data_range=1.0, **kw),
            "rmse_sw": ns.RootMeanSquaredErrorUsingSlidingWindow(**kw),
            "scc": ns.SpatialCorrelationCoefficient(**kw),
            "vif": ns.VisualInformationFidelity(**kw),
            "uqi": ns.UniversalImageQualityIndex(**kw),
            "sam": ns.SpectralAngleMapper(**kw),
            "ergas": ns.ErrorRelativeGlobalDimensionlessSynthesis(**kw),
            "rase": ns.RelativeAverageSpectralError(**kw),
        }

    port = tm.MetricCollection(members(image, device="cpu"), device="cpu")
    ref = jax_tm.MetricCollection(members(jax_image, executor=False), executor=False)
    for seed in (40, 41):
        preds, target = _images(seed, (2, 3, 44, 46))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], WIN_RTOL, WIN_ATOL)
    assert any(len(g) == 4 for g in port.compute_groups.values())


def test_exports_match_the_jax_package():
    """Every name the JAX package's image namespaces export, the port exports."""
    import torchmetrics_tpu.functional.image as jax_functional_image
    import torchmetrics_tpu_torch.functional.image as functional_image

    jax_functional_names = {n for n in dir(jax_functional_image) if not n.startswith("_") and callable(getattr(jax_functional_image, n))}
    assert set(jax_image.__all__) <= set(image.__all__) and len(jax_image.__all__) == 21
    assert jax_functional_names <= set(functional_image.__all__) and len(jax_functional_names) == 18
    for name in jax_functional_names:
        assert getattr(functional, name) is getattr(functional_image, name)
