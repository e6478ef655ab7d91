"""The port's SSIM and MS-SSIM against the JAX package.

The same numpy images, random and smooth, go through both packages on the
CPU: SSIM in 2-D and 3-D with gaussian and uniform windows; ``data_range``
None, a float or a tuple; ``return_full_image`` and
``return_contrast_sensitivity``; the three reductions; MS-SSIM with custom
``betas`` and every ``normalize``; both classes over several updates.

Tolerances. The windowed moments are float32 products summed in another
order (PyTorch's and XLA's matrix products), and the default gaussian's
taps differ between the frameworks by up to 3e-8 (``exp`` rounding). SSIM
takes differences of the moments (``E[x²] − μ²``), which cancel most where
an image is locally flat, and divides by them. So:

- per-image values and their reductions: rtol 1e-5, atol 2e-6;
- the full per-pixel SSIM map: atol 2e-4, since a pixel whose local
  variance is near zero divides a rounding difference by almost nothing.

Smooth images are sums of a few low-frequency sinusoids, as slowly varying
as natural image regions; targets add N(0, 0.02) noise, clipped to [0, 1].
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional as jax_functional
import torchmetrics_tpu.image as jax_image
import torchmetrics_tpu_torch.functional as functional
import torchmetrics_tpu_torch.image as image
from torchmetrics_tpu_torch.ops import ssim_kernel

RTOL = 1e-5
ATOL = 2e-6
MAP_ATOL = 2e-4


def _to_numpy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(port, ref):
    """Recursive comparison; arrays of more than two axes are per-pixel maps."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_close(p, r)
        return
    port, ref = _to_numpy(port), _to_numpy(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if port.ndim > 2:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=0, atol=MAP_ATOL)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _images(seed, shape, smooth=False):
    """``preds`` and a noisy ``target`` in [0, 1]: uniform noise, or with
    ``smooth`` a sum of six random low-frequency sinusoids around 0.5."""
    rng = np.random.RandomState(seed)
    if smooth:
        axes = [np.arange(n).reshape([-1 if a == i else 1 for a in range(len(shape) - 2)]) / n
                for i, n in enumerate(shape[2:])]
        preds = np.full(shape, 0.5)
        for _ in range(6):
            phase = sum(rng.uniform(0.5, 4) * ax for ax in axes) + rng.uniform(0, 6)
            preds = preds + rng.uniform(0.05, 0.2, shape[:2] + (1,) * len(axes)) * np.sin(2 * np.pi * phase)
        preds = np.clip(preds, 0.0, 1.0)
    else:
        preds = rng.rand(*shape)
    target = np.clip(preds + 0.02 * rng.randn(*shape), 0.0, 1.0)
    return preds.astype(np.float32), target.astype(np.float32)


def _both(name, preds, target, **kw):
    port = getattr(functional, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    ref = getattr(jax_functional, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
    return port, ref


SSIM_CASES = {
    "default": {},
    "uniform": {"gaussian_kernel": False, "kernel_size": 7},
    "uniform_tuple": {"gaussian_kernel": False, "kernel_size": (5, 9)},
    "sigma_tuple": {"sigma": (1.0, 2.0)},
    "data_range_float": {"data_range": 1.0},
    "data_range_tuple": {"data_range": (0.1, 0.9)},
    "k1_k2": {"k1": 0.05, "k2": 0.1, "data_range": 1.0},
    "sum": {"reduction": "sum"},
    "none": {"reduction": "none"},
    "full_image": {"return_full_image": True, "reduction": None},
    "contrast_sensitivity": {"return_contrast_sensitivity": True},
}


@pytest.mark.parametrize("smooth", [False, True], ids=["random", "smooth"])
@pytest.mark.parametrize("case", list(SSIM_CASES))
def test_ssim_2d_matches_jax(case, smooth):
    preds, target = _images(len(case), (2, 3, 32, 40), smooth)
    _assert_close(*_both("structural_similarity_index_measure", preds, target, **SSIM_CASES[case]))


@pytest.mark.parametrize("smooth", [False, True], ids=["random", "smooth"])
@pytest.mark.parametrize(
    "kw",
    [{}, {"gaussian_kernel": False, "kernel_size": 5}, {"data_range": (0.0, 1.0), "reduction": "none"}, {"return_contrast_sensitivity": True}],
    ids=["default", "uniform", "data_range_tuple", "contrast_sensitivity"],
)
def test_ssim_3d_matches_jax(kw, smooth):
    preds, target = _images(5, (2, 2, 14, 16, 18), smooth)
    _assert_close(*_both("structural_similarity_index_measure", preds, target, sigma=1.0, **kw))


MS_CASES = {
    "two_scales": {"betas": (0.5, 0.5)},
    "three_scales": {"betas": (0.2, 0.3, 0.5)},
    "simple": {"betas": (0.2, 0.3, 0.5), "normalize": "simple"},
    "no_normalize": {"betas": (0.2, 0.3, 0.5), "normalize": None},
    "uniform": {"betas": (0.5, 0.5), "gaussian_kernel": False, "kernel_size": 7},
    "data_range": {"betas": (0.5, 0.5), "data_range": 1.0, "reduction": "none"},
    "sum": {"betas": (0.5, 0.5), "reduction": "sum"},
}


@pytest.mark.parametrize("smooth", [False, True], ids=["random", "smooth"])
@pytest.mark.parametrize("case", list(MS_CASES))
def test_ms_ssim_matches_jax(case, smooth):
    preds, target = _images(len(case) + 1, (2, 2, 48, 52), smooth)
    _assert_close(*_both("multiscale_structural_similarity_index_measure", preds, target, **MS_CASES[case]))


def test_ms_ssim_default_five_scales_matches_jax():
    preds, target = _images(9, (1, 2, 161, 170), smooth=True)
    _assert_close(*_both("multiscale_structural_similarity_index_measure", preds, target, data_range=1.0))


@pytest.mark.parametrize(
    "name,kw,shape",
    [
        ("structural_similarity_index_measure", {}, (2, 3, 32)),
        ("structural_similarity_index_measure", {"kernel_size": 4, "gaussian_kernel": False}, (1, 1, 16, 16)),
        ("structural_similarity_index_measure", {"sigma": -1.0}, (1, 1, 16, 16)),
        ("structural_similarity_index_measure", {"kernel_size": (3, 3, 3)}, (1, 1, 16, 16)),
        ("multiscale_structural_similarity_index_measure", {}, (1, 1, 64, 64)),  # too small for 5 scales
        ("multiscale_structural_similarity_index_measure", {"betas": [0.5, 0.5]}, (1, 1, 64, 64)),
        ("multiscale_structural_similarity_index_measure", {"betas": (0.5, 0.5), "normalize": "x"}, (1, 1, 64, 64)),
    ],
)
def test_inputs_refused_as_in_jax(name, kw, shape):
    preds, target = _images(1, shape)
    with pytest.raises(ValueError):
        getattr(jax_functional, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
    with pytest.raises(ValueError):
        getattr(functional, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)


CLASS_CASES = {
    "ssim": ("StructuralSimilarityIndexMeasure", {}),
    "ssim_data_range": ("StructuralSimilarityIndexMeasure", {"data_range": 1.0}),
    "ssim_sum": ("StructuralSimilarityIndexMeasure", {"reduction": "sum"}),
    "ssim_none": ("StructuralSimilarityIndexMeasure", {"reduction": "none"}),
    "ssim_full_image": ("StructuralSimilarityIndexMeasure", {"return_full_image": True}),
    "ssim_contrast": ("StructuralSimilarityIndexMeasure", {"return_contrast_sensitivity": True, "reduction": None}),
    "ms_ssim": ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (0.3, 0.7)}),
    "ms_ssim_sum": ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (0.3, 0.7), "reduction": "sum"}),
    "ms_ssim_none": ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (0.3, 0.3, 0.4), "reduction": "none", "normalize": "simple"}),
}


@pytest.mark.parametrize("case", list(CLASS_CASES))
def test_class_over_several_updates_matches_jax(case):
    cls, kw = CLASS_CASES[case]
    port = getattr(image, cls)(**kw, device="cpu")
    ref = getattr(jax_image, cls)(**kw, executor=False)
    for seed in range(3):
        preds, target = _images(seed + len(case), (2, 2, 44, 48), smooth=seed == 1)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port.compute(), ref.compute())
    assert float(port.total) == float(ref.total) == 6.0


def test_ssim_is_differentiable_through_the_window():
    """The gradient of SSIM flows through the windowed sums (the plain body
    here, the kernel's backward on the card)."""
    preds, target = _images(2, (1, 1, 24, 24))
    p = torch.from_numpy(preds).requires_grad_()
    before = ssim_kernel.launches
    value = functional.structural_similarity_index_measure(p, torch.from_numpy(target), data_range=1.0)
    value.backward()
    assert p.grad is not None and bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().sum()) > 0
    assert ssim_kernel.launches == before


@pytest.mark.parametrize(
    "shape,kw",
    [((1, 1, 5, 8), {}), ((1, 1, 5, 8, 12), {}), ((1, 2, 9, 6), {"data_range": 1.0, "reduction": "none"})],
    ids=["2d", "3d", "2d_none"],
)
def test_image_no_larger_than_the_padding_gives_nan_as_in_jax(shape, kw):
    """A pad as large as its axis reflects numpy-style (``jnp.pad``), and the
    crop then leaves no pixel: NaN in both packages, where ``F.pad`` alone
    would refuse the pad."""
    preds, target = _images(3, shape)
    port, ref = _both("structural_similarity_index_measure", preds, target, **kw)
    assert np.isnan(_to_numpy(ref)).all()
    assert np.isnan(_to_numpy(port)).all() and _to_numpy(port).shape == _to_numpy(ref).shape


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("pad", [0, 1, 4, 5, 9, 13])
def test_reflect_pad_equals_jnp_pad_for_any_pad(n, pad):
    from torchmetrics_tpu_torch.functional.image.utils import _reflect_pad_2d

    x = np.random.RandomState(n * 31 + pad).rand(1, 2, n, n + 1).astype(np.float32)
    ref = np.asarray(jnp.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="reflect"))
    np.testing.assert_array_equal(_reflect_pad_2d(torch.from_numpy(x), pad, pad).numpy(), ref)
