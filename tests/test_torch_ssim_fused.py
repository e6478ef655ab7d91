"""The fused SSIM entry's plain version against the JAX package.

2-D SSIM without a gradient goes through the ``"ssim_fused"`` entry of the
dispatch seam (ops/ssim_kernel.py): one kernel launch on the card, and on
the CPU its plain version, the chain of reflect padding, five-plane stack,
plain window, formula and cropped means. The same seeded numpy images go
through the port's ``_ssim_update`` (which must dispatch to that entry) and
the JAX package's ``_ssim_update``. With a gradient the port takes the
generic ``"ssim_windows"`` entry instead; that route is checked here too.

Tolerances, as in tests/test_torch_ssim.py: float32 moments summed in
another order, and gaussian taps up to 3e-8 apart (``exp`` rounding), so
per-image values within rtol 1e-5, atol 2e-6, and the per-pixel map within
atol 2e-4 (a pixel of near-zero local variance divides a rounding difference
by almost nothing).

The reflect index the kernel folds by (``functional/image/utils.py:
_reflect_index``) is held to ``jnp.pad(mode="reflect")`` for every pad,
pads at least as long as the axis included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional as jax_functional
from torchmetrics_tpu.functional.image.ssim import _ssim_update as jax_ssim_update
from torchmetrics_tpu_torch.functional import multiscale_structural_similarity_index_measure
from torchmetrics_tpu_torch.functional.image.ssim import _ssim_update
from torchmetrics_tpu_torch.functional.image.utils import _reflect_index
from torchmetrics_tpu_torch.ops import kernels, ssim_kernel

RTOL = 1e-5
ATOL = 2e-6
MAP_ATOL = 2e-4


def _images(seed, shape):
    rng = np.random.RandomState(seed)
    preds = rng.rand(*shape)
    target = np.clip(preds + 0.05 * rng.randn(*shape), 0.0, 1.0)
    return preds.astype(np.float32), target.astype(np.float32)


def _assert_close(port, ref):
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p, r = p.numpy().astype(np.float64), np.asarray(r).astype(np.float64)
        assert p.shape == r.shape, (p.shape, r.shape)
        if p.ndim > 1:
            np.testing.assert_allclose(p, r, rtol=0, atol=MAP_ATOL)
        else:
            np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


def _fused_calls():
    return kernels.gate_snapshot().get("ssim_fused", {}).get("selections", {}).get("reference", 0)


FUSED_CASES = {
    "gaussian_float": ({"data_range": 1.0}, (2, 3, 40, 44)),
    "gaussian_tuple": ({"data_range": (0.1, 0.9)}, (2, 3, 40, 44)),
    "gaussian_none": ({"data_range": None}, (2, 3, 40, 44)),
    "uniform_float": ({"gaussian_kernel": False, "kernel_size": 7, "data_range": 1.0}, (2, 2, 36, 50)),
    "uniform_none": ({"gaussian_kernel": False, "kernel_size": (5, 9)}, (1, 3, 33, 41)),
    "sigma_tuple": ({"sigma": (1.0, 2.5)}, (2, 2, 38, 42)),
    "sigma_9_3": ({"sigma": 9.3, "data_range": 1.0}, (1, 1, 96, 96)),  # 67 taps
}
OUTPUTS = {
    "per_image": {},
    "full_image": {"return_full_image": True},
    "contrast_sensitivity": {"return_contrast_sensitivity": True},
}


@pytest.mark.parametrize("output", list(OUTPUTS))
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_plain_version_matches_jax(case, output):
    kw, shape = FUSED_CASES[case]
    kw = dict(kw, **OUTPUTS[output])
    preds, target = _images(len(case) + len(output), shape)
    kernels.reset_gate_log()
    port = _ssim_update(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    assert _fused_calls() == 1 and "ssim_windows" not in kernels.gate_snapshot()
    _assert_close(port, jax_ssim_update(jnp.asarray(preds), jnp.asarray(target), **kw))


@pytest.mark.parametrize("betas", [(0.5, 0.5), (0.2, 0.3, 0.5)], ids=["two_scales", "three_scales"])
def test_ms_ssim_takes_one_fused_call_a_scale(betas):
    preds, target = _images(len(betas), (2, 2, 60, 64))
    kernels.reset_gate_log()
    port = multiscale_structural_similarity_index_measure(
        torch.from_numpy(preds), torch.from_numpy(target), betas=betas, reduction="none"
    )
    assert _fused_calls() == len(betas)
    ref = jax_functional.multiscale_structural_similarity_index_measure(
        jnp.asarray(preds), jnp.asarray(target), betas=betas, reduction="none"
    )
    _assert_close(port, ref)


@pytest.mark.parametrize("shape", [(1, 1, 5, 8), (1, 2, 9, 6), (2, 1, 1, 30)], ids=["5x8", "9x6", "1x30"])
def test_image_no_larger_than_the_padding_gives_nan_through_the_fused_entry(shape):
    preds, target = _images(4, shape)
    kernels.reset_gate_log()
    port = _ssim_update(torch.from_numpy(preds), torch.from_numpy(target), data_range=1.0)
    ref = jax_ssim_update(jnp.asarray(preds), jnp.asarray(target), data_range=1.0)
    assert _fused_calls() == 1
    assert np.isnan(np.asarray(ref)).all() and bool(torch.isnan(port).all())
    assert tuple(port.shape) == np.asarray(ref).shape


@pytest.mark.parametrize("output", list(OUTPUTS))
def test_zero_channels_give_nan_as_in_jax(output):
    """C = 0: no pixel to average, so NaN per image in both packages (the
    fused entry's card path divides its empty sums by zero alike)."""
    kw = dict(data_range=1.0, **OUTPUTS[output])
    preds = np.zeros((2, 0, 32, 36), dtype=np.float32)
    kernels.reset_gate_log()
    port = _ssim_update(torch.from_numpy(preds), torch.from_numpy(preds), **kw)
    ref = jax_ssim_update(jnp.asarray(preds), jnp.asarray(preds), **kw)
    assert _fused_calls() == 1
    port, ref = (port, ref) if isinstance(port, tuple) else ((port,), (ref,))
    assert bool(torch.isnan(port[0]).all()) and np.isnan(np.asarray(ref[0])).all()
    for p, r in zip(port, ref):
        assert tuple(p.shape) == np.asarray(r).shape


def test_ms_ssim_with_zero_channels_gives_nan_as_in_jax():
    preds = np.zeros((2, 0, 200, 200), dtype=np.float32)
    port = multiscale_structural_similarity_index_measure(
        torch.from_numpy(preds), torch.from_numpy(preds), data_range=1.0, reduction="none"
    )
    ref = jax_functional.multiscale_structural_similarity_index_measure(
        jnp.asarray(preds), jnp.asarray(preds), data_range=1.0, reduction="none"
    )
    assert tuple(port.shape) == np.asarray(ref).shape == (2,)
    assert bool(torch.isnan(port).all()) and np.isnan(np.asarray(ref)).all()


@pytest.mark.parametrize("grad", [False, True], ids=["fused", "generic"])
def test_empty_batch_gives_no_images_on_either_route(grad):
    """B = 0 (where the JAX package raises ZeroDivisionError): an empty
    per-image result and an empty map, through either route, as the card's
    wrappers give it."""
    preds = torch.zeros((0, 3, 32, 36), requires_grad=grad)
    kernels.reset_gate_log()
    per_image, full = _ssim_update(preds, torch.zeros((0, 3, 32, 36)), data_range=1.0, return_full_image=True)
    gate = kernels.gate_snapshot()
    assert ("ssim_windows" in gate) == grad and ("ssim_fused" in gate) != grad
    assert tuple(per_image.shape) == (0,) and tuple(full.shape) == (0, 3, 32, 36)


@pytest.mark.parametrize("n", list(range(1, 10)))
def test_reflect_index_equals_jnp_pad_for_every_pad(n):
    axis = np.arange(n)
    for pad in range(0, 3 * n + 4):
        ref = np.asarray(jnp.pad(jnp.asarray(axis), pad, mode="reflect"))
        np.testing.assert_array_equal(axis[_reflect_index(n, pad, "cpu").numpy()], ref, err_msg=f"n={n} pad={pad}")


def test_a_gradient_takes_the_generic_chain():
    """With an input that requires grad the stack goes through the generic
    ``ssim_windows`` entry (whose backward is the kernel on the card), the
    gradient flows, and the value equals the fused entry's."""
    preds, target = _images(6, (1, 2, 30, 34))
    p = torch.from_numpy(preds).requires_grad_()
    kernels.reset_gate_log()
    value = _ssim_update(p, torch.from_numpy(target), data_range=1.0)
    gate = kernels.gate_snapshot()
    assert gate["ssim_windows"]["selections"] == {"reference": 1} and "ssim_fused" not in gate
    value.sum().backward()
    assert bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().sum()) > 0
    with torch.no_grad():
        fused = _ssim_update(p, torch.from_numpy(target), data_range=1.0)
    assert _fused_calls() == 1
    torch.testing.assert_close(value.detach(), fused, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "preds,target,err,match",
    [
        (torch.zeros(1, 1, 8, 8, dtype=torch.float64), torch.zeros(1, 1, 8, 8, dtype=torch.float64), TypeError, "float32"),
        (torch.zeros(1, 1, 8, 16)[..., ::2], torch.zeros(1, 1, 8, 8), ValueError, "contiguous"),
        (torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 8, 8), ValueError, "CUDA device"),
    ],
    ids=["dtype", "strided", "cpu"],
)
def test_fused_cuda_wrapper_refuses_without_launching(preds, target, err, match):
    taps = torch.full((3,), 1.0 / 3)
    before = ssim_kernel.launches
    with pytest.raises(err, match=match):
        ssim_kernel._ssim_fused_cuda(preds, target, taps, taps, 1, 1, 1e-4, 9e-4, False)
    assert ssim_kernel.launches == before
