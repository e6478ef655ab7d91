"""The port's ``ssim_windows`` plain body against the JAX package's bodies.

The same numpy planes and taps go through the port's ``windowed_sum_2d``
(the plain body on the CPU) and the JAX package's Pallas kernel in
interpret mode, fed JAX's band matrices built from the same taps: within
rtol/atol 2e-6, the tolerance the JAX package holds its own two bodies to
(float32 products summed in another order). Above an edge of 2048 both
sides switch to two 1-D convolutions; that branch is held to JAX's grouped
convolutions the same way.

The CUDA body's backward pass is the same correlation over the zero-padded
output gradient with reversed taps. That formula is checked here on the
plain body against ``torch.autograd``; the kernel runs it on the card
(tests/test_torch_cuda.py). On the CPU the CUDA wrapper only checks its
arguments, so its refusals are tested here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchmetrics_tpu.functional.image.utils import _band_matrix as jax_band_matrix
from torchmetrics_tpu.functional.image.utils import _gaussian as jax_gaussian
from torchmetrics_tpu.functional.image.utils import _grouped_conv1d_axis
from torchmetrics_tpu.ops.ssim_kernel import _windowed_pallas
from torchmetrics_tpu_torch.functional.image.utils import _gaussian
from torchmetrics_tpu_torch.ops import kernels, ssim_kernel

TOL = 2e-6


def _taps(kind, k):
    if kind == "gaussian":
        return np.array(jax_gaussian(k, 1.5 if k == 11 else 1.0), np.float32)
    if kind == "uniform":
        return np.full(k, 1.0 / k, np.float32)
    return np.random.RandomState(k).rand(k).astype(np.float32)


CASES = {
    "gaussian11": ((10, 44, 52), "gaussian", 11, "gaussian", 11),
    "gaussian7": ((6, 30, 27), "gaussian", 7, "gaussian", 7),
    "uniform7x5": ((4, 33, 40), "uniform", 7, "uniform", 5),
    "random_taps": ((3, 21, 64), "random", 9, "random", 3),
    "one_tap": ((2, 8, 9), "random", 1, "random", 1),
    "window_is_the_plane": ((2, 11, 11), "gaussian", 11, "gaussian", 11),
}


@pytest.mark.parametrize("smooth", [False, True], ids=["random", "smooth"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_body_matches_jax_pallas_body(name, smooth):
    shape, kind_h, kh, kind_w, kw = CASES[name]
    rng = np.random.RandomState(len(name))
    x = rng.rand(*shape).astype(np.float32)
    if smooth:  # slowly varying planes, where E[x^2] - mu^2 cancels most
        x = np.cumsum(np.cumsum(x, axis=1), axis=2) / (shape[1] * shape[2])
        x = x.astype(np.float32)
    g_h, g_w = _taps(kind_h, kh), _taps(kind_w, kw)
    port = ssim_kernel.windowed_sum_2d(torch.from_numpy(x), torch.from_numpy(g_h), torch.from_numpy(g_w)).numpy()
    bh = jax_band_matrix(jnp.asarray(g_h), shape[1] - kh + 1)
    bw = jax_band_matrix(jnp.asarray(g_w), shape[2] - kw + 1)
    ref = np.asarray(_windowed_pallas(jnp.asarray(x), bh, bw, interpret=True))
    assert port.shape == ref.shape == (shape[0], shape[1] - kh + 1, shape[2] - kw + 1)
    np.testing.assert_allclose(port, ref, rtol=TOL, atol=TOL)


def test_band_matrices_equal_jax():
    g = _taps("random", 5)
    port = ssim_kernel._band_matrix(torch.from_numpy(g), 9).numpy()
    np.testing.assert_array_equal(port, np.asarray(jax_band_matrix(jnp.asarray(g), 9)))


@pytest.mark.parametrize("k,sigma", [(11, 1.5), (7, 1.0), (15, 2.0)])
def test_gaussian_taps_match_jax(k, sigma):
    np.testing.assert_allclose(_gaussian(k, sigma).numpy(), np.asarray(jax_gaussian(k, sigma)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 16, 2100), (1, 2060, 24)])
def test_conv_branch_above_2048_matches_jax(shape):
    rng = np.random.RandomState(shape[1])
    x = rng.rand(*shape).astype(np.float32)
    g_h, g_w = _taps("gaussian", 11), _taps("uniform", 7)
    port = ssim_kernel.windowed_sum_2d(torch.from_numpy(x), torch.from_numpy(g_h), torch.from_numpy(g_w)).numpy()
    out = _grouped_conv1d_axis(jnp.asarray(x)[None], jnp.asarray(g_h), 2)
    ref = np.asarray(_grouped_conv1d_axis(out, jnp.asarray(g_w), 3))[0]
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["gaussian11", "uniform7x5", "random_taps"])
def test_backward_formula_equals_autograd(name):
    """The input gradient of the valid correlation is the correlation of the
    zero-padded output gradient with reversed taps, which the CUDA body
    computes with a second launch of the same kernel."""
    shape, kind_h, kh, kind_w, kw = CASES[name]
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).requires_grad_()
    g_h, g_w = torch.from_numpy(_taps(kind_h, kh)), torch.from_numpy(_taps(kind_w, kw))
    y = ssim_kernel._windowed_reference(x, g_h, g_w)
    grad = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    (autograd,) = torch.autograd.grad(y, x, grad)
    padded = F.pad(grad, (kw - 1, kw - 1, kh - 1, kh - 1))
    formula = ssim_kernel._windowed_reference(padded, g_h.flip(0), g_w.flip(0))
    torch.testing.assert_close(formula, autograd, rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_body():
    kernels.reset_gate_log()
    before = ssim_kernel.launches
    ssim_kernel.windowed_sum_2d(torch.rand(2, 12, 12), torch.ones(3) / 3, torch.ones(3) / 3)
    assert kernels.gate_snapshot()["ssim_windows"]["path"] == "reference"
    assert ssim_kernel.launches == before


def _wrapper_args():
    return torch.rand(2, 12, 12), torch.ones(3) / 3, torch.ones(5) / 5


@pytest.mark.parametrize(
    "change,error",
    [
        ({0: torch.rand(2, 12, 12, dtype=torch.float64)}, TypeError),
        ({1: torch.ones(3, dtype=torch.float64)}, TypeError),
        ({0: torch.rand(12, 12)}, ValueError),
        ({2: torch.ones(1, 5)}, ValueError),
        ({0: torch.rand(2, 12, 24)[:, :, ::2]}, ValueError),  # not contiguous
        ({1: torch.ones(13)}, ValueError),  # more taps than rows
        ({}, ValueError),  # CPU tensors: the kernel runs on the card only
    ],
)
def test_kernel_wrapper_refuses_what_it_does_not_take(change, error):
    args = list(_wrapper_args())
    for i, value in change.items():
        args[i] = value
    before = ssim_kernel.launches
    with pytest.raises(error):
        ssim_kernel._windowed_cuda(*args)
    assert ssim_kernel.launches == before
