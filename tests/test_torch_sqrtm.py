"""The port's ``fid_sqrtm`` bodies against the JAX package's.

The same numpy covariances go through both packages on the CPU:

- the port's Newton–Schulz body (``_sqrtm_ns_reference``, the kernel's
  oracle on the card) against JAX's Pallas kernel in interpret mode. JAX pads
  F to a multiple of 128 with an identity block, the port does not: padding
  is exact, so F = 48, 100 and 200 check that both give one result. Both are
  16 float32 steps whose products sum in another order; the largest
  difference seen is 2e-6 of max |ref|, held to 1e-5;
- the port's eigh body (the CPU body of the seam) against JAX's, both
  LAPACK ``eigh`` in float32: held to 1e-5 of max |ref|.

Covariances have a power-law spectrum (eigenvalues about i^-1), 3F samples.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.ops.sqrtm_kernel as jax_sqrtm
from torchmetrics_tpu_torch.ops import kernels, sqrtm_kernel

TOL = 1e-5


def _cov(f, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f) * np.arange(1, f + 1) ** -0.5
    return np.cov(x, rowvar=False).astype(np.float32)


def _assert_close_scaled(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("f", [48, 100, 128, 200])
def test_newton_schulz_body_matches_pallas_interpret(f):
    a = _cov(f, 3 * f, f)
    port = sqrtm_kernel._sqrtm_ns_reference(torch.from_numpy(a))
    ref = jax_sqrtm._sqrtm_pallas(jnp.asarray(a), interpret=True)
    assert port.dtype == torch.float32
    _assert_close_scaled(port.numpy(), ref)


@pytest.mark.parametrize("f", [16, 100, 257])
def test_eigh_body_matches_jax_reference(f):
    a = _cov(f, 3 * f, f + 1)
    _assert_close_scaled(sqrtm_kernel._sqrtm_reference(torch.from_numpy(a)).numpy(), jax_sqrtm._sqrtm_reference(jnp.asarray(a)))


def test_newton_schulz_body_converges_to_the_root():
    """16 steps on a well-conditioned covariance: the square of the result
    is the input within 1e-5 relative (Frobenius)."""
    a = torch.from_numpy(_cov(64, 640, 3)).double()
    y = sqrtm_kernel._sqrtm_ns_reference(a.float()).double()
    assert float(torch.linalg.norm(y @ y - a) / torch.linalg.norm(a)) < 1e-5


def test_sqrtm_psd_on_cpu_takes_the_reference_path():
    kernels.reset_gate_log()
    a = torch.from_numpy(_cov(8, 24, 0))
    out = sqrtm_kernel.sqrtm_psd(a)
    assert kernels.gate_snapshot()["fid_sqrtm"]["path"] == "reference"
    assert torch.equal(out, sqrtm_kernel._sqrtm_reference(a))


def test_sqrtm_psd_takes_float64_and_strided_input_as_float32():
    a = torch.from_numpy(_cov(8, 24, 1)).double().T
    assert sqrtm_kernel.sqrtm_psd(a).dtype == torch.float32


@pytest.mark.parametrize("body", ["_sqrtm_ns_reference", "_sqrtm_reference"])
def test_rank_deficient_input_stays_finite(body):
    """3 samples of 32 features: rank 2. Both bodies stay finite, and so does
    the JAX kernel."""
    a = _cov(32, 3, 1)
    assert bool(torch.isfinite(getattr(sqrtm_kernel, body)(torch.from_numpy(a))).all())
    assert bool(jnp.isfinite(jax_sqrtm._sqrtm_pallas(jnp.asarray(a), interpret=True)).all())


def test_step_count_is_the_jax_packages():
    assert sqrtm_kernel.NS_ITERS == jax_sqrtm.NS_ITERS == 16


def test_cuda_body_refuses_a_cpu_tensor_without_launching():
    before = sqrtm_kernel.launches
    with pytest.raises(ValueError, match="CUDA device"):
        sqrtm_kernel._sqrtm_cuda(torch.eye(4))
    with pytest.raises(TypeError, match="float32"):
        sqrtm_kernel._sqrtm_cuda(torch.eye(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="square"):
        sqrtm_kernel._sqrtm_cuda(torch.ones(3, 4))
    assert sqrtm_kernel.launches == before
