"""The port's ``fid_sqrtm`` bodies against the JAX package's.

The same numpy covariances go through both packages on the CPU:

- the port's Newton–Schulz body (``_sqrtm_ns_reference``, the kernel's
  oracle on the card) run as the JAX package runs it, 16 float32 steps,
  against JAX's Pallas kernel in interpret mode. JAX pads F to a multiple of
  128 with an identity block, the port does not: padding is exact, so F =
  48, 100 and 200 check that both give one result. Their products sum in
  another order; the largest difference seen is 2e-6 of max |ref|, held to
  1e-5;
- the port's eigh body (the CPU body of the seam) against JAX's, both
  LAPACK ``eigh`` in float32: held to 1e-5 of max |ref|;
- FID on a covariance with one dominant mode, where 16 float32 steps (JAX's
  kernel and the port's body alike) miss float64 by more than 1e-3 and the
  card's float64 steps (``KERNEL_ITERS``) come within 1e-4.

Covariances have a power-law spectrum (eigenvalues about i^-1), 3F samples,
unless a test says otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.ops.sqrtm_kernel as jax_sqrtm
from torchmetrics_tpu_torch.image.fid import _fid_from_root
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
    port = sqrtm_kernel._sqrtm_ns_reference(torch.from_numpy(a), iters=sqrtm_kernel.NS_ITERS, dtype=torch.float32)
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
    y = sqrtm_kernel._sqrtm_ns_reference(a.float(), iters=sqrtm_kernel.NS_ITERS, dtype=torch.float32).double()
    assert float(torch.linalg.norm(y @ y - a) / torch.linalg.norm(a)) < 1e-5


@pytest.mark.parametrize("f", [64, 200])
def test_float64_body_matches_the_float64_eigh_root(f):
    """The card's iteration (KERNEL_ITERS float64 steps) on a full-rank
    covariance: float64 out, within 1e-10 of max |ref| of the float64 eigh
    root, where 16 float32 steps are about 1e-6 away."""
    a = torch.from_numpy(_cov(f, 3 * f, f + 2)).double()
    e, v = torch.linalg.eigh(a)
    want = (v * torch.sqrt(torch.clamp(e, min=0.0))) @ v.T
    got = sqrtm_kernel._sqrtm_ns_reference(a)
    assert got.dtype == torch.float64
    _assert_close_scaled(got.numpy(), want.numpy(), tol=1e-10)


def test_sqrtm_psd_on_cpu_takes_the_reference_path():
    kernels.reset_gate_log()
    a = torch.from_numpy(_cov(8, 24, 0))
    out = sqrtm_kernel.sqrtm_psd(a)
    assert kernels.gate_snapshot()["fid_sqrtm"]["path"] == "reference"
    assert torch.equal(out, sqrtm_kernel._sqrtm_reference(a))


def test_sqrtm_psd_takes_float64_and_strided_input_as_float32():
    a = torch.from_numpy(_cov(8, 24, 1)).double().T
    assert sqrtm_kernel.sqrtm_psd(a).dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sqrtm_psd_hands_the_seam_float64(monkeypatch, dtype):
    """The seam is handed the covariance in float64, contiguous: on the card
    the kernel takes it unrounded (FID's moments are float64); the CPU body
    rounds it to float32 itself."""
    seen = []
    real_dispatch = kernels.dispatch

    def spy(name, *args, **kwargs):
        seen.append((name, args[0].dtype, args[0].is_contiguous()))
        return real_dispatch(name, *args, **kwargs)

    monkeypatch.setattr(kernels, "dispatch", spy)
    a = torch.from_numpy(_cov(8, 24, 2)).to(dtype).T
    out = sqrtm_kernel.sqrtm_psd(a)
    assert seen == [("fid_sqrtm", torch.float64, True)]
    assert out.dtype == torch.float32  # the CPU body: float32 eigh, as the JAX package's


@pytest.mark.parametrize("body", ["_sqrtm_ns_reference", "_sqrtm_reference"])
def test_rank_deficient_input_stays_finite(body):
    """3 samples of 32 features: rank 2. Both bodies stay finite, and so does
    the JAX kernel."""
    a = _cov(32, 3, 1)
    assert bool(torch.isfinite(getattr(sqrtm_kernel, body)(torch.from_numpy(a))).all())
    assert bool(jnp.isfinite(jax_sqrtm._sqrtm_pallas(jnp.asarray(a), interpret=True)).all())


def test_step_count_is_the_jax_packages():
    """NS_ITERS is the JAX package's float32 count; the card's kernel runs
    its own float64 count, KERNEL_ITERS (chip_smoke.py's step sweep)."""
    assert sqrtm_kernel.NS_ITERS == jax_sqrtm.NS_ITERS == 16
    assert sqrtm_kernel.KERNEL_ITERS == 22


def _dominant_moments(f, n, dead, seed):
    """Mean and float32 covariance of ``n`` samples whose eigenvalues fall as
    i^-2 in a random basis, plus one mode of standard deviation 10, with the
    last ``dead`` features held at zero (chip_smoke.py's f2048_dominant recipe
    at a smaller width)."""
    q, _ = np.linalg.qr(np.random.RandomState(1000 + f).randn(f, f))
    moments = []
    for scale, shift, s in ((1.0, 0.0, seed), (1.2, 0.05, seed + 1)):
        rng = np.random.RandomState(s)
        x = scale * (rng.randn(n, f) * np.arange(1, f + 1) ** -1.0) @ q.T + shift
        x += 10.0 * scale * rng.randn(n, 1) * q[:, -1]
        x[:, f - dead:] = 0.0
        moments += [x.mean(0), np.cov(x, rowvar=False).astype(np.float32)]
    return moments


def test_dominant_mode_fault_and_its_repair():
    """F = 256, 2,000 samples, one dominant mode, 12 dead features: FID from
    16 float32 steps (JAX's Pallas kernel in interpret mode, and the port's
    body run as JAX runs it) misses float64 by more than 1e-3; from the
    card's KERNEL_ITERS float64 steps it is within 1e-4. Every root goes
    through the port's float64 trace term (``_fid_from_root``)."""
    mu1, s1, mu2, s2 = _dominant_moments(256, 2000, 12, 7)
    args = [torch.from_numpy(np.asarray(m, np.float64)) for m in (mu1, s1, mu2, s2)]
    e, v = np.linalg.eigh(s1.astype(np.float64))
    root64 = torch.from_numpy((v * np.sqrt(np.clip(e, 0.0, None))) @ v.T)
    fid64 = float(_fid_from_root(*args, root64))

    def rel(root):
        return abs(float(_fid_from_root(*args, torch.from_numpy(np.asarray(root, np.float64)))) - fid64) / fid64

    jax16 = rel(jax_sqrtm._sqrtm_pallas(jnp.asarray(s1), interpret=True))
    port16 = rel(sqrtm_kernel._sqrtm_ns_reference(torch.from_numpy(s1), iters=16, dtype=torch.float32).numpy())
    port64 = rel(sqrtm_kernel._sqrtm_ns_reference(torch.from_numpy(s1)).numpy())
    assert jax16 > 1e-3 and port16 > 1e-3
    assert port64 <= 1e-4


def test_cuda_body_refuses_a_cpu_tensor_without_launching():
    before = sqrtm_kernel.launches
    with pytest.raises(ValueError, match="CUDA device"):
        sqrtm_kernel._sqrtm_cuda(torch.eye(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float64"):
        sqrtm_kernel._sqrtm_cuda(torch.eye(4))
    with pytest.raises(ValueError, match="square"):
        sqrtm_kernel._sqrtm_cuda(torch.ones(3, 4, dtype=torch.float64))
    assert sqrtm_kernel.launches == before
