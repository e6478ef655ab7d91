"""The PyTorch port's ``bincount`` kernel module against the JAX package.

The same numpy inputs (negative and out-of-range indices mixed in) go through
the JAX Pallas kernel in interpret mode, the JAX reference body and the
port's plain body; on CPU tensors the port's dispatch serves the plain body.
Integer counts must agree exactly; float-weighted rows within rtol=1e-5
(scatter order differs between the bodies). The CUDA kernel itself is
tested on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.ops.bincount import _wbincount_pallas
from torchmetrics_tpu.ops.bincount import _wbincount_reference as jax_wbincount_reference
from torchmetrics_tpu.ops.bincount import weighted_bincount as jax_weighted_bincount
from torchmetrics_tpu.ops.bincount import weighted_bincount_multi as jax_weighted_bincount_multi
from torchmetrics_tpu_torch.ops import bincount, kernels, native


def _case(seed, n, length, k=1, weighted=False):
    rng = np.random.RandomState(seed)
    spread = max(1, length // 10)
    x = rng.randint(-spread, length + spread, n).astype(np.int32)
    w = rng.rand(k, n).astype(np.float32) if weighted else np.ones((k, n), np.float32)
    return x, w


@pytest.mark.parametrize("n,length", [(3000, 50), (4000, 4), (777, 361), (257, 1000)])
def test_counts_match_jax_exactly(n, length):
    x, w = _case(n, n, length)
    port = bincount._wbincount_reference(torch.from_numpy(x), torch.from_numpy(w), length)
    assert port.dtype == torch.float32 and tuple(port.shape) == (1, length)
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_wbincount_reference(jnp.asarray(x), jnp.asarray(w), length)))
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(_wbincount_pallas(jnp.asarray(x), jnp.asarray(w), length, interpret=True))
    )


@pytest.mark.parametrize("n,length", [(3000, 50), (4000, 4), (777, 361), (257, 1000), (5, 3)])
def test_weightless_counts_match_jax_unit_weights(n, length):
    """``weights=None`` counts every in-range index once, as int64: equal to
    JAX's bodies fed a row of ones, negative and out-of-range indices dropped."""
    x, w = _case(n + 1, n, length)
    port = bincount._wbincount_reference(torch.from_numpy(x), None, length)
    assert port.dtype == torch.int64 and tuple(port.shape) == (1, length)
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_wbincount_reference(jnp.asarray(x), jnp.asarray(w), length)))
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(_wbincount_pallas(jnp.asarray(x), jnp.asarray(w), length, interpret=True))
    )
    assert int(port.sum()) == int(((x >= 0) & (x < length)).sum())


#: one update past float32's last exact integer: 2**24 + 3 events in one bin
PAST_2_24 = 2**24 + 3


def test_weightless_counts_are_exact_past_2_24():
    """Weightless counts are int64 sums of ones: exact where float32 ones
    stop at 2**24 (the JAX package's float32 sums give 16,777,216 here)."""
    x = np.zeros(PAST_2_24, dtype=np.int32)
    want = np.bincount(x, minlength=2)
    plain = bincount._wbincount_reference(torch.from_numpy(x), None, 2)
    assert plain.dtype == torch.int64 and plain[0].tolist() == want.tolist() == [PAST_2_24, 0]
    public = bincount.weighted_bincount(torch.from_numpy(x), length=2)
    assert public.dtype == torch.int32 and public.tolist() == want.tolist()


@pytest.mark.parametrize("path", ["multiclass_functional", "binary_functional", "multiclass_class", "binary_stat_scores"])
def test_confusion_counts_are_exact_past_2_24(path):
    """``preds = target = zeros(2**24 + 3)``: every counting path of the
    port (the weightless bincount, the unfused integer scatter, the fused
    counts) gives the true 16,777,219 in cell (0, 0)."""
    import torchmetrics_tpu_torch.classification as classification
    import torchmetrics_tpu_torch.functional.classification as F

    x = torch.zeros(PAST_2_24, dtype=torch.int32)
    if path == "multiclass_functional":
        got = int(F.multiclass_confusion_matrix(x, x, num_classes=2, validate_args=False)[0, 0])
    elif path == "binary_functional":
        got = int(F.binary_confusion_matrix(x, x, validate_args=False)[0, 0])
    elif path == "multiclass_class":
        metric = classification.MulticlassConfusionMatrix(num_classes=2, validate_args=False, device="cpu")
        metric.update(x, x)
        got = int(metric.compute()[0, 0])
    else:
        metric = classification.BinaryStatScores(validate_args=False, device="cpu")
        metric.update(x, x)
        got = int(metric.compute()[2])  # (tp, fp, tn, fn, support)
    assert got == int(np.bincount(x.numpy())[0]) == PAST_2_24


def test_float_weighted_rows_match_jax():
    x, w = _case(0, 4000, 290, k=3, weighted=True)
    port = bincount._wbincount_reference(torch.from_numpy(x), torch.from_numpy(w), 290).numpy()
    np.testing.assert_allclose(port, np.asarray(jax_wbincount_reference(jnp.asarray(x), jnp.asarray(w), 290)), rtol=1e-5)
    np.testing.assert_allclose(
        port, np.asarray(_wbincount_pallas(jnp.asarray(x), jnp.asarray(w), 290, interpret=True)), rtol=1e-5
    )


def test_weighted_bincount_public_wrappers_match_jax():
    x, w = _case(3, 500, 40, k=3, weighted=True)
    counts = bincount.weighted_bincount(torch.from_numpy(x), length=40)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jax_weighted_bincount(jnp.asarray(x), length=40)))
    weighted = bincount.weighted_bincount(torch.from_numpy(x), torch.from_numpy(w[0]), length=40)
    assert weighted.dtype == torch.float32
    np.testing.assert_allclose(
        weighted.numpy(), np.asarray(jax_weighted_bincount(jnp.asarray(x), jnp.asarray(w[0]), length=40)), rtol=1e-5
    )
    multi = bincount.weighted_bincount_multi(torch.from_numpy(x), torch.from_numpy(w), 40)
    np.testing.assert_allclose(
        multi.numpy(), np.asarray(jax_weighted_bincount_multi(jnp.asarray(x), jnp.asarray(w), 40)), rtol=1e-5
    )
    with pytest.raises(ValueError, match="weights must be"):
        bincount.weighted_bincount_multi(torch.from_numpy(x), torch.from_numpy(w[:, :10]), 40)


def test_cpu_tensors_dispatch_to_the_plain_body():
    kernels.reset_gate_log()
    before = bincount.launches
    bincount.weighted_bincount(torch.tensor([0, 1, 1, 3]), length=4)
    gate = kernels.gate_snapshot()["bincount"]
    assert gate["path"] == "reference" and gate["device"] == "cpu"
    assert gate["selections"] == {"reference": 1}
    assert bincount.launches == before  # the plain body never counts as a launch
    spec = kernels.get_kernel("bincount")
    assert spec.reference is bincount._wbincount_reference and spec.cuda is bincount._wbincount_cuda


def test_dispatch_refuses_other_devices():
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        kernels.dispatch("bincount", torch.empty(4, dtype=torch.int32, device="meta"), torch.empty((1, 4), device="meta"), 4)


@pytest.mark.parametrize(
    "x,w,length,err,match",
    [
        (torch.zeros(4, dtype=torch.int64), torch.ones((1, 4)), 4, TypeError, "int32"),
        (torch.zeros(4, dtype=torch.int32), torch.ones((1, 4), dtype=torch.float64), 4, TypeError, "float32"),
        (torch.zeros(4, dtype=torch.int32), torch.ones((1, 5)), 4, ValueError, r"\(K, N\)"),
        (torch.zeros(4, dtype=torch.int32), torch.ones((1, 8))[:, ::2], 4, ValueError, "contiguous"),
        (torch.zeros(4, dtype=torch.int32), torch.ones((1, 4)), 0, ValueError, "length"),
        (torch.zeros(4, dtype=torch.int32), torch.ones((1, 4)), 4, ValueError, "CUDA device"),
    ],
)
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(x, w, length, err, match):
    before = bincount.launches
    with pytest.raises(err, match=match):
        bincount._wbincount_cuda(x, w, length)
    assert bincount.launches == before


@pytest.mark.parametrize(
    "x,length,err,match",
    [
        (torch.zeros(4, dtype=torch.int64), 4, TypeError, "int32"),
        (torch.zeros((2, 2), dtype=torch.int32), 4, ValueError, r"\(N,\)"),
        (torch.zeros(8, dtype=torch.int32)[::2], 4, ValueError, "contiguous"),
        (torch.zeros(4, dtype=torch.int32), 0, ValueError, "length"),
        (torch.zeros(4, dtype=torch.int32), 4, ValueError, "CUDA device"),
    ],
)
def test_cuda_wrapper_checks_a_weightless_call_without_launching(x, length, err, match):
    """``weights=None`` reaches the CUDA body's argument checks; a CPU tensor
    is refused there, with no launch."""
    before = bincount.launches
    with pytest.raises(err, match=match):
        bincount._wbincount_cuda(x, None, length)
    assert bincount.launches == before


def test_native_build_names_the_hopper_target(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.library_path("bincount")
    assert path.parent == tmp_path and path.name.startswith("libbincount-") and path.suffix == ".so"
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", "/toolkit")
    cmd = native.nvcc_command("bincount", path)
    assert cmd[0] == "/toolkit/bin/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/bincount.cu")
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build(["bincount"])
