"""The port's ``retrieval_topk_stats`` plain body against both JAX bodies.

The same numpy grids (0/1 targets, ragged counts, rows with a count of 0)
go through the port's ``_topk_stats_reference`` and the JAX package's
Pallas kernel in interpret mode and its jnp body, for k in (-1, 1, 5, 200).
With 0/1 targets every sum is an integer in float32, so the three must be
bit-equal. Fractional targets (which the kernel accepts, though the metric
paths validate 0/1) agree within rtol 1e-6: the sums run in another order.
On the CPU the CUDA wrapper only checks its arguments, so its refusals are
tested here; it launches on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.ops.topk_kernel import _topk_stats_pallas
from torchmetrics_tpu.ops.topk_kernel import _topk_stats_reference as jax_reference
from torchmetrics_tpu_torch.ops import kernels, topk_kernel


def _grid(seed, q, length, binary=True, empty_rows=0):
    """A ranked target grid zero beyond each row's count, and the counts."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(1, length + 1, q).astype(np.int32)
    counts[rng.permutation(q)[:empty_rows]] = 0
    t = rng.randint(0, 2, (q, length)) if binary else rng.rand(q, length)
    t = np.where(np.arange(length)[None, :] < counts[:, None], t, 0).astype(np.float32)
    return t, counts


SHAPES = {"ragged": (37, 53, 0), "empty_rows": (24, 40, 6), "one_row": (1, 7, 0), "wide": (9, 300, 2)}


@pytest.mark.parametrize("top_k", [-1, 1, 5, 200])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_body_is_bit_equal_to_both_jax_bodies(shape, top_k):
    q, length, empty = SHAPES[shape]
    t, counts = _grid(q + length + top_k, q, length, empty_rows=empty)
    port = topk_kernel._topk_stats_reference(torch.from_numpy(t), torch.from_numpy(counts), top_k).numpy()
    assert port.dtype == np.float32 and port.shape == (q, 4)
    np.testing.assert_array_equal(port, np.asarray(_topk_stats_pallas(jnp.asarray(t), jnp.asarray(counts), top_k, interpret=True)))
    np.testing.assert_array_equal(port, np.asarray(jax_reference(jnp.asarray(t), jnp.asarray(counts), top_k)))
    assert not port[counts == 0].any()  # rows with a count of 0 give zeros


#: short rows, which the kernel sums with fewer than 32 lanes (4 up to 64
#: values, 8 up to 128, 16 up to 256), and either side of a step
SHORT_ROWS = (1, 7, 31, 100, 128, 129)


@pytest.mark.parametrize("top_k", [-1, 1, 10])
@pytest.mark.parametrize("length", SHORT_ROWS)
def test_short_rows_are_bit_equal_to_both_jax_bodies(length, top_k):
    t, counts = _grid(3 * length + top_k, 45, length, empty_rows=4)
    port = topk_kernel._topk_stats_reference(torch.from_numpy(t), torch.from_numpy(counts), top_k).numpy()
    assert port.dtype == np.float32 and port.shape == (45, 4)
    np.testing.assert_array_equal(port, np.asarray(_topk_stats_pallas(jnp.asarray(t), jnp.asarray(counts), top_k, interpret=True)))
    np.testing.assert_array_equal(port, np.asarray(jax_reference(jnp.asarray(t), jnp.asarray(counts), top_k)))


@pytest.mark.parametrize("top_k", [-1, 3])
def test_fractional_targets_agree_within_rtol(top_k):
    t, counts = _grid(11, 20, 64, binary=False, empty_rows=3)
    port = topk_kernel._topk_stats_reference(torch.from_numpy(t), torch.from_numpy(counts), top_k).numpy()
    ref = np.asarray(jax_reference(jnp.asarray(t), jnp.asarray(counts), top_k))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_body():
    kernels.reset_gate_log()
    before = topk_kernel.launches
    t, counts = _grid(5, 8, 16)
    got = topk_kernel.retrieval_topk_stats(torch.from_numpy(t), torch.from_numpy(counts).to(torch.int64), None)
    assert kernels.gate_snapshot()["retrieval_topk_stats"]["path"] == "reference"
    assert topk_kernel.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_reference(jnp.asarray(t), jnp.asarray(counts), -1)))


def test_shared_result_reuses_one_sweep_inside_a_scope():
    t, counts = (torch.from_numpy(a) for a in _grid(6, 8, 16))
    with kernels.shared_scope():
        a = topk_kernel.retrieval_topk_stats(t, counts, 3)
        b = topk_kernel.retrieval_topk_stats(t, counts, 3)
        c = topk_kernel.retrieval_topk_stats(t, counts, 4)  # another k: its own sweep
        d = topk_kernel.retrieval_topk_stats(t.clone(), counts, 3)  # another grid object
    assert a is b
    assert c is not a and d is not a
    torch.testing.assert_close(d, a, rtol=0, atol=0)
    # outside a scope nothing is memoized
    assert topk_kernel.retrieval_topk_stats(t, counts, 3) is not topk_kernel.retrieval_topk_stats(t, counts, 3)


def _wrapper_args():
    return torch.zeros((4, 6), dtype=torch.float32), torch.full((4,), 6, dtype=torch.int32)


@pytest.mark.parametrize(
    "change,error",
    [
        ({0: torch.zeros((4, 6), dtype=torch.float64)}, TypeError),
        ({1: torch.full((4,), 6, dtype=torch.int64)}, TypeError),
        ({0: torch.zeros(24)}, ValueError),
        ({1: torch.full((5,), 6, dtype=torch.int32)}, ValueError),
        ({0: torch.zeros((6, 4)).T}, ValueError),  # not contiguous
        ({}, ValueError),  # CPU tensors: the kernel runs on the card only
    ],
)
def test_kernel_wrapper_refuses_what_it_does_not_take(change, error):
    args = list(_wrapper_args())
    for i, value in change.items():
        args[i] = value
    before = topk_kernel.launches
    with pytest.raises(error):
        topk_kernel._topk_stats_cuda(*args, 3)
    assert topk_kernel.launches == before
    # the wrapper's one combined test refuses the arguments on their own device too
    assert change == {} or not topk_kernel._fits(*args, args[0].get_device())


def test_combined_check_takes_what_the_kernel_reads():
    """The wrapper's one test passes the arguments the kernel takes (here on
    the CPU, whose ``get_device()`` is -1), so only refused calls reach the
    detailed checks."""
    t, counts = _wrapper_args()
    assert topk_kernel._fits(t, counts, -1)
    assert topk_kernel._fits(t[:0], counts[:0], -1)


def test_kernel_wrapper_refuses_a_cpu_cuda_mix():
    t, counts = _wrapper_args()
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        topk_kernel._topk_stats_cuda(t, meta, 3)
