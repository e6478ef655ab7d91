"""The port's ``binned_curve`` plain body against both JAX bodies.

The same numpy inputs (unsorted and duplicated thresholds, NaN scores,
masked samples, scores that sit exactly on a threshold) go through the
port's ``_binned_counts_reference`` and the JAX package's Pallas kernel in
interpret mode and its searchsorted body; the ``(T, 2, 2)`` counts must be
equal. The per-column form is held to the JAX ``binned_curve_counts_classwise``
the same way, and the port's integer threshold grid to ``jnp.linspace``
bit for bit. The target forms the kernel reads (int64, int32 or uint8, with
a mask or an ``ignore_index``) go through the plain body against JAX given
``valid = target != ignore_index``, and the binned binary update, which now
hands the target and ``ignore_index`` straight to the count, keeps the state
of the masking route it replaced bit for bit. On the CPU the CUDA wrapper only checks its arguments, so its
refusals are tested here; it launches on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.ops.binned_curve import (
    _binned_counts_pallas,
    _binned_counts_searchsorted,
)
from torchmetrics_tpu.ops.binned_curve import binned_curve_counts_classwise as jax_classwise
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_precision_recall_curve_update,
    _valid_and_masked,
)
from torchmetrics_tpu_torch.ops import binned_curve, kernels


def _case(seed, n, len_t, thresholds="sorted", nan=0.0, masked=0.0, on_threshold=0.0):
    rng = np.random.RandomState(seed)
    if thresholds == "sorted":
        thr = np.linspace(0, 1, len_t).astype(np.float32)
    else:
        thr = rng.rand(len_t).astype(np.float32)
        if thresholds == "duplicated":
            thr[len_t // 2:] = thr[: len_t - len_t // 2]
            thr[0] = 0.0
    preds = rng.rand(n).astype(np.float32)
    preds[rng.rand(n) < on_threshold] = thr[rng.randint(0, len_t)]
    preds[rng.rand(n) < nan] = np.nan
    target = rng.randint(0, 2, n).astype(np.int32)
    valid = rng.rand(n) >= masked
    return preds, target, valid, thr


CASES = {
    "sorted": dict(n=3000, len_t=100),
    "unsorted": dict(n=2500, len_t=37, thresholds="unsorted"),
    "duplicated": dict(n=2048, len_t=40, thresholds="duplicated"),
    "nan_scores": dict(n=1500, len_t=11, nan=0.1),
    "masked": dict(n=4096, len_t=64, masked=0.3),
    "on_threshold": dict(n=2000, len_t=9, on_threshold=0.4, masked=0.1),
    "everything": dict(n=5000, len_t=200, thresholds="duplicated", nan=0.05, masked=0.05, on_threshold=0.2),
    "single_threshold": dict(n=700, len_t=1, thresholds="unsorted", on_threshold=0.5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_body_equals_both_jax_bodies(name):
    preds, target, valid, thr = _case(len(name), **CASES[name])
    port = binned_curve._binned_counts_reference(
        torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(valid),
        *binned_curve.sort_thresholds(torch.from_numpy(thr)),
    )
    assert port.dtype == torch.int64 and tuple(port.shape) == (len(thr), 2, 2)
    args = (jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid), jnp.asarray(thr))
    np.testing.assert_array_equal(port.numpy(), np.asarray(_binned_counts_pallas(*args, interpret=True)))
    np.testing.assert_array_equal(port.numpy(), np.asarray(_binned_counts_searchsorted(*args)))
    # every threshold sees every valid sample once
    assert (port.sum((1, 2)) == int(valid.sum())).all()


@pytest.mark.parametrize("name", ["unsorted", "nan_scores", "on_threshold"])
def test_classwise_equals_jax(name):
    kw = dict(CASES[name], n=CASES[name]["n"] // 4)
    columns = [_case(len(name) + c, **kw) for c in range(4)]
    thr = columns[0][3]
    preds = np.stack([col[0] for col in columns], axis=1)
    pos = np.stack([col[1] * col[2] for col in columns], axis=1).astype(np.float32)
    neg = np.stack([(1 - col[1]) * col[2] for col in columns], axis=1).astype(np.float32)
    target = np.stack([col[1] for col in columns], axis=1)
    valid = np.stack([col[2] for col in columns], axis=1)
    port = binned_curve.binned_curve_counts_classwise(
        *(torch.from_numpy(a) for a in (preds, target, valid)), binned_curve.sort_thresholds(torch.from_numpy(thr))
    )
    ref = jax_classwise(*(jnp.asarray(a) for a in (preds, pos, neg, thr)))
    assert port.dtype == torch.int64 and tuple(port.shape) == (len(thr), 4, 2, 2)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_cpu_tensors_take_the_plain_body():
    kernels.reset_gate_log()
    before = binned_curve.launches
    preds, target, valid, thr = _case(3, n=500, len_t=5, masked=0.2)
    got = binned_curve.binned_curve_counts(
        torch.from_numpy(preds), torch.from_numpy(target).to(torch.int64), torch.from_numpy(valid),
        binned_curve.sort_thresholds(torch.from_numpy(thr)),
    )
    assert kernels.gate_snapshot()["binned_curve"]["path"] == "reference"
    assert binned_curve.launches == before
    ref = _binned_counts_searchsorted(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid), jnp.asarray(thr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("len_t", [5, 100, 200, 1000])
def test_integer_thresholds_equal_jnp_linspace_bit_for_bit(len_t):
    port = _adjust_threshold_arg(len_t).numpy()
    ref = np.asarray(jnp.linspace(0, 1, len_t))
    assert port.dtype == np.float32 == ref.dtype
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))


def _wrapper_args():
    thr_sorted, order = binned_curve.sort_thresholds(torch.rand(3))
    return torch.rand(8), torch.zeros(8, dtype=torch.int32), torch.ones(8, dtype=torch.bool), thr_sorted, order


@pytest.mark.parametrize(
    "change,error",
    [
        ({0: torch.rand(8, dtype=torch.float64)}, TypeError),
        ({1: torch.zeros(8, dtype=torch.int16)}, TypeError),
        ({2: torch.ones(8, dtype=torch.int32)}, TypeError),
        ({3: torch.rand(3, dtype=torch.float64)}, TypeError),
        ({4: torch.arange(3, dtype=torch.int32)}, TypeError),
        ({1: torch.zeros(9, dtype=torch.int32)}, ValueError),
        ({3: torch.rand(0), 4: torch.arange(0)}, ValueError),
        ({4: torch.arange(4)}, ValueError),
        ({0: torch.rand(16)[::2]}, ValueError),
        ({}, ValueError),  # CPU tensors: the kernel runs on the card only
    ],
)
def test_kernel_wrapper_refuses_what_it_does_not_take(change, error):
    args = list(_wrapper_args())
    for i, value in change.items():
        args[i] = value
    before = binned_curve.launches
    with pytest.raises(error):
        binned_curve._binned_counts_cuda(*args)
    assert binned_curve.launches == before
    # the wrapper's one combined test refuses the arguments on their own device too
    assert change == {} or not binned_curve._fits(*args, None, args[0].get_device())


@pytest.mark.parametrize("form", ["mask", "ignore_index", "neither"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.uint8])
def test_combined_check_takes_every_form_the_kernel_reads(dtype, form):
    """The wrapper's one test passes every target form the kernel reads (here
    on the CPU, whose ``get_device()`` is -1), so only refused calls reach the
    detailed checks; a mask with an ignore_index is refused."""
    preds, target, valid, thr_sorted, order = _wrapper_args()
    target = target.to(dtype)
    mask, ignore = {"mask": (valid, None), "ignore_index": (None, -1), "neither": (None, None)}[form]
    assert binned_curve._fits(preds, target, mask, thr_sorted, order, ignore, -1)
    assert binned_curve._fits(preds[:0], target[:0], None if mask is None else mask[:0], thr_sorted, order, ignore, -1)
    with pytest.raises(ValueError, match="not both"):
        binned_curve._refuse(preds, target, valid, thr_sorted, order, -1)
    assert not binned_curve._fits(preds, target, valid, thr_sorted, order, -1, -1)


def test_thresholds_are_sorted_again_after_an_in_place_change():
    """A functional call sorts the thresholds it is given, so an in-place
    change of the caller's tensor between calls counts against the new values."""
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
        _binary_precision_recall_curve_update,
    )

    preds, target, valid, thr = (torch.from_numpy(a) for a in _case(7, n=800, len_t=6, thresholds="unsorted"))
    first = _binary_precision_recall_curve_update(preds, target, valid, thr)
    thr.mul_(0.5)  # same tensor object, new values
    second = _binary_precision_recall_curve_update(preds, target, valid, thr)
    ref = _binned_counts_searchsorted(*(jnp.asarray(a.numpy()) for a in (preds, target, valid, thr)))
    np.testing.assert_array_equal(second.numpy(), np.asarray(ref))
    assert not torch.equal(first, second)


def test_metric_keeps_its_own_sorted_copy_of_the_thresholds():
    """A binned metric sorts its thresholds once, when it is built; a later
    in-place change of the caller's tensor leaves the metric's grid as it was."""
    from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve

    preds, target, valid, thr = (torch.from_numpy(a) for a in _case(8, n=800, len_t=6, thresholds="unsorted"))
    ref = _binned_counts_searchsorted(*(jnp.asarray(a.numpy()) for a in (preds, target, valid, thr)))
    metric = BinaryPrecisionRecallCurve(thresholds=thr, device="cpu")
    thr.mul_(0.5)
    metric.update(preds, target)
    np.testing.assert_array_equal(metric.confmat.numpy(), np.asarray(ref))


TARGET_DTYPES = {"int64": torch.int64, "int32": torch.int32, "uint8": torch.uint8}


def _form_case(seed, dtype, ignore_index, n=1200, len_t=17):
    """Scores (NaN and on-threshold ones among them), 0/1 targets of
    ``dtype`` with a tenth set to ``ignore_index`` cast to that type (as
    torch and jnp compare), unsorted thresholds and a random mask."""
    preds, target, mask, thr = _case(seed, n, len_t, thresholds="duplicated", nan=0.05, masked=0.2, on_threshold=0.2)
    target = torch.from_numpy(target).to(TARGET_DTYPES[dtype])
    if ignore_index is not None:
        ignored = torch.from_numpy(np.random.RandomState(seed + 1).rand(n) < 0.1)
        target = torch.where(ignored, torch.tensor(ignore_index).to(target.dtype), target)
    return torch.from_numpy(preds), target, torch.from_numpy(mask), torch.from_numpy(thr)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("ignore_index", [None, -1, 255])
@pytest.mark.parametrize("dtype", list(TARGET_DTYPES))
def test_plain_body_target_forms_equal_both_jax_bodies(dtype, ignore_index, masked):
    """int64, int32 and uint8 targets with an ignore_index (or none), with and
    without a mask: the port's plain body against both JAX bodies, which are
    given ``valid = target != ignore_index`` (and the mask)."""
    preds, target, mask, thr = _form_case(len(dtype) + (ignore_index or 0), dtype, ignore_index)
    jt = jnp.asarray(target.numpy())
    valid = jnp.ones(jt.shape, bool) if ignore_index is None else jt != ignore_index
    if masked:
        valid = valid & jnp.asarray(mask.numpy())
        port_valid, port_ignore = torch.from_numpy(np.array(valid)), None
    else:
        port_valid, port_ignore = None, ignore_index
    port = binned_curve._binned_counts_reference(
        preds, target, port_valid, *binned_curve.sort_thresholds(thr), ignore_index=port_ignore
    )
    args = (jnp.asarray(preds.numpy()), jt.astype(jnp.int32), valid, jnp.asarray(thr.numpy()))
    assert port.dtype == torch.int64 and tuple(port.shape) == (len(thr), 2, 2)
    np.testing.assert_array_equal(port.numpy(), np.asarray(_binned_counts_pallas(*args, interpret=True)))
    np.testing.assert_array_equal(port.numpy(), np.asarray(_binned_counts_searchsorted(*args)))
    assert (port.sum((1, 2)) == int(np.asarray(valid).sum())).all()


def test_plain_body_refuses_a_mask_and_an_ignore_index_together():
    preds, target, mask, thr = _form_case(3, "int64", -1, n=50, len_t=4)
    with pytest.raises(ValueError, match="not both"):
        binned_curve._binned_counts_reference(preds, target, mask, *binned_curve.sort_thresholds(thr), ignore_index=-1)


@pytest.mark.parametrize("ignore_index", [None, -1, 255])
@pytest.mark.parametrize("dtype", list(TARGET_DTYPES))
def test_binned_update_state_equals_the_masking_route(dtype, ignore_index):
    """The binned binary update hands the target and ignore_index straight to
    the count; over the same batches, the metric's state and the functional
    update equal the route it replaced (``_valid_and_masked``, then int32
    targets and a mask) bit for bit."""
    from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve

    thr = _adjust_threshold_arg(25)
    grid = binned_curve.sort_thresholds(thr)
    metric = BinaryPrecisionRecallCurve(thresholds=25, ignore_index=ignore_index, validate_args=False, device="cpu")
    old = torch.zeros((25, 2, 2), dtype=torch.int32)
    for batch in range(3):
        preds, target, _, _ = _form_case(10 * batch + len(dtype), dtype, ignore_index, n=900 + batch)
        masked_target, valid = _valid_and_masked(target, ignore_index)
        assert masked_target.dtype == torch.int32 and valid.dtype == torch.bool
        counts = binned_curve.binned_curve_counts(preds, masked_target, valid, grid)
        old = old + counts.to(torch.int32)
        new = _binary_precision_recall_curve_update(preds, target, None, thr, ignore_index=ignore_index)
        assert new.dtype == torch.int32 and torch.equal(new, counts.to(torch.int32))
        metric.update(preds, target)
    assert metric.confmat.dtype == torch.int32 and torch.equal(metric.confmat, old)
