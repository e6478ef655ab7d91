"""The port's shared confusion counts (ops/fused_classification.py) against the JAX package.

The JAX side runs its CPU reference body (the ``"bincount"`` dispatch serves
the XLA scatter off-TPU); the port runs on CPU tensors, so its dispatch
serves the plain body. Counts and the derived int32 stats must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.ops import fused_classification as jax_fused
from torchmetrics_tpu_torch.ops import fused_classification as fused
from torchmetrics_tpu_torch.ops import kernels


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _assert_exact(port, ref):
    if isinstance(port, tuple):
        for p, r in zip(port, ref):
            _assert_exact(p, r)
        return
    # the port's counts are exact int64 where the JAX package sums float32 ones
    want = {"float32": "int64"}.get(str(np.asarray(ref).dtype), str(np.asarray(ref).dtype))
    assert str(port.dtype).replace("torch.", "") == want
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ignore_index", [None, 3, 255])
@pytest.mark.parametrize("layout", ["logits", "labels", "segmentation"])
def test_multiclass_counts_and_stats(layout, ignore_index):
    rng = np.random.RandomState(11)
    c = 7
    if layout == "segmentation":
        preds = rng.randn(3, c, 5, 6).astype(np.float32)
        target = rng.randint(0, c, (3, 5, 6)).astype(np.int64)
    else:
        preds = rng.randn(64, c).astype(np.float32) if layout == "logits" else rng.randint(0, c, 64).astype(np.int64)
        target = rng.randint(0, c, 64).astype(np.int64)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.2] = ignore_index
    (jp, jt), (tp_, tt) = _both(preds, target)
    port = fused.multiclass_confusion_counts(tp_, tt, c, ignore_index)
    ref = jax_fused.multiclass_confusion_counts(jp, jt, c, ignore_index)
    _assert_exact(port, ref)
    _assert_exact(fused.multiclass_stats(port), jax_fused.multiclass_stats(ref))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
def test_binary_counts_and_stats(kind, ignore_index):
    rng = np.random.RandomState(12)
    preds = {
        "probs": rng.rand(200).astype(np.float32),
        "logits": rng.randn(200).astype(np.float32),
        "labels": rng.randint(0, 2, 200).astype(np.int64),
    }[kind]
    target = rng.randint(0, 2, 200).astype(np.int64)
    if ignore_index is not None:
        target[rng.rand(200) < 0.2] = ignore_index
    (jp, jt), (tp_, tt) = _both(preds, target)
    port = fused.binary_confusion_counts(tp_, tt, 0.5, ignore_index)
    ref = jax_fused.binary_confusion_counts(jp, jt, 0.5, ignore_index)
    _assert_exact(port, ref)
    _assert_exact(fused.binary_stats(port), jax_fused.binary_stats(ref))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("extra_dims", [(), (4,)])
def test_multilabel_counts_and_stats(extra_dims, ignore_index):
    rng = np.random.RandomState(13)
    shape = (50, 5, *extra_dims)
    preds = rng.rand(*shape).astype(np.float32)
    target = rng.randint(0, 2, shape).astype(np.int64)
    if ignore_index is not None:
        target[rng.rand(*shape) < 0.2] = ignore_index
    (jp, jt), (tp_, tt) = _both(preds, target)
    port = fused.multilabel_confusion_counts(tp_, tt, 5, 0.5, ignore_index)
    ref = jax_fused.multilabel_confusion_counts(jp, jt, 5, 0.5, ignore_index)
    _assert_exact(port, ref)
    _assert_exact(fused.multilabel_stats(port), jax_fused.multilabel_stats(ref))


def _spy_dispatch(monkeypatch):
    calls = []
    real_dispatch = kernels.dispatch

    def spy(name, *args, **kwargs):
        calls.append((name, args))
        return real_dispatch(name, *args, **kwargs)

    monkeypatch.setattr(kernels, "dispatch", spy)
    return calls


@pytest.mark.parametrize("family", ["multiclass", "binary", "multilabel"])
def test_ignore_index_is_folded_into_a_weightless_count(monkeypatch, family):
    """Each builder makes one weightless ``bincount`` call (no weight row),
    masked samples carry index -1, and the counts equal the JAX package's,
    which masks by a 0/1 weight."""
    rng = np.random.RandomState(14)
    ignore = {"multiclass": 255, "binary": -1, "multilabel": -1}[family]
    if family == "multiclass":
        preds, target = rng.randn(2, 19, 6, 5).astype(np.float32), rng.randint(0, 19, (2, 6, 5)).astype(np.int64)
    elif family == "binary":
        preds, target = rng.rand(300).astype(np.float32), rng.randint(0, 2, 300).astype(np.int64)
    else:
        preds, target = rng.rand(40, 6).astype(np.float32), rng.randint(0, 2, (40, 6)).astype(np.int64)
    masked = rng.rand(*target.shape) < 0.25
    target[masked] = ignore
    (jp, jt), (tp_, tt) = _both(preds, target)
    calls = _spy_dispatch(monkeypatch)
    if family == "multiclass":
        port, ref = fused.multiclass_confusion_counts(tp_, tt, 19, ignore), jax_fused.multiclass_confusion_counts(jp, jt, 19, ignore)
    elif family == "binary":
        port, ref = fused.binary_confusion_counts(tp_, tt, 0.5, ignore), jax_fused.binary_confusion_counts(jp, jt, 0.5, ignore)
    else:
        port, ref = fused.multilabel_confusion_counts(tp_, tt, 6, 0.5, ignore), jax_fused.multilabel_confusion_counts(jp, jt, 6, 0.5, ignore)
    _assert_exact(port, ref)
    assert [c[0] for c in calls] == ["bincount"]
    idx, weights = calls[0][1][:2]
    assert weights is None and idx.dtype == torch.int32
    assert int((idx == -1).sum()) == int(masked.sum()) and int(port.sum()) == int((~masked).sum())


def _dispatches():
    return kernels.gate_snapshot().get("bincount", {}).get("selections", {}).get("reference", 0)


def test_shared_result_builds_once_per_scope():
    preds = torch.randn(32, 4)
    target = torch.randint(0, 4, (32,))
    kernels.reset_gate_log()
    with kernels.shared_scope():
        a = fused.multiclass_confusion_counts(preds, target, 4, None)
        b = fused.multiclass_confusion_counts(preds, target, 4, None)
        assert a is b and _dispatches() == 1
        # another config or other tensors build their own counts
        fused.multiclass_confusion_counts(preds, target, 4, 0)
        fused.multiclass_confusion_counts(preds.clone(), target, 4, None)
        assert _dispatches() == 3
        with kernels.shared_scope():  # inner frames see outer entries
            assert fused.multiclass_confusion_counts(preds, target, 4, None) is a
    # outside any scope nothing is memoized: the scope's tensors are released
    fused.multiclass_confusion_counts(preds, target, 4, None)
    fused.multiclass_confusion_counts(preds, target, 4, None)
    assert _dispatches() == 5


def test_fused_switch_reads_its_own_env(monkeypatch):
    assert fused.FUSED_ENV != jax_fused.FUSED_ENV
    monkeypatch.delenv(fused.FUSED_ENV, raising=False)
    assert fused.fused_enabled()
    for off in ("0", "false", "off"):
        monkeypatch.setenv(fused.FUSED_ENV, off)
        assert not fused.fused_enabled()
    monkeypatch.setenv(fused.FUSED_ENV, "1")
    assert fused.fused_enabled()


def test_negative_targets_are_dropped_not_wrapped():
    """A known divergence (ROADMAP Queue C): with validation off, the JAX
    fused counts wrap a negative non-ignored target numpy-style into the
    last row; the port drops it, as its kernel's specification says."""
    preds, target = np.array([0, 1]), np.array([-1, 1])
    (jp, jt), (tp_, tt) = _both(preds, target)
    port = fused.multiclass_confusion_counts(tp_, tt, 3, None)
    ref = np.asarray(jax_fused.multiclass_confusion_counts(jp, jt, 3, None))
    assert ref[2, 0] == 1  # the wrapped sample
    expected = ref.copy()
    expected[2, 0] = 0
    np.testing.assert_array_equal(port.numpy(), expected)
