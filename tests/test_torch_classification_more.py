"""The port's specificity, Hamming distance, Matthews correlation and
Cohen's kappa against the JAX package.

Every variant (binary, multiclass, multilabel; Cohen's kappa has no
multilabel form) and the task wrappers, each ``average`` (each ``weights``
for kappa), with ``ignore_index`` unset and set. The same numpy batches go
through the JAX metric (eager, ``executor=False``) and the port's on the
CPU: accumulated int32 states must be bit-equal, computed values within
rtol 1e-5 or 2.4e-7 absolute (two float32 ulps of 1: kappa is 1 minus a
ratio of float32 sums whose order differs between the frameworks); the
functional forms are held the same way.
In a collection with the config-2 metrics the four still take their counts
from the one shared ``bincount`` of each update.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jax_classification
import torchmetrics_tpu.functional as jax_functional
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.classification as classification
import torchmetrics_tpu_torch.functional as functional
from torchmetrics_tpu_torch.ops import fused_classification, kernels

NUM_CLASSES = 5
NUM_LABELS = 4
BATCH = 48
RTOL = 1e-5
ATOL = 2.4e-7
IGNORE = {"binary": -1, "multiclass": 3, "multilabel": -1}

#: modular family -> functional name
FAMILIES = {
    "Specificity": "specificity",
    "HammingDistance": "hamming_distance",
    "MatthewsCorrCoef": "matthews_corrcoef",
    "CohenKappa": "cohen_kappa",
}


def _batches(task, ignore_index, seed, n=2, extra=()):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if task == "binary":
            preds, target = rng.rand(BATCH, *extra), rng.randint(0, 2, (BATCH, *extra))
        elif task == "multiclass":
            preds, target = rng.randn(BATCH, NUM_CLASSES, *extra), rng.randint(0, NUM_CLASSES, (BATCH, *extra))
        else:
            preds, target = rng.rand(BATCH, NUM_LABELS, *extra), rng.randint(0, 2, (BATCH, NUM_LABELS, *extra))
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.15] = ignore_index
        out.append((preds.astype(np.float32), target.astype(np.int64)))
    return out


def _kwargs(family, task, option, ignore_index):
    kw = {"task": task, "ignore_index": ignore_index}
    if task == "multiclass":
        kw["num_classes"] = NUM_CLASSES
    if task == "multilabel":
        kw["num_labels"] = NUM_LABELS
    if family == "CohenKappa":
        kw["weights"] = option
    elif family in ("Specificity", "HammingDistance") and task != "binary":
        kw["average"] = option
    return kw


def _options(family, task):
    if family == "CohenKappa":
        return (None, "linear", "quadratic")
    if family == "MatthewsCorrCoef" or task == "binary":
        return (None,)
    return ("micro", "macro", "weighted", "none")


def _cases():
    for family in FAMILIES:
        tasks = ("binary", "multiclass") if family == "CohenKappa" else ("binary", "multiclass", "multilabel")
        for task in tasks:
            for option in _options(family, task):
                for ignore in (False, True):
                    yield family, task, option, ignore


def _assert_close(port, ref, exact=False):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family,task,option,ignore", list(_cases()))
def test_metric_matches_jax(family, task, option, ignore):
    ignore_index = IGNORE[task] if ignore else None
    kw = _kwargs(family, task, option, ignore_index)
    ref = getattr(jax_classification, family)(**kw, executor=False)
    port = getattr(classification, family)(**kw, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    batches = _batches(task, ignore_index, seed=len(family) + len(task))
    for preds, target in batches:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert port.metric_state.keys() == ref.metric_state.keys()
    for name, value in port.metric_state.items():
        assert value.dtype == torch.int32, name
        _assert_close(value, ref.metric_state[name], exact=True)
    _assert_close(port.compute(), ref.compute())

    fn = FAMILIES[family]
    preds, target = batches[0]
    _assert_close(
        getattr(functional, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw),
        getattr(jax_functional, fn)(jnp.asarray(preds), jnp.asarray(target), **kw),
    )


@pytest.mark.parametrize("family", ["Specificity", "HammingDistance"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_samplewise_matches_jax(family, task):
    kw = _kwargs(family, task, "macro", None)
    kw["multidim_average"] = "samplewise"
    ref = getattr(jax_classification, family)(**kw, executor=False)
    port = getattr(classification, family)(**kw, device="cpu")
    for preds, target in _batches(task, None, seed=21, extra=(6,)):
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize("family", ["Specificity", "HammingDistance"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted"])
def test_multiclass_top_k_matches_jax(family, average):
    kw = _kwargs(family, "multiclass", average, 3)
    kw["top_k"] = 2
    ref = getattr(jax_classification, family)(**kw, executor=False)
    port = getattr(classification, family)(**kw, device="cpu")
    for preds, target in _batches("multiclass", 3, seed=31):
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize(
    "counts",
    [
        [[5, 0], [0, 7]],  # perfect
        [[0, 4], [6, 0]],  # all wrong
        [[9, 0], [3, 0]],  # nothing predicted positive: the zero denominator
        [[0, 0], [0, 8]],  # one class only
        [[4, 1, 0], [0, 0, 0], [2, 0, 3]],  # an absent class
        [[0, 0, 0], [0, 0, 0], [5, 0, 0]],  # a multiclass zero denominator
    ],
)
def test_matthews_degenerate_matrices_match_jax(counts):
    from torchmetrics_tpu.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce as jax_reduce

    from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce

    confmat = np.asarray(counts, np.int32)
    _assert_close(_matthews_corrcoef_reduce(torch.from_numpy(confmat)), jax_reduce(jnp.asarray(confmat)))


@pytest.mark.parametrize("family,task", sorted({(f, t) for f, t, _, _ in _cases()}))
def test_fused_and_unfused_paths_are_bit_exact(monkeypatch, family, task):
    ignore_index = IGNORE[task]
    kw = _kwargs(family, task, _options(family, task)[-1], ignore_index)
    batches = _batches(task, ignore_index, seed=41)
    states = {}
    for flag in ("1", "0"):
        monkeypatch.setenv(fused_classification.FUSED_ENV, flag)
        m = getattr(classification, family)(**kw, device="cpu")
        for preds, target in batches:
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
        states[flag] = (m.metric_state, m.compute())
    for name, value in states["1"][0].items():
        assert torch.equal(value, states["0"][0][name]), name
    assert torch.equal(states["1"][1], states["0"][1])


def test_collection_makes_one_bincount_per_update():
    """The config-2 metrics and the four new ones: one shared count an update."""
    c = NUM_CLASSES
    coll = tm.MetricCollection(
        {
            "accuracy": classification.MulticlassAccuracy(num_classes=c, device="cpu"),
            "f1": classification.MulticlassF1Score(num_classes=c, device="cpu"),
            "confmat": classification.MulticlassConfusionMatrix(num_classes=c, device="cpu"),
            "specificity": classification.MulticlassSpecificity(num_classes=c, device="cpu"),
            "hamming": classification.MulticlassHammingDistance(num_classes=c, device="cpu"),
            "mcc": classification.MulticlassMatthewsCorrCoef(num_classes=c, device="cpu"),
            "kappa": classification.MulticlassCohenKappa(num_classes=c, device="cpu"),
        },
        device="cpu",
    )
    batches = _batches("multiclass", None, seed=51, n=3)
    kernels.reset_gate_log()
    for preds, target in batches:
        coll.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": len(batches)}


def test_invalid_arguments_raise_like_jax():
    for family, kw in (
        ("CohenKappa", {"task": "multiclass", "num_classes": 3, "weights": "cubic"}),
        ("MatthewsCorrCoef", {"task": "multiclass", "num_classes": 1}),
        ("Specificity", {"task": "multiclass", "num_classes": 3, "average": "bogus"}),
        ("HammingDistance", {"task": "binary", "threshold": 2.0}),
    ):
        with pytest.raises(ValueError):
            getattr(jax_classification, family)(**kw, executor=False)
        with pytest.raises(ValueError):
            getattr(classification, family)(**kw, device="cpu")
    with pytest.raises(ValueError):
        classification.CohenKappa(task="multilabel", num_labels=3, device="cpu")
    with pytest.raises(ValueError):
        jax_classification.CohenKappa(task="multilabel", num_labels=3, executor=False)
