"""The port's classification metrics against the JAX package.

Every metric of the slice (stat scores, accuracy, precision, recall, F1,
F-beta, Jaccard index, confusion matrix) in binary, multiclass and multilabel
form, each ``average`` (each ``normalize`` for the confusion matrix), with
``ignore_index`` unset and set. The same numpy batches go through the JAX
metric (eager, ``executor=False``) and the port's metric on the CPU:
accumulated int32 states must agree exactly and computed values within
rtol=1e-6 (both compute in float32, in the same order of operations); the
functional forms are held to the same tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jax_classification
import torchmetrics_tpu.functional as jax_functional
import torchmetrics_tpu_torch.classification as classification
import torchmetrics_tpu_torch.functional as functional
from torchmetrics_tpu_torch.ops import fused_classification

NUM_CLASSES = 5
NUM_LABELS = 4
BATCH = 48
RTOL = 1e-6

FAMILIES = {
    "StatScores": "stat_scores",
    "Accuracy": "accuracy",
    "Precision": "precision",
    "Recall": "recall",
    "F1Score": "f1_score",
    "FBetaScore": "fbeta_score",
    "JaccardIndex": "jaccard_index",
    "ConfusionMatrix": "confusion_matrix",
}
IGNORE = {"binary": -1, "multiclass": 3, "multilabel": -1}


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
    if family == "ConfusionMatrix":
        kw["normalize"] = option
    elif task != "binary":
        kw["average"] = option
    if family == "FBetaScore":
        kw["beta"] = 2.0
    return kw


def _assert_close(port, ref, exact=False):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=0)


def _cases():
    for family in FAMILIES:
        options = (None, "true", "pred", "all") if family == "ConfusionMatrix" else ("micro", "macro", "weighted", "none")
        for ignore in (False, True):
            yield family, "binary", options[0], ignore
            for task in ("multiclass", "multilabel"):
                for option in options:
                    yield family, task, option, ignore


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
    for name, value in port.metric_state.items():
        assert value.dtype == torch.int32, name
        _assert_close(value, ref.metric_state[name], exact=True)
    _assert_close(port.compute(), ref.compute(), exact=family in ("StatScores", "ConfusionMatrix") and option is None)

    fn = FAMILIES[family]
    preds, target = batches[0]
    _assert_close(
        getattr(functional, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw),
        getattr(jax_functional, fn)(jnp.asarray(preds), jnp.asarray(target), **kw),
    )


@pytest.mark.parametrize("family", ["StatScores", "Accuracy", "Precision", "F1Score"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_samplewise_matches_jax(family, task):
    kw = _kwargs(family, task, "macro", None)
    kw["multidim_average"] = "samplewise"
    ref = getattr(jax_classification, family)(**kw, executor=False)
    port = getattr(classification, family)(**kw, device="cpu")
    for preds, target in _batches(task, None, seed=21, extra=(6,)):
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert isinstance(port.metric_state["tp"], list) and len(port.metric_state["tp"]) == 2
    _assert_close(port.compute(), ref.compute(), exact=family == "StatScores")


@pytest.mark.parametrize("family", ["Accuracy", "Precision", "Recall", "StatScores"])
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_multiclass_top_k_matches_jax(family, average):
    kw = _kwargs(family, "multiclass", average, 3)
    kw["top_k"] = 2
    ref = getattr(jax_classification, family)(**kw, executor=False)
    port = getattr(classification, family)(**kw, device="cpu")
    for preds, target in _batches("multiclass", 3, seed=31):
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_fused_and_unfused_paths_are_bit_exact(monkeypatch, family, task):
    ignore_index = IGNORE[task]
    kw = _kwargs(family, task, "macro" if family != "ConfusionMatrix" else None, ignore_index)
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


def test_jaccard_excludes_in_range_ignore_class():
    preds = torch.tensor([0, 1, 2, 3, 3, 1])
    target = torch.tensor([0, 1, 2, 3, 3, 2])
    port = classification.MulticlassJaccardIndex(num_classes=4, ignore_index=3, device="cpu")
    ref = jax_classification.MulticlassJaccardIndex(num_classes=4, ignore_index=3, executor=False)
    port.update(preds, target)
    ref.update(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()))
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize(
    "cls,kw,preds,target",
    [
        ("BinaryAccuracy", {}, [0.2, 0.8], [0, 2]),
        ("BinaryAccuracy", {}, [0, 3], [0, 1]),
        ("MulticlassAccuracy", {"num_classes": 3}, [0, 1], [0, 5]),
        ("MulticlassAccuracy", {"num_classes": 3}, [0, 4], [0, 1]),
        ("MultilabelAccuracy", {"num_labels": 2}, [[0.1, 0.9]], [[0, 2]]),
    ],
)
def test_invalid_values_raise_like_jax(cls, kw, preds, target):
    ref = getattr(jax_classification, cls)(**kw, executor=False)
    port = getattr(classification, cls)(**kw, device="cpu")
    with pytest.raises(RuntimeError) as ref_err:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    with pytest.raises(RuntimeError) as port_err:
        port.update(torch.tensor(preds), torch.tensor(target))
    assert str(port_err.value).split(":")[0] == str(ref_err.value).split(":")[0]
    assert port.update_count == 0  # the failed update rolled back


@pytest.mark.parametrize(
    "cls,kw",
    [
        ("MulticlassAccuracy", {"num_classes": 1}),
        ("MulticlassAccuracy", {"num_classes": 3, "average": "bogus"}),
        ("BinaryAccuracy", {"threshold": 2.0}),
        ("MulticlassConfusionMatrix", {"num_classes": 3, "normalize": "rows"}),
        ("MulticlassFBetaScore", {"num_classes": 3, "beta": -1.0}),
    ],
)
def test_invalid_arguments_raise_like_jax(cls, kw):
    with pytest.raises(ValueError):
        getattr(jax_classification, cls)(**kw)
    with pytest.raises(ValueError):
        getattr(classification, cls)(**kw, device="cpu")
