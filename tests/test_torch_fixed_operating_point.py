"""The port's fixed-operating-point quartet (recall at fixed precision,
precision at fixed recall, sensitivity at specificity, specificity at
sensitivity) against the JAX package.

Every family in binary, multiclass and multilabel form; binned (an integer
grid, an unsorted list) and exact mode; ``ignore_index`` unset and set;
scores on a 0.05 grid, so that curve points tie and scores sit on
thresholds. The sentinel cases: no positives (the PR pair's 0 objective,
the ROC pair's empty qualifying set), an unattainable floor, the exact
ROC's start point (threshold 1.0). The same seeded numpy batches go through
the JAX metric (eager, ``executor=False``) or function and the port's on
the CPU: binned states bit-equal, values within rtol 1e-5 / atol 1e-6, the
selected thresholds equal. A collection puts the members of one curve
state into one compute group with AUROC; one modular case per family is
synced in a two-rank gloo world and held to the JAX value of the ranks'
concatenated data; that world syncs the slice's other families too (their
cases come from ``test_torch_exact_hinge_ranking.py`` and
``test_torch_fairness_dice.py``).

This module imports only torch, numpy and the port at its top level: the
gloo ranks import it to find their target.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.classification as classification
import torchmetrics_tpu_torch.functional as functional
from torchmetrics_tpu_torch.ops import kernels
import test_torch_exact_hinge_ranking as exact_hinge_ranking
import test_torch_fairness_dice as fairness_dice
from helpers.torch_world import run_world

N = 48
C = 4
L = 3
RTOL = 1e-5
ATOL = 1e-6
IGNORE = -1
GRID_LIST = [0.6, 0.05, 0.5, 0.95, 0.25, 0.3]

#: family -> (class stem, floor argument, functional stem)
FAMILIES = {
    "RecallAtFixedPrecision": ("min_precision", "recall_at_fixed_precision"),
    "PrecisionAtFixedRecall": ("min_recall", "precision_at_fixed_recall"),
    "SensitivityAtSpecificity": ("min_specificity", "sensitivity_at_specificity"),
    "SpecificityAtSensitivity": ("min_sensitivity", "specificity_at_sensitivity"),
}
PREFIX = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}
MODES = {"exact": None, "int": 11, "list": GRID_LIST}


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu.classification as jax_classification
    import torchmetrics_tpu.functional.classification as jax_functional

    return jnp, jax_classification, jax_functional


def _close(port, ref):
    """(value, threshold) pairs: values to the tolerance, thresholds equal."""
    (pv, pt), (rv, rt) = port, ref
    pv, pt, rv, rt = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in (pv, pt, rv, rt))
    assert pv.shape == rv.shape and pt.shape == rt.shape
    assert pv.dtype == np.float32 and pt.dtype == np.float32
    np.testing.assert_allclose(pv.astype(np.float64), rv.astype(np.float64), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pt, rt)


def _batches(task, ignore_index, seed, n=2, positives=True):
    """Probabilities on a 0.05 grid leaning towards the target."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if task == "binary":
            target = rng.randint(0, 2, N) * positives
            preds = np.clip(np.round((rng.rand(N) + 0.6 * target) / 1.6 / 0.05) * 0.05, 0, 1)
        elif task == "multiclass":
            target = rng.randint(0, C, N)
            logits = rng.rand(N, C) + 1.5 * np.eye(C)[target]
            preds = np.round(logits / logits.sum(1, keepdims=True) / 0.05) * 0.05
            preds = preds / preds.sum(1, keepdims=True)
        else:
            target = rng.randint(0, 2, (N, L)) * positives
            preds = np.clip(np.round((rng.rand(N, L) + 0.6 * target) / 1.6 / 0.05) * 0.05, 0, 1)
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.1] = ignore_index
        out.append((preds.astype(np.float32), target.astype(np.int64)))
    return out


def _kwargs(task, family, floor, mode, ignore_index):
    kw = {FAMILIES[family][0]: floor, "thresholds": MODES[mode], "ignore_index": ignore_index}
    if task == "multiclass":
        kw["num_classes"] = C
    if task == "multilabel":
        kw["num_labels"] = L
    return kw


def _cases():
    for family in FAMILIES:
        for task in PREFIX:
            for mode in MODES:
                for ignore in (None, IGNORE):
                    yield family, task, mode, ignore


@pytest.mark.parametrize("family,task,mode,ignore_index", list(_cases()))
def test_fixed_point_matches_jax(family, task, mode, ignore_index):
    jnp, jax_classification, jax_functional = _jax()
    kw = _kwargs(task, family, 0.6, mode, ignore_index)
    name = PREFIX[task] + family
    ref = getattr(jax_classification, name)(**kw, executor=False)
    port = getattr(classification, name)(**kw, device="cpu")
    batches = _batches(task, ignore_index, seed=len(family) + 3 * len(task) + len(mode))
    for preds, target in batches:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    if mode != "exact":
        assert port.confmat.dtype == torch.int32
        np.testing.assert_array_equal(port.confmat.numpy(), np.asarray(ref.metric_state["confmat"]))
    _close(port.compute(), ref.compute())

    preds, target = batches[0]
    fn = f"{task}_{FAMILIES[family][1]}"
    _close(
        getattr(functional, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw),
        getattr(jax_functional, fn)(jnp.asarray(preds), jnp.asarray(target), **kw),
    )
    wrapper = getattr(classification, family)(task=task, **kw, device="cpu")
    assert type(wrapper).__name__ == name


def _sentinel_cases():
    """(family, task, mode, case, floor, whether the threshold is the sentinel)."""
    for family in FAMILIES:
        # a floor on precision or specificity fails at every threshold but the
        # exact ROC's start point; one on recall or sensitivity holds at 0 only
        floor_on_top = family in ("RecallAtFixedPrecision", "SensitivityAtSpecificity")
        for mode in MODES:
            for task in ("binary", "multilabel"):
                # no positives: recall and sensitivity are 0 at every threshold
                yield family, task, mode, "no_positives", 0.5, family != "SensitivityAtSpecificity"
            # a negative scored 1.0 and a positive scored 0.0, a floor of 1.0
            if floor_on_top:
                unattainable = family == "RecallAtFixedPrecision" or mode != "exact"
            else:
                unattainable = mode == "list"  # the list grid has no threshold at 0
            yield family, "binary", mode, "extremes", 1.0, unattainable
    # the exact ROC's start point is the only one with specificity 1: threshold 1.0
    yield "SensitivityAtSpecificity", "binary", "exact", "negatives_on_top", 1.0, False


@pytest.mark.parametrize("family,task,mode,case,floor,sentinel", list(_sentinel_cases()))
def test_sentinels_match_jax(family, task, mode, case, floor, sentinel):
    jnp, _, jax_functional = _jax()
    kw = _kwargs(task, family, floor, mode, None)
    preds, target = _batches(task, None, seed=17, n=1, positives=case != "no_positives")[0]
    if case == "extremes":
        preds[np.argmax(target == 0)], preds[np.argmax(target == 1)] = 1.0, 0.0
    if case == "negatives_on_top":
        preds = np.where(target == 1, 0.2, 0.9).astype(np.float32)
    fn = f"{task}_{FAMILIES[family][1]}"
    port = getattr(functional, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    _close(port, getattr(jax_functional, fn)(jnp.asarray(preds), jnp.asarray(target), **kw))
    assert bool((port[1] == 1e6).all()) == sentinel
    if case == "negatives_on_top":
        assert float(port[1]) == 1.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_floor_must_be_a_float(family):
    """A floor of ``1`` (an int) is refused, as in the JAX package."""
    _, jax_classification, _ = _jax()
    arg = FAMILIES[family][0]
    for build in (getattr(classification, "Binary" + family), getattr(jax_classification, "Binary" + family)):
        with pytest.raises(ValueError, match=arg):
            build(**{arg: 1}, thresholds=5, **({"device": "cpu"} if build.__module__.startswith("torchmetrics_tpu_torch") else {}))


def test_collection_counts_once_per_update():
    """Fixed points and AUROC on one (T, C, 2, 2) state form one compute
    group: after the first update (every member counts) one ``bincount``
    an update."""
    kw = {"num_classes": C, "thresholds": 11, "validate_args": False}
    coll = tm.MetricCollection(
        {
            "auroc": classification.MulticlassAUROC(**kw, device="cpu"),
            "recall_at_precision": classification.MulticlassRecallAtFixedPrecision(min_precision=0.5, **kw, device="cpu"),
            "specificity_at_sensitivity": classification.MulticlassSpecificityAtSensitivity(
                min_sensitivity=0.5, **kw, device="cpu"
            ),
        },
        device="cpu",
    )
    batches = _batches("multiclass", None, seed=4, n=3)
    kernels.reset_gate_log()
    coll.update(*(torch.from_numpy(b) for b in batches[0]))
    assert kernels.gate_snapshot()["bincount"]["selections"]["reference"] == 3
    assert [len(g) for g in coll.compute_groups.values()] == [3]
    for batch in batches[1:]:
        coll.update(*(torch.from_numpy(b) for b in batch))
    assert kernels.gate_snapshot()["bincount"]["selections"]["reference"] == 5
    result = coll.compute()
    single = classification.MulticlassRecallAtFixedPrecision(min_precision=0.5, **kw, device="cpu")
    for batch in batches:
        single.update(*(torch.from_numpy(b) for b in batch))
    for got, want in zip(result["recall_at_precision"], single.compute()):
        assert torch.equal(got, want)


# -------------------------------------------------------- two-rank sync
#
# One gloo world for every family of the slice: the fixed points here, and
# exact match, hinge loss, ranking, fairness and Dice from their own test
# modules' ``_sync_data``/``_sync_metrics``.


def _fixed_specs():
    """(name, task, kwargs) of one modular case per fixed-point family."""
    return [
        ("BinaryRecallAtFixedPrecision", "binary", {"min_precision": 0.6, "thresholds": 11, "ignore_index": IGNORE}),
        ("MulticlassPrecisionAtFixedRecall", "multiclass", {"num_classes": C, "min_recall": 0.5, "thresholds": 11}),
        ("MultilabelSensitivityAtSpecificity", "multilabel", {"num_labels": L, "min_specificity": 0.6, "thresholds": None}),
        ("BinarySpecificityAtSensitivity", "binary", {"min_sensitivity": 0.5, "thresholds": None}),
    ]


def _sync_data(rank):
    """key -> batches of this rank, for every synced case."""
    data = {name: _batches(task, kw.get("ignore_index"), seed=90 + rank) for name, task, kw in _fixed_specs()}
    for module in (exact_hinge_ranking, fairness_dice):
        data.update(module._sync_data(rank))
    return data


def _sync_metrics(build):
    """key -> metric of every synced case, built by ``build(name, **kw)``."""
    metrics = {name: build(name, **kw) for name, _, kw in _fixed_specs()}
    for module in (exact_hinge_ranking, fairness_dice):
        metrics.update(module._sync_metrics(build))
    return metrics


def _numpy(value):
    if isinstance(value, dict):
        return {k: v.numpy() for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(v.numpy() for v in value)
    return value.numpy()


def _sync_rank(rank, world):
    metrics = _sync_metrics(lambda name, **kw: getattr(classification, name)(**kw, device="cpu"))
    out = {}
    for key, batches in _sync_data(rank).items():
        for batch in batches:
            metrics[key].update(*(torch.from_numpy(b) for b in batch))
        out[key] = _numpy(metrics[key].compute())
    return out


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """Every rank's synced values, and the JAX values of the ranks'
    concatenated data."""
    jnp, jax_classification, _ = _jax()
    results = run_world(2, tmp_path_factory.mktemp("world"), _sync_rank)
    refs = _sync_metrics(lambda name, **kw: getattr(jax_classification, name)(**kw, executor=False))
    for rank in range(2):
        for key, batches in _sync_data(rank).items():
            for batch in batches:
                refs[key].update(*(jnp.asarray(b) for b in batch))
    return results, {key: ref.compute() for key, ref in refs.items()}


SYNCED = [spec[0] for spec in _fixed_specs()] + ["exact", "hinge", "ranking", "fairness", "dice"]


@pytest.mark.parametrize("key", SYNCED)
def test_sync_two_ranks_matches_jax_on_concatenated_data(synced, key):
    results, refs = synced
    for rank in range(2):
        got, want = results[rank][key], refs[key]
        if isinstance(want, tuple):
            _close(got, want)
        elif isinstance(want, dict):
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
