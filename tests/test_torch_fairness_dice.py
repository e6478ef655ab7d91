"""The port's group fairness and Dice against the JAX package.

Group fairness: ``BinaryGroupStatRates`` and ``BinaryFairness`` (every
task) over probability, logit and label preds, ``ignore_index`` unset and
set, group ids outside [0, G) with ``validate_args=False`` (dropped, as
JAX's ``segment_sum`` drops them), tied group rates (the dict keys take
the first index), and the functionals, whose group ids need not be
contiguous. Dice: the label path (integer preds, float preds with a class
dimension at ``top_k`` None or 1) against JAX's one-hot formulation, with
labels outside [0, C); ``top_k=2``; the binary-probability path with
``ignore_index``; every ``average``; ``mdmc_average`` global and
samplewise; ``num_classes=None``. The same seeded numpy batches go through
the JAX metric (eager, ``executor=False``) or function and the port's on
the CPU: int32 counts bit-equal, float values within rtol 1e-5 / atol
1e-6, the fairness dict keys equal. The data of one modular
case per family (``_sync_data``, ``_sync_metrics``) is synced in the
slice's one two-rank gloo world, in ``test_torch_fixed_operating_point.py``
(a world costs its ranks' imports, about 3 s).

This module imports only torch, numpy and the port at its top level: the
gloo ranks import it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as classification
import torchmetrics_tpu_torch.functional as functional
from torchmetrics_tpu_torch.ops import kernels

N = 40
G = 4
C = 5
X = 3
RTOL = 1e-5
ATOL = 1e-6


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu.classification as jax_classification
    import torchmetrics_tpu.functional as jax_functional

    return jnp, jax_classification, jax_functional


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close(port, ref, exact=False):
    if isinstance(ref, dict):
        assert list(port) == list(ref)
        for key in ref:
            _close(port[key], ref[key], exact)
        return
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _states_equal(port, ref):
    assert port.metric_state.keys() == ref.metric_state.keys()
    for name, value in port.metric_state.items():
        want = ref.metric_state[name]
        if isinstance(value, list):
            _close(torch.cat(value), np.concatenate([np.asarray(w) for w in want]))
        else:
            assert value.dtype == torch.int32, name
            _close(value, want, exact=True)


def _run(port, ref, batches):
    jnp = _jax()[0]
    for batch in batches:
        ref.update(*(None if b is None else jnp.asarray(b) for b in batch))
        port.update(*(None if b is None else torch.from_numpy(b) for b in batch))


# ---------------------------------------------------------- group fairness


def _fairness_batches(kind, ignore_index, seed, groups=(0, G), n=2):
    """(preds, target, groups) with group ids drawn from ``range(*groups)``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        target = rng.randint(0, 2, N)
        if kind == "probs":
            preds = rng.rand(N).astype(np.float32)
        elif kind == "logits":
            preds = rng.randn(N).astype(np.float32)
        else:
            preds = rng.randint(0, 2, N)
        if ignore_index is not None:
            target[rng.rand(N) < 0.15] = ignore_index
        out.append((preds, target.astype(np.int64), rng.randint(*groups, N).astype(np.int64)))
    return out


def _fairness_cases():
    for name, task in (("BinaryGroupStatRates", None), ("BinaryFairness", "all"),
                       ("BinaryFairness", "demographic_parity"), ("BinaryFairness", "equal_opportunity")):
        for kind in ("probs", "logits", "labels"):
            for ignore in (None, -1):
                yield name, task, kind, ignore


@pytest.mark.parametrize("name,task,kind,ignore_index", list(_fairness_cases()))
def test_group_fairness_matches_jax(name, task, kind, ignore_index):
    _, jax_classification, _ = _jax()
    kw = {"num_groups": G, "ignore_index": ignore_index, "threshold": 0.4}
    if task is not None:
        kw["task"] = task
    ref = getattr(jax_classification, name)(**kw, executor=False)
    port = getattr(classification, name)(**kw, device="cpu")
    batches = _fairness_batches(kind, ignore_index, seed=len(name) + len(kind))
    if task == "demographic_parity":
        batches = [(p, None, g) for p, _, g in batches]
    _run(port, ref, batches)
    _states_equal(port, ref)
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", ["BinaryGroupStatRates", "BinaryFairness"])
def test_group_ids_outside_range_are_dropped(name):
    """Ids -2, -1, G and G + 1 with ``validate_args=False``: the counts are
    JAX's (``segment_sum`` drops them) and the port's count over ``4·G``
    bins drops them too."""
    _, jax_classification, _ = _jax()
    ref = getattr(jax_classification, name)(num_groups=G, validate_args=False, executor=False)
    port = getattr(classification, name)(num_groups=G, validate_args=False, device="cpu")
    _run(port, ref, _fairness_batches("probs", None, seed=5, groups=(-2, G + 2)))
    _states_equal(port, ref)
    assert int(port.tp.sum() + port.fp.sum() + port.tn.sum() + port.fn.sum()) < 2 * N
    _close(port.compute(), ref.compute())


def test_fairness_ties_resolve_to_the_first_group():
    """Groups 1 and 2 share the lowest rates and groups 0 and 3 the
    highest: the keys name the first of each, as ``jnp.argmin`` and
    ``jnp.argmax`` do."""
    _, jax_classification, _ = _jax()
    preds = np.array([1, 1, 0, 0, 0, 0, 1, 1], dtype=np.int64)
    target = np.array([1, 1, 1, 1, 1, 1, 1, 1], dtype=np.int64)
    groups = np.array([0, 0, 1, 1, 2, 2, 3, 3], dtype=np.int64)
    ref = jax_classification.BinaryFairness(num_groups=G, executor=False)
    port = classification.BinaryFairness(num_groups=G, device="cpu")
    _run(port, ref, [(preds, target, groups)])
    result = port.compute()
    assert list(result) == ["DP_1_0", "EO_1_0"]
    _close(result, ref.compute())


@pytest.mark.parametrize("fn", ["binary_fairness", "demographic_parity", "equal_opportunity", "binary_groups_stat_rates"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_fairness_functionals_match_jax(fn, ignore_index):
    """The functionals on non-contiguous group ids (3, 7, 10)."""
    jnp, _, jax_functional = _jax()
    preds, target, groups = _fairness_batches("probs", ignore_index, seed=9, n=1)[0]
    groups = np.array([3, 7, 10])[groups % 3]
    kw = {"ignore_index": ignore_index}
    if fn == "binary_groups_stat_rates":
        groups = groups % 3
        kw["num_groups"] = 3
    args = (preds, groups) if fn == "demographic_parity" else (preds, target, groups)
    _close(
        getattr(functional, fn)(*(torch.from_numpy(a) for a in args), **kw),
        getattr(jax_functional, fn)(*(jnp.asarray(a) for a in args), **kw),
    )


# -------------------------------------------------------------------- Dice


def _dice_batches(kind, seed, n=2, out_of_range=False):
    """``labels`` (N,), ``labels_md`` (N, X) integer preds; ``scores`` (N, C)
    probabilities; ``binary`` (N,) probabilities. With ``out_of_range`` a
    tenth of the labels are -1, C or C + 2."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        shape = (N, X) if kind == "labels_md" else (N,)
        target = rng.randint(0, 2 if kind == "binary" else C, shape)
        if kind == "scores":
            preds = rng.dirichlet(np.ones(C), N).astype(np.float32)
        elif kind == "binary":
            preds = rng.rand(N).astype(np.float32)
        else:
            preds = np.where(rng.rand(*shape) < 0.5, target, rng.randint(0, C, shape))
        if out_of_range:
            wild = np.array([-1, C, C + 2])
            target = np.where(rng.rand(*shape) < 0.1, rng.choice(wild, shape), target)
            if kind != "scores":
                preds = np.where(rng.rand(*shape) < 0.1, rng.choice(wild, shape), preds)
        out.append((preds, target.astype(np.int64)))
    return out


def _dice_cases():
    for average in ("micro", "macro", "weighted", "none"):
        for kind in ("labels", "labels_md", "scores"):
            for ignore in (None, 1):
                yield average, "global", kind, None, ignore, False
        yield average, "global", "scores", 2, None, False
        yield average, "global", "labels", None, None, True
        yield average, "samplewise", "labels_md", None, None, False
    yield "samples", "global", "labels_md", None, None, False
    yield "micro", "global", "binary", None, None, False
    yield "micro", "global", "binary", None, 0, False


@pytest.mark.parametrize("average,mdmc,kind,top_k,ignore_index,out_of_range", list(_dice_cases()))
def test_dice_matches_jax(average, mdmc, kind, top_k, ignore_index, out_of_range):
    jnp, jax_classification, jax_functional = _jax()
    kw = {"average": average, "mdmc_average": mdmc, "num_classes": C, "top_k": top_k, "ignore_index": ignore_index}
    ref = jax_classification.Dice(**kw, executor=False)
    port = classification.Dice(**kw, device="cpu")
    batches = _dice_batches(kind, seed=len(average) + len(kind), out_of_range=out_of_range)
    _run(port, ref, batches)
    _states_equal(port, ref)
    _close(port.compute(), ref.compute())
    for preds, target in batches:
        _close(
            functional.dice(torch.from_numpy(preds), torch.from_numpy(target), **kw),
            jax_functional.dice(jnp.asarray(preds), jnp.asarray(target), **kw),
        )


@pytest.mark.parametrize("kind", ["labels", "labels_md", "scores"])
def test_dice_num_classes_inferred(kind):
    """``num_classes=None`` (micro): C from the class dimension or the
    largest label, class-summed states."""
    _, jax_classification, _ = _jax()
    ref = jax_classification.Dice(executor=False)
    port = classification.Dice(device="cpu")
    _run(port, ref, _dice_batches(kind, seed=21))
    _states_equal(port, ref)
    assert tuple(port.tp.shape) == (1,)
    _close(port.compute(), ref.compute())


def test_dice_label_path_is_one_weightless_bincount():
    """The label path's tp/fp/fn come from one dispatch of ``bincount`` over
    (C+1)² bins, weightless."""
    preds, target = (torch.from_numpy(b) for b in _dice_batches("labels", seed=2, n=1, out_of_range=True)[0])
    kernels.reset_gate_log()
    functional.dice(preds, target, num_classes=C, average="none")
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": 1}


# ------------------------------------------- two-rank sync (the data)


def _sync_data(rank):
    return {
        "fairness": _fairness_batches("probs", -1, seed=70 + rank),
        "dice": _dice_batches("labels", seed=80 + rank, out_of_range=True),
    }


def _sync_metrics(build):
    return {
        "fairness": build("BinaryFairness", num_groups=G, ignore_index=-1),
        "dice": build("Dice", num_classes=C, average="macro", ignore_index=1),
    }
