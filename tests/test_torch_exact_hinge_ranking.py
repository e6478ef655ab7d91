"""The port's exact match, hinge loss and multilabel ranking metrics against
the JAX package.

Exact match in multiclass and multilabel form, ``multidim_average``
global and samplewise, ``ignore_index`` unset and set; hinge loss binary
and multiclass (``crammer-singer`` and ``one-vs-all``), plain and squared,
with logits and with ``ignore_index``; coverage error, label ranking
average precision and label ranking loss with tied scores and
``ignore_index``, and the ranking's row chunks against one pass. The same
seeded numpy batches go through the JAX metric (eager, ``executor=False``)
or function and the port's on the CPU: int32 counts bit-equal, float values
within rtol 1e-5 / atol 1e-6. The data of one modular
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
from torchmetrics_tpu_torch.functional.classification import ranking

N = 24
C = 4
L = 5
X = 3
RTOL = 1e-5
ATOL = 1e-6


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu.classification as jax_classification
    import torchmetrics_tpu.functional as jax_functional

    return jnp, jax_classification, jax_functional


def _close(port, ref, exact=False):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _states_equal(port, ref, exact_dtype):
    assert port.metric_state.keys() == ref.metric_state.keys()
    for name, value in port.metric_state.items():
        want = ref.metric_state[name]
        if isinstance(value, list):
            value, want = torch.cat(value), np.concatenate([np.asarray(w) for w in want])
        assert value.dtype == exact_dtype, name
        _close(value, want, exact=exact_dtype == torch.int32)


def _run(port, ref, batches):
    jnp = _jax()[0]
    for batch in batches:
        ref.update(*(jnp.asarray(b) for b in batch))
        port.update(*(torch.from_numpy(b) for b in batch))


# ---------------------------------------------------------------- the data


def _exact_batches(task, multidim, ignore_index, seed, n=2):
    """Multiclass (N, C[, X]) scores or labels; multilabel (N, L[, X])
    probabilities against 0/1 targets biased to match, so that exact
    matches occur."""
    rng = np.random.RandomState(seed)
    extra = (X,) if multidim == "samplewise" else ()
    out = []
    for _ in range(n):
        if task == "multiclass":
            target = rng.randint(0, C, (N, *extra))
            preds = np.where(rng.rand(N, *extra) < 0.8, target, rng.randint(0, C, (N, *extra)))
        else:
            target = rng.randint(0, 2, (N, L, *extra))
            flip = rng.rand(N, L, *extra) < 0.1
            preds = (np.where(flip, 1 - target, target) * 0.6 + 0.2 + rng.rand(N, L, *extra) * 0.1).astype(np.float32)
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.1] = ignore_index
        out.append((preds, target.astype(np.int64)))
    return out


def _hinge_batches(task, logits, ignore_index, seed, n=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if task == "binary":
            preds, target = rng.randn(N) if logits else rng.rand(N), rng.randint(0, 2, N)
        else:
            preds, target = rng.randn(N, C, 2) if logits else rng.dirichlet(np.ones(C), (N, 2)).transpose(0, 2, 1), rng.randint(0, C, (N, 2))
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.15] = ignore_index
        out.append((preds.astype(np.float32), target.astype(np.int64)))
    return out


def _ranking_batches(ignore_index, seed, n=2, rows=N, labels=L):
    """Scores on a 0.1 grid (ties within a row), a row with no relevant
    label and a row with every label relevant."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        preds = np.round(rng.rand(rows, labels), 1).astype(np.float32)
        target = rng.randint(0, 2, (rows, labels))
        target[0] = 0
        target[1] = 1
        if ignore_index is not None:
            target[rng.rand(rows, labels) < 0.1] = ignore_index
        out.append((preds, target.astype(np.int64)))
    return out


# ------------------------------------------------------------- exact match


def _exact_cases():
    for task in ("multiclass", "multilabel"):
        for multidim in ("global", "samplewise"):
            for ignore in (None, 2 if task == "multiclass" else -1):
                yield task, multidim, ignore


@pytest.mark.parametrize("task,multidim,ignore_index", list(_exact_cases()))
def test_exact_match_matches_jax(task, multidim, ignore_index):
    jnp, jax_classification, jax_functional = _jax()
    kw = {"multidim_average": multidim, "ignore_index": ignore_index}
    kw.update({"num_classes": C} if task == "multiclass" else {"num_labels": L})
    name = "MulticlassExactMatch" if task == "multiclass" else "MultilabelExactMatch"
    ref = getattr(jax_classification, name)(**kw, executor=False)
    port = getattr(classification, name)(**kw, device="cpu")
    batches = _exact_batches(task, multidim, ignore_index, seed=len(task) + len(multidim))
    _run(port, ref, batches)
    _states_equal(port, ref, torch.int32)
    _close(port.compute(), ref.compute())

    wrapper = classification.ExactMatch(task=task, **kw, device="cpu")
    assert type(wrapper).__name__ == name
    preds, target = batches[0]
    _close(
        functional.exact_match(torch.from_numpy(preds), torch.from_numpy(target), task=task, **kw),
        jax_functional.exact_match(jnp.asarray(preds), jnp.asarray(target), task=task, **kw),
    )


# -------------------------------------------------------------- hinge loss


def _hinge_cases():
    for squared in (False, True):
        for logits in (False, True):
            for ignore in (None, -1):
                yield "binary", None, squared, logits, ignore
                for mode in ("crammer-singer", "one-vs-all"):
                    yield "multiclass", mode, squared, logits, ignore


@pytest.mark.parametrize("task,mode,squared,logits,ignore_index", list(_hinge_cases()))
def test_hinge_loss_matches_jax(task, mode, squared, logits, ignore_index):
    jnp, jax_classification, jax_functional = _jax()
    kw = {"squared": squared, "ignore_index": ignore_index}
    if task == "multiclass":
        kw.update({"num_classes": C, "multiclass_mode": mode})
    name = "BinaryHingeLoss" if task == "binary" else "MulticlassHingeLoss"
    ref = getattr(jax_classification, name)(**kw, executor=False)
    port = getattr(classification, name)(**kw, device="cpu")
    batches = _hinge_batches(task, logits, ignore_index, seed=3 + squared + 2 * logits)
    _run(port, ref, batches)
    _states_equal(port, ref, torch.float32)
    _close(port.compute(), ref.compute())

    wrapper = classification.HingeLoss(task=task, **kw, device="cpu")
    assert type(wrapper).__name__ == name
    preds, target = batches[0]
    _close(
        functional.hinge_loss(torch.from_numpy(preds), torch.from_numpy(target), task=task, **kw),
        jax_functional.hinge_loss(jnp.asarray(preds), jnp.asarray(target), task=task, **kw),
    )


# ----------------------------------------------------------------- ranking

RANKING = {
    "MultilabelCoverageError": "multilabel_coverage_error",
    "MultilabelRankingAveragePrecision": "multilabel_ranking_average_precision",
    "MultilabelRankingLoss": "multilabel_ranking_loss",
}


@pytest.mark.parametrize("name", list(RANKING))
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_ranking_matches_jax(name, ignore_index):
    jnp, jax_classification, jax_functional = _jax()
    ref = getattr(jax_classification, name)(num_labels=L, ignore_index=ignore_index, executor=False)
    port = getattr(classification, name)(num_labels=L, ignore_index=ignore_index, device="cpu")
    batches = _ranking_batches(ignore_index, seed=len(name))
    _run(port, ref, batches)
    _states_equal(port, ref, torch.float32)
    _close(port.compute(), ref.compute())

    preds, target = batches[0]
    fn = RANKING[name]
    _close(
        getattr(functional, fn)(torch.from_numpy(preds), torch.from_numpy(target), num_labels=L, ignore_index=ignore_index),
        getattr(jax_functional, fn)(jnp.asarray(preds), jnp.asarray(target), num_labels=L, ignore_index=ignore_index),
    )


@pytest.mark.parametrize("update", ["_label_ranking_average_precision_update", "_label_ranking_loss_update"])
def test_ranking_row_chunks_equal_one_pass(update, monkeypatch):
    """Chunks of 3 rows (a (3, 10, 10) compare each, the last chunk short)
    give the one-pass per-sample values bit for bit."""
    preds, target = (torch.from_numpy(b) for b in _ranking_batches(None, seed=11, n=1, rows=23, labels=10)[0])
    fn = getattr(ranking, update)
    whole = fn(preds, target)
    monkeypatch.setattr(ranking, "_CHUNK_ELEMENTS", 3 * 10 * 10)
    chunked = fn(preds, target)
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)


# ------------------------------------------- two-rank sync (the data)


def _sync_data(rank):
    return {
        "exact": _exact_batches("multilabel", "global", -1, seed=40 + rank),
        "hinge": _hinge_batches("multiclass", True, -1, seed=50 + rank),
        "ranking": _ranking_batches(-1, seed=60 + rank),
    }


def _sync_metrics(build):
    return {
        "exact": build("MultilabelExactMatch", num_labels=L, ignore_index=-1),
        "hinge": build("MulticlassHingeLoss", num_classes=C, multiclass_mode="one-vs-all", ignore_index=-1),
        "ranking": build("MultilabelRankingAveragePrecision", num_labels=L, ignore_index=-1),
    }
