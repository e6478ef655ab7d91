"""The port's retrieval metrics against the JAX package.

Every functional and every class goes through the same numpy inputs in both
packages on the CPU: scores with ties, NaN and -inf; ``top_k`` None, small,
and above the document count; ``adaptive_k``; graded targets for nDCG;
``max_fpr`` for AUROC; the four ``empty_target_action`` modes;
``ignore_index``; every ``aggregation``, a callable included; the
``capacity=`` buffers with their overflow warning; several updates; a
``MetricCollection``; and a JAX state export continued in the port.

Tolerance: rtol 1e-5, atol 1e-6 on float outputs. Both sides compute in
float32 and rank identically (a stable descending sort in both), but sums
and means run in another order, and ``1 / log2(pos + 2)`` differs by an ulp
between the two frameworks at about a quarter of the positions (nDCG).
States are equal.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jax_tm
import torchmetrics_tpu.functional as jax_functional
import torchmetrics_tpu.retrieval as jax_retrieval
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as functional
import torchmetrics_tpu_torch.retrieval as retrieval
from torchmetrics_tpu_torch.ops import kernels, topk_kernel
from torchmetrics_tpu_torch.utils.convert import load_numpy_state

RTOL = 1e-5
ATOL = 1e-6
IGNORE = -1


def _to_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(port, ref):
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_close(p, r)
        return
    port, ref = _to_numpy(port), _to_numpy(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _scores(rng, n, edges=True):
    """float32 scores rounded to 0.1 (ties), with NaN and -inf mixed in."""
    preds = np.round(rng.rand(n), 1).astype(np.float32)
    if edges:
        preds[rng.rand(n) < 0.05] = np.nan
        preds[rng.rand(n) < 0.05] = -np.inf
    return preds


# ------------------------------------------------------------------ functional

def _query(seed, n=24, graded=False, edges=True):
    rng = np.random.RandomState(seed)
    preds = _scores(rng, n, edges)
    target = rng.randint(0, 4, n) if graded else rng.randint(0, 2, n)
    return preds, target


FUNCTIONAL_CASES = [
    ("retrieval_precision", {}),
    ("retrieval_precision", {"top_k": 5}),
    ("retrieval_precision", {"top_k": 40}),
    ("retrieval_precision", {"top_k": 40, "adaptive_k": True}),
    ("retrieval_recall", {}),
    ("retrieval_recall", {"top_k": 5}),
    ("retrieval_fall_out", {}),
    ("retrieval_fall_out", {"top_k": 5}),
    ("retrieval_hit_rate", {}),
    ("retrieval_hit_rate", {"top_k": 1}),
    ("retrieval_average_precision", {}),
    ("retrieval_average_precision", {"top_k": 5}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_reciprocal_rank", {"top_k": 2}),
    ("retrieval_r_precision", {}),
    ("retrieval_normalized_dcg", {}),
    ("retrieval_normalized_dcg", {"top_k": 5}),
    ("retrieval_normalized_dcg", {"top_k": 40}),
    ("retrieval_auroc", {}),
    ("retrieval_auroc", {"top_k": 10}),
    ("retrieval_auroc", {"max_fpr": 0.5}),
    ("retrieval_auroc", {"top_k": 12, "max_fpr": 0.3}),
    ("retrieval_precision_recall_curve", {}),
    ("retrieval_precision_recall_curve", {"max_k": 6}),
    ("retrieval_precision_recall_curve", {"max_k": 40, "adaptive_k": True}),
]


def _case_id(name, kw):
    return "-".join([name.replace("retrieval_", ""), *(f"{k}={v}" for k, v in kw.items())])


@pytest.mark.parametrize("edges", [True, False], ids=["nan_inf_ties", "ties"])
@pytest.mark.parametrize("name,kw", [pytest.param(n, k, id=_case_id(n, k)) for n, k in FUNCTIONAL_CASES])
def test_functional_matches_jax(name, kw, edges):
    preds, target = _query(len(name) + len(kw), edges=edges)
    port = getattr(functional, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    ref = getattr(jax_functional, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
    _assert_close(port, ref)


@pytest.mark.parametrize("top_k", [None, 3, 50])
def test_ndcg_with_graded_targets_matches_jax(top_k):
    preds, target = _query(7, n=30, graded=True)
    port = functional.retrieval_normalized_dcg(torch.from_numpy(preds), torch.from_numpy(target), top_k=top_k)
    ref = jax_functional.retrieval_normalized_dcg(jnp.asarray(preds), jnp.asarray(target), top_k=top_k)
    _assert_close(port, ref)


@pytest.mark.parametrize(
    "name,args,kw",
    [
        ("retrieval_precision", ([0.1, 0.2], [0, 1, 1]), {}),  # shapes differ
        ("retrieval_precision", ([], []), {}),  # empty
        ("retrieval_precision", ([1, 2], [0, 1]), {}),  # integer scores
        ("retrieval_precision", ([0.1, 0.2], [0, 2]), {}),  # non-binary target
        ("retrieval_precision", ([0.1, 0.2], [0, 1]), {"top_k": 0}),
        ("retrieval_precision", ([0.1, 0.2], [0, 1]), {"adaptive_k": 1}),
        ("retrieval_auroc", ([0.1, 0.2], [0, 1]), {"max_fpr": 1.5}),
        ("retrieval_precision_recall_curve", ([0.1, 0.2], [0, 1]), {"max_k": -1}),
    ],
)
def test_functional_refuses_what_jax_refuses(name, args, kw):
    with pytest.raises(ValueError):
        getattr(jax_functional, name)(*(jnp.asarray(a) for a in args), **kw)
    with pytest.raises(ValueError):
        getattr(functional, name)(*(torch.tensor(a) for a in args), **kw)


# --------------------------------------------------------------------- modular

def _batches(seed, n_batches=3, n=40, queries=8, ignore=False, graded=False, edges=True):
    """``(preds, target, indexes)`` batches over shared query ids: ragged
    counts, query 0 with no relevant document and query 1 with no
    irrelevant one (the empty queries of recall and fall-out), and with
    ``ignore`` an ignored tenth of the targets."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        indexes = rng.randint(0, queries, n)
        preds = _scores(rng, n, edges)
        target = rng.randint(0, 4, n) if graded else rng.randint(0, 2, n)
        target[indexes == 0] = 0
        target[indexes == 1] = 1 if not graded else 2
        if ignore:
            target[rng.rand(n) < 0.1] = IGNORE
        out.append((preds, target.astype(np.int64), indexes.astype(np.int64)))
    return out


CLASSES = {
    "RetrievalMAP": {},
    "RetrievalMAP_k": {"top_k": 3},
    "RetrievalMRR": {"top_k": 4},
    "RetrievalPrecision": {"top_k": 3},
    "RetrievalPrecision_adaptive": {"top_k": 10, "adaptive_k": True},
    "RetrievalRecall": {"top_k": 2},
    "RetrievalFallOut": {"top_k": 3},
    "RetrievalHitRate": {"top_k": 1},
    "RetrievalRPrecision": {},
    "RetrievalNormalizedDCG": {"top_k": 5},
    "RetrievalAUROC": {},
    "RetrievalAUROC_max_fpr": {"max_fpr": 0.5},
    "RetrievalPrecisionRecallCurve": {"max_k": 6},
    "RetrievalPrecisionRecallCurve_all": {"adaptive_k": True},
    "RetrievalRecallAtFixedPrecision": {"min_precision": 0.4, "max_k": 5},
}


def _build(pkg, key, **kw):
    cls = key.split("_")[0]
    extra = {"executor": False} if pkg is jax_retrieval else {"device": "cpu"}
    return getattr(pkg, cls)(**CLASSES[key], **kw, **extra)


def _drive(metric, batches, framework):
    wrap = jnp.asarray if framework == "jax" else torch.from_numpy
    for preds, target, indexes in batches:
        metric.update(wrap(preds), wrap(target), indexes=wrap(indexes))
    return metric.compute()


def _compute_both(key, batches, **kw):
    """Both packages' results, or both packages' errors."""
    outcomes = []
    for pkg, fw in ((jax_retrieval, "jax"), (retrieval, "torch")):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                outcomes.append(("ok", _drive(_build(pkg, key, **kw), batches, fw)))
        except ValueError as err:
            outcomes.append(("error", str(err)))
    (ref_kind, ref), (port_kind, port) = outcomes
    assert port_kind == ref_kind, (port, ref)
    return port_kind, port, ref


@pytest.mark.parametrize("action", ["neg", "pos", "skip", "error"])
@pytest.mark.parametrize("key", list(CLASSES))
def test_metric_matches_jax(key, action):
    graded = key.startswith("RetrievalNormalizedDCG")
    kind, port, ref = _compute_both(key, _batches(len(key), graded=graded), empty_target_action=action)
    if kind == "ok":
        _assert_close(port, ref)
    else:
        assert port == ref


@pytest.mark.parametrize("key", ["RetrievalMAP", "RetrievalRecall", "RetrievalFallOut", "RetrievalNormalizedDCG", "RetrievalPrecisionRecallCurve"])
def test_ignore_index_matches_jax(key):
    batches = _batches(3 + len(key), ignore=True, graded=key == "RetrievalNormalizedDCG")
    _, port, ref = _compute_both(key, batches, ignore_index=IGNORE)
    _assert_close(port, ref)


def _jax_lower_mean(x, dim):
    return jnp.mean(x, axis=dim) * 0.5


def _torch_lower_mean(x, dim):
    return x.mean(dim) * 0.5


@pytest.mark.parametrize("aggregation", ["mean", "median", "min", "max", "callable"])
@pytest.mark.parametrize("key", ["RetrievalMAP", "RetrievalHitRate", "RetrievalNormalizedDCG", "RetrievalPrecisionRecallCurve"])
def test_aggregation_matches_jax(key, aggregation):
    batches = _batches(11, graded=key == "RetrievalNormalizedDCG")
    agg = {"jax": aggregation, "torch": aggregation}
    if aggregation == "callable":
        agg = {"jax": _jax_lower_mean, "torch": _torch_lower_mean}
    ref = _build(jax_retrieval, key, aggregation=agg["jax"])
    port = _build(retrieval, key, aggregation=agg["torch"])
    _assert_close(_drive(port, batches, "torch"), _drive(ref, batches, "jax"))


def test_median_is_the_lower_middle_value():
    values = torch.tensor([0.4, 0.1, 0.3, 0.2])
    from torchmetrics_tpu_torch.retrieval.base import _retrieval_aggregate

    assert float(_retrieval_aggregate(values, "median")) == float(torch.median(values)) == pytest.approx(0.2)


@pytest.mark.parametrize("capacity", [200, 50])
@pytest.mark.parametrize("key", ["RetrievalMAP", "RetrievalPrecision", "RetrievalNormalizedDCG"])
def test_capacity_buffers_match_jax(key, capacity):
    batches = _batches(21, ignore=True, graded=key == "RetrievalNormalizedDCG")
    ref = _build(jax_retrieval, key, capacity=capacity, ignore_index=IGNORE)
    port = _build(retrieval, key, capacity=capacity, ignore_index=IGNORE)
    overflow = capacity < sum(int((t != IGNORE).sum()) for _, t, _ in batches)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port_value = _drive(port, batches, "torch")
    assert overflow == any("capacity buffer overflowed" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_value = _drive(ref, batches, "jax")
    _assert_close(port_value, ref_value)
    assert port.preds_buffer.dtype == torch.float32 and port.indexes_buffer.dtype == torch.int32
    np.testing.assert_array_equal(port.preds_buffer.numpy(), np.asarray(ref.preds_buffer))
    np.testing.assert_array_equal(port.valid_buffer.numpy(), np.asarray(ref.valid_buffer))
    assert int(port.sample_count) == int(ref.sample_count)


@pytest.mark.parametrize("capacity", [None, 64])
@pytest.mark.parametrize(
    "target,message",
    [([0, 1, 2, 0], "binary"), ([IGNORE] * 4, "non-empty")],
)
def test_update_refuses_what_jax_refuses(capacity, target, message):
    args = (np.array([0.1, 0.4, 0.2, 0.3], np.float32), np.array(target), np.array([0, 0, 1, 1]))
    ref = jax_retrieval.RetrievalMAP(capacity=capacity, ignore_index=IGNORE, executor=False)
    port = retrieval.RetrievalMAP(capacity=capacity, ignore_index=IGNORE, device="cpu")
    with pytest.raises(ValueError, match=message):
        ref.update(*(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match=message):
        port.update(*(torch.from_numpy(a) for a in args))
    assert port.update_count == 0


def test_list_state_dtypes_and_values_match_jax():
    batches = _batches(31, ignore=True)
    ref = _build(jax_retrieval, "RetrievalMRR", ignore_index=IGNORE)
    port = _build(retrieval, "RetrievalMRR", ignore_index=IGNORE)
    _drive(ref, batches, "jax")
    _drive(port, batches, "torch")
    for name, dtype in (("indexes", torch.int32), ("preds", torch.float32), ("target", torch.float32)):
        got = getattr(port, name)
        assert all(v.dtype == dtype for v in got)
        np.testing.assert_array_equal(torch.cat(got).numpy(), np.concatenate([np.asarray(v) for v in getattr(ref, name)]))


def _collection(pkg):
    extra = {"executor": False} if pkg is jax_retrieval else {"device": "cpu"}
    top = jax_tm if pkg is jax_retrieval else tm
    return top.MetricCollection(
        {
            "mrr": pkg.RetrievalMRR(top_k=3, **extra),
            "ndcg": pkg.RetrievalNormalizedDCG(top_k=3, **extra),
            "map": pkg.RetrievalMAP(**extra),
            "precision": pkg.RetrievalPrecision(top_k=3, **extra),
            "recall": pkg.RetrievalRecall(top_k=5, **extra),
            "hit_rate": pkg.RetrievalHitRate(top_k=3, **extra),
        },
        **extra,
    )


@pytest.mark.parametrize("edges", [True, False], ids=["nan_scores", "finite_scores"])
def test_collection_matches_jax(edges):
    """With finite scores the six members share one compute group; a NaN
    score makes states compare unequal, so each member keeps its own."""
    batches = _batches(41, edges=edges)
    ref, port = _collection(jax_retrieval), _collection(retrieval)
    kernels.reset_gate_log()
    before = topk_kernel.launches
    for preds, target, indexes in batches:
        ref.update(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(indexes))
        port.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(indexes))
    got, want = port.compute(), ref.compute()
    assert set(got) == set(want)
    for k in want:
        _assert_close(got[k], want[k])
    assert [sorted(g) for g in port.compute_groups.values()] == [sorted(g) for g in ref.compute_groups.values()]
    assert len(port.compute_groups) == (6 if edges else 1)
    # the CPU collection never launches the kernel: precision, recall and hit
    # rate read their top-k sums from the plain body
    assert topk_kernel.launches == before
    assert kernels.gate_snapshot()["retrieval_topk_stats"]["selections"] == {"reference": 3}


@pytest.mark.parametrize("key", ["RetrievalMAP", "RetrievalFallOut"])
@pytest.mark.parametrize("capacity", [None, 300])
def test_load_numpy_state_continues_a_jax_state(key, capacity):
    batches = _batches(51 + len(key), n_batches=4)
    ref = _build(jax_retrieval, key, capacity=capacity)
    port = _build(retrieval, key, capacity=capacity)
    wrap = jnp.asarray
    for preds, target, indexes in batches[:3]:
        ref.update(wrap(preds), wrap(target), indexes=wrap(indexes))

    def leaf(k, v):
        if k == "_update_count":
            return v
        return [np.asarray(el) for el in v] if isinstance(v, list) else np.asarray(v)

    load_numpy_state(port, {k: leaf(k, v) for k, v in ref.state().items()})
    assert port.update_count == 3
    preds, target, indexes = batches[3]
    ref.update(wrap(preds), wrap(target), indexes=wrap(indexes))
    port.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(indexes))
    _assert_close(port.compute(), ref.compute())
