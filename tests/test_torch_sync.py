"""The port's cross-process sync (``torchmetrics_tpu_torch/parallel/sync.py``)
in spawned gloo worlds of 2 and 3 ranks, against the JAX package.

One world of each size runs every case below (``_rank_cases``) and returns
numpy results; the tests then hold them to the JAX package's
``sync_states`` in ``shard_map`` over a W-device slice of the 8-device CPU
mesh where the ranks' shapes are equal, and to the JAX package's
single-process result on the ranks' concatenation where they are ragged.
Integer results are compared as integers, bit for bit (the port counts in
int64 where JAX, with 64-bit types off, counts in int32); float results
within rtol 1e-5 (XLA's ``psum`` adds in another order).

Collectives are counted at the seams (``parallel.sync.all_reduces`` and
``all_gathers``): one ``all_reduce`` per (reduction, dtype) group, one
metadata gather for every gathered field of a call, one payload gather for
each field that holds data on some rank.

This module imports only torch, numpy and the port at its top level: the
ranks import it to find their target.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch import classification as cls
from torchmetrics_tpu_torch import image, regression, retrieval
from torchmetrics_tpu_torch.parallel import sync as psync
from helpers.torch_world import run_world

DTYPES = ("int32", "int64", "float32", "float64")
FUSED = ("sum", "mean", "max", "min")
C = 5
RTOL = 1e-5


def _spread(stack):
    """A callable reduction both frameworks evaluate alike."""
    return stack.sum(0) - stack[0]


REDUCTIONS = {"sum": "sum", "mean": "mean", "max": "max", "min": "min", "cat": "cat", "none": None, "callable": _spread}


# ----------------------------------------------------------------- the data


def _tensor_case(rank):
    """One field per reduction x dtype (bool too for max, min and None),
    equal shapes on every rank, plus two 0-d fields."""
    rng = np.random.RandomState(100 + rank)
    values, reds = {}, {}
    for rname, red in REDUCTIONS.items():
        for dt in DTYPES + (("bool",) if rname in ("max", "min", "none") else ()):
            if dt == "bool":
                v = rng.rand(3, 2) < 0.5
            elif dt.startswith("int"):
                v = rng.randint(-40, 40, (3, 2)).astype(dt)
            else:
                v = rng.randn(3, 2).astype(dt)
            values[f"{rname}_{dt}"], reds[f"{rname}_{dt}"] = v, red
    values["sum_scalar"], reds["sum_scalar"] = np.asarray(rng.randint(0, 9), np.int32), "sum"
    values["none_scalar"], reds["none_scalar"] = np.asarray(rng.randn(), np.float32), None
    return values, reds


def _list_case(rank, world):
    """List states: ragged lengths, a rank that saw no data (the last, in a
    world of 3), 2-D rows, bools, equal-length lists and an empty list
    everywhere."""
    rng = np.random.RandomState(200 + rank)
    empty = world > 2 and rank == world - 1

    def pieces(n, tail, dtype):
        return [(10 * rng.randn(rng.randint(1, 5), *tail)).astype(dtype) for _ in range(n)]

    values = {
        "cat_f32": pieces(rank + 1, (), "float32"),
        "cat_i64_empty_rank": [] if empty else [rng.randint(0, 99, rng.randint(1, 6)).astype(np.int64) for _ in range(2)],
        "none_f64_rows": [] if empty else pieces(2, (3,), "float64"),
        "cat_bool": [rng.rand(rng.randint(1, 4)) < 0.5 for _ in range(rank + 1)],
        "sum_f32_equal": [rng.randn(2).astype(np.float32) for _ in range(2)],
        "max_i32_equal": [rng.randint(-9, 9, (2, 2)).astype(np.int32)],
        "all_empty": [],
    }
    reds = {
        "cat_f32": "cat", "cat_i64_empty_rank": "cat", "none_f64_rows": None, "cat_bool": "cat",
        "sum_f32_equal": "sum", "max_i32_equal": "max", "all_empty": "cat",
    }
    return values, reds


def _mc_batches(rank, n, batch=16, seed=300):
    rng = np.random.RandomState(seed + rank)
    return [(rng.randn(batch, C).astype(np.float32), rng.randint(0, C, batch)) for _ in range(n)]


def _batches_per_rank(rank, world):
    """Ragged update counts; in a world of 3 the last rank sees nothing."""
    return 0 if (world > 2 and rank == world - 1) else rank + 2


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().copy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x


def _counting(fn):
    """``fn()`` and the collectives it issued through the seams."""
    r0, g0 = psync.all_reduces, psync.all_gathers
    out = fn()
    return out, (psync.all_reduces - r0, psync.all_gathers - g0)


# --------------------------------------------------------- the family data


def _family_data(rank, world):
    """Per-rank inputs of every synced family (numpy)."""
    n = _batches_per_rank(rank, world)
    rng = np.random.RandomState(400 + rank)
    return {
        "multiclass": _mc_batches(rank, n),
        "binary": [(rng.rand(16).astype(np.float32), rng.randint(0, 2, 16)) for _ in range(n)],
        "multilabel": [(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3))) for _ in range(n)],
        "retrieval": [
            (rng.randn(12).astype(np.float32), rng.randint(0, 2, 12), np.repeat(np.arange(3) + 10 * (4 * rank + i), 4))
            for i in range(n)
        ],
        "images": [(rng.rand(2, 1, 16, 16).astype(np.float32), rng.rand(2, 1, 16, 16).astype(np.float32)) for _ in range(n)],
        "features": [(rng.randn(6, 4).astype(np.float32), (rng.randn(6, 4) + 0.3).astype(np.float32)) for _ in range(n)],
        "losses": [rng.rand(4).astype(np.float32) for _ in range(n)],
        "regression": [_regression_batch(rng) for _ in range(n)],
    }


def _regression_batch(rng, rows=10):
    """Two correlated outputs, on scales far apart (the Chan merge's cross
    term carries the shift between the ranks' means)."""
    preds = rng.randn(rows, 2).astype(np.float32) * np.float32([1.0, 30.0]) + np.float32([0.0, 100.0])
    return preds, (0.8 * preds + rng.randn(rows, 2).astype(np.float32) * np.float32([0.5, 10.0])).astype(np.float32)


def _features(x):
    """The image families' feature extractor: the batch is its own features."""
    return x


def _families():
    """name -> (build, update) for every family the slice syncs."""

    def classification():
        return tm.MetricCollection(
            {
                "accuracy": cls.MulticlassAccuracy(num_classes=C, device="cpu"),
                "f1": cls.MulticlassF1Score(num_classes=C, device="cpu"),
                "confmat": cls.MulticlassConfusionMatrix(num_classes=C, device="cpu"),
                "specificity": cls.MulticlassSpecificity(num_classes=C, device="cpu"),
                "hamming": cls.MulticlassHammingDistance(num_classes=C, device="cpu"),
                "mcc": cls.MulticlassMatthewsCorrCoef(num_classes=C, device="cpu"),
                "kappa": cls.MulticlassCohenKappa(num_classes=C, weights="quadratic", device="cpu"),
            },
            device="cpu",
        )

    def binary():
        return tm.MetricCollection(
            {
                "specificity": cls.BinarySpecificity(device="cpu"),
                "hamming": cls.BinaryHammingDistance(device="cpu"),
                "mcc": cls.BinaryMatthewsCorrCoef(device="cpu"),
                "kappa": cls.BinaryCohenKappa(device="cpu"),
                "binned_auroc": cls.BinaryAUROC(thresholds=11, device="cpu"),
                "binned_ap": cls.BinaryAveragePrecision(thresholds=11, device="cpu"),
                "exact_auroc": cls.BinaryAUROC(thresholds=None, device="cpu"),
                "exact_ap": cls.BinaryAveragePrecision(thresholds=None, device="cpu"),
            },
            device="cpu",
        )

    def multilabel():
        return tm.MetricCollection(
            {
                "specificity": cls.MultilabelSpecificity(num_labels=3, device="cpu"),
                "hamming": cls.MultilabelHammingDistance(num_labels=3, device="cpu"),
                "mcc": cls.MultilabelMatthewsCorrCoef(num_labels=3, device="cpu"),
                "auroc": cls.MultilabelAUROC(num_labels=3, thresholds=11, device="cpu"),
            },
            device="cpu",
        )

    def retrieval_family():
        return tm.MetricCollection(
            {
                "map": retrieval.RetrievalMAP(device="cpu"),
                "mrr": retrieval.RetrievalMRR(device="cpu"),
                "ndcg": retrieval.RetrievalNormalizedDCG(top_k=3, device="cpu"),
            },
            device="cpu",
        )

    def ssim():
        return image.StructuralSimilarityIndexMeasure(data_range=1.0, kernel_size=7, device="cpu")

    def inception():
        return {
            "fid": image.FrechetInceptionDistance(feature_extractor=_features, num_features=4, device="cpu"),
            "kid": image.KernelInceptionDistance(feature_extractor=_features, subsets=3, subset_size=4, device="cpu"),
            "is": image.InceptionScore(feature_extractor=_features, splits=2, device="cpu"),
        }

    def aggregators():
        return tm.MetricCollection(
            {
                "sum": tm.SumMetric(device="cpu"),
                "mean": tm.MeanMetric(device="cpu"),
                "max": tm.MaxMetric(device="cpu"),
                "min": tm.MinMetric(device="cpu"),
                "cat": tm.CatMetric(device="cpu"),
                "running_mean": tm.RunningMean(window=3, device="cpu"),
                "running_sum": tm.RunningSum(window=3, device="cpu"),
            },
            device="cpu",
        )

    def regression_family():
        return tm.MetricCollection(
            {
                "pearson": regression.PearsonCorrCoef(num_outputs=2, device="cpu"),
                "concordance": regression.ConcordanceCorrCoef(num_outputs=2, device="cpu"),
                "mse": regression.MeanSquaredError(num_outputs=2, device="cpu"),
                "mae": regression.MeanAbsoluteError(device="cpu"),
                "r2": regression.R2Score(num_outputs=2, multioutput="raw_values", device="cpu"),
                "csi": regression.CriticalSuccessIndex(threshold=50.0, device="cpu"),
                "spearman": regression.SpearmanCorrCoef(num_outputs=2, device="cpu"),
                "kendall": regression.KendallRankCorrCoef(num_outputs=2, device="cpu"),
            },
            device="cpu",
        )

    def update_inception(ms, batch):
        real, fake = (_t(x) for x in batch)
        for m in (ms["fid"], ms["kid"]):
            m.update(real, real=True)
            m.update(fake, real=False)
        ms["is"].update(real)

    def compute_inception(ms):
        return {k: m.compute() for k, m in ms.items()}

    plain = (lambda m, b: m.update(*(_t(x) for x in b)), lambda m: m.compute())
    return {
        "multiclass": ("multiclass", classification, *plain),
        "binary": ("binary", binary, *plain),
        "multilabel": ("multilabel", multilabel, *plain),
        "retrieval": (
            "retrieval", retrieval_family,
            lambda m, b: m.update(_t(b[0]), _t(b[1]), indexes=_t(b[2])), lambda m: m.compute(),
        ),
        "ssim": ("images", ssim, *plain),
        "inception": ("features", inception, update_inception, compute_inception),
        "aggregators": ("losses", aggregators, lambda m, b: m.update(_t(b)), lambda m: m.compute()),
        "regression": ("regression", regression_family, *plain),
    }


def _family_values(name, batches):
    """The family's computed values after updating on ``batches``."""
    data_key, build, update, compute = _families()[name]
    m = build()
    for b in batches:
        update(m, b)
    return _np(compute(m))


# ------------------------------------------------------------- rank target


def _rank_cases(rank, world):
    """Every case, run on one rank of a gloo world; numpy results."""
    out = {}

    values, reds = _tensor_case(rank)
    states = {k: _t(v) for k, v in values.items()}
    synced, counts = _counting(lambda: psync.sync_states(states, reds))
    out["tensors"] = {
        "synced": _np(synced), "counts": counts,
        "untouched": all(np.array_equal(states[k].numpy(), values[k]) for k in values),
    }

    values, reds = _list_case(rank, world)
    states = {k: [_t(p) for p in v] for k, v in values.items()}
    synced, counts = _counting(lambda: psync.sync_states(states, reds))
    out["lists"] = {"synced": _np(synced), "counts": counts}

    # the ranks disagree on a list's dtype: every rank raises, none hangs
    mixed = [torch.ones(2, dtype=torch.float32 if rank == 0 else torch.float64)]
    try:
        psync.sync_value(mixed, "cat")
        out["mismatch"] = None
    except ValueError as err:
        out["mismatch"] = str(err)

    out["gather_all"] = _np(psync.gather_all_tensors(torch.arange(rank + 1)))

    # functional_sync strips, sums and re-attaches the update count
    m = cls.MulticlassStatScores(num_classes=C, average=None, device="cpu")
    for b in _mc_batches(rank, rank + 1, seed=500):
        m.update(*(_t(x) for x in b))
    synced, counts = _counting(lambda: m.functional_sync(m.state()))
    out["functional_sync"] = {"synced": _np(synced), "counts": counts, "local": _np(m.state())}

    # the collection: one sync_states for every leader
    coll = _config2()
    for b in _mc_batches(rank, 2, seed=600):
        coll.update(*(_t(x) for x in b))
    synced, counts = _counting(lambda: coll.functional_sync(coll.state()))
    out["collection_sync"] = {
        "synced": _np(synced), "counts": counts, "groups": [list(g) for g in coll.compute_groups.values()],
        "computed": _np(coll.functional_compute(synced)),
    }

    # a compute group shares its leader's tensors; sync never writes them
    group = tm.MetricCollection(
        {
            "precision": cls.MulticlassPrecision(num_classes=C, device="cpu"),
            "recall": cls.MulticlassRecall(num_classes=C, device="cpu"),
            "f1": cls.MulticlassF1Score(num_classes=C, device="cpu"),
        },
        device="cpu",
    )
    for b in _mc_batches(rank, 2, seed=700):
        group.update(*(_t(x) for x in b))
    members = [group[k] for k in ("precision", "recall", "f1")]
    local = {k: members[0]._state[k].clone() for k in ("tp", "fp", "tn", "fn")}
    shared = lambda: all(m._state[k] is members[0]._state[k] for m in members[1:] for k in local)  # noqa: E731
    shared_before = shared()
    computed = _np(group.compute())
    member_synced = []
    for m in members:
        m.sync()
        member_synced.append(_np({k: m._state[k] for k in local}))
    for m in members:
        m.unsync()
    out["compute_group"] = {
        "groups": [list(g) for g in group.compute_groups.values()],
        "computed": computed, "member_synced": member_synced, "local": _np(local),
        "after": [_np({k: m._state[k] for k in local}) for m in members],
        "shared_before": shared_before, "shared_after": shared(),
    }

    # dist_sync_on_step: forward returns the batch value over every rank
    mean = tm.MeanMetric(dist_sync_on_step=True, device="cpu")
    peak = tm.MaxMetric(dist_sync_on_step=True, device="cpu")
    steps = []
    for x in [np.random.RandomState(800 + rank + 10 * i).rand(3).astype(np.float32) for i in range(3)]:
        steps.append((_np(mean(_t(x))), _np(peak(_t(x)))))
    out["sync_on_step"] = {
        "steps": steps, "local": _np(mean.state()), "computed": (_np(mean.compute()), _np(peak.compute())),
    }

    # sync / unsync / sync_context by hand around a compute
    acc = cls.BinaryAccuracy(sync_on_compute=False, device="cpu")
    acc.update(_t(np.array([0.9, 0.2, 0.7])), _t(np.array([1, 0, rank % 2])))
    local_value = _np(acc.compute())
    acc.sync()
    synced_tp = _np(acc.tp)
    acc._computed = None
    synced_value = _np(acc.compute())  # on the synced state; its exit restores the local one
    unsynced_tp, is_synced = _np(acc.tp), acc._is_synced
    with acc.sync_context():
        in_context = _np(acc.tp)
    out["manual_sync"] = {
        "local_value": local_value, "synced_tp": synced_tp, "synced_value": synced_value,
        "unsynced_tp": unsynced_tp, "in_context": in_context, "is_synced": is_synced,
        "after_context": _np(acc.tp),
    }

    # every family, synced on compute
    data = _family_data(rank, world)
    families = {}
    for name, (key, build, update, compute) in _families().items():
        m = build()
        for b in data[key]:
            update(m, b)
        families[name] = _np(compute(m))
    out["families"] = families

    # Pearson's moment states, local and synced (a None reduction stacks
    # them, one entry a rank, and the compute merges the stack)
    pearson = regression.PearsonCorrCoef(num_outputs=2, device="cpu")
    for b in data["regression"]:
        pearson.update(*(_t(x) for x in b))
    out["pearson"] = {"local": _np(pearson.state()), "synced": _np(pearson.compute())}
    return out


def _config2():
    """The JAX package's config-2 collection (``bench.py``) at C classes."""
    return tm.MetricCollection(
        {
            "confmat": cls.MulticlassConfusionMatrix(num_classes=C, validate_args=False, device="cpu"),
            "f1": cls.MulticlassF1Score(num_classes=C, validate_args=False, device="cpu"),
            "precision": cls.MulticlassPrecision(num_classes=C, validate_args=False, device="cpu"),
            "recall": cls.MulticlassRecall(num_classes=C, validate_args=False, device="cpu"),
            "acc": cls.MulticlassAccuracy(num_classes=C, validate_args=False, device="cpu"),
        },
        device="cpu",
    )


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module", params=[2, 3], ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    w = request.param
    return w, run_world(w, tmp_path_factory.mktemp(f"gloo{w}"), _rank_cases)


def _jax_sync(per_rank, reductions):
    """The JAX package's ``sync_states`` in ``shard_map`` over W devices,
    rank r's state on device r (numpy in, numpy out)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torchmetrics_tpu.parallel.sync import shard_map_compat, sync_states

    w = len(per_rank)
    names = list(per_rank[0])
    lists = {n for n in names if isinstance(per_rank[0][n], list)}

    def as_jax(v):
        v = np.asarray(v)
        return v.astype({np.dtype("int64"): np.int32, np.dtype("float64"): np.float32}.get(v.dtype, v.dtype))

    stacked = [
        jnp.asarray(np.stack([as_jax(np.concatenate(s[n]) if n in lists else s[n]) for s in per_rank])) for n in names
    ]

    def body(*xs):
        st = {n: ([x[0]] if n in lists else x[0]) for n, x in zip(names, xs)}
        return sync_states(st, reductions, "batch")

    mesh = Mesh(np.array(jax.devices()[:w]), ("batch",))
    f = shard_map_compat(body, mesh, tuple(P("batch") for _ in names), P(), check_vma=False)
    return jax.tree_util.tree_map(np.asarray, f(*stacked))


def _same(port, ref, name=""):
    """Integers (and bools) bit for bit, as integers; floats within RTOL."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    if port.dtype.kind in "USO":
        np.testing.assert_array_equal(port, ref, err_msg=name)
    elif port.dtype.kind in "biu" and ref.dtype.kind in "biu":
        np.testing.assert_array_equal(port.astype(np.int64), ref.astype(np.int64), err_msg=name)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=1e-6, err_msg=name)


def _same_tree(port, ref, name=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), (name, set(port), set(ref))
        for k in ref:
            _same_tree(port[k], ref[k], f"{name}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), name
        for i, (a, b) in enumerate(zip(port, ref)):
            _same_tree(a, b, f"{name}[{i}]")
    else:
        _same(port, ref, name)


def _every_rank(results, key, fields=None):
    """The ranks' results for ``key`` (those ``fields`` of it), checked equal
    across ranks; rank 0's."""
    first = results[0][key]
    for r in results[1:]:
        for f in fields or [None]:
            _same_tree(r[key] if f is None else r[key][f], first if f is None else first[f], key)
    return first


# ------------------------------------------------------------------- tests


def test_every_reduction_and_dtype_matches_jax(world):
    w, results = world
    per_rank = [_tensor_case(r)[0] for r in range(w)]
    reds = _tensor_case(0)[1]
    ref = _jax_sync(per_rank, reds)
    port = _every_rank(results, "tensors")
    assert all(r["tensors"]["untouched"] for r in results)
    for name, value in port["synced"].items():
        _same(value, ref[name], name)
        red = reds[name]
        want_dtype = per_rank[0][name].dtype
        if red == "mean" and want_dtype.kind in "iu":
            want_dtype = np.dtype(np.float32)  # lax.pmean of ints is float32
        if not callable(red):
            assert value.dtype == want_dtype, (name, value.dtype)


def test_fused_groups_cost_one_all_reduce_each(world):
    w, results = world
    values, reds = _tensor_case(0)
    fused = {(reds[k], v.dtype) for k, v in values.items() if reds[k] in FUSED and v.dtype != bool}
    gathered = [k for k in values if (reds[k], values[k].dtype) not in fused]
    for r in results:
        assert r["tensors"]["counts"] == (len(fused), 1 + len(gathered))


def test_ragged_lists_and_an_empty_rank_match_jax(world):
    w, results = world
    cases = [_list_case(r, w) for r in range(w)]
    reds = cases[0][1]
    port = _every_rank(results, "lists")["synced"]
    # equal-length lists: the JAX package's sync in shard_map over W devices
    equal = ("sum_f32_equal", "max_i32_equal")
    ref = _jax_sync([{k: c[0][k] for k in equal} for c in cases], {k: reds[k] for k in equal})
    for k in equal:
        assert len(port[k]) == 1
        _same(port[k][0], ref[k][0], k)
    # ragged: the JAX package's single-process result on the concatenation
    for k in ("cat_f32", "cat_i64_empty_rank", "none_f64_rows", "cat_bool"):
        per_rank = [np.concatenate(c[0][k]) if c[0][k] else None for c in cases]
        concat = np.concatenate([p for p in per_rank if p is not None])
        one = _jax_sync([{k: [concat]}], {k: reds[k]})[k][0]
        if reds[k] is None:  # one entry per rank, an empty one for a rank without data
            assert len(port[k]) == w
            for got, want in zip(port[k], per_rank):
                assert got.shape[1:] == concat.shape[1:] and got.dtype == concat.dtype
                _same(got, want if want is not None else concat[:0], k)
            _same(np.concatenate(port[k]), one[0], k)
        else:
            assert len(port[k]) == 1 and port[k][0].dtype == concat.dtype
            _same(port[k][0], one, k)
    assert port["all_empty"] == []


def test_list_fields_share_one_metadata_gather(world):
    w, results = world
    values, _ = _list_case(0, w)
    with_data = [k for k in values if any(_list_case(r, w)[0][k] for r in range(w))]
    for r in results:
        assert r["lists"]["counts"] == (0, 1 + len(with_data))


def test_ranks_that_disagree_raise_together(world):
    w, results = world
    for r in results:
        assert r["mismatch"] is not None and "different dtypes" in r["mismatch"]


def test_gather_all_tensors_is_ragged(world):
    w, results = world
    for r in results:
        assert [x.tolist() for x in r["gather_all"]] == [list(range(k + 1)) for k in range(w)]


def test_functional_sync_sums_the_update_count_like_jax(world):
    import torchmetrics_tpu.classification as jax_cls

    w, results = world
    port = _every_rank(results, "functional_sync", fields=("synced", "counts"))
    assert port["counts"] == (2, 0)  # the int32 quartet, and the int64 count
    assert int(port["synced"]["_update_count"]) == sum(range(1, w + 1))
    per_rank = []
    for r in range(w):
        m = jax_cls.MulticlassStatScores(num_classes=C, average=None, executor=False)
        for b in _mc_batches(r, r + 1, seed=500):
            m.update(*b)
        per_rank.append({k: np.asarray(v) for k, v in m.state().items()})
    ref_m = jax_cls.MulticlassStatScores(num_classes=C, average=None, executor=False)
    ref = _functional_sync_jax(ref_m, per_rank)
    _same_tree(port["synced"], ref, "functional_sync")
    for r, res in enumerate(results):  # the local state is untouched
        _same_tree({k: v for k, v in res["functional_sync"]["local"].items() if k != "_update_count"},
                   {k: v for k, v in per_rank[r].items() if k != "_update_count"}, "local")


def _functional_sync_jax(metric, per_rank):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torchmetrics_tpu.parallel.sync import shard_map_compat

    w = len(per_rank)
    names = list(per_rank[0])
    stacked = [jnp.asarray(np.stack([np.asarray(s[n]) for s in per_rank])) for n in names]

    def body(*xs):
        return metric.functional_sync({n: x[0] for n, x in zip(names, xs)}, "batch")

    mesh = Mesh(np.array(jax.devices()[:w]), ("batch",))
    f = shard_map_compat(body, mesh, tuple(P("batch") for _ in names), P(), check_vma=False)
    return jax.tree_util.tree_map(np.asarray, f(*stacked))


def test_collection_functional_sync_fuses_every_leader(world):
    w, results = world
    port = _every_rank(results, "collection_sync")
    # every leader's int32 counts in one all_reduce, every count in one more
    assert port["counts"] == (2, 0)
    ref = _config2()
    for r in range(w):
        for b in _mc_batches(r, 2, seed=600):
            ref.update(*(_t(x) for x in b))
    expected = _np(ref.compute())
    _same_tree(port["computed"], expected, "collection")
    assert all(int(st["_update_count"]) == 2 * w for st in port["synced"].values())


def test_shared_compute_group_syncs_each_member_once(world):
    w, results = world
    ref = tm.MetricCollection(
        {
            "precision": cls.MulticlassPrecision(num_classes=C, device="cpu"),
            "recall": cls.MulticlassRecall(num_classes=C, device="cpu"),
            "f1": cls.MulticlassF1Score(num_classes=C, device="cpu"),
        },
        device="cpu",
    )
    for r in range(w):
        for b in _mc_batches(r, 2, seed=700):
            ref.update(*(_t(x) for x in b))
    expected_state = _np({k: ref["precision"]._state[k] for k in ("tp", "fp", "tn", "fn")})
    for res in results:
        g = res["compute_group"]
        assert g["groups"] == [["f1", "precision", "recall"]]
        assert g["shared_before"] and g["shared_after"]
        _same_tree(g["computed"], _np(ref.compute()), "computed")
        for synced in g["member_synced"]:  # the world's sum, never w times it
            _same_tree(synced, expected_state, "member_synced")
        for after in g["after"]:
            _same_tree(after, g["local"], "after")


def test_dist_sync_on_step_forward(world):
    w, results = world
    xs = [[np.random.RandomState(800 + r + 10 * i).rand(3).astype(np.float32) for i in range(3)] for r in range(w)]
    for r, res in enumerate(results):
        s = res["sync_on_step"]
        for i, (mean_v, peak_v) in enumerate(s["steps"]):
            batch = np.concatenate([xs[q][i] for q in range(w)])
            _same(mean_v, batch.mean(), "batch mean")
            _same(peak_v, batch.max(), "batch max")
        mine = np.concatenate(xs[r])
        _same(s["local"]["mean_value"], mine.sum(), "local state")  # the accumulation stays local
        everything = np.concatenate([np.concatenate(x) for x in xs])
        _same(s["computed"][0], everything.mean(), "computed mean")
        _same(s["computed"][1], everything.max(), "computed max")


def test_sync_and_unsync_around_compute(world):
    w, results = world
    tps = [int(0.7 > 0.5 and (r % 2) == 1) + 1 for r in range(w)]
    for r, res in enumerate(results):
        s = res["manual_sync"]
        assert int(s["synced_tp"]) == sum(tps) and int(s["in_context"]) == sum(tps)
        assert int(s["unsynced_tp"]) == int(s["after_context"]) == tps[r] and not s["is_synced"]
        correct = [2 + (r2 % 2) for r2 in range(w)]
        _same(s["synced_value"], sum(correct) / (3 * w), "synced accuracy")


@pytest.mark.parametrize("family", list(_families()), ids=str)
def test_synced_family_equals_one_process_on_all_data(world, family):
    """A family synced across the world computes what one process computes
    on every rank's batches, in rank order (integer counts bit for bit)."""
    w, results = world
    key = _families()[family][0]
    batches = [b for r in range(w) for b in _family_data(r, w)[key]]
    expected = _family_values(family, batches)
    if family == "aggregators":
        # RunningMean/RunningSum sync their windows with None: the synced
        # value covers every rank's last window
        windows = [_family_data(r, w)[key][-3:] for r in range(w)]
        expected["running_mean"] = np.mean([x.mean() for win in windows for x in win])
        expected["running_sum"] = np.sum([x.sum() for win in windows for x in win])
    for res in results:
        _same_tree(res["families"][family], expected, family)


def test_synced_pearson_equals_jax_chan_merge_of_the_rank_states(world):
    """Every rank's synced Pearson value is the JAX package's
    ``_final_aggregation`` (Chan merge) of the ranks' local moment states,
    then its compute (the port's int64 counts handed to JAX as float32,
    as its state holds them)."""
    import jax.numpy as jnp

    from torchmetrics_tpu.functional.regression.pearson import _final_aggregation, _pearson_corrcoef_compute

    w, results = world
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    stacked = [jnp.asarray(np.stack([r["pearson"]["local"][k] for r in results]).astype(np.float32)) for k in names]
    _, _, var_x, var_y, corr_xy, n_total = _final_aggregation(*stacked)
    expected = np.asarray(_pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total))
    assert int(np.asarray(n_total).sum()) == sum(int(r["pearson"]["local"]["n_total"].sum()) for r in results)
    for r in results:
        _same(r["pearson"]["synced"], expected, "pearson")
