"""Class-axis state sharding of the PyTorch port
(``torchmetrics_tpu_torch/parallel/class_shard.py`` and the metrics that
adopt it) held to the JAX package on the same seeded inputs.

The layout, stack, gather, route and dense add are bit-equal to the JAX
package's at an odd class count (C = 257) over 1 to 8 shards: padded tails,
``ignore_index`` holes, labels of -1 and >= C (the JAX package drops them
with ``mode="drop"``; the port lands them on a safe cell with the value 0),
and shard counts that do not divide C. A class-sharded
``MulticlassConfusionMatrix`` and the stat-scores family equal their dense
twins and the JAX package's class-sharded values bit for bit (integer
states) or exactly (values computed from the same integers). Also held:
the eligibility rules of ``add_state``, the default shard count, and the
large-class count shared by both packages' dense paths (one 3C
``bincount`` past C^2 > 2^31 - 1 bins, tested by lowering the limit).
"""
import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.classification import (
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
    MulticlassStatScores,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.ops import fused_classification as fc
from torchmetrics_tpu_torch.parallel import class_shard as tcs
from torchmetrics_tpu_torch.utils.exceptions import TopologyMismatchError, TorchMetricsUserError

C = 257
SHARDS = [1, 2, 3, 5, 8]
CPU = "cpu"


def _jax():
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel import class_shard as jcs

    return jnp, jcs


def _np(x):
    return np.asarray(x)


def _labels(seed, n=3000, c=C, lo=-2, hi_extra=3):
    rng = np.random.RandomState(seed)
    rows = rng.randint(lo, c + hi_extra, n).astype(np.int32)
    cols = rng.randint(0, c, n).astype(np.int32)
    return rows, cols


# ------------------------------------------------------------ layout math


@pytest.mark.parametrize("shards", SHARDS)
def test_layout_and_bounds_equal_jax(shards):
    _, jcs = _jax()
    t, j = tcs.shard_layout(C, shards), jcs.shard_layout(C, shards)
    assert (t.shard_size, t.padded_classes) == (j.shard_size, j.padded_classes)
    assert [t.bounds(s) for s in range(shards)] == [j.bounds(s) for s in range(shards)]


def test_layout_rejects_bad_arguments():
    with pytest.raises(ValueError, match="num_classes"):
        tcs.shard_layout(0, 2)
    with pytest.raises(ValueError, match="num_shards"):
        tcs.shard_layout(5, 0)
    with pytest.raises(ValueError, match="shard must be"):
        tcs.shard_layout(5, 2).bounds(2)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("pad_value", [None, -7])
def test_stack_and_gather_equal_jax(shards, pad_value):
    jnp, jcs = _jax()
    rng = np.random.RandomState(shards)
    dense = rng.randint(-100, 100, (C, 3)).astype(np.int32)
    lt, lj = tcs.shard_layout(C, shards), jcs.shard_layout(C, shards)
    got = tcs.stack_dense(torch.from_numpy(dense), lt, pad_value=pad_value)
    want = jcs.stack_dense(jnp.asarray(dense), lj, pad_value=pad_value)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    back = tcs.gather_dense(got, lt)
    np.testing.assert_array_equal(back.numpy(), dense)
    # the gather is a view of the stack: a reshape and a trim, no copy
    assert back.data_ptr() == got.data_ptr()


@pytest.mark.parametrize("shards", SHARDS)
def test_route_with_inner_index_equals_jax(shards):
    jnp, jcs = _jax()
    rows, cols = _labels(10 + shards)
    lt, lj = tcs.shard_layout(C, shards), jcs.shard_layout(C, shards)
    stack = np.zeros((shards, lt.shard_size, C), np.int32)
    ones = np.ones(rows.shape, np.int32)
    got = tcs.route_scatter_add(torch.from_numpy(stack), torch.from_numpy(rows), torch.from_numpy(ones),
                                inner_idx=torch.from_numpy(cols), layout=lt)
    want = jcs.route_scatter_add(jnp.asarray(stack), jnp.asarray(rows), jnp.asarray(ones),
                                 inner_idx=jnp.asarray(cols), layout=lj)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    owned = (rows >= 0) & (rows < C)
    assert int(got.sum()) == int(owned.sum())
    assert not got.reshape(-1, C)[C:].any()  # the padded tail never lands


@pytest.mark.parametrize("shards", SHARDS)
def test_route_without_inner_index_equals_jax(shards):
    jnp, jcs = _jax()
    rows, _ = _labels(20 + shards, lo=-5, hi_extra=9)
    vals = np.random.RandomState(shards).randint(1, 9, rows.shape).astype(np.int32)
    lt, lj = tcs.shard_layout(C, shards), jcs.shard_layout(C, shards)
    stack = np.zeros((shards, lt.shard_size), np.int32)
    got = tcs.route_scatter_add(torch.from_numpy(stack), torch.from_numpy(rows), torch.from_numpy(vals), layout=lt)
    want = jcs.route_scatter_add(jnp.asarray(stack), jnp.asarray(rows), jnp.asarray(vals), layout=lj)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_route_is_out_of_place_and_int64_indexed():
    """The input stack is never written; a flat cell past 2^31 is formed
    in int64 (here the index math alone, on a tiny stack's metadata)."""
    lt = tcs.shard_layout(C, 3)
    stack = torch.zeros((3, lt.shard_size, C), dtype=torch.int32)
    rows, cols = _labels(7)
    out = tcs.route_scatter_add(stack, torch.from_numpy(rows), torch.ones(len(rows), dtype=torch.int32),
                                inner_idx=torch.from_numpy(cols), layout=lt)
    assert not stack.any() and out.any()
    big = tcs.shard_layout(81_313, 8)
    cell = torch.tensor([81_312], dtype=torch.int32).to(torch.int64) * 81_313 + 81_312
    assert int(cell) == 81_313**2 - 1 > 2**31 and big.padded_classes == 81_320


def test_route_and_gather_refuse_a_wrong_stack():
    lt = tcs.shard_layout(C, 3)
    with pytest.raises(TopologyMismatchError, match="layout expects"):
        tcs.gather_dense(torch.zeros((4, lt.shard_size)), lt)
    with pytest.raises(TopologyMismatchError, match="without inner_idx"):
        tcs.route_scatter_add(torch.zeros((3, lt.shard_size, 2)), torch.zeros(1, dtype=torch.int64), torch.ones(1), layout=lt)
    with pytest.raises(TopologyMismatchError, match="dense value"):
        tcs.stack_dense(torch.zeros(C + 1), lt)


@pytest.mark.parametrize("shards", SHARDS)
def test_add_dense_equals_jax(shards):
    jnp, jcs = _jax()
    rng = np.random.RandomState(30 + shards)
    lt, lj = tcs.shard_layout(C, shards), jcs.shard_layout(C, shards)
    stack = rng.randint(0, 5, (shards, lt.shard_size)).astype(np.int32)
    stack.reshape(-1)[C:] = 0
    dense = rng.randint(0, 50, C).astype(np.int32)
    got = tcs.add_dense(torch.from_numpy(stack), torch.from_numpy(dense), lt)
    want = jcs.add_dense(jnp.asarray(stack), jnp.asarray(dense), lj)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("fx,dtype", [("sum", torch.int32), ("max", torch.float32), ("min", torch.int32), ("mean", torch.float32)])
def test_identity_pad_value_equals_jax(fx, dtype):
    jnp, jcs = _jax()
    want = jcs.identity_pad_value(fx, {torch.int32: jnp.int32, torch.float32: jnp.float32}[dtype])
    assert tcs.identity_pad_value(fx, dtype) == float(want)


def test_default_shard_count_is_one_on_the_cpu(monkeypatch):
    """The JAX package defaults to ``jax.local_device_count()`` (8 on its
    virtual test mesh); the port to the CUDA device count for a card
    metric and 1 on the CPU (ROADMAP Queue C)."""
    assert tcs.default_class_shards() == 1
    assert tcs.default_class_shards(torch.device("cpu")) == 1
    assert MulticlassConfusionMatrix(num_classes=9, state_sharding="class_axis", device=CPU).confmat.shape == (1, 9, 9)
    monkeypatch.setenv(tcs.STATE_SHARDING_ENV, "class_axis")
    assert tcs.default_state_sharding() == "class_axis"
    monkeypatch.setenv(tcs.STATE_SHARDING_ENV, "bogus")
    with pytest.raises(ValueError, match="TORCHMETRICS_TPU_STATE_SHARDING"):
        tcs.default_state_sharding()


# ------------------------------------------------------------ the metrics


def _batches(seed, n_batches=3, n=400, c=C, ignore=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        target = rng.randint(0, c, n)
        if ignore is not None:
            target[rng.rand(n) < 0.1] = ignore
        preds = rng.randint(0, c, n)
        out.append((preds, target))
    return out


def _jax_metric(name, **kw):
    from torchmetrics_tpu import classification as jcls

    return getattr(jcls, name)(executor=False, **kw)


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("ignore", [None, -1, 7])
def test_confusion_matrix_sharded_equals_dense_and_jax(shards, ignore):
    import jax.numpy as jnp

    batches = _batches(shards, ignore=ignore)
    kw = {"num_classes": C, "ignore_index": ignore, "validate_args": False}
    sharded = MulticlassConfusionMatrix(state_sharding="class_axis", class_shards=shards, device=CPU, **kw)
    dense = MulticlassConfusionMatrix(device=CPU, **kw)
    jsharded = _jax_metric("MulticlassConfusionMatrix", state_sharding="class_axis", class_shards=shards, **kw)
    for p, t in batches:
        sharded.update(torch.from_numpy(p), torch.from_numpy(t))
        dense.update(torch.from_numpy(p), torch.from_numpy(t))
        jsharded.update(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_array_equal(sharded.confmat.numpy(), _np(jsharded.confmat))
    assert torch.equal(sharded.compute(), dense.compute())
    np.testing.assert_array_equal(sharded.compute().numpy(), _np(jsharded.compute()))
    assert sharded.state_spec()["fields"]["confmat"]["class_shards"] == shards


@pytest.mark.parametrize("shards", [2, 8])
def test_multilabel_confusion_matrix_sharded_equals_dense_and_jax(shards):
    import jax.numpy as jnp

    rng = np.random.RandomState(shards)
    labels = 13
    preds = rng.rand(64, labels).astype(np.float32)
    target = rng.randint(0, 2, (64, labels))
    target[rng.rand(64, labels) < 0.1] = -1
    kw = {"num_labels": labels, "ignore_index": -1, "validate_args": False}
    sharded = MultilabelConfusionMatrix(state_sharding="class_axis", class_shards=shards, device=CPU, **kw)
    dense = MultilabelConfusionMatrix(device=CPU, **kw)
    jsharded = _jax_metric("MultilabelConfusionMatrix", state_sharding="class_axis", class_shards=shards, **kw)
    sharded.update(torch.from_numpy(preds), torch.from_numpy(target))
    dense.update(torch.from_numpy(preds), torch.from_numpy(target))
    jsharded.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_array_equal(sharded.confmat.numpy(), _np(jsharded.confmat))
    assert torch.equal(sharded.compute(), dense.compute())


STAT_FAMILY = [
    ("MulticlassAccuracy", MulticlassAccuracy, {"average": "macro"}),
    ("MulticlassAccuracy", MulticlassAccuracy, {"average": "micro"}),
    ("MulticlassF1Score", MulticlassF1Score, {"average": "macro"}),
    ("MulticlassF1Score", MulticlassF1Score, {"average": None}),
    ("MulticlassPrecision", MulticlassPrecision, {"average": "weighted"}),
    ("MulticlassRecall", MulticlassRecall, {"average": "macro"}),
    ("MulticlassStatScores", MulticlassStatScores, {"average": None}),
]


@pytest.mark.parametrize("name,cls,extra", STAT_FAMILY, ids=[f"{n}-{e['average']}" for n, _, e in STAT_FAMILY])
@pytest.mark.parametrize("shards", [3, 8])
def test_stat_scores_family_sharded_equals_dense_and_jax(name, cls, extra, shards):
    import jax.numpy as jnp

    batches = _batches(100 + shards, ignore=-1)
    kw = {"num_classes": C, "ignore_index": -1, "validate_args": False, **extra}
    sharded = cls(state_sharding="class_axis", class_shards=shards, device=CPU, **kw)
    dense = cls(device=CPU, **kw)
    jsharded = _jax_metric(name, state_sharding="class_axis", class_shards=shards, **kw)
    for p, t in batches:
        sharded.update(torch.from_numpy(p), torch.from_numpy(t))
        dense.update(torch.from_numpy(p), torch.from_numpy(t))
        jsharded.update(jnp.asarray(p), jnp.asarray(t))
    eligible = extra["average"] != "micro"
    assert (sharded._class_layout("tp") is not None) == eligible
    for f in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(sharded._state[f].numpy(), _np(jsharded._state[f]))
    assert torch.equal(sharded.compute(), dense.compute())
    np.testing.assert_allclose(sharded.compute().numpy(), _np(jsharded.compute()), rtol=1e-6)


def test_class_sharded_collection_shares_one_count():
    """Accuracy and F1 class-sharded in one collection: one ``bincount``
    launch an update (their counts shared), the routed confusion matrix
    none; values equal to the dense collection's."""
    spy = {"n": 0}
    spec = kernels.get_kernel("bincount")
    counted = kernels.KernelSpec(name="bincount", reference=lambda *a, **k: (spy.__setitem__("n", spy["n"] + 1), spec.reference(*a, **k))[1], cuda=spec.cuda)
    kernels.register_kernel(counted)
    try:
        kw = {"num_classes": C, "validate_args": False}
        sharded = tm.MetricCollection({
            "confmat": MulticlassConfusionMatrix(state_sharding="class_axis", class_shards=4, device=CPU, **kw),
            "acc": MulticlassAccuracy(average="micro", state_sharding="class_axis", class_shards=4, device=CPU, **kw),
            "f1": MulticlassF1Score(average="macro", state_sharding="class_axis", class_shards=4, device=CPU, **kw),
        }, device=CPU)
        batches = _batches(5)
        for p, t in batches:
            sharded.update(torch.from_numpy(p), torch.from_numpy(t))
        assert spy["n"] == len(batches)
    finally:
        kernels.register_kernel(spec)
    dense = tm.MetricCollection({
        "confmat": MulticlassConfusionMatrix(device=CPU, **kw),
        "acc": MulticlassAccuracy(average="micro", device=CPU, **kw),
        "f1": MulticlassF1Score(average="macro", device=CPU, **kw),
    }, device=CPU)
    for p, t in batches:
        dense.update(torch.from_numpy(p), torch.from_numpy(t))
    a, b = sharded.compute(), dense.compute()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ eligibility


class _Probe(tm.Metric):
    def __init__(self, explicit=None, **kwargs):
        super().__init__(**kwargs)
        self.add_state("counts", torch.zeros(10, dtype=torch.int32), dist_reduce_fx="sum", state_sharding=explicit)
        self.add_state("scalar", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("seen", [], dist_reduce_fx="cat")
        self.add_state("custom", torch.zeros(10), dist_reduce_fx=lambda s: s.sum(0))

    def update(self, x):
        self.counts = self.counts

    def compute(self):
        return self.counts


def test_inherited_policy_shards_only_eligible_states():
    m = _Probe(state_sharding="class_axis", class_shards=3, device=CPU)
    assert m._state_shardings == {"counts": "class_axis", "scalar": "replicated", "seen": "replicated", "custom": "replicated"}
    assert tuple(m.counts.shape) == (3, 4)
    pinned = _Probe(explicit="replicated", state_sharding="class_axis", class_shards=3, device=CPU)
    assert tuple(pinned.counts.shape) == (10,)


@pytest.mark.parametrize("default,fx", [([], "cat"), (torch.tensor(0.0), "sum"), (torch.zeros(4), None), (torch.zeros(4), "cat")])
def test_explicit_class_axis_on_an_ineligible_state_raises(default, fx):
    m = tm.SumMetric(device=CPU)
    with pytest.raises(ValueError, match="requires a fixed-shape array"):
        m.add_state("x", default, dist_reduce_fx=fx, state_sharding="class_axis")


def test_bad_knobs_are_refused():
    with pytest.raises(ValueError, match="state_sharding"):
        tm.SumMetric(state_sharding="rows", device=CPU)
    with pytest.raises(ValueError, match="class_shards"):
        tm.SumMetric(class_shards=0, device=CPU)
    with pytest.raises(ValueError, match="`state_sharding` must be"):
        tm.SumMetric(device=CPU).add_state("x", torch.zeros(3), dist_reduce_fx="sum", state_sharding="rows")


def test_calibration_and_retrieval_pin_their_states_replicated():
    from torchmetrics_tpu_torch.classification import BinaryCalibrationError
    from torchmetrics_tpu_torch.retrieval import RetrievalMAP

    cal = BinaryCalibrationError(n_bins=10, state_sharding="class_axis", class_shards=4, device=CPU)
    assert set(cal._state_shardings.values()) == {"replicated"} and not cal._class_layouts
    ret = RetrievalMAP(state_sharding="class_axis", class_shards=4, device=CPU)
    assert set(ret._state_shardings.values()) == {"replicated"}


def test_load_state_re_splits_a_dense_or_differently_sharded_state():
    batches = _batches(9)
    src = MulticlassConfusionMatrix(num_classes=C, state_sharding="class_axis", class_shards=8, device=CPU, validate_args=False)
    for p, t in batches:
        src.update(torch.from_numpy(p), torch.from_numpy(t))
    dense = MulticlassConfusionMatrix(num_classes=C, device=CPU, validate_args=False)
    dense.load_state(src.state())  # a stacked snapshot into a dense twin
    three = MulticlassConfusionMatrix(num_classes=C, state_sharding="class_axis", class_shards=3, device=CPU, validate_args=False)
    three.load_state(src.state())  # 8 class shards into 3
    back = MulticlassConfusionMatrix(num_classes=C, state_sharding="class_axis", class_shards=8, device=CPU, validate_args=False)
    back.load_state(dense.state())  # dense into 8 class shards
    want = src.compute()
    for m in (dense, three, back):
        assert torch.equal(m.compute(), want)
    assert torch.equal(back.confmat, src.confmat)


# ------------------------------------------------- the large-class count


@pytest.mark.parametrize("ignore", [None, -1, 3])
@pytest.mark.parametrize("average", ["micro", "macro", None])
def test_large_class_stat_scores_take_one_3c_count(monkeypatch, ignore, average):
    """Past ``ROW_BINS_LIMIT`` C^2 bins (lowered here to 10,000 so C = 101
    passes it) the stat scores count 3C bins in ONE launch an update, bit-
    equal to the C x C derivation and to the JAX package."""
    import jax.numpy as jnp

    c = 101
    batches = _batches(77, c=c, ignore=ignore)
    kw = {"num_classes": c, "ignore_index": ignore, "average": average, "validate_args": False}
    small = MulticlassStatScores(device=CPU, **kw)
    for p, t in batches:
        small.update(torch.from_numpy(p), torch.from_numpy(t))
    monkeypatch.setattr(fc, "ROW_BINS_LIMIT", 10_000)
    seen = []
    real = fc._counts
    monkeypatch.setattr(fc, "_counts", lambda idx, length: (seen.append(length), real(idx, length))[1])
    large = MulticlassStatScores(device=CPU, **kw)
    for p, t in batches:
        large.update(torch.from_numpy(p), torch.from_numpy(t))
    assert seen == [3 * c] * len(batches)
    assert torch.equal(large.compute(), small.compute())
    jm = _jax_metric("MulticlassStatScores", **kw)
    for p, t in batches:
        jm.update(jnp.asarray(p), jnp.asarray(t))
    for f in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(large._state[f].numpy(), _np(jm._state[f]))
    # a macro average is a float32 mean, summed in another order by XLA
    np.testing.assert_allclose(large.compute().numpy(), _np(jm.compute()), rtol=1e-6)


def test_out_of_range_targets_count_alike_in_both_counts(monkeypatch):
    c = 50
    rng = np.random.RandomState(4)
    target = torch.from_numpy(rng.randint(-3, c + 4, 2000))
    preds = torch.from_numpy(rng.randint(0, c, 2000))
    want = fc.multiclass_stats(fc.multiclass_confusion_counts(preds, target, c, None))
    got = fc.multiclass_class_stats(preds, target, c, None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dense_confusion_matrix_past_the_limit_names_class_axis(monkeypatch):
    """The smallest failing input of the shared fault is C = 46,341
    (C^2 > 2^31 - 1): a dense matrix there raises instead of wrapping."""
    assert 46_340**2 <= fc.ROW_BINS_LIMIT < 46_341**2
    monkeypatch.setattr(fc, "ROW_BINS_LIMIT", 10_000)
    with pytest.raises(TorchMetricsUserError, match='state_sharding="class_axis"'):
        MulticlassConfusionMatrix(num_classes=101, device=CPU)
    sharded = MulticlassConfusionMatrix(num_classes=101, state_sharding="class_axis", class_shards=4, device=CPU)
    sharded.update(torch.tensor([3, 100]), torch.tensor([3, 5]))
    assert int(sharded.compute().sum()) == 2 and int(sharded.compute()[5, 100]) == 1


def test_counters_count_sharded_states_and_routed_updates():
    from torchmetrics_tpu_torch import obs

    obs.reset()
    m = MulticlassConfusionMatrix(num_classes=C, state_sharding="class_axis", class_shards=2, device=CPU)
    m.update(torch.tensor([1, 2]), torch.tensor([1, 0]))
    counters = obs.counters_snapshot()
    assert not obs.telemetry_enabled() or (
        counters.get("shards.class_sharded_states", 0) >= 1 and counters.get("shards.routed_updates", 0) >= 1
    )
