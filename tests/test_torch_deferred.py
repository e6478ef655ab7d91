"""The deferred (stacked) layouts of the PyTorch port held to the JAX
package: ``init_sharded_state``, per-shard ``functional_update`` and
``reduce_sharded_state`` against the JAX package's ``shard_map`` over the
8-device virtual CPU mesh (one port shard a mesh device, the batch split in
8 contiguous slices as ``shard_map`` splits it), for a metric and for a
collection with compute groups, bit for bit and against the eager metric;
``reshard_state`` 8 -> 3 -> 1 and 1 -> 8 against the JAX package's
``reshard_states`` (and its refusal of ``cat`` fields); the elastic restore
of a JAX-written 8-shard snapshot onto 4 shards and onto 1; a class-layout
change refused under ``"strict"`` and re-split under ``"elastic"``;
``ShardShadow`` directly; the deferred flags.

Float inputs are integer-valued, so sums are exact in any order.
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
)
from torchmetrics_tpu_torch.io import checkpoint as tckpt
from torchmetrics_tpu_torch.ops.async_read import drain_pipeline
from torchmetrics_tpu_torch.parallel import reshard as treshard
from torchmetrics_tpu_torch.utils.exceptions import TopologyMismatchError, TorchMetricsUserError

C = 7
SHARDS = 8
CPU = "cpu"
GROUPS = [["f1", "precision", "recall"], ["accuracy"], ["confmat"]]


def _batches(seed=0, steps=3, rows=8 * 12):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, C, rows), rng.randint(0, C, rows)) for _ in range(steps)]


def _members(kind):
    if kind == "jax":
        from torchmetrics_tpu import classification as m

        kw = {"executor": False}
    else:
        m = __import__("torchmetrics_tpu_torch.classification", fromlist=["x"])
        kw = {"device": CPU}
    return {
        "accuracy": m.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, **kw),
        "f1": m.MulticlassF1Score(num_classes=C, validate_args=False, **kw),
        "precision": m.MulticlassPrecision(num_classes=C, validate_args=False, **kw),
        "recall": m.MulticlassRecall(num_classes=C, validate_args=False, **kw),
        "confmat": m.MulticlassConfusionMatrix(num_classes=C, validate_args=False, **kw),
    }


def _jax_collection():
    import torchmetrics_tpu as jtm

    return jtm.MetricCollection(_members("jax"), compute_groups=GROUPS, executor=False)


def _torch_collection(**kw):
    return tm.MetricCollection(_members("torch"), compute_groups=GROUPS, device=CPU, **kw)


def _jax_mesh_run(obj, batches, collection):
    """The JAX package's deferred loop: local updates in ``shard_map`` over
    8 devices, then the one reduce; returns (stacked states, reduced)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from torchmetrics_tpu.parallel.sync import reshard_local_state, shard_map_compat, unshard_local_state

    mesh = Mesh(np.array(jax.devices()[:SHARDS]), ("batch",))
    spec = obj.sharded_state_spec("batch")

    def body(st, *args):
        return reshard_local_state(obj.functional_update(unshard_local_state(st), *args))

    step = jax.jit(shard_map_compat(body, mesh, (spec,) + (P("batch"),) * len(batches[0]), spec))
    st = obj.init_sharded_states(SHARDS) if collection else obj.init_sharded_state(SHARDS)
    for args in batches:
        st = step(st, *(jnp.asarray(a) for a in args))
    reduce = obj.reduce_sharded_states if collection else obj.reduce_sharded_state
    red = jax.jit(shard_map_compat(lambda s: reduce(s, "batch"), mesh, (spec,), P()))(st)
    return st, red


def _port_run(obj, batches, collection):
    """The port's deferred loop: shard s updates rows [s*k, (s+1)*k) of a batch."""
    st = obj.init_sharded_states(SHARDS) if collection else obj.init_sharded_state(SHARDS)
    for args in batches:
        k = len(args[0]) // SHARDS
        shards = []
        for s in range(SHARDS):
            rows = slice(s * k, (s + 1) * k)
            sub = {l: {f: v[s] for f, v in x.items()} for l, x in st.items()} if collection else {f: v[s] for f, v in st.items()}
            shards.append(obj.functional_update(sub, *(torch.from_numpy(a[rows]) for a in args)))
        if collection:
            st = {l: {f: torch.stack([sh[l][f] for sh in shards]) for f in st[l]} for l in st}
        else:
            st = {f: torch.stack([sh[f] for sh in shards]) for f in st}
    reduce = obj.reduce_sharded_states if collection else obj.reduce_sharded_state
    return st, reduce(st)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _assert_tree_equal(got[k], want[k])
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), (g.dtype, w.dtype)


@pytest.mark.parametrize("name", ["MulticlassConfusionMatrix", "MulticlassF1Score", "MeanMetric", "MaxMetric"])
def test_deferred_metric_equals_jax_shard_map_and_eager(name):
    import torchmetrics_tpu as jtm
    from torchmetrics_tpu import classification as jcls

    batches = _batches(seed=len(name))
    if name.startswith("Multiclass"):
        j = getattr(jcls, name)(num_classes=C, validate_args=False, executor=False)
        t = getattr(__import__("torchmetrics_tpu_torch.classification", fromlist=["x"]), name)(
            num_classes=C, validate_args=False, device=CPU, reduce="deferred")
        data = batches
    else:
        j = getattr(jtm, name)(executor=False)
        t = getattr(tm, name)(device=CPU, reduce="deferred")
        data = [(p.astype(np.float32),) for p, _ in batches]
    jst, jred = _jax_mesh_run(j, data, collection=False)
    tst, tred = _port_run(t, data, collection=False)
    _assert_tree_equal(tst, jst)
    _assert_tree_equal(tred, jred)
    eager = t.clone()
    eager.reset()
    for args in data:
        eager.update(*(torch.from_numpy(a) for a in args))
    _assert_tree_equal(tred, {k: eager._state[k] for k in t._defaults})
    assert t.sharded_state_spec() == {k: 0 for k in t._defaults}


def test_deferred_collection_with_compute_groups_equals_jax_shard_map_and_eager():
    batches = _batches(seed=5)
    j, t = _jax_collection(), _torch_collection(reduce="deferred")
    jst, jred = _jax_mesh_run(j, batches, collection=True)
    tst, tred = _port_run(t, batches, collection=True)
    assert set(tst) == {"f1", "accuracy", "confmat"}
    _assert_tree_equal(tst, jst)
    _assert_tree_equal(tred, jred)
    eager = _torch_collection()
    for p, q in batches:
        eager.update(torch.from_numpy(p), torch.from_numpy(q))
    _assert_tree_equal(tred, {l: {k: v for k, v in st.items() if k != "_update_count"} for l, st in eager.state().items()})
    want = eager.compute()
    got = t.functional_compute(tred)
    assert all(torch.equal(got[k], want[k]) for k in want)


def _stack_case(seed=1):
    rng = np.random.RandomState(seed)
    states = {
        "s": rng.randint(-9, 9, (SHARDS, 4, 3)).astype(np.int32),
        "m": rng.randint(-9, 9, (SHARDS, 5)).astype(np.float32),
        "hi": rng.randint(-9, 9, (SHARDS, 2)).astype(np.float32),
        "lo": rng.randint(-9, 9, (SHARDS, 6)).astype(np.int32),
    }
    reds = {"s": "sum", "m": "mean", "hi": "max", "lo": "min"}
    return states, reds


@pytest.mark.parametrize("path", [(8, 3, 1), (8, 1), (8, 5, 8)])
def test_reshard_states_is_bit_equal_to_jax(path):
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel import reshard as jreshard

    states, reds = _stack_case()
    t = {k: torch.from_numpy(v) for k, v in states.items()}
    j = {k: jnp.asarray(v) for k, v in states.items()}
    for a, b in zip(path, path[1:]):
        t = treshard.reshard_states(t, treshard.ShardLayout(a), treshard.ShardLayout(b), reds)
        j = jreshard.reshard_states(j, jreshard.ShardLayout(a), jreshard.ShardLayout(b), reds)
        _assert_tree_equal(t, j)
    folded = treshard.fold_canonical(t, reds)
    _assert_tree_equal(folded, jreshard.fold_canonical(j, reds))


def test_reshard_one_to_eight_and_the_metric_face():
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel import reshard as jreshard

    states, reds = _stack_case(2)
    one = {k: v[:1] for k, v in states.items()}
    t = treshard.reshard_states({k: torch.from_numpy(v) for k, v in one.items()}, treshard.ShardLayout(1), treshard.ShardLayout(8), reds)
    j = jreshard.reshard_states({k: jnp.asarray(v) for k, v in one.items()}, jreshard.ShardLayout(1), jreshard.ShardLayout(8), reds)
    _assert_tree_equal(t, j)
    m = MulticlassConfusionMatrix(num_classes=C, device=CPU)
    st = m.init_sharded_state(SHARDS)
    st = {"confmat": st["confmat"] + torch.arange(SHARDS, dtype=torch.int32).reshape(-1, 1, 1)}
    three = m.reshard_state(st, 3)
    assert three["confmat"].shape == (3, C, C) and torch.equal(three["confmat"].sum(0), st["confmat"].sum(0))
    assert m.reshard_state(st, SHARDS)["confmat"] is st["confmat"]  # N == N: unchanged


def test_reshard_refuses_cat_and_custom_fields():
    states = {"c": torch.zeros((4, 3)), "n": torch.zeros((4, 2)), "f": torch.zeros((4, 2))}
    for name, fx in (("c", "cat"), ("n", None), ("f", lambda x: x.sum(0))):
        with pytest.raises(TopologyMismatchError, match="cannot be re-split"):
            treshard.reshard_states({name: states[name]}, treshard.ShardLayout(4), treshard.ShardLayout(2), {name: fx})
    with pytest.raises(TopologyMismatchError, match="from_layout declares"):
        treshard.reshard_states({"c": states["c"]}, treshard.ShardLayout(3), treshard.ShardLayout(2), {"c": "sum"})
    with pytest.raises(TopologyMismatchError, match="no derivable segment merge"):
        treshard.merge_folded({"n": torch.zeros(2)}, {"n": torch.zeros(2)}, {"n": None})
    merged = treshard.merge_folded(
        {"s": torch.ones(2), "m": torch.ones(2), "c": torch.ones(1)},
        {"s": torch.ones(2), "m": 2 * torch.ones(2), "c": torch.zeros(1)},
        {"s": "sum", "m": "max", "c": "cat"},
    )
    assert merged["s"].tolist() == [2, 2] and merged["m"].tolist() == [2, 2] and merged["c"].tolist() == [1, 0]


def test_reshard_with_class_layouts_re_splits_both_topologies():
    from torchmetrics_tpu_torch.parallel import class_shard as tcs

    dense = torch.arange(2 * 11, dtype=torch.int32).reshape(2, 11)  # two data shards of 11 classes
    a, b = tcs.shard_layout(11, 4), tcs.shard_layout(11, 3)
    stacked = torch.stack([tcs.stack_dense(d, a) for d in dense])
    canon = treshard.fold_canonical({"x": stacked}, {"x": "sum"}, {"x": a})
    assert torch.equal(canon["x"], dense.sum(0))
    back = treshard.expand_canonical(canon, {"x": "sum"}, 3, {"x": b})
    assert back["x"].shape == (3, 3, 4) and torch.equal(tcs.gather_dense(back["x"].sum(0), b), dense.sum(0))


# ------------------------------------------------------------ checkpoints


def _jax_snapshot(tmp_path, batches):
    import jax.numpy as jnp

    from torchmetrics_tpu.io import checkpoint as jckpt

    jc = _jax_collection()
    jst, _ = _jax_mesh_run(jc, batches, collection=True)
    export = {l: {**{k: jnp.asarray(v) for k, v in st.items()}, "_update_count": len(batches)} for l, st in jst.items()}
    return jckpt.save_state(jc, str(tmp_path / "jax8.ckpt"), states=export, sharded=True), jst


@pytest.mark.parametrize("to_shards", [4, 1, None])
def test_a_jax_eight_shard_snapshot_restores_elastic(tmp_path, to_shards):
    batches = _batches(seed=9)
    path, jst = _jax_snapshot(tmp_path, batches)
    target = _torch_collection(reduce="deferred")
    with pytest.raises(TopologyMismatchError, match="8-shard stacked state"):
        tckpt.restore_state(path, _torch_collection(), num_shards=to_shards or 3)
    manifest = tckpt.restore_state(path, target, topology="elastic", num_shards=to_shards)
    eager = _torch_collection()
    for p, t in batches:
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
    want = {l: {k: v for k, v in st.items() if k != "_update_count"} for l, st in eager.state().items()}
    if to_shards is None:
        assert manifest["topology_action"] == "fold"
        _assert_tree_equal({l: {k: v for k, v in st.items() if k != "_update_count"} for l, st in target.state().items()}, want)
        return
    assert manifest["topology_action"] == "reshard"
    assert target.executor_status["deferred_pending"]
    stacked = {l: {k: v for k, v in st.items() if k not in tm.Metric._RESERVED_STATE_KEYS} for l, st in target.state().items()}
    assert all(v.shape[0] == to_shards for st in stacked.values() for v in st.values())
    _assert_tree_equal(target.reduce_sharded_states(stacked), want)
    assert target.compute()["confmat"].sum() == sum(len(t) for _, t in batches)  # folds on demand


def test_a_class_layout_change_is_refused_strict_and_re_split_elastic(tmp_path):
    batches = _batches(seed=3)
    src = MulticlassConfusionMatrix(num_classes=C, state_sharding="class_axis", class_shards=4, device=CPU)
    for p, t in batches:
        src.update(torch.from_numpy(p), torch.from_numpy(t))
    path = tckpt.save_state(src, str(tmp_path / "cls.ckpt"))
    assert tckpt.load_manifest(path)["topology"]["state_sharding"] == 4
    other = MulticlassConfusionMatrix(num_classes=C, state_sharding="class_axis", class_shards=3, device=CPU)
    with pytest.raises(TopologyMismatchError, match="4 class shard"):
        tckpt.restore_state(path, other)
    assert tckpt.restore_state(path, other, topology="elastic")["topology_action"] == "class_reshard"
    assert torch.equal(other.compute(), src.compute()) and other.confmat.shape == (3, 3, C)
    dense = MulticlassConfusionMatrix(num_classes=C, device=CPU)
    assert tckpt.restore_state(path, dense, topology="elastic")["topology_action"] == "class_reshard"
    assert torch.equal(dense.compute(), src.compute())
    same = MulticlassConfusionMatrix(num_classes=C, state_sharding="class_axis", class_shards=4, device=CPU)
    assert tckpt.restore_state(path, same)["topology_action"] == "match"


# ------------------------------------------------------------ the shadow


def test_shard_shadow_refreshes_on_the_read_pipeline():
    reds = {"leader": {"s": "sum", "m": "max"}}
    shadow = treshard.ShardShadow(lambda: reds, every_n_steps=4)
    assert shadow.snapshot() is None and shadow.updates_behind(3) is None and shadow.due(0)
    folded = {"leader": {"s": torch.tensor([1, 2]), "m": torch.tensor([3.0])}}
    shadow.observe(folded, 4).result(timeout=30)
    assert drain_pipeline(30.0)
    host, step = shadow.snapshot()
    assert step == 4 and host["leader"]["s"].tolist() == [1, 2] and shadow.updates_behind(10) == 6
    assert not shadow.due(7) and shadow.due(8)
    baseline = {"leader": {"s": np.array([10, 10]), "m": np.array([5.0])}}
    shadow.observe(folded, 8, baseline=baseline).result(timeout=30)
    host, step = shadow.snapshot()
    assert step == 8 and host["leader"]["s"].tolist() == [11, 12] and host["leader"]["m"].tolist() == [5.0]
    shadow.observe({"leader": {"s": object()}}, 12).result(timeout=30)  # a refresh that fails
    assert shadow.stats["errors"] == 1 and shadow.snapshot()[1] == 8  # the previous anchor stays
    shadow.seed({"leader": {"s": torch.tensor([0, 0])}}, 20)
    assert shadow.snapshot()[1] == 20 and shadow.stats["refreshes"] == 2
    with pytest.raises(ValueError, match="every_n_steps"):
        treshard.ShardShadow(lambda: reds, every_n_steps=0)


def test_shard_loss_error_is_typed():
    from torchmetrics_tpu_torch.utils.exceptions import ShardLossError

    err = ShardLossError("shard 3 lost", shard=3)
    assert isinstance(err, TorchMetricsUserError) and err.shard == 3


# ------------------------------------------------------------ the flags


def test_deferred_flags_and_the_sharded_restore():
    m = MulticlassAccuracy(num_classes=C, reduce="deferred", device=CPU)
    assert not m.deferred_pending
    m.update(torch.tensor([1, 2]), torch.tensor([1, 1]))
    assert m.deferred_pending and m.executor_status["deferred_pending"]
    m.reset()
    assert not m.deferred_pending
    with pytest.raises(ValueError, match="dist_sync_on_step"):
        MulticlassAccuracy(num_classes=C, reduce="deferred", dist_sync_on_step=True, device=CPU)
    with pytest.raises(ValueError, match="reduce"):
        MulticlassAccuracy(num_classes=C, reduce="later", device=CPU)
    with pytest.raises(ValueError, match="dist_sync_on_step"):
        tm.MetricCollection([MulticlassAccuracy(num_classes=C, dist_sync_on_step=True, device=CPU)], reduce="deferred", device=CPU)
    # a stacked state installs pending and folds at the next read
    plain = MulticlassConfusionMatrix(num_classes=C, device=CPU)
    st = plain.init_sharded_state(3)
    st = {"confmat": st["confmat"] + 1, "_sharded_shards": 3, "_update_count": 5}
    plain.load_state(st)
    assert plain.deferred_pending and plain.state()["_sharded_shards"] == 3
    assert int(plain.compute().sum()) == 3 * C * C and not plain.deferred_pending
    with pytest.raises(Exception, match="disagree on the shard count"):
        MulticlassF1Score(num_classes=C, device=CPU).load_state(
            {"tp": torch.zeros(2, C, dtype=torch.int32), "fp": torch.zeros(3, C, dtype=torch.int32),
             "tn": torch.zeros(3, C, dtype=torch.int32), "fn": torch.zeros(3, C, dtype=torch.int32)}, sharded=True)
    with pytest.raises(TorchMetricsUserError, match="list states"):
        tm.CatMetric(device=CPU).init_sharded_state(2)


def test_unshard_and_reshard_local_state_round_trip():
    from torchmetrics_tpu_torch.parallel import sync as psync

    st = {"a": torch.zeros(1, 3), "b": {"c": torch.ones(1)}}
    local = psync.unshard_local_state(st)
    assert local["a"].shape == (3,) and local["b"]["c"].shape == ()
    assert psync.reshard_local_state(local)["a"].shape == (1, 3)
    with pytest.raises(ValueError, match="size 1"):
        psync.unshard_local_state({"a": torch.zeros(2, 3)})
    assert psync.local_accumulate_spec(st) == {"a": 0, "b": {"c": 0}}
    assert psync.default_reduce_policy() == "step"
