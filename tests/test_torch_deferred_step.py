"""The port's deferred collection step held to the JAX package's.

The same seeded numpy batches go through the JAX package's
``make_deferred_collection_step`` over the first S devices of the 8-device
virtual CPU mesh and through the port's with ``mesh=S`` (S shards stacked
on one process, a batch split in S contiguous slices as ``shard_map``
splits it), for S in 1, 2 and 8: the stacked states per shard and the
counts bit for bit, the values within 1e-6 relative (the bound the JAX
package's own test holds deferred against synced). Then each part of the
step against the JAX package's behaviour: ``local_epoch``, the synced step
and its ``reduce`` argument, the value packer, the shard-loss policies with
``drop_shard``, the shadow's cadence and staleness, recovery, the elastic
restore 8 -> 4, 8 -> 1 and 2 -> 8, the canonical and delta exports exact
and quantized, the integrity audit naming a skewed shard, and the raise on
a donated states tree handed back. The JAX meshes and steps are built once
a module.

Class labels are integers, so every count is exact in any order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.ops.async_read import drain_pipeline
from torchmetrics_tpu_torch.ops.executor import make_deferred_collection_step, make_synced_collection_step, make_value_packer
from torchmetrics_tpu_torch.quarantine import DegradedValue
from torchmetrics_tpu_torch.testing import faults
from torchmetrics_tpu_torch.utils.exceptions import ShardLossError, StateDivergenceError, TorchMetricsUserError

C = 7
ROWS = 8 * 12  # splits evenly over 1, 2, 4 and 8 shards
GROUPS = [["f1", "precision", "recall"], ["accuracy"], ["confmat"]]
SHARD_COUNTS = (1, 2, 8)


# ------------------------------------------------------------------ builders


def _batches(seed: int = 0, steps: int = 3, rows: int = ROWS):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, C, rows), rng.randint(0, C, rows)) for _ in range(steps)]


def _sums(n: int, seed: int):
    rng = np.random.RandomState(seed)
    return [(rng.randint(-40, 40, 16).astype(np.float32) / 8.0,) for _ in range(n)]


def _members(pkg: str):
    if pkg == "jax":
        from torchmetrics_tpu import classification as m

        kw = {"executor": False}
    else:
        from torchmetrics_tpu_torch import classification as m

        kw = {"device": "cpu"}
    return {
        "accuracy": m.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, **kw),
        "f1": m.MulticlassF1Score(num_classes=C, validate_args=False, **kw),
        "precision": m.MulticlassPrecision(num_classes=C, validate_args=False, **kw),
        "recall": m.MulticlassRecall(num_classes=C, validate_args=False, **kw),
        "confmat": m.MulticlassConfusionMatrix(num_classes=C, validate_args=False, **kw),
    }


def _collection(pkg: str, kind: str = "classes"):
    if pkg == "jax":
        import torchmetrics_tpu as jtm

        if kind == "classes":
            return jtm.MetricCollection(_members("jax"), compute_groups=GROUPS, executor=False)
        if kind == "sum":
            return jtm.MetricCollection({"m": jtm.SumMetric(nan_strategy="ignore", executor=False)}, compute_groups=False)
        return jtm.MetricCollection(
            {"mean": jtm.MeanMetric(nan_strategy="ignore", executor=False), "total": jtm.SumMetric(nan_strategy="ignore", executor=False)},
            reduce="deferred",
        )
    if kind == "classes":
        return tm.MetricCollection(_members("torch"), compute_groups=GROUPS, device="cpu")
    if kind == "sum":
        return tm.MetricCollection({"m": tm.SumMetric(nan_strategy="ignore", device="cpu")}, compute_groups=False, device="cpu")
    return tm.MetricCollection(
        {"mean": tm.MeanMetric(nan_strategy="ignore", device="cpu"), "total": tm.SumMetric(nan_strategy="ignore", device="cpu")},
        reduce="deferred", device="cpu",
    )


def _mesh(s: int):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:s]), ("batch",))


def _put(mesh, arr, spec=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("batch") if spec is None else spec))


def _jax_step(s: int, coll, **kw):
    from torchmetrics_tpu.ops.executor import make_deferred_collection_step as jax_make

    return jax_make(coll, _mesh(s), axis_name="batch", **kw)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _np(x):
    return x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v) for k, v in tree.items()}


def _assert_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_equal(got[k], want[k])
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w), (g, w)


def _assert_values(got, want):
    """Counts bit for bit, floats within 1e-6 relative."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _np(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _eager_values(batches, kind="classes"):
    coll = _collection("torch", kind)
    for b in batches:
        coll.update(*_t(*b))
    return coll.compute()


@pytest.fixture(autouse=True)
def _drain_reads():
    yield
    drain_pipeline(timeout=60)
    from torchmetrics_tpu.ops.async_read import drain_pipeline as jax_drain

    jax_drain(60.0)


# ---------------------------------------------------- the step against JAX


@pytest.fixture(scope="module")
def jax_runs():
    """Per S: the JAX step's stacked states after three local steps, after
    a local_epoch of three more and one last local_step, and the reduces."""
    cache = {}

    def run(s):
        if s not in cache:
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P

            batches = _batches(seed=s)
            coll = _collection("jax")
            step = _jax_step(s, coll)
            mesh = _mesh(s)
            st = step.init_states()
            for b in batches:
                st = step.local_step(st, *(_put(mesh, a) for a in b))
            after_steps = _tree_np({k: dict(v) for k, v in st.items()})
            first = step.reduce(st)
            chunk = _batches(seed=10 + s)
            stacked = [_put(mesh, jnp.stack([c[i] for c in chunk]), P(None, "batch")) for i in range(2)]
            st = step.local_epoch(st, *stacked)
            last = _batches(seed=20 + s, steps=1)[0]
            st = step.local_step(st, *(_put(mesh, a) for a in last))
            cache[s] = {
                "after_steps": after_steps, "first": first, "final_states": _tree_np({k: dict(v) for k, v in st.items()}),
                "final": step.reduce(st), "steps": step.steps,
            }
        return cache[s]

    return run


@pytest.mark.parametrize("s", SHARD_COUNTS)
def test_local_steps_epoch_and_reduce_match_jax(s, jax_runs):
    ref = jax_runs(s)
    coll = _collection("torch")
    step = make_deferred_collection_step(coll, mesh=s)
    st = step.init_states()
    for b in _batches(seed=s):
        st = step.local_step(st, *_t(*b))
    _assert_equal(st, ref["after_steps"])  # every shard's slice, bit for bit
    _assert_values(step.reduce(st), ref["first"])
    chunk = _batches(seed=10 + s)
    st = step.local_epoch(st, *_t(*(np.stack([c[i] for c in chunk]) for i in range(2))))
    st = step.local_step(st, *_t(*_batches(seed=20 + s, steps=1)[0]))
    _assert_equal(st, ref["final_states"])
    final = step.reduce(st)
    _assert_values(final, ref["final"])
    assert step.steps == ref["steps"] == 7
    all_batches = _batches(seed=s) + chunk + _batches(seed=20 + s, steps=1)
    _assert_values(final, {k: _np(v) for k, v in _eager_values(all_batches).items()})
    # the keys: one a step's shapes, one the epoch's; every other call a hit
    assert step.stats["compiles"] == 2 and step.stats["calls"] == 5 and step.stats["cache_hits"] == 3, step.stats


@pytest.mark.parametrize("s", (2, 8))
def test_reduce_async_equals_reduce(s):
    """``reduce_async`` resolves to what ``reduce`` returns for the states
    it was handed, though the loop goes on stepping (the step after next
    writes the slot those states live in)."""
    step = make_deferred_collection_step(_collection("torch"), mesh=s)
    st = step.init_states()
    for b in _batches(seed=30 + s):
        st = step.local_step(st, *_t(*b))
    want = step.reduce(st)
    future = step.reduce_async(st)
    for b in _batches(seed=40, steps=2):
        st = step.local_step(st, *_t(*b))
    _assert_values(future.result(timeout=60), want)


def test_make_synced_collection_step_reduce_param_as_jax():
    from torchmetrics_tpu.ops.executor import make_synced_collection_step as jax_synced

    port, ref = _collection("torch"), _collection("jax")
    assert len(make_synced_collection_step(port)) == 2 == len(jax_synced(ref, axis_name="batch"))
    assert len(make_synced_collection_step(port, reduce="deferred")) == 3 == len(jax_synced(ref, axis_name="batch", reduce="deferred"))
    with pytest.raises(ValueError, match="reduce"):
        make_synced_collection_step(port, reduce="bogus")
    with pytest.raises(ValueError, match="reduce"):
        jax_synced(ref, axis_name="batch", reduce="bogus")
    with pytest.raises(TypeError, match="process group"):
        make_synced_collection_step(port, "batch")


def test_synced_step_and_raw_deferred_bodies_match_jax():
    """The synced step (one shard, no world: the sync is the identity) and
    the raw deferred bodies driven by hand equal JAX's bodies in
    ``shard_map`` over one device, and the eager collection."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from torchmetrics_tpu.ops.executor import make_synced_collection_step as jax_synced
    from torchmetrics_tpu.parallel.sync import reshard_local_state, shard_map_compat, unshard_local_state

    batches = _batches(seed=50)
    ref = _collection("jax")
    mesh = _mesh(1)
    spec = ref.sharded_state_spec("batch")
    body, jax_unpack = jax_synced(ref, axis_name="batch")

    def jstep(st, p, t):
        st2, packed = body(unshard_local_state(st), p, t)
        return reshard_local_state(st2), packed

    fn = jax.jit(shard_map_compat(jstep, mesh, (spec, P("batch"), P("batch")), (spec, P())))
    jst = ref.init_sharded_states(1)
    for b in batches:
        jst, packed = fn(jst, *(jnp.asarray(a) for a in b))
    want = jax_unpack(packed)

    port = _collection("torch")
    step, unpack = make_synced_collection_step(port)
    st = port.functional_init()
    for b in batches:
        st, got = step(st, *_t(*b))
    _assert_values(unpack(got), want)
    local, reduce_step, unpack2 = make_synced_collection_step(port, reduce="deferred")
    stacked = port.init_sharded_states(1)
    for b in batches:
        stacked = local(stacked, *_t(*b))
    _assert_values(unpack2(reduce_step(stacked)), want)
    _assert_values(unpack2(reduce_step(stacked)), {k: _np(v) for k, v in _eager_values(batches).items()})


def test_value_packer_matches_jax():
    import jax.numpy as jnp

    from torchmetrics_tpu.ops.executor import make_value_packer as jax_packer

    rng = np.random.RandomState(3)
    values = {
        "a": rng.randn(3, 2).astype(np.float32), "b": np.float32(2.5), "n": rng.randint(0, 9, 4).astype(np.int32),
        "roc": (rng.rand(5).astype(np.float32), rng.rand(5).astype(np.float32)),
    }
    port_tree = {k: (tuple(torch.from_numpy(np.asarray(x)) for x in v) if isinstance(v, tuple) else torch.from_numpy(np.asarray(v))) for k, v in values.items()}
    jax_tree = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v)) for k, v in values.items()}
    pack, unpack = make_value_packer(port_tree)
    jpack, junpack = jax_packer(jax_tree)
    packed, jpacked = pack(port_tree), jpack(jax_tree)
    assert sorted(packed) == sorted(jpacked) == ["float32", "int32"]
    for dt in packed:
        np.testing.assert_array_equal(_np(packed[dt]), np.asarray(jpacked[dt]))
    got, want = unpack(packed), junpack(jpacked)
    for k in values:
        for g, w in zip(got[k] if isinstance(got[k], tuple) else (got[k],), want[k] if isinstance(want[k], tuple) else (want[k],)):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert isinstance(g, np.ndarray)


# ------------------------------------------------------------ shard loss


def _sum_steps(pkg, s=8, **kw):
    if pkg == "jax":
        return _jax_step(s, _collection("jax", "sum"), **kw)
    return make_deferred_collection_step(_collection("torch", "sum"), mesh=s, **kw)


def _run(pkg, step, batches, st=None, s=8):
    st = step.init_states() if st is None else st
    mesh = _mesh(s) if pkg == "jax" else None
    for b in batches:
        st = step.local_step(st, *(_put(mesh, a) for a in b)) if pkg == "jax" else step.local_step(st, *_t(*b))
    return st


def _drain(pkg):
    if pkg == "jax":
        from torchmetrics_tpu.ops.async_read import drain_pipeline as jax_drain

        jax_drain(30.0)
    else:
        drain_pipeline(30.0)


def _faults(pkg):
    if pkg == "jax":
        from torchmetrics_tpu.testing import faults as jax_faults

        return jax_faults
    return faults


def _sum_of(batches):
    return float(sum(np.float64(b[0]).sum() for b in batches))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_raise_policy_propagates_with_the_shard(pkg):
    step = _sum_steps(pkg)
    step.attach_shadow(every_n_steps=1, on_shard_loss="raise")
    st = _run(pkg, step, _sums(2, 31))
    _drain(pkg)
    with _faults(pkg).drop_shard(step, shard=3):
        with pytest.raises(Exception) as err:
            step.reduce(st)
    assert type(err.value).__name__ == "ShardLossError" and err.value.shard == 3


@pytest.mark.parametrize("every", [2, 3])
def test_degraded_serves_the_shadow_with_jax_staleness(every):
    out = {}
    batches = _sums(5, 32)
    for pkg in ("jax", "port"):
        step = _sum_steps(pkg)
        shadow = step.attach_shadow(every_n_steps=every, on_shard_loss="degraded")
        st = _run(pkg, step, batches)
        _drain(pkg)
        behind = shadow.updates_behind(step.steps)
        assert behind is not None and behind < every  # the bounded lag
        with _faults(pkg).drop_shard(step, shard=0):
            got = step.reduce(st)
        assert type(got).__name__ == "DegradedValue"
        assert got.updates_behind == behind and got.age_updates == step.steps - behind
        out[pkg] = (got.updates_behind, got.age_updates, float(np.asarray(_np(got.value["m"]))))
    assert out["port"] == out["jax"]
    assert out["port"][2] == pytest.approx(_sum_of(batches[: out["port"][1]]), rel=1e-6)


def test_restore_policy_continues_the_run_exact():
    """drop_shard under ``"restore"`` with a per-step shadow: the step
    re-dispatches on the reinstalled shadow, and the finished run is exact."""
    batches = _sums(6, 33)
    got = {}
    for pkg in ("jax", "port"):
        step = _sum_steps(pkg)
        step.attach_shadow(every_n_steps=1, on_shard_loss="restore")
        st = _run(pkg, step, batches[:3])
        _drain(pkg)
        with _faults(pkg).drop_shard(step, shard=1, fail_n=1):
            st = _run(pkg, step, batches[3:4], st)
        st = _run(pkg, step, batches[4:], st)
        got[pkg] = float(np.asarray(_np(step.reduce(st)["m"])))
    assert got["port"] == got["jax"] == pytest.approx(_sum_of(batches), rel=1e-6)


def test_restore_policy_loses_at_most_the_cadence():
    batches = _sums(8, 34)
    got = {}
    for pkg in ("jax", "port"):
        step = _sum_steps(pkg)
        shadow = step.attach_shadow(every_n_steps=3, on_shard_loss="restore")
        st = _run(pkg, step, batches[:5])
        _drain(pkg)
        kept = shadow.snapshot()[1]
        assert 5 - kept < 3
        with _faults(pkg).drop_shard(step, shard=2, fail_n=1):
            st = _run(pkg, step, batches[5:6], st)
        st = _run(pkg, step, batches[6:], st)
        got[pkg] = (kept, float(np.asarray(_np(step.reduce(st)["m"]))))
    assert got["port"] == got["jax"]
    kept = got["port"][0]
    assert got["port"][1] == pytest.approx(_sum_of(batches[:kept] + batches[5:]), rel=1e-6)


def test_read_point_restore_hands_back_fresh_states():
    batches = _sums(4, 35)
    for pkg in ("jax", "port"):
        step = _sum_steps(pkg)
        step.attach_shadow(every_n_steps=1, on_shard_loss="restore")
        st = _run(pkg, step, batches)
        _drain(pkg)
        with _faults(pkg).drop_shard(step, shard=0, fail_n=1):
            got = step.reduce(st)
        assert type(got).__name__ == "DegradedValue" and got.updates_behind == 0
        fresh = step.take_recovered_states()
        assert fresh is not None and step.take_recovered_states() is None
        assert float(np.asarray(_np(step.reduce(fresh)["m"]))) == pytest.approx(_sum_of(batches), rel=1e-6)


def test_reduce_async_resolves_the_policy_future():
    step = _sum_steps("port")
    step.attach_shadow(every_n_steps=1, on_shard_loss="degraded")
    st = _run("port", step, _sums(3, 36))
    drain_pipeline(30.0)
    with faults.drop_shard(step, shard=0):
        future = step.reduce_async(st)
    got = future.result(30.0)
    assert isinstance(got, DegradedValue) and future.degraded
    step.attach_shadow(every_n_steps=1, on_shard_loss="raise")
    with faults.drop_shard(step, shard=5):
        future = step.reduce_async(st)
    with pytest.raises(ShardLossError):
        future.result(30.0)


def test_no_shadow_refresh_raises_whatever_the_policy():
    for pkg in ("jax", "port"):
        step = _sum_steps(pkg)
        step.attach_shadow(every_n_steps=1000, on_shard_loss="degraded")
        st = _run(pkg, step, _sums(1, 37))
        _drain(pkg)
        step._shadow._shadow = None
        with _faults(pkg).drop_shard(step, shard=0):
            with pytest.raises(Exception) as err:
                step.reduce(st)
        assert type(err.value).__name__ == "ShardLossError"
        with pytest.raises(ValueError, match="on_shard_loss"):
            step.attach_shadow(on_shard_loss="bogus")


def test_shadow_cadence_refreshes_and_counters():
    from torchmetrics_tpu_torch import obs

    before = obs.counters_snapshot().get("shards.shadow_refreshes", 0)
    step = _sum_steps("port")
    shadow = step.attach_shadow(every_n_steps=4, on_shard_loss="degraded")
    _run("port", step, _sums(9, 38))
    drain_pipeline(30.0)
    # refreshes at steps 1, 5 and 9 (the first observation always refreshes)
    assert shadow.stats["submitted"] == 3 and shadow.snapshot()[1] == 9
    assert obs.counters_snapshot()["shards.shadow_refreshes"] == before + 3
    with faults.drop_shard(step, shard=0):
        step.reduce(step.init_states())
    snap = obs.counters_snapshot()
    assert snap["shards.degraded_reads"] >= 1


# --------------------------------------------------------- elastic restore


@pytest.mark.parametrize("path", [(8, 4), (8, 1), (2, 8)])
def test_restore_states_onto_another_shard_count_matches_jax(path):
    """A stacked snapshot saved on ``a`` shards restores onto ``b``: the
    fold becomes the carried baseline, fresh accumulators continue, and the
    finished reduce equals JAX's same flow and the never-interrupted run."""
    a, b = path
    batches = _batches(seed=60 + a + b, steps=5)
    got = {}
    for pkg in ("jax", "port"):
        coll = _collection("jax" if pkg == "jax" else "torch")
        step_a = _jax_step(a, coll) if pkg == "jax" else make_deferred_collection_step(coll, mesh=a)
        step_b = _jax_step(b, coll) if pkg == "jax" else make_deferred_collection_step(coll, mesh=b)
        mesh_a, mesh_b = (_mesh(a), _mesh(b)) if pkg == "jax" else (None, None)
        st = step_a.init_states()
        for x in batches[:3]:
            st = step_a.local_step(st, *((_put(mesh_a, v) for v in x) if pkg == "jax" else _t(*x)))
        snapshot = {leader: dict({k: _np(v) for k, v in sub.items()}, _sharded_shards=a) for leader, sub in st.items()}
        st2 = step_b.restore_states(snapshot, step_count=3)
        for x in batches[3:]:
            st2 = step_b.local_step(st2, *((_put(mesh_b, v) for v in x) if pkg == "jax" else _t(*x)))
        got[pkg] = step_b.reduce(st2)
        assert step_b.steps == 5 and step_b.baseline is not None
    _assert_values(got["port"], got["jax"])
    _assert_values(got["port"], {k: _np(v) for k, v in _eager_values(batches).items()})


def test_restore_states_counts_and_seeds_the_shadow():
    from torchmetrics_tpu_torch import obs

    before = obs.counters_snapshot().get("shards.elastic_restores", 0)
    step = _sum_steps("port", s=4)
    shadow = step.attach_shadow(every_n_steps=2)
    fresh = step.restore_states({"m": {"sum_value": np.float32(5.0)}}, step_count=7)
    assert obs.counters_snapshot()["shards.elastic_restores"] == before + 1
    assert shadow.snapshot()[1] == 7 and float(shadow.snapshot()[0]["m"]["sum_value"]) == 5.0
    assert float(step.reduce(fresh)["m"]) == 5.0


# ------------------------------------------------------------------ export


def _mean_steps(pkg, s=8):
    if pkg == "jax":
        return _jax_step(s, _collection("jax", "mean"))
    return make_deferred_collection_step(_collection("torch", "mean"), mesh=s)


def test_export_canonical_exact_and_quantized_match_jax():
    from torchmetrics_tpu.parallel import quantized as jq

    from torchmetrics_tpu_torch.parallel import quantized as q

    vals = (np.random.RandomState(6).randn(8 * 2).astype(np.float32),)
    out = {}
    for pkg in ("jax", "port"):
        step = _mean_steps(pkg)
        st = _run(pkg, step, [vals])
        out[pkg] = (step.export_canonical(st), step.export_canonical(st, precision="quantized"))
        with pytest.raises(ValueError, match="precision"):
            step.export_canonical(st, precision="fp4")
    (exact, wire), (jexact, jwire) = out["port"], out["jax"]
    _assert_equal(exact, {k: {f: np.asarray(v) for f, v in sub.items()} for k, sub in jexact.items()})
    fold = make_deferred_collection_step(_collection("torch", "mean"), mesh=8)
    reduced = fold.reduce(_run("port", fold, [vals]))
    assert float(exact["mean"]["mean_value"] / exact["mean"]["weight"]) == pytest.approx(float(reduced["mean"]), rel=1e-6)
    for leader in exact:
        assert wire[leader]["wire_version"] == q.WIRE_VERSION == jwire[leader]["wire_version"]
        dec, jdec = q.decode_canonical(wire[leader]), jq.decode_canonical(jwire[leader])
        for field, val in exact[leader].items():
            val = np.asarray(val)
            if np.issubdtype(val.dtype, np.floating):
                bound = q.reduce_error_bound(val[None], "max", 8, 256)
                assert (np.abs(dec[field] - val) <= bound + 1e-6).all(), field
                np.testing.assert_allclose(dec[field], np.asarray(jdec[field]), rtol=0, atol=float(np.max(bound)) + 1e-6)
            else:
                np.testing.assert_array_equal(dec[field], val)


def test_export_delta_rebuilds_the_canonical_as_jax():
    from torchmetrics_tpu_torch.fleet.delta import apply_delta

    def batch(seed):
        return (np.random.RandomState(seed).randint(-40, 40, 16).astype(np.float32) / 8.0,)

    got = {}
    for pkg in ("jax", "port"):
        step = _mean_steps(pkg)
        st = _run(pkg, step, [batch(0)])
        baseline, first = step.export_delta(st)
        for leader, payload in first.items():
            for field, arr in payload.items():
                np.testing.assert_array_equal(arr, np.asarray(baseline[leader][field]))
        st = _run(pkg, step, [batch(1)], st)
        canonical, payload = step.export_delta(st, baseline=baseline)
        got[pkg] = (canonical, payload)
        if pkg == "port":
            reds = step.canonical_reductions()
            for leader in canonical:
                rebuilt = apply_delta({k: np.asarray(v) for k, v in baseline[leader].items()}, payload[leader], reds[leader])
                _assert_equal(rebuilt, canonical[leader])
    _assert_equal(got["port"][0], {k: {f: np.asarray(v) for f, v in sub.items()} for k, sub in got["jax"][0].items()})
    _assert_equal(got["port"][1], {k: {f: np.asarray(v) for f, v in sub.items()} for k, sub in got["jax"][1].items()})


# --------------------------------------------------------------- integrity


def test_integrity_names_the_skewed_shard_as_jax():
    names = {}
    for pkg in ("jax", "port"):
        step = _sum_steps(pkg)
        integ = step.attach_integrity(every_n_steps=1, on_divergence="raise")
        st = _run(pkg, step, _sums(3, 42))
        _drain(pkg)
        assert integ.baseline_steps == step.steps == 3 and step.integrity is integ
        assert integ.audit(st).ok
        skewed, info = _faults(pkg).skew_replica(st, shard=3, seed=1)
        with pytest.raises(Exception) as err:
            integ.audit(skewed)
        assert type(err.value).__name__ == "StateDivergenceError"
        names[pkg] = (err.value.surface, err.value.shard, info["shard"])
    assert names["port"] == names["jax"] == ("chain", 3, 3)


def test_integrity_restore_reinstalls_the_shadow():
    step = _sum_steps("port")
    step.attach_shadow(every_n_steps=1, on_shard_loss="raise")
    integ = step.attach_integrity(every_n_steps=1, on_divergence="restore")
    batches = _sums(3, 43)
    st = _run("port", step, batches)
    drain_pipeline(30.0)
    skewed, _ = faults.skew_replica(st, shard=5, seed=2)
    report = integ.audit(skewed)
    assert report.action == "restored" and report.restored_states is not None
    assert float(step.reduce(report.restored_states)["m"]) == pytest.approx(_sum_of(batches), rel=1e-6)


# --------------------------------------------------------------- donation


def test_a_donated_tree_handed_back_raises():
    """A donated states tree handed back raises ``TorchMetricsUserError``,
    as the JAX package raises on the deleted buffer of a donated array (not
    run here: a dispatch refused on some of the virtual devices leaves a
    partial collective that deadlocks later collectives in the process),
    also two steps later, when it shares the live tree's slot. The live
    tree goes on exact."""
    batches = _sums(3, 44)
    step = _sum_steps("port")
    st = _run("port", step, batches[:1])
    st2 = _run("port", step, batches[1:2], st)
    with pytest.raises(TorchMetricsUserError, match="donated"):
        _run("port", step, batches[2:], st)
    st3 = _run("port", step, batches[2:], st2)  # the tree the last step returned is live
    assert float(step.reduce(st3)["m"]) == pytest.approx(_sum_of(batches), rel=1e-6)
    assert step.stats["donated_calls"] == 2 and step.stats["copied_calls"] == 1
    # st lives in st3's slot (two steps ago), st2 in the other: both spent
    assert st["m"]["sum_value"].data_ptr() == st3["m"]["sum_value"].data_ptr()
    for spent in (st, st2):
        with pytest.raises(TorchMetricsUserError, match="donated"):
            step.local_step(spent, *_t(*batches[0]))


def test_donate_false_never_writes_what_it_was_given():
    step = make_deferred_collection_step(_collection("torch", "sum"), mesh=2, donate=False)
    st = step.init_states()
    batches = _sums(4, 45)
    kept = []
    for b in batches:
        nxt = step.local_step(st, *_t(*b))
        kept.append((st, _tree_np(st)))
        st = nxt
    for tree, values in kept:
        _assert_equal(tree, values)
    assert float(step.reduce(st)["m"]) == pytest.approx(_sum_of(batches), rel=1e-6)


def test_mesh_batch_specs_and_uneven_rows():
    coll = _collection("torch", "sum")
    with pytest.raises(ValueError, match="number of shards"):
        make_deferred_collection_step(coll, mesh=_mesh(2))
    with pytest.raises(ValueError, match="split evenly"):
        make_deferred_collection_step(coll, mesh=3).local_step(make_deferred_collection_step(coll, mesh=3).init_states(), torch.ones(16))
    # a replicated argument (spec None): every shard sees all of it
    from torchmetrics_tpu_torch.aggregation import SumMetric

    repl = make_deferred_collection_step(
        tm.MetricCollection({"m": SumMetric(nan_strategy="ignore", device="cpu")}, compute_groups=False, device="cpu"),
        mesh=4, batch_specs=(None,),
    )
    st = repl.local_step(repl.init_states(), torch.arange(6.0))
    assert float(repl.reduce(st)["m"]) == 4 * 15.0
    assert st["m"]["sum_value"].shape == (4,) and torch.equal(st["m"]["sum_value"], torch.full((4,), 15.0))


def test_an_output_not_handed_back_stays_valid():
    """A states tree the step returned and that is never donated stays
    valid when the step goes on from other states (a new ``init_states``),
    as an undonated output does in the JAX package (whose buffers only a
    donation deletes): the port moves it off the slot the new call loads."""
    batches = _sums(3, 46)
    step = _sum_steps("port")
    held = _run("port", step, batches[:1])
    other = _run("port", step, batches[1:2])  # from fresh states
    other = _run("port", step, batches[2:], other)
    assert float(step.reduce(held)["m"]) == pytest.approx(_sum_of(batches[:1]), rel=1e-6)
    assert float(step.reduce(other)["m"]) == pytest.approx(_sum_of(batches[1:]), rel=1e-6)
    assert step.stats["donated_calls"] == 1 and step.stats["copied_calls"] == 2
