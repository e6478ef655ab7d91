"""The port's captured executor on the CPU against the JAX package's executor.

On the CPU the port's executor runs its whole bookkeeping with the body
called directly in place of a replay: keys, the bucket ladder, padding,
probes, the two state slots, escapes, copies, stats and containment. The
same seeded numpy batches, with a ragged last batch, go through the JAX
class with ``executor=True`` and the port with ``executor=True``: counts
bit for bit, floats within each metric's port tolerance, and the executor
counters equal after the same call sequence (read, update, update,
``compute_async``, ragged batch). The JAX runs are shared per module, as
their compiles are most of this file's time.
"""
from __future__ import annotations

import pickle
import time

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch import classification as cls_port
from torchmetrics_tpu_torch.ops import async_read
from torchmetrics_tpu_torch.ops import executor as ex_port
from torchmetrics_tpu_torch.testing import faults

C = 10
BATCHES = (32, 32, 32, 21)
#: the executor counters held equal to the JAX package's
STAT_KEYS = (
    "calls", "compiles", "cache_hits", "padded_calls", "probes", "skipped_calls",
    "donated_calls", "copied_calls", "dispatch_failures", "recovery_restores",
)
FLOAT_TOL = {"entry": 1e-6, "jaccard": 1e-6, "binned": 1e-6, "ssim": 2e-5}


def _batches(case: str):
    rng = np.random.RandomState({"entry": 1, "jaccard": 2, "binned": 3, "ssim": 4}[case])
    out = []
    for n in BATCHES:
        if case == "entry":
            out.append((rng.randn(n, C).astype(np.float32), rng.randint(0, C, n).astype(np.int32)))
        elif case == "jaccard":
            n = max(1, n // 8)
            target = rng.randint(0, 4, (n, 6, 5)).astype(np.int32)
            target[rng.rand(n, 6, 5) < 0.1] = 255
            out.append((rng.randn(n, 4, 6, 5).astype(np.float32), target))
        elif case == "binned":
            target = (rng.rand(n) < 0.3).astype(np.int32)
            target[rng.rand(n) < 0.1] = -1
            out.append(((1 / (1 + np.exp(-(rng.randn(n) + 1.5 * target)))).astype(np.float32), target))
        else:
            n = max(1, n // 8)
            base = rng.rand(n, 1, 40, 40).astype(np.float32)
            out.append((np.clip(base + 0.05 * rng.randn(*base.shape), 0, 1).astype(np.float32), base))
    return out


def _members(pkg, case: str, **kw):
    classification = pkg.classification
    if case == "entry":
        return {
            "accuracy": classification.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, **kw),
            "f1": classification.MulticlassF1Score(num_classes=C, average="macro", validate_args=False, **kw),
            "precision": classification.MulticlassPrecision(num_classes=C, average="macro", validate_args=False, **kw),
            "recall": classification.MulticlassRecall(num_classes=C, average="macro", validate_args=False, **kw),
            "confmat": classification.MulticlassConfusionMatrix(num_classes=C, validate_args=False, **kw),
        }
    if case == "jaccard":
        return {
            "jaccard": classification.MulticlassJaccardIndex(num_classes=4, ignore_index=255, validate_args=False, **kw),
            "confmat": classification.MulticlassConfusionMatrix(num_classes=4, ignore_index=255, validate_args=False, **kw),
        }
    if case == "binned":
        common = {"thresholds": 16, "ignore_index": -1, "validate_args": False, **kw}
        return {
            "auroc": classification.BinaryAUROC(**common),
            "ap": classification.BinaryAveragePrecision(**common),
            "roc": classification.BinaryROC(**common),
        }
    return {
        "ssim": pkg.image.StructuralSimilarityIndexMeasure(data_range=1.0, **kw),
        "ms_ssim": pkg.image.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, betas=(0.4, 0.6), kernel_size=5, **kw),
    }


def _jax_pkg():
    import torchmetrics_tpu as jax_tm

    return jax_tm


def _to_jax(batch):
    import jax.numpy as jnp

    return tuple(jnp.asarray(x) for x in batch)


def _to_port(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in batch)


def _np(x):
    """A numpy copy: a view of a slot tensor read through ``_state`` would
    follow the later updates."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def _leader_states(coll):
    return {
        cg[0]: {k: _np(coll[cg[0]]._state[k]) for k in coll[cg[0]]._defaults} for cg in coll.compute_groups.values()
    }


def _stats(obj):
    return {k: obj.executor_status["stats"][k] for k in STAT_KEYS}


def _assert_tree_close(port, ref, tol):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _assert_tree_close(port[k], ref[k], tol)
    elif isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_tree_close(p, r, tol)
    else:
        p, r = _np(port), _np(ref)
        assert p.shape == r.shape
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p, r, rtol=tol, atol=tol, equal_nan=True)
        else:
            np.testing.assert_array_equal(p, r)


def _sequence(pkg, case: str, to, drain, **dev):
    """The call sequence: update, read (an attribute), update, update,
    compute_async, ragged update; states after each step, the final value,
    the collection's counters."""
    coll = pkg.MetricCollection(_members(pkg, case, executor=True, **dev), executor=True, **dev)
    batches = [to(b) for b in _batches(case)]
    steps = []
    coll.update(*batches[0])
    steps.append(_leader_states(coll))
    first = next(iter(coll.keys()))
    held = _np(getattr(coll[first], next(iter(coll[first]._defaults))))
    coll.update(*batches[1])
    coll.update(*batches[2])
    steps.append(_leader_states(coll))
    future = coll.compute_async()
    coll.update(*batches[3])
    steps.append(_leader_states(coll))
    pending = future.result(timeout=60)
    drain()
    return {
        "steps": steps, "held": held, "async": pending, "value": coll.compute(),
        "stats": _stats(coll), "groups": sorted(sorted(g) for g in coll.compute_groups.values()),
    }


@pytest.fixture(scope="module")
def jax_runs():
    import torchmetrics_tpu.ops.async_read as jax_async

    cache = {}

    def run(case):
        if case not in cache:
            cache[case] = _sequence(_jax_pkg(), case, _to_jax, lambda: jax_async.drain_pipeline(timeout=60))
        return cache[case]

    return run


@pytest.fixture(autouse=True)
def _drain_reads():
    yield
    async_read.drain_pipeline(timeout=60)


def _steady_keys_from_jax(case: str, stats: dict) -> dict:
    """The port's counters after :func:`_sequence`, from JAX's. Where the
    steady batch is off the ladder (``jaccard`` and ``ssim``: 4 rows, which
    JAX pads to 8 on every call), the port pads the first executor call as
    JAX does and keys the repeat exactly: one more key built, one cache hit,
    padded call and donated call fewer, one more copied call (the fresh
    exact key copies). ``entry`` and ``binned`` batch 32 rows: equal."""
    if case in ("entry", "binned"):
        return dict(stats)
    delta = {"compiles": 1, "cache_hits": -1, "padded_calls": -1, "donated_calls": -1, "copied_calls": 1}
    return {k: v + delta.get(k, 0) for k, v in stats.items()}


@pytest.mark.parametrize("case", ["entry", "jaccard", "binned", "ssim"])
def test_collection_sequence_matches_jax(case, jax_runs):
    ref = jax_runs(case)
    port = _sequence(tm, case, _to_port, lambda: async_read.drain_pipeline(timeout=60), device="cpu")
    tol = FLOAT_TOL[case]
    assert port["groups"] == ref["groups"]
    for got, want in zip(port["steps"], ref["steps"]):
        _assert_tree_close(got, want, tol)
    _assert_tree_close(port["held"], ref["held"], tol)
    _assert_tree_close(port["async"], ref["async"], tol)
    _assert_tree_close(port["value"], ref["value"], tol)
    assert port["stats"] == _steady_keys_from_jax(case, ref["stats"])
    assert port["stats"]["calls"] == 3 and port["stats"]["probes"] == 1


def test_entry_collection_counters_show_each_path(jax_runs):
    """What the matched counters are: the first update runs the members
    eagerly (groups unresolved), then one fresh key, a donated replay, a
    copy after the async read's escape and a padded, probed fresh key."""
    assert jax_runs("entry")["stats"] == {
        "calls": 3, "compiles": 2, "cache_hits": 1, "padded_calls": 1, "probes": 1, "skipped_calls": 0,
        "donated_calls": 1, "copied_calls": 2, "dispatch_failures": 0, "recovery_restores": 0,
    }


# ---------------------------------------------------------------- one metric


def _accuracy(pkg, **kw):
    if pkg is tm:
        kw.setdefault("device", "cpu")
    return pkg.classification.MulticlassAccuracy(num_classes=C, validate_args=False, **kw)


@pytest.fixture(scope="module")
def jax_single():
    jax_tm = _jax_pkg()
    batches = [_to_jax(b) for b in _batches("entry")]
    m = _accuracy(jax_tm, executor=True)
    states = []
    for b in batches[:2]:
        m.update(*b)
    read = _np(m.tp)
    m.update(*batches[2])
    future = m.compute_async()
    m.update(*batches[3])
    states.append({k: _np(m._state[k]) for k in m._defaults})
    fwd = _accuracy(jax_tm, executor=True)
    values = [_np(fwd(*b)) for b in batches]
    return {
        "read": read, "async": _np(future.result(timeout=60)), "state": states, "stats": _stats(m),
        "value": _np(m.compute()), "forward": values, "forward_value": _np(fwd.compute()),
        "forward_stats": _stats(fwd), "forward_state": {k: _np(fwd._state[k]) for k in fwd._defaults},
    }


def test_single_metric_sequence_and_forward_match_jax(jax_single):
    batches = [_to_port(b) for b in _batches("entry")]
    m = _accuracy(tm, executor=True)
    for b in batches[:2]:
        m.update(*b)
    read = m.tp
    held = read.clone()
    m.update(*batches[2])
    future = m.compute_async()
    m.update(*batches[3])
    np.testing.assert_array_equal(_np(read), jax_single["read"])
    assert torch.equal(read, held)  # the tensor handed out never changed
    np.testing.assert_array_equal(_np(future.result(timeout=60)), jax_single["async"])
    _assert_tree_close({k: _np(m._state[k]) for k in m._defaults}, jax_single["state"][0], 0)
    assert _stats(m) == jax_single["stats"]
    np.testing.assert_allclose(_np(m.compute()), jax_single["value"], rtol=1e-6)
    fwd = _accuracy(tm, executor=True)
    for b, want in zip(batches, jax_single["forward"]):
        np.testing.assert_allclose(_np(fwd(*b)), want, rtol=1e-6)
    _assert_tree_close({k: _np(fwd._state[k]) for k in fwd._defaults}, jax_single["forward_state"], 0)
    np.testing.assert_allclose(_np(fwd.compute()), jax_single["forward_value"], rtol=1e-6)
    assert _stats(fwd) == jax_single["forward_stats"]
    assert fwd.executor_status["engaged"] and fwd.executor_status["enabled"]


def test_fused_collection_forward_matches_jax():
    jax_tm = _jax_pkg()
    batches = _batches("entry")
    ref = jax_tm.MetricCollection(_members(jax_tm, "entry", executor=True), executor=True)
    port = tm.MetricCollection(_members(tm, "entry", executor=True, device="cpu"), executor=True, device="cpu")
    for b in batches:
        _assert_tree_close(port(*_to_port(b)), ref(*_to_jax(b)), 1e-6)
    _assert_tree_close(_leader_states(port), _leader_states(ref), 0)
    assert _stats(port) == _stats(ref)
    assert port.executor_status["stats"]["calls"] == 3


class _MeanOfBatch:
    """A "sum" state fed the batch MEAN: not row-additive, so padding a
    ragged batch with copies of row 0 changes it and the probe must refuse
    the bucket."""

    @staticmethod
    def build(pkg):
        if pkg is tm:

            class MeanOfBatch(tm.Metric):
                full_state_update = False

                def __init__(self, **kw):
                    super().__init__(**kw)
                    self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

                def update(self, x):
                    self.total = self.total + x.mean()

                def compute(self):
                    return self.total

            return MeanOfBatch(executor=True, device="cpu")
        import jax.numpy as jnp

        class JaxMeanOfBatch(pkg.Metric):
            full_state_update = False

            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", jnp.asarray(0.0), dist_reduce_fx="sum")

            def update(self, x):
                self.total = self.total + jnp.mean(x)

            def compute(self):
                return self.total

        return JaxMeanOfBatch(executor=True)


def test_non_row_additive_metric_turns_bucketing_off_as_jax():
    jax_tm = _jax_pkg()
    xs = [np.random.RandomState(5).rand(n).astype(np.float32) for n in (16, 11, 11)]
    ref, port = _MeanOfBatch.build(jax_tm), _MeanOfBatch.build(tm)
    for x in xs:
        ref.update(_to_jax((x,))[0])
        port.update(torch.from_numpy(x))
    np.testing.assert_allclose(_np(port.total), _np(ref.total), rtol=1e-6)
    assert _stats(port) == _stats(ref)
    assert port.executor_status["stats"]["bucketing_enabled"] is False is ref.executor_status["stats"]["bucketing_enabled"]
    assert port.executor_status["stats"]["probes"] == 1


@pytest.mark.parametrize(
    "build",
    [
        lambda pkg, kw: pkg.classification.MulticlassAccuracy(num_classes=C, validate_args=True, **kw),
        lambda pkg, kw: pkg.SumMetric(nan_strategy="error", **kw),
        lambda pkg, kw: pkg.MeanMetric(nan_strategy="warn", **kw),
        lambda pkg, kw: pkg.SumMetric(nan_strategy="ignore", **kw),
    ],
    ids=["validate_args", "sum_error", "mean_warn", "sum_ignore"],
)
def test_step_aside_reasons_match_jax(build):
    jax_tm = _jax_pkg()
    x = np.random.RandomState(6).rand(16, C).astype(np.float32)
    t = np.random.RandomState(7).randint(0, C, 16).astype(np.int32)
    ref, port = build(jax_tm, {"executor": True}), build(tm, {"executor": True, "device": "cpu"})
    args = (x, t) if hasattr(ref, "num_classes") else (x[:, 0],)
    ref.update(*_to_jax(args))
    port.update(*_to_port(args))
    assert port.executor_status["fallback_reason"] == ref.executor_status["fallback_reason"]
    assert port.executor_status["enabled"] is True
    assert _stats(port) == _stats(ref)


def test_step_asides_of_later_items_name_them():
    """Laned metrics and class-axis states step aside, naming the roadmap
    item that brings them onto the executor (4c and 4b); windowed metrics
    ride it (``tests/test_torch_windows_executor.py``)."""
    laned = tm.SumMetric(nan_strategy="ignore", device="cpu").laned(capacity=8, executor=True, device="cpu")
    laned.update(torch.tensor([0, 1]), torch.tensor([1.0, 2.0]))
    sharded = cls_port.MulticlassConfusionMatrix(
        num_classes=C, validate_args=False, state_sharding="class_axis", class_shards=2, executor=True, device="cpu"
    )
    sharded.update(torch.tensor([0, 1]), torch.tensor([1, 1]))
    for m, item in ((laned, "4c"), (sharded, "4b")):
        status = m.executor_status
        assert status["enabled"] and not status["engaged"]
        assert f"ROADMAP Queue A item {item}" in status["fallback_reason"]


def test_fail_dispatch_consumed_keeps_the_pre_call_state_as_jax():
    jax_tm = _jax_pkg()
    batches = _batches("entry")
    from torchmetrics_tpu.testing import faults as jax_faults

    ref, port = _accuracy(jax_tm, executor=True), _accuracy(tm, executor=True)
    for b in batches[:2]:
        ref.update(*_to_jax(b))
        port.update(*_to_port(b))
    before = {k: port._state[k].clone() for k in port._defaults}
    with faults.fail_dispatch(consume=True), pytest.raises(faults.FaultInjected):
        port.update(*_to_port(batches[2]))
    with jax_faults.fail_dispatch(consume=True), pytest.raises(jax_faults.FaultInjected):
        ref.update(*_to_jax(batches[2]))
    for k in port._defaults:
        assert torch.equal(port._state[k], before[k])
        np.testing.assert_array_equal(_np(port._state[k]), _np(ref._state[k]))
    assert port.update_count == ref.update_count == 2
    assert _stats(port) == _stats(ref)
    assert port.executor_status["stats"]["dispatch_failures"] == 1 == port.executor_status["stats"]["recovery_restores"]
    port.update(*_to_port(batches[2]))  # the executor stays engaged after a contained failure
    assert port.executor_status["stats"]["calls"] == 3


def test_fail_dispatch_in_a_collection_keeps_every_group_as_jax():
    jax_tm = _jax_pkg()
    from torchmetrics_tpu.testing import faults as jax_faults

    batches = _batches("entry")
    ref = jax_tm.MetricCollection(_members(jax_tm, "entry", executor=True), executor=True)
    port = tm.MetricCollection(_members(tm, "entry", executor=True, device="cpu"), executor=True, device="cpu")
    for b in batches[:3]:
        ref.update(*_to_jax(b))
        port.update(*_to_port(b))
    before = _leader_states(port)
    with faults.fail_dispatch(consume=True), pytest.raises(faults.FaultInjected):
        port.update(*_to_port(batches[1]))
    with jax_faults.fail_dispatch(consume=True), pytest.raises(jax_faults.FaultInjected):
        ref.update(*_to_jax(batches[1]))
    _assert_tree_close(_leader_states(port), before, 0)
    _assert_tree_close(_leader_states(port), _leader_states(ref), 0)
    assert _stats(port) == _stats(ref)


def test_dispatch_retry_succeeds_as_jax(monkeypatch):
    jax_tm = _jax_pkg()
    from torchmetrics_tpu.testing import faults as jax_faults

    monkeypatch.setenv("TORCHMETRICS_TPU_DISPATCH_RETRIES", "1")
    batches = _batches("entry")
    ref, port, eager = _accuracy(jax_tm, executor=True), _accuracy(tm, executor=True), _accuracy(tm, executor=False)
    for b in batches[:2]:
        ref.update(*_to_jax(b))
        port.update(*_to_port(b))
        eager.update(*_to_port(b))
    with faults.fail_dispatch(consume=True, fail_n=1):
        port.update(*_to_port(batches[2]))
    with jax_faults.fail_dispatch(consume=True, fail_n=1):
        ref.update(*_to_jax(batches[2]))
    eager.update(*_to_port(batches[2]))
    for k in port._defaults:
        assert torch.equal(port._state[k], eager._state[k])
    stats = port.executor_status["stats"]
    assert stats["dispatch_retries"] == 1 == ref.executor_status["stats"]["dispatch_retries"]
    assert _stats(port) == _stats(ref)


def test_pickle_and_clone_drop_the_executor():
    m = _accuracy(tm, executor=True)
    b = _to_port(_batches("entry")[0])
    m.update(*b)
    assert m._executor_obj is not None
    for copy in (pickle.loads(pickle.dumps(m)), m.clone()):
        assert copy._executor_obj is None and copy._state_escaped and not copy._state_shared
        assert "_slot_ids" not in copy.__dict__
        for k in m._defaults:
            assert torch.equal(copy._state[k], m._state[k])
        copy.update(*b)
        assert copy.executor_status["stats"]["calls"] == 1
    coll = tm.MetricCollection(_members(tm, "entry", executor=True, device="cpu"), executor=True, device="cpu")
    coll.update(*b)
    coll.update(*b)
    assert coll._executor_obj is not None and pickle.loads(pickle.dumps(coll))._executor_obj is None
    assert coll.clone()._executor_obj is None


def test_executor_keyword_is_type_checked_as_jax():
    jax_tm = _jax_pkg()
    with pytest.raises(ValueError, match="`executor` to be a `bool`") as port_err:
        _accuracy(tm, executor="yes")
    with pytest.raises(ValueError, match="`executor` to be a `bool`") as ref_err:
        _accuracy(jax_tm, executor="yes")
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="`executor` to be a `bool`"):
        tm.MetricCollection([_accuracy(tm)], executor=1, device="cpu")


def test_executor_defaults_off_on_the_cpu():
    """Kept behaviour: ``executor=None`` is off for a metric on the CPU (no
    graph can be captured there); ``True`` opts in."""
    assert _accuracy(tm).executor_status["enabled"] is False
    assert _accuracy(tm, executor=True).executor_status["enabled"] is True
    assert tm.MetricCollection([_accuracy(tm)], device="cpu").executor_status["enabled"] is False


def _warm_flow(pkg, to_meta):
    m = _accuracy(pkg, executor=True)
    spec = to_meta((32, C), "float32"), to_meta((32,), "int32")
    first = m.warmup(spec, ladder=True)
    b = _batches("entry")
    to = _to_port if pkg is tm else _to_jax
    m.update(*to(b[0]))
    m.update(*to(b[3]))
    profile = m.shape_profile()
    fresh = _accuracy(pkg, executor=True)
    second = fresh.warmup_from_manifest(profile)
    fresh.update(*to(b[0]))
    fresh.update(*to(b[3]))
    return first, profile, second, _stats(m), _stats(fresh)


def test_warmup_profile_and_manifest_warm_the_same_keys_as_jax():
    import jax

    def jax_meta(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype)

    def port_meta(shape, dtype):
        return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")

    ref = _warm_flow(_jax_pkg(), jax_meta)
    port = _warm_flow(tm, port_meta)
    for got, want in ((port[0], ref[0]), (port[2], ref[2])):
        assert (got["warmed"], got["already_warm"], got["skipped"]) == (want["warmed"], want["already_warm"], want["skipped"])
    assert port[1]["specs"] == ref[1]["specs"] and len(port[1]["specs"]) == 2
    assert port[3] == ref[3] and port[4] == ref[4]
    assert port[4]["compiles"] == 2 and port[4]["cache_hits"] == 2


def test_an_escaped_tensor_never_changes():
    """Constraint (a) on the CPU path: a tensor read by reference, a
    ``state()`` export and a pending read keep their values while ten more
    updates run through the slots."""
    batches = [_to_port(b) for b in _batches("entry")[:3]]
    coll = tm.MetricCollection(_members(tm, "entry", executor=True, device="cpu"), executor=True, device="cpu")
    eager = tm.MetricCollection(_members(tm, "entry", executor=False, device="cpu"), executor=False, device="cpu")
    for b in batches:
        coll.update(*b)
        eager.update(*b)
    held = coll["confmat"].confmat
    exported = coll["f1"].state()
    want = eager["confmat"].confmat.clone()
    future = coll.compute_async()
    copies = (held.clone(), {k: v.clone() for k, v in exported.items() if isinstance(v, torch.Tensor)})
    for _ in range(10):
        coll.update(*batches[0])
    assert torch.equal(held, copies[0]) and torch.equal(held, want)
    for k, v in copies[1].items():
        assert torch.equal(exported[k], v)
    _assert_tree_close(future.result(timeout=60), eager.compute(), 1e-6)
    for _ in range(10):
        eager.update(*batches[0])
    _assert_tree_close(coll.compute(), eager.compute(), 1e-6)
    assert coll.executor_status["stats"]["donated_calls"] >= 9


def test_forward_value_is_never_a_slot():
    """Constraint (c): a forward's batch value shares no storage with the
    executor's slots."""
    m = cls_port.MulticlassConfusionMatrix(num_classes=C, validate_args=False, executor=True, device="cpu")
    slots = []
    for b in _batches("entry")[:3]:
        value = m(*_to_port(b))
        slots = [t.data_ptr() for s in m._executor_obj._dispatcher.slots for t in s]
        assert value.data_ptr() not in slots
    assert m.executor_status["stats"]["calls"] == 3


def test_root_exports_and_telemetry_carry_the_executor():
    from torchmetrics_tpu_torch import obs

    m = _accuracy(tm, executor=True)
    m.update(*_to_port(_batches("entry")[0]))
    assert tm.executor_stats(m)["calls"] == 1
    snap = obs.telemetry_snapshot()
    assert snap["counters"].get("executor.calls", 0) >= 1
    from torchmetrics_tpu_torch.ops import ingest

    assert ingest.bucket_size is ex_port.bucket_size and ex_port.bucket_size(21) == 32


def test_no_executor_call_inside_a_torch_func_transform():
    """Inside a ``torch.func`` transform (``lane_values``' vmaps) the
    executor's context check fails, so a call there is skipped and runs
    eagerly."""
    seen = []

    def body(x):
        seen.append(ex_port._trace_clean())
        return x * 2

    torch.func.vmap(body)(torch.ones(3, 2))
    assert seen == [False] and ex_port._trace_clean()


@pytest.mark.parametrize("kind", ["update", "forward", "collection_update", "collection_forward", "non_row_additive"])
def test_card_order_of_a_fresh_padded_key(kind):
    """The order a padded call on a fresh key takes on the card, run here:
    the eager update on the batch as given serves the call (no padded call,
    no probe), the key's first replay probes, and states and values equal
    ``executor=False`` over the same batches."""

    def build(executor):
        if kind == "non_row_additive":
            m = _MeanOfBatch.build(tm)
            return m if executor else type(m)(executor=False, device="cpu")
        if kind.startswith("collection"):
            return tm.MetricCollection(_members(tm, "entry", executor=executor, device="cpu"), executor=executor, device="cpu")
        return _accuracy(tm, executor=executor)

    rng = np.random.RandomState(9)
    # ragged sizes (each differs from the call before) go up the ladder
    sizes = (16, 11, 13) if kind == "non_row_additive" else (16, 16, 11, 13, 5)
    if kind == "non_row_additive":
        batches = [(torch.from_numpy(rng.rand(n).astype(np.float32)),) for n in sizes]
    else:
        batches = [_to_port((rng.randn(n, C).astype(np.float32), rng.randint(0, C, n).astype(np.int32))) for n in sizes]
    on, off = build(True), build(False)
    executor = on._get_executor()
    if kind.startswith("collection"):
        on.update(*batches[0])  # resolves the compute groups (members eager)
        off.update(*batches[0])
        batches = batches[1:]
    executor.dispatcher().eager_fresh_padded = True
    def host(value):
        return {k: _np(v) for k, v in value.items()} if isinstance(value, dict) else _np(value)

    for b in batches:
        if kind.endswith("forward"):
            _assert_tree_close(host(on(*b)), host(off(*b)), 1e-6)
        else:
            on.update(*b)
            off.update(*b)
    if kind.startswith("collection"):
        _assert_tree_close(_leader_states(on), _leader_states(off), 0)
    else:
        _assert_tree_close({k: _np(on._state[k]) for k in on._defaults}, {k: _np(off._state[k]) for k in off._defaults}, 1e-6)
    _assert_tree_close(host(on.compute()), host(off.compute()), 1e-6)
    stats = on.executor_status["stats"]
    if kind == "non_row_additive":
        # 16 fresh; 11 fresh and padded, served eagerly; 13's replay of the
        # same key probes, refuses the bucket and dispatches unpadded (a
        # fresh key)
        assert stats["probes"] == 1 and stats["padded_calls"] == 1 and stats["bucketing_enabled"] is False, stats
        assert stats["calls"] == 3 and stats["compiles"] == 3
    else:
        # 16 fresh, 16 replayed (a collection's first 16 resolved its
        # groups); 11 fresh and padded, served eagerly; 13 replays that key
        # padded, probing; 5 fresh and padded, served eagerly
        calls = len(batches)
        assert stats["calls"] == calls and stats["compiles"] == 3 and stats["cache_hits"] == calls - 3, stats
        assert stats["padded_calls"] == 1 and stats["probes"] == 1 and stats["bucketing_enabled"] is True, stats


# ------------------------------------------------------- steady batch keys


def _size_batches(sizes, seed=12):
    rng = np.random.RandomState(seed)
    return [_to_port((rng.randn(n, C).astype(np.float32), rng.randint(0, C, n).astype(np.int32))) for n in sizes]


@pytest.mark.parametrize("card_order", [False, True], ids=["cpu_order", "card_order"])
def test_a_steady_batch_gets_an_exact_key(card_order):
    """A steady batch of 4 (off the ladder) is keyed exactly from its
    repeat on, and only the ragged last batch (3) pads; states equal
    ``executor=False`` bit for bit. In the card's order the first call's
    fresh padded key is served eagerly, so no call pads but the last."""
    on, off = _accuracy(tm, executor=True), _accuracy(tm, executor=False)
    on._get_executor().dispatcher().eager_fresh_padded = card_order
    for b in _size_batches((4,) * 8 + (3,)):
        on.update(*b)
        off.update(*b)
        for k in off._defaults:
            assert torch.equal(on._state[k], off._state[k]), k
    stats = on.executor_status["stats"]
    # keys: the ladder's 8 (the first 4, padded) and the exact 4; 3 replays 8
    assert stats["compiles"] == 2 and stats["calls"] == 9 and stats["cache_hits"] == 7, stats
    assert (stats["padded_calls"], stats["probes"]) == ((1, 1) if card_order else (2, 1)), stats
    exact = on._get_executor()._exact_sizes
    assert exact == {4}


def test_a_steady_batch_after_its_first_call_never_pads():
    """From its repeat on, a steady batch of 4 replays its exact key:
    ``padded_calls`` stays where the first call left it."""
    m = _accuracy(tm, executor=True)
    batches = _size_batches((4,) * 20)
    m.update(*batches[0])
    m.update(*batches[1])
    padded = m.executor_status["stats"]["padded_calls"]
    for b in batches[2:]:
        m.update(*b)
    stats = m.executor_status["stats"]
    assert stats["padded_calls"] == padded == 1 and stats["donated_calls"] == 18, stats


def test_ragged_sizes_share_ladder_keys():
    """Sizes that vary call after call pad up the ladder and share its keys;
    sizes that repeat are keyed exactly, at most ``_EXACT_SIZES`` of them, so
    captures stay bounded. States equal ``executor=False``."""
    varying = [9, 10, 11, 12, 13, 14, 15, 9, 12, 10, 15, 11, 13, 14] * 2
    repeating = [n for n in range(9, 16) for _ in range(2)]
    for sizes, keys in ((varying, 1), (repeating, 1 + ex_port._EXACT_SIZES)):
        on, off = _accuracy(tm, executor=True), _accuracy(tm, executor=False)
        for b in _size_batches(sizes):
            on.update(*b)
            off.update(*b)
        for k in off._defaults:
            assert torch.equal(on._state[k], off._state[k]), k
        stats = on.executor_status["stats"]
        assert stats["compiles"] == keys and stats["calls"] == len(sizes), (sizes, stats)
        assert len(on._get_executor()._exact_sizes) <= ex_port._EXACT_SIZES


def test_steady_size_off_the_ladder_pads_once_where_jax_pads_every_call():
    """The kept difference from the JAX package (ROADMAP Queue C): JAX keys a
    steady batch of 5 on the ladder (8) and pads every call; the port pads
    its first call and keys the repeats exactly. The states agree bit for
    bit; ``padded_calls`` and ``compiles`` differ by design."""
    jax_tm = _jax_pkg()
    batches = [(np.random.RandomState(20 + i).rand(5).astype(np.float32),) for i in range(6)]
    ref = jax_tm.SumMetric(nan_strategy="ignore", executor=True)
    port = tm.SumMetric(nan_strategy="ignore", executor=True, device="cpu")
    for b in batches:
        ref.update(*_to_jax(b))
        port.update(*_to_port(b))
    np.testing.assert_array_equal(_np(port.sum_value), _np(ref.sum_value))
    ref_stats, port_stats = ref.executor_status["stats"], port.executor_status["stats"]
    assert (ref_stats["padded_calls"], ref_stats["probes"], ref_stats["compiles"]) == (6, 1, 1)
    assert (port_stats["padded_calls"], port_stats["probes"], port_stats["compiles"]) == (1, 1, 2)


def test_a_warmed_steady_spec_is_keyed_exactly():
    """``warmup`` of a spec off the ladder builds its exact key (the traffic's
    steady size) and the rungs below; the first real call replays it."""
    m = _accuracy(tm, executor=True)
    spec = torch.empty((12, C), device="meta"), torch.empty((12,), dtype=torch.int32, device="meta")
    report = m.warmup(spec, ladder=True)
    assert report["warmed"] == 3 and not report["skipped"], report  # exact 12; the rungs 8 and 16 (7, 15 rows)
    for b in _size_batches((12, 12, 12)):
        m.update(*b)
    stats = m.executor_status["stats"]
    assert stats["cache_hits"] == 3 and stats["padded_calls"] == 0, stats


def test_a_deferred_verdict_times_the_next_replay_up_to_its_cap():
    """A timed replay that ran beside an in-flight read hands the timing to
    the key's next replay, ``_VERDICT_DEFERRALS`` times; after that the key
    keeps replaying unjudged (no replay is timed)."""
    entry = ex_port._Entry(lambda: None)
    assert entry.timed_at == 2
    timed = []
    for replay in range(1, 40):
        entry.replays = replay
        if replay == entry.timed_at:
            timed.append(replay)
            ex_port._Dispatcher.defer_verdict(entry)
    assert timed == list(range(2, 3 + ex_port._VERDICT_DEFERRALS)) and entry.timed_at == 0


def test_the_read_pipeline_notes_when_its_worker_last_finished_a_read():
    """``last_read_done_ns``, which tells the verdict that a read ran beside
    a timed call, moves past a call's start once a read queued after it
    resolves, and before the drain sees the read done."""
    t0_ns = time.perf_counter_ns()
    async_read.get_pipeline().submit(lambda: None, owner="test")
    assert async_read.drain_pipeline(30.0)
    assert async_read.last_read_done_ns() >= t0_ns and async_read.pending_reads() == 0
