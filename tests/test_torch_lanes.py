"""Session lanes of the PyTorch port (``torchmetrics_tpu_torch/lanes.py``)
held to the JAX package's ``LanedMetric``/``LanedCollection``
(``executor=False``) on the same seeded traffic: per-lane states bit for bit,
per-lane values and the all-lane aggregate, the session-to-lane directory,
``lane_status``; the row-batched count's plain body against the per-row
count (sentinel rows, ``ignore_index``, the row-chunk boundary); lifecycle,
growth and compute-group aliasing; laned snapshots restored across the two
packages both ways; and what the deferred lane layout still refuses. Windowed lanes are held to the JAX package in
``tests/test_torch_windowed_lanes.py``.

The JAX side compiles a vmapped update per round shape, so the traffic is
built once per module and shared by the tests that read it.
"""
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu.aggregation import CatMetric as JCat
from torchmetrics_tpu.aggregation import MaxMetric as JMax
from torchmetrics_tpu.aggregation import MeanMetric as JMean
from torchmetrics_tpu.aggregation import MinMetric as JMin
from torchmetrics_tpu.aggregation import SumMetric as JSum
from torchmetrics_tpu.classification import MulticlassAccuracy as JAcc
from torchmetrics_tpu.classification import MulticlassConfusionMatrix as JConf
from torchmetrics_tpu.classification import MulticlassF1Score as JF1
from torchmetrics_tpu.classification import MulticlassPrecision as JPrec
from torchmetrics_tpu.classification import MulticlassRecall as JRec
from torchmetrics_tpu.lanes import LaneTable as JLaneTable
from torchmetrics_tpu.ops.executor import bucket_size as jax_bucket_size
from torchmetrics_tpu_torch import lanes as tl
from torchmetrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from torchmetrics_tpu_torch.classification import (
    BinaryAccuracy,
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelConfusionMatrix,
    MultilabelF1Score,
)
from torchmetrics_tpu_torch.io.checkpoint import restore_state, save_state
from torchmetrics_tpu_torch.ops import fused_classification as fc
from torchmetrics_tpu_torch.ops import ingest, kernels
from torchmetrics_tpu_torch.utils.exceptions import StateCorruptionError, TorchMetricsUserError

C = 10
SESSIONS = 40
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture(autouse=True)
def _ingest_reset():
    yield
    assert ingest.drain_pipeline(timeout=30.0)
    ingest.reset_for_tests()


# ------------------------------------------------------------------ traffic

def _classification_traffic(seed=0, rounds=3, batch=8, sessions=SESSIONS):
    """Per-call traffic: each call sends most sessions one batch (host numpy)."""
    rng = np.random.RandomState(seed)
    calls = []
    for _ in range(rounds):
        items = []
        for s in range(sessions):
            if rng.rand() < 0.8:
                items.append((f"w{s:02d}", (rng.randn(batch, C).astype(np.float32), rng.randint(0, C, batch))))
        calls.append(items)
    # a call where two sessions send two batches each (two rounds in one call)
    items = []
    for s in (3, 5):
        for _ in range(2):
            items.append((f"w{s:02d}", (rng.randn(batch, C).astype(np.float32), rng.randint(0, C, batch))))
    calls.append(items)
    return calls


def _jax_collection(**kw):
    return jtm.LanedCollection(
        {
            "accuracy": JAcc(num_classes=C, average="micro", validate_args=False),
            "f1": JF1(num_classes=C, validate_args=False),
            "precision": JPrec(num_classes=C, validate_args=False),
            "recall": JRec(num_classes=C, validate_args=False),
            "confmat": JConf(num_classes=C, validate_args=False),
        },
        capacity=8,
        executor=False,
        **kw,
    )


def _port_members():
    d = dict(device=CPU, validate_args=False)
    return {
        "accuracy": MulticlassAccuracy(num_classes=C, average="micro", **d),
        "f1": MulticlassF1Score(num_classes=C, **d),
        "precision": MulticlassPrecision(num_classes=C, **d),
        "recall": MulticlassRecall(num_classes=C, **d),
        "confmat": MulticlassConfusionMatrix(num_classes=C, **d),
    }


def _port_collection(**kw):
    return tl.LanedCollection(_port_members(), capacity=8, **kw)


@pytest.fixture(scope="module")
def classification_run():
    """The same traffic through the JAX and the port laned collections,
    with the port's bincount launches counted per call."""
    calls = _classification_traffic()
    jax_coll, port_coll = _jax_collection(), _port_collection()
    counts = []
    for items in calls:
        kernels.reset_gate_log()
        n_jax = jax_coll.update_sessions(items)
        n_port = port_coll.update_sessions(items)
        launched = kernels.gate_snapshot().get("bincount", {}).get("selections", {}).get("reference", 0)
        counts.append((n_jax, n_port, launched))
    assert ingest.drain_pipeline(timeout=30.0)
    return {
        "calls": calls,
        "jax": jax_coll,
        "port": port_coll,
        "counts": counts,
        "jax_values": jax_coll.lane_values(),
        "port_values": port_coll.lane_values(),
        "jax_state": jax_coll.state(),
        "port_state": port_coll.state(),
    }


# ------------------------------------------------------------------- tables

def test_bucket_ladders_match_jax():
    for n in (1, 7, 8, 9, 100, 1000, 1024, 1025, 3550):
        assert ingest.bucket_size(n) == jax_bucket_size(n)
        assert tl.lane_capacity_bucket(n) == jtm.lanes.lane_capacity_bucket(n)


@pytest.mark.parametrize("ids", [["a", "b", "c"], [3, "x", True, 7], ["s0", 5]])
def test_lane_table_directory_matches_jax(ids):
    jt, pt = JLaneTable(8), tl.LaneTable(8)
    for sid in ids:
        assert pt.allocate(sid) == jt.allocate(sid)
    pt.release(ids[0])
    jt.release(ids[0])
    assert pt.allocate("late") == jt.allocate("late")
    pt.grow(16)
    jt.grow(16)
    assert pt.to_json() == jt.to_json()
    assert tl.LaneTable.from_json(jt.to_json()).sessions == jt.sessions
    assert tl._encode_directory(pt).tobytes() == jtm.lanes._encode_directory(jt).tobytes()


def test_directory_rejects_out_of_range_and_duplicate_lanes():
    with pytest.raises(StateCorruptionError, match="outside capacity"):
        tl.LaneTable.from_json({"capacity": 8, "sessions": [["s", "a", 9]]})
    with pytest.raises(StateCorruptionError, match="two sessions"):
        tl.LaneTable.from_json({"capacity": 8, "sessions": [["s", "a", 1], ["s", "b", 1]]})


# ------------------------------------------------- classification collection

def test_directory_and_status_match_jax(classification_run):
    jax_coll, port_coll = classification_run["jax"], classification_run["port"]
    assert port_coll.sessions == jax_coll.sessions
    assert port_coll.capacity == jax_coll.capacity == 64
    js, ps = jax_coll.lane_status, port_coll.lane_status
    assert set(ps) == set(js)
    assert {k: ps[k] for k in js} == js


def test_rounds_and_one_count_launch_per_round(classification_run):
    for n_jax, n_port, launched in classification_run["counts"]:
        assert n_port == n_jax
        # every member of the collection shares the round's row-folded count
        assert launched == n_port


def test_per_lane_states_bit_equal_jax(classification_run):
    js, ps = classification_run["jax_state"], classification_run["port_state"]
    assert sorted(ps) == sorted(js)
    for leader in js:
        assert sorted(ps[leader]) == sorted(js[leader])
        for field, value in js[leader].items():
            got, want = _np(ps[leader][field]), _np(value)
            assert got.dtype == want.dtype, (leader, field)
            np.testing.assert_array_equal(got, want, err_msg=f"{leader}.{field}")


def test_per_lane_values_match_jax(classification_run):
    jv, pv = classification_run["jax_values"], classification_run["port_values"]
    assert set(pv) == set(jv)
    for sid in jv:
        for name, want in jv[sid].items():
            np.testing.assert_allclose(_np(pv[sid][name]), _np(want), rtol=0, atol=1e-6, err_msg=f"{sid}.{name}")


def test_all_lane_aggregate_matches_jax(classification_run):
    jc = classification_run["jax"].compute()
    pc = classification_run["port"].compute()
    assert set(pc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(_np(pc[k]), _np(jc[k]), rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(_np(pc["confmat"]), _np(jc["confmat"]))


def test_lane_values_equal_separate_collections(classification_run):
    """Each lane against an unlaned port collection fed that session's
    batches (the counts bit for bit, the values within 1e-6)."""
    port_coll = classification_run["port"]
    pv = classification_run["port_values"]
    per_session = {}
    for items in classification_run["calls"]:
        for sid, batch in items:
            per_session.setdefault(sid, []).append(batch)
    for sid in sorted(per_session)[:6]:
        coll = ttm.MetricCollection(_port_members(), device=CPU)
        for logits, target in per_session[sid]:
            coll.update(torch.from_numpy(logits), torch.from_numpy(target))
        want = coll.compute()
        for name in want:
            np.testing.assert_allclose(_np(pv[sid][name]), _np(want[name]), rtol=0, atol=1e-6)
        lane = port_coll.sessions[sid]
        np.testing.assert_array_equal(_np(port_coll["confmat"].confmat[lane]), _np(coll["confmat"].confmat))


def test_lane_value_routes(classification_run):
    port_coll = classification_run["port"]
    assert all(port_coll[name]._lane_route() == "vmap" for name in port_coll.keys())
    assert tl.LanedMetric(SumMetric(device=CPU))._lane_route() == "loop"
    assert tl.LanedMetric(CatMetric(device=CPU))._lane_route() == "eager"


def test_compute_groups_share_one_stacked_state(classification_run):
    port_coll = classification_run["port"]
    groups = sorted(sorted(g) for g in port_coll.collection.compute_groups.values())
    assert groups == [["accuracy"], ["confmat"], ["f1", "precision", "recall"]]
    assert port_coll["f1"].tp is port_coll["recall"].tp is port_coll["precision"].tp


def test_growth_keeps_compute_group_aliasing():
    calls = _classification_traffic(seed=3, rounds=1, sessions=12)
    coll = _port_collection()
    coll.update_sessions(calls[0])
    before = {sid: _np(coll["confmat"].confmat[lane]).copy() for sid, lane in coll.sessions.items()}
    assert coll.grow() == 32
    assert coll["f1"].tp is coll["recall"].tp
    assert coll["f1"].tp.shape[0] == 32
    for sid, lane in coll.sessions.items():
        np.testing.assert_array_equal(_np(coll["confmat"].confmat[lane]), before[sid])


def test_pipelined_and_inline_rounds_are_bit_equal(monkeypatch):
    calls = _classification_traffic(seed=5, rounds=2)
    flat = [pair for items in calls for pair in items]  # several rounds in one call
    states = {}
    for flag in ("1", "0"):
        monkeypatch.setenv(ingest.PIPELINE_ENV, flag)
        ttm.obs.reset()
        coll = _port_collection()
        coll.update_sessions(flat)
        assert ingest.drain_pipeline(timeout=30.0)
        states[flag] = {k: {f: _np(v) for f, v in st.items()} for k, st in coll.state().items()}
        pipelined = ttm.obs.counters_snapshot().get("lanes.pipelined_rounds", 0)
        assert (pipelined > 0) == (flag == "1")
        ingest.reset_for_tests()
    for leader in states["1"]:
        for f in states["1"][leader]:
            np.testing.assert_array_equal(states["1"][leader][f], states["0"][leader][f])


# ------------------------------------------------------ aggregation families

FAMILIES = {
    "sum": (lambda: JSum(nan_strategy="disable"), lambda: SumMetric(nan_strategy="disable", device=CPU)),
    "mean": (lambda: JMean(nan_strategy="disable"), lambda: MeanMetric(nan_strategy="disable", device=CPU)),
    "max": (lambda: JMax(nan_strategy="disable"), lambda: MaxMetric(nan_strategy="disable", device=CPU)),
    "min": (lambda: JMin(nan_strategy="disable"), lambda: MinMetric(nan_strategy="disable", device=CPU)),
    "cat": (lambda: JCat(nan_strategy="disable"), lambda: CatMetric(nan_strategy="disable", device=CPU)),
}


def _family_traffic(family, seed):
    rng = np.random.RandomState(seed)
    calls = []
    for _ in range(3):
        items = []
        for s in range(10):
            x = rng.randint(-20, 20, 6).astype(np.float32)
            items.append((f"s{s}", (x, np.ones(6, np.float32)) if family == "mean" else (x,)))
        calls.append(items)
    return calls


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_lanes_match_jax_and_independent_instances(family):
    make_jax, make_port = FAMILIES[family]
    jax_laned = jtm.LanedMetric(make_jax(), capacity=8, executor=False)
    port_laned = tl.LanedMetric(make_port(), capacity=8)
    singles = {}
    for items in _family_traffic(family, seed=11):
        assert port_laned.update_sessions(items) == jax_laned.update_sessions(items)
        for sid, batch in items:
            m = singles.setdefault(sid, make_port())
            m.update(*(torch.from_numpy(b) for b in batch))
    assert port_laned.sessions == jax_laned.sessions
    jv, pv = jax_laned.lane_values(), port_laned.lane_values()
    for sid in jv:
        np.testing.assert_array_equal(_np(pv[sid]), _np(jv[sid]))
        np.testing.assert_array_equal(_np(pv[sid]), _np(singles[sid].compute()))
    if family != "cat":
        np.testing.assert_array_equal(_np(port_laned.compute()), _np(jax_laned.compute()))
    assert port_laned.lane_status["compiled"] == (family != "cat")


def test_padded_and_sentinel_rows_never_land():
    laned = tl.LanedMetric(SumMetric(nan_strategy="disable", device=CPU), capacity=8)
    laned.update_sessions([("a", np.asarray([1.0], np.float32)), ("b", np.asarray([2.0], np.float32))])
    cap = laned.capacity
    ids = np.asarray([laned.sessions["a"], cap, laned.sessions["b"]], np.int32)
    rows = torch.tensor([[5.0], [np.nan], [7.0]])
    laned.update(ids, rows)
    vals = laned.lane_values()
    assert float(vals["a"]) == 6.0 and float(vals["b"]) == 9.0
    assert _np(laned.lane_updates).tolist()[:2] == [2, 2]
    assert np.isfinite(_np(laned.sum_value)).all()


def test_inactive_lanes_contribute_identity():
    laned = tl.LanedMetric(MinMetric(nan_strategy="disable", device=CPU), capacity=8)
    laned.update_sessions([("a", np.asarray([3.0], np.float32)), ("b", np.asarray([5.0], np.float32))])
    laned.evict("a")
    assert float(laned.compute()) == 5.0


# ------------------------------------------------------------ row-batched count

def _rows_case(seed, rows, batch, ignore_index):
    rng = np.random.RandomState(seed)
    preds = torch.from_numpy(rng.randn(rows, batch, C).astype(np.float32))
    target = torch.from_numpy(rng.randint(0, C, (rows, batch)))
    if ignore_index is not None:
        target[torch.from_numpy(rng.rand(rows, batch) < 0.2)] = ignore_index
    return preds, target


@pytest.mark.parametrize("ignore_index", [None, -1, 3])
@pytest.mark.parametrize("chunk_rows", [None, 1, 3])
def test_row_folded_count_equals_per_row_count(monkeypatch, ignore_index, chunk_rows):
    if chunk_rows is not None:
        monkeypatch.setattr(fc, "ROW_BINS_LIMIT", chunk_rows * C * C)
    preds, target = _rows_case(7, 7, 16, ignore_index)
    kernels.reset_gate_log()
    got = fc.multiclass_confusion_counts_rows(preds, target, C, ignore_index)
    launched = kernels.gate_snapshot()["bincount"]["selections"]["reference"]
    assert launched == (1 if chunk_rows is None else -(-7 // chunk_rows))
    for r in range(7):
        want = fc.multiclass_confusion_counts(preds[r], target[r], C, ignore_index)
        assert torch.equal(got[r], want), r


def test_row_folded_binary_and_multilabel_counts_equal_per_row():
    rng = np.random.RandomState(2)
    preds = torch.from_numpy(rng.rand(5, 12).astype(np.float32))
    preds[1] = preds[1] * 6 - 3  # one row of logits: its sigmoid is decided per row
    target = torch.from_numpy(rng.randint(0, 2, (5, 12)))
    got = fc.binary_confusion_counts_rows(preds, target, 0.5, None)
    for r in range(5):
        assert torch.equal(got[r], fc.binary_confusion_counts(preds[r], target[r], 0.5, None))
    preds = torch.from_numpy(rng.randn(4, 9, 3).astype(np.float32))
    target = torch.from_numpy(rng.randint(0, 2, (4, 9, 3)))
    got = fc.multilabel_confusion_counts_rows(preds, target, 3, 0.5, -1)
    for r in range(4):
        assert torch.equal(got[r], fc.multilabel_confusion_counts(preds[r], target[r], 3, 0.5, -1))


@pytest.mark.parametrize(
    "make",
    [
        lambda: MulticlassF1Score(num_classes=C, device=CPU),
        lambda: MulticlassAccuracy(num_classes=C, average="micro", device=CPU),
        lambda: MulticlassConfusionMatrix(num_classes=C, ignore_index=-1, device=CPU),
        lambda: BinaryAccuracy(device=CPU),
        lambda: MultilabelF1Score(num_labels=3, device=CPU),
        lambda: MultilabelConfusionMatrix(num_labels=3, device=CPU),
    ],
)
def test_row_batched_update_equals_per_row_loop(make):
    m = make()
    rng = np.random.RandomState(4)
    name = type(m).__name__
    if name.startswith("Binary"):
        args = (torch.from_numpy(rng.rand(6, 10).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, (6, 10))))
    elif name.startswith("Multilabel"):
        args = (torch.from_numpy(rng.rand(6, 10, 3).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, (6, 10, 3))))
    else:
        target = rng.randint(0, C, (6, 10))
        target[0, :3] = -1 if getattr(m, "ignore_index", None) == -1 else target[0, :3]
        args = (torch.from_numpy(rng.randn(6, 10, C).astype(np.float32)), torch.from_numpy(target))
    states = {k: torch.stack([v] * 6) for k, v in m.init_state().items()}
    kernels.reset_gate_log()
    batched = m.functional_update_rows(states, *args)
    assert kernels.gate_snapshot()["bincount"]["selections"]["reference"] == 1
    looped = ttm.Metric.functional_update_rows(m, states, *args)
    for k in looped:
        assert torch.equal(batched[k], looped[k]), k
    vm = torch.func.vmap(m.functional_compute)(batched)
    for r in range(6):
        assert torch.equal(vm[r], m.functional_compute({k: v[r] for k, v in batched.items()}))


# ------------------------------------------------------------------ lifecycle

def test_admit_evict_reset_and_idle():
    laned = tl.LanedMetric(SumMetric(device=CPU), capacity=8)
    laned.update_sessions([(s, np.asarray([1.0], np.float32)) for s in ("a", "b", "c")])
    assert laned.evict("b") == 1
    assert laned.admit("d") == 1  # lowest free lane first
    laned.reset_session("a")
    vals = laned.lane_values()
    assert float(vals["a"]) == 0.0 and float(vals["c"]) == 1.0 and float(vals["d"]) == 0.0
    assert laned.lane_status["evictions"] == 1 and laned.lane_status["resets"] == 1
    assert laned.evict_idle(3600.0) == []
    assert sorted(laned.evict_idle(0.0)) == ["a", "c", "d"]
    laned.update_sessions([("e", np.asarray([2.0], np.float32))])
    laned.reset()
    assert list(laned.sessions) == ["e"] and float(laned.lane_values()["e"]) == 0.0


def test_growth_and_max_capacity():
    laned = tl.LanedMetric(SumMetric(device=CPU), capacity=8, max_capacity=16)
    laned.update_sessions([(f"s{i}", np.asarray([float(i)], np.float32)) for i in range(12)])
    assert laned.capacity == 16 and laned.lane_status["grows"] == 1
    assert {k: float(v) for k, v in laned.lane_values().items()} == {f"s{i}": float(i) for i in range(12)}
    with pytest.raises(TorchMetricsUserError, match="max_capacity"):
        laned.update_sessions([(f"t{i}", np.asarray([1.0], np.float32)) for i in range(8)])


def test_remap_capacity_rehouses_deterministically():
    laned = tl.LanedMetric(SumMetric(device=CPU), capacity=16)
    laned.update_sessions([(f"s{i}", np.asarray([float(i)], np.float32)) for i in range(10)])
    laned.evict("s2")
    before = {k: float(v) for k, v in laned.lane_values().items()}
    with pytest.warns(UserWarning, match="evicting 1 session"):
        assert laned.remap_capacity(8) == 8
    assert laned.sessions == {sid: i for i, sid in enumerate(["s0", "s1"] + [f"s{i}" for i in range(3, 9)])}
    after = {k: float(v) for k, v in laned.lane_values().items()}
    assert all(after[k] == before[k] for k in after) and "s9" not in after


def test_wrapping_and_forward_are_refused():
    laned = tl.LanedMetric(SumMetric(device=CPU))
    with pytest.raises(ValueError, match="another LanedMetric"):
        tl.LanedMetric(laned)
    with pytest.raises(TorchMetricsUserError, match="update_sessions"):
        laned(torch.ones(2))


# -------------------------------------------------------------- refusals

def test_deferred_lanes_name_the_missing_layer():
    """The deferred lane layout exists now (``tests/test_torch_deferred_lanes.py``
    holds it to the JAX package); what it still refuses is named: eager
    (list-state) lanes, which carry no fixed-shape lane axis to stack."""
    laned = tl.LanedMetric(SumMetric(device=CPU), reduce="deferred")
    step = tl.make_deferred_lane_step(laned, None)
    assert isinstance(step, tl.DeferredLaneStep) and step.num_shards == 1
    assert laned.deferred_pending is False
    restored = tl.LanedMetric(SumMetric(device=CPU))
    restored.load_state({**restored.init_sharded_state(2), "_sharded_shards": 2})
    assert restored.capacity == 8 and not restored.deferred_pending
    with pytest.raises(TorchMetricsUserError, match="fixed-shape lane states"):
        tl.make_deferred_lane_step(tl.LanedMetric(CatMetric(device=CPU)), 2)
    with pytest.raises(ValueError, match="stacked shards"):
        tl.make_deferred_lane_step(laned, 0)


def test_prewarm_growth_reports_no_executor():
    report = tl.LanedMetric(SumMetric(device=CPU)).prewarm_growth((np.ones(2, np.float32),), rows=4)
    assert report["warmed"] == 0 and report["skipped"] == [tl.LANED_STEP_ASIDE]
    assert "ROADMAP Queue A item 4" in tl.LANED_STEP_ASIDE
    assert tl.LanedMetric(CatMetric(device=CPU)).prewarm_growth((), rows=1)["skipped"][0].startswith("eager lane mode")


# ----------------------------------------------------------------- snapshots

def test_round_trip_compiled_and_adapted_capacity(tmp_path):
    laned = tl.LanedMetric(SumMetric(device=CPU), capacity=16)
    laned.update_sessions([(f"s{i}", np.asarray([float(i)], np.float32)) for i in range(12)])
    path = str(tmp_path / "lanes.ckpt")
    save_state(laned, path)
    fresh = tl.LanedMetric(SumMetric(device=CPU), capacity=8)
    manifest = restore_state(path, fresh)
    assert manifest["lanes"] == {"capacity": 16, "active": 12, "compiled": True, "policy": None, "quarantined": 0}
    assert manifest["topology"]["lane_capacity"] == 16
    assert fresh.capacity == 16 and fresh.sessions == laned.sessions
    assert {k: float(v) for k, v in fresh.lane_values().items()} == {k: float(v) for k, v in laned.lane_values().items()}


def test_round_trip_eager_cat_mode(tmp_path):
    laned = tl.LanedMetric(CatMetric(device=CPU), capacity=8)
    for _ in range(2):
        laned.update_sessions([(s, np.asarray([1.0, 2.0], np.float32)) for s in ("a", "b")])
    path = str(tmp_path / "cat.ckpt")
    save_state(laned, path)
    fresh = tl.LanedMetric(CatMetric(device=CPU), capacity=8)
    restore_state(path, fresh)
    for sid, v in laned.lane_values().items():
        np.testing.assert_array_equal(_np(fresh.lane_values()[sid]), _np(v))


def test_restore_validation_names_lanes():
    laned = tl.LanedMetric(SumMetric(nan_strategy="disable", device=CPU), capacity=8)
    laned.update_sessions([("a", np.asarray([1.0], np.float32)), ("b", np.asarray([2.0], np.float32))])
    export = laned.state()
    export["sum_value"] = export["sum_value"].clone()
    export["sum_value"][laned.sessions["b"]] = float("nan")
    with pytest.raises(StateCorruptionError, match=r"shard\(s\) \[1\]"):
        tl.LanedMetric(SumMetric(device=CPU), capacity=8).load_state(export, check_finite=True)
    export = laned.state()
    export["lane_updates"] = export["lane_updates"].clone()
    export["lane_updates"][0] = -3
    with pytest.raises(StateCorruptionError, match="negative per-lane"):
        tl.LanedMetric(SumMetric(device=CPU), capacity=8).load_state(export)
    export = laned.state()
    export["sum_value"] = torch.zeros(16)
    export["lane_updates"] = torch.zeros(16, dtype=torch.int32)
    export["lane_health"] = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(StateCorruptionError, match="capacity"):
        tl.LanedMetric(SumMetric(device=CPU), capacity=8).load_state(export)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_laned_metric_snapshot_restores_across_packages(tmp_path, direction):
    calls = _family_traffic("sum", seed=21)
    jax_laned = jtm.LanedMetric(JSum(nan_strategy="disable"), capacity=8, executor=False)
    port_laned = tl.LanedMetric(SumMetric(nan_strategy="disable", device=CPU), capacity=8)
    for items in calls:
        jax_laned.update_sessions(items)
        port_laned.update_sessions(items)
    path = str(tmp_path / "cross.ckpt")
    if direction == "jax_to_port":
        jtm.save_state(jax_laned, path)
        target = tl.LanedMetric(SumMetric(nan_strategy="disable", device=CPU), capacity=8)
        restore_state(path, target)
        source = jax_laned
    else:
        save_state(port_laned, path)
        target = jtm.LanedMetric(JSum(nan_strategy="disable"), capacity=8, executor=False)
        jtm.restore_state(path, target)
        source = port_laned
    assert target.sessions == source.sessions
    for sid, v in source.lane_values().items():
        np.testing.assert_array_equal(_np(target.lane_values()[sid]), _np(v))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_laned_collection_snapshot_restores_across_packages(tmp_path, classification_run, direction):
    path = str(tmp_path / "coll.ckpt")
    first_round = classification_run["calls"][0]
    if direction == "jax_to_port":
        jtm.save_state(classification_run["jax"], path)
        target = _port_collection()
        target.update_sessions(first_round)  # resolve the compute groups as the source did
        restore_state(path, target)
        source = classification_run["port"]
    else:
        save_state(classification_run["port"], path)
        target = _jax_collection()
        target.update_sessions(first_round)
        jtm.restore_state(path, target)
        source = classification_run["jax"]
    assert target.sessions == source.sessions
    got, want = target.state(), source.state()
    for leader in want:
        for field in ("tp", "confmat", "lane_updates"):
            if field in want[leader]:
                np.testing.assert_array_equal(_np(got[leader][field]), _np(want[leader][field]))


def test_compute_async_matches_blocking_compute(classification_run):
    port_coll = classification_run["port"]
    fut = port_coll.compute_async()
    got = fut.result(timeout=60.0)
    want = port_coll.compute()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_laned_metric_status_and_sessions_match_jax():
    calls = _family_traffic("sum", seed=31)
    jax_laned = jtm.LanedMetric(JSum(nan_strategy="disable"), capacity=8, executor=False)
    port_laned = tl.LanedMetric(SumMetric(nan_strategy="disable", device=CPU), capacity=8)
    for items in calls:
        jax_laned.update_sessions(items)
        port_laned.update_sessions(items)
    for laned in (jax_laned, port_laned):
        laned.evict("s3")
        laned.reset_session("s4")
        laned.admit("late")
    js, ps = jax_laned.lane_status, port_laned.lane_status
    assert {k: ps[k] for k in js} == js
    for sid in jax_laned.sessions:
        np.testing.assert_array_equal(_np(port_laned.compute_session(sid)), _np(jax_laned.compute_session(sid)))
    np.testing.assert_array_equal(_np(port_laned.compute()), _np(jax_laned.compute()))


def test_collection_copy_keeps_one_table_and_its_fault_routing():
    import copy

    coll = tl.LanedCollection({"s": SumMetric(device=CPU), "m": MaxMetric(device=CPU)}, capacity=8, on_lane_fault="evict")
    coll.update_sessions([("a", np.ones(2, np.float32)), ("b", np.ones(2, np.float32))])
    twin = copy.deepcopy(coll)
    assert twin["s"]._table is twin["m"]._table is twin._table
    assert all(m.__dict__["_fault_owner"] is twin for m in (twin["s"], twin["m"]))
    twin.update_sessions([("a", np.asarray([np.nan, 1.0], np.float32))])
    assert twin.sessions == {"b": 1} and coll.sessions == {"a": 0, "b": 1}


def test_root_exports_and_laned_shorthands():
    for name in ("LanedMetric", "LanedCollection", "LaneGuard", "DegradedValue", "make_deferred_lane_step"):
        assert name in ttm.__all__ and name in jtm.__all__, name
    laned = SumMetric(device=CPU).laned(capacity=20, max_capacity=100)
    assert isinstance(laned, tl.LanedMetric) and laned.capacity == 32 and laned.max_capacity == 128
    coll = ttm.MetricCollection(_port_members(), device=CPU).laned(capacity=8)
    assert isinstance(coll, tl.LanedCollection) and sorted(coll.keys()) == sorted(_port_members())


def test_mismatched_row_shapes_raise_like_jax():
    items = [("a", np.ones(3, np.float32)), ("b", np.ones(4, np.float32))]
    with pytest.raises(ValueError, match="share shapes"):
        tl.LanedMetric(SumMetric(device=CPU)).update_sessions(items)
    with pytest.raises(ValueError, match="share shapes"):
        jtm.LanedMetric(JSum(), executor=False).update_sessions(items)


def test_duplicate_session_in_one_call_runs_sequential_rounds():
    laned = tl.LanedMetric(MaxMetric(device=CPU))
    n = laned.update_sessions([("a", np.asarray([1.0], np.float32)), ("a", np.asarray([5.0], np.float32)),
                               ("b", np.asarray([2.0], np.float32))])
    assert n == 2 and float(laned.lane_values()["a"]) == 5.0
    assert _np(laned.lane_updates)[:2].tolist() == [2, 1]


def test_eviction_resets_every_member_of_the_collection():
    coll = tl.LanedCollection({"s": SumMetric(device=CPU), "m": MaxMetric(device=CPU)}, capacity=8)
    coll.update_sessions([("a", np.asarray([3.0], np.float32)), ("b", np.asarray([4.0], np.float32))])
    lane = coll.evict("a")
    assert float(coll["s"].sum_value[lane]) == 0.0 and float(coll["m"].max_value[lane]) == float("-inf")
    assert coll["s"]._table is coll["m"]._table and coll.sessions == {"b": 1}


def test_dispatch_span_and_counters():
    from torchmetrics_tpu_torch import obs

    obs.set_tracing(True)
    obs.reset_ring()
    obs.reset()
    try:
        laned = tl.LanedMetric(SumMetric(device=CPU), capacity=8)
        laned.update_sessions([(s, np.ones(2, np.float32)) for s in "abc"])
        names = [e.name for e in obs.peek_events()]
        assert "tm_tpu.lanes.dispatch" in names and "tm_tpu.lanes.pack" in names
        counters = obs.counters_snapshot()
        assert counters["lanes.dispatches"] == 1 and counters["lanes.rows"] == 3
        assert obs.telemetry_snapshot()["gauges"]["lanes.occupancy"] == 3
    finally:
        obs.set_tracing(None)
        obs.reset_ring()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_eager_cat_snapshot_restores_across_packages(tmp_path, direction):
    calls = _family_traffic("cat", seed=41)[:2]
    jax_laned = jtm.LanedMetric(JCat(nan_strategy="disable"), capacity=8, executor=False)
    port_laned = tl.LanedMetric(CatMetric(nan_strategy="disable", device=CPU), capacity=8)
    for items in calls:
        jax_laned.update_sessions(items)
        port_laned.update_sessions(items)
    path = str(tmp_path / "cat.ckpt")
    if direction == "jax_to_port":
        jtm.save_state(jax_laned, path)
        target, source = tl.LanedMetric(CatMetric(nan_strategy="disable", device=CPU), capacity=8), jax_laned
        restore_state(path, target)
    else:
        save_state(port_laned, path)
        target, source = jtm.LanedMetric(JCat(nan_strategy="disable"), capacity=8, executor=False), port_laned
        jtm.restore_state(path, target)
    assert target.sessions == source.sessions
    for sid, v in source.lane_values().items():
        np.testing.assert_array_equal(_np(target.lane_values()[sid]), _np(v))


def test_restore_into_another_capacity_remaps_like_jax():
    items = [(f"s{i}", np.asarray([float(i)], np.float32)) for i in range(12)]
    jax_src = jtm.LanedMetric(JSum(), capacity=16, executor=False, on_lane_fault="quarantine")
    port_src = tl.LanedMetric(SumMetric(device=CPU), capacity=16, on_lane_fault="quarantine")
    for laned in (jax_src, port_src):
        laned.update_sessions(items)
        laned.evict("s1")
    jax_dst = jtm.LanedMetric(JSum(), capacity=8, executor=False, on_lane_fault="quarantine")
    port_dst = tl.LanedMetric(SumMetric(device=CPU), capacity=8, on_lane_fault="quarantine")
    with pytest.warns(UserWarning, match="evicting 3 session"):
        port_dst.load_state(port_src.state(), target_capacity=8)
    with pytest.warns(UserWarning):
        jax_dst.load_state(jax_src.state(), target_capacity=8)
    assert port_dst.capacity == jax_dst.capacity == 8
    assert port_dst.sessions == jax_dst.sessions
    assert {k: float(v) for k, v in port_dst.lane_values().items()} == {k: float(v) for k, v in jax_dst.lane_values().items()}
