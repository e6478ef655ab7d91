"""Per-session fault containment of the port's lanes (``quarantine.py``,
``lanes.py``) held to the JAX package on the same seeded traffic: the
``LaneGuard`` policy, breaker, probation and JSON round trip; the admission
screen helpers; ``poison_batch``; and whole scenarios (a poisoned session
under each ``on_lane_fault`` policy, the breaker, the row screen fused into
the update, an attributed dispatch failure and its round rollback) compared
by quarantine table, per-lane states and degraded reads. Every OTHER lane
must stay bit-equal to a fault-free run.
"""
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
from torchmetrics_tpu import quarantine as jq
from torchmetrics_tpu.aggregation import CatMetric as JCat
from torchmetrics_tpu.aggregation import SumMetric as JSum
from torchmetrics_tpu.classification import MulticlassConfusionMatrix as JConf
from torchmetrics_tpu.classification import MulticlassF1Score as JF1
from torchmetrics_tpu.testing import faults as jfaults
from torchmetrics_tpu_torch import lanes as tl
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch import quarantine as tq
from torchmetrics_tpu_torch.aggregation import CatMetric, SumMetric
from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix, MulticlassF1Score
from torchmetrics_tpu_torch.io.checkpoint import restore_state, save_state
from torchmetrics_tpu_torch.ops import ingest
from torchmetrics_tpu_torch.testing import faults
from torchmetrics_tpu_torch.utils.exceptions import LaneFaultError

C = 6
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


# -------------------------------------------------------------------- guard

def _drive_guard(guard):
    """One fixed sequence of guard events; returns what it answered."""
    out = []
    guard.begin_round()
    out.append(guard.record_fault("a", "admission", "nan"))
    guard.quarantine("a")
    guard.note_diverted("a")
    out.append(guard.probe_progress("a", 1, faulted=False))
    out.append(guard.probe_progress("a", 3, faulted=False))
    guard.begin_round()
    out.append(guard.record_fault("b", "device", "inf"))
    out.append(guard.record_fault("b", "device", "inf"))  # the same event seen twice: one fault
    guard.begin_round()
    out.append(guard.record_fault("b", "dispatch", "boom"))
    guard.begin_round()
    out.append(guard.record_fault(7, "admission", "x"))
    guard.capture_last_good("c", 1.0, committed=2, health=0, slot="m")
    guard.note_diverted("c", 2)
    out.append(guard.staleness("c", 5, 1, slot="m"))
    out.append([guard.breaker_state(s) for s in ("a", "b", 7, "c")])
    return out


@pytest.mark.parametrize("policy", [None, "raise", "quarantine", "reset", "evict"])
def test_lane_guard_matches_jax(policy):
    kw = dict(policy=policy, breaker_threshold=2, breaker_window=3, unquarantine_after=2)
    jg, pg = jq.LaneGuard(**kw), tq.LaneGuard(**kw)
    assert _drive_guard(pg) == _drive_guard(jg)
    assert pg.stats == jg.stats
    assert pg.to_json() == jg.to_json() or sorted(map(repr, pg.to_json()["sessions"])) == sorted(
        map(repr, jg.to_json()["sessions"])
    )
    rows_p = {repr(r["session"]): r for r in pg.table({"a": 0, "b": 1})}
    rows_j = {repr(r["session"]): r for r in jg.table({"a": 0, "b": 1})}
    assert rows_p == rows_j
    restored = tq.LaneGuard(**kw)
    restored.load_json(jg.to_json(), known_sessions={"a", "b"})
    assert set(restored.fault_total) == {"a", "b"} and restored.round == jg.round


def test_lane_guard_rejects_bad_configuration():
    with pytest.raises(ValueError, match="on_lane_fault"):
        tq.LaneGuard(policy="explode")
    for kw in ({"breaker_threshold": 0}, {"breaker_window": 0}, {"unquarantine_after": 0}):
        with pytest.raises(ValueError):
            tq.LaneGuard(**kw)


# ---------------------------------------------------------------- screening

SCREEN_ROWS = [
    [(np.zeros(3, np.float32), np.zeros(3, np.int64))] * 3 + [(np.zeros(4, np.float32), np.zeros(3, np.int64))],
    [(np.zeros(2, np.float32),), (np.zeros(2, np.float32), np.zeros(2)), (np.zeros(2, np.float32),)],
    [(np.asarray([1.0, np.nan], np.float32),), (np.asarray([1, 2]),), (np.asarray([1.0, 2.0], np.float32),)],
    [],
]


@pytest.mark.parametrize("case", range(len(SCREEN_ROWS)))
def test_screen_helpers_match_jax(case):
    rows = SCREEN_ROWS[case]
    spec = tq.row_spec_majority(rows)
    assert spec == jq.row_spec_majority(rows)
    if spec is not None:
        for r in rows:
            assert tq.screen_row(r, spec) == jq.screen_row(r, spec)


def test_screen_slab_leaf_matches_jax():
    slab = np.zeros((8, 3), np.float32)
    slab[1, 2] = np.nan
    slab[4, 0] = np.inf
    slab[6, 0] = np.nan  # past the live rows: never screened
    got, want = [None] * 5, [None] * 5
    tq.screen_slab_leaf(slab, 5, 0, got)
    jq.screen_slab_leaf(slab, 5, 0, want)
    assert got == want == [None, "leaf 0 carries non-finite values", None, None, "leaf 0 carries non-finite values"]


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_poison_batch_matches_jax(mode):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    labels = np.arange(4)
    got = faults.poison_batch(x, labels, mode=mode, frac=0.3, seed=5)
    want = jfaults.poison_batch(x, labels, mode=mode, frac=0.3, seed=5)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] is labels
    t = faults.poison_batch(torch.from_numpy(x), mode=mode, frac=0.3, seed=5)[0]
    assert isinstance(t, torch.Tensor) and np.array_equal(_np(t), got[0], equal_nan=True)


# ---------------------------------------------------------------- scenarios

SESSIONS = [f"u{i}" for i in range(10)]
POISONED = "u3"


def _scenario_traffic(seed=0, rounds=3):
    rng = np.random.RandomState(seed)
    return [
        [(s, (rng.randn(5, C).astype(np.float32), rng.randint(0, C, 5))) for s in SESSIONS] for _ in range(rounds)
    ]


def _jax_coll(policy):
    return jtm.LanedCollection(
        {"f1": JF1(num_classes=C, validate_args=False), "confmat": JConf(num_classes=C, validate_args=False)},
        capacity=8,
        executor=False,
        on_lane_fault=policy,
    )


def _port_coll(policy):
    return tl.LanedCollection(
        {
            "f1": MulticlassF1Score(num_classes=C, validate_args=False, device=CPU),
            "confmat": MulticlassConfusionMatrix(num_classes=C, validate_args=False, device=CPU),
        },
        capacity=8,
        on_lane_fault=policy,
    )


def _run_poisoned(coll, poison_fn, traffic):
    coll.update_sessions(traffic[0])
    with poison_fn(coll, POISONED, seed=1):
        coll.update_sessions(traffic[1])
    coll.update_sessions(traffic[2])
    return coll


def _table(coll):
    keep = ("session", "lane", "faults", "breaker", "quarantined", "clean_probes", "diverted_rows")
    rows = [{k: r[k] for k in keep} | {"where": (r["last_fault"] or {}).get("where")} for r in coll.quarantine_table()]
    return sorted(rows, key=lambda r: repr(r["session"]))


@pytest.fixture(scope="module")
def clean_run():
    traffic = _scenario_traffic()
    coll = _port_coll(None)
    for items in traffic:
        coll.update_sessions(items)
    return traffic, {k: {f: _np(v) for f, v in st.items()} for k, st in coll.state().items()}, coll.sessions


@pytest.mark.parametrize("policy", ["quarantine", "reset", "evict"])
def test_poisoned_session_is_contained_like_jax(policy, clean_run):
    traffic, clean_state, clean_sessions = clean_run
    jax_coll = _run_poisoned(_jax_coll(policy), jfaults.poison_session, traffic)
    port_coll = _run_poisoned(_port_coll(policy), faults.poison_session, traffic)
    assert port_coll.sessions == jax_coll.sessions
    assert _table(port_coll) == _table(jax_coll)
    assert {k: port_coll.lane_status[k] for k in jax_coll.lane_status} == jax_coll.lane_status
    # every other lane is bit-equal to the fault-free run
    state = port_coll.state()
    for leader, fields in clean_state.items():
        for f in ("confmat", "tp", "fp"):
            if f not in fields:
                continue
            for sid, lane in clean_sessions.items():
                if sid == POISONED:
                    continue
                np.testing.assert_array_equal(_np(state[leader][f])[port_coll.sessions[sid]], fields[f][lane])
    jv, pv = jax_coll.lane_values(), port_coll.lane_values()
    assert set(pv) == set(jv)
    for sid in jv:
        for name in jv[sid]:
            want, got = jv[sid][name], pv[sid][name]
            assert isinstance(got, tq.DegradedValue) == isinstance(want, jq.DegradedValue)
            if isinstance(want, jq.DegradedValue):
                assert (got.updates_behind, got.age_updates) == (want.updates_behind, want.age_updates)
                want, got = want.value, got.value
            np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(port_coll.compute()["confmat"]), _np(jax_coll.compute()["confmat"]))


def test_raise_policy_raises_attributed_fault():
    traffic = _scenario_traffic(seed=2, rounds=2)
    coll = _port_coll("raise")
    coll.update_sessions(traffic[0])
    with faults.poison_session(coll, POISONED, seed=1):
        with pytest.raises(LaneFaultError) as info:
            coll.update_sessions(traffic[1])
    assert info.value.session_id == POISONED and info.value.where == "admission"


def _sum_laned(policy, screen=None):
    return tl.LanedMetric(SumMetric(nan_strategy="disable", device=CPU), capacity=8, on_lane_fault=policy,
                          admission_screen=screen, breaker_threshold=2)


def _jsum_laned(policy, screen=None):
    return jtm.LanedMetric(JSum(nan_strategy="disable"), capacity=8, executor=False, on_lane_fault=policy,
                           admission_screen=screen, breaker_threshold=2)


def _sum_rounds(laned, poisoned_rounds):
    for r in range(4):
        items = [(s, np.asarray([float(i + r), 1.0], np.float32)) for i, s in enumerate(("a", "b", "c"))]
        if r in poisoned_rounds:
            items[1] = ("b", np.asarray([np.nan, 1.0], np.float32))
        laned.update_sessions(items)
        laned.lane_values()  # a read point each round: the health scan runs
    return laned


@pytest.mark.parametrize("screen", [None, False], ids=["admission", "device_scan"])
def test_breaker_trips_to_eviction_like_jax(screen):
    port = _sum_rounds(_sum_laned("quarantine", screen), poisoned_rounds=(1, 2))
    jax = _sum_rounds(_jsum_laned("quarantine", screen), poisoned_rounds=(1, 2))
    assert port.sessions == jax.sessions  # "b" was evicted, then admitted afresh by its next batch
    assert port.lane_status["breaker_trips"] == jax.lane_status["breaker_trips"] == 1
    assert port.lane_status["evictions"] == jax.lane_status["evictions"] == 1
    assert {k: float(v) for k, v in port.lane_values().items()} == {k: float(v) for k, v in jax.lane_values().items()}


@pytest.mark.parametrize("screen", [None, False], ids=["admission", "device_scan"])
def test_probation_readmits_after_clean_probes_like_jax(screen):
    port = _sum_rounds(_sum_laned("quarantine", screen), poisoned_rounds=(1,))
    jax = _sum_rounds(_jsum_laned("quarantine", screen), poisoned_rounds=(1,))
    assert _table(port) == _table(jax)
    assert port.guard.stats == jax.guard.stats
    pv, jv = port.lane_values(), jax.lane_values()
    for sid in jv:
        assert isinstance(pv[sid], tq.DegradedValue) == isinstance(jv[sid], jq.DegradedValue)
        np.testing.assert_array_equal(_np(getattr(pv[sid], "value", pv[sid])), _np(getattr(jv[sid], "value", jv[sid])))
    assert np.isfinite(_np(port.sum_value)).all()
    np.testing.assert_array_equal(_np(port.lane_health), _np(jax._state["lane_health"]))


def test_dispatch_fault_rolls_back_and_redispatches_like_jax():
    traffic = _scenario_traffic(seed=4, rounds=2)
    results = []
    for make, inject in ((_jax_coll, jfaults.fail_lane_dispatch), (_port_coll, faults.fail_lane_dispatch)):
        coll = make("quarantine")
        coll.update_sessions(traffic[0])
        with inject(coll, POISONED, fail_n=1):
            assert coll.update_sessions(traffic[1]) == 1
        results.append(coll)
    jax_coll, port_coll = results
    assert _table(port_coll) == _table(jax_coll)
    js, ps = jax_coll.state(), port_coll.state()
    for leader in js:
        np.testing.assert_array_equal(_np(ps[leader]["lane_updates"]), _np(js[leader]["lane_updates"]))
        for f in ("confmat", "tp"):
            if f in js[leader]:
                np.testing.assert_array_equal(_np(ps[leader][f]), _np(js[leader][f]))


def test_eager_mode_screen_and_quarantine():
    port = tl.LanedMetric(CatMetric(nan_strategy="disable", device=CPU), capacity=8, on_lane_fault="quarantine",
                          admission_screen=False)
    jax = jtm.LanedMetric(JCat(nan_strategy="disable"), capacity=8, executor=False, on_lane_fault="quarantine",
                          admission_screen=False)
    for laned in (port, jax):
        laned.update_sessions([("a", np.asarray([1.0], np.float32)), ("b", np.asarray([2.0], np.float32))])
        laned.update_sessions([("a", np.asarray([np.nan], np.float32)), ("b", np.asarray([3.0], np.float32))])
    pv, jv = port.lane_values(), jax.lane_values()
    assert isinstance(pv["a"], tq.DegradedValue) and isinstance(jv["a"], jq.DegradedValue)
    np.testing.assert_array_equal(_np(pv["a"].value), _np(jv["a"].value))
    np.testing.assert_array_equal(_np(pv["b"]), _np(jv["b"]))
    assert _table(port) == _table(jax)


def test_quarantine_rides_the_snapshot_both_ways(tmp_path):
    for direction in ("port_to_jax", "jax_to_port"):
        src = _sum_rounds(_sum_laned("quarantine") if direction == "port_to_jax" else _jsum_laned("quarantine"), (3,))
        path = str(tmp_path / f"{direction}.ckpt")
        (save_state if direction == "port_to_jax" else jtm.save_state)(src, path)
        dst = _jsum_laned("quarantine") if direction == "port_to_jax" else _sum_laned("quarantine")
        (jtm.restore_state if direction == "port_to_jax" else restore_state)(path, dst)
        assert dst.sessions == src.sessions
        assert set(dst.guard.quarantined) == set(src.guard.quarantined) == {"b"}
        assert dst.guard.fault_total == src.guard.fault_total
        assert isinstance(dst.lane_values()["b"], (tq.DegradedValue, jq.DegradedValue))


def test_dump_diagnostics_carries_the_quarantine_table():
    laned = _sum_rounds(_sum_laned("quarantine"), (1,))
    diag = obs.dump_diagnostics(laned)
    rows = diag["lane_quarantine"]
    assert rows[0]["session"] == "b" and rows[0]["faults"] == 1  # the faulted session leads
    assert sorted(r["session"] for r in rows) == ["a", "b", "c"]  # every session with a cached read


# ------------------------------------------------------------------- mirror

def test_lane_state_mirror_folds_rows_incrementally():
    mirror = tq.LaneStateMirror()
    state = {"x": torch.arange(8.0).reshape(4, 2), "n": torch.zeros(4, dtype=torch.int32)}
    mirror.snapshot(state, [0, 1], update_count=1, capacity=4)
    assert mirror.stats == {"rebuilds": 1, "incremental": 0}
    state = {"x": state["x"].index_fill(0, torch.tensor([0, 1]), 9.0), "n": state["n"] + 1}
    rec = mirror.snapshot(state, [2], update_count=2, capacity=4)
    assert mirror.stats["incremental"] == 1
    np.testing.assert_array_equal(mirror.rows([0])["x"], [[9.0, 9.0]])
    np.testing.assert_array_equal(mirror.rows([3])["x"], [[6.0, 7.0]])  # untouched rows keep the rebuild's copy
    assert mirror.verify(state, 2) is False  # lanes 2, 3 of n moved without a fold
    assert rec.materialize() is None
    mirror.snapshot(state, [1], update_count=5, capacity=4)  # a broken chain: full rebuild
    assert mirror.stats["rebuilds"] == 2 and mirror.verify(state, 5)
    mirror.patch_rows([1], {"x": torch.zeros(1, 2), "n": torch.zeros(1, dtype=torch.int32)})
    np.testing.assert_array_equal(mirror.rows([1])["x"], [[0.0, 0.0]])
    assert set(rec.as_state()) == {"x", "n"}


def test_async_read_applies_quarantine_on_the_worker():
    laned = _sum_laned("quarantine", screen=False)
    laned.update_sessions([(s, np.asarray([1.0, 2.0], np.float32)) for s in ("a", "b", "c")])
    laned.update_sessions([("a", np.asarray([5.0, 5.0], np.float32)), ("b", np.asarray([np.nan, 1.0], np.float32))])
    got = laned.compute_async().result(timeout=60.0)  # the device scan attributes "b" on the worker
    assert set(laned.guard.quarantined) == {"b"}
    assert float(got) == float(laned.compute()) == 16.0  # "a" 13 + "c" 3, "b" excluded
    dv = laned.compute_session("b")
    assert isinstance(dv, tq.DegradedValue) and float(dv.value) == 3.0


def test_reset_policy_zeroes_the_lane_across_the_collection():
    traffic = _scenario_traffic(seed=6, rounds=3)
    results = []
    for make, poison in ((_jax_coll, jfaults.poison_session), (_port_coll, faults.poison_session)):
        results.append(_run_poisoned(make("reset"), poison, traffic))
    jax_coll, port_coll = results
    lane = port_coll.sessions[POISONED]
    for leader in ("f1", "confmat"):
        want = jax_coll.state()[leader]
        got = port_coll.state()[leader]
        for f in ("confmat", "tp", "lane_updates"):
            if f in want:
                np.testing.assert_array_equal(_np(got[f])[lane], _np(want[f])[lane])
    assert port_coll.lane_status["resets"] == jax_coll.lane_status["resets"] == 1


@pytest.mark.parametrize(
    "items, reason",
    [
        ([("a", np.ones(2, np.float32)), ("b", np.ones(2, np.float32)), ("w", np.ones(3, np.float32))], "shape"),
        ([("a", np.ones(2, np.float32)), ("b", np.ones(2, np.float32)), ("w", np.asarray([7, 7]))], "dtype kind"),
        ([("w", np.ones(3, np.float32)), ("a", np.ones(2, np.float32)), ("b", np.ones(2, np.float32))], "shape"),
    ],
    ids=["shape", "dtype_kind", "deviant_first"],
)
def test_admission_screen_diverts_malformed_rows_like_jax(items, reason):
    port, jax = _sum_laned("quarantine"), _jsum_laned("quarantine")
    for laned in (port, jax):
        laned.update_sessions(items)
    pv, jv = port.lane_values(), jax.lane_values()
    assert isinstance(pv["w"], tq.DegradedValue) and isinstance(jv["w"], jq.DegradedValue)
    assert reason in port.guard.last_fault["w"]["reason"]
    assert port.guard.last_fault["w"] == jax.guard.last_fault["w"]
    for sid in ("a", "b"):
        np.testing.assert_array_equal(_np(pv[sid]), _np(jv[sid]))


def test_unstackable_round_is_diverted_not_raised():
    laned = _sum_laned("quarantine")
    laned.update_sessions([("a", np.asarray([1.0], np.float32))])
    assert laned.update_sessions([("a", object())]) == 0
    assert laned.guard.fault_total["a"] == 1
    assert float(laned.lane_values()["a"].value) == 1.0


def test_lane_fault_error_carries_its_attribution():
    err = LaneFaultError("boom", session_id="s", lane=3, where="device")
    assert (err.session_id, err.lane, err.where) == ("s", 3, "device")
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    assert isinstance(err, TorchMetricsUserError)
