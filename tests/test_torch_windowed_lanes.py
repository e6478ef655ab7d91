"""Windowed session lanes of the PyTorch port (``lanes.py`` over
``windows.py``) held to the JAX package's ``LanedMetric``/``LanedCollection``
of windowed metrics (``executor=False``) on the same numpy traffic and the
same per-session schedule of rounds, late events and clock skew.

Tolerances: every lane's ring, ``window_head``, ``lane_updates`` and the
counts bit for bit; float values within 1e-6. Also here: growth from a
small capacity, kill and restore mid-window, the guard's row screen and
round rollback over the ring, the row-folded count (one counting launch a
round, ``lanes.rows_looped`` 0), and a lane guard baseline that keeps its
value across windowed rounds and advances (the ring is written out of
place).
"""
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu.testing import faults as jfaults
from torchmetrics_tpu_torch import lanes as tl
from torchmetrics_tpu_torch import obs as tobs
from torchmetrics_tpu_torch.aggregation import MeanMetric, SumMetric
from torchmetrics_tpu_torch.classification import (
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
)
from torchmetrics_tpu_torch.io.checkpoint import load_manifest, restore_state, save_state
from torchmetrics_tpu_torch.ops import ingest, kernels
from torchmetrics_tpu_torch.testing import faults
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.windows import WindowedMetric

C = 5
W = 3
CPU = "cpu"
ATOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture(autouse=True)
def _ingest_reset():
    yield
    assert ingest.drain_pipeline(timeout=30.0)
    ingest.reset_for_tests()


def _same(port, ref, name=""):
    port, ref = _np(port), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    if ref.dtype.kind in "biu":
        assert port.dtype == ref.dtype, (name, port.dtype, ref.dtype)
        np.testing.assert_array_equal(port, ref, err_msg=name)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=0, atol=ATOL, err_msg=name)


def _value(v):
    return v.value if hasattr(v, "updates_behind") else v


def _same_tree(port, ref, name=""):
    port, ref = _value(port), _value(ref)
    if isinstance(ref, dict):
        assert set(port) == set(ref), (name, sorted(port), sorted(ref))
        for k in ref:
            _same_tree(port[k], ref[k], f"{name}.{k}")
    else:
        _same(port, ref, name)


def _same_laned(port, ref, name=""):
    """Every stacked state bit for bit, the directory and the clocks."""
    assert port.sessions == ref.sessions, name
    for f in ref._defaults:
        p, r = _np(port._state[f]), np.asarray(ref._state[f])
        assert p.dtype == r.dtype and p.shape == r.shape, (name, f, p.dtype, r.dtype, p.shape, r.shape)
        np.testing.assert_array_equal(p, r, err_msg=f"{name}.{f}")
    assert port.window_spec() == ref.window_spec(), name


# ------------------------------------------------------------------ traffic

def _entry_members():
    d = dict(validate_args=False, device=CPU)
    return {
        "accuracy": MulticlassAccuracy(num_classes=C, average="micro", **d),
        "f1": MulticlassF1Score(num_classes=C, **d),
        "precision": MulticlassPrecision(num_classes=C, **d),
        "recall": MulticlassRecall(num_classes=C, **d),
        "confmat": MulticlassConfusionMatrix(num_classes=C, **d),
    }


def _jax_entry_members():
    from torchmetrics_tpu import classification as jc

    d = dict(validate_args=False)
    return {
        "accuracy": jc.MulticlassAccuracy(num_classes=C, average="micro", **d),
        "f1": jc.MulticlassF1Score(num_classes=C, **d),
        "precision": jc.MulticlassPrecision(num_classes=C, **d),
        "recall": jc.MulticlassRecall(num_classes=C, **d),
        "confmat": jc.MulticlassConfusionMatrix(num_classes=C, **d),
    }


def _port_coll(capacity=8, **kw):
    return ttm.MetricCollection(_entry_members(), device=CPU).windowed(W, lateness=1).laned(capacity=capacity, **kw)


def _jax_coll(capacity=8, **kw):
    """The JAX package's windowed laned entry collection. Its window advance
    donates a group leader's ring that the group's followers still hold (a
    follower's next advance reads a deleted buffer), so the reference runs
    without compute groups, every member on its own ring."""
    lc = jtm.MetricCollection(_jax_entry_members()).windowed(W, lateness=1).laned(capacity=capacity, executor=False, **kw)
    lc.collection = jtm.MetricCollection(dict(lc._members), compute_groups=False)
    return lc


def _batch(rng, n=6):
    return rng.randn(n, C).astype(np.float32), rng.randint(0, C, n)


def _schedule(seed=0, clocks=4):
    """Per clock: most open sessions send one batch (s01 and s04 two: two
    rounds); then two sessions send a batch one window late and two others
    one two windows late; session s03's clock is skewed one window ahead at
    clock 2; at clock 3 sixteen new sessions join mid-window, growing the
    lanes from 8 to 32 while every old lane's ring holds three windows."""
    rng = np.random.RandomState(seed)
    steps = []
    for t in range(clocks):
        items = []
        for s in range(8 if t < 3 else 24):
            if rng.rand() < 0.8:
                items.append((f"s{s:02d}", _batch(rng)))
        items += [(f"s{s:02d}", _batch(rng)) for s in (1, 4)]
        steps.append(("round", None, items))
        if t >= 1:
            steps.append(("late", 1, [(f"s{s:02d}", _batch(rng)) for s in (2, 5)]))
        if t >= 2:
            steps.append(("late", 2, [(f"s{s:02d}", _batch(rng)) for s in (6, 7)]))
        if t == 2:
            steps.append(("skew", "s03", None))
        steps.append(("advance", None, None))
    return steps


def _grown(coll, before):
    """The capacity change, directory, clocks and every member's stacked
    state (host copies) right after a growth."""
    return {
        "capacity": (before, coll.capacity),
        "sessions": dict(coll.sessions),
        "spec": coll.window_spec(),
        "states": {name: {f: _np(coll[name]._state[f]).copy() for f in coll[name]._defaults} for name in coll.keys()},
    }


def _drive(coll, steps, late_event, skew_clock):
    """Run ``steps``; returns the snapshot taken right after the first
    growth (None without one)."""
    grown = None
    for op, arg, items in steps:
        before = coll.capacity
        if op == "round":
            coll.update_sessions(items)
        elif op == "late":
            for sid, batch in items:
                late_event(coll, sid, batch, age=arg)
        elif op == "skew":
            skew_clock(coll, coll.sessions[arg], 1)
        else:
            coll.advance_windows()
        if grown is None and coll.capacity != before:
            grown = _grown(coll, before)
    return grown


@pytest.fixture(scope="module")
def collection_run():
    """The same schedule through both packages' windowed laned entry
    collections, with the telemetry both counted."""
    for o in (tobs, jtm.obs):
        o.set_telemetry(True)
        o.reset()
    steps = _schedule()
    jax_coll, port_coll = _jax_coll(), _port_coll()
    jax_grown = _drive(jax_coll, steps, jfaults.late_event, jfaults.skew_clock)
    jax_counts = dict(jtm.obs.counters_snapshot())
    port_grown = _drive(port_coll, steps, faults.late_event, faults.skew_clock)
    port_counts = dict(tobs.counters_snapshot())
    for o in (tobs, jtm.obs):
        o.set_telemetry(None)
        o.reset()
    return {
        "jax": jax_coll, "port": port_coll, "jax_counts": jax_counts, "port_counts": port_counts, "steps": steps,
        "jax_grown": jax_grown, "port_grown": port_grown,
    }


# ------------------------------------------------------------------- tests

def test_windowed_collection_lanes_follow_jax(collection_run):
    port, ref = collection_run["port"], collection_run["jax"]
    assert port.capacity == ref.capacity == 32  # grown from 8
    for name in ref.keys():
        _same_laned(port[name], ref[name], name)
    _same_tree(port.lane_values(), ref.lane_values(), "lane_values")
    _same_tree(port.compute(), ref.compute(), "compute")
    assert port.window_spec()["lane_clocks"][port.sessions["s03"]] == 5  # skewed one ahead
    assert port["confmat"]._lane_route() == "vmap"


def test_late_events_and_skew_count_like_jax(collection_run):
    names = ("windows.advanced", "windows.late_events", "windows.dropped_late")
    got = {n: collection_run["port_counts"].get(n) for n in names}
    want = {n: collection_run["jax_counts"].get(n) for n in names}
    # admission counts once a session for the suite; advances once a member
    # (five members, four clocks and one skewed lane); two late sessions
    # admitted at each of three clocks, two dropped at each of two
    assert got == want == {"windows.advanced": 25, "windows.late_events": 6, "windows.dropped_late": 4}


def test_laned_windowed_metric_follows_jax():
    """``LanedMetric(WindowedMetric(SumMetric))``: rows looped per lane (no
    row-batched override), every lane's ring and value equal to JAX's over
    rounds, late events, per-lane skew and advances."""
    from torchmetrics_tpu import aggregation as ja

    port = tl.LanedMetric(WindowedMetric(SumMetric(nan_strategy="disable", device=CPU), window=4, lateness=1), capacity=8)
    ref = jtm.LanedMetric(jtm.WindowedMetric(ja.SumMetric(nan_strategy="disable"), window=4, lateness=1), capacity=8, executor=False)
    rng = np.random.RandomState(3)
    for t in range(6):
        items = [(f"u{s}", rng.randint(-9, 9, 3).astype(np.float32)) for s in range(10) if t == 0 or rng.rand() < 0.7]
        for laned in (port, ref):
            laned.update_sessions(items)
        if t >= 1:
            late = rng.randint(-9, 9, 3).astype(np.float32)
            assert faults.late_event(port, "u0", late, age=1) == jfaults.late_event(ref, "u0", late, age=1)
        if t >= 2:
            assert faults.late_event(port, "u1", late, age=2) == jfaults.late_event(ref, "u1", late, age=2) == 0
        if t == 3:
            assert faults.skew_clock(port, 2, 2) == jfaults.skew_clock(ref, 2, 2)
        for laned in (port, ref):
            laned.advance_windows()
        _same_laned(port, ref, f"t{t}")
        _same_tree(port.lane_values(), ref.lane_values(), f"t{t}.values")
        _same_tree(port.compute(), ref.compute(), f"t{t}.compute")
    assert port.window_spec()["lane_clocks"][2] == 8


def test_one_row_folded_count_a_round_and_no_looped_rows(monkeypatch):
    """A windowed laned round of the counting collection makes ONE
    counting dispatch (the row-folded ``bincount``), late rounds too, and
    no member falls to the per-row loop. An advance retires each distinct
    ring once: one ring write per compute group (3), none for a follower."""
    retired = []
    retire = tl.LanedMetric._retire
    monkeypatch.setattr(tl.LanedMetric, "_retire", lambda self, *a: retired.append(1) or retire(self, *a))
    calls = []
    spec = kernels._REGISTRY["bincount"]
    original = spec.reference

    def counting(*args, **kwargs):
        calls.append(args[0].numel())
        return original(*args, **kwargs)

    tobs.set_telemetry(True)
    tobs.reset()
    coll = _port_coll(capacity=32)
    rng = np.random.RandomState(21)
    spec.reference = counting
    try:
        for t in range(3):
            items = [(f"s{s}", _batch(rng)) for s in range(20)]
            assert coll.update_sessions(items) == 1 and len(calls) == 2 * t + 1
            retired.clear()
            coll.advance_windows()
            assert len(retired) == 3
            assert coll.update_sessions(items[:5], window=t) == 1 and len(calls) == 2 * t + 2
        assert coll.update_sessions(items[:5], window=0) == 0 and len(calls) == 6  # dropped: no launch
    finally:
        spec.reference = original
    assert calls[0] == 20 * 6
    retired.clear()
    coll.advance_lane_windows(coll.sessions["s0"])
    assert len(retired) == 3
    for group in coll.collection.compute_groups.values():
        for name in group[1:]:
            assert coll[name]._state["window_head"] is coll[group[0]]._state["window_head"], name
            assert coll[name]._window_clocks().tolist() == coll[group[0]]._window_clocks().tolist(), name
    assert tobs.counters_snapshot().get("lanes.rows_looped", 0) == 0
    tobs.set_telemetry(None)
    tobs.reset()


def test_growth_keeps_every_ring_and_clock(collection_run):
    """Growth mid-window, after the skew and with three windows in every
    old lane's ring: right after the round that grows the lanes 8 -> 32,
    every member's rings, heads and lane counts, the directory and every
    lane clock equal JAX's at the same point (the run then goes on to the
    final comparison of ``test_windowed_collection_lanes_follow_jax``)."""
    port, ref = collection_run["port_grown"], collection_run["jax_grown"]
    assert port["capacity"] == ref["capacity"] == (8, 32)
    assert port["sessions"] == ref["sessions"] and len(port["sessions"]) > 16
    assert port["spec"] == ref["spec"]
    clocks = port["spec"]["lane_clocks"]
    assert clocks[port["sessions"]["s03"]] == 4 and clocks[port["sessions"]["s00"]] == 3
    assert set(port["states"]) == set(ref["states"])
    for name, fields in ref["states"].items():
        assert set(port["states"][name]) == set(fields), name
        for f, r in fields.items():
            p = port["states"][name][f]
            assert p.dtype == r.dtype and p.shape == r.shape, (name, f, p.dtype, r.dtype, p.shape, r.shape)
            np.testing.assert_array_equal(p, r, err_msg=f"grown.{name}.{f}")
        assert port["states"][name]["window_head"].shape == (32,)


def test_kill_and_restore_mid_window(tmp_path, collection_run):
    """A snapshot mid-window restores into a fresh laned collection (rings,
    heads, directory, clocks); both then run the same traffic to equal
    states. The manifest's windows block carries the fleet clock."""
    port = collection_run["port"]
    path = str(tmp_path / "lanes.tmsnap")
    save_state(port, path)
    block = load_manifest(path)["windows"]
    clock = port.window_spec()["clock"]
    assert block == {"window": W, "lateness": 1, "clock": clock, "head": clock % W, "compiled": True}
    twin = _port_coll(capacity=port.capacity)
    restore_state(path, twin)
    for name in port.keys():
        _same_laned(twin[name], port[name], f"restored.{name}")
    rng = np.random.RandomState(8)
    items = [(f"s{s:02d}", _batch(rng)) for s in range(12)]
    for c in (port, twin):
        c.update_sessions(items)
        c.advance_windows()
        c.update_sessions(items[:4], window=port.window_spec()["clock"] - 1)
    for name in port.keys():
        _same_laned(twin[name], port[name], f"continued.{name}")
    # the JAX package's snapshot of its run restores in the port as well
    from torchmetrics_tpu.io import save_state as jsave

    jpath = str(tmp_path / "jax.tmsnap")
    jsave(collection_run["jax"], jpath)
    mine = _port_coll()
    restore_state(jpath, mine)
    for name in port.keys():
        _same_laned(mine[name], collection_run["jax"][name], f"jax_saved.{name}")


def test_row_screen_and_round_rollback_cover_the_ring():
    """Guard on: a row whose update overflows the float ring to inf keeps
    its lane's old rows (the screen), as in JAX; an attributed dispatch
    fault rolls the round's lanes back to the pre-round ring and heads held
    by reference, and the round re-runs without the culprit."""
    from torchmetrics_tpu import aggregation as ja

    port = tl.LanedMetric(WindowedMetric(MeanMetric(nan_strategy="disable", device=CPU), window=3), capacity=8, on_lane_fault="quarantine")
    ref = jtm.LanedMetric(jtm.WindowedMetric(ja.MeanMetric(nan_strategy="disable"), window=3), capacity=8, executor=False, on_lane_fault="quarantine")
    big = np.full(2, 3e38, np.float32)
    ones = np.ones(2, np.float32)
    for laned in (port, ref):
        laned.update_sessions([("a", ones), ("b", big)])
        laned.advance_windows()
        laned.update_sessions([("a", ones), ("b", big)])
        laned.update_sessions([("a", ones), ("b", big)])  # b's mean_value overflows: screened
    _same_laned(port, ref, "screened")
    # every update of b overflows its sum: each one screened, the ring kept finite
    assert int(port.lane_health[port.sessions["b"]]) == int(np.asarray(ref.lane_health)[ref.sessions["b"]]) == 3
    assert bool(torch.isfinite(port.mean_value).all()) and int(port.lane_updates[port.sessions["b"]]) == 0
    # rollback: the baseline the guard holds keeps its value across the round
    baseline = port._fetch_round_baseline([0, 1])
    held = {f: v.clone() for f, v in baseline.items()}
    with faults.fail_lane_dispatch(port, "a", fail_n=1):
        port.update_sessions([("a", ones), ("b", ones)])
    with jfaults.fail_lane_dispatch(ref, "a", fail_n=1):
        ref.update_sessions([("a", ones), ("b", ones)])
    for f, v in baseline.items():
        assert torch.equal(v, held[f]), f
    _same_laned(port, ref, "rolled_back")
    port.advance_windows()
    for f, v in baseline.items():
        assert torch.equal(v, held[f]), f


def test_lane_lifecycle_resets_the_clock_mirror():
    """Reset, reset_session, evict and remap drop the host clock mirror,
    which re-reads the heads: a reset lane's clock is 0 again (as in JAX)."""
    from torchmetrics_tpu import aggregation as ja

    port = tl.LanedMetric(WindowedMetric(SumMetric(nan_strategy="disable", device=CPU), window=3), capacity=8)
    ref = jtm.LanedMetric(jtm.WindowedMetric(ja.SumMetric(nan_strategy="disable"), window=3), capacity=8, executor=False)
    for laned in (port, ref):
        laned.update_sessions([("a", np.ones(2, np.float32)), ("b", np.ones(2, np.float32)), ("c", np.ones(2, np.float32))])
        laned.advance_windows(2)
        laned.reset_session("b")
        laned.evict("c")
    _same_laned(port, ref, "lifecycle")
    assert port.window_spec()["lane_clocks"][:3] == [2, 0, 0]
    for laned in (port, ref):
        laned.remap_capacity(16)
    _same_laned(port, ref, "remapped")
    port.reset()
    assert port.window_spec()["clock"] == 0


def test_windowed_operations_need_a_windowed_inner():
    plain = tl.LanedMetric(SumMetric(device=CPU))
    for call in (
        lambda: plain.update_sessions([("a", np.ones(1, np.float32))], window=0),
        lambda: plain.advance_windows(),
        lambda: plain.advance_lane_windows(0),
        lambda: plain.window_spec(),
    ):
        with pytest.raises(TorchMetricsUserError, match="windowed inner metric"):
            call()
    coll = tl.LanedCollection({"s": SumMetric(device=CPU)}, capacity=8)
    with pytest.raises(TorchMetricsUserError, match="windowed member"):
        coll.advance_windows()
    from torchmetrics_tpu_torch.aggregation import CatMetric

    with pytest.warns(UserWarning):
        eager = WindowedMetric(CatMetric(device=CPU), window=3)
    with pytest.raises(TorchMetricsUserError, match="compiled ring"):
        tl.LanedMetric(eager)
    laned = _port_coll()
    with pytest.raises(TorchMetricsUserError, match="ahead of lane clock"):
        laned.update_sessions([("a", _batch(np.random.RandomState(0)))], window=1)
