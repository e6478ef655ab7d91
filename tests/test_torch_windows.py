"""Streaming windows of the PyTorch port (``torchmetrics_tpu_torch/windows.py``)
held to the JAX package's ``WindowedMetric``/``WindowedCollection``
(``executor=False``) on the same numpy inputs and the same update, advance
and late-event schedule.

Tolerances: counts, ``window_head`` and every integer state bit for bit
(dtypes too); float values within 1e-6 (the ring values of the aggregation
families are integer-valued floats, so their states compare bit for bit as
well). Also here: the sync's window folds (``parallel/sync.py``), the eager
per-window path, the watermark's counters and breadcrumb, snapshots the JAX
package saved restored in the port, the window-aligned asynchronous read, a
two-rank gloo sync, ``Metric.set_dtype``, and the out-of-place ring write
(a compute-group follower and a pending read keep their values).
"""
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from helpers.torch_window_ranks import LastPeak, rank_windowed
from helpers.torch_world import run_world
from torchmetrics_tpu_torch import obs as tobs
from torchmetrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from torchmetrics_tpu_torch.classification import (
    BinaryAUROC,
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
)
from torchmetrics_tpu_torch.io.checkpoint import load_manifest, restore_state, save_state
from torchmetrics_tpu_torch.ops import async_read, kernels
from torchmetrics_tpu_torch.parallel.sync import fold_window_slots, live_window_mask
from torchmetrics_tpu_torch.testing import faults
from torchmetrics_tpu_torch.utils.exceptions import StateCorruptionError, TorchMetricsUserError
from torchmetrics_tpu_torch.windows import WindowedCollection, WindowedMetric

CPU = "cpu"
C = 5
ATOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(port, ref, name=""):
    """Integers bit for bit with the same dtype; floats within ATOL."""
    port, ref = _np(port), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    if ref.dtype.kind in "biu":
        assert port.dtype == ref.dtype, (name, port.dtype, ref.dtype)
        np.testing.assert_array_equal(port, ref, err_msg=name)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=0, atol=ATOL, err_msg=name)


def _same_tree(port, ref, name=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), (name, sorted(port), sorted(ref))
        for k in ref:
            _same_tree(port[k], ref[k], f"{name}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), name
        for i, (a, b) in enumerate(zip(port, ref)):
            _same_tree(a, b, f"{name}[{i}]")
    else:
        _same(port, ref, name)


def _same_states(port, ref, name=""):
    """Every declared state (ring fields and ``window_head``) bit for bit."""
    assert set(port._defaults) == set(ref._defaults), name
    for f in ref._defaults:
        p, r = port._state[f], ref._state[f]
        if isinstance(r, list):
            _same_tree(list(p), list(r), f"{name}.{f}")
        else:
            p, r = _np(p), np.asarray(r)
            assert p.dtype == r.dtype and p.shape == r.shape, (name, f, p.dtype, r.dtype, p.shape, r.shape)
            np.testing.assert_array_equal(p, r, err_msg=f"{name}.{f}")


# ------------------------------------------------------------- the metrics

def _jax_last_peak():
    import jax.numpy as jnp

    class JLastPeak(jtm.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("peak", jnp.asarray(0.0), dist_reduce_fx="max")

        def update(self, x):
            self.peak = x.max()

        def compute(self):
            return self.peak

    return JLastPeak(executor=False)


def _families(name):
    """(port inner, JAX inner) of one reduction family."""
    from torchmetrics_tpu import aggregation as ja

    if name == "last_peak":
        return LastPeak(device=CPU), _jax_last_peak()
    port_cls = {"sum": SumMetric, "mean": MeanMetric, "max": MaxMetric, "min": MinMetric}[name]
    jax_cls = {"sum": ja.SumMetric, "mean": ja.MeanMetric, "max": ja.MaxMetric, "min": ja.MinMetric}[name]
    return port_cls(nan_strategy="disable", device=CPU), jax_cls(nan_strategy="disable", executor=False)


def _schedule(rng, steps=14):
    """(op, window, batch) steps: on-time updates, advances, late batches one
    and two windows behind (lateness 1 admits the first, drops the second)."""
    ops, clock = [], 0
    for i in range(steps):
        r = rng.rand()
        batch = rng.randint(-20, 20, 4).astype(np.float32)
        if r < 0.5:
            ops.append(("update", None, batch))
        elif r < 0.75:
            ops.append(("advance", None, None))
            clock += 1
        elif clock >= 1:
            ops.append(("late", clock - 1 - int(rng.rand() < 0.3), batch))
        else:
            ops.append(("update", None, batch))
        if i % 4 == 3:
            ops.append(("check", None, None))
    ops.append(("check", None, None))
    return ops


def _apply(win, op, k, batch, to):
    if op == "update":
        win.update(to(batch))
    elif op == "advance":
        win.advance()
    elif op == "late" and k >= 0:
        return win.update_window(k, to(batch))
    return None


def _check_reads(port, jax_win, name):
    _same_states(port, jax_win, name)
    assert port.clock == jax_win.clock and port.window_spec() == jax_win.window_spec()
    if port.update_count:
        _same_tree(port.compute(), jax_win.compute(), f"{name}.compute")
    lo, hi = port.live_windows
    for k in range(lo, hi + 1):
        _same_tree(port.compute_window(k), jax_win.compute_window(k), f"{name}.window{k}")


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("head", [0, 1, 2, 3, 4, 7, 11])
@pytest.mark.parametrize("fx", ["sum", "mean", "max", "min"])
def test_window_folds_match_jax(head, fx):
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel.sync import fold_window_slots as jfold
    from torchmetrics_tpu.parallel.sync import live_window_mask as jlive

    w = 4
    _same(live_window_mask(head, w), jlive(jnp.asarray(head), w), "mask")
    _same(live_window_mask(torch.tensor(head, dtype=torch.int32), w), jlive(jnp.asarray(head), w), "mask")
    rng = np.random.RandomState(head)
    for dtype in (np.int32, np.float32):
        value = rng.randint(-9, 9, (w, 3)).astype(dtype)
        got = fold_window_slots(torch.from_numpy(value), fx, live_window_mask(head, w))
        _same(got, jfold(jnp.asarray(value), fx, jlive(jnp.asarray(head), w)), f"{fx}.{dtype.__name__}")
    # laned: one clock per lane, the window axis second
    heads = np.asarray([0, head, 2 * head + 1], np.int32)
    value = rng.randint(-9, 9, (3, w, 2)).astype(np.int32)
    got = fold_window_slots(torch.from_numpy(value), fx, live_window_mask(torch.from_numpy(heads), w))
    want = np.stack([np.asarray(jfold(jnp.asarray(value[i]), fx, jlive(jnp.asarray(int(h)), w))) for i, h in enumerate(heads)])
    _same(got, want, "laned")


def test_folds_refuse_the_eager_families():
    for fx in ("cat", None, lambda s: s.sum(0)):
        with pytest.raises(ValueError, match="undefined"):
            fold_window_slots(torch.zeros(3), fx, live_window_mask(0, 3))


@pytest.mark.parametrize("family", ["sum", "mean", "max", "min", "last_peak"])
def test_reduction_families_follow_jax(family):
    """The same schedule through both packages, W=4, lateness 1: every state
    bit for bit (``window_head`` int32 too), the sliding value and every
    live window's value; a ``max`` ring read before it wraps."""
    port_inner, jax_inner = _families(family)
    import jax.numpy as jnp

    port = WindowedMetric(port_inner, window=4, lateness=1)
    jwin = jtm.WindowedMetric(jax_inner, window=4, lateness=1, executor=False)
    rng = np.random.RandomState({"sum": 1, "mean": 2, "max": 3, "min": 4, "last_peak": 5}[family])
    first = rng.randint(-20, -1, 4).astype(np.float32)  # negative: a 0 default must not win
    port.update(torch.from_numpy(first))
    jwin.update(jnp.asarray(first))
    _check_reads(port, jwin, f"{family}.before_wrap")
    for op, k, batch in _schedule(rng):
        if op == "check":
            _check_reads(port, jwin, family)
            continue
        landed = _apply(port, op, k, batch, torch.from_numpy)
        assert landed == _apply(jwin, op, k, batch, jnp.asarray), (family, op, k)
    assert port.window_head.dtype == torch.int32
    _check_reads(port, jwin, family)


def _entry_members(device=CPU):
    d = dict(validate_args=False, device=device)
    return {
        "accuracy": MulticlassAccuracy(num_classes=C, average="micro", **d),
        "f1": MulticlassF1Score(num_classes=C, **d),
        "precision": MulticlassPrecision(num_classes=C, **d),
        "recall": MulticlassRecall(num_classes=C, **d),
        "confmat": MulticlassConfusionMatrix(num_classes=C, **d),
    }


def _jax_entry_members():
    from torchmetrics_tpu import classification as jc

    d = dict(validate_args=False, executor=False)
    return {
        "accuracy": jc.MulticlassAccuracy(num_classes=C, average="micro", **d),
        "f1": jc.MulticlassF1Score(num_classes=C, **d),
        "precision": jc.MulticlassPrecision(num_classes=C, **d),
        "recall": jc.MulticlassRecall(num_classes=C, **d),
        "confmat": jc.MulticlassConfusionMatrix(num_classes=C, **d),
    }


def _jax_windowed_entry(window, lateness):
    """The JAX package's windowed entry collection without compute groups:
    its advance donates a leader's ring that the group's followers still
    hold (the next member's advance then reads a deleted buffer), so the
    reference runs every member on its own ring."""
    jwc = jtm.MetricCollection(_jax_entry_members()).windowed(window, lateness=lateness)
    jwc.collection = jtm.MetricCollection(dict(jwc.items()), compute_groups=False)
    return jwc


def _entry_batch(rng, n=12):
    return rng.randn(n, C).astype(np.float32), rng.randint(0, C, n)


def test_entry_collection_and_binned_auroc_follow_jax():
    """The entry collection windowed (W=3, lateness 1) and a windowed binned
    binary AUROC: states bit for bit, ``compute`` and every live
    ``compute_window`` within 1e-6, over updates, advances and late batches;
    one counting launch a landed update, none for a dropped batch."""
    import jax.numpy as jnp

    from torchmetrics_tpu.classification import BinaryAUROC as JAUROC

    wc = ttm.MetricCollection(_entry_members(), device=CPU).windowed(3, lateness=1)
    jwc = _jax_windowed_entry(3, 1)
    auroc = BinaryAUROC(thresholds=10, validate_args=False, device=CPU).windowed(3, lateness=1)
    jauroc = JAUROC(thresholds=10, validate_args=False, executor=False).windowed(3, lateness=1, executor=False)
    rng = np.random.RandomState(7)
    for step in range(6):
        preds, target = _entry_batch(rng)
        probs, labels = rng.rand(12).astype(np.float32), rng.randint(0, 2, 12)
        if step % 3 == 2:
            k = wc.clock - 1 - (step == 5)  # step 2 one window late (admitted), step 5 two (dropped)
            landed = wc.update_window(k, torch.from_numpy(preds), torch.from_numpy(target))
            assert landed == jwc.update_window(k, jnp.asarray(preds), jnp.asarray(target))
            assert auroc.update_window(k, torch.from_numpy(probs), torch.from_numpy(labels)) == landed
            jauroc.update_window(k, jnp.asarray(probs), jnp.asarray(labels))
        else:
            wc.update(torch.from_numpy(preds), torch.from_numpy(target))
            jwc.update(jnp.asarray(preds), jnp.asarray(target))
            auroc.update(torch.from_numpy(probs), torch.from_numpy(labels))
            jauroc.update(jnp.asarray(probs), jnp.asarray(labels))
        if step % 2 == 1 or step == 4:  # the ring of 3 wraps at clocks 3 and 4
            assert wc.advance() == jwc.advance()
            auroc.advance(), jauroc.advance()
        for name in wc.keys():
            _same_states(wc[name], jwc[name], f"step{step}.{name}")
        _same_states(auroc, jauroc, f"step{step}.auroc")
        _same_tree(wc.compute(), jwc.compute(), f"step{step}.compute")
        _same_tree(auroc.compute(), jauroc.compute(), f"step{step}.auroc")
        lo, hi = wc[next(iter(wc.keys()))].live_windows
        for k in range(lo, hi + 1):
            _same_tree(wc.compute_window(k), jwc.compute_window(k), f"step{step}.window{k}")
            _same_tree(auroc.compute_window(k), jauroc.compute_window(k), f"step{step}.auroc{k}")
    assert wc.window_spec() == jwc.window_spec() and wc.clock == 4
    assert sorted(map(sorted, wc.collection.compute_groups.values())) == [
        ["accuracy"], ["confmat"], ["f1", "precision", "recall"]
    ]


def test_windowed_updates_share_one_counting_launch():
    """An on-time and an admitted late batch of the windowed entry
    collection each make ONE ``bincount`` dispatch (the members' groups
    share it through the fusion scope), as the unwindowed collection does;
    a dropped batch makes none."""
    calls = []
    spec = kernels._REGISTRY["bincount"]
    original = spec.reference

    def counting(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    wc = ttm.MetricCollection(_entry_members(), device=CPU).windowed(4, lateness=1)
    plain = ttm.MetricCollection(_entry_members(), device=CPU)
    rng = np.random.RandomState(3)
    spec.reference = counting
    try:
        for i in range(3):
            batch = tuple(torch.from_numpy(a) for a in _entry_batch(rng))
            n = len(calls)
            wc.update(*batch)
            windowed = len(calls) - n
            plain.update(*batch)
            assert windowed == len(calls) - n - windowed == 1, i
        wc.advance(2)
        n = len(calls)
        assert wc.update_window(wc.clock - 1, *batch) and len(calls) - n == 1
        assert not wc.update_window(wc.clock - 2, *batch) and len(calls) - n == 1
    finally:
        spec.reference = original


def test_eager_path_on_a_cat_metric_follows_jax():
    import jax.numpy as jnp

    from torchmetrics_tpu.aggregation import CatMetric as JCat

    with pytest.warns(UserWarning, match="eager per-window"):
        port = WindowedMetric(CatMetric(nan_strategy="disable", device=CPU), window=3, lateness=1)
    with pytest.warns(UserWarning, match="eager per-window"):
        jwin = jtm.WindowedMetric(JCat(nan_strategy="disable", executor=False), window=3, lateness=1, executor=False)
    assert port.window_spec() == jwin.window_spec() and not port.window_spec()["compiled"]
    rng = np.random.RandomState(11)
    for op, k, batch in _schedule(rng, steps=16):
        if op == "check":
            if port.update_count:
                _same(port.compute(), jwin.compute(), "cat.compute")
            lo, hi = port.live_windows
            for w in range(lo, hi + 1):
                if jwin.__dict__["_window_counts"][w % 3]:
                    _same(port.compute_window(w), jwin.compute_window(w), f"cat.window{w}")
            continue
        assert _apply(port, op, k, batch, torch.from_numpy) == _apply(jwin, op, k, batch, jnp.asarray)
    assert port.__dict__["_window_counts"] == jwin.__dict__["_window_counts"]
    restored = WindowedMetric(CatMetric(nan_strategy="disable", device=CPU), window=3, lateness=1)
    restored.load_state(port.state())
    assert restored.clock == port.clock
    _same(restored.compute(), port.compute(), "cat.restored")


@pytest.fixture
def fresh_obs():
    for o in (tobs, jtm.obs):
        o.set_telemetry(True)
        o.reset()
        o.reset_flight()
    yield
    for o in (tobs, jtm.obs):
        o.set_telemetry(None)
        o.reset()
        o.reset_flight()


def test_watermark_boundary_counters_and_breadcrumb(fresh_obs):
    """Admit at the lateness bound, drop past it (and past the ring), raise
    for a future window; the ``windows.*`` counters equal the JAX package's,
    a drop leaves a ``window_late_drop`` breadcrumb with the windows flight
    blob, and a collection counts per member as the JAX package does."""
    import jax.numpy as jnp

    from torchmetrics_tpu import aggregation as ja

    port = WindowedMetric(SumMetric(nan_strategy="disable", device=CPU), window=4, lateness=2)
    jwin = jtm.WindowedMetric(ja.SumMetric(nan_strategy="disable", executor=False), window=4, lateness=2, executor=False)
    for w in (port, jwin):
        w.advance(5)
    x = np.ones(2, np.float32)
    for k, want in ((5, True), (4, True), (3, True), (2, False), (0, False)):
        assert port.update_window(k, torch.from_numpy(x)) is want
        assert jwin.update_window(k, jnp.asarray(x)) is want
    for w, arr in ((port, torch.from_numpy(x)), (jwin, jnp.asarray(x))):
        with pytest.raises(Exception, match="ahead of the clock"):
            w.update_window(6, arr)
    _same_states(port, jwin, "watermark")
    # the collection counts each member, as the JAX package's walk does
    wc = WindowedCollection({"s": SumMetric(nan_strategy="disable", device=CPU), "m": MaxMetric(nan_strategy="disable", device=CPU)}, window=3, lateness=1)
    jwc = jtm.WindowedCollection(
        {"s": ja.SumMetric(nan_strategy="disable", executor=False), "m": ja.MaxMetric(nan_strategy="disable", executor=False)},
        window=3, lateness=1, executor=False,
    )
    for c in (wc, jwc):
        c.advance(3)
    assert wc.update_window(2, torch.from_numpy(x)) == jwc.update_window(2, jnp.asarray(x)) is True
    assert wc.update_window(1, torch.from_numpy(x)) == jwc.update_window(1, jnp.asarray(x)) is False
    names = ("windows.advanced", "windows.late_events", "windows.dropped_late")
    got, want = tobs.counters_snapshot(), jtm.obs.counters_snapshot()
    assert {n: got.get(n) for n in names} == {n: want.get(n) for n in names} == {
        "windows.advanced": 11, "windows.late_events": 4, "windows.dropped_late": 4
    }
    crumbs = [c for c in tobs.dump_diagnostics()["breadcrumbs"] if c["kind"] == "window_late_drop"]
    assert len(crumbs) == 4 and crumbs[0]["data"]["window"] == 2 and crumbs[0]["data"]["age"] == 3
    assert "flight" in crumbs[0]["data"]
    hist = tobs.histograms_snapshot()
    assert hist["windows.advance_us"]["count"] == 11 and hist["windows.lateness_us"]["count"] >= 2


def test_jax_saved_snapshot_restores_in_the_port(tmp_path):
    """A snapshot the JAX package wrote of a windowed metric and of a
    windowed collection restores in the port with its ring and clock; the
    manifest's ``windows`` block names W, clock and head; a ring of another
    size is refused."""
    import jax.numpy as jnp

    from torchmetrics_tpu.io import save_state as jsave

    jwin = _jax_windowed_entry(4, 1)
    rng = np.random.RandomState(5)
    for i in range(7):
        preds, target = _entry_batch(rng)
        jwin.update(jnp.asarray(preds), jnp.asarray(target))
        if i % 2:
            jwin.advance()
    path = str(tmp_path / "win.tmsnap")
    jsave(jwin.collection, path)
    port = ttm.MetricCollection(_entry_members(), device=CPU).windowed(4, lateness=1)
    restore_state(path, port.collection)
    assert port.clock == jwin.clock == 3
    for name in port.keys():
        _same_states(port[name], jwin[name], f"restored.{name}")
    _same_tree(port.compute(), jwin.compute(), "restored.compute")
    # one metric, and the manifest's ring block in both directions
    single = jtm.MetricCollection(_jax_entry_members())["confmat"].windowed(4, lateness=1, executor=False)
    preds, target = _entry_batch(rng)
    single.update(jnp.asarray(preds), jnp.asarray(target))
    single.advance(5)
    jsave(single, str(tmp_path / "one.tmsnap"))
    mine = MulticlassConfusionMatrix(num_classes=C, validate_args=False, device=CPU).windowed(4, lateness=1)
    restore_state(str(tmp_path / "one.tmsnap"), mine)
    _same_states(mine, single, "restored.single")
    assert mine.clock == 5 and mine.head_slot == 1
    save_state(mine, str(tmp_path / "mine.tmsnap"))
    block = load_manifest(str(tmp_path / "mine.tmsnap"))["windows"]
    assert block == {"window": 4, "lateness": 1, "clock": 5, "head": 1, "compiled": True}
    # the port's own round trip of a windowed collection, restored in place
    save_state(port, str(tmp_path / "coll.tmsnap"))
    assert load_manifest(str(tmp_path / "coll.tmsnap"))["windows"] == {"window": 4, "lateness": 1, "clock": 3, "head": 3}
    twin = ttm.MetricCollection(_entry_members(), device=CPU).windowed(4, lateness=1)
    restore_state(str(tmp_path / "coll.tmsnap"), twin)
    assert twin.device == port.device and twin.clock == 3
    for name in port.keys():
        _same_states(twin[name], jwin[name], f"round_trip.{name}")
    wrong = MulticlassConfusionMatrix(num_classes=C, validate_args=False, device=CPU).windowed(8)
    with pytest.raises(StateCorruptionError, match="4-slot ring"):
        wrong.load_state(mine.state())
    with pytest.raises(StateCorruptionError, match="window meta"):
        wrong.load_state({**mine.state(), "_window_meta": np.asarray([255, 0], np.uint8)})


def test_async_read_resolves_to_its_close():
    """A read submitted at window k's close resolves bit-equal to the
    synchronous compute at that close, after later updates and advances
    ran before the worker got to it; the pending read keeps its snapshot
    (the ring is never written in place)."""
    wc = ttm.MetricCollection(_entry_members(), device=CPU).windowed(3, lateness=1)
    rng = np.random.RandomState(9)
    for _ in range(4):
        wc.update(*(torch.from_numpy(a) for a in _entry_batch(rng)))
    wc.advance()
    wc.update(*(torch.from_numpy(a) for a in _entry_batch(rng)))
    at_close = wc.compute()
    with faults.pause_async_reads(max_s=30.0) as release:
        future = wc.compute_async()
        for _ in range(4):
            wc.update(*(torch.from_numpy(a) for a in _entry_batch(rng)))
            wc.update_window(wc.clock - 1, *(torch.from_numpy(a) for a in _entry_batch(rng))) if wc.clock else None
            wc.advance()
        release.set()
        got = future.result(timeout=30.0)
    assert async_read.drain_pipeline(timeout=30.0)
    for k, v in at_close.items():
        assert torch.equal(got[k], v), k
    assert not all(torch.equal(wc.compute()[k], v) for k, v in at_close.items())


def test_follower_keeps_its_leader_across_updates_and_advances(monkeypatch):
    """Compute-group followers share their leader's ring: after windowed
    updates, late batches and advances every follower holds tensors equal
    to (and, after each collection call, the same as) its leader's and
    keeps its clock, and an advance writes each distinct ring once (the
    three groups' 4 + 4 + 1 fields, not every member's)."""
    from torchmetrics_tpu_torch import windows as twindows

    writes = []
    with_row = twindows._with_row
    monkeypatch.setattr(twindows, "_with_row", lambda *a: writes.append(1) or with_row(*a))
    wc = ttm.MetricCollection(_entry_members(), device=CPU).windowed(3, lateness=1)
    rng = np.random.RandomState(12)
    for i in range(6):
        wc.update(*(torch.from_numpy(a) for a in _entry_batch(rng)))
        if i % 2:
            writes.clear()
            wc.advance()
            assert len(writes) == 9
            wc.update_window(wc.clock - 1, *(torch.from_numpy(a) for a in _entry_batch(rng)))
        for group in wc.collection.compute_groups.values():
            leader = wc[group[0]]
            for name in group[1:]:
                assert wc[name].clock == leader.clock == wc.clock, name
                for f in leader._defaults:
                    assert wc[name]._state[f] is leader._state[f], (name, f)


def test_set_dtype_follows_jax():
    import jax.numpy as jnp

    from torchmetrics_tpu import aggregation as ja

    port = MeanMetric(nan_strategy="disable", device=CPU)
    ref = ja.MeanMetric(nan_strategy="disable", executor=False)
    x = np.asarray([1.5, 2.25, 3.0], np.float32)
    port.update(torch.from_numpy(x))
    ref.update(jnp.asarray(x))
    before = dict(port._state)
    assert port.set_dtype(torch.float16) is port
    ref.set_dtype(jnp.float16)
    for f in ref._defaults:
        assert _np(port._state[f]).dtype == np.asarray(ref._state[f]).dtype, f
        assert _np(port._defaults[f]).dtype == np.asarray(ref._defaults[f]).dtype, f
        assert before[f].dtype == torch.float32  # a new tensor: nothing cast in place
    _same(port.compute(), ref.compute(), "set_dtype")
    counts = MulticlassConfusionMatrix(num_classes=C, device=CPU).set_dtype(torch.float16)
    assert counts.confmat.dtype == torch.int32


def test_reset_pickle_repr_and_exports():
    import pickle

    win = SumMetric(device=CPU).windowed(3, lateness=1)
    win.update(torch.ones(2))
    win.advance(2)
    twin = pickle.loads(pickle.dumps(win))
    assert twin.clock == 2 and float(twin.compute()) == 2.0 and twin.window_spec() == win.window_spec()
    assert repr(win) == "WindowedMetric(SumMetric, window=3, clock=2, lateness=1)"
    win.reset()
    assert win.clock == 0 and int(win.window_head) == 0 and float(win.window_head.sum()) == 0.0
    from torchmetrics_tpu import windows as jwindows
    from torchmetrics_tpu_torch import windows as twindows

    assert twindows.__all__ == jwindows.__all__
    for name in ("WindowedMetric", "WindowedCollection"):
        assert name in ttm.__all__ and name in jtm.__all__
    assert twindows.WINDOW_ELIGIBLE_REDUCTIONS == jwindows.WINDOW_ELIGIBLE_REDUCTIONS
    assert twindows.DEFAULT_WINDOW == jwindows.DEFAULT_WINDOW
    for bad in (dict(window=0), dict(window=3, lateness=3), dict(window=3, lateness=-1)):
        with pytest.raises(ValueError):
            WindowedMetric(SumMetric(device=CPU), **bad)
    with pytest.raises(ValueError, match="another WindowedMetric"):
        WindowedMetric(win)
    with pytest.raises(ValueError, match="then lane it"):
        WindowedMetric(SumMetric(device=CPU).laned())
    with pytest.raises(TorchMetricsUserError, match="not live"):
        win.compute_window(1)


def test_two_rank_gloo_sync_follows_jax(tmp_path):
    """Two gloo ranks sync their windowed states (rings by their family,
    ``window_head`` by ``max``); each rank's synced value equals the JAX
    package's ``sync_states`` in ``shard_map`` of the same rank states
    followed by its windowed compute."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from torchmetrics_tpu import aggregation as ja
    from torchmetrics_tpu.parallel.sync import shard_map_compat, sync_states

    results = run_world(2, tmp_path / "world", rank_windowed)
    for name, jinner in (("sum", ja.SumMetric(nan_strategy="disable", executor=False)), ("peak", _jax_last_peak())):
        jwin = jtm.WindowedMetric(jinner, window=3, lateness=1, executor=False)
        fields = list(jwin._defaults)
        per_rank = [r[name]["local"] for r in results]
        stacked = [jnp.asarray(np.stack([s[f] for s in per_rank])) for f in fields]

        def body(*xs):
            return sync_states({f: x[0] for f, x in zip(fields, xs)}, dict(jwin._reductions), "batch")

        mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))
        synced = shard_map_compat(body, mesh, tuple(P("batch") for _ in fields), P(), check_vma=False)(*stacked)
        want = jwin.functional_compute(synced)
        for r in results:
            _same(r[name]["synced"], want, f"{name}.synced")
        assert int(np.asarray(synced["window_head"])) == 3
