"""Captured dispatch of windowed metrics and collections
(``torchmetrics_tpu_torch/windows.py`` on ``ops/executor.py``) held to the
JAX package's ``WindowedMetric``/``WindowedCollection`` with ``executor=True``
and ``executor=False``, on the same numpy batches and schedule.

On the CPU the port's executor runs its bookkeeping with the body called in
place of a replay (keys, slots, escapes, copies, stats), so everything here
but the graphs themselves is checked: the slot read on the device
(``window_head % W``), one key a call shape whatever the slot, a late
window as a 0-d tensor input, no padding, and the escapes of the advance,
the reads and the restores.

Tolerances: integer states and ``window_head`` bit for bit (dtypes too);
float states and values within 1e-6 of the JAX package; the port's
``executor=True`` against its ``executor=False`` bit for bit. The JAX
collections run without compute groups: the JAX advance frees a ring that a
group's followers still hold (ROADMAP Queue C).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu_torch.aggregation import SumMetric
from torchmetrics_tpu_torch.ops import async_read, compile_cache
from torchmetrics_tpu_torch.ops.executor import executor_stats
from torchmetrics_tpu_torch.windows import WindowedCollection, WindowedMetric

CPU = "cpu"
C = 5
W = 3
ATOL = 1e-6
#: the executor counters held equal to the JAX package's
STAT_KEYS = ("compiles", "cache_hits", "padded_calls", "skipped_calls")


def _jtm():
    import torchmetrics_tpu as jtm

    return jtm


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


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
        assert sorted(port) == sorted(ref), name
        for k in ref:
            _same_tree(port[k], ref[k], f"{name}.{k}")
    else:
        _same(port, ref, name)


def _bit_equal_tree(a, b, name=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), name
        for k in b:
            _bit_equal_tree(a[k], b[k], f"{name}.{k}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), name


# ------------------------------------------------------------- the subjects

def _single(pkg, kind, executor):
    """A windowed metric of ``kind`` (W = 3, lateness 1) in ``pkg``."""
    dev = {"device": CPU} if pkg is ttm else {}
    if kind == "sum":
        inner = pkg.SumMetric(nan_strategy="disable", **dev)
    elif kind == "max":
        inner = pkg.MaxMetric(nan_strategy="disable", **dev)
    else:
        inner = pkg.classification.BinaryAUROC(thresholds=10, validate_args=False, **dev)
    return pkg.windows.WindowedMetric(inner, window=W, lateness=1, executor=executor, **dev)


def _entry_members(pkg):
    dev = {"device": CPU} if pkg is ttm else {}
    cls = pkg.classification
    d = dict(validate_args=False, **dev)
    return {
        "accuracy": cls.MulticlassAccuracy(num_classes=C, average="micro", **d),
        "f1": cls.MulticlassF1Score(num_classes=C, **d),
        "precision": cls.MulticlassPrecision(num_classes=C, **d),
        "recall": cls.MulticlassRecall(num_classes=C, **d),
        "confmat": cls.MulticlassConfusionMatrix(num_classes=C, **d),
    }


def _entry(pkg, executor):
    """The windowed entry collection; the JAX one without compute groups."""
    if pkg is ttm:
        return WindowedCollection(_entry_members(ttm), window=W, lateness=1, executor=executor)
    jtm = pkg
    wc = jtm.windows.WindowedCollection(_entry_members(jtm), window=W, lateness=1, executor=executor)
    wc.collection = jtm.MetricCollection(dict(wc.items()), compute_groups=False, executor=executor)
    return wc


def _batch(kind, rng, n):
    if kind in ("sum", "max"):
        return (rng.randn(n).astype(np.float32),)
    if kind == "auroc":
        return rng.rand(n).astype(np.float32), rng.randint(0, 2, n).astype(np.int32)
    return rng.randn(n, C).astype(np.float32), rng.randint(0, C, n).astype(np.int32)


def _to_port(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in batch)


def _to_jax(batch):
    import jax.numpy as jnp

    return tuple(jnp.asarray(x) for x in batch)


#: ragged on-time sizes, late batches one window behind (admitted) and two
#: (dropped), ``advance(1)`` and ``advance(2)``, reads, an asynchronous read,
#: a state round trip and a reset; the sequence wraps the W = 3 ring twice
SCHEDULE = (
    ("update", 5), ("update", 3), ("read",), ("advance", 1), ("update", 5), ("late", 1, 4), ("update", 5),
    ("advance", 2), ("read",), ("late", 1, 3), ("late", 2, 3), ("update", 3), ("async",), ("update", 5),
    ("advance", 1), ("roundtrip",), ("update", 5), ("late", 1, 4), ("read",), ("advance", 1), ("update", 3),
    ("reset",), ("update", 5), ("advance", 1), ("update", 5), ("read",),
)


def _run(pkg, kind, executor, to, schedule=SCHEDULE):
    """Drive one subject through ``schedule``; returns per step its states
    (every member's declared fields), clock and read values, and the
    subject."""
    obj = _entry(pkg, executor) if kind == "entry" else _single(pkg, kind, executor)
    members = dict(obj.items()) if kind == "entry" else {"m": obj}
    rng = np.random.RandomState({"sum": 1, "max": 2, "auroc": 3, "entry": 4}[kind])
    steps, pending = [], None
    for op in schedule:
        out = {"op": op}
        if op[0] == "update":
            obj.update(*to(_batch(kind, rng, op[1])))
        elif op[0] == "late":
            out["landed"] = obj.update_window(obj.clock - op[1], *to(_batch(kind, rng, op[2])))
        elif op[0] == "advance":
            out["clock"] = obj.advance(op[1])
        elif op[0] == "read":
            out["value"] = obj.compute()
            lo, hi = max(0, obj.clock - W + 1), obj.clock
            out["windows"] = {k: obj.compute_window(k) for k in range(lo, hi + 1)}
        elif op[0] == "async":
            pending = (obj.compute_async(), obj.compute())
        elif op[0] == "roundtrip":
            obj.load_state(obj.state())
        elif op[0] == "reset":
            obj.reset()
        if pending is not None and op[0] != "async":
            future, want = pending
            out["async"] = (future.result(timeout=60), want)
            pending = None
        out["states"] = {name: {f: _np(m._state[f]) for f in m._defaults} for name, m in members.items()}
        out["clock_now"] = obj.clock
        steps.append(out)
    return steps, obj


def _jax_run(kind, executor, cache={}):
    """The JAX package's run of ``kind`` (shared across tests: its compiles
    are most of this file's time)."""
    key = (kind, executor)
    if key not in cache:
        steps, obj = _run(_jtm(), kind, executor, _to_jax)
        stats = None
        if kind != "entry" and executor:
            stats = {k: obj.executor_status["stats"][k] for k in STAT_KEYS}
        cache[key] = (steps, stats)
    return cache[key]


@pytest.fixture(autouse=True)
def _drain_reads():
    yield
    async_read.drain_pipeline(timeout=60)


def _assert_steps_match_jax(port_steps, jax_steps, kind):
    for p, j in zip(port_steps, jax_steps):
        name = f"{kind}.{p['op']}"
        assert p.get("landed") == j.get("landed"), name
        assert p["clock_now"] == j["clock_now"], name
        for member, fields in j["states"].items():
            for f, v in fields.items():
                _same(p["states"][member][f], v, f"{name}.{member}.{f}")
        if "value" in j:
            _same_tree(p["value"], j["value"], f"{name}.compute")
            assert sorted(p["windows"]) == sorted(j["windows"]), name
            for k in j["windows"]:
                _same_tree(p["windows"][k], j["windows"][k], f"{name}.window{k}")
        if "async" in j:
            _same_tree(p["async"][0], j["async"][0], f"{name}.async")
    assert len(port_steps) == len(jax_steps)


@pytest.mark.parametrize("kind", ["sum", "max", "auroc", "entry"])
def test_captured_windows_follow_jax_and_the_eager_port(kind):
    """The schedule through the port with ``executor=True``: every state and
    read within the tolerance of the JAX package with ``executor=True`` and
    with ``executor=False``, bit-equal to the port's ``executor=False``; the
    executor engaged with no fallback, and for the single metrics its
    compiles, cache hits, padded and skipped calls equal to JAX's."""
    port_steps, port = _run(ttm, kind, True, _to_port)
    eager_steps, _ = _run(ttm, kind, False, _to_port)
    for executor in (True, False):
        jax_steps, jax_stats = _jax_run(kind, executor)
        _assert_steps_match_jax(port_steps, jax_steps, kind)
        if jax_stats is not None:
            assert {k: port.executor_status["stats"][k] for k in STAT_KEYS} == jax_stats
    for p, e in zip(port_steps, eager_steps):
        for member, fields in e["states"].items():
            for f, v in fields.items():
                np.testing.assert_array_equal(p["states"][member][f], v, err_msg=f"{p['op']}.{member}.{f}")
        if "value" in e:
            _bit_equal_tree(p["value"], e["value"], str(p["op"]))
            for k, v in e["windows"].items():
                _bit_equal_tree(p["windows"][k], v, f"{p['op']}.window{k}")
        if "async" in e:
            _bit_equal_tree(p["async"][0], e["async"][0], "async")
            _bit_equal_tree(p["async"][0], p["async"][1], "async at submission")
    status = port.collection.executor_status if kind == "entry" else port.executor_status
    assert status["engaged"] and status["fallback_reason"] is None
    assert status["stats"]["padded_calls"] == 0 and status["stats"]["skipped_calls"] == 0
    # on-time sizes 5 and 3 and the late batches' 4 and 3 (with a window):
    # one key each, whatever the slot
    assert status["stats"]["compiles"] == 4
    if kind == "entry":
        for member in port.collection.executor_status["members"].values():
            assert member["fallback_reason"] is None


# ------------------------------------------------------- the forward fault

def _forward_sequence(m, to):
    m.update(to([1.0]))
    m.advance()
    m.advance()
    value = m(to([5.0]))
    m.update(to([7.0]))
    m.advance()
    return m, value


@pytest.mark.parametrize("executor", [False, True])
def test_forward_follows_jax_ring_clock_and_window(executor):
    """update, advance, advance, forward, update, advance on W = 4: the ring
    [6, 0, 7, 0] and head 3 in both modes and both packages (a forward's
    batch lands in slot 0, the default head's; the next update in slot
    head % W = 2). The eager forward rewinds the host clock (1), as the JAX
    package's does; the captured one keeps it (3), and window 2 reads 7."""
    jtm = _jtm()
    import jax.numpy as jnp

    jax_m, jax_value = _forward_sequence(
        jtm.windows.WindowedMetric(jtm.SumMetric(nan_strategy="disable"), window=4, executor=executor),
        lambda v: jnp.asarray(v, jnp.float32),
    )
    port, value = _forward_sequence(
        WindowedMetric(SumMetric(nan_strategy="disable", device=CPU), window=4, executor=executor, device=CPU),
        lambda v: torch.tensor(v, dtype=torch.float32),
    )
    _same(port._state["sum_value"], jax_m._state["sum_value"], "ring")
    _same(port._state["window_head"], jax_m._state["window_head"], "head")
    np.testing.assert_array_equal(_np(port._state["sum_value"]), [6.0, 0.0, 7.0, 0.0])
    assert int(port._state["window_head"]) == 3
    assert port.clock == jax_m.clock == (3 if executor else 1)
    _same(value, jax_value, "forward value")
    if executor:
        assert port.executor_status["engaged"] and port.executor_status["stats"]["calls"] == 3
        assert float(port.compute_window(2)) == float(jax_m.compute_window(2)) == 7.0


# ---------------------------------------------------------- the key count

@pytest.mark.parametrize("kind", ["sum", "entry"])
def test_a_steady_size_keeps_one_key_across_three_rings(kind):
    """3W advances with a steady batch size add no key: every update after
    the first replays the one key whatever its slot, and every late batch
    the one late key whatever its window."""
    obj = _entry(ttm, True) if kind == "entry" else _single(ttm, kind, True)
    ref = _entry(ttm, False) if kind == "entry" else _single(ttm, kind, False)
    rng = np.random.RandomState(5)
    for i in range(3 * W + 1):
        batch = _to_port(_batch(kind, rng, 6))
        obj.update(*batch)
        ref.update(*batch)
        if i:
            late = _to_port(_batch(kind, rng, 2))
            assert obj.update_window(obj.clock - 1, *late) and ref.update_window(ref.clock - 1, *late)
        if i == 1:
            status = obj.collection.executor_status if kind == "entry" else obj.executor_status
            keys = status["stats"]["compiles"]
        assert obj.advance() == ref.advance() == i + 1
    status = obj.collection.executor_status if kind == "entry" else obj.executor_status
    assert status["stats"]["compiles"] == keys == 2
    assert status["stats"]["cache_hits"] == status["stats"]["calls"] - 2
    members = dict(obj.items()) if kind == "entry" else {"m": obj}
    refs = dict(ref.items()) if kind == "entry" else {"m": ref}
    for name, m in members.items():
        for f in m._defaults:
            assert torch.equal(m._state[f], refs[name]._state[f]), (name, f)


def test_an_int_window_is_made_a_device_tensor():
    """A direct caller's int ``window`` lands as a tensor's would: the same
    key, no skipped call, the same ring."""
    m = _single(ttm, "sum", True)
    ref = _single(ttm, "sum", False)
    m.advance(2)
    ref.advance(2)
    x = torch.arange(4, dtype=torch.float32)
    m.update(x, window=1)
    m.update(x, window=torch.tensor(1))
    ref.update(x, window=1)
    ref.update(x, window=1)
    stats = m.executor_status["stats"]
    assert stats["skipped_calls"] == 0 and stats["compiles"] == 1 and stats["cache_hits"] == 1
    assert torch.equal(m._state["sum_value"], ref._state["sum_value"])
    np.testing.assert_array_equal(_np(m._state["sum_value"]), [0.0, 12.0, 0.0])


def test_the_window_input_is_never_a_batched_leaf():
    """The 0-d window is keyed by dtype and rank, never padded or taken for
    the batch: a late call pads nothing and its batch dim is the rows'."""
    from torchmetrics_tpu_torch.ops.executor import _common_batch_dim

    m = _single(ttm, "sum", True)
    assert m._get_executor().bucketable() is False
    window = m._window_clock(0)
    assert window.shape == () and window.dtype == torch.int64
    assert _common_batch_dim([torch.zeros(7), window]) == 7
    for n in (7, 5):
        m.update(torch.ones(n), window=window)
    stats = m.executor_status["stats"]
    assert stats["padded_calls"] == 0 and stats["compiles"] == 2
    assert float(m.compute_window(0)) == 12.0


# ------------------------------------------------- escapes and held values

def test_a_held_compute_window_survives_later_replays():
    """A ``compute_window`` value held across two replays keeps its value:
    its row is a copy, never a view of the executor's slot."""
    m = _single(ttm, "sum", True)
    x = torch.ones(4)
    for _ in range(3):
        m.update(x)  # the key is built and replays
    held = m.compute_window(0)
    want = held.clone()
    for _ in range(2):
        m.update(x)
    assert torch.equal(held, want) and float(m.compute_window(0)) == 20.0
    disp = m._get_executor().dispatcher()
    owned = {t.data_ptr() for slot in disp.slots for t in slot}
    assert held.data_ptr() not in {p for p in owned}


def test_an_advance_between_replays_is_not_lost():
    """An advance between two replays writes a new ring outside the
    executor and marks the state escaped: the next call copies it in
    (``copied_calls``), and the ring equals the eager one."""
    m = _single(ttm, "sum", True)
    ref = _single(ttm, "sum", False)
    x = torch.ones(4)
    for _ in range(3):
        m.update(x)
        ref.update(x)
    copied = m.executor_status["stats"]["copied_calls"]
    assert not m._state_escaped
    m.advance()
    ref.advance()
    assert m._state_escaped
    m.update(x * 3)
    ref.update(x * 3)
    assert m.executor_status["stats"]["copied_calls"] == copied + 1
    m.update(x)
    ref.update(x)
    assert m.executor_status["stats"]["copied_calls"] == copied + 1
    assert torch.equal(m._state["sum_value"], ref._state["sum_value"])
    assert torch.equal(m._state["window_head"], ref._state["window_head"])


def test_collection_advance_marks_leaders_and_followers_escaped():
    wc = _entry(ttm, True)
    rng = np.random.RandomState(8)
    for _ in range(3):
        wc.update(*_to_port(_batch("entry", rng, 6)))
    assert not any(m._state_escaped for _, m in wc.items())
    wc.advance()
    assert all(m._state_escaped for _, m in wc.items())
    copied = wc.collection.executor_status["stats"]["copied_calls"]
    wc.update(*_to_port(_batch("entry", rng, 6)))
    assert wc.collection.executor_status["stats"]["copied_calls"] == copied + 1


def test_reads_hand_out_no_slot():
    """``compute``, ``state()``, an asynchronous read's snapshot and
    ``metric_state`` of a captured windowed metric hold no tensor of the
    executor's slots."""
    m = _single(ttm, "sum", True)
    for _ in range(3):
        m.update(torch.ones(4))
    disp = m._get_executor().dispatcher()
    slot_ptrs = {t.data_ptr() for slot in disp.slots for t in slot}
    handed = [m.compute()] + list(m.state().values())[:2] + list(m.metric_state.values())
    future = m.compute_async()
    m.update(torch.ones(4))
    m.update(torch.ones(4))
    assert float(future.result(timeout=60)) == 12.0
    for v in handed:
        if isinstance(v, torch.Tensor):
            assert v.data_ptr() not in slot_ptrs


# ------------------------------------------------- warmup and the compile cache

@pytest.mark.parametrize("kind", ["sum", "entry"])
def test_warmup_from_manifest_builds_on_time_and_late_keys(kind):
    """A windowed owner's shape profile holds its on-time and late calls;
    a fresh owner warmed from it builds both keys and then replays them."""
    rng = np.random.RandomState(11)
    first = _entry(ttm, True) if kind == "entry" else _single(ttm, kind, True)
    batch, late = _to_port(_batch(kind, rng, 6)), _to_port(_batch(kind, rng, 2))
    for _ in range(2):
        first.update(*batch)
    first.advance()
    first.update_window(first.clock - 1, *late)
    profile = (first.collection if kind == "entry" else first).shape_profile()
    assert sorted(sorted(s["kwargs"]) for s in profile["specs"]) == [[], ["window"]]
    fresh = _entry(ttm, True) if kind == "entry" else _single(ttm, kind, True)
    owner = fresh.collection if kind == "entry" else fresh
    report = owner.warmup_from_manifest(profile)
    assert report["warmed"] == 2 and not report["skipped"]
    fresh.update(*batch)
    fresh.update(*batch)
    fresh.advance()
    fresh.update_window(fresh.clock - 1, *late)
    stats = owner.executor_status["stats"]
    # the collection's warmup resolved its groups from the first spec: its
    # first update replays too
    assert stats["compiles"] == 2 and stats["warmup"] == 2 and stats["cache_hits"] == 3


class _DoubledSum(SumMetric):
    """A SumMetric with SumMetric's state spec and another update."""

    def update(self, value):
        super().update(value * 2)


def test_wrappers_of_other_inner_metrics_never_share_an_owner_description():
    """Two windowed wrappers of equal stacked state spec over different
    inner metrics (another class, another configuration) or ring sizes get
    different owner descriptions, in a metric's and a collection's
    executor alike."""

    def desc(inner, window=W):
        m = WindowedMetric(inner, window=window, executor=True, device=CPU)
        return m._get_executor()._owner_desc()

    plain = desc(SumMetric(nan_strategy="disable", device=CPU))
    doubled = desc(_DoubledSum(nan_strategy="disable", device=CPU))
    other_cfg = desc(SumMetric(nan_strategy="ignore", device=CPU))
    assert len({plain, doubled, other_cfg}) == 3
    assert "_DoubledSum" in doubled and f"windows={W}" in plain
    a = WindowedMetric(SumMetric(nan_strategy="disable", device=CPU), window=W, executor=True, device=CPU)
    b = WindowedMetric(_DoubledSum(nan_strategy="disable", device=CPU), window=W, executor=True, device=CPU)
    assert a.state_spec()["fields"] == b.state_spec()["fields"]

    def coll_desc(inner):
        wc = WindowedCollection({"s": inner}, window=W, executor=True)
        return wc.collection._get_executor()._owner_desc()

    assert coll_desc(SumMetric(nan_strategy="disable", device=CPU)) != coll_desc(_DoubledSum(nan_strategy="disable", device=CPU))
    # a plain metric's description is unchanged: nothing joins it
    assert "inner=" not in SumMetric(executor=True, device=CPU)._get_executor()._owner_desc()


@pytest.fixture()
def cache_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TORCHMETRICS_TPU_COMPILE_AHEAD", "1")
    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_DIR", str(tmp_path / "tm_cache"))
    monkeypatch.delenv("TORCHMETRICS_TPU_BG_COMPILE", raising=False)
    yield
    assert compile_cache.drain_worker(60)


def test_a_background_capture_reads_the_same_device_slot(cache_env):
    """A cold key built on the worker over a detached copy of the owner (at
    another clock than the live one's zero state) serves later calls: the
    ring equals the eager one's, each update in the live head's slot."""
    m = _single(ttm, "sum", True)
    ref = _single(ttm, "sum", False)
    m.advance(2)
    ref.advance(2)
    m.set_background_compile(True)
    x = torch.arange(5, dtype=torch.float32)
    m.update(x)  # cold: the eager path serves it while the worker builds
    ref.update(x)
    assert executor_stats(m)["eager_misses"] == 1
    assert compile_cache.drain_worker(60)
    (entry,) = m._get_executor().dispatcher().entries.values()
    assert entry.owner_copy is not None and entry.owner_copy[0] is not m
    for step in range(4):
        m.update(x * (step + 2))
        ref.update(x * (step + 2))
        if step == 1:
            m.advance()
            ref.advance()
    s = executor_stats(m)
    assert s["background_compiles"] == 1 and s["cache_hits"] == 4
    assert torch.equal(m._state["sum_value"], ref._state["sum_value"])
    assert torch.equal(m._state["window_head"], ref._state["window_head"])
