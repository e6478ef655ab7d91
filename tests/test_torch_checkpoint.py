"""The port's ``io/checkpoint.py`` against the JAX package's: one container,
so a snapshot either package writes restores in the other with bit-equal
state and equal manifest fingerprints; rotation and torn or corrupt files
fall back to the previous snapshot; the topology gate; the Autosaver's
cadence, skip-when-busy rule and stats; the preemption handler (called
directly: a real signal would kill the test process); the float-count rule
for cross-package restores; and the references the snapshots rely on
(updates replace state tensors, never write into them; compute groups keep
sharing one state through a restore).
"""
import os
import shutil
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import classification as jcls
from torchmetrics_tpu.io import checkpoint as jckpt
from torchmetrics_tpu.testing import faults as jfaults
from torchmetrics_tpu_torch import classification as tcls
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.io import checkpoint as tckpt
from torchmetrics_tpu_torch.testing import faults as tfaults
from torchmetrics_tpu_torch.utils.exceptions import (
    CheckpointCorruptionError,
    StateCorruptionError,
    TopologyMismatchError,
)

C = 10


def _batches(seed=0, n=4, size=32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(size, C).astype(np.float32), rng.randint(0, C, size)) for _ in range(n)]


def _jax_collection():
    return jtm.MetricCollection({
        "acc": jcls.MulticlassAccuracy(num_classes=C, average="micro", executor=False),
        "f1": jcls.MulticlassF1Score(num_classes=C, executor=False),
        "precision": jcls.MulticlassPrecision(num_classes=C, executor=False),
        "confmat": jcls.MulticlassConfusionMatrix(num_classes=C, executor=False),
    })


def _torch_collection():
    return ttm.MetricCollection({
        "acc": tcls.MulticlassAccuracy(num_classes=C, average="micro", device="cpu"),
        "f1": tcls.MulticlassF1Score(num_classes=C, device="cpu"),
        "precision": tcls.MulticlassPrecision(num_classes=C, device="cpu"),
        "confmat": tcls.MulticlassConfusionMatrix(num_classes=C, device="cpu"),
    }, device="cpu")


def _fed(kind, batches):
    if kind == "jax":
        coll = _jax_collection()
        for p, t in batches:
            coll.update(jnp.asarray(p), jnp.asarray(t))
    else:
        coll = _torch_collection()
        for p, t in batches:
            coll.update(torch.from_numpy(p), torch.from_numpy(t))
    return coll


def _host_state(coll):
    """Every member's state on the host (members, not group leaders: a
    freshly restored collection has not resolved its groups yet)."""
    return {
        name: {k: (v if isinstance(v, int) else np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)) for k, v in m.state().items()}
        for name, m in coll.items(keep_base=True)
    }


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for leader in a:
        assert a[leader].keys() == b[leader].keys()
        for k in a[leader]:
            x, y = a[leader][k], b[leader][k]
            if isinstance(x, int):
                assert x == y
            else:
                assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), (leader, k)


def _fingerprints(path):
    return {(e["leader"], e["field"], e["index"]): e["fingerprint"] for e in jckpt.load_manifest(path)["leaves"]}


def test_the_container_constants_are_the_jax_packages():
    assert tckpt._MAGIC == jckpt._MAGIC == b"TMTPUCKv1\n"
    assert tckpt.MANIFEST_VERSION == jckpt.MANIFEST_VERSION == 2
    assert tckpt.TOPOLOGY_POLICIES == jckpt.TOPOLOGY_POLICIES
    assert tckpt.DEFAULT_KEEP == jckpt.DEFAULT_KEEP


def test_a_jax_snapshot_restores_in_the_port_and_back(tmp_path):
    batches = _batches()
    jc, tc = _fed("jax", batches), _fed("torch", batches)
    _assert_same_state(_host_state(jc), _host_state(tc))
    jpath = jckpt.save_state(jc, str(tmp_path / "jax.ckpt"))
    tpath = tckpt.save_state(tc, str(tmp_path / "torch.ckpt"))
    assert _fingerprints(jpath) == _fingerprints(tpath)
    # JAX -> port, and the port's own manifest through the JAX reader
    into_port = _torch_collection()
    manifest = tckpt.restore_state(jpath, into_port)
    assert manifest["topology_action"] == "match" and manifest["update_count"] == len(batches)
    _assert_same_state(_host_state(into_port), _host_state(jc))
    assert tckpt.load_manifest(tpath)["topology"].keys() == jckpt.load_manifest(jpath)["topology"].keys()
    # port -> JAX
    into_jax = _jax_collection()
    assert jckpt.restore_state(tpath, into_jax)["topology_action"] == "match"
    _assert_same_state(_host_state(into_jax), _host_state(tc))
    for k, v in into_port.compute().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(into_jax.compute()[k]), rtol=1e-6)
    # both restored collections continue bit-equal
    more = _batches(seed=1, n=2)
    for p, t in more:
        into_port.update(torch.from_numpy(p), torch.from_numpy(t))
        into_jax.update(jnp.asarray(p), jnp.asarray(t))
    _assert_same_state(_host_state(into_port), _host_state(into_jax))


def test_a_single_metric_snapshot_crosses_both_ways(tmp_path):
    rng = np.random.RandomState(3)
    p, t = rng.randn(40, C).astype(np.float32), rng.randint(0, C, 40)
    jm = jcls.MulticlassConfusionMatrix(num_classes=C, executor=False)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    tm = tcls.MulticlassConfusionMatrix(num_classes=C, device="cpu")
    tckpt.restore_state(jckpt.save_state(jm, str(tmp_path / "m.ckpt")), tm)
    assert np.array_equal(tm.confmat.numpy(), np.asarray(jm.confmat)) and tm.update_count == 1
    back = jcls.MulticlassConfusionMatrix(num_classes=C, executor=False)
    jckpt.restore_state(tckpt.save_state(tm, str(tmp_path / "t.ckpt")), back)
    assert np.array_equal(np.asarray(back.confmat), tm.confmat.numpy())


def test_rotation_keeps_the_newest(tmp_path):
    coll = _fed("torch", _batches(n=1))
    store = str(tmp_path / "store")
    paths = [tckpt.save_state(coll, store, keep=2) for _ in range(4)]
    assert [os.path.basename(p) for p in paths] == [f"snapshot-{i:08d}.ckpt" for i in range(4)]
    assert sorted(os.listdir(store)) == ["snapshot-00000002.ckpt", "snapshot-00000003.ckpt"]
    manifest = tckpt.restore_state(store, _torch_collection())
    assert manifest["path"].endswith("snapshot-00000003.ckpt") and manifest["fallbacks_skipped"] == 0


@pytest.mark.parametrize("mode", ["truncate", "zero", "flip"])
def test_a_damaged_newest_snapshot_falls_back(tmp_path, mode):
    store = str(tmp_path / "store")
    batches = _batches(n=3)
    coll = _torch_collection()
    for p, t in batches:
        coll.update(torch.from_numpy(p), torch.from_numpy(t))
        tckpt.save_state(coll, store, keep=3)
    newest = tckpt._list_snapshots(store)[-1][1]
    reference = str(tmp_path / "reference.ckpt")
    shutil.copy(newest, reference)
    tfaults.torn_write(newest, mode=mode, seed=5)
    jfaults.torn_write(reference, mode=mode, seed=5)
    assert open(newest, "rb").read() == open(reference, "rb").read()  # the same damage as the JAX primitive
    skipped = []
    restored = _torch_collection()
    manifest = tckpt.restore_state(store, restored, on_fallback=lambda path, err: skipped.append(type(err)))
    assert skipped == [CheckpointCorruptionError]
    assert manifest["fallbacks_skipped"] == 1 and manifest["update_count"] == 2
    want = _fed("torch", batches[:2])
    _assert_same_state(_host_state(restored), _host_state(want))
    with pytest.raises(CheckpointCorruptionError):
        tckpt.restore_state(newest, _torch_collection())


def test_a_store_with_no_valid_snapshot_raises(tmp_path):
    store = str(tmp_path / "store")
    coll = _fed("torch", _batches(n=1))
    for _ in range(2):
        tckpt.save_state(coll, store, keep=2)
    for _, path in tckpt._list_snapshots(store):
        tfaults.torn_write(path)
    with pytest.warns(UserWarning, match="skipping damaged snapshot"), pytest.raises(CheckpointCorruptionError):
        tckpt.restore_state(store, _torch_collection())
    os.makedirs(tmp_path / "empty")
    with pytest.raises(CheckpointCorruptionError, match="no snapshots"):
        tckpt.restore_state(str(tmp_path / "empty"), _torch_collection())


def test_an_installed_state_that_differs_from_the_manifest_is_refused(tmp_path, monkeypatch):
    from torchmetrics_tpu_torch.utils.exceptions import StateDivergenceError

    coll = _fed("torch", _batches(n=2))
    path = tckpt.save_state(coll, str(tmp_path / "s.ckpt"))
    target = _torch_collection()
    orig = target.load_state

    def flipping(states, **kwargs):
        orig(states, **kwargs)
        cm = target["confmat"]
        cm.confmat = cm.confmat + 1  # the install path changed the bits

    monkeypatch.setattr(target, "load_state", flipping)
    with pytest.raises(StateDivergenceError) as err:
        tckpt.restore_state(path, target)
    assert err.value.surface == "restore" and err.value.field == "confmat"


def _stacked(coll, shards):
    return {
        leader: {k: torch.stack([v] * shards) for k, v in st.items() if k != "_update_count"}
        for leader, st in coll.state().items()
    }


def test_a_sharded_snapshot_on_a_shrunk_world_is_refused(tmp_path):
    """Both packages refuse a stacked (sharded) snapshot on a world with
    another device count under ``"strict"``; under ``"elastic"`` the port
    folds it to the reduced layout through ``parallel/reshard.py`` (the
    8 identical shards sum to 8 times one)."""
    batches = _batches(n=2)
    tc, jc = _fed("torch", batches), _fed("jax", batches)
    with tfaults.grow_world(8):
        tpath = tckpt.save_state(tc, str(tmp_path / "t.ckpt"), states=_stacked(tc, 8), sharded=True)
    manifest = tckpt.load_manifest(tpath)
    assert manifest["topology"]["sharded"] and manifest["topology"]["num_shards"] == 8
    with tfaults.shrink_world(4):
        with pytest.raises(TopologyMismatchError, match="restore on the saved topology") as strict:
            tckpt.restore_state(tpath, _torch_collection())
        folded = _torch_collection()
        assert tckpt.restore_state(tpath, folded, topology="elastic")["topology_action"] == "fold"
    assert strict.value.saved["num_shards"] == 8 and strict.value.current["device_count"] == 4
    assert torch.equal(folded["confmat"].confmat, 8 * tc["confmat"].confmat)
    counters = obs.counters_snapshot()
    assert not obs.telemetry_enabled() or (
        counters.get("checkpoint.topology_mismatches", 0) >= 1 and counters.get("checkpoint.elastic_restores", 0) >= 1
    )
    jstates = {leader: {k: jnp.stack([jnp.asarray(v)] * 8) for k, v in st.items() if k != "_update_count"}
               for leader, st in jc.state().items()}
    jpath = jckpt.save_state(jc, str(tmp_path / "j.ckpt"), states=jstates, sharded=True)
    with jfaults.shrink_world(4):
        with pytest.raises(jtm.utils.exceptions.TopologyMismatchError):
            jckpt.restore_state(jpath, _jax_collection())
    # an unsharded snapshot restores on any world, under either policy
    plain = tckpt.save_state(tc, str(tmp_path / "plain.ckpt"))
    with tfaults.shrink_world(1):
        for policy in ("strict", "elastic"):
            assert tckpt.restore_state(plain, _torch_collection(), topology=policy)["topology_action"] == "match"


def _drive(kind, saver_kwargs, directory, n_updates, pause=None):
    """A collection of either package under an Autosaver; returns its stats."""
    io = jckpt if kind == "jax" else tckpt
    batches = _batches(seed=7, n=n_updates, size=8)
    coll = _jax_collection() if kind == "jax" else _torch_collection()
    saver = io.Autosaver(coll, directory, **saver_kwargs).attach()
    try:
        for p, t in batches:
            if kind == "jax":
                coll.update(jnp.asarray(p), jnp.asarray(t))
            else:
                coll.update(torch.from_numpy(p), torch.from_numpy(t))
        if pause is not None:
            pause.set()
        saver.flush(30.0)
    finally:
        saver.detach()
    return saver.stats


def test_autosaver_cadence_and_stats_match_the_jax_package(tmp_path):
    stats = {
        kind: _drive(kind, {"every_n_updates": 3, "keep": 10, "background": False}, str(tmp_path / kind), 7)
        for kind in ("jax", "torch")
    }
    assert stats["torch"].keys() == stats["jax"].keys()
    for key in ("saves", "skipped_inflight", "async_rides", "save_errors"):
        assert stats["torch"][key] == stats["jax"][key]
    assert stats["torch"]["saves"] == 2
    counts = [tckpt.load_manifest(p)["update_count"] for _, p in tckpt._list_snapshots(str(tmp_path / "torch"))]
    assert counts == [3, 6]


def test_autosaver_skips_a_save_while_one_is_in_flight(tmp_path):
    """With the read pipeline's worker parked, the first background save
    stays in flight and the next due one is skipped, in both packages."""
    from torchmetrics_tpu.testing.faults import pause_async_reads as jax_pause

    stats = {}
    for kind, pause in (("jax", jax_pause), ("torch", tfaults.pause_async_reads)):
        with pause(max_s=30.0) as release:
            stats[kind] = _drive(kind, {"every_n_updates": 2, "keep": 10}, str(tmp_path / kind), 4, pause=release)
    for key in ("saves", "skipped_inflight", "async_rides", "save_errors"):
        assert stats["torch"][key] == stats["jax"][key], key
    assert stats["torch"]["skipped_inflight"] == 1 and stats["torch"]["saves"] == 1


def test_autosaver_time_cadence_and_validation(tmp_path):
    coll = _torch_collection()
    with pytest.raises(ValueError):
        tckpt.Autosaver(coll, str(tmp_path))
    with pytest.raises(ValueError):
        tckpt.Autosaver(coll, str(tmp_path), every_n_updates=0)
    saver = tckpt.Autosaver(coll, str(tmp_path), every_s=1e-9, background=False)
    p, t = _batches(n=1)[0]
    coll.update(torch.from_numpy(p), torch.from_numpy(t))
    assert saver.step() is not None and saver.stats["saves"] == 1


def test_preemption_handler_flushes_and_restores_the_previous_handler(tmp_path):
    coll = _fed("torch", _batches(n=3))
    saver = tckpt.Autosaver(coll, str(tmp_path), every_n_updates=100)
    chained = []

    def previous(signum, frame):
        chained.append(signum)

    old = signal.signal(signal.SIGUSR1, previous)
    try:
        handle = tckpt.install_preemption_handler(saver, signums=(signal.SIGUSR1,))
        try:
            assert signal.getsignal(signal.SIGUSR1) == handle._handle
            handle._handle(signal.SIGUSR1, None)
        finally:
            handle.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is previous
    finally:
        signal.signal(signal.SIGUSR1, old)
    assert chained == [signal.SIGUSR1] and handle.flushes == 1
    restored = _torch_collection()
    assert tckpt.restore_state(str(tmp_path), restored)["update_count"] == 3
    _assert_same_state(_host_state(restored), _host_state(coll))


def test_a_simulated_preemption_restores_and_finishes_bit_equal(tmp_path):
    batches = _batches(seed=9, n=7, size=16)
    whole = _fed("torch", batches)
    coll = _torch_collection()
    saver = tckpt.Autosaver(coll, str(tmp_path), every_n_updates=2, keep=3, background=False).attach()
    with tfaults.preempt_after(coll, 5), pytest.raises(tfaults.PreemptionInjected):
        for p, t in batches:
            coll.update(torch.from_numpy(p), torch.from_numpy(t))
    assert coll.update_count == 5
    saver.final_save()
    saver.detach()
    resumed = _torch_collection()
    assert tckpt.restore_state(str(tmp_path), resumed)["update_count"] == 5
    for p, t in batches[5:]:
        resumed.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_same_state(_host_state(resumed), _host_state(whole))
    for k, v in resumed.compute().items():
        assert torch.equal(v, whole.compute()[k])


def test_float_counts_of_the_jax_package_restore_exactly_or_are_refused(tmp_path):
    """Pearson's count is float32 in the JAX package and int64 in the port:
    a count float32 holds exactly restores as that integer; one past 2^24
    (where JAX's float32 count may already have rounded) is refused; the
    port's int64 count is refused by the JAX package's strict validation."""
    from torchmetrics_tpu.regression import PearsonCorrCoef as JaxPearson
    from torchmetrics_tpu_torch.regression import PearsonCorrCoef

    rng = np.random.RandomState(4)
    x, y = rng.randn(50).astype(np.float32), rng.randn(50).astype(np.float32)
    jm = JaxPearson(executor=False)
    jm.update(jnp.asarray(x), jnp.asarray(y))
    assert np.asarray(jm.state()["n_total"]).dtype == np.float32
    ok = jckpt.save_state(jm, str(tmp_path / "ok.ckpt"))
    tm = PearsonCorrCoef(device="cpu")
    tckpt.restore_state(ok, tm)
    assert tm.n_total.dtype == torch.int64 and int(tm.n_total) == 50
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-5)
    state = {k: (v if k == "_update_count" else np.asarray(v)) for k, v in jm.state().items()}
    state["n_total"] = np.float32(2**24 + 2)
    past = jckpt.save_state(jm, str(tmp_path / "past.ckpt"), states=state)
    with pytest.raises(StateCorruptionError, match="2\\^24|16777216"):
        tckpt.restore_state(past, PearsonCorrCoef(device="cpu"))
    port = tckpt.save_state(tm, str(tmp_path / "port.ckpt"))
    with pytest.raises(jtm.utils.exceptions.StateCorruptionError):
        jckpt.restore_state(port, JaxPearson(executor=False))


def test_updates_replace_state_tensors(tmp_path):
    """A snapshot by reference is consistent: every state tensor (and list
    state) held across an update keeps its values."""
    from torchmetrics_tpu_torch.aggregation import CatMetric

    coll = _torch_collection()
    cat = CatMetric(device="cpu")
    batches = _batches(n=3)
    for p, t in batches[:1]:
        coll.update(torch.from_numpy(p), torch.from_numpy(t))
        cat.update(torch.from_numpy(p[:, 0]))
    held = coll.state()
    copies = {leader: {k: v.clone() for k, v in st.items() if k != "_update_count"} for leader, st in held.items()}
    held_cat = cat.state()
    cat_len = len(held_cat["value"])
    for p, t in batches[1:]:
        coll.update(torch.from_numpy(p), torch.from_numpy(t))
        cat.update(torch.from_numpy(p[:, 0]))
    for leader, st in copies.items():
        for k, v in st.items():
            assert torch.equal(held[leader][k], v), (leader, k)
    assert len(held_cat["value"]) == cat_len and len(cat.state()["value"]) == cat_len + 2
    path = tckpt.save_state(cat, str(tmp_path / "cat.ckpt"))
    back = CatMetric(device="cpu")
    tckpt.restore_state(path, back)
    assert torch.equal(back.compute(), cat.compute())


def test_compute_groups_share_one_state_through_a_restore(tmp_path):
    coll = _fed("torch", _batches(n=2))
    assert ["f1", "precision"] in [sorted(g) for g in coll.compute_groups.values()]
    path = tckpt.save_state(coll, str(tmp_path / "groups.ckpt"))
    target = _torch_collection()
    p, t = _batches(seed=5, n=1)[0]
    target.resolve_compute_groups(torch.from_numpy(p), torch.from_numpy(t))
    tckpt.restore_state(path, target)
    assert target["precision"].tp is target["f1"].tp
    target.update(torch.from_numpy(p), torch.from_numpy(t))
    assert target["precision"].tp is target["f1"].tp
    assert target["f1"].update_count == 3


@pytest.mark.parametrize("mode", ["shape", "dtype", "structure", "nan"])
def test_corrupt_state_is_refused_by_strict_validation(mode):
    m = tcls.MulticlassStatScores(num_classes=C, average=None, device="cpu")
    p, t = _batches(n=1)[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    state = m.state()
    if mode == "nan":
        state = {k: (v.float() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    bad = tfaults.corrupt_state(state, mode=mode)
    with pytest.raises(StateCorruptionError):
        m.load_state(bad, check_finite=True)


def test_raise_in_update_and_compute_roll_back():
    m = tcls.MulticlassAccuracy(num_classes=C, device="cpu")
    p, t = _batches(n=1)[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    before = {k: v.clone() for k, v in m.metric_state.items()}
    with tfaults.raise_in_update(m), pytest.raises(tfaults.FaultInjected):
        m.update(torch.from_numpy(p), torch.from_numpy(t))
    assert m.update_count == 1 and all(torch.equal(m.metric_state[k], v) for k, v in before.items())
    with tfaults.raise_in_update(m), pytest.raises(tfaults.FaultInjected):
        m(torch.from_numpy(p), torch.from_numpy(t))
    assert m.update_count == 1
    with tfaults.raise_in_compute(m), pytest.raises(tfaults.FaultInjected):
        m.compute()
    assert "_update_fn" not in m.__dict__ and "_compute_fn" not in m.__dict__
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    assert m.update_count == 2 and float(m.compute()) >= 0


def test_the_preemption_flush_reenters_locks_its_thread_holds(tmp_path):
    """A signal handler runs between bytecodes of the main thread, maybe
    inside a ``counter_inc``, a ring append or a ``save_now``: the flush
    re-enters those locks instead of waiting on itself. The handler runs on
    a helper thread that holds all three, joined with a timeout."""
    import threading

    from torchmetrics_tpu_torch.obs import registry, tracer

    coll = _fed("torch", _batches(n=2))
    saver = tckpt.Autosaver(coll, str(tmp_path), every_n_updates=100)
    handle = tckpt.PreemptionHandle.__new__(tckpt.PreemptionHandle)
    handle._saver, handle._previous, handle.flushes = saver, {signal.SIGUSR1: lambda *_: None}, 0
    obs.set_tracing(True)

    def interrupted():
        with registry._lock, tracer._ring._lock, saver._lock:
            handle._handle(signal.SIGUSR1, None)

    try:
        t = threading.Thread(target=interrupted, daemon=True)
        t.start()
        t.join(30.0)
    finally:
        obs.set_tracing(None)
    assert not t.is_alive() and handle.flushes == 1
    assert tckpt.restore_state(str(tmp_path), _torch_collection())["update_count"] == 2
