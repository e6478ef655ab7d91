"""The executor's recovery snapshot and the Autosaver's reuse of it, held
to the JAX package's (``tests/test_durability.py``'s reuse test).

The JAX package keeps a host copy before every donating call; the port
keeps the state slot the last replay read. Either way a save reuses a
state exactly one committed update behind the live one: here a metric and
a collection with ``executor=True`` (the executor's bookkeeping on the
CPU, the body called in place of a replay) save through an ``Autosaver``
that reuses the snapshot once, and the restored snapshot is one update
behind and bit-equal to the eager state at that count. The snapshot is
None before any replay, after an eager call and after an escape, and a
reuse marks nothing escaped (no later call copies).
"""
from __future__ import annotations

import numpy as np
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.io import Autosaver, restore_state
from torchmetrics_tpu_torch.ops.executor import latest_recovery_snapshot

C = 6


def _vectors(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(8).astype(np.float32) for _ in range(n)]


def _cls_batches(n, seed, rows=16):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, C, rows), rng.randint(0, C, rows)) for _ in range(n)]


def _port_collection(executor=True):
    from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix, MulticlassF1Score

    kw = {"validate_args": False, "device": "cpu", "executor": executor}
    return tm.MetricCollection(
        {"f1": MulticlassF1Score(num_classes=C, **kw), "confmat": MulticlassConfusionMatrix(num_classes=C, **kw)},
        executor=executor, device="cpu",
    )


def test_autosave_reuses_the_recovery_snapshot_as_jax(tmp_path):
    """The counterpart of the JAX package's reuse test: three warm updates,
    an Autosaver every 2, two more updates: one save, one reuse, and the
    restored metric one update behind the live one, in both packages."""
    import jax.numpy as jnp

    import torchmetrics_tpu as jtm
    from torchmetrics_tpu.io import Autosaver as JaxAutosaver
    from torchmetrics_tpu.io import restore_state as jax_restore

    xs = _vectors(5, 8)
    runs = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            m = jtm.SumMetric(nan_strategy="ignore", executor=True)
            saver_cls, restore, to = JaxAutosaver, jax_restore, jnp.asarray
        else:
            m = tm.SumMetric(nan_strategy="ignore", executor=True, device="cpu")
            saver_cls, restore, to = Autosaver, restore_state, torch.from_numpy
        for x in xs[:3]:
            m.update(to(x))
        assert m.executor_status["stats"]["donated_calls"] >= 1
        store = str(tmp_path / pkg)
        saver = saver_cls(m, store, every_n_updates=2, background=False).attach()
        m.update(to(xs[3]))
        m.update(to(xs[4]))  # the trigger
        m2 = jtm.SumMetric(nan_strategy="ignore", executor=False) if pkg == "jax" else tm.SumMetric(nan_strategy="ignore", device="cpu")
        restore(store, m2)
        runs[pkg] = (saver.stats["saves"], saver.stats["reused_recovery_snapshots"], m2.update_count, m.update_count,
                     float(np.asarray(m2.compute() if pkg == "jax" else m2.compute().numpy())))
    assert runs["port"] == runs["jax"]
    saves, reused, restored, live, value = runs["port"]
    assert (saves, reused, restored, live) == (1, 1, 4, 5)
    assert value == float(np.float32(sum(np.float32(x.sum()) for x in xs[:4])))


def test_a_collection_snapshot_is_one_update_behind_and_bit_equal(tmp_path):
    batches = _cls_batches(6, 3)
    on, off = _port_collection(True), _port_collection(False)
    store = str(tmp_path / "coll")
    for b in batches[:3]:
        on.update(*(torch.from_numpy(a) for a in b))
    saver = Autosaver(on, store, every_n_updates=3, background=False).attach()
    copied = on.executor_status["stats"]["copied_calls"]
    for b in batches[3:]:
        on.update(*(torch.from_numpy(a) for a in b))
    assert saver.stats["saves"] == 1 and saver.stats["reused_recovery_snapshots"] == 1
    # the reuse marked nothing escaped: every later call donated
    assert on.executor_status["stats"]["copied_calls"] == copied
    restored = _port_collection(False)
    restore_state(store, restored)
    for b in batches[:5]:
        off.update(*(torch.from_numpy(a) for a in b))
    for cg in off.compute_groups.values():
        assert restored[cg[0]].update_count == 5 == on[cg[0]].update_count - 1
        for k in off[cg[0]]._defaults:
            assert torch.equal(restored[cg[0]]._state[k], off[cg[0]]._state[k]), (cg[0], k)


def test_the_snapshot_of_a_metric_is_the_state_one_update_behind():
    xs = [torch.from_numpy(x) for x in _vectors(4, 9)]
    m = tm.SumMetric(nan_strategy="ignore", executor=True, device="cpu")
    assert latest_recovery_snapshot(m) is None  # no executor yet
    m.update(xs[0])
    assert latest_recovery_snapshot(m) is None  # a fresh key: no replay yet
    m.update(xs[1])
    count, export = latest_recovery_snapshot(m)
    assert count == 1 and export["_update_count"] == 1
    np.testing.assert_array_equal(export["sum_value"], xs[0].sum().numpy())
    assert isinstance(export["sum_value"], np.ndarray)
    again = latest_recovery_snapshot(m)  # reading it twice reads the same slot
    assert again[0] == 1 and np.array_equal(again[1]["sum_value"], export["sum_value"])
    assert not m._state_escaped


def test_the_snapshot_is_none_after_an_escape_or_an_eager_call():
    xs = [torch.from_numpy(x) for x in _vectors(6, 10)]
    m = tm.SumMetric(nan_strategy="ignore", executor=True, device="cpu")
    for x in xs[:3]:
        m.update(x)
    assert latest_recovery_snapshot(m) is not None
    _ = m.sum_value  # read by reference: escaped
    assert latest_recovery_snapshot(m) is None
    m.update(xs[3])  # copies the escaped state in, replays
    assert latest_recovery_snapshot(m) is not None
    m.compute()
    assert latest_recovery_snapshot(m) is None
    m.update(xs[4])
    assert latest_recovery_snapshot(m) is not None
    m.update(torch.from_numpy(np.arange(16, dtype=np.float32)))  # a new key: its eager run, no replay
    assert latest_recovery_snapshot(m) is None
    m.update(xs[5])
    assert latest_recovery_snapshot(m) is not None
    m.__dict__["_executor_enabled"] = False
    m.update(xs[5])  # the eager path: the count moved past the slot's
    assert latest_recovery_snapshot(m) is None
    coll = _port_collection(True)
    for b in _cls_batches(3, 4):
        coll.update(*(torch.from_numpy(a) for a in b))
    assert latest_recovery_snapshot(coll)[0] == 2
    coll.compute()
    assert latest_recovery_snapshot(coll) is None


def test_final_save_takes_the_live_state_not_the_snapshot(tmp_path):
    xs = [torch.from_numpy(x) for x in _vectors(4, 11)]
    m = tm.SumMetric(nan_strategy="ignore", executor=True, device="cpu")
    for x in xs:
        m.update(x)
    saver = Autosaver(m, str(tmp_path / "final"), every_n_updates=100, background=False)
    saver.final_save()
    assert saver.stats["reused_recovery_snapshots"] == 0
    m2 = tm.SumMetric(nan_strategy="ignore", device="cpu")
    restore_state(str(tmp_path / "final"), m2)
    assert m2.update_count == 4
