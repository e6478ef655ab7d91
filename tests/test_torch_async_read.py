"""The port's asynchronous reads (``ops/async_read.py``, ``compute_async``):
a future equals a blocking ``compute()`` at its count (and the JAX
package's ``compute_async`` on the same data); a future keeps its value
across later updates and resets; a full queue runs a read inline; a wrapper
reads inline and says why; errors travel through the future. Every test
drains the pipeline or releases its pause with a timeout of its own.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import classification as jcls
from torchmetrics_tpu_torch import classification as tcls
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.ops import async_read
from torchmetrics_tpu_torch.testing import FaultInjected, pause_async_reads, raise_in_compute

C = 10


@pytest.fixture(autouse=True)
def drained():
    obs.reset()
    yield
    assert async_read.drain_pipeline(30.0)
    obs.reset()


def _batches(seed=0, n=5, size=32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(size, C).astype(np.float32), rng.randint(0, C, size)) for _ in range(n)]


def _collection():
    return ttm.MetricCollection({
        "acc": tcls.MulticlassAccuracy(num_classes=C, average="micro", device="cpu"),
        "f1": tcls.MulticlassF1Score(num_classes=C, device="cpu"),
        "recall": tcls.MulticlassRecall(num_classes=C, device="cpu"),
        "confmat": tcls.MulticlassConfusionMatrix(num_classes=C, device="cpu"),
    }, device="cpu")


def _bit_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_each_future_equals_compute_at_its_count():
    batches = _batches()
    ref, blocking = _collection(), []
    for p, t in batches:
        ref.update(torch.from_numpy(p), torch.from_numpy(t))
        blocking.append(ref.compute())
    coll, futures = _collection(), []
    for p, t in batches:
        coll.update(torch.from_numpy(p), torch.from_numpy(t))
        futures.append(coll.compute_async())
    for i, (fut, want) in enumerate(zip(futures, blocking), 1):
        assert fut.submitted_count == i
        _bit_equal(fut.result(30.0), want)
    counters = obs.counters_snapshot()
    assert counters["reads.async_submitted"] == counters["reads.async_completed"] == len(batches)
    assert "reads.inline_compute" not in counters and "reads.inline_fallback" not in counters


def test_futures_agree_with_the_jax_package():
    batches = _batches(seed=1)
    jc = jtm.MetricCollection({
        "acc": jcls.MulticlassAccuracy(num_classes=C, average="micro", executor=False),
        "f1": jcls.MulticlassF1Score(num_classes=C, executor=False),
        "recall": jcls.MulticlassRecall(num_classes=C, executor=False),
        "confmat": jcls.MulticlassConfusionMatrix(num_classes=C, executor=False),
    })
    tc = _collection()
    pairs = []
    for p, t in batches:
        jc.update(jnp.asarray(p), jnp.asarray(t))
        tc.update(torch.from_numpy(p), torch.from_numpy(t))
        pairs.append((jc.compute_async(), tc.compute_async()))
    for jf, tf in pairs:
        got, want = tf.result(30.0), jf.result(30.0)
        assert got.keys() == want.keys() and tf.submitted_count == jf.submitted_count
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def test_a_future_keeps_its_value_across_updates_and_resets():
    batches = _batches(seed=2, n=4)
    m = tcls.MulticlassF1Score(num_classes=C, device="cpu")
    m.update(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    want = m.compute()
    m.update(torch.from_numpy(batches[1][0]), torch.from_numpy(batches[1][1]))
    coll = _collection()
    coll.update(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    coll_want = coll.compute()
    fresh = tcls.MulticlassF1Score(num_classes=C, device="cpu")
    fresh.update(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    with pause_async_reads(max_s=30.0) as release:
        fut = fresh.compute_async()
        coll_fut = coll.compute_async()
        for p, t in batches[1:]:
            fresh.update(torch.from_numpy(p), torch.from_numpy(t))
            coll.update(torch.from_numpy(p), torch.from_numpy(t))
        fresh.reset()
        coll.reset()
        assert not fut.done() and not coll_fut.done()
        release.set()
        assert torch.equal(fut.result(30.0), want)
        _bit_equal(coll_fut.result(30.0), coll_want)
    # the read at a stale count did not install its value as the live cache
    assert fresh._computed is None and fresh.update_count == 0


def _collection_after_one(batches):
    coll = _collection()
    coll.update(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    return coll


def test_a_resolved_read_fills_the_cache_only_at_its_count():
    m = tcls.MulticlassAccuracy(num_classes=C, device="cpu")
    p, t = _batches(n=1)[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    value = m.compute_async().result(30.0)
    assert m._computed is not None and torch.equal(m._computed, value)
    assert m.compute_async().result(30.0) is m._computed  # a cached value is served as it is


def test_a_full_queue_runs_the_read_inline(monkeypatch):
    pipeline = async_read.ReadPipeline(maxsize=2)
    monkeypatch.setattr(async_read, "_PIPELINE", pipeline)
    coll = _collection_after_one(_batches(seed=3))
    want = _collection_after_one(_batches(seed=3)).compute()
    with pause_async_reads(max_s=30.0) as release:
        deadline = time.monotonic() + 30.0
        while pipeline._q.qsize() and time.monotonic() < deadline:  # the worker takes the barrier
            time.sleep(0.001)
        queued = [coll.compute_async() for _ in range(2)]
        inline = coll.compute_async()
        assert inline.done() and not any(f.done() for f in queued)
        assert pipeline.stats["inline"] == 1
        assert obs.counters_snapshot()["reads.inline_fallback"] == 1
        release.set()
        for fut in queued + [inline]:
            _bit_equal(fut.result(30.0), want)
    assert pipeline.drain(30.0)


def test_a_wrapper_reads_inline_and_says_why():
    from torchmetrics_tpu.wrappers import ClasswiseWrapper as JaxClasswise
    from torchmetrics_tpu_torch.wrappers import ClasswiseWrapper

    m = ClasswiseWrapper(tcls.MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
    j = JaxClasswise(jcls.MulticlassAccuracy(num_classes=3, average=None, executor=False))
    reason = m._async_inline_reason()
    assert reason is not None and reason == j._async_inline_reason()
    m.update(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 1, 1, 2]))
    fut = m.compute_async()
    got = fut.result(30.0)
    assert got.keys() == m.compute().keys() and all(torch.equal(got[k], v) for k, v in m.compute().items())
    assert obs.counters_snapshot()["reads.inline_compute"] == 1
    assert tcls.MulticlassAccuracy(num_classes=3, device="cpu")._async_inline_reason() is None


def test_errors_travel_through_the_future():
    m = tcls.MulticlassAccuracy(num_classes=C, device="cpu")
    p, t = _batches(n=1)[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    clone = m._read_clone()
    with raise_in_compute(clone):
        fut = m.compute_async()
        assert isinstance(fut.exception(30.0), FaultInjected)
    with pytest.raises(FaultInjected):
        fut.result(1.0)
    assert obs.counters_snapshot()["reads.async_errors"] == 1
    assert "error" in repr(fut)
    seen = []
    ok = m.compute_async()
    ok.add_done_callback(seen.append)
    ok.result(30.0)
    ok.add_done_callback(seen.append)
    assert seen == [ok, ok] and not ok.degraded


def test_a_pending_future_times_out_and_the_pause_releases_itself():
    m = tcls.MulticlassAccuracy(num_classes=C, device="cpu")
    p, t = _batches(n=1)[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    with pause_async_reads(max_s=0.2):
        fut = m.compute_async()
        with pytest.raises(TimeoutError):
            fut.result(0.01)
    assert fut.wait(30.0) and torch.equal(fut.result(), m.compute())


def test_the_read_clone_and_observers_are_never_copied():
    import copy

    m = tcls.MulticlassAccuracy(num_classes=C, device="cpu")
    p, t = _batches(n=1)[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    detach = m.add_update_observer(lambda _: None)
    m.compute_async().result(30.0)
    assert "_read_clone_cache" in m.__dict__
    twin = copy.deepcopy(m)
    assert "_read_clone_cache" not in twin.__dict__ and "_update_observers" not in twin.__dict__
    detach()
    assert m.__dict__["_update_observers"] == []


def test_a_failed_sync_serves_the_last_good_value_through_the_future():
    """``on_sync_failure="last_good"``: the worker's read replays the policy
    and the future resolves to the same ``DegradedValue`` a blocking compute
    serves."""
    from torchmetrics_tpu_torch.quarantine import DegradedValue

    calls = {"fail": False}

    def sync(states, reductions, group):
        if calls["fail"]:
            raise RuntimeError("peer gone")
        return dict(states)

    m = tcls.MulticlassAccuracy(num_classes=C, device="cpu", on_sync_failure="last_good", distributed_available_fn=lambda: True)
    m._sync_states = sync
    batches = _batches(seed=6, n=2)
    m.update(*(torch.from_numpy(a) for a in batches[0]))
    good = m.compute()
    m.update(*(torch.from_numpy(a) for a in batches[1]))
    calls["fail"] = True
    with pytest.warns(UserWarning, match="last-good"):
        fut = m.compute_async()
        value = fut.result(30.0)
    assert fut.degraded and isinstance(value, DegradedValue)
    assert torch.equal(value.value, good) and value.updates_behind == 1 and value.age_updates == 1
    assert obs.counters_snapshot()["reads.async_degraded"] == 1
    with pytest.warns(UserWarning, match="last-good"):
        blocking = m.compute()
    assert isinstance(blocking, DegradedValue) and torch.equal(blocking.value, value.value)
    assert m._computed is None  # a degraded value is never cached
