"""The port's ``Metric`` core (torchmetrics_tpu_torch/metric.py) against the JAX package.

One small custom metric is written once per framework; the same numpy
batches drive both through update/forward/compute, both forward strategies,
the functional API, state export and merge. Float values agree within
rtol=1e-6, counts exactly. The port-only behaviour (device placement, the
transaction rollback, sync in a single process) is pinned here too.
"""
import copy
import gc
import inspect
import pickle
import weakref
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jax_tm
import torchmetrics_tpu.classification as jax_classification
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.classification as classification
from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utils.exceptions import StateCorruptionError, TorchMetricsUserError


def _make_pair(full_state_update):
    class JaxSumMean(jax_tm.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", jnp.asarray(0.0), dist_reduce_fx="sum")
            self.add_state("count", jnp.asarray(0), dist_reduce_fx="sum")
            self.add_state("peak", jnp.asarray(-1e9), dist_reduce_fx="max")
            self.add_state("avg", jnp.asarray(0.0), dist_reduce_fx="mean")
            self.add_state("seen", [], dist_reduce_fx="cat")

        def update(self, x):
            self.total = self.total + x.sum()
            self.count = self.count + x.size
            self.peak = jnp.maximum(self.peak, x.max())
            self.avg = x.mean()
            self.seen.append(x)

        def compute(self):
            return self.total / self.count + self.peak + self.avg

    class PortSumMean(tm.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("count", 0, dist_reduce_fx="sum")
            self.add_state("peak", torch.tensor(-1e9), dist_reduce_fx="max")
            self.add_state("avg", torch.tensor(0.0), dist_reduce_fx="mean")
            self.add_state("seen", [], dist_reduce_fx="cat")

        def update(self, x):
            self.total = self.total + x.sum()
            self.count = self.count + x.numel()
            self.peak = torch.maximum(self.peak, x.max())
            self.avg = x.mean()
            self.seen.append(x)

        def compute(self):
            return self.total / self.count + self.peak + self.avg

    JaxSumMean.full_state_update = full_state_update
    PortSumMean.full_state_update = full_state_update
    return JaxSumMean(executor=False), PortSumMean(device="cpu")


def _batches(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(7).astype(np.float32) for _ in range(n)]


def _close(port, ref, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64), rtol=rtol)


@pytest.mark.parametrize("full_state_update", [True, False])
def test_forward_and_compute_match_jax(full_state_update):
    ref, port = _make_pair(full_state_update)
    for x in _batches():
        _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))
    _close(port.compute(), ref.compute())
    assert port.update_count == ref.update_count == 3
    for name in ("total", "count", "peak", "avg"):
        _close(port.metric_state[name], ref.metric_state[name])
    assert port.metric_state["count"].dtype == torch.int32
    assert len(port.metric_state["seen"]) == 3


def test_functional_api_and_merge_match_jax():
    ref, port = _make_pair(False)
    xs = _batches(4, seed=1)
    ref_state, port_state = ref.functional_init(), port.functional_init()
    for x in xs[:2]:
        ref_state = ref.functional_update(ref_state, jnp.asarray(x))
        port_state = port.functional_update(port_state, torch.from_numpy(x))
    ref_b = ref.functional_update(ref.functional_init(), jnp.asarray(xs[2]))
    port_b = port.functional_update(port.functional_init(), torch.from_numpy(xs[2]))
    ref_m = ref.merge_states(ref_state, ref_b, counts=(2, 1))
    port_m = port.merge_states(port_state, port_b, counts=(2, 1))
    _close(port.functional_compute(port_m), ref.functional_compute(ref_m))
    ref_f, ref_v = ref.functional_forward(ref_m, jnp.asarray(xs[3]), update_count=3)
    port_f, port_v = port.functional_forward(port_m, torch.from_numpy(xs[3]), update_count=3)
    _close(port_v, ref_v)
    _close(port.functional_compute(port_f), ref.functional_compute(ref_f))
    assert port.update_count == 0  # the functional API never touches live state


def test_state_spec_matches_jax_for_the_slice():
    kw = {"num_classes": 4}
    for name in ("MulticlassAccuracy", "MulticlassF1Score", "MulticlassConfusionMatrix", "MulticlassJaccardIndex"):
        ref = getattr(jax_classification, name)(**kw, executor=False).state_spec()
        port = getattr(classification, name)(**kw, device="cpu").state_spec()
        assert port == ref, name
    for avg in ("micro", "macro"):
        assert (
            classification.MulticlassAccuracy(num_classes=4, average=avg, device="cpu").state_spec()
            == jax_classification.MulticlassAccuracy(num_classes=4, average=avg, executor=False).state_spec()
        )
    ref = jax_classification.BinaryStatScores(multidim_average="samplewise", executor=False).state_spec()
    assert classification.BinaryStatScores(multidim_average="samplewise", device="cpu").state_spec() == ref


def test_state_round_trip_carries_update_count():
    m = classification.MulticlassAccuracy(num_classes=3, device="cpu")
    for _ in range(2):
        m.update(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 2, 2, 1]))
    exported = m.state()
    assert exported["_update_count"] == 2
    other = classification.MulticlassAccuracy(num_classes=3, device="cpu")
    other.load_state(exported)
    assert other.update_count == 2 and torch.equal(other.compute(), m.compute())
    other.load_state({k: v for k, v in exported.items() if k != "_update_count"})
    assert other.update_count == 1


def test_load_state_validation_modes():
    m = classification.MulticlassConfusionMatrix(num_classes=3, device="cpu")
    good = {"confmat": torch.ones((3, 3), dtype=torch.int32)}
    with pytest.raises(StateCorruptionError, match="dtype|int64"):
        m.load_state({"confmat": torch.ones((3, 3), dtype=torch.int64)})
    with pytest.raises(StateCorruptionError, match="shape"):
        m.load_state({"confmat": torch.ones((2, 2), dtype=torch.int32)}, validate="cast")
    with pytest.raises(StateCorruptionError, match="missing"):
        m.load_state({})
    with pytest.raises(StateCorruptionError, match="not a tensor"):
        m.load_state({"confmat": np.ones((3, 3), np.int32)})
    m.load_state({"confmat": np.ones((3, 3), np.int64)}, validate="cast")
    assert m.confmat.dtype == torch.int32 and int(m.confmat.sum()) == 9
    m.load_state(good)
    f = classification.MulticlassF1Score(num_classes=3, device="cpu")
    bad = {k: v.float().fill_(float("nan")) for k, v in f.metric_state.items()}
    with pytest.raises(StateCorruptionError, match="non-finite"):
        f.load_state(bad, validate="off", check_finite=True)


def test_failed_update_rolls_back():
    class HalfDone(tm.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("a", torch.tensor(0), dist_reduce_fx="sum")
            self.add_state("items", [], dist_reduce_fx="cat")

        def update(self, x):
            self.a = self.a + x.sum()
            self.items.append(x)
            if bool((x < 0).any()):
                raise ValueError("negative input")

        def compute(self):
            return self.a

    m = HalfDone(device="cpu")
    m.update(torch.tensor([1, 2]))
    value = m.compute()
    with pytest.raises(ValueError, match="negative"):
        m.update(torch.tensor([5, -1]))
    assert m.update_count == 1 and int(m.a) == 3 and len(m.items) == 1
    assert m.compute() is value  # the cached value survived the failed call


def test_reset_clone_and_pickle():
    m = classification.MulticlassF1Score(num_classes=3, device="cpu")
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 2, 2]))
    value = m.compute()
    for copy_ in (m.clone(), pickle.loads(pickle.dumps(m))):
        assert torch.equal(copy_.compute(), value) and copy_.update_count == 1
        copy_.update(torch.tensor([1]), torch.tensor([1]))
        assert m.update_count == 1
    m.reset()
    assert m.update_count == 0 and int(m.tp.sum()) == 0
    # the defaults survive a reset followed by an update
    m.update(torch.tensor([0]), torch.tensor([0]))
    assert int(m._defaults["tp"].sum()) == 0


def _state_refs(metric):
    """Weak references to every state tensor of a metric or a collection."""
    metrics = metric.values() if isinstance(metric, tm.MetricCollection) else [metric]
    return [weakref.ref(v) for m in metrics for v in m._state.values() if isinstance(v, torch.Tensor)]


def _collection():
    return tm.MetricCollection(
        {
            "acc": classification.MulticlassAccuracy(num_classes=3, device="cpu"),
            "f1": classification.MulticlassF1Score(num_classes=3, device="cpu"),
            "confmat": classification.MulticlassConfusionMatrix(num_classes=3, device="cpu"),
        },
        device="cpu",
    )


@pytest.mark.parametrize("make", ["metric", "collection"])
@pytest.mark.parametrize("copy_with", ["none", "pickle", "clone", "deepcopy"])
def test_del_frees_the_state_without_the_cyclic_gc(make, copy_with):
    """A metric is no reference cycle: with the cyclic garbage collector
    off, ``del`` frees every state tensor at once, for a metric or a
    collection as built, updated and computed, and for its copies."""
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        metric = classification.MulticlassF1Score(num_classes=3, device="cpu") if make == "metric" else _collection()
        metric.update(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 2, 2, 1]))
        metric.compute()
        if copy_with != "none":
            metric = {"pickle": lambda m: pickle.loads(pickle.dumps(m)), "clone": lambda m: m.clone(),
                      "deepcopy": copy.deepcopy}[copy_with](metric)
            metric.update(torch.tensor([1]), torch.tensor([1]))
            metric.compute()
        refs = _state_refs(metric)
        assert refs and all(r() is not None for r in refs)
        del metric
        assert all(r() is None for r in refs)
    finally:
        if was_enabled:
            gc.enable()


def test_update_on_a_temporary_metric_and_through_super():
    """The transactional ``update`` holds its metric while it runs, and an
    override reaches its parent's plain method through ``super()``."""
    classification.MulticlassAccuracy(num_classes=3, device="cpu").update(torch.tensor([0]), torch.tensor([0]))

    class Doubled(tm.SumMetric):
        def update(self, value):
            super().update(2 * value)

        def compute(self):
            return super().compute() + 1

    m = Doubled(device="cpu")
    m.update(torch.tensor(3.0))
    assert m.update_count == 1 and float(m.compute()) == 7.0
    assert list(inspect.signature(m.update).parameters) == ["value"]


def test_compositional_metric_matches_jax():
    preds, target = np.array([0.2, 0.8, 0.3, 0.6], np.float32), np.array([0, 1, 1, 0])
    ref = jax_classification.BinaryAccuracy(executor=False) + jax_classification.BinaryPrecision(executor=False) * 2
    port = classification.BinaryAccuracy(device="cpu") + classification.BinaryPrecision(device="cpu") * 2
    assert isinstance(port, tm.CompositionalMetric)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _close(port.compute(), ref.compute())
    neg = -classification.BinaryAccuracy(device="cpu")
    neg.update(torch.from_numpy(preds), torch.from_numpy(target))
    _close(neg.compute(), -0.5)


def test_construction_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        classification.MulticlassAccuracy(num_classes=3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tm.MetricCollection([classification.MulticlassAccuracy(num_classes=3, device="cpu")])
    assert resolve_device("cpu") == torch.device("cpu")


def test_input_on_another_device_raises():
    m = classification.MulticlassAccuracy(num_classes=3, device="cpu")
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="never copied"):
        m.update(meta, meta)
    with pytest.raises(RuntimeError, match="never copied"):
        m.functional_update(m.functional_init(), meta, meta)
    assert m.update_count == 0


def test_sync_is_a_no_op_in_one_process_and_unported_in_many():
    m = classification.BinaryAccuracy(device="cpu")
    m.update(torch.tensor([0.9]), torch.tensor([1]))
    m.sync()  # no process group: nothing to do
    assert float(m.compute()) == 1.0
    # told a world exists where no process group was initialised, the sync
    # reaches torch.distributed, which refuses; the local state stays
    world = classification.BinaryAccuracy(device="cpu", distributed_available_fn=lambda: True)
    world.update(torch.tensor([0.9]), torch.tensor([1]))
    with pytest.raises(ValueError, match="process group has not been initialized"):
        world.compute()
    assert not world._is_synced and int(world.tp) == 1
    with pytest.raises(TorchMetricsUserError):
        m.unsync()


def test_compute_before_update_warns_and_bad_kwargs_raise():
    m = classification.BinaryAccuracy(device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m.compute()
    assert any("before the ``update``" in str(w.message) for w in caught)
    with pytest.raises(ValueError, match="Unexpected keyword"):
        classification.BinaryAccuracy(device="cpu", compiled=False)
    with pytest.raises(ValueError, match="`executor` to be a `bool`"):
        classification.BinaryAccuracy(device="cpu", executor="off")
    with pytest.raises(ValueError, match="dist_reduce_fx"):
        m.add_state("x", torch.tensor(0), dist_reduce_fx="median")
