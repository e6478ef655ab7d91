"""The port's wrappers against the JAX package.

The same seeded numpy inputs go through the JAX wrapper (its base metrics
eager, ``executor=False``) and through the port on the CPU. Tolerances:

- counts (every replicate's, output's or slot's stat scores): bit for bit;
- float values: within 1e-6; bootstrap quantiles within 1e-5 (both take
  linear interpolation in float32).

BootStrapper draws its resamples from ``np.random.RandomState(seed)`` in
both packages, so one seed gives the same resamples and the replicates are
compared one by one. The 2-rank gloo world at the end syncs BootStrapper's
and MultitaskWrapper's children and holds them to one process fed all the
data.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassJaccardIndex
from torchmetrics_tpu_torch.regression import MeanSquaredError
from torchmetrics_tpu_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    FeatureShare,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
    MultitaskWrapper,
    NetworkCache,
    Running,
)

ATOL = 1e-6
QTOL = 1e-5
C = 4


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu.wrappers as jax_wrappers

    return jnp, jax_tm, jax_wrappers


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, atol=ATOL):
    if isinstance(ref, dict):
        assert set(port) == set(ref), (sorted(port), sorted(ref))
        for k in ref:
            _close(port[k], ref[k], atol)
        return
    port, ref = _np(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol, equal_nan=True)


def _exact(port_state, ref_state):
    """Two states (dicts of arrays, possibly nested) equal bit for bit."""
    assert set(port_state) - {"_update_count"} == set(ref_state) - {"_update_count"}
    for k, v in ref_state.items():
        if k == "_update_count":
            continue
        if isinstance(v, dict):
            _exact(port_state[k], v)
        else:
            np.testing.assert_array_equal(_np(port_state[k]), np.asarray(v))


def _mc_batches(seed, sizes=(12, 1, 9)):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, C).astype(np.float32), rng.randint(0, C, n)) for n in sizes]


def _acc(jax_tm=None, **kw):
    if jax_tm is None:
        return MulticlassAccuracy(C, device="cpu", **kw)
    return jax_tm.classification.MulticlassAccuracy(C, executor=False, **kw)


# ----------------------------------------------------------------- BootStrapper


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrapper_replicates_match_jax(strategy):
    jnp, jax_tm, jw = _jax()
    q = [0.1, 0.5, 0.9]
    kw = dict(num_bootstraps=6, sampling_strategy=strategy, seed=3, raw=True)
    port = BootStrapper(_acc(average="macro"), quantile=q, **kw)
    ref = jw.BootStrapper(_acc(jax_tm, average="macro"), quantile=jnp.asarray(q), **kw)
    for preds, target in _mc_batches(1):
        port.update(torch.as_tensor(preds), torch.as_tensor(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    for p, r in zip(port.metrics, ref.metrics):
        assert p.update_count == r.update_count
        _exact(p.state(), r.state())
    got, want = port.compute(), ref.compute()
    _close({k: v for k, v in got.items() if k != "quantile"}, {k: v for k, v in want.items() if k != "quantile"})
    _close(got["quantile"], want["quantile"], QTOL)


def test_bootstrapper_skips_empty_poisson_resamples_like_jax():
    jnp, jax_tm, jw = _jax()
    port = BootStrapper(_acc(), num_bootstraps=8, seed=0)
    ref = jw.BootStrapper(_acc(jax_tm), num_bootstraps=8, seed=0)
    x, y = np.array([[0.1, 0.7, 0.1, 0.1]], np.float32), np.array([1])
    for _ in range(3):
        port.update(torch.as_tensor(x), torch.as_tensor(y))
        ref.update(jnp.asarray(x), jnp.asarray(y))
    counts = [m.update_count for m in port.metrics]
    assert counts == [m.update_count for m in ref.metrics]
    assert min(counts) < 3  # some replicate drew an empty resample and skipped it


def test_bootstrapper_indexes_on_the_inputs_device_without_numpy():
    port = BootStrapper(MeanSquaredError(device="cpu"), num_bootstraps=3, seed=1, sampling_strategy="multinomial")
    seen = []
    original = torch.Tensor.index_select
    try:
        torch.Tensor.index_select = lambda self, dim, index: seen.append(index.device) or original(self, dim, index)
        port.update(torch.rand(5), torch.rand(5))
    finally:
        torch.Tensor.index_select = original
    assert seen == [torch.device("cpu")] * 6


def test_bootstrapper_functional_indices_match_jax_and_the_stateful_path():
    jnp, jax_tm, jw = _jax()
    kw = dict(num_bootstraps=4, sampling_strategy="multinomial", quantile=0.5, raw=True)
    port = BootStrapper(_acc(average="macro"), **kw)
    ref = jw.BootStrapper(_acc(jax_tm, average="macro"), **kw)
    ps, rs = port.functional_init(), ref.functional_init()
    oo = [MulticlassAccuracy(C, average="macro", device="cpu") for _ in range(4)]
    rng = np.random.RandomState(9)
    for preds, target in _mc_batches(2, sizes=(10, 10)):
        idx = rng.randint(0, 10, (4, 10))
        ps = port.functional_update(ps, torch.as_tensor(preds), torch.as_tensor(target), indices=torch.as_tensor(idx))
        rs = ref.functional_update(rs, jnp.asarray(preds), jnp.asarray(target), indices=jnp.asarray(idx))
        for i, m in enumerate(oo):
            m.update(torch.as_tensor(preds[idx[i]]), torch.as_tensor(target[idx[i]]))
    _exact(ps, rs)
    for i, m in enumerate(oo):
        _exact({k: v[i] for k, v in ps.items()}, {k: v for k, v in m.state().items()})
    _close(port.functional_compute(ps), ref.functional_compute(rs), QTOL)
    merged = port.merge_states(ps, ps)
    _exact(merged, ref.merge_states(rs, rs))


def test_bootstrapper_functional_generator_key():
    port = BootStrapper(_acc(), num_bootstraps=3, sampling_strategy="multinomial")
    preds, target = _mc_batches(4, sizes=(8,))[0]
    state = port.functional_update(
        port.functional_init(), torch.as_tensor(preds), torch.as_tensor(target), key=torch.Generator().manual_seed(0)
    )
    assert int(state["tp"].sum() + state["fn"].sum()) == 3 * 8
    with pytest.raises(ValueError, match="key"):
        port.functional_update(port.functional_init(), torch.as_tensor(preds), torch.as_tensor(target))
    poisson = BootStrapper(_acc(), num_bootstraps=3)
    with pytest.raises(ValueError, match="multinomial"):
        poisson.functional_update(
            poisson.functional_init(), torch.as_tensor(preds), torch.as_tensor(target), key=torch.Generator()
        )


def test_bootstrapper_list_state_base_exports_replicates_like_jax():
    jnp, jax_tm, jw = _jax()
    port = BootStrapper(tm.CatMetric(device="cpu"), num_bootstraps=3, seed=5)
    ref = jw.BootStrapper(jax_tm.CatMetric(executor=False), num_bootstraps=3, seed=5, raw=True)
    x = np.arange(6, dtype=np.float32)
    port.update(torch.as_tensor(x))
    ref.update(jnp.asarray(x))
    ps, rs = port.state(), ref.state()
    assert set(ps) == set(rs) == {"replicates"}
    for p, r in zip(ps["replicates"], rs["replicates"]):
        assert len(p["value"]) == len(r["value"])
        for a, b in zip(p["value"], r["value"]):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    fresh = BootStrapper(tm.CatMetric(device="cpu"), num_bootstraps=3)
    fresh.load_state(ps)
    for a, b in zip(fresh.metrics, port.metrics):
        assert torch.equal(a.compute(), b.compute())
    with pytest.raises(ValueError, match="replicate"):
        BootStrapper(tm.CatMetric(device="cpu"), num_bootstraps=2).load_state(ps)
    with pytest.raises(ValueError, match="list"):
        port.functional_init()


def test_bootstrapper_stacked_state_round_trips_and_jax_state_loads():
    jnp, jax_tm, jw = _jax()
    ref = jw.BootStrapper(_acc(jax_tm), num_bootstraps=5, seed=2)
    for preds, target in _mc_batches(6):
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    exported = {k: torch.as_tensor(np.asarray(v)) for k, v in ref.state().items()}
    port = BootStrapper(_acc(), num_bootstraps=5)
    port.load_state(exported)
    _close(port.compute(), ref.compute())
    again = BootStrapper(_acc(), num_bootstraps=5)
    again.load_state(port.state())
    _close(again.compute(), ref.compute())
    with pytest.raises(ValueError, match="leading dimension"):
        BootStrapper(_acc(), num_bootstraps=4).load_state(port.state())


def test_bootstrapper_arguments_are_validated_like_jax():
    with pytest.raises(ValueError, match="base metric"):
        BootStrapper(lambda x: x)
    with pytest.raises(ValueError, match="sampling_strategy"):
        BootStrapper(_acc(), sampling_strategy="gauss")
    with pytest.raises(ValueError, match="any tensor"):
        BootStrapper(tm.SumMetric(device="cpu")).update(2.0)


def test_wrapper_lives_on_its_base_device():
    base = _acc()
    assert BootStrapper(base).device == base.device == Running(_acc()).device
    for build in (
        lambda d: BootStrapper(_acc(), device=d),
        lambda d: MinMaxMetric(_acc(), device=d),
        lambda d: Running(_acc(), device=d),
        lambda d: ClasswiseWrapper(_acc(average=None), device=d),
        lambda d: MultioutputWrapper(MeanSquaredError(device="cpu"), 2, device=d),
        lambda d: MultitaskWrapper({"a": _acc()}, device=d),
    ):
        assert build("cpu").device == torch.device("cpu")
        with pytest.raises(ValueError, match="base metric's device"):
            build("meta")


# ----------------------------------------------------------------- Running


@pytest.mark.parametrize("window", [1, 3])
def test_running_matches_jax_and_its_ring_state(window):
    jnp, jax_tm, jw = _jax()
    port, ref = Running(_acc(), window=window), jw.Running(_acc(jax_tm), window=window)
    port_mean, ref_mean = Running(tm.MeanMetric(device="cpu"), window=window), jw.Running(
        jax_tm.MeanMetric(executor=False), window=window
    )
    for i, (preds, target) in enumerate(_mc_batches(7, sizes=(6, 9, 3, 7))):
        if i % 2:
            _close(port(torch.as_tensor(preds), torch.as_tensor(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
        else:
            port.update(torch.as_tensor(preds), torch.as_tensor(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        port_mean.update(torch.as_tensor(preds[:, 0]))
        ref_mean.update(jnp.asarray(preds[:, 0]))
        _close(port.compute(), ref.compute())
        _close(port_mean.compute(), ref_mean.compute())
    ps, rs = port.state(), ref.state()
    assert int(ps["count"]) == int(rs["count"])
    _exact(ps["slots"], rs["slots"])
    restored = Running(_acc(), window=window)
    restored.load_state({"slots": {k: torch.as_tensor(np.asarray(v)) for k, v in rs["slots"].items()}, "count": torch.as_tensor(np.asarray(rs["count"]))})
    _close(restored.compute(), ref.compute())
    assert restored.update_count == port.update_count


def test_running_count_fallback_and_smaller_window_like_jax():
    jnp, jax_tm, jw = _jax()
    port, ref = Running(tm.SumMetric(device="cpu"), window=5), jw.Running(jax_tm.SumMetric(executor=False), window=5)
    for v in (1.0, 2.0, 3.0):
        port.update(v)
        ref.update(v)
    for m in (port, ref):
        m.load_state(m.state(), update_count=50)  # a lifetime count beyond the ring's fill
    assert int(port.state()["count"]) == int(ref.state()["count"]) == 3
    for window in (1, 2, 5):
        small, small_ref = Running(tm.SumMetric(device="cpu"), window=window), jw.Running(jax_tm.SumMetric(executor=False), window=window)
        small.load_state(port.state())
        small_ref.load_state(ref.state())
        _close(small.compute(), small_ref.compute())


def test_running_functional_path_matches_jax():
    jnp, jax_tm, jw = _jax()
    port, ref = Running(tm.MeanMetric(device="cpu"), window=3), jw.Running(jax_tm.MeanMetric(executor=False), window=3)
    ps, rs = port.functional_init(), ref.functional_init()
    _close(port.functional_compute(ps), ref.functional_compute(rs))
    for v in (1.0, 4.0, 2.0, 8.0):
        ps, pv = port.functional_forward(ps, torch.tensor([v, v + 1]))
        rs, rv = ref.functional_forward(rs, jnp.asarray([v, v + 1]))
        _close(pv, rv)
        _close(port.functional_compute(ps), ref.functional_compute(rs))
    _exact(ps["slots"], rs["slots"])
    with pytest.raises(NotImplementedError):
        port.merge_states(ps, ps)
    with pytest.raises(ValueError, match="full_state_update"):
        Running(BootStrapper(_acc()))
    with pytest.raises(ValueError, match="window"):
        Running(_acc(), window=0)


def test_running_list_state_base_exports_snapshots():
    port = Running(tm.CatMetric(device="cpu"), window=2)
    for v in ([1.0], [2.0, 3.0], [4.0]):
        port.update(torch.tensor(v))
    state = port.state()
    assert len(state["snapshots"]) == 2 and int(state["count"]) == 3
    fresh = Running(tm.CatMetric(device="cpu"), window=2)
    fresh.load_state(state)
    assert fresh.compute().tolist() == port.compute().tolist() == [2.0, 3.0, 4.0]


# ----------------------------------------------------------------- MinMax


def test_minmax_after_forwards_is_the_accumulation_like_jax():
    jnp, jax_tm, jw = _jax()
    port, ref = MinMaxMetric(_acc()), jw.MinMaxMetric(_acc(jax_tm))
    for preds, target in _mc_batches(8, sizes=(5, 9, 4, 11)):
        _close(port(torch.as_tensor(preds), torch.as_tensor(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
    _close(port.compute(), ref.compute())
    ps, rs = port.state(), ref.state()
    _exact(ps["base"], rs["base"])
    assert int(ps["count"]) == int(rs["count"]) == 4
    fresh = MinMaxMetric(_acc())
    fresh.load_state({k: (v if k == "base" else torch.as_tensor(np.asarray(rs[k]))) for k, v in ps.items()})
    _close(fresh.compute(), ref.compute())


def test_minmax_functional_path_matches_jax():
    jnp, jax_tm, jw = _jax()
    port, ref = MinMaxMetric(tm.MeanMetric(device="cpu")), jw.MinMaxMetric(jax_tm.MeanMetric(executor=False))
    ps, rs = port.functional_init(), ref.functional_init()
    for i, v in enumerate((3.0, 1.0, 5.0)):
        if i == 1:
            ps, rs = port.functional_update(ps, torch.tensor([v, 2 * v])), ref.functional_update(rs, jnp.asarray([v, 2 * v]))
        else:
            (ps, pv), (rs, rv) = port.functional_forward(ps, torch.tensor([v, 2 * v])), ref.functional_forward(rs, jnp.asarray([v, 2 * v]))
            _close(pv, rv)
    _close(port.functional_compute(ps), ref.functional_compute(rs))
    _close(port.functional_compute(port.merge_states(ps, port.functional_init())), ref.functional_compute(ref.merge_states(rs, ref.functional_init())))


def test_minmax_check_scalar():
    assert MinMaxMetric._check_scalar(torch.tensor([2.0])).shape == ()
    with pytest.raises(RuntimeError, match="scalar"):
        MinMaxMetric(_acc(average=None)).update(torch.rand(3, C), torch.tensor([0, 1, 2])) or MinMaxMetric._check_scalar(torch.ones(3))


# ----------------------------------------------------------------- MetricTracker


def test_tracker_best_metric_with_a_maximize_list_matches_jax():
    jnp, jax_tm, jw = _jax()

    def coll(pkg):
        if pkg is None:
            return tm.MetricCollection({"acc": _acc(), "iou": MulticlassJaccardIndex(C, device="cpu")}, device="cpu")
        return pkg.MetricCollection(
            {"acc": _acc(pkg), "iou": pkg.classification.MulticlassJaccardIndex(C, executor=False)}
        )

    port, ref = MetricTracker(coll(None), maximize=[True, False]), jw.MetricTracker(coll(jax_tm), maximize=[True, False])
    for epoch in range(3):
        port.increment()
        ref.increment()
        for preds, target in _mc_batches(20 + epoch):
            scores = preds + (epoch % 2) * np.eye(C, dtype=np.float32)[target]
            port.update(torch.as_tensor(scores), torch.as_tensor(target))
            ref.update(jnp.asarray(scores), jnp.asarray(target))
    _close(port.compute_all(), ref.compute_all())
    got_v, got_s = port.best_metric(return_step=True)
    want_v, want_s = ref.best_metric(return_step=True)
    assert got_s == want_s
    _close({k: np.float32(v) for k, v in got_v.items()}, {k: np.float32(v) for k, v in want_v.items()})
    assert port.n_steps == 3


def test_tracker_warns_on_a_vector_value_like_jax():
    jnp, jax_tm, jw = _jax()
    port, ref = MetricTracker(_acc(average=None)), jw.MetricTracker(_acc(jax_tm, average=None))
    for _ in range(2):
        port.increment()
        ref.increment()
        preds, target = _mc_batches(3, sizes=(12,))[0]
        port.update(torch.as_tensor(preds), torch.as_tensor(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    for tracker in (port, ref):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert tracker.best_metric(return_step=True) == (None, None)
        assert any("best metric" in str(w.message) for w in caught)


def test_tracker_state_round_trip_and_errors():
    port = MetricTracker(_acc())
    with pytest.raises(ValueError, match="increment"):
        port.update(torch.rand(2, C), torch.tensor([0, 1]))
    for _ in range(2):
        port.increment()
        port.update(*map(torch.as_tensor, _mc_batches(5, sizes=(8,))[0]))
    fresh = MetricTracker(_acc())
    fresh.load_state(port.state())
    assert torch.equal(fresh.compute_all(), port.compute_all())
    with pytest.raises(ValueError, match="single bool"):
        MetricTracker(_acc(), maximize=[True])
    with pytest.raises(TypeError):
        MetricTracker(lambda x: x)


def test_tracker_plot_draws_every_step():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    tracker = MetricTracker(_acc())
    for _ in range(3):
        tracker.increment()
        tracker.update(*map(torch.as_tensor, _mc_batches(6, sizes=(8,))[0]))
    fig, ax = tracker.plot()
    assert fig is not None and ax is not None


# ----------------------------------------------------------------- Classwise, Multitask, Multioutput


@pytest.mark.parametrize("labels,prefix,postfix", [(None, None, None), (["a", "b", "c", "d"], None, None), (None, "p_", None), (["a", "b", "c", "d"], None, "_q")])
def test_classwise_names_match_jax(labels, prefix, postfix):
    jnp, jax_tm, jw = _jax()
    port = ClasswiseWrapper(_acc(average=None), labels=labels, prefix=prefix, postfix=postfix)
    ref = jw.ClasswiseWrapper(_acc(jax_tm, average=None), labels=labels, prefix=prefix, postfix=postfix)
    preds, target = _mc_batches(10, sizes=(16,))[0]
    _close(port(torch.as_tensor(preds), torch.as_tensor(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
    _close(port.compute(), ref.compute())
    _close(port.functional_compute(port.state()), ref.compute())
    with pytest.raises(ValueError, match="labels"):
        ClasswiseWrapper(_acc(average=None), labels=[1, 2])


def _tasks(pkg):
    if pkg is None:
        return {
            "seg": tm.MetricCollection(
                {"miou": MulticlassJaccardIndex(C, device="cpu"), "acc": _acc(average="micro")}, device="cpu"
            ),
            "depth": MeanSquaredError(device="cpu"),
        }
    return {
        "seg": pkg.MetricCollection(
            {"miou": pkg.classification.MulticlassJaccardIndex(C, executor=False), "acc": _acc(pkg, average="micro")}
        ),
        "depth": pkg.regression.MeanSquaredError(executor=False),
    }


def test_multitask_matches_jax_and_refuses_key_mismatches():
    jnp, jax_tm, jw = _jax()
    port, ref = MultitaskWrapper(_tasks(None)), jw.MultitaskWrapper(_tasks(jax_tm))
    rng = np.random.RandomState(12)
    for n in (7, 5):
        preds = {"seg": rng.rand(n, C).astype(np.float32), "depth": rng.rand(n).astype(np.float32)}
        target = {"seg": rng.randint(0, C, n), "depth": rng.rand(n).astype(np.float32)}
        _close(
            port({k: torch.as_tensor(v) for k, v in preds.items()}, {k: torch.as_tensor(v) for k, v in target.items()}),
            ref({k: jnp.asarray(v) for k, v in preds.items()}, {k: jnp.asarray(v) for k, v in target.items()}),
        )
    _close(port.compute(), ref.compute())
    bad = {"seg": torch.rand(2, C)}
    for wrapper, conv in ((port, torch.as_tensor), (ref, jnp.asarray)):
        with pytest.raises(ValueError, match="same keys"):
            wrapper.update(bad, {"seg": conv(np.array([0, 1])), "depth": conv(np.zeros(2))})
        with pytest.raises(ValueError, match="same keys"):
            wrapper.functional_update(wrapper.functional_init(), bad, bad)
    with pytest.raises(TypeError):
        MultitaskWrapper([_acc()])
    with pytest.raises(TypeError):
        MultitaskWrapper({"a": lambda x: x})
    assert list(port.clone(prefix="t_").keys()) == ["t_seg", "t_depth"]


def _multioutput_data(seed, n=9, outputs=3):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n, outputs).astype(np.float32)
    target = rng.rand(n, outputs).astype(np.float32)
    preds[rng.rand(n, outputs) < 0.15] = np.nan
    target[rng.rand(n, outputs) < 0.15] = np.nan
    return preds, target


def test_multioutput_drops_nan_rows_like_jax():
    jnp, jax_tm, jw = _jax()
    port = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=3)
    ref = jw.MultioutputWrapper(jax_tm.regression.MeanSquaredError(executor=False), num_outputs=3)
    for seed in (1, 2):
        preds, target = _multioutput_data(seed)
        _close(port(torch.as_tensor(preds), torch.as_tensor(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
    _close(port.compute(), ref.compute())
    for p, r in zip(port.metrics, ref.metrics):
        assert int(p.total) == int(r.total)  # the rows kept
        _close(p.sum_squared_error, r.sum_squared_error)


def test_multioutput_functional_path_matches_jax():
    jnp, jax_tm, jw = _jax()
    port = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=3, remove_nans=False)
    ref = jw.MultioutputWrapper(jax_tm.regression.MeanSquaredError(executor=False), num_outputs=3, remove_nans=False)
    ps, rs = port.functional_init(), ref.functional_init()
    for seed in (3, 4):
        preds, target = (np.nan_to_num(x) for x in _multioutput_data(seed))
        ps = port.functional_update(ps, torch.as_tensor(preds), torch.as_tensor(target))
        rs = ref.functional_update(rs, jnp.asarray(preds), jnp.asarray(target))
    _close(port.functional_compute(ps), ref.functional_compute(rs))
    port.load_state({**ps, "_update_count": torch.tensor([2, 2, 2])})
    _close(port.compute(), ref.functional_compute(rs))
    with pytest.raises(ValueError, match="remove_nans"):
        MultioutputWrapper(MeanSquaredError(device="cpu"), 3).functional_update(ps, torch.rand(2, 3), torch.rand(2, 3))
    with pytest.raises(ValueError, match="outputs"):
        port.functional_update(ps, torch.rand(2, 4), torch.rand(2, 4))


# ----------------------------------------------------------------- FeatureShare


def test_feature_share_calls_the_extractor_once_a_batch():
    calls = []

    def extractor(x):
        calls.append(x.shape[0])
        return x.mean(dim=(2, 3))

    members = [
        tm.FrechetInceptionDistance(feature_extractor=extractor, num_features=3, device="cpu"),
        tm.KernelInceptionDistance(feature_extractor=extractor, subsets=2, subset_size=3, device="cpu"),
        tm.MemorizationInformedFrechetInceptionDistance(feature_extractor=extractor, device="cpu"),
    ]
    fs = FeatureShare(members)
    alone = [
        tm.FrechetInceptionDistance(feature_extractor=lambda x: x.mean(dim=(2, 3)), num_features=3, device="cpu"),
        tm.KernelInceptionDistance(feature_extractor=lambda x: x.mean(dim=(2, 3)), subsets=2, subset_size=3, device="cpu"),
        tm.MemorizationInformedFrechetInceptionDistance(feature_extractor=lambda x: x.mean(dim=(2, 3)), device="cpu"),
    ]
    g = torch.Generator().manual_seed(0)
    for real in (True, False, True, False):
        imgs = torch.rand(6, 3, 4, 4, generator=g)
        fs.update(imgs, real=real)
        for m in alone:
            m.update(imgs, real=real)
    assert calls == [6] * 4
    got = fs.compute()
    for m in alone:
        want = m.compute()
        name = type(m).__name__
        if isinstance(want, tuple):
            for a, b in zip(got[f"{name}_mean"] if f"{name}_mean" in got else got[name], want):
                assert torch.equal(torch.as_tensor(a), b)
        else:
            assert torch.equal(got[name], want)
    with pytest.raises(AttributeError, match="feature_extractor"):
        FeatureShare([_acc()])
    with pytest.raises(TypeError, match="max_cache_size"):
        FeatureShare(members, max_cache_size=1.5)


def test_network_cache_evicts_the_oldest_entry():
    calls = []
    cache = NetworkCache(lambda x: calls.append(id(x)) or x * 2, max_size=2)
    a, b, c = torch.ones(2), torch.ones(3), torch.ones(4)
    for x in (a, b, a, c, a, b):
        cache(x)
    # a hit refreshes an entry: b (the oldest) goes when c arrives, then returns as new
    assert calls == [id(a), id(b), id(c), id(b)]
    assert len(cache._cache) == 2


# ----------------------------------------------------------------- two-rank sync


def _sync_data(rank):
    return _mc_batches(40 + rank, sizes=(10, 6))


def _sync_target(rank, world):
    boot = BootStrapper(_acc(), num_bootstraps=4, sampling_strategy="multinomial")
    mt = MultitaskWrapper(_tasks(None))
    boot_state = boot.functional_init()
    rng = np.random.RandomState(100 + rank)
    for preds, target in _sync_data(rank):
        idx = torch.as_tensor(rng.randint(0, preds.shape[0], (4, preds.shape[0])))
        for i, m in enumerate(boot.metrics):
            m.update(torch.as_tensor(preds)[idx[i]], torch.as_tensor(target)[idx[i]])
        boot_state = boot.functional_update(boot_state, torch.as_tensor(preds), torch.as_tensor(target), indices=idx)
        mt.update({"seg": torch.as_tensor(preds), "depth": torch.as_tensor(preds[:, 0])},
                  {"seg": torch.as_tensor(target), "depth": torch.as_tensor(preds[:, 1])})
    return {
        "boot": {k: v.tolist() for k, v in boot.compute().items()},
        "boot_functional": {k: v.tolist() for k, v in boot.functional_compute(boot.functional_sync(boot_state)).items()},
        "multitask": {k: ({kk: float(vv) for kk, vv in v.items()} if isinstance(v, dict) else float(v)) for k, v in mt.compute().items()},
    }


def test_children_sync_to_the_one_process_result(tmp_path):
    from helpers.torch_world import run_world

    results = run_world(2, tmp_path, _sync_target)
    boot = BootStrapper(_acc(), num_bootstraps=4, sampling_strategy="multinomial")
    mt = MultitaskWrapper(_tasks(None))
    for rank in range(2):
        rng = np.random.RandomState(100 + rank)
        for preds, target in _sync_data(rank):
            idx = rng.randint(0, preds.shape[0], (4, preds.shape[0]))
            for i, m in enumerate(boot.metrics):
                m.update(torch.as_tensor(preds[idx[i]]), torch.as_tensor(target[idx[i]]))
            mt.update({"seg": torch.as_tensor(preds), "depth": torch.as_tensor(preds[:, 0])},
                      {"seg": torch.as_tensor(target), "depth": torch.as_tensor(preds[:, 1])})
    want_boot = {k: v.tolist() for k, v in boot.compute().items()}
    want_mt = mt.compute()
    for res in results:
        for key in ("boot", "boot_functional"):
            _close({k: np.asarray(v) for k, v in res[key].items()}, {k: np.asarray(v) for k, v in want_boot.items()})
        _close(
            {"seg": res["multitask"]["seg"], "depth": res["multitask"]["depth"]},
            {"seg": {k: float(v) for k, v in want_mt["seg"].items()}, "depth": float(want_mt["depth"])},
        )
