"""The port's aggregators (``torchmetrics_tpu_torch/aggregation.py``) against
the JAX package.

Every aggregator under every ``nan_strategy`` ("error", "warn", "ignore",
"disable" and a float replacement), fed the same numpy batches with and
without NaNs (in the values, and in MeanMetric's weights): computed values
within rtol 1e-6, the same exceptions and warnings, the same state dtypes,
and the same batch values from ``forward`` for the five accumulating
aggregators (RunningMean's and RunningSum's ``forward`` stacks their window
with its ``None`` reduction and fails on the second call in both packages).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jax_tm
import torchmetrics_tpu_torch as tm

AGGREGATORS = ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric", "RunningMean", "RunningSum")
STRATEGIES = ("error", "warn", "ignore", "disable", 0.5)


def _batches(seed, nan):
    rng = np.random.RandomState(seed)
    out = []
    for n in (5, 1, 7):
        x = rng.randn(n).astype(np.float32)
        if nan:
            x[rng.rand(n) < 0.3] = np.nan
            x[0] = np.nan
        out.append(x)
    return out


def _pair(name, strategy, **kw):
    extra = {"window": 2} if name.startswith("Running") else {}
    return (
        getattr(tm, name)(nan_strategy=strategy, device="cpu", **extra, **kw),
        getattr(jax_tm, name)(nan_strategy=strategy, executor=False, **extra, **kw),
    )


def _close(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (port, ref)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0, equal_nan=True)


def _run(metric, batches, as_tensor):
    """Update on every batch; what escaped (error, warnings) and the value."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            for x in batches:
                metric.update(as_tensor(x))
        except RuntimeError as err:
            return ("raised", str(err)), []
        value = metric.compute()
    nan_warnings = sorted({str(w.message) for w in caught if "nan" in str(w.message)})
    return value, nan_warnings


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregator_matches_jax(name, strategy, nan):
    port, ref = _pair(name, strategy)
    batches = _batches(len(name), nan)
    port_value, port_warned = _run(port, batches, torch.from_numpy)
    ref_value, ref_warned = _run(ref, batches, jnp.asarray)
    assert port_warned == ref_warned
    if isinstance(ref_value, tuple):
        assert port_value == ref_value
        return
    _close(port_value, ref_value)
    for field, value in port.metric_state.items():
        want = ref.metric_state[field]
        if isinstance(value, list):
            assert len(value) == len(want)
        else:
            _close(value, want)


@pytest.mark.parametrize("strategy", ["ignore", "disable", 2.0])
def test_weighted_mean_with_nan_weights_matches_jax(strategy):
    port, ref = _pair("MeanMetric", strategy)
    rng = np.random.RandomState(3)
    for _ in range(3):
        x, w = rng.randn(6).astype(np.float32), rng.rand(6).astype(np.float32)
        x[1], w[2] = np.nan, np.nan
        port.update(torch.from_numpy(x), torch.from_numpy(w))
        ref.update(jnp.asarray(x), jnp.asarray(w))
    _close(port.compute(), ref.compute())
    _close(port.weight, ref.weight)


@pytest.mark.parametrize("name", AGGREGATORS[:5])
def test_forward_batch_values_match_jax(name):
    port, ref = _pair(name, "ignore")
    for x in _batches(7, nan=True):
        _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))
    _close(port.compute(), ref.compute())
    assert port.update_count == ref.update_count == 3


@pytest.mark.parametrize("name", ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric"])
def test_scalars_and_empty_inputs_match_jax(name):
    port, ref = _pair(name, "warn")
    for x in (2.5, np.zeros(0, np.float32), np.asarray([1.0, -3.0], np.float32)):
        port.update(torch.as_tensor(x))
        ref.update(jnp.asarray(x))
    _close(port.compute(), ref.compute())


def test_windows_keep_the_last_updates():
    port, ref = _pair("RunningMean", "warn")
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        port.update(torch.tensor([v, v + 1]))
        ref.update(jnp.asarray([v, v + 1]))
    _close(port.compute(), ref.compute())
    assert float(port.compute()) == 5.0
    _close(port.mask, ref.mask)
    _close(port.values, ref.values)


def test_invalid_nan_strategy_raises_like_jax():
    for name in AGGREGATORS:
        with pytest.raises(ValueError):
            getattr(tm, name)(nan_strategy="drop", device="cpu")
        if not name.startswith("Running"):  # the JAX package checks RunningMean's only when it filters
            with pytest.raises(ValueError):
                getattr(jax_tm, name)(nan_strategy="drop", executor=False)


def test_exported_at_the_top_level():
    for name in AGGREGATORS:
        assert name in tm.__all__ and name in jax_tm.__all__
