"""The port's bounded sync and its ``on_sync_failure`` policies, against the
JAX package's fault-containment scenarios.

The JAX package's scenarios (``tests/test_fault_containment.py``,
``test_durability.py``, ``test_lane_faults.py``) hang, break or flake its
multi-host gather seam; here each one is replayed on both packages, the
port's in a one-rank gloo world in this process with its collective seams
(``parallel.sync._all_reduce`` and ``_all_gather``) patched the same way
(``testing.faults.hang_sync``/``break_sync``/``flaky_sync``),
and the outcomes (value, exception, warning, ``last_sync_ok``, the state
after the failure) must be the same. Only symmetric faults are replayed: a
fault on one rank only leaves the collectives out of step in both packages.
"""
from __future__ import annotations

import warnings
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.io import retry as retry_mod
from torchmetrics_tpu_torch.parallel import sync as psync
from torchmetrics_tpu_torch.testing import faults
from torchmetrics_tpu_torch.quarantine import DegradedValue


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """A one-rank gloo world in this process, torn down after the module."""
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


class _Port:
    name = "port"

    def metric(self, cls_name, **kw):
        return getattr(tm, cls_name)(device="cpu", **kw)

    def x(self, values):
        return torch.tensor(values, dtype=torch.float32)

    def value(self, v):
        return float(v)

    def state(self, m, field):
        return float(m._state[field])

    def hang(self):
        return faults.hang_sync(seconds=None)

    def broken(self):
        return faults.break_sync()

    def flaky(self, fail_n):
        return faults.flaky_sync(fail_n=fail_n)


class _Jax:
    name = "jax"

    def metric(self, cls_name, **kw):
        import torchmetrics_tpu as jax_tm

        return getattr(jax_tm, cls_name)(executor=False, distributed_available_fn=lambda: True, **kw)

    def x(self, values):
        import jax.numpy as jnp

        return jnp.asarray(values, dtype=jnp.float32)

    def value(self, v):
        return float(np.asarray(v))

    def state(self, m, field):
        return float(np.asarray(m._state[field]))

    def hang(self):
        from torchmetrics_tpu.testing import faults

        return faults.hang_sync(seconds=5.0)

    def broken(self):
        from torchmetrics_tpu.testing import faults

        return faults.break_sync()

    def flaky(self, fail_n):
        from torchmetrics_tpu.testing import faults

        return faults.flaky_sync(fail_n=fail_n)


@contextmanager
def _recorded():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield caught


def _warned(caught):
    return sorted(
        {("local-only" if "local-only" in str(w.message) else "last-good")
         for w in caught if w.category.__name__ == "TorchMetricsUserWarning"}
    )


def _raised(fn):
    try:
        fn()
    except Exception as err:  # the outcome under test is which error escapes
        return "timeout" if type(err).__name__ == "SyncTimeoutError" else "fault"
    return None


# ---------------------------------------------------------------- scenarios


def _timeout_raise(fw):
    m = fw.metric("SumMetric", nan_strategy="ignore", sync_timeout=0.2, on_sync_failure="raise")
    m.update(fw.x([1.0, 2.0]))
    with fw.hang():
        raised = _raised(m.compute)
    intact = (fw.state(m, "sum_value"), m.update_count, m._is_synced, m._cache is None)
    return {"raised": raised, "intact": intact, "healed": fw.value(m.compute())}


def _timeout_local(fw):
    m = fw.metric("SumMetric", nan_strategy="ignore", sync_timeout=0.2, on_sync_failure="local")
    m.update(fw.x([1.0, 2.0]))
    with fw.hang(), _recorded() as caught:
        value = fw.value(m.compute())
    degraded_ok = m.last_sync_ok
    m._computed = None
    healed = fw.value(m.compute())
    return {"value": value, "warned": _warned(caught), "ok": (degraded_ok, m.last_sync_ok), "healed": healed}


def _broken_local(fw):
    m = fw.metric("SumMetric", nan_strategy="ignore", on_sync_failure="local")
    m.update(fw.x([4.0]))
    with fw.broken(), _recorded() as caught:
        value = fw.value(m.compute())
    return {"value": value, "warned": _warned(caught), "ok": m.last_sync_ok}


def _broken_raise(fw):
    m = fw.metric("SumMetric", nan_strategy="ignore", on_sync_failure="raise")
    m.update(fw.x([4.0]))
    with fw.broken():
        raised = _raised(m.compute)
    return {"raised": raised, "state": fw.state(m, "sum_value"), "synced": m._is_synced, "count": m.update_count}


def _retry_recovers(fw):
    m = fw.metric("MeanMetric", on_sync_failure="retry", sync_retries=3)
    m.update(fw.x([2.0, 4.0]))
    with fw.flaky(2) as counters:
        m.sync()
        synced = fw.state(m, "mean_value")
        m.unsync()
    return {
        "failures": counters["failures"], "retried": counters["attempts"] > 2,
        "ok": m.last_sync_ok, "synced": synced, "value": fw.value(m.compute()),
    }


def _retry_exhausted(fw):
    m = fw.metric("MeanMetric", on_sync_failure="retry", sync_retries=1)
    m.update(fw.x([2.0, 4.0]))
    with fw.flaky(100):
        raised = _raised(m.sync)
    return {"raised": raised, "state": fw.state(m, "mean_value"), "synced": m._is_synced}


def _last_good(fw):
    m = fw.metric("SumMetric", nan_strategy="disable", on_sync_failure="last_good")
    m.update(fw.x([1.0, 2.0]))
    first = fw.value(m.compute())
    m.update(fw.x([4.0]))
    m._computed = None
    with fw.broken(), _recorded() as caught:
        dv = m.compute()
    degraded = (type(dv).__name__, fw.value(dv.value), dv.updates_behind, dv.age_updates, m.last_sync_ok)
    m._computed = None
    return {"first": first, "degraded": degraded, "warned": _warned(caught), "healed": (fw.value(m.compute()), m.last_sync_ok)}


def _last_good_without_cache(fw):
    m = fw.metric("SumMetric", nan_strategy="disable", on_sync_failure="last_good")
    m.update(fw.x([1.0, 2.0]))
    with fw.broken(), _recorded() as caught:
        v = m.compute()
    return {"degraded": type(v).__name__ == "DegradedValue", "value": fw.value(v), "warned": _warned(caught)}


def _gather_timeout(fw):
    m = fw.metric("CatMetric", nan_strategy="ignore", sync_timeout=0.2, on_sync_failure="raise")
    m.update(fw.x([1.0, 2.0]))
    with fw.hang():
        raised = _raised(m.compute)
    return {"raised": raised, "healed": [float(v) for v in np.asarray(m.compute())]}


SCENARIOS = {
    "timeout_raise": _timeout_raise,
    "timeout_local": _timeout_local,
    "broken_local": _broken_local,
    "broken_raise": _broken_raise,
    "retry_recovers": _retry_recovers,
    "retry_exhausted": _retry_exhausted,
    "last_good": _last_good,
    "last_good_without_cache": _last_good_without_cache,
    "gather_timeout": _gather_timeout,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_failure_policy_matches_jax(gloo_world, scenario):
    port = SCENARIOS[scenario](_Port())
    ref = SCENARIOS[scenario](_Jax())
    assert port == ref


def test_scenarios_show_each_policy(gloo_world):
    """What the matched outcomes are, so a scenario that silently stopped
    failing in both packages cannot pass."""
    fw = _Port()
    assert _timeout_raise(fw) == {"raised": "timeout", "intact": (3.0, 1, False, True), "healed": 3.0}
    assert _timeout_local(fw) == {"value": 3.0, "warned": ["local-only"], "ok": (False, True), "healed": 3.0}
    assert _broken_raise(fw)["raised"] == "fault"
    assert _retry_recovers(fw)["failures"] == 2 and _retry_recovers(fw)["ok"]
    assert _retry_exhausted(fw) == {"raised": "fault", "state": 6.0, "synced": False}
    assert _last_good(fw)["degraded"] == ("DegradedValue", 3.0, 1, 1, False)
    assert _last_good_without_cache(fw) == {"degraded": False, "value": 3.0, "warned": ["local-only"]}
    assert _gather_timeout(fw)["raised"] == "timeout"


def test_degraded_value_is_the_packages_shape(gloo_world):
    from torchmetrics_tpu.quarantine import DegradedValue as JaxDegradedValue

    assert DegradedValue._fields == JaxDegradedValue._fields


def test_kwarg_validation_matches_jax():
    import torchmetrics_tpu as jax_tm

    for kw, match in (
        ({"sync_timeout": -1}, "sync_timeout"),
        ({"on_sync_failure": "give_up"}, "on_sync_failure"),
        ({"sync_retries": -2}, "sync_retries"),
        ({"dist_sync_fn": 3}, "dist_sync_fn"),
    ):
        with pytest.raises(ValueError, match=match):
            tm.SumMetric(device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jax_tm.SumMetric(executor=False, **kw)


def test_environment_defaults(monkeypatch):
    from torchmetrics_tpu.io import retry as jax_retry
    from torchmetrics_tpu.parallel import sync as jax_sync

    monkeypatch.setenv(psync.SYNC_TIMEOUT_ENV, "2.5")
    assert tm.SumMetric(device="cpu").sync_timeout == 2.5 == jax_sync.default_sync_timeout()
    monkeypatch.setenv(psync.SYNC_TIMEOUT_ENV, "0")
    assert psync.default_sync_timeout() is None is jax_sync.default_sync_timeout()
    monkeypatch.setenv(retry_mod.SYNC_RETRIES_ENV, "7")
    assert retry_mod.default_sync_retries() == 7 == jax_retry.default_sync_retries()
    monkeypatch.setenv(retry_mod.SYNC_RETRIES_ENV, "bogus")
    with pytest.raises(ValueError):
        retry_mod.default_sync_retries()
    assert list(retry_mod.backoff_delays(retry_mod.RetryPolicy(max_retries=4, base_delay=0.1, jitter=0.0))) == list(
        jax_retry.backoff_delays(jax_retry.RetryPolicy(max_retries=4, base_delay=0.1, jitter=0.0))
    )


def test_a_state_the_backend_cannot_take_raises(gloo_world, monkeypatch):
    """A CPU state under an NCCL group raises, naming the backend and the
    device, before any collective (the backend read is patched: this process
    has no NCCL)."""
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    m = tm.SumMetric(device="cpu")
    m.update(torch.tensor([1.0]))
    before = psync.all_reduces + psync.all_gathers
    with pytest.raises(RuntimeError, match="'nccl' backend cannot take tensors on cpu"):
        psync.sync_states(m.metric_state, m._reductions, device="cpu")
    assert psync.all_reduces + psync.all_gathers == before
    with pytest.raises(RuntimeError, match="nccl"):
        m.compute()
    assert float(m.sum_value) == 1.0 and not m._is_synced


def test_sync_never_writes_the_states_it_reads(gloo_world):
    """The reduce runs on a fresh buffer, even for a group of one field:
    the tensors a sync reads (a follower's shared state, unsync's cache)
    keep their values and identity."""
    m = tm.MaxMetric(device="cpu")
    m.update(torch.tensor([3.0]))
    held = m._state["max_value"]
    synced = psync.sync_states(m.metric_state, m._reductions)
    assert synced["max_value"] is not held and synced["max_value"].data_ptr() != held.data_ptr()
    m.sync()
    assert m._state["max_value"] is not held
    m.unsync()
    assert m._state["max_value"] is held and float(held) == 3.0
