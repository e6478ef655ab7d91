"""The port's ``integrity.py`` against the JAX package's.

- the fold: the plain body of the ``fingerprint`` kernel (``ops/fingerprint.py``)
  and ``host_fingerprints`` give the JAX package's ``device_fingerprints`` /
  ``device_shard_fingerprints`` words bit for bit, for every dtype the
  states use, sizes that are not a multiple of 4 words and empty leaves;
- the keys: ``fingerprint_digest`` of one nested tree is the same in both
  packages (the port's leaf walk produces ``jax.tree_util.keystr``'s keys);
- the fault injectors hit the JAX package's bit positions;
- ``expanded_divergences`` on ``expand_canonical`` stacks, clean and skewed;
- ``IntegrityAuditor``: every policy at every read point (``compute``,
  ``compute_async``, an explicit audit) gives the JAX package's outcome and
  stats on the same seeded inputs and flips; cadence, stale baselines,
  detach and pickling, mirror invalidation;
- ``DeferredIntegrity`` against the JAX class through one duck-typed step;
- ``replica_divergences``: a port process holds one copy of a leaf, so it
  returns ``[]`` (reference behaviour, ROADMAP Queue C).

Exact float claims use multiples of 1/8, so float32 sums carry no rounding.
"""
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import integrity as jint
from torchmetrics_tpu.ops.async_read import drain_pipeline as jdrain
from torchmetrics_tpu.parallel import reshard as jreshard
from torchmetrics_tpu.quarantine import DegradedValue as JDegraded
from torchmetrics_tpu.testing import faults as jfaults
from torchmetrics_tpu.utils.exceptions import StateDivergenceError as JDivergence
from torchmetrics_tpu_torch import integrity as tint
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.ops import fingerprint
from torchmetrics_tpu_torch.ops.async_read import drain_pipeline as tdrain
from torchmetrics_tpu_torch.parallel import reshard as treshard
from torchmetrics_tpu_torch.quarantine import DegradedValue, LaneStateMirror
from torchmetrics_tpu_torch.testing import faults as tfaults
from torchmetrics_tpu_torch.utils.exceptions import StateDivergenceError

jax.config.update("jax_platforms", "cpu")

DTYPES = ["bool", "int8", "uint8", "int16", "float16", "bfloat16", "int32", "float32", "int64", "float64"]


def _np_array(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return np.asarray(rng.rand(*shape) > 0.5)
    if dtype == "bfloat16":
        return np.asarray(rng.randint(-100, 100, shape) / 8.0).astype(ml_dtypes.bfloat16)
    if dtype.startswith("float"):
        return np.asarray(rng.randn(*shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return np.asarray(rng.randint(info.min, int(info.max) + 1, shape, dtype=np.int64)).astype(dtype)


def _to_torch(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _jax_fold(tree, per_shard=False):
    fn = jint.device_shard_fingerprints if per_shard else jint.device_fingerprints
    wide = any(np.asarray(v).dtype.itemsize == 8 for v in jax.tree_util.tree_leaves(tree))
    with jax.enable_x64(wide):
        out = fn(jax.tree_util.tree_map(jnp.asarray, tree))
        return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# the fold and the keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5), (7,), (0,), (2, 0, 3), ()], ids=["3x5", "7", "empty", "empty3d", "scalar"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_fold_equals_jax_device_fingerprints(dtype, shape):
    arr = _np_array(dtype, shape, seed=11)
    want = _jax_fold({"x": arr})["['x']"]
    got = tint.device_fingerprints({"x": _to_torch(arr)})["['x']"]
    assert got.dtype == torch.uint32 and tuple(got.shape) == (2,)
    np.testing.assert_array_equal(tint._fp_host(got), want)
    np.testing.assert_array_equal(tint.host_fingerprints({"x": _to_torch(arr)})["['x']"], want)
    np.testing.assert_array_equal(tint.host_leaf_fingerprint(arr), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_shard_fold_equals_jax(dtype):
    arr = _np_array(dtype, (8, 13), seed=5)
    want = _jax_fold({"s": arr}, per_shard=True)["['s']"]
    got = tint.device_shard_fingerprints({"s": _to_torch(arr)})["['s']"]
    assert tuple(got.shape) == (8, 2)
    np.testing.assert_array_equal(tint._fp_host(got), want)
    for i in range(8):
        np.testing.assert_array_equal(want[i], jint.host_leaf_fingerprint(arr[i]))


def test_plain_fold_in_chunks_equals_one_pass(monkeypatch):
    """The plain body folds in chunks of CHUNK_WORDS words; chunks of 5 (odd
    halving passes, a partial last chunk) give the same words."""
    arr = _np_array("int64", (1003,), seed=3)
    want = tint.host_leaf_fingerprint(arr)
    monkeypatch.setattr(fingerprint, "CHUNK_WORDS", 5)
    np.testing.assert_array_equal(tint._fp_host(fingerprint.fingerprint_segments([_to_torch(arr)])[0]), want)


def test_one_dispatch_for_a_whole_tree():
    from torchmetrics_tpu_torch.ops import kernels

    kernels.reset_gate_log()
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, dtype=torch.int64), torch.ones(4, dtype=torch.bool)]}
    tint.device_fingerprints(tree)
    tint.device_shard_fingerprints({"s": torch.ones(8, 3)})
    assert kernels.gate_snapshot()["fingerprint"]["selections"] == {"reference": 2}
    assert fingerprint.fingerprint_segments([]).shape == (0, 2)


def _nested_tree():
    return {
        "confmat": _np_array("int64", (4, 4), 1),
        "preds": [_np_array("float32", (5,), 2), _np_array("float32", (3,), 3)],
        "inner": {"tp": _np_array("int32", (6,), 4), "flags": _np_array("bool", (7,), 5)},
        "pair": (_np_array("float16", (9,), 6), _np_array("uint8", (2, 2), 7)),
        "empty": np.zeros((0,), np.float32),
        "_update_count": 5,
        "_window_meta": None,
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return _to_torch(tree) if isinstance(tree, np.ndarray) else tree


def test_digest_and_keys_equal_across_packages():
    tree = _nested_tree()
    jtree = {k: v for k, v in tree.items() if not k.startswith("_")}  # python ints trace as arrays under jit
    want = _jax_fold(jtree)
    port = tint.device_fingerprints(_torch_tree(tree))
    assert list(port) == list(want)  # the same keys in the same order
    assert "['preds'][0]" in port and "['inner']['tp']" in port and "['pair'][1]" in port
    assert tint.fingerprint_digest(port) == jint.fingerprint_digest(want)
    assert tint.fingerprint_digest(tint.host_fingerprints(_torch_tree(tree))) == jint.fingerprint_digest(
        jint.host_fingerprints(tree)
    )
    assert list(tint._array_leaves(tree)) and [k for k, _ in tint._array_leaves(tree)] == [
        k for k, _ in jint._array_leaves(tree)
    ]


def test_replica_divergences_is_empty_on_a_port_state():
    """Reference behaviour: a port process holds one copy of a leaf on one
    card, so nothing is compared (the JAX package's result for a
    single-device leaf); no collective runs inside an audit."""
    state = {"r": torch.arange(4, dtype=torch.float32), "c": [torch.ones(2)], "_update_count": 3}
    assert tint.replica_divergences(state) == []
    assert jint.replica_divergences({"r": jnp.arange(4, dtype=jnp.float32)}) == []


# ---------------------------------------------------------------------------
# the injectors hit the JAX package's bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits", [1, 3, 40])
@pytest.mark.parametrize("seed", [0, 7])
def test_flip_bits_host_positions_equal_jax(n_bits, seed):
    arr = _np_array("float32", (4, 8), seed=seed)
    want, want_bits = jfaults._flip_bits_host(arr, n_bits, seed)
    got, bits = tfaults._flip_bits_host(arr, n_bits, seed)
    assert bits == want_bits
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    live = _to_torch(arr)
    assert tfaults._flip_tensor_bits_(live, n_bits, seed) == want_bits
    np.testing.assert_array_equal(live.numpy().view(np.uint32), want.view(np.uint32))


def test_flip_state_bits_tree_and_metric_equal_jax():
    tree = {"b": _np_array("int32", (5,), 1), "a": [_np_array("float32", (3,), 2)]}
    jflipped, jinfo = jfaults.flip_state_bits({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in tree.items()}, seed=3)
    tflipped, tinfo = tfaults.flip_state_bits(_torch_tree(tree), seed=3)
    assert tinfo == jinfo  # leaf 0 in the sorted walk: ['a'][0]
    np.testing.assert_array_equal(tflipped["a"][0].numpy(), np.asarray(jflipped["a"][0]))
    np.testing.assert_array_equal(tflipped["b"].numpy(), tree["b"])

    jm, tm_ = _jax_sumlike(), _torch_sumlike()
    for m, asarray in ((jm, jnp.asarray), (tm_, torch.as_tensor)):
        m.update(asarray(np.float32(2.5)))
    jinfo = jfaults.flip_state_bits(jm, seed=9)
    tinfo = tfaults.flip_state_bits(tm_, seed=9)
    assert tinfo == jinfo
    assert np.asarray(jm.total).view(np.uint32) == tm_.total.numpy().view(np.uint32)


def test_skew_replica_equals_jax():
    stack = _np_array("float32", (8, 6), seed=4)
    jskewed, jinfo = jfaults.skew_replica({"m": jnp.asarray(stack)}, shard=5, seed=2)
    tskewed, tinfo = tfaults.skew_replica({"m": _to_torch(stack)}, shard=5, seed=2)
    assert tinfo == jinfo
    np.testing.assert_array_equal(tskewed["m"].numpy(), np.asarray(jskewed["m"]))


# ---------------------------------------------------------------------------
# expanded_divergences on expand_canonical stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skew", [None, ("s", 3), ("m", 5), ("x", 1)])
def test_expanded_divergences_equal_jax(skew):
    canonical = {
        "s": (np.arange(4) / 8.0).astype(np.float32),
        "m": (np.arange(3) / 4.0).astype(np.float32),
        "x": np.asarray([3, -2, 7], np.int32),
        "n": np.asarray(5, np.int64),
    }
    reds = {"s": "sum", "m": "mean", "x": "max", "n": "sum"}
    jstack = {k: np.asarray(v) for k, v in jreshard.expand_canonical(canonical, reds, 8).items()}
    tstack = treshard.expand_canonical({k: torch.from_numpy(v) for k, v in canonical.items()}, reds, 8)
    for k in canonical:
        np.testing.assert_array_equal(tstack[k].numpy(), jstack[k])
    if skew is not None:
        field, shard = skew
        jsk, _ = jfaults.skew_replica({field: jnp.asarray(jstack[field])}, shard=shard, seed=2)
        tsk, _ = tfaults.skew_replica({field: tstack[field]}, shard=shard, seed=2)
        jstack = {**jstack, field: np.asarray(jsk[field])}
        tstack = {**tstack, field: tsk[field]}
    with jax.enable_x64(True):
        want = jint.expanded_divergences({k: jnp.asarray(v) for k, v in jstack.items()}, reds)
    got = tint.expanded_divergences({**tstack, "_update_count": 1}, reds)
    assert got == want
    assert (len(got) == 1 and got[0].shard == skew[1] and got[0].field == skew[0]) if skew else got == []


# ---------------------------------------------------------------------------
# IntegrityAuditor: policies and read points against the JAX package
# ---------------------------------------------------------------------------


class _JaxSumLike(jtm.Metric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", jnp.asarray(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


class _TorchSumLike(ttm.Metric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def _jax_sumlike():
    return _JaxSumLike(executor=False)


def _torch_sumlike():
    return _TorchSumLike()


def _batches(n, seed=21, width=8):
    rng = np.random.RandomState(seed)
    return [(rng.randint(-40, 40, width) / 8.0).astype(np.float32) for _ in range(n)]


PACKAGES = {
    "jax": (_jax_sumlike, jnp.asarray, jdrain, jfaults, JDegraded, JDivergence),
    "torch": (_torch_sumlike, torch.as_tensor, tdrain, tfaults, DegradedValue, StateDivergenceError),
}
STAT_KEYS = ("captures", "audits", "divergences", "degraded_serves", "restores", "stale_baselines")


def _outcome(fn, degraded_cls, error_cls):
    try:
        got = fn()
    except error_cls as err:
        return ("raise", err.surface, err.field, err.shard, tuple(err.expected), tuple(err.observed))
    if isinstance(got, degraded_cls):
        return ("degraded", float(got.value), got.updates_behind, got.age_updates)
    if hasattr(got, "ok") and hasattr(got, "action"):
        return ("report", got.ok, got.action, got.checked, tuple((d.surface, d.field) for d in got.divergences))
    return ("value", float(got))


def _scenario(pkg, policy, read, snapshots=True, flip=True, updates=3, every=1):
    make, asarray, drain, faults, degraded_cls, error_cls = PACKAGES[pkg]
    m = make()
    auditor = m.attach_integrity(every_n_updates=every, on_divergence=policy, snapshots=snapshots)
    for b in _batches(updates):
        m.update(asarray(b))
    drain(30.0)
    clean = float(m.compute())  # a read: caches the last-good value
    if flip:
        faults.flip_state_bits(m, seed=4)
    reads = {
        "compute": lambda: m.compute(),
        "async": lambda: m.compute_async().result(60.0),
        "audit": lambda: auditor.audit(),
        "audit_async": lambda: auditor.audit(wait=False).result(60.0),
    }
    outcome = _outcome(reads[read], degraded_cls, error_cls)
    drain(30.0)
    after = _outcome(lambda: m.compute(), degraded_cls, error_cls)
    return {
        "clean": clean,
        "outcome": outcome,
        "after": after,
        "stats": {k: auditor.stats[k] for k in STAT_KEYS},
        "baseline": auditor.baseline_count,
    }


CASES = [
    ("raise", "compute", True),
    ("raise", "async", True),
    ("raise", "audit", True),
    ("raise", "audit_async", True),
    ("degraded", "compute", True),
    ("degraded", "async", True),
    ("degraded", "audit", True),
    ("degraded", "compute", False),
    ("degraded", "async", False),
    ("restore", "compute", True),
    ("restore", "async", True),
    ("restore", "audit", True),
    ("restore", "compute", False),
]


@pytest.mark.parametrize("policy,read,snapshots", CASES)
def test_policy_at_read_point_equals_jax(policy, read, snapshots):
    want = _scenario("jax", policy, read, snapshots)
    got = _scenario("torch", policy, read, snapshots)
    if policy == "degraded" and not snapshots:
        # the port's one departure: its compute returns the state tensor
        # itself, which the flip corrupts in place, and without snapshots
        # there is no copy to serve, so the read raises the divergence the
        # "raise" policy names where JAX serves its immutable last-good value
        assert want["outcome"][:2] == ("degraded", want["clean"])
        raised = _scenario("jax", "raise", read, snapshots)
        assert got["outcome"] == raised["outcome"] and got["after"] == raised["after"]
        assert {k: got[k] for k in ("clean", "stats", "baseline")} == {k: want[k] for k in ("clean", "stats", "baseline")}
        return
    assert got == want
    if policy == "restore" and snapshots and read != "audit":
        assert got["outcome"] == ("value", got["clean"])  # healed bit for bit
    if policy == "raise":
        assert got["outcome"][:3] == ("raise", "chain", "['total']")


def test_clean_audit_and_cadence_equal_jax():
    for every, updates in ((1, 3), (2, 5)):
        want = _scenario("jax", "raise", "audit", flip=False, updates=updates, every=every)
        got = _scenario("torch", "raise", "audit", flip=False, updates=updates, every=every)
        assert got == want
    assert got["stats"]["captures"] == 2 and got["baseline"] == 4
    assert got["outcome"] == ("report", True, "stale_baseline", 0, ())


def test_restore_continues_on_verified_bits():
    m = _torch_sumlike()
    auditor = m.attach_integrity(on_divergence="restore")
    for b in _batches(3):
        m.update(torch.as_tensor(b))
    tdrain(30.0)
    want = float(m.compute())
    clean_fp = tint.host_fingerprints(m._copy_state_dict())
    tfaults.flip_state_bits(m, seed=9)
    assert float(m.compute()) == want and auditor.stats["restores"] == 1
    assert tint.fingerprint_digest(tint.host_fingerprints(m._copy_state_dict())) == tint.fingerprint_digest(clean_fp)
    assert m.update_count == 3
    m.update(torch.tensor([8.0]))
    tdrain(30.0)
    assert float(m.compute()) == want + 8.0


def test_raise_is_flighted_in_the_integrity_domain():
    m = _torch_sumlike()
    m.attach_integrity(on_divergence="raise")
    m.update(torch.tensor([1.0]))
    tdrain(30.0)
    before = obs.telemetry_snapshot()["counters"].get("integrity.divergences", 0)
    tfaults.flip_state_bits(m, seed=1)
    with pytest.raises(StateDivergenceError):
        m.integrity.audit()
    crumbs = [c for c in obs.dump_diagnostics()["breadcrumbs"] if c.get("kind") == "integrity_divergence"]
    assert crumbs and crumbs[-1]["data"]["owner"] == "_TorchSumLike"
    assert obs.telemetry_snapshot()["counters"].get("integrity.divergences", 0) > before


def test_detach_and_pickle_drop_the_auditor():
    m = _torch_sumlike()
    auditor = m.attach_integrity()
    m.update(torch.tensor([2.0]))
    tdrain(30.0)
    m2 = pickle.loads(pickle.dumps(m))
    assert m2.integrity is None and m.integrity is auditor
    assert m.attach_integrity() is not auditor and auditor.metric.integrity is not auditor  # re-attach replaces
    m.integrity.detach()
    assert m.integrity is None
    tfaults.flip_state_bits(m, seed=7)
    m.compute()  # detached: the read no longer audits


class _TorchScaledSum(_TorchSumLike):
    def compute(self):
        return self.total * 2.0  # a fresh tensor, apart from the state


@pytest.mark.parametrize("read", ["compute", "async"])
@pytest.mark.parametrize("snapshots", [True, False])
def test_degraded_last_good_shares_no_storage_with_the_state(read, snapshots):
    """The kept last-good value never aliases the state a flip corrupts in
    place: a state tensor returned as it is is cloned under snapshots=True
    and not kept under snapshots=False (the read raises); a fresh value is
    kept as it is and served after the flip."""
    for make, fresh in ((_torch_sumlike, False), (_TorchScaledSum, True)):
        m = make()
        auditor = m.attach_integrity(on_divergence="degraded", snapshots=snapshots)
        for b in _batches(3):
            m.update(torch.as_tensor(b))
        tdrain(30.0)
        clean = (m.compute_async().result(60.0) if read == "async" else m.compute()).clone()
        storages = {t.untyped_storage().data_ptr() for t in m._copy_state_dict().values() if isinstance(t, torch.Tensor)}
        kept = auditor._last_good
        if fresh or snapshots:
            assert kept[0] == 3 and kept[1].untyped_storage().data_ptr() not in storages
        else:
            assert kept is None
        tfaults.flip_state_bits(m, seed=4)
        if fresh or snapshots:
            got = m.compute()
            assert isinstance(got, DegradedValue) and torch.equal(got.value, clean)
        else:
            with pytest.raises(StateDivergenceError, match="total"):
                m.compute()


def test_policy_validation():
    with pytest.raises(ValueError, match="on_divergence"):
        tint.IntegrityAuditor(_torch_sumlike(), on_divergence="bogus")
    with pytest.raises(ValueError, match="every_n_updates"):
        tint.IntegrityAuditor(_torch_sumlike(), every_n_updates=0)
    with pytest.raises(ValueError, match="on_divergence"):
        tint.DeferredIntegrity(object(), on_divergence="explode")
    with pytest.raises(ValueError, match="every_n_steps"):
        tint.DeferredIntegrity(object(), every_n_steps=0)


def test_capture_holds_no_state_reference():
    """A parked capture holds its fold's words and, under snapshots=True,
    a host copy, never the state's own tensors; the next read installs it."""
    for snapshots in (True, False):
        m = _torch_sumlike()
        auditor = m.attach_integrity(snapshots=snapshots)
        m.update(torch.tensor([1.0, 2.0]))
        parked = auditor._parked._capture
        live = m.total.untyped_storage().data_ptr()
        held = [t for part in parked for t in (part.values() if isinstance(part, dict) else [part])
                if isinstance(t, torch.Tensor)]
        assert held and all(t.untyped_storage().data_ptr() != live for t in held)
        assert auditor.baseline_count == 1 and auditor._parked._capture is None
        assert (auditor._baseline[2] is not None) == snapshots
        assert set(auditor._baseline[1]) == {"['total']"}
        m.update(torch.tensor([3.0]))
        m.update(torch.tensor([4.0]))  # the capture at count 2 is superseded unread
        assert auditor.stats["captures"] == 3 and auditor.baseline_count == 3


# ---------------------------------------------------------------------------
# mirror coherence
# ---------------------------------------------------------------------------


def test_lane_mirror_divergence_invalidates():
    state = {"hits": torch.arange(8, dtype=torch.float32)}
    mirror = LaneStateMirror()
    mirror.snapshot(state, np.asarray([0, 1]), update_count=1, capacity=8)
    assert mirror.verify(state, 1)
    mirror._mirror["hits"], _ = tfaults._flip_bits_host(mirror._mirror["hits"], 1, 0)
    assert not mirror.verify(state, 1)
    assert mirror._mirror is None


def test_auditor_heals_attached_mirror():
    m = _torch_sumlike()
    auditor = m.attach_integrity()
    m.update(torch.tensor([1.0]))
    tdrain(30.0)
    mirror = LaneStateMirror()
    mirror.snapshot({"total": m.total}, np.asarray([], np.int64), update_count=1, capacity=1)
    m.__dict__["_lane_mirror"] = mirror
    mirror._mirror["total"], _ = tfaults._flip_bits_host(mirror._mirror["total"], 1, 0)
    report = auditor.audit()  # the mirror surface heals itself; the chain stays ok
    assert report.ok and auditor.stats.get("mirror_rebuilds", 0) == 1 and mirror._mirror is None
    del m.__dict__["_lane_mirror"]


# ---------------------------------------------------------------------------
# DeferredIntegrity against the JAX class through one duck-typed step
# ---------------------------------------------------------------------------


class _Shadow:
    def __init__(self, states):
        self._states = states

    def snapshot(self):
        return self._states


class _Step:
    """What DeferredIntegrity needs of a step: ``steps``, ``shadow`` and
    ``recover()`` (the shadow's states)."""

    def __init__(self, shadow_states=None):
        self.steps = 0
        self.shadow = _Shadow(shadow_states) if shadow_states is not None else None

    def recover(self):
        return self.shadow.snapshot()


def _stacked(seed):
    rng = np.random.RandomState(seed)
    return {
        "m": {"total": (rng.randint(-40, 40, 8) / 8.0).astype(np.float32), "n": rng.randint(0, 9, (8, 3)).astype(np.int32)},
    }


def _deferred(pkg, policy, fault, shadow):
    clean = _stacked(44)
    if pkg == "jax":
        convert, drain, faults, error_cls = (lambda t: jax.tree_util.tree_map(jnp.asarray, t)), jdrain, jfaults, JDivergence
        integ_cls = jint.DeferredIntegrity
    else:
        convert, drain, faults, error_cls = _torch_tree, tdrain, tfaults, StateDivergenceError
        integ_cls = tint.DeferredIntegrity
    states = convert(clean)
    step = _Step(convert(clean) if shadow else None)
    integ = integ_cls(step, every_n_steps=1, on_divergence=policy)
    for s in range(1, 4):
        step.steps = s
        if integ.due(s):
            integ.observe(states, s)
    drain(30.0)
    if fault == "skew":
        states, _ = faults.skew_replica(states, shard=3, seed=1)
    elif fault == "flip":
        states, _ = faults.flip_state_bits(states, seed=2)
    try:
        report = integ.audit(states)
    except error_cls as err:
        return ("raise", err.surface, err.field, err.shard, tuple(err.expected), tuple(err.observed)), integ.stats
    restored = None
    if report.restored_states is not None:
        restored = {k: np.asarray(v) for k, v in report.restored_states["m"].items()}
    return (report.ok, report.checked, report.action, report.divergences, report.update_count, restored), {
        k: integ.stats[k] for k in ("captures", "audits", "divergences", "restores", "stale_baselines")
    }


@pytest.mark.parametrize(
    "policy,fault,shadow",
    [("raise", None, False), ("raise", "skew", False), ("degraded", "flip", False), ("restore", "skew", True),
     ("restore", "skew", False)],
)
def test_deferred_integrity_equals_jax(policy, fault, shadow):
    want, want_stats = _deferred("jax", policy, fault, shadow)
    got, got_stats = _deferred("torch", policy, fault, shadow)
    assert got_stats == want_stats
    if got[0] == "raise":
        assert got == want and got[3] == (3 if fault == "skew" else got[3])
        return
    assert got[:5] == want[:5]
    if want[5] is not None:
        assert set(got[5]) == set(want[5])
        for k in want[5]:
            np.testing.assert_array_equal(got[5][k], want[5][k])
    if fault == "skew":
        assert got[3][0].shard == 3 and got[3][0].field == "['m']['n']"  # the first stacked leaf in the sorted walk
