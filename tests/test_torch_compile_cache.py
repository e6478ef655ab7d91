"""The port's compile cache (``ops/compile_cache.py``) against the JAX package's.

The store's container, pruning, the manifests, the worker, the flags and
background captures go through both packages on the same inputs (seeded
numpy, one process): the same verdict for every damaged entry, the same
files pruned, manifests that each package warms from the other's, the same
worker and flag behaviour, and over the JAX package's state families the
same stats after every step with background compilation on, counts bit for
bit. Then the port's own pieces: a cold and a warm process (subprocesses
that import no JAX), a poisoned store, a stored spec that records other
launches than its capture makes, and the three faults the store's library
half repairs (per-thread launch counts, library names that hash the
toolchain, damaged host libraries rebuilt).

The suite-wide conftest sets ``TORCHMETRICS_TPU_COMPILE_AHEAD=0``: every
test that needs the layer turns it on against a tmp cache dir.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from torchmetrics_tpu_torch.classification import (
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
)
from torchmetrics_tpu_torch.ops import compile_cache, launch_counts
from torchmetrics_tpu_torch.ops.executor import executor_stats
from torchmetrics_tpu_torch.testing import faults

REPO = Path(__file__).resolve().parents[1]
C = 5
#: the stats held equal to the JAX package's over a background sequence
BG_KEYS = ("calls", "compiles", "cache_hits", "eager_misses", "background_compiles", "pending_background", "disk_hits")


@pytest.fixture()
def cache_env(monkeypatch, tmp_path):
    """Compile-ahead on against an isolated store; returns the cache dir."""
    cache_dir = tmp_path / "tm_cache"
    monkeypatch.setenv("TORCHMETRICS_TPU_COMPILE_AHEAD", "1")
    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_DIR", str(cache_dir))
    monkeypatch.delenv("TORCHMETRICS_TPU_BG_COMPILE", raising=False)
    yield cache_dir
    assert compile_cache.drain_worker(60)


def _batch(n: int, seed: int = 0):
    r = np.random.RandomState(seed)
    return r.randn(n, C).astype(np.float32), r.randint(0, C, n).astype(np.int32)


def _port(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in batch)


def _accuracy(**kw):
    return MulticlassAccuracy(num_classes=C, validate_args=False, device="cpu", executor=True, **kw)


def _entry_collection(executor=True):
    kw = {"validate_args": False, "device": "cpu", "executor": executor}
    return MetricCollection(
        {
            "accuracy": MulticlassAccuracy(num_classes=C, average="micro", **kw),
            "f1": MulticlassF1Score(num_classes=C, average="macro", **kw),
            "precision": MulticlassPrecision(num_classes=C, average="macro", **kw),
            "recall": MulticlassRecall(num_classes=C, average="macro", **kw),
            "confmat": MulticlassConfusionMatrix(num_classes=C, **kw),
        },
        executor=executor,
        device="cpu",
    )


def _entries(cache_dir) -> list:
    store = Path(cache_dir) / compile_cache.STORE_SUBDIR
    return sorted(p.name for p in store.glob(f"*{compile_cache.ENTRY_SUFFIX}")) if store.is_dir() else []


# ----------------------------------------------------------------- container


def _jax_cc():
    from torchmetrics_tpu.ops import compile_cache as jax_cc

    return jax_cc


def _rewrite_header(path: str, magic: bytes, **changes) -> None:
    data = open(path, "rb").read()
    hlen = int.from_bytes(data[len(magic):len(magic) + 8], "little")
    start = len(magic) + 8
    header = json.loads(data[start:start + hlen].decode())
    header.update(changes)
    new = json.dumps(header, sort_keys=True).encode()
    open(path, "wb").write(magic + len(new).to_bytes(8, "little") + new + data[start + hlen:])


def _mutate(pkg: str, mode: str, cache_dir: str, key: str) -> str:
    """Damage ``key``'s entry of ``pkg`` (``"jax"``/``"port"``) as ``mode``;
    returns the key description the load then asks for."""
    if pkg == "jax":
        from torchmetrics_tpu.testing import faults as pkg_faults

        cc, magic = _jax_cc(), _jax_cc().ENTRY_MAGIC
    else:
        pkg_faults, cc, magic = faults, compile_cache, compile_cache.ENTRY_MAGIC
    path = cc.entry_path(cc.entry_key(key), cache_dir)
    if mode in ("truncate", "zero", "flip", "garbage"):
        pkg_faults.corrupt_cache_entry(cache_dir, mode=mode, which="all", seed=3)
    elif mode == "stale_toolchain":
        pkg_faults.stale_cache_version(cache_dir, which="all")
    elif mode == "other_backend":
        _rewrite_header(path, magic, backend="tpu/TPU v9")
    elif mode == "trailing_bytes":
        with open(path, "ab") as fh:
            fh.write(b"\x01\x02\x03")
    elif mode == "key_mismatch":
        other = key + "|other"
        os.replace(path, cc.entry_path(cc.entry_key(other), cache_dir))
        return other
    return key


MUTATIONS = ("truncate", "zero", "flip", "garbage", "stale_toolchain", "other_backend", "key_mismatch", "trailing_bytes")


@pytest.mark.parametrize("mode", MUTATIONS)
def test_every_damaged_entry_is_the_same_verdict_as_jax(tmp_path, mode):
    """Each package stores an entry, it is damaged the same way, and each
    load warns, deletes the file and reports a miss."""
    jax_cc = _jax_cc()
    blob = np.random.RandomState(0).bytes(4096)
    key = "owner|desc|with|parts"
    verdicts = {}
    for pkg, cc, store, load, fmt in (
        ("jax", jax_cc, jax_cc.store_executable, jax_cc.load_executable_blob, jax_cc.FORMAT_COMPILED),
        ("port", compile_cache, compile_cache.store_entry, compile_cache.load_entry, compile_cache.SECTION_PROFILE),
    ):
        cache_dir = str(tmp_path / pkg)
        assert store(key, [(fmt, blob)], cache_dir) is not None
        asked = _mutate(pkg, mode, cache_dir, key)
        path = cc.entry_path(cc.entry_key(asked), cache_dir)
        assert os.path.exists(path)
        with pytest.warns(UserWarning, match="damaged/stale entry") as caught:
            got = load(asked, cache_dir)
        verdicts[pkg] = (got, os.path.exists(path), len(caught) >= 1)
    assert verdicts["jax"] == verdicts["port"] == (None, False, True)


def test_a_valid_entry_round_trips_in_both(tmp_path):
    jax_cc = _jax_cc()
    blobs = [b"first" * 100, b"second" * 50]
    assert jax_cc.load_executable_blob("k", str(tmp_path / "j")) is None
    jax_cc.store_executable("k", [(jax_cc.FORMAT_COMPILED, b) for b in blobs], str(tmp_path / "j"))
    compile_cache.store_entry("k", [(compile_cache.SECTION_PROFILE, b) for b in blobs], str(tmp_path / "p"))
    assert [b for _, b in jax_cc.load_executable_blob("k", str(tmp_path / "j"))] == blobs
    assert [b for _, b in compile_cache.load_entry("k", str(tmp_path / "p"))] == blobs
    # a key that was never stored is a plain miss in both, with no warning
    assert jax_cc.load_executable_blob("never", str(tmp_path / "j")) is None
    assert compile_cache.load_entry("never", str(tmp_path / "p")) is None


def test_prune_evicts_the_same_files_in_the_same_order(tmp_path):
    """The same sizes and mtimes in two directories: each package's
    ``prune_store`` leaves the same files at every cap."""
    rng = np.random.RandomState(7)
    sizes = rng.randint(100, 4000, 12)
    mtimes = 1_700_000_000 + rng.permutation(12) * 10
    for cap in (0, int(sizes.sum() // 3), int(sizes.sum() // 2), int(sizes.sum()) - 1, int(sizes.sum())):
        left = {}
        for pkg, prune in (("jax", _jax_cc().prune_store), ("port", compile_cache.prune_store)):
            d = tmp_path / f"{pkg}_{cap}"
            d.mkdir()
            for i, (size, mtime) in enumerate(zip(sizes, mtimes)):
                p = d / f"entry{i:02d}{compile_cache.ENTRY_SUFFIX}"
                p.write_bytes(b"\0" * int(size))
                os.utime(p, (mtime, mtime))
            (d / "not_an_entry.txt").write_bytes(b"\0" * 9999)
            removed = prune(str(d), max_bytes=cap)
            left[pkg] = (removed, sorted(p.name for p in d.iterdir()))
        assert left["jax"] == left["port"]


# ------------------------------------------------------------------ manifests


def _jax_entry_collection():
    from torchmetrics_tpu import MetricCollection as JaxCollection
    from torchmetrics_tpu import classification as jcls

    return JaxCollection(
        {
            "accuracy": jcls.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False),
            "f1": jcls.MulticlassF1Score(num_classes=C, average="macro", validate_args=False),
            "precision": jcls.MulticlassPrecision(num_classes=C, average="macro", validate_args=False),
            "recall": jcls.MulticlassRecall(num_classes=C, average="macro", validate_args=False),
            "confmat": jcls.MulticlassConfusionMatrix(num_classes=C, validate_args=False),
        }
    )


SIZES = (32, 32, 20)


def _specs(manifest) -> list:
    return sorted(json.dumps(s, sort_keys=True) for s in manifest["specs"])


def test_a_jax_manifest_warms_the_port_and_the_reverse(tmp_path):
    import jax.numpy as jnp

    jax_cc = _jax_cc()
    jax_coll = _jax_entry_collection()
    for i, n in enumerate(SIZES):
        jax_coll.update(*(jnp.asarray(x) for x in _batch(n, i)))
    jax_path = str(tmp_path / "jax_profile.json")
    jax_cc.save_shape_manifest(jax_path, jax_coll.shape_profile())
    jax_manifest = jax_cc.load_shape_manifest(jax_path)
    assert jax_manifest["specs"]

    # the JAX manifest warms a fresh port collection: the shapes it recorded
    port = _entry_collection()
    report = port.warmup_from_manifest(jax_path)
    assert report["warmed"] == len(jax_manifest["specs"]) and not report["skipped"]
    assert compile_cache.load_shape_manifest(jax_path) == jax_manifest
    before = executor_stats(port)["compiles"]
    for i, n in enumerate(SIZES[1:]):
        port.update(*_port(_batch(n, i + 1)))
    assert executor_stats(port)["compiles"] == before  # traffic found every key warm
    assert _specs(port.shape_profile()) == _specs(jax_manifest)

    # the reverse: a port collection's profile warms a fresh JAX collection
    traffic = _entry_collection()
    for i, n in enumerate(SIZES):
        traffic.update(*_port(_batch(n, i)))
    port_path = str(tmp_path / "port_profile.json")
    assert traffic.save_shape_profile(port_path) == port_path
    assert _specs(jax_cc.load_shape_manifest(port_path)) == _specs(traffic.shape_profile()) == _specs(jax_manifest)
    jax_fresh = _jax_entry_collection()
    assert jax_fresh.warmup_from_manifest(port_path)["warmed"] == len(jax_manifest["specs"])


@pytest.mark.parametrize(
    "manifest,match",
    [({"profile_version": 99, "specs": []}, "unsupported"), ({"profile_version": 1}, "no 'specs' list"),
     ({"specs": []}, "unsupported")],
    ids=["future_version", "no_specs", "no_version"],
)
def test_manifest_errors_match_jax(tmp_path, manifest, match):
    path = tmp_path / "m.json"
    path.write_text(json.dumps(manifest))
    errors = []
    for load in (_jax_cc().load_shape_manifest, compile_cache.load_shape_manifest):
        with pytest.raises(ValueError, match=match) as err:
            load(str(path))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_single_metric_profile_round_trips_through_a_path(monkeypatch, tmp_path):
    """With the store off, a saved profile alone warms a fresh instance (with
    it on, the store would have built the keys first: ``already_warm``)."""
    monkeypatch.setenv("TORCHMETRICS_TPU_COMPILE_AHEAD", "0")
    m = _accuracy()
    m.update(*_port(_batch(32)))
    m.update(*_port(_batch(20, 1)))
    path = m.save_shape_profile(str(tmp_path / "acc.json"))
    m2 = _accuracy()
    report = m2.warmup_from_manifest(path)
    assert report["warmed"] == 2
    compiles = executor_stats(m2)["compiles"]
    m2.update(*_port(_batch(32)))
    m2.update(*_port(_batch(20, 1)))
    assert executor_stats(m2)["compiles"] == compiles


# --------------------------------------------------------------------- worker


def _drive_worker(worker_cls):
    worker = worker_cls(maxsize=2)
    gate = threading.Event()
    ran = []
    results = [worker.submit(lambda: gate.wait(30))]
    time.sleep(0.05)  # the gate job is running: the queue holds two more
    results += [worker.submit(lambda i=i: ran.append(i)) for i in range(3)]
    results.append(worker.submit(lambda: 1 / 0))

    gate.set()
    drained = worker.drain(30)
    results.append(worker.submit(lambda: 1 / 0))
    results.append(worker.submit(lambda: ran.append("late")))
    assert worker.drain(30)
    return results, drained, ran, dict(worker.stats), worker.pending()


def test_worker_drops_counts_errors_and_drains_as_jax():
    jax_out = _drive_worker(_jax_cc().CompileWorker)
    port_out = _drive_worker(compile_cache.CompileWorker)
    assert jax_out == port_out
    results, drained, ran, stats, pending = port_out
    assert results == [True, True, True, False, False, True, True] and drained
    assert ran == [0, 1, "late"] and pending == 0
    assert stats == {"submitted": 5, "dropped": 2, "completed": 4, "errors": 1}


def test_drain_worker_and_the_worker_counters(cache_env):
    from torchmetrics_tpu_torch import obs

    obs.reset()
    assert compile_cache.get_worker() is compile_cache.get_worker()
    assert compile_cache.get_worker().submit(lambda: None)
    assert compile_cache.drain_worker(30)
    snap = obs.telemetry_snapshot()
    assert snap["counters"].get("compile_worker.submitted", 0) >= 1
    assert snap["counters"].get("compile_worker.completed", 0) >= 1
    assert snap["gauges"].get("compile_worker.pending") == 0


# ---------------------------------------------------------------------- flags


@pytest.mark.parametrize("value", ["0", "false", "off", "no", "1", "yes", "", " OFF "])
def test_flags_parse_as_jax(monkeypatch, tmp_path, value):
    jax_cc = _jax_cc()
    monkeypatch.setenv("TORCHMETRICS_TPU_COMPILE_AHEAD", value)
    monkeypatch.setenv("TORCHMETRICS_TPU_BG_COMPILE", value)
    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_MAX_BYTES", value)
    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_DIR", str(tmp_path / "custom"))
    assert compile_cache.compile_ahead_enabled() == jax_cc.compile_ahead_enabled()
    assert compile_cache.background_compile_default() == jax_cc.background_compile_default()
    assert compile_cache.cache_max_bytes() == jax_cc.cache_max_bytes()
    assert compile_cache.cache_dir() == jax_cc.cache_dir()


def test_cache_dir_default_is_the_ports_own(monkeypatch):
    monkeypatch.setenv("TORCHMETRICS_TPU_COMPILE_AHEAD", "1")
    monkeypatch.delenv("TORCHMETRICS_TPU_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir().endswith(os.path.join(".cache", "torchmetrics_tpu_torch"))
    assert _jax_cc().cache_dir().endswith(os.path.join(".cache", "torchmetrics_tpu"))
    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_MAX_BYTES", "12345")
    assert compile_cache.cache_max_bytes() == 12345 == _jax_cc().cache_max_bytes()


def test_bg_compile_env_default_reaches_the_executor(monkeypatch):
    monkeypatch.delenv("TORCHMETRICS_TPU_BG_COMPILE", raising=False)
    m = _accuracy()
    assert not m._get_executor().background_enabled()
    assert executor_stats(m)["background_enabled"] is False
    monkeypatch.setenv("TORCHMETRICS_TPU_BG_COMPILE", "1")
    assert m._get_executor().background_enabled()
    m.set_background_compile(False)
    assert not m._get_executor().background_enabled()
    m.set_background_compile(None)
    assert m.executor_status["stats"]["background_enabled"] is True


def test_compile_ahead_off_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("TORCHMETRICS_TPU_COMPILE_AHEAD", "0")
    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_DIR", str(tmp_path / "never"))
    monkeypatch.setenv("TORCHMETRICS_TPU_BG_COMPILE", "1")
    m = _accuracy()
    m.update(*_port(_batch(32)))
    assert compile_cache.drain_worker(30)
    s = executor_stats(m)
    assert not (tmp_path / "never").exists()
    assert s["disk_stores"] == 0 and s["eager_misses"] == 0 and s["compiles"] == 1
    assert compile_cache.store_entry("k", [(compile_cache.SECTION_PROFILE, b"b")]) is None


# --------------------------------------------------------- background capture


FAMILIES = {
    "sum": (lambda pkg: pkg.SumMetric(nan_strategy="ignore"), [np.arange(8.0), np.arange(8.0) * 2]),
    "mean": (lambda pkg: pkg.MeanMetric(nan_strategy="ignore"), [np.arange(8.0), np.ones(8)]),
    "max": (lambda pkg: pkg.MaxMetric(nan_strategy="ignore"), [np.arange(8.0), -np.arange(8.0)]),
    "min": (lambda pkg: pkg.MinMetric(nan_strategy="ignore"), [np.arange(8.0), -np.arange(8.0)]),
    "cat": (lambda pkg: pkg.CatMetric(), [np.arange(4.0), np.arange(4.0) + 9]),
}


def _bg_sequence(metric, batches, to, drain):
    """Two passes over ``batches`` with background captures on, the worker
    drained after every update: the stats after each step, and the value."""
    metric.set_background_compile(True)
    seq = []
    for b in list(batches) + list(batches):
        metric.update(to(b))
        assert drain(90)
        s = executor_stats(metric)
        seq.append({k: s[k] for k in BG_KEYS})
    return seq, np.asarray(metric.compute())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_background_sequence_per_state_family_matches_jax(cache_env, monkeypatch, family):
    import jax.numpy as jnp

    import torchmetrics_tpu.aggregation as jax_agg
    from torchmetrics_tpu.ops.executor import executor_stats as jax_stats

    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_DIR", str(cache_env / "jax"))
    build, batches = FAMILIES[family]
    jax_metric = build(jax_agg)
    jax_seq = []
    jax_metric.set_background_compile(True)
    for b in batches + batches:
        jax_metric.update(jnp.asarray(b, dtype=jnp.float32))
        assert _jax_cc().drain_worker(90)
        s = jax_stats(jax_metric)
        jax_seq.append({k: s[k] for k in BG_KEYS})
    jax_value = np.asarray(jax_metric.compute())

    import torchmetrics_tpu_torch.aggregation as port_agg

    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_DIR", str(cache_env / "port"))
    port_cls = getattr(port_agg, type(jax_metric).__name__)
    port_metric = port_cls(**{**_agg_kwargs(family), "device": "cpu", "executor": True})
    port_seq, port_value = _bg_sequence(port_metric, batches, lambda b: torch.tensor(b, dtype=torch.float32),
                                        compile_cache.drain_worker)
    eager = port_cls(**{**_agg_kwargs(family), "device": "cpu", "executor": False})
    for b in batches + batches:
        eager.update(torch.tensor(b, dtype=torch.float32))
    assert port_seq == jax_seq
    np.testing.assert_array_equal(port_value, np.asarray(eager.compute()))
    np.testing.assert_allclose(port_value, jax_value, rtol=1e-6)


def _agg_kwargs(family: str) -> dict:
    return {} if family == "cat" else {"nan_strategy": "ignore"}


def test_collection_background_swap_in_and_values(cache_env):
    coll = _entry_collection()
    ref = _entry_collection(executor=False)
    batches = [_port(_batch(n, i)) for i, n in enumerate((64, 64, 64, 40, 64))]
    coll.update(*batches[0])  # resolves the groups (eager by design)
    ref.update(*batches[0])
    coll.set_background_compile(True)
    coll.update(*batches[1])  # the fused key is cold: the eager loop serves it
    ref.update(*batches[1])
    s = executor_stats(coll)
    assert s["eager_misses"] == 1 and s["calls"] == 0 and s["background_enabled"]
    assert compile_cache.drain_worker(90)
    for b in batches[2:]:
        coll.update(*b)
        ref.update(*b)
    assert compile_cache.drain_worker(90)
    s = executor_stats(coll)
    assert s["calls"] >= 1 and s["background_compiles"] == 2 and s["pending_background"] == 0
    out, want = coll.compute(), ref.compute()
    for k in want:
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=0)


def test_a_background_key_keeps_the_copy_its_body_reads(cache_env):
    """A key built on the worker runs (on the card: captures) the body of a
    detached copy of its owner, whose tensors its graphs then read: the key
    holds that copy after the job ends. A key built inline holds none."""
    import gc
    import weakref

    m = _accuracy()
    m.set_background_compile(True)
    m.update(*_port(_batch(32)))
    assert compile_cache.drain_worker(30)
    (entry,) = m._get_executor().dispatcher().entries.values()
    clone, members = entry.owner_copy
    assert clone is not m and members == [clone]
    copies = {k: weakref.ref(v) for k, v in clone._defaults.items()}
    assert all(copies[k]() is not m._defaults[k] for k in copies)
    del clone, members
    gc.collect()
    assert all(ref() is not None for ref in copies.values())
    inline = _accuracy()
    inline.update(*_port(_batch(32)))
    (entry,) = inline._get_executor().dispatcher().entries.values()
    assert entry.owner_copy is None


def test_a_full_queue_builds_inline(cache_env, monkeypatch):
    monkeypatch.setattr(compile_cache.get_worker(), "submit", lambda job: False)
    m = _accuracy()
    m.set_background_compile(True)
    m.update(*_port(_batch(32)))
    s = executor_stats(m)
    assert s["eager_misses"] == 0 and s["compiles"] == 1 and s["calls"] == 1


def test_an_owner_that_cannot_be_copied_builds_inline(cache_env, monkeypatch):
    m = _accuracy()
    m.set_background_compile(True)
    ex = m._get_executor()

    def refuse():
        raise TypeError("not copyable")

    monkeypatch.setattr(ex, "_clone_owner", refuse)
    m.update(*_port(_batch(32)))
    s = executor_stats(m)
    assert s["eager_misses"] == 0 and s["compiles"] == 1 and s["pending_background"] == 0


def test_a_pending_key_keeps_serving_eagerly(cache_env):
    gate = threading.Event()
    assert compile_cache.get_worker().submit(lambda: gate.wait(30))
    m, ref = _accuracy(), MulticlassAccuracy(num_classes=C, validate_args=False, device="cpu", executor=False)
    m.set_background_compile(True)
    try:
        for i in range(4):
            b = _port(_batch(32, i))
            m.update(*b)
            ref.update(*b)
        s = executor_stats(m)
        assert s["eager_misses"] == 4 and s["pending_background"] == 1 and s["calls"] == 0
    finally:
        gate.set()
    assert compile_cache.drain_worker(30)
    m.update(*_port(_batch(32, 9)))
    ref.update(*_port(_batch(32, 9)))
    s = executor_stats(m)
    assert s["calls"] == 1 and s["background_compiles"] == 1
    assert float(m.compute()) == float(ref.compute())


# ------------------------------------------------------- the store in use


def test_a_warm_instance_builds_its_keys_from_the_store(cache_env):
    m1 = _accuracy()
    for i, n in enumerate((32, 32, 20)):
        m1.update(*_port(_batch(n, i)))
    assert compile_cache.drain_worker(30)
    s1 = executor_stats(m1)
    assert s1["disk_stores"] == 2 and len(_entries(cache_env)) == 1
    m2 = _accuracy()
    for i, n in enumerate((32, 32, 20)):
        m2.update(*_port(_batch(n, i)))
    s2 = executor_stats(m2)
    assert s2["disk_hits"] == 2 and s2["compiles"] == 0 and s2["cache_hits"] == 3
    assert float(m2.compute()) == float(m1.compute())


@pytest.mark.parametrize("mode", ["flip", "truncate", "garbage", "stale"])
def test_a_poisoned_store_warns_misses_and_changes_no_value(cache_env, mode):
    coll = _entry_collection()
    batches = [_port(_batch(n, i)) for i, n in enumerate((32, 32, 20))]
    for b in batches:
        coll.update(*b)
    assert compile_cache.drain_worker(30) and _entries(cache_env)
    if mode == "stale":
        faults.stale_cache_version(str(cache_env), which="all")
    else:
        faults.corrupt_cache_entry(str(cache_env), mode=mode, which="all")
    again = _entry_collection()
    with pytest.warns(UserWarning, match="stale toolchain" if mode == "stale" else "damaged/stale entry"):
        for b in batches:
            again.update(*b)
    s = executor_stats(again)
    assert s["disk_hits"] == 0 and s["compiles"] == 2 and s["disabled_reason"] is None
    out, want = again.compute(), coll.compute()
    for k in want:
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=0)
    assert compile_cache.drain_worker(30)
    assert executor_stats(again)["disk_stores"] == 2  # the entry is written anew


def test_a_stored_spec_with_other_launches_evicts_the_entry(cache_env):
    """The counterpart of the JAX package's wrong-computation entry: a
    record whose capture makes other launches than it says is evicted
    (``disk_evictions``, a warning, a breadcrumb) and the key judged anew."""
    from torchmetrics_tpu_torch import obs

    m1 = _accuracy()
    m1.update(*_port(_batch(32)))
    assert compile_cache.drain_worker(30)
    ex = m1._get_executor()
    desc = ex.store_desc()
    profile = compile_cache.load_profile(desc)
    profile["specs"][0]["launches"] = {"bincount.launches": 7}
    compile_cache.store_profile(desc, profile)
    m2 = _accuracy()
    with pytest.warns(UserWarning, match="other launches than its record"):
        m2.update(*_port(_batch(32)))
    s = executor_stats(m2)
    assert s["disk_evictions"] == 1 and s["disk_hits"] == 0 and s["compiles"] == 1
    assert any(c["kind"] == "disk_entry_evicted" for c in obs.dump_diagnostics()["breadcrumbs"])
    assert float(m2.compute()) == float(m1.compute())
    assert compile_cache.drain_worker(30)
    assert compile_cache.load_profile(desc)["specs"][0]["launches"] == {}


def test_an_unwritable_store_is_never_fatal(cache_env, monkeypatch, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("TORCHMETRICS_TPU_CACHE_DIR", str(blocker / "below_a_file"))
    m = _accuracy()
    m.update(*_port(_batch(32)))
    assert compile_cache.drain_worker(30)
    s = executor_stats(m)
    assert s["calls"] == 1 and s["disk_stores"] == 0


_PROCESS = r"""
import json, sys, time
import torch
from torchmetrics_tpu_torch.classification import MulticlassAccuracy
from torchmetrics_tpu_torch.ops import compile_cache
from torchmetrics_tpu_torch.ops.executor import executor_stats
m = MulticlassAccuracy(num_classes=5, validate_args=False, device="cpu", executor=True)
g = torch.Generator().manual_seed(0)
preds, target = torch.randn(32, 5, generator=g), torch.randint(0, 5, (32,), generator=g)
t0 = time.perf_counter()
m.update(preds, target)
first_s = time.perf_counter() - t0
compile_cache.drain_worker(60)
s = executor_stats(m)
print(json.dumps({"first_call_s": first_s, "disk_hits": s["disk_hits"], "compiles": s["compiles"],
                  "cache_hits": s["cache_hits"], "disk_stores": s["disk_stores"], "value": float(m.compute()),
                  "jax": "jax" in sys.modules}))
"""


def test_a_cold_and_a_warm_process(tmp_path):
    env = dict(os.environ, TORCHMETRICS_TPU_COMPILE_AHEAD="1", TORCHMETRICS_TPU_CACHE_DIR=str(tmp_path / "x"),
               PYTHONPATH=str(REPO))
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _PROCESS], capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["disk_hits"] == 0 and cold["compiles"] == 1 and cold["disk_stores"] == 1
    assert warm["disk_hits"] >= 1 and warm["compiles"] == 0 and warm["cache_hits"] == 1
    assert warm["value"] == cold["value"] and not cold["jax"] and not warm["jax"]


# --------------------------------------------------------------------- faults


def test_a_capture_takes_out_only_its_own_threads_launches(monkeypatch):
    """Thread A counts launches while thread B is inside a capture scope:
    A's stay in the total and none is in B's record."""
    import types

    mod = types.ModuleType("tm_launch_count_probe")
    mod.launches = 0
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    inside, release = threading.Event(), threading.Event()
    recorded = {}

    def capture():
        with launch_counts.capture_scope() as rec:
            launch_counts.add(mod, "launches", 2)  # the capture's own: not launches
            inside.set()
            release.wait(30)
            launch_counts.add(mod, "launches", 2)
        recorded.update(rec)

    b = threading.Thread(target=capture)
    b.start()
    assert inside.wait(30)
    for _ in range(5):
        launch_counts.add(mod, "launches", 1)  # thread A, the live loop
    release.set()
    b.join(30)
    assert mod.launches == 5
    assert recorded == {(mod.__name__, "launches"): 4}
    assert launch_counts.thread_counts()[(mod.__name__, "launches")] == 5
    assert sum(c.get((mod.__name__, "launches"), 0) for c in launch_counts.all_threads().values()) == mod.launches


def test_every_wrapper_counts_through_the_primitive():
    """No kernel wrapper writes its module's counter directly (such a write
    would escape the per-thread counts a capture reads)."""
    import re

    ops = REPO / "torchmetrics_tpu_torch" / "ops"
    for name in ("bincount", "binned_curve", "topk_kernel", "ssim_kernel", "sqrtm_kernel", "fingerprint"):
        text = (ops / f"{name}.py").read_text()
        assert "launch_counts.add(sys.modules[__name__]" in text, name
        assert not re.search(r"^\s*(launches|calls) \+=", text, re.M), name


def test_library_names_hash_the_toolchain(monkeypatch, tmp_path):
    """A library built with other flags or by another compiler has another
    name, for the CUDA kernels and the host libraries alike."""
    from torchmetrics_tpu_torch import native as host
    from torchmetrics_tpu_torch.native import libstore
    from torchmetrics_tpu_torch.ops import native as cuda

    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    base = (cuda.library_path("bincount"), host.library_path(), host.pesq_library_path())
    monkeypatch.setattr(cuda, "NVCC_FLAGS", cuda.NVCC_FLAGS + ("-lineinfo",))
    monkeypatch.setattr(host, "CXX_FLAGS", host.CXX_FLAGS + ("-g",))
    flagged = (cuda.library_path("bincount"), host.library_path(), host.pesq_library_path())
    assert all(a != b for a, b in zip(base, flagged))
    monkeypatch.setattr(cuda, "NVCC_FLAGS", cuda.NVCC_FLAGS[:-1])
    monkeypatch.setattr(host, "CXX_FLAGS", host.CXX_FLAGS[:-1])
    assert (cuda.library_path("bincount"), host.library_path(), host.pesq_library_path()) == base
    versions = dict(libstore._VERSIONS)
    monkeypatch.setattr(libstore, "_VERSIONS", {k: v + " (another build)" for k, v in versions.items()})
    other = (cuda.library_path("bincount"), host.library_path(), host.pesq_library_path())
    assert all(a != b for a, b in zip(base, other))
    assert "sm_90a" in cuda.toolchain() and "target=host" in host.toolchain()


def _damage(path: Path, mode: str) -> None:
    """Damage a library through a new file (a mapped library is never
    written in place)."""
    data = path.read_bytes()
    path.unlink()
    if mode == "truncate":
        data = data[: len(data) // 2]
    elif mode == "zero":
        data = data[: len(data) // 2] + b"\0" * (len(data) - len(data) // 2)
    elif mode == "flip":
        data = bytes([data[0] ^ 0xFF]) + data[1:]
    elif mode == "garbage":
        data = b"\x00garbage-not-a-library" * 64
    elif mode == "no_sidecar":
        path.with_name(path.name + ".json").unlink()
    elif mode == "other_toolchain":
        sidecar = path.with_name(path.name + ".json")
        record = json.loads(sidecar.read_text())
        record["toolchain"] = "compiler=g++ 1.0|flags=|target=host"
        sidecar.write_text(json.dumps(record))
    path.write_bytes(data)


@pytest.fixture(scope="module")
def built_text_library(tmp_path_factory):
    from torchmetrics_tpu_torch import native as host

    d = tmp_path_factory.mktemp("textlib")
    saved = host.BUILD_DIR
    host.BUILD_DIR = d
    try:
        path = host.build()
    finally:
        host.BUILD_DIR = saved
    return d, path.name


@pytest.mark.parametrize("mode", ["truncate", "zero", "flip", "garbage", "no_sidecar", "other_toolchain"])
def test_a_damaged_host_library_is_rebuilt(monkeypatch, tmp_path, built_text_library, mode):
    import shutil

    from torchmetrics_tpu_torch import native as host

    src, name = built_text_library
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    shutil.copy(src / name, tmp_path / name)
    shutil.copy(src / (name + ".json"), tmp_path / (name + ".json"))
    good = (tmp_path / name).read_bytes()
    _damage(tmp_path / name, mode)
    monkeypatch.setattr(host, "_LIB", None)
    monkeypatch.setattr(host, "_TRIED", False)
    with pytest.warns(RuntimeWarning, match=f"{name}.*damaged or stale"):
        assert host.native_available()
    rebuilt = tmp_path / name
    assert rebuilt.read_bytes() == good or len(rebuilt.read_bytes()) > 0
    assert json.loads((tmp_path / (name + ".json")).read_text())["length"] == len(rebuilt.read_bytes())
    rng = np.random.RandomState(5)
    for _ in range(20):
        a = [int(t) for t in rng.randint(0, 6, rng.randint(0, 12))]
        b = [int(t) for t in rng.randint(0, 6, rng.randint(0, 12))]
        assert host.edit_distance(a, b) == host._py_edit_distance(a, b)


def test_a_host_library_that_cannot_be_rebuilt_falls_back_as_before(monkeypatch, tmp_path, built_text_library):
    import shutil

    from torchmetrics_tpu_torch import native as host

    from torchmetrics_tpu_torch.native import libstore

    src, name = built_text_library
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    shutil.copy(src / name, tmp_path / name)  # no sidecar: damaged
    # a compiler that reports g++'s version (so the name is unchanged) but does not run
    monkeypatch.setitem(libstore._VERSIONS, "no-such-compiler-xyz", libstore.compiler_version(host.CXX))
    monkeypatch.setattr(host, "CXX", "no-such-compiler-xyz")
    monkeypatch.setattr(host, "_LIB", None)
    monkeypatch.setattr(host, "_TRIED", False)
    with pytest.warns(RuntimeWarning):
        assert not host.native_available()
    assert not (tmp_path / name).exists()
    assert host.edit_distance(["a", "b"], ["b"]) == 1


def test_a_damaged_cuda_library_is_discarded_before_nvcc(monkeypatch, tmp_path):
    """Off the card there is no ``nvcc``: a damaged kernel library is still
    warned about and deleted, and the build then raises as it always did,
    with no fallback."""
    from torchmetrics_tpu_torch.ops import native as cuda

    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    path = cuda.library_path("bincount")
    path.write_bytes(b"\x7fELF" + b"\0" * 100)
    with pytest.warns(RuntimeWarning, match="damaged or stale"), pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build(["bincount"])
    assert not path.exists()


_BUILDER = r"""
import ctypes, sys, time, warnings
from pathlib import Path
warnings.simplefilter("error", RuntimeWarning)  # a discarded library would warn
from torchmetrics_tpu_torch import native as host
host.BUILD_DIR = Path(sys.argv[1])
go = Path(sys.argv[2])
print("ready", flush=True)
while not go.exists():
    time.sleep(0.01)
path = host.build()
print(path.name, path.stat().st_ino, host.edit_distance(["a", "b", "c"], ["b", "c", "d"]), flush=True)
"""


def _builder(build_dir: Path, go: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", _BUILDER, str(build_dir), str(go)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(REPO)),
    )


def test_a_library_between_its_rename_and_its_sidecar_is_waited_for(tmp_path, built_text_library):
    """A build holds the library's lock from its check to its sidecar: a
    second process that builds the same library meanwhile waits, then loads
    the sealed library; it never finds the library without its sidecar,
    deletes it and builds it again."""
    import shutil

    from torchmetrics_tpu_torch import native as host
    from torchmetrics_tpu_torch.native import libstore

    src, name = built_text_library
    path = tmp_path / name
    go = tmp_path / "go"
    go.touch()
    with libstore.locked(path):
        shutil.copy(src / name, path)  # renamed into place, its sidecar not yet written
        inode = path.stat().st_ino
        proc = _builder(tmp_path, go)
        assert proc.stdout.readline().strip() == "ready"
        time.sleep(1.0)
        assert proc.poll() is None and path.exists() and not libstore.sidecar_path(path).exists()
        libstore.seal(path, host.toolchain())
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    assert out.split() == [name, str(inode), "2"]
    assert libstore.check(path, host.toolchain()) is None


def test_processes_that_build_one_library_at_once_all_load_it(tmp_path):
    """Three processes build the text library into one empty directory at
    the same moment: one compiles, the others wait for it; none warns, all
    load the same file."""
    from torchmetrics_tpu_torch import native as host
    from torchmetrics_tpu_torch.native import libstore

    build_dir, go = tmp_path / "build", tmp_path / "go"
    procs = [_builder(build_dir, go) for _ in range(3)]
    for proc in procs:
        assert proc.stdout.readline().strip() == "ready"
    go.touch()
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        outs.append(out.split())
    assert all(o == outs[0] for o in outs) and outs[0][2] == "2"
    (library,) = build_dir.glob("*.so")
    assert library.name == outs[0][0] and str(library.stat().st_ino) == outs[0][1]
    saved = host.BUILD_DIR
    try:
        host.BUILD_DIR = build_dir
        assert libstore.check(library, host.toolchain()) is None and host.library_path() == library
    finally:
        host.BUILD_DIR = saved


def test_a_key_is_stored_once_across_processes_of_the_same_owner(cache_env):
    """A spec read back from the store and the same key built anew are one
    record: a third instance over the same traffic writes nothing."""
    for expected_stores in (2, 0, 0):
        m = _accuracy()
        for i, n in enumerate((32, 32, 20)):
            m.update(*_port(_batch(n, i)))
        assert compile_cache.drain_worker(30)
        assert executor_stats(m)["disk_stores"] == expected_stores
    probe = _accuracy()
    assert len(compile_cache.load_profile(probe._get_executor().store_desc())["specs"]) == 2
