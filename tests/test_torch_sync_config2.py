"""The JAX package's config-2 collection (``bench.py``: confusion matrix, F1,
precision, recall and accuracy over 10 classes, a 1024-sample batch split
over 8 devices) synced across 8 spawned gloo ranks of the port, against the
JAX package's 8-device ``shard_map`` sync of the same per-rank batches.

Counts (the synced states, the update count) must be equal as integers;
computed values within rtol 1e-5. Each rank computes twice: ``compute()``
(sync on compute) and ``functional_compute(functional_sync(state()))``.

This module imports only torch, numpy and the port at its top level: the
ranks import it to find their target.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch import classification as cls
from torchmetrics_tpu_torch.parallel import sync as psync
from helpers.torch_world import run_world

WORLD = 8
C = 10
PER_RANK = 128  # bench.py config 2: batch 1024 over 8 devices
STEPS = 2


def _members(pkg, **extra):
    return {
        "confmat": pkg.MulticlassConfusionMatrix(num_classes=C, validate_args=False, **extra),
        "f1": pkg.MulticlassF1Score(num_classes=C, validate_args=False, **extra),
        "precision": pkg.MulticlassPrecision(num_classes=C, validate_args=False, **extra),
        "recall": pkg.MulticlassRecall(num_classes=C, validate_args=False, **extra),
        "acc": pkg.MulticlassAccuracy(num_classes=C, validate_args=False, **extra),
    }


def _batches(rank):
    rng = np.random.RandomState(1000 + rank)
    return [(rng.randn(PER_RANK, C).astype(np.float32), rng.randint(0, C, PER_RANK)) for _ in range(STEPS)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().copy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def _rank_target(rank, world):
    coll = tm.MetricCollection(_members(cls, device="cpu"), device="cpu")
    for preds, target in _batches(rank):
        coll.update(torch.from_numpy(preds), torch.from_numpy(target))
    r0, g0 = psync.all_reduces, psync.all_gathers
    synced = coll.functional_sync(coll.state())
    counts = (psync.all_reduces - r0, psync.all_gathers - g0)
    return {
        "groups": [list(g) for g in coll.compute_groups.values()],
        "synced": _np(synced),
        "functional": _np(coll.functional_compute(synced)),
        "computed": _np(coll.compute()),
        "counts": counts,
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_world(WORLD, tmp_path_factory.mktemp("gloo8"), _rank_target)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's collection: update, ``functional_sync`` and
    ``functional_compute`` in ``shard_map`` over the 8 CPU devices, rank r's
    batches on device r."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu.classification as jax_cls
    from torchmetrics_tpu.parallel.sync import shard_map_compat

    coll = jax_tm.MetricCollection(_members(jax_cls, executor=False), executor=False)
    first = _batches(0)[0]
    coll.resolve_compute_groups(jnp.asarray(first[0]), jnp.asarray(first[1]))
    states0 = coll.functional_init()
    # (rank, step, ...) flattened rank-major: device r sees rank r's steps
    preds = np.concatenate([np.stack([b[0] for b in _batches(r)]) for r in range(WORLD)])
    target = np.concatenate([np.stack([b[1] for b in _batches(r)]) for r in range(WORLD)])

    def body(p, t):
        st = states0
        for i in range(STEPS):
            st = coll.functional_update(st, p[i], t[i])
        st = {k: {**v, "_update_count": STEPS} for k, v in st.items()}
        synced = coll.functional_sync(st, "batch")
        return synced, coll.functional_compute(synced)

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("batch",))
    step = shard_map_compat(body, mesh, (P("batch"), P("batch")), P(), check_vma=False)
    synced, values = step(jnp.asarray(preds), jnp.asarray(target))
    groups = [list(g) for g in coll.compute_groups.values()]
    return groups, jax.tree_util.tree_map(np.asarray, synced), jax.tree_util.tree_map(np.asarray, values)


def _state_of(member, groups, states):
    leader = next(g[0] for g in groups if member in g)
    return states[leader]


def test_collection_synced_across_8_ranks_equals_jax_shard_map(ranks, jax_reference):
    ref_groups, ref_states, ref_values = jax_reference
    for rank, res in enumerate(ranks):
        assert sorted(map(sorted, res["groups"])) == sorted(map(sorted, ref_groups))
        for member in ("confmat", "f1", "precision", "recall", "acc"):
            port = _state_of(member, res["groups"], res["synced"])
            ref = _state_of(member, ref_groups, ref_states)
            assert set(port) == set(ref)
            for field in ref:  # counts equal as integers
                np.testing.assert_array_equal(
                    np.asarray(port[field]).astype(np.int64), np.asarray(ref[field]).astype(np.int64),
                    err_msg=f"rank {rank} {member}.{field}",
                )
            assert int(port["_update_count"]) == WORLD * STEPS
        for key in ("computed", "functional"):
            assert set(res[key]) == set(ref_values)
            for name, want in ref_values.items():
                got = np.asarray(res[key][name])
                if got.dtype.kind in "iu":
                    np.testing.assert_array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64))
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=f"rank {rank} {key} {name}")


def test_collection_sync_is_two_all_reduces(ranks):
    """Every leader's int32 counts ride one all_reduce, every update count
    (int64) one more; no gathers."""
    for res in ranks:
        assert res["counts"] == (2, 0)
