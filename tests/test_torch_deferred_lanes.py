"""Deferred session lanes and windows of the PyTorch port
(``lanes.DeferredLaneStep``, ``make_deferred_lane_step``) held to the JAX
package's on the 8-device virtual CPU mesh: the port stacks the 8 shards
on one process, splits each dispatch's rows in 8 contiguous slices as
``shard_map`` splits them, and folds the shard into the lane index, so a
round stays one row-batched update. Per-shard stacked states bit-equal
JAX's, unwindowed and at W = 4 (with ``advance_windows`` and explicit
window routing), the reduced lanes bit-equal JAX's and the port's
non-deferred lanes on the same rounds; the sharded windowed ``load_state``
folds the ring stacks (the clock by ``max``); one ``bincount`` launch a
round with the counting family.

Float inputs are integer-valued, so sums are exact in any order.
"""
import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.lanes as tl
from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
from torchmetrics_tpu_torch.ops import kernels

C = 5
SHARDS = 8
CAP = 8
CPU = "cpu"
ROWS = 16  # a dispatch: 2 rows a shard


def _family(kind, name, window):
    if kind == "jax":
        import torchmetrics_tpu as jtm
        from torchmetrics_tpu import classification as jcls

        m = jcls.MulticlassConfusionMatrix(num_classes=C, validate_args=False) if name == "confmat" else jtm.SumMetric()
    else:
        m = MulticlassConfusionMatrix(num_classes=C, validate_args=False, device=CPU) if name == "confmat" else tm.SumMetric(device=CPU)
    return m if window is None else m.windowed(window, lateness=1)


def _rounds(name, seed=0, n=5):
    """(lane ids, batch) a dispatch: every lane at most once a shard slice,
    sentinel rows (== CAP) between them, one explicit-window round."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        ids = np.concatenate([rng.permutation(CAP + 1)[:2] for _ in range(SHARDS)]).astype(np.int32)
        if name == "confmat":
            batch = (rng.randint(0, C, (ROWS, 6)), rng.randint(0, C, (ROWS, 6)))
        else:
            batch = (rng.randint(-5, 9, (ROWS, 3)).astype(np.float32),)
        out.append((ids, batch))
    return out


def _jax_run(name, window, rounds, mesh):
    import jax.numpy as jnp
    import torchmetrics_tpu as jtm

    laned = jtm.LanedMetric(_family("jax", name, window), capacity=CAP, reduce="deferred", executor=False)
    step = jtm.lanes.make_deferred_lane_step(laned, mesh)
    st = step.init_states()
    for k, (ids, batch) in enumerate(rounds):
        args = tuple(jnp.asarray(b) for b in batch)
        if window is not None and k == len(rounds) - 1:
            st = step.local_step(st, jnp.asarray(ids), *args, window=jnp.asarray(1, jnp.int32))
            continue
        st = step.local_step(st, jnp.asarray(ids), *args)
        if window is not None:
            st = step.advance_windows(st)
    return st, step.reduce(st)


def _port_run(name, window, rounds, launches=None):
    laned = tl.LanedMetric(_family("port", name, window), capacity=CAP, reduce="deferred")
    step = tl.make_deferred_lane_step(laned, SHARDS)
    st = step.init_states()
    for k, (ids, batch) in enumerate(rounds):
        args = tuple(torch.from_numpy(b) for b in batch)
        if window is not None and k == len(rounds) - 1:
            st = step.local_step(st, ids, *args, window=1)
            continue
        st = step.local_step(st, ids, *args)
        if window is not None:
            st = step.advance_windows(st)
    reduced = step.reduce(st)
    return laned, step, st, reduced


def _plain_run(name, window, rounds):
    """The port's non-deferred lanes on the same rounds (the rows of a
    dispatch whose lanes repeat across shards go in separate rounds, one a
    shard, so every round scatters to distinct lanes)."""
    laned = tl.LanedMetric(_family("port", name, window), capacity=CAP)
    k_rows = ROWS // SHARDS
    for k, (ids, batch) in enumerate(rounds):
        for s in range(SHARDS):
            rows = slice(s * k_rows, (s + 1) * k_rows)
            args = tuple(torch.from_numpy(b[rows]) for b in batch)
            if window is not None and k == len(rounds) - 1:
                laned.update(ids[rows], *args, window=1)
            else:
                laned.update(ids[rows], *args)
        if window is not None and k < len(rounds) - 1:
            laned.advance_windows()
    return laned


def _equal(got, want):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["confmat", "sum"])
@pytest.mark.parametrize("window", [None, 4])
def test_deferred_lanes_equal_jax_shard_map_and_plain_lanes(name, window, mesh):
    rounds = _rounds(name, seed=len(name) + (window or 0))
    jst, jred = _jax_run(name, window, rounds, mesh)
    laned, step, tst, tred = _port_run(name, window, rounds)
    assert set(tst) == set(jst)
    for k in jst:
        _equal(tst[k], jst[k])  # every shard's lane copies
        _equal(tred[k], jred[k])
    plain = _plain_run(name, window, rounds)
    step.install_reduced(tred)
    for k in laned._defaults:
        assert torch.equal(laned._state[k], plain._state[k]), k
    assert not laned.deferred_pending


def test_a_deferred_round_is_one_row_folded_bincount():
    spec = kernels.get_kernel("bincount")
    calls = []
    kernels.register_kernel(kernels.KernelSpec(
        name="bincount", reference=lambda *a, **k: (calls.append(a[2]), spec.reference(*a, **k))[1], cuda=spec.cuda))
    try:
        rounds = _rounds("confmat", seed=3)
        laned, step, st, _ = _port_run("confmat", None, rounds)
    finally:
        kernels.register_kernel(spec)
    # one launch a round, over the round's live rows x C^2 folded bins
    assert calls == [int((ids < CAP).sum()) * C * C for ids, _ in rounds]


def test_deferred_rounds_must_split_evenly_and_state_stays_unwritten():
    laned = tl.LanedMetric(tm.SumMetric(device=CPU), capacity=CAP)
    step = tl.make_deferred_lane_step(laned, 3)
    st = step.init_states()
    with pytest.raises(ValueError, match="split evenly"):
        step.local_step(st, np.zeros(4, np.int32), torch.ones(4, 2))
    before = {k: v.clone() for k, v in st.items()}
    out = step.local_step(st, np.array([0, 1, 2], np.int32), torch.ones(3, 2))
    assert all(torch.equal(st[k], before[k]) for k in st)  # out of place
    assert out["sum_value"].shape == (3, CAP) and float(out["sum_value"].sum()) == 6.0


def test_sharded_windowed_load_state_folds_the_ring_stacks():
    """A windowed laned export stacked on 8 shards (as a deferred loop
    carries it) restores folded: counts summed, the clock by max; and an
    unlaned windowed metric restores its own stacked export likewise."""
    rounds = _rounds("confmat", seed=11)
    laned, step, st, reduced = _port_run("confmat", 4, rounds)
    twin = tl.LanedMetric(_family("port", "confmat", 4), capacity=CAP)
    twin.load_state({**st, "_sharded_shards": SHARDS})
    step.install_reduced(reduced)
    for k in laned._defaults:
        assert torch.equal(twin._state[k], laned._state[k]), k
    win = _family("port", "sum", 4)
    stacked = win.init_sharded_state(SHARDS)
    stacked["sum_value"] = stacked["sum_value"] + torch.arange(SHARDS, dtype=torch.float32).reshape(-1, 1)
    stacked["window_head"] = torch.full((SHARDS,), 2, dtype=torch.int32)
    win.load_state({**stacked, "_sharded_shards": SHARDS})
    assert win.clock == 2 and float(win._state["sum_value"][0]) == float(sum(range(SHARDS)))


def test_the_jax_sharded_windowed_export_restores_in_the_port(mesh):
    """The JAX package's deferred windowed lane states, exported stacked,
    install into the port's laned metric folded."""
    rounds = _rounds("sum", seed=21)
    jst, jred = _jax_run("sum", 4, rounds, mesh)
    port = tl.LanedMetric(_family("port", "sum", 4), capacity=CAP)
    port.load_state({**{k: torch.from_numpy(np.array(v)) for k, v in jst.items()}, "_sharded_shards": SHARDS})
    for k in jred:
        _equal(port._state[k], jred[k])
