"""The block-quantized sync of the PyTorch port
(``torchmetrics_tpu_torch/parallel/quantized.py``, ``sync_precision=``)
held to the JAX package.

``block_encode``'s codes and scales are bit-equal to the JAX package's at 8
and 16 bits over several block sizes for normal-range scales (a block whose
scale is subnormal keeps it in the port and is flushed to 0 by the JAX
package on the CPU: a reference quirk), a ragged last block included (the
same float32 order of operations: max-abs scales, a true division, round
half to even, clip); decoding matches; integer input raises ``TypeError``.
In spawned gloo worlds of 2, 3 and 8 ranks a quantized sync of sum, mean,
max and min float fields stays within ``reduce_error_bound`` elementwise
of the exact reduction while the integer field beside them syncs bit for
bit; ``sync_async().result()`` equals a blocking ``sync()``; a
``quantized_sync`` gather stays within half a step. The analytic wire
bytes equal the JAX package's ``state_wire_bytes``, the uplink wire format
its ``encode_canonical``.

This module imports only torch, numpy and the port at its top level: the
ranks import it to find their target.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.parallel import quantized as q
from torchmetrics_tpu_torch.parallel import sync as psync
from helpers.torch_world import run_world

FXS = ("sum", "mean", "max", "min")
N = 700  # elements a field: two full blocks of 256 and a ragged one
CPU = "cpu"


def _within(err, bound, x):
    """``err <= bound`` up to float32 rounding, as both packages compute: the
    quotient x / scale rounds at 2^-24 relative, which can carry a code one
    tie across (up to 2^-24 * qmax of a step: under 0.4% of the bound at
    16 bits), and code x scale rounds at 2^-24 of the value."""
    return bool((err <= bound * (1 + 2.0**-7) + 1e-6 + np.abs(x) * 2.0**-22).all())


def _x(seed, n=10_007, scale=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float32)
    if scale:
        x *= np.linspace(0.001, 1000.0, n, dtype=np.float32)
    x[::97] = 0.0  # exact zeros and a zero block below
    return x


# ------------------------------------------------------------ the encoder


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("block", [1, 7, 64, 256, 1000])
def test_block_encode_is_bit_equal_to_jax(bits, block):
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel import quantized as jq

    x = _x(bits * 1000 + block)
    x[:block] = 0.0
    codes, scales = q.block_encode(torch.from_numpy(x), bits=bits, block_size=block)
    jcodes, jscales = jq.block_encode(jnp.asarray(x), bits=bits, block_size=block)
    assert codes.dtype == {8: torch.int8, 16: torch.int16}[bits]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    got = q.block_decode(codes, scales, x.size, x.shape, torch.float32)
    want = jq.block_decode(jcodes, jscales, x.size, x.shape, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bound = q.reduce_error_bound(x[None].astype(np.float64), "max", bits, block)
    assert _within(np.abs(got.numpy().astype(np.float64) - x), bound, x)


@pytest.mark.parametrize(
    "bits,x",
    [
        (8, [3e-38, -1e-38]),
        (8, [0.5 * 127 * 2.0**-126, -0.2 * 127 * 2.0**-126]),
        (16, [0.5 * 32767 * 2.0**-126, -0.2 * 32767 * 2.0**-126]),
    ],
    ids=["8bit_queue_case", "8bit_under_trigger", "16bit_under_trigger"],
)
def test_subnormal_scale_block_holds_the_bound_where_jax_flushes(bits, x):
    """A block whose max |x| is below qmax x 2^-126 has a subnormal scale.
    The port keeps it and its decode holds ``reduce_error_bound``; the JAX
    package on the CPU flushes the scale to 0 and decodes zeros (a
    reference quirk, ROADMAP Queue C), breaking its own bound."""
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel import quantized as jq

    x = np.asarray(x, dtype=np.float32)
    codes, scales = q.block_encode(torch.from_numpy(x), bits=bits, block_size=2)
    got = q.block_decode(codes, scales, x.size, x.shape, torch.float32).numpy().astype(np.float64)
    bound = q.reduce_error_bound(x[None].astype(np.float64), "max", bits, 2)
    assert 0 < float(scales[0]) < np.finfo(np.float32).tiny
    # at these magnitudes _within's absolute slack would pass anything: hold
    # the bound itself (with its float32 rounding allowance)
    assert (np.abs(got - x) <= bound * (1 + 2.0**-7)).all() and int(codes.abs().max()) == 2 ** (bits - 1) - 1
    jcodes, jscales = jq.block_encode(jnp.asarray(x), bits=bits, block_size=2)
    jgot = np.asarray(jq.block_decode(jcodes, jscales, x.size, x.shape, jnp.float32)).astype(np.float64)
    assert float(np.asarray(jscales)[0]) == 0.0 and not jgot.any()
    assert (np.abs(jgot - x) > bound * (1 + 2.0**-7)).any()
    if bits == 8 and x[0] == np.float32(3e-38):
        assert np.asarray(jcodes).tolist() == [[127, 0]] and codes.tolist() == [[127, -42]]


def test_block_encode_of_float64_and_a_tie_rounds_half_to_even():
    x = torch.tensor([2.5, -2.5, 127.0], dtype=torch.float64)  # scale 1: 2.5 and -2.5 are ties
    codes, scales = q.block_encode(x, bits=8, block_size=3)
    assert codes.tolist() == [[2, -2, 127]] and scales.tolist() == [1.0]
    back = q.block_decode(codes, scales, 3, (3,), torch.float64)
    assert back.dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.bool, torch.uint8])
def test_block_encode_refuses_integer_payloads(dtype):
    with pytest.raises(TypeError, match="integer-exact"):
        q.block_encode(torch.zeros(8, dtype=dtype))


def test_block_encode_rejects_bad_arguments():
    with pytest.raises(ValueError, match="bits"):
        q.block_encode(torch.zeros(4), bits=4)
    with pytest.raises(ValueError, match="block_size"):
        q.block_encode(torch.zeros(4), block_size=0)


@pytest.mark.parametrize("fx", FXS)
@pytest.mark.parametrize("world", [2, 5])
def test_reduce_error_bound_equals_jax(fx, world):
    from torchmetrics_tpu.parallel import quantized as jq

    stack = np.stack([_x(world * 10 + r, n=N) for r in range(world)])
    np.testing.assert_array_equal(q.reduce_error_bound(stack, fx, 8, 256), jq.reduce_error_bound(stack, fx, 8, 256))
    np.testing.assert_array_equal(q.reduce_error_bound(torch.from_numpy(stack), fx, 16, 100),
                                  jq.reduce_error_bound(stack, fx, 16, 100))


# --------------------------------------------------------- wire accounting


def _wire_states():
    rng = np.random.RandomState(3)
    return {
        "cov": rng.randn(33, 17).astype(np.float32),
        "mean": rng.randn(5).astype(np.float32),
        "counts": rng.randint(0, 9, (7, 3)).astype(np.int32),
        "scalar": np.float32(1.5),
        "seen": [rng.randn(4).astype(np.float32), rng.randn(6).astype(np.float32)],
    }


@pytest.mark.parametrize("qspec", [None, (8, 256), (16, 48)])
def test_state_wire_bytes_equal_jax(qspec):
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel import quantized as jq

    states = _wire_states()
    reds = {"cov": "sum", "mean": "mean", "counts": "sum", "scalar": "max", "seen": "cat"}
    qspecs = None if qspec is None else {k: qspec for k in states}
    tstates = {k: ([torch.from_numpy(v) for v in x] if isinstance(x, list) else torch.as_tensor(x)) for k, x in states.items()}
    jstates = {k: ([jnp.asarray(v) for v in x] if isinstance(x, list) else jnp.asarray(x)) for k, x in states.items()}
    assert q.state_wire_bytes(tstates, reds, qspecs) == jq.state_wire_bytes(jstates, reds, qspecs)
    assert q.quantized_wire_bytes(1000, 8, 256) == jq.quantized_wire_bytes(1000, 8, 256)


@pytest.mark.parametrize("bits", [8, 16])
def test_canonical_wire_format_equals_jax(bits):
    from torchmetrics_tpu.parallel import quantized as jq

    states = {k: v for k, v in _wire_states().items() if k != "seen"}
    wire = q.encode_canonical(states, bits=bits, block_size=48)
    jwire = jq.encode_canonical(states, bits=bits, block_size=48)
    assert wire["wire_version"] == jwire["wire_version"]
    for k, f in wire["fields"].items():
        jf = jwire["fields"][k]
        assert f["enc"] == jf["enc"]
        if f["enc"] == "q":
            np.testing.assert_array_equal(f["codes"], jf["codes"])
            np.testing.assert_array_equal(f["scales"], jf["scales"])
    assert q.wire_payload_bytes(wire) == jq.wire_payload_bytes(jwire)
    dec, jdec = q.decode_canonical(wire), jq.decode_canonical(jwire)
    for k in states:
        np.testing.assert_array_equal(dec[k], jdec[k])
    np.testing.assert_array_equal(dec["counts"], states["counts"])  # integers ride raw
    with pytest.raises(ValueError, match="wire_version"):
        q.decode_canonical({"wire_version": 99, "fields": {}})


# ------------------------------------------------------------ the policy


def test_precision_knobs_resolve_like_jax(monkeypatch):
    from torchmetrics_tpu import aggregation as jagg
    from torchmetrics_tpu import classification as jcls

    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    kw = {"sync_precision": "quantized", "sync_quant_bits": 16, "sync_quant_block": 64}
    pairs = [
        (tm.MeanMetric(device=CPU, **kw), jagg.MeanMetric(executor=False, **kw)),
        (MulticlassAccuracy(num_classes=5, device=CPU, **kw), jcls.MulticlassAccuracy(num_classes=5, executor=False, **kw)),
    ]
    for t, j in pairs:
        assert t._sync_qspecs() == j._sync_qspecs()
    assert tm.MeanMetric(device=CPU)._sync_qspecs() == {"mean_value": None, "weight": None}
    pinned = tm.SumMetric(sync_precision="quantized", device=CPU)
    pinned.add_state("exact_float", torch.zeros(3), dist_reduce_fx="sum", sync_precision="exact")
    assert pinned._sync_qspecs()["exact_float"] is None and pinned._sync_qspecs()["sum_value"] == (8, 256)
    monkeypatch.setenv(q.SYNC_PRECISION_ENV, "quantized")
    assert tm.SumMetric(device=CPU).sync_precision == "quantized"
    monkeypatch.setenv(q.SYNC_PRECISION_ENV, "coarse")
    with pytest.raises(ValueError, match="TORCHMETRICS_TPU_SYNC_PRECISION"):
        tm.SumMetric(device=CPU)


@pytest.mark.parametrize("kw,match", [
    ({"sync_precision": "lossy"}, "sync_precision"),
    ({"sync_quant_bits": 4}, "sync_quant_bits"),
    ({"sync_quant_block": 0}, "sync_quant_block"),
    ({"sync_quant_block": True}, "sync_quant_block"),
])
def test_bad_precision_knobs_are_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        tm.SumMetric(device=CPU, **kw)


def test_windowed_metric_inherits_the_inner_precision():
    inner = tm.SumMetric(sync_precision="quantized", sync_quant_bits=16, sync_quant_block=32, device=CPU)
    win = inner.windowed(4)
    assert (win.sync_precision, win.sync_quant_bits, win.sync_quant_block) == ("quantized", 16, 32)
    assert win._sync_qspecs()["sum_value"] == (16, 32) and win._sync_qspecs()["window_head"] is None
    assert tm.SumMetric(device=CPU).windowed(4, sync_precision="exact")._sync_qspecs()["sum_value"] is None


# ------------------------------------------------------------ gloo worlds


class _Family(tm.Metric):
    """One float field a reduction and an int32 count beside them."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        for fx in FXS:
            self.add_state(f"f_{fx}", torch.zeros(N), dist_reduce_fx=fx)
        self.add_state("count", torch.zeros(N, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, values, counts):
        for fx in FXS:
            setattr(self, f"f_{fx}", getattr(self, f"f_{fx}") + values)
        self.count = self.count + counts

    def compute(self):
        return self.f_sum


def _rank_state(rank):
    rng = np.random.RandomState(900 + rank)
    values = (rng.randn(N) * rng.choice([0.01, 1.0, 1e4], N)).astype(np.float32)
    counts = rng.randint(0, 1000, N).astype(np.int32)
    return values, counts


def _rank_cases(rank, world):
    """Every bits: the quantized sync of this rank's state, its local state,
    and whether ``sync_async().result()`` equalled a blocking ``sync()``;
    plus a quantized ``CatMetric`` gather."""
    values, counts = _rank_state(rank)
    out = {"local": {}, "synced": {}, "async_equal": {}}
    for bits in (8, 16):
        m = _Family(sync_precision="quantized", sync_quant_bits=bits, device=CPU)
        m.update(torch.from_numpy(values), torch.from_numpy(counts))
        state = m.state()
        r0, g0 = psync.all_reduces, psync.all_gathers
        synced = m.functional_sync(state)
        out.setdefault("collectives", {})[bits] = (psync.all_reduces - r0, psync.all_gathers - g0)
        out["local"][bits] = {k: state[k].numpy() for k in m._defaults}
        out["synced"][bits] = {k: synced[k].numpy() for k in m._defaults}
        fut = m.sync_async().result(timeout=60.0)
        m.sync()
        blocking = m.state()
        m.unsync()
        out["async_equal"][bits] = all(torch.equal(fut[k], blocking[k]) for k in m._defaults)
    cat = tm.CatMetric(dist_sync_fn=q.quantized_sync(bits=8), device=CPU)
    cat.update(torch.from_numpy(values[:300]))
    out["cat"] = cat.compute().numpy()
    return out


@pytest.fixture(scope="module", params=[2, 3, 8])
def world_results(request, tmp_path_factory):
    world = request.param
    return world, run_world(world, tmp_path_factory.mktemp(f"quantized{world}"), _rank_cases, timeout=240.0)


def test_quantized_sync_stays_within_its_bound_and_counts_stay_exact(world_results):
    world, results = world_results
    for bits in (8, 16):
        for fx in FXS:
            stack = np.stack([r["local"][bits][f"f_{fx}"] for r in results]).astype(np.float64)
            exact = {"sum": stack.sum(0), "mean": stack.mean(0), "max": stack.max(0), "min": stack.min(0)}[fx]
            bound = q.reduce_error_bound(stack, fx, bits, q.DEFAULT_BLOCK)
            for r in results:
                err = np.abs(r["synced"][bits][f"f_{fx}"].astype(np.float64) - exact)
                assert _within(err, bound, exact), (world, bits, fx, err.max())
            assert any(np.abs(r["synced"][bits][f"f_{fx}"] - exact).max() > 0 for r in results)  # it did quantize
        counts = np.stack([r["local"][bits]["count"] for r in results]).sum(0)
        for r in results:
            np.testing.assert_array_equal(r["synced"][bits]["count"], counts)
            assert r["synced"][bits]["count"].dtype == np.int32
            assert r["async_equal"][bits]
        # every rank holds the same dequantized result
        for fx in FXS:
            for r in results[1:]:
                np.testing.assert_array_equal(r["synced"][bits][f"f_{fx}"], results[0]["synced"][bits][f"f_{fx}"])


def test_quantized_collectives_are_two_gathers_a_group(world_results):
    """Each float group costs two gathers (codes, scales); the int32 sum and
    the int64 count one reduce each: 4 groups x 2 gathers, 2 reduces."""
    _, results = world_results
    for r in results:
        assert r["collectives"][8] == (2, 8) and r["collectives"][16] == (2, 8)


def test_quantized_cat_gather_stays_within_half_a_step(world_results):
    world, results = world_results
    parts = [_rank_state(r)[0][:300] for r in range(world)]
    exact = np.concatenate(parts)
    bound = np.concatenate([q.reduce_error_bound(p[None].astype(np.float64), "max", 8, q.DEFAULT_BLOCK) for p in parts])
    for r in results:
        assert _within(np.abs(r["cat"].astype(np.float64) - exact), bound, exact)
