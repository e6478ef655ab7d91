"""The port's staging-slab ingest (``torchmetrics_tpu_torch/ops/ingest.py``):
slab reuse and retirement, the in-place pack and its fallbacks, the
vectorised screen on the slab, the upload of live rows only, the pack
worker and its backpressure, the discard of a slab whose round raised, and
rounds routed through the pipeline bit-equal to the plain pack, with the
flags the JAX package reads. Every pipeline a test starts is drained with a
timeout of its own, and ``reset_for_tests`` runs in the fixture's teardown.
"""
import threading

import numpy as np
import pytest
import torch

from torchmetrics_tpu.ops import ingest as jingest
from torchmetrics_tpu_torch import lanes as tl
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.aggregation import SumMetric
from torchmetrics_tpu_torch.ops import ingest

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _ingest_reset():
    ingest.reset_for_tests()
    yield
    assert ingest.drain_pipeline(timeout=30.0)
    ingest.reset_for_tests()


def _rows(n, seed=0, width=3, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(width).astype(dtype), rng.randint(0, 5, 2)) for _ in range(n)]


def test_flags_and_defaults_match_jax(monkeypatch):
    for name in ("PIPELINE_ENV", "RING_DEPTH_ENV", "QUEUE_ENV", "DEFAULT_RING_DEPTH", "DEFAULT_QUEUE_MAXSIZE", "MAX_SPECS"):
        assert getattr(ingest, name) == getattr(jingest, name)
    monkeypatch.setenv(ingest.PIPELINE_ENV, "off")
    assert not ingest.pipeline_enabled()
    monkeypatch.setenv(ingest.RING_DEPTH_ENV, "0")
    assert ingest.SlabRing()._depth == 1
    assert ingest.device_put_aliases_host() is False


def test_make_spec_matches_jax():
    batches = _rows(3)
    assert ingest.make_spec(batches, 8) == jingest.make_spec(batches, 8)
    assert ingest.make_spec([(np.asarray(["x"]),)], 8) is None
    assert ingest.make_spec([(object(),)], 8) is None
    assert ingest.make_spec([], 8) is None


def test_pack_writes_in_place_and_screens_like_the_inline_screen():
    batches = _rows(5)
    batches[2] = (np.asarray([1.0, np.nan, 0.0], np.float32), batches[2][1])
    ring = ingest.SlabRing(depth=2)
    packed = ingest.pack_inline(ring, batches, 5, 8, screen=True)
    assert packed is not None and packed.rows == 5
    np.testing.assert_array_equal(packed.slab.args[0][:5], np.stack([b[0] for b in batches]))
    np.testing.assert_array_equal(packed.slab.tensors[1][:5].numpy(), np.stack([b[1] for b in batches]))
    _, want = tl._stack_rows_screened(batches)
    assert packed.reasons == want == [None, None, "leaf 0 carries non-finite values", None, None]


@pytest.mark.parametrize(
    "deviant",
    [
        lambda b: (b[0].astype(np.float64), b[1]),  # dtype drift: the plain pack promotes
        lambda b: (np.zeros(4, np.float32), b[1]),  # ragged
        lambda b: (b[0],),  # leaf count
    ],
    ids=["dtype", "ragged", "leaves"],
)
def test_layout_deviants_fall_back_and_release_the_slab(deviant):
    batches = _rows(4)
    batches[1] = deviant(batches[1])
    ring = ingest.SlabRing(depth=1)
    assert ingest.pack_inline(ring, batches, 4, 8, screen=False) is None
    spec = ingest.make_spec(batches, 8)
    assert not any(s.busy for s in ring._slabs[spec])  # the slab went straight back


def test_ring_reuses_retired_slabs_and_refuses_busy_ones():
    batches = _rows(3)
    ring = ingest.SlabRing(depth=2)
    a = ingest.pack_inline(ring, batches, 3, 8, screen=False)
    b = ingest.pack_inline(ring, batches, 3, 8, screen=False)
    assert a.slab is not b.slab and ring.stats["allocated"] == 2
    assert ingest.pack_inline(ring, batches, 3, 8, screen=False) is None  # both checked out
    assert ring.stats["busy"] == 1
    ring.commit(a.slab, ())  # retired on the CPU: no event to wait for
    c = ingest.pack_inline(ring, batches, 3, 8, screen=False)
    assert c.slab is a.slab and a.slab.generation == 2 and ring.stats["reused"] == 1
    ring.discard(b.slab)
    assert ring.stats["discarded"] == 1 and b.slab not in ring._slabs[ingest.make_spec(batches, 8)]


def test_stamp_and_upload_copies_only_live_rows():
    batches = _rows(5)
    ring = ingest.SlabRing(depth=1)
    packed = ingest.pack_inline(ring, batches, 5, 8, screen=False)
    obs.reset()
    ids, up = ingest.stamp_and_upload(packed, [3, 1, 8, 0, 2], sentinel=8, device=CPU)
    assert ids.tolist() == [3, 1, 8, 0, 2] and packed.slab.lane_ids[5:].tolist() == [8, 8, 8]
    assert [tuple(t.shape) for t in up] == [(5, 3), (5, 2)]
    assert up[0].data_ptr() != packed.slab.tensors[0].data_ptr()  # a copy, never an alias
    assert obs.counters_snapshot()["lanes.h2d_bytes"] == 5 * 3 * 4 + 5 * 2 * 8 + 5 * 4


def test_dispatch_scope_commits_or_discards():
    batches = _rows(2)
    ring = ingest.SlabRing(depth=2)
    packed = ingest.pack_inline(ring, batches, 2, 8, screen=False)
    with ingest.dispatch_scope(packed.slab, ring, CPU):
        pass
    assert not packed.slab.busy and packed.slab.tokens == ()
    packed = ingest.pack_inline(ring, batches, 2, 8, screen=False)
    with pytest.raises(RuntimeError):
        with ingest.dispatch_scope(packed.slab, ring, CPU):
            raise RuntimeError("round died")
    assert ring.stats["discarded"] == 1
    with ingest.dispatch_scope(None, ring, CPU):  # the plain pack: nothing to retire
        pass


def test_pipeline_packs_on_its_worker_and_propagates_errors():
    pipeline = ingest.IngestPipeline(maxsize=2)
    ring = ingest.SlabRing(depth=2)
    batches = _rows(4)
    ticket = ingest.pack_async(pipeline, ring, batches, 4, 8, screen=True)
    packed = ticket.take(timeout=30.0)
    assert packed is not None and packed.reasons == [None] * 4
    np.testing.assert_array_equal(packed.slab.args[0][:4], np.stack([b[0] for b in batches]))
    bad = [(np.zeros(3, np.float32),), (np.zeros(3, np.float32), np.zeros(2))]
    assert ingest.pack_async(pipeline, ring, bad, 2, 8, screen=False).take(timeout=30.0) is None  # fallback
    assert pipeline.drain(timeout=30.0)
    assert pipeline.stats["completed"] == 1 and pipeline.stats["fallbacks"] == 1

    def boom():
        raise ValueError("pack failed")

    ticket = pipeline.submit(boom)
    with pytest.raises(ValueError, match="pack failed"):
        ticket.take(timeout=30.0)
    assert pipeline.drain(timeout=30.0) and pipeline.stats["errors"] == 1


def test_full_queue_degrades_to_inline():
    pipeline = ingest.IngestPipeline(maxsize=1)
    gate = threading.Event()
    first = pipeline.submit(lambda: gate.wait(30.0) and None)
    second = pipeline.submit(lambda: None)  # may be queued behind the first
    third = pipeline.submit(lambda: None)
    assert first is not None
    assert second is None or third is None
    assert pipeline.stats["full"] >= 1
    gate.set()
    assert pipeline.drain(timeout=30.0)


@pytest.mark.parametrize("depth", ["1", "4"])
def test_routed_rounds_equal_the_plain_pack(monkeypatch, depth):
    """Back-to-back rounds through the slab ring (depth 1: every round
    reuses the one slab) against the plain pack: every lane bit-equal."""
    rng = np.random.RandomState(9)
    items = [(f"s{i % 12}", rng.randint(-9, 9, 4).astype(np.float32)) for i in range(60)]  # 5 rounds
    monkeypatch.setenv(ingest.RING_DEPTH_ENV, depth)
    results = {}
    for flag in ("1", "0"):
        monkeypatch.setenv(ingest.PIPELINE_ENV, flag)
        ingest.reset_for_tests()
        obs.reset()
        laned = tl.LanedMetric(SumMetric(device="cpu"), capacity=16)
        assert laned.update_sessions(items) == 5
        assert ingest.drain_pipeline(timeout=30.0)
        counters = obs.counters_snapshot()
        allocated = ingest.get_ring().stats["allocated"]
        results[flag] = (_np_state(laned), counters.get("lanes.pipelined_rounds", 0), counters.get("lanes.inline_packs", 0), allocated)
    np.testing.assert_array_equal(results["1"][0], results["0"][0])
    # round 0 packs inline (or plainly, when the worker holds the only slab);
    # the worker stages the rest
    assert results["1"][1] >= 1 and results["1"][1] + results["1"][2] <= 5
    assert results["0"][1] == results["0"][2] == 0
    if depth == "1":
        assert results["1"][3] == 1  # one slab, reused round after round


def _np_state(laned):
    return laned.sum_value.numpy().copy()


def test_histograms_and_counters_of_a_round():
    obs.reset()
    laned = tl.LanedMetric(SumMetric(device="cpu"), capacity=8)
    laned.update_sessions([(s, np.ones(2, np.float32)) for s in "abc"])
    hist = obs.histograms_snapshot()
    for name in ("lanes.pack_us", "lanes.upload_us", "lanes.dispatch_us"):
        assert hist[name]["count"] == 1, name
    counters = obs.counters_snapshot()
    assert counters["lanes.dispatches"] == 1 and counters["lanes.rows"] == 3 and counters["lanes.admissions"] == 3
