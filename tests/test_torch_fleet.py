"""The port's ``fleet/`` against the JAX package's.

Every test of ``tests/test_fleet.py`` runs here on the port: exactly-once ledgers
under any delivery schedule, watermark quarantine and full resync, tree
convergence, every injected transport fault, failover from snapshots,
degraded reads with coverage and staleness, the quantized uplink and the
deferred collection step's delta seam (``export_delta`` and
``deferred_source``). Then
the cross-package properties: payload checksums equal for one canonical
state, a mixed fleet (JAX leaves and port leaves shipping to one port
aggregator) converging bit-exact, aggregator snapshots restoring across the
packages, the dtypes a merge keeps, and the corrupt-payload cases of
``tests/test_integrity.py``. The fleet is host numpy in both packages.
Backoff clocks are injected (``sleep``) so retries cost nothing.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.fleet import (
    Aggregator,
    FleetTopology,
    LeafExporter,
    LeafLedger,
    Uplink,
    apply_delta,
    build_fleet,
    delta_since,
    field_mode,
    metric_source,
    payload_checksum,
)
from torchmetrics_tpu_torch.parallel.quantized import wire_payload_bytes
from torchmetrics_tpu_torch.parallel.reshard import merge_folded
from torchmetrics_tpu_torch.quarantine import DegradedValue
from torchmetrics_tpu_torch.testing import faults
from torchmetrics_tpu_torch.utils.exceptions import CheckpointCorruptionError, FleetProtocolError

NO_SLEEP = lambda s: None  # noqa: E731 - injected backoff clock


# --------------------------------------------------------------------- harness

REDUCTIONS = {
    "s_sum": "sum",
    "s_mean": "mean",
    "s_max": "max",
    "s_min": "min",
    "s_cat": "cat",
    "n": "sum",
}
WIDTH = 4


class FakeLeaf:
    """One simulated leaf process covering all five reduction families.

    Updates draw multiples of 1/8 so every float sum is exact in fp32 —
    bit-exactness claims then have no tolerance to hide behind."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.state = {
            "s_sum": np.zeros(WIDTH, np.float32),
            "s_mean": np.zeros(WIDTH, np.float32),
            "s_max": np.full((WIDTH,), -np.inf, np.float32),
            "s_min": np.full((WIDTH,), np.inf, np.float32),
            "s_cat": np.zeros((0,), np.float32),
            "n": np.asarray(0, np.int64),
        }
        self.updates = 0

    def update(self):
        x = (self.rng.randint(-50, 50, WIDTH) / 8.0).astype(np.float32)
        s = self.state
        s["s_sum"] = s["s_sum"] + x
        s["s_mean"] = s["s_mean"] + x
        s["s_max"] = np.maximum(s["s_max"], x)
        s["s_min"] = np.minimum(s["s_min"], x)
        s["s_cat"] = np.concatenate([s["s_cat"], x])
        s["n"] = s["n"] + 1
        self.updates += 1

    def source(self):
        def _src():
            return dict(self.state), dict(REDUCTIONS), self.updates

        return _src


def single_process_fold(leaves):
    """The fault-free ground truth: each leaf's final canonical state folded
    via ``merge_folded`` in sorted leaf-id order (the aggregator's own fold
    order, so bit-exactness is well-defined)."""
    merged = None
    for lid in sorted(leaves):
        state = {k: np.asarray(v) for k, v in leaves[lid].state.items()}
        if merged is None:
            merged = state
        else:
            merged = {
                k: np.asarray(v) for k, v in merge_folded(merged, state, REDUCTIONS).items()
            }
    return merged


def assert_states_equal(got, want):
    assert got is not None and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def flat_fleet(n_leaves, tmp_path=None, **kwargs):
    topo = FleetTopology([f"leaf/{i}" for i in range(n_leaves)], fanout=max(8, n_leaves))
    kwargs.setdefault("sleep", NO_SLEEP)
    if tmp_path is not None:
        kwargs.setdefault("snapshot_dir", str(tmp_path))
        kwargs.setdefault("snapshot_every", 1)
    fleet = build_fleet(topo, **kwargs)
    leaves = {lid: FakeLeaf(seed=i) for i, lid in enumerate(topo.leaves)}
    exporters = {lid: fleet.leaf_exporter(lid, leaves[lid].source()) for lid in topo.leaves}
    return fleet, leaves, exporters


def drain_all(fleet, exporters, rounds=12):
    """Flush every outbox until empty (breaker probation needs a few passes)."""
    for _ in range(rounds):
        for ex in exporters.values():
            ex.flush()
        fleet.pump()
        if all(ex.outbox_size == 0 for ex in exporters.values()):
            return
    raise AssertionError(
        "outboxes did not drain: " + str({k: ex.outbox_size for k, ex in exporters.items()})
    )


# ----------------------------------------------------------------- wire modes


def test_field_mode_table():
    assert field_mode("cat", np.float32) == "suffix"
    assert field_mode("max", np.float32) == "merge"
    assert field_mode("min", np.int32) == "merge"
    assert field_mode("sum", np.int64) == "add"
    assert field_mode("sum", np.uint32) == "add"
    assert field_mode("sum", np.float32) == "replace"
    assert field_mode("mean", np.float64) == "replace"
    assert field_mode("mean", np.bool_) == "replace"  # bool subtraction is a numpy error
    with pytest.raises(FleetProtocolError, match="wire mode"):
        field_mode(None, np.float32)
    with pytest.raises(FleetProtocolError):
        field_mode(lambda a, b: a, np.float32)


def test_delta_since_modes_and_shrink_guard():
    reds = {"count": "sum", "total": "sum", "rows": "cat", "peak": "max"}
    prev = {
        "count": np.asarray([3, 4], np.int64),
        "total": np.asarray([1.5, 2.5], np.float32),
        "rows": np.asarray([1.0, 2.0], np.float32),
        "peak": np.asarray(7.0, np.float32),
    }
    cur = {
        "count": np.asarray([5, 4], np.int64),
        "total": np.asarray([9.5, 2.5], np.float32),
        "rows": np.asarray([1.0, 2.0, 3.0], np.float32),
        "peak": np.asarray(8.0, np.float32),
    }
    d = delta_since(cur, prev, reds)
    np.testing.assert_array_equal(d["count"], [2, 0])  # int add: exact difference
    np.testing.assert_array_equal(d["total"], cur["total"])  # float replace: full value
    np.testing.assert_array_equal(d["rows"], [3.0])  # cat suffix: new rows only
    np.testing.assert_array_equal(d["peak"], 8.0)  # max merge: full value
    shrunk = dict(cur, rows=np.asarray([1.0], np.float32))
    with pytest.raises(FleetProtocolError, match="shrank"):
        delta_since(shrunk, cur, reds)
    full = delta_since(cur, None, reds)
    for k in cur:
        np.testing.assert_array_equal(full[k], cur[k])


# -------------------------------------------------- exactly-once ledger laws


def _cut_deltas(n_epochs, seed=0):
    """``n_epochs`` consecutive deltas from one FakeLeaf's exporter (no
    transport involved — export() only parks in the outbox)."""
    leaf = FakeLeaf(seed)
    exporter = LeafExporter(
        "leaf/0", leaf.source(), Uplink({}, sleep=NO_SLEEP), "agg/root", outbox_limit=256
    )
    deltas = []
    for _ in range(n_epochs):
        leaf.update()
        deltas.append(exporter.export())
    return leaf, deltas


# Property test over randomized schedules. Seeded numpy draws rather than
# hypothesis (not shipped in the image; tests/test_merge_properties.py's
# st.floats caveat would apply anyway) — 40 schedules per run, deterministic.
@pytest.mark.parametrize("seed", range(40))
def test_ledger_any_delivery_schedule_converges(seed):
    """Any permutation of epochs 1..N with any duplicates interleaved lands
    on the exact state of in-order delivery, with ``applied == N`` — the
    exactly-once law the whole tree rests on (watermark >= N so no schedule
    quarantines here; the quarantine path has its own test)."""
    rng = np.random.RandomState(1000 + seed)
    n = int(rng.randint(3, 9))
    leaf, deltas = _cut_deltas(n, seed=seed)
    schedule = []
    for idx in rng.permutation(n):
        schedule.append(int(idx))
        for dup in rng.randint(0, n, rng.randint(0, 3)):
            schedule.append(int(dup))

    truth = LeafLedger("leaf/0", watermark=n + 1)
    for d in deltas:
        truth.offer(d)
    chaotic = LeafLedger("leaf/0", watermark=n + 1)
    for idx in schedule:
        chaotic.offer(deltas[idx])

    assert chaotic.applied_epoch == n
    assert chaotic.stats["applied"] == truth.stats["applied"] == n
    assert not chaotic.pending  # every gap eventually filled and drained
    assert_states_equal(chaotic.acc, truth.acc)
    assert_states_equal(truth.acc, {k: np.asarray(v) for k, v in leaf.state.items()})


def test_ledger_watermark_quarantine_and_full_resync():
    """A reorder gap wider than the watermark quarantines the leaf (pending
    dropped, ``needs_full`` raised, later deltas counted ``late_dropped``);
    a ``kind="full"`` resync re-anchors the epoch clock and recovers."""
    leaf = FakeLeaf(3)
    exporter = LeafExporter(
        "leaf/0", leaf.source(), Uplink({}, sleep=NO_SLEEP), "agg/root", outbox_limit=256
    )
    deltas = []
    for _ in range(12):
        leaf.update()
        deltas.append(exporter.export())
    ledger = LeafLedger("leaf/0", watermark=4)
    ledger.offer(deltas[0])
    ack = ledger.offer(deltas[11])  # gap of 10 > watermark 4
    assert ack["needs_full"] and ledger.quarantined
    assert ledger.stats["quarantines"] == 1 and not ledger.pending
    ack = ledger.offer(deltas[5])  # anything short of a resync is dead on arrival
    assert ack["needs_full"] and ledger.stats["late_dropped"] == 1

    exporter.mark_resync()
    leaf.update()
    full = exporter.export()
    assert full.kind == "full"
    ack = ledger.offer(full)
    assert not ack["needs_full"] and ledger.applied_epoch == full.epoch
    assert_states_equal(ledger.acc, {k: np.asarray(v) for k, v in leaf.state.items()})


def test_ledger_snapshot_roundtrip():
    leaf, deltas = _cut_deltas(5, seed=9)
    ledger = LeafLedger("leaf/0")
    for d in deltas:
        ledger.offer(d)
    restored = LeafLedger.restore(ledger.export())
    assert restored.applied_epoch == 5 and restored.update_count == leaf.updates
    assert_states_equal(restored.acc, ledger.acc)
    # duplicates of already-applied epochs are still dropped by the successor
    ack = restored.offer(deltas[2])
    assert ack["applied_epoch"] == 5 and restored.stats["duplicates"] == 1


# ------------------------------------------------------------ tree convergence


def test_flat_fleet_five_families_converge_bit_exact():
    fleet, leaves, exporters = flat_fleet(3)
    rng = np.random.RandomState(0)
    for _ in range(5):
        for lid in fleet.topology.leaves:
            for _ in range(int(rng.randint(1, 4))):
                leaves[lid].update()
            exporters[lid].ship(wait=True)
    view = fleet.view()
    assert view.healthy() and view.coverage() == 1.0
    got = view.read()
    assert not isinstance(got, DegradedValue)
    assert_states_equal(got, single_process_fold(leaves))
    assert fleet.root.total_update_count() == sum(l.updates for l in leaves.values())


def test_multi_level_tree_converges_after_pump():
    topo = FleetTopology([f"leaf/{i}" for i in range(5)], fanout=2)
    assert len(topo.levels) > 1  # the test exists to cross an interior link
    fleet = build_fleet(topo, sleep=NO_SLEEP)
    leaves = {lid: FakeLeaf(seed=i + 20) for i, lid in enumerate(topo.leaves)}
    exporters = {lid: fleet.leaf_exporter(lid, leaves[lid].source()) for lid in topo.leaves}
    for _ in range(3):
        for lid in topo.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)
    view = fleet.view()
    assert not view.healthy()  # interior links have not pumped yet
    fleet.pump()
    view = fleet.view()
    assert view.healthy()
    assert_states_equal(view.read(), single_process_fold(leaves))


def test_metric_source_real_metrics_converge():
    """Live aggregation metrics as leaf sources: the global read is the
    cross-process value a single process accumulating everything would
    compute."""
    from torchmetrics_tpu_torch.aggregation import SumMetric

    fleet = build_fleet(FleetTopology(["leaf/0", "leaf/1"]), sleep=NO_SLEEP)
    metrics, all_vals = {}, []
    for i, lid in enumerate(fleet.topology.leaves):
        metrics[lid] = SumMetric(device="cpu")
        vals = [float(v) for v in range(1 + i, 5 + i)]
        for v in vals:
            metrics[lid].update(torch.tensor(v, dtype=torch.float32))
        all_vals.extend(vals)
        fleet.leaf_exporter(lid, metric_source(metrics[lid])).ship(wait=True)
    got = fleet.view().read()
    assert not isinstance(got, DegradedValue)
    total = np.asarray(got["sum_value"], np.float32)
    np.testing.assert_allclose(total, np.float32(sum(all_vals)))


# ------------------------------------------------------------- injected faults


def test_drop_within_retry_budget_is_invisible():
    fleet, leaves, exporters = flat_fleet(2)
    with faults.drop_delta("leaf/0", n=1) as ctx:
        for lid in fleet.topology.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)
    assert ctx["dropped"] == 1
    assert fleet.uplink.stats["failed"] == 0  # retried inside one send
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_drop_past_retry_budget_retains_outbox_then_reships():
    fleet, leaves, exporters = flat_fleet(2)
    with faults.drop_delta("leaf/0", n=4) as ctx:  # budget is 3 attempts/send
        leaves["leaf/0"].update()
        assert exporters["leaf/0"].ship(wait=True) is None
        assert exporters["leaf/0"].outbox_size == 1  # kept for re-ship
        leaves["leaf/1"].update()
        exporters["leaf/1"].ship(wait=True)
        exporters["leaf/0"].flush()  # 4th attempt drops, retry delivers
    assert ctx["dropped"] == 4
    assert exporters["leaf/0"].outbox_size == 0
    assert fleet.root.ledger("leaf/0").stats["applied"] == 1
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_duplicate_delivery_is_idempotent():
    fleet, leaves, exporters = flat_fleet(2)
    with faults.duplicate_delta("leaf/1") as ctx:
        for _ in range(4):
            for lid in fleet.topology.leaves:
                leaves[lid].update()
                exporters[lid].ship(wait=True)
    assert ctx["duplicated"] == 4
    ledger = fleet.root.ledger("leaf/1")
    assert ledger.stats["duplicates"] == 4 and ledger.stats["applied"] == 4
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_delayed_delta_buffers_and_drains():
    """A held epoch arriving after its successors is a genuine reorder: the
    successors sit in the pending buffer until the gap fills, then drain —
    and the value is exactly what in-order delivery produces."""
    fleet, leaves, exporters = flat_fleet(1)
    with faults.delay_delta("leaf/0", epochs=2) as ctx:
        for _ in range(4):
            leaves["leaf/0"].update()
            exporters["leaf/0"].ship(wait=True)
    assert ctx["held_epoch"] == 1 and ctx["delivered_late"]
    ledger = fleet.root.ledger("leaf/0")
    assert ledger.stats["reordered"] >= 1
    drain_all(fleet, exporters)
    assert ledger.applied_epoch >= 4
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_partitioned_leaf_rejoins_and_replays_backlog():
    fleet, leaves, exporters = flat_fleet(2)
    with faults.partition_leaf("leaf/0", epochs=3) as ctx:
        for _ in range(3):
            for lid in fleet.topology.leaves:
                leaves[lid].update()
                exporters[lid].ship(wait=True)
        assert fleet.root.ledger("leaf/0") is None or (
            fleet.root.ledger("leaf/0").stats["applied"] == 0
        )
        assert exporters["leaf/0"].outbox_size == 3  # the whole partition backlog
        view = fleet.view()
        assert not view.healthy()
        degraded = view.read()
        assert isinstance(degraded, DegradedValue)
        assert degraded.coverage == pytest.approx(0.5)
        assert degraded.staleness["leaf/0"]["applied_epoch"] == 0
    assert len(ctx["dropped_epochs"]) >= 1
    drain_all(fleet, exporters)
    ledger = fleet.root.ledger("leaf/0")
    assert ledger.applied_epoch == 3 and ledger.stats["applied"] == 3  # in-order replay
    assert fleet.view().healthy()
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_partition_lifts_after_distinct_epoch_attempts():
    """Driving sends out of flush order (and with no retry budget, so one
    send is one attempt) shows the in-context rejoin: after ``epochs``
    distinct epochs hit the dead link, delivery resumes."""
    from torchmetrics_tpu_torch.io.retry import RetryPolicy

    fleet, leaves, exporters = flat_fleet(1, policy=RetryPolicy(max_retries=0))
    ex = exporters["leaf/0"]
    with faults.partition_leaf("leaf/0", epochs=3) as ctx:
        ds = []
        for _ in range(3):
            leaves["leaf/0"].update()
            ds.append(ex.export())
        for d in ds:  # each distinct epoch marks the partition clock
            assert fleet.uplink.send("agg/root", d) is None
        assert ctx["dropped_epochs"] == {1, 2, 3}
        # partition lifted: backlog replays in order (the three faults opened
        # the breaker, so the first flushes are skipped until its probe)
        for _ in range(4):
            ex.flush()
        assert ex.outbox_size == 0
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_outbox_overflow_collapses_to_full_resync():
    """An aggregator unreachable longer than the outbox bound costs the
    backlog, not correctness: the exporter clears, marks resync, and the next
    successful export is a ``kind="full"`` install."""
    fleet, leaves, exporters = flat_fleet(1)
    ex = fleet.leaf_exporter("leaf/0", leaves["leaf/0"].source(), outbox_limit=2)
    with faults.kill_aggregator(fleet.root):
        for _ in range(3):
            leaves["leaf/0"].update()
            ex.ship(wait=True)
    assert ex.stats["outbox_overflows"] == 1
    leaves["leaf/0"].update()
    ex.ship(wait=True)
    full_epoch = ex.epoch
    ledger = fleet.root.ledger("leaf/0")
    assert ledger.applied_epoch == full_epoch and ledger.stats["resyncs"] == 1
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_breaker_opens_skips_then_probes_closed():
    fleet, leaves, exporters = flat_fleet(1)
    ex = exporters["leaf/0"]
    br = fleet.uplink.breaker("leaf/0")
    with faults.kill_aggregator(fleet.root):
        for _ in range(3):  # threshold faults -> open
            leaves["leaf/0"].update()
            ex.ship(wait=True)
        assert br.state == "open"
        ex.flush()  # skipped without touching the transport
        assert fleet.uplink.stats["breaker_skipped"] >= 1
    for _ in range(4):  # probe_after skips, then the probation probe closes it
        ex.flush()
    assert br.state == "closed" and ex.outbox_size == 0
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


# -------------------------------------------------------------------- failover


def test_aggregator_failover_is_zero_loss(tmp_path):
    fleet, leaves, exporters = flat_fleet(2, tmp_path=tmp_path)
    for _ in range(3):
        for lid in fleet.topology.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)
    fleet.root.kill()
    leaves["leaf/0"].update()
    assert exporters["leaf/0"].ship(wait=True) is None  # outbox retains
    successor = fleet.failover("agg/root")
    assert successor is fleet.root and successor.alive
    assert successor.ledger("leaf/0").applied_epoch == 3  # restored, not rebuilt
    drain_all(fleet, exporters)
    assert successor.ledger("leaf/0").applied_epoch == 4
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_failover_without_snapshot_for_a_leaf_requests_resync(tmp_path):
    """A successor restored from a snapshot that predates a leaf's first
    delta has no ledger for it — the first delta acks ``needs_full`` and the
    leaf resyncs with a full export."""
    fleet, leaves, exporters = flat_fleet(2, tmp_path=tmp_path)
    leaves["leaf/0"].update()
    exporters["leaf/0"].ship(wait=True)  # only leaf/0 is in the snapshot
    fleet.root.kill()
    fleet.failover("agg/root")
    for _ in range(2):
        for lid in fleet.topology.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)
    drain_all(fleet, exporters)
    assert exporters["leaf/1"].stats["full_exports"] >= 1
    assert_states_equal(fleet.view().read(), single_process_fold(leaves))


def test_snapshot_corruption_is_typed(tmp_path):
    fleet, leaves, exporters = flat_fleet(1, tmp_path=tmp_path)
    leaves["leaf/0"].update()
    exporters["leaf/0"].ship(wait=True)
    snaps = sorted(tmp_path.glob("fleet-*.ckpt"))
    assert snaps
    blob = snaps[-1].read_bytes()
    snaps[-1].write_bytes(blob[: len(blob) // 2])  # torn write
    with pytest.raises(CheckpointCorruptionError):
        Aggregator.restore(str(tmp_path), node_id="agg/root")


def test_dead_aggregator_still_serves_degraded_reads():
    fleet, leaves, exporters = flat_fleet(2)
    for lid in fleet.topology.leaves:
        leaves[lid].update()
        exporters[lid].ship(wait=True)
    truth = single_process_fold(leaves)
    fleet.root.kill()
    view = fleet.view()
    assert not view.healthy()
    got = view.read()
    assert isinstance(got, DegradedValue)
    assert got.coverage == pytest.approx(1.0)  # every leaf had merged pre-kill
    assert_states_equal(got.value, truth)
    with pytest.raises(FleetProtocolError, match="degraded"):
        view.read(allow_degraded=False)


# ------------------------------------------------------------- quantized wire


def test_quantized_uplink_cheaper_ints_exact():
    """At state sizes where the wire matters (thousands of elements, not the
    harness's 4-wide toys — block scales would dominate those) the quantized
    uplink undercuts the exact one on bytes, integer fields ride raw."""

    class BigLeaf:
        def __init__(self):
            self.rng = np.random.RandomState(11)
            self.state = {
                "hist": np.zeros(4096, np.float32),
                "n": np.asarray(0, np.int64),
            }
            self.updates = 0

        def update(self):
            self.state["hist"] = self.state["hist"] + (
                self.rng.randint(-50, 50, 4096) / 8.0
            ).astype(np.float32)
            self.state["n"] = self.state["n"] + 1
            self.updates += 1

        def source(self):
            return lambda: (dict(self.state), {"hist": "sum", "n": "sum"}, self.updates)

    topo = FleetTopology(["leaf/0"])
    exact_fleet = build_fleet(topo, sleep=NO_SLEEP)
    quant_fleet = build_fleet(topo, sleep=NO_SLEEP)
    leaf_a, leaf_b = BigLeaf(), BigLeaf()
    ex_a = exact_fleet.leaf_exporter("leaf/0", leaf_a.source())
    ex_b = quant_fleet.leaf_exporter("leaf/0", leaf_b.source(), precision="quantized")
    for _ in range(4):
        leaf_a.update()
        leaf_b.update()
        ex_a.ship(wait=True)
        ex_b.ship(wait=True)
    assert quant_fleet.uplink.stats["bytes"] < exact_fleet.uplink.stats["bytes"] / 2
    exact_val = exact_fleet.view().read()
    quant_val = quant_fleet.view().read()
    np.testing.assert_array_equal(quant_val["n"], exact_val["n"])  # ints ride raw
    scale = np.abs(np.asarray(exact_val["hist"])).max()
    np.testing.assert_allclose(quant_val["hist"], exact_val["hist"], atol=scale / 100)


# -------------------------------------------------------- composed chaos proof


def test_composed_chaos_converges_bit_exact(tmp_path):
    """The acceptance proof: dropped + duplicated + late deltas, one mid-run
    aggregator kill with failover from snapshot, and one partitioned leaf
    that rejoins — the global view still converges BIT-EXACT to the
    fault-free single-process fold for all five reduction families, and
    partial reads during the outage serve a DegradedValue with the correct
    coverage fraction and per-leaf staleness."""
    fleet, leaves, exporters = flat_fleet(4, tmp_path=tmp_path)

    def round_trip():
        for lid in fleet.topology.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)

    with faults.drop_delta("leaf/0", n=4) as dropped, faults.duplicate_delta(
        "leaf/1"
    ) as duplicated, faults.delay_delta("leaf/2", epochs=2) as delayed, faults.partition_leaf(
        "leaf/3", epochs=99
    ) as partitioned:
        for _ in range(3):
            round_trip()

        # mid-run outage: the root dies with leaf/3 still partitioned
        fleet.root.kill()
        round_trip()  # every ship fails; outboxes absorb the epoch
        view = fleet.view()
        assert not view.healthy()
        degraded = view.read()
        assert isinstance(degraded, DegradedValue)
        assert degraded.coverage == pytest.approx(0.75)  # leaf/3 never merged
        assert degraded.staleness["leaf/3"]["applied_epoch"] == 0
        assert degraded.staleness["leaf/1"]["applied_epoch"] >= 1
        with pytest.raises(FleetProtocolError, match="degraded"):
            view.read(allow_degraded=False)

        successor = fleet.failover("agg/root")
        assert successor.alive
        for _ in range(2):
            round_trip()

    assert dropped["dropped"] == 4
    assert duplicated["duplicated"] >= 1
    assert delayed["delivered_late"]
    assert len(partitioned["dropped_epochs"]) >= 1

    drain_all(fleet, exporters)
    view = fleet.view()
    assert view.healthy() and view.coverage() == 1.0
    got = view.read()
    assert not isinstance(got, DegradedValue)
    assert_states_equal(got, single_process_fold(leaves))
    root = fleet.root
    assert root.ledger("leaf/1").stats["duplicates"] >= 1
    assert root.ledger("leaf/3").applied_epoch == exporters["leaf/3"].epoch
    assert root.total_update_count() == sum(l.updates for l in leaves.values())


# ------------------------------------------- the corrupt-payload surface


FLEET_REDS = {"total": "sum", "n": "sum"}


class _Leaf:
    """One simulated leaf; draws multiples of 1/8 so float32 sums are exact."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.state = {"total": np.zeros(4, np.float32), "n": np.asarray(0, np.int64)}
        self.updates = 0

    def update(self):
        x = (self.rng.randint(-40, 40, 4) / 8.0).astype(np.float32)
        self.state["total"] = self.state["total"] + x
        self.state["n"] = self.state["n"] + 1
        self.updates += 1

    def source(self):
        return lambda: (dict(self.state), dict(FLEET_REDS), self.updates)


def test_payload_checksum_deterministic_and_sensitive():
    payload = {"total": np.arange(4, dtype=np.float32), "n": np.asarray(3, np.int64)}
    c1 = payload_checksum(payload)
    c2 = payload_checksum({k: np.array(v) for k, v in payload.items()})
    assert c1 == c2 and len(c1) == 64
    bad, _ = faults._flip_bits_host(payload["total"], 1, 0)
    assert payload_checksum({**payload, "total": bad}) != c1


def test_exports_are_stamped():
    leaf = _Leaf(1)
    exporter = LeafExporter("leaf/0", leaf.source(), Uplink({}, sleep=NO_SLEEP), "agg/root", outbox_limit=64)
    leaf.update()
    delta = exporter.export()
    assert delta.checksum == payload_checksum(delta.payload)


def test_ledger_drops_corrupt_delta_and_heals_on_full():
    leaf = _Leaf(2)
    exporter = LeafExporter("leaf/0", leaf.source(), Uplink({}, sleep=NO_SLEEP), "agg/root", outbox_limit=64)
    leaf.update()
    clean = exporter.export()  # epoch 1, kind="full"
    bad_payload = copy.deepcopy(clean.payload)
    flipped = False
    for f in bad_payload["fields"].values():
        arr = f.get("data")
        if isinstance(arr, np.ndarray) and arr.size and not flipped:
            arr.reshape(-1).view(np.uint8)[0] ^= np.uint8(1)
            flipped = True
    assert flipped
    corrupt = dataclasses.replace(clean, payload=bad_payload)
    ledger = LeafLedger("leaf/0", watermark=8)
    before = obs.telemetry_snapshot()["counters"].get("fleet.deltas_corrupt", 0)
    ack = ledger.offer(corrupt)
    assert ack["needs_full"] and ack["applied_epoch"] == 0
    assert ledger.quarantined and ledger.stats["corrupt_dropped"] == 1
    assert obs.telemetry_snapshot()["counters"].get("fleet.deltas_corrupt", 0) > before
    ack2 = ledger.offer(clean)  # the re-shipped CLEAN full resync heals the quarantine
    assert ack2["applied_epoch"] == 1 and not ledger.quarantined


def test_corrupt_delta_converges_bit_exact_after_resync():
    topo = FleetTopology(["leaf/0", "leaf/1"])
    fleet = build_fleet(topo, sleep=NO_SLEEP)
    leaves = {lid: _Leaf(10 + i) for i, lid in enumerate(topo.leaves)}
    exporters = {lid: fleet.leaf_exporter(lid, leaves[lid].source()) for lid in topo.leaves}
    with faults.corrupt_delta_payload("leaf/0", n=1) as injected:
        for lid in topo.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)
    assert injected["corrupted"] == 1
    assert exporters["leaf/0"].stats["resyncs_requested"] == 1
    for _ in range(2):  # the resync and one steady round
        for lid in topo.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)
    view = fleet.view()
    assert view.healthy() and view.coverage() == 1.0
    got = view.read()
    assert not isinstance(got, DegradedValue)
    want_total = leaves["leaf/0"].state["total"] + leaves["leaf/1"].state["total"]
    np.testing.assert_array_equal(np.asarray(got["total"], np.float32), want_total)
    assert int(np.asarray(got["n"])) == sum(l.updates for l in leaves.values())


# ------------------------------------------------- against the JAX package


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torchmetrics_tpu.fleet as jfleet
    from torchmetrics_tpu.parallel import quantized as jquant

    return jfleet, jquant


def _canonical_state():
    rng = np.random.RandomState(3)
    return {
        "hist": (rng.randint(-50, 50, 700) / 8.0).astype(np.float32),
        "wide": rng.randn(5).astype(np.float64),
        "count": rng.randint(0, 1000, (3, 4)).astype(np.int64),
        "tp": rng.randint(0, 9, 6).astype(np.int32),
        "n": np.asarray(17, np.int64),
        "flags": rng.rand(5) > 0.5,
        "empty": np.zeros((0,), np.float32),
    }


@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_wire_dict_and_checksum_equal_across_packages(precision):
    from torchmetrics_tpu_torch.parallel import quantized as tquant

    jfleet, jquant = _jax()
    state = _canonical_state()
    if precision == "exact":
        jwire = jquant.encode_canonical(state, qspecs={k: None for k in state})
        twire = tquant.encode_canonical(state, qspecs={k: None for k in state})
    else:
        jwire = jquant.encode_canonical(state, bits=8, block_size=256)
        twire = tquant.encode_canonical(state, bits=8, block_size=256)

    def types(wire):
        return {
            name: {k: (type(v).__name__, getattr(v, "dtype", None), getattr(v, "shape", None)) for k, v in f.items()}
            for name, f in wire["fields"].items()
        }

    assert types(twire) == types(jwire)
    assert payload_checksum(twire) == jfleet.payload_checksum(jwire) == jfleet.payload_checksum(twire)


def test_exporter_deltas_equal_across_packages():
    """One leaf's export sequence (a full install, then deltas in every wire
    mode) cut by both packages' exporters: the same kinds, epochs, payload
    checksums and wire bytes."""
    jfleet, _ = _jax()
    a, b = FakeLeaf(5), FakeLeaf(5)
    tex = LeafExporter("leaf/0", a.source(), Uplink({}, sleep=NO_SLEEP), "agg/root", outbox_limit=256)
    jex = jfleet.LeafExporter("leaf/0", b.source(), jfleet.Uplink({}, sleep=NO_SLEEP), "agg/root", outbox_limit=256)
    for i in range(6):
        a.update()
        b.update()
        if i == 3:
            tex.mark_resync()
            jex.mark_resync()
        td, jd = tex.export(), jex.export()
        assert (td.kind, td.epoch, td.base_epoch, td.update_count) == (jd.kind, jd.epoch, jd.base_epoch, jd.update_count)
        assert td.checksum == jd.checksum == payload_checksum(jd.payload)
        assert wire_payload_bytes(td.payload) == wire_payload_bytes(jd.payload)


def test_mixed_fleet_converges_bit_exact(tmp_path):
    """JAX leaves (the JAX exporter and uplink) and port leaves ship to the
    port's aggregator tree, under drops, duplicates and one interior
    aggregator's failover: the root's read equals the single-process fold
    bit for bit."""
    jfleet, _ = _jax()
    topo = FleetTopology([f"leaf/{i}" for i in range(6)], fanout=3)
    fleet = build_fleet(topo, snapshot_dir=str(tmp_path), snapshot_every=1, sleep=NO_SLEEP)
    leaves = {lid: FakeLeaf(seed=30 + i) for i, lid in enumerate(topo.leaves)}
    jax_uplink = jfleet.Uplink(lambda node: fleet.aggregators.get(node), sleep=NO_SLEEP)
    exporters = {}
    for i, lid in enumerate(topo.leaves):
        if i % 2 == 0:
            exporters[lid] = jfleet.LeafExporter(lid, leaves[lid].source(), jax_uplink, topo.parent_of(lid))
        else:
            exporters[lid] = fleet.leaf_exporter(lid, leaves[lid].source())

    def round_trip():
        for lid in topo.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)
        fleet.pump()

    with faults.drop_delta("leaf/1", n=1), faults.duplicate_delta("leaf/3"):
        for _ in range(3):
            round_trip()
    victim = topo.parent_of("leaf/0")
    fleet.aggregators[victim].kill()
    round_trip()
    fleet.failover(victim)
    for _ in range(2):
        round_trip()
    drain_all(fleet, exporters)
    view = fleet.view()
    assert view.healthy() and view.coverage() == 1.0
    got = view.read()
    assert not isinstance(got, DegradedValue)
    assert_states_equal(got, single_process_fold(leaves))
    for k, v in got.items():
        assert v.dtype == np.asarray(leaves["leaf/0"].state[k]).dtype, k


def test_mixed_fleet_of_live_metrics():
    """Live aggregation metrics of both packages as leaf sources
    (``metric_source``) shipping to one port aggregator: sum, mean, max and
    cat each read back as the sorted-order fold of the two leaves' states,
    in their own dtypes."""
    import jax.numpy as jnp

    import torchmetrics_tpu.aggregation as jagg
    import torchmetrics_tpu_torch.aggregation as tagg

    jfleet, _ = _jax()
    rng = np.random.RandomState(8)
    batches = [[(rng.randint(-40, 40, 6) / 8.0).astype(np.float32) for _ in range(2)] for _ in range(3)]
    for kind in ("SumMetric", "MeanMetric", "MaxMetric", "CatMetric"):
        jm, tm_ = getattr(jagg, kind)(), getattr(tagg, kind)(device="cpu")
        for x, y in batches:
            jm.update(jnp.asarray(x))
            tm_.update(torch.from_numpy(y))
        fleet = build_fleet(FleetTopology(["leaf/0", "leaf/1"]), sleep=NO_SLEEP)
        jax_uplink = jfleet.Uplink(fleet.aggregators, sleep=NO_SLEEP)
        jfleet.LeafExporter("leaf/0", jfleet.metric_source(jm), jax_uplink, "agg/root").ship(wait=True)
        fleet.leaf_exporter("leaf/1", metric_source(tm_)).ship(wait=True)
        got = fleet.view().read()
        assert not isinstance(got, DegradedValue), kind
        jstate, reds, _ = jfleet.metric_source(jm)()
        tstate, treds, _ = metric_source(tm_)()
        assert reds == treds and set(jstate) == set(tstate)
        want = {k: np.asarray(v) for k, v in merge_folded(jstate, tstate, reds).items()}
        for f in want:
            assert got[f].dtype == want[f].dtype == np.asarray(tstate[f]).dtype, f"{kind}.{f}"
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{kind}.{f}")
        assert fleet.root.total_update_count() == 6


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_aggregator_snapshot_restores_across_packages(tmp_path, direction):
    jfleet, _ = _jax()
    topo = FleetTopology([f"leaf/{i}" for i in range(3)])
    leaves = {lid: FakeLeaf(seed=50 + i) for i, lid in enumerate(topo.leaves)}
    writer = jfleet if direction == "jax_to_port" else None
    if writer is not None:
        src_fleet = jfleet.build_fleet(topo, snapshot_dir=str(tmp_path), snapshot_every=1, sleep=NO_SLEEP)
    else:
        src_fleet = build_fleet(topo, snapshot_dir=str(tmp_path), snapshot_every=1, sleep=NO_SLEEP)
    exporters = {lid: src_fleet.leaf_exporter(lid, leaves[lid].source()) for lid in topo.leaves}
    for _ in range(3):
        for lid in topo.leaves:
            leaves[lid].update()
            exporters[lid].ship(wait=True)
    want_state, want_reds = src_fleet.root.canonical()
    reader = Aggregator if writer is not None else jfleet.Aggregator
    restored = reader.restore(str(tmp_path), node_id="agg/root")
    got_state, got_reds = restored.canonical()
    assert got_reds == want_reds and set(got_state) == set(want_state)
    for k in want_state:
        np.testing.assert_array_equal(np.asarray(got_state[k]), np.asarray(want_state[k]), err_msg=k)
    assert restored.coverage() == src_fleet.root.coverage()
    assert_states_equal(got_state, single_process_fold(leaves))


@pytest.mark.parametrize(
    "fx,dtype",
    [("sum", "int32"), ("sum", "int64"), ("sum", "float32"), ("sum", "float64"), ("mean", "float32"),
     ("max", "int32"), ("max", "float32"), ("min", "int32"), ("min", "float32"), ("cat", "float32"),
     ("cat", "int32"), ("max", "int64"), ("min", "float64"), ("cat", "int64")],
)
def test_merge_keeps_dtypes_as_the_jax_package(fx, dtype):
    """A merge keeps each field's dtype and values in both packages. The JAX
    package runs max/min/cat through jnp, which under its default 32-bit
    mode narrows 64-bit fields (reference behaviour, ROADMAP Queue C); the
    port keeps them, and agrees with the JAX package's values."""
    jfleet, _ = _jax()
    rng = np.random.RandomState(2)
    acc = {"f": rng.randint(-9, 9, 5).astype(dtype)}
    fresh = {"f": rng.randint(-9, 9, 5).astype(dtype)}
    reds = {"f": fx}
    got = apply_delta(dict(acc), fresh, reds)["f"]
    want = jfleet.apply_delta(dict(acc), fresh, reds)["f"]
    assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want.astype(dtype))
    if np.dtype(dtype).itemsize == 4 or fx in ("sum", "mean"):
        assert want.dtype == got.dtype


# ------------------------------------------------------- deferred-executor seam


def test_deferred_step_export_delta_seam():
    """``DeferredCollectionStep.export_delta``: the cut delta applied to the
    previous canonical export rebuilds the fresh canonical export exactly
    (the leaf-side invariant the fleet exporter rides), over 8 stacked
    shards; and ``deferred_source`` feeds a ``LeafExporter`` whose
    aggregator merges to that same canonical fold."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.aggregation import MeanMetric, SumMetric
    from torchmetrics_tpu_torch.fleet import deferred_source
    from torchmetrics_tpu_torch.ops.executor import make_deferred_collection_step

    coll = MetricCollection(
        {"mean": MeanMetric(device="cpu"), "total": SumMetric(device="cpu")}, reduce="deferred", device="cpu"
    )
    step = make_deferred_collection_step(coll, mesh=8)
    states = step.init_states()

    def batch(seed):
        return torch.from_numpy(np.random.RandomState(seed).randint(-40, 40, 16).astype(np.float32) / 8.0)

    states = step.local_step(states, batch(0))
    baseline, first = step.export_delta(states)
    for leader, payload in first.items():  # no baseline: full payloads
        for field, arr in payload.items():
            np.testing.assert_array_equal(arr, np.asarray(baseline[leader][field]))
    states = step.local_step(states, batch(1))
    canonical, payload = step.export_delta(states, baseline=baseline)
    reds = step.canonical_reductions()
    for leader in canonical:
        rebuilt = apply_delta({k: np.asarray(v) for k, v in baseline[leader].items()}, payload[leader], reds[leader])
        for field, arr in canonical[leader].items():
            np.testing.assert_array_equal(rebuilt[field], np.asarray(arr))
    live = {"states": states}
    agg = Aggregator("agg/root")
    leaf = LeafExporter("leaf/0", deferred_source(step, lambda: live["states"]), Uplink({"agg/root": agg}, sleep=NO_SLEEP), "agg/root")
    leaf.ship()
    live["states"] = step.local_step(live["states"], batch(2))
    leaf.ship()
    folded = step.export_canonical(live["states"])
    view, view_reds = agg.canonical()
    assert agg.total_update_count() == step.steps == 3
    for leader, sub in folded.items():
        for field, arr in sub.items():
            np.testing.assert_array_equal(np.asarray(view[f"{leader}.{field}"]), arr)
            assert view_reds[f"{leader}.{field}"] == reds[leader][field]
