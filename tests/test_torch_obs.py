"""The port's ``obs`` against the JAX package's: the same sequence of spans,
counters, gauges and histograms through both packages gives the same Chrome
trace events (names, phases, args, flow pairs; times, threads and ids
masked), the same Prometheus text line for line (values masked where they
are times) and flight blobs with the same keys. Plus the port's own seams:
profiler ranges, ``observe_ready`` on a CPU value, the exporters' files,
the kernel seam's flight notes and the spans the metric core opens.
"""
import json
import re
import threading

import numpy as np
import pytest
import torch

from torchmetrics_tpu import obs as jobs
from torchmetrics_tpu_torch import obs as tobs

PACKAGES = {"jax": jobs, "torch": tobs}


@pytest.fixture
def fresh():
    """Both packages' registries, rings and flight recorders empty, telemetry
    and tracing on; restored to the environment's defaults afterwards."""
    for o in PACKAGES.values():
        o.set_telemetry(True)
        o.set_tracing(True)
        o.reset()
        o.reset_ring()
        o.reset_flight()
    yield
    for o in PACKAGES.values():
        o.set_telemetry(None)
        o.set_tracing(None)
        o.reset()
        o.reset_ring()
        o.reset_flight()


def _sequence(o):
    """One event sequence, written once for both packages."""
    with o.span(o.SPAN_UPDATE, suffix="MulticlassAccuracy"):
        o.counter_inc("rollback.count")
        with o.span(o.SPAN_REDUCE, owner="MulticlassAccuracy", kind="sync"):
            o.counter_inc("sync.bytes_on_wire", 4096)
    with pytest.raises(ValueError):
        with o.span(o.SPAN_COMPUTE, suffix="MulticlassAccuracy"):
            raise ValueError("boom")
    with o.span(o.SPAN_AUTOSAVE, owner="MetricCollection"):
        ctx = o.capture_context()

    def worker():
        with o.use_context(ctx):
            with o.span(o.SPAN_CKPT_SAVE, owner="MetricCollection"):
                o.counter_inc("checkpoint.saves")
            with o.span(o.SPAN_READ_RESOLVE, suffix="MetricCollection"):
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    assert not t.is_alive()
    o.record_span("custom.prerecorded", 1_000, 3_000, {"k": 1})
    o.gauge_set("reads.pending", 3)
    for v in (40.0, 120.0, 7_000.0):
        o.histogram_observe("reads.e2e_latency_us", v)
    o.histogram_observe("reads.staleness_age_updates", 3)
    with o.span(o.SPAN_EXPORT, histogram="lanes.dispatch_us", fmt="test"):
        pass
    o.counter_inc("checkpoint.saves", 2)
    o.breadcrumb("custom_fault", {"where": "test"})


def _normalised_trace(events):
    """Trace events with times masked, threads numbered by first appearance
    and ids renumbered by first appearance (the two packages draw ids from
    their own counters)."""
    tids, ids = {}, {}

    def rid(v):
        return ids.setdefault(v, len(ids) + 1)

    out = []
    for ev in events:
        ev = dict(ev)
        for key in ("ts", "dur", "pid"):
            ev.pop(key, None)
        ev["tid"] = tids.setdefault(ev["tid"], len(tids))
        if "id" in ev:
            ev["id"] = rid(ev["id"])
        if "args" in ev:
            args = dict(ev["args"])
            for key in ("trace_id", "span_id", "parent_id", "from_span", "to_span"):
                if key in args:
                    args[key] = rid(args[key])
            ev["args"] = args
        out.append(ev)
    return out


def test_chrome_trace_events_agree(fresh):
    traces = {}
    for name, o in PACKAGES.items():
        _sequence(o)
        traces[name] = o.chrome_trace(drain=False)
    got, want = traces["torch"], traces["jax"]
    assert _normalised_trace(got["traceEvents"]) == _normalised_trace(want["traceEvents"])
    assert got.keys() == want.keys() and got["metadata"].keys() == want["metadata"].keys()
    phases = [e["ph"] for e in got["traceEvents"]]
    assert phases.count("s") == phases.count("f") == 1  # the autosave -> worker flow pair
    errors = [e for e in got["traceEvents"] if e.get("args", {}).get("error")]
    assert [e["name"] for e in errors] == ["tm_tpu.compute/MulticlassAccuracy"]


_TIME_FAMILY = re.compile(r"^(# \w+ )?tm_tpu_\w*_us(_\w+)?\b")


def _masked_prometheus(text):
    """Lines of a Prometheus exposition with the values of time families
    masked, and without the JAX package's executor aggregate (summed over
    whatever executors live in the process; the port has no executor, so its
    snapshot carries no ``executor.*`` counter)."""
    lines = []
    for line in text.splitlines():
        if "tm_tpu_executor_" in line:
            continue
        if not line.startswith("#") and _TIME_FAMILY.match(line):
            line = line.rsplit(" ", 1)[0] + " <time>"
        lines.append(line)
    return lines


def test_prometheus_text_agrees_line_for_line(fresh):
    texts = {}
    for name, o in PACKAGES.items():
        _sequence(o)
        texts[name] = o.prometheus_text()
    assert _masked_prometheus(texts["torch"]) == _masked_prometheus(texts["jax"])
    assert "tm_tpu_checkpoint_saves_total 3" in texts["torch"]
    assert 'tm_tpu_reads_e2e_latency_us_bucket{le="50"} 1' in texts["torch"]


def test_flight_blobs_have_the_same_keys(fresh):
    blobs = {}
    for name, o in PACKAGES.items():
        _sequence(o)
        try:
            raise o.flighted(KeyError("lost"), domain="checkpoint", snapshot="x.ckpt")
        except KeyError:
            pass
        crumb = o.dump_diagnostics()["breadcrumbs"][-1]
        blobs[name] = (o.flight_blob("checkpoint"), crumb, o.flight_snapshot())
    (tb, tcrumb, tsnap), (jb, jcrumb, jsnap) = blobs["torch"], blobs["jax"]
    assert tb.keys() == jb.keys()
    assert [sorted(r) for r in tb["events"]] == [sorted(r) for r in jb["events"]]
    assert [r["name"] for r in tb["events"]] == [r["name"] for r in jb["events"]]
    assert tcrumb["kind"] == jcrumb["kind"] == "key_error"
    assert tcrumb["data"].keys() == jcrumb["data"].keys()
    assert tcrumb["data"]["flight"].keys() == jcrumb["data"]["flight"].keys()
    assert tsnap.keys() == jsnap.keys()
    assert {d: [r["name"] for r in rs] for d, rs in tsnap.items()} == {d: [r["name"] for r in rs] for d, rs in jsnap.items()}


def test_names_and_switches_match_the_jax_package():
    assert tobs.SPAN_NAMES == jobs.SPAN_NAMES
    assert tobs.DOMAINS == jobs.DOMAINS
    assert tobs.DOMAIN_OF_SPAN == jobs.DOMAIN_OF_SPAN
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for env in ("TELEMETRY_ENV", "TRACE_ENV", "TRACE_BUFFER_ENV", "FLIGHT_ENV", "FLIGHT_BUFFER_ENV", "FLIGHT_DIR_ENV"):
        assert getattr(tobs, env) == getattr(jobs, env)
    assert tobs.LATENCY_BUCKETS_US == jobs.LATENCY_BUCKETS_US
    assert tobs.AGE_BUCKETS_UPDATES == jobs.AGE_BUCKETS_UPDATES


def test_telemetry_off_records_nothing(fresh):
    tobs.set_telemetry(False)
    assert not tobs.tracing_enabled()
    with tobs.span(tobs.SPAN_UPDATE, suffix="X"):
        tobs.counter_inc("rollback.count")
        tobs.breadcrumb("nothing")
    assert tobs.peek_events() == []
    assert tobs.counters_snapshot() == {}
    assert tobs.flight_snapshot() == {}
    assert tobs.dump_diagnostics()["telemetry"]["telemetry_enabled"] is False


def test_ring_keeps_the_newest_events(fresh):
    tobs.reset_ring(4)
    for i in range(10):
        tobs.record_span(f"s{i}", i, i + 1)
    assert [e.name for e in tobs.peek_events()] == ["s6", "s7", "s8", "s9"]
    assert tobs.ring_stats()["dropped_total"] == 6
    assert [e.name for e in tobs.drain_events()] == ["s6", "s7", "s8", "s9"]
    assert tobs.peek_events() == []


def test_spans_enter_profiler_ranges_only_while_one_records(fresh):
    with tobs.span(tobs.SPAN_REDUCE) as sp:
        assert sp._ann is None  # no profiler: no range is entered
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.span(tobs.SPAN_UPDATE, suffix="Probe"):
            torch.ones(8).sum()
        with tobs.device_span(tobs.SPAN_REDUCE, suffix="Probe"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"tm_tpu.update/Probe", "tm_tpu.reduce/Probe"} <= names


def test_observe_ready_closes_a_cpu_span_at_once(fresh):
    value = {"x": torch.ones(3)}
    assert tobs.observe_ready("ready.cpu", value, step=1) is value
    (ev,) = [e for e in tobs.peek_events() if e.name == "ready.cpu"]
    assert ev.attrs == {"step": 1} and ev.t_end_ns >= ev.t_start_ns
    tobs.set_tracing(False)
    tobs.observe_ready("ready.off", value)
    assert not [e for e in tobs.peek_events() if e.name == "ready.off"]


def test_exporters_write_atomic_files(fresh, tmp_path):
    _sequence(tobs)
    n = len(tobs.peek_events())
    path = tobs.write_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as fh:
        trace = json.load(fh)
    assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == n
    assert tobs.peek_events()[0].name == tobs.SPAN_EXPORT  # drained; the export's own span remains
    prom = tobs.write_prometheus(str(tmp_path / "metrics.prom"))
    assert open(prom).read().startswith("# HELP ")
    flight = tobs.persist_flight(str(tmp_path / "flight.json"))
    doc = json.load(open(flight))
    assert doc.keys() == {"time_unix", "pid", "flight", "counters", "breadcrumbs"}
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


def test_periodic_exporter_records_match(fresh, tmp_path):
    records = {}
    for name, o in PACKAGES.items():
        got = []
        exporter = o.PeriodicExporter(interval_s=0.02, sink=got.append, json_path=str(tmp_path / f"{name}.json"))
        exporter.start()
        try:
            _sequence(o)
        finally:
            exporter.stop(timeout=5.0)
        assert exporter._thread is None and exporter.stats["sink_errors"] == 0 and got
        records[name] = got[-1]
    assert records["torch"].keys() == records["jax"].keys()
    assert records["torch"]["telemetry"].keys() == records["jax"]["telemetry"].keys()


def test_dump_diagnostics_reports_torch_versions(fresh):
    diag = tobs.dump_diagnostics()
    assert diag.keys() == jobs.dump_diagnostics().keys()
    assert diag["versions"]["torch"] == torch.__version__
    assert {"cuda", "device", "torchmetrics_tpu_torch"} <= diag["versions"].keys()


def test_telemetry_snapshot_of_a_metric_keeps_the_schema(fresh):
    import jax.numpy as jnp

    from torchmetrics_tpu.classification import MulticlassAccuracy as JaxAccuracy
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    jm = JaxAccuracy(num_classes=3, executor=False)
    jm.update(jnp.asarray([0, 1, 2]), jnp.asarray([0, 1, 1]))
    tm = MulticlassAccuracy(num_classes=3, device="cpu")
    tm.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    got, want = tobs.telemetry_snapshot(tm), jobs.telemetry_snapshot(jm)
    assert got.keys() == want.keys()
    # the executor is off for a metric on the CPU by default: zeroed counters
    # under the JAX package's keys, as its executor=False instance reports
    assert got["counters"] == want["counters"] and got["enabled"] is False is want["enabled"]
    assert got["engaged"] is False and got["fallback_reason"] is None is want["fallback_reason"]
    coll = MetricCollection([MulticlassAccuracy(num_classes=3, device="cpu")], device="cpu")
    status = coll.executor_status
    assert status["enabled"] is False and status["members"]["MulticlassAccuracy"]["fallback_reason"] == got["fallback_reason"]
    process = tobs.telemetry_snapshot()
    # off on the CPU, no executor is built, so none joins the process's
    # executor.* aggregate
    assert coll._executor_obj is None and all(m._executor_obj is None for m in coll.values()) and tm._executor_obj is None
    assert process.keys() == jobs.telemetry_snapshot().keys()


def test_metric_core_spans_counters_and_breadcrumbs(fresh):
    """An update, a failed update, a compute and a degraded sync open the
    JAX package's spans and counters."""
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.testing import FaultInjected, raise_in_update

    m = MulticlassAccuracy(num_classes=3, device="cpu")
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    with raise_in_update(m), pytest.raises(FaultInjected):
        m.update(torch.tensor([0]), torch.tensor([0]))
    m.compute()
    names = [e.name for e in tobs.peek_events()]
    assert names.count("tm_tpu.update/MulticlassAccuracy") == 2
    assert names.count("tm_tpu.compute/MulticlassAccuracy") == 1
    assert tobs.counters_snapshot()["rollback.count"] == 1
    failed = [e for e in tobs.peek_events() if (e.attrs or {}).get("error")]
    assert [e.name for e in failed] == ["tm_tpu.update/MulticlassAccuracy"]
    assert [r["name"] for r in tobs.flight_snapshot()["dispatch"]][-1] == "tm_tpu.compute/MulticlassAccuracy"

    def broken_sync(*_):
        raise RuntimeError("peer gone")

    m = MulticlassAccuracy(num_classes=3, device="cpu", on_sync_failure="local", distributed_available_fn=lambda: True)
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    m._sync_states = broken_sync
    with pytest.warns(UserWarning, match="degrading to local-only"):
        m.compute()
    assert tobs.counters_snapshot()["sync.degraded_local"] == 1
    crumb = tobs.dump_diagnostics()["breadcrumbs"][-1]
    assert crumb["kind"] == "sync_degraded_local" and "flight" in crumb["data"]
    assert "tm_tpu.reduce" in [e.name for e in tobs.peek_events()]


def test_kernel_seam_feeds_the_flight_recorder(fresh):
    from torchmetrics_tpu_torch.ops import kernels

    kernels.dispatch("bincount", torch.tensor([0, 1, 1], dtype=torch.int32), None, 3)
    records = tobs.flight_snapshot()["kernels"]
    assert records[-1]["name"] == "bincount[path=reference,device=cpu]"
    tobs.set_flight(False)
    try:
        kernels.dispatch("bincount", torch.tensor([0], dtype=torch.int32), None, 3)
        assert len(tobs.flight_snapshot()["kernels"]) == len(records)
    finally:
        tobs.set_flight(None)


def test_sync_counts_its_bytes_and_times_out_with_a_breadcrumb(fresh, monkeypatch):
    """One in-process gloo world: the sync's span and byte counter; a
    collective that never completes times out with ``sync.timeouts``."""
    import tempfile

    import torch.distributed as dist

    from torchmetrics_tpu_torch.parallel import sync as psync
    from torchmetrics_tpu_torch.utils.exceptions import SyncTimeoutError

    store = tempfile.mkdtemp() + "/store"
    dist.init_process_group("gloo", init_method="file://" + store, world_size=1, rank=0)
    try:
        out = psync.sync_states({"tp": torch.arange(4, dtype=torch.int32)}, {"tp": "sum"})
        assert torch.equal(out["tp"], torch.arange(4, dtype=torch.int32))
        assert tobs.counters_snapshot()["sync.bytes_on_wire"] == 16
        assert [e.name for e in tobs.peek_events()] == [tobs.SPAN_SYNC_GATHER]

        class Never:
            def is_completed(self):
                return False

        monkeypatch.setattr(psync, "_all_reduce", lambda *a: Never())
        with pytest.raises(SyncTimeoutError):
            psync.sync_states({"tp": torch.ones(2)}, {"tp": "sum"}, timeout=0.05)
        assert tobs.counters_snapshot()["sync.timeouts"] == 1
        assert tobs.dump_diagnostics()["breadcrumbs"][-1]["kind"] == "sync_timeout"
    finally:
        dist.destroy_process_group()


def test_host_leaf_fingerprint_matches_the_jax_fold():
    from torchmetrics_tpu.integrity import host_leaf_fingerprint as jax_fp
    from torchmetrics_tpu_torch.integrity import host_leaf_fingerprint

    rng = np.random.RandomState(0)
    for arr in (
        rng.randn(7, 5).astype(np.float32), rng.randint(-9, 9, 13).astype(np.int64), rng.rand(6) > 0.5,
        rng.randint(0, 255, 11).astype(np.uint8), np.float32(2.5), np.zeros((0, 3), np.float32),
    ):
        assert host_leaf_fingerprint(arr).tolist() == jax_fp(arr).tolist()
