#!/usr/bin/env python3
"""Host cost of the ``binned_curve`` and ``retrieval_topk_stats`` launch paths
of the PyTorch/CUDA port, piece by piece, on an NVIDIA GPU.

Run from the root of a checkout (``--root DIR`` imports the port from another
checkout, e.g. an unpacked parent commit, so two versions are compared with
one script on one card)::

    python3 tools/torch_host_path.py [--root DIR] [--calls 1000] [--repeats 7]

Every ``*_us`` figure is host wall time per call: ``--calls`` back-to-back
calls with no synchronisation, timed with ``time.perf_counter``, the median
of ``--repeats`` rounds (the device is drained between rounds, outside the
timing). ``call_ms`` is the median CUDA-event time around one wrapper call
(host path and device time together), as ``chip_smoke.py`` reports ``ms``.

One wrapper call is first taken apart: the calls it makes into the kernel's
C library (the module's ``_entry()`` functions, recorded with their
arguments), the device allocations it makes (``torch.cuda.memory_stats``)
and the ``torch.cuda.device`` contexts it enters. Then, for each shape:

- ``wrapper_us``: the kernel wrapper (``_binned_counts_cuda`` /
  ``_topk_stats_cuda``) as the dispatch seam calls it;
- ``public_us``: the public function (``binned_curve_counts`` /
  ``retrieval_topk_stats``): the wrapper plus the seam and the conversions;
- ``empty_us``: one ``torch.empty`` of the output's size on the device,
  times ``allocations``;
- ``device_ctx_us``: entering and leaving ``torch.cuda.device``, times
  ``device_contexts``;
- ``stream_us``: reading the current stream's raw handle;
- ``ctypes_us``: the recorded C calls replayed with the same arguments
  while the call's result is held, the launches included;
- ``rest_us``: the argument checks, Python call overhead and the launch
  counter: ``wrapper_us`` less the pieces above.

A form the wrapper does not take (an older checkout's) prints the error it
raised instead. Prints one JSON object a shape and a last line with the
card's name and power limit as ``nvidia-smi`` reports them.

``--executor`` takes the captured executor's update apart instead, for
``chip_smoke.py``'s binary-curve collection (1M scores) and its ImageNet
collection (1,024 rows), each over one batch a call, with the key kept
captured; and for Cityscapes and UVG with the executor's verdict on (a
key judged eager steps aside: ``on_us`` is its eager route):

- ``off_us`` / ``on_us``: ``collection.update`` with ``executor=False`` and
  ``True`` (the key replayed; a key the executor would run eagerly is kept
  captured here);
- ``pieces_us``: the executor's steps inside ``on_us``, each timed where
  the call makes it (the key's preparation, the leaders' lookup, the
  slots, the dispatch with its replay, the commit) and ``outside_us``, the
  collection's own path around ``run_update``;
- ``replay_parts_us``: the replay's parts run alone on the same key: the
  input copies, the two stream waits, entering the capture stream, the
  graph's launch, and the launch counters;
- ``top``: the on path's heaviest functions under ``cProfile`` (own time).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _host_us(fn, calls: int, repeats: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(rounds)


def _call_ms(fn, iters: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _census(module, fn, dev):
    """One call of ``fn`` taken apart: ``(result, C calls [(function,
    arguments)], device allocations, torch.cuda.device contexts entered)``."""
    import torch

    real = module._entry()
    recorded = []

    def recorder(f):
        def call(*args):
            recorded.append((f, args))
            return f(*args)
        return call

    fake = tuple(recorder(f) for f in real) if isinstance(real, tuple) else recorder(real)
    contexts = [0]
    device_cls = torch.cuda.device

    class Counting(device_cls):
        def __enter__(self):
            contexts[0] += 1
            return super().__enter__()

    entry = module._entry
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    module._entry, torch.cuda.device = (lambda: fake), Counting
    try:
        result = fn()
    finally:
        module._entry, torch.cuda.device = entry, device_cls
    allocations = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - before
    torch.cuda.synchronize()
    return result, recorded, allocations, contexts[0]


def _measure(module, wrapper, public, reference, empty, dev, calls: int, repeats: int) -> dict:
    import torch

    from torchmetrics_tpu_torch.ops import native

    try:
        got = wrapper()
    except TypeError as err:  # a form an older wrapper does not take
        return {"skipped": str(err)}
    torch.cuda.synchronize()
    assert torch.equal(got, reference()), "the kernel differs from the plain version"
    result, recorded, allocations, contexts = _census(module, wrapper, dev)

    def replay():
        for f, args in recorded:
            f(*args)

    idx = dev.index

    def enter_exit():
        with torch.cuda.device(dev):
            pass

    row = {
        "call_ms": _call_ms(wrapper),
        "wrapper_us": _host_us(wrapper, calls, repeats),
        "public_us": _host_us(public, calls, repeats),
        "allocations": allocations,
        "empty_us": _host_us(empty, calls, repeats),
        "device_contexts": contexts,
        "device_ctx_us": _host_us(enter_exit, calls, repeats),
        "stream_us": _host_us(lambda: native.current_stream(idx), calls, repeats),
        "entry_calls": len(recorded),
        "ctypes_us": _host_us(replay, calls, repeats),
    }
    del result
    row["rest_us"] = row["wrapper_us"] - (
        allocations * row["empty_us"] + contexts * row["device_ctx_us"] + row["stream_us"] + row["ctypes_us"]
    )
    return row


def measure_curve(chip_smoke, dev, form: str, calls: int, repeats: int) -> dict:
    """Bench config 6: 1M scores, 100 grid thresholds, 5% of samples ignored,
    in ``chip_smoke.py``'s two target forms."""
    import torch

    from torchmetrics_tpu_torch.ops import binned_curve

    preds, target, valid, thr, order, ignore = chip_smoke._curve_args(1_000_000, 100, "grid", False, form, dev)
    kw = {} if ignore is None else {"ignore_index": ignore}
    row = {"kernel": "binned_curve", "form": form, "N": preds.shape[0], "T": thr.shape[0]}
    row.update(_measure(
        binned_curve,
        lambda: binned_curve._binned_counts_cuda(preds, target, valid, thr, order, **kw),
        lambda: binned_curve.binned_curve_counts(preds, target, valid, (thr, order), **kw),
        lambda: binned_curve._binned_counts_reference(preds, target, valid, thr, order, **kw),
        lambda: torch.empty((thr.shape[0], 2, 2), dtype=torch.int64, device=dev),
        dev, calls, repeats,
    ))
    return row


def measure_topk(chip_smoke, dev, name: str, q: int, length: int, top_k: int, calls: int, repeats: int) -> dict:
    import torch

    from torchmetrics_tpu_torch.ops import topk_kernel

    t, counts = chip_smoke._topk_grid(q, length, dev, chip_smoke.SEED + q + length)
    row = {"kernel": "retrieval_topk_stats", "shape": name, "Q": q, "L": length, "top_k": top_k}
    row.update(_measure(
        topk_kernel,
        lambda: topk_kernel._topk_stats_cuda(t, counts, top_k),
        lambda: topk_kernel.retrieval_topk_stats(t, counts, top_k),
        lambda: topk_kernel._topk_stats_reference(t, counts, top_k),
        lambda: torch.empty((q, 4), dtype=torch.float32, device=dev),
        dev, calls, repeats,
    ))
    return row


def _timed_methods(targets, acc):
    """Wrap each ``(owner, name)`` method so its wall time adds to ``acc[name]``."""
    saved = []
    for owner, name in targets:
        fn = getattr(owner, name)

        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter_ns()
            try:
                return _fn(*a, **k)
            finally:
                acc[_name] = acc.get(_name, 0) + time.perf_counter_ns() - t0

        saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, timed)
    return saved


def _restore(saved) -> None:
    for owner, name, old in saved:
        if old is None:
            delattr(owner, name)
        else:
            setattr(owner, name, old)


def measure_executor(chip_smoke, dev, workload: str, calls: int, repeats: int, judging: bool = False) -> dict:
    import cProfile
    import pstats

    import torch

    from torchmetrics_tpu_torch.ops import executor as ex_mod

    spec = chip_smoke.WORKLOADS[workload](dev)
    batches = spec["batches"]()
    warm = [next(batches) for _ in range(4)]
    batch = warm[-1]
    row = {"workload": workload, "rows": int(batch[0].shape[0]), "judging": judging}
    colls = {}
    for executor in (False, True):
        coll = spec["collection"](executor=executor, validate_args=False)
        if executor:
            disp = coll._get_executor().dispatcher()
            if hasattr(disp, "judging"):
                disp.judging = judging  # False: keep the key captured whatever its figures
        for b in warm + [batch] * 3:  # past the key's timed replay and eager trial
            coll.update(*b)
        colls[executor] = coll
        row["on_us" if executor else "off_us"] = _host_us(lambda: coll.update(*batch), calls, repeats)
    on = colls[True]
    ex = on._executor_obj
    stats = ex.stats_dict()
    row["captured"], row["keys"], row["cache_hits"] = stats["captured"], stats["compiles"], stats["cache_hits"]
    disp = ex._dispatcher
    acc = {}
    names = ["_leader_executors", "_prepare", "_record_profile", "_live_states", "_get_fn", "_donation", "_timed_dispatch", "_commit_all"]
    saved = _timed_methods([(ex, n) for n in names if hasattr(ex, n)], acc)
    saved += _timed_methods([(disp, n) for n in ("ensure_slots", "load", "run_warm")], acc)
    saved += _timed_methods([(ex, "run_update")], acc)
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        on.update(*batch)
    total = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    _restore(saved)
    pieces = {k: v / calls / 1e3 for k, v in acc.items()}
    pieces["outside_us"] = (total - acc.get("run_update", 0)) / calls / 1e3
    pieces["total_us"] = total / calls / 1e3
    row["pieces_us"] = pieces
    # the replay's parts alone, on the key the batch hits
    leaves = [x for x in batch if isinstance(x, torch.Tensor)]
    shapes = [tuple(x.shape) for x in leaves]
    captured = [e for e in disp.entries.values() if e.graphs]
    entry = next((e for e in captured if [tuple(b.shape) for b in e.inputs] == shapes), None)
    row["eager_keys"] = stats.get("eager")
    if entry is None and not captured:  # every key runs eagerly: no replay to take apart
        del colls, on
        return row
    if entry is None:  # the batch's key runs eagerly: time the parts on the most replayed graph
        entry = max(captured, key=lambda e: getattr(e, "replays", 0))
        leaves = [torch.zeros_like(b) for b in entry.inputs]
    stream = ex_mod._capture_stream(dev)
    caller = torch.cuda.current_stream(dev)

    def copies():
        for buf, x in zip(entry.inputs, leaves):
            buf.copy_(x)

    def waits():
        stream.wait_stream(caller)
        caller.wait_stream(stream)

    def enter():
        with torch.cuda.stream(stream):
            pass

    def launch():
        with torch.cuda.stream(stream):
            entry.graphs[disp.cur].replay()

    def counters():
        launches = entry.launches
        if launches and isinstance(launches[0], tuple) and hasattr(ex_mod, "launch_counts"):
            for m, attr, n in launches:
                ex_mod.launch_counts.add(m, attr, n)
        elif launches and isinstance(launches[0], tuple):
            for m, attr, n in launches:
                setattr(m, attr, getattr(m, attr) + n)
        else:
            mods = ex_mod._counter_modules()
            ex_mod._write_counters(mods, [c + n for c, n in zip(ex_mod._read_counters(mods), launches)])

    row["replay_parts_us"] = {
        name: _host_us(fn, calls, repeats) for name, fn in
        (("copies", copies), ("waits", waits), ("enter_stream", enter), ("graph_launch", launch), ("counters", counters),
         ("current_stream", lambda: torch.cuda.current_stream(dev)))
    }
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        on.update(*batch)
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof)
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:25]
    row["top"] = [
        {"fn": f"{Path(f).name}:{line}:{name}", "own_us": tt / calls * 1e6, "cum_us": ct / calls * 1e6, "calls": nc / calls}
        for (f, line, name), (cc, nc, tt, ct, _) in top
    ]
    del colls, on
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--calls", type=int, default=1000)
    parser.add_argument("--repeats", type=int, default=7)
    parser.add_argument("--executor", action="store_true", help="take the captured executor's update apart instead")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_host_path: no CUDA device is available", file=sys.stderr)
        return 2
    # chip_smoke's inputs, from this checkout whatever --root is
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import torchmetrics_tpu_torch

    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"root": str(Path(torchmetrics_tpu_torch.__file__).parent.parent), "torch": torch.__version__}))
    if args.executor:
        from torchmetrics_tpu_torch.ops import native

        native.build(chip_smoke.KERNELS)
        for workload, judging in (("binary_curve_1m", False), ("imagenet_val", False), ("cityscapes_val", True), ("uvg_1080p", True)):
            calls = args.calls if workload in ("binary_curve_1m", "imagenet_val") else max(20, args.calls // 10)
            print(json.dumps(measure_executor(chip_smoke, dev, workload, calls, args.repeats, judging)), flush=True)
    else:
        for form in ("int32_mask", "int64_ignore"):
            print(json.dumps(measure_curve(chip_smoke, dev, form, args.calls, args.repeats)), flush=True)
        for name, q, length, top_k in (("msmarco_k10", 6980, 1000, 10), ("movielens_k100", 138_493, 100, 10)):
            print(json.dumps(measure_topk(chip_smoke, dev, name, q, length, top_k, args.calls, args.repeats)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
