#!/usr/bin/env python3
"""Device time of the ``binned_curve`` and ``retrieval_topk_stats`` kernels of
the PyTorch/CUDA port, read from ``torch.profiler``, on an NVIDIA GPU.

Run from the root of a checkout (``--root DIR`` imports the port from another
checkout, e.g. an unpacked parent commit)::

    python3 tools/torch_kernel_sweep.py [--root DIR] [--calls 20] [--scaling] [--lengths 512,1000]

For each shape it profiles ``--calls`` wrapper calls (after a warm-up call
outside the profiler and one inside it) and prints each device kernel's time
a launch (``us_per_launch``, the profiler's total over the launches it
recorded) and the sum over a call's kernels (``device_us``); each
``binned_curve`` row also says whether the kernel's counts equal the plain
body's, and a target form the wrapper does not take (an older checkout's)
is left out. Shapes: ``chip_smoke.py``'s ``CURVE_SHAPES`` and
``TOPK_SHAPES``. ``--scaling`` adds the one-launch count at T = 100 from no
samples to 16M (its fixed latency against its time a sample); ``--lengths``
adds ``retrieval_topk_stats`` at those row lengths, 6,980 rows each (MS
MARCO's query count, so the lanes the kernel picks for each length can be
held against another checkout's pick). Inputs stay in the card's 50 MB L2
cache from call to call where they fit. The last line is the card's name
and power limit as ``nvidia-smi`` reports them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _profile(fn, calls: int) -> list:
    """``[(kernel, us a launch, launches recorded)]`` over ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    plan = schedule(wait=0, warmup=1, active=calls, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=plan) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [
        (ev.key[:100], ev.self_device_time_total / ev.count, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
        and not ev.key.startswith(("ProfilerStep", "Activity Buffer"))
    ]


def _row(name: str, rows: list, calls: int, **extra) -> dict:
    return {
        "shape": name, **extra,
        # a call's device time: each kernel's time a launch, times its launches a call
        "device_us": sum(us * max(1, round(n / calls)) for _, us, n in rows),
        "kernels": [{"name": k, "us_per_launch": us, "launches": n} for k, us, n in rows],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--lengths", default="", help="comma-separated row lengths")
    parser.add_argument("--scaling", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    # chip_smoke's shapes and inputs, from this checkout whatever --root is
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from torchmetrics_tpu_torch.ops import binned_curve, topk_kernel

    dev = torch.device("cuda", torch.cuda.current_device())
    for name, n, len_t, kind, edges, form in chip_smoke.CURVE_SHAPES:
        *call, ignore = chip_smoke._curve_args(n, len_t, kind, edges, form, dev)
        kw = {} if ignore is None else {"ignore_index": ignore}
        try:
            got = binned_curve._binned_counts_cuda(*call, **kw)
        except TypeError:  # a form an older wrapper does not take
            continue
        exact = bool(torch.equal(got, binned_curve._binned_counts_reference(*call, **kw)))
        rows = _profile(lambda: binned_curve._binned_counts_cuda(*call, **kw), args.calls)
        print(json.dumps(_row(name, rows, args.calls, kernel="binned_curve", N=n, T=len_t, form=form, exact=exact)), flush=True)
    for name, q, length, top_k in chip_smoke.TOPK_SHAPES:
        t, counts = chip_smoke._topk_grid(q, length, dev, chip_smoke.SEED + q + length)
        k = -1 if top_k is None else top_k
        rows = _profile(lambda: topk_kernel._topk_stats_cuda(t, counts, k), args.calls)
        print(json.dumps(_row(name, rows, args.calls, kernel="retrieval_topk_stats", Q=q, L=length)), flush=True)
    if args.scaling:  # the one-launch count's fixed latency against its work a sample
        for n in (0, 8192, 131_072, 1_000_000, 4_000_000, 16_000_000):
            *call, ignore = chip_smoke._curve_args(n, 100, "grid", False, "int64_ignore", dev)
            try:
                binned_curve._binned_counts_cuda(*call, ignore_index=ignore)
            except TypeError:  # an older wrapper takes no ignore_index
                break
            rows = _profile(lambda: binned_curve._binned_counts_cuda(*call, ignore_index=ignore), args.calls)
            print(json.dumps(_row(f"scaling_n{n}", rows, args.calls, kernel="binned_curve", N=n, T=100)), flush=True)
    for length in (int(x) for x in args.lengths.split(",") if x):
        t, counts = chip_smoke._topk_grid(6980, length, dev, chip_smoke.SEED)
        rows = _profile(lambda: topk_kernel._topk_stats_cuda(t, counts, 10), args.calls)
        print(json.dumps(_row(f"length_{length}", rows, args.calls, kernel="retrieval_topk_stats", Q=6980, L=length)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
