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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--calls", type=int, default=1000)
    parser.add_argument("--repeats", type=int, default=7)
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
