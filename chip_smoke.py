#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``torchmetrics_tpu_torch``).

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``torchmetrics_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
main path (a ``MetricCollection`` of classification metrics, updated batch by
batch and computed) at two public evaluation workloads:

- ImageNet-1k validation, top-1: 50,000 images, 1,000 classes, eval batch
  1024 (48 full batches and one of 848), float32 logits; accuracy (micro),
  F1/precision/recall (macro) and the 1000 x 1000 confusion matrix;
- Cityscapes validation, semantic segmentation: 500 images of 1024 x 2048,
  19 classes, ``ignore_index=255``, batch 4, float32 logits; Jaccard index
  (mIoU), accuracy and the confusion matrix.

Logits and labels are drawn from a seeded ``torch.Generator`` on the card.
With ``--profile`` it also traces a few updates of each workload with
``torch.profiler`` (device time by kernel, device idle share).
Each phase prints one JSON line; then come the kernel table line, the card's
name and power limit as ``nvidia-smi`` reports them, and the final line
``{"ok": true, "device": {...}}``. Any failed build, launch error or mismatch
exits non-zero, and so does a run without a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

KERNELS = ("bincount",)
#: ImageNet-1k validation (torchvision references/classification eval):
#: 50,000 images, 1,000 classes, eval batch 1024
IMAGENET = {"num_classes": 1000, "batches": [1024] * 48 + [848]}
#: Cityscapes validation (mmsegmentation's cityscapes config): 500 images of
#: 1024 x 2048, 19 eval classes, void label 255, batch 4
CITYSCAPES = {"num_classes": 19, "ignore_index": 255, "images": 500, "batch": 4, "height": 1024, "width": 2048}
#: (name, K, L, N) of each bincount check: the binary family's 4 bins, the
#: Cityscapes 19 x 19 and ImageNet 1000 x 1000 confusion counts, and
#: calibration's three float-weighted rows over 15 bins
KERNEL_SHAPES = [
    ("binary_segmentation", 1, 4, 4 * 1024 * 2048),
    ("cityscapes_confmat", 1, 19 * 19, 4 * 1024 * 2048),
    ("imagenet_confmat", 1, 1000 * 1000, 1024),
    ("calibration_k3", 3, 15, 1_000_000),
]
#: H100 SXM device-memory rate and float32 (non-tensor-core) peak, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SEED = 1234


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, iters: int) -> float:
    """Median device time of one call, from CUDA events around each of
    ``iters`` calls after one warm-up call."""
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


def phase_kernels(dev) -> list:
    """``bincount`` against its plain version at the shapes the main path and
    its neighbours give it, with negative and out-of-range indices mixed in."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount

    rows = []
    for name, k, length, n in KERNEL_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED)
        spread = max(1, length // 10)
        x = torch.randint(-spread, length + spread, (n,), generator=g, device=dev, dtype=torch.int32)
        w = torch.ones((k, n), device=dev) if k == 1 else torch.rand((k, n), generator=g, device=dev)
        got = bincount._wbincount_cuda(x, w, length)
        ref = bincount._wbincount_reference(x, w, length)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if k == 1:
            _check(torch.equal(got, ref), f"bincount {name}: kernel differs from the plain version (max |d| {err})")
        else:
            _check(torch.allclose(got, ref, rtol=1e-5, atol=0.0), f"bincount {name}: beyond rtol 1e-5 (max |d| {err})")
        in_range = (x >= 0) & (x < length)
        n_in = int(in_range.sum())
        # least work for this data: read every index once, the weights of the
        # in-range ones once, write the histogram once; one compare per index
        # and K adds per in-range index
        nbytes = n * 4 + n_in * 4 * k + k * length * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (n + n_in * k) / FP32_OPS_PER_S * 1e3
        iters = 50 if n < 1 << 20 else 20
        row = {
            "shape": name, "K": k, "L": length, "N": n, "in_range": n_in,
            "max_abs_err": err,
            "tolerance": "exact" if k == 1 else "rtol=1e-5",
            "ms": _time_ms(lambda: bincount._wbincount_cuda(x, w, length), iters),
            "plain_ms": _time_ms(lambda: bincount._wbincount_reference(x, w, length), iters),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        if k == 1:
            xi, wi = x[in_range], w[0][in_range]
            row["library_ms"] = _time_ms(lambda: torch.bincount(xi, wi, minlength=length), iters)
        rows.append(row)
    _emit({"phase": "kernels", "kernel": "bincount", "checks": rows})
    return rows


def _plain_confmat(spec: dict):
    """The confusion counts of ``spec``'s batches (regenerated from the same
    seed) through the plain version of ``bincount``, int64."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount

    c, ignore = spec["num_classes"], spec["ignore_index"]
    plain = None
    for preds, target in spec["batches"]():
        t = target.reshape(-1)
        w = torch.ones(t.shape, dtype=torch.float32, device=t.device)
        if ignore is not None:
            w = (t != ignore).to(torch.float32)
            t = torch.where(t == ignore, torch.zeros_like(t), t)
        idx = (c * t + preds.argmax(1).reshape(-1)).to(torch.int32)
        counts = bincount._wbincount_reference(idx, w[None, :], c * c)[0].to(torch.int64)
        plain = counts if plain is None else plain + counts
    return plain.reshape(c, c)


def _derived(confmat):
    """Per-class tp/fp/fn and the present-class mask from exact counts (float64)."""
    import torch

    cm = confmat.to(torch.float64)
    tp = cm.diagonal()
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    present = (tp + fp + fn) > 0
    return cm, tp, fp, fn, present


def _safe(num, den):
    import torch

    return torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)), torch.zeros_like(num))


def _close(name: str, got, want, rtol: float = 1e-5) -> None:
    import torch

    got = got.to(torch.float64)
    _check(bool(torch.isfinite(got).all()), f"{name}: non-finite result")
    _check(tuple(got.shape) == tuple(want.shape), f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    _check(torch.allclose(got, want, rtol=rtol, atol=1e-7), f"{name}: {got.tolist()} != {want.tolist()}")


def _imagenet(dev) -> dict:
    """The entry-shaped collection over ImageNet-1k validation."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
        MulticlassPrecision,
        MulticlassRecall,
    )

    c = IMAGENET["num_classes"]

    def batches():
        g = torch.Generator(device=dev).manual_seed(SEED)
        for b in IMAGENET["batches"]:
            yield torch.randn((b, c), generator=g, device=dev), torch.randint(0, c, (b,), generator=g, device=dev)

    def collection():
        return MetricCollection(
            {
                "accuracy": MulticlassAccuracy(num_classes=c, average="micro", validate_args=False),
                "f1": MulticlassF1Score(num_classes=c, average="macro", validate_args=False),
                "precision": MulticlassPrecision(num_classes=c, average="macro", validate_args=False),
                "recall": MulticlassRecall(num_classes=c, average="macro", validate_args=False),
                "confmat": MulticlassConfusionMatrix(num_classes=c, validate_args=False),
            }
        )

    def check(result, tp, fp, fn, w) -> None:
        _close("accuracy", result["accuracy"], tp.sum() / sum(IMAGENET["batches"]))
        _close("precision", result["precision"], (_safe(tp, tp + fp) * w).sum() / w.sum())
        _close("recall", result["recall"], (_safe(tp, tp + fn) * w).sum() / w.sum())
        _close("f1", result["f1"], (_safe(2 * tp, 2 * tp + fp + fn) * w).sum() / w.sum())

    return {
        "num_classes": c, "ignore_index": None, "updates": len(IMAGENET["batches"]),
        "samples": sum(IMAGENET["batches"]), "batches": batches, "collection": collection, "check": check,
    }


def _cityscapes(dev) -> dict:
    """The mIoU collection over Cityscapes validation."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassConfusionMatrix,
        MulticlassJaccardIndex,
    )

    c, ignore = CITYSCAPES["num_classes"], CITYSCAPES["ignore_index"]
    n_images, batch = CITYSCAPES["images"], CITYSCAPES["batch"]
    shape = (batch, CITYSCAPES["height"], CITYSCAPES["width"])

    def batches():
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        for _ in range(n_images // batch):
            logits = torch.randn((batch, c, *shape[1:]), generator=g, device=dev)
            target = torch.randint(0, c, shape, generator=g, device=dev)
            void = torch.rand(shape, generator=g, device=dev) < 0.05
            yield logits, torch.where(void, torch.full_like(target, ignore), target)

    def collection():
        return MetricCollection(
            {
                "jaccard": MulticlassJaccardIndex(num_classes=c, ignore_index=ignore, average="macro"),
                "accuracy": MulticlassAccuracy(num_classes=c, ignore_index=ignore),
                "confmat": MulticlassConfusionMatrix(num_classes=c, ignore_index=ignore),
            }
        )

    def check(result, tp, fp, fn, w) -> None:
        _close("jaccard", result["jaccard"], (_safe(tp, tp + fp + fn) * w).sum() / w.sum())
        _close("accuracy", result["accuracy"], (_safe(tp, tp + fn) * w).sum() / w.sum())

    return {
        "num_classes": c, "ignore_index": ignore, "updates": n_images // batch,
        "samples": n_images,
        "batches": batches, "collection": collection, "check": check,
    }


WORKLOADS = {"imagenet_val": _imagenet, "cityscapes_val": _cityscapes}


def phase_workload(name: str, dev) -> dict:
    """Drive the main path over one workload; hold the launches, the
    confusion state and every computed value against the plain version."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount

    spec = WORKLOADS[name](dev)
    c = spec["num_classes"]
    coll = spec["collection"]()
    torch.cuda.reset_peak_memory_stats(dev)
    bincount.launches = 0
    step_s = []
    for preds, target in spec["batches"]():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coll.update(preds, target)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    update_s, steps = sum(step_s), len(step_s)
    step_ms = sorted(t * 1e3 for t in step_s)
    t0 = time.perf_counter()
    result = coll.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    launches = bincount.launches
    peak = torch.cuda.max_memory_allocated(dev)

    plain = _plain_confmat(spec)
    _check(torch.equal(coll["confmat"].confmat.to(torch.int64), plain), f"{name}: confusion state differs from the plain version")
    _check(launches == spec["updates"], f"{name}: {launches} bincount launches for {steps} updates")
    cm, tp, fp, fn, present = _derived(plain)
    spec["check"](result, tp, fp, fn, present.to(torch.float64))
    _check(torch.equal(result["confmat"].to(torch.int64), plain), f"{name}: computed confusion matrix differs")
    out = {
        "phase": name, "updates": steps, "samples": spec["samples"], "counted": int(cm.sum()),
        "num_classes": c, "bincount_launches": launches,
        "compute_groups": [list(g) for g in coll.compute_groups.values()],
        "updates_per_s": steps / update_s, "samples_per_s": spec["samples"] / update_s,
        "update_s": update_s, "compute_s": compute_s, "peak_mem_bytes": peak,
        "update_ms": {"min": step_ms[0], "p50": step_ms[steps // 2], "p90": step_ms[(9 * steps) // 10], "max": step_ms[-1]},
        "values": {k: float(v) for k, v in result.items() if k != "confmat"},
        "confmat_exact": True,
    }
    _emit(out)
    return out


def phase_profile(name: str, dev, steps: int = 5) -> None:
    """Where one update's time goes: ``torch.profiler`` over ``steps``
    updates of pre-generated batches (after one warm-up update), device time
    by kernel and the device's idle share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = WORKLOADS[name](dev)
    coll = spec["collection"]()
    gen = spec["batches"]()
    coll.update(*next(gen))
    batches = [next(gen) for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for preds, target in batches:
            coll.update(preds, target)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, memsets, copies): a CPU operator's
    # row repeats the device time of the kernels it launched
    rows = [
        (ev.key, ev.self_device_time_total, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
        and not ev.key.startswith("Activity Buffer")  # the profiler's own buffer traffic
    ]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    _emit({
        "phase": f"profile_{name}", "updates": steps,
        "wall_ms_per_update": wall_us / steps / 1e3,
        "device_ms_per_update": busy_us / steps / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us) if wall_us else None,
        "top_device_kernels": [
            {"name": k[:120], "ms_per_update": us / steps / 1e3, "calls_per_update": n / steps} for k, us, n in rows[:12]
        ],
    })


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from torchmetrics_tpu_torch.ops import native

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _emit({
        "phase": "device", "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    t0 = time.perf_counter()
    paths = native.build(KERNELS)
    _emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "libraries": {k: str(v.name) for k, v in paths.items()},
        "nvcc": {k: v.strip().splitlines() for k, v in native.build_logs.items()},
    })

    rows = phase_kernels(dev)
    imagenet = phase_workload("imagenet_val", dev)
    cityscapes = phase_workload("cityscapes_val", dev)
    if "--profile" in sys.argv[1:]:
        for name in WORKLOADS:
            phase_profile(name, dev)

    # top-level numbers: the main path's heaviest launch (the Cityscapes
    # update's 361-bin count over 8.4M pixels); every shape under "shapes"
    main = next(r for r in rows if r["shape"] == "cityscapes_confmat")
    _emit({"kernels": [{
        "name": "bincount",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
        "replaces": "torchmetrics_tpu/ops/bincount.py:76",
        "launches": imagenet["bincount_launches"] + cityscapes["bincount_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shapes": rows,
    }]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
