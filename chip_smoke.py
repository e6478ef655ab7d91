#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``torchmetrics_tpu_torch``).

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``torchmetrics_tpu_torch/csrc``
(one ``nvcc`` per source, all started together), holds each against its
plain PyTorch version on the card, then drives the main paths (a
``MetricCollection`` updated batch by batch and computed) at public
evaluation workloads:

- ImageNet-1k validation, top-1: 50,000 images, 1,000 classes, eval batch
  1024 (48 full batches and one of 848), float32 logits; accuracy (micro),
  F1/precision/recall (macro) and the 1000 x 1000 confusion matrix;
- Cityscapes validation, semantic segmentation: 500 images of 1024 x 2048,
  19 classes, ``ignore_index=255``, batch 4, float32 logits; Jaccard index
  (mIoU), accuracy and the confusion matrix;
- binary threshold curves at the JAX package's own benchmark shape (its
  ``bench.py`` config 6): 50 updates of 1,000,000 scores, 100 thresholds,
  ``ignore_index=-1`` on 5% of samples; binned AUROC, average precision and
  ROC, counted by the ``binned_curve`` kernel;
- the ImageNet batches again through macro one-vs-rest AUROC and average
  precision with 100 thresholds: a (100, 1000, 2, 2) state whose histogram
  is a K = 2 ``bincount`` over 101,000 bins;
- one exact-mode (``thresholds=None``) AUROC over four binary batches,
  against a float64 rank statistic on the host;
- MS MARCO passage ranking dev: 6,980 queries reranked over their top-1,000
  BM25 candidates, 70 updates of 100 queries (the last 80); MRR@10,
  nDCG@10, MAP, precision@10, recall@100 and hit rate@10, whose top-k sums
  run on the ``retrieval_topk_stats`` kernel, against the same collection
  on the CPU;
- UVG 1080p: one 600-frame sequence of 1920 x 1080 RGB frames in batches of
  8, decoded frames against their originals; SSIM and MS-SSIM, each SSIM
  call (and each MS-SSIM scale) one launch of the ``ssim_windows`` kernel's
  fused entry, with the first batch's per-image SSIM against a float64
  computation on the card;
- CIFAR-10 scored as torch-fidelity's ``cifar10-val`` input: 10,000 real
  32 x 32 images against 10,000 generated ones through the port's
  InceptionV3 (seeded He-scaled weights, BatchNorm statistics from one pass
  over the images), batches of 500; FID at the 2048
  tap, with KID, MiFID and IS fed the taps of the same forward. FID's and
  MiFID's PSD square roots run on the ``fid_sqrtm`` kernel; FID against a
  float64 FID of the card's own states, the others against the CPU.

It holds both ``ssim_windows`` entries against their plain versions: the
generic windowed sum (11, 7, 67, 131 and 201 taps) and its backward, and the
fused SSIM entry at the UVG update's shapes, 67 and 131 taps and a uniform
window; and the weightless ``bincount`` of 2**24 + 3 equal indices (and the
confusion matrix on them) to the exact count.

It also holds ``fid_sqrtm`` (float64 Newton-Schulz steps on the FP64
tensor cores) against its plain body at the Inception taps' widths (F = 64
to 2048, full-rank, rank-deficient, untiled and dominant-mode covariances),
holds the FID each root gives to float64 on every one, and sweeps the plain
body's float64 step count on the rank-deficient and dominant-mode inputs.

Scores, logits, labels and images are drawn from seeded ``torch.Generator`` s on the
card. With ``--profile`` it also traces a few updates of each workload with
``torch.profiler`` (device time by kernel, device idle share; for MS MARCO
the compute too), and a few calls of each kernel at each of its checked
shapes.
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

KERNELS = ("bincount", "binned_curve", "retrieval_topk_stats", "ssim_windows", "fid_sqrtm")
#: ImageNet-1k validation (torchvision references/classification eval):
#: 50,000 images, 1,000 classes, eval batch 1024
IMAGENET = {"num_classes": 1000, "batches": [1024] * 48 + [848]}
#: Cityscapes validation (mmsegmentation's cityscapes config): 500 images of
#: 1024 x 2048, 19 eval classes, void label 255, batch 4
CITYSCAPES = {"num_classes": 19, "ignore_index": 255, "images": 500, "batch": 4, "height": 1024, "width": 2048}
#: (name, K, L, N, weighted) of each bincount check: the binary family's 4
#: bins, the Cityscapes 19 x 19 and ImageNet 1000 x 1000 confusion counts,
#: calibration's three float-weighted rows over 15 bins, and the ImageNet
#: one-vs-rest curve histogram (negative and positive 0/1 rows over
#: (100 + 1) x 1000 bucket-class bins, 1024 x 1000 scores); K = 1 rows with
#: a weight row of ones, and weightless (the fused counts' launch: the
#: ignore_index mask folded into the index; and the one-vs-rest curve
#: count, a positive's bin shifted by (100 + 1) x 1000)
KERNEL_SHAPES = [
    ("binary_segmentation", 1, 4, 4 * 1024 * 2048, True),
    ("cityscapes_confmat", 1, 19 * 19, 4 * 1024 * 2048, True),
    ("imagenet_confmat", 1, 1000 * 1000, 1024, True),
    ("calibration_k3", 3, 15, 1_000_000, True),
    ("imagenet_curve_k2", 2, 101 * 1000, 1024 * 1000, True),
    ("binary_segmentation_weightless", 1, 4, 4 * 1024 * 2048, False),
    ("cityscapes_confmat_weightless", 1, 19 * 19, 4 * 1024 * 2048, False),
    ("imagenet_curve_weightless", 1, 2 * 101 * 1000, 1024 * 1000, False),
]
#: one update past float32's last exact integer: 2**24 + 3 equal indices,
#: whose weightless count must come out exactly (int64)
PAST_2_24 = 2**24 + 3
#: binned-curve checks: (name, N, T, thresholds, edges). "grid" is the
#: 100-point grid of an integer ``thresholds``, "random" unsorted uniform
#: thresholds; edges adds NaN scores, scores exactly on a threshold and
#: duplicated thresholds
CURVE_SHAPES = [
    ("config6", 1_000_000, 100, "grid", False),
    ("doc_2m", 2_000_000, 200, "grid", False),
    ("t1000", 8_388_608, 1000, "grid", False),
    ("t50k", 1_000_000, 50_000, "random", False),
    ("edges", 1_000_000, 64, "random", True),
]
#: the JAX package's bench.py config 6: 50 updates of 1,000,000 binary scores,
#: 100 thresholds; here with ignore_index=-1 on 5% of samples
BINARY_CURVE = {"updates": 50, "batch": 1_000_000, "thresholds": 100, "ignore_index": -1, "positive_rate": 0.25}
#: MS MARCO passage ranking dev set, reranking BM25's top 1,000 (official
#: metric MRR@10): 6,980 queries; 5% of queries keep 100-999 candidates; no
#: relevant passage among the candidates for 14% (BM25 recall@1000 is about
#: 0.86), two for 6%, one for the rest; float32 N(0, 1) scores, relevant +2;
#: updates of 100 queries (the last 80), pairs shuffled within a batch
MSMARCO = {
    "queries": 6980, "candidates": 1000, "short_share": 0.05, "short_counts": (100, 1000),
    "no_relevant": 0.14, "two_relevant": 0.06, "shift": 2.0, "batch_queries": 100,
}
#: the collection on the card against the same on the CPU: means over 6,980
#: queries summed in another order, nDCG's discounts an ulp apart
MSMARCO_RTOL = 1e-5
#: retrieval_topk_stats checks: (name, Q, L, top_k); MovieLens-20M's 138,493
#: users with top-100 candidates
TOPK_SHAPES = [
    ("msmarco_k10", 6980, 1000, 10),
    ("msmarco_all", 6980, 1000, None),
    ("movielens_k100", 138_493, 100, 10),
]
#: UVG 1080p test set: 1920 x 1080 RGB sequences, used by learned video
#: codecs, which report MS-SSIM on frames in [0, 1]; one 600-frame sequence
#: in batches of 8; "decoded" frames add N(0, 0.02) noise, clipped
UVG = {"frames": 600, "batch": 8, "height": 1080, "width": 1920, "noise": 0.02}
#: the first batch's per-image SSIM against float64 on the card: float32
#: moments cancel in E[x^2] - mu^2, and the float32 taps round
UVG_SSIM_ATOL = 5e-5
#: ssim_windows checks: (name, M planes, Hp, Wp, window, taps). M = 5 moment
#: planes x batch x channels; Hp, Wp include the 2 x 5 reflect padding of
#: the 11-tap gaussian. uvg_4k (one 3840 x 2160 frame) puts the plain body
#: on its convolution branch (an edge above 2048); 67 and 131 taps (sigma
#: 9.3 and 18.6) run on the strip kernel, 201 taps (sigma 28.5) as two
#: launches
SSIM_SHAPES = [
    ("uvg_1080p", 120, 1090, 1930, "gaussian", 11),
    ("config3", 60, 266, 266, "gaussian", 11),
    ("msssim_coarsest", 120, 77, 130, "gaussian", 11),
    ("uvg_4k", 15, 2170, 3850, "gaussian", 11),
    ("uniform7", 60, 262, 262, "uniform", 7),
    ("gaussian67", 15, 336, 546, "gaussian", 67),
    ("gaussian131", 15, 400, 610, "gaussian", 131),
    ("gaussian201", 15, 470, 680, "gaussian", 201),
]
#: the fused SSIM entry: (name, B, C, H, W, window, taps); the UVG update's
#: SSIM and MS-SSIM first scale, MS-SSIM's coarsest 1080p scale, sigma 9.3's
#: 67-tap gaussian (on the strip kernel) and 131 taps (two launches), and a
#: uniform 7-tap window under the 11-tap padding
SSIM_FUSED_SHAPES = [
    ("uvg_1080p", 8, 3, 1080, 1920, "gaussian", 11),
    ("msssim_coarsest", 8, 3, 67, 120, "gaussian", 11),
    ("gaussian67", 8, 3, 270, 480, "gaussian", 67),
    ("gaussian131", 2, 3, 270, 480, "gaussian", 131),
    ("uniform7", 8, 3, 1080, 1920, "uniform", 7),
]
#: fused kernel against its plain version: per-image SSIM and cs within 1e-5
#: (float32 moments summed in another order, then E[x^2] - mu^2 and a
#: division; the kernel sums its means in float64), the map within 2e-4 (a
#: pixel of small local variance divides a rounding difference by little)
SSIM_FUSED_TOL = 1e-5
SSIM_FUSED_MAP_TOL = 2e-4
#: kernel against plain body: float32 sums of products in another order
#: (fmaf in tap order against cuBLAS or cuDNN without TF32), on inputs in
#: [0, 1]; the backward's gradients are N(0, 1) sums, held to 1e-5
SSIM_TOL = 2e-6
SSIM_GRAD_TOL = 1e-5
#: fid_sqrtm checks: (name, F, samples, decay, dominant, dead). Covariances
#: of seeded samples whose eigenvalues fall as i^-decay, in a random basis,
#: at the Inception taps' widths; 1,000 samples at F = 2048 leave the
#: covariance rank-deficient (rank 999); no tile divides F = 1,000. The last
#: adds one mode of standard deviation `dominant` and zeroes `dead` features:
#: the covariance of a network whose BatchNorm does not match its inputs
#: (top eigenvalue 0.9999 of ||A||_F, most eigenvalues below the reach of 16
#: float32 Newton-Schulz steps). Each covariance is rounded to float32, as
#: FID's states are, and handed to the kernel as float64
SQRTM_SHAPES = [
    ("f64", 64, 10_000, 1.0, 0.0, 0),
    ("f192", 192, 10_000, 1.0, 0.0, 0),
    ("f768", 768, 10_000, 1.0, 0.0, 0),
    ("f1000", 1000, 10_000, 1.0, 0.0, 0),
    ("f2048_d1", 2048, 10_000, 1.0, 0.0, 0),
    ("f2048_d2", 2048, 10_000, 2.0, 0.0, 0),
    ("f2048_rank999", 2048, 1_000, 1.0, 0.0, 0),
    ("f2048_dominant", 2048, 10_000, 2.0, 10.0, 93),
]
#: kernel against plain body on full-rank covariances, elementwise and scaled
#: by max |ref|: two float64 runs of KERNEL_ITERS steps whose products sum in
#: other orders (DMMA tiles against cuBLAS's DGEMM); the first run on an
#: H100 measured at most 1.5e-12. FID from either root against a float64
#: eigh FID of the same covariances, on every input
SQRTM_TOL = 1e-9
FID_RTOL = 1e-3
#: float64 step counts of the plain body on the rank-deficient and the
#: dominant-mode inputs: the dominant mode needs enough steps, while more
#: steps grow the negative eigenvalues rounding leaves in the rank-deficient
#: one (KERNEL_ITERS is the least count with every shape's FID within 2.5e-4
#: of float64 before the rank-deficient input starts to drift)
NS_SWEEP = (16, 20, 22, 24, 26, 28, 32)
NS_SWEEP_SHAPES = ("f2048_rank999", "f2048_dominant")
#: CIFAR-10 scored as torch-fidelity's `cifar10-val` input scores a
#: generator: 10,000 real 32 x 32 RGB images (the test set's shape) against
#: 10,000 generated ones, batches of 500 (20 real and 20 generated updates,
#: then one compute); FID at the 2048 tap, KID with the reference's 100
#: subsets of 1,000, MiFID, and IS over 10 splits of the generated images
CIFAR10 = {"images": 10_000, "batch": 500, "size": 32, "kid_subsets": 100, "kid_subset_size": 1000, "is_splits": 10}
#: KID and IS on the card against the same metrics on the CPU from the same
#: features: float32 products and sums in other orders (MiFID's FID takes the
#: Newton-Schulz kernel's root on the card, the eigh root on the CPU)
CIFAR_RTOL = 1e-3
#: the card's InceptionV3 features of 8 images against the port on the CPU,
#: scaled by max |ref|: full float32 on the card (convolutions summed in
#: other orders), and cuDNN's default TF32 (ten mantissa bits) reported
NETWORK_FP32_TOL = 1e-4
NETWORK_TF32_TOL = 5e-2
#: H100 SXM device-memory rate, float32 (non-tensor-core) peak and FP64
#: tensor-core peak (dense), NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_TC_OPS_PER_S = 67e12
SEED = 1234
#: trace with torch.profiler too (``--profile``)
PROFILE = "--profile" in sys.argv[1:]


def _emit(obj: dict) -> dict:
    print(json.dumps(obj), flush=True)
    return obj


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


def _bincount_inputs(k: int, length: int, n: int, weighted: bool, dev):
    """Indices with a tenth of L below 0 and above L - 1, and the weights of
    a ``KERNEL_SHAPES`` row (None weightless)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    spread = max(1, length // 10)
    x = torch.randint(-spread, length + spread, (n,), generator=g, device=dev, dtype=torch.int32)
    if not weighted:
        return x, None
    if k == 1:
        return x, torch.ones((k, n), device=dev)
    if k == 2:  # one-vs-rest 0/1 rows: negative and positive of 1 class in 1000
        pos = (torch.rand(n, generator=g, device=dev) < 1e-3).to(torch.float32)
        return x, torch.stack([1.0 - pos, pos])
    return x, torch.rand((k, n), generator=g, device=dev)


def phase_kernels(dev) -> list:
    """``bincount`` against its plain version at the shapes the main path and
    its neighbours give it, with negative and out-of-range indices mixed in."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount

    rows = []
    for name, k, length, n, weighted in KERNEL_SHAPES:
        x, w = _bincount_inputs(k, length, n, weighted, dev)
        integral = k <= 2  # weightless or 0/1 weights: integer counts, exact in any order
        got = bincount._wbincount_cuda(x, w, length)
        ref = bincount._wbincount_reference(x, w, length)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if integral:
            _check(torch.equal(got, ref), f"bincount {name}: kernel differs from the plain version (max |d| {err})")
        else:
            _check(torch.allclose(got, ref, rtol=1e-5, atol=0.0), f"bincount {name}: beyond rtol 1e-5 (max |d| {err})")
        in_range = (x >= 0) & (x < length)
        n_in = int(in_range.sum())
        # least work for this data: read every index once, the weights of the
        # in-range ones once (none weightless), write the histogram once; one
        # compare per index and K adds per in-range index
        nbytes = n * 4 + (n_in * 4 * k if weighted else 0) + k * length * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (n + n_in * k) / FP32_OPS_PER_S * 1e3
        iters = 50 if n < 1 << 20 else 20
        row = {
            "shape": name, "K": k, "L": length, "N": n, "weighted": weighted, "in_range": n_in,
            "max_abs_err": err,
            "tolerance": "exact" if integral else "rtol=1e-5",
            "ms": _time_ms(lambda: bincount._wbincount_cuda(x, w, length), iters),
            "plain_ms": _time_ms(lambda: bincount._wbincount_reference(x, w, length), iters),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        if k == 1:  # torch.bincount over the in-range indices (masked outside the timing)
            xi = x[in_range]
            wi = None if w is None else w[0][in_range]
            row["library_ms"] = _time_ms(lambda: torch.bincount(xi, wi, minlength=length), iters)
        rows.append(row)
    # past 2**24: the weightless count, and the confusion matrix on it, are exact
    from torchmetrics_tpu_torch.functional.classification import multiclass_confusion_matrix

    zeros = torch.zeros(PAST_2_24, dtype=torch.int32, device=dev)
    got = bincount._wbincount_cuda(zeros, None, 2)
    cm = multiclass_confusion_matrix(zeros, zeros, num_classes=2, validate_args=False)
    torch.cuda.synchronize()
    _check(
        got.dtype == torch.int64 and got.tolist() == [[PAST_2_24, 0]],
        f"bincount: {got.tolist()} ({got.dtype}) for {PAST_2_24} equal indices",
    )
    _check(int(cm[0, 0]) == PAST_2_24, f"confusion matrix: {int(cm[0, 0])} for {PAST_2_24} equal samples")
    exact = {"n": PAST_2_24, "bincount": got[0, 0].item(), "dtype": str(got.dtype), "confmat_00": int(cm[0, 0])}
    del zeros, got, cm
    _emit({"phase": "kernels", "kernel": "bincount", "checks": rows, "past_2_24": exact})
    return rows


def _threshold_grid(len_t: int, dev):
    """The grid an integer ``thresholds=T`` gives the metrics."""
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    return _adjust_threshold_arg(len_t, dev)


def _curve_inputs(n: int, len_t: int, kind: str, edges: bool, dev):
    """Scores, 0/1 targets (int32), a 95% valid mask and thresholds."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + n + len_t)
    thr = _threshold_grid(len_t, dev) if kind == "grid" else torch.rand(len_t, generator=g, device=dev)
    preds = torch.rand(n, generator=g, device=dev)
    if edges:
        thr[len_t // 2:] = thr[: len_t - len_t // 2].clone()  # duplicated thresholds
        on = torch.rand(n, generator=g, device=dev) < 0.3  # scores exactly on a threshold
        preds = torch.where(on, thr[torch.randint(0, len_t, (n,), generator=g, device=dev)], preds)
        preds = torch.where(torch.rand(n, generator=g, device=dev) < 0.05, torch.full_like(preds, float("nan")), preds)
    target = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32)
    valid = torch.rand(n, generator=g, device=dev) >= 0.05
    return preds, target, valid, thr


def _composite_counts(preds, target, valid, thr_sorted, order):
    """The same counts from stock PyTorch calls (bucketize, bincount,
    cumsum), timed as a yardstick only; no path of the port runs it."""
    import torch

    len_t = thr_sorted.shape[0]
    k = torch.bucketize(preds, thr_sorted, right=True)
    k = torch.where(torch.isnan(preds), torch.zeros_like(k), k)
    idx = (k + (len_t + 1) * target)[valid]
    hist = torch.bincount(idx, minlength=2 * (len_t + 1)).reshape(2, len_t + 1)
    pred1 = hist.sum(1, keepdim=True) - torch.cumsum(hist, 1)[:, :len_t]
    return pred1[:, torch.argsort(order)]


def phase_curve_kernels(dev) -> list:
    """``binned_curve`` against its plain version at the main path's shape and
    its neighbours: counts must be equal."""
    import math

    import torch

    from torchmetrics_tpu_torch.ops import binned_curve

    rows = []
    for name, n, len_t, kind, edges in CURVE_SHAPES:
        preds, target, valid, thr = _curve_inputs(n, len_t, kind, edges, dev)
        # a metric sorts its thresholds once, when it is built, not per call
        thr_sorted, order = binned_curve.sort_thresholds(thr)
        args = (preds, target, valid, thr_sorted, order)
        got = binned_curve._binned_counts_cuda(*args)
        ref = binned_curve._binned_counts_reference(*args)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max())
        _check(torch.equal(got, ref), f"binned_curve {name}: kernel differs from the plain version (max |d| {err})")
        _check(
            torch.equal(_composite_counts(preds, target.to(torch.int64), valid, thr_sorted, order), ref[:, :, 1].T),
            f"binned_curve {name}: the composite yardstick disagrees",
        )
        n_valid = int(valid.sum())
        # least work for this data: read each score, target and mask once and
        # the thresholds once, write the (T, 2, 2) int64 counts once; one
        # float compare per search step of each valid sample
        nbytes = n * (4 + 4 + 1) + len_t * 4 + len_t * 4 * 8
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_valid * math.ceil(math.log2(len_t + 1)) / FP32_OPS_PER_S * 1e3
        iters = 20 if n <= 2_000_000 else 10
        rows.append({
            "shape": name, "N": n, "T": len_t, "thresholds": kind, "edges": edges, "valid": n_valid,
            "max_abs_err": err, "tolerance": "exact",
            "ms": _time_ms(lambda: binned_curve._binned_counts_cuda(*args), iters),
            "plain_ms": _time_ms(lambda: binned_curve._binned_counts_reference(*args), iters),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "composite_ms": _time_ms(
                lambda: _composite_counts(preds, target.to(torch.int64), valid, thr_sorted, order), iters
            ),
        })
    _emit({"phase": "kernels", "kernel": "binned_curve", "checks": rows})
    return rows


def _topk_grid(q: int, length: int, dev, seed: int):
    """A ranked 0/1 target grid (1% relevant), zero beyond each row's count,
    and the int32 counts: full rows, except 5% of MS MARCO-wide rows kept
    at 100-999 documents."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    counts = torch.full((q,), length, dtype=torch.int32, device=dev)
    if length == MSMARCO["candidates"]:
        short = torch.rand(q, generator=g, device=dev) < MSMARCO["short_share"]
        drawn = torch.randint(*MSMARCO["short_counts"], (q,), generator=g, device=dev, dtype=torch.int32)
        counts = torch.where(short, drawn, counts)
    t = (torch.rand((q, length), generator=g, device=dev) < 0.01).to(torch.float32)
    t = t * (torch.arange(length, device=dev)[None, :] < counts[:, None])
    return t.contiguous(), counts


def _composite_topk(t, counts, top_k: int):
    """The four masked row sums as the JAX package's unfused comparator
    takes them (``bench.py``): one pass per statistic, each building its
    own masks. A yardstick only; no path of the port runs it."""
    import torch

    def masks():
        pos = torch.arange(t.shape[-1], device=t.device)[None, :]
        k = counts[:, None] if top_k < 0 else torch.clamp(counts[:, None], max=top_k)
        return pos, (pos < k).to(t.dtype)

    _, mask = masks()
    hits = (t * mask).sum(-1)
    total = t.sum(-1)
    pos, mask = masks()
    inv_hits = (torch.where(pos < counts[:, None], 1.0 - t, 0.0) * mask).sum(-1)
    pos, _ = masks()
    inv_total = torch.where(pos < counts[:, None], 1.0 - t, 0.0).sum(-1)
    return torch.stack([hits, total, inv_hits, inv_total], dim=1)


def phase_topk_kernels(dev) -> list:
    """``retrieval_topk_stats`` against its plain version at MS MARCO dev's
    grid (k = 10 and the whole list) and MovieLens-20M's: bit-equal."""
    import torch

    from torchmetrics_tpu_torch.ops import topk_kernel

    rows = []
    for name, q, length, top_k in TOPK_SHAPES:
        k = -1 if top_k is None else top_k
        t, counts = _topk_grid(q, length, dev, SEED + q + length)
        got = topk_kernel._topk_stats_cuda(t, counts, k)
        ref = topk_kernel._topk_stats_reference(t, counts, k)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        _check(torch.equal(got, ref), f"retrieval_topk_stats {name}: kernel differs from the plain version (max |d| {err})")
        _check(torch.equal(_composite_topk(t, counts, k), ref), f"retrieval_topk_stats {name}: the composite disagrees")
        # least work: read the grid and the counts once, write (Q, 4) once;
        # four masked adds a grid value
        nbytes = q * length * 4 + q * 4 + q * 16
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * q * length / FP32_OPS_PER_S * 1e3
        rows.append({
            "shape": name, "Q": q, "L": length, "top_k": top_k, "documents": int(counts.sum()),
            "max_abs_err": err, "tolerance": "exact",
            "ms": _time_ms(lambda: topk_kernel._topk_stats_cuda(t, counts, k), 50),
            "plain_ms": _time_ms(lambda: topk_kernel._topk_stats_reference(t, counts, k), 20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "composite_ms": _time_ms(lambda: _composite_topk(t, counts, k), 20),
        })
    _emit({"phase": "kernels", "kernel": "retrieval_topk_stats", "checks": rows})
    return rows


#: the sigma whose gaussian has k taps (int(3.5 sigma + 0.5) * 2 + 1 = k)
SIGMA_BY_TAPS = {11: 1.5, 67: 9.3, 131: 18.6, 201: 28.5}


def _ssim_pad(kind: str, k: int) -> int:
    """The reflect pad of a window: half the gaussian's taps; a uniform
    window keeps sigma 1.5's 11-tap pad, as the metric does."""
    return 5 if kind == "uniform" else (k - 1) // 2


def _ssim_taps(kind: str, k: int, dev):
    import torch

    from torchmetrics_tpu_torch.functional.image.utils import _gaussian

    return _gaussian(k, SIGMA_BY_TAPS[k], device=dev) if kind == "gaussian" else torch.full((k,), 1.0 / k, device=dev)


def phase_ssim_kernels(dev) -> dict:
    """``ssim_windows`` against its plain version (full float32) at the
    moment stacks of the main path and its neighbours, and its backward
    against the plain version's autograd at bench config 3."""
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.ops import ssim_kernel

    rows = []
    for name, m, hp, wp, kind, k in SSIM_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED + hp + wp)
        x = torch.rand((m, hp, wp), generator=g, device=dev)
        taps = _ssim_taps(kind, k, dev)
        got = ssim_kernel._windowed_cuda(x, taps, taps)
        ref = ssim_kernel._windowed_reference(x, taps, taps)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        _check(
            torch.allclose(got, ref, rtol=SSIM_TOL, atol=SSIM_TOL),
            f"ssim_windows {name}: beyond rtol/atol {SSIM_TOL} of the plain version (max |d| {err})",
        )
        weight = torch.outer(taps, taps).expand(m, 1, k, k).contiguous()

        def library():
            # one grouped convolution with the rank-1 window (cuDNN, no TF32):
            # a yardstick only; no path of the port calls it
            with ssim_kernel.full_float32():
                return F.conv2d(x[None], weight, groups=m)[0]

        lib_err = float((library() - ref).abs().max())
        _check(lib_err <= 1e-4, f"ssim_windows {name}: the library yardstick disagrees (max |d| {lib_err})")
        ho, wo = hp - k + 1, wp - k + 1
        # least work: read the planes once, write the windows once; k
        # multiply-adds a value in each of the two passes
        nbytes = 4 * m * (hp * wp + ho * wo)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * (k * ho * wp + k * ho * wo) / FP32_OPS_PER_S * 1e3
        iters = 5 if m * hp * wp > 50_000_000 else 20
        rows.append({
            "shape": name, "M": m, "Hp": hp, "Wp": wp, "window": kind, "taps": k,
            "plain_branch": "conv" if max(hp, wp) > ssim_kernel._WINDOW_GEMM_MAX_DIM else "band_matmul",
            "max_abs_err": err, "library_max_abs_err": lib_err, "tolerance": f"rtol=atol={SSIM_TOL}",
            "ms": _time_ms(lambda: ssim_kernel._windowed_cuda(x, taps, taps), iters),
            "plain_ms": _time_ms(lambda: ssim_kernel._windowed_reference(x, taps, taps), iters),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": _time_ms(library, iters),
        })
        del x, got, ref, weight

    # backward at config 3: one more launch over the padded output gradient
    _, m, hp, wp, kind, k = next(s for s in SSIM_SHAPES if s[0] == "config3")
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((m, hp, wp), generator=g, device=dev)
    grad = torch.randn((m, hp - k + 1, wp - k + 1), generator=g, device=dev)
    taps = _ssim_taps(kind, k, dev)
    x_card, x_plain = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = ssim_kernel.launches
    ssim_kernel._windowed_cuda(x_card, taps, taps).backward(grad)
    launched = ssim_kernel.launches - before
    ssim_kernel._windowed_reference(x_plain, taps, taps).backward(grad)
    torch.cuda.synchronize()
    grad_err = float((x_card.grad - x_plain.grad).abs().max())
    _check(launched == 2, f"ssim_windows backward: {launched} launches for one forward and one backward")
    _check(
        torch.allclose(x_card.grad, x_plain.grad, rtol=SSIM_GRAD_TOL, atol=SSIM_GRAD_TOL),
        f"ssim_windows backward: beyond rtol/atol {SSIM_GRAD_TOL} of autograd (max |d| {grad_err})",
    )
    backward = {"shape": "config3", "max_abs_err": grad_err, "tolerance": f"rtol=atol={SSIM_GRAD_TOL}", "launches": launched}
    fused = _ssim_fused_rows(dev)
    _emit({"phase": "kernels", "kernel": "ssim_windows", "checks": rows, "backward": backward, "fused": fused})
    return {"rows": rows, "backward": backward, "fused": fused}


def _ssim_fused_rows(dev) -> list:
    """The fused entry against its plain version (the chain it replaces, in
    full float32) at ``SSIM_FUSED_SHAPES``: per-image SSIM and cs, and the
    map; times without the map, as the main path calls it."""
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.functional.image.utils import _reflect_pad_2d
    from torchmetrics_tpu_torch.ops import ssim_kernel

    rows = []
    for name, b, c, h, w, kind, k in SSIM_FUSED_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED + h + w + k)
        target = torch.rand((b, c, h, w), generator=g, device=dev)
        preds = (target + 0.05 * torch.randn(target.shape, generator=g, device=dev)).clamp_(0.0, 1.0)
        taps = _ssim_taps(kind, k, dev)
        pad = _ssim_pad(kind, k)
        c1, c2 = (0.01 * 1.0) ** 2, (0.03 * 1.0) ** 2

        def kernel(full: bool = False):
            return ssim_kernel._ssim_fused_cuda(preds, target, taps, taps, pad, pad, c1, c2, full)

        def plain(full: bool = False):
            with ssim_kernel.full_float32():
                return ssim_kernel.ssim_chain(preds, target, taps, taps, pad, pad, c1, c2, full)

        before = ssim_kernel.launches
        got = kernel(True)
        launched = ssim_kernel.launches - before
        want = plain(True)
        torch.cuda.synchronize()
        errs = [float((a - r).abs().max()) for a, r in zip(got, want)]
        _check(
            all(e <= SSIM_FUSED_TOL for e in errs[:2]) and errs[2] <= SSIM_FUSED_MAP_TOL,
            f"ssim_windows fused {name}: |d| SSIM {errs[0]}, cs {errs[1]}, map {errs[2]} beyond"
            f" {SSIM_FUSED_TOL} / {SSIM_FUSED_MAP_TOL} of the plain version",
        )
        ph, pw = h + 2 * pad, w + 2 * pad
        ho, wo = ph - k + 1, pw - k + 1
        planes = b * c
        padded = torch.cat([_reflect_pad_2d(t, pad, pad) for t in (preds, target)])
        stack = torch.cat([padded, padded[:b] * padded[:b], padded[b:] * padded[b:], padded[:b] * padded[b:]])
        weight = torch.outer(taps, taps).expand(5 * planes, 1, k, k).contiguous()
        stack = stack.reshape(1, 5 * planes, ph, pw)

        def library():
            # the five windows alone, one grouped convolution with the rank-1
            # window over the padded stack (cuDNN, no TF32): a yardstick only
            with ssim_kernel.full_float32():
                return F.conv2d(stack, weight, groups=5 * planes)

        # least work: read preds and target once (the partial sums written are
        # negligible); 3 products an input pixel, 5 k-tap windows down each
        # padded column and across each output row, about 20 operations of
        # formula and sums an output
        nbytes = 2 * 4 * planes * h * w
        ops = planes * (3 * ph * pw + 10 * k * ho * pw + 10 * k * ho * wo + 20 * ho * wo)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        iters = 5 if planes * h * w > 20_000_000 else 20
        rows.append({
            "shape": name, "B": b, "C": c, "H": h, "W": w, "window": kind, "taps": k, "pad": pad,
            "launches_per_call": launched,
            "max_abs_err_ssim": errs[0], "max_abs_err_cs": errs[1], "max_abs_err_map": errs[2],
            "tolerance": f"atol={SSIM_FUSED_TOL} (map {SSIM_FUSED_MAP_TOL})",
            "ms": _time_ms(kernel, iters),
            "plain_ms": _time_ms(plain, iters),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": _time_ms(library, iters),
            "library_call": "F.conv2d of the padded five-plane stack (the windows only)",
        })
        del preds, target, padded, stack, weight, got, want
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


def _binary_curve(dev) -> dict:
    """Binned binary AUROC, average precision and ROC at bench config 6."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import BinaryAUROC, BinaryAveragePrecision, BinaryROC

    spec = BINARY_CURVE
    n, ignore = spec["batch"], spec["ignore_index"]

    def batches(count=None):
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        for _ in range(spec["updates"] if count is None else count):
            target = (torch.rand(n, generator=g, device=dev) < spec["positive_rate"]).to(torch.int64)
            # probabilities that lean towards the target: AUROC near 0.86, not chance
            scores = torch.sigmoid(torch.randn(n, generator=g, device=dev) + 1.5 * target)
            ignored = torch.rand(n, generator=g, device=dev) < 0.05
            yield scores, torch.where(ignored, torch.full_like(target, ignore), target)

    def collection():
        kw = {"thresholds": spec["thresholds"], "ignore_index": ignore, "validate_args": False}
        return MetricCollection({"auroc": BinaryAUROC(**kw), "ap": BinaryAveragePrecision(**kw), "roc": BinaryROC(**kw)})

    return {"updates": spec["updates"], "samples": spec["updates"] * n, "batches": batches, "collection": collection}


def _imagenet_curve(dev) -> dict:
    """Macro one-vs-rest AUROC and average precision over the ImageNet batches."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAUROC, MulticlassAveragePrecision

    c = IMAGENET["num_classes"]

    def collection():
        kw = {"num_classes": c, "average": "macro", "thresholds": 100, "validate_args": False}
        return MetricCollection({"auroc": MulticlassAUROC(**kw), "ap": MulticlassAveragePrecision(**kw)})

    return {
        "updates": len(IMAGENET["batches"]), "samples": sum(IMAGENET["batches"]),
        "batches": _imagenet(dev)["batches"], "collection": collection,
    }


def _msmarco(dev) -> dict:
    """The MS MARCO dev reranking collection over 70 query batches."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.retrieval import (
        RetrievalHitRate,
        RetrievalMAP,
        RetrievalMRR,
        RetrievalNormalizedDCG,
        RetrievalPrecision,
        RetrievalRecall,
    )

    spec = MSMARCO
    q = spec["queries"]
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    counts = torch.full((q,), spec["candidates"], dtype=torch.int64, device=dev)
    short = torch.rand(q, generator=g, device=dev) < spec["short_share"]
    counts = torch.where(short, torch.randint(*spec["short_counts"], (q,), generator=g, device=dev), counts)
    u = torch.rand(q, generator=g, device=dev)
    relevant = torch.where(u < spec["no_relevant"], 0, torch.where(u < spec["no_relevant"] + spec["two_relevant"], 2, 1))
    offsets = torch.cumsum(counts, 0) - counts
    qids = torch.randperm(1_000_000, generator=g, device=dev)[:q]  # distinct query ids, in no order
    indexes = torch.repeat_interleave(qids, counts)
    target = torch.zeros(indexes.shape[0], dtype=torch.int64, device=dev)
    first = (torch.rand(q, generator=g, device=dev) * counts).to(torch.int64)
    second = (first + 1 + (torch.rand(q, generator=g, device=dev) * (counts - 1)).to(torch.int64)) % counts
    target[(offsets + first)[relevant >= 1]] = 1
    target[(offsets + second)[relevant == 2]] = 1
    preds = torch.randn(indexes.shape[0], generator=g, device=dev) + spec["shift"] * target
    bounds = offsets[:: spec["batch_queries"]].tolist() + [indexes.shape[0]]
    data = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        perm = lo + torch.randperm(hi - lo, generator=g, device=dev)  # query ids shuffled within the batch
        data.append((preds[perm], target[perm], indexes[perm]))

    def collection(device=None):
        kw = {"device": device}
        return MetricCollection(
            {
                "mrr@10": RetrievalMRR(top_k=10, **kw),
                "ndcg@10": RetrievalNormalizedDCG(top_k=10, **kw),
                "map": RetrievalMAP(**kw),
                "precision@10": RetrievalPrecision(top_k=10, **kw),
                "recall@100": RetrievalRecall(top_k=100, **kw),
                "hit_rate@10": RetrievalHitRate(top_k=10, **kw),
            },
            **kw,
        )

    return {
        "updates": len(data), "samples": int(indexes.shape[0]), "queries": q,
        "relevant": int(target.sum()), "queries_without_relevant": int((relevant == 0).sum()),
        "batches": lambda: iter(data), "collection": collection,
        "update": lambda coll, b: coll.update(b[0], b[1], indexes=b[2]),
        "profile_compute": True,
    }


def _uvg_frames(g, n: int, dev):
    """``n`` smooth RGB frames in [0, 1]: 0.5 plus six random low-frequency
    sinusoids a frame, amplitudes per channel."""
    import math

    import torch

    h, w = UVG["height"], UVG["width"]
    y = (torch.arange(h, device=dev, dtype=torch.float32) / h)[:, None]
    x = (torch.arange(w, device=dev, dtype=torch.float32) / w)[None, :]
    frames = torch.full((n, 3, h, w), 0.5, device=dev)
    for _ in range(6):
        fy, fx = (0.5 + 3.5 * torch.rand((n, 1, 1, 1), generator=g, device=dev) for _ in range(2))
        phase = 2 * math.pi * torch.rand((n, 1, 1, 1), generator=g, device=dev)
        amp = 0.05 + 0.1 * torch.rand((n, 3, 1, 1), generator=g, device=dev)
        frames += amp * torch.sin(2 * math.pi * (fy * y + fx * x) + phase)
    return frames.clamp_(0.0, 1.0)


def _uvg(dev) -> dict:
    """SSIM and MS-SSIM over one UVG-shaped 1080p sequence, decoded against original."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure, StructuralSimilarityIndexMeasure

    spec = UVG

    def batches():
        g = torch.Generator(device=dev).manual_seed(SEED + 5)
        for _ in range(spec["frames"] // spec["batch"]):
            original = _uvg_frames(g, spec["batch"], dev)
            noise = spec["noise"] * torch.randn(original.shape, generator=g, device=dev)
            yield (original + noise).clamp_(0.0, 1.0), original

    def collection():
        return MetricCollection(
            {
                "ssim": StructuralSimilarityIndexMeasure(data_range=1.0),
                "ms_ssim": MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0),
            }
        )

    return {
        "updates": spec["frames"] // spec["batch"], "samples": spec["frames"],
        "batches": batches, "collection": collection,
    }


WORKLOADS = {
    "imagenet_val": _imagenet,
    "cityscapes_val": _cityscapes,
    "binary_curve_1m": _binary_curve,
    "imagenet_curve": _imagenet_curve,
    "msmarco_dev": _msmarco,
    "uvg_1080p": _uvg,
}


def _update(spec: dict):
    """How one batch updates the workload's collection: ``coll.update(*batch)``
    unless the spec says otherwise."""
    return spec.get("update", lambda coll, batch: coll.update(*batch))


def _launch_counters():
    from torchmetrics_tpu_torch.ops import bincount, binned_curve, sqrtm_kernel, ssim_kernel, topk_kernel

    return {
        "bincount": bincount, "binned_curve": binned_curve, "retrieval_topk_stats": topk_kernel,
        "ssim_windows": ssim_kernel, "fid_sqrtm": sqrtm_kernel,
    }


def _drive(name: str, spec: dict, dev) -> dict:
    """Update a fresh collection over every batch and compute it, with every
    kernel's launch count set to 0 just before and read just after."""
    import torch

    coll = spec["collection"]()
    update = _update(spec)
    batches = spec["batches"]()
    counters = _launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for module in counters.values():
        module.launches = 0
    step_s = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(coll, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    result = coll.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    launches = {name: module.launches for name, module in counters.items()}
    update_s, steps = sum(step_s), len(step_s)
    step_ms = sorted(t * 1e3 for t in step_s)
    return {
        "coll": coll, "result": result, "launches": launches, "out": {
            "phase": name, "updates": steps, "samples": spec["samples"],
            "launches": launches,
            "compute_groups": [list(g) for g in coll.compute_groups.values()],
            "updates_per_s": steps / update_s, "samples_per_s": spec["samples"] / update_s,
            "update_s": update_s, "compute_s": compute_s, "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "update_ms": {"min": step_ms[0], "p50": step_ms[steps // 2], "p90": step_ms[(9 * steps) // 10], "max": step_ms[-1]},
        },
    }


def phase_workload(name: str, dev) -> dict:
    """Drive the main path over one workload; hold the launches, the
    confusion state and every computed value against the plain version."""
    import torch

    spec = WORKLOADS[name](dev)
    run = _drive(name, spec, dev)
    coll, result, out = run["coll"], run["result"], run["out"]
    launches = run["launches"]["bincount"]
    plain = _plain_confmat(spec)
    _check(torch.equal(coll["confmat"].confmat.to(torch.int64), plain), f"{name}: confusion state differs from the plain version")
    _check(launches == spec["updates"], f"{name}: {launches} bincount launches for {out['updates']} updates")
    cm, tp, fp, fn, present = _derived(plain)
    spec["check"](result, tp, fp, fn, present.to(torch.float64))
    _check(torch.equal(result["confmat"].to(torch.int64), plain), f"{name}: computed confusion matrix differs")
    out.update({
        "counted": int(cm.sum()), "num_classes": spec["num_classes"], "bincount_launches": launches,
        "values": {k: float(v) for k, v in result.items() if k != "confmat"},
        "confmat_exact": True,
    })
    _emit(out)
    return out


def _curve_values(counts):
    """float64 ROC, AUROC and average precision from exact ``(T, [C,] 2, 2)``
    counts, over the threshold axis (per class where there is one)."""
    import torch

    cm = counts.to(torch.float64)
    tps, fps, fns, tns = cm[..., 1, 1], cm[..., 0, 1], cm[..., 1, 0], cm[..., 0, 0]
    tpr, fpr = _safe(tps, tps + fns).flip(0), _safe(fps, fps + tns).flip(0)
    auroc = ((tpr[1:] + tpr[:-1]) / 2 * (fpr[1:] - fpr[:-1])).sum(0)
    one = torch.ones_like(tps[:1])
    precision = torch.cat([_safe(tps, tps + fps), one])
    recall = torch.cat([_safe(tps, tps + fns), torch.zeros_like(one)])
    ap = -((recall[1:] - recall[:-1]) * precision[:-1]).sum(0)
    return {"fpr": fpr, "tpr": tpr, "auroc": auroc, "ap": ap}


def phase_binary_curve(dev) -> dict:
    """The binned binary curves at bench config 6: the ``confmat`` state
    against the ``binned_curve`` plain body over the same batches, the values
    against float64 ones from those counts, and the launches against what
    the compute groups imply (every member on the first update, then one
    leader an update: the three curves share one group)."""
    import torch

    from torchmetrics_tpu_torch.ops import binned_curve

    name = "binary_curve_1m"
    spec = WORKLOADS[name](dev)
    run = _drive(name, spec, dev)
    coll, result, out = run["coll"], run["result"], run["out"]
    grid = binned_curve.sort_thresholds(_threshold_grid(BINARY_CURVE["thresholds"], dev))
    plain = None
    for scores, target in spec["batches"]():
        valid = target != BINARY_CURVE["ignore_index"]
        t = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
        counts = binned_curve._binned_counts_reference(scores, t, valid, *grid)
        plain = counts if plain is None else plain + counts
    for member in ("auroc", "ap", "roc"):
        _check(torch.equal(coll[member].confmat.to(torch.int64), plain), f"{name}: {member} state differs from the plain body")
    groups = out["compute_groups"]
    expected = len(coll) + (spec["updates"] - 1) * len(groups)
    _check(len(groups) == 1, f"{name}: the curves did not share one compute group: {groups}")
    _check(
        run["launches"]["binned_curve"] == expected,
        f"{name}: {run['launches']['binned_curve']} binned_curve launches, expected {expected}",
    )
    want = _curve_values(plain)
    _close("auroc", result["auroc"], want["auroc"])
    _close("ap", result["ap"], want["ap"])
    _close("roc fpr", result["roc"][0], want["fpr"])
    _close("roc tpr", result["roc"][1], want["tpr"])
    out.update({
        "thresholds": BINARY_CURVE["thresholds"], "counted": int(plain[0].sum()),
        "binned_curve_launches": run["launches"]["binned_curve"], "expected_launches": expected,
        "values": {"auroc": float(result["auroc"]), "ap": float(result["ap"])},
        "state_exact": True,
    })
    _emit(out)
    return out


def _onevsrest_counts(probs, target, grid):
    """``(T, C, 2, 2)`` counts straight from the definition: one ``>=`` per
    threshold, score and class; shares no code with the port's update."""
    import torch

    pos = torch.nn.functional.one_hot(target, probs.shape[1]).to(torch.bool)[None]  # (1, B, C)
    ge = probs[None] >= grid[:, None, None]  # (T, B, C)
    tp, fp = (ge & pos).sum(1), (ge & ~pos).sum(1)
    fn, tn = (~ge & pos).sum(1), (~ge & ~pos).sum(1)
    return torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)


def phase_imagenet_curve(dev) -> dict:
    """Macro one-vs-rest AUROC and average precision over the ImageNet
    batches: the (100, 1000, 2, 2) state against counts from the definition,
    the values against float64 ones from those counts, and one K = 2
    ``bincount`` launch per leader update."""
    import torch

    name = "imagenet_curve"
    spec = WORKLOADS[name](dev)
    run = _drive(name, spec, dev)
    coll, result, out = run["coll"], run["result"], run["out"]
    grid = _threshold_grid(100, dev)
    plain = None
    for logits, target in spec["batches"]():
        counts = _onevsrest_counts(torch.softmax(logits, dim=-1), target, grid)
        plain = counts if plain is None else plain + counts
    for member in ("auroc", "ap"):
        _check(torch.equal(coll[member].confmat.to(torch.int64), plain), f"{name}: {member} state differs from the plain counts")
    groups = out["compute_groups"]
    expected = len(coll) + (spec["updates"] - 1) * len(groups)
    _check(
        run["launches"]["bincount"] == expected,
        f"{name}: {run['launches']['bincount']} bincount launches, expected {expected}",
    )
    want = _curve_values(plain)
    _close("auroc", result["auroc"], want["auroc"].mean())
    _close("ap", result["ap"], want["ap"].mean())
    out.update({
        "thresholds": 100, "num_classes": IMAGENET["num_classes"], "bincount_launches": run["launches"]["bincount"],
        "expected_launches": expected, "values": {"auroc": float(result["auroc"]), "ap": float(result["ap"])},
        "state_exact": True,
    })
    _emit(out)
    return out


def _rank_auroc(scores, target) -> float:
    """float64 AUROC on the host as the Mann-Whitney statistic, ties counted
    half (the trapezoidal ROC area over distinct scores, by another route)."""
    import numpy as np

    s = scores.astype(np.float64)
    _, inverse, counts = np.unique(s, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    ranks = (ends - (counts - 1) / 2.0)[inverse]  # 1-based average ranks
    n_pos = int(target.sum())
    n_neg = target.size - n_pos
    return float((ranks[target == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def phase_exact_auroc(dev, batches: int = 4) -> dict:
    """One exact-mode ``BinaryAUROC`` over the first binary batches, against
    the float64 rank statistic of the same samples."""
    import torch

    from torchmetrics_tpu_torch.classification import BinaryAUROC

    metric = BinaryAUROC(thresholds=None, ignore_index=BINARY_CURVE["ignore_index"], validate_args=False)
    kept_s, kept_t = [], []
    t0 = time.perf_counter()
    for scores, target in _binary_curve(dev)["batches"](batches):
        metric.update(scores, target)
        valid = target != BINARY_CURVE["ignore_index"]
        kept_s.append(scores[valid].cpu())
        kept_t.append(target[valid].cpu())
    value = metric.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = _rank_auroc(torch.cat(kept_s).numpy(), torch.cat(kept_t).numpy())
    _close("exact auroc", value, torch.tensor(want, dtype=torch.float64))
    out = {"phase": "exact_auroc", "updates": batches, "samples": sum(len(k) for k in kept_s),
           "value": float(value), "float64_rank_auroc": want, "seconds": seconds}
    _emit(out)
    return out


def phase_msmarco(dev) -> dict:
    """The MS MARCO dev collection on the card: every value against the same
    collection on the CPU over the same batches, and the kernel launches
    against what the code implies (none in an update; one a compute for
    each of precision@10, recall@100 and hit rate@10)."""
    import torch

    name = "msmarco_dev"
    spec = WORKLOADS[name](dev)
    run = _drive(name, spec, dev)
    result, out = run["result"], run["out"]
    on_cpu = spec["collection"]("cpu")
    for preds, target, indexes in spec["batches"]():
        on_cpu.update(preds.cpu(), target.cpu(), indexes=indexes.cpu())
    want = on_cpu.compute()
    for key, value in want.items():
        got = result[key].cpu().to(torch.float64)
        _check(bool(torch.isfinite(got).all()), f"{name}: {key} is not finite")
        _check(
            torch.allclose(got, value.to(torch.float64), rtol=MSMARCO_RTOL, atol=1e-7),
            f"{name}: {key} {float(got)} differs from the CPU's {float(value)} beyond rtol {MSMARCO_RTOL}",
        )
    expected = 3
    launches = run["launches"]["retrieval_topk_stats"]
    _check(launches == expected, f"{name}: {launches} retrieval_topk_stats launches, expected {expected}")
    out.update({
        "queries": spec["queries"], "relevant": spec["relevant"],
        "queries_without_relevant": spec["queries_without_relevant"],
        "topk_launches": launches, "expected_launches": expected,
        "values": {k: float(v) for k, v in result.items()},
        "cpu_values": {k: float(v) for k, v in want.items()},
        "max_rel_diff_vs_cpu": max(
            abs(float(result[k]) - float(v)) / max(abs(float(v)), 1e-12) for k, v in want.items()
        ),
        "rtol": MSMARCO_RTOL,
    })
    _emit(out)
    return out


def _ssim_float64(preds, target, data_range: float = 1.0):
    """Per-image SSIM in float64 with one dense grouped convolution of the
    rank-1 11 x 11 gaussian window (sigma 1.5), reflect padding and the
    constants of the metric; shares only the definition with the port."""
    import torch
    import torch.nn.functional as F

    p, t = preds.to(torch.float64), target.to(torch.float64)
    c = p.shape[1]
    dist = torch.arange(-5, 6, dtype=torch.float64, device=p.device)
    g = torch.exp(-((dist / 1.5) ** 2) / 2)
    g = g / g.sum()
    window = torch.outer(g, g).expand(c, 1, 11, 11)

    def filt(x):
        return F.conv2d(F.pad(x, (5, 5, 5, 5), mode="reflect"), window, groups=c)

    mu_p, mu_t = filt(p), filt(t)
    var_p = filt(p * p) - mu_p**2
    var_t = filt(t * t) - mu_t**2
    cov = filt(p * t) - mu_p * mu_t
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    ssim = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / ((mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2))
    return ssim[..., 5:-5, 5:-5].reshape(p.shape[0], -1).mean(-1)


def phase_uvg(dev) -> dict:
    """SSIM and MS-SSIM over the UVG 1080p sequence: 1 + 5 ``ssim_windows``
    launches an update, finite values, and the first batch's per-image SSIM
    against float64 on the card."""
    import torch

    from torchmetrics_tpu_torch.functional import structural_similarity_index_measure

    name = "uvg_1080p"
    spec = WORKLOADS[name](dev)
    run = _drive(name, spec, dev)
    result, out = run["result"], run["out"]
    expected = spec["updates"] * (1 + 5)
    launches = run["launches"]["ssim_windows"]
    _check(launches == expected, f"{name}: {launches} ssim_windows launches, expected {expected}")
    for key in ("ssim", "ms_ssim"):
        value = float(result[key])
        _check(0.0 < value <= 1.0, f"{name}: {key} = {value} is outside (0, 1]")
    preds, target = next(spec["batches"]())
    per_image = structural_similarity_index_measure(preds, target, data_range=1.0, reduction="none")
    want = _ssim_float64(preds, target)
    torch.cuda.synchronize()
    err = float((per_image.to(torch.float64) - want).abs().max())
    _check(
        tuple(per_image.shape) == (UVG["batch"],) and bool(torch.isfinite(per_image).all()),
        f"{name}: per-image SSIM of shape {tuple(per_image.shape)}",
    )
    _check(err <= UVG_SSIM_ATOL, f"{name}: per-image SSIM differs from float64 by {err} > {UVG_SSIM_ATOL}")
    out.update({
        "frames": UVG["frames"], "frame": [UVG["height"], UVG["width"]], "batch": UVG["batch"],
        "ssim_launches": launches, "expected_launches": expected,
        "values": {k: float(v) for k, v in result.items()},
        "first_batch_ssim": per_image.tolist(), "float64_ssim": want.tolist(),
        "max_abs_err_vs_float64": err, "atol": UVG_SSIM_ATOL,
    })
    if PROFILE:  # device time an update, from torch.profiler
        out["device_ms_per_update"] = phase_profile(name, dev)["device_ms_per_update"]
    _emit(out)
    return out


def _sample_covariance(
    f: int, n: int, decay: float, dev, seed: int, scale: float = 1.0, shift: float = 0.0,
    dominant: float = 0.0, dead: int = 0,
):
    """Mean and float32 covariance of ``n`` seeded samples of width ``f``
    whose covariance eigenvalues fall as i^-decay, in a random basis; plus
    one mode of standard deviation ``dominant`` along a basis vector, and the
    last ``dead`` features held at zero."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((f, f), generator=torch.Generator(device=dev).manual_seed(SEED + f), device=dev, dtype=torch.float64))
    x = torch.randn((n, f), generator=g, device=dev, dtype=torch.float64)
    x = scale * x * torch.arange(1, f + 1, device=dev, dtype=torch.float64) ** (-decay / 2) @ q.T + shift
    if dominant:
        x += dominant * scale * torch.randn((n, 1), generator=g, device=dev, dtype=torch.float64) * q[:, -1]
    if dead:
        x[:, f - dead:] = 0.0
    return x.mean(0).to(torch.float32), torch.cov(x.T).to(torch.float32).contiguous()


def _sqrtm_inputs(shape: tuple, dev):
    """The two moments of a ``SQRTM_SHAPES`` entry: the second set scaled and
    shifted, so the FID between them is a few units."""
    _, f, n, decay, dominant, dead = shape
    kw = {"dominant": dominant, "dead": dead}
    mu1, s1 = _sample_covariance(f, n, decay, dev, SEED + 7 + f + n, **kw)
    mu2, s2 = _sample_covariance(f, n, decay, dev, SEED + 8 + f + n, scale=1.2, shift=0.05, **kw)
    return mu1, s1, mu2, s2


def _fid_float64(mu1, sigma1, mu2, sigma2) -> float:
    """FID in float64 through eigh, from float32 (or float64) moments."""
    import torch

    mu1, sigma1, mu2, sigma2 = (t.to(torch.float64) for t in (mu1, sigma1, mu2, sigma2))
    e, v = torch.linalg.eigh(sigma1)
    root = (v * torch.sqrt(torch.clamp(e, min=0.0))) @ v.T
    inner = root @ sigma2 @ root
    inner = 0.5 * (inner + inner.T)
    tr_covmean = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(inner), min=0.0)).sum()
    diff = mu1 - mu2
    return float(diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean)


def _reconstruction(root, a) -> float:
    """||Y^2 - A||_F / ||A||_F in float64."""
    import torch

    y, a = root.to(torch.float64), a.to(torch.float64)
    return float(torch.linalg.norm(y @ y - a) / torch.linalg.norm(a))


def phase_sqrtm_kernels(dev) -> list:
    """``fid_sqrtm`` against its plain body (the same float64 steps on
    cuBLAS DGEMM) at the Inception taps' widths, rank-deficient, untiled and
    dominant-mode inputs included: elementwise on full-rank inputs, and on
    every input the reconstruction and the FID from each root against a
    float64 eigh FID. Then the plain body's float64 step count swept on the
    rank-deficient and the dominant-mode inputs."""
    import torch

    from torchmetrics_tpu_torch.image.fid import _fid_from_root
    from torchmetrics_tpu_torch.ops import sqrtm_kernel

    def fid(mu1, s1, mu2, s2, root) -> float:
        return float(_fid_from_root(mu1, s1, mu2, s2, root))

    steps = sqrtm_kernel.KERNEL_ITERS
    rows = []
    for shape in SQRTM_SHAPES:
        name, f, n, decay, dominant, dead = shape
        mu1, s1, mu2, s2 = _sqrtm_inputs(shape, dev)
        a = s1.double()
        got = sqrtm_kernel._sqrtm_cuda(a)
        ref = sqrtm_kernel._sqrtm_ns_reference(a)
        torch.cuda.synchronize()
        full_rank = n > f and not dead
        err = float((got - ref).abs().max())
        fid64 = _fid_float64(mu1, s1, mu2, s2)
        fid_kernel = fid(mu1, s1, mu2, s2, got)
        fid_plain = fid(mu1, s1, mu2, s2, ref)
        fid_eigh = fid(mu1, s1, mu2, s2, sqrtm_kernel._sqrtm_reference(s1))
        # least work: K steps are 3K - 3 products of f^3 float64 multiply-adds
        # on the FP64 tensor cores (the first step's two products by Z0 = I
        # are exact copies, the last step's Z is not needed); bytes: read A
        # once, write the root once
        products = 3 * steps - 3
        bytes_ms = 2 * 8 * f * f / HBM_BYTES_PER_S * 1e3
        ops_ms = products * 2 * f**3 / FP64_TC_OPS_PER_S * 1e3
        iters = 5 if f >= 2048 else 20
        ms = _time_ms(lambda: sqrtm_kernel._sqrtm_cuda(a), iters)
        rows.append({
            "shape": name, "F": f, "samples": n, "decay": decay, "dominant": dominant, "dead": dead,
            "steps": steps, "full_rank": full_rank, "finite": bool(torch.isfinite(got).all()),
            "dtype": str(got.dtype).replace("torch.", ""),
            "max_abs_err": err, "max_err_scaled": err / float(ref.abs().max()),
            "tolerance": f"{SQRTM_TOL} of max |ref|" if full_rank else "reconstruction and FID",
            "reconstruction": _reconstruction(got, s1), "plain_reconstruction": _reconstruction(ref, s1),
            "fid_float64": fid64, "fid_kernel": fid_kernel, "fid_plain": fid_plain, "fid_eigh_root": fid_eigh,
            "fid_kernel_rel_err": abs(fid_kernel - fid64) / abs(fid64),
            "fid_plain_rel_err": abs(fid_plain - fid64) / abs(fid64),
            "fid_kernel_vs_plain": abs(fid_kernel - fid_plain) / abs(fid64),
            "fid_eigh_root_rel_err": abs(fid_eigh - fid64) / abs(fid64),
            "ms": ms,
            "fp64_tflops": products * 2 * f**3 / (ms * 1e-3) / 1e12,
            # the plain body is the float64 loop on torch.matmul (cuBLAS DGEMM)
            "plain_ms": _time_ms(lambda: sqrtm_kernel._sqrtm_ns_reference(a), iters),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # cuSOLVER's eigh of the float64 covariance (the same function
            # at the kernel's precision); and of the float32 one, what the
            # JAX package serves at F = 2048
            "library_ms": _time_ms(lambda: torch.linalg.eigh(a), max(3, iters // 4)),
            "eigh_float32_ms": _time_ms(lambda: torch.linalg.eigh(s1), max(3, iters // 4)),
        })
        del got, ref
    _emit({"phase": "kernels", "kernel": "fid_sqrtm", "checks": rows})

    # the plain body's float64 step count on the rank-deficient and the
    # dominant-mode inputs
    sweeps = {}
    for shape_name in NS_SWEEP_SHAPES:
        mu1, s1, mu2, s2 = _sqrtm_inputs(next(s for s in SQRTM_SHAPES if s[0] == shape_name), dev)
        fid64 = _fid_float64(mu1, s1, mu2, s2)
        sweep = []
        for count in NS_SWEEP:
            root = sqrtm_kernel._sqrtm_ns_reference(s1.double(), iters=count)
            finite = bool(torch.isfinite(root).all())
            try:
                value = fid(mu1, s1, mu2, s2, root) if finite else float("nan")
            except torch.linalg.LinAlgError:  # a diverged root: eigvalsh finds no spectrum
                value = float("nan")
            sweep.append({
                "steps": count, "finite": finite, "reconstruction": _reconstruction(root, s1) if finite else None,
                "fid_rel_err": abs(value - fid64) / abs(fid64) if value == value else None,
            })
        sweeps[shape_name] = sweep
        _emit({"phase": "sqrtm_steps", "shape": shape_name, "dtype": "float64", "fid_float64": fid64, "sweep": sweep})

    for row in rows:
        _check(row["finite"], f"fid_sqrtm {row['shape']}: non-finite root")
        if row["full_rank"]:
            _check(row["max_err_scaled"] <= SQRTM_TOL, f"fid_sqrtm {row['shape']}: {row['max_err_scaled']} of max |ref| > {SQRTM_TOL}")
        for key in ("fid_kernel_rel_err", "fid_plain_rel_err"):
            _check(row[key] <= FID_RTOL, f"fid_sqrtm {row['shape']}: {key} {row[key]} > {FID_RTOL}")
    for shape_name, sweep in sweeps.items():
        _check(next(s for s in sweep if s["steps"] == steps)["finite"], f"fid_sqrtm: the plain body is not finite on {shape_name} at {steps} steps")
    return rows


def _inception_state(dev) -> dict:
    """Seeded He-scaled weights for the port's InceptionV3: conv weights
    N(0, 2 / fan_in), so activations stay O(1) through the depth; BatchNorm
    at identity (its statistics are calibrated afterwards); the fc head
    N(0, 0.125^2) with bias N(0, 0.1^2), so the logits spread over a few
    units and IS sits above 1."""
    import math

    import torch

    from torchmetrics_tpu_torch.models import InceptionV3Features

    with torch.device("meta"):
        template = InceptionV3Features().state_dict()
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    state = {}
    for name, t in template.items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros((), dtype=torch.int64)
        elif name.endswith("conv.weight"):
            fan_in = math.prod(t.shape[1:])
            state[name] = torch.randn(tuple(t.shape), generator=g, device=dev) * math.sqrt(2.0 / fan_in)
        elif name == "fc.weight":
            state[name] = 0.125 * torch.randn(tuple(t.shape), generator=g, device=dev)
        elif name == "fc.bias":
            state[name] = 0.1 * torch.randn(tuple(t.shape), generator=g, device=dev)
        elif name.endswith(("bn.weight", "running_var")):
            state[name] = torch.ones(tuple(t.shape), device=dev)
        else:
            state[name] = torch.zeros(tuple(t.shape), device=dev)
    return state


def _calibrate_batchnorm(state: dict, images, dev) -> dict:
    """``state`` with every BatchNorm's running mean and variance taken from
    one pass over ``images`` (an iterable of uint8 batches), as a trained
    network's statistics match the data it is fed: BatchNorm in training
    mode with a cumulative average, then back to eval. At identity
    statistics many of the seeded network's features never fire, and most
    eigenvalues of their covariance lie below what 16 Newton-Schulz steps
    converge (the ``f2048_dominant`` covariance of the ``fid_sqrtm``
    checks); statistics from the real images alone leave the generated
    ones' activations unbounded."""
    import torch

    from torchmetrics_tpu_torch.models import inception_feature_extractor

    extractor = inception_feature_extractor(state, feature_dim=2048, device=dev)
    norms = [m for m in extractor.network.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None
        m.train()
    for imgs in images:
        extractor(imgs)
    for m in norms:
        m.eval()
    return {k: v.detach().clone() for k, v in extractor.network.state_dict().items()}


def _cifar_images(g, n: int, generated: bool, dev):
    """``n`` 32 x 32 RGB uint8 images: 0.5 plus four random low-frequency
    sinusoids with per-channel amplitudes, and N(0, 0.02^2) pixel noise; the
    "generated" ones have less contrast (0.6x), a colour cast (+-0.07) and
    N(0, 0.12^2) noise."""
    import math

    import torch

    s = CIFAR10["size"]
    y = (torch.arange(s, device=dev, dtype=torch.float32) / s)[:, None]
    x = (torch.arange(s, device=dev, dtype=torch.float32) / s)[None, :]
    imgs = torch.full((n, 3, s, s), 0.5, device=dev)
    for _ in range(4):
        fy, fx = (0.5 + 2.5 * torch.rand((n, 1, 1, 1), generator=g, device=dev) for _ in range(2))
        phase = 2 * math.pi * torch.rand((n, 1, 1, 1), generator=g, device=dev)
        amp = 0.05 + 0.15 * torch.rand((n, 3, 1, 1), generator=g, device=dev)
        imgs += amp * torch.sin(2 * math.pi * (fy * y + fx * x) + phase)
    if generated:
        cast = torch.tensor([0.07, 0.0, -0.07], device=dev)[None, :, None, None]
        imgs = 0.5 + 0.6 * (imgs - 0.5) + cast + 0.12 * torch.randn(imgs.shape, generator=g, device=dev)
    else:
        imgs = imgs + 0.02 * torch.randn(imgs.shape, generator=g, device=dev)
    return (imgs.clamp(0.0, 1.0) * 255).to(torch.uint8)


def _cifar10(dev) -> dict:
    """The Inception family over CIFAR-10-shaped real and generated images:
    FID through its own network (feature=2048), and KID, MiFID and IS fed
    the taps of that same forward through callable extractors."""
    import torch

    from torchmetrics_tpu_torch.image import (
        FrechetInceptionDistance,
        InceptionScore,
        KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )

    spec = CIFAR10

    def batches():
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        for _ in range(spec["images"] // spec["batch"]):
            yield _cifar_images(g, spec["batch"], False, dev), _cifar_images(g, spec["batch"], True, dev)

    state = _calibrate_batchnorm(_inception_state(dev), (torch.cat(pair) for pair in batches()), dev)
    fid = FrechetInceptionDistance(feature=2048, inception_params=state)
    taps = {}
    fid.feature_extractor.network.register_forward_hook(lambda module, args, out: taps.update(out))
    kid = KernelInceptionDistance(
        feature_extractor=lambda imgs: taps[2048], subsets=spec["kid_subsets"], subset_size=spec["kid_subset_size"]
    )
    mifid = MemorizationInformedFrechetInceptionDistance(feature_extractor=lambda imgs: taps[2048])
    inception_score = InceptionScore(feature_extractor=lambda imgs: taps["logits_unbiased"], splits=spec["is_splits"])

    def update(real_imgs, fake_imgs):
        for imgs, real in ((real_imgs, True), (fake_imgs, False)):
            fid.update(imgs, real=real)  # the forward: every tap lands in `taps`
            kid.update(imgs, real=real)
            mifid.update(imgs, real=real)
            if not real:
                inception_score.update(imgs)

    return {"fid": fid, "kid": kid, "mifid": mifid, "is": inception_score, "state": state,
            "batches": batches, "update": update}


def _relative(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_cifar10(dev) -> dict:
    """The ``cifar10_fid`` workload: 20 + 20 updates and one compute of FID,
    KID, MiFID and IS on the card; FID against a float64 FID from the card's
    own states, KID, MiFID and IS against the same metrics on the CPU from the
    same features, one ``fid_sqrtm`` call of 1 + 2 * KERNEL_ITERS launches
    per FID and MiFID compute; and the network's features of 8 images against
    the port on the CPU."""
    import torch

    from torchmetrics_tpu_torch.image import (
        InceptionScore,
        KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )
    from torchmetrics_tpu_torch.image.fid import _fid_from_root
    from torchmetrics_tpu_torch.models import inception_feature_extractor
    from torchmetrics_tpu_torch.ops import sqrtm_kernel
    from torchmetrics_tpu_torch.utils.compute import full_float32

    spec = CIFAR10
    run = _cifar10(dev)
    fid, kid, mifid, inception_score = run["fid"], run["kid"], run["mifid"], run["is"]
    precision = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sqrtm_kernel.launches = sqrtm_kernel.calls = 0
    step_s = []
    for real_imgs, fake_imgs in run["batches"]():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run["update"](real_imgs, fake_imgs)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    compute_s, calls, launches = {}, {}, {}
    values = {}
    for name, metric in (("fid", fid), ("mifid", mifid), ("kid", kid), ("is", inception_score)):
        before = sqrtm_kernel.calls, sqrtm_kernel.launches
        t0 = time.perf_counter()
        values[name] = metric.compute()
        torch.cuda.synchronize()
        compute_s[name] = time.perf_counter() - t0
        calls[name] = sqrtm_kernel.calls - before[0]
        launches[name] = sqrtm_kernel.launches - before[1]
    total_launches = sqrtm_kernel.launches
    peak = torch.cuda.max_memory_allocated(dev)

    # FID against float64 from the card's own states
    n_r, n_f = int(fid.real_features_num_samples), int(fid.fake_features_num_samples)
    sums = {k: getattr(fid, k).to(torch.float64) for k in ("real_features_sum", "real_features_cov_sum", "fake_features_sum", "fake_features_cov_sum")}
    mu_r, mu_f = sums["real_features_sum"] / n_r, sums["fake_features_sum"] / n_f
    cov_r = (sums["real_features_cov_sum"] - n_r * torch.outer(mu_r, mu_r)) / (n_r - 1)
    cov_f = (sums["fake_features_cov_sum"] - n_f * torch.outer(mu_f, mu_f)) / (n_f - 1)
    fid64 = _fid_float64(mu_r, cov_r, mu_f, cov_f)
    # the same FID with the float32 eigh root (the port's CPU body) in place
    # of the kernel's
    fid_eigh32 = float(_fid_from_root(mu_r, cov_r, mu_f, cov_f, sqrtm_kernel._sqrtm_reference(cov_r.to(torch.float32))))
    # the real covariance's spectrum: numerical rank at float32's resolution
    # (the states are float32 sums; numpy's rule, F eps max |lambda|, with
    # float32's eps), and how many eigenvalues lie below what the kernel's
    # steps converge (1.5^-2K of ||A||_F)
    eig = torch.linalg.eigvalsh(cov_r)
    frobenius = float(torch.linalg.norm(cov_r))
    rank = int((eig.abs() > cov_r.shape[0] * torch.finfo(torch.float32).eps * eig.abs().max()).sum())
    dead = int((torch.diagonal(cov_r) == 0).sum())
    fid_terms = {
        "mean_diff_sq": float((mu_r - mu_f) @ (mu_r - mu_f)),
        "trace_real": float(torch.trace(cov_r)), "trace_generated": float(torch.trace(cov_f)),
        "mean_real_sq": float(mu_r @ mu_r),
    }

    # KID, MiFID and IS on the CPU from the features the card's metrics hold
    def identity(x):
        return x

    on_cpu = {
        "kid": KernelInceptionDistance(feature_extractor=identity, subsets=spec["kid_subsets"], subset_size=spec["kid_subset_size"], device="cpu"),
        "mifid": MemorizationInformedFrechetInceptionDistance(feature_extractor=identity, device="cpu"),
        "is": InceptionScore(feature_extractor=identity, splits=spec["is_splits"], device="cpu"),
    }
    for real, fake in zip(kid.real_features, kid.fake_features):
        on_cpu["kid"].update(real.cpu(), real=True)
        on_cpu["kid"].update(fake.cpu(), real=False)
    for real, fake in zip(mifid.real_features, mifid.fake_features):
        on_cpu["mifid"].update(real.cpu(), real=True)
        on_cpu["mifid"].update(fake.cpu(), real=False)
    for logits in inception_score.features:
        on_cpu["is"].update(logits.cpu())
    cpu_values = {k: m.compute() for k, m in on_cpu.items()}

    def flat(v):
        return [float(x) for x in v] if isinstance(v, tuple) else [float(v)]

    rel_vs_cpu = {k: max(_relative(a, b) for a, b in zip(flat(values[k]), flat(cpu_values[k]))) for k in on_cpu}

    # the network: 8 images on the card (cuDNN as configured, then full
    # float32) against the port on the CPU
    imgs = next(run["batches"]())[0][:8]
    extractor = fid.feature_extractor
    card_default = extractor(imgs)
    with full_float32():
        card_fp32 = extractor(imgs)
    cpu_state = {k: v.cpu() for k, v in run["state"].items()}
    cpu_features = inception_feature_extractor(cpu_state, feature_dim=2048, device="cpu")(imgs.cpu())
    scale = float(cpu_features.abs().max())
    network = {
        "images": 8, "tap": 2048, "mode_default": precision,
        "default_max_err_scaled": float((card_default.cpu() - cpu_features).abs().max()) / scale,
        "fp32_max_err_scaled": float((card_fp32.cpu() - cpu_features).abs().max()) / scale,
        "tolerance_fp32": NETWORK_FP32_TOL, "tolerance_default": NETWORK_TF32_TOL,
    }

    update_s, steps = sum(step_s), len(step_s)
    step_ms = sorted(t * 1e3 for t in step_s)
    out = {
        "phase": "cifar10_fid", "images": {"real": n_r, "generated": n_f}, "batch": spec["batch"],
        "updates": 2 * steps, "inception_forward": precision,
        "images_per_s": (n_r + n_f) / update_s, "update_s": update_s,
        "update_pair_ms": {"min": step_ms[0], "p50": step_ms[steps // 2], "max": step_ms[-1]},
        "compute_s": compute_s, "peak_mem_bytes": peak,
        "values": {k: flat(v) for k, v in values.items()}, "cpu_values": {k: flat(v) for k, v in cpu_values.items()},
        "fid_float64": fid64, "fid_rel_err": _relative(float(values["fid"]), fid64), "fid_float64_terms": fid_terms,
        "fid_eigh_root": fid_eigh32, "fid_eigh_root_rel_err": _relative(fid_eigh32, fid64),
        "real_covariance": {
            "rank": rank, "features": cov_r.shape[0], "zero_variance_features": dead,
            "top_eigenvalue_over_frobenius": float(eig[-1]) / frobenius,
            "eigenvalues_below_kernel_step_reach": int((eig < frobenius * 1.5 ** (-2 * sqrtm_kernel.KERNEL_ITERS)).sum()),
        },
        "rel_vs_cpu": rel_vs_cpu, "rtol": {"fid": FID_RTOL, "vs_cpu": CIFAR_RTOL},
        "fid_sqrtm_calls": calls, "fid_sqrtm_launches": launches, "fid_sqrtm_launches_total": total_launches,
        "network": network,
    }
    _emit(out)
    for k, v in values.items():
        _check(all(map(lambda x: x == x and abs(x) != float("inf"), flat(v))), f"cifar10_fid: {k} is not finite: {v}")
    _check(out["fid_rel_err"] <= FID_RTOL, f"cifar10_fid: FID {float(values['fid'])} vs float64 {fid64} beyond {FID_RTOL}")
    for k, rel in rel_vs_cpu.items():
        _check(rel <= CIFAR_RTOL, f"cifar10_fid: {k} differs from the CPU's by {rel} > {CIFAR_RTOL}")
    for k in ("fid", "mifid"):
        _check(calls[k] == 1 and launches[k] == 1 + 2 * sqrtm_kernel.KERNEL_ITERS,
               f"cifar10_fid: {k} compute made {calls[k]} fid_sqrtm calls and {launches[k]} launches")
    _check(calls["kid"] == calls["is"] == 0, "cifar10_fid: KID or IS called fid_sqrtm")
    _check(network["fp32_max_err_scaled"] <= NETWORK_FP32_TOL, f"cifar10_fid: network in full float32 differs from the CPU by {network['fp32_max_err_scaled']}")
    _check(network["default_max_err_scaled"] <= NETWORK_TF32_TOL, f"cifar10_fid: network as configured differs from the CPU by {network['default_max_err_scaled']}")
    return out


def _device_rows(prof) -> list:
    """``(name, device us, calls)`` of a profile's device-side events only
    (kernels, memsets, copies; a CPU operator's row repeats the device time
    of the kernels it launched), the largest first."""
    from torch.autograd import DeviceType

    rows = [
        (ev.key, ev.self_device_time_total, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
        and not ev.key.startswith("Activity Buffer")  # the profiler's own buffer traffic
        and not ev.key.startswith("ProfilerStep")  # a step's range repeats its kernels' time
    ]
    return sorted(rows, key=lambda r: -r[1])


def _profiled(step, steps: int):
    """``torch.profiler`` over ``step(i)`` for ``i`` in ``range(steps)``,
    after one profiled warm-up step (``step(-1)``) whose events are dropped:
    a trace's first launches can go unrecorded. Returns the device rows
    (:func:`_device_rows`) and the wall us of the ``steps`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    plan = schedule(wait=0, warmup=1, active=steps, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=plan) as prof:
        step(-1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
            if i == steps - 1:  # the device's work ends inside the active window
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    return _device_rows(prof), wall_us


def _complete(rows, steps: int) -> bool:
    """Whether every device row was recorded the same number of times in
    each step (a row whose count is no multiple of ``steps`` lost launches)."""
    return all(n % steps == 0 for _, _, n in rows)


def phase_profile(name: str, dev, steps: int = 5) -> dict:
    """Where one update's time goes: ``torch.profiler`` over ``steps``
    updates of pre-generated batches (after one warm-up update outside the
    profiler and one inside it), device time by kernel and the device's idle
    share of the wall time."""
    spec = WORKLOADS[name](dev)
    coll = spec["collection"]()
    update = _update(spec)
    gen = spec["batches"]()
    update(coll, next(gen))
    batches = [next(gen) for _ in range(steps + 1)]

    def step(i: int) -> None:
        update(coll, batches[i + 1])
        if i == steps - 1 and spec.get("profile_compute"):  # retrieval computes on the grid
            coll.compute()

    rows, wall_us = _profiled(step, steps)
    busy_us = sum(r[1] for r in rows)
    # a compute runs once, in the last update, so its rows are no multiple
    complete = bool(spec.get("profile_compute")) or _complete(rows, steps)
    return _emit({
        "phase": f"profile_{name}", "updates": steps, "with_compute": bool(spec.get("profile_compute")),
        "complete": complete,
        "wall_ms_per_update": wall_us / steps / 1e3,
        "device_ms_per_update": busy_us / steps / 1e3 if complete else None,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us) if wall_us and complete else None,
        "top_device_kernels": [
            {"name": k[:120], "ms_per_update": us / steps / 1e3, "calls_per_update": n / steps, "ms_per_launch": us / n / 1e3}
            for k, us, n in rows[:12]
        ],
    })


def _own_kernel(name: str) -> bool:
    """Whether a device row is one of the port's kernels (each is defined in
    an anonymous namespace of its ``csrc/*.cu``; ATen's and CUB's carry
    their own namespaces)."""
    return "(anonymous namespace)::" in name and "at::" not in name and "cub::" not in name


def _profile_calls(phase: str, fn, module, calls: int = 5) -> None:
    """Where one wrapper call's device time goes: ``torch.profiler`` over
    ``calls`` calls after a warm-up call outside the profiler and one inside
    it. The trace is complete when each of the port's kernels was recorded
    the same number of times in every call, and at least as many times in
    all as ``module.launches`` counted (a wrapper counts a call once where
    it launches two kernels; the trace can drop a launch); a call's device
    time is given only then, each kernel's time per recorded launch
    always."""
    import torch

    fn()
    torch.cuda.synchronize()
    made = []

    def step(i: int) -> None:
        before = module.launches
        fn()
        if i >= 0:
            made.append(module.launches - before)

    rows, wall_us = _profiled(step, calls)
    own = [r for r in rows if _own_kernel(r[0])]
    recorded = sum(n for _, _, n in own)
    complete = _complete(own, calls) and recorded >= sum(made) > 0
    _emit({
        "phase": phase, "calls": calls, "launches_made": sum(made), "launches_recorded": recorded,
        "complete": complete,
        "wall_ms_per_call": wall_us / calls / 1e3,
        "device_ms_per_call": sum(r[1] for r in rows) / calls / 1e3 if complete else None,
        "device_kernels": [
            {"name": k[:120], "ms_per_call": us / calls / 1e3, "launches_per_call": c / calls, "ms_per_launch": us / c / 1e3}
            for k, us, c in rows
        ],
    })


def phase_profile_kernel_shapes(dev) -> None:
    """Device time of one wrapper call of every kernel at each of its checked
    shapes."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount, binned_curve, sqrtm_kernel, ssim_kernel, topk_kernel

    for name, k, length, n, weighted in KERNEL_SHAPES:
        x, w = _bincount_inputs(k, length, n, weighted, dev)
        _profile_calls(f"profile_bincount_{name}", lambda: bincount._wbincount_cuda(x, w, length), bincount)

    for name, n, len_t, kind, edges in CURVE_SHAPES:
        preds, target, valid, thr = _curve_inputs(n, len_t, kind, edges, dev)
        args = (preds, target, valid, *binned_curve.sort_thresholds(thr))
        _profile_calls(f"profile_binned_curve_{name}", lambda: binned_curve._binned_counts_cuda(*args), binned_curve)
    for name, q, length, top_k in TOPK_SHAPES:
        t, counts = _topk_grid(q, length, dev, SEED + q + length)
        k = -1 if top_k is None else top_k
        _profile_calls(
            f"profile_retrieval_topk_stats_{name}", lambda: topk_kernel._topk_stats_cuda(t, counts, k), topk_kernel
        )
    for name, m, hp, wp, kind, k in SSIM_SHAPES:
        x = torch.rand((m, hp, wp), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        taps = _ssim_taps(kind, k, dev)
        _profile_calls(f"profile_ssim_windows_{name}", lambda: ssim_kernel._windowed_cuda(x, taps, taps), ssim_kernel)
        del x
    for name, b, c, h, w, kind, k in SSIM_FUSED_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED)
        preds, target = (torch.rand((b, c, h, w), generator=g, device=dev) for _ in range(2))
        taps = _ssim_taps(kind, k, dev)
        pad = _ssim_pad(kind, k)
        _profile_calls(
            f"profile_ssim_fused_{name}",
            lambda: ssim_kernel._ssim_fused_cuda(preds, target, taps, taps, pad, pad, 1e-4, 9e-4, False),
            ssim_kernel,
        )
        del preds, target
    for shape in SQRTM_SHAPES:
        a = _sqrtm_inputs(shape, dev)[1].double()
        _profile_calls(f"profile_fid_sqrtm_{shape[0]}", lambda: sqrtm_kernel._sqrtm_cuda(a), sqrtm_kernel, calls=2)


def phase_profile_cifar10(dev) -> None:
    """Where the ``cifar10_fid`` time goes: ``torch.profiler`` over two
    update pairs (after one warm-up pair outside the profiler and one inside
    it) and the FID compute."""
    run = _cifar10(dev)
    gen = run["batches"]()
    run["update"](*next(gen))
    batches = [next(gen) for _ in range(3)]

    def step(i: int) -> None:
        run["update"](*batches[i + 1])
        if i == 1:
            run["fid"].compute()

    rows, wall_us = _profiled(step, 2)
    busy_us = sum(r[1] for r in rows)
    _emit({
        "phase": "profile_cifar10_fid", "update_pairs": 2, "with_compute": "fid",
        "wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us) if wall_us else None,
        "top_device_kernels": [{"name": k[:120], "ms": us / 1e3, "calls": n} for k, us, n in rows[:15]],
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
    curve_rows = phase_curve_kernels(dev)
    imagenet = phase_workload("imagenet_val", dev)
    cityscapes = phase_workload("cityscapes_val", dev)
    binary = phase_binary_curve(dev)
    imagenet_curve = phase_imagenet_curve(dev)
    phase_exact_auroc(dev)
    topk_rows = phase_topk_kernels(dev)
    ssim = phase_ssim_kernels(dev)
    msmarco = phase_msmarco(dev)
    uvg = phase_uvg(dev)
    sqrtm_rows = phase_sqrtm_kernels(dev)
    cifar = phase_cifar10(dev)
    if PROFILE:
        for name in WORKLOADS:
            if name != "uvg_1080p":  # profiled inside phase_uvg
                phase_profile(name, dev)
        phase_profile_cifar10(dev)
        phase_profile_kernel_shapes(dev)

    # top-level numbers: each kernel's heaviest launch on its main path (the
    # Cityscapes update's weightless 361-bin count over 8.4M pixels; the config-6
    # update's 100 thresholds over 1M scores; MS MARCO's 6,980 x 1,000 grid
    # at k = 10; the 1080p update's fused SSIM call over 24 planes); every
    # shape under "shapes"
    main = next(r for r in rows if r["shape"] == "cityscapes_confmat_weightless")
    curve = next(r for r in curve_rows if r["shape"] == "config6")
    topk = next(r for r in topk_rows if r["shape"] == "msmarco_k10")
    window = next(r for r in ssim["rows"] if r["shape"] == "uvg_1080p")
    fused = next(r for r in ssim["fused"] if r["shape"] == "uvg_1080p")
    root = next(r for r in sqrtm_rows if r["shape"] == "f2048_d1")
    _emit({"kernels": [
        {
            "name": "bincount",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
            "replaces": "torchmetrics_tpu/ops/bincount.py:76",
            "launches": imagenet["bincount_launches"] + cityscapes["bincount_launches"]
            + imagenet_curve["bincount_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shapes": rows,
        },
        {
            "name": "binned_curve",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/binned_curve.cu",
            "replaces": "torchmetrics_tpu/ops/binned_curve.py:103",
            "launches": binary["binned_curve_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in curve_rows),
            "ms": curve["ms"],
            "plain_ms": curve["plain_ms"],
            "bound_ms": curve["bound_ms"],
            "bound_by": curve["bound_by"],
            # no single PyTorch call computes (T, 2, 2) threshold counts;
            # composite_ms times bucketize + bincount + cumsum instead
            "library_ms": None,
            "composite_ms": curve["composite_ms"],
            "shapes": curve_rows,
        },
        {
            "name": "retrieval_topk_stats",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/retrieval_topk_stats.cu",
            "replaces": "torchmetrics_tpu/ops/topk_kernel.py:68",
            "launches": msmarco["topk_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in topk_rows),
            "ms": topk["ms"],
            "plain_ms": topk["plain_ms"],
            "bound_ms": topk["bound_ms"],
            "bound_by": topk["bound_by"],
            # no single PyTorch call gives the four masked row sums;
            # composite_ms times them one pass each
            "library_ms": None,
            "composite_ms": topk["composite_ms"],
            "shapes": topk_rows,
        },
        {
            "name": "ssim_windows",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/ssim_windows.cu",
            "replaces": "torchmetrics_tpu/ops/ssim_kernel.py:52",
            "launches": uvg["ssim_launches"],
            "max_abs_err": max([r["max_abs_err"] for r in ssim["rows"]] + [r["max_abs_err_ssim"] for r in ssim["fused"]]),
            # the headline is the entry every main-path launch takes: SSIM
            # fused around the windows (tm_ssim_fused), one launch an SSIM
            # call, at the UVG update's full scale
            "entry": "tm_ssim_fused",
            "ms": fused["ms"],
            "plain_ms": fused["plain_ms"],
            "bound_ms": fused["bound_ms"],
            "bound_by": fused["bound_by"],
            # one grouped F.conv2d of the padded five-plane stack (the
            # windows alone, without TF32)
            "library_ms": fused["library_ms"],
            "shapes": ssim["fused"],
            # the second entry, the route when a gradient is needed: the
            # generic windowed sum (tm_ssim_windows) and its backward
            "generic": {
                "entry": "tm_ssim_windows",
                "max_abs_err": max(r["max_abs_err"] for r in ssim["rows"]),
                "ms": window["ms"],
                "plain_ms": window["plain_ms"],
                "bound_ms": window["bound_ms"],
                "bound_by": window["bound_by"],
                # one grouped F.conv2d with the rank-1 window, without TF32
                "library_ms": window["library_ms"],
                "shapes": ssim["rows"],
                "backward": ssim["backward"],
            },
        },
        {
            "name": "fid_sqrtm",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/fid_sqrtm.cu",
            "replaces": "torchmetrics_tpu/ops/sqrtm_kernel.py:82",
            "launches": cifar["fid_sqrtm_launches_total"],
            "calls": sum(cifar["fid_sqrtm_calls"].values()),
            "max_abs_err": max(r["max_abs_err"] for r in sqrtm_rows if r["full_rank"]),
            "ms": root["ms"],
            "plain_ms": root["plain_ms"],
            "bound_ms": root["bound_ms"],
            "bound_by": root["bound_by"],
            # cuSOLVER's eigh of the float64 covariance; plain_ms is the
            # float64 steps on torch.matmul (cuBLAS DGEMM)
            "library_ms": root["library_ms"],
            "eigh_float32_ms": root["eigh_float32_ms"],
            "shapes": sqrtm_rows,
        },
    ]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
