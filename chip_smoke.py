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

- the rest of classification on the ``bincount`` and ``binned_curve``
  kernels: the ImageNet batches (logits leaning to the target) through Dice,
  exact match, hinge loss and two per-class fixed operating points (100
  thresholds); COCO 2014 val shaped multi-label batches (40,504 images, 80
  labels, batch 256) through exact match, coverage error, label ranking
  average precision and loss and precision at fixed recall; WILDS
  CivilComments test shaped batches (133,782 comments, 8 identity groups,
  batch 4,096) through demographic parity, equal opportunity, the per-group
  rates, hinge loss and two binary fixed operating points; counts against
  plain counts bit for bit, values and selected thresholds against float64;
- the rest of image on the ``ssim_windows`` kernel's generic entry: DIV2K
  validation scored as x4 super-resolution (100 images of 3 x 1356 x 2040,
  batch 4; preds the targets blurred and noised) through PSNR, PSNR-B on
  the luma, TV, RMSE-SW, SCC, VIF and LPIPS-Alex (seeded parameters), and
  UQI, SAM, ERGAS and RASE over the first 20 images; WorldView-3
  pan-sharpening as PanCollection's test sets give it (20 reduced-
  resolution samples of 8 x 256 x 256 through SAM, ERGAS, UQI and D_lambda;
  20 full-resolution ones, MS 8 x 128 x 128 and PAN 512 x 512, through
  D_lambda, D_s and QNR) and the perceptual path length of a seeded
  generator (1,024 samples, LPIPS-VGG); generic launches against what the
  code implies, never the fused entry, the first batch's values against
  the same functionals on CPU copies;
- regression and pairwise distances, on plain PyTorch (no kernel of the
  port launches there, and the counts are checked to stay at 0): NYU Depth
  V2's Eigen test split (654 images of 480 x 640, batch 8) through fifteen
  error and correlation metrics in one collection, with Spearman over the
  first 20 images; WeatherBench 2's headline scores at 1.5 degrees (732
  initialisations of a 121 x 240 grid, eight variables in raw units: 21.3M
  rows, past 2**24 in Pearson's exact count) through MSE, RMSE, R2,
  explained variance, Pearson, concordance and CSI on TP24h at 1 mm;
  NAS-Bench-201's 15,625 cells through Kendall tau-b and tau-c (with its
  t-test), Spearman and Pearson, against scipy; DeepFashion In-shop's
  14,218 queries against its 12,612-image gallery (512-d) through the five
  pairwise functions, Manhattan and Minkowski in row chunks; every value
  against float64 of the same data, within the bound float32's summation
  gives (scaled by each statistic's cancellation), with updates/s, compute
  ms and peak memory;
- the wrappers and nominal association, on the ``bincount`` and
  ``fid_sqrtm`` kernels: the ImageNet batches through two BootStrappers of
  100 replicates (top-1 poisson, macro F1 multinomial, 95% quantiles), each
  replicate's counts against a plain int64 count of the same resample and
  exactly 9,800 launches, and the functional path with explicit indices;
  three epochs of them through MetricTracker (top-1, top-5, macro F1),
  MinMaxMetric and Running (16 batches); NYUv2 as multi-task papers score
  it (654 images of 288 x 384, batch 8) through MultitaskWrapper with
  mIoU, pixel accuracy, per-class IoU (ClasswiseWrapper), MAE and MAPE;
  OGB ogbg-molpcba's test split (43,793 x 128 tasks, NaN labels) through
  MultioutputWrapper of exact average precision; the ``cifar10_fid``
  images through FeatureShare([FID, KID, MiFID]), one Inception forward an
  update and values bit-equal to that phase's; UCI Census 1990's shape
  (2,458,285 rows x 68 coded columns) through the Cramér's V and Theil's U
  matrices, a collection of the four table metrics and Fleiss' kappa on
  CIFAR-10H-shaped ratings, against float64 and scipy;
- text, on the port's C++ edit-distance library (built with ``g++`` and
  asserted loaded) and plain PyTorch, no kernel of the port launching:
  WikiText-2 perplexity at GPT-2's vocabulary (71 updates of 8 x 1,024 x
  50,257 float32 logits, windows of 1,024 at stride 512) against float64,
  an unmasked out-of-range target giving NaN with the context alive;
  LibriSpeech test-clean (2,620 utterances) through WER, CER, MER, WIL, WIP
  and edit distance against exact counts; newstest2014 (3,003 sentences)
  through SacreBLEU, BLEU, chrF++, TER (first 512) and EED (first 256);
  CNN/DailyMail's 11,490 highlights through ROUGE-1/2/L (ROUGE-Lsum over
  the first 2,048); SQuAD v1.1 dev's 10,570 questions; BERTScore on a
  seeded 50,265 x 1,024 embedding table and InfoLM's nine measures on
  seeded 30,522-token distributions, both on the card, against float64.
  Text is synthetic, from seeded numpy generators, at each set's
  published shape; each class is held to its functional over the same
  data.
- audio, on plain PyTorch and the port's PESQ library (asserted loaded),
  no kernel of the port launching, with speech-shaped signals made on the
  card from the two formant-synthesised clips of
  ``tests/fixtures_real/speech.npz`` (read circularly at random rates,
  offsets and gains): Libri2Mix test (3,000 two-speaker mixtures at 8 kHz,
  then Libri3Mix's first 256) through PIT with SI-SDR, SA-SDR, SNR, SI-SNR
  and SDR at filter length 512; VoiceBank+DEMAND test (824 utterances at
  16 kHz) through PESQ (wb, nb), STOI and ESTOI on the host path and with
  ``on_device=True``, and SI-SDR; REVERB 2014's SimData evaluation set
  (2,176 utterances) through SRMR on both paths; every value against
  float64 or the CPU, the device paths against the host paths;
- clustering on the ``bincount`` kernel: ImageNet-1k validation clustered
  as SCAN scores it (50,000 samples, 1,000 clusters, 2,048-wide Gaussian
  embeddings) through the nine label metrics, each contingency one
  1,000,000-bin launch, and Calinski-Harabasz, Davies-Bouldin and Dunn,
  against float64;
- detection, segmentation and multimodal, on plain PyTorch but panoptic
  quality's intersection tables, one ``bincount`` launch an update: COCO
  2017 val box detection (5,000 images, 80 categories, 36,781 annotations,
  100 detections an image) through mean AP with per-class results and the
  four IoU classes, against the CPU over 500 images, a perfect detector and
  float64 IoUs; mask mAP over the first 200 images at 640 x 480; COCO
  panoptic val2017 (5,000 images at 640 x 480, 133 categories) through PQ
  and modified PQ against a numpy copy of the JAX package's algorithm;
  BraTS 2021's 219 cases of 240 x 240 x 155 through ``mask_edges`` and
  ``surface_distance`` against ``scipy.ndimage``; CLIPScore over the
  Karpathy test split and CLIP-IQA over KonIQ-10k on a seeded stand-in at
  CLIP ViT-B/32's widths, against float64. Each mAP compute's peak is held
  to the metric's own reckoning.
- the runtime layers on the ImageNet collection (batches made from the seed
  and their index): traced with every flag off, telemetry on, tracing on
  and tracing with an ``observe_ready`` device span an update, in turns
  over nine rounds, values bit-equal across them, spans counted, a Chrome
  trace and Prometheus text parsed back (host µs an update and a span's
  cost printed); a spawned child under ``Autosaver`` and the preemption
  handler, killed by SIGTERM after update 30, its final snapshot restored
  in this process and finished bit-equal to an uninterrupted run, then
  again from the snapshot before a torn newest one (snapshot bytes, save,
  final-save and restore ms printed); ``compute_async()`` every 8 updates
  on the default and on a side stream, each future bit-equal to
  ``compute()`` at its count.
- session lanes over LEAF FEMNIST's 3,550 writers (805,263 samples, 62
  classes, batches of 32): the entry collection laned, one row-folded
  ``bincount`` launch a round, with and without lane fault containment;
- streaming windows: the Criteo Display Advertising Challenge train set
  (45,840,617 rows cut into 168 hours) through the windowed binary entry
  collection with binned AUROC and AP (a 24-hour ring, late clicks an hour
  late admitted and two hours late dropped, async reads at the day's close,
  a save and restore at hour 100), every ring and window against fresh
  collections of the admitted rows bit for bit, advance and update µs at
  W = 24 and 168; and the FEMNIST writers as windowed session lanes (a
  4-batch ring, skewed clocks, late batches), every lane's ring against a
  plain per-window count, one ``bincount`` launch a round.
- class-axis state sharding at Google Landmarks v2-clean's scale (1,580,470
  images, 81,313 classes, batches of 4,096; Zipf labels from the seed):
  confusion matrix, micro accuracy and macro F1 with
  ``state_sharding="class_axis", class_shards=8`` (a 26.45 GB stacked
  confusion state), every (target, pred) cell against the host's counts,
  one 3C ``bincount`` launch an update; the deferred (stacked) layouts:
  the ImageNet collection with ``reduce="deferred"`` over 8 shards
  (reduce, reshard 8 -> 4 -> 1, a snapshot restored elastic onto 4
  shards), and the FEMNIST writers through ``make_deferred_lane_step``
  with 8 shards, unwindowed and at W = 4, bit-equal to plain counts; and,
  in the sync phase, ``sync_precision="quantized"`` at 8 and 16 bits on
  the float families within ``reduce_error_bound``.
- state integrity and the fleet: the ``fingerprint`` kernel (XOR and
  wrapping sum of a state tree's words, one launch a tree) against its
  plain body on every state dtype, a tree, per-shard rows and a leaf of
  2**31 + 3 words; the ImageNet collection with every member audited
  (clean, and a flipped bit caught under ``"restore"``, ``"degraded"`` and
  ``"raise"``); GLDv2's 26.45 GB class-sharded state audited over a second
  pass of 32 batches, its fold against the 7.90 ms bytes bound; and a
  federated evaluation of FEMNIST's writers as 64 sites under a two-level
  aggregator tree, with dropped, duplicated, delayed, partitioned and
  corrupted deltas and an aggregator's failover, converging bit for bit to
  the fault-free fold, then the same traffic quantized at 8 bits;
- the compile cache over the ImageNet collection (``imagenet_val_compile_cache``):
  child processes sharing a store of shape profiles, cold (its captures
  and writes), warm (the recorded keys built before the executor's first
  call, which replays), warmed from the cold run's saved manifest with the
  store off, over a poisoned store (a flipped byte, a stale toolchain) and
  with background captures (cold keys served eagerly, every ``bincount``
  launch accounted for by thread, the live thread's longest wait on the
  device's lock), each bit-equal to ``executor=False``; and the
  ``bincount`` library damaged (a flipped byte, a sidecar naming another
  toolchain), warned about, rebuilt by ``nvcc`` and held to the plain
  body. The script's own process runs with the store off, in a fresh
  cache directory.

It holds both ``ssim_windows`` entries against their plain versions: the
generic windowed sum (11, 7, 67, 131 and 201 taps) and its backward, and the
fused SSIM entry at the UVG update's shapes, 67 and 131 taps and a uniform
window (and the generic entry at the rest of image's shapes: VIF's 17 taps
at 1356 x 2040, UQI's 11-tap stack, the 8- and 7-tap uniform windows); and the weightless ``bincount`` of 2**24 + 3 equal indices (and the
confusion matrix on them) to the exact count.

It also holds ``fid_sqrtm`` (float64 Newton-Schulz steps on the FP64
tensor cores) against its plain body at the Inception taps' widths (F = 64
to 2048, full-rank, rank-deficient, untiled and dominant-mode covariances),
holds the FID each root gives to float64 on every one, and sweeps the plain
body's float64 step count on the rank-deficient and dominant-mode inputs.

Every kernel check also gives ``host_ms``: the wall time of 1,000
back-to-back wrapper calls with no synchronisation, divided by 1,000 (the
host path a call; where the calls' launches overflow the launch queue,
the device's rate).

Scores, logits, labels and images are drawn from seeded ``torch.Generator`` s on the
card. With ``--profile`` it also traces a few updates of each workload with
``torch.profiler`` (device time by kernel, device idle share; for MS MARCO
the compute too), and a few calls of each kernel at each of its checked
shapes.
Each phase prints one JSON line; then come the script's wall time, the
kernel table line, the card's name and power limit as ``nvidia-smi`` reports them, and the final line
``{"ok": true, "device": {...}}``. Any failed build, launch error or mismatch
exits non-zero, and so does a run without a CUDA device.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

KERNELS = ("bincount", "binned_curve", "retrieval_topk_stats", "ssim_windows", "fid_sqrtm", "fingerprint")
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
#: ignore_index mask folded into the index; the one-vs-rest curve count, a
#: positive's bin shifted by (100 + 1) x 1000; Dice's (1000 + 1)^2
#: out-of-range-aware confusion count; the 4 x 8 per-group fairness count;
#: the COCO per-label curve count over 2 x 101 x 80 bins; the laned FEMNIST
#: round's row-folded count: 3,550 writers' 32-sample batches over
#: 3,550 x 62 x 62 bins, one launch for the whole round; the windowed
#: Criteo collection's binary count over 4 bins at its three batch sizes:
#: 32,768 rows, an hour's 7,714-row last batch and its 2,729-row late
#: batch, the last two reaching the kernel's tail past a multiple of 4)
KERNEL_SHAPES = [
    ("binary_segmentation", 1, 4, 4 * 1024 * 2048, True),
    ("cityscapes_confmat", 1, 19 * 19, 4 * 1024 * 2048, True),
    ("imagenet_confmat", 1, 1000 * 1000, 1024, True),
    ("calibration_k3", 3, 15, 1_000_000, True),
    ("imagenet_curve_k2", 2, 101 * 1000, 1024 * 1000, True),
    ("binary_segmentation_weightless", 1, 4, 4 * 1024 * 2048, False),
    ("cityscapes_confmat_weightless", 1, 19 * 19, 4 * 1024 * 2048, False),
    ("imagenet_curve_weightless", 1, 2 * 101 * 1000, 1024 * 1000, False),
    ("imagenet_dice_weightless", 1, 1001 * 1001, 1024, False),
    ("civilcomments_groups_weightless", 1, 4 * 8, 4096, False),
    ("coco_curve_weightless", 1, 2 * 101 * 80, 256 * 80, False),
    ("femnist_rows_weightless", 1, 3_550 * 62 * 62, 3_550 * 32, False),
    ("criteo_batch_weightless", 1, 4, 32_768, False),
    ("criteo_last_weightless", 1, 4, 7_714, False),
    ("criteo_late_weightless", 1, 4, 2_729, False),
]
#: one update past float32's last exact integer: 2**24 + 3 equal indices,
#: whose weightless count must come out exactly (int64)
PAST_2_24 = 2**24 + 3
#: binned-curve checks: (name, N, T, thresholds, edges, form). "grid" is the
#: 100-point grid of an integer ``thresholds``, "random" unsorted uniform
#: thresholds; edges adds NaN scores, scores exactly on a threshold and
#: duplicated thresholds. Form "int32_mask": int32 0/1 targets and a 95%
#: bool mask; "int64_ignore": what the binned binary update hands the
#: kernel, int64 targets with 5% of them ignore_index -1 and no mask;
#: "int64": int64 targets, no mask and no ignore_index (the CivilComments
#: update's fixed operating points; the windowed Criteo AUROC and AP at
#: their three batch sizes, 200 thresholds)
CURVE_SHAPES = [
    ("config6", 1_000_000, 100, "grid", False, "int32_mask"),
    ("config6_int64_ignore", 1_000_000, 100, "grid", False, "int64_ignore"),
    ("doc_2m", 2_000_000, 200, "grid", False, "int32_mask"),
    ("t1000", 8_388_608, 1000, "grid", False, "int32_mask"),
    ("t50k", 1_000_000, 50_000, "random", False, "int32_mask"),
    ("edges", 1_000_000, 64, "random", True, "int32_mask"),
    ("civilcomments_int64", 4096, 100, "grid", False, "int64"),
    ("criteo_batch_int64", 32_768, 200, "grid", False, "int64"),
    ("criteo_last_int64", 7_714, 200, "grid", False, "int64"),
    ("criteo_late_int64", 2_729, 200, "grid", False, "int64"),
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
#: users with top-100 candidates, and with top-20 (a short list: 4 lanes a
#: row, 5 float4s)
TOPK_SHAPES = [
    ("msmarco_k10", 6980, 1000, 10),
    ("msmarco_all", 6980, 1000, None),
    ("movielens_k100", 138_493, 100, 10),
    ("movielens_k20", 138_493, 20, 10),
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
    # the rest of image's main-path generic windows (phases div2k_x4_val and
    # wv3_pansharpening): VIF's 17-tap scale-0 window over a DIV2K batch's
    # channel (4 x 1356 x 2040); UQI's 11-tap window over its 5 x 4 x 3
    # stack, reflect-padded by 5; the 8-tap uniform window of RMSE-SW, RASE
    # and SCC (scipy's 4 + 3 padding) over 4 x 3 planes; D_s's 7-tap uniform
    # window over WorldView-3's 20 x 8 pan planes of 512 x 512
    ("div2k_vif17", 4, 1356, 2040, "vif", 17),
    ("div2k_uqi11", 60, 1366, 2050, "gaussian", 11),
    ("div2k_uniform8", 12, 1363, 2047, "uniform", 8),
    ("wv3_ds_uniform7", 160, 518, 518, "uniform", 7),
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
    _note_executors()
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


def _host_ms(fn, calls: int = 1000) -> float:
    """Host time of one call: the wall time of ``calls`` back-to-back calls
    with no synchronisation, divided by ``calls`` (after one warm-up call;
    the device is drained outside the timing). Where the device is slower
    and the calls' launches overflow the launch queue (about a thousand
    launches: ``fid_sqrtm`` makes 45 a call), this reads the device's rate
    instead."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


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
        # in-range ones once (none weightless), write the histogram once
        # (float32 weighted, int64 weightless); one compare per index and K
        # adds per in-range index
        nbytes = n * 4 + (n_in * 4 * k if weighted else 0) + k * length * (4 if weighted else 8)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (n + n_in * k) / FP32_OPS_PER_S * 1e3
        iters = 50 if n < 1 << 20 else 20
        row = {
            "shape": name, "K": k, "L": length, "N": n, "weighted": weighted, "in_range": n_in,
            "max_abs_err": err,
            "tolerance": "exact" if integral else "rtol=1e-5",
            "ms": _time_ms(lambda: bincount._wbincount_cuda(x, w, length), iters),
            "host_ms": _host_ms(lambda: bincount._wbincount_cuda(x, w, length)),
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


def _curve_args(n: int, len_t: int, kind: str, edges: bool, form: str, dev):
    """The kernel's arguments for a ``CURVE_SHAPES`` row, thresholds sorted
    once (as a metric sorts them when it is built): ``(preds, target, valid,
    thr_sorted, order, ignore_index)``. "int64_ignore" marks the masked-out
    samples of "int32_mask" with ignore_index -1 in an int64 target."""
    import torch

    from torchmetrics_tpu_torch.ops import binned_curve

    preds, target, valid, thr = _curve_inputs(n, len_t, kind, edges, dev)
    thr_sorted, order = binned_curve.sort_thresholds(thr)
    if form == "int32_mask":
        return preds, target, valid, thr_sorted, order, None
    if form == "int64":
        return preds, target.to(torch.int64), None, thr_sorted, order, None
    target = torch.where(valid, target.to(torch.int64), torch.full((), -1, dtype=torch.int64, device=dev))
    return preds, target, None, thr_sorted, order, -1


def _composite_counts(preds, target, valid, thr_sorted, order, ignore_index=None):
    """The same counts from stock PyTorch calls (bucketize, bincount,
    cumsum), timed as a yardstick only; no path of the port runs it."""
    import torch

    if valid is None:
        valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
        target = torch.where(valid, target, torch.zeros_like(target))
    target = target.to(torch.int64)
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
    for name, n, len_t, kind, edges, form in CURVE_SHAPES:
        args = _curve_args(n, len_t, kind, edges, form, dev)
        target, valid = args[1], args[2]
        got = binned_curve._binned_counts_cuda(*args)
        ref = binned_curve._binned_counts_reference(*args)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max())
        _check(torch.equal(got, ref), f"binned_curve {name}: kernel differs from the plain version (max |d| {err})")
        _check(
            torch.equal(_composite_counts(*args), ref[:, :, 1].T),
            f"binned_curve {name}: the composite yardstick disagrees",
        )
        n_valid = int(ref[0].sum())
        # least work for this data: read each score, target and mask (if
        # any) once and the thresholds once, write the (T, 2, 2) int64 counts
        # once; one float compare per search step of each valid sample
        per_sample = 4 + target.element_size() + (0 if valid is None else 1)
        nbytes = n * per_sample + len_t * 4 + len_t * 4 * 8
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_valid * math.ceil(math.log2(len_t + 1)) / FP32_OPS_PER_S * 1e3
        iters = 20 if n <= 2_000_000 else 10
        rows.append({
            "shape": name, "N": n, "T": len_t, "thresholds": kind, "edges": edges, "form": form,
            "bytes_per_sample": per_sample, "valid": n_valid,
            "max_abs_err": err, "tolerance": "exact",
            "ms": _time_ms(lambda: binned_curve._binned_counts_cuda(*args), iters),
            "host_ms": _host_ms(lambda: binned_curve._binned_counts_cuda(*args)),
            "plain_ms": _time_ms(lambda: binned_curve._binned_counts_reference(*args), iters),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "composite_ms": _time_ms(lambda: _composite_counts(*args), iters),
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
            "host_ms": _host_ms(lambda: topk_kernel._topk_stats_cuda(t, counts, k)),
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

    from torchmetrics_tpu_torch.functional.image.vif import _filter_1d

    if kind == "vif":
        return _filter_1d(k, k / 5, device=dev)
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
            "host_ms": _host_ms(lambda: ssim_kernel._windowed_cuda(x, taps, taps)),
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
            "host_ms": _host_ms(kernel),
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

    def collection(executor=None, **_):
        kw = {"validate_args": False, "executor": executor}
        return MetricCollection(
            {
                "accuracy": MulticlassAccuracy(num_classes=c, average="micro", **kw),
                "f1": MulticlassF1Score(num_classes=c, average="macro", **kw),
                "precision": MulticlassPrecision(num_classes=c, average="macro", **kw),
                "recall": MulticlassRecall(num_classes=c, average="macro", **kw),
                "confmat": MulticlassConfusionMatrix(num_classes=c, **kw),
            },
            executor=executor,
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

    def collection(executor=None, validate_args=True):
        kw = {"ignore_index": ignore, "validate_args": validate_args, "executor": executor}
        return MetricCollection(
            {
                "jaccard": MulticlassJaccardIndex(num_classes=c, average="macro", **kw),
                "accuracy": MulticlassAccuracy(num_classes=c, **kw),
                "confmat": MulticlassConfusionMatrix(num_classes=c, **kw),
            },
            executor=executor,
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

    def collection(executor=None, **_):
        kw = {"thresholds": spec["thresholds"], "ignore_index": ignore, "validate_args": False, "executor": executor}
        return MetricCollection(
            {"auroc": BinaryAUROC(**kw), "ap": BinaryAveragePrecision(**kw), "roc": BinaryROC(**kw)}, executor=executor
        )

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

    def collection(executor=None, **_):
        return MetricCollection(
            {
                "ssim": StructuralSimilarityIndexMeasure(data_range=1.0, executor=executor),
                "ms_ssim": MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, executor=executor),
            },
            executor=executor,
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


def _executor_extra(coll, per_update: int = 1) -> int:
    """Launches the captured executor adds to the eager path's, from its
    counters: one row-0 update a padded replay (the padding's contribution
    it subtracts; a padded call on a fresh key runs the batch as given) and
    one eager oracle update a probe, each ``per_update`` launches. 0 where
    the executor stepped aside or replayed no padded batch."""
    stats = coll.executor_status["stats"]
    return per_update * (stats["padded_calls"] + stats["probes"])


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
            "compute_groups": [list(g) for g in getattr(coll, "compute_groups", {}).values()],
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
    # the executor keys ImageNet's steady 1,024 and Cityscapes' steady 4
    # exactly and serves the ragged 848's fresh padded key eagerly: no
    # padded replay, no probe, one launch an update as without it
    _check(launches == spec["updates"], f"{name}: {launches} bincount launches for {out['updates']} updates")
    cm, tp, fp, fn, present = _derived(plain)
    spec["check"](result, tp, fp, fn, present.to(torch.float64))
    _check(torch.equal(result["confmat"].to(torch.int64), plain), f"{name}: computed confusion matrix differs")
    out.update({
        "counted": int(cm.sum()), "num_classes": spec["num_classes"], "bincount_launches": launches,
        "executor": _executor_summary(coll),
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
    expected = len(coll) + (spec["updates"] - 1) * len(groups)  # the steady 1M scores: an exact key, no padding
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
        "executor": _executor_summary(coll),
        "values": {"auroc": float(result["auroc"]), "ap": float(result["ap"])},
        "state_exact": True,
    })
    _emit(out)
    return out


def _label_counts(probs, pos, grid):
    """``(T, C, 2, 2)`` counts of scores ``(B, C)`` against a bool ``pos``
    ``(B, C)`` straight from the definition: one ``>=`` per threshold, score
    and column; shares no code with the port's update."""
    import torch

    ge = probs[None] >= grid[:, None, None]  # (T, B, C)
    pos = pos[None]
    tp, fp = (ge & pos).sum(1), (ge & ~pos).sum(1)
    fn, tn = (~ge & pos).sum(1), (~ge & ~pos).sum(1)
    return torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)


def _onevsrest_counts(probs, target, grid):
    """``(T, C, 2, 2)`` one-vs-rest counts of class scores against labels."""
    import torch

    return _label_counts(probs, torch.nn.functional.one_hot(target, probs.shape[1]).to(torch.bool), grid)


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
    expected = spec["updates"] * (1 + 5)  # a batch of 8: an exact key, no padding
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


# ------------------------------------------------------- the captured executor
#
# Four phases drive an existing workload twice over the same batches (each
# spec's batches come from a seeded generator): executor=False, then
# executor=True. The executor replays one CUDA graph an update (the whole
# collection's compute groups) over its own state slots.

EXECUTOR_PHASES = {
    # phase: (workload, the collection executor's keys, profiled updates)
    "imagenet_val_executor": ("imagenet_val", 8),
    "cityscapes_val_executor": ("cityscapes_val", 4),
    "binary_curve_1m_executor": ("binary_curve_1m", 4),
    "uvg_1080p_executor": ("uvg_1080p", 4),
}
#: the phases whose steady batch is off the ladder (Cityscapes' 4 images,
#: the 1M binary scores): their launches a kernel, on and off alike (every
#: update one count; the first update every member's: one Jaccard/accuracy/
#: confusion group, three curves)
EXECUTOR_STEADY = {
    "cityscapes_val": {"bincount": 125},
    "binary_curve_1m": {"binned_curve": 3 + 49},
}
#: the ImageNet run's checks of escaped and pending tensors: updates after
#: the read, and the batches the check runs over
EXECUTOR_ESCAPE = {"updates_after": 10, "batches": 4}

_SERIALS = iter(range(1 << 62))
#: every executor seen at a phase's emit (live then): serial -> its summary
_EXECUTORS_SEEN: dict = {}


def _executor_summary(obj) -> dict:
    """The parts of ``executor_status`` a phase line carries."""
    status = obj.executor_status
    stats = status["stats"]
    keys = ("calls", "compiles", "cache_hits", "padded_calls", "probes", "donated_calls", "copied_calls",
            "skipped_calls", "dispatch_failures", "recovery_restores", "compile_us_total", "captured", "eager")
    return {"enabled": status["enabled"], "engaged": status["engaged"], "fallback_reason": status["fallback_reason"],
            **{k: stats[k] for k in keys}}


def _note_executors() -> None:
    """Record every live executor's state (called at each phase's emit,
    while the phase's metrics are alive)."""
    from torchmetrics_tpu_torch.obs import registry

    for ex in list(registry._executors):
        serial = ex.__dict__.setdefault("_chip_smoke_serial", next(_SERIALS))
        reason = ex.stats_dict()["fallback_reason"]
        _EXECUTORS_SEEN[serial] = {"owner": ex._owner_name(), "engaged": ex.stats["calls"] > 0, "reason": reason}


def _executor_tally() -> dict:
    """The closing summary: instances whose executor engaged, and the
    fallback reasons by kind (a reason's text up to its first colon or
    parenthesis; a failed capture's with its error)."""
    import re

    reasons: dict = {}
    idle = 0
    for rec in _EXECUTORS_SEEN.values():
        if rec["engaged"]:
            continue
        if rec["reason"] is None:
            idle += 1  # built (a collection leader's) and never needed on its own
            continue
        reason = rec["reason"]
        # a capture's failure keeps its error's kind; other reasons their head
        kind = reason[:120] if reason.startswith("capture failed") else re.split(r"[:(]", reason, maxsplit=1)[0].strip()
        reasons[kind] = reasons.get(kind, 0) + 1
    return {
        "phase": "executor_summary", "instances": len(_EXECUTORS_SEEN),
        "engaged": sum(1 for r in _EXECUTORS_SEEN.values() if r["engaged"]), "idle": idle,
        "fallback_reasons": dict(sorted(reasons.items(), key=lambda kv: -kv[1])),
    }


def _expected_keys(sizes: list) -> int:
    """Cache keys the collection executor builds over the batches after the
    first (the first update resolves the compute groups, its members
    eager): a size that repeats the one before it (or was so keyed
    before), up to ``_EXACT_SIZES`` of them, or a power of two from 8 on,
    is keyed exactly; any other size pads up the ladder."""
    from torchmetrics_tpu_torch.ops.executor import _EXACT_SIZES, bucket_size

    keys, exact, last = set(), set(), None
    for n in sizes[1:]:
        if bucket_size(n) == n or n in exact or (n == last and len(exact) < _EXACT_SIZES):
            if bucket_size(n) != n:
                exact.add(n)
            keys.add(("exact", n))
        else:
            keys.add(("ladder", bucket_size(n)))
        last = n
    return len(keys)


def _leader_state(coll) -> dict:
    return {cg[0]: {k: coll[cg[0]]._state[k].clone() for k in coll[cg[0]]._defaults} for cg in coll.compute_groups.values()}


def _drive_executor(phase: str, spec: dict, dev, executor: bool) -> dict:
    """Update a fresh collection over every batch (executor on or off) and
    compute it, every launch count set to 0 just before and read just after;
    then ``torch.profiler`` over a few more updates of a second collection,
    for the device time an update."""
    import torch

    counters = _launch_counters()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    coll = spec["collection"](executor=executor, validate_args=False)
    for module in counters.values():
        module.launches = 0
    step_s, sizes, first = [], [], None
    for batch in spec["batches"]():
        sizes.append(int(batch[0].shape[0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coll.update(*batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if first is None:  # the first update resolves the groups: every member updates
            first = {name: module.launches for name, module in counters.items()}
    launches = {name: module.launches for name, module in counters.items()}
    state = _leader_state(coll)
    result = coll.compute()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    summary = _executor_summary(coll)
    ex = coll._executor_obj
    pool, static = (ex.graph_pool_bytes(), ex.static_bytes()) if ex is not None else (0, 0)
    steps = EXECUTOR_PHASES[phase][1]
    prof = spec["collection"](executor=executor, validate_args=False)
    gen = spec["batches"]()
    # resolve the groups, build the keys (the first size pads, its repeat is
    # keyed exactly) and judge the exact key at its second replay, all
    # before the profiled window
    warm = [next(gen) for _ in range(5)]
    for batch in warm:
        prof.update(*batch)
    batches = [next(gen) for _ in range(steps + 1)]
    rows, wall_us = _profiled(lambda i: prof.update(*batches[i + 1]), steps)
    busy_us = sum(r[1] for r in rows)
    del prof, batches, warm, gen
    median_s = statistics.median(step_s)
    return {
        "coll": coll, "state": state, "result": result, "launches": launches, "first_launches": first, "sizes": sizes, "out": {
            "executor": executor, "updates": len(step_s), "updates_per_s": len(step_s) / sum(step_s),
            "update_ms_p50": median_s * 1e3,
            "profiled_updates": steps, "wall_us_per_update_profiled": wall_us / steps, "device_us_per_update": busy_us / steps,
            # wall minus device time: the median unprofiled update's, and
            # inside the profiled window (where the profiler's own cost rides)
            "host_us_per_update": median_s * 1e6 - busy_us / steps,
            "host_us_per_update_profiled": (wall_us - busy_us) / steps, "profile_complete": _complete(rows, steps),
            "peak_mem_above_base_bytes": peak, "graph_pool_bytes": pool, "static_bytes": static, "launches": launches,
            "capture_ms": summary["compile_us_total"] / 1e3, "stats": summary,
        },
    }


def _bit_equal_states(phase: str, on: dict, off: dict, atol: float) -> dict:
    """Counts bit for bit; float states within ``atol`` (0: bit for bit too,
    and whether they were is reported)."""
    import torch

    float_err = 0.0
    for leader, fields in off.items():
        for k, v in fields.items():
            got = on[leader][k]
            if v.is_floating_point():
                err = float((got.to(torch.float64) - v.to(torch.float64)).abs().max()) if v.numel() else 0.0
                float_err = max(float_err, err)
                _check(err <= atol, f"{phase}: float state {leader}.{k} differs by {err} > {atol}")
            else:
                _check(torch.equal(got, v), f"{phase}: state {leader}.{k} differs from executor=False")
    return {"max_float_state_err": float_err}


def _escape_checks(dev) -> dict:
    """ImageNet's constraint checks on the card, on a fresh executor
    collection beside an eager one over the same batches: a tensor read by
    reference and a pending ``compute_async`` keep their submission-time
    values through ten more updates; a dispatch that fails after its replay
    ran (``fail_dispatch(consume=True)``) leaves the state bit-equal."""
    import torch

    from torchmetrics_tpu_torch.testing import faults

    spec = WORKLOADS["imagenet_val"](dev)
    on = spec["collection"](executor=True)
    # these checks hold a replaying key's escapes and recovery, so its
    # verdict is off: the key's one timed replay runs beside the pending
    # compute_async's worker, which can slow it past the eager trials and
    # leave no dispatch to fail (the phase's own run holds the verdict)
    on._get_executor().dispatcher().judging = False
    off = spec["collection"](executor=False)
    gen = spec["batches"]()
    batches = [next(gen) for _ in range(EXECUTOR_ESCAPE["batches"])]
    for b in batches[:3]:
        on.update(*b)
        off.update(*b)
    held = on["confmat"].confmat
    future = on.compute_async()
    want = off["confmat"].confmat.clone()
    want_values = off.compute()
    for _ in range(EXECUTOR_ESCAPE["updates_after"]):
        on.update(*batches[3])
    torch.cuda.synchronize()
    _check(torch.equal(held, want), "imagenet_val_executor: a tensor read by reference changed under later updates")
    pending = future.result(60.0)
    for k, v in want_values.items():
        _check(torch.equal(pending[k], v), f"imagenet_val_executor: compute_async's {k} is not its submission-time value")
    before = _leader_state(on)
    count = on.update_count
    stats = on.executor_status["stats"]
    _check(stats["captured"] and stats["eager"]["keys"] == 0 and not stats["eager"]["calls"],
           f"imagenet_val_executor: the key does not replay, no dispatch to fail: {stats['eager']}")
    raised = False
    with faults.fail_dispatch(consume=True):
        try:
            on.update(*batches[3])
        except faults.FaultInjected:
            raised = True
    torch.cuda.synchronize()
    after = on.executor_status["stats"]
    _check(raised, "imagenet_val_executor: fail_dispatch did not propagate")
    for leader, fields in before.items():
        for k, v in fields.items():
            _check(torch.equal(on[leader]._state[k], v), f"imagenet_val_executor: {leader}.{k} changed under a failed dispatch")
    _check(on.update_count == count, "imagenet_val_executor: a failed dispatch moved the update count")
    _check(after["dispatch_failures"] == stats["dispatch_failures"] + 1, "imagenet_val_executor: dispatch failure not counted")
    _check(after["recovery_restores"] == stats["recovery_restores"] + len(before), "imagenet_val_executor: restores not counted")
    return {
        "escaped_unchanged": True, "async_unchanged": True, "failed_dispatch_kept_state": True,
        "updates_after_read": EXECUTOR_ESCAPE["updates_after"], "donated_after_read": after["donated_calls"],
    }


def phase_executor(phase: str, dev) -> dict:
    """One workload with the executor off and on over the same batches:
    states bit-equal (SSIM's float sums within ``UVG_SSIM_ATOL``), launches
    per kernel equal up to the executor's own (one row-0 update a padded
    call, one oracle update a probe), the collection's executor engaged with
    one capture per key the batches imply; updates/s, host us an update,
    capture ms, padding and copies, peak memory and the graph pool's
    bytes."""
    import torch

    workload = EXECUTOR_PHASES[phase][0]
    spec = WORKLOADS[workload](dev)
    off = _drive_executor(phase, spec, dev, False)
    on = _drive_executor(phase, spec, dev, True)
    coll = on["coll"]
    status = coll.executor_status
    stats = status["stats"]
    _check(status["engaged"] and stats["captured"], f"{phase}: the collection's executor did not engage: {status['fallback_reason']}")
    keys = _expected_keys(on["sizes"])
    _check(stats["compiles"] == keys, f"{phase}: {stats['compiles']} captures, the batches imply {keys}")
    atol = UVG_SSIM_ATOL if workload == "uvg_1080p" else 0.0
    compared = _bit_equal_states(phase, on["state"], off["state"], atol)
    for k, v in off["result"].items():
        got, want = on["result"][k], v
        pairs = list(zip(got, want)) if isinstance(want, (tuple, list)) else [(got, want)]
        for g, w in pairs:
            err = float((g.to(torch.float64) - w.to(torch.float64)).abs().max()) if w.numel() else 0.0
            _check(err <= max(atol, 1e-6), f"{phase}: computed {k} differs from executor=False by {err}")
    per_update = {}
    for kernel, n in off["launches"].items():
        # an update of the resolved groups (the first one updates every member)
        later, calls = n - off["first_launches"][kernel], off["out"]["updates"] - 1
        per_update[kernel] = later // calls if later % calls == 0 else None
        want = n + (per_update[kernel] or 0) * (stats["padded_calls"] + stats["probes"])
        _check(per_update[kernel] is not None and on["launches"][kernel] == want,
               f"{phase}: {kernel} launched {on['launches'][kernel]} times with the executor, {want} expected ({n} without)")
    if workload in EXECUTOR_STEADY:
        # a steady batch off the ladder is keyed exactly: no call pads, and
        # every kernel launches as often as without the executor
        _check(stats["padded_calls"] == 0, f"{phase}: {stats['padded_calls']} padded calls for a steady batch")
        for kernel, n in EXECUTOR_STEADY[workload].items():
            _check(on["launches"][kernel] == off["launches"][kernel] == n,
                   f"{phase}: {kernel} launched {on['launches'][kernel]} times on, {off['launches'][kernel]} off, {n} expected")
    out = {
        "phase": phase, "workload": workload, "updates": off["out"]["updates"], "keys_implied": keys,
        "off": off["out"], "on": on["out"], "launches_per_update_off": per_update,
        "speedup_updates_per_s": on["out"]["updates_per_s"] / off["out"]["updates_per_s"],
        "speedup_median_update": off["out"]["update_ms_p50"] / on["out"]["update_ms_p50"],
        "eager_keys": stats["eager"],
        **compared,
    }
    for run in (off, on):
        for name, launched in run["launches"].items():
            out[f"{name}_launches"] = out.get(f"{name}_launches", 0) + launched
    if workload == "imagenet_val":
        out["constraints"] = _escape_checks(dev)
    del off, on, coll
    return _emit(out)


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
        # 1,000 calls at F = 2048 take 23 s each, with the launch queue full
        # (device-bound): measured at the headline shape only
        host = _host_ms(lambda: sqrtm_kernel._sqrtm_cuda(a)) if f < 2048 or name == "f2048_d1" else None
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
            "host_ms": host,
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
    # the calibrated network and the images, for the FeatureShare phase
    out["_reuse"] = {"state": run["state"], "batches": run["batches"]}
    return out


#: the sync phase (one-rank NCCL world), depth cut to fit the time limit:
#: the first 8 ImageNet batches (of 49) through the ImageNet collection plus
#: specificity, Hamming distance, Matthews correlation and Cohen's kappa
#: (1,000 classes), and their per-sample losses through the aggregators; the
#: first 4 config-6 batches (of 50, 1M scores each) through exact-mode and
#: binned binary AUROC; all 70 MS MARCO updates (6,980 x 1,000); FID at
#: F = 2048 over 4 batches of 600 real and 600 generated feature rows
#: the ImageNet batches' shapes (IMAGENET) with logits that lean to the
#: target (top-1 near 0.75, a ResNet-50's) at temperature 3, so that the
#: softmax scores spread over the threshold grid and the operating points
#: are not all sentinels
IMAGENET_REST = {"margin": 4.0, "scale": 3.0, "thresholds": 100}
#: COCO 2014 val as the multi-label literature scores it: 40,504 images, 80
#: labels, about 2.9 positives an image, batches of 256 (158 and one of 56)
COCO = {"images": 40_504, "labels": 80, "positives": 2.9, "batch": 256, "thresholds": 100}
#: WILDS CivilComments test split: 133,782 comments, 8 identity groups with
#: one id a comment (the shares are illustrative), 10% toxic, batches of
#: 4,096 (32 and one of 2,710)
CIVILCOMMENTS = {
    "comments": 133_782, "groups": 8, "positive_rate": 0.1, "batch": 4096, "thresholds": 100,
    "group_shares": (0.30, 0.20, 0.15, 0.10, 0.10, 0.07, 0.05, 0.03),
}
#: the threshold of an unattainable operating point
SENTINEL = 1e6
SYNC = {"imagenet_batches": 8, "curve_batches": 4, "fid_features": 2048, "fid_batches": 4, "fid_batch": 600,
        "weather_batches": 4, "repeats": 5}
#: Matthews correlation and Cohen's kappa on the synced ImageNet counts
#: against float64 from the plain count: float32 near 0
SYNC_ATOL = 1e-5


def _sync_families(dev) -> dict:
    """name -> (metric or collection, batches, update) of every synced family."""
    import torch
    import torch.nn.functional as F

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.classification import (
        BinaryAUROC,
        MulticlassCohenKappa,
        MulticlassHammingDistance,
        MulticlassMatthewsCorrCoef,
        MulticlassSpecificity,
    )
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    from torchmetrics_tpu_torch.regression import MeanSquaredError, PearsonCorrCoef

    imagenet = _imagenet(dev)
    c = imagenet["num_classes"]
    counts = imagenet["collection"]()
    counts.add_metrics({
        "specificity": MulticlassSpecificity(num_classes=c, validate_args=False),
        "hamming": MulticlassHammingDistance(num_classes=c, validate_args=False),
        "mcc": MulticlassMatthewsCorrCoef(num_classes=c, validate_args=False),
        "kappa": MulticlassCohenKappa(num_classes=c, validate_args=False),
    })
    n = SYNC["imagenet_batches"]
    image_batches = [b for _, b in zip(range(n), imagenet["batches"]())]
    aggregators = tm.MetricCollection({
        "sum": tm.SumMetric(), "mean": tm.MeanMetric(), "max": tm.MaxMetric(), "min": tm.MinMetric(),
        "cat": tm.CatMetric(), "running_mean": tm.RunningMean(window=5),
    })
    ignore = BINARY_CURVE["ignore_index"]
    curves = tm.MetricCollection({
        "exact": BinaryAUROC(thresholds=None, ignore_index=ignore, validate_args=False),
        "binned": BinaryAUROC(thresholds=BINARY_CURVE["thresholds"], ignore_index=ignore, validate_args=False),
    })
    msmarco = _msmarco(dev)
    fid = FrechetInceptionDistance(feature_extractor=lambda x: x, num_features=SYNC["fid_features"])

    def features():
        g = torch.Generator(device=dev).manual_seed(SEED + 11)
        shape = (SYNC["fid_batch"], SYNC["fid_features"])
        for _ in range(SYNC["fid_batches"]):
            yield torch.randn(shape, generator=g, device=dev), 1.1 * torch.randn(shape, generator=g, device=dev) + 0.05

    def update_fid(m, batch):
        m.update(batch[0], real=True)
        m.update(batch[1], real=False)

    nv = len(WEATHERBENCH["variables"])
    weather = tm.MetricCollection({"pearson": PearsonCorrCoef(num_outputs=nv), "mse": MeanSquaredError(num_outputs=nv)})
    weather_batches = [_weatherbench_batch(i, dev) for i in range(SYNC["weather_batches"])]
    return {
        "imagenet_counts": (counts, image_batches, lambda m, b: m.update(*b)),
        "aggregators": (
            aggregators, [F.cross_entropy(p, t, reduction="none") for p, t in image_batches],
            lambda m, b: m.update(b),
        ),
        "binary_auroc": (curves, list(_binary_curve(dev)["batches"](SYNC["curve_batches"])), lambda m, b: m.update(*b)),
        "msmarco": (msmarco["collection"](), list(msmarco["batches"]()), msmarco["update"]),
        "fid": (fid, list(features()), update_fid),
        "weatherbench_moments": (weather, weather_batches, lambda m, b: m.update(*b)),
    }


def _bit_equal(a, b) -> bool:
    """Equal bit for bit: dicts key by key, a list state concatenated (a
    synced list is one tensor, or one per rank), a None-reduced field (one
    rank's stack) by its elements; NaN where the other has NaN."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bit_equal(a[k], b[k]) for k in a)
    a, b = (torch.cat([torch.atleast_1d(t) for t in x]) if isinstance(x, list) else x for x in (a, b))
    if a.dtype != b.dtype or a.numel() != b.numel():
        return False
    a, b = a.reshape(-1), b.reshape(-1)
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _state_bytes(state) -> int:
    import torch

    total = 0
    for v in state.values():
        for t in v if isinstance(v, list) else [v]:
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


def _check_imagenet_sync(result, batches) -> dict:
    """The synced ImageNet counts against the plain count of the same
    batches: the confusion matrix exact, the derived values float64's."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount

    c = IMAGENET["num_classes"]
    plain = None
    for preds, target in batches:
        idx = (c * target + preds.argmax(1)).to(torch.int32)
        counts = bincount._wbincount_reference(idx, None, c * c).to(torch.int64)
        plain = counts if plain is None else plain + counts
    plain = plain.reshape(c, c)
    _check(torch.equal(result["confmat"].to(torch.int64), plain), "sync: the synced confusion matrix differs from the plain count")
    cm, tp, fp, fn, present = _derived(plain)
    w = present.to(torch.float64)
    n = cm.sum()
    tn = n - tp - fp - fn
    _close("sync specificity", result["specificity"], (_safe(tn, tn + fp) * w).sum() / w.sum())
    _close("sync hamming", result["hamming"], 1 - (_safe(tp, tp + fn) * w).sum() / w.sum())
    tk, pk = cm.sum(1), cm.sum(0)
    mcc = (tp.sum() * n - (tk * pk).sum()) / torch.sqrt((n**2 - (pk * pk).sum()) * (n**2 - (tk * tk).sum()))
    expected = torch.outer(tk, pk) / n
    off = 1 - torch.eye(c, dtype=torch.float64, device=cm.device)
    kappa = 1 - (off * cm).sum() / (off * expected).sum()
    errors = {"mcc": abs(float(result["mcc"]) - float(mcc)), "kappa": abs(float(result["kappa"]) - float(kappa))}
    for name, err in errors.items():
        _check(err <= SYNC_ATOL, f"sync: {name} {float(result[name])} is {err} from float64")
    return {"mcc_float64": float(mcc), "kappa_float64": float(kappa), "abs_err": errors}


def phase_sync(dev, backend: str = "nccl") -> dict:
    """Cross-process sync in a one-rank world of ``backend`` (NCCL on the
    card: a real communicator whose collectives launch NCCL kernels).

    Each family is updated batch by batch, then computed without a sync
    (``functional_compute`` of its state) and with one (``compute()``,
    sync on compute): the two must be equal bit for bit, and so must every
    field of ``functional_sync`` against the state, since the world is one
    rank. Printed for each family: the collectives of one sync, counted at
    the seams, and the median wall time of a ``functional_sync`` (ending in
    a device synchronise) over a few repeats. Every kernel's launch count
    is set to 0 before the families run and read after; ``bincount`` must
    launch once per ImageNet update, and every kernel on the synced path at
    least once."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.parallel import sync as psync

    store_dir = Path(__file__).resolve().parent / "torchmetrics_tpu_torch" / "_build"
    store_dir.mkdir(parents=True, exist_ok=True)
    store = tempfile.mkdtemp(dir=store_dir)
    dist.init_process_group(backend, init_method=f"file://{store}/store", world_size=1, rank=0, device_id=dev)
    try:
        families = _sync_families(dev)
        counters = _launch_counters()
        for module in counters.values():
            module.launches = 0
        rows = {}
        for name, (metric, batches, update) in families.items():
            before = {k: m.launches for k, m in counters.items()}
            t0 = time.perf_counter()
            for batch in batches:
                update(metric, batch)
            torch.cuda.synchronize()
            update_s = time.perf_counter() - t0
            update_launches = {k: m.launches - before[k] for k, m in counters.items()}
            local = metric.functional_compute(metric.state())
            t0 = time.perf_counter()
            synced = metric.compute()
            torch.cuda.synchronize()
            compute_synced_ms = (time.perf_counter() - t0) * 1e3
            _check(_bit_equal(synced, local), f"sync: {name}: the synced compute differs from the unsynced one")
            state = metric.state()
            is_collection = isinstance(metric, MetricCollection)
            leaders = state if is_collection else {name: state}
            r0, g0 = psync.all_reduces, psync.all_gathers
            after = metric.functional_sync(state)
            collectives = {"all_reduce": psync.all_reduces - r0, "all_gather": psync.all_gathers - g0}
            after = after if is_collection else {name: after}
            for leader, st in leaders.items():
                _check(int(after[leader]["_update_count"]) == st["_update_count"], f"sync: {name}: update count")
                _check(
                    _bit_equal({k: v for k, v in after[leader].items() if k != "_update_count"},
                               {k: v for k, v in st.items() if k != "_update_count"}),
                    f"sync: {name}: functional_sync changed {leader}'s state in a world of one",
                )
            sync_ms = []
            for _ in range(SYNC["repeats"]):
                t0 = time.perf_counter()
                metric.functional_sync(state)
                torch.cuda.synchronize()
                sync_ms.append((time.perf_counter() - t0) * 1e3)
            state_bytes = sum(_state_bytes(st) for st in leaders.values())
            rows[name] = {
                "updates": len(batches), "update_s": update_s, "update_launches": update_launches,
                "collectives_per_sync": collectives, "state_bytes": state_bytes,
                "sync_ms": statistics.median(sync_ms), "sync_ms_all": sync_ms,
                "compute_synced_ms": compute_synced_ms, "bit_equal": True,
            }
            if name == "imagenet_counts":
                rows[name]["check"] = _check_imagenet_sync(synced, batches)
                bc = update_launches["bincount"]
                _check(bc == len(batches), f"sync: {bc} bincount launches for {len(batches)} ImageNet updates")
        launches = {k: m.launches for k, m in counters.items()}
        # sync_precision="quantized" on the float families; the integer
        # ImageNet counts under the same policy stay bit-equal
        quantized = {}
        aggregators = families["aggregators"][0]
        weather = families["weatherbench_moments"][0]
        targets = (
            ("fid", families["fid"][0], True), ("weatherbench_mse", weather["mse"], True),
            ("weatherbench_pearson", weather["pearson"], False),
            ("sum", aggregators["sum"], True), ("mean", aggregators["mean"], True),
        )
        for bits in QUANT["bits"]:
            for name, metric, expect in targets:
                quantized[f"{name}/int{bits}"] = _quantized_row(name, metric, bits, expect)
            counts = families["imagenet_counts"][0]
            for m in counts.values():
                m.sync_precision, m.sync_quant_bits = "quantized", bits
            st = counts.state()
            _check(_bit_equal(_fields(counts.functional_sync(st)), _fields(st)),
                   f"sync: the integer ImageNet counts changed under the int{bits} policy")
            for m in counts.values():
                m.sync_precision, m.sync_quant_bits = "exact", 8
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    on_path = ("bincount", "binned_curve", "retrieval_topk_stats", "fid_sqrtm")
    for k in on_path:
        _check(launches[k] > 0, f"sync: {k} was not launched on the synced path")
    out = {"phase": "sync", "backend": backend, "world": 1, "launches": launches, "families": rows, "quantized": quantized}
    _emit(out)
    return out


# ----------------------------------------------- the rest of classification


def _splits(total: int, batch: int) -> list:
    return [batch] * (total // batch) + ([total % batch] if total % batch else [])


def _imagenet_rest(dev) -> dict:
    """Dice, exact match, hinge loss and two fixed operating points over
    the ImageNet batches."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        Dice,
        MulticlassExactMatch,
        MulticlassHingeLoss,
        MulticlassRecallAtFixedPrecision,
        MulticlassSpecificityAtSensitivity,
    )

    c, spec = IMAGENET["num_classes"], IMAGENET_REST

    def batches():
        g = torch.Generator(device=dev).manual_seed(SEED + 7)
        for b in IMAGENET["batches"]:
            target = torch.randint(0, c, (b,), generator=g, device=dev)
            noise = torch.randn((b, c), generator=g, device=dev)
            lean = spec["margin"] * torch.nn.functional.one_hot(target, c).to(torch.float32)
            yield spec["scale"] * (noise + lean), target

    def collection():
        kw = {"num_classes": c, "validate_args": False}
        points = {"thresholds": spec["thresholds"], **kw}
        return MetricCollection({
            "dice": Dice(num_classes=c, average="macro"),
            "exact_match": MulticlassExactMatch(**kw),
            "hinge": MulticlassHingeLoss(**kw),
            "recall_at_precision": MulticlassRecallAtFixedPrecision(min_precision=0.5, **points),
            "specificity_at_sensitivity": MulticlassSpecificityAtSensitivity(min_sensitivity=0.5, **points),
        })

    return {
        "updates": len(IMAGENET["batches"]), "samples": sum(IMAGENET["batches"]), "batches": batches,
        "collection": collection,
        # (counting members, counting compute groups): every member counts on
        # the first update, one leader a group after it
        "counting": {"bincount": (3, 2)},
    }


def _coco_multilabel(dev) -> dict:
    """Exact match, the three ranking metrics and precision at fixed recall
    over COCO-shaped multi-label batches."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        MultilabelCoverageError,
        MultilabelExactMatch,
        MultilabelPrecisionAtFixedRecall,
        MultilabelRankingAveragePrecision,
        MultilabelRankingLoss,
    )

    spec = COCO
    labels, sizes = spec["labels"], _splits(spec["images"], spec["batch"])

    def batches():
        g = torch.Generator(device=dev).manual_seed(SEED + 8)
        for b in sizes:
            target = (torch.rand((b, labels), generator=g, device=dev) < spec["positives"] / labels).to(torch.int64)
            scores = torch.sigmoid(torch.randn((b, labels), generator=g, device=dev) + 3.0 * target - 2.0)
            yield scores, target

    def collection():
        kw = {"num_labels": labels, "validate_args": False}
        return MetricCollection({
            "exact_match": MultilabelExactMatch(**kw),
            "coverage_error": MultilabelCoverageError(**kw),
            "ranking_ap": MultilabelRankingAveragePrecision(**kw),
            "ranking_loss": MultilabelRankingLoss(**kw),
            "precision_at_recall": MultilabelPrecisionAtFixedRecall(min_recall=0.5, thresholds=spec["thresholds"], **kw),
        })

    return {
        "updates": len(sizes), "samples": spec["images"], "batches": batches, "collection": collection,
        "counting": {"bincount": (1, 1)},
    }


def _civilcomments(dev) -> dict:
    """Group fairness, hinge loss and two binary fixed operating points over
    CivilComments-shaped batches of scores, toxicity labels and identity ids."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        BinaryFairness,
        BinaryGroupStatRates,
        BinaryHingeLoss,
        BinaryRecallAtFixedPrecision,
        BinarySensitivityAtSpecificity,
    )

    spec = CIVILCOMMENTS
    sizes = _splits(spec["comments"], spec["batch"])

    def batches():
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        shares = torch.tensor(spec["group_shares"], device=dev)
        for b in sizes:
            groups = torch.multinomial(shares, b, replacement=True, generator=g)
            target = (torch.rand(b, generator=g, device=dev) < spec["positive_rate"]).to(torch.int64)
            # a score that leans to the label, shifted a little by the group
            logits = torch.randn(b, generator=g, device=dev) + 2.5 * target - 1.5 + 0.1 * groups
            yield torch.sigmoid(logits), target, groups

    def collection():
        kw = {"thresholds": spec["thresholds"], "validate_args": False}
        return MetricCollection({
            "fairness": BinaryFairness(num_groups=spec["groups"], validate_args=False),
            "group_rates": BinaryGroupStatRates(num_groups=spec["groups"], validate_args=False),
            "hinge": BinaryHingeLoss(validate_args=False),
            "recall_at_precision": BinaryRecallAtFixedPrecision(min_precision=0.8, **kw),
            "sensitivity_at_specificity": BinarySensitivityAtSpecificity(min_specificity=0.9, **kw),
        })

    return {
        "updates": len(sizes), "samples": spec["comments"], "batches": batches, "collection": collection,
        "update": lambda coll, b: coll.update(b[0], b[1], groups=b[2]),
        "counting": {"bincount": (2, 1), "binned_curve": (2, 1)},
    }


def _operating_point(counts, grid, floor: float, family: str):
    """float64 ``(values, thresholds)`` of a family from exact ``(T, [C,] 2,
    2)`` counts, from the definition: the largest objective among the
    thresholds whose constraint reaches ``floor``; ties to the larger
    constraint (the precision-recall pair), then to the larger threshold;
    the threshold 1e6 where none qualifies, and for the precision-recall
    pair also where the best objective is 0."""
    import torch

    cm = counts.to(torch.float64)
    tp, fp, fn, tn = cm[..., 1, 1], cm[..., 0, 1], cm[..., 1, 0], cm[..., 0, 0]
    pr_pair = family in ("recall_at_precision", "precision_at_recall")
    if pr_pair:
        first, second = _safe(tp, tp + fp), _safe(tp, tp + fn)  # precision, recall
    else:
        first, second = _safe(tp, tp + fn), 1 - _safe(fp, fp + tn)  # sensitivity, specificity
    objective, constraint = {
        "recall_at_precision": (second, first), "precision_at_recall": (first, second),
        "sensitivity_at_specificity": (first, second), "specificity_at_sensitivity": (second, first),
    }[family]
    neg = torch.tensor(float("-inf"), dtype=torch.float64, device=cm.device)
    ok = constraint >= floor
    masked = torch.where(ok, objective, neg)
    best = masked.amax(0)
    sel = ok & (masked == best)
    if pr_pair:
        tie = torch.where(sel, constraint, neg)
        sel = sel & (tie == tie.amax(0))
    thr = grid.to(torch.float64).reshape((-1,) + (1,) * (cm.ndim - 3))
    chosen = torch.where(sel, thr, neg).amax(0)
    value = torch.where(ok.any(0), best, torch.zeros_like(best))
    none = (value == 0) if pr_pair else ~ok.any(0)
    return value, torch.where(none, torch.full_like(chosen, SENTINEL), chosen)


def _check_operating_point(name: str, got, counts, grid, floor: float, family: str) -> dict:
    """The metric's (values, thresholds) against the float64 reduction of
    the plain counts: thresholds equal, values within rtol 1e-5."""
    import torch

    value, chosen = _operating_point(counts, grid, floor, family)
    _check(torch.equal(got[1], chosen.to(torch.float32)), f"{name}: thresholds {got[1].tolist()} != {chosen.tolist()}")
    _close(name, got[0], value)
    return {"sentinels": int((chosen == SENTINEL).sum()), "mean_value": float(value.mean())}


def _hinge64(probs, target, multiclass: bool):
    """float64 sum of hinge losses of float32 probabilities (crammer-singer
    for multiclass)."""
    import torch

    p = probs.to(torch.float64)
    if multiclass:
        true = p.gather(1, target[:, None])[:, 0]
        other = p.scatter(1, target[:, None], float("-inf")).amax(1)
        margin = 1 - (true - other)
    else:
        margin = 1 - (2 * target.to(torch.float64) - 1) * p
    return margin.clamp(min=0).sum()


def _ranking64(scores, target):
    """float64 sums over a batch of coverage error, label ranking average
    precision and label ranking loss, from the definitions."""
    import torch

    p, rel = scores.to(torch.float64), target == 1
    n_rel, n_irr = rel.sum(1), (~rel).sum(1)
    lowest = torch.where(rel, p, torch.full_like(p, float("inf"))).amin(1, keepdim=True)
    coverage = torch.where(n_rel > 0, (p >= lowest).sum(1).to(torch.float64), torch.zeros_like(p[:, 0]))
    at_least = p[:, None, :] >= p[:, :, None]  # [b, l, m]: label m scored at least as high as label l
    share = (at_least & rel[:, None, :]).sum(2) / at_least.sum(2)
    lrap = torch.where(n_rel > 0, torch.where(rel, share, torch.zeros_like(share)).sum(1) / n_rel.clamp(min=1), 1.0)
    wrong = (at_least & rel[:, :, None] & ~rel[:, None, :]).sum((1, 2))
    pairs = n_rel * n_irr
    loss = torch.where(pairs > 0, wrong / pairs.clamp(min=1), 0.0)
    return torch.stack([coverage.sum(), lrap.sum(), loss.sum()])


def _check_rest_launches(name: str, run: dict, spec: dict) -> dict:
    """The launches the compute groups imply: every counting member on the
    first update, one counting group leader an update after it; no other
    kernel."""
    expected = {k: 0 for k in run["launches"]}
    for kernel, (members, groups) in spec["counting"].items():
        expected[kernel] = members + (spec["updates"] - 1) * groups
    _check(run["launches"] == expected, f"{name}: launches {run['launches']}, expected {expected}")
    return expected


def _drive_rest(name: str, dev):
    """The workload's spec and :func:`_drive` run, with the device memory
    allocated before it as the run's base (no garbage collection first: a
    dropped metric frees its state at once)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    spec = WORKLOADS[name](dev)
    run = _drive(name, spec, dev)
    run["base_mem_bytes"] = base
    return spec, run


def _finish_rest(name: str, dev, run: dict, expected: dict, extra: dict) -> dict:
    """Emit a phase's line: the drive's updates/s, its peak memory above
    the base, the launches, and the device idle share of a short profiled
    window (which prints its own ``profile_<name>`` line)."""
    profile = phase_profile(name, dev, steps=5)
    out = run["out"]
    out.update({
        "bincount_launches": run["launches"]["bincount"], "binned_curve_launches": run["launches"]["binned_curve"],
        "expected_launches": expected, "device_idle_share": profile["device_idle_share"],
        "base_mem_bytes": run["base_mem_bytes"], "peak_mem_above_base_bytes": out["peak_mem_bytes"] - run["base_mem_bytes"],
        "state_exact": True, **extra,
    })
    _emit(out)
    return out


def phase_imagenet_rest(dev) -> dict:
    """Dice (macro), exact match, hinge loss (crammer-singer) and the
    per-class recall at precision 0.5 and specificity at sensitivity 0.5 (100
    thresholds) over the ImageNet batches: Dice's tp/fp/fn, exact match's
    count and the (100, 1000, 2, 2) curve state against plain counts, every
    value against float64, two ``bincount`` launches an update."""
    import torch

    name = "imagenet_rest"
    spec, run = _drive_rest(name, dev)
    coll, result = run["coll"], run["result"]
    c = IMAGENET["num_classes"]
    grid = _threshold_grid(IMAGENET_REST["thresholds"], dev)
    curve = hits = predicted = actual = None
    hinge, correct = torch.zeros((), dtype=torch.float64, device=dev), 0
    for logits, target in spec["batches"]():
        pred, probs = logits.argmax(1), torch.softmax(logits, dim=-1)
        counts = _onevsrest_counts(probs, target, grid)
        batch = [counts] + [torch.bincount(x, minlength=c) for x in (target[pred == target], pred, target)]
        if curve is None:
            curve, hits, predicted, actual = batch
        else:
            curve, hits, predicted, actual = (a + b for a, b in zip((curve, hits, predicted, actual), batch))
        hinge = hinge + _hinge64(probs, target, multiclass=True)
        correct += int((pred == target).sum())
    tp, fp, fn = hits, predicted - hits, actual - hits
    dice = coll["dice"]
    _check(
        all(torch.equal(s.to(torch.int64), w) for s, w in ((dice.tp, tp), (dice.fp, fp), (dice.fn, fn))),
        f"{name}: Dice's tp/fp/fn differ from the plain count",
    )
    em = coll["exact_match"]
    _check(int(em.correct) == correct and int(em.total) == spec["samples"], f"{name}: exact match counts differ")
    for member in ("recall_at_precision", "specificity_at_sensitivity"):
        _check(torch.equal(coll[member].confmat.to(torch.int64), curve), f"{name}: {member} state differs from the plain counts")
    expected = _check_rest_launches(name, run, spec)
    tp64, fp64, fn64 = (x.to(torch.float64) for x in (tp, fp, fn))
    present = (tp64 + fp64 + fn64) > 0
    _close("dice", result["dice"], _safe(2 * tp64, 2 * tp64 + fp64 + fn64)[present].mean())
    _close("exact_match", result["exact_match"], torch.tensor(correct / spec["samples"], dtype=torch.float64, device=dev))
    _close("hinge", result["hinge"], hinge / spec["samples"])
    points = {
        member: _check_operating_point(member, result[member], curve, grid, 0.5, member)
        for member in ("recall_at_precision", "specificity_at_sensitivity")
    }
    return _finish_rest(name, dev, run, expected, {
        "num_classes": c, "thresholds": IMAGENET_REST["thresholds"],
        "values": {k: float(result[k]) for k in ("dice", "exact_match", "hinge")}, "operating_points": points,
    })


def phase_coco_multilabel(dev) -> dict:
    """Exact match, coverage error, label ranking average precision and
    loss, and the per-label precision at recall 0.5 (100 thresholds) over
    the COCO batches: the (100, 80, 2, 2) state and exact match's count
    against plain counts, every value against float64, one ``bincount``
    launch an update."""
    import torch

    name = "coco_multilabel"
    spec, run = _drive_rest(name, dev)
    coll, result = run["coll"], run["result"]
    grid = _threshold_grid(COCO["thresholds"], dev)
    curve, correct = None, 0
    ranking = torch.zeros(3, dtype=torch.float64, device=dev)
    for scores, target in spec["batches"]():
        counts = _label_counts(scores, target == 1, grid)
        curve = counts if curve is None else curve + counts
        correct += int(((scores > 0.5).to(torch.int64) == target).all(1).sum())
        ranking = ranking + _ranking64(scores, target)
    _check(
        torch.equal(coll["precision_at_recall"].confmat.to(torch.int64), curve),
        f"{name}: the curve state differs from the plain counts",
    )
    em = coll["exact_match"]
    _check(int(em.correct) == correct and int(em.total) == spec["samples"], f"{name}: exact match counts differ")
    expected = _check_rest_launches(name, run, spec)
    _close("exact_match", result["exact_match"], torch.tensor(correct / spec["samples"], dtype=torch.float64, device=dev))
    for i, member in enumerate(("coverage_error", "ranking_ap", "ranking_loss")):
        _close(member, result[member], ranking[i] / spec["samples"])
    point = _check_operating_point("precision_at_recall", result["precision_at_recall"], curve, grid, 0.5, "precision_at_recall")
    return _finish_rest(name, dev, run, expected, {
        "labels": COCO["labels"], "thresholds": COCO["thresholds"],
        "values": {k: float(result[k]) for k in ("exact_match", "coverage_error", "ranking_ap", "ranking_loss")},
        "operating_points": {"precision_at_recall": point},
    })


def phase_civilcomments_fairness(dev) -> dict:
    """Group fairness (demographic parity, equal opportunity, per-group
    rates), hinge loss and the binary recall at precision 0.8 and
    sensitivity at specificity 0.9 (100 thresholds) over the CivilComments
    batches: the per-group counts and the (100, 2, 2) curve state against
    plain counts, every value and the parity keys against float64, one
    ``bincount`` and one ``binned_curve`` launch an update."""
    import torch

    name = "civilcomments_fairness"
    spec, run = _drive_rest(name, dev)
    coll, result = run["coll"], run["result"]
    n_groups = CIVILCOMMENTS["groups"]
    grid = _threshold_grid(CIVILCOMMENTS["thresholds"], dev)
    stats = torch.zeros((4, n_groups), dtype=torch.int64, device=dev)  # tp, fp, tn, fn
    curve, hinge = None, torch.zeros((), dtype=torch.float64, device=dev)
    for scores, target, groups in spec["batches"]():
        p, t = scores > 0.5, target == 1
        for g in range(n_groups):
            mine = groups == g
            stats[:, g] += torch.stack([(mine & p & t).sum(), (mine & p & ~t).sum(), (mine & ~p & ~t).sum(), (mine & ~p & t).sum()])
        counts = _label_counts(scores[:, None], t[:, None], grid)[:, 0]
        curve = counts if curve is None else curve + counts
        hinge = hinge + _hinge64(scores, target, multiclass=False)
    for member in ("fairness", "group_rates"):
        m = coll[member]
        _check(
            torch.equal(torch.stack([m.tp, m.fp, m.tn, m.fn]).to(torch.int64), stats),
            f"{name}: {member}'s per-group counts differ from the plain count",
        )
    for member in ("recall_at_precision", "sensitivity_at_specificity"):
        _check(torch.equal(coll[member].confmat.to(torch.int64), curve), f"{name}: {member} state differs from the plain counts")
    expected = _check_rest_launches(name, run, spec)
    s64 = stats.to(torch.float64)
    rates = _safe(s64, s64.sum(0, keepdim=True).expand(4, -1))
    for g in range(n_groups):
        _close(f"group_{g}", result[f"group_{g}"], rates[:, g])
    tp, fp, tn, fn = s64
    parity = {}
    for key, r in (("DP", _safe(tp + fp, tp + fp + tn + fn)), ("EO", _safe(tp, tp + fn))):
        lo, hi = int(torch.argmin(r)), int(torch.argmax(r))
        want = f"{key}_{lo}_{hi}"
        _check(want in result, f"{name}: no key {want} in {sorted(result)}")
        _close(want, result[want], r[lo] / r[hi])
        parity[want] = float(result[want])
    _close("hinge", result["hinge"], hinge / spec["samples"])
    points = {
        member: _check_operating_point(member, result[member], curve, grid, floor, member)
        for member, floor in (("recall_at_precision", 0.8), ("sensitivity_at_specificity", 0.9))
    }
    return _finish_rest(name, dev, run, expected, {
        "groups": n_groups, "thresholds": CIVILCOMMENTS["thresholds"],
        "values": {**parity, "hinge": float(result["hinge"])}, "operating_points": points,
    })


WORKLOADS.update({
    "imagenet_rest": _imagenet_rest,
    "coco_multilabel": _coco_multilabel,
    "civilcomments_fairness": _civilcomments,
})


# ------------------------------------------------------------------ the rest of image

#: DIV2K validation scored as x4 super-resolution papers and NTIRE report it:
#: 100 high-resolution images, one landscape shape (DIV2K's heights vary),
#: float32 in [0, 1], batch 4; the list-state members (UQI, SAM, ERGAS,
#: RASE) keep every image, as the JAX package's do, so they run over the
#: first 20 images (5 updates) and the streaming members over all 100
DIV2K = {"images": 100, "batch": 4, "channels": 3, "height": 1356, "width": 2040, "list_images": 20}
#: WorldView-3 as PanCollection's test sets give it (8 bands): 20 reduced-
#: resolution samples of 8 x 256 x 256 (fused against ground truth) and 20
#: full-resolution ones (MS 8 x 128 x 128, PAN 512 x 512 repeated over the
#: bands, fused 8 x 512 x 512), batch 4
WV3 = {"samples": 20, "batch": 4, "bands": 8, "reduced": 256, "ms": 128, "pan": 512, "ratio": 4}
#: PPL on a seeded generator (512-d latents, six transposed convolutions up
#: to 3 x 256 x 256 in [0, 255]): 1,024 samples (StyleGAN measures 100,000),
#: batch 64, LPIPS-VGG on seeded parameters at 64 x 64, lerp and slerp_unit
PPL = {"samples": 1024, "batch": 64, "latent": 512, "resize": 64}
#: card against the same port functionals on CPU copies of the first batch:
#: the windowed-variance metrics and LPIPS (float32 convolutions in another
#: algorithm) within rtol 1e-3; PSNR, PSNR-B, TV, SAM and ERGAS within 1e-5
REST_IMAGE_RTOL = {"windowed": 1e-3, "plain": 1e-5}
#: PPL's mean and std on the card against the CPU run of the same latents:
#: each distance is divided by epsilon² = 1e-8, so a float32 rounding r of
#: the backbone's features becomes about r / 1e-4 of their difference
PPL_RTOL = 1e-2


def _div2k_batch(i: int, dev):
    """Batch ``i``: targets of random sinusoids from coarse to fine
    (0.002 to 0.2 cycles a pixel) with grain, and preds that blur them (a
    7-tap gaussian, sigma 1.2) and add N(0, 0.01) noise, both in [0, 1]."""
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.functional.image.utils import _gaussian
    from torchmetrics_tpu_torch.utils.compute import full_float32

    b, c, h, w = DIV2K["batch"], DIV2K["channels"], DIV2K["height"], DIV2K["width"]
    g = torch.Generator(device=dev).manual_seed(SEED + 7919 * i)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    target = torch.full((b, c, h, w), 0.5, device=dev)
    for _ in range(12):
        freq = 10 ** (torch.rand((b, 1, 1, 1), generator=g, device=dev) * 2 - 2.7)
        angle = torch.rand((b, 1, 1, 1), generator=g, device=dev) * 6.2832
        amp = 0.02 + 0.06 * torch.rand((b, c, 1, 1), generator=g, device=dev)
        phase = torch.rand((b, c, 1, 1), generator=g, device=dev) * 6.2832
        target = target + amp * torch.sin(6.2832 * freq * (yy * torch.cos(angle) + xx * torch.sin(angle)) + phase)
    target = (target + 0.03 * torch.randn((b, c, h, w), generator=g, device=dev)).clamp(0, 1)
    taps = _gaussian(7, 1.2, device=dev)
    with full_float32():
        blur = F.conv2d(F.pad(target, (3, 3, 3, 3), mode="replicate"), torch.outer(taps, taps).expand(c, 1, 7, 7), groups=c)
    preds = (blur + 0.01 * torch.randn((b, c, h, w), generator=g, device=dev)).clamp(0, 1)
    return preds, target


def _luma(x):
    """BT.601 luma of RGB ``(B, 3, H, W)``: PSNR-B's grayscale input."""
    return (0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]).contiguous()


def _lpips_state(net_type: str, seed: int) -> dict:
    """Seeded LPIPS parameters: PyTorch's initialisation of the backbone
    under ``seed`` and non-negative lin heads, uniform in [0, 1) as the JAX
    package's ``init_lpips_params`` draws them."""
    import torch

    from torchmetrics_tpu_torch.models.lpips import LPIPSNetwork

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = LPIPSNetwork(net_type)
        for lin in net.lins:
            lin.model[1].weight.copy_(torch.rand(lin.model[1].weight.shape))
    return net.state_dict()


def _generic_check(name: str, launched: int, expected: int) -> None:
    """The generic entry launched ``expected`` times, all on the kernel, and
    the fused entry never."""
    from torchmetrics_tpu_torch.ops import kernels

    gate = kernels.gate_snapshot()
    _check("ssim_fused" not in gate, f"{name}: the fused SSIM entry was dispatched ({gate.get('ssim_fused')})")
    selections = gate.get("ssim_windows", {}).get("selections", {})
    _check(selections == {"cuda": selections.get("cuda", 0)}, f"{name}: ssim_windows dispatched off the kernel: {selections}")
    _check(launched == expected, f"{name}: {launched} generic ssim_windows launches, expected {expected}")


def _compare(name: str, checks: dict, got, want, rtol: float) -> None:
    """Hold one card value to its CPU value and record the relative error."""
    import torch

    got, want = got.detach().double().cpu(), want.detach().double()
    err = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    _check(bool(torch.isfinite(got).all()), f"{name}: not finite on the card ({got})")
    _check(torch.allclose(got, want, rtol=rtol, atol=0), f"{name}: card {got.tolist()} against CPU {want.tolist()} (rtol {rtol})")
    checks[name] = {"card": got.tolist(), "cpu": want.tolist(), "rel_err": err, "rtol": rtol}


def _rest_idle_share(step, steps: int) -> dict:
    """The device's idle share over ``steps`` profiled calls of ``step``."""
    rows, wall_us = _profiled(step, steps)
    busy_us = sum(r[1] for r in rows)
    return {
        "wall_ms_per_update": wall_us / steps / 1e3, "device_ms_per_update": busy_us / steps / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "top_device_kernels": [
            {"name": k[:100], "ms_per_update": us / steps / 1e3, "calls_per_update": n / steps} for k, us, n in rows[:8]
        ],
    }


def phase_div2k(dev) -> dict:
    """DIV2K x4 validation through PSNR, PSNR-B (luma), TV (preds), RMSE-SW,
    SCC, VIF, LPIPS-Alex (all 100 images) and UQI, SAM, ERGAS, RASE (the
    first 20): generic ``ssim_windows`` launches against what the code
    implies (VIF 26 a channel, SCC 5 a channel, RMSE-SW 1 an update; UQI 1
    and RASE 2 a compute), never the fused entry; the first batch's values
    against the same functionals on CPU copies; updates/s, the idle share
    of a profiled window and the peak memory."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import functional as tmf
    from torchmetrics_tpu_torch import image as tmi
    from torchmetrics_tpu_torch.models.lpips import lpips_network
    from torchmetrics_tpu_torch.ops import kernels, ssim_kernel

    name = "div2k_x4_val"
    b, c = DIV2K["batch"], DIV2K["channels"]
    updates, list_updates = DIV2K["images"] // b, DIV2K["list_images"] // b
    alex = _lpips_state("alex", SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stream = MetricCollection({
        "psnr": tmi.PeakSignalNoiseRatio(data_range=1.0, device=dev),
        "rmse_sw": tmi.RootMeanSquaredErrorUsingSlidingWindow(window_size=8, device=dev),
        "scc": tmi.SpatialCorrelationCoefficient(device=dev),
        "vif": tmi.VisualInformationFidelity(device=dev),
        "lpips": tmi.LearnedPerceptualImagePatchSimilarity(net_type="alex", params=alex, normalize=True, device=dev),
    }, device=dev)
    lists = MetricCollection({
        "uqi": tmi.UniversalImageQualityIndex(device=dev),
        "sam": tmi.SpectralAngleMapper(device=dev),
        "ergas": tmi.ErrorRelativeGlobalDimensionlessSynthesis(ratio=4, device=dev),
        "rase": tmi.RelativeAverageSpectralError(window_size=8, device=dev),
    }, device=dev)
    psnrb = tmi.PeakSignalNoiseRatioWithBlockedEffect(device=dev)
    tv = tmi.TotalVariation(device=dev)

    def update(i: int, preds, target) -> None:
        stream.update(preds, target)
        psnrb.update(_luma(preds), _luma(target))
        tv.update(preds)
        if i < list_updates:
            lists.update(preds, target)

    kernels.reset_gate_log()
    ssim_kernel.launches = 0
    step_s, first = [], None
    for i in range(updates):
        preds, target = _div2k_batch(i, dev)
        if i == 0:
            first = (preds, target)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(i, preds, target)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    update_launches = ssim_kernel.launches
    t0 = time.perf_counter()
    result = {**stream.compute(), **lists.compute(), "psnrb": psnrb.compute(), "tv": tv.compute()}
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    compute_launches = ssim_kernel.launches - update_launches
    peak = torch.cuda.max_memory_allocated(dev)
    # DIV2K's steady batch of 4: the executor keys it exactly (the first
    # call's padded key is served eagerly), no padded replay adds a row-0 update
    expected = {"update": updates * (26 * c + 5 * c + 1), "compute": 1 + 2}
    _generic_check(name, update_launches + compute_launches, expected["update"] + expected["compute"])
    _check(compute_launches == expected["compute"], f"{name}: {compute_launches} launches in the compute, expected 3")
    for key, value in result.items():
        _check(bool(torch.isfinite(value).all()), f"{name}: {key} = {value} is not finite")

    # the first batch: each member's value on the card against the same
    # port functional on CPU copies (the plain bodies)
    preds, target = first
    cpu_preds, cpu_target = preds.cpu(), target.cpu()
    alex_cpu = lpips_network("alex", alex, device="cpu")
    alex_card = stream["lpips"].net
    checks: dict = {}
    tol = REST_IMAGE_RTOL
    pairs = {
        "psnr": (lambda p, t: tmf.peak_signal_noise_ratio(p, t, data_range=1.0), tol["plain"]),
        "psnrb": (lambda p, t: tmf.peak_signal_noise_ratio_with_blocked_effect(_luma(p), _luma(t)), tol["plain"]),
        "tv": (lambda p, t: tmf.total_variation(p), tol["plain"]),
        "sam": (tmf.spectral_angle_mapper, tol["plain"]),
        "ergas": (lambda p, t: tmf.error_relative_global_dimensionless_synthesis(p, t, ratio=4), tol["plain"]),
        "rmse_sw": (lambda p, t: tmf.root_mean_squared_error_using_sliding_window(p, t, window_size=8), tol["windowed"]),
        "scc": (tmf.spatial_correlation_coefficient, tol["windowed"]),
        "vif": (tmf.visual_information_fidelity, tol["windowed"]),
        "uqi": (tmf.universal_image_quality_index, tol["windowed"]),
        "rase": (lambda p, t: tmf.relative_average_spectral_error(p, t, window_size=8), tol["windowed"]),
    }
    for key, (fn, rtol) in pairs.items():
        _compare(key, checks, fn(preds, target), fn(cpu_preds, cpu_target), rtol)
    with torch.no_grad():
        _compare("lpips", checks, tmf.learned_perceptual_image_patch_similarity(preds, target, net=alex_card, normalize=True),
                 tmf.learned_perceptual_image_patch_similarity(cpu_preds, cpu_target, net=alex_cpu, normalize=True),
                 tol["windowed"])
    del first, preds, target, cpu_preds, cpu_target

    profile_batch = _div2k_batch(updates, dev)
    profile = _rest_idle_share(lambda i: update(updates, *profile_batch), 3)
    update_s = sum(step_s)
    step_ms = sorted(t * 1e3 for t in step_s)
    return _emit({
        "phase": name, "images": DIV2K["images"], "shape": [c, DIV2K["height"], DIV2K["width"]], "batch": b,
        "updates": updates, "list_state_images": DIV2K["list_images"],
        "reduced": ["one landscape shape for all 100 images", "UQI, SAM, ERGAS, RASE over the first 20 images (5 updates)"],
        "ssim_windows_generic_launches": update_launches + compute_launches,
        "expected_launches": {"per_update": 26 * c + 5 * c + 1, **expected}, "fused_launches": 0,
        "updates_per_s": updates / update_s, "images_per_s": DIV2K["images"] / update_s,
        "update_ms": {"min": step_ms[0], "p50": step_ms[updates // 2], "max": step_ms[-1]}, "compute_s": compute_s,
        "base_mem_bytes": base, "peak_mem_bytes": peak, "peak_mem_above_base_bytes": peak - base,
        "device_idle_share": profile["device_idle_share"], "profile": profile,
        "values": {k: float(v) for k, v in result.items()}, "first_batch_checks": checks,
    })


def _wv3_batch(i: int, full: bool, dev):
    """Sample batch ``i``: 8-band ground truth of smooth random fields, the
    fused image (truth plus N(0, 0.01)), and for full resolution the MS
    image (truth 4x4-averaged, plus N(0, 0.005)) and the PAN image (the band
    mean plus fine detail) repeated over the bands."""
    import torch
    import torch.nn.functional as F

    b, bands = WV3["batch"], WV3["bands"]
    side = WV3["pan"] if full else WV3["reduced"]
    g = torch.Generator(device=dev).manual_seed(SEED + 104729 * i + int(full))
    coarse = torch.rand((b, bands, side // 16, side // 16), generator=g, device=dev)
    truth = F.interpolate(coarse, size=(side, side), mode="bicubic", align_corners=False)
    truth = (0.2 + 0.6 * truth + 0.02 * torch.randn((b, bands, side, side), generator=g, device=dev)).clamp(0, 1)
    fused = (truth + 0.01 * torch.randn(truth.shape, generator=g, device=dev)).clamp(0, 1)
    if not full:
        return fused, truth
    ms = F.avg_pool2d(truth, WV3["ratio"])
    ms = (ms + 0.005 * torch.randn(ms.shape, generator=g, device=dev)).clamp(0, 1)
    pan = (truth.mean(1, keepdim=True) + 0.01 * torch.randn((b, 1, side, side), generator=g, device=dev)).clamp(0, 1)
    return fused, ms, pan.expand(b, bands, side, side).contiguous()


class _SeededGenerator:
    """A generator model for PPL: 512-d latents on the unit sphere (as
    StyleGAN normalises z, so that ``slerp_unit`` keeps them there), scaled
    by sqrt(512), a linear layer to 256 x 4 x 4, six 4 x 4 stride-2
    transposed convolutions to 3 x 256 x 256, and ``127.5 (1 + tanh)`` to
    [0, 255]; weights He-scaled from a seed. Runs in full float32 (TF32
    rounding would swamp PPL's epsilon-sized image differences). ``sample``
    draws with the key it is handed and records the latents."""

    def __init__(self, dev, seed: int = SEED):
        import torch

        g = torch.Generator().manual_seed(seed)
        chans = [256, 128, 64, 32, 16, 8, 3]
        self.fc = (torch.randn((256 * 16, PPL["latent"]), generator=g) / PPL["latent"] ** 0.5).to(dev)
        self.convs = [
            (torch.randn((cin, cout, 4, 4), generator=g) * (2.0 / (cin * 4)) ** 0.5).to(dev)
            for cin, cout in zip(chans[:-1], chans[1:])
        ]
        self.drawn = []

    def sample(self, key, num_samples: int):
        import torch

        z = torch.randn((num_samples, PPL["latent"]), generator=key, device=key.device)
        z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
        self.drawn.append(z)
        return z

    def __call__(self, z):
        import torch
        import torch.nn.functional as F

        from torchmetrics_tpu_torch.utils.compute import full_float32

        with torch.no_grad(), full_float32():
            x = F.relu(PPL["latent"] ** 0.5 * z @ self.fc.to(z.device).T).reshape(-1, 256, 4, 4)
            for i, w in enumerate(self.convs):
                x = F.conv_transpose2d(x, w.to(z.device), stride=2, padding=1)
                x = F.relu(x) if i < len(self.convs) - 1 else 127.5 * (1 + torch.tanh(x))
        return x


class _Replay:
    """The same model on the CPU, whose ``sample`` returns the latents the
    card's run drew, in order."""

    def __init__(self, model: _SeededGenerator):
        self.model, self.calls = model, 0

    def sample(self, key, num_samples: int):
        z = self.model.drawn[self.calls].cpu()
        self.calls += 1
        return z

    def __call__(self, z):
        return self.model(z)


def phase_ppl(dev, vgg: dict) -> dict:
    """Perceptual path length of the seeded generator, lerp and slerp_unit,
    on the card and, from the same latents, on the CPU."""
    import torch

    from torchmetrics_tpu_torch import image as tmi

    model = _SeededGenerator(dev)
    out = {}
    for method in ("lerp", "slerp_unit"):
        model.drawn = []
        ppl = tmi.PerceptualPathLength(
            num_samples=PPL["samples"], batch_size=PPL["batch"], interpolation_method=method, resize=PPL["resize"],
            sim_net="vgg", sim_params=vgg, key=torch.Generator(device=dev).manual_seed(SEED), device=dev,
        )
        ppl.update(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, std, kept = ppl.compute()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        cpu = tmi.PerceptualPathLength(
            num_samples=PPL["samples"], batch_size=PPL["batch"], interpolation_method=method, resize=PPL["resize"],
            sim_net="vgg", sim_params=vgg, device="cpu",
        )
        cpu.update(_Replay(model))
        cpu_mean, cpu_std, cpu_kept = cpu.compute()
        checks: dict = {}
        _compare(f"{method}_mean", checks, mean, cpu_mean, PPL_RTOL)
        _compare(f"{method}_std", checks, std, cpu_std, PPL_RTOL)
        _check(kept.shape == cpu_kept.shape, f"ppl {method}: kept {tuple(kept.shape)} on the card, {tuple(cpu_kept.shape)} on the CPU")
        out[method] = {"mean": float(mean), "std": float(std), "kept": kept.numel(), "compute_s": seconds,
                       "samples_per_s": PPL["samples"] / seconds, "checks": checks}
    return out


def phase_wv3(dev) -> dict:
    """WorldView-3 pan-sharpening: reduced resolution through SAM, ERGAS,
    UQI and D_lambda (one compute group of list states), full resolution
    through D_lambda, D_s and QNR; generic ``ssim_windows`` launches at the
    computes against the code's (UQI 1, D_lambda 2, D_s 1 + 2 x 8, QNR 19),
    never the fused entry; the first batch's values against CPU copies; then
    PPL."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import functional as tmf
    from torchmetrics_tpu_torch import image as tmi
    from torchmetrics_tpu_torch.ops import kernels, ssim_kernel

    name = "wv3_pansharpening"
    bands, updates = WV3["bands"], WV3["samples"] // WV3["batch"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reduced = MetricCollection({
        "sam": tmi.SpectralAngleMapper(device=dev),
        "ergas": tmi.ErrorRelativeGlobalDimensionlessSynthesis(ratio=WV3["ratio"], device=dev),
        "uqi": tmi.UniversalImageQualityIndex(device=dev),
        "d_lambda": tmi.SpectralDistortionIndex(device=dev),
    }, device=dev)
    d_lambda = tmi.SpectralDistortionIndex(device=dev)
    full = MetricCollection({
        "d_s": tmi.SpatialDistortionIndex(window_size=7, device=dev),
        "qnr": tmi.QualityWithNoReference(window_size=7, device=dev),
    }, device=dev)

    def update(i: int) -> None:
        reduced.update(*_wv3_batch(i, False, dev))
        fused, ms, pan = _wv3_batch(i, True, dev)
        d_lambda.update(fused, ms)
        full.update(fused, {"ms": ms, "pan": pan})

    kernels.reset_gate_log()
    ssim_kernel.launches = 0
    step_s = []
    for i in range(updates):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    update_launches = ssim_kernel.launches
    t0 = time.perf_counter()
    result = {**{f"rr_{k}": v for k, v in reduced.compute().items()}, "fr_d_lambda": d_lambda.compute(),
              **{f"fr_{k}": v for k, v in full.compute().items()}}
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    launches = ssim_kernel.launches
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {"update": 0, "compute": (1 + 2) + 2 + (1 + 2 * bands) + (2 + 1 + 2 * bands)}
    _check(update_launches == 0, f"{name}: {update_launches} launches in the updates (list states launch at compute)")
    _generic_check(name, launches, expected["compute"])
    for key, value in result.items():
        _check(bool(torch.isfinite(value).all()), f"{name}: {key} = {value} is not finite")

    checks: dict = {}
    tol = REST_IMAGE_RTOL
    fused_rr, truth = _wv3_batch(0, False, dev)
    for key, fn, rtol in (
        ("rr_sam", tmf.spectral_angle_mapper, tol["plain"]),
        ("rr_ergas", lambda p, t: tmf.error_relative_global_dimensionless_synthesis(p, t, ratio=4), tol["plain"]),
        ("rr_uqi", tmf.universal_image_quality_index, tol["windowed"]),
        ("rr_d_lambda", tmf.spectral_distortion_index, tol["windowed"]),
    ):
        _compare(key, checks, fn(fused_rr, truth), fn(fused_rr.cpu(), truth.cpu()), rtol)
    fused, ms, pan = _wv3_batch(0, True, dev)
    _compare(
        "fr_d_lambda", checks, tmf.spectral_distortion_index(fused, ms), tmf.spectral_distortion_index(fused.cpu(), ms.cpu()),
        tol["windowed"],
    )
    for key, fn in (("fr_d_s", tmf.spatial_distortion_index), ("fr_qnr", tmf.quality_with_no_reference)):
        _compare(key, checks, fn(fused, ms, pan, window_size=7), fn(fused.cpu(), ms.cpu(), pan.cpu(), window_size=7), tol["windowed"])
    del fused_rr, truth, fused, ms, pan

    vgg = _lpips_state("vgg", SEED + 1)
    ppl = phase_ppl(dev, vgg)
    profile = _rest_idle_share(lambda i: (update(i), full.compute(), d_lambda.compute(), reduced.compute()), 2)
    update_s = sum(step_s)
    return _emit({
        "phase": name, "samples": WV3["samples"], "batch": WV3["batch"], "bands": bands, "updates": updates,
        "reduced": ["20 samples of each resolution", "PPL over 1,024 samples (StyleGAN: 100,000)"],
        "ssim_windows_generic_launches": launches, "expected_launches": expected, "fused_launches": 0,
        "updates_per_s": updates / update_s, "compute_s": compute_s,
        "base_mem_bytes": base, "peak_mem_bytes": peak, "peak_mem_above_base_bytes": peak - base,
        "device_idle_share": profile["device_idle_share"], "profile": profile,
        "values": {k: float(v) for k, v in result.items()}, "first_batch_checks": checks, "ppl": ppl,
    })


# ------------------------------------------------ regression and pairwise

#: NYU Depth V2, Eigen test split, as monocular depth papers score it: 654
#: images of 480 x 640, batch 8 (81 updates and one of 6); depth in
#: [0.7, 10] m. Spearman keeps every pixel in its list state, so it takes
#: the first 20 images (6.1M pixels, under 2**23)
NYU = {"images": 654, "batch": 8, "height": 480, "width": 640, "depth": (0.7, 10.0), "spearman_images": 20,
       "noise": 0.1, "scale": 1.03, "bias": 0.05}
#: WeatherBench 2's deterministic headline scores on the 1.5 degree grid
#: (121 x 240): eight variables, 732 initialisations (2020, 00 and 12 UTC)
#: at one lead time, 4 an update; climatological mean and spread in each
#: variable's raw units (m²/s², K, kg/kg, m/s, Pa; TP24h in mm), the
#: forecast error a fraction of the spread, CSI on TP24h at 1 mm
WEATHERBENCH = {
    "inits": 732, "batch": 4, "lat": 121, "lon": 240, "tp_threshold": 1.0, "error": 0.15, "bias": 0.02,
    "variables": ("z500", "t850", "q700", "u850", "v850", "t2m", "msl", "tp24h"),
    "climate": ((54_000.0, 3_000.0), (275.0, 15.0), (0.003, 0.002), (2.0, 8.0), (0.0, 6.0), (280.0, 20.0),
                (101_100.0, 1_200.0)),
}
#: NAS-Bench-201's 15,625 cells: a predictor's scores against the true
#: CIFAR-10 test accuracy, which the table rounds to 0.01 (so ties occur),
#: batches of 1,000
NASBENCH = {"cells": 15_625, "batch": 1_000, "best": 94.37, "degenerate": 0.03, "predictor_noise": 1.5}
#: DeepFashion In-shop Clothes Retrieval: 14,218 queries against a
#: 12,612-image gallery of 3,997 items, 512-d L2-normalised embeddings;
#: Manhattan and Minkowski are held to float64 on every 8th query row
INSHOP = {"queries": 14_218, "gallery": 12_612, "items": 3_997, "dim": 512, "spread": 0.6, "check_every": 8}
#: pairwise values against float64: max |d| over max |float64 value|
#: (cosine: values in [-1, 1], so an absolute error); the row means of
#: the "mean" reduction, absolutely
PAIRWISE_RTOL = 1e-5
PAIRWISE_MEAN_ATOL = 1e-5
#: Kendall's tau from exact counts in float64 (then float32), Spearman's
#: and Pearson's float32 moments, against scipy
NAS_ATOL = {"kendall": 1e-6, "spearman": 1e-5, "pearson": 1e-5, "p_value": 1e-6}
#: Spearman over NYU's first 20 images (float32 ranks, exact there) against scipy
NYU_SPEARMAN_ATOL = 1e-5


def _f32_rtol(updates: int, batch: int) -> float:
    """The bound of a float32 sum accumulated as the states are: a tree sum
    over an update's ``batch`` elements, then a running sum over
    ``updates`` (relative to the sum of magnitudes, in units of 2**-24),
    times 4 for the elementwise roundings and a margin."""
    return 4 * (updates + math.ceil(math.log2(batch))) * 2.0**-24


def _no_launches(name: str, launches: dict) -> dict:
    """Every kernel's count over the phase: all must be 0."""
    _check(not any(launches.values()), f"{name}: a kernel of the port launched: {launches}")
    return launches


def _hold(name: str, checks: dict, got, want, tol: float, relative: bool = True) -> None:
    """Hold a card value to its float64 value: ``|got - want| <= tol``
    (times ``|want|`` when ``relative``), elementwise."""
    import torch

    got = torch.as_tensor(got).detach().double().cpu().reshape(-1)
    want = torch.as_tensor(want, dtype=torch.float64).detach().cpu().reshape(-1)
    tol = torch.as_tensor(tol, dtype=torch.float64).cpu().reshape(-1)
    bound = tol * want.abs() if relative else tol.expand_as(want)
    err = (got - want).abs()
    _check(bool(torch.isfinite(got).all()), f"{name}: not finite on the card ({got.tolist()})")
    _check(bool((err <= bound).all()), f"{name}: card {got.tolist()} against float64 {want.tolist()} (|d| {err.tolist()} > {bound.tolist()})")
    checks[name] = {"card": got.tolist(), "float64": want.tolist(), "abs_err": err.tolist(), "bound": bound.tolist()}


def _nyu_batch(i: int, dev):
    """Images ``8i`` to ``8i + 7`` (fewer at the end), flattened: the
    target a smooth depth field over [0.7, 10] m (two low-frequency waves
    of random frequency and phase and a vertical ramp), the prediction the
    target with 10% multiplicative noise, a 3% scale error and a 5 cm bias."""
    import torch

    b = min(NYU["batch"], NYU["images"] - i * NYU["batch"])
    h, w = NYU["height"], NYU["width"]
    lo, hi = NYU["depth"]
    g = torch.Generator(device=dev).manual_seed(SEED + 2000 + i)
    yy = torch.linspace(0, 1, h, device=dev)[:, None]
    xx = torch.linspace(0, 1, w, device=dev)[None, :]
    freq = 0.5 + 2.5 * torch.rand(b, 2, 1, 1, generator=g, device=dev)
    phase = torch.rand(b, 2, 1, 1, generator=g, device=dev)
    field = (0.4 * torch.sin(2 * math.pi * (freq[:, 0] * xx + phase[:, 0]))
             + 0.4 * torch.cos(2 * math.pi * (freq[:, 1] * yy + phase[:, 1])) + 0.2 * (2 * yy - 1))
    target = lo + (hi - lo) * (field + 1) / 2
    noise = torch.randn(target.shape, generator=g, device=dev)
    preds = (target * (1 + NYU["noise"] * noise) * NYU["scale"] + NYU["bias"]).clamp_min(1e-3)
    return preds.reshape(-1), target.reshape(-1)


def _nyu_float64(dev) -> dict:
    """Every NYU value from float64 sums of the same batches on the card."""
    import torch

    updates = -(-NYU["images"] // NYU["batch"])
    keys = ("n", "abs", "sq", "sqlog", "ape", "sape", "tabs", "cube", "logcosh", "logcosh_terms", "tweedie",
            "tweedie_terms", "st", "stt", "sp", "spp", "spt", "sd", "sdd")
    s = {k: torch.zeros((), dtype=torch.float64, device=dev) for k in keys}
    for i in range(updates):
        p, t = (x.double() for x in _nyu_batch(i, dev))
        d = p - t
        s["n"] += t.numel()
        s["abs"] += d.abs().sum()
        s["sq"] += (d * d).sum()
        s["sqlog"] += ((torch.log1p(p) - torch.log1p(t)) ** 2).sum()
        s["ape"] += (d.abs() / t.abs().clamp_min(1.17e-6)).sum()
        s["sape"] += (d.abs() / (t.abs() + p.abs()).clamp_min(1.17e-6)).sum()
        s["tabs"] += t.abs().sum()
        s["cube"] += (d.abs() ** 3).sum()
        s["logcosh"] += torch.log(torch.cosh(d)).sum()
        # the port's terms: d + softplus(-2d) - log 2
        s["logcosh_terms"] += (d.abs() + torch.nn.functional.softplus(-2 * d) + math.log(2.0)).sum()
        # Tweedie deviance at power 1.5, and the magnitude of its three terms
        terms = (t.clamp_min(0) ** 0.5 / -0.25, -t * p ** -0.5 / -0.5, p ** 0.5 / 0.5)
        s["tweedie"] += (2 * sum(terms)).sum()
        s["tweedie_terms"] += (2 * sum(x.abs() for x in terms)).sum()
        s["st"] += t.sum(); s["stt"] += (t * t).sum()
        s["sp"] += p.sum(); s["spp"] += (p * p).sum(); s["spt"] += (p * t).sum()
        s["sd"] += (t - p).sum(); s["sdd"] += ((t - p) ** 2).sum()
    s = {k: float(v) for k, v in s.items()}
    n = s["n"]
    tss, pss = s["stt"] - s["st"] ** 2 / n, s["spp"] - s["sp"] ** 2 / n
    cov = s["spt"] - s["sp"] * s["st"] / n
    err_var = s["sdd"] / n - (s["sd"] / n) ** 2
    tgt_var = s["stt"] / n - (s["st"] / n) ** 2
    pearson = cov / math.sqrt(tss * pss)
    vx, vy = pss / (n - 1), tss / (n - 1)
    values = {
        "mae": s["abs"] / n, "mse": s["sq"] / n, "rmse": math.sqrt(s["sq"] / n), "msle": s["sqlog"] / n,
        "abs_rel": s["ape"] / n, "smape": 2 * s["sape"] / n, "wmape": s["abs"] / s["tabs"], "rse": s["sq"] / tss,
        "log_cosh": s["logcosh"] / n, "minkowski": s["cube"] ** (1 / 3), "tweedie": s["tweedie"] / n,
        "r2": 1 - s["sq"] / tss, "explained_variance": 1 - err_var / tgt_var, "pearson": pearson,
        "concordance": 2 * pearson * math.sqrt(vx) * math.sqrt(vy) / (vx + vy + (s["sp"] / n - s["st"] / n) ** 2),
    }
    # cancellation factors: the sum of squares over the centred sum it feeds
    cancel = {"target": s["stt"] / tss, "error": (s["sdd"] / n) / err_var,
              "log_cosh": s["logcosh_terms"] / s["logcosh"], "tweedie": s["tweedie_terms"] / s["tweedie"],
              "moments": 1 + abs(s["sp"]) / math.sqrt(n * pss) + abs(s["st"]) / math.sqrt(n * tss)}
    return {"values": values, "cancel": cancel, "pixels": int(n)}


def phase_nyu_depth(dev) -> dict:
    """NYU Depth V2 (Eigen test split) through MAE, MSE, RMSE, MSLE, MAPE
    (AbsRel), SMAPE, WMAPE, RSE, LogCosh, Minkowski (p = 3), Tweedie (power
    1.5), R2, explained variance, Pearson and concordance in one
    collection, and Spearman over the first 20 images: every value against
    float64 of the same pixels on the card (Spearman against scipy), the
    compute groups (MSE with RMSE, Pearson with concordance, as the JAX
    package forms them), no kernel launch, updates/s, compute ms and peak
    memory."""
    import numpy as np
    import torch
    from scipy.stats import spearmanr

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import regression as reg

    name = "nyu_depth_v2"
    b, hw = NYU["batch"], NYU["height"] * NYU["width"]
    updates = -(-NYU["images"] // b)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    coll = MetricCollection({
        "mae": reg.MeanAbsoluteError(), "mse": reg.MeanSquaredError(), "rmse": reg.MeanSquaredError(squared=False),
        "msle": reg.MeanSquaredLogError(), "abs_rel": reg.MeanAbsolutePercentageError(),
        "smape": reg.SymmetricMeanAbsolutePercentageError(), "wmape": reg.WeightedMeanAbsolutePercentageError(),
        "rse": reg.RelativeSquaredError(), "log_cosh": reg.LogCoshError(), "minkowski": reg.MinkowskiDistance(p=3),
        "tweedie": reg.TweedieDevianceScore(power=1.5), "r2": reg.R2Score(), "explained_variance": reg.ExplainedVariance(),
        "pearson": reg.PearsonCorrCoef(), "concordance": reg.ConcordanceCorrCoef(),
    })
    spearman = reg.SpearmanCorrCoef()
    spearman_pixels = NYU["spearman_images"] * hw
    seen = [0]

    def update(coll, batch) -> None:
        preds, target = batch
        coll.update(preds, target)
        head = spearman_pixels - seen[0]
        seen[0] += preds.numel()
        if head > 0:
            spearman.update(preds[:head], target[:head])

    run = _drive(name, {
        "collection": lambda: coll, "batches": lambda: (_nyu_batch(i, dev) for i in range(updates)),
        "samples": NYU["images"] * hw, "update": update,
    }, dev)
    t0 = time.perf_counter()
    result = {**run["result"], "spearman": spearman.compute()}
    torch.cuda.synchronize()
    spearman_ms = (time.perf_counter() - t0) * 1e3
    launches = _no_launches(name, run["launches"])
    groups = sorted(sorted(g) for g in coll.compute_groups.values())
    _check(["concordance", "pearson"] in groups and ["mse", "rmse"] in groups and len(groups) == 13,
           f"{name}: compute groups {groups}, expected MSE with RMSE, Pearson with concordance, the rest alone")

    ref = _nyu_float64(dev)
    base_tol = _f32_rtol(updates, b * hw)
    checks: dict = {}
    k_target, k_error = ref["cancel"]["target"], ref["cancel"]["error"]
    want = ref["values"]
    for key in ("mae", "mse", "rmse", "msle", "abs_rel", "smape", "wmape", "minkowski"):
        _hold(key, checks, result[key], want[key], base_tol)
    # an element's terms cancel: 4 units of 2**-24 of their magnitude each
    for key in ("log_cosh", "tweedie"):
        _hold(key, checks, result[key], want[key], base_tol + 4 * 2.0**-24 * ref["cancel"][key])
    _hold("rse", checks, result["rse"], want["rse"], base_tol * (k_target + 1))
    _hold("r2", checks, result["r2"], want["r2"], base_tol * (k_target + 1) * (1 - want["r2"]), relative=False)
    _hold("explained_variance", checks, result["explained_variance"], want["explained_variance"],
          base_tol * (k_target + k_error) * (1 - want["explained_variance"]), relative=False)
    # the streaming update's first batch multiplies deviations by the raw
    # values (the prior mean is 0): mean over spread scales its rounding
    for key in ("pearson", "concordance"):
        _hold(key, checks, result[key], want[key], 2 * base_tol * ref["cancel"]["moments"], relative=False)
    heads = [_nyu_batch(i, dev) for i in range(-(-NYU["spearman_images"] // b))]
    p_host = torch.cat([p for p, _ in heads])[:spearman_pixels].cpu().numpy().astype(np.float64)
    t_host = torch.cat([t for _, t in heads])[:spearman_pixels].cpu().numpy().astype(np.float64)
    del heads
    _hold("spearman", checks, result["spearman"], spearmanr(p_host, t_host).statistic, NYU_SPEARMAN_ATOL, relative=False)
    _check(int(coll["pearson"].n_total) == ref["pixels"], f"{name}: Pearson counted {int(coll['pearson'].n_total)} pixels")
    out = run["out"]
    return _emit({
        **out, "images": NYU["images"], "shape": [NYU["height"], NYU["width"]], "batch": b,
        "pixels": ref["pixels"], "spearman_pixels": spearman_pixels, "spearman_compute_ms": spearman_ms,
        "reduced": ["Spearman over the first 20 images (its list state keeps every pixel, and float32 ranks round past 2**23)"],
        "compute_groups": groups, "launches": launches,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": out["peak_mem_bytes"] - base,
        "float32_sum_rtol": base_tol, "cancellation": ref["cancel"], "values": {k: float(v) for k, v in result.items()},
        "checks": checks,
    })


def _weatherbench_batch(i: int, dev):
    """Initialisations ``4i`` to ``4i + 3`` as (rows, 8) truth and forecast:
    each variable its climatological mean plus its spread times a
    planetary wave pattern (random wave number and phase per
    initialisation) and 30% noise, the forecast that plus 15% of the spread
    in noise and a 2% bias; TP24h 0 on 65% of the grid, else log-normal
    around 2 mm, the forecast scaled by a log-normal factor."""
    import torch

    b, nlat, nlon = WEATHERBENCH["batch"], WEATHERBENCH["lat"], WEATHERBENCH["lon"]
    g = torch.Generator(device=dev).manual_seed(SEED + 3000 + i)
    lat = torch.deg2rad(torch.linspace(-90, 90, nlat, device=dev))[:, None]
    lon = torch.deg2rad(torch.arange(nlon, device=dev) * (360.0 / nlon))[None, :]
    climate = torch.tensor(WEATHERBENCH["climate"], device=dev)
    mean, spread = climate[:, 0].view(1, -1, 1, 1), climate[:, 1].view(1, -1, 1, 1)
    nv = climate.shape[0]
    wave = torch.randint(1, 7, (b, nv, 1, 1), generator=g, device=dev)
    phase = 2 * math.pi * torch.rand(b, nv, 1, 1, generator=g, device=dev)
    pattern = torch.cos(lat) * torch.sin(wave * lon + phase) + 0.5 * torch.sin(2 * lat)
    truth = mean + spread * (0.7 * pattern + 0.3 * torch.randn(b, nv, nlat, nlon, generator=g, device=dev))
    forecast = truth + spread * (WEATHERBENCH["error"] * torch.randn(truth.shape, generator=g, device=dev)
                                 + WEATHERBENCH["bias"])
    truth[:, 2].clamp_(min=0)
    forecast[:, 2].clamp_(min=0)
    wet = torch.rand(b, 1, nlat, nlon, generator=g, device=dev) < 0.35
    tp = torch.where(wet, 2.0 * torch.exp(torch.randn(b, 1, nlat, nlon, generator=g, device=dev)), 0.0)
    tp_forecast = tp * torch.exp(0.3 * torch.randn(tp.shape, generator=g, device=dev))
    truth, forecast = torch.cat([truth, tp], 1), torch.cat([forecast, tp_forecast], 1)
    return tuple(x.permute(0, 2, 3, 1).reshape(-1, nv + 1).contiguous() for x in (forecast, truth))


def _weatherbench_float64(dev) -> dict:
    """Per-variable values from float64 sums of the same rows on the card;
    the TP24h contingency counts exactly (int64)."""
    import torch

    updates = WEATHERBENCH["inits"] // WEATHERBENCH["batch"]
    thr = WEATHERBENCH["tp_threshold"]
    s = {k: 0 for k in ("sp", "st", "spp", "stt", "spt", "sd", "sdd")}
    n, hits, misses, false_alarms = 0, 0, 0, 0
    for i in range(updates):
        p, t = _weatherbench_batch(i, dev)
        p64, t64 = p.double(), t.double()
        d = t64 - p64
        n += t.shape[0]
        for k, v in (("sp", p64), ("st", t64), ("spp", p64 * p64), ("stt", t64 * t64), ("spt", p64 * t64),
                     ("sd", d), ("sdd", d * d)):
            s[k] = s[k] + v.sum(0)
        pb, tb = p[:, -1] >= thr, t[:, -1] >= thr
        hits += int((pb & tb).sum())
        misses += int((~pb & tb).sum())
        false_alarms += int((pb & ~tb).sum())
    tss, pss = s["stt"] - s["st"] ** 2 / n, s["spp"] - s["sp"] ** 2 / n
    cov = s["spt"] - s["sp"] * s["st"] / n
    err_var = s["sdd"] / n - (s["sd"] / n) ** 2
    tgt_var = s["stt"] / n - (s["st"] / n) ** 2
    pearson = cov / torch.sqrt(tss * pss)
    vx, vy = pss / (n - 1), tss / (n - 1)
    return {
        "rows": n,
        "values": {
            "mse": s["sdd"] / n, "rmse": torch.sqrt(s["sdd"] / n), "r2": 1 - s["sdd"] / tss,
            "explained_variance": 1 - err_var / tgt_var, "pearson": pearson,
            "concordance": 2 * pearson * torch.sqrt(vx) * torch.sqrt(vy) / (vx + vy + (s["sp"] / n - s["st"] / n) ** 2),
        },
        "cancel": {"target": s["stt"] / tss, "error": (s["sdd"] / n) / err_var,
                   "moments": 1 + s["sp"].abs() / torch.sqrt(n * pss) + s["st"].abs() / torch.sqrt(n * tss)},
        "csi": {"hits": hits, "misses": misses, "false_alarms": false_alarms,
                "value": hits / (hits + misses + false_alarms)},
    }


def phase_weatherbench(dev) -> dict:
    """WeatherBench 2 at 1.5 degrees: MSE and RMSE (8 outputs), R2 and
    explained variance (raw values), Pearson and concordance (8 outputs) in
    one collection, CSI on TP24h at 1 mm: 21.3M rows of 8 variables in raw
    units, so Pearson's count passes 2**24 (held exact) and R2's float32
    total sum of squares cancels (held within the bound float32's
    algorithm gives, scaled by each variable's cancellation factor)."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import regression as reg

    name = "weatherbench2_1p5deg"
    nv = len(WEATHERBENCH["variables"])
    updates = WEATHERBENCH["inits"] // WEATHERBENCH["batch"]
    rows_per_update = WEATHERBENCH["batch"] * WEATHERBENCH["lat"] * WEATHERBENCH["lon"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    coll = MetricCollection({
        "mse": reg.MeanSquaredError(num_outputs=nv), "rmse": reg.MeanSquaredError(squared=False, num_outputs=nv),
        "r2": reg.R2Score(num_outputs=nv, multioutput="raw_values"),
        "explained_variance": reg.ExplainedVariance(multioutput="raw_values"),
        "pearson": reg.PearsonCorrCoef(num_outputs=nv), "concordance": reg.ConcordanceCorrCoef(num_outputs=nv),
    })
    csi = reg.CriticalSuccessIndex(threshold=WEATHERBENCH["tp_threshold"])

    def update(coll, batch) -> None:
        forecast, truth = batch
        coll.update(forecast, truth)
        csi.update(forecast[:, -1], truth[:, -1])

    run = _drive(name, {
        "collection": lambda: coll, "batches": lambda: (_weatherbench_batch(i, dev) for i in range(updates)),
        "samples": updates * rows_per_update, "update": update,
    }, dev)
    result = {**run["result"], "csi": csi.compute()}
    launches = _no_launches(name, run["launches"])
    groups = sorted(sorted(g) for g in coll.compute_groups.values())
    _check(["concordance", "pearson"] in groups and ["mse", "rmse"] in groups and len(groups) == 4,
           f"{name}: compute groups {groups}")

    ref = _weatherbench_float64(dev)
    rows = ref["rows"]
    n_total = coll["pearson"].n_total
    _check(n_total.dtype == torch.int64 and bool((n_total == rows).all()),
           f"{name}: Pearson counted {n_total.tolist()} rows of {rows}")
    base_tol = _f32_rtol(updates, rows_per_update)
    want, k_target, k_error = ref["values"], ref["cancel"]["target"], ref["cancel"]["error"]
    checks: dict = {}
    _hold("mse", checks, result["mse"], want["mse"], base_tol)
    _hold("rmse", checks, result["rmse"], want["rmse"], base_tol)
    _hold("r2", checks, result["r2"], want["r2"], base_tol * (k_target + 1) * (1 - want["r2"]), relative=False)
    _hold("explained_variance", checks, result["explained_variance"], want["explained_variance"],
          base_tol * (k_target + k_error) * (1 - want["explained_variance"]), relative=False)
    # the streaming update's first batch multiplies deviations by the raw
    # values (the prior mean is 0): mean over spread scales its rounding
    for key in ("pearson", "concordance"):
        _hold(key, checks, result[key], want[key], 2 * base_tol * ref["cancel"]["moments"], relative=False)
    counts = {k: int(getattr(csi, k)) for k in ("hits", "misses", "false_alarms")}
    _check(counts == {k: ref["csi"][k] for k in counts}, f"{name}: CSI counts {counts} against {ref['csi']}")
    _hold("csi", checks, result["csi"], ref["csi"]["value"], 1e-6)
    return _emit({
        "phase": name, "variables": list(WEATHERBENCH["variables"]), "grid": [WEATHERBENCH["lat"], WEATHERBENCH["lon"]],
        "initialisations": WEATHERBENCH["inits"], "rows": rows, "pearson_n_total": n_total.tolist(),
        "rows_past_2_24": rows > 2**24,
        "reduced": ["no cos-latitude weights (these metrics take none)", "one lead time"],
        **{k: v for k, v in run["out"].items() if k != "phase"}, "compute_groups": groups, "launches": launches,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": run["out"]["peak_mem_bytes"] - base,
        "float32_sum_rtol": base_tol, "cancellation": {k: v.tolist() for k, v in ref["cancel"].items()},
        "csi_counts": counts, "values": {k: v.tolist() for k, v in result.items()}, "checks": checks,
    })


def _nasbench(dev):
    """The true accuracies (rounded to 0.01, 3% of cells degenerate at 10%)
    and a predictor's scores (the truth plus noise)."""
    import torch

    n = NASBENCH["cells"]
    g = torch.Generator(device=dev).manual_seed(SEED + 4000)
    acc = (NASBENCH["best"] - torch.exp(0.9 * torch.randn(n, generator=g, device=dev) + 0.3)).clamp(10.0, NASBENCH["best"])
    acc = torch.where(torch.rand(n, generator=g, device=dev) < NASBENCH["degenerate"], 10.0, acc)
    truth = torch.round(acc * 100) / 100
    scores = acc + NASBENCH["predictor_noise"] * torch.randn(n, generator=g, device=dev)
    return scores, truth


def phase_nasbench(dev) -> dict:
    """NAS-Bench-201's 15,625 cells: Kendall tau-b and tau-c (with the
    t-test), Spearman and Pearson of a predictor against the true accuracy,
    against scipy; Kendall's tiled count keeps the peak memory far under
    the JAX package's dense n x n form."""
    import numpy as np
    import torch
    from scipy.stats import kendalltau, norm, pearsonr, spearmanr

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import regression as reg

    name = "nasbench201_ranking"
    n, b = NASBENCH["cells"], NASBENCH["batch"]
    scores, truth = _nasbench(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    coll = MetricCollection({
        "kendall_b": reg.KendallRankCorrCoef(variant="b"),
        "kendall_c": reg.KendallRankCorrCoef(variant="c", t_test=True, alternative="two-sided"),
        "spearman": reg.SpearmanCorrCoef(), "pearson": reg.PearsonCorrCoef(),
    })
    run = _drive(name, {
        "collection": lambda: coll, "batches": lambda: [(scores[s:s + b], truth[s:s + b]) for s in range(0, n, b)],
        "samples": n,
    }, dev)
    result = run["result"]
    launches = _no_launches(name, run["launches"])
    groups = sorted(sorted(g) for g in coll.compute_groups.values())
    _check(groups == [["kendall_b", "kendall_c", "spearman"], ["pearson"]], f"{name}: compute groups {groups}")

    x, y = scores.double().cpu().numpy(), truth.double().cpu().numpy()
    tau_c, p_value = result["kendall_c"]
    z = kendalltau(x, y, variant="c").statistic / math.sqrt(2 * (2 * n + 5) / (9 * n * (n - 1)))
    checks: dict = {}
    _hold("kendall_b", checks, result["kendall_b"], kendalltau(x, y, variant="b").statistic, NAS_ATOL["kendall"], relative=False)
    _hold("kendall_c", checks, tau_c, kendalltau(x, y, variant="c").statistic, NAS_ATOL["kendall"], relative=False)
    _hold("kendall_c_p_value", checks, p_value, 2 * norm.sf(abs(z)), NAS_ATOL["p_value"], relative=False)
    _hold("spearman", checks, result["spearman"], spearmanr(x, y).statistic, NAS_ATOL["spearman"], relative=False)
    _hold("pearson", checks, result["pearson"], pearsonr(x, y).statistic, NAS_ATOL["pearson"], relative=False)
    ties = int(len(y) - len(np.unique(y)))
    return _emit({
        **run["out"], "cells": n, "batch": b, "tied_truth_values": ties, "compute_groups": groups, "launches": launches,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": run["out"]["peak_mem_bytes"] - base,
        # the JAX package's dense form holds at least dx, dy and their sign
        # product (three n x n float32) and the n(n - 1) int32 triangle
        # indices at once: 16 n² bytes
        "jax_dense_lower_bound_bytes": 16 * n * n,
        "values": {k: ([float(t) for t in v] if isinstance(v, tuple) else float(v)) for k, v in result.items()},
        "p_value_note": "scipy's own p-value corrects the variance for ties; held here to the port's formula in float64",
        "checks": checks,
    })


def _inshop(dev):
    """Query and gallery embeddings: each image its item's centre plus
    noise, L2-normalised; the gallery covers every item."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 5000)
    centres = torch.randn(INSHOP["items"], INSHOP["dim"], generator=g, device=dev)
    gallery_items = torch.arange(INSHOP["gallery"], device=dev) % INSHOP["items"]
    query_items = torch.randint(0, INSHOP["items"], (INSHOP["queries"],), generator=g, device=dev)

    def embed(items):
        noise = torch.randn(items.shape[0], INSHOP["dim"], generator=g, device=dev)
        return F.normalize(centres[items] + INSHOP["spread"] * noise, dim=1)

    return embed(query_items), embed(gallery_items)


def phase_inshop_pairwise(dev) -> dict:
    """DeepFashion In-shop: the five pairwise functions of the 14,218
    queries against the 12,612-image gallery (cosine, euclidean, linear in
    full float32; Manhattan and Minkowski p = 3 in chunks), one
    gallery-against-gallery call with the diagonal zeroed and one ``mean``
    reduction: each call timed (host clock ending in a synchronise, after
    a warm-up on 64 rows) and held to float64 on the card."""
    import torch

    from torchmetrics_tpu_torch import functional as tmf
    from torchmetrics_tpu_torch.functional.pairwise import distances

    name = "inshop_pairwise"
    q, g = _inshop(dev)
    q64, g64 = q.double(), g.double()
    every = INSHOP["check_every"]

    def cosine64(a, b):
        return (a / a.norm(dim=1, keepdim=True)) @ (b / b.norm(dim=1, keepdim=True)).T

    calls = {
        "cosine": (lambda a, b: tmf.pairwise_cosine_similarity(a, b), lambda: cosine64(q64, g64), None),
        "euclidean": (lambda a, b: tmf.pairwise_euclidean_distance(a, b), lambda: torch.cdist(q64, g64), None),
        "linear": (lambda a, b: tmf.pairwise_linear_similarity(a, b), lambda: q64 @ g64.T, None),
        "manhattan": (lambda a, b: tmf.pairwise_manhattan_distance(a, b), lambda: torch.cdist(q64[::every], g64, p=1.0), every),
        "minkowski_p3": (lambda a, b: tmf.pairwise_minkowski_distance(a, b, exponent=3), lambda: torch.cdist(q64[::every], g64, p=3.0), every),
    }
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    counters = _launch_counters()
    for module in counters.values():
        module.launches = 0
    rows: dict = {}
    for key, (fn, ref_fn, stride) in calls.items():
        fn(q[:64], g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        got = fn(q, g)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        want = ref_fn()
        checked = got if stride is None else got[::stride]
        err = float((checked.double() - want).abs().max() / want.abs().max())
        _check(bool(torch.isfinite(got).all()), f"{name}: {key} is not finite")
        _check(err <= PAIRWISE_RTOL, f"{name}: {key} is {err} from float64 (relative to its largest value)")
        rows[key] = {"ms": ms, "shape": list(got.shape), "rows_checked": int(checked.shape[0]), "max_rel_err": err,
                     "peak_mem_above_base_bytes": peak}
        del got, want, checked

    # the gallery against itself, its diagonal zeroed (the default without y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gg = tmf.pairwise_cosine_similarity(g)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = cosine64(g64, g64)
    want.fill_diagonal_(0)
    _check(bool((gg.diagonal() == 0).all()), f"{name}: the zeroed diagonal holds nonzero values")
    err = float((gg.double() - want).abs().max())
    _check(err <= PAIRWISE_RTOL, f"{name}: gallery x gallery cosine is {err} from float64")
    rows["gallery_zero_diagonal_cosine"] = {"ms": ms, "shape": list(gg.shape), "max_abs_err": err}
    del gg, want

    t0 = time.perf_counter()
    mean = tmf.pairwise_cosine_similarity(q, g, reduction="mean")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = float((mean.double() - cosine64(q64, g64).mean(1)).abs().max())
    _check(err <= PAIRWISE_MEAN_ATOL, f"{name}: the mean reduction is {err} from float64")
    rows["mean_reduction_cosine"] = {"ms": ms, "shape": list(mean.shape), "max_abs_err": err}
    launches = _no_launches(name, {k: m.launches for k, m in counters.items()})
    return _emit({
        "phase": name, "queries": INSHOP["queries"], "gallery": INSHOP["gallery"], "dim": INSHOP["dim"],
        "chunk_elements": distances._CHUNK_ELEMENTS, "launches": launches, "calls": rows,
        "jax_broadcast_bytes": 4 * INSHOP["queries"] * INSHOP["gallery"] * INSHOP["dim"],
        "rtol": PAIRWISE_RTOL, "mean_atol": PAIRWISE_MEAN_ATOL,
    })


# ------------------------------------------------------------- wrappers and nominal association

#: ImageNet-1k val (IMAGENET's batches) through BootStrapper: 100 replicates
#: of top-1 (poisson) and of macro F1 (multinomial), 95% intervals; the
#: functional path once a batch with explicit indices (10 replicates)
IMAGENET_BOOT = {"replicates": 100, "quantile": [0.025, 0.975], "functional_replicates": 10, "margin": 2.0}
BOOT_ATOL = 1e-6
#: three "epochs" of the ImageNet batches whose logits lean further to the
#: target each epoch (top-1 rising), for MetricTracker, MinMaxMetric and
#: Running (the last 16 batches)
IMAGENET_TRACKED = {"margins": [1.0, 2.0, 3.0], "window": 16}
#: NYUv2 as multi-task papers score it (MTAN, Liu et al., CVPR 2019): the
#: 654 test images at 288 x 384, batch 8, 13-class segmentation
#: (``ignore_index=-1`` on 5% of pixels) and depth in 0.5-10 m (valid
#: everywhere: no depth mask)
NYUV2 = {"images": 654, "batch": 8, "height": 288, "width": 384, "classes": 13, "ignored": 0.05, "block": 16,
         "margin": 2.0, "depth": (0.5, 10.0), "depth_noise": 0.1}
NYUV2_LABELS = ["bed", "books", "ceiling", "chair", "floor", "furniture", "objects", "picture", "sofa", "table",
                "tv", "wall", "window"]
#: OGB ogbg-molpcba's test split: 43,793 molecules x 128 binary tasks, batch
#: 1,024; labels missing (NaN) at the rate and positive among the present at
#: the rate below (the dataset's own label matrix is not in the repository;
#: each task's positive rate is drawn from 0.25x to 1.75x of it)
MOLPCBA = {"molecules": 43_793, "tasks": 128, "batch": 1_024, "missing": 0.6, "positive_rate": 0.014, "shift": 1.5}
MOLPCBA_ATOL = 1e-5
#: UCI "US Census Data (1990)": 2,458,285 rows x 68 coded categorical
#: columns. Cut: synthetic columns of 2-20 categories (``CENSUS_CARDS``),
#: associations planted through 8 shared latent codes (35% of a column's
#: rows) and one global code (15%); the four table metrics over one column
#: pair in batches of 65,536 rows; the no-correction matrices over the
#: first 16 columns
CENSUS = {"rows": 2_458_285, "columns": 68, "latents": 8, "codes": 20, "group": 0.35, "global": 0.15,
          "batch": 65_536, "pair": (0, 1), "subset": 16}
CENSUS_CARDS = [2 + (7 * j) % 19 for j in range(CENSUS["columns"])]
#: CIFAR-10H's shape: 10,000 test images x 10 classes, 50 human labels each
CIFAR10H = {"images": 10_000, "classes": 10, "raters": 50, "batch": 1_000}
NOMINAL_ATOL = 1e-5


def _lean_batches(dev, margin: float, seed: int):
    """IMAGENET's batches: N(0, 1) logits plus ``margin`` on the target's."""
    import torch

    c = IMAGENET["num_classes"]
    g = torch.Generator(device=dev).manual_seed(seed)
    for b in IMAGENET["batches"]:
        target = torch.randint(0, c, (b,), generator=g, device=dev)
        noise = torch.randn((b, c), generator=g, device=dev)
        yield noise + margin * torch.nn.functional.one_hot(target, c).to(torch.float32), target


def _class_counts(pred, target, c: int):
    """Plain int64 per-class (tp, fp, fn) of label vectors (``torch.bincount``)."""
    import torch

    cm = torch.bincount(target * c + pred, minlength=c * c).view(c, c)
    tp = cm.diagonal()
    return torch.stack([tp, cm.sum(0) - tp, cm.sum(1) - tp])


def _macro(counts, kind: str):
    """Macro recall ("accuracy") or F1 in float64 over the present classes,
    from ``(..., 3, C)`` int64 (tp, fp, fn)."""
    tp, fp, fn = (counts[..., k, :].double() for k in range(3))
    present = (tp + fp + fn) > 0
    num, den = (tp, tp + fn) if kind == "accuracy" else (2 * tp, 2 * tp + fp + fn)
    score = _safe(num, den) * present
    return score.sum(-1) / present.sum(-1)


def _hold_boot(name: str, checks: dict, got: dict, vals, quantile) -> None:
    """A BootStrapper's mean, std (ddof 1) and linear quantiles against
    float64 over the replicate values ``vals``."""
    import torch

    q = torch.tensor(quantile, dtype=torch.float64, device=vals.device)
    want = {"mean": vals.mean(), "std": vals.std(correction=1), "quantile": torch.quantile(vals, q)}
    for k, v in want.items():
        _hold(f"{name}_{k}", checks, got[k], v, BOOT_ATOL, relative=False)


def phase_imagenet_bootstrap(dev) -> dict:
    """ImageNet-1k val through two BootStrappers (100 replicates each): every
    replicate's counts against a plain int64 count of the same resample
    (redrawn from a second ``RandomState(seed)``), mean, std and quantiles
    against float64 over those counts, exactly 2 x 100 x 49 ``bincount``
    launches, updates/s and the host's resampling share; then the
    functional path with explicit indices against the stateful one fed the
    same indices."""
    import warnings

    import numpy as np
    import torch

    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.wrappers import BootStrapper, bootstrapping

    name, spec, c = "imagenet_bootstrap", IMAGENET_BOOT, IMAGENET["num_classes"]
    reps, updates = spec["replicates"], len(IMAGENET["batches"])
    kw = {"num_classes": c, "validate_args": False}
    seeds = {"accuracy": SEED + 20, "f1": SEED + 21}
    strategies = {"accuracy": "poisson", "f1": "multinomial"}

    def batches():
        return _lean_batches(dev, spec["margin"], SEED + 22)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    boots = {
        "accuracy": BootStrapper(MulticlassAccuracy(average="micro", **kw), num_bootstraps=reps,
                                 sampling_strategy="poisson", quantile=spec["quantile"], seed=seeds["accuracy"]),
        "f1": BootStrapper(MulticlassF1Score(average="macro", **kw), num_bootstraps=reps,
                           sampling_strategy="multinomial", quantile=spec["quantile"], seed=seeds["f1"]),
    }
    sampler, sample_s = bootstrapping._bootstrap_sampler, [0.0]

    def timed_sampler(*args, **kwargs):
        t0 = time.perf_counter()
        out = sampler(*args, **kwargs)
        sample_s[0] += time.perf_counter() - t0
        return out

    bootstrapping._bootstrap_sampler = timed_sampler
    step_s = []
    try:
        bincount.launches = 0
        for preds, target in batches():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for boot in boots.values():
                boot.update(preds, target)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = bincount.launches
        t0 = time.perf_counter()
        result = {k: b.compute() for k, b in boots.items()}
        torch.cuda.synchronize()
        compute_s = time.perf_counter() - t0
    finally:
        bootstrapping._bootstrap_sampler = sampler
    peak = torch.cuda.max_memory_allocated(dev)
    _check(launches == 2 * reps * updates, f"{name}: {launches} bincount launches, expected {2 * reps * updates}")

    # the same resamples from second generators, counted plainly in int64
    rngs = {k: np.random.RandomState(s) for k, s in seeds.items()}
    counts = {k: torch.zeros((reps, 3, c), dtype=torch.int64, device=dev) for k in boots}
    samples = {k: torch.zeros(reps, dtype=torch.int64, device=dev) for k in boots}
    for preds, target in batches():
        label = preds.argmax(1)
        for k in boots:
            for r in range(reps):
                idx = torch.from_numpy(bootstrapping._bootstrap_sampler(target.shape[0], strategies[k], rngs[k])).to(dev)
                counts[k][r] += _class_counts(label[idx], target[idx], c)
                samples[k][r] += idx.numel()
    exact = True
    for r in range(reps):
        acc, f1 = boots["accuracy"].metrics[r], boots["f1"].metrics[r]
        tp, fp, fn = counts["accuracy"][r].sum(-1)
        want = {"tp": tp, "fp": fp, "fn": fn, "tn": samples["accuracy"][r] * c - tp - fp - fn}
        exact &= all(torch.equal(getattr(acc, k).to(torch.int64), v) for k, v in want.items())
        tp, fp, fn = counts["f1"][r]
        want = {"tp": tp, "fp": fp, "fn": fn, "tn": samples["f1"][r] - tp - fp - fn}
        exact &= all(torch.equal(getattr(f1, k).to(torch.int64), v) for k, v in want.items())
    _check(exact, f"{name}: a replicate's counts differ from the plain int64 count of its resample")
    checks: dict = {}
    micro = counts["accuracy"][:, 0].sum(-1).double() / samples["accuracy"].double()
    _hold_boot("accuracy", checks, result["accuracy"], micro, spec["quantile"])
    _hold_boot("f1", checks, result["f1"], _macro(counts["f1"], "f1"), spec["quantile"])

    # the functional path: explicit indices, against the stateful children fed them
    n_fn = spec["functional_replicates"]
    functional = BootStrapper(MulticlassAccuracy(average="micro", **kw), num_bootstraps=n_fn, sampling_strategy="multinomial")
    stateful = BootStrapper(MulticlassAccuracy(average="micro", **kw), num_bootstraps=n_fn, sampling_strategy="multinomial")
    rng = np.random.RandomState(SEED + 23)
    state, functional_launches = functional.functional_init(), 0
    for preds, target in batches():
        idx = torch.from_numpy(rng.randint(0, target.shape[0], (n_fn, target.shape[0]))).to(dev)
        before = bincount.launches
        state = functional.functional_update(state, preds, target, indices=idx)
        functional_launches += bincount.launches - before
        for i, m in enumerate(stateful.metrics):
            m.update(preds.index_select(0, idx[i]), target.index_select(0, idx[i]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the children were updated directly, not through the wrapper
        stateful_value = stateful.compute()
    functional_value = functional.functional_compute(state)
    live = stateful.state()
    _check(all(torch.equal(state[k], live[k]) for k in state), f"{name}: functional state differs from the stateful one")
    _check(all(torch.equal(functional_value[k], stateful_value[k]) for k in stateful_value),
           f"{name}: functional {functional_value} != stateful {stateful_value}")
    _check(functional_launches == n_fn * updates, f"{name}: functional path made {functional_launches} launches")

    update_s = sum(step_s)
    step_ms = sorted(t * 1e3 for t in step_s)
    return _emit({
        "phase": name, "updates": updates, "replicates": reps, "samples": sum(IMAGENET["batches"]),
        "wrapper_updates_per_s": 2 * updates / update_s, "replicate_updates_per_s": 2 * reps * updates / update_s,
        "update_s": update_s, "update_ms": {"min": step_ms[0], "p50": step_ms[updates // 2], "max": step_ms[-1]},
        "resample_host_s": sample_s[0], "resample_share": sample_s[0] / update_s, "compute_s": compute_s,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base,
        "bincount_launches": launches, "functional_bincount_launches": functional_launches,
        "values": {k: {kk: vv.tolist() for kk, vv in v.items()} for k, v in result.items()},
        "counts_exact": True, "functional_equals_stateful": True, "checks": checks,
    })


def phase_imagenet_tracked(dev) -> dict:
    """Three epochs of the ImageNet batches through MetricTracker (top-1,
    top-5, macro F1), MinMaxMetric and Running (window 16) forwards: the
    best epoch of each, Running against a plain count of the last 16
    batches, MinMax's extrema against the batch values and its compute
    against the plain count of every batch."""
    import collections

    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.wrappers import MetricTracker, MinMaxMetric, Running

    name, spec, c = "imagenet_tracked", IMAGENET_TRACKED, IMAGENET["num_classes"]
    kw = {"num_classes": c, "validate_args": False}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tracker = MetricTracker(
        MetricCollection({
            "top1": MulticlassAccuracy(average="micro", **kw), "top5": MulticlassAccuracy(top_k=5, average="micro", **kw),
            "f1": MulticlassF1Score(average="macro", **kw),
        }),
        maximize=[True, True, True],
    )
    minmax = MinMaxMetric(MulticlassAccuracy(**kw))
    running = Running(MulticlassAccuracy(**kw), window=spec["window"])
    window = collections.deque(maxlen=spec["window"])
    total = torch.zeros((3, c), dtype=torch.int64, device=dev)
    epoch_correct, raws, step_s = [], [], []
    bincount.launches = 0
    for epoch, margin in enumerate(spec["margins"]):
        tracker.increment()
        correct = 0
        for preds, target in _lean_batches(dev, margin, SEED + 30 + epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracker.update(preds, target)
            raws.append(minmax(preds, target)["raw"])
            running(preds, target)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            label = preds.argmax(1)
            window.append(_class_counts(label, target, c))
            total += window[-1]
            correct += int((label == target).sum())
        epoch_correct.append(correct / sum(IMAGENET["batches"]))
    launches = bincount.launches
    extrema = {"min": minmax.min_val.clone(), "max": minmax.max_val.clone()}
    t0 = time.perf_counter()
    best, steps = tracker.best_metric(return_step=True)
    everything = tracker.compute_all()
    final = minmax.compute()
    windowed = running.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)

    last = len(spec["margins"]) - 1
    _check(steps == {"top1": last, "top5": last, "f1": last}, f"{name}: best steps {steps}, expected epoch {last} for all")
    checks: dict = {}
    _hold("top1_by_epoch", checks, everything["top1"], epoch_correct, 1e-5)
    _hold("running", checks, windowed, _macro(sum(window), "accuracy"), 1e-5)
    _hold("minmax_accumulated", checks, final["raw"], _macro(total, "accuracy"), 1e-5)
    batch_values = torch.stack(raws)
    _check(torch.equal(extrema["min"], batch_values.min()) and torch.equal(extrema["max"], batch_values.max()),
           f"{name}: MinMax extrema {extrema} differ from the batch values' {float(batch_values.min())}, {float(batch_values.max())}")
    update_s = sum(step_s)
    return _emit({
        "phase": name, "epochs": len(spec["margins"]), "updates": len(step_s), "window": spec["window"],
        "updates_per_s": len(step_s) / update_s, "update_s": update_s, "compute_s": compute_s,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base, "bincount_launches": launches,
        "best": best, "best_step": steps, "by_epoch": {k: v.tolist() for k, v in everything.items()},
        "minmax": {"min": float(extrema["min"]), "max": float(extrema["max"]), "accumulated": float(final["raw"])},
        "running": float(windowed), "checks": checks,
    })


def _nyuv2_batch(i: int, dev):
    """One NYUv2 batch: block-wise labels (16 x 16 pixel blocks) with 5%
    ignored, logits leaning to the label, a smooth depth field and preds
    with 10% multiplicative noise."""
    import torch

    spec = NYUV2
    b = min(spec["batch"], spec["images"] - i * spec["batch"])
    h, w, c, k = spec["height"], spec["width"], spec["classes"], spec["block"]
    g = torch.Generator(device=dev).manual_seed(SEED + 40 + i)
    labels = torch.randint(0, c, (b, h // k, w // k), generator=g, device=dev)
    labels = labels.repeat_interleave(k, 1).repeat_interleave(k, 2)
    logits = torch.randn((b, c, h, w), generator=g, device=dev)
    logits += spec["margin"] * torch.nn.functional.one_hot(labels, c).permute(0, 3, 1, 2).to(torch.float32)
    target = torch.where(torch.rand((b, h, w), generator=g, device=dev) < spec["ignored"], -1, labels)
    lo, hi = spec["depth"]
    coarse = torch.rand((b, 1, h // 32, w // 32), generator=g, device=dev)
    depth = lo + (hi - lo) * torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)[:, 0]
    pred_depth = depth * (1 + spec["depth_noise"] * torch.randn(depth.shape, generator=g, device=dev))
    return logits, target, pred_depth, depth


def phase_nyuv2_multitask(dev) -> dict:
    """NYUv2 through MultitaskWrapper: segmentation (mIoU, pixel accuracy,
    per-class IoU labeled by ClasswiseWrapper) and depth (MAE, MAPE). The
    segmentation counts against a plain int64 count, one ``bincount``
    launch an update for the segmentation group, depth against float64."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassJaccardIndex
    from torchmetrics_tpu_torch.regression import MeanAbsoluteError, MeanAbsolutePercentageError
    from torchmetrics_tpu_torch.wrappers import ClasswiseWrapper, MultitaskWrapper

    name, spec = "nyuv2_multitask", NYUV2
    c, b, hw = spec["classes"], spec["batch"], spec["height"] * spec["width"]
    updates = -(-spec["images"] // b)
    kw = {"num_classes": c, "ignore_index": -1, "validate_args": False}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    wrapper = MultitaskWrapper({
        "segmentation": MetricCollection({
            "miou": MulticlassJaccardIndex(**kw), "pixel_accuracy": MulticlassAccuracy(average="micro", **kw),
            "iou": ClasswiseWrapper(MulticlassJaccardIndex(average=None, **kw), labels=NYUV2_LABELS, prefix="iou_"),
        }),
        "depth": MetricCollection({"mae": MeanAbsoluteError(), "mape": MeanAbsolutePercentageError()}),
    })

    def update(w, batch) -> None:
        logits, target, pred_depth, depth = batch
        w.update({"segmentation": logits, "depth": pred_depth}, {"segmentation": target, "depth": depth})

    run = _drive(name, {
        "collection": lambda: wrapper, "batches": lambda: (_nyuv2_batch(i, dev) for i in range(updates)),
        "samples": spec["images"] * hw, "update": update,
    }, dev)
    launches = run["launches"]
    _check(launches["bincount"] == updates, f"{name}: {launches['bincount']} bincount launches for {updates} updates")
    _check(not any(v for k, v in launches.items() if k != "bincount"), f"{name}: another kernel launched: {launches}")
    seg = wrapper.task_metrics["segmentation"]

    # plain int64 confusion counts and float64 depth sums of the same batches
    cm = torch.zeros((c, c), dtype=torch.int64, device=dev)
    abs_sum = ape_sum = torch.zeros((), dtype=torch.float64, device=dev)
    pixels = 0
    for i in range(updates):
        logits, target, pred_depth, depth = _nyuv2_batch(i, dev)
        valid = target >= 0
        cm += torch.bincount((target * c + logits.argmax(1))[valid], minlength=c * c).view(c, c)
        err = (pred_depth.double() - depth.double()).abs()
        abs_sum = abs_sum + err.sum()
        ape_sum = ape_sum + (err / depth.double().abs().clamp(min=1.17e-06)).sum()
        pixels += depth.numel()
    tp = cm.diagonal()
    fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
    valid_pixels = cm.sum()
    miou = seg["miou"]
    want = {"tp": tp, "fp": fp, "fn": fn, "tn": valid_pixels - tp - fp - fn}
    _check(all(torch.equal(getattr(miou, k).to(torch.int64), v) for k, v in want.items()), f"{name}: IoU counts differ from plain int64")
    acc = seg["pixel_accuracy"]
    micro = {"tp": tp.sum(), "fp": fp.sum(), "fn": fn.sum()}
    _check(all(torch.equal(getattr(acc, k).to(torch.int64), v) for k, v in micro.items()), f"{name}: pixel accuracy counts differ")
    result = run["result"]
    checks: dict = {}
    iou = _safe(tp.double(), (tp + fp + fn).double())
    _hold("miou", checks, result["segmentation"]["miou"], iou[(tp + fp + fn) > 0].mean(), 1e-5)
    _hold("pixel_accuracy", checks, result["segmentation"]["pixel_accuracy"], tp.sum().double() / valid_pixels, 1e-5)
    _hold("iou", checks, torch.stack([result["segmentation"][f"iou_{k}"] for k in NYUV2_LABELS]), iou, 1e-5)
    tol = _f32_rtol(updates, b * hw)
    _hold("mae", checks, result["depth"]["mae"], abs_sum / pixels, tol)
    _hold("mape", checks, result["depth"]["mape"], ape_sum / pixels, tol)
    out = run["out"]
    return _emit({
        **out, "images": spec["images"], "shape": [spec["height"], spec["width"]], "batch": b, "classes": c,
        "valid_pixels": int(valid_pixels), "bincount_launches": launches["bincount"],
        "reduced": ["depth valid everywhere (no depth mask)"],
        "base_mem_bytes": base, "peak_mem_above_base_bytes": out["peak_mem_bytes"] - base,
        "values": {task: {k: float(v) for k, v in vals.items()} for task, vals in result.items()},
        "counts_exact": True, "float32_sum_rtol": tol, "checks": checks,
    })


def _molpcba_rates(dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    return MOLPCBA["positive_rate"] * (0.25 + 1.5 * torch.rand(MOLPCBA["tasks"], generator=g, device=dev))


def _molpcba_batch(i: int, rates, dev):
    """One batch of scores in (0, 1) (positives' logits shifted up) and
    labels in {0, 1} with NaN where missing."""
    import torch

    spec = MOLPCBA
    b = min(spec["batch"], spec["molecules"] - i * spec["batch"])
    g = torch.Generator(device=dev).manual_seed(SEED + 51 + i)
    shape = (b, spec["tasks"])
    positive = torch.rand(shape, generator=g, device=dev) < rates
    missing = torch.rand(shape, generator=g, device=dev) < spec["missing"]
    preds = torch.sigmoid(torch.randn(shape, generator=g, device=dev) + spec["shift"] * positive)
    return preds, torch.where(missing, float("nan"), positive.to(torch.float32))


def _average_precision64(scores, labels) -> float:
    """Exact average precision in float64 (the step sum over distinct
    scores, as OGB's evaluator takes it from scikit-learn)."""
    import numpy as np

    order = np.argsort(-scores, kind="stable")
    s, y = scores[order], labels[order]
    ends = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
    tps = np.cumsum(y)[ends]
    precision = tps / (ends + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def phase_ogbg_molpcba(dev) -> dict:
    """OGB's ogbg-molpcba evaluator: MultioutputWrapper of exact binary AP
    over 128 tasks with the missing labels' rows removed per task on the
    card; every task's AP against float64 over its non-NaN rows."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.classification import BinaryAveragePrecision
    from torchmetrics_tpu_torch.wrappers import MultioutputWrapper

    name, spec = "ogbg_molpcba", MOLPCBA
    updates = -(-spec["molecules"] // spec["batch"])
    rates = _molpcba_rates(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    wrapper = MultioutputWrapper(BinaryAveragePrecision(thresholds=None, validate_args=False), num_outputs=spec["tasks"], remove_nans=True)
    run = _drive(name, {
        "collection": lambda: wrapper, "batches": lambda: (_molpcba_batch(i, rates, dev) for i in range(updates)),
        "samples": spec["molecules"],
    }, dev)
    _no_launches(name, run["launches"])
    got = run["result"].double().cpu().numpy()
    batches = [_molpcba_batch(i, rates, dev) for i in range(updates)]
    preds = torch.cat([p for p, _ in batches]).double().cpu().numpy()
    target = torch.cat([t for _, t in batches]).double().cpu().numpy()
    del batches
    present = ~np.isnan(target)
    want = np.array([_average_precision64(preds[present[:, t], t], target[present[:, t], t]) for t in range(spec["tasks"])])
    err = np.abs(got - want)
    _check(bool(np.isfinite(got).all()) and got.shape == (spec["tasks"],), f"{name}: AP not finite or of shape {got.shape}")
    _check(bool((err <= MOLPCBA_ATOL).all()), f"{name}: task AP off float64 by {err.max()} > {MOLPCBA_ATOL}")
    out = run["out"]
    return _emit({
        **out, "molecules": spec["molecules"], "tasks": spec["tasks"], "batch": spec["batch"],
        "missing_share": float(1 - present.mean()), "positive_rate_of_present": float(target[present].mean()),
        "positives_per_task": {"min": int(np.nansum(target, 0).min()), "max": int(np.nansum(target, 0).max())},
        "base_mem_bytes": base, "peak_mem_above_base_bytes": out["peak_mem_bytes"] - base,
        "mean_ap": float(got.mean()), "mean_ap_float64": float(want.mean()), "max_abs_err": float(err.max()),
        "atol": MOLPCBA_ATOL,
    })


def phase_cifar10_featureshare(dev, cifar: dict) -> dict:
    """The ``cifar10_fid`` images through FeatureShare([FID, KID, MiFID]) at
    ``feature=2048`` on the same calibrated network: one Inception forward
    an update (the unshared members would run three), the values bit-equal
    to the ``cifar10_fid`` phase's, 2 x 45 ``fid_sqrtm`` launches."""
    import torch

    from torchmetrics_tpu_torch.image import (
        FrechetInceptionDistance,
        KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )
    from torchmetrics_tpu_torch.ops import sqrtm_kernel
    from torchmetrics_tpu_torch.wrappers import FeatureShare

    name, spec, state = "cifar10_featureshare", CIFAR10, cifar["_reuse"]["state"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    fid = FrechetInceptionDistance(feature=2048, inception_params=state)
    forwards = [0]
    fid.feature_extractor.network.register_forward_hook(lambda *args: forwards.__setitem__(0, forwards[0] + 1))
    shared = FeatureShare([
        fid,
        KernelInceptionDistance(feature=2048, inception_params=state, subsets=spec["kid_subsets"], subset_size=spec["kid_subset_size"]),
        MemorizationInformedFrechetInceptionDistance(feature=2048, inception_params=state),
    ])
    torch.cuda.reset_peak_memory_stats(dev)
    counters = _launch_counters()
    for module in counters.values():
        module.launches = 0
    sqrtm_kernel.calls = 0
    step_s = []
    for real_imgs, fake_imgs in cifar["_reuse"]["batches"]():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shared.update(real_imgs, real=True)
        shared.update(fake_imgs, real=False)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    values = shared.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    launches = {k: m.launches for k, m in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    updates = 2 * len(step_s)

    def flat(v):
        return [float(x) for x in v] if isinstance(v, tuple) else [float(v)]

    got = {
        "fid": flat(values["FrechetInceptionDistance"]), "kid": flat(values["KernelInceptionDistance"]),
        "mifid": flat(values["MemorizationInformedFrechetInceptionDistance"]),
    }
    _check(forwards[0] == updates, f"{name}: {forwards[0]} Inception forwards for {updates} updates")
    _check(launches["fid_sqrtm"] == 2 * (1 + 2 * sqrtm_kernel.KERNEL_ITERS), f"{name}: {launches['fid_sqrtm']} fid_sqrtm launches")
    _check(not any(v for k, v in launches.items() if k != "fid_sqrtm"), f"{name}: another kernel launched: {launches}")
    for k, v in got.items():
        _check(v == cifar["values"][k], f"{name}: {k} {v} differs from the cifar10_fid phase's {cifar['values'][k]}")
    update_s = sum(step_s)
    return _emit({
        "phase": name, "images": {"real": spec["images"], "generated": spec["images"]}, "batch": spec["batch"],
        "updates": updates, "inception_forwards": forwards[0], "unshared_forwards": 3 * updates,
        "images_per_s": 2 * spec["images"] / update_s, "update_s": update_s, "compute_s": compute_s,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base,
        "cache": {"max_size": 3, "entries": len(shared["FrechetInceptionDistance"].feature_extractor._cache)},
        "compute_groups": [list(g) for g in shared.compute_groups.values()],
        "fid_sqrtm_launches": launches["fid_sqrtm"], "fid_sqrtm_calls": sqrtm_kernel.calls,
        "values": got, "bit_equal_to_cifar10_fid": True,
    })


def _census(dev):
    """(rows, 68) int64 codes: column j takes its latent group's code (j mod
    8) on 35% of rows, the global code on 15%, its own uniform draw on the
    rest, each shifted and wrapped into its CENSUS_CARDS[j] categories (so
    every column carries both codes)."""
    import torch

    spec = CENSUS
    n = spec["rows"]
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    latents = torch.randint(0, spec["codes"], (spec["latents"] + 1, n), generator=g, device=dev)
    data = torch.empty((n, spec["columns"]), dtype=torch.int64, device=dev)
    for j, card in enumerate(CENSUS_CARDS):
        u = torch.rand(n, generator=g, device=dev)
        own = torch.randint(0, card, (n,), generator=g, device=dev)
        group = (latents[j % spec["latents"]] + 3 * j) % card
        shared = (latents[-1] + j) % card
        data[:, j] = torch.where(u < spec["group"], group, torch.where(u < spec["group"] + spec["global"], shared, own))
    return data


def _tables(data, pairs):
    """Plain int64 contingency tables (rows: the second column's codes,
    columns: the first's) of column pairs, by ``torch.bincount``; on the host."""
    import numpy as np
    import torch

    out = []
    for i, j in pairs:
        ci, cj = CENSUS_CARDS[i], CENSUS_CARDS[j]
        out.append(torch.bincount(data[:, j] * ci + data[:, i], minlength=ci * cj).view(cj, ci))
    host = torch.cat([t.reshape(-1) for t in out]).cpu().numpy()
    tables, at = [], 0
    for (i, j) in pairs:
        size = CENSUS_CARDS[i] * CENSUS_CARDS[j]
        tables.append(host[at:at + size].reshape(CENSUS_CARDS[j], CENSUS_CARDS[i]))
        at += size
    return tables


def _drop_empty(table):
    return table[table.sum(1) > 0][:, table.sum(0) > 0]


def _cramers_v_corrected64(table) -> float:
    """The bias-corrected Cramér's V of the JAX package's algorithm in float64."""
    import numpy as np

    t = _drop_empty(table).astype(np.float64)
    r, k = t.shape
    n = t.sum()
    expected = np.outer(t.sum(1), t.sum(0)) / n
    if (r - 1) * (k - 1) == 1:
        t = t + np.sign(expected - t) * np.minimum(0.5, np.abs(np.sign(expected - t)))
    phi2 = float(((t - expected) ** 2 / expected).sum()) / n
    phi2c = max(0.0, phi2 - (r - 1) * (k - 1) / (n - 1))
    rc, kc = r - (r - 1) ** 2 / (n - 1), k - (k - 1) ** 2 / (n - 1)
    return min(1.0, math.sqrt(phi2c / max(min(rc - 1, kc - 1), 1e-12)))


def _theils_u64(table) -> float:
    """Theil's U of the column variable given the row variable in float64."""
    import numpy as np

    p_xy = table.astype(np.float64) / table.sum()
    p_y, p_x = np.broadcast_to(p_xy.sum(1, keepdims=True), p_xy.shape), p_xy.sum(0)
    nz = p_xy > 0
    s_xy = float((p_xy[nz] * np.log(p_y[nz] / p_xy[nz])).sum())
    s_x = float(-(p_x[p_x > 0] * np.log(p_x[p_x > 0])).sum())
    return 0.0 if s_x == 0 else (s_x - s_xy) / s_x


def phase_census1990_nominal(dev) -> dict:
    """Association between the census columns: Cramér's V (bias-corrected)
    and Theil's U matrices over all 68 columns, the no-correction matrices
    over the first 16 against scipy; the four table metrics over one pair as
    one compute group with one ``bincount`` a batch; Fleiss' kappa over
    CIFAR-10H-shaped ratings. Every value against float64 on the host."""
    import itertools

    import numpy as np
    import torch
    from scipy.stats.contingency import association

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import functional as F
    from torchmetrics_tpu_torch.nominal import (
        CramersV,
        FleissKappa,
        PearsonsContingencyCoefficient,
        TheilsU,
        TschuprowsT,
    )
    from torchmetrics_tpu_torch.ops import bincount

    name, spec = "census1990_nominal", CENSUS
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    data = _census(dev)
    torch.cuda.synchronize()
    data_bytes = data.numel() * data.element_size()
    torch.cuda.reset_peak_memory_stats(dev)
    counters = _launch_counters()
    for module in counters.values():
        module.launches = 0
    timings, launches = {}, {}
    matrices = {}
    sub = data[:, : spec["subset"]]
    for key, fn, arg, kwargs in (
        ("cramers_v_matrix", F.cramers_v_matrix, data, {}),
        ("theils_u_matrix", F.theils_u_matrix, data, {}),
        ("cramers_v_matrix_subset_plain", F.cramers_v_matrix, sub, {"bias_correction": False}),
        ("tschuprows_t_matrix_subset_plain", F.tschuprows_t_matrix, sub, {"bias_correction": False}),
        ("pearsons_matrix_subset", F.pearsons_contingency_coefficient_matrix, sub, {}),
    ):
        before = bincount.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        matrices[key] = fn(arg, **kwargs).double().cpu().numpy()
        timings[key] = time.perf_counter() - t0
        launches[key] = bincount.launches - before

    # the four table metrics over one pair, batch by batch
    num = max(CENSUS_CARDS[i] for i in spec["pair"])
    coll = MetricCollection({
        "cramers_v": CramersV(num, bias_correction=False), "tschuprows_t": TschuprowsT(num, bias_correction=False),
        "pearson": PearsonsContingencyCoefficient(num), "theils_u": TheilsU(num),
    })
    i0, j0 = spec["pair"]
    batch_launches, step_s = [], []
    for start in range(0, spec["rows"], spec["batch"]):
        before = bincount.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coll.update(data[start:start + spec["batch"], i0], data[start:start + spec["batch"], j0])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        batch_launches.append(bincount.launches - before)
    pair_values = coll.compute()
    groups = [list(g) for g in coll.compute_groups.values()]
    _check(len(groups) == 1 and len(groups[0]) == 4, f"{name}: compute groups {groups}, expected one of four")
    _check(all(n == 1 for n in batch_launches), f"{name}: bincount launches a batch {sorted(set(batch_launches))}")
    pair_table = torch.bincount(data[:, j0] * num + data[:, i0], minlength=num * num).view(num, num)
    _check(torch.equal(coll["cramers_v"].confmat, pair_table), f"{name}: the pair's int64 table differs from the plain count")

    # Fleiss' kappa over CIFAR-10H-shaped ratings
    fk = CIFAR10H
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    truth = torch.randint(0, fk["classes"], (fk["images"], 1), generator=g, device=dev)
    easy = 0.5 + 0.5 * torch.rand((fk["images"], 1), generator=g, device=dev)
    votes = torch.where(torch.rand((fk["images"], fk["raters"]), generator=g, device=dev) < easy, truth,
                        torch.randint(0, fk["classes"], (fk["images"], fk["raters"]), generator=g, device=dev))
    ratings = torch.nn.functional.one_hot(votes, fk["classes"]).sum(1)
    kappa = FleissKappa(mode="counts")
    for start in range(0, fk["images"], fk["batch"]):
        kappa.update(ratings[start:start + fk["batch"]])
    kappa_values = {"class": float(kappa.compute()), "functional": float(F.fleiss_kappa(ratings))}
    peak = torch.cuda.max_memory_allocated(dev)
    all_launches = {k: m.launches for k, m in counters.items()}

    # float64 references on the host
    pairs = list(itertools.combinations(range(spec["columns"]), 2))
    tables = dict(zip(pairs, _tables(data, pairs)))
    errs = {"cramers_v_corrected": 0.0, "theils_u": 0.0, "scipy": 0.0}
    min_corrected = 1.0
    for (i, j), t in tables.items():
        v = _cramers_v_corrected64(t)
        min_corrected = min(min_corrected, v)
        errs["cramers_v_corrected"] = max(errs["cramers_v_corrected"], abs(matrices["cramers_v_matrix"][i, j] - v), abs(matrices["cramers_v_matrix"][j, i] - v))
        errs["theils_u"] = max(errs["theils_u"], abs(matrices["theils_u_matrix"][i, j] - _theils_u64(t)),
                               abs(matrices["theils_u_matrix"][j, i] - _theils_u64(t.T)))
        if j < spec["subset"]:
            d = _drop_empty(t)
            for key, method in (("cramers_v_matrix_subset_plain", "cramer"), ("tschuprows_t_matrix_subset_plain", "tschuprow"),
                                ("pearsons_matrix_subset", "pearson")):
                errs["scipy"] = max(errs["scipy"], abs(matrices[key][i, j] - association(d, method=method)))
    d = _drop_empty(tables[(i0, j0)])
    pair_want = {"cramers_v": association(d, method="cramer"), "tschuprows_t": association(d, method="tschuprow"),
                 "pearson": association(d, method="pearson"), "theils_u": _theils_u64(tables[(i0, j0)])}
    errs["pair"] = max(abs(float(pair_values[k]) - v) for k, v in pair_want.items())
    r = ratings.double().cpu().numpy()
    raters = r.sum(1).max()
    p_i = r.sum(0) / (r.shape[0] * raters)
    p_j = ((r ** 2).sum(1) - raters) / (raters * (raters - 1))
    kappa64 = (p_j.mean() - (p_i ** 2).sum()) / (1 - (p_i ** 2).sum() + 1e-5)
    errs["fleiss_kappa"] = max(abs(v - kappa64) for v in kappa_values.values())
    for key, err in errs.items():
        _check(err <= NOMINAL_ATOL, f"{name}: {key} off float64 by {err} > {NOMINAL_ATOL}")
    for key in ("cramers_v_matrix", "theils_u_matrix"):
        _check(bool(np.isfinite(matrices[key]).all()), f"{name}: {key} is not finite")
    expected_launches = {
        "cramers_v_matrix": len(pairs), "theils_u_matrix": 2 * len(pairs),
        **{k: spec["subset"] * (spec["subset"] - 1) // 2 for k in matrices if k.endswith(("_plain", "_subset"))},
    }
    _check(launches == expected_launches, f"{name}: launches {launches}, expected {expected_launches}")
    update_s = sum(step_s)
    return _emit({
        "phase": name, "rows": spec["rows"], "columns": spec["columns"], "cardinalities": CENSUS_CARDS,
        "data_bytes": data_bytes, "reduced": ["synthetic columns with planted associations (the census rows are not in the repository)"],
        "pairs": len(pairs), "matrix_s": timings, "ms_a_pair_call": {k: 1e3 * timings[k] / launches[k] for k in timings},
        "matrix_launches": launches, "bincount_launches": all_launches["bincount"],
        "collection": {"batch": spec["batch"], "updates": len(step_s), "updates_per_s": len(step_s) / update_s,
                       "rows_per_s": spec["rows"] / update_s, "compute_groups": groups,
                       "values": {k: float(v) for k, v in pair_values.items()}},
        "fleiss_kappa": {**kappa_values, "float64": float(kappa64), "images": fk["images"], "raters": fk["raters"]},
        "min_corrected_cramers_v": min_corrected, "max_abs_err": errs, "atol": NOMINAL_ATOL,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base,
    })


# ------------------------------------------------------------------------- text

#: WikiText-2 raw test under GPT-2's tokenizer (287,644 tokens, vocabulary
#: 50,257), scored as the Hugging Face guide "Perplexity of fixed-length
#: models" scores it: windows of 1,024 tokens at stride 512, each window's
#: targets the tokens past the previous window's end (the rest
#: ignore_index=-100), 561 windows in 71 updates of 8 (the last padded with
#: -100); the target logit of every position raised by U(6, 10) over N(0, 1)
#: logits, so that perplexity is in the tens
WIKITEXT = {"tokens": 287_644, "vocab": 50_257, "window": 1_024, "stride": 512, "batch": 8, "boost": (6.0, 10.0)}
#: LibriSpeech test-clean: 2,620 utterances, 52,576 upper-case reference
#: words, batch 32; hypotheses with 3% of words substituted, 1% inserted, 1%
#: deleted; the character distances checked against Python on the first 128
LIBRISPEECH = {"utterances": 2_620, "words": 52_576, "batch": 32, "vocab": 8_000, "sub": 0.03, "ins": 0.01,
               "dele": 0.01, "char_subset": 128}
#: WMT14 English-German newstest2014: 3,003 German references of 21 words
#: on average, batch 128; hypotheses with 15% of words substituted, 5%
#: inserted, 5% deleted and a moved phrase in 30% of sentences. TER's shift
#: search and EED's DP are pure Python (6 and 7.5-10 ms a sentence on the
#: host of an H100 machine): they score the first 512 and 256 sentences
WMT14 = {"sentences": 3_003, "batch": 128, "vocab": 12_000, "mean_words": 21, "sub": 0.15, "ins": 0.05, "dele": 0.05,
         "move": 0.3, "ter_prefix": 512, "eed_prefix": 256}
#: CNN/DailyMail 3.0.0 test: 11,490 articles' highlights (3.75 sentences of
#: about 14 words), batch 64, system summaries with 35% of words
#: substituted; ROUGE-Lsum's union LCS is pure Python (0.7-1.3 ms an
#: article on the host of an H100 machine): it scores the first 2,048
#: articles; the native LCS and n-gram hits are held to Python over the
#: first 512
CNNDM = {"articles": 11_490, "batch": 64, "vocab": 20_000, "lsum_prefix": 2_048, "python_subset": 512}
#: SQuAD v1.1 dev: 10,570 questions with 1-6 reference answers of 1-5
#: words, batch 256
SQUAD = {"questions": 10_570, "batch": 256, "vocab": 6_000}
#: newstest2014's 3,003 pairs at roberta-large's width (1,024, vocabulary
#: 50,265: a seeded float32 table on the card, 206 MB) and
#: bert-base-uncased's vocabulary (30,522: seeded distributions on the card,
#: 367 MB a side), InfoLM at temperature 0.25
TEXT_MODELS = {"vocab": 50_265, "dim": 1_024, "mlm_vocab": 30_522, "temperature": 0.25}
#: values formed in other float32 orders (BLEU's exp and log, chrF's and
#: EED's means, ROUGE) against the functional over the whole corpus
TEXT_RTOL = 1e-6
#: BERTScore and InfoLM against float64 on the card (relative)
TEXT_MODEL_RTOL = 1e-5
INFOLM_MEASURES = (
    ("kl_divergence", {}), ("alpha_divergence", {"alpha": 0.5}), ("beta_divergence", {"beta": 0.5}),
    ("ab_divergence", {"alpha": 0.5, "beta": 0.5}), ("renyi_divergence", {"alpha": 0.5}), ("l1_distance", {}),
    ("l2_distance", {}), ("l_infinity_distance", {}), ("fisher_rao_distance", {}),
)


class _Lexicon:
    """A seeded vocabulary of random words drawn with Zipf weights (rank^-1.1)."""

    def __init__(self, seed: int, size: int, letters: str) -> None:
        import numpy as np

        self.rng = np.random.RandomState(seed)
        chars = list(letters)
        words: set = set()
        while len(words) < size:
            words.add("".join(self.rng.choice(chars, self.rng.randint(1, 11))))
        self.words = sorted(words)
        self.cdf = np.cumsum(1.0 / np.arange(1, size + 1) ** 1.1)

    def draw(self, n: int) -> list:
        import numpy as np

        picks = np.searchsorted(self.cdf, self.rng.random_sample(n) * self.cdf[-1], side="right")
        return [self.words[min(i, len(self.words) - 1)] for i in picks]

    def plant(self, words: list, sub: float, ins: float, dele: float, move: float = 0.0) -> list:
        """``words`` with planted substitutions, insertions, deletions and
        (with probability ``move``) one moved phrase."""
        out = []
        for w in words:
            r = self.rng.rand()
            if r < sub:
                out.append(self.draw(1)[0])
            elif r < sub + ins:
                out.extend([w, self.draw(1)[0]])
            elif r >= sub + ins + dele:
                out.append(w)
        if len(out) > 6 and self.rng.rand() < move:
            i, j = sorted(self.rng.choice(len(out), 2, replace=False))
            out = out[:i] + out[j:] + out[i:j]
        return out


def _zero_counters() -> dict:
    """The launch counters set to 0 and the seam's gate log cleared."""
    from torchmetrics_tpu_torch.ops import kernels

    counters = _launch_counters()
    for module in counters.values():
        module.launches = 0
    kernels.reset_gate_log()
    return counters


def _text_start() -> dict:
    """:func:`_zero_counters` before a text phase, whose native library must
    be loaded."""
    from torchmetrics_tpu_torch import native

    _check(native.native_available(), "the native text library did not build or load")
    return _zero_counters()


def _text_no_kernels(name: str, counters: dict) -> dict:
    """No kernel of the port launched in the phase (the counts and the gate log)."""
    from torchmetrics_tpu_torch.ops import kernels

    launches = {k: m.launches for k, m in counters.items()}
    gate = sorted(set(kernels.gate_snapshot()) & set(KERNELS))
    _check(not any(launches.values()) and not gate, f"{name}: a kernel of the port launched: {launches}, gate log {gate}")
    return launches


def _text_close(name: str, checks: dict, got, want, rtol) -> None:
    """``|got - want| <= rtol |want|``, elementwise (``rtol`` a number or one
    a value), both read to the host."""
    import numpy as np
    import torch

    got = np.asarray(torch.as_tensor(got).detach().double().cpu()).reshape(-1)
    want = np.asarray(torch.as_tensor(want).detach().double().cpu()).reshape(-1)
    rtol = np.asarray(torch.as_tensor(rtol).detach().double().cpu()).reshape(-1)
    _check(got.shape == want.shape, f"{name}: shape {got.shape} against {want.shape}")
    err = np.abs(got - want)
    bad = ~(err <= rtol * np.abs(want))
    _check(bool(np.isfinite(got).all()) and not bad.any(),
           f"{name}: {got[bad][:4].tolist()} against {want[bad][:4].tolist()} (max |d| {err.max()}, rtol {rtol.max()})")
    checks[name] = {"max_abs_err": float(err.max()) if err.size else 0.0, "max_rel_err": float((err / np.abs(want)).max()) if err.size else 0.0,
                    "rtol": float(rtol.max()), "n": int(got.size)}


def _timed_updates(metric, batches) -> list:
    """Update ``metric`` over ``batches`` (argument tuples); the host time of
    each update, ending in a synchronise."""
    import torch

    step_s = []
    for args in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return step_s


def _wikitext_windows() -> list:
    """``(begin, end, first_target)`` of every window of the guide's loop."""
    spec = WIKITEXT
    windows, prev_end = [], 0
    for begin in range(0, spec["tokens"], spec["stride"]):
        end = min(begin + spec["window"], spec["tokens"])
        windows.append((begin, end, prev_end))
        prev_end = end
        if end == spec["tokens"]:
            break
    return windows


def _wikitext_batch(i: int, stream, windows: list, dev):
    """Update ``i``: float32 logits (8, 1024, V) and aligned int64 targets,
    -100 before each window's first target and in padding."""
    import torch

    spec = WIKITEXT
    b, w, v = spec["batch"], spec["window"], spec["vocab"]
    target = torch.full((b, w), -100, dtype=torch.int64, device=dev)
    for k, (begin, end, first) in enumerate(windows[i * b : (i + 1) * b]):
        target[k, first - begin : end - begin] = stream[first:end]
    g = torch.Generator(device=dev).manual_seed(SEED + 13_000 + i)
    logits = torch.randn(b, w, v, generator=g, device=dev)
    lo, hi = spec["boost"]
    boost = lo + (hi - lo) * torch.rand(b * w, 1, generator=g, device=dev)
    logits.view(-1, v).scatter_add_(1, target.clamp_min(0).view(-1, 1), boost)
    return logits, target


def phase_wikitext2_perplexity(dev) -> dict:
    """WikiText-2 perplexity at GPT-2's vocabulary through ``Perplexity``:
    71 updates of (8, 1024, 50,257) float32 logits. The value against a
    float64 perplexity of the same logits on the card within the float32
    bound, the count equal to the unmasked tokens, an unmasked out-of-range
    target giving NaN with the CUDA context left alive; the update's time
    against its bytes bound, its temporaries and tokens/s."""
    import torch

    from torchmetrics_tpu_torch.text import Perplexity

    name, spec = "wikitext2_gpt2_perplexity", WIKITEXT
    counters = _text_start()
    windows = _wikitext_windows()
    updates = -(-len(windows) // spec["batch"])
    stream = torch.randint(0, spec["vocab"], (spec["tokens"],), generator=torch.Generator(device=dev).manual_seed(SEED + 12_999), device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    ppl = Perplexity(ignore_index=-100)
    total64 = torch.zeros((), dtype=torch.float64, device=dev)
    terms64 = torch.zeros((), dtype=torch.float64, device=dev)
    magnitude64 = torch.zeros((), dtype=torch.float64, device=dev)
    count = 0
    step_s, update_peaks, batch_bytes = [], [], 0
    for i in range(updates):
        logits, target = _wikitext_batch(i, stream, windows, dev)
        batch_bytes = logits.numel() * logits.element_size()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ppl.update(logits, target)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        update_peaks.append(torch.cuda.max_memory_allocated(dev) - before)
        # float64 of the same logits, row chunks of 1,024
        flat, tgt = logits.view(-1, spec["vocab"]), target.view(-1)
        mask = tgt != -100
        for s in range(0, flat.shape[0], 1024):
            chunk = flat[s : s + 1024].double()
            lse = torch.logsumexp(chunk, dim=1)
            tok = chunk.gather(1, tgt[s : s + 1024].clamp_min(0)[:, None]).squeeze(1)
            m = mask[s : s + 1024]
            total64 += (lse - tok)[m].sum()
            terms64 += (lse - tok).abs()[m].sum()
            magnitude64 += (1 + lse.abs() + tok.abs())[m].sum()
        count += int(mask.sum())
        del logits, target, flat, tgt, chunk
    t0 = time.perf_counter()
    value = ppl.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    launches = _text_no_kernels(name, counters)

    _check(count == spec["tokens"], f"{name}: {count} unmasked targets, expected {spec['tokens']}")
    _check(int(ppl.count) == count and ppl.count.dtype == torch.int32, f"{name}: counted {int(ppl.count)} ({ppl.count.dtype})")
    mean64 = float(total64) / count
    ppl64 = math.exp(mean64)
    # the float32 bound: the update's tree sum over 8,192 positions and the
    # running sum over updates (PERF.md section 2), plus each position's
    # log-sum-exp (a sum of V terms: ceil(log2 V) + 4 units of 2**-24 of its
    # magnitude), then exp's rounding
    sum_bound = _f32_rtol(updates, spec["batch"] * spec["window"]) * float(terms64)
    element_bound = (math.ceil(math.log2(spec["vocab"])) + 4) * 2.0**-24 * float(magnitude64)
    ppl_rtol = math.expm1((sum_bound + element_bound) / count) + 2.0**-23
    checks: dict = {}
    _text_close("perplexity", checks, value, ppl64, ppl_rtol)
    _check(5.0 < ppl64 < 100.0, f"{name}: perplexity {ppl64} is not in the tens")

    # an unmasked out-of-range target: NaN, and the context still runs
    g = torch.Generator(device=dev).manual_seed(SEED + 13_500)
    small = torch.randn(2, 4, 10, generator=g, device=dev)
    bad = torch.tensor([[0, 1, 2, 3], [4, 10, 6, -3]], device=dev)
    oob = Perplexity()
    oob.update(small, bad)
    nan_value = float(oob.compute())
    masked = Perplexity(ignore_index=10)
    masked.update(small, bad.clamp_min(0))
    masked_value = float(masked.compute())
    alive = int(torch.arange(5, device=dev).sum())
    torch.cuda.synchronize()
    _check(math.isnan(nan_value) and math.isfinite(masked_value) and alive == 10,
           f"{name}: out-of-range target gave {nan_value} (masked {masked_value}, context check {alive})")

    update_s = sum(step_s)
    step_ms = sorted(t * 1e3 for t in step_s)
    bound_ms = batch_bytes / HBM_BYTES_PER_S * 1e3
    return _emit({
        "phase": name, "tokens": spec["tokens"], "vocab": spec["vocab"], "windows": len(windows), "updates": updates,
        "logits_shape": [spec["batch"], spec["window"], spec["vocab"]], "logits_bytes": batch_bytes,
        "update_ms": {"min": step_ms[0], "p50": step_ms[updates // 2], "p90": step_ms[(9 * updates) // 10], "max": step_ms[-1]},
        "update_bytes_bound_ms": bound_ms, "p50_over_bound": step_ms[updates // 2] / bound_ms,
        "tokens_per_s": count / update_s, "positions_per_s": updates * spec["batch"] * spec["window"] / update_s,
        "positions_per_s_after_first": (updates - 1) * spec["batch"] * spec["window"] / sum(step_s[1:]),
        "compute_ms": compute_ms, "update_peak_above_inputs_bytes": max(update_peaks),
        "base_mem_bytes": base, "value": float(value), "float64": ppl64, "ppl_rtol": ppl_rtol,
        "count": count, "out_of_range": {"value": nan_value, "masked_value": masked_value, "context_alive": True},
        "launches": launches, "checks": checks,
    })


def _librispeech() -> tuple:
    """2,620 upper-case reference utterances of 52,576 words and their
    hypotheses."""
    spec = LIBRISPEECH
    lex = _Lexicon(SEED + 14_000, spec["vocab"], "ABCDEFGHIJKLMNOPQRSTUVWXYZ'")
    lengths = lex.rng.randint(4, 37, spec["utterances"])
    while lengths.sum() != spec["words"]:
        k = lex.rng.randint(spec["utterances"])
        lengths[k] = max(1, lengths[k] + (1 if lengths.sum() < spec["words"] else -1))
    refs = [lex.draw(int(n)) for n in lengths]
    hyps = [lex.plant(r, spec["sub"], spec["ins"], spec["dele"]) for r in refs]
    return [" ".join(r) for r in refs], [" ".join(h) for h in hyps]


def phase_librispeech_asr(dev) -> dict:
    """LibriSpeech test-clean through a collection of WER, CER, MER, WIL,
    WIP and EditDistance: every word distance of the native library against
    the Python DP, the character distances over a subset, the states equal
    to the exact counts and every rate within its float32 rounding of the
    ratio of those counts; utterances/s and the native calls' share."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch import MetricCollection, native
    from torchmetrics_tpu_torch.functional.text import helper
    from torchmetrics_tpu_torch.text import (
        CharErrorRate,
        EditDistance,
        MatchErrorRate,
        WordErrorRate,
        WordInfoLost,
        WordInfoPreserved,
    )

    name, spec = "librispeech_test_clean_asr", LIBRISPEECH
    refs, hyps = _librispeech()
    counters = _text_start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    coll = MetricCollection({
        "wer": WordErrorRate(), "cer": CharErrorRate(), "mer": MatchErrorRate(), "wil": WordInfoLost(),
        "wip": WordInfoPreserved(), "edit": EditDistance(),
    })
    native_s = [0.0]
    plain = helper.batch_edit_distance

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return plain(*args, **kwargs)
        finally:
            native_s[0] += time.perf_counter() - t0

    b = spec["batch"]
    helper.batch_edit_distance = timed
    try:
        step_s = _timed_updates(coll, ((hyps[s : s + b], refs[s : s + b]) for s in range(0, len(refs), b)))
        t0 = time.perf_counter()
        result = coll.compute()
        torch.cuda.synchronize()
        compute_ms = (time.perf_counter() - t0) * 1e3
    finally:
        helper.batch_edit_distance = plain
    peak = torch.cuda.max_memory_allocated(dev)
    launches = _text_no_kernels(name, counters)

    word_pairs = [(h.split(), r.split()) for h, r in zip(hyps, refs)]
    char_pairs = [(list(h), list(r)) for h, r in zip(hyps, refs)]
    word_d = native.batch_edit_distance(word_pairs)
    char_d = native.batch_edit_distance(char_pairs)
    t0 = time.perf_counter()
    _check(word_d.tolist() == [native._py_edit_distance(a, r) for a, r in word_pairs],
           f"{name}: a native word distance differs from the Python DP")
    sub = spec["char_subset"]
    _check(char_d[:sub].tolist() == [native._py_edit_distance(a, r) for a, r in char_pairs[:sub]],
           f"{name}: a native character distance differs from the Python DP")
    python_s = time.perf_counter() - t0

    n_ref = sum(len(r) for _, r in word_pairs)
    n_hyp = sum(len(h) for h, _ in word_pairs)
    n_max = sum(max(len(h), len(r)) for h, r in word_pairs)
    n_chars = sum(len(r) for _, r in char_pairs)
    errors, char_errors = int(word_d.sum()), int(char_d.sum())
    hits = n_max - errors
    _check(n_ref == spec["words"], f"{name}: {n_ref} reference words")
    exact_states = {
        ("wer", "errors"): errors, ("wer", "total"): n_ref, ("cer", "errors"): char_errors, ("cer", "total"): n_chars,
        ("mer", "total"): n_max, ("wil", "errors"): -hits, ("wil", "target_total"): n_ref,
        ("wil", "preds_total"): n_hyp, ("edit", "edit_scores"): char_errors, ("edit", "num_elements"): len(refs),
    }
    for (key, state), want in exact_states.items():
        got = getattr(coll[key], state)
        _check(float(got) == want, f"{name}: {key}.{state} is {float(got)}, the exact count {want}")
    wip = (hits / n_ref) * (hits / n_hyp)
    want = {"wer": errors / n_ref, "cer": char_errors / n_chars, "mer": errors / n_max, "wip": wip, "wil": 1 - wip,
            "edit": char_errors / len(refs)}
    # one rounding of a ratio of exact float32 counts: within one ulp; WIP
    # rounds two quotients and their product (3 units of 2**-24), WIL also 1 - WIP
    tol = {k: float(np.spacing(np.float32(v))) for k, v in want.items()}
    tol["wip"] = 3 * 2.0**-24 * wip
    tol["wil"] = 3 * 2.0**-24 * wip + 2.0**-24 * (1 - wip)
    errs = {k: abs(float(result[k]) - v) for k, v in want.items()}
    _check(all(errs[k] <= tol[k] for k in want), f"{name}: rates {errs} beyond {tol}")
    update_s = sum(step_s)
    return _emit({
        "phase": name, "utterances": len(refs), "reference_words": n_ref, "reference_chars": n_chars, "batch": b,
        "updates": len(step_s), "utterances_per_s": len(refs) / update_s, "update_s": update_s,
        "native_s": native_s[0], "native_share": native_s[0] / update_s, "compute_ms": compute_ms,
        "compute_groups": [list(g) for g in coll.compute_groups.values()],
        "values": {k: float(v) for k, v in result.items()}, "exact": want, "abs_err": errs, "tolerance": tol,
        "python_check_s": python_s, "char_subset": sub, "launches": launches,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base,
    })


def _wmt14(seed: int = SEED + 15_000) -> tuple:
    """3,003 German-like reference sentences (capitalised nouns, umlauts,
    commas, numbers, final marks) and their hypotheses."""
    spec = WMT14
    lex = _Lexicon(seed, spec["vocab"], "abcdefghijklmnopqrstuvwxyzäöüß")
    refs, hyps = [], []
    for _ in range(spec["sentences"]):
        n = int(min(90, max(2, round(lex.rng.gamma(2.2, spec["mean_words"] / 2.2)))))
        words = [w.capitalize() if lex.rng.rand() < 0.25 else w for w in lex.draw(n)]
        words[0] = words[0].capitalize()
        for k in range(len(words) - 1):
            r = lex.rng.rand()
            if r < 0.08:
                words[k] += ","
            elif r < 0.10:
                words[k] = str(lex.rng.randint(1, 3000))
        words[-1] += ".?!"[int(lex.rng.choice(3, p=[0.9, 0.06, 0.04]))]
        refs.append(words)
        hyps.append(lex.plant(words, spec["sub"], spec["ins"], spec["dele"], spec["move"]))
    return [" ".join(h) for h in hyps], [" ".join(r) for r in refs]


def phase_wmt14_mt(dev) -> dict:
    """newstest2014 En-De through SacreBLEU (13a), BLEU, chrF++ (sentence
    scores), TER (sentence scores) and EED, each class in batches of 128
    against its functional over the whole corpus (or the stated prefix):
    counts and edits bit for bit, scores within 1e-6, the sentence lists as
    long as the corpus."""
    import torch

    from torchmetrics_tpu_torch import functional as F
    from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_update, _SacreBLEUTokenizer, _tokenize_fn
    from torchmetrics_tpu_torch.functional.text.chrf import _chrf_score_compute, _chrf_score_update, _chrf_split
    from torchmetrics_tpu_torch.functional.text.ter import _ter_compute, _ter_sentence_scores, _ter_update, _TercomTokenizer
    from torchmetrics_tpu_torch.text import (
        BLEUScore,
        CHRFScore,
        ExtendedEditDistance,
        SacreBLEUScore,
        TranslationEditRate,
    )

    name, spec = "wmt14_ende_mt", WMT14
    hyps, refs = _wmt14()
    targets = [[r] for r in refs]
    counters = _text_start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = {
        "sacrebleu": (SacreBLEUScore(tokenize="13a"), len(hyps)),
        "bleu": (BLEUScore(), len(hyps)),
        "chrf++": (CHRFScore(n_word_order=2, return_sentence_level_score=True), len(hyps)),
        "ter": (TranslationEditRate(return_sentence_level_score=True), spec["ter_prefix"]),
        "eed": (ExtendedEditDistance(return_sentence_level_score=True), spec["eed_prefix"]),
    }
    b = spec["batch"]
    timing, values = {}, {}
    for key, (metric, n) in metrics.items():
        step_s = _timed_updates(metric, ((hyps[s : min(s + b, n)], targets[s : min(s + b, n)]) for s in range(0, n, b)))
        t0 = time.perf_counter()
        values[key] = metric.compute()
        torch.cuda.synchronize()
        timing[key] = {"sentences": n, "updates": len(step_s), "sentences_per_s": n / sum(step_s),
                       "update_s": sum(step_s), "compute_ms": (time.perf_counter() - t0) * 1e3}
    peak = torch.cuda.max_memory_allocated(dev)

    checks: dict = {}
    t0 = time.perf_counter()
    for key, tokenizer, functional in (
        ("sacrebleu", lambda s: _SacreBLEUTokenizer.tokenize(s, "13a"), lambda: F.sacre_bleu_score(hyps, targets, tokenize="13a")),
        ("bleu", _tokenize_fn, lambda: F.bleu_score(hyps, targets)),
    ):
        metric = metrics[key][0]
        p_len, t_len, num, den = _bleu_score_update(hyps, targets, 4, tokenizer)
        _check(metric.numerator.tolist() == [float(x) for x in num] and metric.denominator.tolist() == [float(x) for x in den]
               and float(metric.preds_len) == p_len and float(metric.target_len) == t_len,
               f"{name}: {key}'s counts differ from the functional's over the corpus")
        _text_close(key, checks, values[key], functional(), TEXT_RTOL)
    chrf = metrics["chrf++"][0]
    totals, sentences = _chrf_score_update(hyps, targets, 6, 2, 8.0, 2.0, False, False)
    stats = _chrf_split(torch.from_numpy(totals).to(dev), 6, 2)
    _check(all(torch.equal(getattr(chrf, k), v) for k, v in zip(chrf._TOTALS, stats)),
           f"{name}: chrF++'s n-gram totals differ from the functional's")
    _text_close("chrf++", checks, values["chrf++"][0], _chrf_score_compute(*stats, 8.0, 2.0), TEXT_RTOL)
    _check(values["chrf++"][1].shape == (len(hyps),) and values["chrf++"][1].tolist() == torch.tensor(sentences).tolist(),
           f"{name}: chrF++'s sentence scores differ ({values['chrf++'][1].shape[0]} of {len(hyps)})")
    n_ter = spec["ter_prefix"]
    edits, lengths = _ter_update(hyps[:n_ter], targets[:n_ter], _TercomTokenizer())
    ter = metrics["ter"][0]
    _check(float(ter.total_num_edits) == sum(edits) and float(ter.total_tgt_length) == sum(lengths),
           f"{name}: TER's edits {float(ter.total_num_edits)} against the functional's {sum(edits)}")
    want_ter = _ter_compute(*torch.tensor([sum(edits), sum(lengths)], dtype=torch.float32, device=dev))
    _text_close("ter", checks, values["ter"][0], want_ter, TEXT_RTOL)
    _check(torch.equal(values["ter"][1], _ter_sentence_scores(edits, lengths, dev)) and values["ter"][1].shape == (n_ter,),
           f"{name}: TER's sentence scores differ")
    n_eed = spec["eed_prefix"]
    eed_corpus, eed_sentences = F.extended_edit_distance(hyps[:n_eed], targets[:n_eed], return_sentence_level_score=True)
    _text_close("eed", checks, values["eed"][0], eed_corpus, TEXT_RTOL)
    _check(torch.equal(values["eed"][1], eed_sentences) and eed_sentences.shape == (n_eed,), f"{name}: EED's sentence scores differ")
    functional_s = time.perf_counter() - t0
    launches = _text_no_kernels(name, counters)
    return _emit({
        "phase": name, "sentences": len(hyps), "reference_words": sum(len(r.split()) for r in refs), "batch": b,
        "metrics": timing, "functional_s": functional_s,
        "values": {"sacrebleu": float(values["sacrebleu"]), "bleu": float(values["bleu"]), "chrf++": float(values["chrf++"][0]),
                   "ter": float(values["ter"][0]), "eed": float(values["eed"][0])},
        "sentence_scores": {"chrf++": int(values["chrf++"][1].shape[0]), "ter": n_ter, "eed": n_eed},
        "reduced": [f"TER over the first {n_ter} sentences and EED over the first {n_eed} (pure-Python shift search and DP)"],
        "checks": checks, "launches": launches, "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base,
    })


def _cnndm() -> tuple:
    """11,490 reference highlights (3-4 sentences) and system summaries."""
    spec = CNNDM
    lex = _Lexicon(SEED + 16_000, spec["vocab"], "abcdefghijklmnopqrstuvwxyz")
    refs, preds = [], []
    for _ in range(spec["articles"]):
        sentences = [lex.draw(int(max(4, round(lex.rng.gamma(4.0, 3.5))))) for _ in range(int(lex.rng.choice([3, 4], p=[0.25, 0.75])))]
        system = [lex.plant(s, 0.35, 0.1, 0.15) for s in sentences if lex.rng.rand() < 0.85] or [sentences[0]]
        refs.append(" ".join(" ".join(s).capitalize() + "." for s in sentences))
        preds.append(" ".join(" ".join(s).capitalize() + "." for s in system if s))
    return preds, refs


def phase_cnndm_rouge(dev) -> dict:
    """CNN/DailyMail through ROUGE-1, -2 and -L over the 11,490 articles and
    ROUGE-Lsum over the first 2,048, ``accumulate="best"``, batches of 64,
    each class against the functional over the same articles within 1e-6;
    the native LCS and n-gram hits against the Python bodies over the first
    512 articles' token pairs, bit for bit."""
    import torch

    from torchmetrics_tpu_torch import functional as F
    from torchmetrics_tpu_torch import native
    from torchmetrics_tpu_torch.functional.text.rouge import _normalize_and_tokenize_text
    from torchmetrics_tpu_torch.text import ROUGEScore

    name, spec = "cnndm_rouge", CNNDM
    preds, refs = _cnndm()
    counters = _text_start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    b, n_lsum = spec["batch"], spec["lsum_prefix"]
    runs = {
        "rouge1_2_L": (("rouge1", "rouge2", "rougeL"), len(preds)),
        "rougeLsum": (("rougeLsum",), n_lsum),
    }
    timing, checks, values = {}, {}, {}
    for key, (keys, n) in runs.items():
        metric = ROUGEScore(rouge_keys=keys, accumulate="best")
        step_s = _timed_updates(metric, ((preds[s : min(s + b, n)], refs[s : min(s + b, n)]) for s in range(0, n, b)))
        t0 = time.perf_counter()
        got = metric.compute()
        torch.cuda.synchronize()
        timing[key] = {"articles": n, "updates": len(step_s), "articles_per_s": n / sum(step_s), "update_s": sum(step_s),
                       "compute_ms": (time.perf_counter() - t0) * 1e3}
        want = F.rouge_score(preds[:n], refs[:n], accumulate="best", rouge_keys=keys)
        for k in want:
            _text_close(k, checks, got[k], want[k], TEXT_RTOL)
            values[k] = float(got[k])
    peak = torch.cuda.max_memory_allocated(dev)
    sub = spec["python_subset"]
    pairs = [(_normalize_and_tokenize_text(p), _normalize_and_tokenize_text(r)) for p, r in zip(preds[:sub], refs[:sub])]
    t0 = time.perf_counter()
    _check(native.batch_lcs(pairs).tolist() == [native._py_lcs(a, r) for a, r in pairs], f"{name}: a native LCS differs")
    hits = native.batch_ngram_hits_multi(pairs, [1, 2])
    for n in (1, 2):
        _check(list(zip(*(c.tolist() for c in hits[n]))) == [native._py_ngram_hits(a, r, n) for a, r in pairs],
               f"{name}: a native {n}-gram count differs")
    python_s = time.perf_counter() - t0
    launches = _text_no_kernels(name, counters)
    return _emit({
        "phase": name, "articles": len(preds), "batch": b, "runs": timing, "values": values,
        "reduced": [f"ROUGE-Lsum over the first {n_lsum} articles (its union LCS is pure Python)"],
        "python_subset": sub, "python_check_s": python_s, "checks": checks, "launches": launches,
        "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base,
    })


def _squad_norm(text: str) -> str:
    """SQuAD v1.1's answer normalisation: lower case, no punctuation, no
    articles, single spaces."""
    import re
    import string

    text = "".join(ch for ch in text.lower() if ch not in set(string.punctuation))
    return " ".join(re.sub(r"\b(a|an|the)\b", " ", text).split())


def _squad() -> tuple:
    """10,570 questions: 1-6 reference answers of 1-5 words (variants of one
    answer), and a prediction that is one answer reformatted, a partial
    overlap or unrelated."""
    spec = SQUAD
    lex = _Lexicon(SEED + 17_000, spec["vocab"], "abcdefghijklmnopqrstuvwxyz")
    preds, target = [], []
    for q in range(spec["questions"]):
        base = lex.draw(int(lex.rng.randint(1, 6)))
        answers = []
        for _ in range(int(lex.rng.choice(6, p=[0.1, 0.2, 0.45, 0.1, 0.1, 0.05])) + 1):
            words = list(base)
            if len(words) > 1 and lex.rng.rand() < 0.3:
                words = words[1:] if lex.rng.rand() < 0.5 else words[:-1]
            if lex.rng.rand() < 0.2:
                words = ["the"] + words
            answers.append(" ".join(words))
        r = lex.rng.rand()
        if r < 0.6:
            pred = answers[int(lex.rng.randint(len(answers)))]
            pred = (pred.upper() if lex.rng.rand() < 0.2 else pred) + ("." if lex.rng.rand() < 0.3 else "")
        elif r < 0.85:
            pred = " ".join(lex.plant(base, 0.3, 0.3, 0.1))
        else:
            pred = " ".join(lex.draw(int(lex.rng.randint(1, 5))))
        preds.append({"prediction_text": pred, "id": str(q)})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": str(q)})
    return preds, target


def phase_squad_v11(dev) -> dict:
    """SQuAD v1.1 dev through the SQuAD class in batches of 256 against the
    functional over the whole set: the exact-match sum and the count bit for
    bit and equal to an exact count made here, F1 within 1e-6."""
    import torch

    from torchmetrics_tpu_torch import functional as F
    from torchmetrics_tpu_torch.text import SQuAD

    name, spec = "squad_v11_dev", SQUAD
    preds, target = _squad()
    counters = _text_start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metric = SQuAD()
    b = spec["batch"]
    step_s = _timed_updates(metric, ((preds[s : s + b], target[s : s + b]) for s in range(0, len(preds), b)))
    got = metric.compute()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    want = F.squad(preds, target)
    exact = sum(
        any(_squad_norm(p["prediction_text"]) == _squad_norm(a) for a in t["answers"]["text"]) for p, t in zip(preds, target)
    )
    _check(float(metric.exact_match) == exact and int(metric.total) == len(preds),
           f"{name}: exact matches {float(metric.exact_match)} of {int(metric.total)}, counted {exact}")
    _check(float(got["exact_match"]) == float(want["exact_match"]), f"{name}: EM {float(got['exact_match'])} against {float(want['exact_match'])}")
    checks: dict = {}
    _text_close("f1", checks, got["f1"], want["f1"], TEXT_RTOL)
    launches = _text_no_kernels(name, counters)
    update_s = sum(step_s)
    return _emit({
        "phase": name, "questions": len(preds), "batch": b, "updates": len(step_s), "questions_per_s": len(preds) / update_s,
        "update_s": update_s, "values": {k: float(v) for k, v in got.items()}, "exact_matches": exact, "checks": checks,
        "launches": launches, "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base,
    })


def _token_ids(sentences: list, vocab: int):
    """Each word's id (crc32 mod ``vocab``), zero-padded, and the mask."""
    import zlib

    import numpy as np

    width = max(len(s.split()) for s in sentences)
    ids = np.zeros((len(sentences), width), dtype=np.int64)
    mask = np.zeros((len(sentences), width), dtype=bool)
    for i, s in enumerate(sentences):
        words = s.split()
        ids[i, : len(words)] = [zlib.crc32(w.encode()) % vocab for w in words]
        mask[i, : len(words)] = True
    return ids, mask


def _bertscore64(table, pred_ids, pred_mask, target_ids, target_mask, dev) -> tuple:
    """Greedy-matched P, R, F in float64 on the card, IDF over the reference
    ids from float64 logs."""
    import numpy as np
    import torch

    n = target_ids.shape[0]
    df: dict = {}
    for row, m in zip(target_ids, target_mask):
        for t in set(row[m].tolist()):
            df[t] = df.get(t, 0) + 1

    def idf(ids):
        return torch.tensor(np.vectorize(lambda t: math.log((n + 1) / (df.get(int(t), 0) + 1)))(ids), dtype=torch.float64, device=dev)

    def unit(ids):
        e = table.double()[torch.from_numpy(ids).to(dev)]
        return e / e.norm(dim=-1, keepdim=True)

    pm, tm_ = torch.from_numpy(pred_mask).to(dev), torch.from_numpy(target_mask).to(dev)
    sim = torch.bmm(unit(pred_ids), unit(target_ids).transpose(1, 2))
    sim = torch.where(pm[:, :, None] & tm_[:, None, :], sim, -1e9)
    pw, tw = idf(pred_ids) * pm, idf(target_ids) * tm_
    p = (sim.amax(2) * pw).sum(1) / pw.sum(1).clamp_min(1e-12)
    r = (sim.amax(1) * tw).sum(1) / tw.sum(1).clamp_min(1e-12)
    # the definition's clamp: where P + R <= 1e-12 (cosines of random
    # embeddings can be negative), F1 is 2PR / 1e-12
    return p, r, 2 * p * r / (p + r).clamp_min(1e-12)


def _infolm64(p, t, measure: str, kwargs: dict):
    """An information measure in float64 (NaN and inf replaced as
    ``nan_to_num`` replaces them)."""
    import torch

    a, b = kwargs.get("alpha", 0.0), kwargs.get("beta", 0.0)
    if measure == "beta_divergence":
        a = 1.0
    if measure == "kl_divergence":
        out = (t * torch.log(p / t)).sum(-1)
    elif measure == "alpha_divergence":
        out = (1 - (t**a * p ** (1 - a)).sum(-1)) / (a * (a - 1))
    elif measure in ("ab_divergence", "beta_divergence"):
        out = (torch.log((t ** (a + b)).sum(-1)) / (b * (a + b)) + torch.log((p ** (a + b)).sum(-1)) / (a * (a + b))
               - torch.log((t**a * p**b).sum(-1)) / (a * b))
    elif measure == "renyi_divergence":
        out = torch.log((t**a * p ** (1 - a)).sum(-1)) / (a - 1)
    elif measure == "l1_distance":
        out = (t - p).abs().sum(-1)
    elif measure == "l2_distance":
        out = ((t - p) ** 2).sum(-1).sqrt()
    elif measure == "l_infinity_distance":
        out = (t - p).abs().amax(-1)
    else:
        out = 2 * torch.arccos(torch.sqrt(p * t).sum(-1).clamp(0, 1))
    return torch.nan_to_num(out)


def phase_wmt14_bertscore_infolm(dev) -> dict:
    """newstest2014's pairs through BERTScore (``idf=True``) with a user
    model that looks embeddings up in a seeded 50,265 x 1,024 table on the
    card and returns ``(emb, mask, ids)`` as card tensors, and InfoLM with
    all nine measures on seeded 30,522-token distributions on the card: P,
    R, F and each measure against float64 on the card within 1e-5, no
    embedding or distribution read back to the host; compute time and peak
    memory."""
    import zlib

    import numpy as np
    import torch

    from torchmetrics_tpu_torch.functional.text import helper
    from torchmetrics_tpu_torch.text import BERTScore, InfoLM

    name, spec = "wmt14_bertscore_infolm", TEXT_MODELS
    hyps, refs = _wmt14()
    counters = _text_start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    table = torch.randn(spec["vocab"], spec["dim"], generator=torch.Generator(device=dev).manual_seed(SEED + 18_000), device=dev)
    returned = [0]

    def embedder(sentences):
        ids, mask = _token_ids(sentences, spec["vocab"])
        ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
        returned[0] += 1
        return table[ids_t], mask_t, ids_t

    def mlm(sentences):
        g = torch.Generator(device=dev).manual_seed(zlib.crc32("\n".join(sentences).encode()))
        d = torch.rand(len(sentences), spec["mlm_vocab"], generator=g, device=dev) ** 8 + 1e-4
        returned[0] += 1
        return d / d.sum(1, keepdim=True)

    host_reads: list = []
    plain_host, plain_on_device = sys.modules["torchmetrics_tpu_torch.functional.text.bert"]._host, helper._on_device

    def host(value):
        if isinstance(value, torch.Tensor):
            host_reads.append((str(value.dtype), value.numel()))
        return plain_host(value)

    def on_device(value, *args, **kwargs):
        out = plain_on_device(value, *args, **kwargs)
        if isinstance(value, torch.Tensor) and value.is_floating_point():
            _check(out is value, f"{name}: a model output was copied ({value.dtype} {tuple(value.shape)})")
        return out

    bert_module = sys.modules["torchmetrics_tpu_torch.functional.text.bert"]
    infolm_module = sys.modules["torchmetrics_tpu_torch.functional.text.infolm"]
    bert_module._host, bert_module._on_device = host, on_device
    infolm_module._on_device = on_device
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        bert = BERTScore(user_model=embedder, idf=True)
        b = WMT14["batch"]
        for s in range(0, len(hyps), b):
            bert.update(hyps[s : s + b], refs[s : s + b])
        t0 = time.perf_counter()
        got = bert.compute()
        torch.cuda.synchronize()
        bert_ms = (time.perf_counter() - t0) * 1e3
        bert_peak = torch.cuda.max_memory_allocated(dev) - base
        infolm_ms, measures = {}, {}
        torch.cuda.reset_peak_memory_stats(dev)
        for measure, kwargs in INFOLM_MEASURES:
            metric = InfoLM(information_measure=measure, temperature=spec["temperature"], user_model=mlm,
                            return_sentence_level_score=True, **kwargs)
            metric.update(hyps, refs)
            t0 = time.perf_counter()
            measures[measure] = metric.compute()
            torch.cuda.synchronize()
            infolm_ms[measure] = (time.perf_counter() - t0) * 1e3
        infolm_peak = torch.cuda.max_memory_allocated(dev) - base
    finally:
        bert_module._host, bert_module._on_device = plain_host, plain_on_device
        infolm_module._on_device = plain_on_device
    _check(all(dtype in ("torch.int64", "torch.bool") for dtype, _ in host_reads),
           f"{name}: read back to the host: {host_reads}")
    checks: dict = {}
    pred_ids, pred_mask = _token_ids(hyps, spec["vocab"])
    target_ids, target_mask = _token_ids(refs, spec["vocab"])
    want = _bertscore64(table, pred_ids, pred_mask, target_ids, target_mask, dev)
    # F1 divides by P + R, which cancels where the cosines are of both
    # signs: its tolerance scales by (|P| + |R|) / |P + R|
    cancel = ((want[0].abs() + want[1].abs()) / (want[0] + want[1]).abs()).clamp_min(1.0)
    for key, w, rtol in zip(("precision", "recall", "f1"), want, (TEXT_MODEL_RTOL, TEXT_MODEL_RTOL, TEXT_MODEL_RTOL * cancel)):
        _text_close(f"bertscore_{key}", checks, got[key], w, rtol)
    clamped = int(((want[0] + want[1]) <= 1e-12).sum())
    temperature = spec["temperature"]

    def sharpened(sentences):
        d = mlm(sentences).double() ** (1 / temperature)
        return d / d.sum(1, keepdim=True)

    p64, t64 = sharpened(hyps), sharpened(refs)
    for measure, kwargs in INFOLM_MEASURES:
        sentence64 = _infolm64(p64, t64, measure, kwargs)
        _text_close(f"infolm_{measure}", checks, measures[measure][0], sentence64.mean(), TEXT_MODEL_RTOL)
        _text_close(f"infolm_{measure}_sentences", checks, measures[measure][1], sentence64, TEXT_MODEL_RTOL)
    del p64, t64
    launches = _text_no_kernels(name, counters)
    return _emit({
        "phase": name, "pairs": len(hyps), "dim": spec["dim"], "vocab": spec["vocab"], "mlm_vocab": spec["mlm_vocab"],
        "table_bytes": table.numel() * table.element_size(),
        "bertscore": {"compute_ms": bert_ms, "peak_mem_above_base_bytes": bert_peak, "f1_clamped_pairs": clamped,
                      "median": {k: float(v.median()) for k, v in got.items()}},
        "infolm": {"compute_ms": infolm_ms, "peak_mem_above_base_bytes": infolm_peak,
                   "values": {k: float(v[0]) for k, v in measures.items()}},
        "host_reads": sorted(set(host_reads))[:4], "model_outputs_used_in_place": returned[0],
        "checks": checks, "launches": launches, "base_mem_bytes": base,
    })


# ------------------------------------------------------- audio and clustering

#: Libri2Mix test (Cosentino et al., 2020, "min" mode, 8 kHz): 3,000
#: two-speaker mixtures in batches of 8, each batch cropped to a common
#: length drawn from 3-15 s; then the first 256 mixtures of Libri3Mix test
#: (three speakers, the 3! permutation table). A separator's estimates leak
#: a share of the other speakers and noise, in a random speaker order. Cut:
#: SDR (filter 512) is held to scipy's float64 Toeplitz solve over the first
#: 64 mixtures (its FFTs of up to 2**18 points on the host cost about 10 ms
#: a signal), every other SDR only to be finite
LIBRI2MIX = {"mixtures": 3_000, "fs": 8_000, "batch": 8, "seconds": (3.0, 15.0), "filter_length": 512,
             "libri3mix": 256, "leak": (0.05, 0.35), "noise": (0.01, 0.1), "sdr_check": 64}
#: VoiceBank+DEMAND test (Valentini-Botinhao et al., 2016): 824 utterances
#: at 16 kHz, noisy at 2.5, 7.5, 12.5 and 17.5 dB SNR (coloured noise in
#: place of DEMAND's recordings); an enhancer's output keeps a fifth of the
#: noise's amplitude. Batches of 8 cropped to a common length drawn from
#: 1.5-5 s. Cut: PESQ (wb and nb) and the host STOI/ESTOI score the first
#: 64 utterances (about 35 ms a PESQ call and 25 ms a host STOI an utterance
#: on one core, each made twice: the class and its check)
VOICEBANK = {"utterances": 824, "fs": 16_000, "batch": 8, "seconds": (1.5, 5.0), "snrs": (2.5, 7.5, 12.5, 17.5),
             "residual": 0.2, "host_prefix": 64}
#: REVERB Challenge 2014 SimData evaluation set at 16 kHz (Kinoshita et
#: al., "A summary of the REVERB challenge", EURASIP J. Adv. Signal Process.
#: 2016:7, its data overview: 2,176 SimData evaluation utterances, WSJCAM0
#: sentences convolved with room impulse responses of three rooms, T60 0.25,
#: 0.5 and 0.7 s, plus noise at 20 dB SNR; test utterances about 6.9 s long
#: on average). The overview gives the mean length, not the spread: lengths
#: are drawn uniform on 2.0-11.8 s, whose mean is that 6.9 s; the memory
#: reckoning and the card against the CPU are also checked at both ends of
#: the range and at a length whose Hilbert transform takes Bluestein's
#: algorithm ("sweep"). The impulse responses here are exponentially
#: decaying noise at those T60s. Batches of 16 cropped to a common length.
#: Cuts: the host path scores the first 2 utterances (2-3 s a 7 s
#: utterance on one core; its class is held to its functional on their
#: first second); one utterance of every 4th batch is held to the CPU's
#: device path (0.1-0.25 s a 7 s utterance on the host)
REVERB = {"utterances": 2_176, "fs": 16_000, "batch": 16, "seconds": (2.0, 11.8), "t60": (0.25, 0.5, 0.7), "snr": 20.0,
          "host_prefix": 2, "sweep_seconds": (2.0, 6.9, 11.8), "cpu_check_every": 4}
#: ImageNet-1k validation clustered as SCAN (Van Gansbeke et al., ECCV 2020)
#: scores it: 50,000 samples of 1,000 classes (50 each) against 1,000
#: clusters, 30% of the assignments redrawn at random; 50,000 x 2,048 float32
#: embeddings (ResNet-50's pool width) as Gaussian clusters; batches of 1,000
IMAGENET_CLUSTERS = {"samples": 50_000, "classes": 1_000, "dim": 2_048, "reassigned": 0.3, "batch": 1_000, "spread": 0.5}
#: dB values of float32 sums against float64 (absolute)
AUDIO_DB_ATOL = 2e-3
#: STOI's device path against its host path (JAX's stated agreement), and
#: SRMR's (relative)
STOI_PATHS_ATOL = 1e-3
SRMR_PATHS_RTOL = 1e-3
#: a device path on the card against the same path on the CPU
DEVICE_PATH_ATOL = {"stoi": 1e-5, "srmr": 1e-4}
CLUSTER_RTOL = 1e-5
LABEL_METRICS = (
    ("MutualInfoScore", "mutual_info_score", 1), ("NormalizedMutualInfoScore", "normalized_mutual_info_score", 3),
    ("AdjustedMutualInfoScore", "adjusted_mutual_info_score", 3), ("RandScore", "rand_score", 1),
    ("AdjustedRandScore", "adjusted_rand_score", 1), ("FowlkesMallowsIndex", "fowlkes_mallows_index", 1),
    ("HomogeneityScore", "homogeneity_score", 3), ("CompletenessScore", "completeness_score", 3),
    ("VMeasureScore", "v_measure_score", 3),
)
EMBEDDING_METRICS = (("CalinskiHarabaszScore", "calinski_harabasz_score"), ("DaviesBouldinScore", "davies_bouldin_score"),
                     ("DunnIndex", "dunn_index"))


def _audio_start() -> dict:
    """:func:`_zero_counters` before an audio phase, whose PESQ library must
    be loaded."""
    from torchmetrics_tpu_torch import native

    _check(native.pesq_available(), f"the PESQ library did not build or load: {native.pesq_build_error()}")
    return _zero_counters()


class _Speech:
    """Speech-shaped sources made on the card from the two formant-
    synthesised 16 kHz clips of ``tests/fixtures_real/speech.npz``: a clip
    (decimated to ``fs``) read circularly from a random offset at a random
    rate of 0.8-1.25 (pitch and tempo scaled), linearly interpolated, with a
    gain of 0.3-1."""

    def __init__(self, fs: int, seed: int, dev) -> None:
        from pathlib import Path

        import numpy as np
        import torch

        speech = np.load(Path(__file__).resolve().parent / "tests" / "fixtures_real" / "speech.npz")
        step = int(speech["fs"]) // fs
        clips = np.stack([speech["clip1"][::step], speech["clip2"][::step]]).astype(np.float32)
        self.clips = torch.as_tensor(clips, device=dev)
        self.g = torch.Generator(device=dev).manual_seed(seed)
        self.rng = np.random.RandomState(seed)
        self.dev = dev

    def sources(self, count: int, length: int):
        import torch

        g, dev, n_clip = self.g, self.dev, self.clips.shape[1]
        which = torch.randint(0, 2, (count, 1), generator=g, device=dev)
        rate = 0.8 + 0.45 * torch.rand(count, 1, generator=g, device=dev)
        offset = torch.rand(count, 1, generator=g, device=dev) * n_clip
        gain = 0.3 + 0.7 * torch.rand(count, 1, generator=g, device=dev)
        pos = torch.remainder(offset + rate * torch.arange(length, device=dev, dtype=torch.float32)[None], n_clip)
        i0 = pos.floor().to(torch.int64).clamp(max=n_clip - 1)
        frac = pos - i0
        i1 = torch.remainder(i0 + 1, n_clip)
        return gain * (self.clips[which, i0] * (1 - frac) + self.clips[which, i1] * frac)

    def length(self, seconds: tuple, fs: int) -> int:
        return int(self.rng.uniform(*seconds) * fs)


def _hold_db(name: str, checks: dict, got, want, atol: float) -> None:
    """``|got - want| <= atol`` elementwise (dB), both read to the host."""
    import numpy as np
    import torch

    got = np.asarray(torch.as_tensor(got).detach().double().cpu()).reshape(-1)
    want = np.asarray(torch.as_tensor(want).detach().double().cpu()).reshape(-1)
    err = np.abs(got - want)
    _check(got.shape == want.shape and bool(np.isfinite(got).all()) and bool((err <= atol).all()),
           f"{name}: max |d| {err.max() if err.size else 0.0} beyond {atol}")
    entry = checks.setdefault(name, {"max_abs_err": 0.0, "atol": atol, "n": 0})
    entry["max_abs_err"] = max(entry["max_abs_err"], float(err.max()) if err.size else 0.0)
    entry["n"] += int(got.size)


# float64 references, written out from the definitions (float64 tensors on
# the card: the sums over up to 2.4M samples a pair are too slow in numpy
# for every batch)
_EPS32 = 1.1920928955078125e-07


def _si_sdr64(p, t, zero_mean: bool = False):
    import torch

    if zero_mean:
        p, t = p - p.mean(-1, keepdim=True), t - t.mean(-1, keepdim=True)
    alpha = ((p * t).sum(-1, keepdim=True) + _EPS32) / ((t * t).sum(-1, keepdim=True) + _EPS32)
    scaled = alpha * t
    return 10 * torch.log10(((scaled * scaled).sum(-1) + _EPS32) / (((scaled - p) ** 2).sum(-1) + _EPS32))


def _snr64(p, t):
    import torch

    return 10 * torch.log10(((t * t).sum(-1) + _EPS32) / (((t - p) ** 2).sum(-1) + _EPS32))


def _sa_sdr64(p, t):
    import torch

    alpha = ((p * t).sum((-2, -1), keepdim=True) + _EPS32) / ((t * t).sum((-2, -1), keepdim=True) + _EPS32)
    t = alpha * t
    return 10 * torch.log10(((t * t).sum((-2, -1)) + _EPS32) / (((t - p) ** 2).sum((-2, -1)) + _EPS32))


def _sdr64(p, t, filter_length: int):
    """SDR of float64 rows by scipy: FFT correlations and a Levinson Toeplitz solve."""
    import numpy as np
    from scipy.linalg import solve_toeplitz

    out = []
    n_fft = 2 ** math.ceil(math.log2(2 * p.shape[-1] - 1))
    for pp, tt in zip(p.reshape(-1, p.shape[-1]), t.reshape(-1, t.shape[-1])):
        tt, pp = tt / max(np.linalg.norm(tt), 1e-6), pp / max(np.linalg.norm(pp), 1e-6)
        tf = np.fft.rfft(tt, n_fft)
        r = np.fft.irfft(np.abs(tf) ** 2, n_fft)[:filter_length]
        b = np.fft.irfft(np.conj(tf) * np.fft.rfft(pp, n_fft), n_fft)[:filter_length]
        coh = b @ solve_toeplitz(r, b)
        out.append(10 * np.log10(coh / max(1 - coh, np.finfo(np.float64).eps)))
    return np.asarray(out).reshape(p.shape[:-1])


def _best_perm64(p, t):
    """Brute-force best speaker order by float64 SI-SDR (over every pair, then
    every order), and its margin over the runner-up (dB)."""
    import itertools

    import torch

    b, spk = t.shape[:2]
    pair = torch.stack([_si_sdr64(p, t[:, i : i + 1].expand_as(p)) for i in range(spk)], dim=1)  # (B, spk_t, spk_p)
    perms = torch.as_tensor(list(itertools.permutations(range(spk))), device=p.device)
    scores = pair[:, torch.arange(spk, device=p.device)[None, :], perms].mean(-1)  # (B, P)
    top = torch.topk(scores, 2, dim=1)
    return perms[top.indices[:, 0]], top.values[:, 0], top.values[:, 0] - top.values[:, 1]


def _mixture_batches(spec: dict, speech: "_Speech", count: int, spk: int, dev):
    """``(preds, target)`` batches of ``spk``-speaker mixtures: the target
    sources, and a separator's estimates in a random speaker order, each
    leaking the other speakers and noise."""
    import torch

    g = speech.g
    for start in range(0, count, spec["batch"]):
        b = min(spec["batch"], count - start)
        length = speech.length(spec["seconds"], spec["fs"])
        target = speech.sources(b * spk, length).reshape(b, spk, length)
        order = torch.argsort(torch.rand(b, spk, generator=g, device=dev), dim=1)
        est = torch.gather(target, 1, order[:, :, None].expand(-1, -1, length))
        lo, hi = spec["leak"]
        leak = lo + (hi - lo) * torch.rand(b, spk, 1, generator=g, device=dev)
        others = est.sum(1, keepdim=True) - est
        lo, hi = spec["noise"]
        noise = (lo + (hi - lo) * torch.rand(b, spk, 1, generator=g, device=dev)) * est.abs().amax(-1, keepdim=True)
        preds = est + leak * others / max(spk - 1, 1) + noise * torch.randn(est.shape, generator=g, device=dev)
        yield preds, target


def _timed(step_s: list, fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
    return out


def phase_libri2mix_separation(dev) -> dict:
    """Libri2Mix test (then the first 256 mixtures of Libri3Mix) through
    PIT with SI-SDR (speaker-wise, ``eval_func="max"``), and on the
    PIT-ordered estimates SA-SDR, SNR, SI-SNR and SDR at ``filter_length``
    512 (batched float64 Toeplitz solves on the card): every value against
    float64 numpy (SDR against scipy over the first 64 mixtures), PIT's
    order against a brute-force float64 search wherever the best order wins
    by more than 1e-3 dB, each class against its functional; updates/s,
    device time, peak memory."""
    import torch

    from torchmetrics_tpu_torch import audio
    from torchmetrics_tpu_torch.functional import audio as fa

    name, spec = "libri2mix_separation", LIBRI2MIX
    started = time.perf_counter()
    counters = _audio_start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    speech = _Speech(spec["fs"], SEED + 20_000, dev)
    checks: dict = {}
    results = {}
    for spk, count in ((2, spec["mixtures"]), (3, spec["libri3mix"])):
        metrics = {
            "pit_si_sdr": audio.PermutationInvariantTraining(fa.scale_invariant_signal_distortion_ratio, eval_func="max"),
            "sa_sdr": audio.SourceAggregatedSignalDistortionRatio(), "snr": audio.SignalNoiseRatio(),
            "si_snr": audio.ScaleInvariantSignalNoiseRatio(), "sdr": audio.SignalDistortionRatio(filter_length=spec["filter_length"]),
        }
        values = {k: [] for k in metrics}
        step_s, samples, ties, sdr_checked = [], 0, 0, 0
        for preds, target in _mixture_batches(spec, speech, count, spk, dev):

            def update():
                best, perm = fa.permutation_invariant_training(preds, target, fa.scale_invariant_signal_distortion_ratio)
                aligned = fa.pit_permutate(preds, perm)
                metrics["pit_si_sdr"].update(preds, target)
                for key in ("sa_sdr", "snr", "si_snr", "sdr"):
                    metrics[key].update(aligned, target)
                return best, perm, aligned

            best, perm, aligned = _timed(step_s, update)
            samples += preds.shape[0] * preds.shape[-1]
            # the functionals' values, for the classes and the float64 checks
            vals = {
                "pit_si_sdr": best, "sa_sdr": fa.source_aggregated_signal_distortion_ratio(aligned, target),
                "snr": fa.signal_noise_ratio(aligned, target), "si_snr": fa.scale_invariant_signal_noise_ratio(aligned, target),
                "sdr": fa.signal_distortion_ratio(aligned, target, filter_length=spec["filter_length"]),
            }
            for k, v in vals.items():
                values[k].append(v.reshape(-1))
            p64, t64, a64 = preds.double(), target.double(), aligned.double()
            perm64, best64, margin = _best_perm64(p64, t64)
            clear = margin > 1e-3
            ties += int((~clear).sum())
            _check(torch.equal(perm[clear], perm64[clear]), f"{name}: a PIT order differs from float64's")
            _hold_db(f"pit_si_sdr_{spk}spk", checks, best, best64, AUDIO_DB_ATOL)
            _hold_db("sa_sdr", checks, vals["sa_sdr"], _sa_sdr64(a64, t64), AUDIO_DB_ATOL)
            _hold_db("snr", checks, vals["snr"], _snr64(a64, t64), AUDIO_DB_ATOL)
            _hold_db("si_snr", checks, vals["si_snr"], _si_sdr64(a64, t64, zero_mean=True), AUDIO_DB_ATOL)
            _check(bool(torch.isfinite(vals["sdr"]).all()), f"{name}: a non-finite SDR")
            if spk == 2 and sdr_checked < spec["sdr_check"]:
                sdr64 = _sdr64(a64.cpu().numpy(), t64.cpu().numpy(), spec["filter_length"])
                _hold_db("sdr_512", checks, vals["sdr"], sdr64, AUDIO_DB_ATOL)
                sdr_checked += preds.shape[0]
        computed = {k: m.compute() for k, m in metrics.items()}
        for k, m in metrics.items():
            want = torch.cat(values[k]).double().mean()
            _check(int(m.total) == torch.cat(values[k]).numel() and m.total.dtype == torch.int64, f"{name}: {k}'s count")
            _check(abs(float(computed[k]) - float(want)) <= 1e-5 * max(1.0, abs(float(want))),
                   f"{name}: {k} class {float(computed[k])} against its functional {float(want)}")
        update_s = sum(step_s)
        results[f"{spk}spk"] = {
            "mixtures": count, "updates": len(step_s), "updates_per_s": len(step_s) / update_s, "update_s": update_s,
            "audio_s_per_s": samples / spec["fs"] / update_s / spk,
            "values": {k: float(v) for k, v in computed.items()}, "pit_near_ties": ties, "sdr_checked_mixtures": sdr_checked,
        }
    peak = torch.cuda.max_memory_allocated(dev)
    preds, target = next(_mixture_batches(spec, speech, spec["batch"], 2, dev))
    metrics = {"sdr": audio.SignalDistortionRatio(filter_length=spec["filter_length"]),
               "pit": audio.PermutationInvariantTraining(fa.scale_invariant_signal_distortion_ratio)}
    profile = _rest_idle_share(lambda i: [m.update(preds, target) for m in metrics.values()], 3)
    launches = _text_no_kernels(name, counters)
    return _emit({
        "phase": name, "source": "Libri2Mix test, min, 8 kHz (Cosentino et al. 2020); Libri3Mix test's first 256",
        "cuts": "SDR held to scipy over the first 64 mixtures", "results": results, "checks": checks,
        "profile_sdr_pit_batch": profile, "launches": launches, "base_mem_bytes": base,
        "peak_mem_above_base_bytes": peak - base, "phase_s": time.perf_counter() - started,
    })


def _coloured_noise(shape, alpha, g, dev):
    """Noise with a 1/f**alpha power spectrum a row (alpha (rows, 1))."""
    import torch

    n = shape[-1]
    white = torch.fft.rfft(torch.randn(shape, generator=g, device=dev), dim=-1)
    f = torch.arange(white.shape[-1], device=dev, dtype=torch.float32).clamp(min=1.0)
    noise = torch.fft.irfft(white * f[None, :] ** (-alpha / 2), n=n, dim=-1)
    return noise / noise.square().mean(-1, keepdim=True).sqrt()


def phase_voicebank_demand_enhancement(dev) -> dict:
    """VoiceBank+DEMAND test through PESQ (wb, nb), STOI and ESTOI on the
    host path and with ``on_device=True``, and SI-SDR: PESQ equal to the
    native library called directly on float64 copies (bit for bit after the
    float32 rounding), the two STOI paths within 1e-3, the device path on the
    card within 1e-5 of the same path on the CPU (the first batch), SI-SDR
    against float64, each class against its functional; updates/s, device
    time, peak memory and the host share of PESQ and STOI."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch import audio, native
    from torchmetrics_tpu_torch.functional import audio as fa

    name, spec = "voicebank_demand_enhancement", VOICEBANK
    started = time.perf_counter()
    counters = _audio_start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fs = spec["fs"]
    speech = _Speech(fs, SEED + 21_000, dev)
    g = speech.g
    host = {"pesq_wb": audio.PerceptualEvaluationSpeechQuality(fs, "wb"), "pesq_nb": audio.PerceptualEvaluationSpeechQuality(fs, "nb"),
            "stoi": audio.ShortTimeObjectiveIntelligibility(fs), "estoi": audio.ShortTimeObjectiveIntelligibility(fs, extended=True)}
    device = {"stoi_device": audio.ShortTimeObjectiveIntelligibility(fs, on_device=True),
              "estoi_device": audio.ShortTimeObjectiveIntelligibility(fs, extended=True, on_device=True),
              "si_sdr": audio.ScaleInvariantSignalDistortionRatio()}
    values = {k: [] for k in (*host, *device)}
    checks: dict = {}
    # one call of each host scorer outside the timing: the first pays scipy's imports
    warm = speech.sources(1, 3 * fs)
    fa.short_time_objective_intelligibility(warm, warm, fs)
    fa.perceptual_evaluation_speech_quality(warm, warm, fs, "wb")
    step_s, host_s, device_s = [], {k: 0.0 for k in host}, 0.0
    done = 0
    snrs = torch.as_tensor(spec["snrs"], device=dev)
    while done < spec["utterances"]:
        b = min(spec["batch"], spec["utterances"] - done)
        length = speech.length(spec["seconds"], fs)
        clean = speech.sources(b, length)
        alpha = 1.5 * torch.rand(b, 1, generator=g, device=dev)
        snr = snrs[torch.randint(0, len(spec["snrs"]), (b,), generator=g, device=dev)][:, None]
        noise = _coloured_noise((b, length), alpha, g, dev) * clean.square().mean(-1, keepdim=True).sqrt() * 10 ** (-snr / 20)
        enhanced = clean + spec["residual"] * noise
        in_prefix = done < spec["host_prefix"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if in_prefix:
            for k, m in host.items():
                t1 = time.perf_counter()
                m.update(enhanced, clean)
                host_s[k] += time.perf_counter() - t1
        t1 = time.perf_counter()
        for m in device.values():
            m.update(enhanced, clean)
        torch.cuda.synchronize()
        device_s += time.perf_counter() - t1
        step_s.append(time.perf_counter() - t0)
        vals = {"stoi_device": fa.short_time_objective_intelligibility(enhanced, clean, fs, on_device=True),
                "estoi_device": fa.short_time_objective_intelligibility(enhanced, clean, fs, True, on_device=True),
                "si_sdr": fa.scale_invariant_signal_distortion_ratio(enhanced, clean)}
        _hold_db("si_sdr", checks, vals["si_sdr"], _si_sdr64(enhanced.double(), clean.double()), AUDIO_DB_ATOL)
        c64, e64 = clean.double().cpu().numpy(), enhanced.double().cpu().numpy()
        if done == 0:
            for key, ext in (("stoi_device", False), ("estoi_device", True)):
                cpu = fa.short_time_objective_intelligibility(enhanced.cpu(), clean.cpu(), fs, ext, on_device=True)
                _hold_db(f"{key}_card_vs_cpu", checks, vals[key], cpu.numpy(), DEVICE_PATH_ATOL["stoi"])
        if in_prefix:
            # PESQ from the library's own call on float64 copies: the class's
            # sum is held to it, and the functional to it on the first batch
            for key, wide in (("pesq_wb", True), ("pesq_nb", False)):
                vals[key] = torch.as_tensor(native.pesq_batch(c64, e64, fs, wide).astype(np.float32))
                if done == 0:
                    got = fa.perceptual_evaluation_speech_quality(enhanced, clean, fs, key[-2:])
                    _check(got.cpu().numpy().tobytes() == vals[key].numpy().tobytes(), f"{name}: {key} differs from the library's own call")
            vals["stoi"] = fa.short_time_objective_intelligibility(enhanced, clean, fs)
            vals["estoi"] = fa.short_time_objective_intelligibility(enhanced, clean, fs, True)
            _hold_db("stoi_paths", checks, vals["stoi_device"], vals["stoi"].cpu().numpy(), STOI_PATHS_ATOL)
            _hold_db("estoi_paths", checks, vals["estoi_device"], vals["estoi"].cpu().numpy(), STOI_PATHS_ATOL)
        for k, v in vals.items():
            values[k].append(v.reshape(-1))
        done += b
    checks["pesq_bit_equal_to_the_library"] = True
    computed = {k: m.compute() for k, m in {**host, **device}.items()}
    for k, v in computed.items():
        want = torch.cat([x.cpu() for x in values[k]]).double()
        want = want[~want.isnan()].mean()
        _check(abs(float(v) - float(want)) <= 1e-5 * max(1.0, abs(float(want))), f"{name}: {k} class {float(v)} against its functional {float(want)}")
    peak = torch.cuda.max_memory_allocated(dev)
    update_s = sum(step_s)
    prefix_updates = -(-spec["host_prefix"] // spec["batch"])
    clean = speech.sources(spec["batch"], int(3.25 * fs))
    enhanced = clean + spec["residual"] * _coloured_noise(clean.shape, torch.ones(spec["batch"], 1, device=dev), g, dev) * 0.1
    profile = _rest_idle_share(lambda i: [m.update(enhanced, clean) for m in device.values()], 3)
    launches = _text_no_kernels(name, counters)
    return _emit({
        "phase": name, "source": "VoiceBank+DEMAND test, 824 utterances, 16 kHz (Valentini-Botinhao et al. 2016)",
        "cuts": f"PESQ and the host STOI/ESTOI over the first {spec['host_prefix']} utterances; coloured noise for DEMAND's",
        "utterances": done, "updates": len(step_s), "updates_per_s": len(step_s) / update_s, "update_s": update_s,
        "host_s": host_s, "device_path_s": device_s,
        "host_share_of_prefix_updates": sum(host_s.values()) / sum(step_s[:prefix_updates]),
        "host_ms_per_utterance": {k: v / spec["host_prefix"] * 1e3 for k, v in host_s.items()},
        "device_path_ms_per_utterance": device_s / done * 1e3,
        "values": {k: float(v) for k, v in computed.items()}, "checks": checks,
        "profile_device_batch_3p25s": profile, "launches": launches, "base_mem_bytes": base,
        "peak_mem_above_base_bytes": peak - base, "phase_s": time.perf_counter() - started,
    })


def _reverberant(speech: "_Speech", spec: dict, b: int, length: int, dev):
    """``b`` utterances convolved with exponentially decaying noise impulse
    responses at the rooms' T60s (FFT convolution), plus noise at the stated SNR."""
    import torch

    g, fs = speech.g, spec["fs"]
    clean = speech.sources(b, length)
    t60 = torch.as_tensor(spec["t60"], device=dev)[torch.randint(0, len(spec["t60"]), (b,), generator=g, device=dev)][:, None]
    taps = int(max(spec["t60"]) * fs)
    t = torch.arange(taps, device=dev, dtype=torch.float32)[None] / fs
    rir = torch.randn(b, taps, generator=g, device=dev) * torch.exp(-6.908 * t / t60)
    rir[:, 0] = 1.0
    n = 1 << (length + taps - 2).bit_length()  # a power of two past the linear length: few cuFFT plans
    wet = torch.fft.irfft(torch.fft.rfft(clean, n=n) * torch.fft.rfft(rir, n=n), n=n)[:, :length]
    noise = torch.randn(wet.shape, generator=g, device=dev) * wet.square().mean(-1, keepdim=True).sqrt() * 10 ** (-spec["snr"] / 20)
    return wet + noise


def _srmr_peak_ratio(srmr, dev, before: int, length: int, b: int, fs: int) -> float:
    """The peak above ``before`` since the last reset, over the device path's
    reckoning for a chunk of this batch (``_device_bytes_per_signal`` times
    the signals a chunk holds)."""
    import torch

    per_signal = srmr._device_bytes_per_signal(length, fs, 23)
    chunk = min(b, max(1, srmr.DEVICE_BUDGET_BYTES // per_signal))
    return (torch.cuda.max_memory_allocated(dev) - before) / (per_signal * chunk)


def phase_reverb_srmr(dev) -> dict:
    """REVERB Challenge 2014 SimData evaluation utterances through SRMR with
    ``on_device=True`` (all of them) and on the host path (a prefix): the
    two paths within 1e-3 relative (the prefix); the device path on the card
    within 1e-4 of the same path on the CPU on one utterance of every 4th
    batch and at the sweep's lengths; every update's peak memory within the
    path's reckoning; the class's sums against its functional (the checked
    batches); updates/s, device time, and at the sweep's lengths the first
    call's time (new cuFFT plans) beside a cached call's."""
    import torch

    from torchmetrics_tpu_torch import audio
    from torchmetrics_tpu_torch.functional import audio as fa
    from torchmetrics_tpu_torch.functional.audio import srmr

    name, spec = "reverb_srmr", REVERB
    started = time.perf_counter()
    counters = _audio_start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    fs = spec["fs"]
    speech = _Speech(fs, SEED + 22_000, dev)
    device_metric = audio.SpeechReverberationModulationEnergyRatio(fs, on_device=True)
    host_metric = audio.SpeechReverberationModulationEnergyRatio(fs)
    checks: dict = {"card_vs_cpu_max_rel_err": 0.0, "card_vs_cpu_bluestein_max_rel_err": 0.0, "card_vs_cpu_n": 0,
                    "class_vs_functional_max_rel_err": 0.0}
    step_s, host_s, done, ratios, seconds, cpu_s = [], 0.0, 0, [], 0.0, 0.0

    def hold_cpu(vals, wet, j: int, length: int) -> None:
        # utterance j of the card's device path against the CPU's
        nonlocal cpu_s
        t0 = time.perf_counter()
        cpu = fa.speech_reverberation_modulation_energy_ratio(wet[j : j + 1].cpu(), fs, on_device=True).double()
        cpu_s += time.perf_counter() - t0
        rel = float((vals[j].double().cpu() - cpu).abs().max() / cpu.abs().min())
        _check(rel <= DEVICE_PATH_ATOL["srmr"], f"{name}: card and CPU device paths {rel} apart at length {length}")
        checks["card_vs_cpu_max_rel_err"] = max(checks["card_vs_cpu_max_rel_err"], rel)
        checks["card_vs_cpu_n"] += 1
        if srmr._bluestein(srmr._hilbert_length(length)):
            checks["card_vs_cpu_bluestein_max_rel_err"] = max(checks["card_vs_cpu_bluestein_max_rel_err"], rel)

    while done < spec["utterances"]:
        b = min(spec["batch"], spec["utterances"] - done)
        length = speech.length(spec["seconds"], fs)
        wet = _reverberant(speech, spec, b, length, dev)
        checked = len(step_s) % spec["cpu_check_every"] == 0
        before_sum = float(device_metric.msum) if checked else 0.0
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _timed(step_s, lambda: device_metric.update(wet))
        ratio = _srmr_peak_ratio(srmr, dev, before, length, b, fs)
        _check(ratio <= 1.0, f"{name}: an update's peak {ratio:.3f}x its reckoning at length {length}")
        ratios.append([length, ratio])
        seconds += b * length / fs
        if checked:
            # the class's sum grew by the functional's scores; one of them against the CPU
            vals = fa.speech_reverberation_modulation_energy_ratio(wet, fs, on_device=True)
            _check(bool(torch.isfinite(vals).all()) and bool((vals > 0).all()), f"{name}: a non-finite or non-positive SRMR")
            after_sum, want = float(device_metric.msum), float(vals.double().sum())
            # float32: the batch's sum of b scores, then the running sum
            rel = abs(after_sum - before_sum - want) / want
            _check(rel * want <= 2.0**-24 * (b * want + 2 * after_sum),
                   f"{name}: the class's sum grew {after_sum - before_sum}, its functional's {want}")
            checks["class_vs_functional_max_rel_err"] = max(checks["class_vs_functional_max_rel_err"], rel)
            hold_cpu(vals, wet, (len(step_s) // spec["cpu_check_every"]) % b, length)
        if done == 0:
            # the device path against the host path (a prefix); the host class
            # against its functional on the prefix's first second
            prefix = wet[: spec["host_prefix"]]
            t0 = time.perf_counter()
            host_vals = fa.speech_reverberation_modulation_energy_ratio(prefix, fs).double().cpu()
            host_s += time.perf_counter() - t0
            dev_vals = vals[: prefix.shape[0]].double().cpu()
            rel = ((dev_vals - host_vals).abs() / host_vals).numpy()
            _check(bool((rel <= SRMR_PATHS_RTOL).all()), f"{name}: device and host paths {rel.max()} apart")
            checks["paths_max_rel_err"] = float(rel.max())
            host_metric.update(prefix[:, :fs])
            got, want = float(host_metric.compute()), float(fa.speech_reverberation_modulation_energy_ratio(prefix[:, :fs], fs).double().mean())
            _check(abs(got - want) <= 1e-5 * abs(want), f"{name}: host class {got} against its functional {want}")
        done += b
    total = float(device_metric.compute())
    _check(math.isfinite(total) and total > 0 and int(device_metric.total) == done, f"{name}: the mean SRMR {total} over {int(device_metric.total)}")
    update_s = sum(step_s)

    # the sweep: both ends of the length range and a Bluestein Hilbert length
    # near the mean, a full batch each on new cuFFT plans, then cached
    sweep = []
    for sec in spec["sweep_seconds"]:
        length = int(sec * fs)
        if sec not in spec["seconds"]:
            while not srmr._bluestein(srmr._hilbert_length(length)):
                length += 1
        wet = _reverberant(speech, spec, spec["batch"], length, dev)
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        first: list = []
        vals = _timed(first, lambda: fa.speech_reverberation_modulation_energy_ratio(wet, fs, on_device=True))
        ratio = _srmr_peak_ratio(srmr, dev, before, length, spec["batch"], fs)
        _check(ratio <= 1.0, f"{name}: the sweep's peak {ratio:.3f}x its reckoning at length {length}")
        cached: list = []
        _timed(cached, lambda: fa.speech_reverberation_modulation_energy_ratio(wet, fs, on_device=True))
        hold_cpu(vals, wet, 0, length)
        hold_cpu(vals, wet, spec["batch"] - 1, length)
        sweep.append({"length": length, "bluestein_hilbert": srmr._bluestein(srmr._hilbert_length(length)),
                      "first_ms": first[0] * 1e3, "cached_ms": cached[0] * 1e3, "peak_ratio": ratio})

    wet = _reverberant(speech, spec, spec["batch"], int(6.9 * fs), dev)
    profile = _rest_idle_share(lambda i: device_metric.update(wet), 3)
    launches = _text_no_kernels(name, counters)
    bluestein = [r for r in ratios if srmr._bluestein(srmr._hilbert_length(r[0]))]
    return _emit({
        "phase": name, "source": "REVERB Challenge 2014 SimData evaluation set (Kinoshita et al., 2016): 2,176 utterances, "
        "16 kHz, mean 6.9 s",
        "cuts": f"host path over the first {spec['host_prefix']} utterances; lengths uniform on {spec['seconds']} s; "
        "exponential-decay RIRs",
        "utterances": done, "audio_s": seconds, "updates": len(step_s), "updates_per_s": len(step_s) / update_s,
        "update_s": update_s, "device_audio_s_per_s": seconds / update_s, "bluestein_updates": len(bluestein),
        "host_s_per_utterance": host_s / spec["host_prefix"], "cpu_check_s": cpu_s,
        "values": {"device": total, "host_prefix": float(host_vals.mean()), "device_prefix": float(dev_vals.mean())},
        "checks": checks, "device_budget_bytes": srmr.DEVICE_BUDGET_BYTES,
        "max_peak_ratio": max(r for _, r in ratios), "peak_ratio_by_update": ratios, "sweep": sweep,
        "profile_batch_6p9s": profile, "launches": launches, "base_mem_bytes": base,
        "phase_s": time.perf_counter() - started,
    })


def _clusters(spec: dict, dev):
    """ImageNet-shaped labels (50 a class, shuffled), cluster assignments
    with a share redrawn at random, and Gaussian embeddings around per-class
    centres, on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 23_000)
    n, k, d = spec["samples"], spec["classes"], spec["dim"]
    target = torch.arange(k, device=dev).repeat_interleave(n // k)[torch.randperm(n, generator=g, device=dev)]
    redraw = torch.rand(n, generator=g, device=dev) < spec["reassigned"]
    perm = torch.randperm(k, generator=g, device=dev)  # cluster ids are a permutation of the classes
    preds = torch.where(redraw, torch.randint(0, k, (n,), generator=g, device=dev), perm[target])
    centres = torch.randn(k, d, generator=g, device=dev)
    data = centres[target] + spec["spread"] * torch.randn(n, d, generator=g, device=dev)
    return preds, target, data


def _emi64(cont: "np.ndarray") -> float:
    """The expected mutual information of the table's margins in float64,
    from its definition (sklearn's sum over the hypergeometric cells, with
    scipy's ``gammaln``), summed once for each distinct pair of row and
    column sums and weighted by how many pairs share it."""
    import numpy as np
    from scipy.special import gammaln

    n = int(cont.sum())
    a_vals, a_count = np.unique(cont.sum(1), return_counts=True)
    b_vals, b_count = np.unique(cont.sum(0), return_counts=True)
    a, b = a_vals[:, None, None].astype(np.float64), b_vals[None, :, None].astype(np.float64)
    nij = np.arange(1, int(min(a_vals.max(), b_vals.max())) + 1, dtype=np.float64)[None, None, :]
    inside = (nij >= np.maximum(1.0, a + b - n)) & (nij <= np.minimum(a, b))
    # the log of each cell's probability, clipped to a finite argument outside its support
    log_p = (gammaln(a + 1) + gammaln(b + 1) + gammaln(n - a + 1) + gammaln(n - b + 1) - gammaln(n + 1) - gammaln(nij + 1)
             - gammaln(np.maximum(a - nij, 0) + 1) - gammaln(np.maximum(b - nij, 0) + 1)
             - gammaln(np.maximum(n - a - b + nij, 0) + 1))
    terms = np.where(inside, nij / n * (np.log(n * nij) - np.log(a) - np.log(b)) * np.exp(np.where(inside, log_p, 0.0)), 0.0)
    return float((terms.sum(-1) * a_count[:, None] * b_count[None, :]).sum())


def _label_scores64(cont: "np.ndarray", emi: float) -> dict:
    """The nine label scores in float64 from the exact table (sklearn's definitions)."""
    import numpy as np

    n = cont.sum()
    a, b = cont.sum(1), cont.sum(0)
    nz = cont > 0
    mi = float(np.sum(cont[nz] / n * (np.log(n) + np.log(cont[nz]) - np.log(a[:, None] * b[None, :])[nz])))

    def entropy(x):
        p = x[x > 0] / n
        return float(-(p * np.log(p)).sum())

    h_t, h_p = entropy(a), entropy(b)
    ss = float((cont.astype(np.float64) ** 2).sum())
    cols, rows = float((b.astype(np.float64) ** 2).sum()), float((a.astype(np.float64) ** 2).sum())
    tp, fp, fn = ss - n, cols - ss, rows - ss
    tn = float(n) ** 2 - fp - fn - ss
    homogeneity, completeness = mi / h_t, mi / h_p
    return {
        "mutual_info_score": mi, "normalized_mutual_info_score": mi / ((h_t + h_p) / 2),
        "adjusted_mutual_info_score": (mi - emi) / ((h_t + h_p) / 2 - emi),
        "rand_score": (tp + tn) / (tp + tn + fp + fn),
        "adjusted_rand_score": 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)),
        "fowlkes_mallows_index": tp / math.sqrt(cols - n) / math.sqrt(rows - n),
        "homogeneity_score": homogeneity, "completeness_score": completeness,
        "v_measure_score": 2 * homogeneity * completeness / (homogeneity + completeness),
    }


def _embedding_scores64(data, labels, k: int) -> dict:
    """Calinski-Harabasz, Davies-Bouldin and Dunn in float64 on the card,
    unchunked (``torch.cdist`` for the centroid distances)."""
    import torch

    x = data.double()
    n = x.shape[0]
    counts = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(0, labels, torch.ones(n, dtype=torch.float64, device=x.device))
    centroids = torch.zeros(k, x.shape[1], dtype=torch.float64, device=x.device).index_add_(0, labels, x) / counts[:, None]
    resid = x - centroids[labels]
    within = float(resid.square().sum())
    between = float((counts * (centroids - x.mean(0)).square().sum(1)).sum())
    dist = resid.square().sum(1).sqrt()
    intra = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(0, labels, dist) / counts
    cd = torch.cdist(centroids, centroids)
    ratio = (intra[None] + intra[:, None]) / cd.fill_diagonal_(float("inf"))
    radius = torch.zeros(k, dtype=torch.float64, device=x.device).scatter_reduce(0, labels, dist, "amax", include_self=False)
    return {
        "calinski_harabasz_score": between * (n - k) / (within * (k - 1)),
        "davies_bouldin_score": float(ratio.amax(1).mean()),
        "dunn_index": float(cd.min() / radius.max()),
    }


def phase_imagenet_clustering(dev) -> dict:
    """ImageNet-1k validation clustered (SCAN's scoring): the nine label
    metrics over 50 batches of labels against cluster assignments, each
    contingency one 1,000,000-bin ``bincount`` launch (the launch counter
    held to the count the metrics imply: 19 for the nine computes), the
    table equal to an int64 numpy count, every value within 1e-5 of float64
    from that table; Calinski-Harabasz, Davies-Bouldin (chunked centroid
    distances) and Dunn on the 50,000 x 2,048 embeddings within 1e-5 of
    float64 on the card; each class against its functional; updates/s,
    compute ms, peak memory."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch import clustering
    from torchmetrics_tpu_torch.functional import clustering as fc
    from torchmetrics_tpu_torch.functional.clustering import utils
    from torchmetrics_tpu_torch.ops import bincount, kernels

    name, spec = "imagenet_clustering", IMAGENET_CLUSTERS
    started = time.perf_counter()
    preds, target, data = _clusters(spec, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    label_metrics = {fn: getattr(clustering, cls)() for cls, fn, _ in LABEL_METRICS}
    embedding_metrics = {fn: getattr(clustering, cls)() for cls, fn in EMBEDDING_METRICS}
    counters = _zero_counters()
    step_s = []
    batch = spec["batch"]
    for s in range(0, spec["samples"], batch):
        def update():
            for m in label_metrics.values():
                m.update(preds[s : s + batch], target[s : s + batch])
            for m in embedding_metrics.values():
                m.update(data[s : s + batch], target[s : s + batch])

        _timed(step_s, update)
    compute_ms, computed, launches_per = {}, {}, {}
    for fn, m in {**label_metrics, **embedding_metrics}.items():
        before = bincount.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        computed[fn] = m.compute()
        torch.cuda.synchronize()
        compute_ms[fn] = (time.perf_counter() - t0) * 1e3
        launches_per[fn] = bincount.launches - before
    launches = {k: mod.launches for k, mod in counters.items()}
    expected = {fn: count for _, fn, count in LABEL_METRICS}
    _check(all(launches_per[fn] == expected.get(fn, 0) for fn in launches_per), f"{name}: bincount launches {launches_per} against {expected}")
    _check(launches["bincount"] == sum(expected.values()) and sum(v for k, v in launches.items() if k != "bincount") == 0,
           f"{name}: launches {launches}")
    gate = kernels.gate_snapshot()["bincount"]
    _check(gate["selections"] == {"cuda": sum(expected.values())}, f"{name}: gate log {gate['selections']}")
    peak = torch.cuda.max_memory_allocated(dev)

    # the contingency against an int64 numpy count, bit for bit
    p_np, t_np = preds.cpu().numpy(), target.cpu().numpy()
    cont = utils.calculate_contingency_matrix(preds, target)
    _, p_idx = np.unique(p_np, return_inverse=True)
    _, t_idx = np.unique(t_np, return_inverse=True)
    cont64 = np.bincount(t_idx * cont.shape[1] + p_idx, minlength=cont.numel()).reshape(cont.shape)
    _check(np.array_equal(cont.cpu().numpy(), cont64), f"{name}: the contingency differs from numpy's count")
    # AMI's expected mutual information from its definition, apart from the port's chunked host sum
    t0 = time.perf_counter()
    emi = _emi64(cont64)
    emi_s = time.perf_counter() - t0
    want = _label_scores64(cont64, emi)
    want.update(_embedding_scores64(data, target, spec["classes"]))
    checks = {}
    for fn, v in computed.items():
        err = abs(float(v) - want[fn])
        _check(err <= CLUSTER_RTOL * max(1.0, abs(want[fn])), f"{name}: {fn} {float(v)} against float64 {want[fn]}")
        inputs = (data, target) if fn in embedding_metrics else (preds, target)
        functional = getattr(fc, fn)(*inputs)
        _check(abs(float(functional) - float(v)) <= 1e-6 * max(1.0, abs(float(v))), f"{name}: {fn} class against its functional")
        checks[fn] = {"value": float(v), "float64": want[fn], "abs_err": err}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    fc.davies_bouldin_score(data, target)
    torch.cuda.synchronize()
    db_peak = torch.cuda.max_memory_allocated(dev) - before
    update_s = sum(step_s)
    return _emit({
        "phase": name, "source": "ImageNet-1k val as SCAN (ECCV 2020) scores clustering: 50,000 samples, 1,000 clusters",
        "cuts": "synthetic labels (30% redrawn) and Gaussian embeddings at ResNet-50's 2,048 width",
        "updates": len(step_s), "updates_per_s": len(step_s) / update_s, "update_s": update_s, "compute_ms": compute_ms,
        "emi_float64_reference_s": emi_s, "checks": checks, "launches": launches, "bincount_launches": launches["bincount"],
        "bincount_launches_per_compute": launches_per, "contingency_bins": cont.numel(),
        "base_mem_bytes": base, "peak_mem_above_base_bytes": peak - base, "davies_bouldin_peak_above_inputs_bytes": db_peak,
        "phase_s": time.perf_counter() - started,
    })


# ------------------------------------- detection, segmentation, multimodal

#: COCO 2017 val box detection (``instances_val2017.json``: 5,000 images, 80
#: categories, 36,781 annotations, about 1% ``iscrowd``); object sizes split
#: as the COCO detection-eval page gives them ("41% small, 34% medium, 24%
#: large"; the remaining 1% drawn large); 100 detections an image (the
#: eval's ``maxDets``). Stated choices, not from the source: images of 640 x
#: 480; annotations spread over images and categories uniformly; areas
#: log-uniform within each size range and aspect ratios log-uniform on
#: 0.5-2; 90% of ground truths found (jittered by 8% of their size, 10%
#: relabelled) and the rest of the 100 false positives; scores at three
#: decimals, so ties occur across images.
COCO_DET = {"images": 5_000, "categories": 80, "annotations": 36_781, "crowd": 0.01, "dets": 100,
            "split": (0.41, 0.34), "width": 640, "height": 480, "batch": 50, "cpu_prefix": 500,
            "found": 0.9, "jitter": 0.08, "relabel": 0.1}
#: mask mAP over the first 200 of the same images at 640 x 480 (cut: 200 of
#: 5,000 images, about 21,000 masks of 307,200 pixels; the CPU check over
#: the first 8); each mask the ellipse inscribed in its box (a stated choice)
COCO_SEGM = {"images": 200, "cpu_prefix": 8}
#: COCO panoptic val2017's category ids (``panoptic_coco_categories.json``):
#: 80 things and 53 stuffs; 0 is unlabeled (void)
COCO_THINGS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 27, 28, 31, 32,
               33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59,
               60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90)
COCO_STUFFS = (92, 93, 95, 100, 107, 109, 112, 118, 119, 122, 125, 128, 130, 133, 138, 141, 144, 145, 147, 148, 149,
               151, 154, 155, 156, 159, 161, 166, 168, 171, 175, 176, 177, 178, 180, 181, 184, 185, 186, 187, 188, 189,
               190, 191, 192, 193, 194, 195, 196, 197, 198, 199, 200)
#: COCO panoptic val2017: 5,000 images at 640 x 480 in batches of 8. Stated
#: choices: stuff regions a 6 x 8 grid of stuff categories, 0-15 thing
#: instances an image (ellipses); predictions shifted by up to 2 pixels,
#: 16 x 16 blocks relabelled with probability 3%, 1% of pixels an unknown
#: category (201); 2% of target pixels unlabeled (0, void). The numpy check
#: over the first 2 batches.
COCO_PANOPTIC = {"images": 5_000, "batch": 8, "height": 480, "width": 640, "grid": (6, 8), "things": 16,
                 "shift": 2, "block": 16, "relabel": 0.03, "unknown": 0.01, "void": 0.02, "unknown_id": 201,
                 "numpy_batches": 2}
#: BraTS 2021 validation's shape: 219 cases of 240 x 240 x 155 at 1 mm.
#: Stated choices: one tumour a case, an ellipsoid of radii 8-28 mm whose
#: surface is perturbed by low-frequency ripples; the prediction its
#: centre moved by 2 mm and radii by 10%. Cuts: the scipy checks over the
#: first 4 cases; surface distances over the tumour-bearing axial slices
#: of the first 2.
BRATS = {"cases": 219, "shape": (240, 240, 155), "radii": (8.0, 28.0), "scipy_cases": 4, "slice_cases": 2}
#: CLIPScore over the Karpathy test split of COCO (5,000 images, 5 captions
#: each), 100 images (500 pairs) an update; CLIP-IQA over KonIQ-10k
#: (10,073 images of 1024 x 768) in batches of 64, with the default prompt
#: and with prompt pairs. Both on a seeded two-tower stand-in at CLIP
#: ViT-B/32's widths (224 x 224 input, 32-pixel patches, a 768-wide patch
#: embedding, 512-wide outputs, a 49,408-token vocabulary, 77-token
#: contexts), not CLIP: no CLIP weights are in the repository. Its towers
#: add one shared direction to their unit outputs, so that caption scores
#: are positive; captions are synthetic words, hashed to token ids.
KARPATHY = {"images": 5_000, "captions": 5, "batch": 100}
KONIQ = {"images": 10_073, "height": 768, "width": 1024, "batch": 64,
         "pairs": ("quality", ("Sharp photo.", "Blurry photo."), ("A well-lit photo.", "A dim photo."))}
CLIP_B32 = {"image": 224, "patch": 32, "width": 768, "embed": 512, "vocab": 49_408, "context": 77}
DET_TOL = 1e-6
IOU64_ATOL = 1e-5
PQ_RTOL = 1e-6
EDT_ATOL = 1e-5
CLIP_RTOL = 1e-5


def _peak_above(dev, base: int) -> int:
    import torch

    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) - base


def _coco_boxes(n: int, g, spec: dict, dev):
    """``n`` xyxy float32 boxes in the image, their sizes split as COCO's."""
    import torch

    w_img, h_img = spec["width"], spec["height"]
    u = torch.rand(n, generator=g, device=dev)
    small, medium = spec["split"]
    lo = torch.where(u < small, 16.0, torch.where(u < small + medium, 32.0**2, 96.0**2))
    hi = torch.where(u < small, 32.0**2, torch.where(u < small + medium, 96.0**2, 0.6 * w_img * h_img))
    area = torch.exp(torch.log(lo) + torch.rand(n, generator=g, device=dev) * (torch.log(hi) - torch.log(lo)))
    aspect = torch.exp((torch.rand(n, generator=g, device=dev) * 2 - 1) * math.log(2.0))
    w = torch.sqrt(area * aspect).clamp(max=w_img - 1)
    h = (area / w).clamp(max=h_img - 1)
    x1 = torch.rand(n, generator=g, device=dev) * (w_img - w)
    y1 = torch.rand(n, generator=g, device=dev) * (h_img - h)
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=1)


def _coco_detection(spec: dict, dev) -> dict:
    """Ground truths and 100 detections an image, on the card, as per-image
    lists of dicts (views of a few flat tensors)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 31_000)
    n_img, n_ann, k = spec["images"], spec["annotations"], spec["dets"]
    things = torch.tensor(COCO_THINGS, device=dev)
    ann_img = torch.sort(torch.randint(0, n_img, (n_ann,), generator=g, device=dev)).values
    gt_boxes = _coco_boxes(n_ann, g, spec, dev)
    gt_labels = things[torch.randint(0, spec["categories"], (n_ann,), generator=g, device=dev)]
    crowd = torch.rand(n_ann, generator=g, device=dev) < spec["crowd"]
    n_gt = torch.bincount(ann_img, minlength=n_img)
    gt_first = torch.cumsum(n_gt, 0) - n_gt
    slot = torch.arange(k, device=dev).repeat(n_img)
    det_img = torch.arange(n_img, device=dev).repeat_interleave(k)
    src = (gt_first[det_img] + slot).clamp(max=n_ann - 1)
    found = (slot < n_gt[det_img]) & (torch.rand(n_img * k, generator=g, device=dev) < spec["found"])
    size = (gt_boxes[src, 2:] - gt_boxes[src, :2]).repeat(1, 2)
    jittered = gt_boxes[src] + spec["jitter"] * size * torch.randn(n_img * k, 4, generator=g, device=dev)
    jittered = torch.cat([jittered[:, :2], torch.maximum(jittered[:, 2:], jittered[:, :2] + 1)], dim=1)
    det_boxes = torch.where(found[:, None], jittered, _coco_boxes(n_img * k, g, spec, dev))
    relabel = torch.rand(n_img * k, generator=g, device=dev) < spec["relabel"]
    random_labels = things[torch.randint(0, spec["categories"], (n_img * k,), generator=g, device=dev)]
    det_labels = torch.where(found & ~relabel, gt_labels[src], random_labels)
    score = torch.where(found, 0.4 + 0.6 * torch.rand(n_img * k, generator=g, device=dev),
                        0.6 * torch.rand(n_img * k, generator=g, device=dev))
    score = torch.round(score * 1000) / 1000
    counts = n_gt.tolist()
    gts = zip(gt_boxes.split(counts), gt_labels.split(counts), crowd.split(counts))
    target = [{"boxes": b, "labels": lab, "iscrowd": c} for b, lab, c in gts]
    preds = [{"boxes": b, "labels": lab, "scores": s}
             for b, lab, s in zip(det_boxes.split(k), det_labels.split(k), score.split(k))]
    perfect = [{"boxes": t["boxes"], "labels": t["labels"], "scores": torch.ones_like(t["labels"], dtype=torch.float32)}
               for t in target]
    return {"preds": preds, "target": target, "perfect": perfect, "annotations": n_ann,
            "crowds": int(crowd.sum()), "max_gt_an_image": max(counts)}


def _to_cpu(items) -> list:
    return [{k: v.cpu() for k, v in d.items()} for d in items]


def _iou64(p, t, kind: str):
    """The IoU family in float64 numpy over ``(N, 4)`` and ``(M, 4)`` boxes
    (the JAX package's formulas and epsilons)."""
    import numpy as np

    eps = 1e-7
    a1 = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1])
    a2 = (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])
    wh = np.clip(np.minimum(p[:, None, 2:], t[None, :, 2:]) - np.maximum(p[:, None, :2], t[None, :, :2]), 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[:, None] + a2[None, :] - inter
    iou = inter / (union + eps)
    if kind == "iou":
        return iou
    hull = np.clip(np.maximum(p[:, None, 2:], t[None, :, 2:]) - np.minimum(p[:, None, :2], t[None, :, :2]), 0, None)
    if kind == "giou":
        area = hull[..., 0] * hull[..., 1]
        return iou - (area - union) / (area + eps)
    diag = hull[..., 0] ** 2 + hull[..., 1] ** 2 + eps
    d = (p[:, None, :2] + p[:, None, 2:]) / 2 - (t[None, :, :2] + t[None, :, 2:]) / 2
    diou = iou - (d[..., 0] ** 2 + d[..., 1] ** 2) / diag
    if kind == "diou":
        return diou
    v = (4 / np.pi**2) * (np.arctan((t[:, 2] - t[:, 0]) / (t[:, 3] - t[:, 1] + eps))[None, :]
                          - np.arctan((p[:, 2] - p[:, 0]) / (p[:, 3] - p[:, 1] + eps))[:, None]) ** 2
    return diou - v / (1 - iou + v + eps) * v


def _timed_compute(metric, dev) -> tuple:
    """``metric.compute()`` timed on the host clock, with the peak above the
    memory allocated before it."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    value = metric.compute()
    torch.cuda.synchronize()
    return value, (time.perf_counter() - t0) * 1e3, _peak_above(dev, base)


def _compute_ms(metric) -> tuple:
    """``metric.compute()`` and its host-clock ms (the peak statistics left
    running for the phase's own peak)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = metric.compute()
    torch.cuda.synchronize()
    return value, (time.perf_counter() - t0) * 1e3


def _map_breakdown(metric) -> dict:
    """One more compute with the pair build and each chunk's matcher timed
    (synchronised around them): their ms beside the whole compute's and
    the device part's (pairs, overlaps, matching, the read-back)."""
    import torch

    from torchmetrics_tpu_torch.detection import mean_ap

    spent = {"pairs": 0.0, "matcher": 0.0, "device": 0.0, "chunks": 0}
    cls = type(metric)
    build, match, greedy = cls._build_pairs, cls._match, mean_ap._greedy_match

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += (time.perf_counter() - t0) * 1e3
            spent["chunks"] += key == "matcher"
            return out
        return wrapper

    cls._build_pairs, cls._match, mean_ap._greedy_match = timed("pairs", build), timed("device", match), timed("matcher", greedy)
    try:
        metric._computed = None
        t0 = time.perf_counter()
        metric.compute()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        cls._build_pairs, cls._match, mean_ap._greedy_match = build, match, greedy
    return {"compute_ms": total, "pair_build_ms": spent["pairs"], "matcher_ms": spent["matcher"],
            "device_part_ms": spent["device"], "host_accumulate_ms": total - spent["device"],
            "matcher_share": spent["matcher"] / total, "host_share": (total - spent["device"]) / total,
            "chunks": spent["chunks"]}


def _hold_dicts(name: str, got: dict, want: dict, tol: float) -> float:
    """Every entry of two summary dicts equal in shape and within ``tol``."""
    import torch

    _check(sorted(got) == sorted(want), f"{name}: keys {sorted(got)} against {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        gv, wv = got[k].detach().double().cpu(), w.detach().double().cpu()
        _check(gv.shape == wv.shape, f"{name}: {k} shape {tuple(gv.shape)} against {tuple(wv.shape)}")
        err = float((gv - wv).abs().max()) if gv.numel() else 0.0
        _check(err <= tol and bool(torch.isfinite(gv).all()), f"{name}: {k} {gv.tolist()} against {wv.tolist()}")
        worst = max(worst, err)
    return worst


def phase_coco_val2017_bbox(dev) -> dict:
    """COCO 2017 val box detection (``COCO_DET``): ``MeanAveragePrecision(
    iou_type="bbox", class_metrics=True)`` over the 5,000 images in updates
    of 50, and the four IoU classes. Hard checks: the summary dict on the
    card equals the port's on the CPU over the first 500 images within 1e-6;
    a perfect detector over all 5,000 images scores ``map`` 1.0; each IoU
    class within 1e-5 of a float64 numpy IoU of the same boxes; the
    compute's peak under the metric's reckoning; no kernel launch. Reports
    images/s, compute ms (pair build, matcher, host accumulation), the
    peak and the idle share of the card over one compute."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch import detection

    name, spec = "coco_val2017_bbox", COCO_DET
    started = time.perf_counter()
    sections = {}

    def lap(label: str) -> None:
        sections[label] = time.perf_counter() - started - sum(sections.values())

    data = _coco_detection(spec, dev)
    preds, target, batch = data["preds"], data["target"], spec["batch"]
    counters = _zero_counters()
    metric = detection.MeanAveragePrecision(iou_type="bbox", class_metrics=True)
    step_s = []
    for s in range(0, spec["images"], batch):
        _timed(step_s, lambda: metric.update(preds[s : s + batch], target[s : s + batch]))
    reckoned = metric._reckoned_peak_bytes()
    print(json.dumps({"phase": name, "reckoned_compute_peak_bytes": reckoned}), flush=True)
    result, compute_ms, peak = _timed_compute(metric, dev)
    _check(peak <= reckoned, f"{name}: the compute's peak {peak} above its reckoning {reckoned}")
    breakdown = _map_breakdown(metric)
    launches = _text_no_kernels(name, counters)
    lap("generate_update_compute")

    # the card against the CPU over a prefix
    n = spec["cpu_prefix"]
    card = detection.MeanAveragePrecision(iou_type="bbox", class_metrics=True)
    card.update(preds[:n], target[:n])
    cpu = detection.MeanAveragePrecision(iou_type="bbox", class_metrics=True, device="cpu")
    cpu.update(_to_cpu(preds[:n]), _to_cpu(target[:n]))
    t0 = time.perf_counter()
    cpu_result = cpu.compute()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    prefix_err = _hold_dicts(f"{name} card against the CPU", card.compute(), cpu_result, DET_TOL)
    lap("cpu_prefix")

    perfect = detection.MeanAveragePrecision(iou_type="bbox")
    for s in range(0, spec["images"], batch):
        perfect.update(data["perfect"][s : s + batch], target[s : s + batch])
    perfect_map = float(perfect.compute()["map"])
    _check(perfect_map == 1.0, f"{name}: a perfect detector scores map {perfect_map}")
    lap("perfect")

    # the IoU classes against float64 numpy
    ious, iou_checks = {}, {}
    for cls_name, kind in (("IntersectionOverUnion", "iou"), ("GeneralizedIntersectionOverUnion", "giou"),
                           ("DistanceIntersectionOverUnion", "diou"), ("CompleteIntersectionOverUnion", "ciou")):
        m = getattr(detection, cls_name)()
        iou_steps = []
        for s in range(0, spec["images"], batch):
            _timed(iou_steps, lambda: m.update(preds[s : s + batch], target[s : s + batch]))
        value, ms, _ = _timed_compute(m, dev)
        ious[cls_name] = {"value": float(value[kind]), "images_per_s": spec["images"] / sum(iou_steps), "compute_ms": ms}
    lap("iou_classes")
    total, count = {k: 0.0 for k in ("iou", "giou", "diou", "ciou")}, 0
    for p, t in zip(preds, target):
        pb, tb = p["boxes"].double().cpu().numpy(), t["boxes"].double().cpu().numpy()
        same = p["labels"].cpu().numpy()[:, None] == t["labels"].cpu().numpy()[None, :]
        count += int(same.sum())
        for kind in total:
            total[kind] += float(_iou64(pb, tb, kind)[same].sum())
    for cls_name, kind in zip(ious, total):
        want = total[kind] / count
        err = abs(ious[cls_name]["value"] - want)
        _check(err <= IOU64_ATOL, f"{name}: {cls_name} {ious[cls_name]['value']} against float64 {want}")
        iou_checks[cls_name] = {"float64": want, "abs_err": err}
    lap("iou_float64")
    idle = _rest_idle_share(lambda i: (setattr(metric, "_computed", None), metric.compute()), 1)
    lap("profile")
    update_s = sum(step_s)
    return _emit({
        "phase": name, "source": "COCO 2017 val (instances_val2017): 5,000 images, 80 categories, 36,781 annotations; "
        "the detection-eval page's 41% small, 34% medium, 24% large; maxDets 100",
        "cuts": "synthetic boxes (stated choices in COCO_DET); the CPU check over the first 500 images",
        "annotations": data["annotations"], "crowds": data["crowds"], "max_gt_an_image": data["max_gt_an_image"],
        "updates": len(step_s), "images_per_s": spec["images"] / update_s, "update_s": update_s,
        "compute_ms": compute_ms, "breakdown": breakdown, "peak_above_states_bytes": peak, "reckoned_bytes": reckoned,
        "peak_over_reckoning": peak / reckoned, "map": float(result["map"]), "map_50": float(result["map_50"]),
        "mar_100": float(result["mar_100"]), "cpu_prefix_images": n, "cpu_prefix_max_abs_err": prefix_err,
        "cpu_prefix_compute_ms": cpu_ms, "perfect_map": perfect_map, "iou_classes": ious, "iou_float64": iou_checks,
        "compute_idle": idle, "launches": launches, "sections_s": sections, "phase_s": time.perf_counter() - started,
    })


def _ellipse_masks(boxes, h: int, w: int):
    """The ellipse inscribed in each xyxy box, as ``(N, h, w)`` bool."""
    import torch

    ys = torch.arange(h, device=boxes.device, dtype=torch.float32)[None, :, None] + 0.5
    xs = torch.arange(w, device=boxes.device, dtype=torch.float32)[None, None, :] + 0.5
    cx, cy = ((boxes[:, 0] + boxes[:, 2]) / 2)[:, None, None], ((boxes[:, 1] + boxes[:, 3]) / 2)[:, None, None]
    rx, ry = ((boxes[:, 2] - boxes[:, 0]) / 2)[:, None, None], ((boxes[:, 3] - boxes[:, 1]) / 2)[:, None, None]
    return ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1


def phase_coco_val2017_segm(dev) -> dict:
    """Mask mAP (``iou_type="segm"``) over the first 200 images of the same
    detections (``COCO_SEGM``), each box's inscribed ellipse at 640 x 480.
    Hard checks: the summary dict equals the port's on the CPU over the
    first 8 images within 1e-6; the compute's peak under the reckoning; no
    kernel launch. Reports the compute ms and its breakdown, the peak."""
    import torch

    from torchmetrics_tpu_torch import detection

    name, spec = "coco_val2017_segm", COCO_SEGM
    started = time.perf_counter()
    boxes = _coco_detection(COCO_DET, dev)
    h, w = COCO_DET["height"], COCO_DET["width"]
    preds = [{"masks": _ellipse_masks(p["boxes"], h, w), "scores": p["scores"], "labels": p["labels"]}
             for p in boxes["preds"][: spec["images"]]]
    target = [{"masks": _ellipse_masks(t["boxes"], h, w), "labels": t["labels"], "iscrowd": t["iscrowd"]}
              for t in boxes["target"][: spec["images"]]]
    del boxes
    counters = _zero_counters()
    metric = detection.MeanAveragePrecision(iou_type="segm", class_metrics=True)
    step_s = []
    for s in range(0, spec["images"], COCO_DET["batch"]):
        _timed(step_s, lambda: metric.update(preds[s : s + COCO_DET["batch"]], target[s : s + COCO_DET["batch"]]))
    reckoned = metric._reckoned_peak_bytes()
    print(json.dumps({"phase": name, "reckoned_compute_peak_bytes": reckoned}), flush=True)
    result, compute_ms, peak = _timed_compute(metric, dev)
    _check(peak <= reckoned, f"{name}: the compute's peak {peak} above its reckoning {reckoned}")
    breakdown = _map_breakdown(metric)
    launches = _text_no_kernels(name, counters)
    n = spec["cpu_prefix"]
    card = detection.MeanAveragePrecision(iou_type="segm", class_metrics=True)
    card.update(preds[:n], target[:n])
    cpu = detection.MeanAveragePrecision(iou_type="segm", class_metrics=True, device="cpu")
    cpu.update(_to_cpu(preds[:n]), _to_cpu(target[:n]))
    prefix_err = _hold_dicts(f"{name} card against the CPU", card.compute(), cpu.compute(), DET_TOL)
    masks = sum(p["masks"].shape[0] for p in preds) + sum(t["masks"].shape[0] for t in target)
    return _emit({
        "phase": name, "source": "COCO 2017 val segm: the bbox phase's first 200 images, masks at 640 x 480",
        "cuts": "200 of 5,000 images; inscribed ellipses for masks; the CPU check over the first 8",
        "masks": masks, "mask_bytes": masks * h * w, "images_per_s": spec["images"] / sum(step_s),
        "compute_ms": compute_ms, "breakdown": breakdown, "peak_above_states_bytes": peak,
        "reckoned_bytes": reckoned, "peak_over_reckoning": peak / reckoned, "map": float(result["map"]),
        "cpu_prefix_images": n, "cpu_prefix_max_abs_err": prefix_err, "launches": launches,
        "phase_s": time.perf_counter() - started,
    })


def _panoptic_batch(i: int, spec: dict, dev):
    """One batch of (category, instance) maps: ``(preds, target)`` int64
    ``(B, H, W, 2)`` on the card (``COCO_PANOPTIC``'s stated choices)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 33_000 + i)
    b, h, w = spec["batch"], spec["height"], spec["width"]
    stuffs, things = torch.tensor(COCO_STUFFS, device=dev), torch.tensor(COCO_THINGS, device=dev)
    grid = stuffs[torch.randint(0, len(COCO_STUFFS), (b, 1, *spec["grid"]), generator=g, device=dev)]
    cat = F.interpolate(grid.float(), size=(h, w), mode="nearest").long()[:, 0]
    inst = torch.zeros_like(cat)
    count = torch.randint(0, spec["things"], (b,), generator=g, device=dev)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    for k in range(spec["things"]):
        c = torch.rand(b, 4, generator=g, device=dev)
        cy, cx = (c[:, 0] * h)[:, None, None], (c[:, 1] * w)[:, None, None]
        ry, rx = (8 + c[:, 2] * h / 4)[:, None, None], (8 + c[:, 3] * w / 4)[:, None, None]
        inside = (((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1) & (k < count)[:, None, None]
        label = things[torch.randint(0, len(COCO_THINGS), (b,), generator=g, device=dev)][:, None, None]
        cat = torch.where(inside, label, cat)
        inst = torch.where(inside, torch.full_like(inst, k + 1), inst)
    target = torch.stack([cat, inst], dim=-1)
    shift = torch.randint(-spec["shift"], spec["shift"] + 1, (2,), generator=g, device=dev).tolist()
    preds = torch.roll(target, shifts=shift, dims=(1, 2)).clone()
    blocks = torch.rand(b, h // spec["block"], w // spec["block"], generator=g, device=dev) < spec["relabel"]
    blocks = blocks.repeat_interleave(spec["block"], 1).repeat_interleave(spec["block"], 2)
    every = torch.cat([things, stuffs])
    preds[..., 0] = torch.where(blocks, every[torch.randint(0, every.numel(), (b, h, w), generator=g, device=dev)], preds[..., 0])
    unknown = torch.rand(b, h, w, generator=g, device=dev) < spec["unknown"]
    preds[..., 0] = torch.where(unknown, torch.full_like(cat, spec["unknown_id"]), preds[..., 0])
    void = torch.rand(b, h, w, generator=g, device=dev) < spec["void"]
    target[..., 0] = torch.where(void, torch.zeros_like(cat), target[..., 0])
    return preds, target


def _pq_numpy(preds, target, things, stuffs) -> dict:
    """A numpy copy of the JAX package's per-sample panoptic statistics
    (``functional/detection/panoptic_quality.py``: preprocessing, the
    ``np.unique`` relabel, the void-corrected IoU, the matching and the FP/FN
    filters), summed over the batch for plain PQ (``False``) and modified PQ
    (``True``) from one relabel: float64 IoU sums and int64 counts."""
    import numpy as np

    cat_ids = sorted(things) + sorted(stuffs)
    cont = {c: i for i, c in enumerate(cat_ids)}
    void = np.asarray((1 + max(cat_ids), 0))

    def prep(x):
        out = np.array(x, dtype=np.int64).reshape(x.shape[0], -1, 2)
        cats = out[:, :, 0]
        is_stuff, is_thing = np.isin(cats, list(stuffs)), np.isin(cats, list(things))
        out[:, :, 1] = np.where(is_stuff, 0, out[:, :, 1])
        out[~(is_stuff | is_thing)] = void
        return out

    n = len(cat_ids)
    stats = {m: [np.zeros(n), np.zeros(n, np.int64), np.zeros(n, np.int64), np.zeros(n, np.int64)] for m in (False, True)}
    for p, t in zip(prep(preds), prep(target)):
        up, pinv = np.unique(p, axis=0, return_inverse=True)
        ut, tinv = np.unique(t, axis=0, return_inverse=True)
        pinv, tinv = pinv.reshape(-1), tinv.reshape(-1)
        pa = np.bincount(pinv, minlength=len(up)).astype(np.float64)
        ta = np.bincount(tinv, minlength=len(ut)).astype(np.float64)
        inter = np.bincount(pinv * len(ut) + tinv, minlength=len(up) * len(ut)).reshape(len(up), len(ut)).astype(np.float64)
        p_void, t_void = (up == void).all(1), (ut == void).all(1)
        pred_void, void_target = inter[:, t_void].sum(1), inter[p_void, :].sum(0)
        union = pa[:, None] - pred_void[:, None] + ta[None, :] - void_target[None, :] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(inter > 0, inter / union, 0.0)
            tvf = np.where(ta > 0, void_target / ta, 0.0)
            pvf = np.where(pa > 0, pred_void / pa, 0.0)
        considered = (up[:, :1] == ut[None, :, 0]) & (inter > 0) & ~t_void[None, :] & ~p_void[:, None]
        ct = np.array([cont.get(int(c), -1) for c in ut[:, 0]])
        cp = np.array([cont.get(int(c), -1) for c in up[:, 0]])
        for modified, (iou_sum, tp, fp, fn) in stats.items():
            mod = list(stuffs) if modified else []
            t_mod, p_mod = np.isin(ut[:, 0], mod), np.isin(up[:, 0], mod)
            matched = considered & (iou > 0.5) & ~t_mod[None, :]
            a, b = np.nonzero(matched)
            np.add.at(iou_sum, ct[b], iou[a, b])
            np.add.at(tp, ct[b], 1)
            a, b = np.nonzero(considered & (iou > 0) & t_mod[None, :])
            np.add.at(iou_sum, ct[b], iou[a, b])
            np.add.at(tp, ct[~t_void & t_mod], 1)
            np.add.at(fn, ct[~matched.any(0) & ~t_void & ~t_mod & (tvf <= 0.5)], 1)
            np.add.at(fp, cp[~matched.any(1) & ~p_void & ~p_mod & (pvf <= 0.5) & (cp >= 0)], 1)
    return stats


def _pq64(iou_sum, tp, fp, fn) -> float:
    """The averaged PQ of float64 statistics (the JAX package's formula)."""
    import numpy as np

    sq = np.where(tp > 0, iou_sum / np.maximum(tp, 1), 0.0)
    den = tp + 0.5 * fp + 0.5 * fn
    rq = np.where(den > 0, tp / np.maximum(den, 1e-12), 0.0)
    return float((sq * rq)[den > 0].mean())


def phase_coco_panoptic_val2017(dev) -> dict:
    """COCO panoptic val2017 (``COCO_PANOPTIC``): ``PanopticQuality`` and
    ``ModifiedPanopticQuality`` over 5,000 images at 640 x 480 in batches of
    8, 133 categories under COCO panoptic's ids. Hard checks: exactly one
    ``bincount`` launch an update of each metric, on the kernel; TP, FP and
    FN equal to a numpy copy of the JAX package's per-sample algorithm over
    the first 2 batches, the IoU sums and both values within 1e-6 relative
    of it. Reports images/s, compute ms, the peak and the idle share of the
    card over a few updates."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch import detection
    from torchmetrics_tpu_torch.ops import kernels

    name, spec = "coco_panoptic_val2017", COCO_PANOPTIC
    started = time.perf_counter()
    things, stuffs = set(COCO_THINGS), set(COCO_STUFFS)
    pq = detection.PanopticQuality(things, stuffs, allow_unknown_preds_category=True, return_sq_and_rq=True)
    mpq = detection.ModifiedPanopticQuality(things, stuffs, allow_unknown_preds_category=True)
    batches = spec["images"] // spec["batch"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counters = _zero_counters()
    step_s, gen_s = [], 0.0
    for i in range(batches):
        t0 = time.perf_counter()
        preds, target = _panoptic_batch(i, spec, dev)
        torch.cuda.synchronize()
        gen_s += time.perf_counter() - t0
        _timed(step_s, lambda: (pq.update(preds, target), mpq.update(preds, target)))
    launches = {k: m.launches for k, m in counters.items()}
    _check(launches["bincount"] == 2 * batches and sum(launches.values()) == 2 * batches,
           f"{name}: launches {launches}, expected {2 * batches} bincount")
    gate = kernels.gate_snapshot()
    _check(gate.get("bincount", {}).get("selections") == {"cuda": 2 * batches}, f"{name}: gate log {gate}")
    value, compute_ms = _compute_ms(pq)
    modified, mcompute_ms = _compute_ms(mpq)
    peak = _peak_above(dev, base)

    # a prefix against the numpy copy of the JAX algorithm
    checks, n_cat = {}, len(things) + len(stuffs)
    prefix = {"pq": detection.PanopticQuality(things, stuffs, allow_unknown_preds_category=True),
              "modified": detection.ModifiedPanopticQuality(things, stuffs, allow_unknown_preds_category=True)}
    want = {m: [np.zeros(n_cat), *(np.zeros(n_cat, np.int64) for _ in range(3))] for m in (False, True)}
    iou32 = {m: np.zeros(n_cat, np.float32) for m in (False, True)}
    for i in range(spec["numpy_batches"]):
        preds, target = _panoptic_batch(i, spec, dev)
        for m in prefix.values():
            m.update(preds, target)
        for modified, part in _pq_numpy(preds.cpu().numpy(), target.cpu().numpy(), things, stuffs).items():
            iou32[modified] = iou32[modified] + part[0].astype(np.float32)  # rounded once an update
            for acc, x in zip(want[modified], part):
                acc += x
    for (label, m), modified in zip(prefix.items(), (False, True)):
        for k, w in zip(("true_positives", "false_positives", "false_negatives"), want[modified][1:]):
            _check(np.array_equal(getattr(m, k).cpu().numpy(), w), f"{name}: {label} {k} differ from the numpy copy")
        _check(np.allclose(m.iou_sum.cpu().numpy(), iou32[modified], rtol=PQ_RTOL, atol=0), f"{name}: {label} iou sums differ")
        got, want_value = float(m.compute()), _pq64(*want[modified])
        _check(abs(got - want_value) <= PQ_RTOL * abs(want_value), f"{name}: {label} {got} against float64 {want_value}")
        checks[label] = {"value": got, "float64": want_value, "rel_err": abs(got - want_value) / abs(want_value),
                         "tp": int(want[modified][1].sum()), "fp": int(want[modified][2].sum()), "fn": int(want[modified][3].sum())}
    preds, target = _panoptic_batch(0, spec, dev)
    idle = _rest_idle_share(lambda i: (pq.update(preds, target), mpq.update(preds, target)), 3)
    update_s = sum(step_s)
    return _emit({
        "phase": name, "source": "COCO panoptic val2017: 5,000 images, 80 things and 53 stuffs (panoptic_coco_categories.json)",
        "cuts": "synthetic maps at 640 x 480 (stated choices in COCO_PANOPTIC); the numpy check over the first 16 images",
        "updates": batches, "images_per_s": spec["images"] / update_s, "update_ms": 1e3 * update_s / batches,
        "generation_s": gen_s, "pq_sq_rq": [float(v) for v in value], "modified_pq": float(modified),
        "compute_ms": {"pq": compute_ms, "modified": mcompute_ms}, "peak_above_base_bytes": peak,
        "numpy_checks": checks, "launches": launches, "bincount_launches": launches["bincount"],
        "update_idle": idle, "phase_s": time.perf_counter() - started,
    })


def _brats_case(case: int, spec: dict, grids, dev):
    """A case's target and predicted tumour masks, ``(240, 240, 155)`` bool."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 34_000 + case)
    zs, ys, xs = grids
    shape = torch.tensor(spec["shape"], device=dev, dtype=torch.float32)
    lo, hi = spec["radii"]
    centre = shape * (0.3 + 0.4 * torch.rand(3, generator=g, device=dev))
    radii = lo + (hi - lo) * torch.rand(3, generator=g, device=dev)
    phase = 6.283 * torch.rand(3, generator=g, device=dev)

    def ellipsoid(c, r):
        d = ((zs - c[0]) / r[0]) ** 2 + ((ys - c[1]) / r[1]) ** 2 + ((xs - c[2]) / r[2]) ** 2
        ripple = 0.15 * torch.sin(zs / 7 + phase[0]) * torch.cos(ys / 9 + phase[1]) * torch.sin(xs / 5 + phase[2])
        return d <= 1 + ripple

    target = ellipsoid(centre, radii)
    pred = ellipsoid(centre + 2 * torch.randn(3, generator=g, device=dev), radii * (1 + 0.1 * torch.randn(3, generator=g, device=dev)))
    return pred, target


def _edges_scipy(mask, spacing: bool):
    """A padded mask's edges from ``scipy.ndimage.binary_erosion``: the mask
    minus its 6-connected erosion, or (``spacing``) the 2 x 2 x 2 cubes
    neither all in nor all out."""
    import numpy as np
    from scipy import ndimage

    m = np.pad(mask, 1)
    if not spacing:
        return m ^ ndimage.binary_erosion(m, ndimage.generate_binary_structure(m.ndim, 1))
    cube = np.ones((2,) * m.ndim, bool)
    valid = tuple(slice(0, s - 1) for s in m.shape)
    all_in = ndimage.binary_erosion(m, cube, origin=-1)[valid]
    all_out = ndimage.binary_erosion(~m, cube, origin=-1)[valid]
    return ~all_in & ~all_out


def phase_brats2021_surface(dev) -> dict:
    """BraTS 2021 validation's shape (``BRATS``): ``mask_edges`` with
    ``spacing=(1, 1, 1)`` (and without) on the 219 cases' 3-D tumour masks;
    ``surface_distance`` (the ``"pytorch"`` distance transform) on the
    tumour-bearing axial slices of the first 2 cases. Hard checks: edges
    bit-equal to ``scipy.ndimage.binary_erosion`` references over the
    first 4 cases; distances within 1e-5 of ``distance_transform_edt``; no
    kernel launch. Reports cases/s, ms a slice, the peak."""
    import numpy as np
    import torch
    from scipy import ndimage

    from torchmetrics_tpu_torch.functional.segmentation import mask_edges, surface_distance

    name, spec = "brats2021_surface", BRATS
    started = time.perf_counter()
    grids = torch.meshgrid(*[torch.arange(s, device=dev, dtype=torch.float32) for s in spec["shape"]], indexing="ij")
    counters = _zero_counters()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, area_mm2, plain_s, cases = [], [], [], []
    for case in range(spec["cases"]):
        pred, target = _brats_case(case, spec, grids, dev)
        out = _timed(step_s, lambda: mask_edges(pred, target, spacing=(1, 1, 1)))
        area_mm2.append((float(out[2].sum()), float(out[3].sum())))
        plain = _timed(plain_s, lambda: mask_edges(pred, target))
        if case < spec["scipy_cases"]:
            for got, mask in ((out[0], pred), (out[1], target)):
                _check(np.array_equal(got.cpu().numpy(), _edges_scipy(mask.cpu().numpy(), True)), f"{name}: case {case} edges (spacing) differ from scipy")
            for got, mask in ((plain[0], pred), (plain[1], target)):
                _check(np.array_equal(got.cpu().numpy(), _edges_scipy(mask.cpu().numpy(), False)), f"{name}: case {case} edges differ from scipy")
        if case < spec["slice_cases"]:
            cases.append((pred, target))
    peak = _peak_above(dev, base)

    slice_s, worst, slices, distances = [], 0.0, 0, 0
    for pred, target in cases:
        for z in range(spec["shape"][2]):
            p2, t2 = pred[:, :, z], target[:, :, z]
            if not bool(p2.any()) or not bool(t2.any()):
                continue
            ep, et = mask_edges(p2, t2, crop=False)
            got = _timed(slice_s, lambda: surface_distance(ep, et))
            want = ndimage.distance_transform_edt(~et.cpu().numpy())[ep.cpu().numpy()]
            err = float(np.abs(got.cpu().numpy().astype(np.float64) - want).max()) if want.size else 0.0
            _check(err <= EDT_ATOL, f"{name}: slice {z} distances {err} from scipy")
            worst, slices, distances = max(worst, err), slices + 1, distances + int(want.size)
    launches = _text_no_kernels(name, counters)
    idle = _rest_idle_share(lambda i: mask_edges(pred, target, spacing=(1, 1, 1)), 3)
    return _emit({
        "phase": name, "source": "BraTS 2021 validation: 219 cases of 240 x 240 x 155 at 1 mm",
        "cuts": "synthetic ellipsoid tumours (stated choices in BRATS); scipy edge checks over 4 cases; "
        "surface distances over the tumour-bearing slices of 2",
        "cases_per_s": spec["cases"] / sum(step_s), "mask_edges_spacing_ms": 1e3 * sum(step_s) / len(step_s),
        "mask_edges_plain_ms": 1e3 * sum(plain_s) / len(plain_s), "mean_surface_mm2": float(np.mean(area_mm2)),
        "slices": slices, "distances": distances, "surface_distance_ms_a_slice": 1e3 * sum(slice_s) / max(1, slices),
        "max_abs_err_vs_scipy": worst, "peak_above_base_bytes": peak, "mask_edges_idle": idle, "launches": launches,
        "phase_s": time.perf_counter() - started,
    })


class _ClipStandIn:
    """A seeded two-tower image-text embedder at CLIP ViT-B/32's widths (not
    CLIP): patch embedding, GELU, a mean over the 49 patches and a 512-wide
    projection; token embedding over a 49,408-token vocabulary, a masked
    mean over 77 positions and a projection. Each tower's unit output plus
    one shared direction."""

    def __init__(self, dev):
        import torch

        s, g = CLIP_B32, torch.Generator(device=dev).manual_seed(SEED + 35_000)
        patch_dim = 3 * s["patch"] ** 2
        self.patch = torch.randn(patch_dim, s["width"], generator=g, device=dev) / math.sqrt(patch_dim)
        self.pos = 0.02 * torch.randn((s["image"] // s["patch"]) ** 2, s["width"], generator=g, device=dev)
        self.vproj = torch.randn(s["width"], s["embed"], generator=g, device=dev) / math.sqrt(s["width"])
        self.tokens = 0.02 * torch.randn(s["vocab"], s["embed"], generator=g, device=dev)
        self.tpos = 0.01 * torch.randn(s["context"], s["embed"], generator=g, device=dev)
        self.tproj = torch.randn(s["embed"], s["embed"], generator=g, device=dev) / math.sqrt(s["embed"])
        shared = torch.randn(s["embed"], generator=g, device=dev)
        self.shared = shared / shared.norm()
        self.dev = dev

    def image(self, x):
        import torch
        import torch.nn.functional as F

        p = CLIP_B32["patch"]
        if x.shape[-1] != CLIP_B32["image"] or x.shape[-2] != CLIP_B32["image"]:
            x = F.interpolate(x, size=(CLIP_B32["image"],) * 2, mode="bilinear", align_corners=False)
        patches = x.unfold(2, p, p).unfold(3, p, p).permute(0, 2, 3, 1, 4, 5).reshape(x.shape[0], -1, 3 * p * p)
        h = (F.gelu(patches @ self.patch + self.pos).mean(1)) @ self.vproj
        return h / h.norm(dim=-1, keepdim=True) + self.shared

    def text(self, captions):
        import zlib

        import torch

        s = CLIP_B32
        ids = torch.zeros(len(captions), s["context"], dtype=torch.int64)
        for i, c in enumerate(captions):
            words = [s["vocab"] - 2] + [zlib.crc32(w.encode()) % (s["vocab"] - 3) + 1 for w in c.split()] + [s["vocab"] - 1]
            ids[i, : min(len(words), s["context"])] = torch.tensor(words[: s["context"]])
        ids = ids.to(self.dev)
        mask = (ids > 0).float()[..., None]
        h = ((self.tokens[ids] + self.tpos) * mask).sum(1) / mask.sum(1)
        h = h @ self.tproj
        return h / h.norm(dim=-1, keepdim=True) + self.shared


def _captions(n: int, seed: int) -> list:
    """``n`` synthetic captions of 8-15 words drawn from 2,000 pseudo-words."""
    import numpy as np

    rng = np.random.RandomState(seed)
    syllables = ["ka", "lo", "mi", "ne", "su", "ta", "ri", "po", "de", "va", "zu", "he"]
    words = ["".join(rng.choice(syllables, rng.randint(1, 4))) + str(k % 7) for k in range(2_000)]
    return [" ".join(rng.choice(words, rng.randint(8, 16))) for _ in range(n)]


def _smooth_images(n: int, h: int, w: int, g, dev):
    import torch
    import torch.nn.functional as F

    low = torch.rand(n, 3, max(2, h // 32), max(2, w // 32), generator=g, device=dev)
    return F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False).clamp(0, 1)


def phase_coco_karpathy_clipscore(dev) -> dict:
    """``CLIPScore`` over the Karpathy test split (5,000 images x 5
    captions, 100 images an update) and ``CLIPImageQualityAssessment`` over
    KonIQ-10k (10,073 images of 1024 x 768 in batches of 64, resized to
    224 by the hook) with the default prompt and prompt pairs, on the
    seeded stand-in (``KARPATHY``, ``KONIQ``, ``CLIP_B32``). Hard checks:
    the score and every image's probabilities within 1e-5 (relative, and
    absolute for probabilities) of float64 computations from the same
    features; no kernel launch. Reports pairs/s, images/s, the peak and the
    idle share of the card over a few updates."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch import multimodal

    name = "coco_karpathy_clipscore"
    started = time.perf_counter()
    tower = _ClipStandIn(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 36_000)
    captions = _captions(KARPATHY["images"] * KARPATHY["captions"], SEED + 36_000)
    seen = []

    def embed(images, texts):
        pair = (tower.image(images), tower.text(texts))
        seen.append((pair[0].double(), pair[1].double()))
        return pair

    counters = _zero_counters()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    score = multimodal.CLIPScore(embedding_fn=embed)
    step_s, per = [], KARPATHY["batch"] * KARPATHY["captions"]
    for b in range(KARPATHY["images"] // KARPATHY["batch"]):
        images = _smooth_images(KARPATHY["batch"], 224, 224, g, dev).repeat_interleave(KARPATHY["captions"], 0)
        _timed(step_s, lambda: score.update(images, captions[b * per : (b + 1) * per]))
    value, compute_ms = _compute_ms(score)
    value = float(value)
    cos = torch.cat([(i / i.norm(dim=-1, keepdim=True) * (t / t.norm(dim=-1, keepdim=True))).sum(-1) for i, t in seen])
    want = max(float(100 * cos.mean()), 0.0)
    _check(abs(value - want) <= CLIP_RTOL * abs(want), f"{name}: CLIPScore {value} against float64 {want}")

    iqa_feats = {"default": [], "pairs": []}
    anchors = {}

    def image_hook(key):
        def hook(images):
            f = tower.image(images)
            iqa_feats[key].append(f.double())
            return f
        return hook

    def text_hook(key):
        def hook(prompts):
            f = tower.text(prompts)
            anchors[key] = f.double()
            return f
        return hook

    iqa = {"default": multimodal.CLIPImageQualityAssessment(image_hook("default"), text_hook("default")),
           "pairs": multimodal.CLIPImageQualityAssessment(image_hook("pairs"), text_hook("pairs"), prompts=KONIQ["pairs"])}
    iqa_s = []
    for s in range(0, KONIQ["images"], KONIQ["batch"]):
        n = min(KONIQ["batch"], KONIQ["images"] - s)
        images = _smooth_images(n, KONIQ["height"], KONIQ["width"], g, dev)
        _timed(iqa_s, lambda: [m.update(images) for m in iqa.values()])
    iqa_checks = {}
    for key, m in iqa.items():
        got, iqa_ms = _compute_ms(m)
        got = torch.stack(list(got.values()), 1) if isinstance(got, dict) else got[:, None]
        img = torch.cat(iqa_feats[key])
        img = img / img.norm(dim=-1, keepdim=True)
        anc = anchors[key] / anchors[key].norm(dim=-1, keepdim=True)
        want_p = torch.softmax((100 * img @ anc.T).reshape(img.shape[0], -1, 2), dim=-1)[:, :, 0]
        err = float((got.double() - want_p).abs().max())
        _check(got.shape == want_p.shape and err <= CLIP_RTOL, f"{name}: CLIP-IQA {key} {err} from float64")
        iqa_checks[key] = {"images": int(got.shape[0]), "max_abs_err": err, "mean": got.mean(0).tolist(), "compute_ms": iqa_ms}
    peak = _peak_above(dev, base)
    launches = _text_no_kernels(name, counters)
    images = _smooth_images(KARPATHY["batch"], 224, 224, g, dev).repeat_interleave(KARPATHY["captions"], 0)
    idle = _rest_idle_share(lambda i: score.update(images, captions[:per]), 3)
    return _emit({
        "phase": name, "source": "COCO Karpathy test split (5,000 images x 5 captions); KonIQ-10k (10,073 images, 1024 x 768); "
        "CLIP ViT-B/32's widths",
        "cuts": "a seeded two-tower stand-in, not CLIP; synthetic images and captions",
        "clipscore": value, "clipscore_float64": want, "clipscore_compute_ms": compute_ms, "clipscore_rel_err": abs(value - want) / abs(want),
        "pairs_per_s": KARPATHY["images"] * KARPATHY["captions"] / sum(step_s), "iqa_images_per_s": KONIQ["images"] / sum(iqa_s),
        "iqa": iqa_checks, "peak_above_base_bytes": peak, "update_idle": idle, "launches": launches,
        "phase_s": time.perf_counter() - started,
    })


# --------------------------------------------------------------------------
# The runtime layers: observability, durability and asynchronous
# reads on the ImageNet counting path.
# --------------------------------------------------------------------------

#: the runtime phases' ImageNet pass: an autosave every 8 updates into a
#: store of the newest 3, SIGTERM after update 30, a compute_async every 8
RUNTIME = {"every_n_updates": 8, "keep": 3, "kill_after": 30, "async_every": 8, "rounds": 9, "span_calls": 100_000,
           "child_timeout_s": 300}


def _runtime_dir(name: str):
    """A fresh scratch directory for a runtime phase, under the port's
    gitignored ``_build/``."""
    import shutil
    from pathlib import Path

    path = Path(__file__).resolve().parent / "torchmetrics_tpu_torch" / "_build" / "runtime" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def _imagenet_batch(i: int, dev):
    """ImageNet batch ``i``, from the seed and its index alone, so any
    process makes the same batch."""
    import torch

    c = IMAGENET["num_classes"]
    g = torch.Generator(device=dev).manual_seed(SEED + 16_000 + i)
    b = IMAGENET["batches"][i]
    return torch.randn((b, c), generator=g, device=dev), torch.randint(0, c, (b,), generator=g, device=dev)


def _imagenet_indexed(dev) -> dict:
    """The ``imagenet_val`` workload with batches made by index."""
    spec = _imagenet(dev)
    spec["batches"] = lambda: (_imagenet_batch(i, dev) for i in range(len(IMAGENET["batches"])))
    return spec


def _values(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "confmat"}


def _same_result(name: str, got: dict, want: dict) -> None:
    """Every value bit-equal (the confusion matrix too)."""
    import torch

    _check(got.keys() == want.keys(), f"{name}: keys {sorted(got)} != {sorted(want)}")
    for k in want:
        _check(
            got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]),
            f"{name}: {k} differs bit for bit ({got[k].flatten()[:4].tolist()} against {want[k].flatten()[:4].tolist()})",
        )


def _prometheus_families(text: str) -> dict:
    """Parse a Prometheus text exposition: every sample line's value must be
    a number and every family must carry HELP and TYPE."""
    helped, typed, samples = set(), {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            helped.add(line.split()[2])
        elif line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            typed[name] = kind
        elif line:
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    for name in samples:
        family = name.split("{")[0]
        base = next((f for f in typed if family == f or family.startswith(f + "_")), None)
        _check(base is not None and base in helped, f"prometheus: sample {name} has no HELP/TYPE family")
    return {"families": len(typed), "samples": len(samples)}


def _span_cost_us(calls: int) -> float:
    """Host µs of one ``with span(...)`` under the current flags, less the
    empty loop's."""
    from torchmetrics_tpu_torch import obs

    t0 = time.perf_counter()
    for _ in range(calls):
        pass
    empty = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(calls):
        with obs.span(obs.SPAN_UPDATE, suffix="MulticlassAccuracy"):
            pass
    return (time.perf_counter() - t0 - empty) / calls * 1e6


def phase_imagenet_val_traced(dev) -> dict:
    """The ImageNet collection with every flag off, telemetry on (the
    default), tracing on (``TORCHMETRICS_TPU_TRACE=1``), and tracing on with
    an ``observe_ready`` device span after each update, in turns over
    ``RUNTIME["rounds"]`` rounds (each round starting at the next mode).
    Every run: 49 ``bincount`` launches, the
    confusion state equal to the plain count, every value bit-equal across
    runs. The traced runs: one ``tm_tpu.update/<member>`` span per member
    update, one compute span per member, a Chrome trace written and parsed
    back, Prometheus text that parses; with ``observe_ready``, one
    device-completion span per update from a CUDA event. Printed: host µs
    per update (the update call, no synchronise) per mode, a span's host
    cost per mode, and the host time of a ``bincount`` call through the
    kernel seam with the flight recorder's note and without it."""
    import torch

    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.ops import bincount

    spec = _imagenet_indexed(dev)
    plain = _plain_confmat(spec)
    batches = list(spec["batches"]())
    out_dir = _runtime_dir("traced")
    modes = {"flags_off": (False, False, False), "telemetry": (True, False, False), "traced": (True, True, False),
             "traced_ready": (True, True, True)}
    host_us = {m: [] for m in modes}
    span_us = {}
    reference = None
    traced = {}
    seam_ms = {}
    try:
        for mode, (telemetry, tracing, ready) in modes.items():
            if ready:
                continue  # the same spans as "traced"
            obs.set_telemetry(telemetry)
            obs.set_tracing(tracing)
            span_us[mode] = _span_cost_us(RUNTIME["span_calls"])
        obs.set_telemetry(True)
        obs.set_tracing(False)
        seam_ms = _seam_host_ms(dev)
        order = list(modes)
        for r in range(RUNTIME["rounds"]):
            # each round starts at another mode, so no mode always runs first
            for mode in order[r % len(order):] + order[:r % len(order)]:
                telemetry, tracing, ready = modes[mode]
                obs.set_telemetry(telemetry)
                obs.set_tracing(tracing)
                obs.reset()
                obs.reset_ring()
                obs.reset_flight()
                coll = spec["collection"]()
                torch.cuda.synchronize()
                bincount.launches = 0
                steps = []
                groups = []
                for preds, target in batches:
                    t0 = time.perf_counter()
                    coll.update(preds, target)
                    steps.append(time.perf_counter() - t0)
                    groups.append(len(coll.compute_groups) if len(groups) else len(coll._modules))
                    if ready:
                        obs.observe_ready("imagenet_val.update.ready", coll["confmat"].confmat)
                result = coll.compute()
                torch.cuda.synchronize()
                launches = bincount.launches
                _check(launches == len(batches), f"imagenet_val_traced/{mode}: {launches} bincount launches")
                _check(torch.equal(coll["confmat"].confmat.to(torch.int64), plain), f"imagenet_val_traced/{mode}: confusion state")
                if reference is None:
                    reference = result
                _same_result(f"imagenet_val_traced/{mode}", result, reference)
                steps_us = sorted(s * 1e6 for s in steps)
                host_us[mode].append({"p50": steps_us[len(steps_us) // 2], "mean": statistics.fmean(steps_us)})
                if tracing:
                    traced[mode] = _check_trace(coll, groups, out_dir, ready)
    finally:
        obs.set_telemetry(None)
        obs.set_tracing(None)
    cm, tp, fp, fn, present = _derived(plain)
    spec["check"](reference, tp, fp, fn, present.to(torch.float64))
    return _emit({
        "phase": "imagenet_val_traced", "updates": len(batches), "rounds": RUNTIME["rounds"],
        "bincount_launches": len(batches) * len(modes) * RUNTIME["rounds"],
        "host_us_per_update": host_us,
        "host_us_median_of_rounds": {m: statistics.median(r["p50"] for r in rounds) for m, rounds in host_us.items()},
        "span_cost_us": span_us, "trace": traced, "bincount_seam_host_ms": seam_ms,
        "values": {k: float(v) for k, v in _values(reference).items()},
    })


def _seam_host_ms(dev) -> dict:
    """Host ms of one ``bincount`` call through the kernel seam (the gate
    log and, with telemetry, the flight recorder's note) at the Cityscapes
    update's weightless shape, with the note on and off, in turns."""
    import torch

    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.ops import kernels

    _, k, length, n, _ = next(s for s in KERNEL_SHAPES if s[0] == "cityscapes_confmat_weightless")
    x, _ = _bincount_inputs(k, length, n, False, dev)
    out = {"flight_on": [], "flight_off": []}
    try:
        for flight in (True, False, False, True):
            obs.set_flight(flight)
            out["flight_on" if flight else "flight_off"].append(_host_ms(lambda: kernels.dispatch("bincount", x, None, length)))
    finally:
        obs.set_flight(None)
    torch.cuda.synchronize()
    return out


def _check_trace(coll, groups: list, out_dir, ready: bool) -> dict:
    """The traced run's spans, trace file and Prometheus text."""
    from torchmetrics_tpu_torch import obs

    _check(obs.flush_ready_observations(60.0), "imagenet_val_traced: ready observations did not land")
    events = obs.peek_events()
    names = [e.name for e in events]
    member_classes = sorted(type(m).__name__ for m in coll.values())
    update_spans = [n for n in names if n.startswith(obs.SPAN_UPDATE + "/")]
    # the updates the executor served are one dispatch span each, no member's
    served = coll.executor_status["stats"]["calls"]
    dispatch_spans = [n for n in names if n.startswith(obs.SPAN_DISPATCH + "/MetricCollection")]
    eager = sum(groups[: len(groups) - served])
    _check(len(update_spans) == eager and len(dispatch_spans) == served,
           f"imagenet_val_traced: {len(update_spans)} update spans for {eager} eager member updates,"
           f" {len(dispatch_spans)} dispatch spans for {served} executor calls"
           f" (fallback: {coll.executor_status['fallback_reason']})")
    compute_spans = sorted(n.split("/", 1)[1] for n in names if n.startswith(obs.SPAN_COMPUTE + "/"))
    _check(compute_spans == member_classes, f"imagenet_val_traced: compute spans {compute_spans}")
    ready_spans = [e for e in events if e.name == "imagenet_val.update.ready"]
    want_ready = len(groups) if ready else 0
    _check(len(ready_spans) == want_ready and all(e.t_end_ns >= e.t_start_ns and not (e.attrs or {}).get("error") for e in ready_spans),
           f"imagenet_val_traced: {len(ready_spans)} device-completion spans, not {want_ready}")
    path = obs.write_chrome_trace(str(out_dir / "imagenet_val.trace.json"), drain=True)
    with open(path) as fh:
        trace = json.load(fh)
    complete = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    _check(len(complete) == len(events), f"imagenet_val_traced: the trace holds {len(complete)} of {len(events)} spans")
    text = obs.prometheus_text()
    parsed = _prometheus_families(text)
    ready_us = sorted(e.duration_us for e in ready_spans) or [None]
    return {
        "spans": len(events), "update_spans": len(update_spans), "compute_spans": len(compute_spans),
        "ready_spans": len(ready_spans), "ready_us_p50": ready_us[len(ready_us) // 2], "trace_bytes": os.path.getsize(path),
        "prometheus": parsed,
    }


def _preempted_child(store: str, device: str, conn) -> None:
    """The preempted process: the collection under an Autosaver and the
    preemption handler; reports each committed update, and after
    ``RUNTIME["kill_after"]`` waits for its SIGTERM."""
    import torch

    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.io import Autosaver, install_preemption_handler

    dev = torch.device(device)
    coll = _imagenet(dev)["collection"]()
    saver = Autosaver(coll, store, every_n_updates=RUNTIME["every_n_updates"], keep=RUNTIME["keep"]).attach()
    final_save = saver.final_save

    def timed_final_save():
        t0 = time.perf_counter()
        path = final_save()
        conn.send(("final_save", {"ms": (time.perf_counter() - t0) * 1e3, "path": path}))
        return path

    saver.final_save = timed_final_save
    install_preemption_handler(saver)
    tick_us = []
    for i in range(RUNTIME["kill_after"]):
        preds, target = _imagenet_batch(i, dev)
        t0 = time.perf_counter()
        coll.update(preds, target)
        tick_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    saver.flush(60.0)
    flight = obs.flight_snapshot()
    conn.send(("committed", {
        "updates": coll.update_count,
        "stats": {k: saver.stats[k] for k in ("saves", "skipped_inflight", "async_rides", "save_errors", "reused_recovery_snapshots")},
        "background_save_ms": [r["duration_us"] / 1e3 for r in flight.get("checkpoint", []) if r["name"].startswith(obs.SPAN_CKPT_SAVE)],
        "autosave_tick_ms": [r["duration_us"] / 1e3 for r in flight.get("autosave", [])],
        "update_us_p50": sorted(tick_us)[len(tick_us) // 2],
    }))
    deadline = time.monotonic() + RUNTIME["child_timeout_s"]
    while time.monotonic() < deadline:  # the handler runs between these bytecodes
        time.sleep(0.01)
    sys.exit(3)  # no signal came


def phase_imagenet_val_preempted(dev) -> dict:
    """A real preemption. A spawned child updates the collection under
    ``Autosaver(every_n_updates=8, keep=3)`` and the preemption handler;
    after it reports update 30 committed the parent sends SIGTERM, the child
    flushes a final snapshot and dies by the signal. The parent restores the
    newest snapshot into a fresh collection and finishes batches 31-49:
    values bit-equal to an uninterrupted run, the confusion matrix equal to
    the plain count, every member at 49 updates. Then the newest snapshot is
    torn: the restore skips it, takes the one before, and replaying from its
    count gives the same values. Printed: snapshot bytes, background save
    ms, final save ms, restore ms."""
    import multiprocessing
    import signal

    import torch

    from torchmetrics_tpu_torch.io import load_manifest, restore_state
    from torchmetrics_tpu_torch.io.checkpoint import _list_snapshots
    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.testing import torn_write

    spec = _imagenet_indexed(dev)
    n = len(IMAGENET["batches"])
    store = str(_runtime_dir("preempted"))
    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=_preempted_child, args=(store, str(dev), child_conn))
    t_spawn = time.perf_counter()
    child.start()
    messages = {}
    deadline = time.monotonic() + RUNTIME["child_timeout_s"]
    try:
        while "committed" not in messages:
            _check(child.is_alive() and time.monotonic() < deadline,
                   f"imagenet_val_preempted: the child ended (exit code {child.exitcode}) or stalled before update 30")
            if parent_conn.poll(1.0):
                kind, body = parent_conn.recv()
                messages[kind] = body
        t_kill = time.perf_counter()
        os.kill(child.pid, signal.SIGTERM)
        child.join(RUNTIME["child_timeout_s"])
        _check(not child.is_alive(), "imagenet_val_preempted: the child outlived its SIGTERM")
        while parent_conn.poll(1.0):
            kind, body = parent_conn.recv()
            messages[kind] = body
    finally:
        if child.is_alive():
            child.kill()
            child.join(30)
    _check(child.exitcode == -signal.SIGTERM, f"imagenet_val_preempted: child exit code {child.exitcode}, not -SIGTERM")
    _check("final_save" in messages, "imagenet_val_preempted: the child flushed no final snapshot")
    committed = messages["committed"]
    _check(committed["updates"] == RUNTIME["kill_after"] and committed["stats"]["save_errors"] == 0,
           f"imagenet_val_preempted: child state {committed}")

    torch.cuda.synchronize()
    bincount.launches = 0
    whole = spec["collection"]()
    for i in range(n):
        whole.update(*_imagenet_batch(i, dev))
    want = whole.compute()

    def resume(expect_count: int, expect_skipped: int):
        coll = spec["collection"]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        manifest = restore_state(store, coll)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        _check(manifest["update_count"] == expect_count and manifest["fallbacks_skipped"] == expect_skipped,
               f"imagenet_val_preempted: restored count {manifest['update_count']} skipped {manifest['fallbacks_skipped']}")
        for i in range(expect_count, n):
            coll.update(*_imagenet_batch(i, dev))
        got = coll.compute()
        _same_result(f"imagenet_val_preempted (from {expect_count})", got, want)
        counts = {name: m._update_count for name, m in coll.items(keep_base=True)}
        _check(all(c == n for c in counts.values()), f"imagenet_val_preempted: update counts {counts}")
        return manifest, restore_ms, got

    snaps = _list_snapshots(store)
    newest = snaps[-1][1]
    snapshot_bytes = os.path.getsize(newest)
    manifest, restore_ms, got = resume(RUNTIME["kill_after"], 0)
    _check(torch.equal(got["confmat"].to(torch.int64), _plain_confmat(spec)), "imagenet_val_preempted: confusion matrix")
    torn_write(newest)
    previous = load_manifest(snaps[-2][1])["update_count"]
    manifest_torn, restore_torn_ms, _ = resume(previous, 1)
    launches = bincount.launches
    _check(launches == n + (n - RUNTIME["kill_after"]) + (n - previous),
           f"imagenet_val_preempted: {launches} bincount launches")
    reuse = _autosave_reusing_recovery(dev, spec)
    launches += reuse.pop("bincount_launches")
    return _emit({
        "phase": "imagenet_val_preempted", "child_exitcode": child.exitcode, "kill_after": RUNTIME["kill_after"],
        "child_s": t_kill - t_spawn, "child": committed, "final_save_ms": messages["final_save"]["ms"],
        "snapshots": [os.path.basename(p) for _, p in snaps], "snapshot_bytes": snapshot_bytes,
        "restore_ms": restore_ms, "restore_after_torn_ms": restore_torn_ms, "torn_fallback_count": previous,
        "bincount_launches": launches, "values": {k: float(v) for k, v in _values(want).items()},
        "reuse_recovery": reuse,
    })


def _autosave_reusing_recovery(dev, spec: dict) -> dict:
    """The collection on the captured executor under ``Autosaver(every 8,
    reuse_recovery=True)``, saving inline (every 8th update exactly): each save after a replay
    reuses the executor's recovery reference (the slot the replay read).
    Checks: some saves reused it; the newest snapshot restores one update
    behind the live state at its save, bit-equal to the eager counts at
    that count; the saves raise no ``copied_calls`` (the reuse marks
    nothing escaped: a replay copies only after the fresh key's run and
    after the key's one eager trial)."""
    import torch

    from torchmetrics_tpu_torch.io import Autosaver, load_manifest, restore_state
    from torchmetrics_tpu_torch.io.checkpoint import _list_snapshots
    from torchmetrics_tpu_torch.ops import bincount

    n = len(IMAGENET["batches"])
    every = RUNTIME["every_n_updates"]
    store = str(_runtime_dir("preempted_reuse"))
    coll = spec["collection"](executor=True)
    saver = Autosaver(coll, store, every_n_updates=every, keep=RUNTIME["keep"], background=False, reuse_recovery=True).attach()
    bincount.launches = 0
    tick_us = []
    for i in range(n - 1):  # the 1,024-row batches: one key, replayed
        t0 = time.perf_counter()
        coll.update(*_imagenet_batch(i, dev))
        tick_us.append((time.perf_counter() - t0) * 1e6)
    saver.flush(60.0)
    torch.cuda.synchronize()
    launches = bincount.launches
    stats = coll.executor_status["stats"]
    _check(saver.stats["reused_recovery_snapshots"] > 0 and saver.stats["save_errors"] == 0,
           f"imagenet_val_preempted: the autosaver reused no recovery snapshot: {saver.stats}")
    # the first call resolves the groups, the second is the fresh key's
    # (copied), the key's eager trials make the replay after them copy;
    # every other replay donates: the saves copied nothing in
    copies = 1 + (1 if stats["eager"]["calls"] and stats["eager"]["keys"] == 0 else 0)
    _check(stats["copied_calls"] == copies and stats["donated_calls"] == stats["calls"] - copies,
           f"imagenet_val_preempted: the saves raised copied_calls: {stats}")
    newest = _list_snapshots(store)[-1][1]
    count = load_manifest(newest)["update_count"]
    restored = spec["collection"](executor=False)
    restore_state(newest, restored)
    _check((count + 1) % every == 0 and restored.update_count == count,
           f"imagenet_val_preempted: the newest snapshot holds {count} updates, not one behind a save every {every}")
    ref = spec["collection"](executor=False)
    for i in range(count):
        ref.update(*_imagenet_batch(i, dev))
    launches += count
    want = _fields(ref.state())
    got = {leader: {k: restored[leader]._state[k] for k in sub} for leader, sub in want.items()}
    _check(_bit_equal(got, want), "imagenet_val_preempted: the reused snapshot differs from the eager state at its count")
    saver.detach()  # the saver and the collection observe each other: part them
    out = {
        "saves": saver.stats["saves"], "reused_recovery_snapshots": saver.stats["reused_recovery_snapshots"],
        "snapshot_count": count, "executor": {k: stats[k] for k in ("calls", "donated_calls", "copied_calls", "eager")},
        "update_us_p50": statistics.median(tick_us), "bincount_launches": launches,
    }
    del coll, saver, restored, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_imagenet_val_async(dev) -> dict:
    """``compute_async()`` every 8 updates (and after the last) while the
    loop goes on, on the default stream and then with the loop inside
    ``torch.cuda.stream(s)``: each future bit-equal to a blocking
    ``compute()`` at the same count, ``reads.inline_compute`` and
    ``reads.inline_fallback`` 0. Printed: host µs of a ``compute_async``
    call and of the blocking compute it replaces."""
    from contextlib import nullcontext

    import torch

    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.ops.async_read import drain_pipeline

    spec = _imagenet_indexed(dev)
    batches = list(spec["batches"]())
    n, every = len(batches), RUNTIME["async_every"]
    points = [i for i in range(1, n + 1) if i % every == 0 or i == n]
    torch.cuda.synchronize()
    bincount.launches = 0
    blocking, blocking_us = {}, []
    coll = spec["collection"]()
    for i, batch in enumerate(batches, 1):
        coll.update(*batch)
        if i in points:
            t0 = time.perf_counter()
            blocking[i] = coll.compute()
            torch.cuda.synchronize()
            blocking_us.append((time.perf_counter() - t0) * 1e6)
    obs.reset()
    runs = {}
    for mode in ("default_stream", "side_stream"):
        stream = torch.cuda.Stream(dev) if mode == "side_stream" else None
        coll = spec["collection"]()
        futures, submit_us = {}, []
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream) if stream is not None else nullcontext():
            for i, batch in enumerate(batches, 1):
                coll.update(*batch)
                if i in points:
                    t0 = time.perf_counter()
                    futures[i] = coll.compute_async()
                    submit_us.append((time.perf_counter() - t0) * 1e6)
        for i, fut in futures.items():
            _check(fut.submitted_count == i, f"imagenet_val_async/{mode}: future at count {fut.submitted_count}, not {i}")
            _same_result(f"imagenet_val_async/{mode} at {i}", fut.result(120.0), blocking[i])
        runs[mode] = {"futures": len(futures), "submit_us_p50": sorted(submit_us)[len(submit_us) // 2],
                      "submit_us_max": max(submit_us)}
    _check(drain_pipeline(60.0), "imagenet_val_async: the read pipeline did not drain")
    counters = obs.counters_snapshot()
    inline = {k: counters.get(k, 0) for k in ("reads.inline_compute", "reads.inline_fallback")}
    _check(not any(inline.values()), f"imagenet_val_async: inline reads {inline}")
    _check(counters.get("reads.async_completed", 0) == 2 * len(points), f"imagenet_val_async: {counters}")
    launches = bincount.launches
    _check(launches == 3 * n, f"imagenet_val_async: {launches} bincount launches for {3 * n} updates")
    return _emit({
        "phase": "imagenet_val_async", "updates": n, "reads_each": len(points), "runs": runs,
        "blocking_compute_us_p50": sorted(blocking_us)[len(blocking_us) // 2], "inline": inline,
        "bincount_launches": launches,
    })


# ---------------------------------------------------------------------------
# Session lanes (lanes.py, ops/ingest.py, quarantine.py): LEAF's FEMNIST
# writers as sessions, one per writer, on the entry-shaped counting
# collection at 62 classes, laned as one LanedCollection.

#: LEAF FEMNIST (Caldas et al., "LEAF: A Benchmark for Federated Settings",
#: Table 1): 3,550 writers, 805,263 samples, 226.83 +- 88.94 samples a writer,
#: 62 classes. Evaluated per writer in batches of 32, about 80% top-1.
FEMNIST = {"writers": 3_550, "samples": 805_263, "mean": 226.83, "std": 88.94, "classes": 62, "batch": 32,
           "floor": 10, "top1": 0.8, "spread": 0.08, "margin": 6.0, "capacity": 1_024, "check_writers": 64,
           "poisoned": 36, "whole_batch": 32_768}
#: values against the unlaned collections (the counts are bit-equal)
FEMNIST_ATOL = 1e-6


def _femnist_counts() -> "np.ndarray":
    """Samples per writer: LEAF's mean and spread from the seed, clipped at
    the floor, rescaled to sum to the dataset's 805,263."""
    import numpy as np

    spec = FEMNIST
    rng = np.random.RandomState(SEED + 17_000)
    raw = np.clip(rng.normal(spec["mean"], spec["std"], spec["writers"]), spec["floor"], None)
    counts = np.maximum(np.round(raw * spec["samples"] / raw.sum()).astype(np.int64), spec["floor"])
    diff = spec["samples"] - int(counts.sum())
    order = np.argsort(-counts)  # settle the rounding on the largest writers
    counts[order[: abs(diff)]] += int(np.sign(diff))
    return counts


def _femnist_writer(w: int, n: int):
    """Writer ``w``'s ``n`` samples from the seed and its index: float32
    logits leaning to the target for about 80% top-1, with a per-writer
    spread of skill."""
    import numpy as np

    spec = FEMNIST
    c = spec["classes"]
    rng = np.random.RandomState([SEED, 17_001, w])
    skill = float(np.clip(rng.normal(spec["top1"], spec["spread"]), 0.3, 0.99))
    target = rng.randint(0, c, n)
    wrong = (target + rng.randint(1, c, n)) % c
    picked = np.where(rng.rand(n) < skill, target, wrong)
    logits = rng.randn(n, c).astype(np.float32)
    logits[np.arange(n), picked] += np.float32(spec["margin"])
    return logits, target


def _femnist_data() -> dict:
    """Every writer's samples and the traffic: one ``update_sessions`` call
    with all full batches of 32 (one round per batch index), then each
    writer's shorter last batch in calls grouped by length (the rows of a
    round share a shape)."""
    import numpy as np

    counts = _femnist_counts()
    batch = FEMNIST["batch"]
    writers = [_femnist_writer(w, int(n)) for w, n in enumerate(counts)]
    full, tails = [], {}
    for w, (logits, target) in enumerate(writers):
        n = len(target)
        for b in range(n // batch):
            full.append((w, (logits[b * batch:(b + 1) * batch], target[b * batch:(b + 1) * batch])))
        rest = n % batch
        if rest:
            tails.setdefault(rest, []).append((w, (logits[n - rest:], target[n - rest:])))
    calls = [full] + [tails[r] for r in sorted(tails)]
    return {"counts": counts, "writers": writers, "calls": calls, "tail_writers": sorted(w for r in tails for w, _ in tails[r]),
            "rounds": int(counts.max() // batch) + len(tails)}


def _femnist_members(dev) -> dict:
    """The entry-shaped counting collection at 62 classes (the JAX package's
    ``__graft_entry__`` collection), ``validate_args=False``."""
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
        MulticlassPrecision,
        MulticlassRecall,
    )

    c = FEMNIST["classes"]
    return {
        "accuracy": MulticlassAccuracy(num_classes=c, average="micro", validate_args=False, device=dev),
        "f1": MulticlassF1Score(num_classes=c, average="macro", validate_args=False, device=dev),
        "precision": MulticlassPrecision(num_classes=c, average="macro", validate_args=False, device=dev),
        "recall": MulticlassRecall(num_classes=c, average="macro", validate_args=False, device=dev),
        "confmat": MulticlassConfusionMatrix(num_classes=c, validate_args=False, device=dev),
    }


def _femnist_plain_counts(data: dict, dev, skip_last: tuple = ()) -> "torch.Tensor":
    """Plain int64 per-writer confusion counts on the card, ``(W, C, C)``:
    one ``index_add_`` of ones over every sample (a writer in ``skip_last``
    without its last batch)."""
    import numpy as np
    import torch

    c, batch = FEMNIST["classes"], FEMNIST["batch"]
    idx = []
    for w, (logits, target) in enumerate(data["writers"]):
        n = len(target)
        keep = n - (n % batch or batch) if w in skip_last else n
        pred = logits[:keep].argmax(1)
        idx.append((w * c + target[:keep]) * c + pred)
    flat = torch.from_numpy(np.concatenate(idx).astype(np.int64)).to(dev)
    out = torch.zeros(len(data["writers"]) * c * c, dtype=torch.int64, device=dev)
    out.index_add_(0, flat, torch.ones_like(flat))
    return out.reshape(len(data["writers"]), c, c)


def _stats_of(confmat):
    """Per-class (tp, fp, tn, fn) of ``(..., C, C)`` counts, int64."""
    import torch

    tp = torch.diagonal(confmat, dim1=-2, dim2=-1)
    fp = confmat.sum(-2) - tp
    fn = confmat.sum(-1) - tp
    tn = confmat.sum((-2, -1))[..., None] - tp - fp - fn
    return tp, fp, tn, fn


def _femnist_route(dev, data: dict, pipeline: bool, guarded: bool = False, poisoned: tuple = ()) -> dict:
    """One laned run over every writer's traffic; returns the collection,
    the wall time of the updates, and the lanes.* telemetry of the run."""
    import os
    from contextlib import ExitStack

    import torch

    from torchmetrics_tpu_torch import lanes, obs
    from torchmetrics_tpu_torch.ops import bincount, ingest
    from torchmetrics_tpu_torch.testing import faults

    saved = os.environ.get(ingest.PIPELINE_ENV)
    os.environ[ingest.PIPELINE_ENV] = "1" if pipeline else "0"
    try:
        ingest.reset_for_tests()
        obs.reset()
        coll = lanes.LanedCollection(
            _femnist_members(dev), capacity=FEMNIST["capacity"], on_lane_fault="quarantine" if guarded else None
        )
        _sync(dev)
        base = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        launches0 = bincount.launches
        rounds = 0
        t0 = time.perf_counter()
        rounds += coll.update_sessions(data["calls"][0])
        with ExitStack() as stack:
            for w in poisoned:  # each poisoned writer's LAST batch carries NaN logits
                stack.enter_context(faults.poison_session(coll, w, seed=w))
            for call in data["calls"][1:]:
                rounds += coll.update_sessions(call)
        _sync(dev)
        seconds = time.perf_counter() - t0
        _check(ingest.drain_pipeline(60.0), "femnist: the ingest pipeline did not drain")
        launches = bincount.launches - launches0
        counters, hist = obs.counters_snapshot(), obs.histograms_snapshot()
        peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else None
    finally:
        if saved is None:
            os.environ.pop(ingest.PIPELINE_ENV, None)
        else:
            os.environ[ingest.PIPELINE_ENV] = saved
        ingest.reset_for_tests()

    def mean_us(name: str):
        h = hist.get(name) or {}
        return h["sum"] / h["count"] if h.get("count") else None

    samples = int(data["counts"].sum())
    return {
        "coll": coll, "seconds": seconds, "rounds": rounds, "bincount_launches": launches,
        "sessions_per_s": len(data["writers"]) / seconds, "samples_per_s": samples / seconds,
        "pack_us_per_round": mean_us("lanes.pack_us"), "upload_us_per_round": mean_us("lanes.upload_us"),
        "dispatch_us_per_round": mean_us("lanes.dispatch_us"),
        "rows": int(counters.get("lanes.rows", 0)),
        "pipelined_rounds": int(counters.get("lanes.pipelined_rounds", 0)),
        "inline_packs": int(counters.get("lanes.inline_packs", 0)),
        "h2d_bytes": int(counters.get("lanes.h2d_bytes", 0)), "peak_mem_above_base_bytes": peak,
    }


def _lane_rows(coll, writers, field: str, member: str = "confmat"):
    """``field`` of ``member``'s lanes of ``writers``, in writer order."""
    import torch

    state = coll[member]._state[field]
    lanes_of = [coll.sessions[w] for w in writers]
    return state.index_select(0, torch.as_tensor(lanes_of, device=state.device))


def _femnist_lanes_equal_plain(name: str, coll, plain, writers) -> None:
    """Every lane's confusion matrix, stat scores and micro counts bit-equal
    to the plain count of its writer."""
    _check(_lane_rows(coll, writers, "confmat").to(plain.dtype).equal(plain),
           f"{name}: a lane's confusion matrix differs from its plain count")
    stats = _stats_of(plain)
    for i, field in enumerate(("tp", "fp", "tn", "fn")):
        _check(_lane_rows(coll, writers, field, "f1").to(plain.dtype).equal(stats[i]),
               f"{name}: a lane's {field} differs from its plain count")
        _check(_lane_rows(coll, writers, field, "accuracy").to(plain.dtype).equal(stats[i].sum(-1)),
               f"{name}: a lane's micro {field} differs from its plain count")


def _femnist_unlaned(dev, batches) -> "MetricCollection":
    from torchmetrics_tpu_torch import MetricCollection

    coll = MetricCollection(_femnist_members(dev), device=dev)
    for logits, target in batches:
        coll.update(*_to_dev(dev, logits, target))
    return coll


def _to_dev(dev, *arrays):
    import torch

    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _femnist_values_close(name: str, got: dict, want: dict) -> dict:
    """Every value within ``FEMNIST_ATOL``; returns the largest difference
    and whether every one was bit-equal."""
    worst, bit_equal = 0.0, True
    for k, v in want.items():
        g = got[k]
        g = g.value if hasattr(g, "value") and not hasattr(g, "shape") else g
        diff = float((g.double() - v.double()).abs().max())
        worst = max(worst, diff)
        bit_equal = bit_equal and bool(g.equal(v))
        _check(diff <= FEMNIST_ATOL, f"{name}: {k} differs by {diff} > {FEMNIST_ATOL}")
    return {"max_abs_err": worst, "bit_equal": bit_equal}


def phase_femnist_writers(dev, data: dict) -> dict:
    """Every FEMNIST writer a session of one laned collection: one
    ``update_sessions`` call with all full batches, then the shorter last
    batches grouped by length; capacity starts at 1,024 and grows to 4,096.
    Run with the ingest pipeline on (the default) and off
    (``TORCHMETRICS_TPU_INGEST_PIPELINE=0``). Checks: every lane bit-equal
    to a plain int64 count of its writer on the card, in both runs, and the
    two runs bit-equal; ``lane_values()`` of 64 seeded writers against 64
    separate unlaned collections within 1e-6; the all-lane ``compute()``
    against one unlaned collection over all 805,263 samples (counts
    bit-equal, values within 1e-6); bincount launches equal to the rounds
    times the row chunks. Printed: sessions and samples a second of both
    runs and of the separate collections, the pack, upload and dispatch µs
    of a round, lane_values and compute ms, peak memory, bytes uploaded."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.lanes import lane_capacity_bucket
    from torchmetrics_tpu_torch.ops import fused_classification as fc

    writers = list(range(len(data["writers"])))
    plain = _femnist_plain_counts(data, dev)
    c = FEMNIST["classes"]
    runs = {}
    for mode, pipeline in (("pipelined", True), ("inline", False)):
        run = _femnist_route(dev, data, pipeline)
        _femnist_lanes_equal_plain(f"femnist_writers/{mode}", run["coll"], plain, writers)
        runs[mode] = run
    a, b = runs["pipelined"]["coll"], runs["inline"]["coll"]
    _check(a.sessions == b.sessions, "femnist_writers: the two runs' directories differ")
    for member in ("accuracy", "f1", "confmat"):
        for field, value in a[member]._state.items():
            _check(value.equal(b[member]._state[field]), f"femnist_writers: {member}.{field} differs between the runs")
    _check(runs["pipelined"]["pipelined_rounds"] > 0, "femnist_writers: no round went through the pack pipeline")
    chunks = -(-len(writers) // max(1, fc.ROW_BINS_LIMIT // (c * c)))
    want_capacity = max(FEMNIST["capacity"], lane_capacity_bucket(len(writers)))
    for mode, run in runs.items():
        _check(run["rounds"] == data["rounds"], f"femnist_writers/{mode}: {run['rounds']} rounds, not {data['rounds']}")
        _check(a.capacity == want_capacity, f"femnist_writers: capacity {a.capacity}, not {want_capacity}")
        _check(run["bincount_launches"] == run["rounds"] * chunks,
               f"femnist_writers/{mode}: {run['bincount_launches']} bincount launches for {run['rounds']} rounds")
    # reads: every lane's values at once, and the all-lane aggregate
    _sync(dev)
    t0 = time.perf_counter()
    values = a.lane_values()
    _sync(dev)
    lane_values_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    total = a.compute()
    _sync(dev)
    compute_ms = (time.perf_counter() - t0) * 1e3
    # 64 seeded writers against 64 separate unlaned collections
    batch = FEMNIST["batch"]
    picks = np.random.RandomState(SEED + 17_002).choice(len(writers), FEMNIST["check_writers"], replace=False)
    _sync(dev)
    t0 = time.perf_counter()
    separate = {}
    for w in picks:
        logits, target = data["writers"][w]
        separate[int(w)] = _femnist_unlaned(dev, [(logits[i:i + batch], target[i:i + batch]) for i in range(0, len(target), batch)])
    _sync(dev)
    separate_s = time.perf_counter() - t0
    lane_check = {"max_abs_err": 0.0, "bit_equal": True}
    for w, coll in separate.items():
        got = _femnist_values_close(f"femnist_writers: writer {w}", values[w], coll.compute())
        lane_check = {"max_abs_err": max(lane_check["max_abs_err"], got["max_abs_err"]),
                      "bit_equal": lane_check["bit_equal"] and got["bit_equal"]}
    # the all-lane aggregate against one unlaned collection over every sample
    whole = np.concatenate([x for x, _ in data["writers"]]), np.concatenate([t for _, t in data["writers"]])
    step = FEMNIST["whole_batch"]
    unlaned = _femnist_unlaned(dev, [(whole[0][i:i + step], whole[1][i:i + step]) for i in range(0, len(whole[1]), step)])
    want = unlaned.compute()
    _check(total["confmat"].equal(want["confmat"]), "femnist_writers: the all-lane confusion matrix differs")
    _check(total["confmat"].to(torch.int64).equal(plain.sum(0)), "femnist_writers: the all-lane counts differ from the plain count")
    aggregate = _femnist_values_close("femnist_writers: all-lane compute()", total, want)
    out = {
        "phase": "femnist_writers", "writers": len(writers), "samples": int(data["counts"].sum()),
        "samples_per_writer": {"min": int(data["counts"].min()), "max": int(data["counts"].max())},
        "rounds": data["rounds"], "row_chunks": chunks, "capacity": a.capacity,
        "lane_values_ms": lane_values_ms, "compute_ms": compute_ms,
        "lane_values_route": {name: a[name]._lane_route() for name in a.keys()},
        "separate": {"writers": len(separate), "seconds": separate_s, "sessions_per_s": len(separate) / separate_s},
        "lanes_vs_separate": lane_check, "aggregate_vs_unlaned": aggregate,
    }
    for mode, run in runs.items():
        out[mode] = {k: v for k, v in run.items() if k != "coll"}
    out["bincount_launches"] = sum(run["bincount_launches"] for run in runs.values())
    _emit(out)
    out["_reuse"] = {"coll": a, "plain": plain, "seconds": runs["pipelined"]["seconds"]}
    return out


def phase_femnist_writers_guarded(dev, data: dict, clean: dict) -> dict:
    """The same traffic with ``on_lane_fault="quarantine"``; 36 seeded
    writers (1%) send their last batch with NaN logits (``poison_session``).
    Checks: exactly those 36 are quarantined; each of their lanes equals the
    plain count of all their batches but the last, and reads of them serve a
    ``DegradedValue`` of that value; every other lane bit-equal to
    ``femnist_writers``; the all-lane ``compute()`` equal to the plain count
    over the other 3,514 writers. Printed: sessions a second and the
    overhead against the unguarded run."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.quarantine import DegradedValue

    rng = np.random.RandomState(SEED + 17_003)
    poisoned = tuple(int(w) for w in rng.choice(data["tail_writers"], FEMNIST["poisoned"], replace=False))
    run = _femnist_route(dev, data, pipeline=True, guarded=True, poisoned=poisoned)
    coll = run["coll"]
    quarantined = set(coll.guard.quarantined)
    _check(quarantined == set(poisoned), f"femnist_writers_guarded: quarantined {sorted(quarantined)[:8]}..., not the 36")
    writers = list(range(len(data["writers"])))
    clean_writers = [w for w in writers if w not in quarantined]
    plain = _femnist_plain_counts(data, dev, skip_last=poisoned)
    _femnist_lanes_equal_plain("femnist_writers_guarded", coll, plain, writers)
    reuse = clean["_reuse"]
    for member in ("accuracy", "f1", "confmat"):
        for field in coll[member].inner._defaults:
            _check(_lane_rows(coll, clean_writers, field, member).equal(_lane_rows(reuse["coll"], clean_writers, field, member)),
                   f"femnist_writers_guarded: a clean lane's {member}.{field} differs from femnist_writers")
    values = coll.lane_values()
    for w in poisoned:
        dv = values[w]["confmat"]
        _check(isinstance(dv, DegradedValue), f"femnist_writers_guarded: writer {w} did not read degraded")
        _check(dv.value.to(torch.int64).equal(plain[w]), f"femnist_writers_guarded: writer {w}'s degraded value")
        _check(dv.updates_behind >= 1, f"femnist_writers_guarded: writer {w}'s staleness {dv.updates_behind}")
    total = coll.compute()
    _check(total["confmat"].to(torch.int64).equal(plain[clean_writers].sum(0)),
           "femnist_writers_guarded: the all-lane aggregate differs from the plain count of the 3,514 writers")
    # the guard's round baseline: the JAX package fetches the touched lanes'
    # rows of every member to the host each round; the port holds the
    # pre-round state tensors by reference (updates replace them)
    lane_bytes = sum(
        coll[name]._state[f][0].nbytes for name in coll.keys()
        for f in list(coll[name].inner._defaults) + list(coll[name]._LANE_AUX_FIELDS)
    )
    baseline = {"held": "pre-round state tensors, by reference", "bytes_copied": 0,
                "a_rows_fetch_would_move_bytes": lane_bytes * run["rows"]}
    out = {
        "phase": "femnist_writers_guarded", "poisoned": len(poisoned), "quarantined": len(quarantined),
        "baseline": baseline,
        "clean_writers": len(clean_writers), "diverted_rows": coll.lane_status["diverted_rows"],
        "faults": coll.lane_status["faults"],
        "overhead_vs_unguarded": run["seconds"] / reuse["seconds"] - 1.0,
        **{k: v for k, v in run.items() if k != "coll"},
    }
    return _emit(out)


# ---------------------------------------------------------------------------
# Streaming windows (windows.py and the windowed session lanes): Criteo's
# seven days of clicks as the hourly windows of a click-through-rate
# monitor, and LEAF FEMNIST's writers as windowed session lanes.

#: The Criteo Display Advertising Challenge train set (Kaggle, 2014):
#: 45,840,617 rows over 7 days of traffic in time order, 25.62% clicks. The
#: set has no timestamps, so the rows are cut into 168 equal hours (hour h is
#: rows [h*N//168, (h+1)*N//168)). Scores at an AUROC near 0.80 (the level
#: DLRM-class models reach on this set); batches of 32,768 within an hour; a
#: 24-hour ring with lateness 1; 1% of each hour delivered an hour late
#: (admitted) and 0.1% two hours late (dropped), as delayed clicks arrive
#: (Chapelle, KDD 2014).
CRITEO = {"rows": 45_840_617, "hours": 168, "ctr": 0.2562, "auroc": 0.80, "batch": 32_768, "thresholds": 200,
          "window": 24, "lateness": 1, "late": 0.01, "later": 0.001, "save_at": 100, "async_every": 24,
          "checks": (24, 100, 168), "bench_windows": (24, 168), "bench_calls": 48}


def _criteo_hour(h: int, dev) -> dict:
    """Hour ``h``'s rows from the seed on the card: labels at the train
    set's click rate, float32 probabilities from a binormal score (AUROC
    Phi(d / sqrt 2) = 0.80); split into the on-time rows, the 1% an hour
    late and the 0.1% two hours late."""
    import math

    import torch

    spec = CRITEO
    n = (h + 1) * spec["rows"] // spec["hours"] - h * spec["rows"] // spec["hours"]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 18_000 + h)
    labels = (torch.rand(n, generator=g, device=dev) < spec["ctr"]).to(torch.int64)
    d = math.sqrt(2.0) * 0.8416212335729143  # Phi^-1(0.80)
    scores = torch.sigmoid(torch.randn(n, generator=g, device=dev) + d * labels - 1.6)
    n_later = round(n * spec["later"])
    n_late = round(n * spec["late"])
    on = n - n_late - n_later
    b = spec["batch"]
    return {
        "rows": n,
        "on": [(scores[i:min(on, i + b)], labels[i:min(on, i + b)]) for i in range(0, on, b)],
        "late": (scores[on:on + n_late], labels[on:on + n_late]),
        "later": (scores[on + n_late:], labels[on + n_late:]),
    }


def _criteo_members(dev) -> dict:
    from torchmetrics_tpu_torch.classification import (
        BinaryAccuracy,
        BinaryAUROC,
        BinaryAveragePrecision,
        BinaryConfusionMatrix,
        BinaryF1Score,
        BinaryPrecision,
        BinaryRecall,
    )

    d = dict(validate_args=False, device=dev)
    t = CRITEO["thresholds"]
    return {
        "accuracy": BinaryAccuracy(**d), "precision": BinaryPrecision(**d), "recall": BinaryRecall(**d),
        "f1": BinaryF1Score(**d), "confmat": BinaryConfusionMatrix(**d),
        "auroc": BinaryAUROC(thresholds=t, **d), "ap": BinaryAveragePrecision(thresholds=t, **d),
    }


def _criteo_windowed(dev, window: int, executor: bool = True):
    """The windowed entry collection; ``executor`` reaches its members and
    its collection (on: every member's windowed update one replay)."""
    from torchmetrics_tpu_torch import MetricCollection

    return MetricCollection(_criteo_members(dev), device=dev).windowed(
        window, lateness=CRITEO["lateness"], executor=executor
    )


def _launch_counts() -> dict:
    from torchmetrics_tpu_torch.ops import bincount, binned_curve

    return {"bincount": bincount.launches, "binned_curve": binned_curve.launches}


def _launched(fn) -> tuple:
    """``fn()`` and the kernel launches it made."""
    before = _launch_counts()
    out = fn()
    after = _launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def _criteo_reference(dev, hours: list, clock: int):
    """A fresh unwindowed collection fed exactly the rows of ``hours``
    admitted by ``clock``: an hour's on-time batches once it has passed,
    its hour-late rows once they arrived (at the next clock)."""
    from torchmetrics_tpu_torch import MetricCollection

    ref = MetricCollection(_criteo_members(dev), device=dev)
    for h in hours:
        if h >= clock:
            continue
        data = _criteo_hour(h, dev)
        for batch in data["on"]:
            ref.update(*batch)
        ref.update(*data["late"])
    return ref


def _criteo_hard_check(dev, wc, clock: int) -> dict:
    """At ``clock``: every member's folded ring bit-equal to a fresh
    collection fed the live windows' admitted rows, and ``compute_window(k)``
    of every live k bit-equal to a fresh collection of window k's rows."""
    from torchmetrics_tpu_torch.parallel.sync import live_window_mask

    w = CRITEO["window"]
    live = list(range(max(0, clock - w + 1), clock + 1))
    ref = _criteo_reference(dev, live, clock)
    for name, m in wc.items():
        folded = m._fold_windows(m._state, live_window_mask(m._state["window_head"], w))
        for f, v in folded.items():
            _check(v.equal(ref[name]._state[f]), f"criteo: at clock {clock} the folded {name}.{f} differs from the live windows' rows")
    t0 = time.perf_counter()
    windows = {k: wc.compute_window(k) for k in live}
    _sync(dev)
    window_ms = (time.perf_counter() - t0) * 1e3 / len(live)
    for k in live:
        want = _criteo_reference(dev, [k], clock).compute()
        for name, v in windows[k].items():
            _check(_bit_equal(v, want[name]), f"criteo: compute_window({k}) {name} differs at clock {clock}")
    return {"clock": clock, "live": [live[0], live[-1]], "compute_window_ms": window_ms}


def _criteo_ring_bench(dev, window: int) -> dict:
    """Advance and update µs of the windowed collection at one ring size,
    with its executor (``update``) and without (``update_off``), against
    the unwindowed update of the same batch: host wall time of
    ``bench_calls`` calls ending in a synchronise; the stream's elapsed
    time between CUDA events around them (which counts the device's waits
    for the host); and the device's busy time from ``torch.profiler`` over
    8 calls (the kernels' own time, which the ring copies grow). The
    warm-up builds the executor's key and passes its verdict (its timed
    replay and two eager trials)."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection

    calls = CRITEO["bench_calls"]
    batch = _criteo_hour(0, dev)["on"][0]
    wc = _criteo_windowed(dev, window)
    off = _criteo_windowed(dev, window, executor=False)
    plain = MetricCollection(_criteo_members(dev), device=dev)
    for _ in range(3):  # groups resolved, allocator warm
        wc.update(*batch)
        off.update(*batch)
        plain.update(*batch)
        wc.advance()
        off.advance()
    for _ in range(4):  # the key's timed replay, its eager trials, the verdict
        wc.update(*batch)
    out = {"window": window}
    for name, fn in (("advance", lambda: wc.advance()), ("update", lambda: wc.update(*batch)),
                     ("update_off", lambda: off.update(*batch)),
                     ("unwindowed_update", lambda: plain.update(*batch))):
        _sync(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        _sync(dev)
        out[f"{name}_us"] = (time.perf_counter() - t0) * 1e6 / calls
        out[f"{name}_event_us"] = start.elapsed_time(end) * 1e3 / calls
        rows, _ = _profiled(lambda i, fn=fn: fn(), 8)
        out[f"{name}_device_us"] = sum(r[1] for r in rows) / 8
    held = {id(v): v.nbytes for m in wc.collection._modules.values() for v in m._state.values()}
    out["ring_bytes"] = sum(held.values())  # a compute group's rings once
    stats = wc.collection.executor_status["stats"]
    out["executor"] = {"engaged": stats["calls"] > 0, "fallback_reason": stats["fallback_reason"],
                       "eager_keys": stats["eager"]["keys"], "copied_calls": stats["copied_calls"]}
    return out


def _criteo_same(a, b, clock: int, what: str) -> None:
    """The executor-on collection ``a`` bit-equal to its executor-off twin
    ``b`` at ``clock``: every member's state (the rings and the clock),
    ``compute()`` and every live ``compute_window``."""
    for name, m in a.items():
        for f, v in m._state.items():
            _check(v.equal(b[name]._state[f]), f"criteo: at clock {clock} {what}: {name}.{f} differs")
    _check(_bit_equal(a.compute(), b.compute()), f"criteo: at clock {clock} {what}: compute() differs")
    w = CRITEO["window"]
    for k in range(max(0, clock - w + 1), clock + 1):
        _check(_bit_equal(a.compute_window(k), b.compute_window(k)), f"criteo: at clock {clock} {what}: compute_window({k}) differs")


def _criteo_executor_report(wc) -> dict:
    """The windowed collection's executor: engaged, its keys and captures,
    the eager keys and why, the calls copied in and donated, capture ms,
    pool and static bytes; each member's updates ride the collection's
    executor (a member's own never runs), so a member counts as engaged
    where the collection's did and names no fallback of its own."""
    status = wc.collection.executor_status
    stats = status["stats"]
    ex = wc.collection._get_executor()
    members = {
        name: {"engaged": status["engaged"], "fallback_reason": m["fallback_reason"]}
        for name, m in status["members"].items()
    }
    return {
        "engaged": status["engaged"], "fallback_reason": status["fallback_reason"], "members": members,
        "captured": stats["captured"], "keys": stats["cached_executables"], "captures": stats["compiles"],
        "calls": stats["calls"], "cache_hits": stats["cache_hits"], "padded_calls": stats["padded_calls"],
        "skipped_calls": stats["skipped_calls"], "copied_calls": stats["copied_calls"],
        "donated_calls": stats["donated_calls"], "eager_keys": stats["eager"]["keys"],
        "eager_calls": stats["eager"]["calls"], "eager_reasons": stats["eager"]["reasons"],
        "capture_ms_total": stats["compile_us_total"] / 1e3,
        "pool_bytes": ex.graph_pool_bytes(), "static_bytes": ex.static_bytes(),
    }


def phase_criteo_kaggle_hourly_windows(dev) -> dict:
    """The Criteo train set's 168 hours through the windowed entry
    collection ``MetricCollection(...).windowed(24, lateness=1)`` with its
    captured executor (``executor=True``: one replay an update, the slot read
    on the device) and an ``executor=False`` twin fed the same traffic:
    each hour's on-time batches, then ``advance()`` (under sync debug mode
    "error") and ``compute()``; 1% of an hour delivered after the next
    advance by ``update_window`` (admitted), 0.1% two hours late (dropped);
    ``compute_async()`` at every 24th close, resolved after the next hour's
    updates; at hour 100's close a save to a rotating store, restored into a
    fresh collection that runs on beside the first (the twin saves and
    restores in place, after a reset).
    Checks: at clocks 24, 100 and 168 the folded ring and every live
    ``compute_window`` bit-equal to fresh collections of the admitted rows,
    and the executor run bit-equal to its twin (states, compute, every live
    window); every async read bit-equal to the compute at its close; the
    restored runs bit-equal to the uninterrupted one; the manifest's windows
    block; the windows.* counters; the executor engaged for every member
    with no fallback and no padding; kernel launches equal to the
    unwindowed collection's and the twin's for the landed batches (none for
    a dropped one). Printed: rows/s and update µs windowed on and off
    against unwindowed, advance and update µs (host, events, device) at W =
    24 and 168 on and off, the executor's keys, captures, eager keys,
    copied calls, capture ms, pool and static bytes, compute,
    compute_window and save/restore ms, peak memory above base."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection, obs
    from torchmetrics_tpu_torch.io import load_manifest, restore_state, save_state
    from torchmetrics_tpu_torch.ops.async_read import drain_pipeline

    spec = CRITEO
    hours, w = spec["hours"], spec["window"]
    bench = [_criteo_ring_bench(dev, k) for k in spec["bench_windows"] + spec["bench_windows"]][len(spec["bench_windows"]):]
    obs.reset()
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    wc = _criteo_windowed(dev, w)
    off = _criteo_windowed(dev, w, executor=False)
    plain = MetricCollection(_criteo_members(dev), device=dev)
    twin = None
    store, store_off = str(_runtime_dir("criteo")), str(_runtime_dir("criteo_off"))
    win_launches = {"bincount": 0, "binned_curve": 0}
    plain_launches = {"bincount": 0, "binned_curve": 0}
    off_launches = {"bincount": 0, "binned_curve": 0}
    landed = dropped_launches = 0
    secs = {"win": 0.0, "plain": 0.0, "off": 0.0}
    on_rows = on_calls = 0
    compute_ms, checks, reads, pending = [], [], [], []
    late, later = {}, {}
    save = None

    def land(fn_win, fn_plain, fn_off):
        nonlocal landed
        _, a = _launched(fn_win)
        _, b = _launched(fn_plain)
        _, c = _launched(fn_off)
        for k in win_launches:
            win_launches[k] += a[k]
            plain_launches[k] += b[k]
            off_launches[k] += c[k]
        landed += 1

    for clock in range(hours + 1):
        # the delayed clicks of earlier hours arrive
        if clock - 1 in late:
            rows = late.pop(clock - 1)
            if twin is not None:
                _check(twin.update_window(clock - 1, *rows), "criteo: the restored run dropped an hour-late batch")
            land(lambda: _check(wc.update_window(clock - 1, *rows), f"criteo: hour {clock - 1}'s late rows were dropped"),
                 lambda: plain.update(*rows),
                 lambda: _check(off.update_window(clock - 1, *rows), f"criteo: the twin dropped hour {clock - 1}'s late rows"))
        if clock - 2 in later:
            rows = later.pop(clock - 2)
            if twin is not None:
                _check(not twin.update_window(clock - 2, *rows), "criteo: the restored run admitted a two-hour-late batch")
            _check(not off.update_window(clock - 2, *rows), "criteo: the twin admitted a two-hour-late batch")
            got, n = _launched(lambda: wc.update_window(clock - 2, *rows))
            _check(not got, f"criteo: hour {clock - 2}'s two-hour-late rows were admitted")
            dropped_launches += sum(n.values())
        if clock in spec["checks"]:
            checks.append(_criteo_hard_check(dev, wc, clock))
            _criteo_same(wc, off, clock, "against executor=False")
        if clock == hours:
            break
        data = _criteo_hour(clock, dev)
        _sync(dev)
        kinds = ("win", "plain", "off")
        for kind in kinds[clock % 3:] + kinds[:clock % 3]:
            t0 = time.perf_counter()
            for batch in data["on"]:
                if kind == "win":
                    land(lambda: wc.update(*batch), lambda: None, lambda: None)
                else:
                    _, n = _launched(lambda: (plain if kind == "plain" else off).update(*batch))
                    for k in plain_launches:
                        (plain_launches if kind == "plain" else off_launches)[k] += n[k]
            _sync(dev)
            secs[kind] += time.perf_counter() - t0
        if twin is not None:
            for batch in data["on"]:
                twin.update(*batch)
        on_calls += len(data["on"])
        on_rows += sum(int(b[1].numel()) for b in data["on"])
        late[clock], later[clock] = data["late"], data["later"]
        # resolve the reads submitted at the previous close, after this hour's updates
        for at, future, value in pending:
            got = future.result(120.0)
            for k, v in value.items():
                _check(_bit_equal(got[k], v), f"criteo: the async read at clock {at} differs in {k}")
            reads.append(at)
        pending = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            wc.advance()
            off.advance()
            if twin is not None:
                twin.advance()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        futures = [wc.compute_async(), off.compute_async()] if wc.clock % spec["async_every"] == 0 else []
        _sync(dev)
        t0 = time.perf_counter()
        value = wc.compute()
        _sync(dev)
        compute_ms.append((time.perf_counter() - t0) * 1e3)
        pending = [(wc.clock, future, value) for future in futures]
        if wc.clock == spec["save_at"]:
            t0 = time.perf_counter()
            path = save_state(wc, store, keep=3)
            save_ms = (time.perf_counter() - t0) * 1e3
            block = load_manifest(path)["windows"]
            _check(block == {"window": w, "lateness": spec["lateness"], "clock": 100, "head": 4},
                   f"criteo: the manifest's windows block is {block}")
            twin = _criteo_windowed(dev, w)
            t0 = time.perf_counter()
            restore_state(store, twin)
            _sync(dev)
            save = {"save_ms": save_ms, "restore_ms": (time.perf_counter() - t0) * 1e3, "windows_block": block}
            _check(twin.clock == wc.clock, "criteo: the restored clock differs")
            # the twin goes on from its own save, restored in place (its
            # compute groups stay resolved, so its launches stay comparable)
            save_state(off, store_off, keep=3)
            off.reset()
            restore_state(store_off, off)
            _check(off.clock == wc.clock, "criteo: the twin's restored clock differs")
    for at, future, value in pending:
        got = future.result(120.0)
        for k, v in value.items():
            _check(_bit_equal(got[k], v), f"criteo: the async read at clock {at} differs in {k}")
        reads.append(at)
    _check(drain_pipeline(60.0), "criteo: the read pipeline did not drain")
    want_reads = [at for at in range(spec["async_every"], hours + 1, spec["async_every"]) for _ in range(2)]
    _check(reads == want_reads, f"criteo: async reads at {reads}")
    for name, m in wc.items():
        for f, v in m._state.items():
            _check(v.equal(twin[name]._state[f]), f"criteo: the restored run's {name}.{f} differs from the uninterrupted run's")
    peak = _peak_above(dev, base)
    counters = obs.counters_snapshot()
    members = len(wc.keys())
    # each member counts a late event or a drop (the JAX package walks the
    # members); the twin and the restored run deliver too, the restored
    # run from clock 100 on
    twin_clocks = hours - spec["save_at"] + 1
    want = {"windows.late_events": members * (2 * hours + twin_clocks),
            "windows.dropped_late": members * (2 * (hours - 1) + twin_clocks)}
    got = {k: int(counters.get(k, 0)) for k in want}
    _check(got == want, f"criteo: counters {got}, not {want}")
    # the unwindowed collection's executor pads its ragged batches: one
    # row-0 update a padded replay and one oracle a probe; the windowed
    # executor pads nothing
    report = _criteo_executor_report(wc)
    _check(report["engaged"] and report["fallback_reason"] is None,
           f"criteo: the windowed collection's executor did not engage: {report['fallback_reason']}")
    _check(all(m["engaged"] and m["fallback_reason"] is None for m in report["members"].values()),
           f"criteo: a windowed member steps aside: {report['members']}")
    _check(report["padded_calls"] == 0 and report["skipped_calls"] == 0, f"criteo: the windowed executor padded or skipped: {report}")
    plain_eager = {k: v - _executor_extra(plain) for k, v in plain_launches.items()}
    _check(win_launches == plain_eager, f"criteo: windowed launches {win_launches} != unwindowed {plain_eager} (executor's own removed)")
    _check(win_launches == off_launches, f"criteo: windowed launches {win_launches} != executor=False twin's {off_launches}")
    _check(win_launches["bincount"] == landed, f"criteo: {win_launches['bincount']} bincount launches for {landed} landed calls")
    _check(dropped_launches == 0, f"criteo: dropped batches launched {dropped_launches} kernels")
    out = {
        "phase": "criteo_kaggle_hourly_windows", "rows": spec["rows"], "hours": hours, "window": w,
        "landed_update_calls": landed, "on_time_calls": on_calls, "on_time_rows": on_rows,
        "bincount_launches": win_launches["bincount"], "binned_curve_launches": win_launches["binned_curve"],
        "unwindowed_launches": plain_launches, "compute_groups": sorted(map(sorted, wc.collection.compute_groups.values())),
        "rows_per_s": {"windowed": on_rows / secs["win"], "windowed_off": on_rows / secs["off"], "unwindowed": on_rows / secs["plain"]},
        "update_us": {"windowed": secs["win"] * 1e6 / on_calls, "windowed_off": secs["off"] * 1e6 / on_calls,
                      "unwindowed": secs["plain"] * 1e6 / on_calls},
        "executor": report, "ring_bench": bench,
        "compute_ms_p50": sorted(compute_ms)[len(compute_ms) // 2], "checks": checks, "async_reads": len(reads),
        "save_restore": save, "counters": got, "peak_mem_above_base_bytes": peak,
    }
    return _emit(out)


def _femnist_schedule(data: dict) -> dict:
    """The per-clock traffic: at clock t every writer's batch t (the full
    batches in one call, the short last batches in calls grouped by length);
    36 seeded writers' clocks skewed one window ahead after clock 0; 36
    others each send one batch one window late (admitted) and 36 more one
    batch two windows late (dropped)."""
    import numpy as np

    batch = FEMNIST["batch"]
    nb = [-(-len(t) // batch) for _, t in data["writers"]]
    rng = np.random.RandomState(SEED + 18_100)
    eligible = [w for w, n in enumerate(nb) if n >= 3]
    picked = rng.choice(eligible, 3 * FEMNIST["poisoned"], replace=False)
    k = FEMNIST["poisoned"]
    skewed = sorted(int(w) for w in picked[:k])
    # a full batch each (never the short last one): one late call a writer
    late = {int(w): int(rng.randint(1, nb[w] - 1)) for w in picked[k:2 * k]}
    later = {int(w): int(rng.randint(1, nb[w] - 1)) for w in picked[2 * k:]}
    clocks = max(nb)
    calls = []
    for t in range(clocks):
        full, tails = [], {}
        for w, (logits, target) in enumerate(data["writers"]):
            lo = t * batch
            if lo >= len(target) or late.get(w) == t or later.get(w) == t:
                continue
            hi = min(len(target), lo + batch)
            item = (w, (logits[lo:hi], target[lo:hi]))
            (full if hi - lo == batch else tails.setdefault(hi - lo, [])).append(item)
        calls.append([full] + [tails[r] for r in sorted(tails)])
    return {"nb": nb, "skewed": skewed, "late": late, "later": later, "clocks": clocks, "calls": calls}


def _femnist_window_plain(data: dict, sched: dict, clock: int, dev) -> "torch.Tensor":
    """Plain int64 ``(writers, 4, C, C)`` counts on the card: every batch
    that landed in a window live at ``clock`` (each writer's own clock: the
    skewed ones run one ahead), in its ring slot."""
    import numpy as np
    import torch

    c, batch, ring = FEMNIST["classes"], FEMNIST["batch"], FEMNIST_WINDOWS["window"]
    skewed = set(sched["skewed"])
    idx = []
    for w, (logits, target) in enumerate(data["writers"]):
        shift = 1 if w in skewed else 0
        own = clock + shift
        for b in range(sched["nb"][w]):
            if sched["later"].get(w) == b:
                continue  # dropped by the watermark
            if sched["late"].get(w) == b:
                if b + 1 > clock:
                    continue  # not delivered yet
                k = b
            else:
                if b > clock:
                    continue
                k = b + shift if b > 0 else 0  # batch 0 landed before the skew
            if not own - ring < k <= own:
                continue
            lo, hi = b * batch, min(len(target), (b + 1) * batch)
            pred = logits[lo:hi].argmax(1)
            idx.append(((w * ring + k % ring) * c + target[lo:hi]) * c + pred)
    flat = torch.from_numpy(np.concatenate(idx).astype(np.int64)).to(dev)
    out = torch.zeros(len(data["writers"]) * ring * c * c, dtype=torch.int64, device=dev)
    out.index_add_(0, flat, torch.ones_like(flat))
    return out.reshape(len(data["writers"]), ring, c, c)


#: the windowed lanes: a 4-batch ring per writer, lateness 1
FEMNIST_WINDOWS = {"window": 4, "lateness": 1, "check_clocks": (3, 9)}


def _femnist_rings_equal_plain(name: str, coll, plain, writers) -> None:
    """Every lane's confusion ring, stat-score rings and micro rings bit-equal
    to the plain per-window counts of its writer."""
    _check(_lane_rows(coll, writers, "confmat").to(plain.dtype).equal(plain),
           f"{name}: a lane's confusion ring differs from its plain count")
    stats = _stats_of(plain)
    for i, field in enumerate(("tp", "fp", "tn", "fn")):
        _check(_lane_rows(coll, writers, field, "f1").to(plain.dtype).equal(stats[i]),
               f"{name}: a lane's {field} ring differs from its plain count")
        _check(_lane_rows(coll, writers, field, "accuracy").to(plain.dtype).equal(stats[i].sum(-1)),
               f"{name}: a lane's micro {field} ring differs from its plain count")


def phase_femnist_writers_windowed(dev, data: dict) -> dict:
    """The ``femnist_writers`` traffic, not cut, clock by clock through the entry
    collection as ``.windowed(4, lateness=1).laned(capacity=1024)`` (grown
    to 4,096): at clock t every writer's batch t, then
    ``advance_windows()`` under sync debug mode "error" (the clock mirror
    warm); ``skew_clock`` runs 36 writers one window ahead; ``late_event``
    delivers 36 writers' batch one window late (admitted) and 36 others' two
    windows late (dropped). Checks, at two clocks and at the end: every
    lane's ring (every live window) and its folded value bit-equal to a
    plain count of the batches that landed there; one ``bincount`` launch
    per dispatched round and row chunk, ``lanes.rows_looped`` 0; exactly the
    36 two-late batches dropped. Printed: sessions/s windowed against the
    unwindowed rounds on the same writers, dispatch µs a round,
    ``lane_values`` ms, peak memory above base."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection, lanes, obs
    from torchmetrics_tpu_torch.lanes import lane_capacity_bucket
    from torchmetrics_tpu_torch.ops import bincount, ingest
    from torchmetrics_tpu_torch.ops import fused_classification as fc
    from torchmetrics_tpu_torch.testing import faults

    sched = _femnist_schedule(data)
    spec = FEMNIST_WINDOWS
    writers = list(range(len(data["writers"])))
    c = FEMNIST["classes"]
    chunk_rows = max(1, fc.ROW_BINS_LIMIT // (c * c))
    # the unwindowed rounds of ``femnist_writers`` on the same writers and calls (every
    # batch on time), for the rate
    ingest.reset_for_tests()
    plain_coll = lanes.LanedCollection(_femnist_members(dev), capacity=FEMNIST["capacity"])
    _sync(dev)
    t0 = time.perf_counter()
    for t, calls in enumerate(sched["calls"]):
        for call in calls:
            plain_coll.update_sessions(call)
        extra = [(w, _femnist_batch(data, w, t)) for w in list(sched["late"]) + list(sched["later"]) if sched["late"].get(w) == t or sched["later"].get(w) == t]
        if extra:
            plain_coll.update_sessions(extra)
    _sync(dev)
    unwindowed_s = time.perf_counter() - t0
    del plain_coll
    _check(ingest.drain_pipeline(60.0), "femnist_writers_windowed: the ingest pipeline did not drain")
    ingest.reset_for_tests()
    obs.reset()
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    coll = MetricCollection(_femnist_members(dev), device=dev).windowed(spec["window"], lateness=spec["lateness"]).laned(
        capacity=FEMNIST["capacity"]
    )
    bincount.launches = 0
    rounds, checked, peaks, advance_s = 0, [], [], 0.0
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(sched["clocks"] + 2):
        for w, b in sched["late"].items():
            if b + 1 == t:
                rounds += faults.late_event(coll, w, _femnist_batch(data, w, b), age=1)
        for w, b in sched["later"].items():
            if b + 2 == t:
                _check(faults.late_event(coll, w, _femnist_batch(data, w, b), age=2) == 0,
                       f"femnist_writers_windowed: writer {w}'s two-late batch landed")
        for call in sched["calls"][t] if t < sched["clocks"] else []:
            rounds += coll.update_sessions(call)
        if t == 0:
            for w in sched["skewed"]:
                faults.skew_clock(coll, coll.sessions[w], 1)
        if t in spec["check_clocks"]:
            _sync(dev)
            checked.append(t)
            peaks.append(_peak_above(dev, base))  # the traffic's peak, not the check's
            pause = time.perf_counter()
            _femnist_rings_equal_plain(f"femnist_writers_windowed at clock {t}", coll,
                                       _femnist_window_plain(data, sched, t, dev), writers)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 += time.perf_counter() - pause  # the checks are no traffic
        a0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            coll.advance_windows()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        advance_s += time.perf_counter() - a0
    _sync(dev)
    windowed_s = time.perf_counter() - t0
    launches = bincount.launches
    peaks.append(_peak_above(dev, base))
    _check(ingest.drain_pipeline(60.0), "femnist_writers_windowed: the ingest pipeline did not drain")
    counters, hist = obs.counters_snapshot(), obs.histograms_snapshot()
    end = sched["clocks"] + 2
    plain = _femnist_window_plain(data, sched, end, dev)
    _femnist_rings_equal_plain("femnist_writers_windowed at the end", coll, plain, writers)
    _sync(dev)
    t1 = time.perf_counter()
    values = coll.lane_values()
    _sync(dev)
    lane_values_ms = (time.perf_counter() - t1) * 1e3
    folded = torch.stack([values[w]["confmat"] for w in writers]).to(torch.int64)
    _check(folded.equal(plain.sum(1)), "femnist_writers_windowed: a lane's folded value differs from its plain count")
    want_capacity = max(FEMNIST["capacity"], lane_capacity_bucket(len(writers)))
    _check(coll.capacity == want_capacity, f"femnist_writers_windowed: capacity {coll.capacity}, not {want_capacity}")
    _check(launches == rounds, f"femnist_writers_windowed: {launches} bincount launches for {rounds} rounds of one row chunk")
    _check(len(writers) <= chunk_rows, "femnist_writers_windowed: a round spans more than one row chunk")
    _check(int(counters.get("lanes.rows_looped", 0)) == 0, f"femnist_writers_windowed: {counters.get('lanes.rows_looped')} rows looped")
    dropped, admitted = int(counters.get("windows.dropped_late", 0)), int(counters.get("windows.late_events", 0))
    _check(dropped == len(sched["later"]) and admitted == len(sched["late"]),
           f"femnist_writers_windowed: {dropped} dropped and {admitted} admitted late batches")
    clocks = coll.window_spec()["lane_clocks"]
    skewed = set(sched["skewed"])
    _check(all(clocks[coll.sessions[w]] == end + (w in skewed) for w in writers), "femnist_writers_windowed: lane clocks")
    # the device's busy time of one advance of the 4,096 x 4-slot rings
    rows, _ = _profiled(lambda i: coll.advance_windows(), 4)
    advance_device_us = sum(r[1] for r in rows) / 4

    def mean_us(name: str):
        h = hist.get(name) or {}
        return h["sum"] / h["count"] if h.get("count") else None

    out = {
        "phase": "femnist_writers_windowed", "writers": len(writers), "samples": int(data["counts"].sum()),
        "window": spec["window"], "lateness": spec["lateness"], "clocks": end, "capacity": coll.capacity,
        "rounds": rounds, "bincount_launches": launches, "rows_looped": int(counters.get("lanes.rows_looped", 0)),
        "skewed": len(sched["skewed"]), "late_admitted": admitted, "late_dropped": dropped, "checked_clocks": checked + [end],
        "sessions_per_s": {"windowed": len(writers) / windowed_s, "unwindowed": len(writers) / unwindowed_s},
        "seconds": {"windowed": windowed_s, "unwindowed": unwindowed_s, "advances": advance_s},
        "advance_windows_us": advance_s * 1e6 / end, "advance_windows_device_us": advance_device_us,
        "dispatch_us_per_round": mean_us("lanes.dispatch_us"),
        "windows_advance_us": mean_us("windows.advance_us"), "lane_values_ms": lane_values_ms,
        "lane_values_route": coll["confmat"]._lane_route(), "peak_mem_above_base_bytes": max(peaks),
        "confmat_ring_bytes": coll["confmat"]._state["confmat"].nbytes,
    }
    return _emit(out)


def _femnist_batch(data: dict, w: int, b: int) -> tuple:
    logits, target = data["writers"][w]
    batch = FEMNIST["batch"]
    return logits[b * batch:(b + 1) * batch], target[b * batch:(b + 1) * batch]


# ------------------------------ class sharding, the deferred layouts, the quantized sync


#: Google Landmarks Dataset v2, the clean training set (Weyand et al., CVPR
#: 2020; the Kaggle Landmark Recognition 2020 training set): 1,580,470
#: images of 81,313 landmark classes, scored in batches of 4,096 (385 full
#: batches and one of 3,510). Cut: the real per-class counts need
#: ``train_clean.csv``, which the repository does not hold, so the labels
#: follow a Zipf law (s = 1) over the classes, drawn from the seed; a
#: prediction is the target with probability 0.6, else uniform over the
#: classes. Every metric runs with ``state_sharding="class_axis"`` over 8
#: class shards: the confusion state is (8, 10,165, 81,313) int32, 26.45 GB,
#: and an out-of-place update holds two of it (52.9 GB).
GLDV2 = {"images": 1_580_470, "classes": 81_313, "batch": 4_096, "zipf_s": 1.0, "top1": 0.6, "class_shards": 8}
#: accuracy and macro F1 against float64 values of the host's counts
GLDV2_ATOL = 1e-6
#: the deferred layouts: 8 stacked shards, the ImageNet snapshot taken
#: after batch 24 and resumed on 4 shards
DEFERRED = {"shards": 8, "resume_after": 24, "resume_shards": 4}
#: the quantized rows of the sync phase
QUANT = {"bits": (8, 16), "block": 256}


def _gldv2_labels(dev):
    """Every image's (target, prediction), int64 on the card, from the seed."""
    import torch

    spec = GLDV2
    c, n = spec["classes"], spec["images"]
    g = torch.Generator(device=dev).manual_seed(SEED + 19_000)
    weights = torch.arange(1, c + 1, dtype=torch.float64, device=dev) ** -spec["zipf_s"]
    cdf = torch.cumsum(weights, 0) / weights.sum()
    rank = torch.searchsorted(cdf, torch.rand(n, generator=g, dtype=torch.float64, device=dev)).clamp_(max=c - 1)
    target = torch.randperm(c, generator=g, device=dev)[rank]
    hit = torch.rand(n, generator=g, device=dev) < spec["top1"]
    pred = torch.where(hit, target, torch.randint(0, c, (n,), generator=g, device=dev))
    return target, pred


def phase_gldv2_clean_class_sharded(dev) -> dict:
    """GLDv2-clean's 1,580,470 images through a class-sharded collection
    (confusion matrix, micro accuracy, macro F1; ``class_shards=8``).
    Checks: the confusion total equals the images; the cell of every
    distinct (target, pred) pair, gathered on the card, equals the host's
    ``np.unique`` count, and ``count_nonzero`` equals the number of pairs
    (so the counts are exact without a 26 GB host copy); the 7 pad rows are
    zero; accuracy and F1 within 1e-6 of float64 from the host's counts;
    one ``bincount`` launch an update (the stat-scores group's 3C count) and
    none for the routed confusion matrix. Printed: update ms (wall and
    device), compute ms, peak memory against the reckoning."""
    import gc

    import numpy as np
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score
    from torchmetrics_tpu_torch.ops import bincount

    spec = GLDV2
    c, shards, step = spec["classes"], spec["class_shards"], spec["batch"]
    target, pred = _gldv2_labels(dev)
    n = int(target.numel())
    _sync(dev)
    gc.collect()  # the state needs 53 GB: no earlier phase's garbage may hold the card
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kw = {"num_classes": c, "validate_args": False, "state_sharding": "class_axis", "class_shards": shards, "device": dev}
    coll = MetricCollection({
        "confmat": MulticlassConfusionMatrix(**kw),
        "accuracy": MulticlassAccuracy(average="micro", **kw),
        "f1": MulticlassF1Score(average="macro", **kw),
    }, device=dev)
    cm = coll["confmat"]
    layout = cm._class_layout("confmat")
    _check(layout is not None and tuple(cm.confmat.shape) == (shards, layout.shard_size, c),
           f"gldv2: the confusion state is {tuple(cm.confmat.shape)}, not the class stack")
    _check(coll["f1"]._class_layout("tp") is not None and coll["accuracy"]._class_layout("tp") is None,
           "gldv2: F1's per-class counts must be class-sharded, micro accuracy's scalars replicated")
    state_bytes = cm.confmat.numel() * cm.confmat.element_size()
    bincount.launches = 0
    wall_ms, device_ms = [], []
    for lo in range(0, n, step):
        p, t = pred[lo:lo + step], target[lo:lo + step]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _sync(dev)
        t0 = time.perf_counter()
        start.record()
        coll.update(p, t)
        end.record()
        _sync(dev)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    launches = bincount.launches
    updates = len(wall_ms)
    peak = _peak_above(dev, base)
    t0 = time.perf_counter()
    result = coll.compute()
    _sync(dev)
    compute_ms = (time.perf_counter() - t0) * 1e3
    dense = result["confmat"]
    _check(updates == -(-spec["images"] // step), f"gldv2: {updates} updates")
    _check(launches == updates, f"gldv2: {launches} bincount launches for {updates} updates (one an update, none for the route)")
    total = int(dense.sum())
    _check(total == n, f"gldv2: the confusion total {total} is not the {n} images")
    t_h, p_h = target.cpu().numpy(), pred.cpu().numpy()
    pairs, counts = np.unique(t_h * c + p_h, return_counts=True)
    rows = torch.from_numpy(pairs // c).to(dev)
    cols = torch.from_numpy(pairs % c).to(dev)
    got = dense[rows, cols].to(torch.int64).cpu().numpy()
    _check(np.array_equal(got, counts), "gldv2: a (target, pred) cell differs from the host's count")
    nonzero = sum(int(torch.count_nonzero(cm.confmat[s])) for s in range(shards))
    _check(nonzero == len(pairs), f"gldv2: {nonzero} nonzero cells for {len(pairs)} distinct pairs")
    pad = cm.confmat.reshape(-1, c)[c:]
    _check(pad.shape[0] == layout.padded_classes - c and not bool(pad.any()), "gldv2: a pad row holds a count")
    hits = t_h == p_h
    tp = np.bincount(t_h[hits], minlength=c).astype(np.float64)
    fp = np.bincount(p_h, minlength=c) - tp
    fn = np.bincount(t_h, minlength=c) - tp
    present = (tp + fp + fn) > 0
    den = 2 * tp + fp + fn
    f1 = np.where(den > 0, 2 * tp / np.where(den > 0, den, 1), 0.0)
    want = {"accuracy": tp.sum() / n, "f1": f1[present].mean()}
    errors = {k: abs(float(result[k]) - v) for k, v in want.items()}
    for k, err in errors.items():
        _check(err <= GLDV2_ATOL, f"gldv2: {k} {float(result[k])} is {err} from float64 {want[k]}")
    reckoned = {"state_bytes": layout.padded_classes * c * 4, "update_peak_bytes": 2 * layout.padded_classes * c * 4,
                "update_ms_at_3.35TB/s": 2 * layout.padded_classes * c * 4 / HBM_BYTES_PER_S * 1e3}
    _check(state_bytes == reckoned["state_bytes"], f"gldv2: the state holds {state_bytes} bytes")
    ms = sorted(wall_ms)
    dms = sorted(device_ms)
    out = {
        "phase": "gldv2_clean_class_sharded", "images": n, "classes": c, "class_shards": shards,
        "shard_size": layout.shard_size, "pad_rows": layout.padded_classes - c, "updates": updates,
        "bincount_launches": launches, "distinct_pairs": len(pairs),
        "update_ms": {"p50": ms[updates // 2], "p90": ms[(9 * updates) // 10], "max": ms[-1], "mean": sum(ms) / updates},
        "update_device_ms": {"p50": dms[updates // 2], "mean": sum(dms) / updates},
        "compute_ms": compute_ms, "state_bytes": state_bytes, "peak_mem_above_base_bytes": peak,
        "reckoned": reckoned, "abs_err": errors, "values": {k: float(result[k]) for k in want},
    }
    del result, dense, pad
    _emit(out)
    # the finished collection, for gldv2_clean_audited's second pass
    out["_reuse"] = {"coll": coll, "target": target, "pred": pred}
    return out


def _deferred_update(coll, states: dict, shard: int, batch) -> dict:
    """One batch into shard ``shard`` of a collection's stacked states: the
    shard's slice updated by ``functional_update`` (every leader sharing
    one count), written back out of place."""
    import torch

    sub = {leader: {k: v[shard] for k, v in st.items()} for leader, st in states.items()}
    new = coll.functional_update(sub, *batch)
    out = {}
    for leader, st in states.items():
        idx = torch.tensor([shard], device=next(iter(st.values())).device)
        out[leader] = {k: v.index_copy(0, idx, new[leader][k].unsqueeze(0)) for k, v in st.items()}
    return out


def _deferred_collection(dev):
    """The ImageNet collection with ``reduce="deferred"``, its compute groups
    resolved on batch 0."""
    from torchmetrics_tpu_torch import MetricCollection

    members = dict(_imagenet(dev)["collection"]().items(keep_base=True))
    coll = MetricCollection(members, reduce="deferred", device=dev)
    coll.resolve_compute_groups(*_imagenet_batch(0, dev))
    return coll


def _fields(states: dict) -> dict:
    from torchmetrics_tpu_torch import Metric

    return {leader: {k: v for k, v in st.items() if k not in Metric._RESERVED_STATE_KEYS} for leader, st in states.items()}


def phase_imagenet_val_deferred(dev) -> dict:
    """ImageNet-1k val's collection with ``reduce="deferred"`` over 8 stacked
    shards, batch b into shard b mod 8. Checks: ``reduce_sharded_states``
    bit-equal to the eager collection's counts (and the computed values);
    ``reshard_states`` 8 -> 4 -> 1 and 8 -> 1 reduce to the same counts; a
    snapshot saved after batch 24 on 8 shards restores elastic onto 4
    (``restore_state(..., topology="elastic", num_shards=4)``), finishes on
    4 and reduces bit-equal to the uninterrupted run; one ``bincount``
    launch an update. Printed: update, reduce, reshard, save and restore ms."""
    import torch

    from torchmetrics_tpu_torch.io import checkpoint
    from torchmetrics_tpu_torch.ops import bincount

    spec = DEFERRED
    n = len(IMAGENET["batches"])
    shards = spec["shards"]
    eager = _imagenet(dev)["collection"]()
    for i in range(n):
        eager.update(*_imagenet_batch(i, dev))
    want = _fields(eager.state())
    want_values = eager.compute()
    coll = _deferred_collection(dev)
    states = coll.init_sharded_states(shards)
    store = _runtime_dir("imagenet_val_deferred")
    bincount.launches = 0
    update_ms, snapshot = [], None
    for i in range(n):
        batch = _imagenet_batch(i, dev)
        _sync(dev)
        t0 = time.perf_counter()
        states = _deferred_update(coll, states, i % shards, batch)
        _sync(dev)
        update_ms.append((time.perf_counter() - t0) * 1e3)
        if i == spec["resume_after"]:
            export = {leader: {**st, "_update_count": i + 1} for leader, st in states.items()}
            t0 = time.perf_counter()
            snapshot = checkpoint.save_state(coll, str(store / "at24.ckpt"), states=export, sharded=True)
            save_ms = (time.perf_counter() - t0) * 1e3
    launches = bincount.launches
    _check(launches == n, f"imagenet_val_deferred: {launches} bincount launches for {n} updates")
    t0 = time.perf_counter()
    reduced = coll.reduce_sharded_states(states)
    _sync(dev)
    reduce_ms = (time.perf_counter() - t0) * 1e3
    _check(reduced.keys() == want.keys(), f"imagenet_val_deferred: leaders {sorted(reduced)} != {sorted(want)}")
    _check(_bit_equal(reduced, want), "imagenet_val_deferred: the reduced counts differ from the eager collection's")
    _check(_bit_equal(coll.functional_compute(reduced), want_values), "imagenet_val_deferred: the values differ from the eager ones")
    t0 = time.perf_counter()
    four = coll.reshard_states(states, 4)
    one = coll.reshard_states(four, 1)
    _sync(dev)
    reshard_ms = (time.perf_counter() - t0) * 1e3
    for name, st, s in (("8->4", four, 4), ("8->4->1", one, 1), ("8->1", coll.reshard_states(states, 1), 1)):
        _check(all(v.shape[0] == s for sub in st.values() for v in sub.values()), f"imagenet_val_deferred: {name} shard axis")
        _check(_bit_equal(coll.reduce_sharded_states(st), want), f"imagenet_val_deferred: reshard {name} changed the counts")
    # the elastic restore: 8 shards saved after batch 24, resumed on 4
    resumed = _deferred_collection(dev)
    t0 = time.perf_counter()
    manifest = checkpoint.restore_state(snapshot, resumed, topology="elastic", num_shards=spec["resume_shards"])
    _sync(dev)
    restore_ms = (time.perf_counter() - t0) * 1e3
    _check(manifest["topology_action"] == "reshard", f"imagenet_val_deferred: restore action {manifest['topology_action']}")
    _check(resumed.executor_status["deferred_pending"], "imagenet_val_deferred: the restored stack does not report a pending reduction")
    rest = _fields(resumed.state())
    _check(all(v.shape[0] == spec["resume_shards"] for sub in rest.values() for v in sub.values()),
           "imagenet_val_deferred: the restored stack is not on 4 shards")
    for i in range(spec["resume_after"] + 1, n):
        rest = _deferred_update(resumed, rest, i % spec["resume_shards"], _imagenet_batch(i, dev))
    _check(_bit_equal(resumed.reduce_sharded_states(rest), want),
           "imagenet_val_deferred: the run resumed on 4 shards differs from the uninterrupted one")
    ms = sorted(update_ms)
    out = {
        "phase": "imagenet_val_deferred", "updates": n, "shards": shards, "bincount_launches": launches,
        "leaders": sorted(reduced), "state_bytes_stacked": sum(_state_bytes(st) for st in states.values()),
        "update_ms": {"p50": ms[n // 2], "max": ms[-1], "mean": sum(ms) / n},
        "reduce_ms": reduce_ms, "reshard_8_4_1_ms": reshard_ms, "save_ms": save_ms, "restore_elastic_ms": restore_ms,
        "resumed_on": spec["resume_shards"], "bit_equal": True,
    }
    return _emit(out)


#: the deferred collection step's phase: the stacked shard counts (one
#: card's deployment, and 8 shards as a data-parallel rank stacks them),
#: the shadow's and the audits' cadence, the step the degraded read and the
#: recovery are taken at, and the elastic restore's point and target
DEFERRED_STEP = {"shards": (1, 8), "every": 8, "lost_at": 46, "resume_after": 24, "resume_shards": 4, "ship_after": 16}


def _step_batches(dev) -> list:
    """ImageNet's 49 batches on the card, made once by index."""
    return [_imagenet_batch(i, dev) for i in range(len(IMAGENET["batches"]))]


def _eager_reference(dev, batches: list, keep=()) -> dict:
    """The eager collection (executor off) over ``batches``: its leader
    fields after each count in ``keep``, its final fields and values, and
    the median ms of an update."""
    import torch

    coll = _imagenet(dev)["collection"](executor=False)
    kept, update_ms = {}, []
    for i, batch in enumerate(batches):
        _sync(dev)
        t0 = time.perf_counter()
        coll.update(*batch)
        _sync(dev)
        update_ms.append((time.perf_counter() - t0) * 1e3)
        if i + 1 in keep:
            kept[i + 1] = {leader: {k: v.clone() for k, v in st.items()} for leader, st in _fields(coll.state()).items()}
    return {"fields": _fields(coll.state()), "values": coll.compute(), "kept": kept, "update_ms": update_ms}


def _same_counts(name: str, got: dict, want: dict) -> None:
    """Leader-keyed host (numpy) or device counts against the eager
    collection's fields, bit for bit."""
    import numpy as np

    _check(sorted(got) == sorted(want), f"{name}: leaders {sorted(got)} != {sorted(want)}")
    for leader, sub in want.items():
        for k, v in sub.items():
            g = got[leader][k]
            g = g.detach().cpu().numpy() if hasattr(g, "detach") else np.asarray(g)
            _check(np.array_equal(g, v.detach().cpu().numpy()), f"{name}: {leader}.{k} differs from the eager collection's")


def _same_values(name: str, got: dict, want: dict) -> None:
    import numpy as np

    for k, v in want.items():
        w = v.detach().cpu().numpy()
        g = np.asarray(got[k].detach().cpu().numpy() if hasattr(got[k], "detach") else got[k])
        _check(g.shape == w.shape and np.array_equal(g, w), f"{name}: value {k} differs from the eager collection's")


def phase_imagenet_val_deferred_step(dev) -> dict:
    """ImageNet-1k val's collection (1,000 classes, 48 batches of 1,024 and
    one of 848) through ``make_deferred_collection_step`` at S = 1 (one
    card's deployment) and S = 8 stacked shards: ``local_step`` over every
    batch, and ``local_epoch`` over the 48 full batches as one chunk (one
    captured graph of 48 x S shard updates) then the last batch by
    ``local_step``. Checks: ``reduce`` counts bit-equal to the eager
    collection's and values equal; ``reduce_async`` equal to ``reduce``;
    one capture a key (a step's two batch sizes, the epoch); S ``bincount``
    launches a step (one a shard's update: 49 S a run, the same by epoch);
    a donated states tree handed back raises. On 8 shards: the shadow every
    8 steps, with ``drop_shard`` under ``"raise"``, ``"degraded"`` (after
    45 steps: 4 behind the shadow's refresh at 41, the value of the eager
    counts at 41) and ``"restore"`` (step 46 is lost: the run resumes from
    the shadow at 41 and re-applies that step's batch: the eager counts of
    batches 0-40 and 45-48);
    ``attach_integrity`` with ``skew_replica(states, shard=3)`` names shard
    3; the states after batch 24 restored onto 4 shards finish bit-equal;
    ``export_canonical`` equals the folded reduce; ``export_delta`` through
    ``deferred_source`` into a ``LeafExporter`` and an ``Aggregator`` is
    bit-equal to the fold; the quantized export decodes within
    ``reduce_error_bound`` (the ImageNet fields are integers: raw).
    Printed: us a ``local_step`` against an eager collection update, ms a
    48-step ``local_epoch`` against 48 eager updates, reduce ms, capture
    ms, pool and static bytes, the peak."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.fleet import Aggregator, LeafExporter, Uplink, deferred_source
    from torchmetrics_tpu_torch.ops import bincount, fingerprint
    from torchmetrics_tpu_torch.ops.async_read import drain_pipeline
    from torchmetrics_tpu_torch.ops.executor import make_deferred_collection_step
    from torchmetrics_tpu_torch.parallel import quantized
    from torchmetrics_tpu_torch.quarantine import DegradedValue
    from torchmetrics_tpu_torch.testing import faults
    from torchmetrics_tpu_torch.utils.exceptions import ShardLossError, StateDivergenceError, TorchMetricsUserError

    spec = DEFERRED_STEP
    t_phase = time.perf_counter()
    batches = _step_batches(dev)
    n, full = len(batches), len(batches) - 1
    lost_at, every = spec["lost_at"], spec["every"]
    kept_at = lost_at - (lost_at - 1) % every  # the shadow's last refresh before the loss: 41
    audit_at = max(range(every - 1, lost_at, every))  # the audits' last capture before it: 39
    eager = _eager_reference(dev, batches, keep=(kept_at, spec["resume_after"]))
    want, want_values = eager["fields"], eager["values"]
    # the restore policy's run: the shadow's prefix, then the lost step's batch on
    survivor = _eager_reference(dev, batches[:kept_at] + batches[lost_at - 1:])["fields"]
    chunk = [torch.stack([b[i] for b in batches[:full]]) for i in range(2)]
    out = {"phase": "imagenet_val_deferred_step", "updates": n, "runs": {}}
    launches_total = 0
    for shards in spec["shards"]:
        row = {}
        # ---- local_step over every batch
        coll = _deferred_collection(dev)
        step = make_deferred_collection_step(coll, mesh=shards)
        _sync(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        bincount.launches = 0
        states, step_ms, snapshot, spent = step.init_states(), [], None, None
        for i, batch in enumerate(batches):
            _sync(dev)
            t0 = time.perf_counter()
            states = step.local_step(states, *batch)
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i + 1 == spec["resume_after"]:
                snapshot = {leader: {**{k: v.clone() for k, v in sub.items()}, "_sharded_shards": shards} for leader, sub in states.items()}
            if i == n - 2:
                spent = states  # donated to the last step: its slot is the other one
        launches = bincount.launches
        launches_total += launches
        _check(launches == shards * n, f"imagenet_val_deferred_step: S={shards}: {launches} bincount launches, {shards * n} expected (one a shard a step)")
        _check(step.stats["compiles"] == 2 and step.stats["cache_hits"] == n - 2,
               f"imagenet_val_deferred_step: S={shards}: keys {step.stats} (two batch sizes: two captures)")
        _check(step.stats["donated_calls"] == n - 1, f"imagenet_val_deferred_step: S={shards}: donation {step.stats}")
        t0 = time.perf_counter()
        got = step.reduce(states)
        reduce_ms = (time.perf_counter() - t0) * 1e3
        folded = coll.reduce_sharded_states(states)
        _same_counts(f"imagenet_val_deferred_step: S={shards} fold", folded, want)
        _same_values(f"imagenet_val_deferred_step: S={shards} reduce", got, want_values)
        pending = step.reduce_async(states)
        _same_values(f"imagenet_val_deferred_step: S={shards} reduce_async", pending.result(60.0), want_values)
        raised = False
        try:
            step.local_step(spent, *batches[0])
        except TorchMetricsUserError:
            raised = True
        _check(raised, f"imagenet_val_deferred_step: S={shards}: a spent (donated) states tree was accepted")
        _same_counts(f"imagenet_val_deferred_step: S={shards} after the refused call", coll.reduce_sharded_states(states), want)
        canonical = step.export_canonical(states)
        _same_counts(f"imagenet_val_deferred_step: S={shards} export_canonical", canonical, want)
        row.update({
            "local_step_us_p50": statistics.median(step_ms[1:full]) * 1e3,
            "eager_update_us_p50": statistics.median(eager["update_ms"][1:full]) * 1e3,
            "first_step_ms": step_ms[0], "ragged_step_ms": step_ms[-1], "reduce_ms": reduce_ms,
            "capture_ms": step.stats["capture_us_total"] / 1e3, "stats": dict(step.stats),
            "static_bytes": step.static_bytes(), "graph_pool_bytes": step.graph_pool_bytes(),
            "peak_above_base_bytes": torch.cuda.max_memory_allocated(dev) - base, "bincount_launches": launches,
        })
        del states, spent
        # ---- the 48 full batches as one local_epoch, then the last by local_step
        coll_e = _deferred_collection(dev)
        epoch_step = make_deferred_collection_step(coll_e, mesh=shards)
        bincount.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        st = epoch_step.local_epoch(epoch_step.init_states(), *chunk)
        _sync(dev)
        first_epoch_ms = (time.perf_counter() - t0) * 1e3
        st = epoch_step.local_step(st, *batches[-1])
        launches = bincount.launches
        launches_total += launches
        _check(launches == shards * n, f"imagenet_val_deferred_step: S={shards} epoch: {launches} bincount launches, {shards * n} expected")
        _check(epoch_step.steps == n, f"imagenet_val_deferred_step: S={shards} epoch: {epoch_step.steps} steps")
        _same_values(f"imagenet_val_deferred_step: S={shards} epoch reduce", epoch_step.reduce(st), want_values)
        _same_counts(f"imagenet_val_deferred_step: S={shards} epoch fold", coll_e.reduce_sharded_states(st), want)
        bincount.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        again = epoch_step.local_epoch(epoch_step.init_states(), *chunk)  # the epoch key's replay
        _sync(dev)
        epoch_ms = (time.perf_counter() - t0) * 1e3
        launches_total += bincount.launches
        _check(bincount.launches == shards * full, f"imagenet_val_deferred_step: S={shards}: the epoch's replay launched {bincount.launches}")
        _check(epoch_step.stats["compiles"] == 2 and epoch_step.stats["cache_hits"] == 1,
               f"imagenet_val_deferred_step: S={shards} epoch keys {epoch_step.stats}")
        row.update({
            "epoch_ms": epoch_ms, "first_epoch_ms": first_epoch_ms, "eager_48_updates_ms": sum(eager["update_ms"][:full]),
            "epoch_capture_ms": epoch_step.stats["capture_us_total"] / 1e3,
            "epoch_static_bytes": epoch_step.static_bytes(), "epoch_graph_pool_bytes": epoch_step.graph_pool_bytes(),
            "epoch_stats": dict(epoch_step.stats),
        })
        del st, again, epoch_step, coll_e
        out["runs"][str(shards)] = row
        if shards != 8:
            del step, coll
            continue
        # ---- elastic restore: the states after batch 24 on 8 shards, onto 4
        step4 = make_deferred_collection_step(_deferred_collection(dev), mesh=spec["resume_shards"])
        t0 = time.perf_counter()
        st4 = step4.restore_states(snapshot, step_count=spec["resume_after"])
        restore_ms = (time.perf_counter() - t0) * 1e3
        bincount.launches = 0
        for batch in batches[spec["resume_after"]:]:
            st4 = step4.local_step(st4, *batch)
        launches_total += bincount.launches
        _same_values("imagenet_val_deferred_step: restored 8 -> 4", step4.reduce(st4), want_values)
        _same_counts("imagenet_val_deferred_step: restored 8 -> 4 export", step4.export_canonical(st4), want)
        row["restore_8_to_4_ms"] = restore_ms
        del step4, st4, snapshot
        # ---- the fleet: deferred_source into a LeafExporter and an Aggregator
        fleet_step = make_deferred_collection_step(_deferred_collection(dev), mesh=shards)
        live = {"states": fleet_step.init_states()}
        agg = Aggregator("agg/root")
        leaf = LeafExporter("leaf/imagenet", deferred_source(fleet_step, lambda: live["states"]), Uplink({"agg/root": agg}), "agg/root")
        bincount.launches = 0
        for i, batch in enumerate(batches):
            live["states"] = fleet_step.local_step(live["states"], *batch)
            if i + 1 == spec["ship_after"]:
                leaf.ship()
        launches_total += bincount.launches
        leaf.ship()
        view, _ = agg.canonical()
        _same_counts("imagenet_val_deferred_step: the aggregator's view",
                     {leader: {k: view[f"{leader}.{k}"] for k in sub} for leader, sub in want.items()}, want)
        _check(agg.total_update_count() == n, f"imagenet_val_deferred_step: the aggregator counts {agg.total_update_count()} steps")
        wire = fleet_step.export_canonical(live["states"], precision="quantized")
        for leader, sub in wire.items():
            dec = quantized.decode_canonical(sub)
            for k, v in want[leader].items():
                w = v.detach().cpu().numpy()
                if np.issubdtype(w.dtype, np.floating):
                    bound = quantized.reduce_error_bound(w[None], "max", 8, 256)
                    _check(bool((np.abs(dec[k] - w) <= bound + 1e-6).all()), f"imagenet_val_deferred_step: quantized {leader}.{k} past its bound")
                else:
                    _check(np.array_equal(dec[k], w), f"imagenet_val_deferred_step: quantized {leader}.{k} (an integer field rides raw)")
        row["fleet"] = {"shipped": 2, "wire_fields": sum(len(sub["fields"]) for sub in wire.values())}
        del fleet_step, live, agg, leaf
        # ---- the shadow every 8 steps, the shard-loss policies and the audits
        fault_step = make_deferred_collection_step(_deferred_collection(dev), mesh=shards)
        shadow = fault_step.attach_shadow(every_n_steps=every, on_shard_loss="degraded")
        integ = fault_step.attach_integrity(every_n_steps=every, on_divergence="raise")
        fingerprint.launches = 0
        bincount.launches = 0
        st = fault_step.init_states()
        for i, batch in enumerate(batches[: lost_at - 1]):
            st = fault_step.local_step(st, *batch)
            if i + 1 == audit_at:  # a capture at this step: audit, then a skewed copy
                drain_pipeline(60.0)
                _check(integ.audit(st).ok, "imagenet_val_deferred_step: a clean audit failed")
                skewed, info = faults.skew_replica(st, shard=3, seed=1)
                named = None
                try:
                    integ.audit(skewed)
                except StateDivergenceError as err:
                    named = err.shard
                _check(named == 3 == info["shard"], f"imagenet_val_deferred_step: the audit named shard {named}, not 3")
                del skewed
        drain_pipeline(60.0)
        behind = shadow.updates_behind(fault_step.steps)
        _check(behind is not None and behind <= every - 1 and fault_step.steps == lost_at - 1,
               f"imagenet_val_deferred_step: the shadow is {behind} steps behind step {fault_step.steps}")
        fault_step._on_shard_loss = "raise"
        raised = None
        with faults.drop_shard(fault_step, shard=2):
            try:
                fault_step.reduce(st)
            except ShardLossError as err:
                raised = err.shard
        _check(raised == 2, f"imagenet_val_deferred_step: the raise policy gave shard {raised}")
        fault_step._on_shard_loss = "degraded"
        with faults.drop_shard(fault_step, shard=0):
            degraded = fault_step.reduce(st)
        _check(isinstance(degraded, DegradedValue) and degraded.updates_behind == behind and degraded.age_updates == kept_at,
               f"imagenet_val_deferred_step: degraded read {getattr(degraded, 'updates_behind', None)} behind at {getattr(degraded, 'age_updates', None)}")
        _check(torch.equal(degraded.value["confmat"].to(torch.int64), eager["kept"][kept_at]["confmat"]["confmat"].to(torch.int64)),
               "imagenet_val_deferred_step: the degraded confusion matrix is not the eager one at the shadow's step")
        fault_step._on_shard_loss = "restore"
        with faults.drop_shard(fault_step, shard=5, fail_n=1):
            st = fault_step.local_step(st, *batches[lost_at - 1])  # lost, recovered, re-applied
        for batch in batches[lost_at:]:
            st = fault_step.local_step(st, *batch)
        _same_counts("imagenet_val_deferred_step: the run restored from the shadow", fault_step.export_canonical(st), survivor)
        launches_total += bincount.launches
        row["faults"] = {
            "shadow_refreshes": shadow.stats["refreshes"], "updates_behind": behind, "age_updates": kept_at,
            "integrity": dict(integ.stats), "audit_named_shard": 3, "raise_shard": raised,
            "restored_steps": fault_step.steps, "fingerprint_launches": fingerprint.launches,
        }
        out["fingerprint_launches"] = fingerprint.launches
        del fault_step, st, step, coll
    out.update({"bincount_launches": launches_total, "seconds": time.perf_counter() - t_phase, "bit_equal": True})
    del eager, survivor, batches, chunk
    gc.collect()
    torch.cuda.empty_cache()  # GLDv2's audited pass, later, needs 49 GB in one block
    return _emit(out)


def _femnist_rounds(data: dict, windowed: bool) -> list:
    """The FEMNIST traffic as low-level rounds ``(clock, writers, logits,
    targets)``: round b of the unwindowed run holds every writer's full batch
    b, then the shorter last batches grouped by length; the windowed run
    keeps that order clock by clock (clock t: every writer's batch t, full
    batches first)."""
    import numpy as np

    batch = FEMNIST["batch"]
    nb = [-(-len(t) // batch) for _, t in data["writers"]]
    out = []
    for t in range(max(nb)):
        groups = {}
        for w, (logits, target) in enumerate(data["writers"]):
            lo = t * batch
            if lo < len(target):
                hi = min(len(target), lo + batch)
                groups.setdefault(hi - lo, []).append((w, logits[lo:hi], target[lo:hi]))
        for size in sorted(groups, reverse=True):
            ws = groups[size]
            out.append((t, [w for w, _, _ in ws], np.stack([x for _, x, _ in ws]), np.stack([y for _, _, y in ws])))
    if windowed:
        return out
    full = [r for r in out if r[2].shape[1] == batch]
    tails = {}
    for r in out:
        if r[2].shape[1] != batch:
            tails.setdefault(r[2].shape[1], []).append(r)
    merged = [(0, sum((r[1] for r in rs), []), np.concatenate([r[2] for r in rs]), np.concatenate([r[3] for r in rs]))
              for _, rs in sorted(tails.items())]
    return full + merged


def _deferred_lane_run(dev, data: dict, window) -> dict:
    """Every writer's traffic through ``make_deferred_lane_step`` (8 shards)
    of three laned members (confusion matrix, macro F1, micro accuracy),
    one shared ``bincount`` launch a round; rounds padded with sentinel rows
    to a multiple of the shards. Windowed: ``advance_windows`` after every
    clock. Returns the reduced, installed members and the launches."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.lanes import LanedMetric, LaneRound, lane_capacity_bucket, make_deferred_lane_step
    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.ops.kernels import shared_scope

    shards = DEFERRED["shards"]
    writers = len(data["writers"])
    capacity = lane_capacity_bucket(writers)
    members = {k: m for k, m in _femnist_members(dev).items() if k in ("confmat", "f1", "accuracy")}
    laned = {}
    for k, m in members.items():
        inner = m if window is None else m.windowed(window, lateness=FEMNIST_WINDOWS["lateness"])
        laned[k] = LanedMetric(inner, capacity=capacity, reduce="deferred")
        for w in range(writers):
            laned[k].admit(w)
        _check(laned[k].sessions[writers - 1] == writers - 1, "femnist_writers_deferred: lanes are not the writers")
    steps = {k: make_deferred_lane_step(m, shards) for k, m in laned.items()}
    states = {k: s.init_states() for k, s in steps.items()}
    rounds = _femnist_rounds(data, windowed=window is not None)
    _sync(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    from torchmetrics_tpu_torch.ops import fused_classification as fc

    per_chunk = max(1, fc.ROW_BINS_LIMIT // (FEMNIST["classes"] ** 2))
    chunks = sum(-(-len(ws) // per_chunk) for _, ws, _, _ in rounds)
    bincount.launches = 0
    clock, advance_s, round_ms = 0, 0.0, []
    t_start = time.perf_counter()
    for t, ws, logits, target in rounds:
        while window is not None and clock < t:
            a0 = time.perf_counter()
            states = {k: steps[k].advance_windows(st) for k, st in states.items()}
            advance_s += time.perf_counter() - a0
            clock += 1
        pad = (-len(ws)) % shards
        ids = np.asarray(ws + [capacity] * pad, dtype=np.int32)
        if pad:
            logits = np.concatenate([logits, np.zeros((pad,) + logits.shape[1:], logits.dtype)])
            target = np.concatenate([target, np.zeros((pad,) + target.shape[1:], target.dtype)])
        x, y = _to_dev(dev, logits, target)
        rnd = LaneRound(ids)
        r0 = time.perf_counter()
        with shared_scope():
            states = {k: steps[k].local_step(st, rnd, x, y) for k, st in states.items()}
        _sync(dev)
        round_ms.append((time.perf_counter() - r0) * 1e3)
    while window is not None and clock < max(r[0] for r in rounds) + 1:
        states = {k: steps[k].advance_windows(st) for k, st in states.items()}
        clock += 1
    _sync(dev)
    seconds = time.perf_counter() - t_start
    launches = bincount.launches
    peak = _peak_above(dev, base) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    for k in laned:
        steps[k].install_reduced(steps[k].reduce(states[k]))
    _sync(dev)
    reduce_ms = (time.perf_counter() - t0) * 1e3
    return {"laned": laned, "rounds": len(rounds), "row_chunks": chunks, "launches": launches, "seconds": seconds, "clock": clock,
            "advance_s": advance_s, "round_ms": round_ms, "reduce_ms": reduce_ms, "peak": peak,
            "stacked_state_bytes": sum(_state_bytes(st) for st in states.values())}


def phase_femnist_writers_deferred(dev, data: dict) -> dict:
    """PR 17's FEMNIST traffic (3,550 writers on 4,096 lanes) through
    ``make_deferred_lane_step`` with 8 shards, unwindowed and at W = 4.
    Checks: after the one reduce, every lane's confusion matrix, stat
    scores and micro counts bit-equal to the plain count of its writer (the
    counts ``femnist_writers`` is held to), and every lane's ring bit-equal
    to the plain per-window count (the windowed run follows the on-time
    schedule: the skew and late events of ``femnist_writers_windowed`` go
    through the router's per-lane clock, which the deferred step, like the
    JAX package's, does not have: it advances every lane at once); the
    lane values against ``lane_values`` of a non-deferred run of the same
    rounds; one ``bincount`` launch a round, the shard folded into the
    row index. Printed: launches a round, rounds, ms a round, reduce ms."""
    import torch

    writers = list(range(len(data["writers"])))
    plain = _femnist_plain_counts(data, dev)
    runs = {}
    for name, window in (("unwindowed", None), ("windowed", FEMNIST_WINDOWS["window"])):
        run = _deferred_lane_run(dev, data, window)
        laned = run["laned"]
        _check(run["launches"] == run["row_chunks"],
               f"femnist_writers_deferred/{name}: {run['launches']} bincount launches for {run['rounds']} rounds"
               f" of {run['row_chunks']} row chunks")
        if window is None:
            want = plain
        else:
            nb = [-(-len(t) // FEMNIST["batch"]) for _, t in data["writers"]]
            want = _femnist_window_plain(data, {"nb": nb, "skewed": [], "late": {}, "later": {}}, run["clock"], dev)
        idx = torch.as_tensor(writers, device=dev)
        _check(laned["confmat"]._state["confmat"].index_select(0, idx).to(torch.int64).equal(want),
               f"femnist_writers_deferred/{name}: a lane's confusion counts differ from the plain count")
        stats = _stats_of(want)
        for i, field in enumerate(("tp", "fp", "tn", "fn")):
            _check(laned["f1"]._state[field].index_select(0, idx).to(torch.int64).equal(stats[i]),
                   f"femnist_writers_deferred/{name}: a lane's {field} differs from the plain count")
            _check(laned["accuracy"]._state[field].index_select(0, idx).to(torch.int64).equal(stats[i].sum(-1)),
                   f"femnist_writers_deferred/{name}: a lane's micro {field} differs from the plain count")
        values = laned["confmat"].lane_values()
        folded = torch.stack([values[w] for w in writers]).to(torch.int64)
        _check(folded.equal(want if window is None else want.sum(1)), f"femnist_writers_deferred/{name}: lane values")
        ms = sorted(run["round_ms"])
        runs[name] = {
            "rounds": run["rounds"], "row_chunks": run["row_chunks"], "bincount_launches": run["launches"],
            "launches_per_round": run["launches"] / run["rounds"],
            "seconds": run["seconds"], "sessions_per_s": len(writers) / run["seconds"],
            "round_ms": {"p50": ms[len(ms) // 2], "max": ms[-1]}, "reduce_ms": run["reduce_ms"],
            "advance_s": run["advance_s"], "clock": run["clock"], "peak_mem_above_base_bytes": run["peak"],
            "stacked_state_bytes": run["stacked_state_bytes"], "capacity": laned["confmat"].capacity,
        }
        del run, laned
    out = {"phase": "femnist_writers_deferred", "writers": len(writers), "shards": DEFERRED["shards"], **runs,
           "bincount_launches": sum(r["bincount_launches"] for r in runs.values())}
    return _emit(out)


def _grouped_wire(fields: dict, reds: dict, qspecs: dict) -> dict:
    """The state as the sync ships it: the quantized fields of one
    (reduction, dtype, bits, block) group concatenated (they are encoded as
    one payload), every other field as it is; ``state_wire_bytes`` of that
    is what the sync puts on the wire."""
    import torch

    out, groups = {}, {}
    for k, v in fields.items():
        q = qspecs.get(k)
        if q is not None and isinstance(v, torch.Tensor) and v.is_floating_point() and reds.get(k) in ("sum", "mean", "max", "min"):
            groups.setdefault((reds[k], v.dtype, q), []).append(v.reshape(-1))
        else:
            out[k] = v
    qspecs_out = {k: None for k in out}
    for i, ((fx, _, q), parts) in enumerate(groups.items()):
        out[f"_group{i}"] = torch.cat(parts)
        qspecs_out[f"_group{i}"] = q
    return {"states": out, "qspecs": qspecs_out}


def _quantized_row(name: str, metric, bits: int, expect_quantized: bool = True) -> dict:
    """``metric``'s state synced at ``sync_precision="quantized"`` in the
    world of one: float fields within ``reduce_error_bound`` up to float32
    rounding (the bound times 1 + 2^-7: the quotient's rounding can carry a
    16-bit code one tie across; plus 1e-6 and 2^-22 of the value: code
    times scale), integer
    fields bit-equal, the bytes on the wire equal to ``state_wire_bytes`` of
    the grouped payload (and beside it the per-field reckoning),
    ``sync_async().result()`` equal to a blocking ``sync()``."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.parallel import quantized as q
    from torchmetrics_tpu_torch.parallel import sync as psync

    saved = (metric.sync_precision, metric.sync_quant_bits, metric.sync_quant_block)
    metric.sync_precision, metric.sync_quant_bits, metric.sync_quant_block = "quantized", bits, QUANT["block"]
    try:
        state = metric.state()
        qspecs = metric._sync_qspecs()
        wire0 = obs.counters_snapshot().get("sync.bytes_on_wire", 0)
        r0, g0 = psync.all_reduces, psync.all_gathers
        _sync(metric.device)
        t0 = time.perf_counter()
        synced = metric.functional_sync(state)
        _sync(metric.device)
        sync_ms = (time.perf_counter() - t0) * 1e3
        wire = obs.counters_snapshot().get("sync.bytes_on_wire", 0) - wire0
        collectives = {"all_reduce": psync.all_reduces - r0, "all_gather": psync.all_gathers - g0}
        fields = {k: state[k] for k in metric._defaults}
        flat = dict(fields, _update_count=torch.tensor(0, dtype=torch.int64))
        reds = dict(metric._reductions, _update_count="sum")
        grouped = _grouped_wire(flat, reds, qspecs)
        want_wire = q.state_wire_bytes(grouped["states"], reds, grouped["qspecs"])
        per_field = q.state_wire_bytes(flat, reds, qspecs)["total"]
        exact_wire = q.state_wire_bytes(flat, reds, None)["total"]
        if obs.telemetry_enabled():
            _check(wire == want_wire["total"], f"sync/{name}/int{bits}: {wire} bytes on the wire, not {want_wire['total']}")
        max_err, quantized_fields, groups = 0.0, 0, {}
        for k, v in fields.items():
            fx = metric._reductions[k]
            if qspecs[k] is None or not v.is_floating_point() or fx not in ("sum", "mean", "max", "min"):
                _check(_bit_equal(synced[k], v), f"sync/{name}/int{bits}: the exact field {k} changed")
                continue
            groups.setdefault((fx, v.dtype), []).append(k)
        for (fx, _), names in groups.items():
            # the fields of a group are encoded as ONE payload, so a block
            # may span two fields: the bound is the concatenation's
            quantized_fields += len(names)
            x = np.concatenate([fields[k].detach().double().cpu().numpy().reshape(-1) for k in names])
            got = np.concatenate([synced[k].detach().double().cpu().numpy().reshape(-1) for k in names])
            bound = q.reduce_error_bound(x[None], fx, bits, QUANT["block"])
            err = np.abs(got - x)
            _check(bool((err <= bound * (1 + 2.0**-7) + 1e-6 + np.abs(x) * 2.0**-22).all()),
                   f"sync/{name}/int{bits}: {names} off by {float(err.max())}, past reduce_error_bound")
            max_err = max(max_err, float(err.max()))
        _check(quantized_fields > 0 or not expect_quantized, f"sync/{name}/int{bits}: no field took the quantized path")
        fut = metric.sync_async()
        async_state = fut.result(timeout=300)
        metric.sync()
        blocking = metric.state()
        metric.unsync()
        _check(_bit_equal(_fields({"m": async_state})["m"], _fields({"m": blocking})["m"]),
               f"sync/{name}/int{bits}: sync_async().result() differs from sync()")
    finally:
        metric.sync_precision, metric.sync_quant_bits, metric.sync_quant_block = saved
    return {"bits": bits, "block": QUANT["block"], "sync_ms": sync_ms, "collectives": collectives,
            "wire_bytes": wire, "wire_reckoned": want_wire, "wire_per_field": per_field, "exact_wire_bytes": exact_wire,
            "wire_ratio": wire / exact_wire, "max_abs_err": max_err, "quantized_fields": quantized_fields}



# ------------------------------------------------ state integrity and the fleet


#: the fingerprint kernel's checks: every dtype the states use at sizes that
#: are not a multiple of 4 words (and an empty leaf), a per-shard fold of an
#: (8, n) stack, and one leaf past 2**31 words (the kernel indexes in int64)
FINGERPRINT = {
    "dtypes": ("bool", "int8", "uint8", "int16", "float16", "bfloat16", "int32", "float32", "int64", "float64"),
    "elements": 1_000_003, "stack": (8, 1_000_001), "large_words": 2**31 + 3, "iters": 20,
}
#: the audited ImageNet runs: the bit flip lands on the confusion matrix
#: after this batch, and the timed audits, folds and captures
AUDIT = {"flip_after": 25, "audit_calls": 20, "fold_calls": 50, "capture_calls": 100}
#: GLDv2's audited second evaluation pass: the first 32 batches again, a
#: capture every 8 updates; batch temporaries allowed above the two stacks
GLDV2_AUDIT = {"batches": 32, "every": 8, "fold_iters": 5, "temporaries_bytes": 1 << 30}
#: the FEMNIST fleet: 64 sites (writer w feeds leaf w mod 64) under a
#: two-level tree of fanout 8, each leaf shipping every 8 of its batches;
#: the ledgers' reorder watermark; the quantized pass's bits and block
FLEET = {"leaves": 64, "fanout": 8, "ship_every": 8, "watermark": 8, "bits": 8, "block": 256}


def _fp_leaf(dtype: str, n: int, dev, seed: int = 0):
    """A leaf of ``n`` elements of ``dtype`` from the seed, on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 30_000 + seed)
    if dtype == "bool":
        return torch.rand(n, generator=g, device=dev) < 0.5
    dt = getattr(torch, dtype)
    if dt.is_floating_point:
        return (torch.randn(n, generator=g, device=dev) * 100).to(dt)
    info = torch.iinfo(dt)
    return torch.randint(info.min, info.max, (n,), generator=g, device=dev, dtype=torch.int64).to(dt)


def _fp_launch_ms(segments, iters: int) -> float:
    """Device time of the launch alone (the memset and the fold), with the
    segment table built and copied once, outside the timing."""
    import torch

    from torchmetrics_tpu_torch.ops import fingerprint, native

    device = segments[0].get_device()
    rows = [(s.data_ptr(), s.numel() * s.element_size() // fingerprint._width(s), fingerprint._width(s)) for s in segments]
    table = torch.tensor(rows, dtype=torch.int64, device=device)
    out = torch.empty((len(segments), 2), dtype=torch.int32, device=device)
    max_units = max(r[1] for r in rows)
    entry = fingerprint._entry()
    stream = native.current_stream(device)

    def launch() -> None:
        _check(entry(device, None, table.data_ptr(), len(segments), max_units, out.data_ptr(), stream) == 0,
               "fingerprint: the raw launch failed")

    return _time_ms(launch, iters)


def _fp_row(name: str, segments, iters: int, call=None, host_calls: int = 1000) -> dict:
    """The kernel against its plain body on ``segments`` (bit for bit), with
    its time, host time, launch-alone device time and bound. ``call`` is the
    timed entry (default: the wrapper on the segments)."""
    import torch

    from torchmetrics_tpu_torch.ops import fingerprint

    call = call or (lambda: fingerprint._fingerprint_cuda(*segments))
    got = fingerprint._fingerprint_cuda(*segments)
    ref = fingerprint._fingerprint_reference(*segments)
    torch.cuda.synchronize()
    _check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
           f"fingerprint {name}: the kernel's words differ from the plain body's")
    nbytes = sum(s.numel() * s.element_size() for s in segments) + 8 * len(segments)
    words = sum(s.numel() * s.element_size() // fingerprint._width(s) for s in segments)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * words / FP32_OPS_PER_S * 1e3  # one XOR and one add a word
    return {
        "shape": name, "segments": len(segments), "bytes": nbytes, "words": words,
        "max_abs_err": 0, "tolerance": "exact (every word)",
        "ms": _time_ms(call, iters),
        "device_ms": _fp_launch_ms(segments, iters),
        "host_ms": _host_ms(call, host_calls),
        "plain_ms": _time_ms(lambda: fingerprint._fingerprint_reference(*segments), max(2, iters // 5)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # no PyTorch call folds words with XOR (bitwise_xor is elementwise only)
        "library_ms": None,
    }


def phase_fingerprint_kernels(dev) -> list:
    """``fingerprint`` against its plain body, bit for bit: every state
    dtype at 1,000,003 elements (no multiple of 4 words) and an empty leaf;
    the ImageNet collection's states folded as a tree in ONE launch (and
    nothing else in it); a per-shard fold of an (8, 1,000,001) stack; a leaf
    of 2**31 + 3 int32 words (8.6 GB)."""
    import torch

    from torchmetrics_tpu_torch import integrity
    from torchmetrics_tpu_torch.ops import fingerprint

    spec, iters = FINGERPRINT, FINGERPRINT["iters"]
    rows = []
    for i, dtype in enumerate(spec["dtypes"]):
        leaf = _fp_leaf(dtype, spec["elements"], dev, seed=i)
        rows.append(_fp_row(f"{dtype}_{spec['elements']}", [leaf, leaf[:0]], iters))
        del leaf
    coll = _imagenet(dev)["collection"]()
    for i in range(2):
        coll.update(*_imagenet_batch(i, dev))
    tree = {name: m._copy_state_dict() for name, m in coll.items(keep_base=True)}
    leaves = [leaf.contiguous() for _, leaf in integrity._array_leaves(tree)]
    before = fingerprint.launches
    fps = integrity.device_fingerprints(tree)
    _check(fingerprint.launches - before == 1, f"fingerprint: the ImageNet tree took {fingerprint.launches - before} launches")
    packed = torch.stack([fps[k] for k, _ in integrity._array_leaves(tree)]).view(torch.int32)
    ref = fingerprint._fingerprint_reference(*leaves).view(torch.int32)
    _check(torch.equal(packed, ref), "fingerprint: the ImageNet tree's words differ from the plain body's")
    row = _fp_row("imagenet_collection_tree", leaves, AUDIT["fold_calls"], call=lambda: integrity.device_fingerprints(tree))
    row["leaves"] = len(leaves)
    rows.append(row)
    stack = _fp_leaf("int32", spec["stack"][0] * spec["stack"][1], dev, seed=20).reshape(spec["stack"])
    got = integrity.device_shard_fingerprints({"s": stack})["['s']"]
    want = fingerprint._fingerprint_reference(*stack.unbind(0))
    _check(torch.equal(got.view(torch.int32), want.view(torch.int32)), "fingerprint: the per-shard fold differs")
    rows.append(_fp_row("int32_stack_8x1000001_per_shard", list(stack.unbind(0)), iters,
                        call=lambda: integrity.device_shard_fingerprints({"s": stack})))
    del stack
    large = _fp_leaf("int32", spec["large_words"], dev, seed=21)
    rows.append(_fp_row(f"int32_{spec['large_words']}", [large], 5, host_calls=20))
    del large, coll, tree, leaves
    torch.cuda.empty_cache()
    _emit({"phase": "kernels", "kernel": "fingerprint", "checks": rows})
    return rows


def _member_stats(coll) -> dict:
    """The auditors' stats summed over a collection's members."""
    keys = ("captures", "audits", "stale_baselines", "divergences", "restores", "degraded_serves")
    out = dict.fromkeys(keys, 0)
    for _, m in coll.items(keep_base=True):
        auditor = m.integrity
        if auditor is not None:
            for k in keys:
                out[k] += auditor.stats[k]
    return out


def phase_imagenet_val_audited(dev) -> dict:
    """ImageNet-1k val's collection with every member audited
    (``attach_integrity(every_n_updates=1, snapshots=True)``), in four runs
    beside an unaudited one: clean; ``"restore"``, ``"degraded"`` and
    ``"raise"`` with ``flip_state_bits`` on the confusion matrix after batch
    25 and a read after it. Checks: the clean run's values and states
    bit-equal to the unaudited run's; the restore run's final values
    bit-equal to the clean run's; the degraded read a ``DegradedValue``
    with the last-good value; ``"raise"`` raising ``StateDivergenceError``
    from ``compute`` and from ``compute_async``'s worker, flighted in the
    ``integrity`` domain; ``bincount`` launches as the unaudited run's;
    ``fingerprint`` launches one a capture plus one an audit that folds.
    Printed: µs an update with and without the auditor (and with it under
    ``snapshots=False``, a measurement run outside the launch counts), ms
    an audit, device µs a fold of the collection's tree, and each member's
    host µs a ``capture()`` with and without its host copy."""
    import torch

    from torchmetrics_tpu_torch import integrity, obs
    from torchmetrics_tpu_torch.ops import bincount, fingerprint
    from torchmetrics_tpu_torch.ops.async_read import drain_pipeline
    from torchmetrics_tpu_torch.quarantine import DegradedValue
    from torchmetrics_tpu_torch.testing import faults
    from torchmetrics_tpu_torch.utils.exceptions import StateDivergenceError

    spec = _imagenet_indexed(dev)
    batches = list(spec["batches"]())
    n, flip_at = len(batches), AUDIT["flip_after"]

    def run(policy, stop: int = None, at: int = None, snapshots: bool = True):
        """Update through batch ``stop`` (all), reading at ``at``; the
        collection, loop µs an update (no sync inside the loop) and the
        read at ``at``."""
        coll = spec["collection"]()
        if policy is not None:
            for _, m in coll.items(keep_base=True):
                m.attach_integrity(every_n_updates=1, on_divergence=policy, snapshots=snapshots)
        loop_us, mid = [], None
        _sync(dev)
        for i, batch in enumerate(batches[:stop], 1):
            t0 = time.perf_counter()
            coll.update(*batch)
            loop_us.append((time.perf_counter() - t0) * 1e6)
            if i == at:
                mid = coll.compute()
        _sync(dev)
        return coll, loop_us, mid

    torch.cuda.synchronize()
    bincount.launches = 0
    plain, plain_us, plain_at = run(None, at=flip_at)
    plain_values, plain_state = plain.compute(), _fields({k: m.state() for k, m in plain.items(keep_base=True)})
    plain_launches = bincount.launches
    _check(plain_launches == n, f"imagenet_val_audited: {plain_launches} bincount launches unaudited for {n} updates")

    bincount.launches, fp0 = 0, fingerprint.launches
    clean, clean_us, _ = run("raise")
    t0 = time.perf_counter()
    _check(drain_pipeline(60.0), "imagenet_val_audited: the read pipeline did not drain")
    drain_ms = (time.perf_counter() - t0) * 1e3
    clean_values = clean.compute()
    _same_result("imagenet_val_audited clean", clean_values, plain_values)
    _check(_bit_equal(_fields({k: m.state() for k, m in clean.items(keep_base=True)}), plain_state),
           "imagenet_val_audited: the audited states differ from the unaudited ones")
    _check(bincount.launches == plain_launches, f"imagenet_val_audited: {bincount.launches} bincount launches audited")
    stats = _member_stats(clean)
    folds = stats["captures"] + stats["audits"] - stats["stale_baselines"]
    _check(fingerprint.launches - fp0 == folds,
           f"imagenet_val_audited: {fingerprint.launches - fp0} fingerprint launches for {stats}")
    _check(stats["divergences"] == 0, f"imagenet_val_audited: the clean run diverged: {stats}")
    auditor = clean["confmat"].integrity
    audit_ms = []
    for _ in range(AUDIT["audit_calls"]):
        t0 = time.perf_counter()
        _check(auditor.audit().ok, "imagenet_val_audited: a clean audit failed")
        audit_ms.append((time.perf_counter() - t0) * 1e3)
    # the explicit audits are a user's entry point (main path); the timed
    # folds below are a measurement and stay out of the count
    launches = {"bincount": 2 * n, "fingerprint": fingerprint.launches - fp0}
    tree = {name: m._copy_state_dict() for name, m in clean.items(keep_base=True)}
    fold_us = _time_ms(lambda: integrity.device_fingerprints(tree), AUDIT["fold_calls"]) * 1e3
    # what a capture costs the step loop: an audited run without host
    # copies, and each member's capture() timed back to back with and
    # without its host copy (measurements: outside the launch counts)
    _, nosnap_us, _ = run("raise", snapshots=False)
    _check(drain_pipeline(60.0), "imagenet_val_audited: the read pipeline did not drain")
    capture_us = {}
    for name, m in clean.items(keep_base=True):
        for snapshots in (True, False):
            m.integrity.snapshots = snapshots
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(AUDIT["capture_calls"]):
                m.integrity.capture()
            capture_us[f"{name}_{'with' if snapshots else 'without'}_host_copy"] = (
                (time.perf_counter() - t0) / AUDIT["capture_calls"] * 1e6)
            _sync(dev)
    _check(drain_pipeline(60.0), "imagenet_val_audited: the read pipeline did not drain")

    # "restore": the flip is caught at the next read and the verified host
    # copy reinstalled; the run goes on and ends bit-equal to the clean one
    bincount.launches, fp0 = 0, fingerprint.launches
    coll, _, _ = run("restore", stop=flip_at)
    drain_pipeline(60.0)
    info = faults.flip_state_bits(coll["confmat"], field="confmat", seed=SEED)
    mid = coll.compute()
    _same_result("imagenet_val_audited restore at the read", mid, plain_at)
    for batch in batches[flip_at:]:
        coll.update(*batch)
    drain_pipeline(60.0)
    _same_result("imagenet_val_audited restore", coll.compute(), clean_values)
    restore_stats = _member_stats(coll)
    _check(restore_stats["restores"] == 1, f"imagenet_val_audited: restore stats {restore_stats}")
    launches["bincount"] += bincount.launches
    launches["fingerprint"] += fingerprint.launches - fp0

    # "degraded": the read after the flip serves the last-good value
    bincount.launches, fp0 = 0, fingerprint.launches
    coll, _, _ = run("degraded", stop=flip_at, at=flip_at)
    drain_pipeline(60.0)
    faults.flip_state_bits(coll["confmat"], field="confmat", seed=SEED)
    got = coll.compute()
    served = got["confmat"]
    _check(isinstance(served, DegradedValue), f"imagenet_val_audited: the degraded read served {type(served).__name__}")
    _check(torch.equal(served.value, plain_at["confmat"]) and served.updates_behind == 0,
           "imagenet_val_audited: the degraded read is not the last-good value")
    _same_result("imagenet_val_audited degraded (other members)", _values(got), _values(plain_at))
    launches["bincount"] += bincount.launches
    launches["fingerprint"] += fingerprint.launches - fp0

    # "raise": from compute, and from compute_async's worker
    bincount.launches, fp0 = 0, fingerprint.launches
    coll, _, _ = run("raise", stop=flip_at, at=flip_at)
    drain_pipeline(60.0)
    faults.flip_state_bits(coll["confmat"], field="confmat", seed=SEED)
    raised = {}
    for how, read in (("compute", lambda: coll.compute()), ("compute_async", lambda: coll.compute_async().result(120.0))):
        try:
            read()
            raised[how] = None
        except StateDivergenceError as err:
            raised[how] = {"surface": err.surface, "field": err.field, "shard": err.shard}
    _check(all(v is not None and v["field"] == "['confmat']" for v in raised.values()),
           f"imagenet_val_audited: the raise run raised {raised}")
    crumbs = [c for c in obs.dump_diagnostics()["breadcrumbs"]
              if c.get("kind") == "state_divergence_error" and c.get("data", {}).get("owner") == "MulticlassConfusionMatrix"]
    _check(len(crumbs) >= 2, f"imagenet_val_audited: {len(crumbs)} flighted divergences in the integrity domain")
    launches["bincount"] += bincount.launches
    launches["fingerprint"] += fingerprint.launches - fp0
    drain_pipeline(60.0)

    def p50(xs):
        return sorted(xs)[len(xs) // 2]

    return _emit({
        "phase": "imagenet_val_audited", "updates": n, "flip_after": flip_at, "flipped_bits": info["bits"],
        "update_us": {"unaudited_p50": p50(plain_us), "audited_p50": p50(clean_us),
                      "unaudited_mean": sum(plain_us) / n, "audited_mean": sum(clean_us) / n,
                      "ratio_p50": p50(clean_us) / p50(plain_us),
                      "audited_no_snapshots_p50": p50(nosnap_us),
                      "ratio_no_snapshots_p50": p50(nosnap_us) / p50(plain_us)},
        "capture_host_us": capture_us,
        "drain_after_loop_ms": drain_ms, "audit_ms_p50": p50(audit_ms), "fold_device_us": fold_us,
        "clean_stats": stats, "restore_stats": restore_stats, "raised": raised,
        "bincount_launches": launches["bincount"], "fingerprint_launches": launches["fingerprint"],
        "bit_equal": True,
    })


def phase_gldv2_clean_audited(dev, reuse: dict) -> dict:
    """GLDv2-clean's finished class-sharded collection (from
    ``gldv2_clean_class_sharded``) with the confusion matrix and macro F1
    audited (``attach_integrity(every_n_updates=8, snapshots=False,
    on_divergence="degraded")``), scoring its first 32 batches again as a
    second evaluation pass. Checks: the kernel's fold of the 26.45 GB stack
    equals the plain body's, whole and shard by shard; the total is the
    images plus the 32 batches; after ``flip_state_bits`` on both, F1's next
    read is a ``DegradedValue`` of its pre-flip value, and the confusion
    matrix's raises ``StateDivergenceError`` naming ``['confmat']``: its
    value is a view of the stack the flip reached, and without snapshots
    there is no copy to serve; the per-shard map names the shard hit; the
    peak above the base without the state stays within two stacks plus the
    batch temporaries (neither a capture nor a last-good value holds a third
    stack). Printed: the fold's ms against its bound, update ms with and
    without a capture, peak memory."""
    import torch

    from torchmetrics_tpu_torch import integrity
    from torchmetrics_tpu_torch.ops import bincount, fingerprint
    from torchmetrics_tpu_torch.ops.async_read import drain_pipeline
    from torchmetrics_tpu_torch.quarantine import DegradedValue
    from torchmetrics_tpu_torch.testing import faults
    from torchmetrics_tpu_torch.utils.exceptions import StateDivergenceError

    spec, step = GLDV2_AUDIT, GLDV2["batch"]
    coll, target, pred = reuse["coll"], reuse["target"], reuse["pred"]
    cm, f1 = coll["confmat"], coll["f1"]
    state_bytes = cm.confmat.numel() * cm.confmat.element_size()
    auditor, f1_auditor = (
        m.attach_integrity(every_n_updates=spec["every"], snapshots=False, on_divergence="degraded") for m in (cm, f1)
    )
    _sync(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev) - state_bytes  # the base before the state existed
    torch.cuda.reset_peak_memory_stats(dev)
    bincount.launches, fp0 = 0, fingerprint.launches
    with_capture, without = [], []
    for b in range(spec["batches"]):
        lo = b * step
        _sync(dev)
        t0 = time.perf_counter()
        coll.update(pred[lo:lo + step], target[lo:lo + step])
        _sync(dev)
        (with_capture if (b + 1) % spec["every"] == 0 else without).append((time.perf_counter() - t0) * 1e3)
    _check(drain_pipeline(120.0), "gldv2_clean_audited: the read pipeline did not drain")
    peak = torch.cuda.max_memory_allocated(dev) - base
    launches = bincount.launches
    captures = fingerprint.launches - fp0
    _check(launches == spec["batches"], f"gldv2_clean_audited: {launches} bincount launches for {spec['batches']} updates")
    _check(captures == 2 * (spec["batches"] // spec["every"]) == auditor.stats["captures"] + f1_auditor.stats["captures"],
           f"gldv2_clean_audited: {captures} fingerprint launches for"
           f" {auditor.stats['captures']} + {f1_auditor.stats['captures']} captures")
    limit = 2 * state_bytes + spec["temporaries_bytes"]
    _check(peak <= limit, f"gldv2_clean_audited: peak {peak} B above the base, beyond two stacks and temporaries ({limit})")
    fp_read = fingerprint.launches
    result = coll.compute()
    main_launches = captures + fingerprint.launches - fp_read  # the read-point audit of the compute
    total = int(result["confmat"].sum())
    want_total = GLDV2["images"] + spec["batches"] * step
    _check(total == want_total, f"gldv2_clean_audited: the confusion total {total} is not {want_total}")
    stack = cm.confmat
    fold_ms = _time_ms(lambda: integrity.device_fingerprints({"confmat": stack}), spec["fold_iters"])
    shard_ms = _time_ms(lambda: integrity.device_shard_fingerprints({"confmat": stack}), spec["fold_iters"])
    whole = integrity.device_fingerprints({"confmat": stack})["['confmat']"]
    per_shard = integrity.device_shard_fingerprints({"confmat": stack})["['confmat']"]
    t0 = time.perf_counter()
    plain_whole = fingerprint._fingerprint_reference(stack)[0]
    plain_shards = fingerprint._fingerprint_reference(*stack.unbind(0))
    _sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    _check(torch.equal(whole.view(torch.int32), plain_whole.view(torch.int32)),
           "gldv2_clean_audited: the stack's fingerprint differs from the plain body's")
    _check(torch.equal(per_shard.view(torch.int32), plain_shards.view(torch.int32)),
           "gldv2_clean_audited: a shard's fingerprint differs from the plain body's")
    f1_clean = result["f1"].clone()
    info = faults.flip_state_bits(cm, field="confmat", seed=SEED)
    f1_info = faults.flip_state_bits(f1, seed=SEED)
    fp_read = fingerprint.launches
    try:
        read = cm.compute()
    except StateDivergenceError as err:
        read = err
    f1_read = f1.compute()
    main_launches += fingerprint.launches - fp_read
    _check(isinstance(read, StateDivergenceError) and read.field == "['confmat']" and read.surface == "chain",
           f"gldv2_clean_audited: the confusion matrix's read after the flip gave {read!r}")
    _check(isinstance(f1_read, DegradedValue) and torch.equal(f1_read.value, f1_clean) and f1_read.updates_behind == 0,
           f"gldv2_clean_audited: F1's read after the flip of {f1_info['field']} is not its last-good value")
    last = auditor.stats["last_divergence"]
    _check(last is not None and last["field"] == "['confmat']" and last["surface"] == "chain",
           f"gldv2_clean_audited: the divergence is {last}")
    flipped = integrity.device_shard_fingerprints({"confmat": stack})
    _, found = integrity._compare_fps("chain", {"['confmat']": per_shard}, flipped)
    shard_bytes = stack[0].numel() * stack.element_size()
    hit = info["bits"][0] // 8 // shard_bytes
    _check(len(found) == 1 and found[0].shard == hit, f"gldv2_clean_audited: the per-shard map named {found}, not shard {hit}")
    auditor.detach()
    f1_auditor.detach()
    bytes_ms = (state_bytes + 8) / HBM_BYTES_PER_S * 1e3
    return _emit({
        "phase": "gldv2_clean_audited", "batches": spec["batches"], "captures": captures, "state_bytes": state_bytes,
        "fold_ms": fold_ms, "fold_per_shard_ms": shard_ms, "fold_bound_ms": bytes_ms, "fold_plain_ms": plain_ms,
        "fold_tb_per_s": state_bytes / fold_ms / 1e9,
        "update_ms": {"with_capture_p50": sorted(with_capture)[len(with_capture) // 2],
                      "without_p50": sorted(without)[len(without) // 2],
                      "with_capture_mean": sum(with_capture) / len(with_capture), "without_mean": sum(without) / len(without)},
        "peak_above_base_bytes": peak, "peak_limit_bytes": limit, "confmat_total": total,
        "flipped_bit": info["bits"][0], "shard_hit": hit, "divergence": last,
        "confmat_read": type(read).__name__, "f1_read": type(f1_read).__name__, "f1_flipped_field": f1_info["field"],
        "bincount_launches": launches, "fingerprint_launches": main_launches,
    })


def _fleet_leaf(dev) -> dict:
    """One FEMNIST site: the counting collection (62-class confusion matrix,
    micro accuracy, macro F1) and the top probability's mean, max and
    rows, all on the card."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score

    c = FEMNIST["classes"]
    cls = MetricCollection({
        "confmat": MulticlassConfusionMatrix(num_classes=c, validate_args=False, device=dev),
        "accuracy": MulticlassAccuracy(num_classes=c, average="micro", validate_args=False, device=dev),
        "f1": MulticlassF1Score(num_classes=c, average="macro", validate_args=False, device=dev),
    }, device=dev)
    # softmax probabilities are finite by construction: no NaN scan (a host
    # sync an update) on the aggregators
    kw = {"nan_strategy": "disable", "device": dev}
    return {"cls": cls, "agg": {"mean": MeanMetric(**kw), "max": MaxMetric(**kw), "cat": CatMetric(**kw)}}


def _fleet_source(leaf: dict):
    """The site's fleet source: every member's ``metric_source`` under
    ``"<member>.<field>"`` keys (the protocol is flat)."""
    from torchmetrics_tpu_torch.fleet import metric_source

    members = dict(leaf["cls"].items(keep_base=True))
    members.update(leaf["agg"])
    sources = {name: metric_source(m) for name, m in members.items()}

    def source():
        state, reds, count = {}, {}, 0
        for name, src in sources.items():
            st, rd, c = src()
            for k, v in st.items():
                state[f"{name}.{k}"] = v
                reds[f"{name}.{k}"] = rd[k]
            count = max(count, c)
        return state, reds, count

    return source


def _hist_quantile(h: dict, q: float) -> float:
    """A quantile of an ``obs`` histogram: the upper bound of its bucket."""
    target, seen = q * h["count"], 0
    for bound, count in zip(list(h["buckets"]) + [float("inf")], h["counts"]):
        seen += count
        if seen >= target:
            return bound
    return float("inf")


def _timed_receive(agg, sink: list) -> None:
    """Time every merge at ``agg`` into ``sink`` (an instance attribute over
    the method the uplink calls)."""
    receive = agg.receive

    def timed(delta):
        t0 = time.perf_counter()
        try:
            return receive(delta)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)

    agg.receive = timed


def phase_femnist_fleet(dev, data: dict) -> dict:
    """A federated evaluation over LEAF FEMNIST's 3,550 writers as 64 sites
    (writer w at site w mod 64) under ``FleetTopology(64 sites, fanout=8)``:
    8 interior aggregators and a root, snapshots under a temporary directory.
    Each site is a collection on the card (62-class confusion matrix, micro
    accuracy, macro F1, and the mean, max and rows of each sample's top
    probability: the add, replace, merge and suffix wire modes) shipping
    every 8 of its batches; the tree is pumped after every round of ships.
    Chaos on named sites: a drop within the retry budget and one past it, a
    duplicate, a delay of 2 epochs, a 3-epoch partition (replayed in order),
    a 12-epoch partition from the start (its outbox, bounded at the
    watermark, collapses to a full resync), a corrupted payload (dropped,
    quarantined, healed by a resync), and one interior aggregator killed and
    failed over from its snapshot. A second pass ships the same traffic with
    ``precision="quantized"`` at 8 bits. Checks: the root's read after the
    last pump healthy and bit-equal to the fault-free fold of every site's
    state in sorted site order (cat rows in the same order); the values from
    the merged state within ``FEMNIST_ATOL`` of float64 from the plain
    counts; during the long partition a ``DegradedValue`` at coverage 63/64
    naming the partitioned site, and ``allow_degraded=False`` raising; the
    quantized pass's integer fields bit-equal and float fields within
    ``reduce_error_bound``; ``bincount`` one launch a site update. Printed:
    deltas shipped, ms a ship and a merge, ``fleet.aggregation_lag_us``
    p50/p99, wire bytes exact against quantized."""
    import shutil
    import tempfile
    from contextlib import ExitStack

    import numpy as np
    import torch

    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.fleet import FleetTopology, build_fleet
    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.parallel.quantized import _qmax, reduce_error_bound, wire_payload_bytes
    from torchmetrics_tpu_torch.parallel.reshard import merge_folded
    from torchmetrics_tpu_torch.quarantine import DegradedValue
    from torchmetrics_tpu_torch.testing import faults
    from torchmetrics_tpu_torch.utils.exceptions import FleetProtocolError

    spec, batch = FLEET, FEMNIST["batch"]
    ids = [f"leaf/{i:02d}" for i in range(spec["leaves"])]
    # each site's samples on the card once, and its batches: every writer's
    # batches of 32 and its shorter last one, writers in order
    sites = {lid: {"logits": [], "target": [], "bounds": []} for lid in ids}
    for w, (logits, target) in enumerate(data["writers"]):
        site = sites[ids[w % spec["leaves"]]]
        off = sum(len(t) for t in site["target"])
        n = len(target)
        site["bounds"] += [(off + lo, off + min(lo + batch, n)) for lo in range(0, n, batch)]
        site["logits"].append(logits)
        site["target"].append(target)
    for site in sites.values():
        site["logits"] = torch.from_numpy(np.concatenate(site.pop("logits"))).to(dev)
        site["target"] = torch.from_numpy(np.concatenate(site.pop("target"))).to(dev)
    leaves = {lid: _fleet_leaf(dev) for lid in ids}
    recorded = {lid: [] for lid in ids}

    def recording(lid):
        source = _fleet_source(leaves[lid])

        def src():
            out = source()
            recorded[lid].append(out)
            return out

        return src

    topo = FleetTopology(ids, fanout=spec["fanout"])
    tmp = tempfile.mkdtemp(prefix="femnist_fleet_")
    fleet = build_fleet(topo, snapshot_dir=tmp, watermark=spec["watermark"])
    victim = topo.parent_of("leaf/08")
    fleet.aggregators[victim].snapshot_every = 1  # the node that dies snapshots every applied delta
    merge_ms: list = []
    for agg in fleet.aggregators.values():
        _timed_receive(agg, merge_ms)
    exporters = {
        lid: fleet.leaf_exporter(lid, recording(lid), outbox_limit=spec["watermark"] if lid == "leaf/05" else 64)
        for lid in ids
    }
    rounds = -(-max(len(s["bounds"]) for s in sites.values()) // spec["ship_every"])
    # (first round, last round, fault): nested, so the patched seam unwinds in order
    schedule = [
        (0, 11, lambda: faults.partition_leaf("leaf/05", epochs=12)),
        (2, 2, lambda: faults.drop_delta("leaf/00", n=1)),
        (3, 4, lambda: faults.drop_delta("leaf/01", n=4)),  # 3 attempts fail a send; the 4th, a round later, a retry
        (5, 6, lambda: faults.duplicate_delta("leaf/02")),
        (7, 10, lambda: faults.delay_delta("leaf/03", epochs=2)),
        (12, 14, lambda: faults.partition_leaf("leaf/04", epochs=3)),
        (16, 16, lambda: faults.corrupt_delta_payload("leaf/06", n=1)),
        (18, 19, lambda: faults.kill_aggregator(fleet.aggregators[victim])),
    ]
    obs.reset()
    bincount.launches = 0
    export_ms, flush_ms, updates, counters, partition_read = [], [], 0, {}, None
    leaf_bytes = {"exact": 0, "quantized": 0}  # the leaves' own deltas, without the interior links
    open_faults = {}
    t_run = time.perf_counter()
    for r in range(rounds):
        for i, (first, last, make) in enumerate(schedule):
            if first == r:
                open_faults[i] = ExitStack()
                counters[i] = open_faults[i].enter_context(make())
        for t in range(r * spec["ship_every"], (r + 1) * spec["ship_every"]):
            for lid in ids:
                site = sites[lid]
                if t >= len(site["bounds"]):
                    continue
                lo, hi = site["bounds"][t]
                logits, target = site["logits"][lo:hi], site["target"][lo:hi]
                leaves[lid]["cls"].update(logits, target)
                top = logits.softmax(-1).amax(-1)
                for m in leaves[lid]["agg"].values():
                    m.update(top)
                updates += 1
                if (t + 1) % spec["ship_every"] == 0 or t + 1 == len(site["bounds"]):
                    t0 = time.perf_counter()
                    leaf_bytes["exact"] += wire_payload_bytes(exporters[lid].export().payload)
                    t1 = time.perf_counter()
                    exporters[lid].flush()
                    export_ms.append((t1 - t0) * 1e3)
                    flush_ms.append((time.perf_counter() - t1) * 1e3)
        fleet.pump()
        if r == 6:  # inside the long partition: a degraded read naming the partitioned site
            view = fleet.view()
            read = view.read()
            try:
                view.read(allow_degraded=False)
                refused = False
            except FleetProtocolError:
                refused = True
            partition_read = {
                "degraded": isinstance(read, DegradedValue),
                "coverage": read.coverage if isinstance(read, DegradedValue) else None,
                "partitioned_anchor": read.staleness["leaf/05"] if isinstance(read, DegradedValue) else None,
                "refused": refused,
            }
        if r == 19:
            successor = fleet.failover(victim)  # inside the kill: the successor from the newest snapshot
            _timed_receive(successor, merge_ms)
        for i, (first, last, make) in sorted(enumerate(schedule), key=lambda e: -e[0]):
            if last == r and i in open_faults:
                open_faults.pop(i).close()
    for _ in range(12):  # drain every outbox (breakers probe their way back)
        for ex in exporters.values():
            ex.flush()
        fleet.pump()
        if all(ex.outbox_size == 0 for ex in exporters.values()):
            break
    run_s = time.perf_counter() - t_run
    _check(all(ex.outbox_size == 0 for ex in exporters.values()), "femnist_fleet: the outboxes did not drain")
    launches = bincount.launches
    extra = sum(_executor_extra(leaf["cls"]) for leaf in leaves.values())
    _check(launches == updates + extra, f"femnist_fleet: {launches} bincount launches for {updates} site updates (+{extra} the executor's)")
    _check(partition_read is not None and partition_read["degraded"] and partition_read["refused"]
           and partition_read["coverage"] == (spec["leaves"] - 1) / spec["leaves"]
           and partition_read["partitioned_anchor"]["applied_epoch"] == 0,
           f"femnist_fleet: the read during the partition was {partition_read}")
    view = fleet.view()
    got = view.read()
    _check(view.healthy() and not isinstance(got, DegradedValue), "femnist_fleet: the root's final read is degraded")
    # the fault-free fold: every site's state read directly, merged in sorted
    # site order along the tree (each interior node's sites, then the
    # interior nodes), the order the aggregators fold in
    finals = {lid: _fleet_source(leaves[lid])() for lid in ids}
    reds = finals[ids[0]][1]

    def fold(states):
        out = None
        for state in states:
            state = {k: np.asarray(v) for k, v in state.items()}
            out = state if out is None else {k: np.asarray(v) for k, v in merge_folded(out, state, reds).items()}
        return out

    want = fold(fold(finals[lid][0] for lid in sorted(topo.children_of(node))) for node in sorted(topo.children_of(topo.root)))
    _check(set(got) == set(want), f"femnist_fleet: fields {sorted(got)} != {sorted(want)}")
    for k in want:
        _check(got[k].dtype == want[k].dtype and got[k].shape == want[k].shape and np.array_equal(got[k], want[k]),
               f"femnist_fleet: {k} differs from the fault-free fold")
    _check(fleet.root.total_update_count() == updates, f"femnist_fleet: the root counts {fleet.root.total_update_count()} updates of {updates}")
    # values from the merged state against float64 from the plain counts
    plain = _femnist_plain_counts(data, dev).sum(0)
    merged_cm = torch.from_numpy(got["confmat.confmat"]).to(dev)
    _check(torch.equal(merged_cm.to(torch.int64), plain), "femnist_fleet: the merged confusion matrix differs from the plain counts")
    fresh = _fleet_leaf(dev)
    for name, m in fresh["cls"].items(keep_base=True):
        m.load_state({f: torch.from_numpy(got[f"{name}.{f}"]).to(dev) for f in m._defaults}, update_count=1)
    values = fresh["cls"].compute()
    tp, fp, _, fn = (s.double() for s in _stats_of(plain))
    present = (tp + fp + fn) > 0
    f1 = torch.where(2 * tp + fp + fn > 0, 2 * tp / (2 * tp + fp + fn).clamp(min=1), torch.zeros_like(tp))
    top = torch.cat([sites[lid]["logits"].softmax(-1).amax(-1) for lid in ids]).double()
    value_errors = {
        "accuracy": abs(float(values["accuracy"]) - float(tp.sum() / plain.sum())),
        "f1": abs(float(values["f1"]) - float(f1[present].mean())),
        "max": abs(float(got["max.max_value"]) - float(top.max())),
        "mean": abs(float(got["mean.mean_value"]) / float(got["mean.weight"]) - float(top.mean())),
    }
    _check(value_errors["accuracy"] <= FEMNIST_ATOL and value_errors["f1"] <= FEMNIST_ATOL and value_errors["max"] == 0,
           f"femnist_fleet: values from the merged state {value_errors}")
    # float32 sums: a site's running sum of batch sums, then 64 merges
    mean_tol = _f32_rtol(max(len(s["bounds"]) for s in sites.values()) + spec["leaves"], batch) * float(top.mean())
    _check(value_errors["mean"] <= mean_tol, f"femnist_fleet: the mean is {value_errors['mean']} from float64 (> {mean_tol})")
    _check(np.array_equal(np.sort(got["cat.value"]), np.sort(top.float().cpu().numpy())),
           "femnist_fleet: the merged rows are not the samples' top probabilities")
    corrupt_ledger = fleet.aggregators[topo.parent_of("leaf/06")].ledger("leaf/06")
    _check(corrupt_ledger.stats["corrupt_dropped"] == 1 and corrupt_ledger.stats["resyncs"] >= 2,
           f"femnist_fleet: the corrupted site's ledger {corrupt_ledger.stats}")
    _check(exporters["leaf/05"].stats["outbox_overflows"] >= 1 and exporters["leaf/01"].stats["exports"] > 0,
           f"femnist_fleet: the long partition's exporter {exporters['leaf/05'].stats}")
    _check(counters[1]["dropped"] == 1 and counters[2]["dropped"] == 4 and counters[3]["duplicated"] >= 1
           and counters[4]["delivered_late"] and counters[5]["dropped_epochs"] and counters[6]["corrupted"] == 1,
           f"femnist_fleet: a fault did not fire: {counters}")
    hist = obs.histograms_snapshot().get("fleet.aggregation_lag_us")
    exact_bytes = fleet.uplink.stats["bytes"]
    shipped = fleet.uplink.stats["sent"]

    # the quantized pass: the same traffic (every recorded ship of every site,
    # in order) through a fresh tree at 8 bits
    qfleet = build_fleet(topo, watermark=spec["watermark"])
    cursor = {lid: iter(recorded[lid]) for lid in ids}
    qexporters = {lid: qfleet.leaf_exporter(lid, (lambda lid=lid: next(cursor[lid])), precision="quantized",
                                             bits=spec["bits"], block_size=spec["block"]) for lid in ids}
    order = []  # the exact pass's ship order, rebuilt from the recorded counts per round
    for r in range(rounds):
        for t in range(r * spec["ship_every"], (r + 1) * spec["ship_every"]):
            for lid in ids:
                n_batches = len(sites[lid]["bounds"])
                if t < n_batches and ((t + 1) % spec["ship_every"] == 0 or t + 1 == n_batches):
                    order.append((r, lid))
    t0 = time.perf_counter()
    last_round = 0
    for r, lid in order:
        if r != last_round:
            qfleet.pump()
            last_round = r
        leaf_bytes["quantized"] += wire_payload_bytes(qexporters[lid].export().payload)
        qexporters[lid].flush()
    qfleet.pump()
    qship_ms = (time.perf_counter() - t0) * 1e3 / max(1, len(order))
    qgot = qfleet.view().read()
    _check(not isinstance(qgot, DegradedValue), "femnist_fleet: the quantized root's read is degraded")
    q_errors = {}
    stacks = {k: np.stack([np.asarray(finals[lid][0][k]) for lid in sorted(ids)]) for k in want if reds[k] != "cat"}
    for k in want:
        if np.issubdtype(want[k].dtype, np.integer) or want[k].dtype == np.bool_:
            _check(np.array_equal(qgot[k], want[k]), f"femnist_fleet: the quantized pass changed integer field {k}")
            continue
        err = np.abs(qgot[k].astype(np.float64) - want[k].astype(np.float64))
        if reds[k] == "cat":
            bound = np.abs(want[k]).max() / (2.0 * _qmax(spec["bits"])) + np.zeros_like(err)
        else:
            bound = reduce_error_bound(stacks[k], reds[k], bits=spec["bits"], block_size=spec["block"])
        bound = bound + 1e-6 * np.abs(want[k])  # float32 rounding of the decoded sums
        _check(bool((err <= bound).all()), f"femnist_fleet: quantized {k} off by {err.max()} beyond its bound")
        q_errors[k] = {"max_abs_err": float(err.max()), "bound_max": float(np.max(bound))}
    shutil.rmtree(tmp, ignore_errors=True)

    def p(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    return _emit({
        "phase": "femnist_fleet", "sites": spec["leaves"], "aggregators": len(topo.aggregators), "rounds": rounds,
        "site_updates": updates, "deltas_shipped": shipped, "exports": len(export_ms), "run_s": run_s,
        "ship_ms": {"p50": p(export_ms, 0.5), "p99": p(export_ms, 0.99), "mean": sum(export_ms) / len(export_ms)},
        "flush_ms_p50": p(flush_ms, 0.5),
        "merge_ms": {"p50": p(merge_ms, 0.5), "p99": p(merge_ms, 0.99), "mean": sum(merge_ms) / len(merge_ms),
                     "merges": len(merge_ms)},
        "aggregation_lag_us": {"p50": _hist_quantile(hist, 0.5), "p99": _hist_quantile(hist, 0.99),
                               "count": hist["count"]} if hist else None,
        "wire_bytes": {"exact": exact_bytes, "quantized": qfleet.uplink.stats["bytes"],
                       "ratio": qfleet.uplink.stats["bytes"] / exact_bytes,
                       "leaf_deltas": leaf_bytes, "leaf_ratio": leaf_bytes["quantized"] / leaf_bytes["exact"]},
        "quantized_ship_ms_mean": qship_ms, "quantized_errors": q_errors,
        "faults": {"drop_within": counters[1], "drop_past": counters[2], "duplicated": counters[3],
                   "delayed": counters[4], "partition_3": sorted(counters[5]["dropped_epochs"]),
                   "partition_12": sorted(counters[0]["dropped_epochs"]), "corrupted": counters[6]},
        "partition_read": partition_read, "value_errors": value_errors, "bincount_launches": launches,
        "bit_equal": True,
    })


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
        and not ev.key.startswith("tm_tpu.")  # a span's profiler range repeats its kernels' time too
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


#: the compile cache's phase (imagenet_val_compile_cache): child processes
#: over ImageNet-1k val's collection sharing one store, each bounded; the
#: background run's wave of replays beside a capture (the first half of the
#: first batch, 512 rows: a key of its own) for the live thread's wait on
#: the device's lock
COMPILE_CACHE = {"child_timeout_s": 300, "lock_wave_updates": 64}
#: the children, in order: (mode, store, environment). "store" is the shared
#: store, "bg" the background run's own (its keys must miss)
COMPILE_CACHE_RUNS = (
    ("cold", "store", {"TORCHMETRICS_TPU_COMPILE_AHEAD": "1"}),
    # the same cold run with the store off (the main process's setting): what
    # the store's lookup and its writes on the worker cost the first updates
    ("cold_store_off", "off", {"TORCHMETRICS_TPU_COMPILE_AHEAD": "0"}),
    ("warm", "store", {"TORCHMETRICS_TPU_COMPILE_AHEAD": "1"}),
    ("manifest", "store", {"TORCHMETRICS_TPU_COMPILE_AHEAD": "0"}),
    ("poisoned_flip", "store", {"TORCHMETRICS_TPU_COMPILE_AHEAD": "1"}),
    ("poisoned_stale", "store", {"TORCHMETRICS_TPU_COMPILE_AHEAD": "1"}),
    ("background", "bg", {"TORCHMETRICS_TPU_COMPILE_AHEAD": "1", "TORCHMETRICS_TPU_BG_COMPILE": "1"}),
)


def _bincount_per_replay(entry) -> int:
    from torchmetrics_tpu_torch.ops import bincount

    return sum(n for m, attr, n in entry.launches if m is bincount and attr == "launches")


def _compile_cache_child(mode: str, out_dir: str, device: str) -> None:
    """One process of ``phase_imagenet_val_compile_cache`` (started as
    ``python3 -c``, its store and flags in the environment): the ImageNet
    collection over every batch, each update timed (host and synchronised
    wall time) and classed as a replay or an eager call, with the launches
    the main thread made; the states, values and figures written to
    ``out_dir``. ``manifest`` first warms from the cold run's saved profile;
    ``background`` then replays beside a capture of a new key."""
    import warnings

    import torch

    from torchmetrics_tpu_torch.ops import bincount, compile_cache, launch_counts

    warnings.simplefilter("always")
    dev = torch.device(device)
    spec = _imagenet_indexed(dev)
    key = (bincount.__name__, "launches")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        coll = spec["collection"]()
        out = {"mode": mode}
        if mode == "manifest":
            t0 = time.perf_counter()
            out["warmup"] = coll.warmup_from_manifest(os.path.join(out_dir, "profile.json"))
            torch.cuda.synchronize()
            out["warmup_s"] = time.perf_counter() - t0
        ex = coll._get_executor()
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream(dev)
        bincount.launches = 0
        main_start = launch_counts.thread_counts().get(key, 0)
        rows, kept = [], []
        for i, batch in enumerate(spec["batches"]()):
            if i < 4:
                kept.append(batch)
            before = ex.stats_dict()
            disp = ex._dispatcher
            replays = {id(e): (e, e.replays) for e in disp.entries.values()} if disp is not None else {}
            c0 = launch_counts.thread_counts().get(key, 0)
            # the caller's stream, never the whole device: a device-wide
            # synchronize raises while the worker captures
            stream.synchronize()
            t0 = time.perf_counter()
            coll.update(*batch)
            host_s = time.perf_counter() - t0
            stream.synchronize()
            wall_s = time.perf_counter() - t0
            after = ex.stats_dict()
            disp = ex._dispatcher
            replayed = [e for e in (disp.entries.values() if disp is not None else ()) if e.replays > replays.get(id(e), (e, 0))[1]]
            rows.append({
                "wall_ms": wall_s * 1e3, "host_us": host_s * 1e6,
                "replayed": after["cache_hits"] > before["cache_hits"],
                "per_replay": _bincount_per_replay(replayed[0]) if replayed else None,
                "probes": after["probes"] - before["probes"],
                "launched": launch_counts.thread_counts().get(key, 0) - c0,
                "compiles": after["compiles"] - before["compiles"],
            })
            if i == 0:
                out["disk_hits_before_first_executor_call"] = after["disk_hits"]
        compile_cache.drain_worker(120)
        torch.cuda.synchronize()
        stats = ex.stats_dict()
        entries = list(ex._dispatcher.entries.values())
        out.update(
            rows=rows, stats={k: v for k, v in stats.items() if k != "eager"}, eager=stats["eager"],
            total_launches=bincount.launches,
            main_thread_launches=launch_counts.thread_counts().get(key, 0) - main_start,
            thread_launches=sum(c.get(key, 0) for c in launch_counts.all_threads().values()),
            entries_per_replay=sorted(_bincount_per_replay(e) for e in entries),
            lock_wait_main_us=ex.device_lock_wait_us_max(),
            worker=dict(compile_cache.get_worker().stats),
        )
        torch.save(
            {"state": {k: {f: t.cpu() for f, t in v.items()} for k, v in _leader_state(coll).items()},
             "result": {k: v.cpu() for k, v in coll.compute().items()}},
            os.path.join(out_dir, f"{mode}.pt"),
        )
        if mode == "cold":
            coll.save_shape_profile(os.path.join(out_dir, "profile.json"))
        if mode == "background":
            # a new key's capture on the worker while the live thread replays
            small = tuple(t[: t.shape[0] // 2] for t in kept[0])
            coll.update(*small)
            for j in range(COMPILE_CACHE["lock_wave_updates"]):
                coll.update(*kept[j % len(kept)])
            compile_cache.drain_worker(120)
            torch.cuda.synchronize()
            wave = ex.stats_dict()
            out["lock_wave"] = {
                "eager_misses": wave["eager_misses"] - stats["eager_misses"],
                "background_compiles": wave["background_compiles"] - stats["background_compiles"],
                "replays": wave["cache_hits"] - stats["cache_hits"],
                "lock_wait_max_us": ex.device_lock_wait_us_max(),
            }
    out["warnings"] = [str(w.message)[:300] for w in caught if "compile cache" in str(w.message)]
    with open(os.path.join(out_dir, f"{mode}.json"), "w") as fh:
        json.dump(out, fh)


def _library_rebuilds(dev) -> list:
    """A copy of the built ``bincount`` library, first with one flipped
    byte, then with a sidecar naming another toolchain, each in a scratch
    ``BUILD_DIR``: the next launch must warn (naming the file), rebuild it
    with ``nvcc`` and agree with the plain body. Each launch's seconds (the
    rebuild's, mostly) are printed."""
    import shutil
    import warnings

    import torch

    from torchmetrics_tpu_torch.ops import bincount, native

    built = native.build(["bincount"])["bincount"]
    saved = native.BUILD_DIR
    rows = []
    x = torch.randint(-5, IMAGENET["num_classes"] ** 2 + 5, (IMAGENET["batches"][0],), device=dev, dtype=torch.int32)
    want = bincount._wbincount_reference(x, None, IMAGENET["num_classes"] ** 2)
    for case in ("flip", "other_toolchain"):
        try:
            native.BUILD_DIR = _runtime_dir(f"compile_cache_library_{case}")
            path = native.library_path("bincount")
            sidecar = path.with_name(path.name + ".json")
            shutil.copy(built, path)
            shutil.copy(built.with_name(built.name + ".json"), sidecar)
            if case == "flip":
                data = bytearray(path.read_bytes())
                data[len(data) // 2] ^= 0xFF
                path.write_bytes(bytes(data))
            else:
                record = json.loads(sidecar.read_text())
                record["toolchain"] = "compiler=nvcc 0.0|flags=|target=sm_00"
                sidecar.write_text(json.dumps(record))
            native._LIBS.pop("bincount", None)
            bincount._entry.cache_clear()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = bincount._wbincount_cuda(x, None, IMAGENET["num_classes"] ** 2)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            named = [str(w.message) for w in caught if str(path) in str(w.message) and "damaged or stale" in str(w.message)]
            _check(len(named) == 1, f"imagenet_val_compile_cache: the {case} library was not warned about once: {[str(w.message) for w in caught]}")
            _check(torch.equal(got, want), f"imagenet_val_compile_cache: the rebuilt ({case}) bincount disagrees with the plain body")
            _check(json.loads(sidecar.read_text())["length"] == path.stat().st_size,
                   f"imagenet_val_compile_cache: the rebuilt ({case}) library's sidecar does not match it")
            rows.append({"case": case, "warning": named[0][:240], "launch_with_rebuild_s": seconds,
                         "nvcc_log_lines": len(native.build_logs.get("bincount", "").splitlines()), "max_abs_err": 0})
        finally:
            native.BUILD_DIR = saved
            native._LIBS.pop("bincount", None)
            bincount._entry.cache_clear()
    return rows


def phase_imagenet_val_compile_cache(dev) -> dict:
    """The compile cache (``ops/compile_cache.py``) over ImageNet-1k val's
    collection at full width, in child processes that share a store
    (``COMPILE_CACHE_RUNS``): a cold run (the captures it makes, the store's
    writes, its saved shape profile), the same cold run with the store off
    (its first updates against the cold run's), a warm one (every recorded key built
    at the group resolution, before the executor's first call, which
    replays), one warmed from the saved manifest with the store off (its
    first update replays), two over a poisoned store (one flipped byte,
    then a stale toolchain: each warns, misses, finishes), and one with
    background captures (cold keys served eagerly, captured on the worker,
    then replayed; every ``bincount`` launch accounted for by thread; the
    live thread's longest wait on the device's lock beside a capture).
    Every child's states and values bit-equal to ``executor=False`` here.
    Then the damaged-library rebuilds (:func:`_library_rebuilds`)."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.testing import corrupt_cache_entry, stale_cache_version

    spec = _imagenet_indexed(dev)
    ref = spec["collection"](executor=False)
    per_update = []
    for batch in spec["batches"]():
        before = bincount.launches
        ref.update(*batch)
        per_update.append(bincount.launches - before)
    want_state = {k: {f: t.cpu() for f, t in v.items()} for k, v in _leader_state(ref).items()}
    want_result = {k: v.cpu() for k, v in ref.compute().items()}
    torch.cuda.synchronize()
    dirs = {"store": _runtime_dir("compile_cache_store"), "bg": _runtime_dir("compile_cache_bg"),
            "off": _runtime_dir("compile_cache_off")}
    out_dir = _runtime_dir("compile_cache_runs")
    root = os.path.dirname(os.path.abspath(__file__))
    runs, t_phase = {}, time.perf_counter()
    for mode, store, flags in COMPILE_CACHE_RUNS:
        if mode == "poisoned_flip":
            corrupt_cache_entry(str(dirs["store"]), mode="flip", which="all")
        elif mode == "poisoned_stale":
            stale_cache_version(str(dirs["store"]), which="all")
        env = dict(os.environ, TORCHMETRICS_TPU_CACHE_DIR=str(dirs[store]), TORCHMETRICS_TPU_BG_COMPILE="0")
        env.update(flags)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke._compile_cache_child({mode!r}, {str(out_dir)!r}, {str(dev)!r})"],
            cwd=root, env=env, capture_output=True, text=True, timeout=COMPILE_CACHE["child_timeout_s"],
        )
        _check(proc.returncode == 0, f"imagenet_val_compile_cache: the {mode} child failed:\n{proc.stderr[-3000:]}")
        with open(os.path.join(out_dir, f"{mode}.json")) as fh:
            run = json.load(fh)
        run["process_s"] = time.perf_counter() - t0
        saved = torch.load(os.path.join(out_dir, f"{mode}.pt"))
        for leader, fields in want_state.items():
            for f, v in fields.items():
                _check(torch.equal(saved["state"][leader][f], v), f"imagenet_val_compile_cache: {mode}: {leader}.{f} differs from executor=False")
        _same_result(f"imagenet_val_compile_cache {mode}", saved["result"], want_result)
        runs[mode] = run
    cold, warm, manifest, bg = runs["cold"], runs["warm"], runs["manifest"], runs["background"]
    _check(cold["stats"]["compiles"] >= 1 and cold["stats"]["disk_hits"] == 0 and cold["stats"]["disk_stores"] == cold["stats"]["compiles"],
           f"imagenet_val_compile_cache: cold run: {cold['stats']}")
    _check(warm["disk_hits_before_first_executor_call"] >= 1 and warm["rows"][1]["replayed"] and warm["stats"]["compiles"] == 0,
           f"imagenet_val_compile_cache: the warm run's first executor call did not replay a stored key: {warm['stats']}")
    _check(manifest["warmup"]["warmed"] >= 1 and manifest["rows"][0]["replayed"] and manifest["stats"]["disk_hits"] == 0,
           f"imagenet_val_compile_cache: the manifest run's first update did not replay: {manifest['warmup']} {manifest['stats']}")
    for mode, text in (("poisoned_flip", "damaged/stale entry"), ("poisoned_stale", "stale toolchain")):
        run = runs[mode]
        _check(any(text in w for w in run["warnings"]) and run["stats"]["disk_hits"] == 0 and run["stats"]["compiles"] >= 1,
               f"imagenet_val_compile_cache: {mode} did not warn and miss: {run['warnings']} {run['stats']}")
    stats = bg["stats"]
    _check(stats["eager_misses"] >= 1 and stats["background_compiles"] >= 1 and stats["cache_hits"] >= 1,
           f"imagenet_val_compile_cache: background run: {stats}")
    # every launch accounted for: each update the main thread served eagerly
    # launches what executor=False's did, each replay its key's recorded
    # launches (and a probe one eager update more); the worker's launches
    # are each background capture's eager run, one replay's worth
    for i, row in enumerate(bg["rows"]):
        _check(not row["replayed"] or row["per_replay"] is not None, f"imagenet_val_compile_cache: background update {i} replayed no key")
        want = (row["per_replay"] or 0) + row["probes"] * per_update[i] if row["replayed"] else per_update[i]
        _check(row["launched"] == want, f"imagenet_val_compile_cache: background update {i} launched {row['launched']}, {want} expected ({row})")
    worker = bg["total_launches"] - bg["main_thread_launches"]
    _check(worker == sum(bg["entries_per_replay"]) and bg["thread_launches"] == bg["total_launches"],
           f"imagenet_val_compile_cache: the worker launched {worker}, its captures' eager runs {bg['entries_per_replay']}")
    _check(bg["lock_wave"]["background_compiles"] == 1 and bg["lock_wave"]["replays"] >= COMPILE_CACHE["lock_wave_updates"] - 8,
           f"imagenet_val_compile_cache: the lock wave: {bg['lock_wave']}")
    library = _library_rebuilds(dev)

    def summary(run: dict) -> dict:
        rows = run["rows"]
        steady = [r for r in rows[2:-1] if r["replayed"]]
        return {
            "process_s": run["process_s"], "first_update_ms": rows[0]["wall_ms"], "first_executor_update_ms": rows[1]["wall_ms"],
            "first_executor_update_replayed": rows[1]["replayed"], "update_ms_p50": statistics.median(r["wall_ms"] for r in rows),
            "replay_host_us_p50": statistics.median(r["host_us"] for r in steady) if steady else None,
            "last_update_ms": rows[-1]["wall_ms"], "replays": sum(r["replayed"] for r in rows),
            **{k: run["stats"][k] for k in ("compiles", "cache_hits", "disk_hits", "disk_stores", "disk_evictions", "eager_misses",
                                           "background_compiles", "compile_us_total", "probes", "padded_calls")},
            "eager_calls": run["eager"]["calls"], "warnings": run["warnings"],
        }

    off = runs["cold_store_off"]
    _check(off["stats"]["disk_stores"] == 0 and off["stats"]["disk_hits"] == 0 and off["stats"]["compiles"] == cold["stats"]["compiles"],
           f"imagenet_val_compile_cache: the cold run with the store off: {off['stats']}")

    def first(run: dict, n: int) -> float:
        return sum(r["wall_ms"] for r in run["rows"][:n])

    out = {
        "phase": "imagenet_val_compile_cache", "updates": len(per_update), "classes": IMAGENET["num_classes"],
        "runs": {mode: summary(run) for mode, run in runs.items()},
        # the store at its default (on) against off, in one cold process
        # each over the same batches: the first updates' synchronised wall ms
        "store_on_vs_off": {
            f"first_{n}_updates_ms": {"on": first(cold, n), "off": first(off, n)} for n in (1, 2, 5, len(per_update))
        },
        "warm_disk_hits_before_first_executor_call": warm["disk_hits_before_first_executor_call"],
        "manifest_warmup": manifest["warmup"], "manifest_warmup_s": manifest["warmup_s"],
        "background": {
            "launches_total": bg["total_launches"], "launches_main_thread": bg["main_thread_launches"],
            "launches_worker": worker, "entries_per_replay": bg["entries_per_replay"],
            "lock_wait_max_us_main_pass": bg["lock_wait_main_us"], "lock_wave": bg["lock_wave"], "worker": bg["worker"],
        },
        "library": library, "children_s": time.perf_counter() - t_phase,
        "bincount_launches": sum(run["total_launches"] for run in runs.values()),
    }
    return _emit(out)


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


def phase_profile_femnist(dev, data: dict, steps: int = 5) -> dict:
    """Where a laned round's time goes: ``torch.profiler`` over ``steps``
    full-batch rounds of every FEMNIST writer (one ``update_sessions`` call
    each, after a warm-up round that admits the sessions): device time by
    kernel and the device's idle share of the wall time."""
    from torchmetrics_tpu_torch import lanes

    batch = FEMNIST["batch"]
    by_round = {}
    for w, (logits, target) in enumerate(data["writers"]):
        for b in range(min(len(target) // batch, steps + 2)):
            by_round.setdefault(b, []).append((w, (logits[b * batch:(b + 1) * batch], target[b * batch:(b + 1) * batch])))
    coll = lanes.LanedCollection(_femnist_members(dev), capacity=FEMNIST["capacity"])
    coll.update_sessions(by_round[0])

    def step(i: int) -> None:
        coll.update_sessions(by_round[i + 2])

    rows, wall_us = _profiled(step, steps)
    busy_us = sum(r[1] for r in rows)
    complete = _complete(rows, steps)
    return _emit({
        "phase": "profile_femnist_writers", "rounds": steps, "rows_per_round": [len(by_round[i + 2]) for i in range(steps)],
        "complete": complete, "wall_ms_per_round": wall_us / steps / 1e3,
        "device_ms_per_round": busy_us / steps / 1e3 if complete else None,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us) if wall_us and complete else None,
        "top_device_kernels": [
            {"name": k[:120], "ms_per_round": us / steps / 1e3, "calls_per_round": n / steps, "ms_per_launch": us / n / 1e3}
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

    for name, n, len_t, kind, edges, form in CURVE_SHAPES:
        args = _curve_args(n, len_t, kind, edges, form, dev)
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
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the compile cache (ops/compile_cache.py): this process's store is a
    # fresh directory, and off. On, a second instance of an owner builds the
    # keys the first stored, each with an eager run on zero inputs: real
    # launches that the phases' exact launch counts do not hold. Its own
    # phase runs the store at its default in child processes, and times a
    # cold process with it on against one with it off
    os.environ["TORCHMETRICS_TPU_CACHE_DIR"] = str(_runtime_dir("compile_cache_main"))
    os.environ["TORCHMETRICS_TPU_COMPILE_AHEAD"] = "0"
    os.environ.pop("TORCHMETRICS_TPU_BG_COMPILE", None)
    from torchmetrics_tpu_torch.native import build as build_text_library
    from torchmetrics_tpu_torch.native import build_pesq as build_pesq_library
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
    kernels_s = time.perf_counter() - t0
    text_library = build_text_library()
    pesq_library = build_pesq_library()
    _emit({
        "phase": "build", "seconds": time.perf_counter() - t0, "kernels_s": kernels_s,
        "libraries": {k: str(v.name) for k, v in paths.items()}, "text_library": text_library.name,
        "pesq_library": pesq_library.name,
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
    # the captured executor: four workloads with it off and on over the same batches
    executor = [phase_executor(name, dev) for name in EXECUTOR_PHASES]
    sqrtm_rows = phase_sqrtm_kernels(dev)
    cifar = phase_cifar10(dev)
    featureshare = phase_cifar10_featureshare(dev, cifar)
    del cifar["_reuse"]
    sync = phase_sync(dev)
    rest = [phase_imagenet_rest(dev), phase_coco_multilabel(dev), phase_civilcomments_fairness(dev)]
    image_rest = [phase_div2k(dev), phase_wv3(dev)]
    # regression and pairwise: plain PyTorch, no kernel of the port
    phase_nyu_depth(dev)
    phase_weatherbench(dev)
    phase_nasbench(dev)
    phase_inshop_pairwise(dev)
    # the wrappers and nominal association, on the bincount kernel
    boot = phase_imagenet_bootstrap(dev)
    wrapped = [boot, phase_imagenet_tracked(dev), phase_nyuv2_multitask(dev)]
    phase_ogbg_molpcba(dev)
    census = phase_census1990_nominal(dev)
    # text: host counting (the port's C++ library) and plain PyTorch, no kernel
    phase_wikitext2_perplexity(dev)
    phase_librispeech_asr(dev)
    phase_wmt14_mt(dev)
    phase_cnndm_rouge(dev)
    phase_squad_v11(dev)
    phase_wmt14_bertscore_infolm(dev)
    # audio: the host PESQ library, plain PyTorch on the card; clustering on the bincount kernel
    phase_libri2mix_separation(dev)
    phase_voicebank_demand_enhancement(dev)
    phase_reverb_srmr(dev)
    clusters = phase_imagenet_clustering(dev)
    # detection, segmentation, multimodal: plain PyTorch, but panoptic
    # quality's intersection tables on the bincount kernel
    phase_coco_val2017_bbox(dev)
    phase_coco_val2017_segm(dev)
    panoptic = phase_coco_panoptic_val2017(dev)
    phase_brats2021_surface(dev)
    phase_coco_karpathy_clipscore(dev)
    # the runtime layers on the ImageNet counting path: tracing, a real
    # preemption with autosave and restore, asynchronous reads
    runtime = [phase_imagenet_val_traced(dev), phase_imagenet_val_preempted(dev), phase_imagenet_val_async(dev)]
    # session lanes over LEAF FEMNIST's writers: the row-folded bincount a
    # round, the staging-slab ingest and lane fault containment
    femnist_data = _femnist_data()
    femnist = phase_femnist_writers(dev, femnist_data)
    femnist_guarded = phase_femnist_writers_guarded(dev, femnist_data, femnist)
    del femnist["_reuse"]
    # streaming windows: Criteo's hours as a click-through-rate monitor's
    # windows, and the FEMNIST writers as windowed session lanes
    criteo = phase_criteo_kaggle_hourly_windows(dev)
    femnist_windowed = phase_femnist_writers_windowed(dev, femnist_data)
    # class-axis sharding at GLDv2-clean's 81,313 classes, and the deferred
    # stacked layouts over ImageNet's collection and FEMNIST's lanes
    femnist_deferred = phase_femnist_writers_deferred(dev, femnist_data)
    gldv2 = phase_gldv2_clean_class_sharded(dev)
    deferred = phase_imagenet_val_deferred(dev)
    # state integrity and the fleet: the fingerprint kernel's checks, the
    # audited ImageNet collection, GLDv2's second pass over its 26.45 GB
    # class-sharded state, and a 64-site FEMNIST fleet under chaos
    fp_rows = phase_fingerprint_kernels(dev)
    audited = phase_imagenet_val_audited(dev)
    torch.cuda.empty_cache()  # one 49 GB block for GLDv2's audited pass
    gldv2_audited = phase_gldv2_clean_audited(dev, gldv2.pop("_reuse"))
    torch.cuda.empty_cache()
    femnist_fleet = phase_femnist_fleet(dev, femnist_data)
    del femnist_data
    # the deferred collection step: a step or a 48-step chunk as one captured
    # graph over 1 and 8 stacked shards, the read point, the shard shadow's
    # policies, the audits, the elastic restore and the exports (after
    # GLDv2's passes, whose 49 GB blocks it would otherwise fragment)
    deferred_step = phase_imagenet_val_deferred_step(dev)
    # the compile cache: cold, warm, manifest-warmed, poisoned and
    # background processes over the ImageNet collection, and damaged
    # kernel libraries rebuilt
    compile_cached = phase_imagenet_val_compile_cache(dev)
    if PROFILE:
        for name in WORKLOADS:
            # uvg and the rest of classification are profiled inside their phases
            if name not in ("uvg_1080p", "imagenet_rest", "coco_multilabel", "civilcomments_fairness"):
                phase_profile(name, dev)
        phase_profile_cifar10(dev)
        phase_profile_kernel_shapes(dev)
        phase_profile_femnist(dev, _femnist_data())

    # top-level numbers: each kernel's heaviest launch on its main path (the
    # Cityscapes update's weightless 361-bin count over 8.4M pixels; the config-6
    # update's 100 thresholds over 1M scores, its int64 target read with
    # ignore_index as the update passes it; MS MARCO's 6,980 x 1,000 grid
    # at k = 10; the 1080p update's fused SSIM call over 24 planes); every
    # shape under "shapes"
    main = next(r for r in rows if r["shape"] == "cityscapes_confmat_weightless")
    curve = next(r for r in curve_rows if r["shape"] == "config6_int64_ignore")
    topk = next(r for r in topk_rows if r["shape"] == "msmarco_k10")
    window = next(r for r in ssim["rows"] if r["shape"] == "div2k_vif17")
    fused = next(r for r in ssim["fused"] if r["shape"] == "uvg_1080p")
    root = next(r for r in sqrtm_rows if r["shape"] == "f2048_d1")
    _emit(_executor_tally())
    _emit({"phase": "done", "script_s": time.perf_counter() - started})
    _emit({"kernels": [
        {
            "name": "bincount",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
            "replaces": "torchmetrics_tpu/ops/bincount.py:76",
            "launches": imagenet["bincount_launches"] + cityscapes["bincount_launches"]
            + imagenet_curve["bincount_launches"] + sync["launches"]["bincount"]
            + sum(r["bincount_launches"] for r in rest)
            + sum(r["bincount_launches"] for r in wrapped) + boot["functional_bincount_launches"]
            + census["bincount_launches"] + clusters["bincount_launches"] + panoptic["bincount_launches"]
            + sum(r["bincount_launches"] for r in runtime)
            + femnist["bincount_launches"] + femnist_guarded["bincount_launches"]
            + criteo["bincount_launches"] + femnist_windowed["bincount_launches"]
            + femnist_deferred["bincount_launches"] + gldv2["bincount_launches"] + deferred["bincount_launches"]
            + deferred_step["bincount_launches"] + compile_cached["bincount_launches"]
            + audited["bincount_launches"] + gldv2_audited["bincount_launches"] + femnist_fleet["bincount_launches"]
            + sum(r["bincount_launches"] for r in executor),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            # the laned round's row-folded launch (femnist_writers)
            "femnist_rows": next(r for r in rows if r["shape"] == "femnist_rows_weightless"),
            "shapes": rows,
        },
        {
            "name": "binned_curve",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/binned_curve.cu",
            "replaces": "torchmetrics_tpu/ops/binned_curve.py:103",
            "launches": binary["binned_curve_launches"] + sync["launches"]["binned_curve"]
            + sum(r["binned_curve_launches"] for r in rest) + criteo["binned_curve_launches"]
            + sum(r["binned_curve_launches"] for r in executor),
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
            "launches": msmarco["topk_launches"] + sync["launches"]["retrieval_topk_stats"],
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
            "launches": uvg["ssim_launches"] + sum(r["ssim_windows_generic_launches"] for r in image_rest)
            + sum(r["ssim_windows_launches"] for r in executor),
            "fused_launches": uvg["ssim_launches"] + sum(r["ssim_windows_launches"] for r in executor),
            "generic_launches": sum(r["ssim_windows_generic_launches"] for r in image_rest),
            "max_abs_err": max([r["max_abs_err"] for r in ssim["rows"]] + [r["max_abs_err_ssim"] for r in ssim["fused"]]),
            # the headline is SSIM's entry: SSIM fused around the windows
            # (tm_ssim_fused), one launch an SSIM call, at the UVG update's
            # full scale
            "entry": "tm_ssim_fused",
            "ms": fused["ms"],
            "plain_ms": fused["plain_ms"],
            "bound_ms": fused["bound_ms"],
            "bound_by": fused["bound_by"],
            # one grouped F.conv2d of the padded five-plane stack (the
            # windows alone, without TF32)
            "library_ms": fused["library_ms"],
            "shapes": ssim["fused"],
            # the second entry: the generic windowed sum (tm_ssim_windows)
            # and its backward, the rest of image's route (UQI, RMSE-SW,
            # RASE, SCC, VIF, D_lambda, D_s, QNR) and SSIM's with a
            # gradient; its headline is the heaviest main-path launch, VIF's
            # 17-tap scale-0 window over a DIV2K batch's channel
            "generic": {
                "entry": "tm_ssim_windows",
                "shape": window["shape"],
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
            "launches": cifar["fid_sqrtm_launches_total"] + sync["launches"]["fid_sqrtm"]
            + featureshare["fid_sqrtm_launches"],
            "calls": sum(cifar["fid_sqrtm_calls"].values()) + featureshare["fid_sqrtm_calls"],
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
        {
            "name": "fingerprint",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/fingerprint.cu",
            # an XLA fold (jitted jax.lax.reduce with bitwise_xor, and a uint32
            # sum), no Pallas site
            "replaces": "torchmetrics_tpu/integrity.py:112",
            "replaces_kind": "XLA fold, no Pallas site",
            "launches": audited["fingerprint_launches"] + gldv2_audited["fingerprint_launches"]
            + deferred_step["fingerprint_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in fp_rows),
            # the headline: GLDv2's 26.45 GB class-sharded stack, one leaf
            "shape": "gldv2_confmat_stack",
            "ms": gldv2_audited["fold_ms"],
            "plain_ms": gldv2_audited["fold_plain_ms"],
            "bound_ms": gldv2_audited["fold_bound_ms"],
            "bound_by": "bytes",
            # no PyTorch call folds words with XOR: bitwise_xor is elementwise
            "library_ms": None,
            "shapes": fp_rows,
        },
    ]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
