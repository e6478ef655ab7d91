"""Threshold-binned confusion counts: the update of every binned curve metric.

The binned precision-recall curve, ROC, AUROC and average precision all keep
a ``(T, 2, 2)`` state: for each threshold, the 2 x 2 confusion counts of
``pred >= threshold`` against the 0/1 target, over the valid samples.

Two bodies behind the ``"binned_curve"`` entry of the dispatch seam
(ops/kernels.py):

- :func:`_binned_counts_cuda` launches the hand-written Hopper kernel in
  ``csrc/binned_curve.cu`` (the port of the JAX package's Pallas kernel
  ``ops/binned_curve.py:_binned_counts_pallas``); it serves every CUDA tensor;
- :func:`_binned_counts_reference`, the plain PyTorch version: bucket each
  sample by a search in the sorted thresholds, histogram the buckets, take
  a suffix sum. It serves CPU tensors and is the oracle the kernel is held
  against on the card.

Both count in int64, so they are exact at any N. The per-column form
:func:`binned_curve_counts_classwise` (multiclass one-vs-rest and multilabel
curves) has no kernel of its own: its histogram is one K = 2 call of the
``bincount`` kernel, one weightless launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from torchmetrics_tpu_torch.ops import kernels, native

#: launches of the CUDA kernel in this process (a plain counter that a run
#: resets and reads to show its main path went through the kernel)
launches = 0


#: ascending thresholds and the permutation that sorts them: the form every
#: count here takes its thresholds in
SortedThresholds = Tuple[torch.Tensor, torch.Tensor]


def sort_thresholds(thresholds: torch.Tensor) -> SortedThresholds:
    """Float32 thresholds in ascending order and the permutation that sorts
    them (stable, so duplicates keep their order). A binned metric sorts its
    thresholds once, when it is built or moved; a functional call sorts once
    a call."""
    thr_sorted, order = torch.sort(thresholds.to(torch.float32), stable=True)
    return thr_sorted.contiguous(), order.contiguous()


def _suffix_counts(hist: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``(2, T+1, C)`` bucket histograms (row 0 negatives, row 1 positives)
    -> ``(T, C, 2, 2)`` counts in the caller's threshold order.

    A sample in bucket ``k`` clears exactly the sorted thresholds ``t < k``,
    so the positive predictions at sorted threshold ``t`` are the samples of
    buckets above ``t``: the row total minus the cumulative sum through ``t``.
    """
    len_t = hist.shape[1] - 1
    totals = hist.sum(dim=1, keepdim=True)  # (2, 1, C)
    pred1_sorted = totals - torch.cumsum(hist, dim=1)[:, :len_t]  # (2, T, C)
    pred1 = torch.empty_like(pred1_sorted)
    pred1[:, order] = pred1_sorted
    pred0 = totals - pred1
    # (2 target, T, C) x (2 pred) -> (T, C, 2 target, 2 pred)
    return torch.stack([pred0, pred1], dim=-1).permute(1, 2, 0, 3)


def _buckets(preds: torch.Tensor, thr_sorted: torch.Tensor) -> torch.Tensor:
    """``#{t : thr_sorted[t] <= pred}`` per score; NaN scores go to bucket 0."""
    k = torch.searchsorted(thr_sorted, preds.contiguous(), right=True)
    return torch.where(torch.isnan(preds), torch.zeros_like(k), k)


def _binned_counts_reference(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: ``(T, 2, 2)`` int64 counts ``[t, target, pred]``
    in the caller's threshold order, where ``thresholds[order[k]] = thr_sorted[k]``.

    The port of the JAX package's ``_binned_counts_searchsorted``, with its
    sample weights (``target * valid`` positive, ``(1 - target) * valid``
    negative), counted in int64 rather than float32 so that it is exact at
    any N."""
    k = _buckets(preds, thr_sorted)
    t = target.to(torch.int64)
    v = valid.to(torch.int64)
    w = torch.stack([(1 - t) * v, t * v])  # (2, N)
    hist = torch.zeros((2, thr_sorted.shape[0] + 1), dtype=torch.int64, device=preds.device)
    hist.index_add_(1, k, w)
    return _suffix_counts(hist[:, :, None], order)[:, 0]


@functools.lru_cache(maxsize=None)
def _entry() -> Tuple[ctypes._CFuncPtr, ctypes._CFuncPtr]:
    """The kernel's C entry points, built and typed once: the launch, and the
    int64 scratch length it needs for T thresholds."""
    lib = native.load("binned_curve")
    launch, scratch = lib.tm_binned_curve, lib.tm_binned_curve_scratch
    launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    scratch.argtypes = [ctypes.c_int64]
    scratch.restype = ctypes.c_int64
    return launch, scratch


def _binned_counts_cuda(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> torch.Tensor:
    """Launch ``csrc/binned_curve.cu`` on ``torch.cuda.current_stream()``.

    Takes ``preds`` float32, ``target`` int32 and ``valid`` bool, all ``(N,)``,
    ``thr_sorted`` float32 ``(T,)`` ascending and its int64 permutation
    ``order`` (:func:`sort_thresholds`), all contiguous on one CUDA device;
    raises on anything else. Returns a fresh int64 ``(T, 2, 2)``."""
    global launches
    if preds.dtype != torch.float32 or target.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(
            "binned_curve kernel takes float32 preds, int32 target and bool valid,"
            f" got {preds.dtype}, {target.dtype} and {valid.dtype}"
        )
    if thr_sorted.dtype != torch.float32 or order.dtype != torch.int64:
        raise TypeError(
            f"binned_curve kernel takes float32 sorted thresholds and an int64 order, got {thr_sorted.dtype}"
            f" and {order.dtype}"
        )
    n = preds.shape[0] if preds.ndim == 1 else -1
    len_t = thr_sorted.shape[0] if thr_sorted.ndim == 1 else -1
    if n < 0 or tuple(target.shape) != (n,) or tuple(valid.shape) != (n,) or tuple(order.shape) != (len_t,):
        raise ValueError(
            "binned_curve kernel takes preds, target and valid of one shape (N,) and sorted thresholds and"
            f" order of one shape (T,), got {tuple(preds.shape)}, {tuple(target.shape)}, {tuple(valid.shape)},"
            f" {tuple(thr_sorted.shape)} and {tuple(order.shape)}"
        )
    if not 1 <= len_t <= 1 << 30:
        raise ValueError(f"binned_curve kernel takes 1 <= T <= 2**30 thresholds, got {len_t}")
    tensors = (preds, target, valid, thr_sorted, order)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("binned_curve kernel takes contiguous preds, target, valid, sorted thresholds and order")
    if preds.device.type != "cuda" or any(t.device != preds.device for t in tensors):
        raise ValueError(
            "binned_curve kernel takes every tensor on one CUDA device, got"
            f" {[str(t.device) for t in tensors]}"
        )
    launch, scratch_len = _entry()
    # the bucket histogram (zeroed by the launch), then the suffix sums' tile sums
    scratch = torch.empty(scratch_len(len_t), dtype=torch.int64, device=preds.device)
    out = torch.empty((len_t, 2, 2), dtype=torch.int64, device=preds.device)
    with torch.cuda.device(preds.device):
        stream = native.current_stream(preds.device.index)
        err = launch(
            preds.data_ptr(), target.data_ptr(), valid.data_ptr(), thr_sorted.data_ptr(),
            order.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, len_t, stream,
        )
    if err != 0:
        raise RuntimeError(f"binned_curve kernel launch failed with CUDA error {err}")
    launches += 1
    return out


kernels.register_kernel(
    kernels.KernelSpec(
        name="binned_curve",
        reference=_binned_counts_reference,
        cuda=_binned_counts_cuda,
    )
)


def binned_curve_counts(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, sorted_thresholds: SortedThresholds
) -> torch.Tensor:
    """``(T, 2, 2)`` int64 threshold-binned confusion counts through the
    dispatch seam: ``[t, i, j]`` counts the valid samples with target ``i``
    whose ``pred >= thresholds[t]`` is ``j``, for the thresholds that
    ``sorted_thresholds = sort_thresholds(thresholds)`` sorted.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.ops.binned_curve import binned_curve_counts, sort_thresholds
        >>> counts = binned_curve_counts(torch.tensor([0.2, 0.8, 0.5]), torch.tensor([0, 1, 1]),
        ...                              torch.tensor([True, True, True]), sort_thresholds(torch.tensor([0.5, 0.0])))
        >>> counts.tolist()
        [[[1, 0], [0, 2]], [[0, 1], [0, 2]]]
    """
    thr_sorted, order = sorted_thresholds
    return kernels.dispatch(
        "binned_curve",
        preds.reshape(-1).to(torch.float32).contiguous(),
        target.reshape(-1).to(torch.int32).contiguous(),
        valid.reshape(-1).to(torch.bool).contiguous(),
        thr_sorted,
        order,
    )


def binned_curve_counts_classwise(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, sorted_thresholds: SortedThresholds
) -> torch.Tensor:
    """``(T, C, 2, 2)`` int64 per-column threshold-binned counts.

    Each of the C columns of ``preds (N, C)`` (one-vs-rest classes or labels)
    gets its own ``(T, 2, 2)`` block from one bucketing pass, one weightless
    count over ``2·(T+1)·C`` bins (the ``bincount`` kernel on the card) and a
    suffix sum. ``target`` is the 0/1 ``(N, C)`` one-hot or label matrix and
    ``valid`` a bool mask that broadcasts to it (``(N, 1)`` for a sample,
    ``(N, C)`` for a label): a positive sample's bin is shifted by
    ``(T+1)·C``, a masked one gets -1 and is dropped. The counts are int64,
    exact at any N (the JAX package sums 0/1 masks as float32 weights, exact
    while a bin holds fewer than 2**24 samples). ``sorted_thresholds`` is
    :func:`sort_thresholds` of the T thresholds.
    """
    n, c = preds.shape
    thr_sorted, order = sorted_thresholds
    len_t = thr_sorted.shape[0]
    bins = (len_t + 1) * c
    k = _buckets(preds.reshape(-1), thr_sorted).reshape(n, c)
    col = torch.arange(c, device=preds.device)
    idx = k * c + col + bins * target.to(k.dtype)  # bucket-major, so the (T+1, C) reshape is direct
    idx = torch.where(valid.to(torch.bool), idx, -1)
    hist = kernels.dispatch("bincount", idx.reshape(-1).to(torch.int32), None, 2 * bins)[0]
    return _suffix_counts(hist.reshape(2, len_t + 1, c), order)
