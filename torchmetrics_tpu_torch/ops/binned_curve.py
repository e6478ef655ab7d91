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

Both take the target as the metric holds it (int64, int32 or uint8) with a
bool mask or an ``ignore_index``, and both count in int64, so they are exact
at any N. The kernel's wrapper is on the lean launch path of
``ops/native.py``. The per-column form
:func:`binned_curve_counts_classwise` (multiclass one-vs-rest and multilabel
curves) has no kernel of its own: its histogram is one K = 2 call of the
``bincount`` kernel, one weightless launch.
"""
from __future__ import annotations

import ctypes
import functools
import sys
from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import kernels, launch_counts, native

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
    preds: torch.Tensor,
    target: torch.Tensor,
    valid: Optional[torch.Tensor],
    thr_sorted: torch.Tensor,
    order: torch.Tensor,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``(T, 2, 2)`` int64 counts ``[t, target, pred]``
    in the caller's threshold order, where ``thresholds[order[k]] = thr_sorted[k]``.

    The samples counted are those of the bool mask ``valid``, or with
    ``valid=None`` those whose target is not ``ignore_index`` (compared as
    torch compares, the index cast to the target's type), or every sample
    when both are None. The port of the JAX package's
    ``_binned_counts_searchsorted``, with its sample weights (``target *
    valid`` positive, ``(1 - target) * valid`` negative; the target taken as
    int32, as the kernel takes it), counted in int64 rather than float32 so
    that it is exact at any N."""
    if valid is None:
        valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    elif ignore_index is not None:
        raise ValueError("binned_curve takes a valid mask or an ignore_index, not both")
    k = _buckets(preds, thr_sorted)
    t = target.to(torch.int32).to(torch.int64)
    v = valid.to(torch.int64)
    w = torch.stack([(1 - t) * v, t * v])  # (2, N)
    hist = torch.zeros((2, thr_sorted.shape[0] + 1), dtype=torch.int64, device=preds.device)
    hist.index_add_(1, k, w)
    return _suffix_counts(hist[:, :, None], order)[:, 0]


#: the kernel's code of each target dtype it reads (the low two bits of its
#: ``form`` argument); the validity mode is the next two
_TARGET_CODES = {torch.int32: 0, torch.int64: 1, torch.uint8: 2}
_MASK_FORM, _IGNORE_FORM = 1 << 2, 2 << 2
#: what tm_binned_curve returns, having launched nothing, when the stream's
#: buffers are too small for the call
_NEED_SCRATCH = -1
#: the tickets and histograms the kernel keeps from call to call, per stream
_scratch = native.StreamScratch()


@functools.lru_cache(maxsize=None)
def _entry() -> Tuple[ctypes._CFuncPtr, ctypes._CFuncPtr]:
    """The kernel's C entry points, built and typed once: the launch, and the
    query of the per-stream buffer sizes a call needs."""
    lib = native.load("binned_curve")
    launch, scratch = lib.tm_binned_curve, lib.tm_binned_curve_scratch
    launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 3
        + [ctypes.c_int64, ctypes.c_void_p] + [ctypes.c_int64, ctypes.c_void_p] + [ctypes.c_int64] * 2
        + [ctypes.c_void_p]
    )
    launch.restype = ctypes.c_int
    scratch.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_int64] * 2 + [ctypes.POINTER(ctypes.c_int64)]
    scratch.restype = ctypes.c_int
    return launch, scratch


def _refuse(preds, target, valid, thr_sorted, order, ignore_index) -> None:
    """Raise the error that says why :func:`_binned_counts_cuda` cannot take
    these arguments (its one combined test failed)."""
    if preds.dtype != torch.float32 or target.dtype not in _TARGET_CODES or (
        valid is not None and valid.dtype != torch.bool
    ):
        raise TypeError(
            "binned_curve kernel takes float32 preds, int32, int64 or uint8 target and a bool valid mask (or"
            f" None), got {preds.dtype}, {target.dtype} and {None if valid is None else valid.dtype}"
        )
    if thr_sorted.dtype != torch.float32 or order.dtype != torch.int64:
        raise TypeError(
            f"binned_curve kernel takes float32 sorted thresholds and an int64 order, got {thr_sorted.dtype}"
            f" and {order.dtype}"
        )
    if valid is not None and ignore_index is not None:
        raise ValueError("binned_curve kernel takes a valid mask or an ignore_index, not both")
    n = preds.shape[0] if preds.ndim == 1 else -1
    len_t = thr_sorted.shape[0] if thr_sorted.ndim == 1 else -1
    mask_shape = (n,) if valid is None else tuple(valid.shape)
    if n < 0 or tuple(target.shape) != (n,) or mask_shape != (n,) or tuple(order.shape) != (len_t,):
        raise ValueError(
            "binned_curve kernel takes preds, target and valid of one shape (N,) and sorted thresholds and"
            f" order of one shape (T,), got {tuple(preds.shape)}, {tuple(target.shape)},"
            f" {None if valid is None else tuple(valid.shape)}, {tuple(thr_sorted.shape)} and {tuple(order.shape)}"
        )
    if not 1 <= len_t <= 1 << 30:
        raise ValueError(f"binned_curve kernel takes 1 <= T <= 2**30 thresholds, got {len_t}")
    tensors = [t for t in (preds, target, valid, thr_sorted, order) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("binned_curve kernel takes contiguous preds, target, valid, sorted thresholds and order")
    raise ValueError(
        f"binned_curve kernel takes every tensor on one CUDA device, got {[str(t.device) for t in tensors]}"
    )


def _fits(preds, target, valid, thr_sorted, order, ignore_index, device: int) -> bool:
    """The wrapper's one combined test: whether the kernel takes these
    arguments with every tensor on ``device`` (a ``get_device()`` index)."""
    return (
        preds.dtype is torch.float32 and target.dtype in _TARGET_CODES and preds.dim() == 1
        and thr_sorted.dtype is torch.float32 and order.dtype is torch.int64 and thr_sorted.dim() == 1
        and target.shape == preds.shape and order.shape == thr_sorted.shape
        and 1 <= thr_sorted.shape[0] <= 1 << 30
        and preds.is_contiguous() and target.is_contiguous() and thr_sorted.is_contiguous() and order.is_contiguous()
        and target.get_device() == device and thr_sorted.get_device() == device and order.get_device() == device
        and (
            valid is None or (
                ignore_index is None and valid.dtype is torch.bool and valid.shape == preds.shape
                and valid.is_contiguous() and valid.get_device() == device
            )
        )
    )


def _binned_counts_cuda(
    preds: torch.Tensor,
    target: torch.Tensor,
    valid: Optional[torch.Tensor],
    thr_sorted: torch.Tensor,
    order: torch.Tensor,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``csrc/binned_curve.cu`` on ``torch.cuda.current_stream()``.

    Takes ``preds`` float32 ``(N,)``; ``target`` int32, int64 or uint8
    ``(N,)``; either a bool ``valid`` ``(N,)`` or an ``ignore_index`` (or
    neither: every sample counts); ``thr_sorted`` float32 ``(T,)`` ascending
    and its int64 permutation ``order`` (:func:`sort_thresholds`), all
    contiguous on one CUDA device; raises on anything else. Returns a fresh
    int64 ``(T, 2, 2)``: one kernel launch for T < 4,096, four above.

    The lean launch path: one combined test of the arguments (the detailed
    errors come from :func:`_refuse` only when it fails), the device guard in
    the C entry, the output the only allocation (the tickets and histograms
    the kernel reuses live per stream in :data:`_scratch`). A launch
    recorded into a CUDA graph takes buffers of its own from the graph's
    pool instead, zeroed by the graph at every replay."""
    device = preds.get_device()
    if device < 0 or not _fits(preds, target, valid, thr_sorted, order, ignore_index, device):
        _refuse(preds, target, valid, thr_sorted, order, ignore_index)
    code = _TARGET_CODES[target.dtype]
    if valid is not None:
        form, valid_ptr, ignore = code | _MASK_FORM, valid.data_ptr(), 0
    elif ignore_index is not None:
        form, valid_ptr, ignore = code | _IGNORE_FORM, None, ignore_index
    else:
        form, valid_ptr, ignore = code, None, 0
    n, len_t = preds.shape[0], thr_sorted.shape[0]
    launch, query = _entry()
    stream = native.current_stream(device)
    out = torch.empty((len_t, 2, 2), dtype=torch.int64, device=device)
    args = [
        device, preds.data_ptr(), target.data_ptr(), valid_ptr, form, ignore, thr_sorted.data_ptr(),
        order.data_ptr(), None, 0, None, 0, out.data_ptr(), n, len_t, stream,
    ]
    kept = not torch.cuda.is_current_stream_capturing()
    buffers = _scratch.get(device, stream) if kept else None
    err = _NEED_SCRATCH
    if buffers is not None:
        args[8:12] = buffers[2:]
        err = launch(*args)
    if err == _NEED_SCRATCH:
        sizes = (ctypes.c_int64 * 2)()
        err = query(device, code, n, len_t, sizes)
        if err == 0:
            buffers = _scratch.grow(device, stream, sizes[0], sizes[1], keep=kept)
            args[8:12] = buffers[2:]
            err = launch(*args)
    if err != 0:
        if kept:
            _scratch.drop(device, stream)
        raise RuntimeError(f"binned_curve kernel launch failed with CUDA error {err}")
    launch_counts.add(sys.modules[__name__], "launches", 1)
    return out


kernels.register_kernel(
    kernels.KernelSpec(
        name="binned_curve",
        reference=_binned_counts_reference,
        cuda=_binned_counts_cuda,
    )
)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous 1-D tensor, with no op where it already is one."""
    if x.dim() != 1:
        x = x.reshape(-1)
    return x if x.is_contiguous() else x.contiguous()


def binned_curve_counts(
    preds: torch.Tensor,
    target: torch.Tensor,
    valid: Optional[torch.Tensor],
    sorted_thresholds: SortedThresholds,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """``(T, 2, 2)`` int64 threshold-binned confusion counts through the
    dispatch seam: ``[t, i, j]`` counts the valid samples with target ``i``
    whose ``pred >= thresholds[t]`` is ``j``, for the thresholds that
    ``sorted_thresholds = sort_thresholds(thresholds)`` sorted.

    The valid samples are those of the bool mask ``valid``, or with
    ``valid=None`` those whose target is not ``ignore_index`` (every sample
    when it is None too). The target goes to the kernel as the caller holds
    it when it is int64, int32 or uint8 (a bool one as uint8, others as
    int32): the binned metric update passes its batch's target and
    ``ignore_index`` straight through.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.ops.binned_curve import binned_curve_counts, sort_thresholds
        >>> counts = binned_curve_counts(torch.tensor([0.2, 0.8, 0.5]), torch.tensor([0, 1, 1]),
        ...                              torch.tensor([True, True, True]), sort_thresholds(torch.tensor([0.5, 0.0])))
        >>> counts.tolist()
        [[[1, 0], [0, 2]], [[0, 1], [0, 2]]]
        >>> binned_curve_counts(torch.tensor([0.2, 0.8, 0.5]), torch.tensor([0, 1, -1]), None,
        ...                     sort_thresholds(torch.tensor([0.5])), ignore_index=-1).tolist()
        [[[1, 0], [0, 1]]]
    """
    thr_sorted, order = sorted_thresholds
    preds = _flat(preds)
    if preds.dtype is not torch.float32:
        preds = preds.to(torch.float32)
    target = _flat(target)
    if target.dtype not in _TARGET_CODES:
        target = target.view(torch.uint8) if target.dtype is torch.bool else target.to(torch.int32)
    if valid is not None:
        valid = _flat(valid)
        if valid.dtype is not torch.bool:
            valid = valid.to(torch.bool)
    return kernels.dispatch(
        "binned_curve", preds, target, valid, thr_sorted, order, None if ignore_index is None else int(ignore_index)
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
