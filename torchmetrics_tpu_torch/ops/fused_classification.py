"""Shared confusion counts: one counting pass for a whole classification collection.

An accuracy + F1 + precision + recall + confusion-matrix collection shares ONE
counting core: every state any of them accumulates is a slice of the task's
confusion counts. Each builder here computes those counts once per distinct
``(preds, target, task-config)`` through the ``"bincount"`` kernel, and
:func:`~torchmetrics_tpu_torch.ops.kernels.shared_result` hands the same
result to every compute-group leader inside one collection call: one kernel
launch per update.

Masking: ``ignore_index`` is folded into the index (a masked sample gets
index -1, which the kernel drops), so the count is weightless: no 0/1 weight
row is built, written or read.

Exactness: counts are int64, exact at any number of events per update (the
JAX package's float32 sums of ones stop at 2**24), and bit-exact against the
per-metric path; ``TORCHMETRICS_TPU_TORCH_FUSED_CLASSIFICATION=0`` restores the
per-metric passes (the exactness oracle in the tests).

Row-batched forms (``*_rows``): the session lanes (``lanes.py``) advance R
independent states at once, each with its own batch, where the JAX package
runs ``jax.vmap`` over the count. The port writes that batch axis out: preds
and target carry a leading row axis, row r's bin b is folded to
``r * L + b`` (an index outside ``[0, L)`` is dropped, as the per-row count
drops it), and ONE weightless ``bincount`` launch over ``R * L`` bins, read
as ``(R, L)``, counts every row. The folded index is int32, so the rows are
cut into chunks of at most ``ROW_BINS_LIMIT // L`` rows, one launch each.
Row r of the result is bit-equal to the per-row count of row r.

Large class counts: the C x C count's flat index ``C * t + p`` is int32 and
its output C^2 int64 bins. Past ``ROW_BINS_LIMIT`` bins (C > 46,340) the
index would wrap and the output would not fit (52.9 GB at 81,313
classes), so multiclass stat scores take their per-class counts from ONE
weightless launch over 3C bins instead (:func:`multiclass_class_stats`):
hits at ``t``, valid predictions at ``C + p``, valid targets at ``2C + t``;
tn follows from the number of valid samples. Bit-equal to the C x C
derivation wherever both fit.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import kernels

#: switch for the fused classification family (default on)
FUSED_ENV = "TORCHMETRICS_TPU_TORCH_FUSED_CLASSIFICATION"

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_enabled() -> bool:
    return os.environ.get(FUSED_ENV, "1").strip().lower() not in ("0", "false", "off")


def _counts(idx: torch.Tensor, length: int) -> torch.Tensor:
    """One weightless pass of ``bincount`` over int32 indices: int64 counts;
    negative indices (masked samples) are dropped."""
    return kernels.dispatch("bincount", idx.reshape(-1).contiguous(), None, length)[0]


#: the most bins one row-batched launch counts: the folded index is int32
ROW_BINS_LIMIT = 2**31 - 1


def _row_counts(idx: torch.Tensor, length: int) -> torch.Tensor:
    """Weightless counts of every row of int32 ``idx (R, N)`` at once:
    ``(R, length)`` int64, one ``bincount`` launch per chunk of rows.
    Indices outside ``[0, length)`` are dropped, so no row spills into its
    neighbour's bins."""
    rows = idx.shape[0]
    if rows == 0:
        return torch.zeros((0, int(length)), dtype=torch.int64, device=idx.device)
    per_chunk = max(1, ROW_BINS_LIMIT // int(length))
    out = []
    for start in range(0, rows, per_chunk):
        chunk = idx[start:start + per_chunk]
        r = chunk.shape[0]
        offsets = (torch.arange(r, dtype=torch.int32, device=idx.device) * int(length))[:, None]
        in_row = (chunk >= 0) & (chunk < length)
        folded = torch.where(in_row, chunk + offsets, torch.full_like(chunk, -1))
        out.append(_counts(folded, r * int(length)).reshape(r, int(length)))
    return out[0] if len(out) == 1 else torch.cat(out)


def _sigmoid_if_logits_rows(preds: torch.Tensor) -> torch.Tensor:
    """``_sigmoid_if_logits`` decided row by row, as ``vmap`` decides it:
    a row gets the sigmoid iff one of ITS values lies outside [0, 1]."""
    rows = preds.shape[0]
    needs = ((preds < 0) | (preds > 1)).reshape(rows, -1).any(dim=1)
    return torch.where(needs.reshape((rows,) + (1,) * (preds.ndim - 1)), torch.sigmoid(preds), preds)


def _mask_ignored(idx: torch.Tensor, t: torch.Tensor, ignore_index: Optional[int]) -> torch.Tensor:
    """``idx`` with -1 where the target ``t`` is ``ignore_index``."""
    if ignore_index is None:
        return idx
    return torch.where(t != ignore_index, idx, torch.full_like(idx, -1))


# ----------------------------------------------------------------- multiclass

def multiclass_confusion_counts(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int]
) -> torch.Tensor:
    """(C, C) int64 confusion counts, shared across every multiclass metric
    updated against the same ``(preds, target)``: score preds argmax over dim
    1, everything flattened, preds clipped into range, ``ignore_index``
    folded into the index."""
    spec = ("mc", int(num_classes), ignore_index)

    def build() -> torch.Tensor:
        p = preds.argmax(dim=1) if preds.ndim == target.ndim + 1 else preds
        t = target.reshape(-1)
        p = torch.clamp(p.reshape(-1).to(torch.int32), 0, num_classes - 1)
        idx = _mask_ignored(num_classes * t.to(torch.int32) + p, t, ignore_index)
        return _counts(idx, num_classes * num_classes).reshape(num_classes, num_classes)

    return kernels.shared_result((preds, target), spec, build)


def multiclass_confusion_counts_rows(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int]
) -> torch.Tensor:
    """(R, C, C) int64 confusion counts of R independent batches (row axis
    first), shared like :func:`multiclass_confusion_counts`: one launch per
    row chunk for every multiclass metric counting the same rows."""
    spec = ("mc_rows", int(num_classes), ignore_index)

    def build() -> torch.Tensor:
        rows = target.shape[0]
        p = preds.argmax(dim=2) if preds.ndim == target.ndim + 1 else preds
        t = target.reshape(rows, -1)
        p = torch.clamp(p.reshape(rows, -1).to(torch.int32), 0, num_classes - 1)
        idx = _mask_ignored(num_classes * t.to(torch.int32) + p, t, ignore_index)
        return _row_counts(idx, num_classes * num_classes).reshape(rows, num_classes, num_classes)

    return kernels.shared_result((preds, target), spec, build)


def multiclass_class_stats(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int]
) -> Stats:
    """Per-class (tp, fp, tn, fn) int32 from one weightless ``bincount`` over
    3C bins, shared like :func:`multiclass_confusion_counts` (every
    stat-scores metric updated against the same ``(preds, target)`` reads
    one launch). A sample counts when its target lies in ``[0, C)`` and is
    not ``ignore_index``; its prediction is clipped into range, as the
    C x C count clips it."""
    spec = ("mc_class", int(num_classes), ignore_index)
    c = int(num_classes)

    def build() -> torch.Tensor:
        p = preds.argmax(dim=1) if preds.ndim == target.ndim + 1 else preds
        t = target.reshape(-1)
        p = torch.clamp(p.reshape(-1).to(torch.int32), 0, c - 1)
        valid = (t >= 0) & (t < c)
        if ignore_index is not None:
            valid = valid & (t != ignore_index)
        t32 = torch.where(valid, t, torch.zeros_like(t)).to(torch.int32)
        drop = torch.full_like(p, -1)
        hits = torch.where(valid & (p == t32), t32, drop)
        pred_bins = torch.where(valid, p + c, drop)
        target_bins = torch.where(valid, t32 + 2 * c, drop)
        return _counts(torch.cat([hits, pred_bins, target_bins]), 3 * c)

    counts = kernels.shared_result((preds, target), spec, build)
    tp, predicted, actual = counts[:c], counts[c : 2 * c], counts[2 * c :]
    fp = predicted - tp
    fn = actual - tp
    tn = actual.sum() - tp - fp - fn
    return tuple(s.to(torch.int32) for s in (tp, fp, tn, fn))  # type: ignore[return-value]


def multiclass_stat_counts(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int]
) -> Stats:
    """Per-class (tp, fp, tn, fn) int32 in one ``bincount`` launch: from the
    shared C x C count while its C^2 bins fit ``ROW_BINS_LIMIT``, else from
    the 3C count of :func:`multiclass_class_stats`."""
    if int(num_classes) ** 2 > ROW_BINS_LIMIT:
        return multiclass_class_stats(preds, target, num_classes, ignore_index)
    return multiclass_stats(multiclass_confusion_counts(preds, target, num_classes, ignore_index))


def multiclass_stats(confmat: torch.Tensor) -> Stats:
    """Per-class (tp, fp, tn, fn) int32 from (C, C) counts."""
    tp = torch.diagonal(confmat)
    fp = confmat.sum(0) - tp
    fn = confmat.sum(1) - tp
    tn = confmat.sum() - tp - fp - fn
    return tuple(s.to(torch.int32) for s in (tp, fp, tn, fn))  # type: ignore[return-value]


# --------------------------------------------------------------------- binary

def binary_confusion_counts(
    preds: torch.Tensor, target: torch.Tensor, threshold: float, ignore_index: Optional[int]
) -> torch.Tensor:
    """(2, 2) int64 confusion counts shared across the binary family."""
    from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits

    spec = ("bin", float(threshold), ignore_index)

    def build() -> torch.Tensor:
        p = preds.reshape(-1)
        if p.is_floating_point():
            p = (_sigmoid_if_logits(p) > threshold).to(torch.int32)
        else:
            p = torch.clamp(p.to(torch.int32), 0, 1)
        t = target.reshape(-1)
        idx = _mask_ignored(t.to(torch.int32) * 2 + p, t, ignore_index)
        return _counts(idx, 4).reshape(2, 2)

    return kernels.shared_result((preds, target), spec, build)


def binary_confusion_counts_rows(
    preds: torch.Tensor, target: torch.Tensor, threshold: float, ignore_index: Optional[int]
) -> torch.Tensor:
    """(R, 2, 2) int64 confusion counts of R independent binary batches."""
    spec = ("bin_rows", float(threshold), ignore_index)

    def build() -> torch.Tensor:
        rows = target.shape[0]
        p = preds.reshape(rows, -1)
        if p.is_floating_point():
            p = (_sigmoid_if_logits_rows(p) > threshold).to(torch.int32)
        else:
            p = torch.clamp(p.to(torch.int32), 0, 1)
        t = target.reshape(rows, -1)
        idx = _mask_ignored(t.to(torch.int32) * 2 + p, t, ignore_index)
        return _row_counts(idx, 4).reshape(rows, 2, 2)

    return kernels.shared_result((preds, target), spec, build)


def binary_stats(confmat: torch.Tensor) -> Stats:
    """Scalar (tp, fp, tn, fn) int32 from the (2, 2) counts."""
    return tuple(confmat[i, j].to(torch.int32) for i, j in ((1, 1), (0, 1), (0, 0), (1, 0)))  # type: ignore[return-value]


# ----------------------------------------------------------------- multilabel

def multilabel_confusion_counts(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, threshold: float, ignore_index: Optional[int]
) -> torch.Tensor:
    """(L, 2, 2) int64 per-label confusion counts shared across the
    multilabel family."""
    from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits

    spec = ("ml", int(num_labels), float(threshold), ignore_index)

    def build() -> torch.Tensor:
        p = preds
        if p.is_floating_point():
            p = (_sigmoid_if_logits(p) > threshold).to(torch.int32)
        p = torch.clamp(torch.movedim(p, 1, -1).reshape(-1, num_labels).to(torch.int32), 0, 1)
        t = torch.movedim(target, 1, -1).reshape(-1, num_labels)
        label_idx = torch.arange(num_labels, dtype=torch.int32, device=p.device)[None, :]
        idx = _mask_ignored(label_idx * 4 + t.to(torch.int32) * 2 + p, t, ignore_index)
        return _counts(idx, num_labels * 4).reshape(num_labels, 2, 2)

    return kernels.shared_result((preds, target), spec, build)


def multilabel_confusion_counts_rows(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, threshold: float, ignore_index: Optional[int]
) -> torch.Tensor:
    """(R, L, 2, 2) int64 per-label confusion counts of R independent batches."""
    spec = ("ml_rows", int(num_labels), float(threshold), ignore_index)

    def build() -> torch.Tensor:
        rows = target.shape[0]
        p = preds
        if p.is_floating_point():
            p = (_sigmoid_if_logits_rows(p) > threshold).to(torch.int32)
        p = torch.clamp(torch.movedim(p, 2, -1).reshape(rows, -1, num_labels).to(torch.int32), 0, 1)
        t = torch.movedim(target, 2, -1).reshape(rows, -1, num_labels)
        label_idx = torch.arange(num_labels, dtype=torch.int32, device=p.device)[None, None, :]
        idx = _mask_ignored(label_idx * 4 + t.to(torch.int32) * 2 + p, t, ignore_index)
        return _row_counts(idx.reshape(rows, -1), num_labels * 4).reshape(rows, num_labels, 2, 2)

    return kernels.shared_result((preds, target), spec, build)


def multilabel_stats(confmat: torch.Tensor) -> Stats:
    """Per-label (tp, fp, tn, fn) int32 from the (L, 2, 2) counts."""
    return tuple(confmat[:, i, j].to(torch.int32) for i, j in ((1, 1), (0, 1), (0, 0), (1, 0)))  # type: ignore[return-value]


# ----------------------------------------------------------- row-batched stats

def multiclass_stats_rows(confmat: torch.Tensor) -> Stats:
    """Per-row, per-class (tp, fp, tn, fn) int32 from (R, C, C) counts, each
    row as :func:`multiclass_stats` computes it."""
    tp = torch.diagonal(confmat, dim1=1, dim2=2)
    fp = confmat.sum(1) - tp
    fn = confmat.sum(2) - tp
    tn = confmat.sum((1, 2))[:, None] - tp - fp - fn
    return tuple(s.to(torch.int32) for s in (tp, fp, tn, fn))  # type: ignore[return-value]


def binary_stats_rows(confmat: torch.Tensor) -> Stats:
    """Per-row (tp, fp, tn, fn) int32 from (R, 2, 2) counts."""
    return tuple(confmat[:, i, j].to(torch.int32) for i, j in ((1, 1), (0, 1), (0, 0), (1, 0)))  # type: ignore[return-value]


def multilabel_stats_rows(confmat: torch.Tensor) -> Stats:
    """Per-row, per-label (tp, fp, tn, fn) int32 from (R, L, 2, 2) counts."""
    return tuple(confmat[:, :, i, j].to(torch.int32) for i, j in ((1, 1), (0, 1), (0, 0), (1, 0)))  # type: ignore[return-value]
