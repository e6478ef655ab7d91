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


def multilabel_stats(confmat: torch.Tensor) -> Stats:
    """Per-label (tp, fp, tn, fn) int32 from the (L, 2, 2) counts."""
    return tuple(confmat[:, i, j].to(torch.int32) for i, j in ((1, 1), (0, 1), (0, 0), (1, 0)))  # type: ignore[return-value]
