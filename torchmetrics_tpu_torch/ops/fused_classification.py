"""Shared confusion counts: one counting pass for a whole classification collection.

An accuracy + F1 + precision + recall + confusion-matrix collection shares ONE
counting core: every state any of them accumulates is a slice of the task's
confusion counts. Each builder here computes those counts once per distinct
``(preds, target, task-config)`` through the ``"bincount"`` kernel, and
:func:`~torchmetrics_tpu_torch.ops.kernels.shared_result` hands the same
result to every compute-group leader inside one collection call: one kernel
launch per update.

Exactness: counts are 0/1-weighted float32 sums, exact integers up to 2**24
events per update. Within that bound the fused path is bit-exact against the
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


def _counts(idx: torch.Tensor, w: torch.Tensor, length: int) -> torch.Tensor:
    """One pass of ``bincount`` over in-range int32 indices with float weights."""
    return kernels.dispatch("bincount", idx.contiguous(), w[None, :].contiguous(), length)[0]


def _weights_and_target(t: torch.Tensor, ignore_index: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask ``ignore_index`` by weight and zero the masked targets."""
    if ignore_index is None:
        return torch.ones(t.shape, dtype=torch.float32, device=t.device), t
    valid = t != ignore_index
    return valid.to(torch.float32), torch.where(valid, t, torch.zeros_like(t))


# ----------------------------------------------------------------- multiclass

def multiclass_confusion_counts(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int]
) -> torch.Tensor:
    """(C, C) float32 confusion counts, shared across every multiclass metric
    updated against the same ``(preds, target)``: score preds argmax over dim
    1, everything flattened, ``ignore_index`` masked by weight, masked targets
    zeroed, preds clipped into range."""
    spec = ("mc", int(num_classes), ignore_index)

    def build() -> torch.Tensor:
        p = preds.argmax(dim=1) if preds.ndim == target.ndim + 1 else preds
        w, t = _weights_and_target(target.reshape(-1), ignore_index)
        p = torch.clamp(p.reshape(-1).to(torch.int32), 0, num_classes - 1)
        idx = num_classes * t.to(torch.int32) + p
        return _counts(idx, w, num_classes * num_classes).reshape(num_classes, num_classes)

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
    """(2, 2) float32 confusion counts shared across the binary family."""
    from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits

    spec = ("bin", float(threshold), ignore_index)

    def build() -> torch.Tensor:
        p = preds.reshape(-1)
        if p.is_floating_point():
            p = (_sigmoid_if_logits(p) > threshold).to(torch.int32)
        else:
            p = torch.clamp(p.to(torch.int32), 0, 1)
        w, t = _weights_and_target(target.reshape(-1), ignore_index)
        idx = t.to(torch.int32) * 2 + p
        return _counts(idx, w, 4).reshape(2, 2)

    return kernels.shared_result((preds, target), spec, build)


def binary_stats(confmat: torch.Tensor) -> Stats:
    """Scalar (tp, fp, tn, fn) int32 from the (2, 2) counts."""
    return tuple(confmat[i, j].to(torch.int32) for i, j in ((1, 1), (0, 1), (0, 0), (1, 0)))  # type: ignore[return-value]


# ----------------------------------------------------------------- multilabel

def multilabel_confusion_counts(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, threshold: float, ignore_index: Optional[int]
) -> torch.Tensor:
    """(L, 2, 2) float32 per-label confusion counts shared across the
    multilabel family."""
    from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits

    spec = ("ml", int(num_labels), float(threshold), ignore_index)

    def build() -> torch.Tensor:
        p = preds
        if p.is_floating_point():
            p = (_sigmoid_if_logits(p) > threshold).to(torch.int32)
        p = torch.movedim(p, 1, -1).reshape(-1, num_labels)
        w, t = _weights_and_target(torch.movedim(target, 1, -1).reshape(-1, num_labels), ignore_index)
        if ignore_index is not None:
            p = torch.where(w > 0, p, torch.zeros_like(p))
        p = torch.clamp(p.to(torch.int32), 0, 1)
        label_idx = torch.arange(num_labels, dtype=torch.int32, device=p.device)[None, :]
        idx = label_idx * 4 + t.to(torch.int32) * 2 + p
        return _counts(idx.reshape(-1), w.reshape(-1), num_labels * 4).reshape(num_labels, 2, 2)

    return kernels.shared_result((preds, target), spec, build)


def multilabel_stats(confmat: torch.Tensor) -> Stats:
    """Per-label (tp, fp, tn, fn) int32 from the (L, 2, 2) counts."""
    return tuple(confmat[:, i, j].to(torch.int32) for i, j in ((1, 1), (0, 1), (0, 0), (1, 0)))  # type: ignore[return-value]
