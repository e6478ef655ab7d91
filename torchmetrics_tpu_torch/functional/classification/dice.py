"""Dice score with the legacy averaging options (``average``, ``mdmc_average``).

Behaviour held to the JAX package:

- integer label inputs (binary included) score as C-class one-hot stats,
  binary probabilities (float preds shaped like the target) as one column;
- ``ignore_index`` removes that class column after the count, and must lie
  in [0, C); only on the binary-probability path does it drop samples;
- a pred or target outside [0, C) still counts: an out-of-range target
  adds its sample's pred to fp, an out-of-range pred adds its target to fn;
- macro averaging leaves out classes absent from both preds and target;
  ``mdmc_average="global"`` flattens extra dims, ``"samplewise"`` (and
  ``average="samples"``) scores each sample and then averages, a Python
  loop over the samples as in the JAX package.

On the label path (integer preds, or float preds with a class dimension and
``top_k`` in {None, 1}) tp/fp/fn come from one weightless count of
``(C+1)·t' + p'`` over ``(C+1)²`` bins, where ``t'`` and ``p'`` are the
labels with every value outside [0, C) mapped to C (the ``bincount`` kernel
on the card): tp is the diagonal's first C entries, fp the column sums less
tp, fn the row sums less tp. The JAX package builds N x C one-hot matrices
instead, 640 MB of int32 at Cityscapes' 8.4M pixels and 19 classes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits
from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _safe_divide

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_AVERAGES = ("micro", "macro", "weighted", "samples", "none", None)


def _check_dice_average(average: Optional[str]) -> None:
    if average not in _AVERAGES:
        raise ValueError(f"The `average` has to be one of {_AVERAGES}, got {average}.")


def _in_range_or(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """int32 labels with every value outside [0, C) mapped to C."""
    inside = (x >= 0) & (x < num_classes)
    return torch.where(inside, x, torch.full_like(x, num_classes)).to(torch.int32)


def _dice_label_counts(preds: torch.Tensor, target: torch.Tensor, num_classes: int) -> Counts:
    """Per-class int32 (tp, fp, fn) of label vectors from one weightless
    ``bincount`` over ``(C+1)²`` bins (see the module docstring)."""
    c = num_classes
    idx = (c + 1) * _in_range_or(target, c) + _in_range_or(preds, c)
    cm = weighted_bincount(idx, None, (c + 1) * (c + 1)).reshape(c + 1, c + 1)  # [target, pred]
    tp = torch.diagonal(cm)[:c]
    return tp, cm.sum(0, dtype=torch.int32)[:c] - tp, cm.sum(1, dtype=torch.int32)[:c] - tp


def _dice_topk_counts(preds: torch.Tensor, target: torch.Tensor, num_classes: int, top_k: int) -> Counts:
    """Per-class int32 (tp, fp, fn) of (N, C) scores whose ``top_k`` largest
    (ties to the lower class, a stable sort of the negated scores) are
    predicted: JAX's multi-hot formulation in plain torch."""
    order = torch.argsort(-preds, dim=1, stable=True)[:, :top_k]
    ph = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device).scatter_(1, order, 1)
    th = (target[:, None] == torch.arange(num_classes, device=target.device)).to(torch.int32)
    return (
        (ph * th).sum(0, dtype=torch.int32),
        (ph * (1 - th)).sum(0, dtype=torch.int32),
        ((1 - ph) * th).sum(0, dtype=torch.int32),
    )


def _dice_binary_counts(
    preds: torch.Tensor, target: torch.Tensor, threshold: float, ignore_index: Optional[int]
) -> Counts:
    """(1,) int32 (tp, fp, fn) of binary probabilities (or logits), the
    samples whose target is ``ignore_index`` left out."""
    p = (_sigmoid_if_logits(preds) > threshold).to(torch.int32).reshape(-1)
    t = target.reshape(-1)
    w = torch.ones_like(t) if ignore_index is None else (t != ignore_index).to(torch.int32)
    return (
        (p * t * w).sum(dtype=torch.int32)[None],
        (p * (1 - t) * w).sum(dtype=torch.int32)[None],
        ((1 - p) * t * w).sum(dtype=torch.int32)[None],
    )


def _dice_stats(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    ignore_index: Optional[int],
) -> Counts:
    """Per-class int32 (tp, fp, fn) of shape (C,), less the ignored class,
    or (1,) for binary-probability input. ``num_classes=None`` takes C from
    the class dimension of float preds, else from the largest label (a host
    read)."""
    target = target.to(torch.int32)
    is_float = preds.is_floating_point()
    if is_float and preds.ndim == target.ndim:
        return _dice_binary_counts(preds, target, threshold, ignore_index)
    if is_float and preds.ndim != target.ndim + 1:
        raise ValueError("float preds must have one extra class dimension for multiclass dice")
    if preds.dtype == torch.bool:
        preds = preds.to(torch.int32)
    if num_classes is None:
        num_classes = preds.shape[1] if is_float else int(torch.maximum(preds.max(), target.max())) + 1
    if is_float:
        # classes last, flattened: (N, C, ...) scores become (N·..., C)
        scores = preds.movedim(1, -1).reshape(-1, num_classes)
        if top_k is not None and top_k > 1:
            tp, fp, fn = _dice_topk_counts(scores, target.reshape(-1), num_classes, top_k)
        else:
            tp, fp, fn = _dice_label_counts(scores.argmax(dim=1), target.reshape(-1), num_classes)
    else:
        tp, fp, fn = _dice_label_counts(preds.reshape(-1), target.reshape(-1), num_classes)
    if ignore_index is not None:
        if not 0 <= ignore_index < num_classes:
            raise ValueError(f"ignore_index {ignore_index} is not in [0, {num_classes})")
        keep = torch.arange(num_classes, device=tp.device) != ignore_index
        tp, fp, fn = tp[keep], fp[keep], fn[keep]
    return tp, fp, fn


def _dice_reduce(
    tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor, average: Optional[str], zero_division: float
) -> torch.Tensor:
    zero_division = float(zero_division)
    if average == "micro":
        tps = tp.sum()
        denom = 2 * tps + fp.sum() + fn.sum()
        return torch.where(denom == 0, zero_division, 2 * tps / torch.where(denom == 0, 1, denom))
    denom = 2 * tp + fp + fn
    scores = torch.where(denom == 0, zero_division, 2 * tp / torch.where(denom == 0, 1, denom))
    if average in (None, "none"):
        return scores
    meaningful = (tp + fp + fn) > 0
    if average == "macro":
        return _safe_divide(torch.where(meaningful, scores, 0.0).sum(), meaningful.sum())
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
        return _safe_divide((weights * scores).sum(), weights.sum())
    raise ValueError(f"Unsupported average {average}")


def _samplewise_dice(
    preds: torch.Tensor,
    target: torch.Tensor,
    zero_division: float,
    average: Optional[str],
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    ignore_index: Optional[int],
) -> torch.Tensor:
    """(N, ...) per-sample scores, each sample reduced on its own (``micro``
    under ``average="samples"``). Float (N, C) preds give each sample's
    score row with its target of one element, which scores as binary
    probabilities, as in the JAX package."""
    if preds.is_floating_point() and preds.ndim == target.ndim + 1 and preds.ndim > 2:
        raise NotImplementedError("samplewise dice with probabilistic multidim preds is not supported")
    inner = "micro" if average == "samples" else average
    vals = [
        _dice_reduce(
            *_dice_stats(
                preds[i] if preds[i].ndim else preds[i : i + 1],
                target[i].reshape(-1),
                threshold,
                top_k,
                num_classes,
                ignore_index,
            ),
            inner,
            zero_division,
        )
        for i in range(preds.shape[0])
    ]
    return torch.stack(vals)


def dice(
    preds: torch.Tensor,
    target: torch.Tensor,
    zero_division: float = 0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Dice = 2·TP / (2·TP + FP + FN) with the legacy averaging options.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import dice
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> round(float(dice(preds, torch.tensor([0, 1, 2, 0]))), 4)
        0.75
    """
    _check_dice_average(average)
    is_float = preds.is_floating_point()
    class_dim = is_float and preds.ndim == target.ndim + 1
    extra_dims = preds.ndim > 1 + (1 if class_dim else 0)
    if (extra_dims and mdmc_average == "samplewise") or average == "samples":
        vals = _samplewise_dice(preds, target, zero_division, average, threshold, top_k, num_classes, ignore_index)
        return vals.mean(0)
    if extra_dims:  # mdmc global: flatten the extra dims
        if class_dim:
            preds = preds.movedim(1, -1).reshape(-1, preds.shape[1])
        else:
            preds = preds.reshape(-1)
        target = target.reshape(-1)
    _check_same_shape(target if class_dim else preds, target)
    tp, fp, fn = _dice_stats(preds, target, threshold, top_k, num_classes, ignore_index)
    return _dice_reduce(tp, fp, fn, average, zero_division)
