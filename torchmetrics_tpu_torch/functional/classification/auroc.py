"""AUROC: the trapezoidal area under the ROC built from the curve state,
with the McClish-corrected partial area for ``max_fpr``."""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _keep_valid,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _task_count,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _trapz(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Trapezoid along the last axis."""
    dx = torch.diff(x, dim=-1)
    return ((y[..., :-1] + y[..., 1:]) / 2.0 * dx).sum(-1)


def _check_max_fpr(max_fpr: Optional[float]) -> None:
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")


def _binary_auroc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    thresholds: Optional[torch.Tensor],
    max_fpr: Optional[float] = None,
    pos_label: int = 1,
) -> torch.Tensor:
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    # degenerate single-class curves (fpr or tpr identically 0) skip the
    # McClish correction
    if max_fpr is None or max_fpr == 1 or float(fpr.sum()) == 0 or float(tpr.sum()) == 0:
        return _trapz(tpr, fpr)
    # McClish correction for the partial AUC, on the host in float64
    fpr_np, tpr_np = fpr.cpu().numpy(), tpr.cpu().numpy()
    stop = int(np.searchsorted(fpr_np, max_fpr, "right"))
    lo = max(stop - 1, 0)
    x_interp = np.interp(max_fpr, fpr_np[lo: stop + 1], tpr_np[lo: stop + 1]) if stop < fpr_np.size else tpr_np[-1]
    fpr_c = np.hstack([fpr_np[:stop], [max_fpr]])
    tpr_c = np.hstack([tpr_np[:stop], [x_interp]])
    partial_auc = float(np.sum(np.diff(fpr_c) * (tpr_c[:-1] + tpr_c[1:]) / 2.0))
    min_area = 0.5 * max_fpr**2
    max_area = max_fpr
    return torch.tensor(0.5 * (1 + (partial_auc - min_area) / (max_area - min_area)), dtype=torch.float32, device=fpr.device)


def binary_auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary AUROC (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_auroc
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> round(float(binary_auroc(preds, target)), 4)
        0.75
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
        _check_max_fpr(max_fpr)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds, ignore_index=ignore_index)
    if state is None:
        state = _keep_valid(preds, target, valid)
    return _binary_auroc_compute(state, thresholds, max_fpr)


def _reduce_auroc(
    fpr: Union[torch.Tensor, List[torch.Tensor]],
    tpr: Union[torch.Tensor, List[torch.Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-class trapezoids, then the average."""
    if isinstance(fpr, (list, tuple)):
        res = torch.stack([_trapz(t, f) for f, t in zip(fpr, tpr)])
    else:
        res = _trapz(tpr, fpr)
    return _average_scores(res, average, weights)


def _average_scores(res: torch.Tensor, average: Optional[str], weights: Optional[torch.Tensor]) -> torch.Tensor:
    if average in (None, "none"):
        return res
    if average == "macro":
        return res.mean()
    if average == "weighted":
        if weights is None:
            raise ValueError("`average='weighted'` needs per-class weights")
        w = _safe_divide(weights.to(torch.float32), weights.sum())
        return (res * w).sum()
    raise ValueError(f"Expected argument `average` to be one of ('macro', 'weighted', 'none', None) but got {average}")


def _class_weights(target: torch.Tensor, valid: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class float32 counts of the valid targets (the ``weighted``
    average); targets outside ``[0, num_classes)`` count nowhere. A scatter,
    so nothing reads back to the host."""
    keep = valid & (target >= 0) & (target < num_classes)
    idx = torch.where(keep, target, torch.zeros_like(target)).to(torch.int64)
    counts = torch.zeros(num_classes, dtype=torch.float32, device=target.device)
    return counts.index_add_(0, idx, keep.to(torch.float32))


def multiclass_auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass one-vs-rest AUROC (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_auroc
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> round(float(multiclass_auroc(preds, target, num_classes=3)), 4)
        1.0
    """
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    weights = _class_weights(target, valid, num_classes) if average == "weighted" else None
    if state is None:
        state = _keep_valid(preds, target, valid)
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    return _reduce_auroc(fpr, tpr, average, weights)


def multilabel_auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel AUROC (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_auroc
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> round(float(multilabel_auroc(preds, target, num_labels=3)), 4)
        1.0
    """
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    if average == "micro":
        if state is None:
            return _binary_auroc_compute(_keep_valid(preds.reshape(-1), target.reshape(-1), valid.reshape(-1)), None)
        return _binary_auroc_compute(state.sum(1), thresholds)
    if state is None:
        fpr, tpr, _ = _multilabel_roc_compute((preds, target), num_labels, None, valid)
    else:
        fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds)
    weights = (target * valid).sum(0).to(torch.float32)
    return _reduce_auroc(fpr, tpr, average, weights)


def auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """AUROC of any task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import auroc
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> round(float(auroc(preds, target, task="multiclass", num_classes=3)), 4)
        1.0
    """
    task = ClassificationTask.from_str(task)
    _task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    return multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
