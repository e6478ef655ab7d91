"""Precision-recall curve machinery: the state and update shared by the PR
curve, ROC, AUROC and average precision.

Two state modes, as in the JAX package:

- ``thresholds=None``: the exact curve. Every valid sample is kept; compute
  sorts the scores (with torch, on the tensors' device) and takes
  cumulative sums in float64, rounding the curve once to float32.
- ``thresholds=int|list|tensor``: the binned curve, constant memory. The
  state is a ``(T, 2, 2)`` int32 count per threshold (``(T, C, 2, 2)``
  one-vs-rest for multiclass and multilabel). The binary count runs on the
  ``binned_curve`` kernel (ops/binned_curve.py); the per-class counts are
  one K = 2 ``bincount`` over ``(T+1)·C`` bins.

An integer ``thresholds`` is the grid ``arange(T) * float32(1/(T-1))``,
which equals ``jnp.linspace(0, 1, T)`` bit for bit (``torch.linspace`` does
not), so a score that sits on a threshold counts on the same side as in the
JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits, _softmax_if_logits
from torchmetrics_tpu_torch.ops.binned_curve import (
    SortedThresholds,
    binned_curve_counts,
    binned_curve_counts_classwise,
    sort_thresholds,
)
from torchmetrics_tpu_torch.utils.checks import _check_same_shape, _unique_values
from torchmetrics_tpu_torch.utils.compute import _safe_divide, interp
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Thresholds = Union[int, List[float], torch.Tensor, None]
Curve = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _adjust_threshold_arg(
    thresholds: Thresholds = None, device: Optional[torch.device] = None
) -> Optional[torch.Tensor]:
    """The thresholds argument as a float32 tensor on ``device`` (or None)."""
    if thresholds is None:
        return None
    if isinstance(thresholds, int):
        step = torch.tensor(1 / (thresholds - 1), dtype=torch.float32)
        return (torch.arange(thresholds, dtype=torch.float32) * step).to(device)
    if isinstance(thresholds, (list, tuple)):
        return torch.tensor(thresholds, dtype=torch.float32, device=device)
    thresholds = torch.as_tensor(thresholds, device=device)
    return thresholds.to(torch.float32) if thresholds.dtype == torch.float64 else thresholds


def _binary_precision_recall_curve_arg_validation(
    thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    if thresholds is not None and not isinstance(thresholds, (list, tuple, int)) and not hasattr(thresholds, "shape"):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or tensor of floats,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}")
    if isinstance(thresholds, (list, tuple)) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            f"If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range, but got {thresholds}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _check_binary_target_values(target: torch.Tensor, ignore_index: Optional[int]) -> None:
    """Target values must be {0, 1} (+ ignore_index): one device sort, one host read."""
    unique_values = sorted(_unique_values(target))
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not set(unique_values).issubset(allowed):
        raise ValueError(
            f"Detected the following values in `target`: {unique_values} but expected only"
            f" the following values {[0, 1] if ignore_index is None else [ignore_index, 0, 1]}."
        )


def _binary_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if target.is_floating_point():
        raise ValueError(
            f"Expected argument `target` to be an int tensor with ground truth labels, but got dtype {target.dtype}"
        )
    if not preds.is_floating_point():
        raise ValueError(f"Expected argument `preds` to be a float tensor, but got {preds.dtype}")
    _check_binary_target_values(target, ignore_index)


def _valid_and_masked(target: torch.Tensor, ignore_index: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(target with ignored entries set to 0, as int32; the valid mask)."""
    if ignore_index is not None:
        valid = target != ignore_index
        target = torch.where(valid, target, torch.zeros_like(target))
    else:
        valid = torch.ones_like(target, dtype=torch.bool)
    return target.to(torch.int32), valid


def _binary_precision_recall_curve_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Flatten, sigmoid-if-logits; returns (preds, target, valid, thresholds)."""
    preds = _sigmoid_if_logits(preds.reshape(-1))
    target, valid = _valid_and_masked(target.reshape(-1), ignore_index)
    return preds, target, valid, _adjust_threshold_arg(thresholds, preds.device)


def _binary_precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    valid: torch.Tensor,
    thresholds: Optional[torch.Tensor],
    sorted_thresholds: Optional[SortedThresholds] = None,
) -> Optional[torch.Tensor]:
    """Binned state update: ``(T, 2, 2)`` int32 counts from the
    ``binned_curve`` kernel (None in exact mode). A metric passes the
    ``sorted_thresholds`` it keeps; a functional call leaves them to be
    sorted here."""
    if thresholds is None:
        return None
    if sorted_thresholds is None:
        sorted_thresholds = sort_thresholds(thresholds)
    return binned_curve_counts(preds, target, valid, sorted_thresholds).to(torch.int32)


def _binary_clf_curve(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact float64 false/true positive counts at each distinct score, scores
    descending (ties keep their input order)."""
    desc = torch.argsort(-preds, stable=True)
    preds = preds[desc]
    target = target[desc]
    distinct = torch.nonzero(torch.diff(preds)).reshape(-1)
    last = torch.tensor([target.numel() - 1], dtype=distinct.dtype, device=distinct.device)
    threshold_idxs = torch.cat([distinct, last])
    tps = torch.cumsum(target.to(torch.float64), 0)[threshold_idxs]
    fps = 1 + threshold_idxs.to(torch.float64) - tps
    return fps, tps, preds[threshold_idxs]


def _binary_precision_recall_curve_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    thresholds: Optional[torch.Tensor],
    pos_label: int = 1,
) -> Curve:
    """(precision, recall, thresholds) from the binned counts or the exact
    (preds, target) pair."""
    if thresholds is not None and isinstance(state, torch.Tensor):
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones(1, dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros(1, dtype=recall.dtype, device=recall.device)])
        return precision, recall, thresholds
    preds, target = state
    fps, tps, thresh = _binary_clf_curve(preds, target)
    ps = tps + fps
    precision = torch.where(ps != 0, tps / torch.where(ps == 0, torch.ones_like(ps), ps), torch.zeros_like(ps))
    recall = torch.where(tps[-1] != 0, tps / torch.where(tps[-1] != 0, tps[-1], 1.0), torch.ones_like(tps))
    one = torch.ones(1, dtype=torch.float64, device=ps.device)
    precision = torch.cat([precision.flip(0), one]).to(torch.float32)
    recall = torch.cat([recall.flip(0), torch.zeros_like(one)]).to(torch.float32)
    return precision, recall, thresh.flip(0)


def _keep_valid(preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact mode's sample state: the valid rows only (a host read of the
    mask's count)."""
    return preds[valid], target[valid]


def binary_precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curve:
    """Binary PR curve. Returns (precision, recall, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> [[round(x, 4) for x in v.tolist()] for v in binary_precision_recall_curve(preds, target)]
        [[0.5, 0.6667, 0.5, 1.0, 1.0], [1.0, 1.0, 0.5, 0.5, 0.0], [0.2, 0.3, 0.6, 0.8]]
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    if state is None:
        state = _keep_valid(preds, target, valid)
    return _binary_precision_recall_curve_compute(state, thresholds)


# ----------------------------------------------------------------- multiclass

def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if average not in (None, "micro", "macro"):
        raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target`")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to equal `num_classes={num_classes}`")
    if not preds.is_floating_point():
        raise ValueError("Expected argument `preds` to be a float tensor with probabilities/logits")
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int tensor with ground truth labels")
    unique_values = sorted(_unique_values(target))
    bad = [v for v in unique_values if (v < 0 or v >= num_classes) and v != ignore_index]
    if bad:
        raise ValueError(f"Detected values in `target` outside [0, {num_classes - 1}]: {bad}")


def _multiclass_precision_recall_curve_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    preds = _softmax_if_logits(preds.movedim(1, -1).reshape(-1, num_classes), dim=-1)
    target, valid = _valid_and_masked(target.reshape(-1), ignore_index)
    if average == "micro":
        # one-vs-rest flattening: the task becomes binary over N*C pairs
        target = torch.nn.functional.one_hot(target.to(torch.int64), num_classes).reshape(-1).to(torch.int32)
        valid = valid[:, None].expand(-1, num_classes).reshape(-1)
        preds = preds.reshape(-1)
    return preds, target, valid, _adjust_threshold_arg(thresholds, preds.device)


def _multiclass_precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    valid: torch.Tensor,
    num_classes: int,
    thresholds: Optional[torch.Tensor],
    average: Optional[str] = None,
    sorted_thresholds: Optional[SortedThresholds] = None,
) -> Optional[torch.Tensor]:
    """Binned state: ``(T, C, 2, 2)`` int32 one-vs-rest counts (``(T, 2, 2)``
    for micro)."""
    if thresholds is None:
        return None
    if sorted_thresholds is None:
        sorted_thresholds = sort_thresholds(thresholds)
    if average == "micro":
        return _binary_precision_recall_curve_update(preds, target, valid, thresholds, sorted_thresholds)
    target_oh = torch.nn.functional.one_hot(target.to(torch.int64), num_classes)
    return binned_curve_counts_classwise(preds, target_oh, valid[:, None], sorted_thresholds).to(torch.int32)


def _per_class_curves(state: Tuple[torch.Tensor, torch.Tensor], num_classes: int, curve_fn) -> Tuple[list, list, list]:
    """One-vs-rest exact curves of every class of an exact multiclass state."""
    preds, target = state
    xs, ys, ts = [], [], []
    for c in range(num_classes):
        x, y, t = curve_fn((preds[:, c], (target == c).to(torch.int32)), None)
        xs.append(x)
        ys.append(y)
        ts.append(t)
    return xs, ys, ts


def _multiclass_precision_recall_curve_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_classes: int,
    thresholds: Optional[torch.Tensor],
    average: Optional[str] = None,
):
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)
    if thresholds is not None and isinstance(state, torch.Tensor):
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        ones = torch.ones((1, num_classes), dtype=precision.dtype, device=precision.device)
        precision = torch.cat([precision, ones], dim=0).T
        recall = torch.cat([recall, torch.zeros_like(ones)], dim=0).T
        if average == "macro":
            return _macro_interp_merge(precision, recall, thresholds.repeat(num_classes), descending=False)
        return precision, recall, thresholds
    precision, recall, thresh = _per_class_curves(state, num_classes, _binary_precision_recall_curve_compute)
    if average == "macro":
        return _macro_interp_merge(precision, recall, torch.cat(thresh), descending=False)
    return precision, recall, thresh


def _macro_interp_merge(
    xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor], all_thresholds: torch.Tensor, descending: bool
) -> Curve:
    """Average per-class curves onto their pooled sorted x grid by
    interpolation."""
    thresh = torch.sort(all_thresholds).values
    if descending:
        thresh = thresh.flip(0)
    mean_x = torch.sort(torch.cat([x.reshape(-1) for x in xs])).values
    mean_y = torch.zeros_like(mean_x)
    for x, y in zip(xs, ys):
        mean_y = mean_y + interp(mean_x, x, y)
    return mean_x, mean_y / len(xs), thresh


def multiclass_precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Multiclass one-vs-rest PR curves.

    ``average``: ``"micro"`` one-hot-flattens into a single binary curve;
    ``"macro"`` interpolation-merges the per-class curves.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_precision_recall_curve
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> result = multiclass_precision_recall_curve(preds, target, num_classes=3, thresholds=5)
        >>> [tuple(v.shape) for v in result]
        [(3, 6), (3, 6), (5,)]
    """
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds, average)
    if state is None:
        state = _keep_valid(preds, target, valid)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average)


# ----------------------------------------------------------------- multilabel

def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to equal `num_labels={num_labels}`")
    if not preds.is_floating_point():
        raise ValueError("Expected argument `preds` to be a float tensor with probabilities/logits")
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int tensor with ground truth labels")
    _check_binary_target_values(target, ignore_index)


def _multilabel_precision_recall_curve_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    preds = _sigmoid_if_logits(preds.movedim(1, -1).reshape(-1, num_labels))
    target, valid = _valid_and_masked(target.movedim(1, -1).reshape(-1, num_labels), ignore_index)
    return preds, target, valid, _adjust_threshold_arg(thresholds, preds.device)


def _multilabel_precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    valid: torch.Tensor,
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    sorted_thresholds: Optional[SortedThresholds] = None,
) -> Optional[torch.Tensor]:
    if thresholds is None:
        return None
    if sorted_thresholds is None:
        sorted_thresholds = sort_thresholds(thresholds)
    return binned_curve_counts_classwise(preds, target, valid, sorted_thresholds).to(torch.int32)


def _per_label_curves(
    state: Tuple[torch.Tensor, torch.Tensor], num_labels: int, valid: Optional[torch.Tensor], curve_fn
) -> Tuple[list, list, list]:
    """Exact curves of every label, each over its own valid samples."""
    preds, target = state
    xs, ys, ts = [], [], []
    for lbl in range(num_labels):
        p_l, t_l = preds[:, lbl], target[:, lbl]
        if valid is not None:
            p_l, t_l = p_l[valid[:, lbl]], t_l[valid[:, lbl]]
        x, y, t = curve_fn((p_l, t_l), None)
        xs.append(x)
        ys.append(y)
        ts.append(t)
    return xs, ys, ts


def _multilabel_precision_recall_curve_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    ignore_index: Optional[int] = None,
    valid: Optional[torch.Tensor] = None,
):
    if thresholds is not None and isinstance(state, torch.Tensor):
        return _multiclass_precision_recall_curve_compute(state, num_labels, thresholds)
    return _per_label_curves(state, num_labels, valid, _binary_precision_recall_curve_compute)


def multilabel_precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Per-label PR curves.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_precision_recall_curve
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> result = multilabel_precision_recall_curve(preds, target, num_labels=3, thresholds=5)
        >>> [tuple(v.shape) for v in result]
        [(3, 6), (3, 6), (5,)]
    """
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    if state is None:
        return _multilabel_precision_recall_curve_compute((preds, target), num_labels, None, ignore_index, valid)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds)


def _task_count(task: ClassificationTask, num_classes: Optional[int], num_labels: Optional[int]) -> None:
    """Raise when the task's class or label count is not an int."""
    if task == ClassificationTask.MULTICLASS and not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
    if task == ClassificationTask.MULTILABEL and not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")


def precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Precision-recall curve of any task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> result = precision_recall_curve(preds, target, task="binary", thresholds=5)
        >>> [tuple(v.shape) for v in result]
        [(6,), (6,), (5,)]
    """
    task = ClassificationTask.from_str(task)
    _task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_precision_recall_curve(
            preds, target, num_classes, thresholds, ignore_index=ignore_index, validate_args=validate_args
        )
    return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
