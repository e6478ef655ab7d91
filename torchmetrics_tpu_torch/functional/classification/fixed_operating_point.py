"""Fixed operating points: the ``*AtFixed*`` quartet (recall at fixed
precision, precision at fixed recall, sensitivity at specificity and
specificity at sensitivity) for every task.

All four are one reduction: maximise one curve quantity subject to another
staying at or above a floor (:func:`_best_operating_point`). Binned mode
reads the ``(T, [C,] 2, 2)`` count state straight, all classes in one
masked reduction over the threshold axis; the counts are the curve
metrics' (the ``binned_curve`` kernel for binary, one weightless
``bincount`` for the one-vs-rest classes and labels). Exact mode reduces
each class's host-side curve.

Held to the JAX package:

- among the qualifying points with the largest objective, the PR pair
  prefers the largest constraint, then the largest threshold; the ROC pair
  the largest threshold;
- the threshold is the 1e6 sentinel when nothing qualifies, and for the PR
  pair also when the best objective is 0;
- the exact ROC's (0, 0) start point reports threshold 1.0;
- specificity is ``1 - fpr``, so 1 with no negative samples;
- a floor that is not a float in [0, 1] (``1`` included) is refused.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _keep_valid,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
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

Pair = Tuple[torch.Tensor, torch.Tensor]

_SENTINEL = 1e6

#: per family: whether it reads the PR pair (else the ROC pair), whether
#: ties on the objective break towards the larger constraint before the
#: larger threshold, and whether a 0 objective maps to the sentinel (the PR
#: pair) or only an empty qualifying set does (the ROC pair)
_FAMILIES = {
    "recall_at_precision": dict(pr_curve=True, tiebreak=True, zero_sentinel=True),
    "precision_at_recall": dict(pr_curve=True, tiebreak=True, zero_sentinel=True),
    "sensitivity_at_specificity": dict(pr_curve=False, tiebreak=False, zero_sentinel=False),
    "specificity_at_sensitivity": dict(pr_curve=False, tiebreak=False, zero_sentinel=False),
}


def _best_operating_point(
    objective: torch.Tensor,
    constraint: torch.Tensor,
    thresholds: torch.Tensor,
    min_constraint: float,
    tiebreak: Optional[torch.Tensor] = None,
    zero_to_sentinel: bool = True,
) -> Pair:
    """max(objective) subject to constraint >= min_constraint, over the
    threshold axis (dim 0) of threshold-aligned ``(T,)`` or ``(T, C)``
    inputs, every class at once. Returns float32 ``(best_objective,
    best_threshold)`` of shape ``()`` or ``(C,)`` (see the module docstring
    for the ties and the sentinel)."""
    neg = torch.tensor(float("-inf"), dtype=objective.dtype, device=objective.device)
    ok = constraint >= min_constraint
    masked_obj = torch.where(ok, objective, neg)
    best = masked_obj.amax(0)
    sel = ok & (masked_obj == best)
    if tiebreak is not None:
        masked_tb = torch.where(sel, tiebreak, neg)
        sel = sel & (masked_tb == masked_tb.amax(0))
    thr = thresholds.reshape((-1,) + (1,) * (objective.ndim - 1)).to(objective.dtype)
    best_thr = torch.where(sel, thr, neg).amax(0)
    any_ok = ok.any(0)
    best_val = torch.where(any_ok, best, torch.zeros_like(best)).to(torch.float32)
    sentinel = torch.full_like(best_thr, _SENTINEL)
    if zero_to_sentinel:
        best_thr = torch.where(best_val == 0.0, sentinel, best_thr)
    else:
        best_thr = torch.where(any_ok, best_thr, sentinel)
    return best_val, best_thr.to(torch.float32)


def _binned_pr_quantities(state: torch.Tensor) -> Pair:
    """(precision, recall) per threshold of a ``(T, [C,] 2, 2)`` state."""
    tps, fps, fns = state[..., 1, 1], state[..., 0, 1], state[..., 1, 0]
    return _safe_divide(tps, tps + fps), _safe_divide(tps, tps + fns)


def _binned_roc_quantities(state: torch.Tensor) -> Pair:
    """(sensitivity, specificity) per threshold of a ``(T, [C,] 2, 2)``
    state, specificity as ``1 - fpr`` (1 with no negative samples, as on the
    ROC)."""
    tps, fps, fns, tns = state[..., 1, 1], state[..., 0, 1], state[..., 1, 0], state[..., 0, 0]
    return _safe_divide(tps, tps + fns), 1.0 - _safe_divide(fps, fps + tns)


def _objective_constraint(family: str, first: torch.Tensor, second: torch.Tensor) -> Pair:
    """The family's (objective, constraint) from its curve pair: (precision,
    recall) for the PR pair, (sensitivity, specificity) for the ROC pair."""
    if family in ("recall_at_precision", "specificity_at_sensitivity"):
        return second, first
    if family in ("precision_at_recall", "sensitivity_at_specificity"):
        return first, second
    raise ValueError(f"Unknown family {family}")


def _reduce(family: str, first: torch.Tensor, second: torch.Tensor, thresholds: torch.Tensor, min_constraint: float) -> Pair:
    cfg = _FAMILIES[family]
    objective, constraint = _objective_constraint(family, first, second)
    return _best_operating_point(
        objective, constraint, thresholds, min_constraint,
        constraint if cfg["tiebreak"] else None, zero_to_sentinel=cfg["zero_sentinel"],
    )


def _reduce_binned(state: torch.Tensor, thresholds: torch.Tensor, min_constraint: float, family: str) -> Pair:
    """Binned-mode reduction straight off the (T, 2, 2) or (T, C, 2, 2) state."""
    quantities = _binned_pr_quantities if _FAMILIES[family]["pr_curve"] else _binned_roc_quantities
    return _reduce(family, *quantities(state), thresholds, min_constraint)


def _reduce_curve(
    curve_a: torch.Tensor, curve_b: torch.Tensor, thresholds: torch.Tensor, min_constraint: float, family: str
) -> Pair:
    """Exact-mode reduction of one class's curve: (precision, recall) for
    the PR pair, (fpr, tpr) for the ROC pair, each trimmed to the points
    that have a threshold (the PR curve's appended end point has none)."""
    n = min(curve_a.shape[0], curve_b.shape[0], thresholds.shape[0])
    if _FAMILIES[family]["pr_curve"]:
        first, second = curve_a[:n], curve_b[:n]
    else:
        first, second = curve_b[:n], 1.0 - curve_a[:n]
        # the exact ROC's (0, 0) start point sits above the probability range
        thresholds = torch.clamp(thresholds, max=1.0)
    return _reduce(family, first, second, thresholds[:n], min_constraint)


def _min_constraint_validation(name: str, value: float) -> None:
    if not isinstance(value, float) or not (0 <= value <= 1):
        raise ValueError(f"Expected argument `{name}` to be a float in the [0,1] range, but got {value}")


def _binary_fixed_compute(state, thresholds: Optional[torch.Tensor], min_constraint: float, family: str) -> Pair:
    if thresholds is not None and isinstance(state, torch.Tensor):
        return _reduce_binned(state, thresholds, min_constraint, family)
    curve = _binary_precision_recall_curve_compute if _FAMILIES[family]["pr_curve"] else _binary_roc_compute
    a, b, t = curve(state, None)
    return _reduce_curve(a, b, t, min_constraint, family)


def _multidim_fixed_compute(
    state, thresholds: Optional[torch.Tensor], min_constraint: float, family: str, curves
) -> Pair:
    """Binned: one reduction over the (T, C, 2, 2) state. Exact: one
    reduction of each class's ``curves`` entry, stacked."""
    if thresholds is not None and isinstance(state, torch.Tensor):
        return _reduce_binned(state, thresholds, min_constraint, family)
    res = [_reduce_curve(a, b, t, min_constraint, family) for a, b, t in zip(*curves)]
    return torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res])


def _multiclass_curves(state, num_classes: int, family: str):
    """The exact per-class curves the family reads."""
    if _FAMILIES[family]["pr_curve"]:
        return _multiclass_precision_recall_curve_compute(state, num_classes, None)
    return _multiclass_roc_compute(state, num_classes, None)


def _multilabel_curves(state, num_labels: int, family: str, ignore_index: Optional[int], valid: Optional[torch.Tensor]):
    """The exact per-label curves the family reads, each over its valid samples."""
    if _FAMILIES[family]["pr_curve"]:
        return _multilabel_precision_recall_curve_compute(state, num_labels, None, ignore_index, valid)
    return _multilabel_roc_compute(state, num_labels, None, valid)


# --------------------------------------------------------------------- binary

def _binary_fixed_functional(preds, target, min_constraint, thresholds, ignore_index, validate_args, name, family):
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _min_constraint_validation(name, min_constraint)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds, ignore_index=ignore_index)
    if state is None:
        state = _keep_valid(preds, target, valid)
    return _binary_fixed_compute(state, thresholds, min_constraint, family)


def binary_recall_at_fixed_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Highest recall whose precision stays at or above ``min_precision``:
    scalar ``(recall, threshold)``, the threshold 1e6 when unattainable.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_recall_at_fixed_precision
        >>> preds, target = torch.tensor([0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0])
        >>> [round(float(v), 4) for v in binary_recall_at_fixed_precision(preds, target, 0.5, thresholds=5)]
        [1.0, 0.5]
    """
    return _binary_fixed_functional(
        preds, target, min_precision, thresholds, ignore_index, validate_args, "min_precision", "recall_at_precision"
    )


def binary_precision_at_fixed_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Highest precision whose recall stays at or above ``min_recall``."""
    return _binary_fixed_functional(
        preds, target, min_recall, thresholds, ignore_index, validate_args, "min_recall", "precision_at_recall"
    )


def binary_sensitivity_at_specificity(
    preds: torch.Tensor,
    target: torch.Tensor,
    min_specificity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Highest sensitivity (TPR) whose specificity stays at or above ``min_specificity``."""
    return _binary_fixed_functional(
        preds, target, min_specificity, thresholds, ignore_index, validate_args,
        "min_specificity", "sensitivity_at_specificity",
    )


def binary_specificity_at_sensitivity(
    preds: torch.Tensor,
    target: torch.Tensor,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Highest specificity (TNR) whose sensitivity stays at or above ``min_sensitivity``."""
    return _binary_fixed_functional(
        preds, target, min_sensitivity, thresholds, ignore_index, validate_args,
        "min_sensitivity", "specificity_at_sensitivity",
    )


# ----------------------------------------------------------------- multiclass

def _multiclass_fixed_functional(
    preds, target, num_classes, min_constraint, thresholds, ignore_index, validate_args, name, family
):
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _min_constraint_validation(name, min_constraint)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    curves = None
    if state is None:
        state = _keep_valid(preds, target, valid)
        curves = _multiclass_curves(state, num_classes, family)
    return _multidim_fixed_compute(state, thresholds, min_constraint, family, curves)


def multiclass_recall_at_fixed_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Per-class highest recall with precision at or above ``min_precision``: ``(C,)`` pairs."""
    return _multiclass_fixed_functional(
        preds, target, num_classes, min_precision, thresholds, ignore_index, validate_args,
        "min_precision", "recall_at_precision",
    )


def multiclass_precision_at_fixed_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Per-class highest precision with recall at or above ``min_recall``."""
    return _multiclass_fixed_functional(
        preds, target, num_classes, min_recall, thresholds, ignore_index, validate_args,
        "min_recall", "precision_at_recall",
    )


def multiclass_sensitivity_at_specificity(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    min_specificity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Per-class highest sensitivity with specificity at or above ``min_specificity``."""
    return _multiclass_fixed_functional(
        preds, target, num_classes, min_specificity, thresholds, ignore_index, validate_args,
        "min_specificity", "sensitivity_at_specificity",
    )


def multiclass_specificity_at_sensitivity(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Per-class highest specificity with sensitivity at or above ``min_sensitivity``."""
    return _multiclass_fixed_functional(
        preds, target, num_classes, min_sensitivity, thresholds, ignore_index, validate_args,
        "min_sensitivity", "specificity_at_sensitivity",
    )


# ----------------------------------------------------------------- multilabel

def _multilabel_fixed_functional(
    preds, target, num_labels, min_constraint, thresholds, ignore_index, validate_args, name, family
):
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _min_constraint_validation(name, min_constraint)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    curves = None
    if state is None:
        state = (preds, target)
        curves = _multilabel_curves(state, num_labels, family, ignore_index, valid)
    return _multidim_fixed_compute(state, thresholds, min_constraint, family, curves)


def multilabel_recall_at_fixed_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Per-label highest recall with precision at or above ``min_precision``: ``(L,)`` pairs."""
    return _multilabel_fixed_functional(
        preds, target, num_labels, min_precision, thresholds, ignore_index, validate_args,
        "min_precision", "recall_at_precision",
    )


def multilabel_precision_at_fixed_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Per-label highest precision with recall at or above ``min_recall``."""
    return _multilabel_fixed_functional(
        preds, target, num_labels, min_recall, thresholds, ignore_index, validate_args,
        "min_recall", "precision_at_recall",
    )


def multilabel_sensitivity_at_specificity(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    min_specificity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Per-label highest sensitivity with specificity at or above ``min_specificity``."""
    return _multilabel_fixed_functional(
        preds, target, num_labels, min_specificity, thresholds, ignore_index, validate_args,
        "min_specificity", "sensitivity_at_specificity",
    )


def multilabel_specificity_at_sensitivity(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Per-label highest specificity with sensitivity at or above ``min_sensitivity``."""
    return _multilabel_fixed_functional(
        preds, target, num_labels, min_sensitivity, thresholds, ignore_index, validate_args,
        "min_sensitivity", "specificity_at_sensitivity",
    )


# ---------------------------------------------------------------- dispatchers

def _fixed_dispatch(binary_fn: Callable, multiclass_fn: Callable, multilabel_fn: Callable, *args) -> Pair:
    preds, target, task, min_value, thresholds, num_classes, num_labels, ignore_index, validate_args = args
    task = ClassificationTask.from_str(task)
    _task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_fn(preds, target, min_value, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_fn(preds, target, num_classes, min_value, thresholds, ignore_index, validate_args)
    return multilabel_fn(preds, target, num_labels, min_value, thresholds, ignore_index, validate_args)


def recall_at_fixed_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    min_precision: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Recall at fixed precision of any task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import recall_at_fixed_precision
        >>> preds, target = torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0])
        >>> result = recall_at_fixed_precision(preds, target, task="binary", min_precision=0.5, thresholds=5)
        >>> [round(float(v), 4) for v in result]
        [1.0, 0.25]
    """
    return _fixed_dispatch(
        binary_recall_at_fixed_precision, multiclass_recall_at_fixed_precision, multilabel_recall_at_fixed_precision,
        preds, target, task, min_precision, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def precision_at_fixed_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    min_recall: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Precision at fixed recall of any task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import precision_at_fixed_recall
        >>> preds, target = torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0])
        >>> result = precision_at_fixed_recall(preds, target, task="binary", min_recall=0.5, thresholds=5)
        >>> [round(float(v), 4) for v in result]
        [1.0, 0.75]
    """
    return _fixed_dispatch(
        binary_precision_at_fixed_recall, multiclass_precision_at_fixed_recall, multilabel_precision_at_fixed_recall,
        preds, target, task, min_recall, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def sensitivity_at_specificity(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    min_specificity: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Sensitivity at fixed specificity of any task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import sensitivity_at_specificity
        >>> preds, target = torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0])
        >>> result = sensitivity_at_specificity(preds, target, task="binary", min_specificity=0.5, thresholds=5)
        >>> [round(float(v), 4) for v in result]
        [1.0, 0.25]
    """
    return _fixed_dispatch(
        binary_sensitivity_at_specificity, multiclass_sensitivity_at_specificity, multilabel_sensitivity_at_specificity,
        preds, target, task, min_specificity, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def specificity_at_sensitivity(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Pair:
    """Specificity at fixed sensitivity of any task (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import specificity_at_sensitivity
        >>> preds, target = torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0])
        >>> result = specificity_at_sensitivity(preds, target, task="binary", min_sensitivity=0.5, thresholds=5)
        >>> [round(float(v), 4) for v in result]
        [1.0, 0.75]
    """
    return _fixed_dispatch(
        binary_specificity_at_sensitivity, multiclass_specificity_at_sensitivity, multilabel_specificity_at_sensitivity,
        preds, target, task, min_sensitivity, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )
