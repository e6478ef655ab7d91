"""Precision and recall (functional interface)."""
from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification._stats_helper import (
    _binary_stats,
    _multiclass_stats,
    _multilabel_stats,
)
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _precision_recall_reduce(
    stat: str,
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0.0,
) -> torch.Tensor:
    """Reduce to precision (stat='precision': tp/(tp+fp)) or recall (tp/(tp+fn))."""
    different_stat = fp if stat == "precision" else fn
    if average == "binary":
        return _safe_divide(tp, tp + different_stat, zero_division)
    if average == "micro":
        if tp.ndim:
            dim = 0 if multidim_average == "global" else 1
            tp, different_stat = tp.sum(dim), different_stat.sum(dim)
        return _safe_divide(tp, tp + different_stat, zero_division)
    score = _safe_divide(tp, tp + different_stat, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def _make_pr(stat: str):
    def binary_fn(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True):
        tp, fp, tn, fn = _binary_stats(preds, target, threshold, multidim_average, ignore_index, validate_args)
        return _precision_recall_reduce(stat, tp, fp, tn, fn, average="binary", multidim_average=multidim_average)

    def multiclass_fn(
        preds, target, num_classes, average="macro", top_k=1, multidim_average="global", ignore_index=None, validate_args=True
    ):
        tp, fp, tn, fn = _multiclass_stats(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
        return _precision_recall_reduce(stat, tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k)

    def multilabel_fn(
        preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global", ignore_index=None, validate_args=True
    ):
        tp, fp, tn, fn = _multilabel_stats(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
        return _precision_recall_reduce(
            stat, tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True
        )

    for fn, task in ((binary_fn, "binary"), (multiclass_fn, "multiclass"), (multilabel_fn, "multilabel")):
        fn.__name__ = fn.__qualname__ = f"{task}_{stat}"
        fn.__doc__ = f"{task.capitalize()} {stat} (functional interface)."
    return binary_fn, multiclass_fn, multilabel_fn


binary_precision, multiclass_precision, multilabel_precision = _make_pr("precision")
binary_recall, multiclass_recall, multilabel_recall = _make_pr("recall")


def _dispatch(binary_fn, multiclass_fn, multilabel_fn, name: str):
    def task_fn(
        preds,
        target,
        task,
        threshold=0.5,
        num_classes=None,
        num_labels=None,
        average="micro",
        multidim_average="global",
        top_k=1,
        ignore_index=None,
        validate_args=True,
    ):
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return binary_fn(preds, target, threshold, multidim_average, ignore_index, validate_args)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            if not isinstance(top_k, int):
                raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
            return multiclass_fn(preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return multilabel_fn(preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args)
        raise ValueError(f"Not handled value: {task}")

    task_fn.__name__ = task_fn.__qualname__ = name
    task_fn.__doc__ = f"Task-dispatching {name} (functional interface)."
    return task_fn


precision = _dispatch(binary_precision, multiclass_precision, multilabel_precision, "precision")
recall = _dispatch(binary_recall, multiclass_recall, multilabel_recall, "recall")
