"""Modular precision and recall."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_dispatch,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall import _precision_recall_reduce


class BinaryPrecision(BinaryStatScores):
    """Binary precision."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce("precision", tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassPrecision(MulticlassStatScores):
    """Multiclass precision."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "precision", tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, top_k=self.top_k
        )


class MultilabelPrecision(MultilabelStatScores):
    """Multilabel precision."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "precision", tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class BinaryRecall(BinaryStatScores):
    """Binary recall."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce("recall", tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassRecall(MulticlassStatScores):
    """Multiclass recall."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "recall", tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, top_k=self.top_k
        )


class MultilabelRecall(MultilabelStatScores):
    """Multilabel recall."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "recall", tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


Precision = _task_dispatch(
    BinaryPrecision, MulticlassPrecision, MultilabelPrecision, "Precision", "Task-dispatching precision."
)
Recall = _task_dispatch(BinaryRecall, MulticlassRecall, MultilabelRecall, "Recall", "Task-dispatching recall.")
