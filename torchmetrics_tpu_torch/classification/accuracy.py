"""Modular accuracy."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_dispatch,
)
from torchmetrics_tpu_torch.functional.classification.accuracy import _accuracy_reduce


class BinaryAccuracy(BinaryStatScores):
    """Binary accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> m = BinaryAccuracy(device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> round(float(m.compute()), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassAccuracy(num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.8333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, top_k=self.top_k
        )


class MultilabelAccuracy(MultilabelStatScores):
    """Multilabel accuracy."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


Accuracy = _task_dispatch(
    BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy, "Accuracy", "Task-dispatching accuracy."
)
