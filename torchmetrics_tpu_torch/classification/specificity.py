"""Modular specificity, on the stat-scores states."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_dispatch,
)
from torchmetrics_tpu_torch.functional.classification.specificity import _specificity_reduce


class BinarySpecificity(BinaryStatScores):
    """Binary specificity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinarySpecificity
        >>> m = BinarySpecificity(device="cpu")
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
        return _specificity_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassSpecificity(MulticlassStatScores):
    """Multiclass specificity."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, top_k=self.top_k
        )


class MultilabelSpecificity(MultilabelStatScores):
    """Multilabel specificity."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


Specificity = _task_dispatch(
    BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity, "Specificity", "Task-dispatching specificity."
)
