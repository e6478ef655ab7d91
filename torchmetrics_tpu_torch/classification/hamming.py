"""Modular Hamming distance, on the stat-scores states."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_dispatch,
)
from torchmetrics_tpu_torch.functional.classification.hamming import _hamming_distance_reduce


class BinaryHammingDistance(BinaryStatScores):
    """Binary Hamming distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryHammingDistance
        >>> m = BinaryHammingDistance(device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> round(float(m.compute()), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassHammingDistance(MulticlassStatScores):
    """Multiclass Hamming distance."""

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, top_k=self.top_k
        )


class MultilabelHammingDistance(MultilabelStatScores):
    """Multilabel Hamming distance."""

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


HammingDistance = _task_dispatch(
    BinaryHammingDistance,
    MulticlassHammingDistance,
    MultilabelHammingDistance,
    "HammingDistance",
    "Task-dispatching Hamming distance.",
)
