"""Modular Matthews correlation coefficient, on the confusion-matrix state."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _single_value_plot
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.classification.stat_scores import _check_int
from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class BinaryMatthewsCorrCoef(BinaryConfusionMatrix):
    """Binary Matthews correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryMatthewsCorrCoef
        >>> m = BinaryMatthewsCorrCoef(device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> round(float(m.compute()), 4)
        0.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(
        self, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_reduce(self.confmat)

    plot = _single_value_plot


class MulticlassMatthewsCorrCoef(MulticlassConfusionMatrix):
    """Multiclass Matthews correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassMatthewsCorrCoef
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassMatthewsCorrCoef(num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.7
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(
        self, num_classes: int, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_reduce(self.confmat)

    plot = _single_value_plot


class MultilabelMatthewsCorrCoef(MultilabelConfusionMatrix):
    """Multilabel Matthews correlation coefficient (the labels' matrices summed)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_reduce(self.confmat)

    plot = _single_value_plot


class MatthewsCorrCoef(_ClassificationTaskWrapper):
    """Task-dispatching Matthews correlation coefficient."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryMatthewsCorrCoef(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            _check_int(num_classes, "num_classes")
            return MulticlassMatthewsCorrCoef(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            _check_int(num_labels, "num_labels")
            return MultilabelMatthewsCorrCoef(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")
