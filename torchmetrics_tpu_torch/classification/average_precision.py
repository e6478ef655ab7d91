"""Modular average precision."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.auroc import _CLASS_AVERAGES, _LABEL_AVERAGES, _check_average
from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _single_value_plot
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _reduce_average_precision,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _multiclass_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_compute,
    _task_count,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Binary average precision (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAveragePrecision
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> m = BinaryAveragePrecision(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.8333
    """

    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        return _binary_average_precision_compute(self._curve_state(), self.thresholds)

    plot = _single_value_plot


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Multiclass one-vs-rest average precision (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAveragePrecision
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> m = MulticlassAveragePrecision(num_classes=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        1.0
    """

    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        if validate_args:
            _check_average(average, _CLASS_AVERAGES)
        self.average = average

    def compute(self) -> torch.Tensor:
        state = self._curve_state()
        precision, recall, _ = _multiclass_precision_recall_curve_compute(state, self.num_classes, self.thresholds)
        weights = self._class_weights(state) if self.average == "weighted" else None
        return _reduce_average_precision(precision, recall, self.average, weights)

    plot = _single_value_plot


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Multilabel average precision (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelAveragePrecision
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> m = MultilabelAveragePrecision(num_labels=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        1.0
    """

    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        if validate_args:
            _check_average(average, _LABEL_AVERAGES)
        self.average = average

    def compute(self) -> torch.Tensor:
        if self.average == "micro":
            if self.thresholds is None:
                preds, target = self._curve_state()
                valid = self._valid_state().reshape(-1)
                return _binary_average_precision_compute((preds.reshape(-1)[valid], target.reshape(-1)[valid]), None)
            return _binary_average_precision_compute(self.confmat.sum(1), self.thresholds)
        precision, recall, _ = _multilabel_precision_recall_curve_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index, self._valid_state()
        )
        return _reduce_average_precision(precision, recall, self.average, self._label_weights())

    plot = _single_value_plot


class AveragePrecision(_ClassificationTaskWrapper):
    """Average precision of any task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import AveragePrecision
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> m = AveragePrecision(task="multiclass", num_classes=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        1.0
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _task_count(task, num_classes, num_labels)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAveragePrecision(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassAveragePrecision(num_classes, average, **kwargs)
        return MultilabelAveragePrecision(num_labels, average, **kwargs)
