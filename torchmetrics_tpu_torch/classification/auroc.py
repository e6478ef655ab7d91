"""Modular AUROC."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _single_value_plot
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.auroc import (
    _binary_auroc_compute,
    _check_max_fpr,
    _reduce_auroc,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds, _task_count
from torchmetrics_tpu_torch.functional.classification.roc import _multiclass_roc_compute, _multilabel_roc_compute
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

_CLASS_AVERAGES = ("macro", "weighted", "none", None)
_LABEL_AVERAGES = ("micro", "macro", "weighted", "none", None)


def _check_average(average: Optional[str], allowed: tuple) -> None:
    if average not in allowed:
        raise ValueError(f"Expected argument `average` to be one of {allowed} but got {average}")


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Binary AUROC (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAUROC
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> m = BinaryAUROC(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.75
    """

    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args:
            _check_max_fpr(max_fpr)
        self.max_fpr = max_fpr

    def compute(self) -> torch.Tensor:
        return _binary_auroc_compute(self._curve_state(), self.thresholds, self.max_fpr)

    plot = _single_value_plot


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Multiclass one-vs-rest AUROC (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAUROC
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> m = MulticlassAUROC(num_classes=3, device="cpu")
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
        fpr, tpr, _ = _multiclass_roc_compute(state, self.num_classes, self.thresholds)
        weights = self._class_weights(state) if self.average == "weighted" else None
        return _reduce_auroc(fpr, tpr, self.average, weights)

    plot = _single_value_plot


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Multilabel AUROC (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelAUROC
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> m = MultilabelAUROC(num_labels=3, device="cpu")
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
            # all labels flattened into one binary problem
            if self.thresholds is None:
                preds, target = self._curve_state()
                valid = self._valid_state().reshape(-1)
                return _binary_auroc_compute((preds.reshape(-1)[valid], target.reshape(-1)[valid]), None)
            return _binary_auroc_compute(self.confmat.sum(1), self.thresholds)
        fpr, tpr, _ = _multilabel_roc_compute(self._curve_state(), self.num_labels, self.thresholds, self._valid_state())
        return _reduce_auroc(fpr, tpr, self.average, self._label_weights())

    plot = _single_value_plot


class AUROC(_ClassificationTaskWrapper):
    """AUROC of any task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import AUROC
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> m = AUROC(task="multiclass", num_classes=3, device="cpu")
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
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _task_count(task, num_classes, num_labels)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAUROC(max_fpr, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassAUROC(num_classes, average, **kwargs)
        return MultilabelAUROC(num_labels, average, **kwargs)
