"""Modular ``*AtFixed*`` quartet.

Each class is the task's precision-recall curve class with a constrained
operating point for ``compute``: the state is the curve state itself
(binned ``(T, [C,] 2, 2)`` int32 counts, or the exact mode's sample lists),
so sync, ``forward`` and ``state()``/``load_state`` come from the curve
classes, and in a collection a member lands in one compute group with the
AUROC, average precision and other fixed-point members of the same curve
state: one count an update for them all.
"""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.fixed_operating_point import (
    Pair,
    _binary_fixed_compute,
    _min_constraint_validation,
    _multiclass_curves,
    _multidim_fixed_compute,
    _multilabel_curves,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds, _task_count
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class _BinaryFixedBase(BinaryPrecisionRecallCurve):
    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _family: str
    _min_arg_name: str

    def __init__(
        self,
        min_constraint: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args:
            _min_constraint_validation(self._min_arg_name, min_constraint)
        self.min_constraint = min_constraint

    def compute(self) -> Pair:  # type: ignore[override]
        return _binary_fixed_compute(self._curve_state(), self.thresholds, self.min_constraint, self._family)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the value only (by default ``compute()[0]``): the threshold
        is the operating point, not a result."""
        return self._plot(val if val is not None else self.compute()[0], ax)


class _MulticlassFixedBase(MulticlassPrecisionRecallCurve):
    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name = "Class"
    _family: str
    _min_arg_name: str

    def __init__(
        self,
        num_classes: int,
        min_constraint: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args,
            **kwargs,
        )
        if validate_args:
            _min_constraint_validation(self._min_arg_name, min_constraint)
        self.min_constraint = min_constraint

    def compute(self) -> Pair:  # type: ignore[override]
        state = self._curve_state()
        curves = None if self.thresholds is not None else _multiclass_curves(state, self.num_classes, self._family)
        return _multidim_fixed_compute(state, self.thresholds, self.min_constraint, self._family, curves)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the value only (by default ``compute()[0]``): the threshold
        is the operating point, not a result."""
        return self._plot(val if val is not None else self.compute()[0], ax)


class _MultilabelFixedBase(MultilabelPrecisionRecallCurve):
    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name = "Label"
    _family: str
    _min_arg_name: str

    def __init__(
        self,
        num_labels: int,
        min_constraint: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args,
            **kwargs,
        )
        if validate_args:
            _min_constraint_validation(self._min_arg_name, min_constraint)
        self.min_constraint = min_constraint

    def compute(self) -> Pair:  # type: ignore[override]
        state = self._curve_state()
        curves = None
        if self.thresholds is None:
            curves = _multilabel_curves(state, self.num_labels, self._family, self.ignore_index, self._valid_state())
        return _multidim_fixed_compute(state, self.thresholds, self.min_constraint, self._family, curves)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the value only (by default ``compute()[0]``): the threshold
        is the operating point, not a result."""
        return self._plot(val if val is not None else self.compute()[0], ax)


class BinaryRecallAtFixedPrecision(_BinaryFixedBase):
    """Highest recall whose precision stays at or above ``min_precision``,
    binary: scalar ``(value, threshold)``, the threshold 1e6 when unattainable.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryRecallAtFixedPrecision
        >>> m = BinaryRecallAtFixedPrecision(min_precision=0.5, thresholds=5, device="cpu")
        >>> m.update(torch.tensor([0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
        >>> [round(float(v), 4) for v in m.compute()]
        [1.0, 0.5]
    """

    _family = "recall_at_precision"
    _min_arg_name = "min_precision"

    def __init__(self, min_precision: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs) -> None:
        super().__init__(min_precision, thresholds, ignore_index, validate_args, **kwargs)


class MulticlassRecallAtFixedPrecision(_MulticlassFixedBase):
    """Highest recall whose precision stays at or above ``min_precision``,
    per class: ``(C,)`` values and thresholds.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassRecallAtFixedPrecision
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassRecallAtFixedPrecision(num_classes=3, min_precision=0.5, thresholds=5, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> [[round(x, 4) for x in v.tolist()] for v in m.compute()]
        [[1.0, 1.0, 1.0], [0.25, 0.75, 0.5]]
    """

    _family = "recall_at_precision"
    _min_arg_name = "min_precision"

    def __init__(
        self, num_classes: int, min_precision: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(num_classes, min_precision, thresholds, ignore_index, validate_args, **kwargs)


class MultilabelRecallAtFixedPrecision(_MultilabelFixedBase):
    """Highest recall whose precision stays at or above ``min_precision``,
    per label: ``(L,)`` values and thresholds.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelRecallAtFixedPrecision
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> m = MultilabelRecallAtFixedPrecision(num_labels=3, min_precision=0.5, thresholds=5, device="cpu")
        >>> m.update(preds, torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]]))
        >>> [[round(x, 4) for x in v.tolist()] for v in m.compute()]
        [[1.0, 1.0, 1.0], [0.75, 0.5, 0.5]]
    """

    _family = "recall_at_precision"
    _min_arg_name = "min_precision"

    def __init__(
        self, num_labels: int, min_precision: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(num_labels, min_precision, thresholds, ignore_index, validate_args, **kwargs)


class BinaryPrecisionAtFixedRecall(_BinaryFixedBase):
    """Highest precision whose recall stays at or above ``min_recall``,
    binary: scalar ``(value, threshold)``, the threshold 1e6 when unattainable."""

    _family = "precision_at_recall"
    _min_arg_name = "min_recall"

    def __init__(self, min_recall: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs) -> None:
        super().__init__(min_recall, thresholds, ignore_index, validate_args, **kwargs)


class MulticlassPrecisionAtFixedRecall(_MulticlassFixedBase):
    """Highest precision whose recall stays at or above ``min_recall``,
    per class: ``(C,)`` values and thresholds."""

    _family = "precision_at_recall"
    _min_arg_name = "min_recall"

    def __init__(
        self, num_classes: int, min_recall: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(num_classes, min_recall, thresholds, ignore_index, validate_args, **kwargs)


class MultilabelPrecisionAtFixedRecall(_MultilabelFixedBase):
    """Highest precision whose recall stays at or above ``min_recall``,
    per label: ``(L,)`` values and thresholds."""

    _family = "precision_at_recall"
    _min_arg_name = "min_recall"

    def __init__(
        self, num_labels: int, min_recall: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(num_labels, min_recall, thresholds, ignore_index, validate_args, **kwargs)


class BinarySensitivityAtSpecificity(_BinaryFixedBase):
    """Highest sensitivity whose specificity stays at or above ``min_specificity``,
    binary: scalar ``(value, threshold)``, the threshold 1e6 when unattainable."""

    _family = "sensitivity_at_specificity"
    _min_arg_name = "min_specificity"

    def __init__(
        self, min_specificity: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(min_specificity, thresholds, ignore_index, validate_args, **kwargs)


class MulticlassSensitivityAtSpecificity(_MulticlassFixedBase):
    """Highest sensitivity whose specificity stays at or above ``min_specificity``,
    per class: ``(C,)`` values and thresholds."""

    _family = "sensitivity_at_specificity"
    _min_arg_name = "min_specificity"

    def __init__(
        self, num_classes: int, min_specificity: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(num_classes, min_specificity, thresholds, ignore_index, validate_args, **kwargs)


class MultilabelSensitivityAtSpecificity(_MultilabelFixedBase):
    """Highest sensitivity whose specificity stays at or above ``min_specificity``,
    per label: ``(L,)`` values and thresholds."""

    _family = "sensitivity_at_specificity"
    _min_arg_name = "min_specificity"

    def __init__(
        self, num_labels: int, min_specificity: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(num_labels, min_specificity, thresholds, ignore_index, validate_args, **kwargs)


class BinarySpecificityAtSensitivity(_BinaryFixedBase):
    """Highest specificity whose sensitivity stays at or above ``min_sensitivity``,
    binary: scalar ``(value, threshold)``, the threshold 1e6 when unattainable."""

    _family = "specificity_at_sensitivity"
    _min_arg_name = "min_sensitivity"

    def __init__(
        self, min_sensitivity: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(min_sensitivity, thresholds, ignore_index, validate_args, **kwargs)


class MulticlassSpecificityAtSensitivity(_MulticlassFixedBase):
    """Highest specificity whose sensitivity stays at or above ``min_sensitivity``,
    per class: ``(C,)`` values and thresholds."""

    _family = "specificity_at_sensitivity"
    _min_arg_name = "min_sensitivity"

    def __init__(
        self, num_classes: int, min_sensitivity: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(num_classes, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs)


class MultilabelSpecificityAtSensitivity(_MultilabelFixedBase):
    """Highest specificity whose sensitivity stays at or above ``min_sensitivity``,
    per label: ``(L,)`` values and thresholds."""

    _family = "specificity_at_sensitivity"
    _min_arg_name = "min_sensitivity"

    def __init__(
        self, num_labels: int, min_sensitivity: float, thresholds=None, ignore_index=None, validate_args=True, **kwargs
    ) -> None:
        super().__init__(num_labels, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs)


def _fixed_task(task, min_value, thresholds, num_classes, num_labels, ignore_index, validate_args, kwargs, classes):
    """The task's metric of one family (``classes`` binary, multiclass, multilabel)."""
    task = ClassificationTask.from_str(task)
    _task_count(task, num_classes, num_labels)
    binary, multiclass, multilabel = classes
    if task == ClassificationTask.BINARY:
        return binary(min_value, thresholds, ignore_index, validate_args, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        return multiclass(num_classes, min_value, thresholds, ignore_index, validate_args, **kwargs)
    return multilabel(num_labels, min_value, thresholds, ignore_index, validate_args, **kwargs)


class RecallAtFixedPrecision(_ClassificationTaskWrapper):
    """Recall at a fixed precision of any task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import RecallAtFixedPrecision
        >>> m = RecallAtFixedPrecision(task="binary", min_precision=0.5, thresholds=5, device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> [round(float(v), 4) for v in m.compute()]
        [1.0, 0.25]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_precision: Optional[float] = None,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _fixed_task(
            task, min_precision, thresholds, num_classes, num_labels, ignore_index, validate_args, kwargs,
            (BinaryRecallAtFixedPrecision, MulticlassRecallAtFixedPrecision, MultilabelRecallAtFixedPrecision),
        )


class PrecisionAtFixedRecall(_ClassificationTaskWrapper):
    """Precision at a fixed recall of any task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import PrecisionAtFixedRecall
        >>> m = PrecisionAtFixedRecall(task="binary", min_recall=0.5, thresholds=5, device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> [round(float(v), 4) for v in m.compute()]
        [1.0, 0.75]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_recall: Optional[float] = None,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _fixed_task(
            task, min_recall, thresholds, num_classes, num_labels, ignore_index, validate_args, kwargs,
            (BinaryPrecisionAtFixedRecall, MulticlassPrecisionAtFixedRecall, MultilabelPrecisionAtFixedRecall),
        )


class SensitivityAtSpecificity(_ClassificationTaskWrapper):
    """Sensitivity at a fixed specificity of any task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import SensitivityAtSpecificity
        >>> m = SensitivityAtSpecificity(task="binary", min_specificity=0.5, thresholds=5, device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> [round(float(v), 4) for v in m.compute()]
        [1.0, 0.25]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_specificity: Optional[float] = None,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _fixed_task(
            task, min_specificity, thresholds, num_classes, num_labels, ignore_index, validate_args, kwargs,
            (BinarySensitivityAtSpecificity, MulticlassSensitivityAtSpecificity, MultilabelSensitivityAtSpecificity),
        )


class SpecificityAtSensitivity(_ClassificationTaskWrapper):
    """Specificity at a fixed sensitivity of any task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import SpecificityAtSensitivity
        >>> m = SpecificityAtSensitivity(task="binary", min_sensitivity=0.5, thresholds=5, device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> [round(float(v), 4) for v in m.compute()]
        [1.0, 0.75]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_sensitivity: Optional[float] = None,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _fixed_task(
            task, min_sensitivity, thresholds, num_classes, num_labels, ignore_index, validate_args, kwargs,
            (BinarySpecificityAtSensitivity, MulticlassSpecificityAtSensitivity, MultilabelSpecificityAtSensitivity),
        )
