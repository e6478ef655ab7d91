"""Modular precision-recall curves: the state holders that ROC, AUROC and
average precision subclass.

State per mode:

- binned (``thresholds`` an int, list or tensor): one ``confmat`` int32
  tensor, ``(T, 2, 2)`` (binary, multiclass micro) or ``(T, C, 2, 2)``,
  summed across updates; the thresholds live on the metric's device;
- exact (``thresholds=None``): growing ``preds``/``target`` lists of the
  valid samples (``"cat"``); multilabel also keeps its per-label ``valid``
  mask;
- exact with ``capacity=N`` (binary only): fixed ``(N,)`` buffers that keep
  the first N valid samples, so the update allocates nothing that grows; an
  overflow is dropped and warned about at compute time.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.auroc import _class_weights
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
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
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops.binned_curve import SortedThresholds, sort_thresholds
from torchmetrics_tpu_torch.utils.data import compact_readout, compact_scatter, dim_zero_cat
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class _CurveMetric(Metric):
    """A metric whose ``thresholds`` tensor, and the sorted form of it that
    every binned update reads, follow its state across devices."""

    thresholds: Optional[torch.Tensor]
    _sorted_thresholds: Optional[SortedThresholds]

    def _set_thresholds(self, thresholds: Optional[torch.Tensor]) -> None:
        """Keep a copy of ``thresholds`` (the caller may change theirs in
        place) and sort it once, for every update to come."""
        self.thresholds = None if thresholds is None else thresholds.clone()
        self._sorted_thresholds = None if thresholds is None else sort_thresholds(self.thresholds)

    def to(self, device: Union[str, torch.device]) -> "_CurveMetric":
        super().to(device)
        if self.thresholds is not None:
            self._set_thresholds(self.thresholds.to(self.device))
        return self


class BinaryPrecisionRecallCurve(_CurveMetric):
    """Exact (``thresholds=None``) or binned binary PR curve.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> m = BinaryPrecisionRecallCurve(thresholds=5, device="cpu")
        >>> m.update(preds, target)
        >>> [[round(x, 4) for x in v.tolist()] for v in m.compute()]
        [[0.5, 0.6667, 0.5, 1.0, 0.0, 1.0], [1.0, 1.0, 0.5, 0.5, 0.0, 0.0], [0.0, 0.25, 0.5, 0.75, 1.0]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        # capacity shapes the state buffers: validated unconditionally
        if capacity is not None and (not isinstance(capacity, int) or capacity < 1):
            raise ValueError(f"Argument `capacity` expected to be a positive integer, got {capacity}")
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._set_thresholds(_adjust_threshold_arg(thresholds, self.device))
        if capacity is not None and self.thresholds is not None:
            raise ValueError(
                "Argument `capacity` only applies to exact mode (`thresholds=None`); the binned mode"
                " already has constant-memory state."
            )
        self.capacity = capacity
        if self.thresholds is not None:
            self.add_state("confmat", torch.zeros((len(self.thresholds), 2, 2), dtype=torch.int32), dist_reduce_fx="sum")
        elif capacity is not None:
            self.add_state("preds_buffer", torch.zeros(capacity, dtype=torch.float32), dist_reduce_fx="cat")
            self.add_state("target_buffer", torch.zeros(capacity, dtype=torch.int32), dist_reduce_fx="cat")
            self.add_state("valid_buffer", torch.zeros(capacity, dtype=torch.bool), dist_reduce_fx="cat")
            self.add_state("sample_count", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        else:
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, valid, _ = _binary_precision_recall_curve_format(
            preds, target, self.thresholds, self.ignore_index
        )
        if self.thresholds is not None:
            # the count reads the target and ignore_index as they are: no masking pass
            self.confmat = self.confmat + _binary_precision_recall_curve_update(
                preds, target, valid, self.thresholds, self._sorted_thresholds, self.ignore_index
            )
        elif self.capacity is not None:
            (self.preds_buffer, self.target_buffer, self.valid_buffer), self.sample_count = compact_scatter(
                (self.preds_buffer, self.target_buffer, self.valid_buffer), (preds, target, valid), valid, self.sample_count
            )
        else:
            p, t = _keep_valid(preds, target, valid)
            self.preds.append(p)
            self.target.append(t)

    def _curve_state(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        if self.thresholds is not None:
            return self.confmat
        if self.capacity is not None:
            p, t = compact_readout(
                (self.preds_buffer, self.target_buffer), self.valid_buffer, self.sample_count, type(self).__name__
            )
            return p, t
        return dim_zero_cat(self.preds), dim_zero_cat(self.target)

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return _binary_precision_recall_curve_compute(self._curve_state(), self.thresholds)

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """The curve (by default ``compute()``), one line per class of a
        per-class curve; ``score`` labels it (``True``: its area); needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(
            (curve[1], curve[0], curve[2]), score=score, ax=ax, label_names=("Recall", "Precision"), name=type(self).__name__
        )


class MulticlassPrecisionRecallCurve(_CurveMetric):
    """Multiclass one-vs-rest PR curves (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassPrecisionRecallCurve
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> m = MulticlassPrecisionRecallCurve(num_classes=3, thresholds=5, device="cpu")
        >>> m.update(preds, target)
        >>> [tuple(v.shape) for v in m.compute()]
        [(3, 6), (3, 6), (5,)]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False
    plot_legend_name = "Class"

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._set_thresholds(_adjust_threshold_arg(thresholds, self.device))
        if self.thresholds is None:
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            # micro flattens one-vs-rest into a single binary curve: binary state
            len_t = len(self.thresholds)
            shape = (len_t, 2, 2) if average == "micro" else (len_t, num_classes, 2, 2)
            self.add_state("confmat", torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, valid, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, None, self.ignore_index, self.average
        )
        if self.thresholds is None:
            p, t = _keep_valid(preds, target, valid)
            self.preds.append(p)
            self.target.append(t)
        else:
            self.confmat = self.confmat + _multiclass_precision_recall_curve_update(
                preds, target, valid, self.num_classes, self.thresholds, self.average, self._sorted_thresholds
            )

    def _curve_state(self):
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat

    def _class_weights(self, state) -> torch.Tensor:
        """Per-class float32 target counts (the ``weighted`` average)."""
        if self.thresholds is None:
            return _class_weights(state[1], torch.ones_like(state[1], dtype=torch.bool), self.num_classes)
        return (self.confmat[0, :, 1, 0] + self.confmat[0, :, 1, 1]).to(torch.float32)

    def compute(self):
        return _multiclass_precision_recall_curve_compute(self._curve_state(), self.num_classes, self.thresholds, self.average)

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """The curve (by default ``compute()``), one line per class of a
        per-class curve; ``score`` labels it (``True``: its area); needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(
            (curve[1], curve[0], curve[2]), score=score, ax=ax, label_names=("Recall", "Precision"), name=type(self).__name__
        )


class MultilabelPrecisionRecallCurve(_CurveMetric):
    """Per-label PR curves (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelPrecisionRecallCurve
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> m = MultilabelPrecisionRecallCurve(num_labels=3, thresholds=5, device="cpu")
        >>> m.update(preds, target)
        >>> [tuple(v.shape) for v in m.compute()]
        [(3, 6), (3, 6), (5,)]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False
    plot_legend_name = "Label"

    def __init__(
        self,
        num_labels: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._set_thresholds(_adjust_threshold_arg(thresholds, self.device))
        if self.thresholds is None:
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
            self.add_state("valid", [], dist_reduce_fx="cat")
        else:
            shape = (len(self.thresholds), num_labels, 2, 2)
            self.add_state("confmat", torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, valid, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, None, self.ignore_index
        )
        if self.thresholds is None:
            self.preds.append(preds)
            self.target.append(target)
            self.valid.append(valid)
        else:
            self.confmat = self.confmat + _multilabel_precision_recall_curve_update(
                preds, target, valid, self.num_labels, self.thresholds, self._sorted_thresholds
            )

    def _curve_state(self):
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat

    def _valid_state(self) -> Optional[torch.Tensor]:
        return dim_zero_cat(self.valid) if self.thresholds is None else None

    def _label_weights(self) -> torch.Tensor:
        """Per-label float32 counts of valid positives (the ``weighted`` average)."""
        if self.thresholds is None:
            return (self._curve_state()[1] * self._valid_state()).sum(0).to(torch.float32)
        return (self.confmat[0, :, 1, 0] + self.confmat[0, :, 1, 1]).to(torch.float32)

    def compute(self):
        return _multilabel_precision_recall_curve_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index, self._valid_state()
        )

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """The curve (by default ``compute()``), one line per class of a
        per-class curve; ``score`` labels it (``True``: its area); needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(
            (curve[1], curve[0], curve[2]), score=score, ax=ax, label_names=("Recall", "Precision"), name=type(self).__name__
        )


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Precision-recall curve of any task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import PrecisionRecallCurve
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> m = PrecisionRecallCurve(task="binary", thresholds=5, device="cpu")
        >>> m.update(preds, target)
        >>> [tuple(v.shape) for v in m.compute()]
        [(6,), (6,), (5,)]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _task_count(task, num_classes, num_labels)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionRecallCurve(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassPrecisionRecallCurve(num_classes, **kwargs)
        return MultilabelPrecisionRecallCurve(num_labels, **kwargs)
