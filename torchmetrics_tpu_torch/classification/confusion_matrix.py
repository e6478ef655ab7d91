"""Modular confusion matrices, accumulating int32 counts across updates."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import _check_int
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_compute,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_compute,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_compute,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import fused_classification as _fused
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class BinaryConfusionMatrix(Metric):
    """Binary confusion matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryConfusionMatrix
        >>> m = BinaryConfusionMatrix(device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> m.compute().tolist()
        [[1, 1], [1, 1]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        if _fused.fused_enabled():
            counts = _fused.binary_confusion_counts(preds, target, self.threshold, self.ignore_index)
            self.confmat = self.confmat + counts.to(torch.int32)
            return
        preds, target, valid = _binary_confusion_matrix_format(preds, target, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _binary_confusion_matrix_update(preds, target, valid)

    def compute(self) -> torch.Tensor:
        return _binary_confusion_matrix_compute(self.confmat, self.normalize)


class MulticlassConfusionMatrix(Metric):
    """Multiclass confusion matrix (rows: target, columns: prediction).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> m.compute().tolist()
        [[1, 1, 0], [0, 1, 0], [0, 0, 1]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        if _fused.fused_enabled():
            counts = _fused.multiclass_confusion_counts(preds, target, self.num_classes, self.ignore_index)
            self.confmat = self.confmat + counts.to(torch.int32)
            return
        preds, target, valid = _multiclass_confusion_matrix_format(preds, target, self.ignore_index)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(preds, target, valid, self.num_classes)

    def compute(self) -> torch.Tensor:
        return _multiclass_confusion_matrix_compute(self.confmat, self.normalize)


class MultilabelConfusionMatrix(Metric):
    """Multilabel confusion matrix: one (2, 2) matrix per label."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        self.num_labels = num_labels
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_labels, 2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multilabel_confusion_matrix_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        if _fused.fused_enabled():
            counts = _fused.multilabel_confusion_counts(
                preds, target, self.num_labels, self.threshold, self.ignore_index
            )
            self.confmat = self.confmat + counts.to(torch.int32)
            return
        preds, target, valid = _multilabel_confusion_matrix_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self.confmat = self.confmat + _multilabel_confusion_matrix_update(preds, target, valid, self.num_labels)

    def compute(self) -> torch.Tensor:
        return _multilabel_confusion_matrix_compute(self.confmat, self.normalize)


class ConfusionMatrix(_ClassificationTaskWrapper):
    """Task-dispatching confusion matrix."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryConfusionMatrix(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            _check_int(num_classes, "num_classes")
            return MulticlassConfusionMatrix(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            _check_int(num_labels, "num_labels")
            return MultilabelConfusionMatrix(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")
