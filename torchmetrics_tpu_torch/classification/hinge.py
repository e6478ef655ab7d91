"""Modular hinge loss: float32 ``measures`` (a scalar, or (C,) in
``one-vs-all`` mode) and ``total`` sums."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.hinge import (
    _binary_hinge_loss_arg_validation,
    _binary_hinge_loss_format,
    _binary_hinge_loss_update,
    _hinge_loss_compute,
    _multiclass_hinge_loss_arg_validation,
    _multiclass_hinge_loss_format,
    _multiclass_hinge_loss_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class BinaryHingeLoss(Metric):
    """Binary hinge loss (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryHingeLoss
        >>> m = BinaryHingeLoss(device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> round(float(m.compute()), 4)
        0.925
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        squared: bool = False,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _binary_hinge_loss_format(preds, target)
        measures, total = _binary_hinge_loss_update(preds, target, self.squared, self.ignore_index)
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _hinge_loss_compute(self.measures, self.total)


class MulticlassHingeLoss(Metric):
    """Multiclass hinge loss (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassHingeLoss
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassHingeLoss(num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.625
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        num_classes: int,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_hinge_loss_arg_validation(squared, multiclass_mode, ignore_index)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        measures = torch.tensor(0.0) if multiclass_mode == "crammer-singer" else torch.zeros(num_classes)
        self.add_state("measures", measures, dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _multiclass_hinge_loss_format(preds, target, self.num_classes)
        measures, total = _multiclass_hinge_loss_update(
            preds, target, self.num_classes, self.squared, self.multiclass_mode, self.ignore_index
        )
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _hinge_loss_compute(self.measures, self.total)


class HingeLoss(_ClassificationTaskWrapper):
    """Hinge loss of a binary or multiclass task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import HingeLoss
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = HingeLoss(task="multiclass", num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.625
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        num_classes: Optional[int] = None,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryHingeLoss(squared, **kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return MulticlassHingeLoss(num_classes, squared, multiclass_mode, **kwargs)
