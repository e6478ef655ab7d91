"""Modular Cohen's kappa, on the confusion-matrix state."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _single_value_plot
from torchmetrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix
from torchmetrics_tpu_torch.classification.stat_scores import _check_int
from torchmetrics_tpu_torch.functional.classification.cohen_kappa import _check_weights, _cohen_kappa_reduce
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Binary Cohen's kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCohenKappa
        >>> m = BinaryCohenKappa(device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> round(float(m.compute()), 4)
        0.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        if validate_args:
            _check_weights(weights)
        self.weights = weights

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)

    plot = _single_value_plot


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    """Multiclass Cohen's kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassCohenKappa
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassCohenKappa(num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.6364
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        if validate_args:
            _check_weights(weights)
        self.weights = weights

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)

    plot = _single_value_plot


class CohenKappa(_ClassificationTaskWrapper):
    """Task-dispatching Cohen's kappa (binary or multiclass)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        weights: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"weights": weights, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCohenKappa(threshold, **kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            _check_int(num_classes, "num_classes")
            return MulticlassCohenKappa(num_classes, **kwargs)
        raise ValueError(f"Not handled value: {task}")
