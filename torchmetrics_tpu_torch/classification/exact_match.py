"""Modular exact match.

Under ``multidim_average="global"`` the states are int32 sums; under
``"samplewise"`` the per-sample values are ``cat`` lists (multiclass keeps
``total`` a sum, multilabel keeps both as lists), as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoBinary


class MulticlassExactMatch(Metric):
    """Multiclass exact match (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassExactMatch
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassExactMatch(num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
        else:
            self.add_state("correct", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        preds, target = _multiclass_stat_scores_format(preds, target, 1)
        correct, total = _multiclass_exact_match_update(preds, target, self.multidim_average, self.ignore_index)
        if self.multidim_average == "samplewise":
            self.correct.append(correct)
            self.total = self.total + total.sum(dtype=torch.int32)
        else:
            self.correct = self.correct + correct
            self.total = self.total + total

    def compute(self) -> torch.Tensor:
        if self.multidim_average == "samplewise":
            return dim_zero_cat(self.correct).to(torch.float32)
        return _exact_match_reduce(self.correct, self.total)


class MultilabelExactMatch(Metric):
    """Multilabel exact match (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelExactMatch
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> m = MultilabelExactMatch(num_labels=3, device="cpu")
        >>> m.update(preds, torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]]))
        >>> round(float(m.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        else:
            self.add_state("correct", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target, valid = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        correct, total = _multilabel_exact_match_update(preds, target, valid, self.num_labels, self.multidim_average)
        if self.multidim_average == "samplewise":
            self.correct.append(correct)
            self.total.append(total)
        else:
            self.correct = self.correct + correct
            self.total = self.total + total

    def compute(self) -> torch.Tensor:
        if self.multidim_average == "samplewise":
            return _exact_match_reduce(dim_zero_cat(self.correct), dim_zero_cat(self.total))
        return _exact_match_reduce(self.correct, self.total)


class ExactMatch(_ClassificationTaskWrapper):
    """Exact match of a multiclass or multilabel task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import ExactMatch
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = ExactMatch(task="multiclass", num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.75
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoBinary.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassExactMatch(num_classes, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return MultilabelExactMatch(num_labels, threshold, **kwargs)
