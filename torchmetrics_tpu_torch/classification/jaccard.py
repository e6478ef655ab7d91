"""Modular Jaccard index (IoU)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _check_int,
)
from torchmetrics_tpu_torch.functional.classification.jaccard import _jaccard_index_reduce
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class BinaryJaccardIndex(BinaryStatScores):
    """Binary Jaccard index."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold=threshold, multidim_average="global", ignore_index=ignore_index, validate_args=validate_args, **kwargs)

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _jaccard_index_reduce(tp, fp, tn, fn, average="binary")


class MulticlassJaccardIndex(MulticlassStatScores):
    """Multiclass Jaccard index (mean IoU with ``average="macro"``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassJaccardIndex
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassJaccardIndex(num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        if validate_args and average not in ("micro", "macro", "weighted", "none", None):
            raise ValueError(f"Expected argument `average` to be one of ['micro','macro','weighted','none',None] but got {average}")
        # always keep per-class states so ignore_index/micro masking happens at compute
        super().__init__(
            num_classes=num_classes,
            top_k=1,
            average="none",
            multidim_average="global",
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )
        self.average_jaccard = average

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _jaccard_index_reduce(tp, fp, tn, fn, average=self.average_jaccard, ignore_index=self.ignore_index)


class MultilabelJaccardIndex(MultilabelStatScores):
    """Multilabel Jaccard index."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels,
            threshold=threshold,
            average="none" if average in (None, "none", "macro", "weighted") else average,
            multidim_average="global",
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )
        self.average_jaccard = average

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _jaccard_index_reduce(tp, fp, tn, fn, average=self.average_jaccard)


class JaccardIndex(_ClassificationTaskWrapper):
    """Task-dispatching Jaccard index."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryJaccardIndex(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            _check_int(num_classes, "num_classes")
            return MulticlassJaccardIndex(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            _check_int(num_labels, "num_labels")
            return MultilabelJaccardIndex(num_labels, threshold, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")
