"""Modular multilabel ranking metrics: float32 ``measure`` and ``total`` sums."""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.ranking import (
    _coverage_error_update,
    _label_ranking_average_precision_update,
    _label_ranking_loss_update,
    _multilabel_ranking_format,
)
from torchmetrics_tpu_torch.metric import Metric


class _MultilabelRankingBase(Metric):
    is_differentiable = False
    full_state_update: bool = False

    _ranking_update: Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args and (not isinstance(num_labels, int) or num_labels < 2):
            raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _multilabel_ranking_format(preds, target, self.num_labels, self.ignore_index)
        measure, total = self._ranking_update(preds, target)
        self.measure = self.measure + measure
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return self.measure / self.total


class MultilabelCoverageError(_MultilabelRankingBase):
    """Multilabel coverage error (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelCoverageError
        >>> m = MultilabelCoverageError(num_labels=3, device="cpu")
        >>> m.update(torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]]),
        ...          torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]]))
        >>> round(float(m.compute()), 4)
        1.6667
    """

    higher_is_better = False
    _ranking_update = staticmethod(_coverage_error_update)


class MultilabelRankingAveragePrecision(_MultilabelRankingBase):
    """Multilabel label ranking average precision (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelRankingAveragePrecision
        >>> m = MultilabelRankingAveragePrecision(num_labels=3, device="cpu")
        >>> m.update(torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]]),
        ...          torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]]))
        >>> round(float(m.compute()), 4)
        1.0
    """

    higher_is_better = True
    _ranking_update = staticmethod(_label_ranking_average_precision_update)


class MultilabelRankingLoss(_MultilabelRankingBase):
    """Multilabel label ranking loss (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelRankingLoss
        >>> m = MultilabelRankingLoss(num_labels=3, device="cpu")
        >>> m.update(torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]]),
        ...          torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]]))
        >>> round(float(m.compute()), 4)
        0.0
    """

    higher_is_better = False
    _ranking_update = staticmethod(_label_ranking_loss_update)
