"""Modular group fairness: per-group int32 tp/fp/tn/fn sums, counted by one
weightless ``bincount`` an update."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.group_fairness import (
    _binary_groups_stat_scores,
    _check_fairness_task,
    _check_num_groups,
    _fairness_compute,
    _group_rates,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


class _AbstractGroupStatScores(Metric):
    """Per-group tp/fp/tn/fn accumulators."""

    def _create_states(self, num_groups: int) -> None:
        for name in ("tp", "fp", "tn", "fn"):
            self.add_state(name, torch.zeros(num_groups, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_states(self, tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> None:
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """Per-group tp/fp/tn/fn rates (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryGroupStatRates
        >>> m = BinaryGroupStatRates(num_groups=2, device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]), torch.tensor([0, 1, 0, 1]))
        >>> {k: v.tolist() for k, v in m.compute().items()}
        {'group_0': [0.0, 0.0, 0.5, 0.5], 'group_1': [0.5, 0.5, 0.0, 0.0]}
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_num_groups(num_groups)
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_states(num_groups)

    def update(self, preds: torch.Tensor, target: torch.Tensor, groups: torch.Tensor) -> None:
        self._update_states(*_binary_groups_stat_scores(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        ))

    def compute(self) -> Dict[str, torch.Tensor]:
        return _group_rates(self.tp, self.fp, self.tn, self.fn)


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and/or equal opportunity ratios (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryFairness
        >>> m = BinaryFairness(num_groups=2, device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]), torch.tensor([0, 1, 0, 1]))
        >>> {k: round(float(v), 4) for k, v in m.compute().items()}
        {'DP_0_1': 0.0, 'EO_0_1': 0.0}
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_fairness_task(task)
        _check_num_groups(num_groups)
        self.task = task
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_states(num_groups)

    def update(self, preds: torch.Tensor, target: Optional[torch.Tensor], groups: torch.Tensor) -> None:
        if self.task == "demographic_parity":
            if target is not None:
                rank_zero_warn("The task demographic_parity does not require a target.", UserWarning)
            target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
        self._update_states(*_binary_groups_stat_scores(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        ))

    def compute(self) -> Dict[str, torch.Tensor]:
        return _fairness_compute(self.task, (self.tp, self.fp, self.tn, self.fn))
