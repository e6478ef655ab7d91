"""Permutation-invariant training as a class: the mean of the best
permutation's metric over every sample seen."""
from __future__ import annotations

from typing import Any, Callable

import torch

from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from torchmetrics_tpu_torch.metric import Metric

#: the keyword arguments that configure the metric itself; any other goes to ``metric_func``
_METRIC_KWARGS = (
    "device",
    "dist_sync_on_step",
    "process_group",
    "dist_sync_fn",
    "distributed_available_fn",
    "sync_on_compute",
    "compute_with_cache",
    "sync_timeout",
    "on_sync_failure",
    "sync_retries",
)


class PermutationInvariantTraining(Metric):
    """Mean of the best-permutation metric value over every sample seen.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import PermutationInvariantTraining
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> t = torch.arange(0, 0.5, 1 / 800.0)
        >>> target = torch.stack([torch.sin(2 * math.pi * 100 * t), torch.sin(2 * math.pi * 150 * t)])[None]
        >>> preds = target.flip(1) + 0.01 * torch.cos(2 * math.pi * 17 * t)
        >>> m = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        40.0014
    """

    full_state_update = False
    is_differentiable = True
    plot_lower_bound: float = -10.0
    plot_upper_bound: float = 10.0

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _METRIC_KWARGS}
        super().__init__(**base_kwargs)
        if eval_func not in ["max", "min"]:
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        if mode not in ["speaker-wise", "permutation-wise"]:
            raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        pit_metric = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.kwargs
        )[0]
        self.sum_pit_metric = self.sum_pit_metric + pit_metric.sum().to(torch.float32)
        self.total = self.total + pit_metric.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_pit_metric / self.total
