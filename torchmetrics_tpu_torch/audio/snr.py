"""SNR, SI-SNR and C-SI-SNR as classes: the mean over every signal seen (a
float32 sum and an exact int64 count)."""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from torchmetrics_tpu_torch.metric import Metric


class SignalNoiseRatio(Metric):
    """Signal-to-noise ratio, averaged over every signal seen.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import SignalNoiseRatio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> m = SignalNoiseRatio(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        20.0
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_snr", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        snr_batch = signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + snr_batch.sum().to(torch.float32)
        self.total = self.total + snr_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_snr / self.total


class ScaleInvariantSignalNoiseRatio(Metric):
    """Scale-invariant signal-to-noise ratio, averaged over every signal seen.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalNoiseRatio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> m = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        20.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = -20.0
    plot_upper_bound: float = 10.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + si_snr_batch.sum().to(torch.float32)
        self.total = self.total + si_snr_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_si_snr / self.total


class ComplexScaleInvariantSignalNoiseRatio(Metric):
    """Complex scale-invariant signal-to-noise ratio, averaged over every
    spectrum seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ComplexScaleInvariantSignalNoiseRatio
        >>> target = torch.stack([torch.cos(torch.arange(20.0)).reshape(4, 5),
        ...                       torch.sin(torch.arange(20.0)).reshape(4, 5)], dim=-1)
        >>> preds = target * 0.9 + 0.01
        >>> m = ComplexScaleInvariantSignalNoiseRatio(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        36.0883
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be an bool, but got {zero_mean}")
        self.zero_mean = zero_mean
        self.add_state("ci_snr_sum", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        v = complex_scale_invariant_signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.ci_snr_sum = self.ci_snr_sum + v.sum().to(torch.float32)
        self.num = self.num + v.numel()

    def compute(self) -> torch.Tensor:
        return self.ci_snr_sum / self.num
