"""SDR, SI-SDR and SA-SDR as classes: the mean over every signal seen (a
float32 sum and an exact int64 count)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from torchmetrics_tpu_torch.metric import Metric


class SignalDistortionRatio(Metric):
    """Signal distortion ratio, averaged over every signal seen.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import SignalDistortionRatio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> m = SignalDistortionRatio(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        21.6644
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = -20.0
    plot_upper_bound: float = 10.0

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr = self.sum_sdr + sdr_batch.sum().to(torch.float32)
        self.total = self.total + sdr_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_sdr / self.total


class ScaleInvariantSignalDistortionRatio(Metric):
    """Scale-invariant signal distortion ratio, averaged over every signal seen.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalDistortionRatio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> m = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        20.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = -20.0
    plot_upper_bound: float = 10.0

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + si_sdr_batch.sum().to(torch.float32)
        self.total = self.total + si_sdr_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_si_sdr / self.total


class SourceAggregatedSignalDistortionRatio(Metric):
    """Source-aggregated signal distortion ratio, averaged over every
    mixture seen.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import SourceAggregatedSignalDistortionRatio
        >>> t = torch.arange(0, 0.5, 1 / 800.0)
        >>> target = torch.stack([torch.sin(2 * math.pi * 100 * t), torch.sin(2 * math.pi * 150 * t)])
        >>> preds = target + 0.05 * torch.cos(2 * math.pi * 17 * t)
        >>> m = SourceAggregatedSignalDistortionRatio(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        26.0254
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = -20.0
    plot_upper_bound: float = 10.0

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        self.scale_invariant = scale_invariant
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean
        self.add_state("msdr_sum", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        msdr = source_aggregated_signal_distortion_ratio(preds, target, self.scale_invariant, self.zero_mean)
        self.msdr_sum = self.msdr_sum + msdr.sum().to(torch.float32)
        self.total = self.total + msdr.numel()

    def compute(self) -> torch.Tensor:
        return self.msdr_sum / self.total
