"""PESQ, STOI and SRMR as classes: the mean over every signal seen (a
float32 sum and an exact int64 count). PESQ runs on the host (the port's C++
library); STOI and SRMR on the host in float64, or on the metric's device
with ``on_device=True``."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.functional.audio.srmr import (
    _srmr_arg_validate,
    speech_reverberation_modulation_energy_ratio,
)
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from torchmetrics_tpu_torch.metric import Metric


class PerceptualEvaluationSpeechQuality(Metric):
    """PESQ MOS-LQO averaged over every signal seen; a signal the library
    refuses (NaN) is left out of the sum and the count.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import PerceptualEvaluationSpeechQuality
        >>> t = torch.arange(0, 1.0, 1 / 8000.0)
        >>> target = torch.sin(2 * math.pi * 440 * t)
        >>> preds = target + 0.1 * torch.sin(2 * math.pi * 555 * t)
        >>> m = PerceptualEvaluationSpeechQuality(fs=8000, mode="nb", device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        4.4069
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = -0.5
    plot_upper_bound: float = 4.5

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        if mode == "wb" and fs == 8000:
            raise ValueError("Argument `mode='wb'` requires `fs=16000`")
        self.mode = mode
        if not isinstance(n_processes, int):
            raise ValueError(f"Expected argument `n_processes` to be an int but got {n_processes}")
        self.n_processes = n_processes
        self.add_state("sum_pesq", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        scores = perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode)
        self.sum_pesq = self.sum_pesq + scores.nansum()
        self.total = self.total + (~scores.isnan()).sum()

    def compute(self) -> torch.Tensor:
        return self.sum_pesq / self.total


class ShortTimeObjectiveIntelligibility(Metric):
    """STOI (ESTOI with ``extended=True``) averaged over every signal seen;
    ``on_device=True`` scores on the metric's device.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import ShortTimeObjectiveIntelligibility
        >>> t = torch.arange(0, 1.0, 1 / 8000.0)
        >>> target = torch.sin(2 * math.pi * 440 * t)
        >>> preds = target + 0.1 * torch.sin(2 * math.pi * 555 * t)
        >>> m = ShortTimeObjectiveIntelligibility(fs=8000, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.4784
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, fs: int, extended: bool = False, on_device: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(fs, int) or fs <= 0:
            raise ValueError(f"Expected argument `fs` to be a positive integer, but got {fs}")
        self.fs = fs
        if not isinstance(extended, bool):
            raise ValueError(f"Expected argument `extended` to be a bool, but got {extended}")
        self.extended = extended
        self.on_device = on_device
        self.add_state("sum_stoi", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        scores = short_time_objective_intelligibility(preds, target, self.fs, self.extended, on_device=self.on_device)
        self.sum_stoi = self.sum_stoi + scores.sum()
        self.total = self.total + scores.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_stoi / self.total


class SpeechReverberationModulationEnergyRatio(Metric):
    """SRMR averaged over every signal seen; ``on_device=True`` scores on
    the metric's device.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> m = SpeechReverberationModulationEnergyRatio(fs=8000, device="cpu")
        >>> m.update(preds)
        >>> round(float(m.compute()), 4)
        67.7379
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125,
        min_cf: float = 4,
        max_cf: Optional[float] = None,
        norm: bool = False,
        fast: bool = False,
        on_device: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
        self.fs = fs
        self.n_cochlear_filters = n_cochlear_filters
        self.low_freq = low_freq
        self.min_cf = min_cf
        self.max_cf = max_cf
        self.norm = norm
        self.fast = fast
        self.on_device = on_device
        self.add_state("msum", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor) -> None:
        scores = speech_reverberation_modulation_energy_ratio(
            preds,
            self.fs,
            n_cochlear_filters=self.n_cochlear_filters,
            low_freq=self.low_freq,
            min_cf=self.min_cf,
            max_cf=self.max_cf,
            norm=self.norm,
            fast=self.fast,
            on_device=self.on_device,
        )
        self.msum = self.msum + scores.sum()
        self.total = self.total + scores.numel()

    def compute(self) -> torch.Tensor:
        return self.msum / self.total
