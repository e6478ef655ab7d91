"""Modular Dice with the legacy averaging options.

States as in the JAX package: per-class int32 tp/fp/fn sums (less the
ignored class), class-summed to one element when ``num_classes`` is None
(so batches may infer different class counts); under ``average="samples"``
or ``mdmc_average="samplewise"`` a ``cat`` list of per-sample scores and
their count.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.dice import (
    _check_dice_average,
    _dice_reduce,
    _dice_stats,
    _samplewise_dice,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


class Dice(Metric):
    """Dice score accumulated over per-class (or single-column) stat scores.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import Dice
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = Dice(device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(m.compute()), 4)
        0.75
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        zero_division: float = 0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_dice_average(average)
        if average in ("macro", "weighted", "none", None) and (num_classes is None or num_classes < 1):
            raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
        if ignore_index is not None and num_classes is not None and not 0 <= ignore_index < num_classes:
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.mdmc_average = mdmc_average
        self.ignore_index = ignore_index
        self.top_k = top_k
        self._samplewise = average == "samples" or mdmc_average == "samplewise"
        if self._samplewise:
            self.add_state("sample_scores", default=[], dist_reduce_fx="cat")
            self.add_state("sample_count", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        else:
            size = 1 if num_classes is None else num_classes - (1 if ignore_index is not None else 0)
            for name in ("tp", "fp", "fn"):
                self.add_state(name, torch.zeros(size, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self._samplewise:
            self.sample_scores.append(_samplewise_dice(
                preds, target, self.zero_division, self.average, self.threshold, self.top_k, self.num_classes,
                self.ignore_index,
            ))
            self.sample_count = self.sample_count + preds.shape[0]
            return
        tp, fp, fn = _dice_stats(preds, target, self.threshold, self.top_k, self.num_classes, self.ignore_index)
        if self.num_classes is None:
            tp, fp, fn = (s.sum(dtype=torch.int32)[None] for s in (tp, fp, fn))
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.fn = self.fn + fn

    def compute(self) -> torch.Tensor:
        if self._samplewise:
            return dim_zero_cat(self.sample_scores).sum(0) / self.sample_count
        return _dice_reduce(self.tp, self.fp, self.fn, self.average, self.zero_division)
