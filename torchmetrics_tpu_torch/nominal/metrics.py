"""Nominal association metrics: a ``(C, C)`` contingency table per metric,
summed over updates; FleissKappa concatenates per-batch category counts.

The table is an exact int64 state counted by the ``bincount`` kernel (JAX
keeps it in float32, exact up to 2**24 a cell); ``compute`` forms the
statistics in float32 from it, so below 2**24 a cell the values are JAX's.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.nominal.metrics import (
    _cramers_v_compute,
    _fleiss_kappa_compute,
    _fleiss_kappa_update,
    _nominal_confmat_update,
    _nominal_input_validation,
    _pearsons_contingency_coefficient_compute,
    _theils_u_compute,
    _tschuprows_t_compute,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


class _ConfmatNominalMetric(Metric):
    """Shared state of the chi-square-on-table family: labels in
    ``[0, num_classes)`` (out-of-range labels raise)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_classes, int) and num_classes > 0):
            raise ValueError(f"Argument `num_classes` is expected to be a positive integer, but got {num_classes}")
        self.num_classes = num_classes
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes)), dist_reduce_fx="sum", dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        confmat = _nominal_confmat_update(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)
        self.confmat = self.confmat + confmat


class CramersV(_ConfmatNominalMetric):
    """Cramér's V (modular interface, accumulating across updates).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import CramersV
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0])
        >>> m = CramersV(num_classes=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.6667
    """

    def __init__(self, num_classes: int, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> torch.Tensor:
        return _cramers_v_compute(self.confmat, self.bias_correction)


class TschuprowsT(_ConfmatNominalMetric):
    """Tschuprow's T (modular interface, accumulating across updates).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import TschuprowsT
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0])
        >>> m = TschuprowsT(num_classes=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.6667
    """

    def __init__(self, num_classes: int, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> torch.Tensor:
        return _tschuprows_t_compute(self.confmat, self.bias_correction)


class PearsonsContingencyCoefficient(_ConfmatNominalMetric):
    """Pearson's contingency coefficient (modular interface, accumulating across updates).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import PearsonsContingencyCoefficient
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0])
        >>> m = PearsonsContingencyCoefficient(num_classes=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.7559
    """

    def compute(self) -> torch.Tensor:
        return _pearsons_contingency_coefficient_compute(self.confmat)


class TheilsU(_ConfmatNominalMetric):
    """Theil's U (modular interface, accumulating across updates).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import TheilsU
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0])
        >>> m = TheilsU(num_classes=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.7103
    """

    def compute(self) -> torch.Tensor:
        return _theils_u_compute(self.confmat)


class FleissKappa(Metric):
    """Fleiss' kappa (modular interface, accumulating across updates).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import FleissKappa
        >>> ratings = torch.tensor([[2, 1, 0], [1, 2, 0], [0, 1, 2], [3, 0, 0]])
        >>> m = FleissKappa(device="cpu")
        >>> m.update(ratings)
        >>> round(float(m.compute()), 4)
        0.1818
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ["counts", "probs"]:
            raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'.")
        self.mode = mode
        self.add_state("counts", default=[], dist_reduce_fx="cat")

    def update(self, ratings: torch.Tensor) -> None:
        self.counts.append(_fleiss_kappa_update(ratings, self.mode))

    def compute(self) -> torch.Tensor:
        return _fleiss_kappa_compute(dim_zero_cat(self.counts))
