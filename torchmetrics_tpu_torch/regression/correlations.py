"""Correlations and variance-explained scores as classes.

Pearson and Lin's concordance hold streaming moment states reduced with
``None``: a sync stacks them, one entry a rank, and the compute merges the
stack with the Chan et al. formula. Their count is an exact int64 (float32
in the JAX package). Spearman and Kendall keep every sample in ``cat`` list
states.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.explained_variance import (
    ALLOWED_MULTIOUTPUT,
    _explained_variance_compute,
    _explained_variance_update,
)
from torchmetrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from torchmetrics_tpu_torch.functional.regression.r2 import MULTIOUTPUT, _r2_score_compute, _r2_score_update
from torchmetrics_tpu_torch.functional.regression.rank_based import (
    _concordance_corrcoef_compute,
    _spearman_corrcoef_compute,
    kendall_rank_corrcoef,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


def _check_num_outputs(num_outputs: Any) -> None:
    if not (isinstance(num_outputs, int) and num_outputs > 0):
        raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")


class _MomentStates(Metric):
    """Pearson's six moment states, updated batch by batch."""

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        for name in _MOMENTS[:-1]:
            self.add_state(name, torch.zeros(num_outputs), dist_reduce_fx=None)
        self.add_state("n_total", torch.zeros(num_outputs), dist_reduce_fx=None, dtype=torch.int64)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds = torch.as_tensor(preds).to(torch.float32)
        target = torch.as_tensor(target).to(torch.float32)
        if self.num_outputs == 1 and preds.ndim == 1:
            preds, target = preds[:, None], target[:, None]
        moments = _pearson_corrcoef_update(
            preds, target, *(getattr(self, name) for name in _MOMENTS), self.num_outputs
        )
        for name, value in zip(_MOMENTS, moments):
            setattr(self, name, value)

    def _moments(self):
        """The moments, merged across ranks when a sync stacked them."""
        moments = tuple(getattr(self, name) for name in _MOMENTS)
        return _final_aggregation(*moments) if self.mean_x.ndim > 1 else moments


class PearsonCorrCoef(_MomentStates):
    """Pearson correlation coefficient, one per output with ``num_outputs > 1``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import PearsonCorrCoef
        >>> m = PearsonCorrCoef(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.9849
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        _, _, var_x, var_y, corr_xy, n_total = self._moments()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)


class ConcordanceCorrCoef(_MomentStates):
    """Lin's concordance correlation coefficient, shape ``(num_outputs,)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import ConcordanceCorrCoef
        >>> m = ConcordanceCorrCoef(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.9777
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        return _concordance_corrcoef_compute(*self._moments())


class SpearmanCorrCoef(Metric):
    """Spearman's rank correlation over every sample seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import SpearmanCorrCoef
        >>> m = SpearmanCorrCoef(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.preds.append(torch.as_tensor(preds).to(torch.float32))
        self.target.append(torch.as_tensor(target).to(torch.float32))

    def compute(self) -> torch.Tensor:
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class KendallRankCorrCoef(Metric):
    """Kendall's tau over every sample seen (``t_test=True``: with its p-value).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import KendallRankCorrCoef
        >>> m = KendallRankCorrCoef(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = True
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        variant: str = "b",
        t_test: bool = False,
        alternative: Optional[str] = "two-sided",
        num_outputs: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if variant not in ("a", "b", "c"):
            raise ValueError(f"Argument `variant` is expected to be one of 'a', 'b', 'c' but got {variant}")
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test}.")
        if t_test and alternative not in ("two-sided", "less", "greater"):
            raise ValueError("Argument `alternative` is expected to be one of 'two-sided', 'less', 'greater'")
        self.variant = variant
        self.t_test = t_test
        self.alternative = alternative
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.preds.append(torch.as_tensor(preds).to(torch.float32))
        self.target.append(torch.as_tensor(target).to(torch.float32))

    def compute(self):
        return kendall_rank_corrcoef(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.variant, self.t_test, self.alternative
        )


class R2Score(Metric):
    """R² score (``adjusted`` regressors, ``multioutput`` averaging).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import R2Score
        >>> m = R2Score(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.9486
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        if multioutput not in MULTIOUTPUT:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {MULTIOUTPUT}")
        self.multioutput = multioutput
        self.add_state("sum_squared_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("sum_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("residual", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_squared_obs, sum_obs, residual, num_obs = _r2_score_update(torch.as_tensor(preds), torch.as_tensor(target))
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + residual
        self.total = self.total + num_obs

    def compute(self) -> torch.Tensor:
        # the count read on the host, so the n < 2 and adjusted checks apply
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, int(self.total), self.adjusted, self.multioutput
        )


class ExplainedVariance(Metric):
    """Explained variance (``multioutput`` averaging).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import ExplainedVariance
        >>> m = ExplainedVariance(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.9572
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}")
        self.multioutput = multioutput
        self.add_state("sum_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_target", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_squared_target", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_obs", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        num_obs, sum_error, ss_error, sum_target, ss_target = _explained_variance_update(
            torch.as_tensor(preds), torch.as_tensor(target)
        )
        self.num_obs = self.num_obs + num_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + ss_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + ss_target

    def compute(self) -> torch.Tensor:
        return _explained_variance_compute(
            self.num_obs,
            self.sum_error,
            self.sum_squared_error,
            self.sum_target,
            self.sum_squared_target,
            self.multioutput,
        )
