"""Error metrics as classes: sum and count states, summed across processes."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.basic import (
    _check_minkowski_p,
    _check_tweedie_power,
    _critical_success_index_update,
    _log_cosh_error_update,
    _mean_absolute_error_update,
    _mean_absolute_percentage_error_update,
    _mean_squared_error_update,
    _mean_squared_log_error_update,
    _minkowski_distance_update,
    _relative_squared_error_compute,
    _symmetric_mean_absolute_percentage_error_update,
    _tweedie_deviance_score_update,
    _weighted_mean_absolute_percentage_error_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.compute import _at_least_float32, _safe_divide
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


def _check_num_outputs(num_outputs: Any) -> None:
    if not (isinstance(num_outputs, int) and num_outputs > 0):
        raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")


class MeanAbsoluteError(Metric):
    """Mean absolute error, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanAbsoluteError
        >>> m = MeanAbsoluteError(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.5
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("sum_abs_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_abs_error, num_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + num_obs

    def compute(self) -> torch.Tensor:
        return self.sum_abs_error / self.total


class MeanSquaredError(Metric):
    """Mean squared error (its root with ``squared=False``), one per output
    column with ``num_outputs > 1``, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> m = MeanSquaredError(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.375
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("sum_squared_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_squared_error, num_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + num_obs

    def compute(self) -> torch.Tensor:
        mse = self.sum_squared_error / self.total
        return mse if self.squared else torch.sqrt(mse)


class MeanSquaredLogError(Metric):
    """Mean squared log error, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredLogError
        >>> m = MeanSquaredLogError(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.128
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        s, n = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + s
        self.total = self.total + n

    def compute(self) -> torch.Tensor:
        return self.sum_squared_log_error / self.total


class MeanAbsolutePercentageError(Metric):
    """Mean absolute percentage error, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanAbsolutePercentageError
        >>> m = MeanAbsolutePercentageError(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.3274
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        s, n = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + s
        self.total = self.total + n

    def compute(self) -> torch.Tensor:
        return self.sum_abs_per_error / self.total


class SymmetricMeanAbsolutePercentageError(MeanAbsolutePercentageError):
    """Symmetric mean absolute percentage error, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import SymmetricMeanAbsolutePercentageError
        >>> m = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.5788
    """

    plot_upper_bound: float = 2.0

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + s
        self.total = self.total + n


class WeightedMeanAbsolutePercentageError(Metric):
    """Weighted mean absolute percentage error, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import WeightedMeanAbsolutePercentageError
        >>> m = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.16
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_scale", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        s, t = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + s
        self.sum_scale = self.sum_scale + t

    def compute(self) -> torch.Tensor:
        return self.sum_abs_error / torch.clamp(self.sum_scale, min=1.17e-06)


class RelativeSquaredError(Metric):
    """Relative squared error (its root with ``squared=False``), averaged
    over ``num_outputs`` columns, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import RelativeSquaredError
        >>> m = RelativeSquaredError(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.0514
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.squared = squared
        self.add_state("sum_squared_obs", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("sum_obs", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("sum_squared_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds = _at_least_float32(preds)
        target = _at_least_float32(target)
        self.sum_squared_obs = self.sum_squared_obs + (target * target).sum(0)
        self.sum_obs = self.sum_obs + target.sum(0)
        self.sum_squared_error = self.sum_squared_error + ((target - preds) ** 2).sum(0)
        self.total = self.total + target.shape[0]

    def compute(self) -> torch.Tensor:
        return _relative_squared_error_compute(
            self.sum_squared_obs, self.sum_obs, self.sum_squared_error, self.total, self.squared
        )


class LogCoshError(Metric):
    """Mean log-cosh error, one per output column with ``num_outputs > 1``,
    accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import LogCoshError
        >>> m = LogCoshError(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.1685
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        s, n = _log_cosh_error_update(preds, target, self.num_outputs)
        self.sum_log_cosh_error = self.sum_log_cosh_error + s
        self.total = self.total + n

    def compute(self) -> torch.Tensor:
        return (self.sum_log_cosh_error / self.total).squeeze()


class MinkowskiDistance(Metric):
    """Minkowski distance of order ``p >= 1``, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MinkowskiDistance
        >>> m = MinkowskiDistance(p=3, device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        1.0772
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_minkowski_p(p)
        self.p = p
        self.add_state("minkowski_dist_sum", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.minkowski_dist_sum = self.minkowski_dist_sum + _minkowski_distance_update(preds, target, self.p)

    def compute(self) -> torch.Tensor:
        return self.minkowski_dist_sum ** (1.0 / self.p)


class TweedieDevianceScore(Metric):
    """Mean Tweedie deviance at ``power``, accumulated over updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import TweedieDevianceScore
        >>> m = TweedieDevianceScore(device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        0.375
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_tweedie_power(power)
        self.power = power
        self.add_state("sum_deviance_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_observations", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        s, n = _tweedie_deviance_score_update(preds, target, self.power)
        self.sum_deviance_score = self.sum_deviance_score + s
        self.num_observations = self.num_observations + n

    def compute(self) -> torch.Tensor:
        return self.sum_deviance_score / self.num_observations


class CriticalSuccessIndex(Metric):
    """Critical success index at ``threshold``, accumulated over updates.
    With ``keep_sequence_dim`` the counts are list states, one entry a step
    of that dimension, and the index comes per step.

    The summed counts are int32 states, as the JAX package declares them;
    an update's counts are formed in int64.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import CriticalSuccessIndex
        >>> m = CriticalSuccessIndex(threshold=0.5, device="cpu")
        >>> m.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(m.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, threshold: float, keep_sequence_dim: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(threshold, (int, float)):
            raise ValueError(f"Expected argument `threshold` to be a float but got {threshold}")
        self.threshold = float(threshold)
        if keep_sequence_dim is not None and (not isinstance(keep_sequence_dim, int) or keep_sequence_dim < 0):
            raise ValueError(f"Expected argument `keep_sequence_dim` to be an int but got {keep_sequence_dim}")
        self.keep_sequence_dim = keep_sequence_dim
        for name in ("hits", "misses", "false_alarms"):
            if keep_sequence_dim is None:
                self.add_state(name, torch.tensor(0), dist_reduce_fx="sum")
            else:
                self.add_state(name, [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        counts = _critical_success_index_update(preds, target, self.threshold, self.keep_sequence_dim)
        for name, count in zip(("hits", "misses", "false_alarms"), counts):
            if self.keep_sequence_dim is None:
                setattr(self, name, getattr(self, name) + count.to(torch.int32))
            else:
                getattr(self, name).append(count)

    def compute(self) -> torch.Tensor:
        if self.keep_sequence_dim is None:
            hits, misses, false_alarms = self.hits, self.misses, self.false_alarms
        else:
            hits, misses, false_alarms = (dim_zero_cat(s) for s in (self.hits, self.misses, self.false_alarms))
        return _safe_divide(hits, hits + misses + false_alarms)
