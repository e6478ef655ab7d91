"""Elementary error metrics: MAE, MSE, MSLE, MAPE, SMAPE, WMAPE, RSE,
LogCosh, Minkowski distance, Tweedie deviance and the critical success
index. Each is an ``_update`` (sums and counts, the class states) and a
compute (a division); every function runs on its inputs' device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _at_least_float32, _safe_divide, _safe_xlogy

Count = Union[int, torch.Tensor]


def _pair(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same-shape inputs, at least float32."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _check_same_shape(preds, target)
    return _at_least_float32(preds), _at_least_float32(target)


# ------------------------------------------------------------------------ MAE
def _mean_absolute_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    preds, target = _pair(preds, target)
    return (preds - target).abs().sum(), preds.numel()


def _mean_absolute_error_compute(sum_abs_error: torch.Tensor, num_obs: Count) -> torch.Tensor:
    return sum_abs_error / num_obs


def mean_absolute_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_absolute_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(mean_absolute_error(preds, target)), 4)
        0.5
    """
    return _mean_absolute_error_compute(*_mean_absolute_error_update(preds, target))


# ------------------------------------------------------------------------ MSE
def _mean_squared_error_update(
    preds: torch.Tensor, target: torch.Tensor, num_outputs: int
) -> Tuple[torch.Tensor, int]:
    """Sum of squared errors (per output when ``num_outputs > 1``) and the
    count of rows (or of elements)."""
    preds, target = _pair(preds, target)
    if num_outputs == 1:
        preds, target = preds.reshape(-1), target.reshape(-1)
    diff = preds - target
    if num_outputs > 1:
        return (diff * diff).sum(0), target.shape[0]
    return (diff * diff).sum(), target.numel()


def _mean_squared_error_compute(sum_squared_error: torch.Tensor, num_obs: Count, squared: bool = True) -> torch.Tensor:
    mse = sum_squared_error / num_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(
    preds: torch.Tensor, target: torch.Tensor, squared: bool = True, num_outputs: int = 1
) -> torch.Tensor:
    """Mean squared error, or its root with ``squared=False``; one per output
    column with ``num_outputs > 1``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_squared_error
        >>> round(float(mean_squared_error(torch.tensor([1., 2., 3.]), torch.tensor([1., 2., 5.]))), 4)
        1.3333
    """
    sum_squared_error, num_obs = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, num_obs, squared)


# ----------------------------------------------------------------------- MSLE
def _mean_squared_log_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    preds, target = _pair(preds, target)
    return ((torch.log1p(preds) - torch.log1p(target)) ** 2).sum(), preds.numel()


def mean_squared_log_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared log error, ``mean((log1p(preds) - log1p(target))²)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_squared_log_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(mean_squared_log_error(preds, target)), 4)
        0.128
    """
    s, n = _mean_squared_log_error_update(preds, target)
    return s / n


# ----------------------------------------------------------------------- MAPE
def _mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = 1.17e-06
) -> Tuple[torch.Tensor, int]:
    preds, target = _pair(preds, target)
    abs_per_error = (preds - target).abs() / torch.clamp(target.abs(), min=epsilon)
    return abs_per_error.sum(), preds.numel()


def mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute percentage error (the target's magnitude floored at 1.17e-6).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(mean_absolute_percentage_error(preds, target)), 4)
        0.3274
    """
    s, n = _mean_absolute_percentage_error_update(preds, target)
    return s / n


# ---------------------------------------------------------------------- SMAPE
def _symmetric_mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = 1.17e-06
) -> Tuple[torch.Tensor, int]:
    preds, target = _pair(preds, target)
    abs_per_error = (preds - target).abs() / torch.clamp(target.abs() + preds.abs(), min=epsilon)
    return 2 * abs_per_error.sum(), preds.numel()


def symmetric_mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Symmetric mean absolute percentage error, in [0, 2].

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import symmetric_mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(symmetric_mean_absolute_percentage_error(preds, target)), 4)
        0.5788
    """
    s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return s / n


# ---------------------------------------------------------------------- WMAPE
def _weighted_mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    preds, target = _pair(preds, target)
    return (preds - target).abs().sum(), target.abs().sum()


def weighted_mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Weighted mean absolute percentage error, ``Σ|preds - target| / Σ|target|``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import weighted_mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(weighted_mean_absolute_percentage_error(preds, target)), 4)
        0.16
    """
    s, t = _weighted_mean_absolute_percentage_error_update(preds, target)
    return s / torch.clamp(t, min=1.17e-06)


# ------------------------------------------------------------------------ RSE
def _relative_squared_error_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    sum_squared_error: torch.Tensor,
    num_obs: Count,
    squared: bool = True,
) -> torch.Tensor:
    """``Σ(y − ŷ)² / Σ(y − ȳ)²`` per output, averaged over the outputs."""
    denom = sum_squared_obs - sum_obs * sum_obs / num_obs
    rse = sum_squared_error / denom
    if not squared:
        rse = torch.sqrt(rse)
    return rse.mean()


def relative_squared_error(preds: torch.Tensor, target: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """Relative squared error, or its root with ``squared=False``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import relative_squared_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(relative_squared_error(preds, target)), 4)
        0.0514
    """
    preds, target = _pair(preds, target)
    sum_squared_obs = (target * target).sum(0)
    sum_obs = target.sum(0)
    sum_squared_error = ((target - preds) ** 2).sum(0)
    return _relative_squared_error_compute(sum_squared_obs, sum_obs, sum_squared_error, target.shape[0], squared)


# -------------------------------------------------------------------- LogCosh
def _log_cosh_error_update(preds: torch.Tensor, target: torch.Tensor, num_outputs: int) -> Tuple[torch.Tensor, int]:
    preds, target = _pair(preds, target)
    if num_outputs == 1:
        preds, target = preds.reshape(-1), target.reshape(-1)
    diff = preds - target
    # log(cosh(x)) = x + softplus(-2x) - log 2, stable at any |x|
    vals = diff + torch.logaddexp(-2 * diff, torch.zeros_like(diff)) - math.log(2.0)
    return vals.sum(0), preds.shape[0]


def log_cosh_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean of ``log(cosh(preds - target))``, one per output column of 2-D inputs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import log_cosh_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(log_cosh_error(preds, target)), 4)
        0.1685
    """
    preds = torch.as_tensor(preds)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[1]
    s, n = _log_cosh_error_update(preds, target, num_outputs)
    return (s / n).squeeze()


# ------------------------------------------------------------------ Minkowski
def _check_minkowski_p(p: float, name: str = "p") -> None:
    if not (isinstance(p, (float, int)) and p >= 1):
        raise ValueError(f"Argument ``{name}`` expected to be a float larger than 1, but got {p}")


def _minkowski_distance_update(preds: torch.Tensor, target: torch.Tensor, p: float) -> torch.Tensor:
    preds, target = _pair(preds, target)
    _check_minkowski_p(p)
    return ((preds - target).abs() ** p).sum()


def minkowski_distance(preds: torch.Tensor, target: torch.Tensor, p: float) -> torch.Tensor:
    """Minkowski distance ``(Σ|preds - target|^p)^(1/p)``, ``p >= 1``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import minkowski_distance
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(minkowski_distance(preds, target, p=3)), 4)
        1.0772
    """
    return _minkowski_distance_update(preds, target, p) ** (1.0 / p)


# ------------------------------------------------------------------- Tweedie
def _check_tweedie_power(power: float) -> None:
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")


def _tweedie_deviance_score_update(
    preds: torch.Tensor, target: torch.Tensor, power: float = 0.0
) -> Tuple[torch.Tensor, int]:
    preds, target = _pair(preds, target)
    _check_tweedie_power(power)
    if power == 0:
        deviance_score = (preds - target) ** 2
    elif power == 1:
        deviance_score = 2 * (_safe_xlogy(target, target / preds) + preds - target)
    elif power == 2:
        deviance_score = 2 * (torch.log(preds / target) + target / preds - 1)
    else:  # power < 0 or power > 1, power != 2
        deviance_score = 2 * (
            torch.pow(torch.clamp(target, min=0), 2 - power) / ((1 - power) * (2 - power))
            - target * torch.pow(preds, 1 - power) / (1 - power)
            + torch.pow(preds, 2 - power) / (2 - power)
        )
    return deviance_score.sum(), preds.numel()


def tweedie_deviance_score(preds: torch.Tensor, target: torch.Tensor, power: float = 0.0) -> torch.Tensor:
    """Mean Tweedie deviance at ``power`` (0: squared error, 1: Poisson, 2:
    gamma; undefined in (0, 1)).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tweedie_deviance_score
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(tweedie_deviance_score(preds, target)), 4)
        0.375
    """
    s, n = _tweedie_deviance_score_update(preds, target, power)
    return s / n


# ------------------------------------------------------------------------ CSI
def _critical_success_index_update(
    preds: torch.Tensor, target: torch.Tensor, threshold: float, keep_sequence_dim: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int64 hits, misses and false alarms at ``threshold``, summed over
    everything or over every dimension but ``keep_sequence_dim``."""
    preds, target = _pair(preds, target)
    pred_bin = preds >= threshold
    target_bin = target >= threshold
    masks = (pred_bin & target_bin, ~pred_bin & target_bin, pred_bin & ~target_bin)
    if keep_sequence_dim is None:
        return tuple(m.sum() for m in masks)
    dims = tuple(d for d in range(preds.ndim) if d != keep_sequence_dim)
    return tuple(m.sum(dims) for m in masks)


def critical_success_index(
    preds: torch.Tensor, target: torch.Tensor, threshold: float, keep_sequence_dim: Optional[int] = None
) -> torch.Tensor:
    """Critical success index ``hits / (hits + misses + false alarms)`` at
    ``threshold``; one per step of ``keep_sequence_dim`` when given.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import critical_success_index
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(critical_success_index(preds, target, threshold=0.5)), 4)
        1.0
    """
    hits, misses, false_alarms = _critical_success_index_update(preds, target, threshold, keep_sequence_dim)
    return _safe_divide(hits, hits + misses + false_alarms)
