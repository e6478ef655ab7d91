"""Aggregation metrics: running sum, mean, max, min and concatenation, and
the windowed RunningMean and RunningSum.

``nan_strategy`` is one of ``"error"`` (raise on a NaN), ``"warn"`` (warn on
rank zero, then drop it), ``"ignore"`` (drop it silently), ``"disable"``
(no check: NaN propagates) or a float that replaces every NaN. As in the
JAX package, a dropped value is replaced by the reduction's neutral element
(0 for sum, mean and cat, -inf for max, +inf for min) rather than removed,
and a dropped value's weight is 0.

States are float32 (RunningMean's window adds a bool mask and an int32
cursor, all reduced with ``None``: a synced window stacks one row per rank).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_NAN_STRATEGIES = ("error", "warn", "ignore", "disable")


def _check_nan_strategy(nan_strategy: Union[str, float]) -> None:
    if nan_strategy not in _NAN_STRATEGIES and not isinstance(nan_strategy, float):
        raise ValueError(
            f"Arg `nan_strategy` should either be a float or one of {_NAN_STRATEGIES} but got {nan_strategy}."
        )


def _report_nans(nan_strategy: Union[str, float], nans: torch.Tensor) -> None:
    """Raise or warn per ``"error"``/``"warn"`` when ``nans`` has any (one host read)."""
    if nan_strategy in ("error", "warn") and bool(nans.any()):
        if nan_strategy == "error":
            raise RuntimeError("Encountered `nan` values in tensor")
        rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)


class BaseAggregator(Metric):
    """Base class for aggregation metrics.

    Args:
        fn: the state's reduction ("sum", "max", "min", "cat" or a callable).
        default_value: the state's default (a tensor, or ``[]``).
        nan_strategy: ``"error"``, ``"warn"``, ``"ignore"``, ``"disable"`` or
            a float replacement value.
        state_name: name of the single state.
    """

    is_differentiable = None
    higher_is_better = None
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[torch.Tensor, List],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_nan_strategy(nan_strategy)
        self.nan_strategy = nan_strategy
        self.state_name = state_name
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn)

    def _nan_neutral(self) -> float:
        """Value that is a no-op for this aggregator's reduction."""
        return 0.0

    def _executor_traceable(self) -> bool:
        """The "error"/"warn" NaN strategies read the values on the host: a
        replay would skip the raise or the warning, so those instances keep
        the eager path (ops/executor.py consults this hook)."""
        return self.nan_strategy not in ("error", "warn")

    def _cast_and_nan_check_input(
        self, x: Union[float, torch.Tensor], weight: Optional[Union[float, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cast the input (and weight) to float32 on the metric's device and
        handle NaNs per the strategy; the weight defaults to ones."""
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        if weight is not None:
            weight = torch.broadcast_to(torch.as_tensor(weight, device=self.device).to(torch.float32), x.shape)
        if self.nan_strategy == "disable":
            return x, (torch.ones_like(x) if weight is None else weight)
        nans = torch.isnan(x)
        if weight is not None:
            nans = nans | torch.isnan(weight)
        _report_nans(self.nan_strategy, nans)
        if isinstance(self.nan_strategy, float):
            x = torch.where(nans, torch.full_like(x, self.nan_strategy), x)
        else:
            if weight is not None:
                weight = torch.where(nans, torch.zeros_like(weight), weight)
            x = torch.where(nans, torch.full_like(x, self._nan_neutral()), x)
        return x, (torch.ones_like(x) if weight is None else weight)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        raise NotImplementedError

    def compute(self) -> torch.Tensor:
        return self._state[self.state_name]


class MaxMetric(BaseAggregator):
    """Running maximum.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MaxMetric
        >>> m = MaxMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> float(m.compute())
        3.0
    """

    full_state_update = True
    higher_is_better = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-torch.inf), nan_strategy, state_name="max_value", **kwargs)

    def _nan_neutral(self) -> float:
        return -float("inf")

    def update(self, value: Union[float, torch.Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.max_value = torch.maximum(self.max_value, value.max())


class MinMetric(BaseAggregator):
    """Running minimum.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MinMetric
        >>> m = MinMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> float(m.compute())
        1.0
    """

    full_state_update = True
    higher_is_better = False

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(torch.inf), nan_strategy, state_name="min_value", **kwargs)

    def _nan_neutral(self) -> float:
        return float("inf")

    def update(self, value: Union[float, torch.Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.min_value = torch.minimum(self.min_value, value.min())


class SumMetric(BaseAggregator):
    """Running sum.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> m = SumMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> float(m.compute())
        6.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="sum_value", **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        self.sum_value = self.sum_value + value.sum()


class CatMetric(BaseAggregator):
    """Concatenation of every value seen.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CatMetric
        >>> m = CatMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> m.compute().tolist()
        [1.0, 2.0, 3.0]
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value.append(value)

    def compute(self) -> torch.Tensor:
        return dim_zero_cat(self.value) if self.value else torch.tensor([], device=self.device)


class MeanMetric(BaseAggregator):
    """Weighted running mean (states ``mean_value``, the weighted sum, and
    ``weight``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric
        >>> m = MeanMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 3.0]))
        >>> m.update(5.0)
        >>> float(m.compute())
        3.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="mean_value", **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, torch.Tensor], weight: Union[float, torch.Tensor] = 1.0) -> None:
        value, weight = self._cast_and_nan_check_input(value, weight)
        self.mean_value = self.mean_value + (value * weight).sum()
        self.weight = self.weight + weight.sum()

    def compute(self) -> torch.Tensor:
        return _safe_divide(self.mean_value, self.weight)


class RunningMean(Metric):
    """Mean over the last ``window`` updates: a ring of per-update means
    with a mask of the slots written.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RunningMean
        >>> m = RunningMean(window=2, device="cpu")
        >>> for v in (1.0, 2.0, 6.0):
        ...     m.update(torch.tensor([v]))
        >>> float(m.compute())
        4.0
    """

    full_state_update = False

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_nan_strategy(nan_strategy)
        self.window = int(window)
        self.nan_strategy = nan_strategy
        self.add_state("values", default=torch.zeros(self.window, dtype=torch.float32), dist_reduce_fx=None)
        self.add_state("mask", default=torch.zeros(self.window, dtype=torch.bool), dist_reduce_fx=None)
        self.add_state("cursor", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx=None)

    def _nan_filter(self, value: Union[float, torch.Tensor]) -> torch.Tensor:
        value = torch.as_tensor(value, device=self.device).to(torch.float32)
        nans = torch.isnan(value)
        if self.nan_strategy in ("error", "warn", "ignore"):
            _report_nans(self.nan_strategy, nans)
            value = torch.where(nans, torch.zeros_like(value), value)
        elif isinstance(self.nan_strategy, float):
            value = torch.where(nans, torch.full_like(value, self.nan_strategy), value)
        return value

    def _put(self, value: torch.Tensor) -> None:
        """Write ``value`` into the cursor's slot (new tensors, no in-place
        write: a compute-group follower may share these states)."""
        slot = torch.arange(self.window, device=self.device) == self.cursor % self.window
        self.values = torch.where(slot, value, self.values)
        self.mask = self.mask | slot
        self.cursor = self.cursor + 1

    def update(self, value: Union[float, torch.Tensor]) -> None:
        self._put(self._nan_filter(value).mean())

    def compute(self) -> torch.Tensor:
        return _safe_divide((self.values * self.mask).sum(), self.mask.sum())


class RunningSum(RunningMean):
    """Sum over the last ``window`` updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RunningSum
        >>> m = RunningSum(window=2, device="cpu")
        >>> for v in (1.0, 2.0, 6.0):
        ...     m.update(torch.tensor([v]))
        >>> float(m.compute())
        8.0
    """

    def update(self, value: Union[float, torch.Tensor]) -> None:
        self._put(self._nan_filter(value).sum())

    def compute(self) -> torch.Tensor:
        return (self.values * self.mask).sum()


__all__ = ["CatMetric", "MaxMetric", "MeanMetric", "MinMetric", "RunningMean", "RunningSum", "SumMetric"]
