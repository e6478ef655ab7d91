"""MetricTracker: a metric (or collection) tracked over steps or epochs.

``increment()`` starts a fresh copy of the base for a new step;
``compute_all`` and ``best_metric`` read across the steps.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


class MetricTracker:
    """Track a metric (or collection) over epochs/steps.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MetricTracker
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> tracker = MetricTracker(BinaryAccuracy(device="cpu"))
        >>> for epoch in range(2):
        ...     tracker.increment()
        ...     tracker.update(preds, target)
        >>> round(float(tracker.best_metric()), 4)
        0.5
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool], None] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a torchmetrics_tpu_torch"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        if maximize is not None:
            if not isinstance(maximize, (bool, list)):
                raise ValueError("Argument `maximize` should either be a single bool or list of bool")
            if isinstance(maximize, list) and not all(isinstance(m, bool) for m in maximize):
                raise ValueError("Argument `maximize` should either be a single bool or list of bool")
            if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
                raise ValueError("The len of argument `maximize` should match the length of the metric collection")
            if isinstance(metric, Metric) and not isinstance(maximize, bool):
                raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
        elif isinstance(metric, Metric):
            maximize = bool(metric.higher_is_better)
        else:
            maximize = [bool(m.higher_is_better) for m in metric.values()]
        self.maximize = maximize
        self._steps: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        return len(self._steps)

    def increment(self) -> None:
        """Start a fresh copy of the base metric for a new step."""
        self._increment_called = True
        self._steps.append(deepcopy(self._base_metric))
        self._steps[-1].reset()

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._steps[-1].update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._steps[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._steps[-1].compute()

    def compute_all(self) -> Any:
        """Every step's value, stacked along a leading step axis."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._steps]
        if isinstance(self._base_metric, MetricCollection):
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in res[0]}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def reset(self) -> None:
        self._steps[-1].reset()

    def reset_all(self) -> None:
        for metric in self._steps:
            metric.reset()

    def state(self) -> Dict[str, Any]:
        """Per-step states (each step in the base metric's layout)."""
        return {"steps": [m.state() for m in self._steps]}

    def load_state(self, state: Dict[str, Any], update_count: Optional[int] = None) -> None:
        # update_count is accepted for signature uniformity only: each step
        # carries its own count
        del update_count
        # build every step before swapping them in, so a bad step state
        # raises without leaving a half-loaded tracker
        new_steps: List[Union[Metric, MetricCollection]] = []
        for st in state["steps"]:
            m = deepcopy(self._base_metric)
            m.reset()
            m.load_state(st)
            new_steps.append(m)
        self._steps = new_steps
        self._increment_called = bool(self._steps)

    @staticmethod
    def _best(values: torch.Tensor, maximize: bool) -> Tuple[float, int]:
        """The best value and its step (reads both to the host)."""
        idx = int(torch.argmax(values)) if maximize else int(torch.argmin(values))
        return float(values[idx]), idx

    def best_metric(
        self, return_step: bool = False
    ) -> Union[float, Tuple[float, int], Dict[str, float], Tuple[Dict[str, float], Dict[str, int]]]:
        """Best value (and optionally step) over the tracked steps; a value
        with no single best (a per-class vector) warns and gives None."""
        res = self.compute_all()
        # a vector per step has no single best: the flat argmax runs past the
        # steps (IndexError) or picks a vector (ValueError)
        errors = (ValueError, TypeError, IndexError)
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            values, steps = {}, {}
            for (k, v), m in zip(res.items(), maximize):
                try:
                    values[k], steps[k] = self._best(v, m)
                except errors as error:
                    rank_zero_warn(
                        f"Encountered the following error when trying to get the best metric for metric {k}: {error}"
                    )
                    values[k], steps[k] = None, None
            return (values, steps) if return_step else values
        try:
            value, step = self._best(res, bool(self.maximize))
        except errors as error:
            rank_zero_warn(f"Encountered the following error when trying to get the best metric: {error}")
            value, step = None, None
        return (value, step) if return_step else value

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot tracked values over steps (by default ``compute_all()``): one
        line per metric for a tracked collection, one series otherwise;
        needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute_all()
        return plot_single_or_multi_val(val, ax=ax, name=type(self._base_metric).__name__)
