"""MinMaxMetric: track the running min and max of a base metric's value."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.parallel.sync import sync_states
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _on_base_device, _require_mergeable_tensor_states


def _where_tree(cond: torch.Tensor, a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """``where(cond, a, b)`` field by field."""
    return {k: torch.where(cond, a[k], b[k]) for k in b}


class MinMaxMetric(WrapperMetric):
    """Track the running min/max of a base metric's compute. Lives on the
    base metric's device.

    The upstream wrapper loses the base metric's accumulated state after each
    ``forward``; here the base metric's own ``forward`` keeps the
    accumulation, so ``compute()`` after N forwards gives the accumulated
    value, with the same per-forward outputs (the batch value, and extrema
    over the batch values).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MinMaxMetric
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> mm = MinMaxMetric(BinaryAccuracy(device="cpu"))
        >>> mm.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in mm.compute().items()}
        {'raw': 0.5, 'max': 0.5, 'min': 0.5}
    """

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `torchmetrics_tpu_torch.Metric` but received {base_metric}"
            )
        super().__init__(**_on_base_device(base_metric.device, kwargs, "MinMaxMetric"))
        self._base_metric = base_metric
        self.add_state("min_val", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("max_val", torch.tensor(float("-inf")), dist_reduce_fx="max")

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, torch.Tensor]:
        """Batch value + running extrema; the base keeps the accumulation."""
        batch_raw = self._base_metric.forward(*args, **kwargs)
        # the override bypasses Metric.forward's bookkeeping: count the update
        # and drop any cached compute() result here
        self._update_count += 1
        self._computed = None
        self._track(batch_raw)
        return {"raw": torch.as_tensor(batch_raw), "max": self.max_val, "min": self.min_val}

    def _track(self, val: Any) -> None:
        val = self._check_scalar(val).to(torch.float32)
        self.max_val = torch.where(self.max_val < val, val, self.max_val)
        self.min_val = torch.where(self.min_val > val, val, self.min_val)

    def compute(self) -> Dict[str, torch.Tensor]:
        val = self._base_metric.compute()
        self._track(val)
        return {"raw": torch.as_tensor(val), "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()

    def state(self) -> Dict[str, Any]:
        """Live state in the functional layout (base state nested, extrema,
        count), so ``state()``, ``merge_states``, ``functional_compute`` and
        ``load_state`` interoperate."""
        return {
            "base": self._base_metric._copy_state_dict(),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "count": torch.tensor(self._update_count, dtype=torch.int32, device=self.device),
        }

    def load_state(self, state: Dict[str, Any], update_count: Optional[int] = None) -> None:
        # the exported state carries the true count; an explicit update_count
        # overrides it
        count = self._restored_count(update_count, fallback=int(state["count"]))
        self._base_metric.load_state(state["base"], update_count=count)
        self.min_val = torch.as_tensor(state["min_val"], device=self.device)
        self.max_val = torch.as_tensor(state["max_val"], device=self.device)
        self._update_count = count
        self._computed = None

    # ------------------------------------------------------ pure/functional API
    #
    # Extrema move when a value is produced into the state: on
    # ``functional_forward`` (batch values). ``functional_compute`` is a pure
    # read: it folds the accumulated value into the reported extrema but does
    # not persist that fold.

    def functional_init(self) -> Dict[str, Any]:
        """Fresh wrapper state: base metric state + running extrema + count."""
        if self._base_metric.full_state_update is not False:
            raise ValueError(
                "The functional MinMaxMetric path requires a base metric with"
                " full_state_update=False: its update is decomposed into fresh-batch-state"
                f" + merge, but {type(self._base_metric).__name__}.full_state_update is"
                f" {self._base_metric.full_state_update}."
            )
        _require_mergeable_tensor_states(self._base_metric, "MinMaxMetric")
        return {
            "base": self._base_metric.init_state(),
            "min_val": torch.tensor(float("inf"), device=self.device),
            "max_val": torch.tensor(float("-inf"), device=self.device),
            "count": torch.tensor(0, dtype=torch.int32, device=self.device),
        }

    def _absorb(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        base = self._base_metric
        base_batch = base.functional_update(base.init_state(), *args, **kwargs)
        merged = base.merge_states(state["base"], base_batch, counts=(torch.clamp(state["count"], min=1), 1))
        # the first batch REPLACES the default state: a (1, 1)-weighted
        # default would dilute "mean" states
        return base_batch, _where_tree(state["count"] == 0, base_batch, merged)

    def functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update: absorb the batch into the base state (count-weighted);
        extrema move only on forward and compute."""
        _, merged = self._absorb(state, *args, **kwargs)
        return {"base": merged, "min_val": state["min_val"], "max_val": state["max_val"], "count": state["count"] + 1}

    def functional_forward(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Pure forward: ``(state, batch) -> (state', {'raw','min','max'})``."""
        base_batch, merged = self._absorb(state, *args, **kwargs)
        batch_val = self._check_scalar(self._base_metric.functional_compute(base_batch))
        new_min, new_max = self._fold_extrema(state, batch_val)
        new_state = {"base": merged, "min_val": new_min, "max_val": new_max, "count": state["count"] + 1}
        return new_state, {"raw": batch_val, "max": new_max, "min": new_min}

    def functional_sync(self, state: Dict[str, Any], process_group: Any = None) -> Dict[str, Any]:
        """Base state by its own reductions, extrema by min/max, the count
        summed (after a sync the base state holds global totals)."""
        group = process_group if process_group is not None else self.process_group
        extrema = sync_states(
            {"min_val": state["min_val"], "max_val": state["max_val"], "count": state["count"]},
            {"min_val": "min", "max_val": "max", "count": "sum"},
            group,
            timeout=self.sync_timeout,
            device=self.device,
        )
        return {
            "base": self._base_metric.functional_sync(state["base"], process_group),
            "min_val": extrema["min_val"],
            "max_val": extrema["max_val"],
            "count": extrema["count"],
        }

    def functional_compute(self, state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Accumulated base value with extrema folded over it (not persisted)."""
        val = self._check_scalar(self._base_metric.functional_compute(state["base"]))
        new_min, new_max = self._fold_extrema(state, val)
        return {"raw": val, "max": new_max, "min": new_min}

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any], counts: Any = None) -> Dict[str, Any]:
        """Base by its own reductions (weighted by each side's update count),
        extrema by NaN-ignoring min/max. A side that saw no updates
        contributes nothing."""
        na, nb = a["count"], b["count"]
        base = self._base_metric.merge_states(a["base"], b["base"], counts=(torch.clamp(na, min=1), torch.clamp(nb, min=1)))
        base = _where_tree(na == 0, b["base"], base)
        base = _where_tree(nb == 0, a["base"], base)
        return {
            "base": base,
            "min_val": torch.fmin(a["min_val"], b["min_val"]),
            "max_val": torch.fmax(a["max_val"], b["max_val"]),
            "count": na + nb,
        }

    @staticmethod
    def _fold_extrema(state: Dict[str, Any], val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Strict-comparison fold like ``_track``: a NaN value leaves the
        extrema untouched."""
        v = val.to(torch.float32)
        new_min = torch.where(state["min_val"] > v, v, state["min_val"])
        new_max = torch.where(state["max_val"] < v, v, state["max_val"])
        return new_min, new_max

    @staticmethod
    def _check_scalar(raw: Any) -> torch.Tensor:
        """The base value as a 0-d tensor; anything but one element raises."""
        if not (isinstance(raw, (float, int)) or (hasattr(raw, "numel") and raw.numel() == 1)):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {raw}.")
        return torch.as_tensor(raw).reshape(())
