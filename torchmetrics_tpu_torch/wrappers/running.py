"""Running: a sliding window over the last ``window`` updates.

One state snapshot per update; compute folds the window's snapshots with the
base metric's merge (count-weighted, so "mean" states average uniformly).
The base metric must have ``full_state_update=False``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import (
    WrapperMetric,
    _first_leaf,
    _on_base_device,
    _require_mergeable_tensor_states,
    _stacked_init,
    _stacked_sync,
    _tree_index,
    _tree_stack,
)


def _fold(base: Metric, states: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-update states oldest to newest with ``counts=(k, 1)``."""
    acc = states[0]
    for k, st in enumerate(states[1:], start=1):
        acc = base.merge_states(acc, st, counts=(k, 1))
    return acc


class Running(WrapperMetric):
    """Sliding-window view of the last ``window`` updates. Lives on the base
    metric's device.

    Example:
        >>> from torchmetrics_tpu_torch.wrappers import Running
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> running = Running(SumMetric(device="cpu"), window=2)
        >>> for v in [1.0, 2.0, 3.0]:
        ...     running.update(v)
        >>> float(running.compute())  # only the last two updates
        5.0
    """

    def __init__(self, base_metric: Metric, window: int = 5, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected argument `metric` to be an instance of `torchmetrics_tpu_torch.Metric` but got {base_metric}"
            )
        super().__init__(**_on_base_device(base_metric.device, kwargs, "Running"))
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        self.base_metric = base_metric
        self.window = window
        if base_metric.full_state_update is not False:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        self._window_states: List[Dict[str, Any]] = []  # ring of state snapshots, newest last

    def _push(self, batch_state: Dict[str, Any]) -> None:
        self._window_states.append(batch_state)
        if len(self._window_states) > self.window:
            self._window_states.pop(0)
        self._computed = None

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Snapshot the state produced by this update alone."""
        self._push(self.base_metric.functional_update(self.base_metric.init_state(), *args, **kwargs))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Batch value; the batch state joins the window."""
        batch_state = self.base_metric.functional_update(self.base_metric.init_state(), *args, **kwargs)
        batch_val = self.base_metric.functional_compute(batch_state)
        self._push(batch_state)
        self._update_count += 1
        return batch_val

    def compute(self) -> Any:
        """Fold the window's states with the base metric's merge."""
        if not self._window_states:
            return self.base_metric.functional_compute(self.base_metric.init_state())
        return self.base_metric.functional_compute(_fold(self.base_metric, self._window_states))

    def reset(self) -> None:
        super().reset()
        self._window_states = []
        self.base_metric.reset()

    def state(self) -> Dict[str, Any]:
        """Live window in the functional ring layout: ``(window, ...)`` slots
        (default-padded at the front, newest last) + total update count.

        List ("cat") state bases cannot stack into a fixed ring (per-slot
        list lengths differ); their window is exported as a ``snapshots``
        list of per-update state dicts instead."""
        base = self.base_metric
        # the count doubles as the ring's validity counter (slot i is valid
        # iff i >= window - min(count, window)); when load_state(...,
        # update_count=) set a lifetime count inconsistent with the ring,
        # export the actual fill instead
        fill = len(self._window_states)
        lifetime = self._update_count
        count = torch.tensor(lifetime if min(lifetime, self.window) == fill else fill, dtype=torch.int32, device=self.device)
        if any(isinstance(d, list) for d in base._defaults.values()):
            return {"snapshots": [dict(s) for s in self._window_states], "count": count}
        pad = [base.init_state() for _ in range(self.window - fill)]
        return {"slots": _tree_stack(pad + list(self._window_states)), "count": count}

    def load_state(self, state: Dict[str, Any], update_count: Optional[int] = None) -> None:
        # the ring's count (valid slots, see state()) decides which slots are
        # restored; an explicit update_count only sets the bookkeeping counter
        count = int(state["count"])
        if "snapshots" in state:
            keep = min(self.window, len(state["snapshots"]))
            self._window_states = [dict(s) for s in state["snapshots"][-keep:]] if keep else []
        else:
            slots = state["slots"]
            # relative to the SOURCE ring's window (its leading dim): real
            # data sits newest-last, front slots are default pads
            src_window = _first_leaf(slots).shape[0]
            n = min(count, src_window, self.window)
            self._window_states = [_tree_index(slots, i) for i in range(src_window - n, src_window)]
        self._update_count = self._restored_count(update_count, fallback=count)
        self._computed = None

    # ------------------------------------------------------ pure/functional API
    #
    # The window is a fixed leading axis: state leaves are ``(window, ...)``
    # rings, an update shifts the newest batch state in (and the oldest out),
    # and compute folds the filled slots oldest to newest. Tensor states only.

    def functional_init(self) -> Dict[str, Any]:
        """Fresh ring state: ``window``-stacked default states + fill count."""
        _require_mergeable_tensor_states(self.base_metric, "Running")
        return {
            "slots": _stacked_init(self.base_metric, self.window),
            "count": torch.tensor(0, dtype=torch.int32, device=self.device),
        }

    def functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update: shift the batch state into the newest ring slot."""
        new_state, _ = self._functional_step(state, *args, **kwargs)
        return new_state

    def functional_forward(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Any:
        """Pure forward: ``(state, batch) -> (state', batch_value)``."""
        return self._functional_step(state, *args, compute_batch=True, **kwargs)

    def _functional_step(self, state: Dict[str, Any], *args: Any, compute_batch: bool = False, **kwargs: Any) -> Any:
        base = self.base_metric
        batch_state = base.functional_update(base.init_state(), *args, **kwargs)
        slots = {k: torch.cat([s[1:], batch_state[k][None]], dim=0) for k, s in state["slots"].items()}
        new_state = {"slots": slots, "count": state["count"] + 1}
        batch_val = base.functional_compute(batch_state) if compute_batch else None
        return new_state, batch_val

    def functional_sync(self, state: Dict[str, Any], process_group: Any = None) -> Dict[str, Any]:
        """Per-slot sync by the base's declared reductions."""
        return {"slots": _stacked_sync(self.base_metric, state["slots"], self.window, process_group), "count": state["count"]}

    def merge_states(self, a: Any, b: Any, counts: Any = None) -> Any:
        raise NotImplementedError(
            "Running state is a sliding-window ring of per-update states; merging two rings"
            " has no defined order. Advance the window with functional_update/functional_forward"
            " instead."
        )

    def functional_compute(self, state: Dict[str, Any]) -> Any:
        """Fold the filled ring slots oldest to newest (count-weighted, as
        :meth:`compute`). Reads the fill count to the host."""
        n_valid = min(int(state["count"]), self.window)
        if n_valid == 0:
            return self.base_metric.functional_compute(self.base_metric.init_state())
        slots = state["slots"]
        return self.base_metric.functional_compute(
            _fold(self.base_metric, [_tree_index(slots, i) for i in range(self.window - n_valid, self.window)])
        )
