"""MultioutputWrapper: one copy of a metric per output dimension.

Each output's slice is taken with ``narrow`` (a view), and rows holding a NaN
in any input are dropped with a boolean mask built and applied on the
inputs' device: no input is copied to the host.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import (
    WrapperMetric,
    _load_stacked_state,
    _on_base_device,
    _stacked_init,
    _stacked_state,
    _stacked_sync,
    _tree_stack,
    _unstack,
)


def _get_nan_indices(*tensors: torch.Tensor) -> torch.Tensor:
    """Rows containing a NaN in any tensor (a boolean mask on their device)."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    sentinel = tensors[0]
    nan_idxs = torch.zeros(sentinel.shape[0], dtype=torch.bool, device=sentinel.device)
    for tensor in tensors:
        permuted = tensor.reshape(tensor.shape[0], -1)
        nan_idxs = nan_idxs | torch.isnan(permuted).any(dim=1)
    return nan_idxs


def _is_batched(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim > 0


class MultioutputWrapper(WrapperMetric):
    """Apply a metric independently per output dimension (last axis by
    default). Lives on the base metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MultioutputWrapper
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> mo = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
        >>> mo.update(torch.tensor([[1.0, 2.0], [3.0, 4.0]]), torch.tensor([[1.0, 1.0], [4.0, 3.0]]))
        >>> mo.compute().tolist()
        [0.5, 1.0]
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**_on_base_device(base_metric.device, kwargs, "MultioutputWrapper"))
        self.metrics: List[Metric] = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[List[Any], Dict[str, Any]]]:
        """Each output's slice of the inputs, NaN rows dropped and the output
        axis squeezed as configured."""
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            selected_args = [a.narrow(self.output_dim, i, 1) if _is_batched(a) else a for a in args]
            selected_kwargs = {k: (v.narrow(self.output_dim, i, 1) if _is_batched(v) else v) for k, v in kwargs.items()}
            if self.remove_nans:
                tensors = [a for a in selected_args if _is_batched(a)] + [v for v in selected_kwargs.values() if _is_batched(v)]
                if tensors:
                    keep = ~_get_nan_indices(*tensors)
                    selected_args = [a[keep] if _is_batched(a) else a for a in selected_args]
                    selected_kwargs = {k: (v[keep] if _is_batched(v) else v) for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [a.squeeze(self.output_dim) if _is_batched(a) else a for a in selected_args]
                selected_kwargs = {k: (v.squeeze(self.output_dim) if _is_batched(v) else v) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        reshaped = self._get_args_kwargs_by_output(*args, **kwargs)
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> torch.Tensor:
        return torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], 0)

    def forward(self, *args: Any, **kwargs: Any) -> Optional[torch.Tensor]:
        reshaped = self._get_args_kwargs_by_output(*args, **kwargs)
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped)
        ]
        if any(r is None for r in results):
            return None
        return torch.stack([torch.as_tensor(r) for r in results], 0)

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        super().reset()

    # ------------------------------------------------------ pure/functional API
    #
    # State leaves carry a leading ``num_outputs`` axis. NaN-row removal
    # changes shapes per output, so it stays on the stateful path: construct
    # with ``remove_nans=False`` to use the functional API.

    def functional_init(self) -> Dict[str, Any]:
        """Fresh default state with a leading ``num_outputs`` axis per leaf."""
        return _stacked_init(self.metrics[0], len(self.metrics))

    def _per_output(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> List[Tuple[List[Any], Dict[str, Any]]]:
        """Each output's inputs: the output axis moved to the front and indexed."""
        def prep(x: Any) -> Any:
            if _is_batched(x):
                moved = torch.movedim(x, self.output_dim, 0)
                if moved.shape[0] != len(self.metrics):
                    raise ValueError(
                        f"Expected {len(self.metrics)} outputs along dim {self.output_dim} but got {moved.shape[0]}"
                    )
                return moved
            return x

        args = [prep(a) for a in args]
        kwargs = {k: prep(v) for k, v in kwargs.items()}
        return [
            ([a[i] if _is_batched(a) else a for a in args], {k: (v[i] if _is_batched(v) else v) for k, v in kwargs.items()})
            for i in range(len(self.metrics))
        ]

    def functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update over the output axis: ``(stacked_state, batch) -> stacked_state'``."""
        if self.remove_nans:
            raise ValueError(
                "The functional path requires remove_nans=False: NaN-row removal changes shapes"
                " per output and cannot be traced. Construct MultioutputWrapper(..., remove_nans=False)."
            )
        if not self.squeeze_outputs:
            raise ValueError(
                "The functional path requires squeeze_outputs=True: mapping over the output"
                " axis always removes it, so a kept size-1 axis cannot be honored."
            )
        base = self.metrics[0]
        per_output = self._per_output(args, kwargs)
        return _tree_stack([
            base.functional_update(st, *a, **kw) for st, (a, kw) in zip(_unstack(state, len(self.metrics)), per_output)
        ])

    def functional_sync(self, state: Dict[str, Any], process_group: Any = None) -> Dict[str, Any]:
        """Per-output sync by the base's declared reductions."""
        return _stacked_sync(self.metrics[0], state, len(self.metrics), process_group)

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any], counts: Any = None) -> Dict[str, Any]:
        """Output-wise merge: sum/mean/max/min folds are elementwise, so the
        base metric's merge applies directly to the stacked leaves."""
        return self.metrics[0].merge_states(a, b, counts=counts)

    def state(self) -> Any:
        """Live per-output states in the functional stacked layout (or a
        ``replicates`` snapshot list for list-state bases)."""
        return _stacked_state(self.metrics)

    def load_state(self, state: Any, update_count: Optional[int] = None) -> None:
        _load_stacked_state(self.metrics, state, update_count=update_count)
        self._computed = None
        self._update_count = self._restored_count(update_count)

    def functional_compute(self, state: Dict[str, Any]) -> torch.Tensor:
        """Stacked per-output values, matching :meth:`compute`'s layout."""
        base = self.metrics[0]
        return _tree_stack([base.functional_compute(st) for st in _unstack(state, len(self.metrics))])
