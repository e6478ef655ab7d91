"""ClasswiseWrapper: label a metric's per-class outputs."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _on_base_device


class ClasswiseWrapper(WrapperMetric):
    """Split a per-class vector output into a labeled dict. Lives on the
    wrapped metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import ClasswiseWrapper
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> wrapped = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> wrapped.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> {k: round(float(v), 4) for k, v in wrapped.compute().items()}
        {'multiclassaccuracy_0': 0.5, 'multiclassaccuracy_1': 1.0, 'multiclassaccuracy_2': 1.0}
    """

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `torchmetrics_tpu_torch.Metric` but got {metric}")
        super().__init__(**_on_base_device(metric.device, kwargs, "ClasswiseWrapper"))
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        self.metric = metric
        self.labels = labels
        self._prefix = prefix
        self._postfix = postfix

    def _convert(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        name = self.metric.__class__.__name__.lower()
        prefix = self._prefix or (name + "_" if self._prefix is None and self._postfix is None else "")
        postfix = self._postfix or ""
        if self.labels is None:
            return {f"{prefix}{i}{postfix}": val for i, val in enumerate(x)}
        return {f"{prefix}{lab}{postfix}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        return self._convert(self.metric(*args, **kwargs))

    def reset(self) -> None:
        self.metric.reset()

    def state(self) -> Dict[str, Any]:
        return self.metric.state()

    def load_state(self, state: Dict[str, Any], update_count: Optional[int] = None) -> None:
        self.metric.load_state(state, update_count=update_count)
        self._computed = None
        self._update_count = self._restored_count(update_count)

    # ------------------------------------------------------ pure/functional API
    # the state IS the base metric's state; only the compute output is relabeled

    def functional_init(self) -> Dict[str, Any]:
        return self.metric.init_state()

    def functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.metric.functional_update(state, *args, **kwargs)

    def functional_sync(self, state: Dict[str, Any], process_group: Any = None) -> Dict[str, Any]:
        return self.metric.functional_sync(state, process_group)

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any], counts: Any = None) -> Dict[str, Any]:
        return self.metric.merge_states(a, b, counts=counts)

    def functional_compute(self, state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self._convert(self.metric.functional_compute(state))
