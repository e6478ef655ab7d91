"""MultitaskWrapper: a dict of task name -> metric (or collection)."""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _on_base_device


class MultitaskWrapper(WrapperMetric):
    """Dict of task name -> metric, updated from per-task preds/target dicts.
    Every task's metric lives on one device, which is the wrapper's.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MultitaskWrapper
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> mt = MultitaskWrapper({"cls": BinaryAccuracy(device="cpu"), "reg": MeanSquaredError(device="cpu")})
        >>> mt.update({"cls": preds, "reg": preds}, {"cls": target, "reg": target.float()})
        >>> {k: round(float(v), 4) for k, v in mt.compute().items()}
        {'cls': 0.5, 'reg': 0.2325}
    """

    def __init__(self, task_metrics: Dict[str, Union[Metric, MetricCollection]], **kwargs: Any) -> None:
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not isinstance(metric, (Metric, MetricCollection)):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )
        devices = {m.device for m in task_metrics.values()}
        if len(devices) > 1:
            raise ValueError(f"MultitaskWrapper: the task metrics live on several devices {sorted(map(str, devices))}")
        if devices:
            kwargs = _on_base_device(devices.pop(), kwargs, "MultitaskWrapper")
        super().__init__(**kwargs)
        self.task_metrics = task_metrics

    def items(self):
        return self.task_metrics.items()

    def keys(self):
        return self.task_metrics.keys()

    def values(self):
        return self.task_metrics.values()

    def _check_all_tasks_present(self, task_dict: Dict[str, Any]) -> None:
        if task_dict.keys() != self.task_metrics.keys():
            raise ValueError(
                f"Expected arguments to have the same keys as the wrapped `task_metrics`. Found task_preds/targets keys"
                f" = {task_dict.keys()} and task_metrics.keys() = {self.task_metrics.keys()}"
            )

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        self._check_all_tasks_present(task_preds)
        self._check_all_tasks_present(task_targets)
        for task_name, metric in self.task_metrics.items():
            metric.update(task_preds[task_name], task_targets[task_name])

    def compute(self) -> Dict[str, Any]:
        return {task_name: metric.compute() for task_name, metric in self.task_metrics.items()}

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        self._check_all_tasks_present(task_preds)
        self._check_all_tasks_present(task_targets)
        return {
            task_name: metric(task_preds[task_name], task_targets[task_name])
            for task_name, metric in self.task_metrics.items()
        }

    def reset(self) -> None:
        for metric in self.task_metrics.values():
            metric.reset()
        super().reset()

    # ------------------------------------------------------ pure/functional API
    # states are a dict keyed by task; each task delegates to its metric's (or
    # collection's) own pure functions

    def functional_init(self) -> Dict[str, Any]:
        return {task: m.functional_init() for task, m in self.task_metrics.items()}

    def functional_update(
        self, states: Dict[str, Any], task_preds: Dict[str, Any], task_targets: Dict[str, Any]
    ) -> Dict[str, Any]:
        self._check_all_tasks_present(task_preds)
        self._check_all_tasks_present(task_targets)
        return {
            task: m.functional_update(states[task], task_preds[task], task_targets[task])
            for task, m in self.task_metrics.items()
        }

    def functional_sync(self, states: Dict[str, Any], process_group: Any = None) -> Dict[str, Any]:
        return {task: m.functional_sync(states[task], process_group) for task, m in self.task_metrics.items()}

    def functional_compute(self, states: Dict[str, Any]) -> Dict[str, Any]:
        return {task: m.functional_compute(states[task]) for task, m in self.task_metrics.items()}

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any], counts: Any = None) -> Dict[str, Any]:
        return {task: m.merge_states(a[task], b[task], counts=counts) for task, m in self.task_metrics.items()}

    def state(self) -> Dict[str, Any]:
        return {task: m.state() for task, m in self.task_metrics.items()}

    def load_state(self, states: Dict[str, Any], update_count: Optional[int] = None) -> None:
        for task, m in self.task_metrics.items():
            m.load_state(states[task], update_count=update_count)
        self._computed = None
        self._update_count = self._restored_count(update_count)

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MultitaskWrapper":
        multitask_copy = copy.deepcopy(self)
        if prefix is not None:
            multitask_copy.task_metrics = {prefix + k: v for k, v in multitask_copy.task_metrics.items()}
        if postfix is not None:
            multitask_copy.task_metrics = {k + postfix: v for k, v in multitask_copy.task_metrics.items()}
        return multitask_copy
