"""Abstract base for the task-dispatching classification wrappers."""
from typing import Any

from torchmetrics_tpu_torch.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Never instantiated itself: ``__new__`` returns the task's metric."""

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not have an `update` method.")

    def compute(self) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not have a `compute` method.")
