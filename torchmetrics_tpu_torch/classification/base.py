"""Abstract base for the task-dispatching classification wrappers, and the
value plot of scalar-valued curve and confusion-matrix subclasses."""
from typing import Any

from torchmetrics_tpu_torch.metric import Metric


def _single_value_plot(self: Metric, val: Any = None, ax: Any = None) -> Any:
    """The value plot, for scalar-valued subclasses of the curve and
    confusion-matrix classes, whose inherited curve or heatmap plot does
    not fit their ``compute()``."""
    return self._plot(val, ax)


class _ClassificationTaskWrapper(Metric):
    """Never instantiated itself: ``__new__`` returns the task's metric."""

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not have an `update` method.")

    def compute(self) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not have a `compute` method.")
