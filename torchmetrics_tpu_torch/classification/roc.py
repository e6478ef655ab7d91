"""Modular ROC: the precision-recall curve's state holders with the ROC's compute."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds, _task_count
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class BinaryROC(BinaryPrecisionRecallCurve):
    """Binary ROC (modular interface). Returns (fpr, tpr, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryROC
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> m = BinaryROC(thresholds=5, device="cpu")
        >>> m.update(preds, target)
        >>> [[round(x, 4) for x in v.tolist()] for v in m.compute()]
        [[0.0, 0.0, 0.5, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0, 1.0], [1.0, 0.75, 0.5, 0.25, 0.0]]
    """

    def compute(self):
        return _binary_roc_compute(self._curve_state(), self.thresholds)

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """The curve (by default ``compute()``), one line per class of a
        per-class curve; ``score`` labels it (``True``: its area); needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(
            (curve[0], curve[1], curve[2]), score=score, ax=ax, label_names=("FPR", "TPR"), name=type(self).__name__
        )


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """Multiclass one-vs-rest ROC (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassROC
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> m = MulticlassROC(num_classes=3, thresholds=5, device="cpu")
        >>> m.update(preds, target)
        >>> [tuple(v.shape) for v in m.compute()]
        [(3, 5), (3, 5), (5,)]
    """

    def compute(self):
        return _multiclass_roc_compute(self._curve_state(), self.num_classes, self.thresholds, self.average)

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """The curve (by default ``compute()``), one line per class of a
        per-class curve; ``score`` labels it (``True``: its area); needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(
            (curve[0], curve[1], curve[2]), score=score, ax=ax, label_names=("FPR", "TPR"), name=type(self).__name__
        )


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """Per-label ROC (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelROC
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.4, 0.7, 0.3], [0.1, 0.6, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> m = MultilabelROC(num_labels=3, thresholds=5, device="cpu")
        >>> m.update(preds, target)
        >>> [tuple(v.shape) for v in m.compute()]
        [(3, 5), (3, 5), (5,)]
    """

    def compute(self):
        return _multilabel_roc_compute(self._curve_state(), self.num_labels, self.thresholds, self._valid_state())

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """The curve (by default ``compute()``), one line per class of a
        per-class curve; ``score`` labels it (``True``: its area); needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(
            (curve[0], curve[1], curve[2]), score=score, ax=ax, label_names=("FPR", "TPR"), name=type(self).__name__
        )


class ROC(_ClassificationTaskWrapper):
    """ROC of any task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import ROC
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> m = ROC(task="binary", thresholds=5, device="cpu")
        >>> m.update(preds, target)
        >>> [tuple(v.shape) for v in m.compute()]
        [(5,), (5,), (5,)]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _task_count(task, num_classes, num_labels)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryROC(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassROC(num_classes, **kwargs)
        return MultilabelROC(num_labels, **kwargs)
