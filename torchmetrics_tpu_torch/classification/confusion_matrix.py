"""Modular confusion matrices, accumulating int32 counts across updates."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import _check_int, _merge_rows
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_compute,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_compute,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_compute,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import fused_classification as _fused
from torchmetrics_tpu_torch.parallel import class_shard as _class_shard
from torchmetrics_tpu_torch.utils.enums import ClassificationTask
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError


class BinaryConfusionMatrix(Metric):
    """Binary confusion matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryConfusionMatrix
        >>> m = BinaryConfusionMatrix(device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> m.compute().tolist()
        [[1, 1], [1, 1]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False
    lane_compute = "vmap"

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        if _fused.fused_enabled():
            counts = _fused.binary_confusion_counts(preds, target, self.threshold, self.ignore_index)
            self.confmat = self.confmat + counts.to(torch.int32)
            return
        preds, target, valid = _binary_confusion_matrix_format(preds, target, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _binary_confusion_matrix_update(preds, target, valid)

    def functional_update_rows(self, states: Dict[str, Any], *args: Any) -> Dict[str, Any]:
        """R sessions' updates with one row-folded ``bincount`` launch (see
        :meth:`Metric.functional_update_rows`)."""
        if not (len(args) == 2 and _fused.fused_enabled() and self._own_update_is(BinaryConfusionMatrix)):
            return super().functional_update_rows(states, *args)
        preds, target = args
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(_merge_rows(preds), _merge_rows(target), self.ignore_index)
        counts = _fused.binary_confusion_counts_rows(preds, target, self.threshold, self.ignore_index)
        return {**states, "confmat": states["confmat"] + counts.to(torch.int32)}

    def compute(self) -> torch.Tensor:
        return _binary_confusion_matrix_compute(self.confmat, self.normalize)

    def plot(self, val: Optional[torch.Tensor] = None, ax: Any = None, add_text: bool = True, labels: Any = None) -> Any:
        """Heatmap of the matrix (by default ``compute()``); needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels)


class MulticlassConfusionMatrix(Metric):
    """Multiclass confusion matrix (rows: target, columns: prediction).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> m.compute().tolist()
        [[1, 1, 0], [0, 1, 0], [0, 0, 1]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False
    lane_compute = "vmap"

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        if self.state_sharding != "class_axis" and num_classes * num_classes > _fused.ROW_BINS_LIMIT:
            raise TorchMetricsUserError(
                f"MulticlassConfusionMatrix: {num_classes} classes make {num_classes * num_classes} cells,"
                f" more than one dense count holds ({_fused.ROW_BINS_LIMIT}); build it with"
                ' state_sharding="class_axis" (and class_shards=S), which routes each sample'
                " into a (S, ceil(C / S), C) stack instead"
            )
        # a broadcast zero: the class-sharded default stays a broadcast, so
        # only the live state holds memory (the stack is C^2 int32)
        zero = torch.zeros((), dtype=torch.int32, device=self.device).expand(num_classes, num_classes)
        self.add_state("confmat", zero, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        layout = self._class_layout("confmat")
        if layout is not None:
            # class-sharded: route (target, pred, 1) contributions to the shard
            # owning the target's row; the shared dense count is bypassed (it
            # would build the whole C x C grid this layout exists to avoid)
            preds, target, valid = _multiclass_confusion_matrix_format(preds, target, self.ignore_index)
            cols = torch.clamp(preds.to(torch.int64), 0, self.num_classes - 1)
            rows = torch.where(valid, target.to(torch.int64), torch.full_like(cols, -1))
            self.confmat = _class_shard.route_scatter_add(
                self.confmat, rows, torch.ones_like(rows, dtype=torch.int32), inner_idx=cols, layout=layout
            )
            return
        if _fused.fused_enabled():
            counts = _fused.multiclass_confusion_counts(preds, target, self.num_classes, self.ignore_index)
            self.confmat = self.confmat + counts.to(torch.int32)
            return
        preds, target, valid = _multiclass_confusion_matrix_format(preds, target, self.ignore_index)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(preds, target, valid, self.num_classes)

    def functional_update_rows(self, states: Dict[str, Any], *args: Any) -> Dict[str, Any]:
        """R sessions' updates with one row-folded ``bincount`` launch (see
        :meth:`Metric.functional_update_rows`)."""
        if not (
            len(args) == 2
            and _fused.fused_enabled()
            and self._own_update_is(MulticlassConfusionMatrix)
            and self._class_layout("confmat") is None
        ):
            return super().functional_update_rows(states, *args)
        preds, target = args
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(
                _merge_rows(preds), _merge_rows(target), self.num_classes, self.ignore_index
            )
        counts = _fused.multiclass_confusion_counts_rows(preds, target, self.num_classes, self.ignore_index)
        return {**states, "confmat": states["confmat"] + counts.to(torch.int32)}

    def compute(self) -> torch.Tensor:
        confmat = self.confmat
        layout = self._class_layout("confmat")
        if layout is not None:
            confmat = _class_shard.gather_dense(confmat, layout)
        return _multiclass_confusion_matrix_compute(confmat, self.normalize)

    def plot(self, val: Optional[torch.Tensor] = None, ax: Any = None, add_text: bool = True, labels: Any = None) -> Any:
        """Heatmap of the matrix (by default ``compute()``); needs matplotlib."""
        from torchmetrics_tpu_torch.utils.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels)


class MultilabelConfusionMatrix(Metric):
    """Multilabel confusion matrix: one (2, 2) matrix per label."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False
    lane_compute = "vmap"

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        self.num_labels = num_labels
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_labels, 2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multilabel_confusion_matrix_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        layout = self._class_layout("confmat")
        if layout is not None:
            # label-axis sharded: each (sample, label) cell adds 1 to its
            # label shard's 2x2 block at cell target * 2 + pred
            preds, target, valid = _multilabel_confusion_matrix_format(
                preds, target, self.num_labels, self.threshold, self.ignore_index
            )
            p = torch.clamp(preds.to(torch.int64), 0, 1)
            t = torch.clamp(target.to(torch.int64), 0, 1)
            labels = torch.arange(self.num_labels, device=t.device).expand(t.shape)
            rows = torch.where(valid, labels, torch.full_like(labels, -1))
            self.confmat = _class_shard.route_scatter_add(
                self.confmat, rows, torch.ones_like(rows, dtype=torch.int32), inner_idx=t * 2 + p, layout=layout
            )
            return
        if _fused.fused_enabled():
            counts = _fused.multilabel_confusion_counts(
                preds, target, self.num_labels, self.threshold, self.ignore_index
            )
            self.confmat = self.confmat + counts.to(torch.int32)
            return
        preds, target, valid = _multilabel_confusion_matrix_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self.confmat = self.confmat + _multilabel_confusion_matrix_update(preds, target, valid, self.num_labels)

    def functional_update_rows(self, states: Dict[str, Any], *args: Any) -> Dict[str, Any]:
        """R sessions' updates with one row-folded ``bincount`` launch (see
        :meth:`Metric.functional_update_rows`)."""
        if not (
            len(args) == 2
            and _fused.fused_enabled()
            and self._own_update_is(MultilabelConfusionMatrix)
            and self._class_layout("confmat") is None
        ):
            return super().functional_update_rows(states, *args)
        preds, target = args
        if self.validate_args:
            _multilabel_confusion_matrix_tensor_validation(
                _merge_rows(preds), _merge_rows(target), self.num_labels, self.ignore_index
            )
        counts = _fused.multilabel_confusion_counts_rows(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        return {**states, "confmat": states["confmat"] + counts.to(torch.int32)}

    def compute(self) -> torch.Tensor:
        confmat = self.confmat
        layout = self._class_layout("confmat")
        if layout is not None:
            confmat = _class_shard.gather_dense(confmat, layout)
        return _multilabel_confusion_matrix_compute(confmat, self.normalize)


class ConfusionMatrix(_ClassificationTaskWrapper):
    """Task-dispatching confusion matrix."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryConfusionMatrix(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            _check_int(num_classes, "num_classes")
            return MulticlassConfusionMatrix(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            _check_int(num_labels, "num_labels")
            return MultilabelConfusionMatrix(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")
