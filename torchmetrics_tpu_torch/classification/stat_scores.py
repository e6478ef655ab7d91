"""Modular stat-scores metrics.

``multidim_average="global"`` keeps fixed-shape int32 tensor states summed
across updates; ``"samplewise"`` keeps list states concatenated at compute.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    Stats,
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import fused_classification as _fused
from torchmetrics_tpu_torch.parallel import class_shard as _class_shard
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class _AbstractStatScores(Metric):
    """Holds tp/fp/tn/fn states and the shared update plumbing.

    Eligible configurations (``multidim_average="global"``, multiclass
    ``top_k == 1``) derive their counts from the task's shared confusion
    counts (ops/fused_classification.py): in a collection every
    stat-scores-family group and the confusion matrix then accumulate from ONE
    ``bincount`` launch. Bit-exact against the per-metric path, which
    ``TORCHMETRICS_TPU_TORCH_FUSED_CLASSIFICATION=0`` restores.

    With ``state_sharding="class_axis"`` the per-class ``(C,)`` counters live
    as ``(class_shards, ceil(C / S))`` stacks: an update adds its dense
    per-class vectors into the stack (``add_dense``), and the compute
    gathers the dense view once.
    """

    #: the compute is plain tensor operations: laned reads vmap it
    lane_compute = "vmap"

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                default = torch.zeros(size, dtype=torch.int32)
                self.add_state(name, default.squeeze() if size == 1 else default, dist_reduce_fx="sum")

    def _update_state(self, tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> None:
        if isinstance(self._state["tp"], list):
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
            return
        layout = self._class_layout("tp")
        if layout is not None:
            self.tp = _class_shard.add_dense(self.tp, tp, layout)
            self.fp = _class_shard.add_dense(self.fp, fp, layout)
            self.tn = _class_shard.add_dense(self.tn, tn, layout)
            self.fn = _class_shard.add_dense(self.fn, fn, layout)
            return
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn

    def _final_state(self) -> Stats:
        layout = self._class_layout("tp")
        if layout is not None:
            return tuple(_class_shard.gather_dense(self._state[k], layout) for k in ("tp", "fp", "tn", "fn"))  # type: ignore[return-value]
        return tuple(dim_zero_cat(self._state[k]) for k in ("tp", "fp", "tn", "fn"))  # type: ignore[return-value]

    def _rows_batchable(self) -> bool:
        """Whether the row-batched override may stand in for the per-row
        loop: dense states only (a class stack has no row-batched form)."""
        return self._class_layout("tp") is None

    @staticmethod
    def _add_rows(states: Dict[str, Any], tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> Dict[str, Any]:
        """``states`` (R, ...) advanced by per-row (tp, fp, tn, fn), as
        :meth:`_update_state` advances one state."""
        return {**states, "tp": states["tp"] + tp, "fp": states["fp"] + fp, "tn": states["tn"] + tn, "fn": states["fn"] + fn}


def _merge_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-batched inputs ``(R, B, ...)`` as one batch ``(R * B, ...)``: the
    input validation of R batches at once."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


class BinaryStatScores(_AbstractStatScores):
    """Binary tp/fp/tn/fn.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryStatScores
        >>> m = BinaryStatScores(device="cpu")
        >>> m.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> m.compute().tolist()
        [1, 1, 1, 1, 2]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1, multidim_average=multidim_average)

    def _fused_active(self) -> bool:
        return _fused.fused_enabled() and self.multidim_average == "global"

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)
        if self._fused_active():
            confmat = _fused.binary_confusion_counts(preds, target, self.threshold, self.ignore_index)
            tp, fp, tn, fn = _fused.binary_stats(confmat)
        else:
            preds, target, valid = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
            tp, fp, tn, fn = _binary_stat_scores_update(preds, target, valid, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def functional_update_rows(self, states: Dict[str, Any], *args: Any) -> Dict[str, Any]:
        """R sessions' updates with one row-folded ``bincount`` launch (see
        :meth:`Metric.functional_update_rows`)."""
        if not (len(args) == 2 and self._fused_active() and self._own_update_is(BinaryStatScores)):
            return super().functional_update_rows(states, *args)
        preds, target = args
        if self.validate_args:
            _binary_stat_scores_tensor_validation(_merge_rows(preds), _merge_rows(target), self.multidim_average, self.ignore_index)
        confmat = _fused.binary_confusion_counts_rows(preds, target, self.threshold, self.ignore_index)
        return self._add_rows(states, *_fused.binary_stats_rows(confmat))

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _binary_stat_scores_compute(tp, fp, tn, fn, self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    """Multiclass tp/fp/tn/fn.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassStatScores
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> m = MulticlassStatScores(num_classes=3, average="micro", device="cpu")
        >>> m.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> m.compute().tolist()
        [3, 1, 7, 1, 4]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1 if (average == "micro" and top_k == 1) else num_classes, multidim_average=multidim_average)

    def _fused_active(self) -> bool:
        return _fused.fused_enabled() and self.top_k == 1 and self.multidim_average == "global"

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        if self._fused_active():
            tp, fp, tn, fn = _fused.multiclass_stat_counts(preds, target, self.num_classes, self.ignore_index)
        else:
            if self.top_k == 1:
                preds, target = _multiclass_stat_scores_format(preds, target, self.top_k)
            tp, fp, tn, fn = _multiclass_stat_scores_update(
                preds, target, self.num_classes, self.top_k, self.average, self.multidim_average, self.ignore_index
            )
        if self.average == "micro" and self.top_k == 1 and not isinstance(self._state["tp"], list):
            tp, fp, tn, fn = (s.sum(dtype=torch.int32) for s in (tp, fp, tn, fn))
        self._update_state(tp, fp, tn, fn)

    def functional_update_rows(self, states: Dict[str, Any], *args: Any) -> Dict[str, Any]:
        """R sessions' updates with one row-folded ``bincount`` launch (see
        :meth:`Metric.functional_update_rows`)."""
        if not (
            len(args) == 2
            and self._fused_active()
            and self._own_update_is(MulticlassStatScores)
            and self._rows_batchable()
            and self.num_classes**2 <= _fused.ROW_BINS_LIMIT
        ):
            return super().functional_update_rows(states, *args)
        preds, target = args
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                _merge_rows(preds), _merge_rows(target), self.num_classes, self.multidim_average, self.ignore_index
            )
        confmat = _fused.multiclass_confusion_counts_rows(preds, target, self.num_classes, self.ignore_index)
        stats = _fused.multiclass_stats_rows(confmat)
        if self.average == "micro":
            stats = tuple(s.sum(1, dtype=torch.int32) for s in stats)
        return self._add_rows(states, *stats)

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multiclass_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelStatScores(_AbstractStatScores):
    """Multilabel tp/fp/tn/fn."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def _fused_active(self) -> bool:
        return _fused.fused_enabled() and self.multidim_average == "global"

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        if self._fused_active():
            confmat = _fused.multilabel_confusion_counts(
                preds, target, self.num_labels, self.threshold, self.ignore_index
            )
            tp, fp, tn, fn = _fused.multilabel_stats(confmat)
        else:
            preds, target, valid = _multilabel_stat_scores_format(
                preds, target, self.num_labels, self.threshold, self.ignore_index
            )
            tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, valid, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def functional_update_rows(self, states: Dict[str, Any], *args: Any) -> Dict[str, Any]:
        """R sessions' updates with one row-folded ``bincount`` launch (see
        :meth:`Metric.functional_update_rows`)."""
        if not (len(args) == 2 and self._fused_active() and self._own_update_is(MultilabelStatScores) and self._rows_batchable()):
            return super().functional_update_rows(states, *args)
        preds, target = args
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                _merge_rows(preds), _merge_rows(target), self.num_labels, self.multidim_average, self.ignore_index
            )
        confmat = _fused.multilabel_confusion_counts_rows(preds, target, self.num_labels, self.threshold, self.ignore_index)
        return self._add_rows(states, *_fused.multilabel_stats_rows(confmat))

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multilabel_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


def _check_int(value: Any, name: str) -> None:
    if not isinstance(value, int):
        raise ValueError(f"`{name}` is expected to be `int` but `{type(value)} was passed.`")


def _task_dispatch(binary_cls, multiclass_cls, multilabel_cls, cls_name: str, doc: str):
    """A ``_ClassificationTaskWrapper`` subclass whose ``__new__`` returns the
    task's metric (the shape shared by StatScores, Accuracy, Precision, Recall)."""

    def __new__(  # noqa: N807
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: int = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return binary_cls(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            _check_int(num_classes, "num_classes")
            _check_int(top_k, "top_k")
            return multiclass_cls(num_classes, top_k, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            _check_int(num_labels, "num_labels")
            return multilabel_cls(num_labels, threshold, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")

    return type(cls_name, (_ClassificationTaskWrapper,), {"__new__": __new__, "__doc__": doc})


StatScores = _task_dispatch(
    BinaryStatScores, MulticlassStatScores, MultilabelStatScores, "StatScores", "Task-dispatching stat scores."
)
