"""Modular calibration error.

The state is a fixed-bin histogram by default (``formulation="binned"``):
per-bin ``(count, conf_sum, acc_sum)`` float32 sums, constant memory however
many samples stream through, built by one K = 3 ``bincount`` a batch with no
read back to the host. ``formulation="samples"`` keeps the growing lists of
valid confidences and accuracies instead; both bin through the same
``_ce_update_binned`` and agree up to float summation order.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.calibration_error import (
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_update,
    _ce_compute,
    _ce_compute_binned,
    _ce_update_binned,
    _multiclass_calibration_error_update,
)
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class _CalibrationMetric(Metric):
    """The calibration state of either formulation, and its update and compute."""

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def _init_calibration(
        self, n_bins: int, norm: str, ignore_index: Optional[int], validate_args: bool, formulation: str
    ) -> None:
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.formulation = formulation
        if formulation == "binned":
            for name in ("bin_count", "bin_conf", "bin_acc"):
                self.add_state(name, torch.zeros(n_bins, dtype=torch.float32), dist_reduce_fx="sum", state_sharding="replicated")
        elif formulation == "samples":
            self.add_state("confidences", [], dist_reduce_fx="cat", state_sharding="replicated")
            self.add_state("accuracies", [], dist_reduce_fx="cat", state_sharding="replicated")
        else:
            raise ValueError(f"Argument `formulation` is expected to be 'binned' or 'samples' but got {formulation}")

    def _accumulate(self, confidences: torch.Tensor, accuracies: torch.Tensor, valid: torch.Tensor) -> None:
        if self.formulation == "binned":
            count, conf, acc = _ce_update_binned(confidences, accuracies, self.n_bins, valid)
            self.bin_count = self.bin_count + count
            self.bin_conf = self.bin_conf + conf
            self.bin_acc = self.bin_acc + acc
        else:
            self.confidences.append(confidences[valid])
            self.accuracies.append(accuracies[valid])

    def compute(self) -> torch.Tensor:
        if self.formulation == "binned":
            return _ce_compute_binned(self.bin_count, self.bin_conf, self.bin_acc, self.norm)
        return _ce_compute(dim_zero_cat(self.confidences), dim_zero_cat(self.accuracies), self.n_bins, self.norm)


class BinaryCalibrationError(_CalibrationMetric):
    """Binary calibration error (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCalibrationError
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> m = BinaryCalibrationError(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.425
    """

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        formulation: str = "binned",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._init_calibration(n_bins, norm, ignore_index, validate_args, formulation)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        self._accumulate(*_binary_calibration_error_update(preds, target, self.ignore_index))


class MulticlassCalibrationError(_CalibrationMetric):
    """Multiclass (top-label) calibration error (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassCalibrationError
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> m = MulticlassCalibrationError(num_classes=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.325
    """

    def __init__(
        self,
        num_classes: int,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        formulation: str = "binned",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._init_calibration(n_bins, norm, ignore_index, validate_args, formulation)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        self._accumulate(*_multiclass_calibration_error_update(preds, target, self.num_classes, self.ignore_index))


class CalibrationError(_ClassificationTaskWrapper):
    """Calibration error of a binary or multiclass task (modular interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import CalibrationError
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> m = CalibrationError(task="multiclass", num_classes=3, device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.325
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return MulticlassCalibrationError(num_classes, **kwargs)
