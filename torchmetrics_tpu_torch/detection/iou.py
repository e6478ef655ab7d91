"""The IoU-family metrics as classes: IoU, GIoU, DIoU and CIoU.

One base class parameterised by the pairwise function. The states keep each
image's IoU matrix (with ``invalid_val`` where a pair is below
``iou_threshold`` or, with ``respect_labels``, of different labels) and its
ground-truth labels, as ``None``-reduced list states whose per-image entries
survive a sync (``helpers.sync_keeping_entries``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from torchmetrics_tpu_torch.detection.helpers import (
    _check_items_device,
    _fix_empty_tensors,
    _input_validator,
    _state_tensor,
    sync_keeping_entries,
)
from torchmetrics_tpu_torch.functional.detection.iou import (
    box_convert,
    box_iou,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
)
from torchmetrics_tpu_torch.metric import Metric


class IntersectionOverUnion(Metric):
    """Mean IoU over the box pairs of each image (of matching labels by
    default), with per-class means under ``class_metrics``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import IntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 20.0, 20.0]]),
        ...           "scores": torch.tensor([0.8]), "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 10.0, 22.0, 20.0]]),
        ...            "labels": torch.tensor([0])}]
        >>> iou = IntersectionOverUnion(device="cpu")
        >>> iou.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in iou.compute().items()}
        {'iou': 0.6667}
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True

    _iou_type: str = "iou"
    _invalid_val: float = -1.0
    _pairwise_fn: Callable = staticmethod(box_iou)

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.respect_labels = respect_labels

        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("iou_matrix", default=[], dist_reduce_fx=None)

    def update(self, preds: List[Dict[str, torch.Tensor]], target: List[Dict[str, torch.Tensor]]) -> None:
        _input_validator(preds, target, ignore_score=True)
        _check_items_device(self.device, [*preds, *target], type(self).__name__)
        for p, t in zip(preds, target):
            det_boxes = self._get_safe_item_values(p["boxes"])
            gt_boxes = self._get_safe_item_values(t["boxes"])
            t_labels = _state_tensor(t["labels"], self.device)
            p_labels = _state_tensor(p["labels"], self.device)
            self.groundtruth_labels.append(t_labels)

            iou_matrix = type(self)._pairwise_fn(det_boxes, gt_boxes)  # N x M
            invalid = torch.full_like(iou_matrix, self._invalid_val)
            if self.iou_threshold is not None:
                iou_matrix = torch.where(iou_matrix < self.iou_threshold, invalid, iou_matrix)
            if self.respect_labels and iou_matrix.numel():
                iou_matrix = torch.where(p_labels[:, None] == t_labels[None, :], iou_matrix, invalid)
            self.iou_matrix.append(iou_matrix)

    def _get_safe_item_values(self, boxes) -> torch.Tensor:
        boxes = _fix_empty_tensors(torch.as_tensor(boxes, device=self.device))
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def _sync_states(self, state, reductions, group):
        return sync_keeping_entries(state, reductions, lambda s, r: super(IntersectionOverUnion, self)._sync_states(s, r, group))

    def compute(self) -> dict:
        values = [m.reshape(-1) for m in self.iou_matrix]
        flat = torch.cat(values) if values else torch.zeros(0, device=self.device)
        valid = flat != self._invalid_val
        score = flat[valid].mean() if bool(valid.any()) else torch.tensor(0.0, device=self.device)
        results: Dict[str, torch.Tensor] = {f"{self._iou_type}": score}

        if self.class_metrics and self.groundtruth_labels:
            gt_labels = torch.cat(self.groundtruth_labels)
            classes = torch.unique(gt_labels)
            # each entry's class is its column's ground-truth label; sums in
            # float64 (JAX sums image by image in float32), rounded once
            col_labels = torch.cat([lab[None, :].expand(m.shape[0], -1).reshape(-1)
                                    for m, lab in zip(self.iou_matrix, self.groundtruth_labels)])
            idx = torch.searchsorted(classes, col_labels)
            sums = torch.zeros(classes.numel(), dtype=torch.float64, device=self.device)
            sums.index_add_(0, idx[valid], flat[valid].to(torch.float64))
            observed = torch.zeros(classes.numel(), dtype=torch.int64, device=self.device)
            observed.index_add_(0, idx[valid], torch.ones_like(idx[valid]))
            per_class = sums.to(torch.float32) / observed.to(torch.float32)
            for cl, value in zip(classes.tolist(), per_class):
                results[f"{self._iou_type}/cl_{int(cl)}"] = value
        return results


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """GIoU variant of :class:`IntersectionOverUnion`.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import GeneralizedIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 20.0, 20.0]]),
        ...           "scores": torch.tensor([0.8]), "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 10.0, 22.0, 20.0]]),
        ...            "labels": torch.tensor([0])}]
        >>> m = GeneralizedIntersectionOverUnion(device="cpu")
        >>> m.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in m.compute().items()}
        {'giou': 0.6667}
    """

    _iou_type: str = "giou"
    _invalid_val: float = -1.0
    _pairwise_fn = staticmethod(generalized_box_iou)


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    """DIoU variant of :class:`IntersectionOverUnion`.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import DistanceIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 20.0, 20.0]]),
        ...           "scores": torch.tensor([0.8]), "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 10.0, 22.0, 20.0]]),
        ...            "labels": torch.tensor([0])}]
        >>> m = DistanceIntersectionOverUnion(device="cpu")
        >>> m.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in m.compute().items()}
        {'diou': 0.6503}
    """

    _iou_type: str = "diou"
    _invalid_val: float = -1.0
    _pairwise_fn = staticmethod(distance_box_iou)


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """CIoU variant of :class:`IntersectionOverUnion`.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import CompleteIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 20.0, 20.0]]),
        ...           "scores": torch.tensor([0.8]), "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 10.0, 22.0, 20.0]]),
        ...            "labels": torch.tensor([0])}]
        >>> m = CompleteIntersectionOverUnion(device="cpu")
        >>> m.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in m.compute().items()}
        {'ciou': 0.6503}
    """

    _iou_type: str = "ciou"
    _invalid_val: float = -2.0
    _pairwise_fn = staticmethod(complete_box_iou)
