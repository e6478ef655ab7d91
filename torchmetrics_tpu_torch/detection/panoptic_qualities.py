"""PanopticQuality and ModifiedPanopticQuality as classes.

The states are the four per-category accumulators, summed across
processes: ``iou_sum`` float32 (each update's float64 sum rounded once, as
the JAX package rounds it) and the int32 TP, FP and FN counts. An update
takes one ``bincount`` launch on the card (``functional/detection/
panoptic_quality.py``).
"""
from __future__ import annotations

from typing import Any, Collection

import torch

from torchmetrics_tpu_torch.functional.detection.panoptic_quality import (
    _get_category_id_to_continuous_id,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _preprocess_inputs,
    _validate_inputs,
)
from torchmetrics_tpu_torch.metric import Metric


class PanopticQuality(Metric):
    """Panoptic quality over ``(B, *spatial, 2)`` (category, instance) maps.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import PanopticQuality
        >>> preds = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [1, 0]]])
        >>> target = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [0, 0], [1, 0]]])
        >>> pq = PanopticQuality(things={0}, stuffs={1}, device="cpu")
        >>> pq.update(preds, target)
        >>> round(float(pq.compute()), 4)
        0.5
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        return_sq_and_rq: bool = False,
        return_per_class: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        things, stuffs = _parse_categories(things, stuffs)
        self.things = things
        self.stuffs = stuffs
        self.void_color = _get_void_color(things, stuffs)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
        self.allow_unknown_preds_category = allow_unknown_preds_category
        self.return_sq_and_rq = return_sq_and_rq
        self.return_per_class = return_per_class

        num_categories = len(things) + len(stuffs)
        self.add_state("iou_sum", default=torch.zeros(num_categories), dist_reduce_fx="sum")
        self.add_state("true_positives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_positives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_negatives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_stats(self, preds: torch.Tensor, target: torch.Tensor, modified_metric_stuffs=None) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        _validate_inputs(preds, target)
        flatten_preds = _preprocess_inputs(
            self.things, self.stuffs, preds, self.void_color, self.allow_unknown_preds_category
        )
        flatten_target = _preprocess_inputs(self.things, self.stuffs, target, self.void_color, True)
        iou_sum, tp, fp, fn = _panoptic_quality_update(
            flatten_preds, flatten_target, self.cat_id_to_continuous_id, self.void_color, modified_metric_stuffs
        )
        self.iou_sum = self.iou_sum + iou_sum.to(torch.float32)
        self.true_positives = self.true_positives + tp.to(torch.int32)
        self.false_positives = self.false_positives + fp.to(torch.int32)
        self.false_negatives = self.false_negatives + fn.to(torch.int32)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_stats(preds, target)

    def compute(self) -> torch.Tensor:
        pq, sq, rq, pq_avg, sq_avg, rq_avg = _panoptic_quality_compute(
            self.iou_sum, self.true_positives, self.false_positives, self.false_negatives
        )
        if self.return_per_class:
            if self.return_sq_and_rq:
                return torch.stack((pq, sq, rq), dim=-1)
            return pq.reshape(1, -1)
        if self.return_sq_and_rq:
            return torch.stack((pq_avg, sq_avg, rq_avg))
        return pq_avg


class ModifiedPanopticQuality(PanopticQuality):
    """PQ with the modified stuff rule: a stuff category scores the mean IoU
    of all its overlaps, its TP the number of its target segments.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality
        >>> preds = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [1, 0]]])
        >>> target = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [0, 0], [1, 0]]])
        >>> mpq = ModifiedPanopticQuality(things={0}, stuffs={1}, device="cpu")
        >>> mpq.update(preds, target)
        >>> round(float(mpq.compute()), 4)
        0.625
    """

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            things=things,
            stuffs=stuffs,
            allow_unknown_preds_category=allow_unknown_preds_category,
            **kwargs,
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_stats(preds, target, modified_metric_stuffs=self.stuffs)

    def compute(self) -> torch.Tensor:
        return _panoptic_quality_compute(
            self.iou_sum, self.true_positives, self.false_positives, self.false_negatives
        )[3]
