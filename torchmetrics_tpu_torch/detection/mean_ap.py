"""MeanAveragePrecision: COCO-style mAP and mAR over boxes or masks.

The compute keeps the JAX package's semantics, order and float32 decisions
and runs the heavy part on the metric's device:

- **Pairs.** Every (image, class) with a detection or a ground truth is one
  evaluation pair, image-major and classes ascending, as the JAX package
  builds them. Its detections are ranked by score, ties in index order
  (``np.argsort(-score, kind="stable")``), and truncated at the largest
  ``max_detection_thresholds``. The port builds all pairs at once with
  stable sorts over (image, class, score) on the device and reads back only
  their sizes.
- **Overlaps.** Box IoU and IoA (intersection over the detection's area, the
  crowd overlap) are the JAX package's float32 formulas with their ``1e-7``.
  Mask intersections are formed image by image as float32 products of the
  flattened 0/1 masks in full float32 (TF32 off; 0/1 operands would be exact
  in TF32 too), exact up to 2**24 pixels a mask, with ``clip(1e-9)``
  denominators.
- **Greedy matching.** A loop over detection rank, vectorised over (area
  range, pair, IoU threshold): each detection takes the best free,
  non-ignored ground truth (``argmax``, the first maximum) if its IoU passes
  the float32 threshold; an unmatched detection whose IoA with a crowd
  ground truth passes is ignored. Pairs are grouped into chunks of similar
  size, largest first, whose temporaries stay under ``MATCH_BUDGET_BYTES``
  (a pair larger than the budget alone is a chunk of its own); every pair is
  matched on its own, so the chunking changes no result.
- **Accumulation.** The match and ignore flags of the kept detections, in
  (class, score, pair, rank) order, are read back once; the precision
  envelope, the 101-point interpolation and the summary run in host numpy
  float64, as in the JAX package.

Crowd ground truths (``iscrowd``) never count toward recall and absorb the
detections that overlap them, as in the JAX package.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.detection.helpers import (
    _check_items_device,
    _fix_empty_tensors,
    _input_validator,
    _state_tensor,
    sync_keeping_entries,
)
from torchmetrics_tpu_torch.functional.detection.iou import _inter_union, box_area, box_convert
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.compute import full_float32

#: bytes the matcher's temporaries of one chunk of pairs may take
MATCH_BUDGET_BYTES = 1 << 30

#: reckoned device bytes a kept detection, ground truth and pair hold during
#: a compute, beside the chunk's temporaries (index, key and sort arrays)
_DET_BYTES = 384
_GT_BYTES = 192
_PAIR_BYTES = 128


def _pair_bytes(d: int, g: int, t: int, a: int, masks: bool) -> int:
    """Reckoned peak bytes of one pair's chunk temporaries at ``d``
    detections and ``g`` ground truths: its padded items and index arrays,
    IoU and IoA grids, the larger of the overlap step (box corners, or the
    mask gather's cell indices) and the matcher's step, and its outputs with
    their gathered copies."""
    items = 80 * (d + g)
    grids = 8 * d * g
    overlap = (32 if masks else 40) * d * g
    matcher = 8 * a * t * g + 8 * a * t
    outputs = 8 * a * t * d
    return items + grids + np.maximum(overlap, matcher) + outputs


def _box_iou_ioa(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """(IoU, IoA) of box sets batched over the leading axis, one shared
    intersection: IoA is the intersection over the first box's area."""
    inter, union = _inter_union(boxes1, boxes2)
    return inter / (union + 1e-7), inter / (box_area(boxes1)[..., :, None] + 1e-7)


def _score_order(scores: torch.Tensor) -> torch.Tensor:
    """Indices sorting ``scores`` descending, ties in index order and NaN
    last, as ``np.argsort(-scores, kind="stable")`` orders them (``+ 0.0``
    makes -0.0 equal to 0.0 for the radix sort)."""
    nan = torch.isnan(scores)
    key = torch.where(nan, torch.full_like(scores, -float("inf")), scores) + 0.0
    order = torch.sort(key, descending=True, stable=True).indices
    return order[torch.sort(nan[order].to(torch.uint8), stable=True).indices]


def _greedy_match(ious, ioa, gt_ignore, gt_crowd, det_valid, thresholds):
    """Greedy matching of one chunk of pairs.

    ``ious``/``ioa`` ``(E, D, G)``, ``gt_ignore`` ``(A, E, G)``, ``gt_crowd``
    ``(E, G)``, ``det_valid`` ``(E, D)``, float32 ``thresholds`` ``(T,)``.
    Returns ``(matched, crowd_hit)``, bool ``(A, E, T, D)``."""
    a_n, e_n, g_n = gt_ignore.shape
    d_n, t_n = ious.shape[1], thresholds.numel()
    taken = torch.zeros((a_n, e_n, t_n, g_n), dtype=torch.bool, device=ious.device)
    matched = torch.zeros((a_n, e_n, t_n, d_n), dtype=torch.bool, device=ious.device)
    crowd_hit = torch.zeros_like(matched)
    ignored = gt_ignore[:, :, None, :]
    thr = thresholds[None, None, :]
    crowd_ioa = torch.where(gt_crowd[:, None, :], ioa, torch.zeros_like(ioa)).amax(-1)  # (E, D)
    for d in range(d_n):
        cand = ious[None, :, d, None, :] * ~(taken | ignored)  # (A, E, T, G) float32
        best = cand.argmax(-1, keepdim=True)
        valid = det_valid[None, :, d, None]
        ok = (cand.gather(-1, best)[..., 0] > thr) & valid
        taken |= torch.zeros_like(taken).scatter_(-1, best, ok[..., None])
        matched[..., d] = ok
        crowd_hit[..., d] = (crowd_ioa[None, :, d, None] > thr) & valid & ~ok
    return matched, crowd_hit


class MeanAveragePrecision(Metric):
    """COCO mAP/mAR over box (or mask) detections.

    ``update`` takes the list-of-dicts form: predictions with ``boxes`` (or
    ``masks``), ``scores`` and ``labels``; targets with ``boxes`` (or
    ``masks``), ``labels`` and an optional ``iscrowd``. ``compute`` returns
    the COCO summary dict (map, map_50, map_75, map_small/medium/large,
    mar_1/10/100, mar_small/medium/large, map_per_class, mar_100_per_class,
    classes).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 20.0, 20.0]]),
        ...           "scores": torch.tensor([0.8]), "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 10.0, 22.0, 20.0]]),
        ...            "labels": torch.tensor([0])}]
        >>> m = MeanAveragePrecision(device="cpu")
        >>> m.update(preds, target)
        >>> result = m.compute()
        >>> round(float(result["map"]), 4), round(float(result["map_50"]), 4)
        (0.4, 1.0)
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: str = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        allowed_iou_types = ("segm", "bbox")
        if iou_type not in allowed_iou_types:
            raise ValueError(f"Expected argument `iou_type` to be one of {allowed_iou_types} but got {iou_type}")
        self.iou_type = iou_type
        self.iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, 10).tolist()
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.0, 101).tolist()
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        self.bbox_area_ranges = {
            "all": (float(0**2), float(1e5**2)),
            "small": (float(0**2), float(32**2)),
            "medium": (float(32**2), float(96**2)),
            "large": (float(96**2), float(1e5**2)),
        }

        self.add_state("detections", default=[], dist_reduce_fx=None)
        self.add_state("detection_scores", default=[], dist_reduce_fx=None)
        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruths", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_crowds", default=[], dist_reduce_fx=None)

    def update(self, preds: List[Dict[str, torch.Tensor]], target: List[Dict[str, torch.Tensor]]) -> None:
        _input_validator(preds, target, iou_type=self.iou_type)
        _check_items_device(self.device, [*preds, *target], type(self).__name__)
        key = "boxes" if self.iou_type == "bbox" else "masks"
        for item in preds:
            self.detections.append(self._get_safe_item_values(item[key]))
            self.detection_labels.append(_state_tensor(item["labels"], self.device, torch.int64))
            self.detection_scores.append(_state_tensor(item["scores"], self.device, torch.float32))
        for item in target:
            self.groundtruths.append(self._get_safe_item_values(item[key]))
            labels = _state_tensor(item["labels"], self.device, torch.int64)
            self.groundtruth_labels.append(labels)
            crowds = item.get("iscrowd")
            crowds = torch.zeros(labels.numel(), dtype=torch.bool, device=self.device) if crowds is None else crowds
            self.groundtruth_crowds.append(_state_tensor(crowds, self.device, torch.bool))

    def _get_safe_item_values(self, item) -> torch.Tensor:
        if self.iou_type == "bbox":
            boxes = _fix_empty_tensors(torch.as_tensor(item, device=self.device))
            if boxes.numel() > 0:
                boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
            return boxes.reshape(-1, 4)
        return torch.as_tensor(item, device=self.device).to(torch.bool)

    def _sync_states(self, state, reductions, group):
        return sync_keeping_entries(state, reductions, lambda s, r: super(MeanAveragePrecision, self)._sync_states(s, r, group))

    def _get_classes(self) -> List[int]:
        labels = self.detection_labels + self.groundtruth_labels
        if labels:
            return torch.unique(torch.cat(labels)).tolist()
        return []

    @staticmethod
    def _areas(masks: torch.Tensor) -> torch.Tensor:
        if masks.shape[0] == 0:
            return torch.zeros(0, device=masks.device)
        return masks.reshape(masks.shape[0], -1).sum(-1).to(torch.float32)

    def compute(self) -> dict:
        classes = self._get_classes()
        precision, recall = self._calculate(classes)
        res = self._summarize_results(precision, recall)

        map_per_class = np.full(1, -1.0)
        mar_per_class = np.full(1, -1.0)
        if self.class_metrics and classes:
            maps, mars = [], []
            for ci in range(len(classes)):
                cls_res = self._summarize_results(precision[:, :, ci : ci + 1], recall[:, ci : ci + 1])
                maps.append(cls_res["map"])
                mars.append(cls_res[f"mar_{self.max_detection_thresholds[-1]}"])
            map_per_class = np.asarray(maps)
            mar_per_class = np.asarray(mars)
        out = {k: torch.tensor(v, dtype=torch.float32, device=self.device) for k, v in res.items()}
        out["map_per_class"] = torch.tensor(map_per_class, dtype=torch.float32, device=self.device)
        out[f"mar_{self.max_detection_thresholds[-1]}_per_class"] = torch.tensor(
            mar_per_class, dtype=torch.float32, device=self.device
        )
        out["classes"] = torch.tensor(classes, dtype=torch.int32, device=self.device)
        return out

    # ------------------------------------------------------------ the device part
    def _reckoned_peak_bytes(self) -> int:
        """Upper bound of the device bytes a compute allocates beside the
        states, from the states' shapes alone (no device read): the
        per-detection, per-ground-truth and per-pair arrays at the most pairs
        the images can make, the mask products of the largest image, and one
        chunk of the matcher at the largest pair the images can make, capped
        by ``MATCH_BUDGET_BYTES``."""
        n_det = [d.shape[0] for d in self.detections]
        n_gt = [g.shape[0] for g in self.groundtruths]
        num_t, num_a = len(self.iou_thresholds), len(self.bbox_area_ranges)
        pairs = sum(d + g for d, g in zip(n_det, n_gt))
        d_max = min(max(n_det, default=0), self.max_detection_thresholds[-1])
        g_max = max(n_gt, default=0)
        masks = self.iou_type == "segm"
        per_pair = _pair_bytes(max(d_max, 1), max(g_max, 1), num_t, num_a, masks)
        chunk = min(max(pairs, 1), max(1, MATCH_BUDGET_BYTES // per_pair)) * per_pair
        total = (_DET_BYTES + 4 * num_a * num_t) * sum(n_det) + _GT_BYTES * sum(n_gt) + _PAIR_BYTES * pairs + chunk
        if masks:
            pixels = [
                (d + g) * max([m.shape[1] * m.shape[2] for m in (dm, gm) if m.ndim == 3] or [0])
                for d, g, dm, gm in zip(n_det, n_gt, self.detections, self.groundtruths)
            ]
            total += 5 * max(pixels, default=0) + 4 * sum(d * g for d, g in zip(n_det, n_gt))
        return int(total)

    def _mask_intersections(self):
        """Each image's detection-by-ground-truth mask intersections, flat in
        one float32 buffer (image-major, row-major within an image) with a
        trailing 0 for padded cells, and each image's offset in it."""
        pieces, offsets, at = [], [], 0
        with full_float32():
            for dm, gm in zip(self.detections, self.groundtruths):
                offsets.append(at)
                if dm.shape[0] == 0 or gm.shape[0] == 0:
                    continue
                h, w = max(dm.shape[1], gm.shape[1]), max(dm.shape[2], gm.shape[2])
                m1 = torch.nn.functional.pad(dm, (0, w - dm.shape[2], 0, h - dm.shape[1])) if dm.shape[1:] != (h, w) else dm
                m2 = torch.nn.functional.pad(gm, (0, w - gm.shape[2], 0, h - gm.shape[1])) if gm.shape[1:] != (h, w) else gm
                inter = m1.reshape(m1.shape[0], -1).to(torch.float32) @ m2.reshape(m2.shape[0], -1).to(torch.float32).T
                pieces.append(inter.reshape(-1))
                at += inter.numel()
        pieces.append(torch.zeros(1, device=self.device))
        return torch.cat(pieces), torch.tensor(offsets, dtype=torch.int64, device=self.device)

    def _build_pairs(self, classes: List[int]) -> Optional[SimpleNamespace]:
        """The evaluation pairs and their chunk plan, on the device; the
        pairs' sizes are the one read back. None when there is no image or
        class.

        Detections are kept (``order``: indices into the concatenated
        states) in (pair, score, index) order, truncated at the largest
        max-detection threshold, with their ``pair_of`` and ``rank``; ground
        truths in (pair, index) order (``gt_order``, ``gt_pair_of``,
        ``gt_rank``). ``chunks`` lists ``(first, last, d, g)`` over the pairs
        with detections in size order (``chunk_rank`` of each pair), and
        ``det_sel``/``gt_sel`` with ``det_bounds``/``gt_bounds`` give each
        chunk's detections and ground truths."""
        dev = self.device
        num_img = len(self.groundtruths)
        if num_img == 0 or not classes:
            return None
        num_k, num_t = len(classes), len(self.iou_thresholds)
        num_a = len(self.bbox_area_ranges)
        max_det = self.max_detection_thresholds[-1]
        class_ids = torch.tensor(classes, dtype=torch.int64, device=dev)

        det_n = torch.tensor([d.shape[0] for d in self.detections], dtype=torch.int64, device=dev)
        gt_n = torch.tensor([g.shape[0] for g in self.groundtruths], dtype=torch.int64, device=dev)
        det_img = torch.repeat_interleave(torch.arange(num_img, device=dev), det_n)
        gt_img = torch.repeat_interleave(torch.arange(num_img, device=dev), gt_n)
        det_key = det_img * num_k + torch.searchsorted(class_ids, torch.cat(self.detection_labels))
        gt_key = gt_img * num_k + torch.searchsorted(class_ids, torch.cat(self.groundtruth_labels))
        det_score = torch.cat(self.detection_scores)

        # pairs image-major, classes ascending; detections by (pair, score, index)
        keys = torch.unique(torch.cat([det_key, gt_key]))
        det_pair = torch.searchsorted(keys, det_key)
        order = _score_order(det_score)
        order = order[torch.sort(det_pair[order], stable=True).indices]
        pair_of = det_pair[order]
        det_start = torch.searchsorted(pair_of, torch.arange(keys.numel() + 1, device=dev))
        rank = torch.arange(order.numel(), device=dev) - det_start[pair_of]
        kept = rank < max_det
        order, pair_of, rank = order[kept], pair_of[kept], rank[kept]
        gt_pair = torch.searchsorted(keys, gt_key)
        gt_order = torch.sort(gt_pair, stable=True).indices
        gt_pair_of = gt_pair[gt_order]
        gt_start = torch.searchsorted(gt_pair_of, torch.arange(keys.numel() + 1, device=dev))
        gt_rank = torch.arange(gt_order.numel(), device=dev) - gt_start[gt_pair_of]
        d_cnt = (det_start[1:] - det_start[:-1]).clamp(max=max_det)
        g_cnt = gt_start[1:] - gt_start[:-1]

        # chunks of pairs with detections, largest first, under the budget
        d_host, g_host = (x.cpu().numpy() for x in (d_cnt, g_cnt))
        by_size = np.lexsort((-g_host, -d_host))
        by_size = by_size[d_host[by_size] > 0]
        chunks, at = [], 0
        while at < by_size.size:
            d_c = int(d_host[by_size[at]])
            g_run = np.maximum(np.maximum.accumulate(g_host[by_size[at:]]), 1)
            cost = np.arange(1, g_run.size + 1) * _pair_bytes(d_c, g_run, num_t, num_a, self.iou_type == "segm")
            n = max(1, int(np.searchsorted(cost, MATCH_BUDGET_BYTES, side="right")))
            chunks.append((at, at + n, d_c, int(g_run[n - 1])))
            at += n
        chunk_rank = np.full(d_host.size, -1, dtype=np.int64)
        chunk_rank[by_size] = np.arange(by_size.size)
        chunk_rank = torch.as_tensor(chunk_rank, device=dev)

        # detections and ground truths in chunk order, each chunk contiguous
        det_sel = torch.sort(chunk_rank[pair_of] * (max_det + 1) + rank, stable=True).indices
        det_slot = chunk_rank[pair_of][det_sel]
        gt_sel = torch.nonzero(torch.as_tensor(d_host > 0, device=dev)[gt_pair_of])[:, 0]
        gt_sel = gt_sel[torch.sort(chunk_rank[gt_pair_of[gt_sel]], stable=True).indices]
        gt_slot = chunk_rank[gt_pair_of[gt_sel]]
        bounds = torch.tensor([c[0] for c in chunks] + [by_size.size], dtype=torch.int64, device=dev)
        return SimpleNamespace(
            num_k=num_k, keys=keys, det_img=det_img, gt_img=gt_img, gt_n=gt_n, gt_key=gt_key, det_score=det_score,
            det_first=torch.cumsum(det_n, 0) - det_n, gt_first=torch.cumsum(gt_n, 0) - gt_n,
            order=order, pair_of=pair_of, rank=rank, gt_order=gt_order, gt_pair_of=gt_pair_of, gt_rank=gt_rank,
            chunks=chunks, chunk_rank=chunk_rank, det_sel=det_sel, gt_sel=gt_sel,
            det_bounds=torch.searchsorted(det_slot, bounds).tolist(), gt_bounds=torch.searchsorted(gt_slot, bounds).tolist(),
        )

    def _match(self, classes: List[int]):
        """The device part of the compute: pairs, overlaps, greedy matching.

        Returns host numpy arrays over the kept detections with a score above
        ``-inf``, ordered by (class, score, pair, rank): their class index,
        their rank in their pair, the matched and ignored flags ``(A, T, N)``
        bool; and the non-ignored ground-truth count ``(K, A)`` of every
        class and area range. None when there is no pair."""
        p = self._build_pairs(classes)
        if p is None:
            return None
        dev = self.device
        ranges = list(self.bbox_area_ranges.values())
        num_a, num_t, num_k = len(ranges), len(self.iou_thresholds), p.num_k
        masks = self.iou_type == "segm"
        gt_crowd = torch.cat(self.groundtruth_crowds)
        if masks:
            det_area = torch.cat([self._areas(d) for d in self.detections])
            gt_area = torch.cat([self._areas(g) for g in self.groundtruths])
        else:
            det_boxes = torch.cat(self.detections)
            gt_boxes = torch.cat(self.groundtruths)
            det_area, gt_area = box_area(det_boxes), box_area(gt_boxes)
        thresholds = torch.tensor(self.iou_thresholds, dtype=torch.float32, device=dev)
        lo = torch.tensor([r[0] for r in ranges], dtype=torch.float32, device=dev)
        hi = torch.tensor([r[1] for r in ranges], dtype=torch.float32, device=dev)
        det_out = (det_area[None, :] < lo[:, None]) | (det_area[None, :] > hi[:, None])  # (A, N_all)
        gt_out = (gt_area[None, :] < lo[:, None]) | (gt_area[None, :] > hi[:, None])
        if masks:
            inter_all, inter_at = self._mask_intersections()
            pad_cell = inter_all.numel() - 1

        matched = torch.zeros((num_a, num_t, p.order.numel()), dtype=torch.bool, device=dev)
        ignore = torch.zeros_like(matched)
        for c, (first, last, d_c, g_c) in enumerate(p.chunks):
            e_c = last - first
            dsel = p.det_sel[p.det_bounds[c] : p.det_bounds[c + 1]]  # positions in the kept arrays
            gsel = p.gt_sel[p.gt_bounds[c] : p.gt_bounds[c + 1]]  # positions in the gt-sorted arrays
            d_row, d_col = p.chunk_rank[p.pair_of[dsel]] - first, p.rank[dsel]
            g_row, g_col = p.chunk_rank[p.gt_pair_of[gsel]] - first, p.gt_rank[gsel]
            d_item, g_item = p.order[dsel], p.gt_order[gsel]
            det_valid = torch.zeros((e_c, d_c), dtype=torch.bool, device=dev)
            det_valid[d_row, d_col] = True
            gt_ignore = torch.ones((num_a, e_c, g_c), dtype=torch.bool, device=dev)
            gt_ignore[:, g_row, g_col] = gt_out[:, g_item] | gt_crowd[g_item][None, :]
            crowd = torch.zeros((e_c, g_c), dtype=torch.bool, device=dev)
            crowd[g_row, g_col] = gt_crowd[g_item]
            if masks:
                d_local = torch.full((e_c, d_c), -1, dtype=torch.int64, device=dev)
                d_local[d_row, d_col] = d_item - p.det_first[p.det_img[d_item]]
                g_local = torch.full((e_c, g_c), -1, dtype=torch.int64, device=dev)
                g_local[g_row, g_col] = g_item - p.gt_first[p.gt_img[g_item]]
                img = torch.zeros(e_c, dtype=torch.int64, device=dev)
                img[d_row] = p.det_img[d_item]
                live = (d_local[:, :, None] >= 0) & (g_local[:, None, :] >= 0)
                at_cell = inter_at[img][:, None, None] + d_local[:, :, None] * p.gt_n[img][:, None, None] + g_local[:, None, :]
                inter = inter_all[torch.where(live, at_cell, torch.full_like(at_cell, pad_cell))]
                del at_cell, live
                area_d = torch.zeros((e_c, d_c), device=dev)
                area_d[d_row, d_col] = det_area[d_item]
                area_g = torch.zeros((e_c, g_c), device=dev)
                area_g[g_row, g_col] = gt_area[g_item]
                union = area_d[:, :, None] + area_g[:, None, :] - inter
                ious = inter / union.clamp(min=1e-9)
                del union
                ioa = inter / area_d[:, :, None].clamp(min=1e-9)
                del inter
            else:
                boxes_d = torch.zeros((e_c, d_c, 4), device=dev)
                boxes_d[d_row, d_col] = det_boxes[d_item]
                boxes_g = torch.zeros((e_c, g_c, 4), device=dev)
                boxes_g[g_row, g_col] = gt_boxes[g_item]
                ious, ioa = _box_iou_ioa(boxes_d, boxes_g)
                del boxes_d, boxes_g
            ok, crowd_hit = _greedy_match(ious, ioa, gt_ignore, crowd, det_valid, thresholds)
            del ious, ioa
            # (n, A, T) at each kept detection of the chunk; unmatched
            # out-of-range and crowd-absorbed detections are ignored
            ok_d = ok.permute(1, 3, 0, 2)[d_row, d_col]
            crowd_d = crowd_hit.permute(1, 3, 0, 2)[d_row, d_col]
            out_d = det_out[:, d_item].T[:, :, None]
            matched[:, :, dsel] = ok_d.permute(1, 2, 0)
            ignore[:, :, dsel] = ((~ok_d & out_d) | crowd_d).permute(1, 2, 0)

        # the kept detections with a score above -inf, by (class, score, pair, rank)
        score = p.det_score[p.order]
        cls = p.keys[p.pair_of] % num_k
        take = torch.nonzero(score > -float("inf"))[:, 0]
        final = take[_score_order(score[take])]
        final = final[torch.sort(cls[final], stable=True).indices]
        npig = torch.stack(
            [torch.zeros(num_k, dtype=torch.int64, device=dev).index_add_(
                0, p.gt_key % num_k, (~(gt_out[a] | gt_crowd)).to(torch.int64)) for a in range(num_a)],
            dim=1,
        )
        return (
            cls[final].cpu().numpy(),
            p.rank[final].cpu().numpy(),
            matched[:, :, final].cpu().numpy(),
            ignore[:, :, final].cpu().numpy(),
            npig.cpu().numpy(),
        )

    # --------------------------------------------------------------- the host part
    def _calculate(self, classes: List[int]):
        """Precision (T,R,K,A,M) and recall (T,K,A,M) tables, -1 where undefined."""
        num_t = len(self.iou_thresholds)
        num_r = len(self.rec_thresholds)
        num_k = max(len(classes), 1)
        num_a = len(self.bbox_area_ranges)
        num_m = len(self.max_detection_thresholds)
        precision = -np.ones((num_t, num_r, num_k, num_a, num_m))
        recall = -np.ones((num_t, num_k, num_a, num_m))

        found = self._match(classes)
        if found is None:
            return precision, recall
        det_cls, det_rank, matches, ignores, npig = found
        starts = np.searchsorted(det_cls, np.arange(len(classes) + 1))
        rec_thrs = np.asarray(self.rec_thresholds)
        eps = np.finfo(np.float64).eps
        for ci in range(len(classes)):
            seg = slice(starts[ci], starts[ci + 1])
            rank_c = det_rank[seg]
            for ai in range(num_a):
                n_pos = int(npig[ci, ai])
                if n_pos == 0:
                    continue
                matches_c = matches[ai, :, seg]  # (T, Nc)
                ignore_c = ignores[ai, :, seg]
                for mi, max_det in enumerate(self.max_detection_thresholds):
                    keep = rank_c < max_det
                    flat_matches = matches_c[:, keep]
                    flat_ignore = ignore_c[:, keep]
                    tp_sum = np.cumsum(flat_matches & ~flat_ignore, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(~flat_matches & ~flat_ignore, axis=1).astype(np.float64)
                    rc = tp_sum / n_pos
                    pr = tp_sum / (fp_sum + tp_sum + eps)
                    n = tp_sum.shape[1]
                    recall[:, ci, ai, mi] = rc[:, -1] if n else 0
                    # precision envelope (monotone non-increasing from the right)
                    pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    for ti in range(num_t):
                        inds = np.searchsorted(rc[ti], rec_thrs, side="left")
                        prec = np.zeros(num_r)
                        valid_inds = inds < n
                        prec[valid_inds] = pr[ti, inds[valid_inds]]
                        precision[ti, :, ci, ai, mi] = prec
        return precision, recall

    def _summarize(self, precision, recall, avg_prec=True, iou_threshold=None, area_range="all", max_dets=100):
        area_idx = list(self.bbox_area_ranges.keys()).index(area_range)
        mdet_idx = self.max_detection_thresholds.index(max_dets)
        if avg_prec:
            prec = precision
            if iou_threshold is not None:
                ti = self.iou_thresholds.index(iou_threshold)
                prec = prec[ti : ti + 1]
            prec = prec[:, :, :, area_idx, mdet_idx]
        else:
            prec = recall
            if iou_threshold is not None:
                ti = self.iou_thresholds.index(iou_threshold)
                prec = prec[ti : ti + 1]
            prec = prec[:, :, area_idx, mdet_idx]
        valid = prec[prec > -1]
        return float(valid.mean()) if valid.size else -1.0

    def _summarize_results(self, precision, recall) -> dict:
        last_max_det = self.max_detection_thresholds[-1]
        res = {
            "map": self._summarize(precision, recall, True, max_dets=last_max_det),
            "map_small": self._summarize(precision, recall, True, area_range="small", max_dets=last_max_det),
            "map_medium": self._summarize(precision, recall, True, area_range="medium", max_dets=last_max_det),
            "map_large": self._summarize(precision, recall, True, area_range="large", max_dets=last_max_det),
        }
        res["map_50"] = (
            self._summarize(precision, recall, True, iou_threshold=0.5, max_dets=last_max_det)
            if 0.5 in self.iou_thresholds
            else -1.0
        )
        res["map_75"] = (
            self._summarize(precision, recall, True, iou_threshold=0.75, max_dets=last_max_det)
            if 0.75 in self.iou_thresholds
            else -1.0
        )
        for max_det in self.max_detection_thresholds:
            res[f"mar_{max_det}"] = self._summarize(precision, recall, False, max_dets=max_det)
        res["mar_small"] = self._summarize(precision, recall, False, area_range="small", max_dets=last_max_det)
        res["mar_medium"] = self._summarize(precision, recall, False, area_range="medium", max_dets=last_max_det)
        res["mar_large"] = self._summarize(precision, recall, False, area_range="large", max_dets=last_max_det)
        return res
