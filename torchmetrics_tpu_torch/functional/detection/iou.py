"""Box algebra and the IoU family: IoU, GIoU, DIoU and CIoU.

Boxes are ``(x1, y1, x2, y2)`` rows in float32; every pairwise function
takes ``(N, 4)`` and ``(M, 4)`` and returns ``(N, M)`` on the boxes' device.
The epsilons are the JAX package's: ``_EPS`` in every denominator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_EPS = 1e-7


def _as_boxes(boxes) -> torch.Tensor:
    return torch.as_tensor(boxes, dtype=torch.float32)


def box_convert(boxes, in_fmt: str, out_fmt: str = "xyxy") -> torch.Tensor:
    """Convert between the xyxy, xywh and cxcywh box formats."""
    boxes = _as_boxes(boxes)
    if in_fmt == out_fmt:
        return boxes
    if in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        boxes = torch.stack([x, y, x + w, y + h], dim=-1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    elif in_fmt != "xyxy":
        raise ValueError(f"Unknown box format {in_fmt}")
    if out_fmt == "xyxy":
        return boxes
    x1, y1, x2, y2 = boxes.unbind(-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    if out_fmt == "cxcywh":
        return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)
    raise ValueError(f"Unknown box format {out_fmt}")


def box_area(boxes) -> torch.Tensor:
    boxes = _as_boxes(boxes)
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _inter_union(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Intersections and unions of every pair, over the last two axes
    (leading axes batch)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter, union


def _pairwise_inputs(boxes1, boxes2):
    return _as_boxes(boxes1).reshape(-1, 4), _as_boxes(boxes2).reshape(-1, 4)


def box_iou(boxes1, boxes2) -> torch.Tensor:
    boxes1, boxes2 = _pairwise_inputs(boxes1, boxes2)
    inter, union = _inter_union(boxes1, boxes2)
    return inter / (union + _EPS)


def _hull(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Width and height of each pair's enclosing box."""
    lt = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    return (rb - lt).clamp(min=0)


def generalized_box_iou(boxes1, boxes2) -> torch.Tensor:
    """GIoU: IoU - (hull minus union) / hull."""
    boxes1, boxes2 = _pairwise_inputs(boxes1, boxes2)
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / (union + _EPS)
    wh = _hull(boxes1, boxes2)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / (hull + _EPS)


def _diag_and_center_dist(boxes1: torch.Tensor, boxes2: torch.Tensor):
    wh = _hull(boxes1, boxes2)
    diag = wh[..., 0] ** 2 + wh[..., 1] ** 2 + _EPS
    c1 = (boxes1[:, :2] + boxes1[:, 2:]) / 2
    c2 = (boxes2[:, :2] + boxes2[:, 2:]) / 2
    d = c1[:, None, :] - c2[None, :, :]
    dist = d[..., 0] ** 2 + d[..., 1] ** 2
    return diag, dist


def distance_box_iou(boxes1, boxes2) -> torch.Tensor:
    """DIoU: IoU - squared centre distance / squared enclosing diagonal."""
    boxes1, boxes2 = _pairwise_inputs(boxes1, boxes2)
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / (union + _EPS)
    diag, dist = _diag_and_center_dist(boxes1, boxes2)
    return iou - dist / diag


def complete_box_iou(boxes1, boxes2) -> torch.Tensor:
    """CIoU: DIoU - the aspect-ratio penalty alpha * v."""
    boxes1, boxes2 = _pairwise_inputs(boxes1, boxes2)
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / (union + _EPS)
    diag, dist = _diag_and_center_dist(boxes1, boxes2)
    diou = iou - dist / diag
    w1 = boxes1[:, 2] - boxes1[:, 0]
    h1 = boxes1[:, 3] - boxes1[:, 1]
    w2 = boxes2[:, 2] - boxes2[:, 0]
    h2 = boxes2[:, 3] - boxes2[:, 1]
    v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + _EPS))[None, :] - torch.atan(w1 / (h1 + _EPS))[:, None]) ** 2
    alpha = v / (1 - iou + v + _EPS)
    return diou - alpha * v


def _iou_family(pairwise_fn, preds, target, iou_threshold, replacement_val, aggregate) -> torch.Tensor:
    preds, target = _pairwise_inputs(preds, target)
    iou = pairwise_fn(preds, target)
    if iou_threshold is not None:
        iou = torch.where(iou < iou_threshold, torch.full_like(iou, replacement_val), iou)
    if not aggregate:
        return iou
    if iou.numel() == 0:
        return torch.tensor(0.0, device=iou.device)
    return torch.diagonal(iou).mean()


def intersection_over_union(
    preds,
    target,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> torch.Tensor:
    """Pairwise IoU of ``(N, 4)`` and ``(M, 4)`` xyxy boxes, or with
    ``aggregate`` the mean over matched (diagonal) pairs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79], [298.55, 98.96, 314.97, 151.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00], [300.00, 100.00, 315.00, 150.00]])
        >>> round(float(intersection_over_union(preds, target)), 4)
        0.7756
    """
    return _iou_family(box_iou, preds, target, iou_threshold, replacement_val, aggregate)


def generalized_intersection_over_union(
    preds,
    target,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> torch.Tensor:
    """Generalized IoU (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import generalized_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79], [298.55, 98.96, 314.97, 151.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00], [300.00, 100.00, 315.00, 150.00]])
        >>> round(float(generalized_intersection_over_union(preds, target)), 4)
        0.7754
    """
    return _iou_family(generalized_box_iou, preds, target, iou_threshold, replacement_val, aggregate)


def distance_intersection_over_union(
    preds,
    target,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> torch.Tensor:
    """Distance IoU (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import distance_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79], [298.55, 98.96, 314.97, 151.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00], [300.00, 100.00, 315.00, 150.00]])
        >>> round(float(distance_intersection_over_union(preds, target)), 4)
        0.7747
    """
    return _iou_family(distance_box_iou, preds, target, iou_threshold, replacement_val, aggregate)


def complete_intersection_over_union(
    preds,
    target,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> torch.Tensor:
    """Complete IoU (functional interface).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import complete_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79], [298.55, 98.96, 314.97, 151.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00], [300.00, 100.00, 315.00, 150.00]])
        >>> round(float(complete_intersection_over_union(preds, target)), 4)
        0.7747
    """
    return _iou_family(complete_box_iou, preds, target, iou_threshold, replacement_val, aggregate)
