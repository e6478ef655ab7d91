"""Detection functionals: the IoU family and panoptic quality."""
from torchmetrics_tpu_torch.functional.detection.iou import (
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
)
from torchmetrics_tpu_torch.functional.detection.panoptic_quality import (
    modified_panoptic_quality,
    panoptic_quality,
)

__all__ = [
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
]
