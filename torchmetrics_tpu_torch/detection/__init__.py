"""Detection metrics as classes: mean average precision, the IoU family and
panoptic quality (on the ``bincount`` kernel)."""
from torchmetrics_tpu_torch.detection.iou import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
)
from torchmetrics_tpu_torch.detection.mean_ap import MeanAveragePrecision
from torchmetrics_tpu_torch.detection.panoptic_qualities import (
    ModifiedPanopticQuality,
    PanopticQuality,
)

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
