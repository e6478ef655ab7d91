"""Modular image metrics: SSIM and MS-SSIM so far."""
from torchmetrics_tpu_torch.image.basic import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)

__all__ = ["MultiScaleStructuralSimilarityIndexMeasure", "StructuralSimilarityIndexMeasure"]
