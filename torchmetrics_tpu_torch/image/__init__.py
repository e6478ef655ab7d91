"""Modular image metrics: SSIM and MS-SSIM, and the Inception family (FID,
KID, MiFID, Inception Score)."""
from torchmetrics_tpu_torch.image.basic import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from torchmetrics_tpu_torch.image.fid import FrechetInceptionDistance
from torchmetrics_tpu_torch.image.inception import InceptionScore
from torchmetrics_tpu_torch.image.kid import KernelInceptionDistance
from torchmetrics_tpu_torch.image.mifid import MemorizationInformedFrechetInceptionDistance

__all__ = [
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "StructuralSimilarityIndexMeasure",
]
