"""Modular image metrics: the pure-tensor family (PSNR, PSNR-B, SSIM,
MS-SSIM, TV, UQI, SAM, ERGAS, RMSE-SW, RASE, SCC, VIF, D_lambda, D_s, QNR),
the Inception family (FID, KID, MiFID, Inception Score), LPIPS and PPL."""
from torchmetrics_tpu_torch.image.basic import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    PeakSignalNoiseRatioWithBlockedEffect,
    QualityWithNoReference,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpatialCorrelationCoefficient,
    SpatialDistortionIndex,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    TotalVariation,
    UniversalImageQualityIndex,
    VisualInformationFidelity,
)
from torchmetrics_tpu_torch.image.fid import FrechetInceptionDistance
from torchmetrics_tpu_torch.image.inception import InceptionScore
from torchmetrics_tpu_torch.image.kid import KernelInceptionDistance
from torchmetrics_tpu_torch.image.lpips import LearnedPerceptualImagePatchSimilarity
from torchmetrics_tpu_torch.image.mifid import MemorizationInformedFrechetInceptionDistance
from torchmetrics_tpu_torch.image.perceptual_path_length import PerceptualPathLength

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "PerceptualPathLength",
    "QualityWithNoReference",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
