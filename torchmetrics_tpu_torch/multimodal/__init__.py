"""Multimodal metrics on the user's embedding functions: CLIPScore and CLIP-IQA."""
from torchmetrics_tpu_torch.multimodal.clip_score import (
    CLIPImageQualityAssessment,
    CLIPScore,
)

__all__ = ["CLIPImageQualityAssessment", "CLIPScore"]
