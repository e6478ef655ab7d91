"""Multimodal functionals: CLIPScore and CLIP-IQA."""
from torchmetrics_tpu_torch.multimodal.clip_score import (
    clip_image_quality_assessment,
    clip_score,
)

__all__ = ["clip_image_quality_assessment", "clip_score"]
