"""Image functionals: SSIM and MS-SSIM so far."""
from torchmetrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)

__all__ = ["multiscale_structural_similarity_index_measure", "structural_similarity_index_measure"]
