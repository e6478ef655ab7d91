"""Kernel layer: the dispatch seam, the hand-written CUDA kernels and the
shared-count fusion built on them."""
from torchmetrics_tpu_torch.ops.bincount import weighted_bincount, weighted_bincount_multi
from torchmetrics_tpu_torch.ops.kernels import dispatch, registered_kernels, shared_result, shared_scope

__all__ = [
    "dispatch",
    "registered_kernels",
    "shared_result",
    "shared_scope",
    "weighted_bincount",
    "weighted_bincount_multi",
]
