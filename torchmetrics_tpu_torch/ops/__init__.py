"""Kernel layer: the dispatch seam, the hand-written CUDA kernels, the
shared-count fusion built on them, and the captured executor
(``ops/executor.py``: captured dispatch, the synced and deferred
collection steps, the recovery snapshot)."""
from torchmetrics_tpu_torch.ops.bincount import weighted_bincount, weighted_bincount_multi
from torchmetrics_tpu_torch.ops.binned_curve import binned_curve_counts, binned_curve_counts_classwise, sort_thresholds
from torchmetrics_tpu_torch.ops.executor import (
    DeferredCollectionStep,
    latest_recovery_snapshot,
    make_deferred_collection_step,
    make_synced_collection_step,
    make_value_packer,
)
from torchmetrics_tpu_torch.ops.kernels import (
    dispatch,
    gate_snapshot,
    registered_kernels,
    resolve_backend,
    shared_result,
    shared_scope,
)
from torchmetrics_tpu_torch.ops.sqrtm_kernel import sqrtm_psd
from torchmetrics_tpu_torch.ops.ssim_kernel import windowed_sum_2d
from torchmetrics_tpu_torch.ops.topk_kernel import retrieval_topk_stats

__all__ = [
    "DeferredCollectionStep",
    "binned_curve_counts",
    "binned_curve_counts_classwise",
    "dispatch",
    "gate_snapshot",
    "latest_recovery_snapshot",
    "make_deferred_collection_step",
    "make_synced_collection_step",
    "make_value_packer",
    "registered_kernels",
    "resolve_backend",
    "retrieval_topk_stats",
    "shared_result",
    "shared_scope",
    "sort_thresholds",
    "sqrtm_psd",
    "weighted_bincount",
    "weighted_bincount_multi",
    "windowed_sum_2d",
]
