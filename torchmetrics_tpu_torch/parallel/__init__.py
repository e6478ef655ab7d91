"""Cross-process state sync on ``torch.distributed`` (``parallel/sync.py``)."""
from torchmetrics_tpu_torch.parallel.sync import (
    SYNC_FAILURE_POLICIES,
    SYNC_TIMEOUT_ENV,
    class_reduce,
    default_sync_timeout,
    fold_window_slots,
    gather_all_tensors,
    live_window_mask,
    reduce,
    reduce_stacked,
    reduction_identity,
    sync_states,
    sync_value,
)

__all__ = [
    "SYNC_FAILURE_POLICIES",
    "SYNC_TIMEOUT_ENV",
    "class_reduce",
    "default_sync_timeout",
    "fold_window_slots",
    "gather_all_tensors",
    "live_window_mask",
    "reduce",
    "reduce_stacked",
    "reduction_identity",
    "sync_states",
    "sync_value",
]
