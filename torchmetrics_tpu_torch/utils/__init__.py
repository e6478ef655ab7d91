"""Shared utilities: enums, typed errors, checks, data and safe-math helpers."""
from torchmetrics_tpu_torch.utils.checks import check_forward_full_state_property
from torchmetrics_tpu_torch.utils.data import (
    allclose,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_categorical,
    to_onehot,
)
from torchmetrics_tpu_torch.utils.enums import AverageMethod, ClassificationTask, DataType, MDMCAverageMethod
from torchmetrics_tpu_torch.utils.exceptions import (
    CheckpointCorruptionError,
    DispatchStallError,
    FleetProtocolError,
    ShardLossError,
    StateCorruptionError,
    StateDivergenceError,
    SyncTimeoutError,
    TopologyMismatchError,
    TorchMetricsUserError,
    TorchMetricsUserWarning,
)
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_warn


def __getattr__(name: str):
    # the reference's tensor reductions, implemented beside the sync they
    # serve (parallel/sync.py); resolved on first use, as parallel/ imports
    # this package
    if name in ("class_reduce", "reduce"):
        from torchmetrics_tpu_torch.parallel import sync

        return getattr(sync, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AverageMethod",
    "CheckpointCorruptionError",
    "ClassificationTask",
    "DataType",
    "DispatchStallError",
    "FleetProtocolError",
    "MDMCAverageMethod",
    "ShardLossError",
    "StateCorruptionError",
    "StateDivergenceError",
    "SyncTimeoutError",
    "TopologyMismatchError",
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "allclose",
    "check_forward_full_state_property",
    "class_reduce",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
    "reduce",
    "select_topk",
    "to_categorical",
    "to_onehot",
]
