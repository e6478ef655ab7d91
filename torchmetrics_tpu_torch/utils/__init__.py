"""Shared utilities: enums, typed errors, checks, data and safe-math helpers."""
from torchmetrics_tpu_torch.utils.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum, select_topk
from torchmetrics_tpu_torch.utils.enums import AverageMethod, ClassificationTask
from torchmetrics_tpu_torch.utils.exceptions import (
    CheckpointCorruptionError,
    FleetProtocolError,
    ShardLossError,
    StateCorruptionError,
    StateDivergenceError,
    SyncTimeoutError,
    TopologyMismatchError,
    TorchMetricsUserError,
    TorchMetricsUserWarning,
)

__all__ = [
    "AverageMethod",
    "CheckpointCorruptionError",
    "ClassificationTask",
    "FleetProtocolError",
    "ShardLossError",
    "StateCorruptionError",
    "StateDivergenceError",
    "SyncTimeoutError",
    "TopologyMismatchError",
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "select_topk",
]
