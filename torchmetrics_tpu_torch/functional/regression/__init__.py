"""Regression functionals."""
from torchmetrics_tpu_torch.functional.regression.basic import (
    critical_success_index,
    log_cosh_error,
    mean_absolute_error,
    mean_absolute_percentage_error,
    mean_squared_error,
    mean_squared_log_error,
    minkowski_distance,
    relative_squared_error,
    symmetric_mean_absolute_percentage_error,
    tweedie_deviance_score,
    weighted_mean_absolute_percentage_error,
)
from torchmetrics_tpu_torch.functional.regression.explained_variance import explained_variance
from torchmetrics_tpu_torch.functional.regression.misc import cosine_similarity, kl_divergence
from torchmetrics_tpu_torch.functional.regression.pearson import pearson_corrcoef
from torchmetrics_tpu_torch.functional.regression.r2 import r2_score
from torchmetrics_tpu_torch.functional.regression.rank_based import (
    concordance_corrcoef,
    kendall_rank_corrcoef,
    spearman_corrcoef,
)

__all__ = [
    "concordance_corrcoef",
    "cosine_similarity",
    "critical_success_index",
    "explained_variance",
    "kendall_rank_corrcoef",
    "kl_divergence",
    "log_cosh_error",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "minkowski_distance",
    "pearson_corrcoef",
    "r2_score",
    "relative_squared_error",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
