"""Regression metrics as classes."""
from torchmetrics_tpu_torch.regression.correlations import (
    ConcordanceCorrCoef,
    ExplainedVariance,
    KendallRankCorrCoef,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
)
from torchmetrics_tpu_torch.regression.errors import (
    CriticalSuccessIndex,
    LogCoshError,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    MinkowskiDistance,
    RelativeSquaredError,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from torchmetrics_tpu_torch.regression.misc import CosineSimilarity, KLDivergence

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "CriticalSuccessIndex",
    "ExplainedVariance",
    "KLDivergence",
    "KendallRankCorrCoef",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
