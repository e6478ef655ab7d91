"""Clustering metrics as classes; state lives on the metric's device."""
from torchmetrics_tpu_torch.clustering.metrics import (  # noqa: F401
    AdjustedMutualInfoScore,
    AdjustedRandScore,
    CalinskiHarabaszScore,
    CompletenessScore,
    DaviesBouldinScore,
    DunnIndex,
    FowlkesMallowsIndex,
    HomogeneityScore,
    MutualInfoScore,
    NormalizedMutualInfoScore,
    RandScore,
    VMeasureScore,
)

__all__ = [
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "CalinskiHarabaszScore",
    "CompletenessScore",
    "DaviesBouldinScore",
    "DunnIndex",
    "FowlkesMallowsIndex",
    "HomogeneityScore",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "RandScore",
    "VMeasureScore",
]
