"""Clustering metrics as functions of tensors: label comparisons on the
``bincount`` kernel's contingency tables, and embedding scores."""
from torchmetrics_tpu_torch.functional.clustering.extrinsic import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    completeness_score,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.intrinsic import (
    calinski_harabasz_score,
    davies_bouldin_score,
    dunn_index,
)

__all__ = [
    "adjusted_mutual_info_score",
    "adjusted_rand_score",
    "calinski_harabasz_score",
    "completeness_score",
    "davies_bouldin_score",
    "dunn_index",
    "fowlkes_mallows_index",
    "homogeneity_score",
    "mutual_info_score",
    "normalized_mutual_info_score",
    "rand_score",
    "v_measure_score",
]
