"""Clustering metrics on embeddings: Calinski-Harabasz, Davies-Bouldin and
Dunn.

Every per-cluster statistic (centroid, count, spread, radius) is one
segment reduction over the relabelled clusters: ``index_add_`` for sums,
``scatter_reduce(..., "amax")`` for maxima. The centroid-to-centroid
distances are formed a chunk of rows at a time, at most
``_CHUNK_ELEMENTS`` elements of the (rows, K, D) difference (256 MiB in
float32): each pair's sum over the features is the same as in the
unchunked (K, K, D) form, which at 1,000 clusters of 2,048 features would
hold 8.2 GB.
"""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _validate_intrinsic_cluster_data,
    _validate_intrinsic_labels_to_samples,
)

_CHUNK_ELEMENTS = 1 << 26


def _relabel(data: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    data, labels = torch.as_tensor(data), torch.as_tensor(labels)
    _validate_intrinsic_cluster_data(data, labels)
    unique_labels, labels = torch.unique(labels, return_inverse=True)
    num_labels = unique_labels.numel()
    _validate_intrinsic_labels_to_samples(num_labels, data.shape[0])
    return data, labels.reshape(-1), num_labels


def _segment_sum(values: torch.Tensor, labels: torch.Tensor, num_labels: int) -> torch.Tensor:
    out = values.new_zeros((num_labels, *values.shape[1:]))
    return out.index_add_(0, labels, values)


def _centroids_counts(data: torch.Tensor, labels: torch.Tensor, num_labels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    counts = _segment_sum(torch.ones(data.shape[0], dtype=data.dtype, device=data.device), labels, num_labels)
    return _segment_sum(data, labels, num_labels) / counts[:, None], counts


def _centroid_distances(centroids: torch.Tensor, p: float = 2) -> torch.Tensor:
    """(K, K) ``p``-norm distances between centroids, a chunk of rows at a time."""
    k, d = centroids.shape
    rows = max(1, _CHUNK_ELEMENTS // max(k * d, 1))
    out = centroids.new_empty((k, k))
    for i0 in range(0, k, rows):
        diff = centroids[i0 : i0 + rows, None, :] - centroids[None, :, :]
        out[i0 : i0 + rows] = torch.linalg.vector_norm(diff, ord=p, dim=-1)
    return out


def calinski_harabasz_score(data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Variance-ratio criterion: between- over within-cluster dispersion.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import calinski_harabasz_score
        >>> data = torch.tensor([[0.0, 0.1], [0.1, 0.0], [4.0, 4.1], [4.1, 4.0], [8.0, 8.1], [8.1, 8.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> round(float(calinski_harabasz_score(data, labels)), 2)
        6399.99
    """
    data, labels, num_labels = _relabel(data, labels)
    num_samples = data.shape[0]
    mean = data.mean(dim=0)
    centroids, counts = _centroids_counts(data, labels, num_labels)
    between = (counts * ((centroids - mean) ** 2).sum(dim=1)).sum()
    within = ((data - centroids[labels]) ** 2).sum()
    if bool(within == 0):
        return torch.tensor(1.0, device=data.device)
    return between * (num_samples - num_labels) / (within * (num_labels - 1.0))


def davies_bouldin_score(data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over clusters of the worst ratio of summed spreads to centroid separation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import davies_bouldin_score
        >>> data = torch.tensor([[0.0, 0.1], [0.1, 0.0], [4.0, 4.1], [4.1, 4.0], [8.0, 8.1], [8.1, 8.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> round(float(davies_bouldin_score(data, labels)), 4)
        0.025
    """
    data, labels, num_labels = _relabel(data, labels)
    centroids, counts = _centroids_counts(data, labels, num_labels)
    dists = torch.sqrt(((data - centroids[labels]) ** 2).sum(dim=1))
    intra = _segment_sum(dists, labels, num_labels) / counts
    centroid_distances = _centroid_distances(centroids)
    if bool(torch.allclose(intra, torch.zeros_like(intra))) or bool(
        torch.allclose(centroid_distances, torch.zeros_like(centroid_distances))
    ):
        return torch.tensor(0.0, device=data.device)
    centroid_distances = torch.where(centroid_distances == 0, torch.inf, centroid_distances)
    combined = intra[None, :] + intra[:, None]
    return (combined / centroid_distances).amax(dim=1).mean()


def dunn_index(data: torch.Tensor, labels: torch.Tensor, p: float = 2) -> torch.Tensor:
    """Smallest centroid distance over the largest cluster radius.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import dunn_index
        >>> data = torch.tensor([[0.0, 0.1], [0.1, 0.0], [4.0, 4.1], [4.1, 4.0], [8.0, 8.1], [8.1, 8.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> round(float(dunn_index(data, labels)), 2)
        80.0
    """
    data, labels, num_labels = _relabel(data, labels)
    centroids, _ = _centroids_counts(data, labels, num_labels)
    inter = _centroid_distances(centroids, p)
    inter = torch.where(torch.eye(num_labels, dtype=torch.bool, device=data.device), torch.inf, inter)
    radii = torch.linalg.vector_norm(data - centroids[labels], ord=p, dim=-1)
    max_intra = torch.full((num_labels,), -torch.inf, dtype=radii.dtype, device=data.device)
    max_intra = max_intra.scatter_reduce(0, labels, radii, reduce="amax")
    return inter.min() / max_intra.max()
