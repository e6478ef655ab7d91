"""Clustering metrics as classes.

Label metrics keep every batch's ``preds`` and ``target``, embedding metrics
every ``data`` and ``labels``, as ``cat`` list states on the metric's device:
the scores need the whole assignment (no streaming statistic gives the
mutual-information family). ``compute`` concatenates them and calls the
functional.
"""
from __future__ import annotations

from typing import Any

import torch

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
from torchmetrics_tpu_torch.functional.clustering.utils import _validate_average_method_arg
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


class _LabelClusteringMetric(Metric):
    """Base for metrics comparing two label assignments."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.preds.append(torch.as_tensor(preds))
        self.target.append(torch.as_tensor(target))

    def _compute_fn_args(self):
        return ()

    def compute(self) -> torch.Tensor:
        return type(self)._fn(dim_zero_cat(self.preds), dim_zero_cat(self.target), *self._compute_fn_args())


class MutualInfoScore(_LabelClusteringMetric):
    """Mutual Info Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import MutualInfoScore
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = MutualInfoScore(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.5004
    """

    _fn = staticmethod(mutual_info_score)


class RandScore(_LabelClusteringMetric):
    """Rand Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import RandScore
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = RandScore(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.6
    """

    _fn = staticmethod(rand_score)


class AdjustedRandScore(_LabelClusteringMetric):
    """Adjusted Rand Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import AdjustedRandScore
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = AdjustedRandScore(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        -0.25
    """

    _fn = staticmethod(adjusted_rand_score)
    plot_lower_bound: float = -0.5


class FowlkesMallowsIndex(_LabelClusteringMetric):
    """Fowlkes Mallows Index (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import FowlkesMallowsIndex
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = FowlkesMallowsIndex(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.0
    """

    _fn = staticmethod(fowlkes_mallows_index)
    plot_upper_bound: float = 1.0


class HomogeneityScore(_LabelClusteringMetric):
    """Homogeneity Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import HomogeneityScore
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = HomogeneityScore(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.4744
    """

    _fn = staticmethod(homogeneity_score)
    plot_upper_bound: float = 1.0


class CompletenessScore(_LabelClusteringMetric):
    """Completeness Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import CompletenessScore
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = CompletenessScore(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.4744
    """

    _fn = staticmethod(completeness_score)
    plot_upper_bound: float = 1.0


class VMeasureScore(_LabelClusteringMetric):
    """V Measure Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import VMeasureScore
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = VMeasureScore(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.4744
    """

    _fn = staticmethod(v_measure_score)
    plot_upper_bound: float = 1.0

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, (int, float)) and beta > 0):
            raise ValueError(f"Argument `beta` should be a positive float. Got {beta}.")
        self.beta = beta

    def _compute_fn_args(self):
        return (self.beta,)


class NormalizedMutualInfoScore(_LabelClusteringMetric):
    """Normalized Mutual Info Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import NormalizedMutualInfoScore
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = NormalizedMutualInfoScore(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        0.4744
    """

    _fn = staticmethod(normalized_mutual_info_score)
    plot_upper_bound: float = 1.0

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def _compute_fn_args(self):
        return (self.average_method,)


class AdjustedMutualInfoScore(NormalizedMutualInfoScore):
    """Adjusted Mutual Info Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import AdjustedMutualInfoScore
        >>> import torch
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> m = AdjustedMutualInfoScore(device="cpu")
        >>> m.update(preds, target)
        >>> round(float(m.compute()), 4)
        -0.25
    """

    _fn = staticmethod(adjusted_mutual_info_score)
    plot_lower_bound: float = -1.0


class _EmbeddingClusteringMetric(Metric):
    """Base for metrics over (data, labels) embeddings."""

    is_differentiable = True
    full_state_update = True
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", default=[], dist_reduce_fx="cat")
        self.add_state("labels", default=[], dist_reduce_fx="cat")

    def update(self, data: torch.Tensor, labels: torch.Tensor) -> None:
        self.data.append(torch.as_tensor(data))
        self.labels.append(torch.as_tensor(labels))

    def _compute_fn_args(self):
        return ()

    def compute(self) -> torch.Tensor:
        return type(self)._fn(dim_zero_cat(self.data), dim_zero_cat(self.labels), *self._compute_fn_args())


class CalinskiHarabaszScore(_EmbeddingClusteringMetric):
    """Calinski Harabasz Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import CalinskiHarabaszScore
        >>> import torch
        >>> data = torch.tensor([[0.0, 0.1], [0.1, 0.0], [4.0, 4.1], [4.1, 4.0], [8.0, 8.1], [8.1, 8.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> m = CalinskiHarabaszScore(device="cpu")
        >>> m.update(data, labels)
        >>> round(float(m.compute()), 2)
        6399.99
    """

    _fn = staticmethod(calinski_harabasz_score)
    higher_is_better = True


class DaviesBouldinScore(_EmbeddingClusteringMetric):
    """Davies Bouldin Score (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import DaviesBouldinScore
        >>> import torch
        >>> data = torch.tensor([[0.0, 0.1], [0.1, 0.0], [4.0, 4.1], [4.1, 4.0], [8.0, 8.1], [8.1, 8.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> m = DaviesBouldinScore(device="cpu")
        >>> m.update(data, labels)
        >>> round(float(m.compute()), 4)
        0.025
    """

    _fn = staticmethod(davies_bouldin_score)
    higher_is_better = False


class DunnIndex(_EmbeddingClusteringMetric):
    """Dunn Index (modular interface, accumulating across updates).

    Example:
        >>> from torchmetrics_tpu_torch.clustering import DunnIndex
        >>> import torch
        >>> data = torch.tensor([[0.0, 0.1], [0.1, 0.0], [4.0, 4.1], [4.1, 4.0], [8.0, 8.1], [8.1, 8.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> m = DunnIndex(device="cpu")
        >>> m.update(data, labels)
        >>> round(float(m.compute()), 2)
        80.0
    """

    _fn = staticmethod(dunn_index)
    higher_is_better = True

    def __init__(self, p: float = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def _compute_fn_args(self):
        return (self.p,)
