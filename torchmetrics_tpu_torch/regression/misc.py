"""Cosine similarity and KL divergence as classes."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.misc import _cosine_similarity_compute, _kld_compute, _kld_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


class CosineSimilarity(Metric):
    """Cosine similarity of paired rows over every row seen (list states).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import CosineSimilarity
        >>> m = CosineSimilarity(device="cpu")
        >>> m.update(torch.tensor([[1.0, 2.0, 3.0], [0.0, 1.0, 0.5]]), torch.tensor([[1.0, 2.0, 2.5], [0.0, 1.0, 1.0]]))
        >>> round(float(m.compute()), 4)
        1.9447
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.preds.append(torch.as_tensor(preds).to(torch.float32))
        self.target.append(torch.as_tensor(target).to(torch.float32))

    def compute(self) -> torch.Tensor:
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)


class KLDivergence(Metric):
    """KL divergence ``KL(P‖Q)`` of paired distributions; a ``"mean"`` or
    ``"sum"`` reduction keeps a running sum, ``"none"`` every row's value.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import KLDivergence
        >>> m = KLDivergence(device="cpu")
        >>> m.update(torch.tensor([[0.3, 0.3, 0.4]]), torch.tensor([[0.25, 0.5, 0.25]]))
        >>> round(float(m.compute()), 4)
        0.0895
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument to be a bool but got {log_prob}")
        self.log_prob = log_prob
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        if self.reduction in ("mean", "sum"):
            self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, p: torch.Tensor, q: torch.Tensor) -> None:
        measures, total = _kld_update(
            torch.as_tensor(p).to(torch.float32), torch.as_tensor(q).to(torch.float32), self.log_prob
        )
        if self.reduction in ("none", None):
            self.measures.append(measures)
        else:
            self.measures = self.measures + measures.sum()
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        measures = dim_zero_cat(self.measures) if self.reduction in ("none", None) else self.measures
        return _kld_compute(measures, self.total, self.reduction)
