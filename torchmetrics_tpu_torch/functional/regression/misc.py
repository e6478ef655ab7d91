"""Cosine similarity of paired rows, and the KL divergence of paired distributions."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _safe_xlogy


def _cosine_similarity_compute(
    preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum"
) -> torch.Tensor:
    dot = (preds * target).sum(-1)
    norm = torch.linalg.vector_norm(preds, dim=-1) * torch.linalg.vector_norm(target, dim=-1)
    sim = dot / norm
    if reduction == "sum":
        return sim.sum()
    if reduction == "mean":
        return sim.mean()
    if reduction in ("none", None):
        return sim
    raise ValueError(f"Expected reduction to be one of `['sum', 'mean', 'none', None]` but got {reduction}")


def cosine_similarity(preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Cosine similarity of each row of ``preds`` with the same row of ``target``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cosine_similarity
        >>> preds = torch.tensor([[1.0, 2.0, 3.0], [0.0, 1.0, 0.5]])
        >>> target = torch.tensor([[1.0, 2.0, 2.5], [0.0, 1.0, 1.0]])
        >>> round(float(cosine_similarity(preds, target)), 4)
        1.9447
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    if preds.ndim != 2:
        raise ValueError(f"Expected input to cosine similarity to be 2D tensors of shape `[N,D]` but got {tuple(preds.shape)}")
    return _cosine_similarity_compute(preds, target, reduction)


def _kld_update(p: torch.Tensor, q: torch.Tensor, log_prob: bool) -> Tuple[torch.Tensor, int]:
    """Per-row ``KL(p‖q)`` (rows normalised to sum 1 unless ``log_prob``) and the row count."""
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")
    total = p.shape[0]
    if log_prob:
        measures = (torch.exp(p) * (p - q)).sum(-1)
    else:
        p = p / p.sum(-1, keepdim=True)
        q = q / q.sum(-1, keepdim=True)
        measures = _safe_xlogy(p, p / q).sum(-1)
    return measures, total


def _kld_compute(measures: torch.Tensor, total, reduction: Optional[str] = "mean") -> torch.Tensor:
    if reduction == "sum":
        return measures.sum()
    if reduction == "mean":
        return measures.sum() / total
    if reduction in ("none", None):
        return measures
    return measures / total


def kl_divergence(
    p: torch.Tensor, q: torch.Tensor, log_prob: bool = False, reduction: Optional[str] = "mean"
) -> torch.Tensor:
    """KL divergence ``KL(P‖Q)`` of each row; ``log_prob=True`` takes log-probabilities.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import kl_divergence
        >>> p = torch.tensor([[0.3, 0.3, 0.4]])
        >>> q = torch.tensor([[0.25, 0.5, 0.25]])
        >>> round(float(kl_divergence(p, q)), 4)
        0.0895
    """
    measures, total = _kld_update(
        torch.as_tensor(p).to(torch.float32), torch.as_tensor(q).to(torch.float32), log_prob
    )
    return _kld_compute(measures, total, reduction)
