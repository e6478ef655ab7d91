"""Safe-math helpers, written without data-dependent Python branching so a
CUDA caller never waits on the device for them."""
from __future__ import annotations

from typing import Optional

import torch


def _safe_divide(num: torch.Tensor, denom: torch.Tensor, zero_division: float = 0.0) -> torch.Tensor:
    """Elementwise num/denom returning ``zero_division`` where denom == 0.

    Integer operands are divided in float32, as the JAX package does with x64
    off; the double ``where`` keeps nan/inf out of the result.
    """
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom)
    if not (num.is_floating_point() or denom.is_floating_point()):
        num = num.to(torch.float32)
        denom = denom.to(torch.float32)
    zero = denom == 0
    quotient = num / torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.full_like(quotient, zero_division), quotient)


def _adjust_weights_safe_divide(
    score: torch.Tensor,
    average: Optional[str],
    is_multilabel: bool,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    top_k: int = 1,
) -> torch.Tensor:
    """Macro/weighted averaging of per-class scores, ignoring absent classes."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
    else:  # macro
        weights = torch.ones_like(score, dtype=torch.float32)
        if not is_multilabel:
            # classes absent from the data carry no weight; with top_k > 1 a
            # class can have fp without true instances, so the absence test
            # drops fp
            absent = (tp + fp + fn == 0) if top_k == 1 else (tp + fn == 0)
            weights = torch.where(absent, torch.zeros_like(weights), weights)
    return _safe_divide(weights * score, weights.sum(-1, keepdim=True)).sum(-1)
