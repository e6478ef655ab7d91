"""Data-manipulation utilities (``dim_zero_*`` reducers and ``select_topk``)."""
from __future__ import annotations

from typing import Any, List, Sequence, Union

import torch


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor]]) -> torch.Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    if isinstance(x, torch.Tensor):
        return x
    x = [torch.atleast_1d(torch.as_tensor(el)) for el in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    return torch.max(x, dim=0).values


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    return torch.min(x, dim=0).values


def _flatten(x: Sequence) -> list:
    """Flatten one level of nesting."""
    return [item for sublist in x for item in sublist]


def _flatten_dict(x: dict) -> tuple:
    """Flatten one level of nested dicts; returns (new_dict, duplicates_found)."""
    new_dict = {}
    duplicates = False
    for key, value in x.items():
        if isinstance(value, dict):
            for k, v in value.items():
                if k in new_dict:
                    duplicates = True
                new_dict[k] = v
        else:
            if key in new_dict:
                duplicates = True
            new_dict[key] = value
    return new_dict, duplicates


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """int32 0/1 mask of the top-k entries along ``dim``; ``topk == 1`` takes
    the first maximum, as ``argmax`` does in both frameworks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utils.data import select_topk
        >>> select_topk(torch.tensor([[0.1, 0.7, 0.2], [0.6, 0.1, 0.3]]), topk=2).tolist()
        [[0, 1, 1], [1, 0, 1]]
    """
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.topk(prob_tensor, topk, dim=dim).indices
    return torch.zeros_like(prob_tensor, dtype=torch.int32).scatter_(dim, idx, 1)


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze every one-element tensor in a (nested) result to 0-d."""
    if isinstance(data, torch.Tensor):
        return data.squeeze() if data.numel() == 1 else data
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(v) for v in data)
    return data
