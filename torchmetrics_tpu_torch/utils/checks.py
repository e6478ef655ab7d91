"""Input-validation helpers.

Validation reads values, so it waits for the device: each check gathers what
it needs into as few host reads as it can. It is toggled by every metric's
``validate_args`` flag, exactly as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    if tuple(preds.shape) != tuple(target.shape):
        raise ValueError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _unique_values(x: torch.Tensor) -> set:
    """The set of distinct values of ``x`` (one device sort, one host read)."""
    return set(torch.unique(x).tolist())


def _check_same_device(device: torch.device, args: Sequence[Any], kwargs: dict, owner: str) -> None:
    """Raise when an input tensor lies on another device than the metric's
    state: the port never copies an input across devices behind the caller's
    back. A numpy array counts as a CPU input."""
    for value in list(args) + list(kwargs.values()):
        if isinstance(value, torch.Tensor):
            where = value.device
        elif isinstance(value, np.ndarray):
            where = torch.device("cpu")
        else:
            continue
        if where.type != device.type or (
            where.type == "cuda" and where.index is not None and where.index != device.index
        ):
            raise RuntimeError(
                f"{owner}: input on {where} but the metric state lives on {device}; move the"
                " input (or build the metric with a matching `device=`) — inputs are never"
                " copied across devices implicitly"
            )
