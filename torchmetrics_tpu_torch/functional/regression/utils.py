"""Shared regression input checks."""
from __future__ import annotations

import torch


def _check_data_shape_to_num_outputs(
    preds: torch.Tensor, target: torch.Tensor, num_outputs: int, allow_1d_reshape: bool = False
) -> None:
    """Raise unless ``preds`` and ``target`` are 1-D or 2-D and their second
    dimension agrees with ``num_outputs``."""
    if preds.ndim > 2 or target.ndim > 2:
        raise ValueError(
            f"Expected both predictions and target to be either 1- or 2-dimensional tensors,"
            f" but got {target.ndim} and {preds.ndim}."
        )
    cond1 = False if allow_1d_reshape else (num_outputs == 1 and not (preds.ndim == 1 or preds.shape[1] == 1))
    cond2 = num_outputs > 1 and (preds.ndim < 2 or num_outputs != preds.shape[1])
    if cond1 or cond2:
        raise ValueError(
            f"Expected argument `num_outputs` to match the second dimension of input, but got {num_outputs}"
            f" and {preds.shape[1] if preds.ndim > 1 else 1}."
        )
