"""Input-validation helpers.

Validation reads values, so it waits for the device: each check gathers what
it needs into as few host reads as it can. It is toggled by every metric's
``validate_args`` flag, exactly as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

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


def _allclose_recursive(res1: Any, res2: Any, atol: float = 1e-6) -> bool:
    """Recursive allclose over tensors, sequences and mappings."""
    if isinstance(res1, torch.Tensor):
        return bool(torch.allclose(res1.double().cpu(), torch.as_tensor(res2).double().cpu(), atol=atol))
    if isinstance(res1, str):
        return res1 == res2
    if isinstance(res1, dict):
        return all(_allclose_recursive(res1[k], res2[k], atol) for k in res1)
    if isinstance(res1, (list, tuple)):
        return all(_allclose_recursive(r1, r2, atol) for r1, r2 in zip(res1, res2))
    return res1 == res2


def check_forward_full_state_property(
    metric_class: Any,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare: Sequence[int] = (10, 100, 1000),
    reps: int = 5,
) -> None:
    """Check empirically whether ``metric_class`` is safe with
    ``full_state_update=False``, and time both forward strategies.

    Runs the metric with both settings on the same inputs; when every batch
    value and the final compute agree, the one-update path is safe, and both
    are timed to print a recommendation (else it recommends
    ``full_state_update=True``).
    """
    from time import perf_counter

    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):
        full_state_update = True

    class PartState(metric_class):
        full_state_update = False

    fullstate = FullState(**init_args)
    partstate = PartState(**init_args)

    equal = True
    try:
        for _ in range(num_update_to_compare[0]):
            equal = equal and _allclose_recursive(fullstate(**input_args), partstate(**input_args))
        equal = equal and _allclose_recursive(fullstate.compute(), partstate.compute())
    except (RuntimeError, TypeError):  # the one-update path needed the full state
        equal = False

    if not equal:
        print("Recommended setting `full_state_update=True`")
        return

    timings = np.zeros((2, len(num_update_to_compare), reps))
    for i, metric in enumerate([fullstate, partstate]):
        for j, steps in enumerate(num_update_to_compare):
            for r in range(reps):
                start = perf_counter()
                for _ in range(steps):
                    metric(**input_args)
                timings[i, j, r] = perf_counter() - start
                metric.reset()

    mean = timings.mean(-1)
    std = timings.std(-1)
    for j, steps in enumerate(num_update_to_compare):
        print(f"Full state for {steps} steps took: {mean[0, j]:0.3f}+-{std[0, j]:0.3f}")
        print(f"Partial state for {steps} steps took: {mean[1, j]:0.3f}+-{std[1, j]:0.3f}")
    faster = bool(mean[1, -1] < mean[0, -1])
    print(f"Recommended setting `full_state_update={not faster}`")
