"""Group fairness: per-group stat rates, demographic parity and equal
opportunity for binary predictions.

The per-group (tp, fp, tn, fn) are one weightless count over ``4·G`` bins
(the ``bincount`` kernel on the card) at the index ``4·g + 2·t + p``, where
the JAX package makes four ``segment_sum`` passes. The index is group-major,
so a group id outside [0, G) (a negative one passes the validation, and any
passes with ``validate_args=False``) lands outside [0, 4G) and is dropped,
as ``segment_sum`` drops it; an ignored sample gets -1 and is dropped too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_TASKS = ("demographic_parity", "equal_opportunity", "all")


def _groups_validation(groups: torch.Tensor, num_groups: int) -> None:
    """Group ids must be integers below ``num_groups`` (one host read)."""
    if groups.is_floating_point() or groups.is_complex() or groups.dtype == torch.bool:
        raise ValueError(f"Excpected dtype of argument groups to be int, got {groups.dtype}")
    largest = int(groups.max())
    if largest >= num_groups:
        raise ValueError(
            f"The largest number in the groups tensor is {largest}, which is larger than the specified"
            f"number of groups {num_groups}. The group identifiers should be ``0, 1, ..., (num_groups - 1)``."
        )


def _check_fairness_task(task: str) -> None:
    if task not in _TASKS:
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )


def _check_num_groups(num_groups: int) -> None:
    if not isinstance(num_groups, int) or num_groups < 2:
        raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")


def _binary_groups_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    groups: torch.Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Stats:
    """Per-group int32 (tp, fp, tn, fn), each of shape (num_groups,), from
    one weightless ``bincount`` over ``4·num_groups`` bins.

    Predictions and targets enter the index by their low bit, which is what
    the JAX package's bitwise ``preds & target`` products count for a 0/1
    target."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    # clamped to [-1, G]: an id outside [0, G) stays outside [0, 4G), and int32 cannot wrap
    g = groups.reshape(-1).clamp(-1, num_groups).to(torch.int32)
    g = torch.where(valid.reshape(-1), g, torch.full_like(g, -1))
    idx = 4 * g + 2 * (target.reshape(-1) & 1) + (preds.reshape(-1) & 1)
    counts = weighted_bincount(idx, None, 4 * num_groups).reshape(num_groups, 2, 2)
    return counts[:, 1, 1], counts[:, 0, 1], counts[:, 0, 0], counts[:, 1, 0]


def binary_groups_stat_rates(
    preds: torch.Tensor,
    target: torch.Tensor,
    groups: torch.Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """Per-group (tp, fp, tn, fn) rates, each group's counts over its size.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_groups_stat_rates
        >>> preds, target = torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0])
        >>> result = binary_groups_stat_rates(preds, target, torch.tensor([0, 1, 0, 1]), num_groups=2)
        >>> {k: v.tolist() for k, v in result.items()}
        {'group_0': [0.0, 0.0, 0.5, 0.5], 'group_1': [0.5, 0.5, 0.0, 0.0]}
    """
    stats = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _group_rates(*stats)


def _group_rates(tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> Dict[str, torch.Tensor]:
    stats = torch.stack([tp, fp, tn, fn], dim=1).to(torch.float32)  # (G, 4)
    rates = _safe_divide(stats, stats.sum(dim=1, keepdim=True))
    return {f"group_{g}": rates[g] for g in range(stats.shape[0])}


def _min_max_ratio(prefix: str, rates: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{prefix_argmin_argmax: min / max}``; ties go to the first index, as
    ``jnp.argmin``/``jnp.argmax`` resolve them (one host read)."""
    min_id, max_id = torch.stack([torch.argmin(rates), torch.argmax(rates)]).tolist()
    return {f"{prefix}_{min_id}_{max_id}": _safe_divide(rates[min_id], rates[max_id])}


def _compute_binary_demographic_parity(
    tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor
) -> Dict[str, torch.Tensor]:
    return _min_max_ratio("DP", _safe_divide(tp + fp, tp + fp + tn + fn))


def _compute_binary_equal_opportunity(
    tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor
) -> Dict[str, torch.Tensor]:
    return _min_max_ratio("EO", _safe_divide(tp, tp + fn))


def _fairness_compute(task: str, stats: Stats) -> Dict[str, torch.Tensor]:
    if task == "demographic_parity":
        return _compute_binary_demographic_parity(*stats)
    if task == "equal_opportunity":
        return _compute_binary_equal_opportunity(*stats)
    return {**_compute_binary_demographic_parity(*stats), **_compute_binary_equal_opportunity(*stats)}


def demographic_parity(
    preds: torch.Tensor,
    groups: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """Ratio of the lowest to the highest positive-prediction rate across groups.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import demographic_parity
        >>> result = demographic_parity(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 0, 1]))
        >>> {k: round(float(v), 4) for k, v in result.items()}
        {'DP_0_1': 0.0}
    """
    return binary_fairness(preds, None, groups, "demographic_parity", threshold, ignore_index, validate_args)


def equal_opportunity(
    preds: torch.Tensor,
    target: torch.Tensor,
    groups: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """Ratio of the lowest to the highest true-positive rate across groups.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import equal_opportunity
        >>> preds, target = torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0])
        >>> result = equal_opportunity(preds, target, torch.tensor([0, 1, 0, 1]))
        >>> {k: round(float(v), 4) for k, v in result.items()}
        {'EO_0_1': 0.0}
    """
    return binary_fairness(preds, target, groups, "equal_opportunity", threshold, ignore_index, validate_args)


def binary_fairness(
    preds: torch.Tensor,
    target: Optional[torch.Tensor],
    groups: torch.Tensor,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """Demographic parity and/or equal opportunity for binary predictions.

    The group ids are relabelled to compact ones first (one device sort and
    the count of distinct ids read on the host), so ids need not be
    contiguous and none is dropped.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_fairness
        >>> preds, target = torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0])
        >>> result = binary_fairness(preds, target, torch.tensor([0, 1, 0, 1]), task="all")
        >>> {k: round(float(v), 4) for k, v in result.items()}
        {'DP_0_1': 0.0, 'EO_0_1': 0.0}
    """
    _check_fairness_task(task)
    if task == "demographic_parity":
        if target is not None:
            rank_zero_warn("The task demographic_parity does not require a target.", UserWarning)
        target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    uniques, compact = torch.unique(groups, return_inverse=True)
    stats = _binary_groups_stat_scores(
        preds, target, compact.to(torch.int32), uniques.numel(), threshold, ignore_index, validate_args
    )
    return _fairness_compute(task, stats)
