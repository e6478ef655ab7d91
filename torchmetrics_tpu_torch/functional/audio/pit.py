"""Permutation-invariant training (PIT): a metric under the best speaker
permutation.

Speaker-wise mode scores every (target, estimate) speaker pair in one
metric call over the broadcast grid, then scores every permutation by a
gather over the cached permutation table and takes the best. Above six
speakers the table (``spk!`` rows) gives way to the Hungarian solver on the
host (``scipy.optimize.linear_sum_assignment``), fed by one device-to-host
read of the score matrix. Permutation-wise mode scores every permuted copy
in one batched metric call. Ties go to the first best permutation, as
``jnp.argmax`` and ``torch.argmax`` both choose.
"""
from __future__ import annotations

from itertools import permutations
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

_ps_cache: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _gen_permutations(spk_num: int, device: torch.device) -> torch.Tensor:
    """All permutations of ``range(spk_num)`` as a ``(spk_num!, spk_num)``
    int64 table on ``device``, made once per speaker count and device."""
    key = (spk_num, torch.device(device))
    if key not in _ps_cache:
        table = np.asarray(list(permutations(range(spk_num))), dtype=np.int64)
        _ps_cache[key] = torch.as_tensor(table, device=device)
    return _ps_cache[key]


def _best(scores: torch.Tensor, eval_func: str) -> Tuple[torch.Tensor, torch.Tensor]:
    if eval_func == "max":
        return scores.max(dim=1).values, scores.argmax(dim=1)
    return scores.min(dim=1).values, scores.argmin(dim=1)


def permutation_invariant_training(
    preds: torch.Tensor,
    target: torch.Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``metric_func`` under the best speaker permutation.

    Args:
        preds: estimates, shape ``(batch, spk, ...)``.
        target: references, shape ``(batch, spk, ...)``.
        metric_func: for ``"speaker-wise"`` a pairwise metric
            ``(preds, target) -> (batch,)``; for ``"permutation-wise"`` a
            metric over the whole ``(batch, spk, ...)``.
        mode: ``"speaker-wise"`` or ``"permutation-wise"``.
        eval_func: ``"max"`` (higher is better) or ``"min"``.
        kwargs: passed on to ``metric_func``.

    Returns:
        ``(best_metric, best_perm)`` of shapes ``(batch,)`` and ``(batch,
        spk)`` (int64), on the inputs' device.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import permutation_invariant_training
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> t = torch.arange(0, 0.5, 1 / 800.0)
        >>> target = torch.stack([torch.sin(2 * math.pi * 100 * t), torch.sin(2 * math.pi * 150 * t)])[None]
        >>> preds = target.flip(1) + 0.01 * torch.cos(2 * math.pi * 17 * t)
        >>> best, perm = permutation_invariant_training(preds, target, scale_invariant_signal_noise_ratio)
        >>> round(float(best), 4), perm.tolist()
        (40.0014, [[1, 0]])
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    batch_size, spk_num = target.shape[0:2]

    if mode == "permutation-wise":
        perms = _gen_permutations(spk_num, preds.device)
        perm_num = perms.shape[0]
        ppreds = preds[:, perms.reshape(-1)].reshape(batch_size * perm_num, *preds.shape[1:])
        ptarget = target.repeat_interleave(perm_num, dim=0)
        metric_of_ps = metric_func(ppreds, ptarget, **kwargs)
        metric_of_ps = metric_of_ps.reshape(batch_size, perm_num, -1).mean(dim=-1)
        best_metric, best_idx = _best(metric_of_ps, eval_func)
        return best_metric, perms[best_idx]

    # one metric call over the (target speaker, estimate speaker) grid
    rest = preds.shape[2:]
    p_grid = preds[:, None].expand(batch_size, spk_num, spk_num, *rest)
    t_grid = target[:, :, None].expand(batch_size, spk_num, spk_num, *rest)
    metric_mtx = metric_func(
        p_grid.reshape(batch_size * spk_num * spk_num, *rest),
        t_grid.reshape(batch_size * spk_num * spk_num, *rest),
        **kwargs,
    ).reshape(batch_size, spk_num, spk_num)

    if spk_num > 6:
        # spk! rows explode past six speakers: the assignment on the host
        from scipy.optimize import linear_sum_assignment

        mtx = metric_mtx.detach().cpu().numpy()
        best_perm = np.stack([linear_sum_assignment(m, maximize=eval_func == "max")[1] for m in mtx])
        best_metric = np.stack([m[np.arange(spk_num), p].mean() for m, p in zip(mtx, best_perm)])
        return (
            torch.as_tensor(best_metric, device=preds.device),
            torch.as_tensor(best_perm.astype(np.int64), device=preds.device),
        )

    perms = _gen_permutations(spk_num, preds.device)
    # a permutation's score: the mean of mtx[t, perm[t]] over the speakers t
    scores = metric_mtx[:, torch.arange(spk_num, device=preds.device)[None, :], perms].mean(dim=-1)
    best_metric, best_idx = _best(scores, eval_func)
    return best_metric, perms[best_idx]


def pit_permutate(preds: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``preds`` reordered on the speaker axis by a per-sample permutation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pit_permutate
        >>> preds = torch.arange(12.0).reshape(2, 3, 2)
        >>> perm = torch.tensor([[1, 0, 2], [0, 2, 1]])
        >>> pit_permutate(preds, perm).tolist()
        [[[2.0, 3.0], [0.0, 1.0], [4.0, 5.0]], [[6.0, 7.0], [10.0, 11.0], [8.0, 9.0]]]
    """
    preds, perm = torch.as_tensor(preds), torch.as_tensor(perm).to(torch.int64)
    index = perm.reshape(*perm.shape, *([1] * (preds.ndim - 2))).expand(*perm.shape, *preds.shape[2:])
    return torch.gather(preds, 1, index)
