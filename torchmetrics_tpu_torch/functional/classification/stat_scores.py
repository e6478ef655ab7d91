"""Stat-scores (tp/fp/tn/fn): the per-metric decomposition of the classification family.

``_arg_validation`` -> ``_tensor_validation`` -> ``_format`` -> ``_update`` ->
``_compute`` for each of binary / multiclass / multilabel, plus the
task-dispatching ``stat_scores``, as in the JAX package:

- "sigmoid if logits" is a ``torch.where`` on a device-side ``any``, so a
  CUDA update never waits for the device;
- ``ignore_index`` is masked by weight, so shapes never depend on the data;
- multiclass counts use the flattened confusion-matrix trick
  ``scatter(C*target + preds, length=C*C)``; ``top_k > 1`` uses a one-hot
  top-k mask.

Counts come back as int32, the JAX package's count dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_shape, _unique_values
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.data import select_topk
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _sigmoid_if_logits(preds: torch.Tensor) -> torch.Tensor:
    """Apply sigmoid iff any value lies outside [0, 1] (a device-side select)."""
    needs = torch.any((preds < 0) | (preds > 1))
    return torch.where(needs, torch.sigmoid(preds), preds)


def _softmax_if_logits(preds: torch.Tensor, dim: int = 1) -> torch.Tensor:
    needs = torch.any((preds < 0) | (preds > 1))
    return torch.where(needs, torch.softmax(preds, dim=dim), preds)


def _count(mask: torch.Tensor, dim) -> torch.Tensor:
    return mask.sum(dim, dtype=torch.int32)


def _plain_confusion_counts(idx: torch.Tensor, length: int) -> torch.Tensor:
    """The per-metric scatter of the unfused path (the JAX package leaves it to
    an XLA scatter, not to the kernel): int64 counts of ``idx`` in
    ``[0, length)``, exact at any N; an index of -1 (a masked sample) is
    counted in a slot before the first and dropped."""
    idx = idx.reshape(-1).to(torch.int64) + 1
    counts = torch.zeros(length + 1, dtype=torch.int64, device=idx.device)
    return counts.index_add_(0, idx, torch.ones_like(idx))[1:]


# --------------------------------------------------------------------- binary

def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_stat_scores_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    unique_values = _unique_values(target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique_values.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if not preds.is_floating_point():
        unique_p = _unique_values(preds)
        if not unique_p.issubset({0, 1}):
            raise RuntimeError(
                f"Detected the following values in `preds`: {sorted(unique_p)} but expected only"
                " the following values [0,1] since preds is a label tensor."
            )
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")


def _binary_stat_scores_format(
    preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (preds01, target01, valid_mask), shapes preserved."""
    if preds.is_floating_point():
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    else:
        preds = preds.to(torch.int32)
    if ignore_index is not None:
        valid = target != ignore_index
    else:
        valid = torch.ones_like(target, dtype=torch.bool)
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    preds = torch.where(valid, preds, torch.zeros_like(preds))
    return preds, target, valid


def _binary_stat_scores_update(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, multidim_average: str = "global"
) -> Stats:
    if multidim_average == "global":
        preds, target, valid = preds.reshape(-1), target.reshape(-1), valid.reshape(-1)
        dim = 0
    else:
        preds = preds.reshape(preds.shape[0], -1)
        target = target.reshape(target.shape[0], -1)
        valid = valid.reshape(valid.shape[0], -1)
        dim = 1
    tp = _count((target == preds) & (target == 1) & valid, dim)
    fn = _count((target != preds) & (target == 1) & valid, dim)
    fp = _count((target != preds) & (target == 0) & valid, dim)
    tn = _count((target == preds) & (target == 0) & valid, dim)
    return tp, fp, tn, fn


def _binary_stat_scores_compute(
    tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor, multidim_average: str = "global"
) -> torch.Tensor:
    stacked = torch.stack([tp, fp, tn, fn, tp + fn], dim=0 if tp.ndim == 0 or multidim_average == "global" else 1)
    return stacked.squeeze() if multidim_average == "global" else stacked


def binary_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn and support for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_stat_scores
        >>> binary_stat_scores(torch.tensor([0.1, 0.9, 0.8, 0.3]), torch.tensor([0, 1, 0, 1])).tolist()
        [1, 1, 1, 1, 2]
    """
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, valid, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# ----------------------------------------------------------------- multiclass

def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) and top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_stat_scores_tensor_validation(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError("If `preds` have one dimension more than `target`, the shape of `preds` should "
                             " be at least 3D when multidim_average is set to `samplewise`")
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape.")
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError("When `preds` and `target` have the same shape, the shape should be at least 2D when"
                             " multidim_average is set to `samplewise`")
    else:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be"
                         " (N, ...) and `preds` should be (N, C, ...).")
    if target.numel() == 0:
        return
    # one device sort and one host read for the target checks
    uniques = torch.unique(target)
    num_unique, t_max = uniques.numel(), int(uniques[-1])
    check_value = num_classes if ignore_index is None else num_classes + 1
    if num_unique > check_value or (t_max >= num_classes and (ignore_index is None or t_max != ignore_index)):
        raise RuntimeError(f"Detected more unique values in `target` than expected. Expected only {check_value} but found"
                           f" {num_unique} in `target`.")
    if not preds.is_floating_point() and preds.numel() and int(preds.max()) >= num_classes:
        raise RuntimeError(f"Detected more unique values in `preds` than expected. Expected only {num_classes} but found"
                           f" more in `preds`.")


def _multiclass_stat_scores_format(
    preds: torch.Tensor, target: torch.Tensor, top_k: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convert probability/logit preds to labels (top_k == 1) and flatten extra dims."""
    if preds.ndim == target.ndim + 1 and top_k == 1:
        preds = preds.argmax(dim=1)
    if top_k == 1:
        preds = preds.reshape(preds.shape[0], -1) if preds.ndim > 1 else preds.reshape(preds.shape[0])
    target = target.reshape(target.shape[0], -1) if target.ndim > 1 else target.reshape(target.shape[0])
    return preds, target


def _multiclass_stat_scores_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Stats:
    """Count tp/fp/tn/fn per class.

    top_k == 1: flattened confusion-matrix scatter (an ignored sample indexes -1).
    top_k > 1: one-hot top-k mask path.
    """
    if top_k > 1:
        preds_mask = select_topk(preds, topk=top_k, dim=1)  # (N, C, ...)
        classes = torch.arange(num_classes, device=target.device).reshape((1, num_classes) + (1,) * (target.ndim - 1))
        target_oh = (target.unsqueeze(1) == classes).to(torch.int32)  # out-of-range rows are all zero
        if ignore_index is not None:
            valid = (target != ignore_index).unsqueeze(1).to(torch.int32)
        else:
            valid = torch.ones_like(target, dtype=torch.int32).unsqueeze(1)
        # ignored positions contribute to no bucket
        sum_dims = (0,) + tuple(range(2, preds_mask.ndim)) if multidim_average == "global" else tuple(range(2, preds_mask.ndim))
        tp = _count(preds_mask * target_oh * valid, sum_dims)
        fp = _count(preds_mask * (1 - target_oh) * valid, sum_dims)
        fn = _count((1 - preds_mask) * target_oh * valid, sum_dims)
        tn = _count((1 - preds_mask) * (1 - target_oh) * valid, sum_dims)
        return tp, fp, tn, fn

    n = preds.shape[0]
    samplewise = multidim_average != "global"
    p = preds.reshape(n, -1) if samplewise else preds.reshape(-1)
    t = target.reshape(n, -1) if samplewise else target.reshape(-1)
    p = torch.clamp(p, 0, num_classes - 1)
    idx = num_classes * t + p
    if samplewise:
        idx = torch.arange(n, device=t.device)[:, None] * num_classes * num_classes + idx
    if ignore_index is not None:
        idx = torch.where(t != ignore_index, idx, -1)
    if not samplewise:
        confmat = _plain_confusion_counts(idx, num_classes * num_classes).reshape(num_classes, num_classes)
        tp = torch.diagonal(confmat)
        fp = confmat.sum(0) - tp
        fn = confmat.sum(1) - tp
        tn = confmat.sum() - tp - fp - fn
    else:
        confmat = _plain_confusion_counts(idx, n * num_classes * num_classes).reshape(n, num_classes, num_classes)
        tp = torch.diagonal(confmat, dim1=1, dim2=2)
        fp = confmat.sum(1) - tp
        fn = confmat.sum(2) - tp
        tn = confmat.sum((1, 2))[:, None] - tp - fp - fn
    return tuple(s.to(torch.int32) for s in (tp, fp, tn, fn))  # type: ignore[return-value]


def _multiclass_stat_scores_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> torch.Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        # scalar states are already class-aggregated
        return res.sum(sum_dim) if res.ndim > 1 else res
    if average in ("macro", "weighted"):
        res = res.to(torch.float32)
        weights = (tp + fn).to(torch.float32) if average == "weighted" else torch.ones_like(tp, dtype=torch.float32)
        w = _safe_divide(weights, weights.sum(-1, keepdim=True) if weights.ndim else weights.sum())
        return (res * (w[..., None] if res.ndim > w.ndim else w)).sum(sum_dim)
    return res


def multiclass_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn and support for multiclass tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_stat_scores
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])
        >>> multiclass_stat_scores(preds, torch.tensor([0, 1, 2, 0]), num_classes=3, average="micro").tolist()
        [3, 1, 7, 1, 4]
    """
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    if top_k == 1:
        preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ----------------------------------------------------------------- multilabel

def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multilabel_stat_scores_tensor_validation(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )
    unique_values = _unique_values(target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique_values.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if not preds.is_floating_point():
        unique_p = _unique_values(preds)
        if not unique_p.issubset({0, 1}):
            raise RuntimeError(
                f"Detected the following values in `preds`: {sorted(unique_p)} but expected only 0s and 1s since preds"
                " is a label tensor."
            )
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")


def _multilabel_stat_scores_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if preds.is_floating_point():
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    else:
        preds = preds.to(torch.int32)
    preds = preds.reshape(*preds.shape[:2], -1)
    target = target.reshape(*target.shape[:2], -1)
    if ignore_index is not None:
        valid = target != ignore_index
    else:
        valid = torch.ones_like(target, dtype=torch.bool)
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    preds = torch.where(valid, preds, torch.zeros_like(preds))
    return preds, target, valid


def _multilabel_stat_scores_update(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, multidim_average: str = "global"
) -> Stats:
    sum_dims = (0, -1) if multidim_average == "global" else (-1,)
    tp = _count((target == preds) & (target == 1) & valid, sum_dims)
    fn = _count((target != preds) & (target == 1) & valid, sum_dims)
    fp = _count((target != preds) & (target == 0) & valid, sum_dims)
    tn = _count((target == preds) & (target == 0) & valid, sum_dims)
    return tp, fp, tn, fn


def _multilabel_stat_scores_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> torch.Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(sum_dim)
    if average == "macro":
        return res.to(torch.float32).mean(sum_dim)
    if average == "weighted":
        # weights normalised by the GLOBAL support sum even samplewise, and a
        # plain division (zero total support yields NaN), as in the JAX package
        res = res.to(torch.float32)
        weights = (tp + fn).to(torch.float32)
        w = weights / weights.sum()
        return (res * w[..., None]).sum(sum_dim)
    return res


def multilabel_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn and support for multilabel tasks."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, valid = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, valid, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ------------------------------------------------------------------- dispatch

def stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: Optional[str] = "global",
    top_k: Optional[int] = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task-dispatching stat scores."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_stat_scores(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
