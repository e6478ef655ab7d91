"""Clustering helpers: the contingency table, label entropy, the pair
confusion matrix and the argument checks.

The contingency table, which every extrinsic clustering metric reduces to,
is one weightless count on the ``bincount`` kernel (``ops/bincount.py``):
both labelings are relabelled to ``[0, n)`` by ``torch.unique`` and the
``target * n_preds + preds`` pairs are counted into exact int64 cells. A
label entropy is one such count of one labeling.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from torchmetrics_tpu_torch.ops import bincount, kernels  # noqa: F401  (importing bincount registers the kernel)
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

#: the flattened cell index is int32 on the kernel
_MAX_CELLS = 2**31 - 1


def _count(idx: torch.Tensor, length: int) -> torch.Tensor:
    """Weightless int64 count of ``idx`` in ``[0, length)``: one launch of
    the ``bincount`` kernel on a CUDA tensor."""
    return kernels.dispatch("bincount", idx.reshape(-1).to(torch.int32).contiguous(), None, int(length))[0]


def is_nonnegative(x: torch.Tensor, atol: float = 1e-5) -> bool:
    return bool((x >= -atol).all())


def _validate_average_method_arg(average_method: str) -> None:
    if average_method not in ("min", "geometric", "arithmetic", "max"):
        raise ValueError(
            "Expected argument `average_method` to be one of `min`, `geometric`, `arithmetic`, `max`,"
            f" but got {average_method}"
        )


def calculate_entropy(x: torch.Tensor) -> torch.Tensor:
    """Entropy of a label assignment (float32; 1.0 for no labels)."""
    x = torch.as_tensor(x).reshape(-1)
    if x.numel() == 0:
        return torch.tensor(1.0, device=x.device)
    uniques, inv = torch.unique(x, return_inverse=True)
    p = _count(inv, uniques.numel())
    p = p[p > 0]
    if p.numel() == 1:
        return torch.tensor(0.0, device=x.device)
    n = p.sum()
    return -((p / n) * (torch.log(p) - torch.log(n))).sum()


def calculate_generalized_mean(x: torch.Tensor, p: Union[int, str]) -> torch.Tensor:
    """Power mean of ``x``, or its min, geometric mean, arithmetic mean or max."""
    if x.is_complex() or not is_nonnegative(x):
        raise ValueError("`x` must contain positive real numbers")
    if isinstance(p, str):
        if p == "min":
            return x.min()
        if p == "geometric":
            return torch.exp(torch.log(x).mean())
        if p == "arithmetic":
            return x.mean()
        if p == "max":
            return x.max()
        raise ValueError("'method' must be 'min', 'geometric', 'arirthmetic', or 'max'")
    return torch.pow(x, p).mean() ** (1.0 / p)


def calculate_contingency_matrix(
    preds: torch.Tensor, target: torch.Tensor, eps: Optional[float] = None
) -> torch.Tensor:
    """Contingency table of shape ``(n_classes_target, n_classes_preds)``:
    exact int64 counts (one ``bincount`` launch), or float32 plus ``eps``."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if preds.ndim != 1 or target.ndim != 1:
        raise ValueError(f"Expected 1d `preds` and `target` but got {preds.ndim} and {target.ndim}.")
    preds_uniques, preds_idx = torch.unique(preds, return_inverse=True)
    target_uniques, target_idx = torch.unique(target, return_inverse=True)
    n_p, n_t = preds_uniques.numel(), target_uniques.numel()
    if n_t * n_p > _MAX_CELLS:
        raise ValueError(f"A contingency table of {n_t} x {n_p} cells is past the count's int32 index")
    contingency = _count(target_idx * n_p + preds_idx, n_t * n_p).reshape(n_t, n_p)
    if eps is not None:
        contingency = contingency.to(torch.float32) + eps
    return contingency


def _is_real_discrete_label(x: torch.Tensor) -> bool:
    if x.ndim != 1:
        raise ValueError(f"Expected arguments to be 1-d tensors but got {x.ndim}-d tensors.")
    return not (x.is_floating_point() or x.is_complex())


def check_cluster_labels(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Check that ``preds`` and ``target`` are 1-D discrete labels of one shape."""
    _check_same_shape(preds, target)
    if not (_is_real_discrete_label(preds) and _is_real_discrete_label(target)):
        raise ValueError(f"Expected real, discrete values but received {preds.dtype} and {target.dtype}.")


def _validate_intrinsic_cluster_data(data: torch.Tensor, labels: torch.Tensor) -> None:
    if data.ndim != 2:
        raise ValueError(f"Expected 2D data, got {data.ndim}D data instead")
    if not data.is_floating_point():
        raise ValueError(f"Expected floating point data, got {data.dtype} data instead")
    if labels.ndim != 1:
        raise ValueError(f"Expected 1D labels, got {labels.ndim}D labels instead")


def _validate_intrinsic_labels_to_samples(num_labels: int, num_samples: int) -> None:
    if not 1 < num_labels < num_samples:
        raise ValueError(
            "Number of detected clusters must be greater than one and less than the number of samples."
            f"Got {num_labels} clusters and {num_samples} samples."
        )


def calculate_pair_cluster_confusion_matrix(
    preds: Optional[torch.Tensor] = None,
    target: Optional[torch.Tensor] = None,
    contingency: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2 x 2 confusion matrix over ordered sample pairs (same or different
    cluster in ``target`` against ``preds``).

    From an integer table the four cells are formed exactly in int64 and
    converted to float32 once (the JAX package forms them in float32, which
    rounds ``n_samples**2`` past 4,096 samples); a float table keeps its
    float dtype (float64, else float32) throughout.
    """
    if preds is None and target is None and contingency is None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`.")
    if preds is not None and target is not None and contingency is not None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`, not both.")
    if contingency is None:
        contingency = calculate_contingency_matrix(preds, target)
    contingency = torch.as_tensor(contingency)
    if contingency.is_floating_point():
        dtype = torch.float64 if contingency.dtype == torch.float64 else torch.float32
        work = contingency.to(dtype)
    else:
        dtype, work = torch.float32, contingency.to(torch.int64)
    n_samples = work.sum()
    sum_squares = (work**2).sum()
    # (contingency @ n_k).sum() is the sum of the squared column sums, and
    # (contingency.T @ n_c).sum() that of the squared row sums
    col_squares = (work.sum(dim=0) ** 2).sum()
    row_squares = (work.sum(dim=1) ** 2).sum()
    same_same = sum_squares - n_samples
    diff_same = col_squares - sum_squares
    same_diff = row_squares - sum_squares
    diff_diff = n_samples**2 - diff_same - same_diff - sum_squares
    return torch.stack([torch.stack([diff_diff, diff_same]), torch.stack([same_diff, same_same])]).to(dtype)
