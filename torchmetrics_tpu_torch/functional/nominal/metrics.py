"""Nominal association: Cramér's V, Tschuprow's T, Pearson's contingency
coefficient, Theil's U (with their pairwise ``*_matrix`` variants) and
Fleiss' kappa.

Every contingency table is counted by the weightless ``bincount`` kernel
(``ops/bincount.py``) into exact int64 cells; the statistics are formed in
float32 from them, as in the JAX package (whose table is float32, exact up
to 2**24 a cell).
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import bincount, kernels  # noqa: F401  (importing bincount registers the kernel)
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    if nan_strategy not in ["replace", "drop"]:
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (float, int)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _handle_nan_in_data(
    preds: torch.Tensor, target: torch.Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NaN handling as ``(preds, target, valid)``: "replace" fills NaNs and
    keeps every row; "drop" marks rows with a NaN invalid (zero-filled)."""
    if nan_strategy == "replace":
        return (
            torch.nan_to_num(preds, nan=float(nan_replace_value)),
            torch.nan_to_num(target, nan=float(nan_replace_value)),
            torch.ones(preds.shape, dtype=torch.bool, device=preds.device),
        )
    valid = ~(torch.isnan(preds) | torch.isnan(target))
    return torch.nan_to_num(preds, nan=0.0), torch.nan_to_num(target, nan=0.0), valid


def _labels(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One label a sample: an (N, C) input is reduced by argmax."""
    preds = preds.argmax(1) if preds.ndim == 2 else preds
    target = target.argmax(1) if target.ndim == 2 else target
    return preds, target


def _count(idx: torch.Tensor, length: int) -> torch.Tensor:
    """Weightless int64 count of ``idx`` in ``[0, length)`` on the kernel."""
    return kernels.dispatch("bincount", idx.reshape(-1).to(torch.int32).contiguous(), None, int(length))[0]


def _nominal_confmat_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """``(num_classes, num_classes)`` int64 table (rows target, columns
    preds) of labels already in ``[0, num_classes)``; one ``bincount``
    launch, shared by every metric of a collection updated on the same
    tensors. Labels outside the range raise, after one host read of their
    minimum and maximum."""

    def build() -> torch.Tensor:
        p, t = _labels(preds, target)
        # integer labels stay integer: a float32 round trip would corrupt
        # label values above 2**24
        if p.is_floating_point() or t.is_floating_point():
            p, t, valid = _handle_nan_in_data(p.to(torch.float32), t.to(torch.float32), nan_strategy, nan_replace_value)
        else:
            valid = None
        both = torch.stack([p.reshape(-1), t.reshape(-1)])
        if valid is not None:
            both = torch.where(valid.reshape(1, -1), both, torch.zeros_like(both))
        if both.numel():
            lo, hi = torch.stack(torch.aminmax(both)).tolist()
            if lo < 0 or hi >= num_classes:
                raise ValueError(
                    f"Expected label values in [0, {num_classes}), but got values in"
                    f" [{float(lo)}, {float(hi)}]. Relabel the data or raise `num_classes`."
                )
        p = torch.clamp(p.to(torch.int32), 0, num_classes - 1)
        idx = t.to(torch.int32) * num_classes + p
        if valid is not None:
            idx = torch.where(valid, idx, torch.full_like(idx, -1))
        return _count(idx, num_classes * num_classes).reshape(num_classes, num_classes)

    return kernels.shared_result((preds, target), ("nominal_confmat", num_classes, nan_strategy, nan_replace_value), build)


def _nominal_confmat_from_values(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Int64 table over ARBITRARY label values (the functional path): a
    joint sorted relabel makes non-contiguous and non-zero-based labels
    work, then one ``bincount`` launch counts the table."""
    preds, target = _labels(preds, target)
    if preds.is_floating_point() or target.is_floating_point():
        preds, target, valid = _handle_nan_in_data(
            preds.to(torch.float32), target.to(torch.float32), nan_strategy, nan_replace_value
        )
        preds, target = preds[valid], target[valid]
    preds, target = preds.reshape(-1).contiguous(), target.reshape(-1).contiguous()
    uniques = torch.unique(torch.cat([preds, target]))
    num_classes = int(uniques.shape[0])
    if num_classes == 0:
        return torch.zeros((0, 0), dtype=torch.int64, device=preds.device)
    idx = torch.searchsorted(uniques, target) * num_classes + torch.searchsorted(uniques, preds)
    return _count(idx, num_classes * num_classes).reshape(num_classes, num_classes)


def _reduced_stats(confmat: torch.Tensor):
    """Chi-square ingredients on the full table, all-zero rows and columns
    masked (they contribute nothing) instead of dropped."""
    confmat = confmat.to(torch.float32)
    rows = confmat.sum(1)
    cols = confmat.sum(0)
    num_rows = (rows != 0).sum().to(torch.float32)
    num_cols = (cols != 0).sum().to(torch.float32)
    total = confmat.sum()
    expected = torch.outer(rows, cols) / total
    return confmat, expected, num_rows, num_cols, total


def _compute_chi_squared_masked(
    confmat: torch.Tensor, expected: torch.Tensor, num_rows: torch.Tensor, num_cols: torch.Tensor, bias_correction: bool
) -> torch.Tensor:
    """Chi-square test of independence (after scipy), with Yates' correction
    at one degree of freedom when ``bias_correction``."""
    df = num_rows * num_cols - num_rows - num_cols + 1
    if bias_correction:
        diff = expected - confmat
        direction = torch.sign(diff)
        corrected = confmat + direction * torch.clamp(torch.abs(direction), max=0.5)
        confmat = torch.where(df == 1, corrected, confmat)
    safe = torch.where(expected > 0, expected, torch.ones_like(expected))
    chi = torch.where(expected > 0, (confmat - expected) ** 2 / safe, torch.zeros_like(expected)).sum()
    return torch.where(df == 0, torch.zeros_like(chi), chi)


def _compute_bias_corrected_values(
    phi_squared: torch.Tensor, num_rows: torch.Tensor, num_cols: torch.Tensor, confmat_sum: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    phi_squared_corrected = torch.clamp(phi_squared - ((num_rows - 1) * (num_cols - 1)) / (confmat_sum - 1), min=0.0)
    rows_corrected = num_rows - (num_rows - 1) ** 2 / (confmat_sum - 1)
    cols_corrected = num_cols - (num_cols - 1) ** 2 / (confmat_sum - 1)
    return phi_squared_corrected, rows_corrected, cols_corrected


def _bias_correction_warning(cond: torch.Tensor, metric_name: str) -> None:
    if bool(cond):
        rank_zero_warn(
            f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`.",
            UserWarning,
        )


def _corrected_or_plain(confmat: torch.Tensor, bias_correction: bool, metric_name: str, denominator: Callable) -> torch.Tensor:
    """``sqrt(phi^2 / denominator(rows - 1, cols - 1))`` clipped to [0, 1]:
    Cramér's V (``min``) and Tschuprow's T (``sqrt`` of the product)."""
    confmat, expected, num_rows, num_cols, cm_sum = _reduced_stats(confmat)
    chi_squared = _compute_chi_squared_masked(confmat, expected, num_rows, num_cols, bias_correction)
    phi_squared = chi_squared / cm_sum
    if bias_correction:
        phi_sq_c, rows_c, cols_c = _compute_bias_corrected_values(phi_squared, num_rows, num_cols, cm_sum)
        unusable = torch.minimum(rows_c, cols_c) == 1
        _bias_correction_warning(unusable, metric_name)
        value = torch.sqrt(phi_sq_c / torch.clamp(denominator(rows_c - 1, cols_c - 1), min=1e-12))
        return torch.where(unusable, torch.full_like(value, float("nan")), torch.clamp(value, 0.0, 1.0))
    value = torch.sqrt(phi_squared / torch.clamp(denominator(num_rows - 1, num_cols - 1), min=1e-12))
    return torch.clamp(value, 0.0, 1.0)


def _cramers_v_compute(confmat: torch.Tensor, bias_correction: bool) -> torch.Tensor:
    return _corrected_or_plain(confmat, bias_correction, "Cramer's V", torch.minimum)


def cramers_v(
    preds: torch.Tensor,
    target: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Cramér's V: sqrt(phi^2 / min(r-1, k-1)).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cramers_v
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0])
        >>> round(float(cramers_v(preds, target)), 4)
        0.6667
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _nominal_confmat_from_values(preds, target, nan_strategy, nan_replace_value)
    return _cramers_v_compute(confmat, bias_correction)


def _tschuprows_t_compute(confmat: torch.Tensor, bias_correction: bool) -> torch.Tensor:
    return _corrected_or_plain(confmat, bias_correction, "Tschuprow's T", lambda r, c: torch.sqrt(r * c))


def tschuprows_t(
    preds: torch.Tensor,
    target: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Tschuprow's T: sqrt(phi^2 / sqrt((r-1)(k-1))).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tschuprows_t
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0])
        >>> round(float(tschuprows_t(preds, target)), 4)
        0.6667
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _nominal_confmat_from_values(preds, target, nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(confmat, bias_correction)


def _pearsons_contingency_coefficient_compute(confmat: torch.Tensor) -> torch.Tensor:
    confmat, expected, num_rows, num_cols, cm_sum = _reduced_stats(confmat)
    chi_squared = _compute_chi_squared_masked(confmat, expected, num_rows, num_cols, bias_correction=False)
    phi_squared = chi_squared / cm_sum
    return torch.clamp(torch.sqrt(phi_squared / (1 + phi_squared)), 0.0, 1.0)


def pearsons_contingency_coefficient(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Pearson's contingency coefficient: sqrt(phi^2 / (1 + phi^2)).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearsons_contingency_coefficient
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0])
        >>> round(float(pearsons_contingency_coefficient(preds, target)), 4)
        0.7559
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _nominal_confmat_from_values(preds, target, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(confmat)


def _conditional_entropy_compute(confmat: torch.Tensor) -> torch.Tensor:
    total = confmat.sum()
    p_xy = confmat / total
    p_y = confmat.sum(1) / total
    nonzero = p_xy > 0
    ratio = torch.where(nonzero, p_y[:, None] / torch.where(nonzero, p_xy, torch.ones_like(p_xy)), torch.ones_like(p_xy))
    return torch.where(nonzero, p_xy * torch.log(ratio), torch.zeros_like(p_xy)).sum()


def _theils_u_compute(confmat: torch.Tensor) -> torch.Tensor:
    # all-zero rows and columns add nothing to either entropy
    confmat = confmat.to(torch.float32)
    s_xy = _conditional_entropy_compute(confmat)
    total = confmat.sum()
    p_x = confmat.sum(0) / total
    nonzero = p_x > 0
    s_x = -torch.where(nonzero, p_x * torch.log(torch.where(nonzero, p_x, torch.ones_like(p_x))), torch.zeros_like(p_x)).sum()
    zero = s_x == 0
    return torch.where(zero, torch.zeros_like(s_x), (s_x - s_xy) / torch.where(zero, torch.ones_like(s_x), s_x))


def theils_u(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Theil's U (uncertainty coefficient): (H(X) - H(X|Y)) / H(X). Asymmetric.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import theils_u
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0])
        >>> round(float(theils_u(preds, target)), 4)
        0.7103
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _nominal_confmat_from_values(preds, target, nan_strategy, nan_replace_value)
    return _theils_u_compute(confmat)


def _matrix_variant(pair_fn: Callable, matrix: torch.Tensor, symmetric: bool, **kwargs) -> torch.Tensor:
    """``pair_fn`` over every pair of columns (both orders when asymmetric),
    ones on the diagonal."""
    num_variables = matrix.shape[1]
    out = torch.ones((num_variables, num_variables), dtype=torch.float32, device=matrix.device)
    for i, j in itertools.combinations(range(num_variables), 2):
        x, y = matrix[:, i], matrix[:, j]
        if symmetric:
            out[i, j] = out[j, i] = pair_fn(x, y, **kwargs)
        else:
            out[i, j] = pair_fn(x, y, **kwargs)
            out[j, i] = pair_fn(y, x, **kwargs)
    return out


def cramers_v_matrix(
    matrix: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Pairwise Cramér's V over feature columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cramers_v_matrix
        >>> matrix = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [2, 2]])
        >>> cramers_v_matrix(matrix).round(decimals=4).tolist()
        [[1.0, 0.0], [0.0, 1.0]]
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _matrix_variant(
        cramers_v, matrix, True, bias_correction=bias_correction, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value
    )


def tschuprows_t_matrix(
    matrix: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Pairwise Tschuprow's T over feature columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tschuprows_t_matrix
        >>> matrix = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [2, 2]])
        >>> tschuprows_t_matrix(matrix).round(decimals=4).tolist()
        [[1.0, 0.0], [0.0, 1.0]]
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _matrix_variant(
        tschuprows_t, matrix, True, bias_correction=bias_correction, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value
    )


def pearsons_contingency_coefficient_matrix(
    matrix: torch.Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> torch.Tensor:
    """Pairwise Pearson contingency coefficient over feature columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearsons_contingency_coefficient_matrix
        >>> matrix = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [2, 2]])
        >>> pearsons_contingency_coefficient_matrix(matrix).round(decimals=4).tolist()
        [[1.0, 0.5774000287055969], [0.5774000287055969, 1.0]]
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _matrix_variant(
        pearsons_contingency_coefficient, matrix, True, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value
    )


def theils_u_matrix(
    matrix: torch.Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> torch.Tensor:
    """Pairwise (asymmetric) Theil's U over feature columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import theils_u_matrix
        >>> matrix = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [2, 2]])
        >>> theils_u_matrix(matrix).round(decimals=4).tolist()
        [[1.0, 0.36910000443458557], [0.36910000443458557, 1.0]]
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _matrix_variant(theils_u, matrix, False, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value)


def _fleiss_kappa_update(ratings: torch.Tensor, mode: str = "counts") -> torch.Tensor:
    """Per-sample category counts: as given (``"counts"``, (N, C) integers),
    or the raters' argmax one-hot summed (``"probs"``, (N, C, R) floats)."""
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        num_categories = ratings.shape[1]
        winners = ratings.argmax(dim=1)  # (n_samples, n_raters)
        one_hot = (winners[..., None] == torch.arange(num_categories, device=ratings.device)).to(torch.int32)
        return one_hot.sum(dim=1, dtype=torch.int32)  # (n_samples, n_categories)
    if ratings.ndim != 2 or ratings.is_floating_point():
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return ratings


def _fleiss_kappa_compute(counts: torch.Tensor) -> torch.Tensor:
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = counts.sum(1).max()
    p_i = counts.sum(dim=0) / (total * num_raters)
    p_j = ((counts**2).sum(dim=1) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = p_j.mean()
    pe_bar = (p_i**2).sum()
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings: torch.Tensor, mode: str = "counts") -> torch.Tensor:
    """Fleiss' kappa inter-rater agreement over a [n_samples, n_categories] counts matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import fleiss_kappa
        >>> ratings = torch.tensor([[2, 1, 0], [1, 2, 0], [0, 1, 2], [3, 0, 0]])
        >>> round(float(fleiss_kappa(ratings)), 4)
        0.1818
    """
    if mode not in ["counts", "probs"]:
        raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'.")
    return _fleiss_kappa_compute(_fleiss_kappa_update(ratings, mode))
