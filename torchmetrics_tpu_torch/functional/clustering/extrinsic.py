"""Clustering metrics that compare two label assignments: mutual
information (plain, normalised, adjusted), rand and adjusted rand,
Fowlkes-Mallows, homogeneity, completeness and V-measure.

Each reduces to the contingency table (one ``bincount`` launch,
``utils.calculate_contingency_matrix``) and label entropies (one each). The
expected mutual information of the adjusted score is formed on the host in
float64 (scipy's ``gammaln``), over the (row, column, n_ij) grid a chunk of
rows at a time.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _validate_average_method_arg,
    calculate_contingency_matrix,
    calculate_entropy,
    calculate_generalized_mean,
    calculate_pair_cluster_confusion_matrix,
    check_cluster_labels,
)

#: the expected mutual information's grid is formed at most this many
#: float64 elements (128 MiB) a chunk of rows
_EMI_CHUNK_ELEMENTS = 1 << 24
_F32_EPS = torch.finfo(torch.float32).eps


def _mutual_info_score_compute(contingency: torch.Tensor) -> torch.Tensor:
    contingency = contingency.to(torch.float32)
    n = contingency.sum()
    u = contingency.sum(dim=1)
    v = contingency.sum(dim=0)
    if u.numel() == 1 or v.numel() == 1:
        return torch.tensor(0.0, device=contingency.device)
    log_outer = torch.log(u.clamp(min=1e-30))[:, None] + torch.log(v.clamp(min=1e-30))[None, :]
    terms = torch.where(
        contingency > 0,
        contingency / n * (torch.log(n) + torch.log(contingency.clamp(min=1e-30)) - log_outer),
        0.0,
    )
    return terms.sum()


def mutual_info_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mutual information of two label assignments.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mutual_info_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(mutual_info_score(preds, target)), 4)
        0.5004
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    return _mutual_info_score_compute(calculate_contingency_matrix(preds, target))


def _entropies(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.stack([calculate_entropy(preds), calculate_entropy(target)])


def normalized_mutual_info_score(
    preds: torch.Tensor, target: torch.Tensor, average_method: str = "arithmetic"
) -> torch.Tensor:
    """Mutual information over a generalised mean of the two entropies.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import normalized_mutual_info_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(normalized_mutual_info_score(preds, target)), 4)
        0.4744
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    _validate_average_method_arg(average_method)
    mutual_info = mutual_info_score(preds, target)
    if bool(mutual_info.abs() <= _F32_EPS):
        return mutual_info
    return mutual_info / calculate_generalized_mean(_entropies(preds, target), average_method)


def _emi_rows(
    a: np.ndarray, b: np.ndarray, n: float, rows: slice, nijs: np.ndarray, gln_b_nij: np.ndarray, consts: tuple
) -> np.ndarray:
    """The expected mutual information's sum over the grid of each row in ``rows``."""
    from scipy.special import gammaln

    gln_a, gln_b, gln_na, gln_nb, gln_nnij, log_nnij, log_b = consts
    n_max = nijs.shape[0] - 1
    av = a[rows][:, None, None]
    bv = b[None, :, None]
    idx = np.arange(0, n_max + 1, dtype=np.float64)[None, None, :]
    nij = nijs[None, None, :]
    start = np.maximum(1.0, av - n + bv)
    end = np.minimum(av, bv) + 1
    valid = (idx >= start) & (idx < end)
    gln = (
        gln_a[rows][:, None, None]
        + gln_b[None, :, None]
        + gln_na[rows][:, None, None]
        + gln_nb[None, :, None]
        - gln_nnij[None, None, :]
        - gammaln(np.clip(av - nij + 1, 1e-6, None))
        - gln_b_nij[None, :, :]
        - gammaln(np.clip(n - av - bv + nij + 1, 1e-6, None))
    )
    term2 = log_nnij[None, None, :] - np.log(a[rows])[:, None, None] - log_b[None, :, None]
    terms = np.where(valid, (nijs / n)[None, None, :] * term2 * np.exp(gln), 0.0)
    return terms.reshape(terms.shape[0], -1).sum(axis=1)


def expected_mutual_info_score(contingency: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Expected mutual information under the permutation model, on the host
    in float64 (the log-gamma differences cancel past float32).

    The hypergeometric terms fill a (rows, columns, n_max + 1) grid with a
    validity mask. It is formed a chunk of rows at a time, at most
    ``_EMI_CHUNK_ELEMENTS`` elements, and each row's sum is added to the
    total in row order: the same sums as one row at a time.
    """
    from scipy.special import gammaln

    cont = contingency.detach().to("cpu", torch.float64).numpy()
    a = cont.sum(axis=1)
    b = cont.sum(axis=0)
    if a.size == 1 or b.size == 1:
        return torch.tensor(0.0, device=contingency.device)
    n = float(n_samples)
    n_max = int(max(a.max(), b.max()))
    nijs = np.arange(0, n_max + 1, dtype=np.float64)
    nijs[0] = 1.0
    consts = (
        gammaln(a + 1),
        gammaln(b + 1),
        gammaln(n - a + 1),
        gammaln(n - b + 1),
        gammaln(nijs + 1) + gammaln(n + 1),
        np.log(n) + np.log(nijs),
        np.log(b),
    )
    # depends on the column and n_ij only: formed once for every row
    gln_b_nij = gammaln(np.clip(b[:, None] - nijs[None, :] + 1, 1e-6, None))
    chunk = max(1, _EMI_CHUNK_ELEMENTS // (b.size * (n_max + 1)))
    emi = 0.0
    for start in range(0, a.size, chunk):
        for row_sum in _emi_rows(a, b, n, slice(start, start + chunk), nijs, gln_b_nij, consts):
            emi += row_sum
    return torch.tensor(emi, dtype=torch.float32, device=contingency.device)


def adjusted_mutual_info_score(
    preds: torch.Tensor, target: torch.Tensor, average_method: str = "arithmetic"
) -> torch.Tensor:
    """Mutual information adjusted for chance: (MI - E[MI]) / (mean entropy - E[MI]).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import adjusted_mutual_info_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(adjusted_mutual_info_score(preds, target)), 4)
        -0.25
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _validate_average_method_arg(average_method)
    check_cluster_labels(preds, target)
    contingency = calculate_contingency_matrix(preds, target)
    mutual_info = _mutual_info_score_compute(contingency)
    emi = expected_mutual_info_score(contingency, target.numel())
    normalizer = calculate_generalized_mean(_entropies(preds, target), average_method)
    denominator = normalizer - emi
    denominator = torch.where(
        denominator < 0, denominator.clamp(max=-_F32_EPS), denominator.clamp(min=_F32_EPS)
    )
    return (mutual_info - emi) / denominator


def _pair_matrix(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    return calculate_pair_cluster_confusion_matrix(contingency=calculate_contingency_matrix(preds, target))


def rand_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Rand index from the pair confusion matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import rand_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(rand_score(preds, target)), 4)
        0.6
    """
    pair_matrix = _pair_matrix(preds, target)
    numerator = pair_matrix.diagonal().sum()
    denominator = pair_matrix.sum()
    if bool(numerator == denominator) or bool(denominator == 0):
        return torch.tensor(1.0, device=pair_matrix.device)
    return (numerator / denominator).to(torch.float32)


def adjusted_rand_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Rand index adjusted for chance, from the pair confusion matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import adjusted_rand_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(adjusted_rand_score(preds, target)), 4)
        -0.25
    """
    pair_matrix = _pair_matrix(preds, target)
    (tn, fp), (fn, tp) = pair_matrix
    if bool(fn == 0) and bool(fp == 0):
        return torch.tensor(1.0, device=pair_matrix.device)
    return (2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))).to(torch.float32)


def fowlkes_mallows_index(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Fowlkes-Mallows index: the geometric mean of pairwise precision and recall.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import fowlkes_mallows_index
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(fowlkes_mallows_index(preds, target)), 4)
        0.0
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    contingency = calculate_contingency_matrix(preds, target).to(torch.float32)
    n = preds.shape[0]
    tk = (contingency**2).sum() - n
    if bool(torch.isclose(tk, torch.zeros_like(tk))):
        return torch.tensor(0.0, device=contingency.device)
    pk = (contingency.sum(dim=0) ** 2).sum() - n
    qk = (contingency.sum(dim=1) ** 2).sum() - n
    return torch.sqrt(tk / pk) * torch.sqrt(tk / qk)


def _homogeneity_score_compute(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    check_cluster_labels(preds, target)
    if target.numel() == 0:
        zero = torch.tensor(0.0, device=target.device)
        return zero, zero, zero, zero
    entropy_target = calculate_entropy(target)
    entropy_preds = calculate_entropy(preds)
    mutual_info = mutual_info_score(preds, target)
    homogeneity = mutual_info / entropy_target if bool(entropy_target) else torch.ones_like(entropy_target)
    return homogeneity, mutual_info, entropy_preds, entropy_target


def homogeneity_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Homogeneity: each predicted cluster holds members of one class only.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import homogeneity_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(homogeneity_score(preds, target)), 4)
        0.4744
    """
    return _homogeneity_score_compute(torch.as_tensor(preds), torch.as_tensor(target))[0]


def _completeness(mutual_info: torch.Tensor, entropy_preds: torch.Tensor) -> torch.Tensor:
    return mutual_info / entropy_preds if bool(entropy_preds) else torch.ones_like(entropy_preds)


def completeness_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Completeness: every member of a class lands in the same cluster.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import completeness_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(completeness_score(preds, target)), 4)
        0.4744
    """
    _, mutual_info, entropy_preds, _ = _homogeneity_score_compute(torch.as_tensor(preds), torch.as_tensor(target))
    return _completeness(mutual_info, entropy_preds)


def v_measure_score(preds: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """V-measure: the weighted harmonic mean of homogeneity and completeness.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import v_measure_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(v_measure_score(preds, target)), 4)
        0.4744
    """
    homogeneity, mutual_info, entropy_preds, _ = _homogeneity_score_compute(
        torch.as_tensor(preds), torch.as_tensor(target)
    )
    completeness = _completeness(mutual_info, entropy_preds)
    if bool(homogeneity + completeness == 0.0):
        return torch.ones_like(homogeneity)
    return (1 + beta) * homogeneity * completeness / (beta * homogeneity + completeness)
