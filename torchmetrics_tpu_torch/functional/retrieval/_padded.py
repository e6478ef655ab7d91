"""Padded per-query retrieval kernels.

As in the JAX package, the ragged per-query groups are packed into one
static ``(num_queries, max_docs)`` grid (preds padded with -inf, targets with
0) and every metric is a batched masked tensor expression over that grid,
instead of a Python loop over queries.

All functions take the grid sorted per row by descending score
(``ranked_target``: the targets in retrieval order) plus the per-query
document counts, and return one value per query. Precision, recall,
fall-out and hit rate read their masked sums from the
``retrieval_topk_stats`` kernel (ops/topk_kernel.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops.topk_kernel import retrieval_topk_stats
from torchmetrics_tpu_torch.utils.compute import _safe_divide


def pad_by_query(
    indexes: torch.Tensor, preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack flat (doc -> query) data into a ``(Q, L)`` grid.

    Returns ``(preds_pad, target_pad, counts)``: ``preds_pad`` is -inf and
    ``target_pad`` 0 beyond each query's document count, counts are int32.
    Queries keep the order of their ids, documents the order they arrived in.
    The one explicit host read is ``counts.max()`` (the grid's width);
    ``torch.unique`` waits for the device as well, for its output size.
    """
    indexes = indexes.reshape(-1)
    preds = preds.reshape(-1).to(torch.float32)
    target = target.reshape(-1)

    order = torch.argsort(indexes, stable=True)
    indexes, preds, target = indexes[order], preds[order], target[order]

    unique, counts = torch.unique(indexes, return_counts=True)
    num_queries = int(unique.shape[0])
    max_docs = int(counts.max())

    row = torch.searchsorted(unique, indexes)
    offsets = torch.cumsum(counts, 0) - counts
    col = torch.arange(indexes.shape[0], device=indexes.device) - offsets[row]

    preds_pad = torch.full((num_queries, max_docs), float("-inf"), dtype=torch.float32, device=preds.device)
    preds_pad[row, col] = preds
    target_pad = torch.zeros((num_queries, max_docs), dtype=torch.float32, device=preds.device)
    target_pad[row, col] = target.to(torch.float32)
    return preds_pad, target_pad, counts.to(torch.int32)


def rank_by_preds(preds_pad: torch.Tensor, target_pad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by descending score, stably (tied documents keep their
    order, as in the JAX package); returns ``(ranked_preds, ranked_target)``."""
    order = torch.argsort(-preds_pad, dim=-1, stable=True)
    return torch.gather(preds_pad, -1, order), torch.gather(target_pad, -1, order)


def _positions(length: int, device: torch.device) -> torch.Tensor:
    return torch.arange(length, device=device)[None, :]


def _ranks(length: int, device: torch.device) -> torch.Tensor:
    """1-based float32 ranks, ``(1, L)``."""
    return torch.arange(1, length + 1, device=device, dtype=torch.float32)[None, :]


def _topk_mask(counts: torch.Tensor, top_k: Optional[int], length: int) -> torch.Tensor:
    """``(Q, L)`` mask of ranks below ``min(top_k, count_q)``."""
    k = counts[:, None] if top_k is None else torch.clamp(counts[:, None], max=top_k)
    return _positions(length, counts.device) < k


def hit_counts(ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int]) -> torch.Tensor:
    """Number of relevant documents in the top k of each query."""
    return retrieval_topk_stats(ranked_target, counts, top_k)[:, 0]


def precision_padded(
    ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int] = None, adaptive_k: bool = False
) -> torch.Tensor:
    """Precision@k per query."""
    hits = retrieval_topk_stats(ranked_target, counts, top_k)[:, 0]
    if top_k is None:
        denom = counts
    elif adaptive_k:
        denom = torch.clamp(counts, max=top_k)
    else:
        denom = torch.full_like(counts, top_k)
    return _safe_divide(hits, denom.to(hits.dtype))


def recall_padded(ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """Recall@k per query."""
    stats = retrieval_topk_stats(ranked_target, counts, top_k)
    return _safe_divide(stats[:, 0], stats[:, 1])


def fall_out_padded(ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """Fall-out@k per query: non-relevant retrieved over all non-relevant."""
    stats = retrieval_topk_stats(ranked_target, counts, top_k)
    return _safe_divide(stats[:, 2], stats[:, 3])


def hit_rate_padded(ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """1.0 where a relevant document is in the top k."""
    return (retrieval_topk_stats(ranked_target, counts, top_k)[:, 0] > 0).to(torch.float32)


def average_precision_padded(
    ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int] = None
) -> torch.Tensor:
    """AP per query: the mean of precision@rank over the relevant ranks in the top k."""
    length = ranked_target.shape[-1]
    t = ranked_target * _topk_mask(counts, top_k, length)
    prec_at_rank = torch.cumsum(t, dim=-1) / _ranks(length, t.device)
    return _safe_divide((t * prec_at_rank).sum(-1), t.sum(-1))


def reciprocal_rank_padded(
    ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int] = None
) -> torch.Tensor:
    """RR per query: 1/rank of the first relevant document in the top k; 0 if none."""
    length = ranked_target.shape[-1]
    mask = _topk_mask(counts, top_k, length)
    rr = torch.where(mask & (ranked_target > 0), 1.0 / _ranks(length, ranked_target.device), 0.0)
    return rr.amax(-1)


def r_precision_padded(ranked_target: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Precision at k = the number of relevant documents, per query."""
    total = ranked_target.sum(-1)
    pos = _positions(ranked_target.shape[-1], ranked_target.device)
    hits = (ranked_target * (pos < total[:, None])).sum(-1)
    return _safe_divide(hits, total)


def _row_segment_ids(ranked_preds: torch.Tensor) -> torch.Tensor:
    """Tie-group ids per row (int64): consecutive equal scores share an id."""
    boundary = ranked_preds[:, 1:] != ranked_preds[:, :-1]
    first = torch.zeros((ranked_preds.shape[0], 1), dtype=torch.int64, device=ranked_preds.device)
    return torch.cat([first, torch.cumsum(boundary, dim=-1)], dim=-1)


def _segment_sum(values: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Per-row sums of ``values`` over the segments ``gid`` (``L`` segments a row)."""
    return torch.zeros_like(values).scatter_add_(1, gid, values)


def dcg_padded(
    ranked_preds: torch.Tensor,
    ranked_target: torch.Tensor,
    counts: torch.Tensor,
    top_k: Optional[int],
    ignore_ties: bool,
) -> torch.Tensor:
    """Tie-averaged discounted cumulative gain per query: tied scores share
    the average of their positions' discounts. The per-row tie groups are
    summed with one ``scatter_add_`` each (the JAX package's vmapped
    ``segment_sum``)."""
    length = ranked_target.shape[-1]
    pos = _positions(length, ranked_target.device)
    cut = length if top_k is None else min(top_k, length)
    discount = torch.where(pos < cut, 1.0 / torch.log2(pos + 2.0), 0.0).to(torch.float32)
    discount = discount * torch.ones((ranked_target.shape[0], 1), device=ranked_target.device)

    if ignore_ties:
        return (discount * ranked_target).sum(-1)

    gid = _row_segment_ids(ranked_preds)
    group_t = _segment_sum(ranked_target, gid)
    group_c = _segment_sum(torch.ones_like(ranked_target), gid)
    group_d = _segment_sum(discount, gid)
    return (_safe_divide(group_t, group_c) * group_d).sum(-1)


def ndcg_padded(
    ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int] = None
) -> torch.Tensor:
    """Normalized DCG per query."""
    gain = dcg_padded(ranked_preds, ranked_target, counts, top_k, ignore_ties=False)
    # padded slots (rank >= count) must sort below any real relevance value,
    # negatives included, so they are keyed -inf for the ideal ordering
    pos = _positions(ranked_target.shape[-1], ranked_target.device)
    key = torch.where(pos < counts[:, None], ranked_target, float("-inf"))
    ideal_target = -torch.sort(-key, dim=-1).values
    ideal_target = torch.where(torch.isfinite(ideal_target), ideal_target, 0.0)
    ideal = dcg_padded(ideal_target, ideal_target, counts, top_k, ignore_ties=True)
    return _safe_divide(gain, ideal)


def auroc_padded(
    ranked_preds: torch.Tensor, ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int] = None
) -> torch.Tensor:
    """AUROC per query over the top-k retrieved documents, tie-aware: the
    Mann-Whitney statistic with tie-averaged ranks."""
    length = ranked_target.shape[-1]
    mask = _topk_mask(counts, top_k, length)
    k = mask.sum(-1, keepdim=True).to(torch.float32)  # selected documents per query

    # tie-averaged ascending rank of each selected document's score; tie
    # groups are restricted to the selection (its size and first position)
    gid = _row_segment_ids(ranked_preds)
    sel = mask.to(torch.float32)
    group_c = _segment_sum(sel, gid)
    first = torch.where(mask, _positions(length, mask.device), length)
    group_start = torch.full_like(first, length).scatter_reduce_(1, gid, first, "amin").to(torch.float32)
    # descending positions [start, start + c) -> the average ascending 1-based rank
    group_avg_asc = k - group_start - (group_c - 1.0) / 2.0
    avg_rank = torch.gather(group_avg_asc, 1, gid)

    t = ranked_target * sel
    npos = t.sum(-1)
    nneg = sel.sum(-1) - npos
    u = (t * avg_rank).sum(-1) - npos * (npos + 1.0) / 2.0
    return _safe_divide(u, npos * nneg)


def precision_recall_curve_padded(
    ranked_target: torch.Tensor, counts: torch.Tensor, max_k: int, adaptive_k: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query precision@k and recall@k for k = 1..max_k: cumulative hits
    over ranks, divided by k (precision; with ``adaptive_k`` the document
    count caps k) and by the relevant count (recall)."""
    length = ranked_target.shape[-1]
    device = ranked_target.device
    t = ranked_target * (_positions(length, device) < counts[:, None])
    cum = torch.cumsum(t, dim=-1)
    ks = torch.arange(1, max_k + 1, device=device, dtype=torch.int32)[None, :]
    capped = torch.minimum(ks, counts[:, None])
    hits = torch.gather(cum, 1, torch.clamp(capped.to(torch.int64) - 1, 0, length - 1))
    recall = _safe_divide(hits, t.sum(-1, keepdim=True))
    topk = (capped if adaptive_k else ks.expand_as(hits)).to(torch.float32)
    precision = _safe_divide(hits, topk)
    return precision, recall, ks[0]
