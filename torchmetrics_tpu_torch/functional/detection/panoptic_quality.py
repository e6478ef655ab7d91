"""Panoptic quality and its modified form.

Each pixel is a ``(category, instance)`` pair. An update relabels the pairs
of every image with one ``torch.unique(dim=0)`` over ``(image, category,
instance)`` rows (sorted, as ``np.unique(axis=0)`` sorts each image's), and
counts the intersection table of every image's predicted and target
segments with ONE weightless launch of the ``bincount`` kernel
(``ops/bincount.py``): image ``i``'s ``n_p x n_t`` table sits at its own
offset in the bins, so the tables of a batch never share a bin. The
segments' areas are the table's exact row and column sums. The matching
(IoU > 0.5 with void-corrected unions, the modified metric's stuff rule, the
mostly-void filters) then runs on the flat list of a batch's table cells,
on the device: an update's IoUs sum in float64 and round once to float32,
as the JAX package rounds its float64 numpy sums into its float32 state.
"""
from __future__ import annotations

from typing import Collection, Dict, Optional, Set, Tuple

import torch

from torchmetrics_tpu_torch.ops import bincount, kernels  # noqa: F401  (importing bincount registers the kernel)

#: the flattened cell index is int32 on the kernel
_MAX_CELLS = 2**31 - 1


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    """Validate and normalise the category sets."""
    things_parsed = set(things)
    stuffs_parsed = set(stuffs)
    if not all(isinstance(t, int) or hasattr(t, "item") for t in things_parsed | stuffs_parsed):
        raise TypeError("Expected arguments `things` and `stuffs` to contain `int` categories")
    things_parsed = {int(t) for t in things_parsed}
    stuffs_parsed = {int(s) for s in stuffs_parsed}
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    unused_category_id = 1 + max([0, *list(things), *list(stuffs)])
    return unused_category_id, 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> Dict[int, int]:
    thing_id_to_continuous_id = {t: idx for idx, t in enumerate(sorted(things))}
    stuff_id_to_continuous_id = {s: idx + len(things) for idx, s in enumerate(sorted(stuffs))}
    return {**thing_id_to_continuous_id, **stuff_id_to_continuous_id}


def _validate_inputs(preds: torch.Tensor, target: torch.Tensor) -> None:
    if tuple(preds.shape) != tuple(target.shape):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same shape, got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if preds.ndim < 3:
        raise ValueError(f"Expected argument `preds` to have at least 3 dimensions, got {preds.ndim}")
    if preds.shape[-1] != 2:
        raise ValueError(f"Expected the final dimension of `preds` to be of size 2, got {preds.shape[-1]}")


def _preprocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs: torch.Tensor,
    void_color: Tuple[int, int],
    allow_unknown_category: bool,
) -> torch.Tensor:
    """``(B, *spatial, 2)`` to int64 ``(B, P, 2)``: stuff instance ids zeroed,
    unknown categories mapped to the void colour (or, for predictions
    without ``allow_unknown_category``, refused)."""
    out = inputs.to(torch.int64).reshape(inputs.shape[0], -1, 2).clone()
    cats = out[:, :, 0]
    mask_stuffs = _member(cats, stuffs)
    mask_things = _member(cats, things)
    out[:, :, 1] = torch.where(mask_stuffs, torch.zeros_like(out[:, :, 1]), out[:, :, 1])
    known = mask_things | mask_stuffs
    if not allow_unknown_category and not bool(known.all()):
        raise ValueError(f"Unknown categories found: {torch.unique(cats[~known]).cpu().numpy()}")
    out[~known] = torch.tensor(void_color, dtype=torch.int64, device=out.device)
    return out


def _segments(flat: torch.Tensor):
    """Relabel a batch's ``(B, P, 2)`` pixels: the sorted distinct
    ``(image, category, instance)`` rows, each pixel's row index, and each
    row's index within its image and the count of rows of every image."""
    b, p = flat.shape[:2]
    device = flat.device
    image = torch.arange(b, device=device).repeat_interleave(p)
    rows, inverse = torch.unique(torch.cat([image[:, None], flat.reshape(-1, 2)], dim=1), dim=0, return_inverse=True)
    # the rows are sorted by image: each image's first row and row count
    first = torch.searchsorted(rows[:, 0].contiguous(), torch.arange(b + 1, device=device))
    counts = first[1:] - first[:-1]
    first = first[:-1]
    local = torch.arange(rows.shape[0], device=device) - first[rows[:, 0]]
    return rows, inverse, local, counts


def _member(values: torch.Tensor, ids) -> torch.Tensor:
    """Whether each value is one of ``ids``: a binary search of the sorted
    ids (``torch.isin`` compares every value with every id)."""
    ids = torch.tensor(sorted(ids), dtype=torch.int64, device=values.device)
    if ids.numel() == 0:
        return torch.zeros_like(values, dtype=torch.bool)
    at = torch.searchsorted(ids, values.contiguous()).clamp(max=ids.numel() - 1)
    return ids[at] == values


def _panoptic_quality_update(
    flatten_preds: torch.Tensor,
    flatten_target: torch.Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """An update's per-category IoU sum (float64) and TP, FP and FN (int64)
    over preprocessed ``(B, P, 2)`` inputs; images never match across each
    other. One ``bincount`` dispatch counts every image's intersections."""
    device = flatten_preds.device
    num_categories = len(cat_id_to_continuous_id)
    iou_sum = torch.zeros(num_categories, dtype=torch.float64, device=device)
    tp = torch.zeros(num_categories, dtype=torch.int64, device=device)
    fp = torch.zeros_like(tp)
    fn = torch.zeros_like(tp)
    if flatten_preds.numel() == 0:
        return iou_sum, tp, fp, fn

    up, pinv, p_local, n_p = _segments(flatten_preds)
    ut, tinv, t_local, n_t = _segments(flatten_target)
    # image i's table at offset sum_{j<i} n_p[j] * n_t[j], row-major within it
    sizes = n_p * n_t
    offsets = torch.cumsum(sizes, 0) - sizes
    p_image = up[pinv, 0]
    cell_of_pixel = offsets[p_image] + p_local[pinv] * n_t[p_image] + t_local[tinv]
    cells = int(sizes.sum())
    if cells > _MAX_CELLS:
        raise ValueError(f"panoptic quality: the batch's intersection tables need {cells} bins, past the kernel's {_MAX_CELLS}")
    inter = kernels.dispatch("bincount", cell_of_pixel.to(torch.int32).contiguous(), None, cells)[0]

    # every cell's (pred segment, target segment), as global row indices
    cell_image = torch.repeat_interleave(torch.arange(sizes.numel(), device=device), sizes)
    within = torch.arange(cells, device=device) - offsets[cell_image]
    p_first = torch.cumsum(n_p, 0) - n_p
    t_first = torch.cumsum(n_t, 0) - n_t
    cp = p_first[cell_image] + torch.div(within, n_t[cell_image], rounding_mode="floor")
    ct = t_first[cell_image] + within % n_t[cell_image]

    pred_areas = torch.zeros(up.shape[0], dtype=torch.int64, device=device).index_add_(0, cp, inter)
    target_areas = torch.zeros(ut.shape[0], dtype=torch.int64, device=device).index_add_(0, ct, inter)
    void = torch.tensor(void_color, dtype=torch.int64, device=device)
    p_is_void = (up[:, 1:] == void).all(dim=1)
    t_is_void = (ut[:, 1:] == void).all(dim=1)
    zero = torch.zeros_like(inter)
    # area of each pred segment over void target, of each target segment under void pred
    pred_void = torch.zeros_like(pred_areas).index_add_(0, cp, torch.where(t_is_void[ct], inter, zero))
    void_target = torch.zeros_like(target_areas).index_add_(0, ct, torch.where(p_is_void[cp], inter, zero))

    inter64 = inter.to(torch.float64)
    union = (pred_areas[cp] - pred_void[cp] + target_areas[ct] - void_target[ct] - inter).to(torch.float64)
    iou = torch.where(inter > 0, inter64 / union, torch.zeros_like(inter64))

    known = torch.tensor(sorted(cat_id_to_continuous_id), dtype=torch.int64, device=device)
    cont = torch.tensor([cat_id_to_continuous_id[k] for k in sorted(cat_id_to_continuous_id)], dtype=torch.int64, device=device)

    def continuous(cat: torch.Tensor) -> torch.Tensor:
        at = torch.searchsorted(known, cat).clamp(max=known.numel() - 1)
        return torch.where(known[at] == cat, cont[at], torch.full_like(cat, -1))

    cont_t = continuous(ut[:, 1].contiguous())
    cont_p = continuous(up[:, 1].contiguous())
    t_modified = _member(ut[:, 1], modified_metric_stuffs or ())
    p_modified = _member(up[:, 1], modified_metric_stuffs or ())

    considered = (up[cp, 1] == ut[ct, 1]) & (inter > 0) & ~t_is_void[ct] & ~p_is_void[cp]
    # things (and plain-PQ stuffs) match at IoU > 0.5: at most one per row and column
    matched = considered & (iou > 0.5) & ~t_modified[ct]
    # modified-PQ stuffs add every IoU > 0; their TP is the number of target segments
    mod_pairs = considered & (iou > 0) & t_modified[ct]
    adds = matched | mod_pairs
    iou_sum.index_add_(0, cont_t[ct[adds]], iou[adds])
    tp.index_add_(0, cont_t[ct[matched]], torch.ones_like(ct[matched]))
    mod_targets = ~t_is_void & t_modified
    tp.index_add_(0, cont_t[mod_targets], torch.ones_like(cont_t[mod_targets]))

    matched64 = matched.to(torch.int64)
    t_matched = torch.zeros_like(target_areas).index_add_(0, ct, matched64) > 0
    p_matched = torch.zeros_like(pred_areas).index_add_(0, cp, matched64) > 0
    t_area64 = target_areas.to(torch.float64)
    p_area64 = pred_areas.to(torch.float64)
    t_void_frac = torch.where(target_areas > 0, void_target / t_area64, torch.zeros_like(t_area64))
    p_void_frac = torch.where(pred_areas > 0, pred_void / p_area64, torch.zeros_like(p_area64))
    # FN: unmatched non-void target segments not mostly void; FP: the same of predictions
    fns = ~t_matched & ~t_is_void & ~t_modified & (t_void_frac <= 0.5)
    fn.index_add_(0, cont_t[fns], torch.ones_like(cont_t[fns]))
    fps = ~p_matched & ~p_is_void & ~p_modified & (p_void_frac <= 0.5) & (cont_p >= 0)
    fp.index_add_(0, cont_p[fps], torch.ones_like(cont_p[fps]))
    return iou_sum, tp, fp, fn


def _panoptic_quality_compute(
    iou_sum: torch.Tensor, true_positives: torch.Tensor, false_positives: torch.Tensor, false_negatives: torch.Tensor
):
    """Per-category and averaged PQ, SQ and RQ (NaN averages when no
    category was seen)."""
    zero = torch.zeros((), dtype=torch.float32, device=iou_sum.device)
    sq = torch.where(true_positives > 0.0, iou_sum / true_positives.clamp(min=1), zero)
    denominator = true_positives + 0.5 * false_positives + 0.5 * false_negatives
    rq = torch.where(denominator > 0.0, true_positives / denominator.clamp(min=1e-12), zero)
    pq = sq * rq
    seen = denominator > 0
    nan = torch.tensor(float("nan"), device=iou_sum.device)
    any_seen = bool(seen.any())
    pq_avg = pq[seen].mean() if any_seen else nan
    sq_avg = sq[seen].mean() if any_seen else nan
    rq_avg = rq[seen].mean() if any_seen else nan
    return pq, sq, rq, pq_avg, sq_avg, rq_avg


def _functional_stats(preds, target, things, stuffs, allow_unknown_preds_category, modified: bool):
    things, stuffs = _parse_categories(things, stuffs)
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _validate_inputs(preds, target)
    if preds.device != target.device:
        raise RuntimeError(f"panoptic quality: preds on {preds.device} but target on {target.device}")
    void_color = _get_void_color(things, stuffs)
    cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
    flatten_preds = _preprocess_inputs(things, stuffs, preds, void_color, allow_unknown_preds_category)
    flatten_target = _preprocess_inputs(things, stuffs, target, void_color, True)
    iou_sum, tp, fp, fn = _panoptic_quality_update(
        flatten_preds, flatten_target, cat_id_to_continuous_id, void_color, stuffs if modified else None
    )
    return iou_sum.to(torch.float32), tp.to(torch.int32), fp.to(torch.int32), fn.to(torch.int32)


def panoptic_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    return_sq_and_rq: bool = False,
    return_per_class: bool = False,
) -> torch.Tensor:
    """Panoptic quality over ``(B, *spatial, 2)`` (category, instance) maps.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import panoptic_quality
        >>> preds = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [1, 0]]])
        >>> target = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [0, 0], [1, 0]]])
        >>> round(float(panoptic_quality(preds, target, things={0}, stuffs={1})), 4)
        0.5
    """
    stats = _functional_stats(preds, target, things, stuffs, allow_unknown_preds_category, modified=False)
    pq, sq, rq, pq_avg, sq_avg, rq_avg = _panoptic_quality_compute(*stats)
    if return_per_class:
        if return_sq_and_rq:
            return torch.stack((pq, sq, rq), dim=-1)
        return pq.reshape(1, -1)
    if return_sq_and_rq:
        return torch.stack((pq_avg, sq_avg, rq_avg))
    return pq_avg


def modified_panoptic_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> torch.Tensor:
    """Modified PQ: stuff categories score the mean IoU of all their overlaps.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import modified_panoptic_quality
        >>> preds = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [1, 0]]])
        >>> target = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [0, 0], [1, 0]]])
        >>> round(float(modified_panoptic_quality(preds, target, things={0}, stuffs={1})), 4)
        0.625
    """
    stats = _functional_stats(preds, target, things, stuffs, allow_unknown_preds_category, modified=True)
    return _panoptic_quality_compute(*stats)[3]
