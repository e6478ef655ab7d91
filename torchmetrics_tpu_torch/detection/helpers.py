"""Input checks for the detection metrics, their state tensors, and the sync
that keeps a list state's per-image entries apart."""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_device

#: the most dimensions a per-image entry has (a stack of H x W masks)
_MAX_ENTRY_DIMS = 3


def _fix_empty_tensors(boxes) -> torch.Tensor:
    """Empty boxes get a (0, 4) shape so pairwise ops stay well-formed."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    if boxes.numel() == 0 and boxes.ndim == 1:
        return boxes.reshape(0, 4)
    return boxes


def _rows(x) -> int:
    """Leading size of a per-image entry, 0 when it holds nothing."""
    shape = tuple(x.shape) if isinstance(x, (torch.Tensor, np.ndarray)) else np.shape(x)
    return shape[0] if shape and int(np.prod(shape)) else 0


def _numel(x) -> int:
    return int(x.numel()) if isinstance(x, torch.Tensor) else int(np.size(x))


def _input_validator(
    preds: Sequence[Dict],
    targets: Sequence[Dict],
    iou_type: str = "bbox",
    ignore_score: bool = False,
) -> None:
    """Check list-of-dicts detection inputs (shapes only: no device read)."""
    item_val_name = "boxes" if iou_type == "bbox" else "masks"

    if not isinstance(preds, Sequence):
        raise ValueError(f"Expected argument `preds` to be of type Sequence, but got {preds}")
    if not isinstance(targets, Sequence):
        raise ValueError(f"Expected argument `target` to be of type Sequence, but got {targets}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )

    for k in [item_val_name, "labels"] + (["scores"] if not ignore_score else []):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in [item_val_name, "labels"]:
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    for i, item in enumerate(targets):
        n_gt, n_lab = _rows(item[item_val_name]), _numel(item["labels"])
        if n_gt != n_lab:
            raise ValueError(
                f"Input '{item_val_name}' and labels of sample {i} in targets have a"
                f" different length (expected {n_gt} labels, got {n_lab})"
            )
    for i, item in enumerate(preds):
        n_det, n_lab = _rows(item[item_val_name]), _numel(item["labels"])
        if not ignore_score:
            n_sc = _numel(item["scores"])
            if n_det != n_lab or n_det != n_sc:
                raise ValueError(
                    f"Input '{item_val_name}', labels and scores of sample {i} in predictions have a"
                    f" different length (expected {n_det} labels and scores, got {n_lab} labels and {n_sc})"
                )
        elif n_det != n_lab:
            raise ValueError(
                f"Input '{item_val_name}' and labels of sample {i} in predictions have a"
                f" different length (expected {n_det} labels, got {n_lab})"
            )


def _check_items_device(device: torch.device, items: Sequence[Dict], owner: str) -> None:
    """Raise when a tensor or array of the input dicts lies on another
    device than the metric's state (nothing is copied across devices)."""
    for item in items:
        _check_same_device(device, (), dict(item), owner)


def _state_tensor(x, device: torch.device, dtype: torch.dtype = None) -> torch.Tensor:
    """An input entry as a 1-D state tensor with the JAX package's 32-bit
    defaults (int64 to int32, float64 to float32) unless ``dtype`` is given."""
    t = torch.as_tensor(x, device=device).reshape(-1)
    if dtype is not None:
        return t.to(dtype)
    if t.dtype == torch.int64:
        return t.to(torch.int32)
    if t.dtype == torch.float64:
        return t.to(torch.float32)
    return t


def sync_keeping_entries(
    states: Dict[str, Any], reductions: Dict[str, Any], sync: Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]]
) -> Dict[str, Any]:
    """Sync ``states`` with ``sync`` (the port's ``sync_states``), keeping the
    entries of every ``None``-reduced list state apart.

    The port's sync sends a list state as one concatenation per rank, which
    would merge a detection metric's images (and cannot concatenate masks of
    different sizes). Each such list goes out as the concatenation of its
    flattened entries beside a table of the entries' shapes, and comes back
    as every rank's entries in rank order, as one process that had seen the
    ranks' updates in that order would hold them."""
    packed, sent, shapes_of = dict(states), dict(reductions), {}
    for name, value in states.items():
        if isinstance(value, list) and reductions.get(name) is None:
            shapes = torch.zeros((len(value), 1 + _MAX_ENTRY_DIMS), dtype=torch.int64)
            for i, v in enumerate(value):
                if v.ndim > _MAX_ENTRY_DIMS:
                    raise ValueError(f"sync: an entry of state {name!r} has {v.ndim} dimensions")
                shapes[i, 0] = v.ndim
                shapes[i, 1 : 1 + v.ndim] = torch.tensor(v.shape)
            packed[name] = [torch.cat([v.reshape(-1) for v in value])] if value else []
            shape_name = f"_{name}_entry_shapes"
            device = value[0].device if value else None
            packed[shape_name] = [shapes.to(device)] if value else []
            sent[shape_name] = None
            shapes_of[name] = shape_name
    synced = sync(packed, sent)
    out = {}
    for name in states:
        if name not in shapes_of:
            out[name] = synced[name]
            continue
        entries = []
        for flat, shapes in zip(synced[name], synced[shapes_of[name]]):
            rows = shapes.tolist()
            sizes = [int(np.prod(r[1 : 1 + r[0]])) for r in rows]
            for piece, r in zip(torch.split(flat, sizes), rows):
                entries.append(piece.reshape(r[1 : 1 + r[0]]))
        out[name] = entries
    return out
