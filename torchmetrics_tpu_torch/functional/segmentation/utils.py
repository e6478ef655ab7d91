"""Segmentation utilities: binary morphology, the distance transform, the
neighbour-code tables, mask edges and surface distances.

- ``binary_erosion`` ANDs the shifted views the (static, at most 27-element)
  structuring element selects.
- ``distance_transform``'s ``"pytorch"`` engine takes, for every foreground
  pixel, the minimum distance to the background pixels: the JAX package's
  all-pairs form, whose ``(N, N, 2)`` differences would take 550 GB on a
  512 x 512 slice. The port gathers the foreground and background pixels and
  takes the same minimum over row chunks of foreground pixels, each chunk's
  ``(rows, background)`` distances under ``DISTANCE_BUDGET_BYTES``; each
  distance is formed by the same float32 operations, and a minimum does not
  depend on how the rows are split, so any chunking gives the same bits.
  ``"scipy"`` runs ``scipy.ndimage`` on the host.
- The 2-D contour-length table follows from the pixel spacing; the 3-D
  surface-area table scales the marching-cubes surface normals
  (``_surface_normals.npz``, public deepmind/surface-distance data, a byte
  copy of the JAX package's) by the per-face voxel areas.
"""
from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utils.checks import _check_same_shape

#: bytes of one row chunk's distances (and their temporaries) in the
#: ``"pytorch"`` distance transform
DISTANCE_BUDGET_BYTES = 1 << 28


def check_if_binarized(x: torch.Tensor) -> None:
    """Raise unless every element is 0 or 1."""
    x = torch.as_tensor(x)
    if not bool((x.to(torch.bool) == x).all()):
        raise ValueError("Input x should be binarized")


def generate_binary_structure(rank: int, connectivity: int) -> torch.Tensor:
    """The ``scipy.ndimage`` structuring element of ``rank`` and
    ``connectivity`` (a small static tensor on the CPU)."""
    if connectivity < 1:
        connectivity = 1
    if rank < 1:
        return torch.tensor([1], dtype=torch.uint8).to(torch.bool)
    grids = torch.meshgrid(*[torch.arange(3) for _ in range(rank)], indexing="ij")
    output = torch.abs(torch.stack(grids, dim=0) - 1)
    return torch.sum(output, dim=0) <= connectivity


def binary_erosion(
    image: torch.Tensor,
    structure: Optional[torch.Tensor] = None,
    origin: Optional[Tuple[int, ...]] = None,
    border_value: int = 0,
) -> torch.Tensor:
    """Binary erosion of ``(B, C, *spatial)`` images: a pixel survives iff
    every neighbour the structuring element selects is set. Returns uint8."""
    image = torch.as_tensor(image)
    if image.ndim not in [4, 5]:
        raise ValueError(f"Expected argument `image` to be of rank 4 or 5 but found rank {image.ndim}")
    check_if_binarized(image)

    rank = image.ndim - 2
    if structure is None:
        structure = generate_binary_structure(rank, 1)
    structure = torch.as_tensor(structure)
    check_if_binarized(structure)
    if origin is None:
        origin = structure.ndim * (1,)

    pad = []
    for i in reversed(range(len(origin))):
        pad += [origin[i], structure.shape[i] - origin[i] - 1]
    padded = torch.nn.functional.pad(image.to(torch.uint8), pad, value=int(bool(border_value))).to(torch.bool)

    out = torch.ones(image.shape, dtype=torch.bool, device=image.device)
    spatial = image.shape[2:]
    for offset in np.argwhere(structure.cpu().numpy()):
        sl = (slice(None), slice(None)) + tuple(slice(int(o), int(o) + s) for o, s in zip(offset, spatial))
        out = out & padded[sl]
    return out.to(torch.uint8)


def _distances(rows: torch.Tensor, cols: torch.Tensor, metric: str) -> torch.Tensor:
    d = rows[:, None, :] - cols[None, :, :]
    if metric == "euclidean":
        return torch.sqrt(torch.sum(d**2, dim=-1))
    if metric == "chessboard":
        return torch.amax(torch.abs(d), dim=-1)
    return torch.sum(torch.abs(d), dim=-1)


def distance_transform(
    x: torch.Tensor,
    sampling: Optional[Union[torch.Tensor, List[float]]] = None,
    metric: str = "euclidean",
    engine: str = "pytorch",
) -> torch.Tensor:
    """Distance of each foreground pixel of a 2-D ``x`` to the nearest
    background pixel (0 on the background; ``inf`` without background).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.segmentation import distance_transform
        >>> x = torch.tensor([[0, 1, 1], [0, 1, 1], [0, 0, 1]])
        >>> distance_transform(x)
        tensor([[0.0000, 1.0000, 2.0000],
                [0.0000, 1.0000, 1.4142],
                [0.0000, 0.0000, 1.0000]])
    """
    x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be of rank 2 but got rank `{x.ndim}`.")
    if sampling is not None and not isinstance(sampling, list):
        raise ValueError(
            f"Expected argument `sampling` to either be `None` or of type `list` but got `{type(sampling)}`."
        )
    if metric not in ["euclidean", "chessboard", "taxicab"]:
        raise ValueError(
            f"Expected argument `metric` to be one of `['euclidean', 'chessboard', 'taxicab']` but got `{metric}`."
        )
    if engine not in ["pytorch", "scipy"]:
        raise ValueError(f"Expected argument `engine` to be one of `['pytorch', 'scipy']` but got `{engine}`.")

    if sampling is None:
        sampling = [1, 1]
    if len(sampling) != 2:
        raise ValueError("Sampling must have length 2")

    if engine == "scipy":
        from scipy import ndimage

        # the host engine: a copy to the host and the result back, float32
        x_np = x.cpu().numpy()
        if metric == "euclidean":
            out = ndimage.distance_transform_edt(x_np, sampling)
        else:
            out = ndimage.distance_transform_cdt(x_np, metric="chessboard" if metric == "chessboard" else "taxicab")
        return torch.from_numpy(np.asarray(out, dtype=np.float32)).to(x.device)

    h, w = x.shape
    ii, jj = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device), torch.arange(w, dtype=torch.float32, device=x.device),
        indexing="ij",
    )
    coords = torch.stack([ii.reshape(-1) * sampling[0], jj.reshape(-1) * sampling[1]], dim=1)  # (N, 2)
    flat = x.reshape(-1)
    fg = torch.nonzero(flat != 0)[:, 0]
    bg_coords = coords[flat == 0]
    out = torch.zeros(h * w, dtype=torch.float32, device=x.device)
    if bg_coords.shape[0] == 0:
        out[fg] = float("inf")
        return out.reshape(h, w)
    # a row's bytes per background pixel: the float32 difference pair, its
    # square and their sum alive at once, then the distance
    chunk = max(1, DISTANCE_BUDGET_BYTES // (24 * bg_coords.shape[0]))
    for start in range(0, fg.numel(), chunk):
        rows = fg[start : start + chunk]
        out[rows] = _distances(coords[rows], bg_coords, metric).amin(dim=1)
    return out.reshape(h, w)


@lru_cache
def table_contour_length(spacing: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbour code to contour length for 2-D masks: each 2 x 2
    neighbourhood encodes to 4 bits through the ``[[8, 4], [2, 1]]``
    kernel; the lengths are the marching-squares segments at ``spacing``."""
    if not isinstance(spacing, tuple) or len(spacing) != 2:
        raise ValueError("The spacing must be a tuple of length 2.")
    first, second = spacing
    diag = 0.5 * math.sqrt(first**2 + second**2)
    table = np.zeros(16, dtype=np.float32)
    for i in [1, 2, 4, 7, 8, 11, 13, 14]:
        table[i] = diag
    for i in [3, 12]:
        table[i] = second
    for i in [5, 10]:
        table[i] = first
    for i in [6, 9]:
        table[i] = 2 * diag
    kernel = torch.tensor([[8, 4], [2, 1]], dtype=torch.float32)
    return torch.from_numpy(table), kernel


@lru_cache
def _surface_normals() -> np.ndarray:
    """The 256-code marching-cubes surface-normal lookup, ``(256, 4, 3)``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_surface_normals.npz")
    return np.load(path)["normals"]


@lru_cache
def table_surface_area(spacing: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbour code to surface area for 3-D masks: each 2 x 2 x 2
    neighbourhood encodes to 8 bits through the
    ``[[[128, 64], [32, 16]], [[8, 4], [2, 1]]]`` kernel; a code's area is the
    sum of the norms of its surface normals scaled by the per-face voxel
    areas (s1 s2, s0 s2, s0 s1), formed in float32 numpy as the JAX package
    forms it."""
    if not isinstance(spacing, tuple) or len(spacing) != 3:
        raise ValueError("The spacing must be a tuple of length 3.")
    normals = _surface_normals()
    face = np.asarray(
        [spacing[1] * spacing[2], spacing[0] * spacing[2], spacing[0] * spacing[1]], dtype=np.float32
    )
    table = np.linalg.norm(normals * face, axis=-1).sum(-1)
    kernel = torch.tensor([[[128, 64], [32, 16]], [[8, 4], [2, 1]]], dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(table)), kernel


def get_neighbour_tables(
    spacing: Union[Tuple[int, int], Tuple[int, int, int]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contour-length (2-D) or surface-area (3-D) table and its kernel."""
    if isinstance(spacing, tuple) and len(spacing) == 2:
        return table_contour_length(spacing)
    if isinstance(spacing, tuple) and len(spacing) == 3:
        return table_surface_area(spacing)
    raise ValueError("The spacing must be a tuple of length 2 or 3.")


def _neighbour_codes(mask: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2 x 2 (x 2) correlation: each position's neighbour code."""
    m = mask.to(torch.float32)
    out = torch.zeros(tuple(s - 1 for s in m.shape), dtype=torch.float32, device=m.device)
    for offset in np.ndindex(*kernel.shape):
        sl = tuple(slice(o, s - 1 + o) for o, s in zip(offset, m.shape))
        out = out + m[sl] * float(kernel[offset])
    return out.to(torch.int32)


def mask_edges(
    preds: torch.Tensor,
    target: torch.Tensor,
    crop: bool = True,
    spacing: Optional[Tuple[int, ...]] = None,
):
    """Edges of two binary 2-D or 3-D masks, and with ``spacing`` each
    position's contour length or surface area.

    Without ``spacing`` an edge is a set pixel that erosion removes; with it,
    a 2 x 2 (x 2) neighbourhood that is neither empty nor full, scored from
    the neighbour-code table. With ``crop`` the masks get a one-pixel border
    first (and two empty masks give four empty results).
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    if preds.ndim not in [2, 3]:
        raise ValueError(f"Expected argument `preds` to be of rank 2 or 3 but got rank `{preds.ndim}`.")
    check_if_binarized(preds)
    check_if_binarized(target)
    preds = preds.to(torch.bool)
    target = target.to(torch.bool)

    if crop:
        if not bool((preds | target).any()):
            p, t = torch.zeros_like(preds), torch.zeros_like(target)
            return p, t, p, t
        pad = preds.ndim * [1, 1]
        preds = torch.nn.functional.pad(preds.to(torch.uint8), pad).to(torch.bool)
        target = torch.nn.functional.pad(target.to(torch.uint8), pad).to(torch.bool)

    if spacing is None:
        be_pred = binary_erosion(preds[None, None]).squeeze(0).squeeze(0).to(torch.bool) ^ preds
        be_target = binary_erosion(target[None, None]).squeeze(0).squeeze(0).to(torch.bool) ^ target
        return be_pred, be_target

    if len(spacing) != preds.ndim:
        raise ValueError(f"`spacing` length {len(spacing)} must match the mask rank {preds.ndim}.")
    table, kernel = get_neighbour_tables(spacing)
    table = table.to(preds.device)
    code_preds = _neighbour_codes(preds, kernel)
    code_target = _neighbour_codes(target, kernel)
    all_ones = table.shape[0] - 1
    edges_preds = (code_preds != 0) & (code_preds != all_ones)
    edges_target = (code_target != 0) & (code_target != all_ones)
    areas_preds = table[code_preds]
    areas_target = table[code_target]
    return edges_preds, edges_target, areas_preds, areas_target


def surface_distance(
    preds: torch.Tensor,
    target: torch.Tensor,
    distance_metric: str = "euclidean",
    spacing: Optional[Union[torch.Tensor, List[float]]] = None,
) -> torch.Tensor:
    """Distances from each predicted edge pixel to the nearest target edge
    pixel: the distance transform of the target edges' complement, read at
    the predicted edges."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if not (preds.dtype == torch.bool and target.dtype == torch.bool):
        raise ValueError(f"Expected both inputs to be of type bool, but got {preds.dtype} and {target.dtype}.")

    if not bool(target.any()):
        dis = torch.full(target.shape, float("inf"), device=target.device)
    else:
        if not bool(preds.any()):
            dis = torch.full(preds.shape, float("inf"), device=preds.device)
            return dis[target]
        dis = distance_transform(~target, sampling=spacing, metric=distance_metric)
    return dis[preds]
