"""The port's segmentation utilities against the JAX package.

The same seeded numpy masks go through JAX and the port on the CPU:
structures, erosions, edges and neighbour codes bit for bit; the tables
and areas bit for bit (the same float32 numpy arithmetic); the distance
transform within 1e-6 of JAX on both engines and all three metrics, and
the chunked ``"pytorch"`` engine bit-equal to one chunk.
"""
from __future__ import annotations

import importlib
import os

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch.functional.segmentation import utils

TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("euclidean", "chessboard", "taxicab")


def _jax():
    return importlib.import_module("torchmetrics_tpu.functional.segmentation.utils")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def blob(seed: int, shape, p: float = 0.35) -> np.ndarray:
    """A lumpy binary mask: a thresholded sum of random bumps."""
    rng = np.random.RandomState(seed)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    field = np.zeros(shape)
    for _ in range(4):
        centre = [rng.uniform(0, s) for s in shape]
        field += np.exp(-sum((g - c) ** 2 for g, c in zip(grids, centre)) / (2 * (min(shape) / 4) ** 2))
    return field > np.quantile(field, 1 - p)


def test_surface_normals_are_a_byte_copy():
    port = os.path.join(REPO, "torchmetrics_tpu_torch", "functional", "segmentation", "_surface_normals.npz")
    jax = os.path.join(REPO, "torchmetrics_tpu", "functional", "segmentation", "_surface_normals.npz")
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
@pytest.mark.parametrize("connectivity", [0, 1, 2, 3])
def test_generate_binary_structure_against_jax(rank, connectivity):
    got = F.segmentation.generate_binary_structure(rank, connectivity)
    assert np.array_equal(_np(got), np.asarray(_jax().generate_binary_structure(rank, connectivity)))


@pytest.mark.parametrize("shape", [(2, 1, 9, 11), (1, 2, 6, 7, 5)])
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("border_value", [0, 1])
def test_binary_erosion_against_jax(shape, connectivity, border_value):
    image = np.stack([blob(s, shape[2:]) for s in range(shape[0] * shape[1])]).reshape(shape).astype(np.uint8)
    structure = _jax().generate_binary_structure(len(shape) - 2, connectivity)
    got = utils.binary_erosion(torch.from_numpy(image), torch.from_numpy(np.array(structure)), border_value=border_value)
    want = _jax().binary_erosion(image, structure, border_value=border_value)
    assert got.dtype == torch.uint8 and np.array_equal(_np(got), np.asarray(want))


def test_binary_erosion_with_an_origin_equals_scipy():
    from scipy import ndimage

    image = blob(3, (10, 12)).astype(np.uint8)
    got = utils.binary_erosion(torch.from_numpy(image)[None, None], origin=(1, 1))[0, 0]
    assert np.array_equal(_np(got), ndimage.binary_erosion(image, utils.generate_binary_structure(2, 1).numpy()))


def test_check_if_binarized():
    utils.check_if_binarized(torch.tensor([0.0, 1.0, 1.0]))
    with pytest.raises(ValueError, match="binarized"):
        utils.check_if_binarized(torch.tensor([0.0, 0.5]))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("engine", ["pytorch", "scipy"])
@pytest.mark.parametrize("sampling", [None, [1.5, 0.5]])
def test_distance_transform_against_jax(metric, engine, sampling):
    if engine == "scipy" and metric != "euclidean" and sampling is not None:
        sampling = None  # scipy's cdt takes no sampling, in both packages
    x = blob(7, (13, 17), p=0.6).astype(np.int64)
    got = F.segmentation.distance_transform(torch.from_numpy(x), sampling=sampling, metric=metric, engine=engine)
    want = np.asarray(_jax().distance_transform(x, sampling=sampling, metric=metric, engine=engine))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_chunked_distance_transform_equals_one_chunk(metric, monkeypatch):
    x = torch.from_numpy(blob(8, (21, 19), p=0.7))
    whole = utils.distance_transform(x, sampling=[0.7, 1.3], metric=metric)
    for budget in (1, 24 * 40):  # one row a chunk; a few rows a chunk
        monkeypatch.setattr(utils, "DISTANCE_BUDGET_BYTES", budget)
        assert torch.equal(utils.distance_transform(x, sampling=[0.7, 1.3], metric=metric), whole)


def test_distance_transform_edge_cases_against_jax():
    for x in (np.ones((4, 5), np.int64), np.zeros((4, 5), np.int64)):
        got = utils.distance_transform(torch.from_numpy(x))
        assert np.array_equal(_np(got), np.asarray(_jax().distance_transform(x)))
    with pytest.raises(ValueError, match="rank 2"):
        utils.distance_transform(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="sampling"):
        utils.distance_transform(torch.zeros(3, 4), sampling=(1, 1))


@pytest.mark.parametrize("spacing", [(1, 1), (0.5, 2.0), (1, 1, 1), (1.5, 0.5, 2.0)])
def test_neighbour_tables_against_jax(spacing):
    table, kernel = utils.get_neighbour_tables(spacing)
    want_table, want_kernel = _jax().get_neighbour_tables(spacing)
    assert np.array_equal(_np(table), np.asarray(want_table)) and np.array_equal(_np(kernel), np.asarray(want_kernel))


@pytest.mark.parametrize("shape", [(14, 18), (9, 10, 11)])
@pytest.mark.parametrize("crop", [True, False])
@pytest.mark.parametrize("with_spacing", [False, True])
def test_mask_edges_against_jax(shape, crop, with_spacing):
    preds, target = blob(1, shape), blob(2, shape)
    spacing = ((0.5, 2.0) if len(shape) == 2 else (1.5, 0.5, 2.0)) if with_spacing else None
    got = utils.mask_edges(torch.from_numpy(preds), torch.from_numpy(target), crop=crop, spacing=spacing)
    want = _jax().mask_edges(preds, target, crop=crop, spacing=spacing)
    assert len(got) == len(want) == (4 if with_spacing else 2)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(_np(g), w)


def test_mask_edges_of_empty_masks_against_jax():
    empty = np.zeros((6, 7), bool)
    got = utils.mask_edges(torch.from_numpy(empty), torch.from_numpy(empty))
    want = _jax().mask_edges(empty, empty)
    assert len(got) == len(want) == 4
    assert all(np.array_equal(_np(g), np.asarray(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("spacing", [None, [1.0, 2.5]])
def test_surface_distance_against_jax(metric, spacing):
    jax_utils = _jax()
    preds, target = blob(4, (16, 15)), blob(5, (16, 15))
    ep, et = (np.asarray(e) for e in jax_utils.mask_edges(preds, target, crop=False))
    got = utils.surface_distance(torch.from_numpy(ep), torch.from_numpy(et), distance_metric=metric, spacing=spacing)
    want = np.asarray(jax_utils.surface_distance(ep, et, distance_metric=metric, spacing=spacing))
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)


def test_surface_distance_empty_sides_against_jax():
    jax_utils = _jax()
    edge = np.zeros((5, 5), bool)
    edge[2, 1:4] = True
    empty = np.zeros((5, 5), bool)
    for p, t in ((edge, empty), (empty, edge)):
        got = utils.surface_distance(torch.from_numpy(p), torch.from_numpy(t))
        assert np.array_equal(_np(got), np.asarray(jax_utils.surface_distance(p, t)))
    with pytest.raises(ValueError, match="bool"):
        utils.surface_distance(torch.zeros(3, 3), torch.zeros(3, 3))
