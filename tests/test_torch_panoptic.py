"""The port's panoptic quality against the JAX package.

The same seeded numpy (category, instance) maps go through JAX and the port
on the CPU: TP, FP and FN bit for bit, the float32 IoU sums and every value
within 1e-6. Cases: void and unknown categories, ``allow_unknown_preds_
category``, modified stuffs, ``return_sq_and_rq`` and ``return_per_class``,
spatial maps of rank 1 to 3. An update is one ``bincount`` dispatch.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch.ops import kernels

# the module, not the function its package exports under the same name
port_pq = importlib.import_module("torchmetrics_tpu_torch.functional.detection.panoptic_quality")

TOL = 1e-6
THINGS = {0, 1, 7}
STUFFS = {3, 5, 6}


def _jax():
    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu.functional as jax_functional
    jax_pq = importlib.import_module("torchmetrics_tpu.functional.detection.panoptic_quality")
    return jax_tm, jax_functional, jax_pq


def panoptic_maps(seed: int, batch: int = 3, spatial=(12, 10), unknown: bool = True):
    """Targets of thing instances and stuff regions; predictions are the
    targets with blocks relabelled, instances split, and (``unknown``) some
    pixels of a category outside things and stuffs."""
    rng = np.random.RandomState(seed)
    cats = np.array(sorted(THINGS | STUFFS))
    shape = (batch, *spatial)
    block = [max(1, s // 3) for s in spatial]
    coarse = tuple((s + b - 1) // b for s, b in zip(spatial, block))
    target_cat = rng.choice(cats, (batch, *coarse))
    for ax, b in enumerate(block):
        target_cat = np.repeat(target_cat, b, axis=ax + 1)
    target_cat = target_cat[(slice(None),) + tuple(slice(0, s) for s in spatial)]
    target_inst = rng.randint(0, 3, shape) * np.isin(target_cat, list(THINGS))
    target = np.stack([target_cat, target_inst], -1)
    preds = target.copy()
    flip = rng.rand(*shape) < 0.15
    preds[..., 0] = np.where(flip, rng.choice(cats, shape), preds[..., 0])
    preds[..., 1] = np.where(rng.rand(*shape) < 0.1, rng.randint(0, 4, shape), preds[..., 1])
    if unknown:
        preds[..., 0] = np.where(rng.rand(*shape) < 0.05, 11, preds[..., 0])
        target[..., 0] = np.where(rng.rand(*shape) < 0.05, 12, target[..., 0])  # void in the target
    return preds.astype(np.int64), target.astype(np.int64)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("modified", [False, True])
@pytest.mark.parametrize("spatial", [(12, 10), (30,), (4, 5, 6)])
def test_update_stats_against_jax(seed, modified, spatial):
    _, _, jpq = _jax()
    preds, target = panoptic_maps(seed, spatial=spatial)
    void = port_pq._get_void_color(THINGS, STUFFS)
    cat_map = port_pq._get_category_id_to_continuous_id(THINGS, STUFFS)
    fp_ = port_pq._preprocess_inputs(THINGS, STUFFS, torch.from_numpy(preds), void, True)
    ft_ = port_pq._preprocess_inputs(THINGS, STUFFS, torch.from_numpy(target), void, True)
    kernels.reset_gate_log()
    iou_sum, tp, fp, fn = port_pq._panoptic_quality_update(fp_, ft_, cat_map, void, STUFFS if modified else None)
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": 1}
    jp = jpq._preprocess_inputs(THINGS, STUFFS, preds, void, True)
    jt = jpq._preprocess_inputs(THINGS, STUFFS, target, void, True)
    assert np.array_equal(fp_.numpy(), jp) and np.array_equal(ft_.numpy(), jt)
    want = [np.zeros(len(cat_map)), np.zeros(len(cat_map), np.int64), np.zeros(len(cat_map), np.int64), np.zeros(len(cat_map), np.int64)]
    for p, t in zip(jp, jt):  # JAX's float64 per-sample statistics
        for acc, part in zip(want, jpq._panoptic_quality_update_sample(p, t, cat_map, void, STUFFS if modified else None)):
            acc += part
    for got, w in zip((tp, fp, fn), want[1:]):
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), w)
    assert iou_sum.dtype == torch.float64
    np.testing.assert_allclose(iou_sum.numpy(), want[0], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize(
    "kwargs",
    [
        {"allow_unknown_preds_category": True},
        {"allow_unknown_preds_category": True, "return_sq_and_rq": True},
        {"allow_unknown_preds_category": True, "return_per_class": True},
        {"allow_unknown_preds_category": True, "return_sq_and_rq": True, "return_per_class": True},
    ],
)
def test_functional_against_jax(seed, kwargs):
    _, jf, _ = _jax()
    preds, target = panoptic_maps(seed)
    got = F.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS, **kwargs)
    _close(got, jf.panoptic_quality(preds, target, THINGS, STUFFS, **kwargs))


@pytest.mark.parametrize("seed", [5, 6])
def test_modified_functional_against_jax(seed):
    _, jf, _ = _jax()
    preds, target = panoptic_maps(seed)
    got = F.modified_panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS, True)
    _close(got, jf.modified_panoptic_quality(preds, target, THINGS, STUFFS, True))


@pytest.mark.parametrize(
    "cls,extra",
    [
        ("PanopticQuality", {}),
        ("PanopticQuality", {"return_sq_and_rq": True}),
        ("PanopticQuality", {"return_per_class": True}),
        ("ModifiedPanopticQuality", {}),
    ],
)
def test_classes_against_jax(cls, extra):
    jax_tm, _, _ = _jax()
    port = getattr(tm, cls)(THINGS, STUFFS, allow_unknown_preds_category=True, device="cpu", **extra)
    ref = getattr(jax_tm, cls)(THINGS, STUFFS, allow_unknown_preds_category=True, **extra)
    kernels.reset_gate_log()
    for seed in (7, 8, 9):
        preds, target = panoptic_maps(seed, batch=2)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(preds, target)
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": 3}
    for name in ("true_positives", "false_positives", "false_negatives"):
        state = getattr(port, name)
        assert state.dtype == torch.int32 and np.array_equal(state.numpy(), np.asarray(getattr(ref, name)))
    assert port.iou_sum.dtype == torch.float32
    np.testing.assert_allclose(port.iou_sum.numpy(), np.asarray(ref.iou_sum), rtol=TOL, atol=TOL)
    _close(port.compute(), ref.compute())


def test_unknown_prediction_category_raises_without_allow():
    preds, target = panoptic_maps(1)
    with pytest.raises(ValueError, match="Unknown categories"):
        F.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS)
    # an unknown category in the target is void, not an error
    clean, target = panoptic_maps(1, unknown=False)
    target[0, 0, 0, 0] = 99
    F.panoptic_quality(torch.from_numpy(clean), torch.from_numpy(target), THINGS, STUFFS)


def test_no_category_seen_is_nan_like_jax():
    _, jf, _ = _jax()
    void = np.full((1, 3, 3, 2), 0, np.int64)
    void[..., 0] = 12  # unknown: void everywhere
    got = F.panoptic_quality(torch.from_numpy(void), torch.from_numpy(void), THINGS, STUFFS, allow_unknown_preds_category=True)
    want = jf.panoptic_quality(void, void, THINGS, STUFFS, allow_unknown_preds_category=True)
    assert np.isnan(float(got)) and np.isnan(float(want))


def test_argument_checks():
    with pytest.raises(ValueError, match="distinct"):
        tm.PanopticQuality({0, 1}, {1, 2}, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        tm.PanopticQuality(set(), set(), device="cpu")
    with pytest.raises(TypeError):
        tm.PanopticQuality({0.5}, {1}, device="cpu")
    m = tm.PanopticQuality(THINGS, STUFFS, device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        m.update(torch.zeros(1, 2, 2, 2, dtype=torch.int64), torch.zeros(1, 3, 2, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="size 2"):
        m.update(torch.zeros(1, 2, 3, dtype=torch.int64), torch.zeros(1, 2, 3, dtype=torch.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_segments_and_membership(seed):
    """Each image's rows, local indices and counts from the relabel, with
    negative and large ids; the binary-search membership equals
    ``torch.isin``."""
    preds, _ = panoptic_maps(seed, batch=4, spatial=(9, 7))
    flat = torch.from_numpy(preds).reshape(4, -1, 2)
    flat[1, :5, 1] = torch.tensor([-3, 10**12, -(10**12), 7, 0])
    rows, inverse, local, counts = port_pq._segments(flat)
    assert torch.equal(rows[inverse][:, 1:], flat.reshape(-1, 2))
    assert torch.equal(counts, torch.bincount(rows[:, 0], minlength=4))
    assert torch.equal(local, torch.cat([torch.arange(int(c)) for c in counts]))
    for ids in (THINGS, STUFFS, set(), {-(10**12), 7}):
        want = torch.isin(flat, torch.tensor(sorted(ids), dtype=torch.int64))
        assert torch.equal(port_pq._member(flat, ids), want)
