"""The port's MeanAveragePrecision against the JAX package.

The same seeded numpy detections go through JAX (its jitted matcher on the
CPU) and the port on the CPU; every value of the summary dict within 1e-6,
``classes`` equal. Cases: every box format, empty images and images with
only predictions or only targets, crowds, tied scores across images (the
pair-order case), an IoU exactly at a float32 threshold, ``class_metrics``,
custom IoU, recall and max-detection thresholds, masks of different sizes,
and a matcher chunked to one pair at a time against one chunk.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.detection import mean_ap

from test_torch_detection_iou import boxes_xyxy, detection_batch, to_jax, to_torch

TOL = 1e-6


def _jax_tm():
    import torchmetrics_tpu as jax_tm

    return jax_tm


def _run(preds_batches, target_batches, **kwargs):
    port = tm.MeanAveragePrecision(device="cpu", **kwargs)
    ref = _jax_tm().MeanAveragePrecision(**kwargs)
    for preds, target in zip(preds_batches, target_batches):
        port.update(to_torch(preds), to_torch(target))
        ref.update(to_jax(preds), to_jax(target))
    return port.compute(), ref.compute()


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].numpy()
        w = np.asarray(v)
        assert g.shape == w.shape, k
        if k == "classes":
            assert g.dtype == np.int32 and np.array_equal(g, w), k
        else:
            assert g.dtype == np.float32, k
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=k)


def crowded(seed: int, images: int = 5, fmt: str = "xyxy"):
    """``detection_batch`` with about a fifth of the targets crowds, sizes
    spread over COCO's small, medium and large ranges."""
    preds, target = detection_batch(seed, images=images, classes=4, fmt=fmt)
    rng = np.random.RandomState(seed + 100)
    for t in target:
        t["iscrowd"] = (rng.rand(len(t["labels"])) < 0.2).astype(np.int64)
    return preds, target


@pytest.mark.parametrize("fmt", ["xyxy", "xywh", "cxcywh"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bbox_against_jax(fmt, seed):
    batches = [crowded(seed * 10 + b, fmt=fmt) for b in range(2)]
    got, want = _run([b[0] for b in batches], [b[1] for b in batches], box_format=fmt)
    _same(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_bbox_class_metrics_against_jax(seed):
    preds, target = crowded(seed, images=8)
    got, want = _run([preds], [target], class_metrics=True)
    _same(got, want)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"iou_thresholds": [0.3, 0.5, 0.75]},
        {"rec_thresholds": [0.0, 0.25, 0.5, 0.75, 1.0]},
        {"max_detection_thresholds": [2, 5, 3]},
        {"iou_thresholds": [0.55], "max_detection_thresholds": [1], "class_metrics": True},
    ],
)
def test_bbox_custom_thresholds_against_jax(kwargs):
    preds, target = crowded(7, images=6)
    got, want = _run([preds], [target], **kwargs)
    _same(got, want)


def test_images_with_nothing_only_preds_or_only_targets():
    empty = np.zeros((0, 4), np.float32)
    none = np.zeros(0, np.int64)
    preds = [
        {"boxes": empty, "scores": np.zeros(0, np.float32), "labels": none},
        {"boxes": boxes_xyxy(np.random.RandomState(1), 3), "scores": np.array([0.9, 0.5, 0.1], np.float32),
         "labels": np.array([0, 1, 1])},
        {"boxes": empty, "scores": np.zeros(0, np.float32), "labels": none},
    ]
    target = [
        {"boxes": empty, "labels": none},
        {"boxes": empty, "labels": none},
        {"boxes": boxes_xyxy(np.random.RandomState(2), 2), "labels": np.array([1, 2])},
    ]
    got, want = _run([preds], [target], class_metrics=True)
    _same(got, want)


def test_no_data_at_all():
    got, want = _run([[]], [[]])
    _same(got, want)
    assert float(got["map"]) == -1.0


def test_tied_scores_across_images_keep_the_pair_order():
    """Equal scores across images and within an image: the cumulative TP/FP
    order (and so the precision envelope) follows the (image, class) pair
    order and each pair's index order, as the JAX package builds them."""
    rng = np.random.RandomState(9)
    preds, target = [], []
    for i in range(6):
        gt = boxes_xyxy(rng, 3)
        hit = gt + 0.5
        miss = boxes_xyxy(rng, 3) + 200
        # alternate hits and misses at one score, in different orders per image
        det = np.concatenate([miss, hit]) if i % 2 else np.concatenate([hit, miss])
        preds.append({"boxes": det.astype(np.float32), "scores": np.full(6, 0.5, np.float32),
                      "labels": np.array([0, 1, 0, 1, 0, 1])})
        target.append({"boxes": gt, "labels": np.array([0, 1, 0])})
    got, want = _run([preds[:3], preds[3:]], [target[:3], target[3:]], class_metrics=True)
    _same(got, want)
    # the order matters: reversing the images changes the value in both packages
    rev_got, rev_want = _run([preds[::-1]], [target[::-1]], class_metrics=True)
    _same(rev_got, rev_want)
    assert float(rev_got["map"]) != float(got["map"])


def test_iou_exactly_at_a_float32_threshold():
    """IoU 11/20 is float32(0.55); the float32 threshold 0.55 does not pass
    it (``val > thr``), a float64 0.55 would. Boxes on integers, so every
    operation is exact."""
    gt = np.array([[0, 0, 20, 1], [0, 10, 20, 11]], np.float32)
    det = np.array([[0, 0, 11, 1], [0, 10, 20, 11]], np.float32)
    preds = [{"boxes": det, "scores": np.array([0.9, 0.8], np.float32), "labels": np.array([0, 0])}]
    target = [{"boxes": gt, "labels": np.array([0, 0])}]
    iou = mean_ap._box_iou_ioa(torch.from_numpy(det)[None], torch.from_numpy(gt)[None])[0][0, 0, 0]
    assert float(iou) == float(np.float32(0.55))
    got, want = _run([preds], [target], iou_thresholds=[0.5, 0.55, 0.6])
    _same(got, want)
    # matched at 0.5 only for the first detection: 0.5 -> AP 1, 0.55 and 0.6 -> one of two
    assert float(got["map"]) < 1.0


def test_crowd_absorbs_a_detection_by_ioa():
    """A small detection inside a large crowd region: its IoU is low, its
    IoA with the crowd 1, so it is ignored rather than a false positive."""
    gt = np.array([[0, 0, 10, 10], [20, 20, 100, 100]], np.float32)
    det = np.array([[0, 0, 10, 10], [30, 30, 40, 40]], np.float32)
    preds = [{"boxes": det, "scores": np.array([0.9, 0.95], np.float32), "labels": np.array([0, 0])}]
    target = [{"boxes": gt, "labels": np.array([0, 0]), "iscrowd": np.array([0, 1])}]
    got, want = _run([preds], [target])
    _same(got, want)
    assert float(got["map_50"]) == 1.0


def _masks(rng, n: int, h: int, w: int) -> np.ndarray:
    out = np.zeros((n, h, w), bool)
    for k in range(n):
        y, x = rng.randint(0, h - 2), rng.randint(0, w - 2)
        out[k, y : y + rng.randint(2, h - y + 1), x : x + rng.randint(2, w - x + 1)] = True
    return out


def segm_batch(seed: int, shapes=((12, 16), (9, 20), (15, 11))):
    """Masks of a different size in every image; detections are targets
    with pixels flipped, plus false positives."""
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for h, w in shapes:
        n_gt = rng.randint(1, 4)
        gt = _masks(rng, n_gt, h, w)
        det = np.concatenate([gt ^ (rng.rand(n_gt, h, w) < 0.08), _masks(rng, 2, h, w)])
        labels = rng.randint(0, 2, n_gt)
        preds.append({"masks": det, "scores": rng.rand(n_gt + 2).astype(np.float32),
                      "labels": np.concatenate([labels, rng.randint(0, 2, 2)])})
        target.append({"masks": gt, "labels": labels, "iscrowd": (rng.rand(n_gt) < 0.2).astype(np.int64)})
    return preds, target


@pytest.mark.parametrize("seed", [0, 1])
def test_segm_against_jax(seed):
    preds, target = segm_batch(seed)
    got, want = _run([preds], [target], iou_type="segm", class_metrics=True)
    _same(got, want)


def test_segm_detection_and_target_masks_of_different_sizes():
    rng = np.random.RandomState(4)
    gt = _masks(rng, 2, 10, 12)
    det = np.zeros((2, 13, 9), bool)
    det[:, :10, :9] = gt[:, :, :9]
    preds = [{"masks": det, "scores": np.array([0.4, 0.7], np.float32), "labels": np.array([0, 0])}]
    target = [{"masks": gt, "labels": np.array([0, 0])}]
    got, want = _run([preds], [target], iou_type="segm")
    _same(got, want)


def test_matcher_chunked_equals_one_chunk(monkeypatch):
    """A budget of one byte makes every pair a chunk of its own; the values
    equal one chunk's bit for bit, for boxes and masks."""
    preds, target = crowded(21, images=10)
    spreds, starget = segm_batch(22)
    whole = []
    for budget in (1 << 40, 1):
        monkeypatch.setattr(mean_ap, "MATCH_BUDGET_BYTES", budget)
        boxes = tm.MeanAveragePrecision(device="cpu", class_metrics=True)
        boxes.update(to_torch(preds), to_torch(target))
        masks = tm.MeanAveragePrecision(device="cpu", iou_type="segm")
        masks.update(to_torch(spreds), to_torch(starget))
        whole.append((boxes.compute(), masks.compute()))
    for a, b in zip(whole[0], whole[1]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_state_dtypes_follow_jax():
    preds, target = crowded(5, images=3)
    m = tm.MeanAveragePrecision(device="cpu")
    m.update(to_torch(preds), to_torch(target))
    assert {s.dtype for s in m.detections} == {torch.float32}
    assert {s.dtype for s in m.detection_scores} == {torch.float32}
    assert {s.dtype for s in m.detection_labels} == {torch.int64}
    assert {s.dtype for s in m.groundtruth_labels} == {torch.int64}
    assert {s.dtype for s in m.groundtruth_crowds} == {torch.bool}
    assert m._reductions == {k: None for k in m._reductions}
    assert 0 < m._reckoned_peak_bytes() < mean_ap.MATCH_BUDGET_BYTES


def test_refuses_bad_arguments():
    with pytest.raises(ValueError, match="iou_type"):
        tm.MeanAveragePrecision(iou_type="keypoints", device="cpu")
    with pytest.raises(ValueError, match="box_format"):
        tm.MeanAveragePrecision(box_format="xy", device="cpu")
    m = tm.MeanAveragePrecision(device="cpu")
    with pytest.raises(ValueError, match="scores"):
        m.update([{"boxes": torch.zeros(1, 4), "labels": torch.zeros(1)}], [{"boxes": torch.zeros(1, 4), "labels": torch.zeros(1)}])


def test_segm_images_without_masks():
    """An image with no predicted masks and one with no target masks. The
    JAX package takes an empty mask stack as shape ``(0,)`` (a ``(0, H, W)``
    stack fails its padding); the port takes either, with the same values."""
    preds, target = segm_batch(5)
    none = np.zeros(0, np.int64)
    preds[0] = {"masks": np.zeros(0, bool), "scores": np.zeros(0, np.float32), "labels": none}
    target[1] = {"masks": np.zeros(0, bool), "labels": none, "iscrowd": none}
    got, want = _run([preds], [target], iou_type="segm", class_metrics=True)
    _same(got, want)
    preds[0]["masks"] = np.zeros((0, *preds[1]["masks"].shape[1:]), bool)
    target[1]["masks"] = np.zeros((0, *target[0]["masks"].shape[1:]), bool)
    stacked = tm.MeanAveragePrecision(device="cpu", iou_type="segm", class_metrics=True)
    stacked.update(to_torch(preds), to_torch(target))
    _same(stacked.compute(), want)
