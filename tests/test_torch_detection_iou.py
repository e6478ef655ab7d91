"""The port's box algebra and IoU family against the JAX package.

The same seeded numpy boxes go through JAX and the port on the CPU. Every
box format, empty images and images with only predictions or only targets;
IoUs within 1e-6 (float32, the same epsilons).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch.functional.detection import iou as port_iou

TOL = 1e-6
FORMATS = ("xyxy", "xywh", "cxcywh")
PAIRWISE = ("box_iou", "generalized_box_iou", "distance_box_iou", "complete_box_iou")
FUNCTIONALS = (
    "intersection_over_union",
    "generalized_intersection_over_union",
    "distance_intersection_over_union",
    "complete_intersection_over_union",
)
CLASSES = (
    "IntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "CompleteIntersectionOverUnion",
)


def _jax():
    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu.functional as jax_functional
    from torchmetrics_tpu.functional.detection import iou as jax_iou

    return jax_tm, jax_functional, jax_iou


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def boxes_xyxy(rng, n: int, scale: float = 100.0) -> np.ndarray:
    xy = rng.rand(n, 2) * scale
    wh = rng.rand(n, 2) * scale / 3 + 1
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def in_format(boxes: np.ndarray, fmt: str) -> np.ndarray:
    x1, y1, x2, y2 = boxes.T
    if fmt == "xywh":
        return np.stack([x1, y1, x2 - x1, y2 - y1], 1).astype(np.float32)
    if fmt == "cxcywh":
        return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], 1).astype(np.float32)
    return boxes


def detection_batch(seed: int, images: int = 6, classes: int = 3, fmt: str = "xyxy"):
    """Predictions near the targets plus false positives; image 1 has no
    predictions, image 2 no targets, image 3 neither."""
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(images):
        n_gt = 0 if i in (2, 3) else rng.randint(1, 6)
        gt = boxes_xyxy(rng, n_gt)
        gt_labels = rng.randint(0, classes, n_gt)
        n_det = 0 if i in (1, 3) else n_gt + rng.randint(0, 4)
        extra = max(0, n_det - n_gt)
        det = np.concatenate([gt + rng.randn(*gt.shape).astype(np.float32) * 3, boxes_xyxy(rng, extra)])[:n_det]
        det_labels = np.concatenate([gt_labels, rng.randint(0, classes, extra)])[:n_det]
        if n_det:
            flip = rng.rand(n_det) < 0.2
            det_labels = np.where(flip, rng.randint(0, classes, n_det), det_labels)
        preds.append({"boxes": in_format(det.astype(np.float32), fmt), "labels": det_labels,
                      "scores": rng.rand(n_det).astype(np.float32)})
        target.append({"boxes": in_format(gt, fmt), "labels": gt_labels})
    return preds, target


def to_torch(items):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in items]


def to_jax(items):
    import jax.numpy as jnp

    return [{k: jnp.asarray(v) for k, v in d.items()} for d in items]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("out_fmt", FORMATS)
def test_box_convert_against_jax(fmt, out_fmt):
    _, _, jiou = _jax()
    boxes = in_format(boxes_xyxy(np.random.RandomState(3), 11), fmt)
    got = port_iou.box_convert(torch.from_numpy(boxes), fmt, out_fmt)
    np.testing.assert_allclose(_np(got), np.asarray(jiou.box_convert(boxes, fmt, out_fmt)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", PAIRWISE)
@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_against_jax(name, seed):
    _, _, jiou = _jax()
    rng = np.random.RandomState(seed)
    b1, b2 = boxes_xyxy(rng, 9), boxes_xyxy(rng, 7)
    b2[0] = b1[0]  # one identical pair
    got = getattr(port_iou, name)(torch.from_numpy(b1), torch.from_numpy(b2))
    want = np.asarray(getattr(jiou, name)(b1, b2))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", FUNCTIONALS)
@pytest.mark.parametrize(
    "kwargs", [{}, {"aggregate": False}, {"iou_threshold": 0.3}, {"iou_threshold": 0.3, "replacement_val": -1.0, "aggregate": False}]
)
def test_functionals_against_jax(name, kwargs):
    _, jf, _ = _jax()
    rng = np.random.RandomState(5)
    gt = boxes_xyxy(rng, 6)
    det = gt + rng.randn(6, 4).astype(np.float32) * 4
    got = getattr(F, name)(torch.from_numpy(det), torch.from_numpy(gt), **kwargs)
    want = np.asarray(getattr(jf, name)(det, gt, **kwargs))
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functionals_on_empty_boxes(name):
    _, jf, _ = _jax()
    empty = np.zeros((0, 4), np.float32)
    got = getattr(F, name)(torch.from_numpy(empty), torch.from_numpy(empty))
    assert float(got) == float(getattr(jf, name)(empty, empty)) == 0.0


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("options", [
    {},
    {"class_metrics": True},
    {"respect_labels": False, "class_metrics": True},
    {"iou_threshold": 0.4, "class_metrics": True},
])
def test_classes_against_jax(cls, fmt, options):
    jax_tm, _, _ = _jax()
    port = getattr(tm, cls)(box_format=fmt, device="cpu", **options)
    ref = getattr(jax_tm, cls)(box_format=fmt, **options)
    for seed in (11, 12):
        preds, target = detection_batch(seed, fmt=fmt)
        port.update(to_torch(preds), to_torch(target))
        ref.update(to_jax(preds), to_jax(target))
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=TOL, atol=TOL, err_msg=k)
    assert [s.dtype for s in port.iou_matrix] == [torch.float32] * len(port.iou_matrix)
    assert [s.dtype for s in port.groundtruth_labels] == [torch.int32] * len(port.groundtruth_labels)


def test_class_with_no_images_is_zero():
    jax_tm, _, _ = _jax()
    assert float(tm.IntersectionOverUnion(device="cpu").compute()["iou"]) == float(jax_tm.IntersectionOverUnion().compute()["iou"]) == 0.0


def test_class_refuses_bad_arguments_and_inputs():
    with pytest.raises(ValueError, match="box_format"):
        tm.IntersectionOverUnion(box_format="yxyx", device="cpu")
    with pytest.raises(ValueError, match="class_metrics"):
        tm.IntersectionOverUnion(class_metrics=1, device="cpu")
    m = tm.IntersectionOverUnion(device="cpu")
    with pytest.raises(ValueError, match="same length"):
        m.update([{"boxes": torch.zeros(1, 4), "labels": torch.zeros(1)}], [])
    with pytest.raises(ValueError, match="different length"):
        m.update([{"boxes": torch.zeros(2, 4), "labels": torch.zeros(1)}], [{"boxes": torch.zeros(0, 4), "labels": torch.zeros(0)}])


@pytest.mark.parametrize("module", ["detection", "functional.detection", "functional.segmentation", "multimodal", "functional.multimodal"])
def test_exports_match_jax(module):
    import importlib

    port = importlib.import_module(f"torchmetrics_tpu_torch.{module}")
    ref = importlib.import_module(f"torchmetrics_tpu.{module}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(callable(getattr(port, name)) for name in port.__all__)


@pytest.mark.parametrize("root", ["", ".functional"])
def test_root_exports_the_slice_like_jax(root):
    import importlib

    port = importlib.import_module(f"torchmetrics_tpu_torch{root}")
    ref = importlib.import_module(f"torchmetrics_tpu{root}")
    modules = ("detection", "multimodal") if not root else ("detection", "segmentation", "multimodal")
    names = set()
    for module in modules:
        sub = importlib.import_module(f"torchmetrics_tpu{root}.{module}")
        names |= {n for n in sub.__all__ if hasattr(ref, n)}
    assert names and all(hasattr(port, n) for n in names)
    assert all(hasattr(port, m) for m in modules if hasattr(ref, m))
    listed = set(getattr(ref, "__all__", [])) & names
    assert listed <= set(port.__all__)
