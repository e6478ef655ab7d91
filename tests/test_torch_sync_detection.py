"""The detection metrics synced across a spawned 2-rank gloo world equal one
process that saw both ranks' updates, rank 0's first.

``MeanAveragePrecision`` (boxes with crowds, and masks of a different size
in every image) and the IoU family keep ``None``-reduced list states of
one entry an image: the sync must keep every image's entry apart, in rank
order (``detection.helpers.sync_keeping_entries``), so the summary dicts are
bit-equal to the single process's. ``PanopticQuality``'s summed states: the
counts equal as integers, the float32 IoU sums within 1e-6 (two ranks' sums
add in another order). Each rank computes twice: ``compute()`` (sync on
compute) and ``functional_compute(functional_sync(state()))``.

This module imports only torch, numpy and the port at its top level: the
ranks import it to find their target.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from helpers.torch_world import run_world
from test_torch_detection_iou import to_torch
from test_torch_mean_ap import crowded, segm_batch
from test_torch_panoptic import STUFFS, THINGS, panoptic_maps

WORLD = 2


def _metrics():
    return {
        "bbox": tm.MeanAveragePrecision(device="cpu", class_metrics=True),
        "segm": tm.MeanAveragePrecision(device="cpu", iou_type="segm"),
        "giou": tm.GeneralizedIntersectionOverUnion(device="cpu", class_metrics=True),
        "pq": tm.PanopticQuality(THINGS, STUFFS, allow_unknown_preds_category=True, return_sq_and_rq=True, device="cpu"),
    }


def _feed(metrics, rank: int) -> None:
    for step in range(2):
        seed = 100 * rank + step
        preds, target = crowded(seed, images=3 + rank)
        metrics["bbox"].update(to_torch(preds), to_torch(target))
        metrics["giou"].update(to_torch(preds), to_torch(target))
        spreds, starget = segm_batch(seed, shapes=((10 + rank, 12), (8, 9 + step)))
        metrics["segm"].update(to_torch(spreds), to_torch(starget))
        ppreds, ptarget = panoptic_maps(seed, batch=2)
        metrics["pq"].update(torch.from_numpy(ppreds), torch.from_numpy(ptarget))


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.numpy().copy()


def _rank_target(rank, world):
    metrics = _metrics()
    _feed(metrics, rank)
    out = {}
    for name, m in metrics.items():
        synced = m.functional_sync(m.state())
        out[name] = {
            "computed": _np(m.compute()),
            "functional": _np(m.functional_compute(synced)),
        }
        if name == "pq":
            out[name]["states"] = {k: synced[k].numpy().copy() for k in ("iou_sum", "true_positives", "false_positives", "false_negatives")}
        if name == "bbox":
            out[name]["synced_images"] = len(synced["groundtruths"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_world(WORLD, tmp_path_factory.mktemp("gloo_detection"), _rank_target)


@pytest.fixture(scope="module")
def single():
    metrics = _metrics()
    for rank in range(WORLD):
        _feed(metrics, rank)
    return {name: m for name, m in metrics.items()}


@pytest.mark.parametrize("name", ["bbox", "segm", "giou"])
def test_list_states_synced_keep_every_image(ranks, single, name):
    want = _np(single[name].compute())
    for res in ranks:
        for key in ("computed", "functional"):
            got = res[name][key]
            assert sorted(got) == sorted(want)
            for k in want:
                assert np.array_equal(got[k], want[k], equal_nan=True), (name, key, k)
    assert [r["bbox"]["synced_images"] for r in ranks] == [len(single["bbox"].groundtruths)] * WORLD


def test_panoptic_summed_states_synced(ranks, single):
    m = single["pq"]
    for res in ranks:
        states = res["pq"]["states"]
        for k in ("true_positives", "false_positives", "false_negatives"):
            assert states[k].dtype == np.int32 and np.array_equal(states[k], getattr(m, k).numpy())
        np.testing.assert_allclose(states["iou_sum"], m.iou_sum.numpy(), rtol=1e-6, atol=1e-6)
        for key in ("computed", "functional"):
            np.testing.assert_allclose(res["pq"][key], m.compute().numpy(), rtol=1e-6, atol=1e-6)
