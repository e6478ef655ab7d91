"""The port's ``MetricCollection`` against the JAX package, and the slice as a whole.

The collection shaped like the package's entry point (accuracy, F1,
precision, recall and the confusion matrix) and a small Cityscapes-shaped
segmentation collection are driven with the same numpy batches through
both packages on the CPU: compute groups must match, int32 states must be
equal, computed values within rtol=1e-6. A JAX-accumulated state exported
to numpy continues in the port (``load_numpy_state``) to the same final value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jax_tm
import torchmetrics_tpu.classification as jax_classification
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.classification as classification
from torchmetrics_tpu_torch.ops import fused_classification, kernels
from torchmetrics_tpu_torch.utils.convert import load_numpy_state

C = 10


def _entry(pkg, **extra):
    return {
        "accuracy": pkg.MulticlassAccuracy(num_classes=C, average="micro", **extra),
        "f1": pkg.MulticlassF1Score(num_classes=C, average="macro", **extra),
        "precision": pkg.MulticlassPrecision(num_classes=C, average="macro", **extra),
        "recall": pkg.MulticlassRecall(num_classes=C, average="macro", **extra),
        "confmat": pkg.MulticlassConfusionMatrix(num_classes=C, **extra),
    }


def _pair():
    ref = jax_tm.MetricCollection(_entry(jax_classification, executor=False), executor=False)
    port = tm.MetricCollection(_entry(classification, device="cpu"), device="cpu")
    return ref, port


def _batches(n=3, seed=0, batch=32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, C).astype(np.float32), rng.randint(0, C, batch)) for _ in range(n)]


def _j(preds, target):
    return jnp.asarray(preds), jnp.asarray(target)


def _t(preds, target):
    return torch.from_numpy(preds), torch.from_numpy(target)


def _assert_results(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(
            port[k].numpy().astype(np.float64), np.asarray(ref[k]).astype(np.float64), rtol=1e-6, atol=0, err_msg=k
        )


def _assert_states(port_states, ref_states):
    assert set(port_states) == set(ref_states)
    for leader, st in ref_states.items():
        for field, value in st.items():
            if field == "_update_count":
                assert port_states[leader][field] == value
            else:
                np.testing.assert_array_equal(port_states[leader][field].numpy(), np.asarray(value), err_msg=field)


def _groups(coll):
    return sorted(sorted(g) for g in coll.compute_groups.values())


def test_entry_collection_matches_jax():
    ref, port = _pair()
    for b in _batches():
        ref.update(*_j(*b))
        port.update(*_t(*b))
    assert _groups(port) == _groups(ref) == [["accuracy"], ["confmat"], ["f1", "precision", "recall"]]
    _assert_states(port.state(), ref.state())
    _assert_results(port.compute(), ref.compute())
    assert port.state_spec() == ref.state_spec()


def test_functional_path_matches_jax():
    ref, port = _pair()
    batches = _batches(seed=1)
    ref.resolve_compute_groups(*_j(*batches[0]))
    port.resolve_compute_groups(*_t(*batches[0]))
    assert _groups(port) == _groups(ref)
    ref_states, port_states = ref.functional_init(), port.functional_init()
    for b in batches:
        ref_states = ref.functional_update(ref_states, *_j(*b))
        port_states = port.functional_update(port_states, *_t(*b))
    _assert_results(port.functional_compute(port_states), ref.functional_compute(ref_states))
    ref_states, ref_vals = ref.functional_forward(ref_states, *_j(*batches[0]), update_count=3)
    port_states, port_vals = port.functional_forward(port_states, *_t(*batches[0]), update_count=3)
    _assert_results(port_vals, ref_vals)
    _assert_results(port.functional_compute(port_states), ref.functional_compute(ref_states))
    merged_ref = ref.merge_states(ref_states, ref_states)
    merged_port = port.merge_states(port_states, port_states)
    _assert_results(port.functional_compute(merged_port), ref.functional_compute(merged_ref))


def test_forward_matches_jax():
    ref, port = _pair()
    for b in _batches(seed=2):
        _assert_results(port(*_t(*b)), ref(*_j(*b)))
    _assert_results(port.compute(), ref.compute())
    _assert_states(port.state(), ref.state())


@pytest.mark.parametrize("fresh_groups", [False, True])
def test_load_numpy_state_continues_a_jax_state(fresh_groups):
    ref, port = _pair()
    batches = _batches(n=4, seed=3)
    for b in batches[:3]:
        ref.update(*_j(*b))
    exported = {
        leader: {k: (v if k == "_update_count" else np.asarray(v)) for k, v in st.items()}
        for leader, st in ref.state().items()
    }
    if not fresh_groups:
        port.resolve_compute_groups(*_t(*batches[0]))
    load_numpy_state(port, exported)
    assert port.update_count == 3
    ref.update(*_j(*batches[3]))
    port.update(*_t(*batches[3]))
    _assert_results(port.compute(), ref.compute())
    np.testing.assert_array_equal(port["confmat"].confmat.numpy(), np.asarray(ref["confmat"].confmat))


def test_load_numpy_state_into_one_metric():
    rng = np.random.RandomState(4)
    ref = jax_classification.MulticlassJaccardIndex(num_classes=C, ignore_index=255, executor=False)
    port = classification.MulticlassJaccardIndex(num_classes=C, ignore_index=255, device="cpu")
    target = rng.randint(0, C, (2, 6, 6))
    target[rng.rand(2, 6, 6) < 0.1] = 255
    preds = rng.randn(2, C, 6, 6).astype(np.float32)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    load_numpy_state(port, {k: (v if k == "_update_count" else np.asarray(v)) for k, v in ref.state().items()})
    ref.update(jnp.asarray(preds[::-1].copy()), jnp.asarray(target))
    port.update(torch.from_numpy(preds[::-1].copy()), torch.from_numpy(target))
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), rtol=1e-6)
    assert port.tp.dtype == torch.int32 and port.update_count == 2


def test_segmentation_collection_matches_jax():
    rng = np.random.RandomState(5)
    c, ignore = 19, 255

    def members(pkg, **extra):
        return {
            "jaccard": pkg.MulticlassJaccardIndex(num_classes=c, ignore_index=ignore, average="macro", **extra),
            "accuracy": pkg.MulticlassAccuracy(num_classes=c, ignore_index=ignore, **extra),
            "confmat": pkg.MulticlassConfusionMatrix(num_classes=c, ignore_index=ignore, **extra),
        }

    ref = jax_tm.MetricCollection(members(jax_classification, executor=False), executor=False)
    port = tm.MetricCollection(members(classification, device="cpu"), device="cpu")
    for _ in range(3):
        preds = rng.randn(2, c, 8, 16).astype(np.float32)
        target = rng.randint(0, c, (2, 8, 16))
        target[rng.rand(2, 8, 16) < 0.05] = ignore
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert _groups(port) == _groups(ref) == [["accuracy", "jaccard"], ["confmat"]]
    _assert_states(port.state(), ref.state())
    _assert_results(port.compute(), ref.compute())


def _selections():
    return kernels.gate_snapshot().get("bincount", {}).get("selections", {}).get("reference", 0)


def test_one_bincount_per_collection_update():
    _, port = _pair()
    kernels.reset_gate_log()
    for i, b in enumerate(_batches(n=3, seed=6), start=1):
        port.update(*_t(*b))  # the first update runs all five members, later ones the three leaders
        assert _selections() == i
    port(*_t(*_batches(n=1, seed=7)[0]))
    assert _selections() == 4


def test_unfused_confusion_matrix_still_reaches_the_kernel(monkeypatch):
    monkeypatch.setenv(fused_classification.FUSED_ENV, "0")
    m = classification.MulticlassConfusionMatrix(num_classes=C, device="cpu")
    kernels.reset_gate_log()
    m.update(*_t(*_batches(n=1, seed=8)[0]))
    assert _selections() == 1


def test_reset_clone_and_state_round_trip():
    _, port = _pair()
    for b in _batches(seed=9):
        port.update(*_t(*b))
    values = port.compute()
    clone = port.clone(prefix="val_")
    assert set(clone.compute()) == {f"val_{k}" for k in values}
    fresh = tm.MetricCollection(_entry(classification, device="cpu"), device="cpu")
    fresh.load_state(port.state())
    _assert_results(fresh.compute(), {k: v.numpy() for k, v in values.items()})
    port.reset()
    assert port.update_count == 0 and int(port["confmat"].confmat.sum()) == 0
    assert port["f1"].tp is port["recall"].tp  # followers share the leader's tensors after reset
    assert int(clone["confmat"].confmat.sum()) == 96
