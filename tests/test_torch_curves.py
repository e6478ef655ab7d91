"""The port's threshold curves and calibration error against the JAX package.

PR curve, ROC, AUROC and average precision in binary, multiclass (averages
``None``/``micro``/``macro`` for the curves, ``macro``/``weighted``/``none``
for the scores) and multilabel form; exact (``thresholds=None``) and binned
(an int, a list, an unsorted tensor) modes; ``ignore_index`` unset and set;
``max_fpr``; the ``capacity=`` buffers; and a ``MetricCollection`` whose
curves share one compute group. Calibration error in binary and multiclass
form, every norm, both state formulations.

The same numpy batches go through the JAX function or metric (eager,
``executor=False``) and the port's on the CPU. Inputs are probabilities, not
logits, wherever counts must match: ``torch.sigmoid`` and
``jax.nn.sigmoid`` differ by an ulp on a few hundred of 100,000 float32
logits, which moves a score across a threshold. Tolerances:

- binned ``(T, [C,] 2, 2)`` states and exact-mode sample lists: equal;
- float outputs: rtol 1e-5, atol 1e-6. Both sides compute in float32 (the
  exact curve in float64, rounded once), but reductions run in another order
  and XLA may fuse a multiply-add that PyTorch rounds twice;
- calibration error: rtol 1e-5, atol 1e-6, because the port's plain
  ``bincount`` sums the confidence weights in float64 and the JAX scatter in
  float32.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jax_tm
import torchmetrics_tpu.classification as jax_classification
import torchmetrics_tpu.functional as jax_functional
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.classification as classification
import torchmetrics_tpu_torch.functional as functional
from torchmetrics_tpu_torch.ops import kernels

N = 64
NUM_CLASSES = 4
NUM_LABELS = 3
RTOL = 1e-5
ATOL = 1e-6
IGNORE = -1
GRID = np.array([0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0], dtype=np.float32)
UNSORTED = np.array([0.6, 0.05, 0.5, 0.95, 0.25, 0.5, 0.33], dtype=np.float32)
THRESHOLDS = {"exact": None, "int": 7, "list": [float(x) for x in GRID], "tensor": UNSORTED}


def _thresholds(kind, framework):
    value = THRESHOLDS[kind]
    if isinstance(value, np.ndarray):
        return jnp.asarray(value) if framework == "jax" else torch.from_numpy(value)
    return value


def _batches(task, ignore_index, seed, n_batches=2):
    """Probabilities (no sigmoid/softmax on either side), a tenth of them
    exactly on a threshold of the grids above, targets with ignored entries."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        if task == "binary":
            preds = rng.rand(N)
            target = rng.randint(0, 2, N)
        elif task == "multiclass":
            preds = rng.rand(N, NUM_CLASSES)
            preds /= preds.sum(1, keepdims=True)
            target = rng.randint(0, NUM_CLASSES, N)
        else:
            preds = rng.rand(N, NUM_LABELS)
            target = rng.randint(0, 2, (N, NUM_LABELS))
        preds = preds.astype(np.float32)
        on_grid = rng.rand(*preds.shape) < 0.1
        preds[on_grid] = rng.choice(np.concatenate([GRID, UNSORTED]), int(on_grid.sum()))
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.15] = ignore_index
        out.append((preds, target.astype(np.int64)))
    return out


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_close(port, ref, exact=False):
    """Recursive comparison of (nested tuples/lists of) tensors and arrays."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_close(p, r, exact)
        return
    port, ref = _to_numpy(port), _to_numpy(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _task_kwargs(task):
    if task == "multiclass":
        return {"num_classes": NUM_CLASSES}
    if task == "multilabel":
        return {"num_labels": NUM_LABELS}
    return {}


# ------------------------------------------------------------------ functional

CURVE_AVERAGES = {"binary": [None], "multiclass": [None, "micro", "macro"], "multilabel": [None]}
SCORE_AVERAGES = {"binary": [None], "multiclass": ["macro", "weighted", "none"], "multilabel": ["micro", "macro", "weighted", "none"]}


def _functional_cases():
    for kind in THRESHOLDS:
        for ignore in (False, True):
            for task in ("binary", "multiclass", "multilabel"):
                for fn in ("precision_recall_curve", "roc"):
                    for average in CURVE_AVERAGES[task]:
                        yield f"{task}_{fn}", task, {} if average is None else {"average": average}, kind, ignore
                for fn in ("auroc", "average_precision"):
                    for average in SCORE_AVERAGES[task]:
                        yield f"{task}_{fn}", task, {} if average is None else {"average": average}, kind, ignore
            yield "binary_auroc", "binary", {"max_fpr": 0.3}, kind, ignore


def _params(cases):
    """pytest params named ``<metric>-<options>-<mode>-<ignore>``."""
    out = []
    for case in cases:
        name, _, kw, kind, ignore = case
        label = "-".join([name, *(f"{k}={v}" for k, v in kw.items()), kind, "ignore" if ignore else "all"])
        out.append(pytest.param(*case, id=label))
    return out


@pytest.mark.parametrize("name,task,kw,kind,ignore", _params(_functional_cases()))
def test_functional_matches_jax(name, task, kw, kind, ignore):
    ignore_index = IGNORE if ignore else None
    preds, target = _batches(task, ignore_index, seed=len(name) + len(kind))[0]
    kw = dict(kw, ignore_index=ignore_index, **_task_kwargs(task))
    port = getattr(functional, name)(torch.from_numpy(preds), torch.from_numpy(target), thresholds=_thresholds(kind, "torch"), **kw)
    ref = getattr(jax_functional, name)(jnp.asarray(preds), jnp.asarray(target), thresholds=_thresholds(kind, "jax"), **kw)
    _assert_close(port, ref)


@pytest.mark.parametrize("fn", ["precision_recall_curve", "roc", "auroc", "average_precision"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_dispatch_matches_jax(fn, task):
    preds, target = _batches(task, None, seed=5)[0]
    kw = dict(task=task, thresholds=7, **_task_kwargs(task))
    port = getattr(functional, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    ref = getattr(jax_functional, fn)(jnp.asarray(preds), jnp.asarray(target), **kw)
    _assert_close(port, ref)


# --------------------------------------------------------------------- modular

CLASS_AVERAGES = {
    "PrecisionRecallCurve": {"binary": [None], "multiclass": [None, "micro", "macro"], "multilabel": [None]},
    "ROC": {"binary": [None], "multiclass": [None, "micro", "macro"], "multilabel": [None]},
    "AUROC": SCORE_AVERAGES,
    "AveragePrecision": SCORE_AVERAGES,
}
PREFIX = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}


def _modular_cases():
    for kind in ("exact", "int", "tensor"):
        for ignore in (False, True):
            for family, averages in CLASS_AVERAGES.items():
                for task in ("binary", "multiclass", "multilabel"):
                    for average in averages[task]:
                        yield PREFIX[task] + family, task, {} if average is None else {"average": average}, kind, ignore
            yield "BinaryAUROC", "binary", {"max_fpr": 0.3}, kind, ignore


def _state_value(value):
    """A state as one array: list states are concatenated."""
    if isinstance(value, list):
        return np.concatenate([_to_numpy(v).reshape((-1,) + _to_numpy(v).shape[1:]) for v in value])
    return _to_numpy(value)


@pytest.mark.parametrize("cls,task,kw,kind,ignore", _params(_modular_cases()))
def test_metric_matches_jax(cls, task, kw, kind, ignore):
    ignore_index = IGNORE if ignore else None
    kw = dict(kw, ignore_index=ignore_index, **_task_kwargs(task))
    port = getattr(classification, cls)(thresholds=_thresholds(kind, "torch"), **kw, device="cpu")
    ref = getattr(jax_classification, cls)(thresholds=_thresholds(kind, "jax"), **kw, executor=False)
    for preds, target in _batches(task, ignore_index, seed=len(cls) + len(kind)):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert port.metric_state.keys() == ref.metric_state.keys()
    for name, value in port.metric_state.items():
        if kind != "exact":
            assert value.dtype == torch.int32, name
        _assert_close(_state_value(value), _state_value(ref.metric_state[name]), exact=True)
    _assert_close(port.compute(), ref.compute())


@pytest.mark.parametrize("family", list(CLASS_AVERAGES))
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_wrapper_builds_the_task_metric(family, task):
    port = getattr(classification, family)(task=task, thresholds=5, **_task_kwargs(task), device="cpu")
    ref = getattr(jax_classification, family)(task=task, thresholds=5, **_task_kwargs(task), executor=False)
    assert type(port).__name__ == type(ref).__name__ == PREFIX[task] + family
    assert port.thresholds.device == torch.device("cpu")


@pytest.mark.parametrize("interface", ["functional", "modular"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_binned_auroc_under_inference_mode_matches_jax(interface, task):
    """Evaluation runs under ``torch.inference_mode()``: thresholds made
    there are inference tensors, and the binned update still counts them."""
    batches = _batches(task, IGNORE, seed=11)
    kw = dict(thresholds=7, ignore_index=IGNORE, **_task_kwargs(task))
    with torch.inference_mode():
        if interface == "functional":
            preds, target = batches[0]
            port = functional.auroc(torch.from_numpy(preds), torch.from_numpy(target), task=task, **kw)
        else:
            metric = classification.AUROC(task=task, **kw, device="cpu").to("cpu")
            for preds, target in batches:
                metric.update(torch.from_numpy(preds), torch.from_numpy(target))
            port = metric.compute()
    if interface == "functional":
        ref = jax_functional.auroc(jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]), task=task, **kw)
    else:
        jax_metric = jax_classification.AUROC(task=task, **kw, executor=False)
        for preds, target in batches:
            jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        ref = jax_metric.compute()
    _assert_close(port, ref)


@pytest.mark.parametrize("capacity", [200, 100])
def test_capacity_buffers_match_jax(capacity):
    port = classification.BinaryAUROC(capacity=capacity, ignore_index=IGNORE, device="cpu")
    ref = jax_classification.BinaryAUROC(capacity=capacity, ignore_index=IGNORE, executor=False)
    batches = _batches("binary", IGNORE, seed=11, n_batches=3)
    for preds, target in batches:
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    for name, value in port.metric_state.items():
        _assert_close(value, ref.metric_state[name], exact=True)
    overflow = int(port.sample_count) > capacity
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = port.compute()
    assert overflow == any("overflowed" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_close(value, ref.compute())
    if not overflow:  # every valid sample kept: the buffers equal the growing lists
        plain = classification.BinaryAUROC(ignore_index=IGNORE, device="cpu")
        for preds, target in batches:
            plain.update(torch.from_numpy(preds), torch.from_numpy(target))
        assert torch.equal(plain.compute(), value)


def test_capacity_is_refused_in_binned_mode():
    with pytest.raises(ValueError, match="only applies to exact mode"):
        classification.BinaryPrecisionRecallCurve(thresholds=5, capacity=10, device="cpu")


@pytest.mark.parametrize("kind", ["exact", "int"])
def test_collection_curves_share_one_compute_group(kind):
    names = ("BinaryAUROC", "BinaryAveragePrecision", "BinaryROC")
    port = tm.MetricCollection(
        {n: getattr(classification, n)(thresholds=_thresholds(kind, "torch"), device="cpu") for n in names}, device="cpu"
    )
    refs = {n: getattr(jax_classification, n)(thresholds=_thresholds(kind, "jax"), executor=False) for n in names}
    kernels.reset_gate_log()
    batches = _batches("binary", None, seed=17, n_batches=3)
    for preds, target in batches:
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        for m in refs.values():
            m.update(jnp.asarray(preds), jnp.asarray(target))
    assert [sorted(g) for g in port.compute_groups.values()] == [sorted(names)]
    if kind == "int":
        # every member counts on the first update, one leader on each later one
        assert kernels.gate_snapshot()["binned_curve"]["selections"] == {"reference": len(names) + len(batches) - 1}
    result = port.compute()
    for n, m in refs.items():
        _assert_close(result[n], m.compute())


def test_jax_collection_groups_the_same_metrics():
    names = ("BinaryAUROC", "BinaryAveragePrecision", "BinaryROC")
    ref = jax_tm.MetricCollection({n: getattr(jax_classification, n)(thresholds=7, executor=False) for n in names})
    port = tm.MetricCollection({n: getattr(classification, n)(thresholds=7, device="cpu") for n in names}, device="cpu")
    for preds, target in _batches("binary", None, seed=19):
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert sorted(map(sorted, ref.compute_groups.values())) == sorted(map(sorted, port.compute_groups.values()))


def test_logits_agree_with_the_ports_own_probabilities():
    """Logits go through ``torch.sigmoid``; the port's counts then equal its
    counts on the same probabilities, and the JAX counts (through
    ``jax.nn.sigmoid``) within one sample per threshold cell."""
    rng = np.random.RandomState(23)
    logits = (rng.randn(4 * N) * 3).astype(np.float32)
    target = rng.randint(0, 2, 4 * N)
    on_logits = classification.BinaryPrecisionRecallCurve(thresholds=7, device="cpu")
    on_logits.update(torch.from_numpy(logits), torch.from_numpy(target))
    on_probs = classification.BinaryPrecisionRecallCurve(thresholds=7, device="cpu")
    on_probs.update(torch.sigmoid(torch.from_numpy(logits)), torch.from_numpy(target))
    assert torch.equal(on_logits.confmat, on_probs.confmat)
    ref = jax_classification.BinaryPrecisionRecallCurve(thresholds=7, executor=False)
    ref.update(jnp.asarray(logits), jnp.asarray(target))
    assert np.abs(on_logits.confmat.numpy() - np.asarray(ref.confmat)).max() <= 1


@pytest.mark.parametrize(
    "cls,kw,error",
    [
        ("BinaryROC", {"thresholds": 1}, "larger than 1"),
        ("BinaryROC", {"thresholds": [0.5, 2.0]}, "list"),
        ("MulticlassROC", {"num_classes": 1}, "num_classes"),
        ("MulticlassROC", {"num_classes": 3, "average": "weighted"}, "average"),
        ("MulticlassAUROC", {"num_classes": 3, "average": "micro"}, "average"),
        ("BinaryAUROC", {"max_fpr": 1.5}, "max_fpr"),
        ("BinaryCalibrationError", {"norm": "l3"}, "norm"),
        ("BinaryCalibrationError", {"n_bins": 0}, "n_bins"),
    ],
)
def test_bad_arguments_raise_like_jax(cls, kw, error):
    with pytest.raises(ValueError, match=error):
        getattr(jax_classification, cls)(**kw, executor=False)
    with pytest.raises(ValueError, match=error):
        getattr(classification, cls)(**kw, device="cpu")


@pytest.mark.parametrize(
    "cls,kw,preds,target",
    [
        ("BinaryAUROC", {}, [0.2, 0.8], [0, 2]),
        ("BinaryAUROC", {}, [0.2, 0.8], [0.0, 1.0]),
        ("MulticlassAUROC", {"num_classes": 3}, [[0.2, 0.3, 0.5]], [3]),
        ("MultilabelAUROC", {"num_labels": 2}, [[0.1, 0.9]], [[0, 2]]),
    ],
)
def test_bad_values_raise_like_jax(cls, kw, preds, target):
    ref = getattr(jax_classification, cls)(**kw, executor=False)
    port = getattr(classification, cls)(**kw, device="cpu")
    with pytest.raises(ValueError):
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    with pytest.raises(ValueError):
        port.update(torch.tensor(preds), torch.tensor(target))
    assert port.update_count == 0  # the failed update rolled back


# ----------------------------------------------------------------- calibration

def _calibration_cases():
    for task in ("binary", "multiclass"):
        for norm in ("l1", "l2", "max"):
            for ignore in (False, True):
                yield task, norm, ignore


@pytest.mark.parametrize("task,norm,ignore", list(_calibration_cases()))
def test_calibration_functional_matches_jax(task, norm, ignore):
    ignore_index = IGNORE if ignore else None
    preds, target = _batches(task, ignore_index, seed=29)[0]
    kw = dict(task=task, norm=norm, n_bins=10, ignore_index=ignore_index, **_task_kwargs(task))
    port = functional.calibration_error(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    ref = jax_functional.calibration_error(jnp.asarray(preds), jnp.asarray(target), **kw)
    _assert_close(port, ref)


@pytest.mark.parametrize("formulation", ["binned", "samples"])
@pytest.mark.parametrize("task,norm,ignore", list(_calibration_cases()))
def test_calibration_metric_matches_jax(task, norm, ignore, formulation):
    ignore_index = IGNORE if ignore else None
    kw = dict(norm=norm, ignore_index=ignore_index, formulation=formulation, **_task_kwargs(task))
    cls = "BinaryCalibrationError" if task == "binary" else "MulticlassCalibrationError"
    port = getattr(classification, cls)(**kw, device="cpu")
    ref = getattr(jax_classification, cls)(**kw, executor=False)
    for preds, target in _batches(task, ignore_index, seed=31):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    for name, value in port.metric_state.items():
        # bin counts are integers and exact; the sums follow the stated tolerance
        _assert_close(_state_value(value), _state_value(ref.metric_state[name]), exact=name == "bin_count")
    _assert_close(port.compute(), ref.compute())


# ------------------------------------------------------------ curve utilities

@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("direction", ["increasing", "decreasing", "shuffled"])
def test_auc_matches_jax(reorder, direction):
    from torchmetrics_tpu.utils.compute import auc as jax_auc
    from torchmetrics_tpu_torch.utils.compute import auc

    rng = np.random.RandomState(37)
    x = np.sort(rng.rand(20)).astype(np.float32)
    if direction == "decreasing":
        x = x[::-1].copy()
    elif direction == "shuffled":
        rng.shuffle(x)
    y = rng.rand(20).astype(np.float32)
    _assert_close(auc(torch.from_numpy(x), torch.from_numpy(y), reorder=reorder), jax_auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder))


@pytest.mark.parametrize("axis", [-1, 0])
def test_auc_without_check_matches_jax(axis):
    from torchmetrics_tpu.utils.compute import _auc_compute_without_check as jax_fn
    from torchmetrics_tpu_torch.utils.compute import _auc_compute_without_check

    rng = np.random.RandomState(41)
    x = np.sort(rng.rand(5, 9), axis=axis).astype(np.float32)
    y = rng.rand(5, 9).astype(np.float32)
    _assert_close(
        _auc_compute_without_check(torch.from_numpy(x), torch.from_numpy(y), 1.0, axis=axis),
        jax_fn(jnp.asarray(x), jnp.asarray(y), 1.0, axis=axis),
    )


@pytest.mark.parametrize("xp_kind", ["sorted", "ties", "unsorted"])
def test_interp_matches_jax(xp_kind):
    from torchmetrics_tpu.utils.compute import interp as jax_interp
    from torchmetrics_tpu_torch.utils.compute import interp

    rng = np.random.RandomState(43)
    xp = np.sort(rng.rand(12)).astype(np.float32)
    if xp_kind == "ties":
        xp[3:6] = xp[3]
    elif xp_kind == "unsorted":
        rng.shuffle(xp)
    fp = rng.rand(12).astype(np.float32)
    x = np.concatenate([rng.rand(30), [-0.5, 1.5], xp[:3]]).astype(np.float32)  # past both ends, on knots
    _assert_close(
        interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)),
        jax_interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)),
    )
