"""The port's plotting (``utils/plot.py``, ``Metric.plot`` and the class
overrides) against the JAX package's, with matplotlib on ``Agg``.

As the JAX package's ``tests/test_plot_sweep.py``: build a metric, update
it, call ``plot()`` and require a live (figure, axes) pair; here each case
also draws the JAX class on the same data and the two drawings must agree:
the same lines (x and y data within rtol 1e-5, atol 1e-6, the values'
own tolerance), labels, legend entries, title and axis labels. The plot
functions are held to the JAX package's on every value layout, and a
missing matplotlib raises ``ModuleNotFoundError`` both when a plot is
drawn and, in a fresh interpreter without matplotlib, after a clean import
of the port.
"""
from __future__ import annotations

import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import torchmetrics_tpu_torch as tm  # noqa: E402
from torchmetrics_tpu_torch import classification, regression  # noqa: E402
from torchmetrics_tpu_torch.utils import plot as port_plot  # noqa: E402

N = 24


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu as jax_tm
    from torchmetrics_tpu.utils import plot as jax_plot

    return jnp, jax_tm, jax_plot


def _drawing(fig, ax):
    """What a drawing shows: every axes' lines (x, y, label), title, axis
    labels, legend entries and tick labels."""
    axes = list(np.asarray(ax).ravel()) if isinstance(ax, np.ndarray) else [ax]
    axes = [a for a in axes if a.figure is not None]  # a grid's removed spare axes
    out = []
    for a in axes:
        legend = a.get_legend()
        out.append({
            "lines": [(np.asarray(l.get_xdata(), np.float64), np.asarray(l.get_ydata(), np.float64), l.get_label()) for l in a.get_lines()],
            "texts": [t.get_text() for t in a.texts],
            "title": a.get_title(), "xlabel": a.get_xlabel(), "ylabel": a.get_ylabel(),
            "legend": [t.get_text() for t in legend.get_texts()] if legend else None,
            "xticks": [t.get_text() for t in a.get_xticklabels()],
            "images": [np.asarray(im.get_array(), np.float64) for im in a.get_images()],
        })
    assert fig is not None
    plt.close(fig)
    return out


def _same_drawing(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert (p["title"], p["xlabel"], p["ylabel"], p["xticks"]) == (r["title"], r["xlabel"], r["ylabel"], r["xticks"])
        assert len(p["lines"]) == len(r["lines"])
        for (px, py, pl), (rx, ry, rl) in zip(p["lines"], r["lines"]):
            np.testing.assert_allclose(px, rx, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(py, ry, rtol=1e-5, atol=1e-6)
        assert len(p["images"]) == len(r["images"])
        for pi, ri in zip(p["images"], r["images"]):
            np.testing.assert_allclose(pi, ri, rtol=1e-5, atol=1e-6)
        # labels and texts carry formatted values: compare those with a
        # score rounded alike, and the rest exactly
        assert [l for *_, l in p["lines"]] == [l for *_, l in r["lines"]]
        assert p["legend"] == r["legend"] and p["texts"] == r["texts"]


# --------------------------------------------------------------- the sweep


def _regression_data(shape=(N,), seed=0):
    rng = np.random.RandomState(seed)
    target = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    return target * rng.uniform(0.8, 1.2, shape).astype(np.float32), target


def _probs(seed=0, shape=(N,)):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.randint(0, 2, shape)


def _multiclass(seed=0, c=3):
    rng = np.random.RandomState(seed)
    p = rng.rand(N, c).astype(np.float32)
    return p / p.sum(1, keepdims=True), rng.randint(0, c, N)


REGRESSION = [
    ("MeanAbsoluteError", {}), ("MeanSquaredError", {"squared": False}), ("MeanSquaredLogError", {}),
    ("MeanAbsolutePercentageError", {}), ("SymmetricMeanAbsolutePercentageError", {}),
    ("WeightedMeanAbsolutePercentageError", {}), ("RelativeSquaredError", {}), ("LogCoshError", {}),
    ("MinkowskiDistance", {"p": 3}), ("TweedieDevianceScore", {"power": 1.5}),
    ("CriticalSuccessIndex", {"threshold": 1.5}), ("PearsonCorrCoef", {}), ("ConcordanceCorrCoef", {}),
    ("SpearmanCorrCoef", {}), ("KendallRankCorrCoef", {}), ("R2Score", {}), ("ExplainedVariance", {}),
]
CASES = [("regression", name, kwargs, _regression_data) for name, kwargs in REGRESSION] + [
    ("regression", "MeanSquaredError", {"num_outputs": 3}, lambda: _regression_data((N, 3))),
    ("regression", "ExplainedVariance", {"multioutput": "raw_values"}, lambda: _regression_data((N, 3))),
    ("regression", "CosineSimilarity", {"reduction": "mean"}, lambda: _regression_data((N, 3))),
    ("regression", "KLDivergence", {}, lambda: _regression_data((N, 3))),
    ("classification", "BinaryConfusionMatrix", {}, _probs),
    ("classification", "MulticlassConfusionMatrix", {"num_classes": 3}, _multiclass),
    ("classification", "MulticlassConfusionMatrix", {"num_classes": 3, "normalize": "true"}, _multiclass),
    ("classification", "MultilabelConfusionMatrix", {"num_labels": 3}, lambda: _probs(0, (N, 3))),
    ("classification", "BinaryPrecisionRecallCurve", {"thresholds": 5}, _probs),
    ("classification", "BinaryPrecisionRecallCurve", {}, _probs),
    ("classification", "MulticlassPrecisionRecallCurve", {"num_classes": 3, "thresholds": 5}, _multiclass),
    ("classification", "MulticlassPrecisionRecallCurve", {"num_classes": 3}, _multiclass),
    ("classification", "MultilabelPrecisionRecallCurve", {"num_labels": 3, "thresholds": 5}, lambda: _probs(0, (N, 3))),
    ("classification", "BinaryROC", {"thresholds": 5}, _probs),
    ("classification", "MulticlassROC", {"num_classes": 3}, _multiclass),
    ("classification", "MultilabelROC", {"num_labels": 3}, lambda: _probs(0, (N, 3))),
    ("classification", "BinaryRecallAtFixedPrecision", {"min_precision": 0.5, "thresholds": 5}, _probs),
    ("classification", "BinaryPrecisionAtFixedRecall", {"min_recall": 0.5}, _probs),
    ("classification", "BinarySensitivityAtSpecificity", {"min_specificity": 0.5}, _probs),
    ("classification", "BinarySpecificityAtSensitivity", {"min_sensitivity": 0.5}, _probs),
    ("classification", "MulticlassRecallAtFixedPrecision", {"num_classes": 3, "min_precision": 0.5, "thresholds": 5}, _multiclass),
    ("classification", "MultilabelSpecificityAtSensitivity", {"num_labels": 3, "min_sensitivity": 0.5}, lambda: _probs(0, (N, 3))),
    ("classification", "MulticlassAccuracy", {"num_classes": 3, "average": None}, _multiclass),
    ("classification", "MulticlassF1Score", {"num_classes": 3}, _multiclass),
    ("classification", "BinaryAUROC", {}, _probs),
    ("classification", "MulticlassAveragePrecision", {"num_classes": 3, "thresholds": 5}, _multiclass),
    ("classification", "BinaryCohenKappa", {}, _probs),
    ("classification", "MulticlassMatthewsCorrCoef", {"num_classes": 3}, _multiclass),
    ("classification", "MultilabelMatthewsCorrCoef", {"num_labels": 3}, lambda: _probs(0, (N, 3))),
    ("aggregation", "MeanMetric", {}, lambda: (np.arange(5, dtype=np.float32),)),
]


def _build(module, name, kwargs):
    _, jax_tm, _ = _jax()
    port_module = tm if module == "aggregation" else getattr(tm, module)
    jax_module = jax_tm if module == "aggregation" else getattr(jax_tm, module)
    return getattr(port_module, name)(device="cpu", **kwargs), getattr(jax_module, name)(executor=False, **kwargs)


@pytest.mark.parametrize("module,name,kwargs,data", CASES, ids=lambda v: v if isinstance(v, str) else None)
def test_plot_renders_as_jax_draws_it(module, name, kwargs, data):
    jnp = _jax()[0]
    port, ref = _build(module, name, kwargs)
    batch = data()
    port.update(*(torch.from_numpy(np.asarray(b)) for b in batch))
    ref.update(*(jnp.asarray(b) for b in batch))
    _same_drawing(_drawing(*port.plot()), _drawing(*ref.plot()))


@pytest.mark.parametrize("name", ["BinaryROC", "MulticlassPrecisionRecallCurve"])
@pytest.mark.parametrize("score", [True, "value"])
def test_curve_plot_with_a_score(name, score):
    jnp = _jax()[0]
    kwargs = {"thresholds": 5} if name == "BinaryROC" else {"num_classes": 3, "thresholds": 5}
    port, ref = _build("classification", name, kwargs)
    batch = _probs() if name == "BinaryROC" else _multiclass()
    port.update(*(torch.from_numpy(b) for b in batch))
    ref.update(*(jnp.asarray(b) for b in batch))
    if score == "value":
        port_score = torch.tensor([0.25, 0.5, 0.75]) if name != "BinaryROC" else torch.tensor(0.5)
        ref_score = jnp.asarray(port_score.numpy())
    else:
        port_score = ref_score = True
    _same_drawing(_drawing(*port.plot(score=port_score)), _drawing(*ref.plot(score=ref_score)))


def test_plot_of_given_values_and_into_given_axes():
    """``plot(val)`` draws the values given (a list: a line over steps);
    ``ax=`` draws into that axes."""
    port, ref = _build("regression", "MeanSquaredError", {})
    values = [0.5, 0.4, 0.35]
    _same_drawing(
        _drawing(*port.plot([torch.tensor(v) for v in values])), _drawing(*ref.plot([np.float32(v) for v in values]))
    )
    fig, ax = plt.subplots()
    got_fig, got_ax = port.plot(torch.tensor(0.5), ax=ax)
    assert got_ax is ax and got_fig is fig
    plt.close(fig)


@pytest.mark.parametrize("together", [False, True])
def test_collection_plot_matches_jax(together):
    jnp, jax_tm, _ = _jax()
    port = tm.MetricCollection(
        {"mse": regression.MeanSquaredError(device="cpu"), "mae": regression.MeanAbsoluteError(device="cpu")}, device="cpu"
    )
    import torchmetrics_tpu.regression as jax_regression

    ref = jax_tm.MetricCollection(
        {"mse": jax_regression.MeanSquaredError(executor=False), "mae": jax_regression.MeanAbsoluteError(executor=False)}
    )
    p, t = _regression_data()
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    ref.update(jnp.asarray(p), jnp.asarray(t))
    _same_drawing(_drawing(*port.plot(together=together)), _drawing(*ref.plot(together=together)))


# ------------------------------------------------------- the plot functions

VALUES = {
    "scalar": lambda: 0.5,
    "vector": lambda: np.array([0.1, 0.5, 0.9], np.float32),
    "steps": lambda: [0.1, 0.2, 0.4],
    "steps_of_vectors": lambda: [np.array([0.1, 0.2]), np.array([0.3, 0.4]), np.array([0.5, 0.6])],
    "dict": lambda: {"a": 0.5, "b": np.array([0.1, 0.2, 0.3])},
}


@pytest.mark.parametrize("layout", list(VALUES))
@pytest.mark.parametrize("legend_name", [None, "Class"])
def test_plot_single_or_multi_val_matches_jax(layout, legend_name):
    _, _, jax_plot = _jax()
    kwargs = {"lower_bound": 0.0, "upper_bound": 1.0, "legend_name": legend_name, "name": "M"}
    value = VALUES[layout]()
    as_port = (
        {k: torch.as_tensor(v) for k, v in value.items()} if isinstance(value, dict)
        else [torch.as_tensor(v) for v in value] if isinstance(value, list) else torch.as_tensor(value)
    )
    _same_drawing(
        _drawing(*port_plot.plot_single_or_multi_val(as_port, **kwargs)),
        _drawing(*jax_plot.plot_single_or_multi_val(value, **kwargs)),
    )


@pytest.mark.parametrize(
    "confmat",
    [np.array([[3, 1], [0, 4]]), np.array([[0.5, 0.25], [0.125, 1.0]], np.float32), np.arange(20).reshape(5, 2, 2)],
    ids=["ints", "floats", "multilabel_grid"],
)
@pytest.mark.parametrize("labels", [None, ["no", "yes"]])
def test_plot_confusion_matrix_matches_jax(confmat, labels):
    _, _, jax_plot = _jax()
    _same_drawing(
        _drawing(*port_plot.plot_confusion_matrix(torch.from_numpy(confmat), labels=labels)),
        _drawing(*jax_plot.plot_confusion_matrix(confmat, labels=labels)),
    )


CURVES = {
    "single": lambda: (np.linspace(0, 1, 6), np.linspace(0, 1, 6) ** 0.5, np.linspace(1, 0, 6)),
    "per_class_rows": lambda: (np.linspace(0, 1, 5), np.stack([np.linspace(0, 1, 5) ** k for k in (1, 2, 3)]), np.linspace(1, 0, 5)),
    "ragged": lambda: ([np.linspace(0, 1, n) for n in (3, 4, 5)], [np.linspace(0, 1, n) ** 2 for n in (3, 4, 5)], None),
}


@pytest.mark.parametrize("layout", list(CURVES))
@pytest.mark.parametrize("score", [None, True, "per_class"])
def test_plot_curve_matches_jax(layout, score):
    """Every layout with no score, its areas, and a per-class score (which a
    single curve labels with its mean)."""
    _, _, jax_plot = _jax()
    curve = CURVES[layout]()
    score = np.array([0.2, 0.4, 0.9]) if score == "per_class" else score

    def port_form(v):
        if isinstance(v, list):
            return [torch.from_numpy(a) for a in v]
        return None if v is None else torch.from_numpy(np.asarray(v))

    kwargs = {"label_names": ("FPR", "TPR"), "name": "ROC"}
    port_score = torch.from_numpy(score) if isinstance(score, np.ndarray) else score
    _same_drawing(
        _drawing(*port_plot.plot_curve(tuple(port_form(v) for v in curve), score=port_score, **kwargs)),
        _drawing(*jax_plot.plot_curve(curve, score=score, **kwargs)),
    )


def test_grid_split_and_trim_match_jax():
    _, _, jax_plot = _jax()
    for n in range(1, 17):
        assert port_plot._get_col_row_split(n) == jax_plot._get_col_row_split(n)
    fig, axs = plt.subplots(2, 3)
    assert len(port_plot.trim_axs(axs, 4)) == 4 and len(fig.axes) == 4
    plt.close(fig)


# ----------------------------------------------------------- no matplotlib


@pytest.mark.parametrize(
    "draw",
    [
        lambda: port_plot.plot_single_or_multi_val(0.5),
        lambda: port_plot.plot_confusion_matrix(np.eye(2)),
        lambda: port_plot.plot_curve((np.arange(3), np.arange(3), None)),
        lambda: regression.MeanSquaredError(device="cpu").plot(torch.tensor(0.5)),
    ],
    ids=["single", "confmat", "curve", "metric"],
)
def test_missing_matplotlib_raises_module_not_found(monkeypatch, draw):
    monkeypatch.setattr(port_plot, "_MATPLOTLIB_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        draw()


def test_the_port_imports_without_matplotlib():
    """A fresh interpreter where ``import matplotlib`` fails imports the
    port, computes, and raises ``ModuleNotFoundError`` only on ``plot``."""
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import torch, torchmetrics_tpu_torch as tm\n"
        "m = tm.regression.MeanSquaredError(device='cpu'); m.update(torch.ones(3), torch.zeros(3))\n"
        "assert float(m.compute()) == 1.0\n"
        "try:\n    m.plot()\nexcept ModuleNotFoundError:\n    print('raised')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
