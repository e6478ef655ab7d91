"""Plotting helpers behind every metric's ``plot``.

matplotlib is imported under ``try`` with the ``Agg`` backend: importing
the package never needs it, and a plot drawn without it raises
``ModuleNotFoundError``. Values are copied to host numpy arrays first,
from whatever device they were computed on.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _MATPLOTLIB_AVAILABLE = True
except Exception:  # pragma: no cover - exercised by patching the flag
    _MATPLOTLIB_AVAILABLE = False
    plt = None

_PLOT_OUT_TYPE = Tuple[Any, Any]


def _error_on_missing_matplotlib() -> None:
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(
            "Plot function expects `matplotlib` to be installed. Install with `pip install matplotlib`"
        )


def _as_numpy(value: Any) -> np.ndarray:
    """A host numpy copy of a tensor (from any device) or array-like."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _get_col_row_split(n: int) -> Tuple[int, int]:
    """Split ``n`` plots into a near-square (rows, cols) grid."""
    nsq = int(np.sqrt(n))
    if nsq * nsq == n:
        return nsq, nsq
    if n <= nsq * (nsq + 1):
        return nsq, nsq + 1
    return nsq + 1, nsq + 1


def trim_axs(axs: Any, nb: int) -> Any:
    """Remove the axes of a grid beyond the first ``nb``."""
    if hasattr(axs, "flat"):
        axs = axs.flat
        for ax in axs[nb:]:
            ax.remove()
        return axs[:nb]
    return axs


def plot_single_or_multi_val(
    val: Union[Any, Sequence[Any], Dict[str, Any]],
    ax: Optional[Any] = None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> _PLOT_OUT_TYPE:
    """Plot a value, a sequence of values (a line over steps) or a dict of
    values; a vector is one point per class. Bounds are dashed lines."""
    _error_on_missing_matplotlib()
    fig, ax = plt.subplots() if ax is None else (ax.get_figure(), ax)
    if isinstance(val, dict):
        for i, (k, v) in enumerate(val.items()):
            v = _as_numpy(v)
            if v.ndim == 0:
                ax.plot([i], [float(v)], "o", label=k)
            else:
                ax.plot(v.ravel(), label=k)
        ax.legend()
    elif isinstance(val, (list, tuple)):
        series = np.stack([_as_numpy(v) for v in val])
        if series.ndim == 1:
            ax.plot(np.arange(len(series)), series, "-o")
        else:
            for c in range(series.shape[1]):
                ax.plot(np.arange(series.shape[0]), series[:, c], "-o", label=f"{legend_name or 'Class'} {c}")
            ax.legend()
        ax.set_xlabel("Step")
    else:
        v = _as_numpy(val)
        if v.ndim == 0:
            ax.plot([0], [float(v)], "o")
        else:
            x = np.arange(v.size)
            ax.plot(x, v.ravel(), "o")
            if legend_name:
                ax.set_xticks(x)
                ax.set_xticklabels([f"{legend_name} {i}" for i in x], rotation=45)
    if lower_bound is not None:
        ax.axhline(lower_bound, color="k", linestyle="--", alpha=0.4)
    if upper_bound is not None:
        ax.axhline(upper_bound, color="k", linestyle="--", alpha=0.4)
    if name is not None:
        ax.set_title(name)
    ax.grid(True, alpha=0.3)
    return fig, ax


def plot_confusion_matrix(
    confmat: Any,
    ax: Optional[Any] = None,
    add_text: bool = True,
    labels: Optional[List[Union[int, str]]] = None,
    cmap: Optional[str] = None,
) -> _PLOT_OUT_TYPE:
    """Heatmap of a (C, C) confusion matrix, or a grid of the (N, 2, 2)
    matrices of a multilabel one."""
    _error_on_missing_matplotlib()
    confmat = _as_numpy(confmat)
    if confmat.ndim == 3:
        nb = confmat.shape[0]
        rows, cols = _get_col_row_split(nb)
        fig, axs = plt.subplots(nrows=rows, ncols=cols)
        axs = np.asarray(axs).ravel()
        for i in range(nb):
            _plot_single_confmat(confmat[i], axs[i], add_text, labels, cmap, title=f"Label {i}")
        for j in range(nb, rows * cols):
            axs[j].remove()
        return fig, axs
    fig, ax = plt.subplots() if ax is None else (ax.get_figure(), ax)
    _plot_single_confmat(confmat, ax, add_text, labels, cmap)
    return fig, ax


def _plot_single_confmat(confmat, ax, add_text, labels, cmap, title=None) -> None:
    n_classes = confmat.shape[0]
    ax.imshow(confmat, cmap=cmap or "Blues")
    if add_text:
        for i in range(n_classes):
            for j in range(n_classes):
                v = confmat[i, j]
                txt = f"{v:.2f}" if np.issubdtype(confmat.dtype, np.floating) else str(int(v))
                ax.text(j, i, txt, ha="center", va="center")
    labels = labels if labels is not None else list(range(n_classes))
    ax.set_xticks(range(n_classes))
    ax.set_yticks(range(n_classes))
    ax.set_xticklabels(labels)
    ax.set_yticklabels(labels)
    ax.set_xlabel("Predicted class")
    ax.set_ylabel("True class")
    if title:
        ax.set_title(title)


def plot_curve(
    curve: Tuple[Any, Any, Any],
    score: Optional[Any] = None,
    ax: Optional[Any] = None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> _PLOT_OUT_TYPE:
    """Plot an (x, y, thresholds) curve such as ROC or PR.

    A curve is one 1-D pair, a (C, T) stack of per-class rows, or per-class
    lists of 1-D arrays of different lengths (the exact-mode multiclass and
    multilabel layout). ``score=True`` labels each polyline with its
    trapezoid area; another score labels it with its value (a per-class
    score with a single curve, with its mean)."""
    _error_on_missing_matplotlib()
    if isinstance(curve[0], (list, tuple)) or isinstance(curve[1], (list, tuple)):
        polylines = [(_as_numpy(xc), _as_numpy(yc)) for xc, yc in zip(curve[0], curve[1])]
        per_class = True
    else:
        x, y = _as_numpy(curve[0]), _as_numpy(curve[1])
        per_class = y.ndim > 1
        if per_class:
            polylines = [(x[c] if x.ndim > 1 else x, y[c]) for c in range(y.shape[0])]
        else:
            polylines = [(x, y)]

    def _trapz(xv, yv):
        xv, yv = np.asarray(xv, np.float64), np.asarray(yv, np.float64)
        order = np.argsort(xv, kind="stable")
        integrate = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
        return float(integrate(yv[order], xv[order]))

    if score is True:
        areas = [_trapz(xc, yc) for xc, yc in polylines]
        score = np.asarray(areas) if per_class else areas[0]

    fig, ax = plt.subplots() if ax is None else (ax.get_figure(), ax)
    for c, (xc, yc) in enumerate(polylines):
        if per_class:
            lbl = f"{legend_name or 'Class'} {c}"
            if score is not None and _as_numpy(score).ndim:
                lbl += f" (score={float(_as_numpy(score)[c]):.3f})"
        elif score is not None:
            s = _as_numpy(score)
            lbl = f"score={float(s) if s.size == 1 else float(s.mean()):.3f}"
        else:
            lbl = None
        ax.plot(xc, yc, label=lbl)
    if per_class or (polylines and score is not None):
        ax.legend()
    if label_names:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    if name:
        ax.set_title(name)
    ax.grid(True, alpha=0.3)
    return fig, ax
