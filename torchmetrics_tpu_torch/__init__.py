"""torchmetrics_tpu_torch: the metrics framework on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``torchmetrics_tpu``, slice by slice; this package
imports nothing of it. State lives on the current CUDA device unless a
metric is built with ``device="cpu"``. Ported so far: the ``Metric`` core,
``MetricCollection`` with compute groups, the classification stat-scores
family (stat scores, accuracy, precision, recall, F-beta/F1, Jaccard index,
confusion matrix) and calibration error, whose counts run on the
``bincount`` kernel in ``csrc/bincount.cu``, and the threshold curves (PR
curve, ROC, AUROC, average precision), whose binned binary counts run on
the ``binned_curve`` kernel in ``csrc/binned_curve.cu``.
"""
from torchmetrics_tpu_torch import classification, functional
from torchmetrics_tpu_torch.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric

__all__ = ["CompositionalMetric", "Metric", "MetricCollection", "classification", "functional", *_classification_all]
