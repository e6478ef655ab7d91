"""Wrappers around metrics: bootstrap intervals, per-step tracking, running
windows, running extrema, per-class labels, multi-task and multi-output
evaluation, and one feature network shared by several metrics."""
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from torchmetrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from torchmetrics_tpu_torch.wrappers.feature_share import FeatureShare, NetworkCache
from torchmetrics_tpu_torch.wrappers.minmax import MinMaxMetric
from torchmetrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from torchmetrics_tpu_torch.wrappers.multitask import MultitaskWrapper
from torchmetrics_tpu_torch.wrappers.running import Running
from torchmetrics_tpu_torch.wrappers.tracker import MetricTracker

__all__ = [
    "BootStrapper",
    "ClasswiseWrapper",
    "FeatureShare",
    "MetricTracker",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "NetworkCache",
    "Running",
    "WrapperMetric",
]
