"""torchmetrics_tpu_torch: the metrics framework on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``torchmetrics_tpu``, slice by slice; this package
imports nothing of it. State lives on the current CUDA device unless a
metric is built with ``device="cpu"``. Ported so far:

- the ``Metric`` core and ``MetricCollection`` with compute groups;
- the classification stat-scores family (stat scores, accuracy, precision,
  recall, F-beta/F1, Jaccard index, confusion matrix) and calibration error,
  whose counts run on the ``bincount`` kernel (``csrc/bincount.cu``);
- the threshold curves (PR curve, ROC, AUROC, average precision), whose
  binned binary counts run on the ``binned_curve`` kernel
  (``csrc/binned_curve.cu``);
- retrieval (MAP, MRR, precision, recall, fall-out, hit rate, R-precision,
  nDCG, AUROC, the precision-recall curve), whose top-k sums run on the
  ``retrieval_topk_stats`` kernel (``csrc/retrieval_topk_stats.cu``);
- SSIM and MS-SSIM, whose windowed moments run on the ``ssim_windows``
  kernel (``csrc/ssim_windows.cu``);
- FID, KID, MiFID and the Inception Score on the InceptionV3 feature
  network (``models/``); FID's and MiFID's PSD square root runs on the
  ``fid_sqrtm`` kernel (``csrc/fid_sqrtm.cu``);
- cross-process state sync on ``torch.distributed`` (``parallel/``: gloo
  on the CPU, NCCL on the card), with its timeout, retry and degradation
  policies (``io/retry.py``, ``quarantine.py``), the block-quantized sync
  (``sync_precision="quantized"``), class-axis state sharding
  (``state_sharding="class_axis"``), the deferred stacked layouts
  (``reduce="deferred"``, metrics, collections, lanes and windows) and the
  elastic N->M re-split (``parallel/reshard.py``);
- the aggregators (sum, mean, max, min, cat, running mean and sum);
- regression (errors, correlations, R², explained variance, cosine
  similarity, KL divergence) and the pairwise distances, on plain PyTorch
  (no kernel of the port);
- ``plot`` on every metric and collection (matplotlib, imported only when
  a plot is drawn);
- the wrappers (bootstrap, tracker, running window, min-max, classwise,
  multi-task, multi-output, feature share) and nominal association
  (Cramér's V, Tschuprow's T, Pearson's contingency coefficient, Theil's U,
  Fleiss' kappa), whose contingency tables run on the ``bincount`` kernel;
- text: the ASR error rates (WER, CER, MER, WIL, WIP), edit distance and
  EED, BLEU and SacreBLEU, chrF, TER, ROUGE, SQuAD, perplexity, BERTScore
  and InfoLM; strings are counted on the host, the edit distances, LCS and
  n-gram overlaps by the port's own C++ library (``native/``, built with
  ``g++`` into ``_build/`` at first use), and perplexity, the greedy
  BERTScore match and InfoLM's measures run on the device (no kernel of the
  port).
- audio: SDR (Toeplitz systems solved in float64), SI-SDR, SA-SDR, SNR,
  SI-SNR, C-SI-SNR and PIT on the device; PESQ on the port's own C++
  library (``native/pesq.cpp``, a library of its own in ``_build/``); STOI
  and SRMR on the host in float64 or on the device (``on_device=True``);
- clustering: mutual information and its normalised and adjusted forms,
  rand and adjusted rand, Fowlkes-Mallows, homogeneity, completeness and
  V-measure, whose contingency tables run on the ``bincount`` kernel, and
  Calinski-Harabasz, Davies-Bouldin and Dunn on embeddings;
- detection: COCO mean average precision (boxes and masks, greedy matching
  on the device), IoU, GIoU, DIoU and CIoU, and panoptic quality, whose
  intersection tables run on the ``bincount`` kernel; the segmentation
  utilities (erosion, distance transforms, mask edges, surface distances);
  and CLIPScore and CLIP-IQA on the user's embedding functions.
- session lanes (``LanedMetric``, ``LanedCollection``): thousands of
  independent per-session states advanced per round, the counting family
  with one row-folded ``bincount`` launch a round; per-lane fault
  containment (``LaneGuard``, ``quarantine.py``) and the staging-slab
  ingest (``ops/ingest.py``).
- streaming windows (``WindowedMetric``, ``WindowedCollection``): W
  per-window states on a ring axis with a watermark for late events, and
  windowed session lanes (``metric.windowed(W).laned(N)``).
- state integrity (``integrity.py``: ``IntegrityAuditor`` through
  ``metric.attach_integrity()``, ``DeferredIntegrity``), whose fingerprints
  fold on the ``fingerprint`` kernel, and the fleet (``fleet/``): the
  exactly-once delta protocol, uplinks, leaf exporters, the aggregator tree
  and the global view.
- the captured executor (``ops/executor.py``): on the card every eager
  ``update``/``forward`` of an eligible metric, and a collection's every
  compute group, replays as one CUDA graph over the executor's own state
  slots (``executor=``, ``TORCHMETRICS_TPU_EXECUTOR``; ``executor_stats``);
  the synced step (``make_synced_collection_step``) and the deferred
  collection step (``ops.make_deferred_collection_step``: a step or a
  chunk of steps over stacked shards as one replay, the read point, the
  shard shadow, elastic restore and export), and the recovery snapshot the
  ``Autosaver`` reuses (``ops.latest_recovery_snapshot``).
"""
__version__ = "0.1.0"

from torchmetrics_tpu_torch import (
    audio,
    classification,
    clustering,
    detection,
    fleet,
    functional,
    image,
    models,
    multimodal,
    nominal,
    parallel,
    regression,
    retrieval,
    text,
    wrappers,
)
from torchmetrics_tpu_torch.aggregation import (
    CatMetric,
    MaxMetric,
    MeanMetric,
    MinMetric,
    RunningMean,
    RunningSum,
    SumMetric,
)
from torchmetrics_tpu_torch.audio import *  # noqa: F401,F403
from torchmetrics_tpu_torch.audio import __all__ as _audio_all
from torchmetrics_tpu_torch.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.clustering import *  # noqa: F401,F403
from torchmetrics_tpu_torch.clustering import __all__ as _clustering_all
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.detection import *  # noqa: F401,F403
from torchmetrics_tpu_torch.detection import __all__ as _detection_all
from torchmetrics_tpu_torch.image import *  # noqa: F401,F403
from torchmetrics_tpu_torch.image import __all__ as _image_all
from torchmetrics_tpu_torch import io, obs
from torchmetrics_tpu_torch.integrity import DeferredIntegrity, IntegrityAuditor
from torchmetrics_tpu_torch.io import Autosaver, install_preemption_handler, restore_state, save_state
from torchmetrics_tpu_torch.lanes import LanedCollection, LanedMetric, make_deferred_lane_step
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.multimodal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.multimodal import __all__ as _multimodal_all
from torchmetrics_tpu_torch.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.nominal import __all__ as _nominal_all
from torchmetrics_tpu_torch.obs import dump_diagnostics, telemetry_snapshot
from torchmetrics_tpu_torch.ops.async_read import MetricFuture, pending_reads
from torchmetrics_tpu_torch.ops.async_read import drain_pipeline as drain_async_reads
from torchmetrics_tpu_torch.ops.executor import executor_stats, make_synced_collection_step
from torchmetrics_tpu_torch.quarantine import DegradedValue, LaneGuard
from torchmetrics_tpu_torch.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.regression import __all__ as _regression_all
from torchmetrics_tpu_torch.retrieval import *  # noqa: F401,F403
from torchmetrics_tpu_torch.retrieval import __all__ as _retrieval_all
from torchmetrics_tpu_torch.text import *  # noqa: F401,F403
from torchmetrics_tpu_torch.text import __all__ as _text_all
from torchmetrics_tpu_torch.utils.exceptions import (
    CheckpointCorruptionError,
    DispatchStallError,
    LaneFaultError,
    ShardLossError,
    StateCorruptionError,
    StateDivergenceError,
    SyncTimeoutError,
    TopologyMismatchError,
    TorchMetricsUserError,
    TorchMetricsUserWarning,
)
from torchmetrics_tpu_torch.windows import WindowedCollection, WindowedMetric
from torchmetrics_tpu_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    FeatureShare,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
    MultitaskWrapper,
    Running,
)

__all__ = [
    "Autosaver",
    "BootStrapper",
    "CatMetric",
    "CheckpointCorruptionError",
    "ClasswiseWrapper",
    "CompositionalMetric",
    "DeferredIntegrity",
    "DegradedValue",
    "DispatchStallError",
    "FeatureShare",
    "IntegrityAuditor",
    "LaneFaultError",
    "LaneGuard",
    "LanedCollection",
    "LanedMetric",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MetricFuture",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "Running",
    "RunningMean",
    "RunningSum",
    "ShardLossError",
    "StateCorruptionError",
    "StateDivergenceError",
    "SumMetric",
    "SyncTimeoutError",
    "TopologyMismatchError",
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "WindowedCollection",
    "WindowedMetric",
    "audio",
    "classification",
    "clustering",
    "detection",
    "drain_async_reads",
    "dump_diagnostics",
    "executor_stats",
    "make_synced_collection_step",
    "fleet",
    "functional",
    "install_preemption_handler",
    "io",
    "make_deferred_lane_step",
    "image",
    "models",
    "multimodal",
    "nominal",
    "obs",
    "parallel",
    "pending_reads",
    "regression",
    "restore_state",
    "retrieval",
    "save_state",
    "telemetry_snapshot",
    "text",
    "wrappers",
    *_audio_all,
    *_classification_all,
    *_clustering_all,
    *_detection_all,
    *_image_all,
    *_multimodal_all,
    *_nominal_all,
    *_regression_all,
    *_retrieval_all,
    *_text_all,
]
