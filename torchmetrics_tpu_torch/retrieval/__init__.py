"""Modular retrieval metrics: query-grouped scores over ``(preds, target, indexes)``."""
from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric
from torchmetrics_tpu_torch.retrieval.metrics import (
    RetrievalAUROC,
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)

__all__ = [
    "RetrievalAUROC",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
]
