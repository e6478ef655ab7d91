"""Functional classification metrics of the stat-scores family."""
from torchmetrics_tpu_torch.functional.classification.accuracy import (
    accuracy,
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
)
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from torchmetrics_tpu_torch.functional.classification.f_beta import (
    binary_f1_score,
    binary_fbeta_score,
    f1_score,
    fbeta_score,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multilabel_f1_score,
    multilabel_fbeta_score,
)
from torchmetrics_tpu_torch.functional.classification.jaccard import (
    binary_jaccard_index,
    jaccard_index,
    multiclass_jaccard_index,
    multilabel_jaccard_index,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall import (
    binary_precision,
    binary_recall,
    multiclass_precision,
    multiclass_recall,
    multilabel_precision,
    multilabel_recall,
    precision,
    recall,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    binary_stat_scores,
    multiclass_stat_scores,
    multilabel_stat_scores,
    stat_scores,
)

__all__ = [
    "accuracy",
    "binary_accuracy",
    "binary_confusion_matrix",
    "binary_f1_score",
    "binary_fbeta_score",
    "binary_jaccard_index",
    "binary_precision",
    "binary_recall",
    "binary_stat_scores",
    "confusion_matrix",
    "f1_score",
    "fbeta_score",
    "jaccard_index",
    "multiclass_accuracy",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_jaccard_index",
    "multiclass_precision",
    "multiclass_recall",
    "multiclass_stat_scores",
    "multilabel_accuracy",
    "multilabel_confusion_matrix",
    "multilabel_f1_score",
    "multilabel_fbeta_score",
    "multilabel_jaccard_index",
    "multilabel_precision",
    "multilabel_recall",
    "multilabel_stat_scores",
    "precision",
    "recall",
    "stat_scores",
]
