"""Modular classification metrics of the stat-scores family."""
from torchmetrics_tpu_torch.classification.accuracy import (
    Accuracy,
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
)
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from torchmetrics_tpu_torch.classification.jaccard import (
    BinaryJaccardIndex,
    JaccardIndex,
    MulticlassJaccardIndex,
    MultilabelJaccardIndex,
)
from torchmetrics_tpu_torch.classification.precision_recall import (
    BinaryPrecision,
    BinaryRecall,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelPrecision,
    MultilabelRecall,
    Precision,
    Recall,
)
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "Accuracy",
    "BinaryAccuracy",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryJaccardIndex",
    "BinaryPrecision",
    "BinaryRecall",
    "BinaryStatScores",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "JaccardIndex",
    "MulticlassAccuracy",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassJaccardIndex",
    "MulticlassPrecision",
    "MulticlassRecall",
    "MulticlassStatScores",
    "MultilabelAccuracy",
    "MultilabelConfusionMatrix",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelJaccardIndex",
    "MultilabelPrecision",
    "MultilabelRecall",
    "MultilabelStatScores",
    "Precision",
    "Recall",
    "StatScores",
]
