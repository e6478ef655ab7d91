"""Text metrics as classes: strings are counted on the host, state lives on
the metric's device."""
from torchmetrics_tpu_torch.text.asr import (  # noqa: F401
    CharErrorRate,
    MatchErrorRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from torchmetrics_tpu_torch.text.counters import (  # noqa: F401
    BLEUScore,
    CHRFScore,
    EditDistance,
    ExtendedEditDistance,
    SacreBLEUScore,
    TranslationEditRate,
)
from torchmetrics_tpu_torch.text.misc import Perplexity, ROUGEScore, SQuAD  # noqa: F401
from torchmetrics_tpu_torch.text.model_based import BERTScore, InfoLM  # noqa: F401

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CharErrorRate",
    "CHRFScore",
    "EditDistance",
    "ExtendedEditDistance",
    "InfoLM",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SacreBLEUScore",
    "SQuAD",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
