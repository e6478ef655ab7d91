"""Audio metrics as classes; state lives on the metric's device."""
from torchmetrics_tpu_torch.audio.dsp import (  # noqa: F401
    PerceptualEvaluationSpeechQuality,
    ShortTimeObjectiveIntelligibility,
    SpeechReverberationModulationEnergyRatio,
)
from torchmetrics_tpu_torch.audio.pit import PermutationInvariantTraining  # noqa: F401
from torchmetrics_tpu_torch.audio.sdr import (  # noqa: F401
    ScaleInvariantSignalDistortionRatio,
    SignalDistortionRatio,
    SourceAggregatedSignalDistortionRatio,
)
from torchmetrics_tpu_torch.audio.snr import (  # noqa: F401
    ComplexScaleInvariantSignalNoiseRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalNoiseRatio,
)

__all__ = [
    "ComplexScaleInvariantSignalNoiseRatio",
    "PerceptualEvaluationSpeechQuality",
    "ShortTimeObjectiveIntelligibility",
    "SpeechReverberationModulationEnergyRatio",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SourceAggregatedSignalDistortionRatio",
]
