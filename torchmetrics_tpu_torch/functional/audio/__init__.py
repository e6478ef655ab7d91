"""Audio metrics as functions of tensors: SDR, SI-SDR, SA-SDR, SNR, SI-SNR,
C-SI-SNR and PIT on the inputs' device; PESQ on the host (the port's C++
library); STOI and SRMR on the host in float64, or on the device with
``on_device=True``."""
from torchmetrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate
from torchmetrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from torchmetrics_tpu_torch.functional.audio.srmr import speech_reverberation_modulation_energy_ratio
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility

__all__ = [
    "complex_scale_invariant_signal_noise_ratio",
    "perceptual_evaluation_speech_quality",
    "short_time_objective_intelligibility",
    "speech_reverberation_modulation_energy_ratio",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "source_aggregated_signal_distortion_ratio",
]
