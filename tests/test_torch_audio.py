"""The port's audio functionals and classes against the JAX package.

The same seeded numpy inputs (speech-shaped: the formant-synthesised clips
of ``tests/fixtures_real/speech.npz``, shifted, mixed and noised, 0.5-2 s at
8 and 16 kHz) go through the JAX functions and through the port on the CPU.
Tolerances:

- SDR: the port solves its Toeplitz systems in float64, so it is held to
  JAX under ``jax.enable_x64`` within rtol 1e-6, and to JAX's default
  float32 solve within 0.01 dB at ``filter_length`` 64 and 0.05 dB at 512
  (measured: under 1e-3 dB);
- SI-SDR, SA-SDR, SNR, SI-SNR, C-SI-SNR and PIT on float32 inputs: 1e-4 dB
  (float32 sums in another order); PIT's permutations exactly;
- STOI and SRMR, host paths: 1e-6 (the same float64 numpy code, rounded to
  float32); device paths against JAX's device paths: STOI 1e-5, SRMR 1e-4
  relative (float32 FFTs of other libraries);
- each class against its functional: 1e-6.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch.functional.audio import pit as port_pit
from torchmetrics_tpu_torch.functional.audio import srmr as port_srmr
from torchmetrics_tpu_torch.functional.audio import stoi as port_stoi

DB_ATOL = 1e-4
SPEECH = np.load(__import__("pathlib").Path(__file__).resolve().parent / "fixtures_real" / "speech.npz")


def _jax():
    import jax

    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu.functional as jax_functional

    return jax, jax_tm, jax_functional


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _speech(fs: int, seconds: float, count: int, seed: int) -> np.ndarray:
    """``count`` speech-shaped float64 signals: the 16 kHz clips decimated to
    ``fs``, tiled, shifted and scaled."""
    rng = np.random.RandomState(seed)
    clips = [SPEECH["clip1"].astype(np.float64), SPEECH["clip2"].astype(np.float64)]
    step = 16000 // fs if 16000 % fs == 0 else None
    n = int(seconds * fs)
    out = []
    for k in range(count):
        clip = clips[k % 2]
        if step is None:  # 10 kHz: linear interpolation of the 16 kHz clip
            clip = np.interp(np.arange(0, len(clip), 1.6), np.arange(len(clip)), clip)
        else:
            clip = clip[::step]
        tiled = np.tile(clip, n // len(clip) + 2)
        shift = rng.randint(0, len(clip))
        out.append(rng.uniform(0.5, 1.5) * tiled[shift : shift + n])
    return np.stack(out)


def _degrade(clean: np.ndarray, seed: int, noise: float = 0.05, echo: float = 0.3) -> np.ndarray:
    rng = np.random.RandomState(seed)
    scale = np.abs(clean).max(axis=-1, keepdims=True)
    return clean + echo * np.roll(clean, 7, axis=-1) + noise * scale * rng.randn(*clean.shape)


def _db_close(port, ref, atol=DB_ATOL):
    port, ref = _np(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol)


# ---------------------------------------------------------------- SDR family
@pytest.mark.parametrize("filter_length", [64, 512])
@pytest.mark.parametrize("zero_mean,load_diag", [(False, None), (True, None), (False, 1e-3)])
def test_sdr_against_jax_under_x64(filter_length, zero_mean, load_diag):
    jax, _, jf = _jax()
    target = _speech(8000, 1.0, 4, seed=filter_length).reshape(2, 2, -1)
    preds = _degrade(target, seed=1)
    with jax.enable_x64(True):
        want = np.asarray(jf.signal_distortion_ratio(preds, target, filter_length=filter_length, zero_mean=zero_mean, load_diag=load_diag))
    got = F.signal_distortion_ratio(torch.tensor(preds), torch.tensor(target), filter_length=filter_length,
                                    zero_mean=zero_mean, load_diag=load_diag)
    assert got.dtype == torch.float64 and got.shape == (2, 2)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6)


@pytest.mark.parametrize("filter_length,db_tol", [(64, 0.01), (512, 0.05)])
def test_sdr_against_jax_float32_solve(filter_length, db_tol):
    _, _, jf = _jax()
    target = _speech(8000, 1.0, 3, seed=5).astype(np.float32)
    preds = _degrade(target, seed=2).astype(np.float32)
    want = np.asarray(jf.signal_distortion_ratio(preds, target, filter_length=filter_length))
    got = F.signal_distortion_ratio(torch.tensor(preds), torch.tensor(target), filter_length=filter_length)
    assert got.dtype == torch.float32
    _db_close(got, want, db_tol)


def test_sdr_scipy_toeplitz_oracle_and_dtypes():
    from scipy.linalg import solve_toeplitz
    from scipy.signal import fftconvolve

    target = _speech(8000, 0.5, 2, seed=3)
    preds = _degrade(target, seed=3)
    want = []
    for p, t in zip(preds, target):
        t, p = t / np.linalg.norm(t), p / np.linalg.norm(p)
        r = fftconvolve(t, t[::-1])[len(t) - 1 : len(t) - 1 + 128]
        b = fftconvolve(p, t[::-1])[len(t) - 1 : len(t) - 1 + 128]
        coh = b @ solve_toeplitz(r, b)
        want.append(10 * np.log10(coh / (1 - coh)))
    got = F.signal_distortion_ratio(torch.tensor(preds), torch.tensor(target), filter_length=128, use_cg_iter=10)
    np.testing.assert_allclose(_np(got), want, rtol=1e-9)
    ints = F.signal_distortion_ratio(torch.tensor((preds * 1000).astype(np.int32)), torch.tensor((target * 1000).astype(np.int32)), filter_length=16)
    assert ints.dtype == torch.float32
    # identical inputs: the residual clamps at float64's eps, not inf
    same = F.signal_distortion_ratio(torch.tensor(target), torch.tensor(target), filter_length=16)
    assert torch.isfinite(same).all()


@pytest.mark.parametrize("zero_mean", [False, True])
def test_si_sdr_snr_si_snr_against_jax(zero_mean):
    _, _, jf = _jax()
    target = _speech(16000, 0.5, 6, seed=7).reshape(2, 3, -1).astype(np.float32)
    preds = _degrade(target, seed=8).astype(np.float32)
    p, t = torch.tensor(preds), torch.tensor(target)
    _db_close(F.scale_invariant_signal_distortion_ratio(p, t, zero_mean=zero_mean),
              jf.scale_invariant_signal_distortion_ratio(preds, target, zero_mean=zero_mean))
    _db_close(F.signal_noise_ratio(p, t, zero_mean=zero_mean), jf.signal_noise_ratio(preds, target, zero_mean=zero_mean))
    _db_close(F.scale_invariant_signal_noise_ratio(p, t), jf.scale_invariant_signal_noise_ratio(preds, target))
    # integer inputs go to float32, as in JAX
    pi, ti = (preds * 1000).astype(np.int32), (target * 1000).astype(np.int32)
    got = F.signal_noise_ratio(torch.tensor(pi), torch.tensor(ti))
    assert got.dtype == torch.float32
    _db_close(got, jf.signal_noise_ratio(pi, ti))


@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_sa_sdr_against_jax(scale_invariant, zero_mean):
    _, _, jf = _jax()
    target = _speech(8000, 0.5, 6, seed=9).reshape(3, 2, -1).astype(np.float32)
    preds = _degrade(target, seed=10).astype(np.float32)
    want = jf.source_aggregated_signal_distortion_ratio(preds, target, scale_invariant, zero_mean)
    got = F.source_aggregated_signal_distortion_ratio(torch.tensor(preds), torch.tensor(target), scale_invariant, zero_mean)
    _db_close(got, want)
    with pytest.raises(RuntimeError, match="spk, time"):
        F.source_aggregated_signal_distortion_ratio(torch.zeros(5), torch.zeros(5))


@pytest.mark.parametrize("form", ["complex", "real"])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_c_si_snr_against_jax(form, zero_mean):
    _, _, jf = _jax()
    rng = np.random.RandomState(11)
    target = rng.randn(2, 9, 20, 2).astype(np.float32)
    preds = (0.8 * target + 0.2 * rng.randn(*target.shape)).astype(np.float32)
    if form == "complex":
        p = torch.view_as_complex(torch.tensor(preds))
        t = torch.view_as_complex(torch.tensor(target))
        jp, jt = preds[..., 0] + 1j * preds[..., 1], target[..., 0] + 1j * target[..., 1]
    else:
        p, t, jp, jt = torch.tensor(preds), torch.tensor(target), preds, target
    want = jf.complex_scale_invariant_signal_noise_ratio(jp.astype(np.complex64) if form == "complex" else jp,
                                                           jt.astype(np.complex64) if form == "complex" else jt,
                                                           zero_mean=zero_mean)
    _db_close(F.complex_scale_invariant_signal_noise_ratio(p, t, zero_mean=zero_mean), want)
    with pytest.raises(RuntimeError, match="frequency, time, 2"):
        F.complex_scale_invariant_signal_noise_ratio(torch.zeros(3, 4, 3), torch.zeros(3, 4, 3))


# ---------------------------------------------------------------- PIT
def _mixture(spk: int, seed: int, batch: int = 3):
    rng = np.random.RandomState(seed)
    target = _speech(8000, 0.5, batch * spk, seed=seed).reshape(batch, spk, -1).astype(np.float32)
    perms = np.stack([rng.permutation(spk) for _ in range(batch)])
    preds = np.take_along_axis(target, perms[:, :, None], axis=1)
    preds = (preds + 0.1 * rng.randn(*preds.shape) * np.abs(target).max()).astype(np.float32)
    return preds, target


@pytest.mark.parametrize("spk", [2, 3, 4])
@pytest.mark.parametrize("eval_func,metric", [("max", "scale_invariant_signal_distortion_ratio"), ("min", "signal_noise_ratio")])
def test_pit_speaker_wise_against_jax(spk, eval_func, metric):
    _, _, jf = _jax()
    preds, target = _mixture(spk, seed=20 + spk)
    want_metric, want_perm = jf.permutation_invariant_training(preds, target, getattr(jf, metric), eval_func=eval_func)
    got_metric, got_perm = F.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), getattr(F, metric), eval_func=eval_func)
    _db_close(got_metric, want_metric)
    assert _np(got_perm).tolist() == np.asarray(want_perm).tolist()
    assert got_perm.dtype == torch.int64
    np.testing.assert_array_equal(
        _np(F.pit_permutate(torch.tensor(preds), got_perm)), np.asarray(jf.pit_permutate(preds, np.asarray(want_perm)))
    )


@pytest.mark.parametrize("spk", [2, 3])
def test_pit_permutation_wise_against_jax(spk):
    _, _, jf = _jax()
    preds, target = _mixture(spk, seed=30 + spk)
    want = jf.permutation_invariant_training(preds, target, jf.source_aggregated_signal_distortion_ratio, mode="permutation-wise")
    got = F.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), F.source_aggregated_signal_distortion_ratio, mode="permutation-wise")
    _db_close(got[0], want[0])
    assert _np(got[1]).tolist() == np.asarray(want[1]).tolist()
    # a per-speaker metric: the mean over speakers decides
    want = jf.permutation_invariant_training(preds, target, jf.signal_noise_ratio, mode="permutation-wise", eval_func="min")
    got = F.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), F.signal_noise_ratio, mode="permutation-wise", eval_func="min")
    _db_close(got[0], want[0])
    assert _np(got[1]).tolist() == np.asarray(want[1]).tolist()


def test_pit_seven_speakers_on_the_hungarian_path():
    _, _, jf = _jax()
    preds, target = _mixture(7, seed=41, batch=2)
    want_metric, want_perm = jf.permutation_invariant_training(preds, target, jf.scale_invariant_signal_distortion_ratio)
    got_metric, got_perm = F.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), F.scale_invariant_signal_distortion_ratio)
    _db_close(got_metric, want_metric)
    assert _np(got_perm).tolist() == np.asarray(want_perm).tolist()
    assert got_perm.dtype == torch.int64 and got_metric.device == torch.device("cpu")
    assert (7, torch.device("cpu")) not in port_pit._ps_cache  # 7! rows are never tabled


def test_pit_ties_go_to_the_first_permutation():
    """Two identical estimates tie every permutation: both packages pick the first."""
    _, _, jf = _jax()
    target = _speech(8000, 0.5, 2, seed=50)[None].astype(np.float32)
    preds = np.repeat(target[:, :1], 2, axis=1)
    want = jf.permutation_invariant_training(preds, target, jf.signal_noise_ratio)
    got = F.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), F.signal_noise_ratio)
    assert _np(got[1]).tolist() == np.asarray(want[1]).tolist() == [[0, 1]]
    got = F.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), F.signal_noise_ratio, mode="permutation-wise")
    assert _np(got[1]).tolist() == [[0, 1]]


def test_pit_argument_errors():
    p = torch.zeros(2, 2, 10)
    with pytest.raises(ValueError, match="eval_func"):
        F.permutation_invariant_training(p, p, F.signal_noise_ratio, eval_func="mean")
    with pytest.raises(ValueError, match="mode"):
        F.permutation_invariant_training(p, p, F.signal_noise_ratio, mode="x")
    with pytest.raises(RuntimeError, match="batch and speaker"):
        F.permutation_invariant_training(p, torch.zeros(2, 3, 10), F.signal_noise_ratio)


# ---------------------------------------------------------------- STOI
@pytest.mark.parametrize("fs", [8000, 10000, 16000])
@pytest.mark.parametrize("extended", [False, True])
def test_stoi_both_paths_against_jax(fs, extended):
    _, _, jf = _jax()
    target = _speech(fs, 1.5, 2, seed=fs)
    preds = _degrade(target, seed=fs + 1, noise=0.2)
    want_host = np.asarray(jf.short_time_objective_intelligibility(preds, target, fs, extended))
    got_host = F.short_time_objective_intelligibility(torch.tensor(preds), torch.tensor(target), fs, extended)
    np.testing.assert_allclose(_np(got_host), want_host, rtol=0, atol=1e-6)
    p32, t32 = preds.astype(np.float32), target.astype(np.float32)
    want_dev = np.asarray(jf.short_time_objective_intelligibility(p32, t32, fs, extended, on_device=True))
    got_dev = F.short_time_objective_intelligibility(torch.tensor(p32), torch.tensor(t32), fs, extended, on_device=True)
    assert got_dev.dtype == torch.float32 and got_dev.shape == (2,)
    np.testing.assert_allclose(_np(got_dev), want_dev, rtol=0, atol=1e-5)
    # the two paths within the stated ~1e-3
    np.testing.assert_allclose(_np(got_dev), _np(got_host), rtol=0, atol=2e-3)


def test_stoi_device_resampler_and_overlap_add_against_jax():
    jax, _, _ = _jax()
    from torchmetrics_tpu.functional.audio import stoi as jax_stoi

    taps = port_stoi._resample_taps(5, 8)
    x = np.random.RandomState(60).randn(3, 999).astype(np.float32)
    want = np.asarray(jax_stoi._resample_device(jax.numpy.asarray(x), 5, 8, taps))
    got = port_stoi._resample_device(torch.tensor(x), 5, 8, taps)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-6)


def _stuffed_resample(x: torch.Tensor, up: int, down: int, taps: np.ndarray) -> torch.Tensor:
    """The zero-stuffed form: every ``up``-th sample of a zero signal set, a
    strided correlation with the flipped taps over all of it."""
    batch, n = x.shape
    length, start = len(taps), len(taps) // 2
    xs = x.new_zeros(batch, n * up)
    xs[:, ::up] = x
    padded = torch.nn.functional.pad(xs, (length - 1 - start, length - 1))
    kernel = torch.as_tensor(taps[::-1].copy(), dtype=x.dtype).reshape(1, 1, -1)
    return torch.nn.functional.conv1d(padded[:, None, :], kernel, stride=down)[:, 0][:, : -(-n * up // down)]


@pytest.mark.parametrize("up,down", [(5, 8), (5, 4), (25, 8), (10, 1), (1, 4)])
@pytest.mark.parametrize("n", [1, 999, 16000])
def test_stoi_polyphase_resampler_equals_the_stuffed_form(up, down, n):
    """The polyphase resampler forms the stuffed form's nonzero products:
    float32 outputs bit for bit on the CPU."""
    taps = port_stoi._resample_taps(up, down)
    x = torch.tensor(np.random.RandomState(n).randn(3, n).astype(np.float32))
    got = port_stoi._resample_device(x, up, down, taps)
    want = _stuffed_resample(x, up, down, taps)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


def test_stoi_short_signals_floor():
    """Shorter than a segment: 1e-5 on both paths, the device path without a host branch on the data."""
    rng = np.random.RandomState(61)
    short = torch.tensor(rng.randn(2, 3000))
    with pytest.warns(RuntimeWarning, match="Not enough STFT frames"):
        host = F.short_time_objective_intelligibility(short, short, 10000)
    assert _np(host).tolist() == [np.float32(1e-5)] * 2
    dev = F.short_time_objective_intelligibility(short, short, 10000, on_device=True)
    assert _np(dev).tolist() == [np.float32(1e-5)] * 2
    # long enough in samples, but silent after the first frames: the where() floor
    sig = np.zeros((1, 20000))
    sig[0, :600] = rng.randn(600)
    dev = F.short_time_objective_intelligibility(torch.tensor(sig), torch.tensor(sig), 10000, on_device=True)
    assert _np(dev).tolist() == [np.float32(1e-5)]
    with pytest.raises(RuntimeError, match="same shape"):
        F.short_time_objective_intelligibility(torch.zeros(100), torch.zeros(200), 10000)


# ---------------------------------------------------------------- SRMR
@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("norm", [False, True])
def test_srmr_both_paths_against_jax(fs, norm):
    _, _, jf = _jax()
    x = _degrade(_speech(fs, 1.0, 2, seed=fs + 3), seed=4, noise=0.01, echo=0.5)
    want_host = np.asarray(jf.speech_reverberation_modulation_energy_ratio(x, fs, norm=norm))
    got_host = F.speech_reverberation_modulation_energy_ratio(torch.tensor(x), fs, norm=norm)
    np.testing.assert_allclose(_np(got_host), want_host, rtol=1e-6)
    x32 = x.astype(np.float32)
    want_dev = np.asarray(jf.speech_reverberation_modulation_energy_ratio(x32, fs, norm=norm, on_device=True))
    got_dev = F.speech_reverberation_modulation_energy_ratio(torch.tensor(x32), fs, norm=norm, on_device=True)
    assert got_dev.dtype == torch.float32
    np.testing.assert_allclose(_np(got_dev), want_dev, rtol=1e-4)
    np.testing.assert_allclose(_np(got_dev), _np(got_host), rtol=1e-3)


def test_srmr_chunked_device_path_and_shapes(monkeypatch):
    x = _degrade(_speech(8000, 0.6, 3, seed=70), seed=5).astype(np.float32)
    whole = F.speech_reverberation_modulation_energy_ratio(torch.tensor(x), 8000, on_device=True)
    # a 7 s utterance at 16 kHz is reckoned at about 93 MB: 23 of them a chunk
    assert port_srmr.DEVICE_BUDGET_BYTES // port_srmr._device_bytes_per_signal(112_000, 16_000, 23) == 23
    monkeypatch.setattr(port_srmr, "DEVICE_BUDGET_BYTES", 1)  # one signal a chunk
    chunked = F.speech_reverberation_modulation_energy_ratio(torch.tensor(x), 8000, on_device=True)
    np.testing.assert_allclose(_np(chunked), _np(whole), rtol=1e-6)
    one = F.speech_reverberation_modulation_energy_ratio(torch.tensor(x[0]), 8000, on_device=True)
    assert one.shape == (1,)
    assert F.speech_reverberation_modulation_energy_ratio(torch.tensor(x[0]).double(), 8000).shape == (1,)
    with pytest.warns(RuntimeWarning, match="fast=True"):
        F.speech_reverberation_modulation_energy_ratio(torch.tensor(x[0]).double(), 8000, fast=True)
    with pytest.raises(ValueError, match="fs"):
        F.speech_reverberation_modulation_energy_ratio(torch.tensor(x[0]), 0)


def test_srmr_fft_lengths_are_the_least_7_smooth():
    def smooth(n):
        for f in (2, 3, 5, 7):
            while n % f == 0:
                n //= f
        return n == 1

    lengths = list(range(1, 600)) + [135_999, 211_260, 1 << 20, (1 << 20) + 1]
    for n in lengths:
        m = port_srmr._fast_length(n)
        assert m >= n and smooth(m) and not any(smooth(k) for k in range(n, m)), (n, m)
    # cuFFT's Bluestein lengths: a prime factor above 127
    assert [port_srmr._bluestein(n) for n in (112_000, 145_440, 171_248, 52_928, 127, 131, 2 * 127, 2 * 131)] == [
        False, False, True, True, False, True, False, True]


# ---------------------------------------------------------------- classes
def _class_cases():
    target = _speech(8000, 1.2, 8, seed=80).reshape(2, 2, 2, -1).astype(np.float32)
    preds = _degrade(target, seed=81).astype(np.float32)
    spec = np.random.RandomState(82).randn(2, 2, 5, 6, 2).astype(np.float32)
    spec_p = (0.9 * spec + 0.1).astype(np.float32)
    return [
        ("SignalDistortionRatio", {"filter_length": 32}, (preds, target), lambda p, t: F.signal_distortion_ratio(p, t, filter_length=32)),
        ("ScaleInvariantSignalDistortionRatio", {}, (preds, target), F.scale_invariant_signal_distortion_ratio),
        ("SourceAggregatedSignalDistortionRatio", {}, (preds, target), F.source_aggregated_signal_distortion_ratio),
        ("SignalNoiseRatio", {"zero_mean": True}, (preds, target), lambda p, t: F.signal_noise_ratio(p, t, zero_mean=True)),
        ("ScaleInvariantSignalNoiseRatio", {}, (preds, target), F.scale_invariant_signal_noise_ratio),
        ("ComplexScaleInvariantSignalNoiseRatio", {}, (spec_p, spec), F.complex_scale_invariant_signal_noise_ratio),
        ("PermutationInvariantTraining", {"metric_func": F.scale_invariant_signal_distortion_ratio}, (preds, target),
         lambda p, t: F.permutation_invariant_training(p, t, F.scale_invariant_signal_distortion_ratio)[0]),
        ("ShortTimeObjectiveIntelligibility", {"fs": 8000}, (preds, target), lambda p, t: F.short_time_objective_intelligibility(p, t, 8000)),
        ("ShortTimeObjectiveIntelligibility", {"fs": 8000, "extended": True, "on_device": True}, (preds, target),
         lambda p, t: F.short_time_objective_intelligibility(p, t, 8000, True, on_device=True)),
        ("SpeechReverberationModulationEnergyRatio", {"fs": 8000}, (preds,), lambda p: F.speech_reverberation_modulation_energy_ratio(p, 8000)),
        ("SpeechReverberationModulationEnergyRatio", {"fs": 8000, "on_device": True}, (preds,),
         lambda p: F.speech_reverberation_modulation_energy_ratio(p, 8000, on_device=True)),
        ("PerceptualEvaluationSpeechQuality", {"fs": 8000, "mode": "nb"}, (preds, target),
         lambda p, t: F.perceptual_evaluation_speech_quality(p, t, 8000, "nb")),
    ]


@pytest.mark.parametrize("case", range(12))
def test_class_against_its_functional(case):
    name, kwargs, data, fn = _class_cases()[case]
    metric = getattr(tm, name)(device="cpu", **kwargs)
    batches = [tuple(torch.tensor(a[i]) for a in data) for i in range(2)]
    batch_vals = [metric(*b) for b in batches]  # forward: the batch's value
    values = [fn(*b).reshape(-1) for b in batches]
    for got, want in zip(batch_vals, values):
        np.testing.assert_allclose(_np(got), _np(want.mean()), rtol=1e-6)
    np.testing.assert_allclose(_np(metric.compute()), _np(torch.cat(values).mean()), rtol=1e-6)
    state = metric.state()
    count = state.get("total", state.get("num"))
    assert count.dtype == torch.int64 and int(count) == sum(v.numel() for v in values)
    metric.reset()
    assert int(metric.state().get("total", metric.state().get("num"))) == 0


def test_classes_against_jax_classes():
    _, jax_tm, _ = _jax()
    target = _speech(8000, 1.5, 4, seed=90).reshape(2, 2, -1).astype(np.float32)
    preds = _degrade(target, seed=91).astype(np.float32)
    for name, kwargs in [("ScaleInvariantSignalNoiseRatio", {}), ("SignalDistortionRatio", {"filter_length": 32}),
                         ("ShortTimeObjectiveIntelligibility", {"fs": 8000})]:
        ours = getattr(tm, name)(device="cpu", **kwargs)
        theirs = getattr(jax_tm, name)(**kwargs)
        for i in range(2):
            ours.update(torch.tensor(preds[i]), torch.tensor(target[i]))
            theirs.update(preds[i], target[i])
        tol = 0.05 if name == "SignalDistortionRatio" else 1e-5  # JAX's float32 solve
        np.testing.assert_allclose(_np(ours.compute()), np.asarray(theirs.compute()), rtol=0, atol=tol)


def test_every_jax_audio_name_is_exported():
    _, jax_tm, jf = _jax()
    import torchmetrics_tpu.audio as jax_audio
    import torchmetrics_tpu.functional.audio as jax_faudio

    import torchmetrics_tpu_torch.audio as audio
    import torchmetrics_tpu_torch.functional.audio as faudio

    assert set(jax_audio.__all__) <= set(audio.__all__)
    assert set(jax_faudio.__all__) <= set(faudio.__all__)
    for name in jax_audio.__all__:
        assert getattr(tm, name) is getattr(audio, name)
    for name in jax_faudio.__all__:
        assert getattr(F, name) is getattr(faudio, name)


def test_state_lives_on_the_metric_device_and_other_devices_raise():
    metric = tm.SignalNoiseRatio(device="cpu")
    assert metric.total.device == torch.device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric.update(torch.ones(4), torch.ones(4))
    assert metric.total.dtype == torch.int64
