"""Speech-to-Reverberation Modulation energy Ratio (SRMR), non-intrusive.

gammatone ERB filterbank (Slaney's four-biquad cascade, Glasberg & Moore
spacing) → Hilbert envelope → 8-channel Q=2 modulation filterbank (4 to 128
Hz) → Hamming-windowed modulation energy (256 ms frames every 64 ms) →
energy ratio of the low modulation bands (1-4) to the high ones (5 to k*),
k* chosen from the 90%-energy cochlear bandwidth.

Two paths:

- the default is the host path in float64 (scipy ``lfilter`` for both IIR
  banks, ``fftconvolve`` for the frame energies), one read of the input
  from the device an update;
- ``on_device=True`` runs on the input's device in float32: both IIR banks
  become their FIR impulse responses (0.128 s of gammatone taps, 1.5 s of
  modulation taps, made on the host once) applied by ``torch.fft``
  convolution at 7-smooth lengths (cuFFT's fast radices: an utterance's
  arbitrary length would take a slow plan and slow kernels), one
  modulation band at a time; the frame energies are one full-float32 matrix
  product of the squared band, cut into blocks of the frame step, with the
  squared window's blocks (one read of the band, only the frames' sums
  formed). A batch
  whose reckoned peak (:func:`_device_bytes_per_signal`) would pass
  ``DEVICE_BUDGET_BYTES`` runs in chunks of signals; each signal's score
  depends on that signal alone. The k* choice and the band sums are
  branch-free. It agrees with the host path to about 1e-3 relative.
"""
from __future__ import annotations

import functools
import warnings
from math import ceil, pi
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.functional.audio.pesq import _host_float64, _out_device
from torchmetrics_tpu_torch.utils.compute import full_float32

_EAR_Q = 9.26449  # Glasberg and Moore parameters
_MIN_BW = 24.7
#: the device path's peak memory a chunk of signals is held under
DEVICE_BUDGET_BYTES = 2 << 30


def _centre_freqs(fs: int, num_freqs: int, cutoff: float) -> np.ndarray:
    """ERB-spaced centre frequencies from ``cutoff`` to fs/2 (Glasberg & Moore)."""
    low, high = cutoff, fs / 2
    return -(_EAR_Q * _MIN_BW) + np.exp(
        np.arange(1, num_freqs + 1)
        * (-np.log(high + _EAR_Q * _MIN_BW) + np.log(low + _EAR_Q * _MIN_BW))
        / num_freqs
    ) * (high + _EAR_Q * _MIN_BW)


def _calc_erbs(low_freq: float, fs: int, n_filters: int) -> np.ndarray:
    """ERB widths of the filterbank's centre frequencies."""
    cfs = _centre_freqs(fs, n_filters, low_freq)
    return (cfs / _EAR_Q) + _MIN_BW


def _make_erb_filters(fs: int, cfs: np.ndarray) -> np.ndarray:
    """Slaney gammatone coefficients, (N, 10) as [A0, A11..A14, A2, B0, B1, B2, gain]."""
    t = 1.0 / fs
    erb = (cfs / _EAR_Q) + _MIN_BW
    b = 1.019 * 2 * np.pi * erb
    arg = 2 * cfs * np.pi * t
    vec = np.exp(2j * arg)

    a0 = t * np.ones_like(cfs)
    a2 = np.zeros_like(cfs)
    b0 = np.ones_like(cfs)
    b1 = -2 * np.cos(arg) / np.exp(b * t)
    b2 = np.exp(-2 * b * t)

    rt_pos = np.sqrt(3 + 2**1.5)
    rt_neg = np.sqrt(3 - 2**1.5)
    common = -t * np.exp(-(b * t))
    k11 = np.cos(arg) + rt_pos * np.sin(arg)
    k12 = np.cos(arg) - rt_pos * np.sin(arg)
    k13 = np.cos(arg) + rt_neg * np.sin(arg)
    k14 = np.cos(arg) - rt_neg * np.sin(arg)

    a11, a12, a13, a14 = common * k11, common * k12, common * k13, common * k14

    gain_arg = np.exp(1j * arg - b * t)
    gain = np.abs(
        (vec - gain_arg * k11)
        * (vec - gain_arg * k12)
        * (vec - gain_arg * k13)
        * (vec - gain_arg * k14)
        * (t * np.exp(b * t) / (-1 / np.exp(b * t) + 1 + vec * (1 - np.exp(b * t)))) ** 4
    )
    return np.column_stack([a0, a11, a12, a13, a14, a2, b0, b1, b2, gain])


def _erb_filterbank(wave: np.ndarray, fcoefs: np.ndarray) -> np.ndarray:
    """The four-biquad gammatone cascade on the host: (B, time) -> (B, N, time)."""
    from scipy.signal import lfilter

    gain = fcoefs[:, 9]
    bs = fcoefs[:, 6:9]
    out = np.empty((wave.shape[0], fcoefs.shape[0], wave.shape[1]))
    for i in range(fcoefs.shape[0]):
        a0, a11, a12, a13, a14, a2 = fcoefs[i, :6]
        y = lfilter([a0, a11, a2], bs[i], wave, axis=-1)
        y = lfilter([a0, a12, a2], bs[i], y, axis=-1)
        y = lfilter([a0, a13, a2], bs[i], y, axis=-1)
        y = lfilter([a0, a14, a2], bs[i], y, axis=-1)
        out[:, i] = y / gain[i]
    return out


def _hilbert_mask(n: int) -> np.ndarray:
    """The analytic signal's spectral weights (1, 2 ... 2, 1, 0 ... 0)."""
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[0] = 1
        h[1 : (n + 1) // 2] = 2
    return h


def _hilbert_length(n_orig: int) -> int:
    return n_orig if n_orig % 16 == 0 else ceil(n_orig / 16) * 16


def _hilbert_envelope(x: np.ndarray) -> np.ndarray:
    """|analytic signal| along the last axis (host)."""
    n_orig = x.shape[-1]
    n = _hilbert_length(n_orig)
    x_fft = np.fft.fft(x, n=n, axis=-1)
    return np.abs(np.fft.ifft(x_fft * _hilbert_mask(n), axis=-1)[..., :n_orig])


def _modulation_filterbank_and_cutoffs(
    min_cf: float, max_cf: float, n: int, fs: float, q: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Second-order band-pass modulation filters and their lower 3 dB cutoffs."""
    spacing_factor = (max_cf / min_cf) ** (1.0 / (n - 1))
    cfs = min_cf * spacing_factor ** np.arange(n)

    w0s = 2 * pi * cfs / fs
    mfb = np.zeros((n, 2, 3))
    for k, w0 in enumerate(w0s):
        w0t = np.tan(w0 / 2)
        b0 = w0t / q
        mfb[k, 0] = [b0, 0.0, -b0]
        mfb[k, 1] = [1 + b0 + w0t**2, 2 * w0t**2 - 2, 1 - b0 + w0t**2]

    b0s = np.tan(w0s / 2) / q
    lower = cfs - (b0s * fs / (2 * pi))
    return cfs, mfb, lower


def _normalize_energy(energy: np.ndarray, drange: float = 30.0) -> np.ndarray:
    """Clamp the modulation energy into a 30 dB dynamic range."""
    peak = energy.mean(axis=1, keepdims=True).max(axis=2, keepdims=True).max(axis=3, keepdims=True)
    min_energy = peak * 10.0 ** (-drange / 10.0)
    return np.clip(energy, min_energy, peak)


def _srmr_score(bw: float, avg_energy: np.ndarray, cutoffs: np.ndarray) -> float:
    """Low over high modulation energy, the high bands limited by k*."""
    if cutoffs[4] <= bw < cutoffs[5]:
        kstar = 5
    elif cutoffs[5] <= bw < cutoffs[6]:
        kstar = 6
    elif cutoffs[6] <= bw < cutoffs[7]:
        kstar = 7
    elif cutoffs[7] <= bw:
        kstar = 8
    else:
        raise ValueError("Something wrong with the cutoffs compared to bw values.")
    return float(np.sum(avg_energy[:, :4]) / np.sum(avg_energy[:, 4:kstar]))


def _srmr_arg_validate(
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = 128,
    norm: bool = False,
    fast: bool = False,
) -> None:
    if not (isinstance(fs, int) and fs > 0):
        raise ValueError(f"Expected argument `fs` to be an int larger than 0, but got {fs}")
    if not (isinstance(n_cochlear_filters, int) and n_cochlear_filters > 0):
        raise ValueError(
            f"Expected argument `n_cochlear_filters` to be an int larger than 0, but got {n_cochlear_filters}"
        )
    if not (isinstance(low_freq, (float, int)) and low_freq > 0):
        raise ValueError(f"Expected argument `low_freq` to be a float larger than 0, but got {low_freq}")
    if not (isinstance(min_cf, (float, int)) and min_cf > 0):
        raise ValueError(f"Expected argument `min_cf` to be a float larger than 0, but got {min_cf}")
    if max_cf is not None and not ((isinstance(max_cf, (float, int))) and max_cf > 0):
        raise ValueError(f"Expected argument `max_cf` to be a float larger than 0, but got {max_cf}")
    if not isinstance(norm, bool):
        raise ValueError("Expected argument `norm` to be a bool value")
    if not isinstance(fast, bool):
        raise ValueError("Expected argument `fast` to be a bool value")


def _frame_geometry(fs: int, time: int) -> Tuple[int, int, int, int]:
    """``(w_length, w_inc, num_frames, pad_len)`` of the modulation energy frames."""
    w_length = ceil(0.256 * fs)
    w_inc = ceil(0.064 * fs)
    num_frames = max(1, int(1 + (time - w_length) // w_inc))  # at least 1: the pad covers short signals
    pad_len = max(ceil(time / w_inc) * w_inc - time, w_length - time)
    return w_length, w_inc, num_frames, pad_len


def speech_reverberation_modulation_energy_ratio(
    preds: torch.Tensor,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
    on_device: bool = False,
) -> torch.Tensor:
    """SRMR of ``preds`` with shape ``(..., time)``: float32 scores of the
    batch shape (shape ``(1,)`` for a 1-D input) on ``preds``' device.

    ``on_device=True`` takes the device path (:func:`srmr_on_device`).
    ``fast=True`` (SRMRpy's gammatonegram shortcut) warns on the host path
    and runs the exact filterbank.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import speech_reverberation_modulation_energy_ratio
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> [round(v, 4) for v in speech_reverberation_modulation_energy_ratio(preds, fs=8000).tolist()]
        [67.7379]
    """
    _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
    if on_device:
        return srmr_on_device(preds, fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm)
    if fast:
        warnings.warn(
            "`fast=True` is accepted for API parity but the exact gammatone filterbank path is used.",
            RuntimeWarning,
        )
    device = _out_device(preds)
    x = _host_float64(preds)
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    num_batch, time = x.shape

    # into [-1, 1], as the reference does for lfilter's stability
    max_vals = np.max(np.abs(x), axis=-1, keepdims=True)
    x = x / np.where(max_vals > 1, max_vals, 1.0)

    cfs = _centre_freqs(fs, n_cochlear_filters, low_freq)
    gt_env = _hilbert_envelope(_erb_filterbank(x, _make_erb_filters(fs, cfs)))  # (B, N, time)

    if max_cf is None:
        max_cf = 30 if norm else 128
    _, mfb, cutoffs = _modulation_filterbank_and_cutoffs(min_cf, max_cf, n=8, fs=float(fs), q=2)

    from scipy.signal import fftconvolve, lfilter

    w_length, w_inc, num_frames, pad_len = _frame_geometry(fs, time)
    window = np.hamming(w_length + 1)[:-1]
    mod_out = np.stack([lfilter(mfb[k, 0], mfb[k, 1], gt_env, axis=-1) for k in range(mfb.shape[0])], axis=2)
    mod_out = np.pad(mod_out, [(0, 0)] * 3 + [(0, pad_len)])
    # each frame's windowed energy sum((x w)^2): a sliding dot product of x^2
    # with w^2, every w_inc samples
    sliding = fftconvolve(mod_out**2, (window**2)[None, None, None, ::-1], mode="valid", axes=-1)
    energy = np.maximum(sliding[..., ::w_inc][..., :num_frames], 0.0)  # (B, N, 8, n_frames)

    if norm:
        energy = _normalize_energy(energy)

    erbs = _calc_erbs(low_freq, fs, n_cochlear_filters)[::-1]

    avg_energy = energy.mean(axis=-1)  # (B, N, 8)
    total_energy = avg_energy.reshape(num_batch, -1).sum(axis=-1)
    ac_energy = avg_energy.sum(axis=2)
    ac_perc = ac_energy * 100 / total_energy[:, None]
    ac_perc_cumsum = np.cumsum(ac_perc[:, ::-1], axis=-1)
    k90perc_idx = np.argmax(ac_perc_cumsum > 90, axis=-1)
    bw = erbs[k90perc_idx]

    scores = np.asarray([_srmr_score(bw[b], avg_energy[b], cutoffs) for b in range(num_batch)])
    out = scores.reshape(shape[:-1]) if len(shape) > 1 else scores
    return torch.as_tensor(out.astype(np.float32), device=device)


@functools.lru_cache(maxsize=8)
def _gammatone_fir_taps(fs: int, n_cochlear_filters: int, low_freq: float, length: int) -> np.ndarray:
    """(N, length) impulse responses of the gammatone bank (made on the host
    once a configuration). They decay as exp(-1.019·2π·ERB·t): at the lowest
    default band (125 Hz) the tail is below -200 dB by 128 ms."""
    impulse = np.zeros((1, length))
    impulse[0, 0] = 1.0
    return _erb_filterbank(impulse, _make_erb_filters(fs, _centre_freqs(fs, n_cochlear_filters, low_freq)))[0]


def _modulation_fir_taps(mfb: np.ndarray, length: int) -> np.ndarray:
    """(8, length) impulse responses of the Q=2 modulation filters."""
    from scipy.signal import lfilter

    impulse = np.zeros(length)
    impulse[0] = 1.0
    return np.stack([lfilter(mfb[k, 0], mfb[k, 1], impulse) for k in range(mfb.shape[0])])


def _fast_length(n: int) -> int:
    """The least 7-smooth length ``>= n`` (2^a 3^b 5^c 7^d): cuFFT's fast
    radices, where an arbitrary length takes a slow plan and slow kernels.
    A linear FIR convolution's first samples are the same at any FFT length
    past ``len(x) + len(taps) - 1``."""
    best = 1 << max(n - 1, 0).bit_length()
    p7 = 1
    while p7 < best:
        p5 = p7
        while p5 < best:
            p3 = p5
            while p3 < best:
                # the least p3 * 2^k >= n
                best = min(best, p3 << (max(n - 1, 0) // p3).bit_length())
                p3 *= 3
            p5 *= 5
        p7 *= 7
    return best


def _fft_filter(x: torch.Tensor, taps: torch.Tensor, t_len: int) -> torch.Tensor:
    """Causal FIR filtering of ``x`` along the last axis by FFT (``taps``
    broadcast against ``x``), at a fast length; the first ``t_len`` samples."""
    n = _fast_length(x.shape[-1] + taps.shape[-1] - 1)
    return torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(taps, n=n), n=n)[..., :t_len]


def _hilbert_envelope_device(x: torch.Tensor) -> torch.Tensor:
    """|analytic signal| along the last axis: the one-sided spectrum of
    ``x`` zero-padded to the Hilbert length, as on the host."""
    n_orig = x.shape[-1]
    n = _hilbert_length(n_orig)
    mask = torch.as_tensor(_hilbert_mask(n), dtype=torch.float32, device=x.device)
    return torch.fft.ifft(torch.fft.fft(x, n=n, dim=-1) * mask, dim=-1)[..., :n_orig].abs()


def _frame_energies(sq: torch.Tensor, window_sq: torch.Tensor, w_inc: int, num_frames: int) -> torch.Tensor:
    """``sum_t sq[f w_inc + t] window_sq[t]`` for each frame ``f``: the
    squared band cut into blocks of ``w_inc`` samples, one matrix product
    with the window's ``q`` blocks (``q = ceil(len(window) / w_inc)``, the
    last zero-padded), and a frame summed from its ``q`` blocks. One read of
    the band; the host path's frames all lie inside it."""
    q = -(-window_sq.shape[0] // w_inc)
    blocks = num_frames - 1 + q
    need = blocks * w_inc
    sq = sq[..., :need] if sq.shape[-1] >= need else F.pad(sq, (0, need - sq.shape[-1]))
    w = F.pad(window_sq, (0, q * w_inc - window_sq.shape[0])).reshape(q, w_inc).T  # (w_inc, q)
    partial = torch.matmul(sq.reshape(*sq.shape[:-1], blocks, w_inc), w)  # (..., blocks, q)
    return sum(partial[..., j : j + num_frames, j] for j in range(q))


def _bluestein(n: int) -> bool:
    """Whether cuFFT transforms length ``n`` by Bluestein's algorithm (a
    prime factor above 127), whose work area is reckoned as two complex
    buffers of the next power of two past ``2 n - 1``."""
    factor = 2
    while factor * factor <= n:
        while n % factor == 0:
            n //= factor
        factor += 1
    return n > 127


def _device_bytes_per_signal(time: int, fs: int, n_filters: int) -> int:
    """The device path's reckoned peak for one signal, the larger of its two
    stages in float32 terms: the Hilbert stage holds the gammatone output
    (N, n_gt) beside the complex spectrum, its masked copy and its inverse,
    (N, n_h) each at twice the size, and cuFFT's work area (two complex
    buffers of a power of two past 2 n_h where the Hilbert length takes
    Bluestein's algorithm, else one more spectrum); a modulation band holds
    the envelope's spectrum, the band's product, its inverse and a work area,
    (N, n_mod) each, beside the band's square and its blocks, (N, time) each.
    ``chip_smoke.py``'s ``reverb_srmr`` phase holds every update's peak on
    the card to it, at batch 16 over REVERB's lengths."""
    n_gt = _fast_length(time + int(0.128 * fs) - 1)
    n_mod = _fast_length(time + int(1.5 * fs) - 1)
    n_h = _hilbert_length(time)
    work = 4 * (1 << (2 * n_h - 1).bit_length()) if _bluestein(n_h) else 2 * n_h
    hilbert = n_gt + 6 * n_h + work
    modulation = 4 * n_mod + 2 * time
    return 4 * n_filters * max(hilbert, modulation)


def _srmr_device_chunk(
    x: torch.Tensor, fs: int, gt_taps: torch.Tensor, mod_taps: torch.Tensor, cutoffs: np.ndarray,
    erbs: torch.Tensor, norm: bool,
) -> torch.Tensor:
    num_batch, time = x.shape
    dev = x.device
    gt_env = _hilbert_envelope_device(_fft_filter(x[:, None, :], gt_taps, time))  # (B, N, T)

    w_length, w_inc, num_frames, _ = _frame_geometry(fs, time)
    window_sq = torch.as_tensor(np.hamming(w_length + 1)[:-1] ** 2, dtype=torch.float32, device=dev)
    n_mod = _fast_length(time + mod_taps.shape[-1] - 1)
    env_f = torch.fft.rfft(gt_env, n=n_mod)
    del gt_env
    energies = []
    for k in range(mod_taps.shape[0]):
        band = torch.fft.irfft(env_f * torch.fft.rfft(mod_taps[k], n=n_mod), n=n_mod)[..., :time]
        energies.append(_frame_energies(band.square_(), window_sq, w_inc, num_frames))
        del band
    energy = torch.stack(energies, dim=2).clamp(min=0.0)  # (B, N, 8, n_frames)

    if norm:
        peak = energy.mean(dim=1, keepdim=True).amax(dim=(2, 3), keepdim=True)
        energy = torch.minimum(torch.maximum(energy, peak * 10.0 ** (-3.0)), peak)

    avg_energy = energy.mean(dim=-1)  # (B, N, 8)
    total_energy = avg_energy.reshape(num_batch, -1).sum(dim=-1)
    ac_perc = avg_energy.sum(dim=2) * 100 / total_energy[:, None]
    ac_perc_cumsum = torch.cumsum(ac_perc.flip(-1), dim=-1)
    # the first band past 90% (argmax of a bool: its first True, 0 if none)
    k90perc_idx = torch.argmax((ac_perc_cumsum > 90).to(torch.uint8), dim=-1)
    bw = erbs[k90perc_idx]

    # k* without a host branch: 5 + #{cutoffs[5:8] <= bw}
    cut = torch.as_tensor(cutoffs[5:8], dtype=torch.float32, device=dev)
    kstar = 5 + (bw[:, None] >= cut[None, :]).sum(dim=-1)
    band_ix = torch.arange(8, device=dev)
    low_e = torch.where(band_ix < 4, avg_energy, 0.0).sum(dim=(1, 2))
    high_mask = (band_ix[None, None, :] >= 4) & (band_ix[None, None, :] < kstar[:, None, None])
    high_e = torch.where(high_mask, avg_energy, 0.0).sum(dim=(1, 2))
    return low_e / high_e


def srmr_on_device(
    preds: torch.Tensor,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
) -> torch.Tensor:
    """SRMR on the input's device in float32, batched over the leading axes
    (in chunks of signals under ``DEVICE_BUDGET_BYTES``); within about 1e-3
    relative of the host float64 path.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional.audio.srmr import srmr_on_device
        >>> t = torch.arange(0, 1.0, 1 / 800.0)
        >>> target = torch.sin(2 * math.pi * 100 * t)
        >>> preds = target + 0.1 * torch.cos(2 * math.pi * 17 * t)
        >>> [round(v, 2) for v in srmr_on_device(preds, fs=8000).tolist()]
        [67.74]
    """
    _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, False)
    preds = torch.as_tensor(preds)
    shape = preds.shape
    x = preds.to(torch.float32).reshape(-1, shape[-1])
    dev = x.device
    time = x.shape[-1]

    max_vals = x.abs().amax(dim=-1, keepdim=True)
    x = x / torch.where(max_vals > 1, max_vals, torch.ones_like(max_vals))

    if max_cf is None:
        max_cf = 30 if norm else 128
    _, mfb, cutoffs = _modulation_filterbank_and_cutoffs(min_cf, max_cf, n=8, fs=float(fs), q=2)
    gt_taps = torch.as_tensor(
        _gammatone_fir_taps(fs, n_cochlear_filters, float(low_freq), int(0.128 * fs)), dtype=torch.float32, device=dev
    )
    mod_taps = torch.as_tensor(_modulation_fir_taps(mfb, int(1.5 * fs)), dtype=torch.float32, device=dev)
    erbs = torch.as_tensor(_calc_erbs(low_freq, fs, n_cochlear_filters)[::-1].copy(), dtype=torch.float32, device=dev)

    chunk = max(1, DEVICE_BUDGET_BYTES // _device_bytes_per_signal(time, fs, n_cochlear_filters))
    with full_float32():
        scores = torch.cat([
            _srmr_device_chunk(x[s : s + chunk], fs, gt_taps, mod_taps, cutoffs, erbs, norm)
            for s in range(0, x.shape[0], chunk)
        ]) if x.shape[0] else x.new_zeros(0)
    return scores.reshape(shape[:-1]) if len(shape) > 1 else scores
