"""Short-Time Objective Intelligibility (STOI, Taal et al. 2011) and its
extended form (ESTOI, Jensen & Taal 2016).

resample to 10 kHz → drop silent frames (40 dB dynamic range, 256/128 Hann
framing, overlap-add) → 512-point STFT → 15 third-octave bands from 150 Hz
→ 30-frame segments → (STOI) per-band normalisation and clipping at -15 dB
SDR, then band-row correlation / (ESTOI) row and column normalisation and
inner product.

Two paths:

- the default is the host path in float64 numpy (scipy's ``resample_poly``),
  one read of the inputs from the device an update;
- ``on_device=True`` runs on the inputs' device in float32, batched over the
  leading axes. The resampler applies the same FIR taps in polyphase form
  (one strided ``conv1d`` with a channel for each of the ``up`` output
  streams: only the nonzero products of the zero-stuffed convolution, and
  only every ``down``-th output). The silent
  frames are compacted by a stable sort of the drop mask, and the
  overlap-add of the 50%-overlapping frames is a fold of their two halves
  (each sample is the sum of exactly two frames' halves, in a fixed order),
  so no scatter-add runs. Segments that reach past the kept frames are
  masked, and a signal with no whole segment scores ``1e-5`` through
  ``torch.where``. It agrees with the host path to about 1e-3.
"""
from __future__ import annotations

import warnings
from math import gcd
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.functional.audio.pesq import _host_float64, _out_device
from torchmetrics_tpu_torch.utils.compute import full_float32

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0
_EPS = np.finfo(np.float64).eps


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float) -> np.ndarray:
    """Third-octave band matrix over the rfft bins (pystoi's ``thirdoct``)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    freq_low = min_freq * np.power(2.0, (2 * k - 1) / 6)
    freq_high = min_freq * np.power(2.0, (2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = int(np.argmin(np.square(f - freq_low[i])))
        fh_ii = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, fl_ii:fh_ii] = 1.0
    return obm


_OBM = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)
_HANN = np.hanning(N_FRAME + 2)[1:-1]


def _frames(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    """Windowed overlapping frames, shape (num_frames, framelen)."""
    n = (len(x) - framelen) // hop + 1
    if n <= 0:
        return np.zeros((0, framelen))
    idx = np.arange(framelen)[None, :] + hop * np.arange(n)[:, None]
    return _HANN[None, :] * x[idx]


def _overlap_and_add(frames: np.ndarray, hop: int) -> np.ndarray:
    num_frames, framelen = frames.shape
    out = np.zeros(framelen + (num_frames - 1) * hop)
    for i in range(num_frames):
        out[i * hop : i * hop + framelen] += frames[i]
    return out


def _remove_silent_frames(
    x: np.ndarray, y: np.ndarray, dyn_range: float, framelen: int, hop: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop the frames whose clean-signal energy is more than ``dyn_range``
    below the loudest."""
    x_frames = _frames(x, framelen, hop)
    y_frames = _frames(y, framelen, hop)
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + _EPS)
    mask = (np.max(energies) - dyn_range - energies) < 0
    return _overlap_and_add(x_frames[mask], hop), _overlap_and_add(y_frames[mask], hop)


def _resample_to_fs(x: np.ndarray, fs_in: int) -> np.ndarray:
    """Polyphase resample to 10 kHz."""
    from scipy.signal import resample_poly

    g = gcd(FS, fs_in)
    return resample_poly(x, FS // g, fs_in // g)


def _band_envelopes(sig: np.ndarray) -> np.ndarray:
    """(15, num_frames) third-octave band magnitudes of a 10 kHz signal."""
    frames = _frames(sig, N_FRAME, N_FRAME // 2)
    spec = np.fft.rfft(frames, n=NFFT).T
    return np.sqrt(_OBM @ np.square(np.abs(spec)))


def _row_col_normalize(seg: np.ndarray) -> np.ndarray:
    """Normalise the band rows, then the frame columns, of (J, 15, 30)
    segments (ESTOI)."""
    s = seg - np.mean(seg, axis=2, keepdims=True)
    s = s / (np.linalg.norm(s, axis=2, keepdims=True) + _EPS)
    s = s - np.mean(s, axis=1, keepdims=True)
    s = s / (np.linalg.norm(s, axis=1, keepdims=True) + _EPS)
    return s


def _warn_few_frames() -> None:
    warnings.warn(
        "Not enough STFT frames to compute intermediate intelligibility measure after"
        " removing silent frames. Returning 1e-5.",
        RuntimeWarning,
    )


def _stoi_single(x: np.ndarray, y: np.ndarray, fs: int, extended: bool) -> float:
    """STOI of one clean/degraded pair on the host, in float64."""
    if fs != FS:
        x = _resample_to_fs(x, fs)
        y = _resample_to_fs(y, fs)
    if len(x) < N_FRAME:
        _warn_few_frames()
        return 1e-5
    x, y = _remove_silent_frames(x, y, DYN_RANGE, N_FRAME, N_FRAME // 2)
    x_tob = _band_envelopes(x)
    y_tob = _band_envelopes(y)
    num_frames = x_tob.shape[1]
    if num_frames < N_SEG:
        _warn_few_frames()
        return 1e-5

    starts = np.arange(num_frames - N_SEG + 1)
    x_seg = np.stack([x_tob[:, m : m + N_SEG] for m in starts])
    y_seg = np.stack([y_tob[:, m : m + N_SEG] for m in starts])

    if extended:
        x_n = _row_col_normalize(x_seg)
        y_n = _row_col_normalize(y_seg)
        return float(np.sum(x_n * y_n / N_SEG) / x_n.shape[0])

    norm_const = np.linalg.norm(x_seg, axis=2, keepdims=True) / (np.linalg.norm(y_seg, axis=2, keepdims=True) + _EPS)
    y_prime = np.minimum(y_seg * norm_const, x_seg * (1 + np.power(10.0, -BETA / 20)))

    y_prime = y_prime - np.mean(y_prime, axis=2, keepdims=True)
    x_c = x_seg - np.mean(x_seg, axis=2, keepdims=True)
    y_prime = y_prime / (np.linalg.norm(y_prime, axis=2, keepdims=True) + _EPS)
    x_c = x_c / (np.linalg.norm(x_c, axis=2, keepdims=True) + _EPS)
    J, M = x_c.shape[0], x_c.shape[1]
    return float(np.sum(y_prime * x_c) / (J * M))


def short_time_objective_intelligibility(
    preds: torch.Tensor,
    target: torch.Tensor,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
    on_device: bool = False,
) -> torch.Tensor:
    """STOI (or ESTOI with ``extended=True``) of degraded ``preds`` against
    clean ``target``, shapes ``(..., time)``; float32 scores of the batch
    shape on ``preds``' device. ``on_device=True`` takes the device path
    (:func:`stoi_on_device`); ``keep_same_device`` is accepted and changes
    nothing.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional import short_time_objective_intelligibility
        >>> t = torch.arange(0, 1.0, 1 / 8000.0)
        >>> target = torch.sin(2 * math.pi * 440 * t)
        >>> preds = target + 0.1 * torch.sin(2 * math.pi * 555 * t)
        >>> round(float(short_time_objective_intelligibility(preds, target, fs=8000)), 4)
        0.4784
    """
    if not isinstance(fs, int) or fs <= 0:
        raise ValueError(f"Expected argument `fs` to be a positive integer, but got {fs}")
    if on_device:
        return stoi_on_device(preds, target, fs=fs, extended=extended)
    device = _out_device(preds)
    preds_np, target_np = _host_float64(preds), _host_float64(target)
    if preds_np.shape != target_np.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, got {preds_np.shape} and {target_np.shape}"
        )
    if preds_np.ndim == 1:
        out = np.asarray(_stoi_single(target_np, preds_np, fs, extended))
    else:
        flat_p = preds_np.reshape(-1, preds_np.shape[-1])
        flat_t = target_np.reshape(-1, target_np.shape[-1])
        vals = [_stoi_single(t, p, fs, extended) for p, t in zip(flat_p, flat_t)]
        out = np.asarray(vals).reshape(preds_np.shape[:-1])
    return torch.as_tensor(out.astype(np.float32), device=device)


def _resample_taps(up: int, down: int) -> np.ndarray:
    """FIR taps of scipy's ``resample_poly`` default design (Kaiser, beta 5)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    return firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0)) * up


def _resample_device(x: torch.Tensor, up: int, down: int, taps: np.ndarray) -> torch.Tensor:
    """Resample ``(B, time)`` by ``up / down`` as zero-stuffing, filtering with
    ``taps`` (a convolution, centred) and keeping every ``down``-th sample
    would, in polyphase form: output ``m`` reads the taps of one phase
    (``(m down + start) mod up``), so the outputs split into ``up`` streams,
    each a correlation of the unstuffed input with one phase's taps at stride
    ``down``. One ``conv1d`` with a channel a stream (the phases' taps shifted
    to a common start), then the streams interleaved: 1/``up`` of the
    stuffed form's multiply-adds, and the same nonzero products."""
    batch, n = x.shape
    length = len(taps)
    start = length // 2
    out_len = -(-n * up // down)
    r = -(-length // up)  # taps a phase
    h = np.zeros(up * r)
    h[:length] = taps
    first = np.arange(up) * down + start  # the stuffed index of each stream's first output
    phase, base = first % up, first // up
    lo = int(base.min())
    width = int(base.max()) - lo + r
    # stream c at input offset base_c + j down - i reads tap phase_c + up i
    w = np.zeros((up, 1, width))
    i = np.arange(r)
    for c in range(up):
        w[c, 0, r - 1 - lo + base[c] - i] = h[phase[c] + up * i]
    streams = -(-out_len // up)
    left = r - 1 - lo
    padded = F.pad(x, (left, max((streams - 1) * down + width - n - left, 0)))
    y = F.conv1d(padded[:, None, :], torch.as_tensor(w, dtype=x.dtype, device=x.device), stride=down)[:, :, :streams]
    return y.transpose(1, 2).reshape(batch, -1)[:, :out_len]


def _stoi_device_batch(x: torch.Tensor, y: torch.Tensor, extended: bool) -> torch.Tensor:
    """STOI of ``(B, time)`` clean/degraded 10 kHz pairs on their device."""
    batch, n = x.shape
    hop = N_FRAME // 2
    num_frames = max((n - N_FRAME) // hop + 1, 0)
    floor = torch.full((batch,), 1e-5, dtype=torch.float32, device=x.device)
    if num_frames - N_SEG + 1 <= 0:
        return floor
    dev = x.device
    hann = torch.as_tensor(_HANN, dtype=x.dtype, device=dev)
    idx = torch.arange(N_FRAME, device=dev)[None, :] + hop * torch.arange(num_frames, device=dev)[:, None]
    x_frames = hann * x[:, idx]  # (B, F, 256)
    y_frames = hann * y[:, idx]

    energies = 20 * torch.log10(torch.linalg.vector_norm(x_frames, dim=-1) + _EPS)
    keep = (energies.amax(dim=-1, keepdim=True) - DYN_RANGE - energies) < 0
    # stable compaction: the kept frames first, in their order
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    gather = order[..., None].expand(-1, -1, N_FRAME)
    count = keep.sum(dim=-1)
    valid = (torch.arange(num_frames, device=dev)[None, :] < count[:, None])[..., None]
    x_frames = torch.where(valid, torch.gather(x_frames, 1, gather), 0.0)
    y_frames = torch.where(valid, torch.gather(y_frames, 1, gather), 0.0)

    def overlap_add(frames: torch.Tensor) -> torch.Tensor:
        # 50% overlap: block k of hop samples is frame k's first half plus
        # frame k-1's second half
        halves = frames.reshape(batch, num_frames, 2, hop)
        blocks = F.pad(halves[:, :, 0], (0, 0, 0, 1)) + F.pad(halves[:, :, 1], (0, 0, 1, 0))
        return blocks.reshape(batch, (num_frames + 1) * hop)

    obm = torch.as_tensor(_OBM, dtype=x.dtype, device=dev)

    def band_envelopes(sig: torch.Tensor) -> torch.Tensor:
        spec = torch.fft.rfft(hann * sig[:, idx], n=NFFT, dim=-1).abs().square()  # (B, F, 257)
        return torch.sqrt(torch.matmul(spec, obm.T)).transpose(1, 2)  # (B, 15, F)

    x_tob = band_envelopes(overlap_add(x_frames))
    y_tob = band_envelopes(overlap_add(y_frames))

    num_seg = num_frames - N_SEG + 1
    starts = torch.arange(num_seg, device=dev)
    seg_idx = starts[:, None] + torch.arange(N_SEG, device=dev)[None, :]
    x_seg = x_tob[:, :, seg_idx].permute(0, 2, 1, 3)  # (B, J, 15, 30)
    y_seg = y_tob[:, :, seg_idx].permute(0, 2, 1, 3)
    seg_valid = (starts[None, :] + N_SEG) <= count[:, None]
    n_valid = seg_valid.sum(dim=-1)

    def unit(s: torch.Tensor, dim: int) -> torch.Tensor:
        s = s - s.mean(dim=dim, keepdim=True)
        return s / (torch.linalg.vector_norm(s, dim=dim, keepdim=True) + _EPS)

    if extended:
        corr = (unit(unit(x_seg, 3), 2) * unit(unit(y_seg, 3), 2)).sum(dim=(2, 3)) / N_SEG
    else:
        norm_const = torch.linalg.vector_norm(x_seg, dim=3, keepdim=True) / (
            torch.linalg.vector_norm(y_seg, dim=3, keepdim=True) + _EPS
        )
        y_prime = torch.minimum(y_seg * norm_const, x_seg * (1 + 10.0 ** (-BETA / 20)))
        corr = (unit(y_prime, 3) * unit(x_seg, 3)).sum(dim=(2, 3)) / NUMBAND
    score = torch.where(seg_valid, corr, 0.0).sum(dim=-1) / n_valid.clamp(min=1)
    return torch.where(n_valid > 0, score, floor).to(torch.float32)


def stoi_on_device(preds: torch.Tensor, target: torch.Tensor, fs: int, extended: bool = False) -> torch.Tensor:
    """STOI on the inputs' device in float32, batched over the leading axes;
    within about 1e-3 of the host float64 path.

    Example:
        >>> import math, torch
        >>> from torchmetrics_tpu_torch.functional.audio.stoi import stoi_on_device
        >>> t = torch.arange(0, 1.0, 1 / 8000.0)
        >>> target = torch.sin(2 * math.pi * 440 * t)
        >>> preds = target + 0.1 * torch.sin(2 * math.pi * 555 * t)
        >>> round(float(stoi_on_device(preds, target, fs=8000)), 3)
        0.478
    """
    if not isinstance(fs, int) or fs <= 0:
        raise ValueError(f"Expected argument `fs` to be a positive integer, but got {fs}")
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    shape = preds.shape[:-1]
    flat_p = preds.reshape(-1, preds.shape[-1])
    flat_t = target.reshape(-1, target.shape[-1])
    with full_float32():
        if fs != FS:
            g = gcd(FS, fs)
            taps = _resample_taps(FS // g, fs // g)
            flat_p = _resample_device(flat_p, FS // g, fs // g, taps)
            flat_t = _resample_device(flat_t, FS // g, fs // g, taps)
        out = _stoi_device_batch(flat_t, flat_p, extended)
    return out.reshape(shape)
