"""Speech-recognition error rates: WER, CER, MER, WIL and WIP.

Each update is host-side Levenshtein counting (one batched native call) into
two or three Python floats; the functionals form the ratio on the host and
put one float32 scalar on ``device``, the classes add the floats to float32
state on theirs. Division keeps IEEE semantics: 0/0 is NaN, x/0 is inf.
"""
from __future__ import annotations

import math
from typing import List, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _batch_distances, _text_device, _validate_text_inputs

Number = Union[torch.Tensor, float]


def _host_div(num: Number, den: Number) -> Number:
    """Division with IEEE zero semantics on host floats (0/0 -> nan, x/0 ->
    inf), which tensor division has already."""
    if isinstance(num, (int, float)) and isinstance(den, (int, float)):
        if den == 0.0:
            return float("nan") if num == 0.0 else math.copysign(math.inf, num)
        return num / den
    return num / den


def _as_float32(value: Number, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """A host float as one float32 scalar on ``device``; a tensor (a class's
    state arithmetic) as float32 where it lies."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32)
    return torch.tensor(value, dtype=torch.float32, device=_text_device(device))


# ------------------------------------------------------------------------- WER
def _wer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Summed word-level edit distance and the number of reference words."""
    preds, target = _validate_text_inputs(preds, target)
    pairs, dists = _batch_distances(preds, target)
    return float(dists.sum()), float(sum(len(t) for _, t in pairs))


def _wer_compute(errors: Number, total: Number, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    return _as_float32(_host_div(errors, total), device)


def word_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> torch.Tensor:
    """Word error rate: (substitutions + deletions + insertions) over the
    reference words. The result lies on ``device`` (default: the current
    CUDA device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_error_rate
        >>> round(float(word_error_rate(["this is the answer"], ["this was the answer"], device="cpu")), 4)
        0.25
    """
    device = _text_device(device)
    errors, total = _wer_update(preds, target)
    return _wer_compute(errors, total, device)


# ------------------------------------------------------------------------- CER
def _cer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Summed character-level edit distance and the number of reference
    characters."""
    preds, target = _validate_text_inputs(preds, target)
    pairs, dists = _batch_distances(preds, target, char_level=True)
    return float(dists.sum()), float(sum(len(t) for _, t in pairs))


def _cer_compute(errors: Number, total: Number, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    return _as_float32(_host_div(errors, total), device)


def char_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> torch.Tensor:
    """Character error rate over the reference characters.

    Example:
        >>> from torchmetrics_tpu_torch.functional import char_error_rate
        >>> preds = ["this is the answer", "hello duck"]
        >>> target = ["this was the answer", "hello world"]
        >>> round(float(char_error_rate(preds, target, device="cpu")), 4)
        0.2333
    """
    device = _text_device(device)
    errors, total = _cer_update(preds, target)
    return _cer_compute(errors, total, device)


# ------------------------------------------------------------------------- MER
def _mer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Summed word edit distance and the sum of each pair's longer length."""
    preds, target = _validate_text_inputs(preds, target)
    pairs, dists = _batch_distances(preds, target)
    return float(dists.sum()), float(sum(max(len(p_), len(t_)) for p_, t_ in pairs))


def _mer_compute(errors: Number, total: Number, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    return _as_float32(_host_div(errors, total), device)


def match_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> torch.Tensor:
    """Match error rate.

    Example:
        >>> from torchmetrics_tpu_torch.functional import match_error_rate
        >>> preds = ["this is the answer", "hello duck"]
        >>> target = ["this was the answer", "hello world"]
        >>> round(float(match_error_rate(preds, target, device="cpu")), 4)
        0.3333
    """
    device = _text_device(device)
    errors, total = _mer_update(preds, target)
    return _mer_compute(errors, total, device)


# --------------------------------------------------------------------- WIL/WIP
def _word_info_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float, float]:
    """The negated hit count (``edit - max_len`` summed; the squared ratio
    cancels the sign) and the reference and prediction word totals."""
    preds, target = _validate_text_inputs(preds, target)
    pairs, dists = _batch_distances(preds, target)
    errors = float(dists.sum())
    target_total = float(sum(len(t_) for _, t_ in pairs))
    preds_total = float(sum(len(p_) for p_, _ in pairs))
    total = float(sum(max(len(p_), len(t_)) for p_, t_ in pairs))
    return errors - total, target_total, preds_total


def _wil_compute(
    errors: Number, target_total: Number, preds_total: Number, device: Union[str, torch.device, None] = None
) -> torch.Tensor:
    return _as_float32(1 - (_host_div(errors, target_total) * _host_div(errors, preds_total)), device)


def _wip_compute(
    errors: Number, target_total: Number, preds_total: Number, device: Union[str, torch.device, None] = None
) -> torch.Tensor:
    return _as_float32(_host_div(errors, target_total) * _host_div(errors, preds_total), device)


def word_information_lost(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> torch.Tensor:
    """Word information lost: 1 - (H / N_ref)(H / N_hyp).

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_information_lost
        >>> preds = ["this is the answer", "hello duck"]
        >>> target = ["this was the answer", "hello world"]
        >>> round(float(word_information_lost(preds, target, device="cpu")), 4)
        0.5556
    """
    device = _text_device(device)
    errors, target_total, preds_total = _word_info_update(preds, target)
    return _wil_compute(errors, target_total, preds_total, device)


def word_information_preserved(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> torch.Tensor:
    """Word information preserved: (H / N_ref)(H / N_hyp).

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_information_preserved
        >>> preds = ["this is the answer", "hello duck"]
        >>> target = ["this was the answer", "hello world"]
        >>> round(float(word_information_preserved(preds, target, device="cpu")), 4)
        0.4444
    """
    device = _text_device(device)
    errors, target_total, preds_total = _word_info_update(preds, target)
    return _wip_compute(errors, target_total, preds_total, device)
