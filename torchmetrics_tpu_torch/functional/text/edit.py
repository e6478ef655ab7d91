"""Levenshtein edit distance and Extended Edit Distance (EED).

EditDistance is the character-level Levenshtein distance with a
substitution cost and a batch reduction, counted by the native library. EED
(Stanchev, Wang and Ney, WMT 2019) is the CDER alignment grid with long
jumps, a pure-Python DP. Both are host work: an update's distances or
sentence scores reach the device as one tensor.
"""
from __future__ import annotations

import re
import unicodedata
from math import inf
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.helper import _batch_distances, _text_device
from torchmetrics_tpu_torch.native import batch_edit_distance


# --------------------------------------------------------------- EditDistance
def _edit_distance_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
) -> np.ndarray:
    """The character-level distance of every pair (int64, on the host)."""
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [target] if isinstance(target, str) else list(target)
    if not all(isinstance(x, str) for x in preds_l):
        raise ValueError(f"Expected all values in argument `preds` to be string type, but got {preds_l}")
    if not all(isinstance(x, str) for x in target_l):
        raise ValueError(f"Expected all values in argument `target` to be string type, but got {target_l}")
    if len(preds_l) != len(target_l):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds_l)} and {len(target_l)}"
        )
    if substitution_cost == 1:
        return _batch_distances(preds_l, target_l, char_level=True)[1]
    return batch_edit_distance([(list(p), list(t)) for p, t in zip(preds_l, target_l)], substitution_cost)


def _edit_distance_compute(
    edit_scores: torch.Tensor,
    num_elements: Union[torch.Tensor, int],
    reduction: Optional[str] = "mean",
) -> torch.Tensor:
    """Mean, sum (in the scores' dtype) or the scores themselves."""
    if edit_scores.numel() == 0:
        return torch.tensor(0, dtype=torch.int32, device=edit_scores.device)
    if reduction == "mean":
        return edit_scores.sum() / num_elements
    if reduction == "sum":
        return edit_scores.sum(dtype=edit_scores.dtype)
    if reduction is None or reduction == "none":
        return edit_scores
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """Character-level Levenshtein distance over a batch, reduced by
    ``reduction`` ("mean", "sum", "none" or None); int32 distances on
    ``device`` (default: the current CUDA device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import edit_distance
        >>> float(edit_distance(["kitten"], ["sitting"], device="cpu"))
        3.0
    """
    device = _text_device(device)
    distance = torch.as_tensor(_edit_distance_update(preds, target, substitution_cost), dtype=torch.int32).to(device)
    return _edit_distance_compute(distance, num_elements=distance.numel(), reduction=reduction)


# ------------------------------------------------------------------------ EED
def _eed_dp(hyp: str, ref: str, alpha: float, rho: float, deletion: float, insertion: float) -> float:
    """One sentence's EED on the CDER alignment grid with long jumps.

    Columns index hypothesis characters and rows sweep reference characters.
    At each reference space a jump edge (cost ``alpha``) lets the alignment
    restart from the best column, and per-column visit counts accumulate the
    rho-weighted coverage penalty.
    """
    n = len(hyp)
    visits = [-1] * (n + 1)
    row = [1.0] * (n + 1)
    row[0] = 0.0
    for w in range(1, len(ref) + 1):
        ref_ch = ref[w - 1]
        next_row = [inf] * (n + 1)
        next_row[0] = row[0] + 1.0
        for i in range(1, n + 1):
            next_row[i] = min(
                next_row[i - 1] + deletion,
                row[i - 1] + (0.0 if hyp[i - 1] == ref_ch else 1.0),
                row[i] + insertion,
            )
        min_index = next_row.index(min(next_row))
        visits[min_index] += 1
        if ref_ch == " ":
            jump = alpha + next_row[min_index]
            next_row = [min(x, jump) for x in next_row]
        row = next_row
    coverage = rho * sum(x if x >= 0 else 1 for x in visits)
    return min(1.0, (row[-1] + coverage) / (float(len(ref)) + coverage))


_EED_EN_INTERPUNCTION = [(".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")]
_EED_EN_RE = [
    (r"\s+", r" "),
    (r"(\d) ([.,]) (\d)", r"\1\2\3"),
    # the trailing " ." is a space and ANY character, as the reference
    # pattern (unescaped) has it, so that scores stay bit-identical
    (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
]
_EED_EN_ABBREV = [("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")]


def _eed_preprocess_en(sentence: str) -> str:
    """English normalisation: spaced interpunction, repaired abbreviations,
    and the sentence wrapped in single spaces (the DP's jump sentinels)."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in _EED_EN_INTERPUNCTION:
        sentence = sentence.replace(pattern, replacement)
    for pattern, replacement in _EED_EN_RE:
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in _EED_EN_ABBREV:
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _eed_preprocess_ja(sentence: str) -> str:
    """Japanese normalisation: rstrip and NFKC only, no sentinels."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> List[float]:
    """Sentence-level EED scores, the best (lowest) over each sentence's
    references (host floats; a sentence without references has none)."""
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_l) != len(target_l):
        raise ValueError(f"Corpus has different size {len(preds_l)} != {len(target_l)}")
    preprocess = _eed_preprocess_en if language == "en" else _eed_preprocess_ja
    if language not in ("en", "ja"):
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")

    scores: List[float] = []
    for pred, refs in zip(preds_l, target_l):
        hyp = preprocess(pred)
        best = None
        for ref in refs:
            score = _eed_dp(hyp, preprocess(ref), alpha, rho, deletion, insertion)
            best = score if best is None or score < best else best
        if best is not None:
            scores.append(best)
    return scores


def _eed_compute(sentence_level_scores: torch.Tensor) -> torch.Tensor:
    """Corpus EED: the mean of the float32 sentence scores (0 with none)."""
    if sentence_level_scores.numel() == 0:
        return torch.tensor(0.0, device=sentence_level_scores.device)
    return sentence_level_scores.mean()


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Union[str, torch.device, None] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Extended Edit Distance, with the float32 sentence scores when
    ``return_sentence_level_score``; on ``device`` (default: the current CUDA
    device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import extended_edit_distance
        >>> preds = ["the cat sat on the mat"]
        >>> target = [["a cat sat on the mat"]]
        >>> round(float(extended_edit_distance(preds, target, device="cpu")), 4)
        0.1452
    """
    device = _text_device(device)
    scores = torch.tensor(
        _eed_update(preds, target, language, alpha, rho, deletion, insertion), dtype=torch.float32
    ).to(device)
    corpus = _eed_compute(scores)
    if return_sentence_level_score:
        return corpus, scores
    return corpus
