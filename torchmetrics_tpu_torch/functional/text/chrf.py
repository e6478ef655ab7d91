"""chrF and chrF++ (Popović 2015, 2017).

The F-beta score of character n-grams (orders 1 to ``n_char_order``) and,
for chrF++, of word n-grams (orders 1 to ``n_word_order``), averaged over
all orders. The corpus state is six dense per-order vectors (prediction,
reference and matching totals for characters and words), summed across
processes.

N-gram counting is host work. Each sentence keeps its best reference by the
sentence score, which is formed on the host in float32 with the same
operations as the corpus score on the device, so the choice among
references and the sentence scores follow the JAX package's float32
arithmetic. An update's totals reach the device as one tensor, and its
sentence scores (with ``return_sentence_level_score``) as another.
"""
from __future__ import annotations

import string
from collections import Counter
from itertools import chain
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.helper import _ngram_counts_by_order, _text_device

_EPS_SMOOTHING = 1e-16
_PUNCTUATIONS = set(string.punctuation)


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    """The character stream, ASCII spaces removed unless ``whitespace``."""
    if whitespace:
        return list(sentence)
    # only ASCII spaces go (after a strip): unicode whitespace such as
    # U+3000 stays a character, as in the reference
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    """Split a leading or trailing punctuation mark off a word."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    """The word stream with punctuation separated."""
    return list(chain.from_iterable(_separate_word_and_punctuation(word) for word in sentence.strip().split()))


def _sentence_counts(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[Dict[int, Counter], Dict[int, Counter]]:
    if lowercase:
        sentence = sentence.lower()
    char_counts = _ngram_counts_by_order(_get_characters(sentence, whitespace), n_char_order)
    word_counts = _ngram_counts_by_order(_get_words_and_punctuation(sentence), n_word_order)
    return char_counts, word_counts


def _totals(counts: Dict[int, Counter], order: int) -> np.ndarray:
    return np.asarray([sum(counts[n].values()) for n in range(1, order + 1)], dtype=np.float32)


def _matches(hyp: Dict[int, Counter], ref: Dict[int, Counter], order: int) -> np.ndarray:
    """Clipped matches by order."""
    out = []
    for n in range(1, order + 1):
        h, r = hyp[n], ref[n]
        out.append(sum(min(cnt, r[g]) for g, cnt in h.items()))
    return np.asarray(out, dtype=np.float32)


def _sentence_fscore(matching: np.ndarray, hyp_total: np.ndarray, ref_total: np.ndarray, beta: float) -> np.ndarray:
    """Per-order F-beta of one sentence in float32 on the host (the same
    operations as :func:`_chrf_fscore_vec`)."""
    precision = np.where(hyp_total > 0, matching / np.maximum(hyp_total, np.float32(1)), np.float32(0))
    recall = np.where(ref_total > 0, matching / np.maximum(ref_total, np.float32(1)), np.float32(0))
    denom = np.maximum(np.float32(beta**2) * precision + recall, np.float32(_EPS_SMOOTHING))
    return np.float32(1 + beta**2) * precision * recall / denom


def _chrf_fscore_vec(
    matching: torch.Tensor, hyp_total: torch.Tensor, ref_total: torch.Tensor, beta: float
) -> torch.Tensor:
    """Per-order F-beta vector."""
    precision = torch.where(hyp_total > 0, matching / hyp_total.clamp_min(1), 0.0)
    recall = torch.where(ref_total > 0, matching / ref_total.clamp_min(1), 0.0)
    denom = (beta**2 * precision + recall).clamp_min(_EPS_SMOOTHING)
    return (1 + beta**2) * precision * recall / denom


def _chrf_score_compute(
    total_preds_char: torch.Tensor, total_preds_word: torch.Tensor,
    total_target_char: torch.Tensor, total_target_word: torch.Tensor,
    total_matching_char: torch.Tensor, total_matching_word: torch.Tensor,
    n_order: float, beta: float,
) -> torch.Tensor:
    """The average F-beta over all character and word orders (0-1 scale)."""
    char_f = _chrf_fscore_vec(total_matching_char, total_preds_char, total_target_char, beta)
    word_f = _chrf_fscore_vec(total_matching_word, total_preds_word, total_target_word, beta)
    return (torch.sum(char_f) + torch.sum(word_f)) / n_order


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int, n_word_order: int, n_order: float,
    beta: float, lowercase: bool, whitespace: bool,
) -> Tuple[np.ndarray, List[float]]:
    """An update's corpus statistics, each sentence against its best
    reference: one float32 vector ``[preds_char, preds_word, target_char,
    target_word, matching_char, matching_word]`` (each by order) and the
    sentence scores."""
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_l) != len(target_l):
        raise ValueError(f"Corpus has different size {len(preds_l)} != {len(target_l)}")

    width = 3 * (n_char_order + n_word_order)
    totals = np.zeros(width, dtype=np.float64)
    sentence_scores: List[float] = []
    for pred, refs in zip(preds_l, target_l):
        hyp_char, hyp_word = _sentence_counts(pred, n_char_order, n_word_order, lowercase, whitespace)
        hyp_char_total = _totals(hyp_char, n_char_order)
        hyp_word_total = _totals(hyp_word, n_word_order)

        best_f = None
        best = None
        for ref in refs:
            ref_char, ref_word = _sentence_counts(ref, n_char_order, n_word_order, lowercase, whitespace)
            ref_char_total = _totals(ref_char, n_char_order)
            ref_word_total = _totals(ref_word, n_word_order)
            match_char = _matches(hyp_char, ref_char, n_char_order)
            match_word = _matches(hyp_word, ref_word, n_word_order)
            f_sum = np.sum(_sentence_fscore(match_char, hyp_char_total, ref_char_total, beta)) + np.sum(
                _sentence_fscore(match_word, hyp_word_total, ref_word_total, beta)
            )
            f = float(f_sum / np.float32(n_order))
            if best_f is None or f > best_f:
                best_f = f
                best = (ref_char_total, ref_word_total, match_char, match_word)

        if best is None:
            raise ValueError("Expected at least one reference for every prediction")
        totals += np.concatenate([hyp_char_total, hyp_word_total, *best])
        sentence_scores.append(best_f)
    return totals.astype(np.float32), sentence_scores


def _chrf_split(totals: torch.Tensor, n_char_order: int, n_word_order: int) -> Tuple[torch.Tensor, ...]:
    """The six per-order vectors of :func:`_chrf_score_update`'s layout."""
    sizes = [n_char_order, n_word_order] * 3
    return tuple(torch.split(totals, sizes))


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device, None] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """chrF / chrF++ score, with the float32 sentence scores when
    ``return_sentence_level_score``; on ``device`` (default: the current CUDA
    device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import chrf_score
        >>> preds = ["the cat sat on the mat"]
        >>> target = [["a cat sat on the mat"]]
        >>> round(float(chrf_score(preds, target, device="cpu")), 4)
        0.8713
    """
    device = _text_device(device)
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")
    n_order = float(n_char_order + n_word_order)

    totals, sentence_scores = _chrf_score_update(
        preds, target, n_char_order, n_word_order, n_order, beta, lowercase, whitespace
    )
    stats = _chrf_split(torch.from_numpy(totals).to(device), n_char_order, n_word_order)
    corpus = _chrf_score_compute(*stats, n_order, beta)
    if return_sentence_level_score:
        return corpus, torch.tensor(sentence_scores, dtype=torch.float32).to(device)
    return corpus
