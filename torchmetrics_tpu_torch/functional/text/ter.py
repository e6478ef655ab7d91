"""Translation Edit Rate (TER).

tercom's algorithm as sacrebleu's lib_ter runs it: TER = (shifts + word
edit distance) / average reference length, where the shifts greedily move a
contiguous misaligned phrase of the hypothesis to its reference position
while that lowers the edit distance. A traced Levenshtein DP (``helper.py``)
drives the alignment; the shift search enumerates matching phrase pairs
(capped as tercom caps them: size under 10, distance at most 50, at most
1,000 candidates) and ranks candidates by (edit gain, length, earliest).

All of it is host work in Python; the corpus state is two scalars (total
edits, total reference length) summed across processes, and an update's
sentence scores reach the device as one tensor.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _LevenshteinEditDistance, _text_device

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000

# the reference removes ONLY this set, not all of
# string.punctuation — tokens like <, >, #, - must survive no_punctuation
_PUNCT_RE = re.compile(r"[\.,\?:;!\"\(\)]")
_ASIAN_PUNCT = re.compile(r"([、。〈-】〔-〟｡-･・])")
_FULL_WIDTH_PUNCT = re.compile(r"([．，？：；！＂（）])")
_TERCOM_TOKENIZE_RE = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    # possessive splitting, in the reference's rule order
    (re.compile(r"'s "), r" 's "),
    (re.compile(r"'s$"), r" 's"),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)


class _TercomTokenizer:
    """Tercom normalization/tokenization options."""

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        # NB the reference joins "\n-" (not the sgm-era "-\n") and has NO
        # <skipped> rule — it tokenizes that literally
        sentence = (
            sentence.replace("\n-", "")
            .replace("\n", " ")
            .replace("&quot;", '"')
            .replace("&amp;", "&")
            .replace("&lt;", "<")
            .replace("&gt;", ">")
        )
        for pattern, repl in _TERCOM_TOKENIZE_RE:
            sentence = pattern.sub(repl, sentence)
        return sentence

    @staticmethod
    def _normalize_asian(sentence: str) -> str:
        """Split ideographs to character level, kana runs kept joined —
        rule-for-rule the reference tokenizer (its
        kana regexes are start-anchored and near-no-op, reproduced verbatim
        because tercom parity means matching them, quirks included)."""
        # CJK Unified Ideographs + Extension A
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        # CJK Strokes + Radicals Supplement
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        # CJK Compatibility (+Ideographs, +Forms)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        # Enclosed CJK Letters and Months (reference's over-wide ㈀-㼢)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", sentence)
        sentence = _ASIAN_PUNCT.sub(r" \1 ", sentence)
        return _FULL_WIDTH_PUNCT.sub(r" \1 ", sentence)

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return _PUNCT_RE.sub("", sentence)

    @staticmethod
    def _remove_asian_punct(sentence: str) -> str:
        sentence = _ASIAN_PUNCT.sub("", sentence)
        return _FULL_WIDTH_PUNCT.sub("", sentence)


def _preprocess_sentence(sentence: str, tokenizer: _TercomTokenizer) -> str:
    return tokenizer(sentence.rstrip())


def _trace_to_alignment(trace: str) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Map the edit trace to ref→pred position alignment + per-side error flags.

    For each reference position, the aligned prediction index (for 'e'/'s'
    steps); the error flags mark positions touched by s/i/d ops.
    """
    pred_idx = ref_idx = -1
    alignments: Dict[int, int] = {}
    pred_errors: List[int] = []
    target_errors: List[int] = []
    for op in trace:
        if op == "e":  # keep
            pred_idx += 1
            ref_idx += 1
            alignments[ref_idx] = pred_idx
            pred_errors.append(0)
            target_errors.append(0)
        elif op == "s":
            pred_idx += 1
            ref_idx += 1
            alignments[ref_idx] = pred_idx
            pred_errors.append(1)
            target_errors.append(1)
        elif op == "i":  # extra pred token
            pred_idx += 1
            pred_errors.append(1)
        elif op == "d":  # missing pred token — still anchors to current pred pos
            ref_idx += 1
            alignments[ref_idx] = pred_idx
            target_errors.append(1)
    return alignments, target_errors, pred_errors


def _find_shifted_pairs(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """All matching phrase pairs eligible to shift (tercom caps applied)."""
    for pred_start in range(len(pred_words)):
        for target_start in range(len(target_words)):
            if abs(pred_start - target_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if pred_words[pred_start + length - 1] != target_words[target_start + length - 1]:
                    break
                yield pred_start, target_start, length
                if len(pred_words) == pred_start + length or len(target_words) == target_start + length:
                    break


def _handle_corner_cases_during_shifting(
    alignments: Dict[int, int],
    pred_errors: List[int],
    target_errors: List[int],
    pred_start: int,
    target_start: int,
    length: int,
) -> bool:
    """True → skip this candidate (error-free span, or already aligned) — ter.py:244-278."""
    # no errors in either span → nothing to fix by shifting
    if sum(pred_errors[pred_start : pred_start + length]) == 0:
        return True
    if sum(target_errors[target_start : target_start + length]) == 0:
        return True
    # shifting within an already-aligned match is a no-op
    if pred_start <= alignments[target_start] < pred_start + length:
        return True
    return False


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move words[start:start+length] so it lands at position `target` (ter.py:281-312)."""
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    # target within the shifted span: rotate inside
    return (
        words[:start]
        + words[start + length : length + target]
        + words[start : start + length]
        + words[length + target :]
    )


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    cached_edit_distance: _LevenshteinEditDistance,
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """One round of the greedy shift search."""
    edit_distance, trace = cached_edit_distance(pred_words)
    alignments, target_errors, pred_errors = _trace_to_alignment(trace)
    best: Optional[Tuple[int, int, int, int, List[str]]] = None

    for pred_start, target_start, length in _find_shifted_pairs(pred_words, target_words):
        if _handle_corner_cases_during_shifting(
            alignments, pred_errors, target_errors, pred_start, target_start, length
        ):
            continue
        prev_idx = -1
        for offset in range(-1, length):
            if target_start + offset == -1:
                idx = 0
            elif target_start + offset in alignments:
                idx = alignments[target_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted_words = _perform_shift(pred_words, pred_start, length, idx)
            candidate = (
                edit_distance - cached_edit_distance(shifted_words)[0],
                length,
                -pred_start,
                -idx,
                shifted_words,
            )
            checked_candidates += 1
            if best is None or candidate[:4] > best[:4]:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if best is None:
        return 0, pred_words, checked_candidates
    return best[0], best[4], checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> int:
    """Edits (shifts + Levenshtein) for one hypothesis/reference pair (ter.py:396-428)."""
    if len(target_words) == 0:
        return 0
    cached_edit_distance = _LevenshteinEditDistance(target_words)
    num_shifts = 0
    checked_candidates = 0
    input_words = list(pred_words)
    while True:
        delta, new_input_words, checked_candidates = _shift_words(
            input_words, target_words, cached_edit_distance, checked_candidates
        )
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words
    edit_distance, _ = cached_edit_distance(input_words)
    return num_shifts + edit_distance


def _compute_sentence_statistics(
    pred_words: List[str], target_words_list: List[List[str]]
) -> Tuple[float, float]:
    """Best edits over references + avg reference length (ter.py:431-455)."""
    tgt_lengths = 0.0
    best_num_edits = float(int(2e16))
    for tgt_words in target_words_list:
        # argument order mirrors the reference (ter.py:449): the Levenshtein
        # cache is built on the prediction and the reference words are shifted
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    avg_tgt_len = tgt_lengths / len(target_words_list)
    return best_num_edits, avg_tgt_len


def _compute_ter_score_from_statistics(num_edits: torch.Tensor, tgt_length: torch.Tensor) -> torch.Tensor:
    """Edits over the average reference length, with the degenerate-length
    conventions (no reference words: 1 if there are edits, else 0)."""
    return torch.where(
        tgt_length > 0,
        num_edits / tgt_length.clamp_min(1e-16),
        torch.where(num_edits > 0, 1.0, 0.0),
    )


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
) -> Tuple[List[float], List[float]]:
    """Every sentence's best edit count over its references and its average
    reference length (host floats)."""
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_l) != len(target_l):
        raise ValueError(f"Corpus has different size {len(preds_l)} != {len(target_l)}")
    edits: List[float] = []
    lengths: List[float] = []
    for pred, tgt in zip(preds_l, target_l):
        tgt_words_ = [_preprocess_sentence(t, tokenizer).split() for t in tgt]
        pred_words_ = _preprocess_sentence(pred, tokenizer).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words_, tgt_words_)
        edits.append(num_edits)
        lengths.append(tgt_length)
    return edits, lengths


def _ter_sentence_scores(edits: List[float], lengths: List[float], device: torch.device) -> torch.Tensor:
    """An update's float32 sentence scores on ``device``, in one copy."""
    stats = torch.tensor([edits, lengths], dtype=torch.float32).to(device)
    return _compute_ter_score_from_statistics(stats[0], stats[1])


def _ter_compute(total_num_edits: torch.Tensor, total_tgt_length: torch.Tensor) -> torch.Tensor:
    return _compute_ter_score_from_statistics(total_num_edits, total_tgt_length)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device, None] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """TER of translated text against references, with the float32 sentence
    scores when ``return_sentence_level_score``; on ``device`` (default: the
    current CUDA device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import translation_edit_rate
        >>> preds = ["the cat sat on the mat"]
        >>> target = [["a cat sat on the mat"]]
        >>> round(float(translation_edit_rate(preds, target, device="cpu")), 4)
        0.1667
    """
    device = _text_device(device)
    _check_ter_flags(normalize, no_punctuation, lowercase, asian_support)
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    edits, lengths = _ter_update(preds, target, tokenizer)
    totals = torch.tensor([sum(edits), sum(lengths)], dtype=torch.float32).to(device)
    corpus = _ter_compute(totals[0], totals[1])
    if return_sentence_level_score:
        return corpus, _ter_sentence_scores(edits, lengths, device)
    return corpus


def _check_ter_flags(normalize: bool, no_punctuation: bool, lowercase: bool, asian_support: bool) -> None:
    for name, value in (
        ("normalize", normalize), ("no_punctuation", no_punctuation),
        ("lowercase", lowercase), ("asian_support", asian_support),
    ):
        if not isinstance(value, bool):
            raise ValueError(f"Expected argument `{name}` to be of type boolean but got {value}.")
