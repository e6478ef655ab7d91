"""BLEU and SacreBLEU.

Clipped n-gram precision with a brevity penalty over corpus-level counts.
SacreBLEU runs the same update after one of sacrebleu's tokenizers
(``none``, ``13a``, ``zh``, ``intl``, ``char``; the ``ja``/``ko`` MeCab and
``flores`` tokenizers need wheels that are not bundled and are refused).

N-gram counting is host work (Counters over word tuples); an update's counts
reach the device as one float32 tensor, and the states (``numerator``,
``denominator`` of shape ``(n_gram,)``, ``preds_len``, ``target_len``) are
summed across processes. The score is formed on the device.
"""
from __future__ import annotations

import re
import unicodedata
from collections import Counter
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _count_ngrams, _text_device


def _tokenize_fn(sentence: str) -> Sequence[str]:
    """Default whitespace tokenizer."""
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[int, int, List[int], List[int]]:
    """An update's prediction length, closest reference length, and clipped
    n-gram matches and prediction n-gram totals by order (host ints)."""
    target_tok = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok = [tokenizer(line) if line else [] for line in preds]
    num = [0] * n_gram
    den = [0] * n_gram
    p_len = 0
    t_len = 0
    for pred, targets in zip(preds_tok, target_tok):
        p_len += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        t_len += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter = _count_ngrams(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngrams(tgt, n_gram)
        clipped = preds_counter & target_counter
        for ngram, cnt in clipped.items():
            num[len(ngram) - 1] += cnt
        for ngram, cnt in preds_counter.items():
            den[len(ngram) - 1] += cnt
    return p_len, t_len, num, den


def _bleu_counts(num: Sequence[int], den: Sequence[int], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """An update's counts as float32 vectors on ``device``, in one copy."""
    counts = torch.tensor([*num, *den], dtype=torch.float32).to(device)
    return counts[: len(num)], counts[len(num) :]


def _bleu_score_compute(
    preds_len: torch.Tensor,
    target_len: torch.Tensor,
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> torch.Tensor:
    """Weighted geometric mean of the clipped precisions times the brevity
    penalty, in float32 on the states' device; 0 when an order has no match."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    if smooth:
        precision_scores = (numerator + 1.0) / (denominator + 1.0)
        precision_scores[0] = torch.where(denominator[0] > 0, numerator[0] / denominator[0].clamp_min(1), 0.0)
    else:
        precision_scores = numerator / denominator.clamp_min(1)
    weights_t = torch.tensor(weights, dtype=torch.float32, device=numerator.device)
    geometric_mean = torch.exp(torch.sum(weights_t * torch.log(precision_scores.clamp_min(1e-30))))
    brevity_penalty = torch.where(
        preds_len > target_len, 1.0, torch.exp(1 - (target_len / preds_len.clamp_min(1e-9)))
    )
    return torch.where(numerator.min() == 0.0, 0.0, brevity_penalty * geometric_mean)


def _corpus_bleu(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int,
    smooth: bool,
    weights: Sequence[float],
    tokenizer: Callable[[str], Sequence[str]],
    device: torch.device,
) -> torch.Tensor:
    p_len, t_len, num, den = _bleu_score_update(preds, target, n_gram, tokenizer)
    numerator, denominator = _bleu_counts(num, den, device)
    preds_len = torch.tensor(float(p_len), device=device)
    target_len = torch.tensor(float(t_len), device=device)
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """Corpus BLEU of machine-translated text, on ``device`` (default: the
    current CUDA device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import bleu_score
        >>> preds = ["the cat sat on the mat"]
        >>> target = [["a cat sat on the mat"]]
        >>> round(float(bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    device = _text_device(device)
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram
    return _corpus_bleu(preds_, target_, n_gram, smooth, weights, _tokenize_fn, device)


# ----------------------------------------------------------------- SacreBLEU
AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")

# CJK codepoint ranges the `zh` tokenizer splits on (sacrebleu tokenizer_zh spec)
_UCODE_RANGES = (
    ("㐀", "䶵"), ("一", "龥"), ("龦", "龻"),
    ("豈", "鶴"), ("侮", "頻"), ("並", "龎"),
    # NB kept as the reference writes them:
    # "\\u20000" parses as the TWO-char string "\\u2000"+"0", so the
    # lexicographic range check treats the whole U+2000..U+2A6D band (e.g.
    # '\u20ac') as Chinese - a reference quirk reproduced for parity
    ("\u20000", "\u2a6d6"), ("\u2f800", "\u2fa1d"),
    ("＀", "￯"), ("⺀", "⻿"), ("　", "〿"),
    ("㇀", "㇯"), ("⼀", "⿟"), ("⿰", "⿿"),
    ("㄀", "ㄯ"), ("ㆠ", "ㆿ"), ("︐", "︟"),
    ("︰", "﹏"), ("☀", "⛿"), ("✀", "➿"),
    ("㈀", "㋿"), ("㌀", "㏿"),
)

_13A_REGEX = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)


class _SacreBLEUTokenizer:
    """The sacrebleu tokenizer family.

    The `intl` tokenizer is implemented with unicodedata category checks
    (`P*`/`S*`/`N*`) instead of the `regex` wheel's \\p classes.
    """

    def __init__(self, tokenize: str, lowercase: bool = False) -> None:
        self._check_tokenizers_validity(tokenize)
        self.tokenize_fn = getattr(self, "_tokenize_" + {"none": "base", "13a": "13a", "zh": "zh", "intl": "international", "char": "char"}[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        return self._lower(self.tokenize_fn(line), self.lowercase).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        cls._check_tokenizers_validity(tokenize)
        fn = getattr(cls, "_tokenize_" + {"none": "base", "13a": "13a", "zh": "zh", "intl": "international", "char": "char"}[tokenize])
        return cls._lower(fn(line), lowercase).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for _re, repl in _13A_REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        return any(start <= uchar <= end for start, end in _UCODE_RANGES)

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        parts = []
        for ch in line:
            if cls._is_chinese_char(ch):
                parts.append(f" {ch} ")
            else:
                parts.append(ch)
        return cls._tokenize_regex("".join(parts))

    @staticmethod
    def _sub_pairs(line: str, rule: str) -> str:
        """One non-overlapping left-to-right pass of the reference's intl
        regex rules, expressed with
        unicodedata category checks instead of the `regex` wheel's \\p
        classes. ``rule``: "nonnum_punct" = (\\P{N})(\\p{P}) -> "\\1 \\2 ",
        "punct_nonnum" = (\\p{P})(\\P{N}) -> " \\1 \\2", "symbol" =
        (\\p{S}) -> " \\1 "."""
        cat = unicodedata.category
        out: List[str] = []
        i = 0
        n = len(line)
        while i < n:
            ch = line[i]
            if rule == "symbol":
                if cat(ch).startswith("S"):
                    out.append(f" {ch} ")
                else:
                    out.append(ch)
                i += 1
                continue
            if i + 1 < n:
                nxt = line[i + 1]
                if rule == "nonnum_punct" and not cat(ch).startswith("N") and cat(nxt).startswith("P"):
                    out.append(f"{ch} {nxt} ")
                    i += 2
                    continue
                if rule == "punct_nonnum" and cat(ch).startswith("P") and not cat(nxt).startswith("N"):
                    out.append(f" {ch} {nxt}")
                    i += 2
                    continue
            out.append(ch)
            i += 1
        return "".join(out)

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        # three cascaded passes, exactly the reference's rule order — spaces
        # inserted by earlier passes participate in later ones (space is
        # \P{N}), which a single char loop cannot reproduce
        line = cls._sub_pairs(line, "nonnum_punct")
        line = cls._sub_pairs(line, "punct_nonnum")
        line = cls._sub_pairs(line, "symbol")
        return " ".join(line.split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(ch for ch in line)

    @staticmethod
    def _lower(line: str, lowercase: bool) -> str:
        return line.lower() if lowercase else line

    @classmethod
    def _check_tokenizers_validity(cls, tokenize: str) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(
                f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}."
                " (`ja-mecab`/`ko-mecab`/`flores*` require external tokenizer wheels not bundled here.)"
            )


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """SacreBLEU: BLEU after one of the standard tokenizers, on ``device``
    (default: the current CUDA device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import sacre_bleu_score
        >>> preds = ["the cat sat on the mat"]
        >>> target = [["a cat sat on the mat"]]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    device = _text_device(device)
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram
    tokenize_fn = partial(_SacreBLEUTokenizer.tokenize, tokenize=tokenize, lowercase=lowercase)
    target_ = [[t] if isinstance(t, str) else t for t in target]
    return _corpus_bleu(preds, target_, n_gram, smooth, weights, tokenize_fn, device)
