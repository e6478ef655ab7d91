"""The n-gram and edit-distance text metrics as classes: BLEU, SacreBLEU,
chrF, TER, EditDistance and ExtendedEditDistance.

Corpus statistics are dense sum states on the metric's device; per-sentence
scores are list states with one tensor an update (concatenated across
processes). Counting is host work, and an update's counts or sentence scores
reach the device in one copy.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.bleu import (
    AVAILABLE_TOKENIZERS,
    _bleu_counts,
    _bleu_score_compute,
    _bleu_score_update,
    _SacreBLEUTokenizer,
    _tokenize_fn,
)
from torchmetrics_tpu_torch.functional.text.chrf import _chrf_score_compute, _chrf_score_update, _chrf_split
from torchmetrics_tpu_torch.functional.text.edit import (
    _edit_distance_compute,
    _edit_distance_update,
    _eed_compute,
    _eed_update,
)
from torchmetrics_tpu_torch.functional.text.ter import (
    _check_ter_flags,
    _ter_compute,
    _ter_sentence_scores,
    _ter_update,
    _TercomTokenizer,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


class BLEUScore(Metric):
    """Corpus BLEU, accumulated over updates.

    Example:
        >>> from torchmetrics_tpu_torch.text import BLEUScore
        >>> bleu = BLEUScore(device="cpu")
        >>> bleu.update(["the cat sat on the mat"], [["a cat sat on the mat"]])
        >>> round(float(bleu.compute()), 4)
        0.7598
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram
        self.tokenizer = _tokenize_fn

        self.add_state("preds_len", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_len", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(n_gram), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        p_len, t_len, num, den = _bleu_score_update(preds_, target_, self.n_gram, self.tokenizer)
        numerator, denominator = _bleu_counts(num, den, self.device)
        self.preds_len = self.preds_len + p_len
        self.target_len = self.target_len + t_len
        self.numerator = self.numerator + numerator
        self.denominator = self.denominator + denominator

    def compute(self) -> torch.Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator,
            self.n_gram, self.weights, self.smooth,
        )


class SacreBLEUScore(BLEUScore):
    """SacreBLEU: BLEU after one of the standard tokenizers.

    Example:
        >>> from torchmetrics_tpu_torch.text import SacreBLEUScore
        >>> bleu = SacreBLEUScore(tokenize="13a", device="cpu")
        >>> bleu.update(["the cat sat on the mat"], [["a cat sat on the mat"]])
        >>> round(float(bleu.compute()), 4)
        0.7598
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self.tokenizer = partial(_SacreBLEUTokenizer.tokenize, tokenize=tokenize, lowercase=lowercase)


class CHRFScore(Metric):
    """chrF / chrF++ score: six dense per-order sum states, and the sentence
    scores (one float32 tensor an update) with
    ``return_sentence_level_score``.

    Example:
        >>> from torchmetrics_tpu_torch.text import CHRFScore
        >>> chrf = CHRFScore(device="cpu")
        >>> chrf.update(["the cat sat on the mat"], [["a cat sat on the mat"]])
        >>> round(float(chrf.compute()), 4)
        0.8713
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    _TOTALS = (
        "total_preds_char_n_grams", "total_preds_word_n_grams",
        "total_target_char_n_grams", "total_target_word_n_grams",
        "total_matching_char_n_grams", "total_matching_word_n_grams",
    )

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)

        for name, order in zip(self._TOTALS, (n_char_order, n_word_order) * 3):
            self.add_state(name, torch.zeros(order), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_chrf_score", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        totals, sentence_scores = _chrf_score_update(
            preds, target, self.n_char_order, self.n_word_order, self.n_order,
            self.beta, self.lowercase, self.whitespace,
        )
        stats = _chrf_split(torch.from_numpy(totals).to(self.device), self.n_char_order, self.n_word_order)
        for name, value in zip(self._TOTALS, stats):
            setattr(self, name, getattr(self, name) + value)
        if self.return_sentence_level_score and sentence_scores:
            scores = torch.tensor(sentence_scores, dtype=torch.float32).to(self.device)
            self.sentence_chrf_score = [*self.sentence_chrf_score, scores]

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        corpus = _chrf_score_compute(*(getattr(self, name) for name in self._TOTALS), self.n_order, self.beta)
        if self.return_sentence_level_score:
            return corpus, dim_zero_cat(self.sentence_chrf_score)
        return corpus


class TranslationEditRate(Metric):
    """Translation Edit Rate: total edits and reference length as sum
    states, and the sentence scores (one float32 tensor an update) with
    ``return_sentence_level_score``.

    Example:
        >>> from torchmetrics_tpu_torch.text import TranslationEditRate
        >>> ter = TranslationEditRate(device="cpu")
        >>> ter.update(["the cat sat on the mat"], [["a cat sat on the mat"]])
        >>> round(float(ter.compute()), 4)
        0.1667
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_ter_flags(normalize, no_punctuation, lowercase, asian_support)
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", torch.tensor(0.0), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        edits, lengths = _ter_update(preds, target, self.tokenizer)
        self.total_num_edits = self.total_num_edits + sum(edits)
        self.total_tgt_length = self.total_tgt_length + sum(lengths)
        if self.return_sentence_level_score and edits:
            self.sentence_ter = [*self.sentence_ter, _ter_sentence_scores(edits, lengths, self.device)]

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        corpus = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return corpus, dim_zero_cat(self.sentence_ter)
        return corpus


class EditDistance(Metric):
    """Character-level Levenshtein distance, reduced over updates: a float32
    sum and an int32 count, or (``reduction="none"``) the int32 distances, one
    tensor an update.

    Example:
        >>> from torchmetrics_tpu_torch.text import EditDistance
        >>> ed = EditDistance(device="cpu")
        >>> ed.update(["kitten"], ["sitting"])
        >>> float(ed.compute())
        3.0
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError(
                f"Expected argument `substitution_cost` to be a positive integer, but got {substitution_cost}"
            )
        allowed = ("mean", "sum", "none", None)
        if reduction not in allowed:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed}, but got {reduction}")
        self.substitution_cost = substitution_cost
        self.reduction = reduction

        if reduction == "none" or reduction is None:
            self.add_state("edit_scores_list", [], dist_reduce_fx="cat")
        else:
            self.add_state("edit_scores", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("num_elements", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        distance = _edit_distance_update(preds, target, self.substitution_cost)
        if self.reduction == "none" or self.reduction is None:
            scores = torch.from_numpy(distance.astype("int32")).to(self.device)
            self.edit_scores_list = [*self.edit_scores_list, scores]
        else:
            self.edit_scores = self.edit_scores + int(distance.sum())
            self.num_elements = self.num_elements + distance.size

    def compute(self) -> torch.Tensor:
        if self.reduction == "none" or self.reduction is None:
            if not self.edit_scores_list:
                return torch.tensor(0, dtype=torch.int32, device=self.device)
            return dim_zero_cat(self.edit_scores_list)
        return _edit_distance_compute(torch.atleast_1d(self.edit_scores), self.num_elements, self.reduction)


class ExtendedEditDistance(Metric):
    """Extended Edit Distance: the sentence scores as a list state (one
    float32 tensor an update), averaged at compute.

    Example:
        >>> from torchmetrics_tpu_torch.text import ExtendedEditDistance
        >>> eed = ExtendedEditDistance(device="cpu")
        >>> eed.update(["the cat sat on the mat"], [["a cat sat on the mat"]])
        >>> round(float(eed.compute()), 4)
        0.1452
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        for param, name in ((alpha, "alpha"), (rho, "rho"), (deletion, "deletion"), (insertion, "insertion")):
            if not isinstance(param, float) or param < 0:
                raise ValueError(f"Parameter `{name}` is expected to be a non-negative float.")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion
        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        if scores:
            self.sentence_eed = [*self.sentence_eed, torch.tensor(scores, dtype=torch.float32).to(self.device)]

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        scores = (
            dim_zero_cat(self.sentence_eed) if self.sentence_eed else torch.zeros(0, device=self.device)
        )
        corpus = _eed_compute(scores)
        if self.return_sentence_level_score:
            return corpus, dim_zero_cat(self.sentence_eed)
        return corpus
