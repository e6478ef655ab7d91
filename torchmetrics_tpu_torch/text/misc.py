"""Perplexity, SQuAD and ROUGE as classes.

Perplexity's update runs on the device: a float32 sum of negative log
probabilities and an int32 token count. SQuAD keeps three sum states, fed
Python numbers from the host. ROUGE keeps one list state a key and score,
one float64 tensor of sentence scores an update, averaged in float64.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update
from torchmetrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    SCORE_KINDS,
    _check_rouge_keys,
    _rouge_inputs,
    _rouge_score_compute,
    _rouge_score_update,
    _rouge_sentence_tensor,
)
from torchmetrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat


class Perplexity(Metric):
    """Perplexity of a language model's token predictions, accumulated over
    updates on the metric's device (logits and targets must lie there).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import Perplexity
        >>> ppl = Perplexity(device="cpu")
        >>> ppl.update(torch.full((1, 4, 6), 1 / 6), torch.tensor([[0, 1, 2, 3]]))
        >>> round(float(ppl.compute()), 2)  # uniform over 6 tokens
        6.0
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("count", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        total_log_probs, count = _perplexity_update(torch.as_tensor(preds), torch.as_tensor(target), self.ignore_index)
        self.total_log_probs = self.total_log_probs + total_log_probs
        self.count = self.count + count

    def compute(self) -> torch.Tensor:
        return _perplexity_compute(self.total_log_probs, self.count)


class SQuAD(Metric):
    """SQuAD exact match and F1, accumulated over updates.

    Example:
        >>> from torchmetrics_tpu_torch.text import SQuAD
        >>> squad = SQuAD(device="cpu")
        >>> preds = [{"prediction_text": "the panda", "id": "1"}]
        >>> target = [{"answers": {"answer_start": [0], "text": ["the panda"]}, "id": "1"}]
        >>> squad.update(preds, target)
        >>> {k: float(v) for k, v in squad.compute().items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("exact_match", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        preds_dict, targets_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, targets_dict)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, torch.Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)


class ROUGEScore(Metric):
    """ROUGE, one list state a key and score (``rouge1_fmeasure``, ...).

    Example:
        >>> from torchmetrics_tpu_torch.text import ROUGEScore
        >>> rouge = ROUGEScore(rouge_keys="rouge1", device="cpu")
        >>> rouge.update(["the cat sat on the mat"], ["a cat sat on the mat"])
        >>> round(float(rouge.compute()["rouge1_fmeasure"]), 4)
        0.8333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if use_stemmer:
            raise ValueError(
                "Stemming requires the `nltk` PorterStemmer which is not bundled; pass a custom `normalizer` instead."
            )
        rouge_keys = _check_rouge_keys(rouge_keys)
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        for rouge_key in self.rouge_keys:
            for score in SCORE_KINDS:
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx="cat")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        preds, target = _rouge_inputs(preds, target)
        output = _rouge_score_update(
            preds, target, self.rouge_keys_values, accumulate=self.accumulate,
            normalizer=self.normalizer, tokenizer=self.tokenizer,
        )
        scores = _rouge_sentence_tensor(output, self.device)
        names = [f"rouge{k}_{t}" for k in output for t in SCORE_KINDS]
        for name, row in zip(names, scores):
            setattr(self, name, [*getattr(self, name), row])

    def compute(self) -> Dict[str, torch.Tensor]:
        empty = torch.zeros(0, dtype=torch.float64, device=self.device)
        return _rouge_score_compute({
            f"{rouge_key}_{score}": dim_zero_cat(values) if (values := getattr(self, f"{rouge_key}_{score}")) else empty
            for rouge_key in self.rouge_keys
            for score in SCORE_KINDS
        })
