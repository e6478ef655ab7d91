"""SQuAD exact match and F1.

The official SQuAD v1.1 evaluation: answers normalised (lowercase, no
punctuation, no articles, single spaces), the best score over the reference
answers, corpus averages times 100. Host work; the state is three scalars
(the F1 sum, the exact-match sum, the question count) summed across
processes.
"""
from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _text_device
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

SINGLE_PRED_TYPE = Dict[str, str]
PREDS_TYPE = Union[SINGLE_PRED_TYPE, List[SINGLE_PRED_TYPE]]
SINGLE_TARGET_TYPE = Dict[str, Any]
TARGETS_TYPE = Union[SINGLE_TARGET_TYPE, List[SINGLE_TARGET_TYPE]]

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}


def _normalize_text(s: str) -> str:
    """Lowercase; strip punctuation, articles, extra whitespace (squad.py:41-58)."""

    def remove_articles(text: str) -> str:
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text: str) -> str:
        return " ".join(text.split())

    def remove_punc(text: str) -> str:
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    return white_space_fix(remove_articles(remove_punc(s.lower())))


def _get_tokens(s: str) -> List[str]:
    return [] if not s else _normalize_text(s).split()


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    """Token-overlap F1 for one answer pair."""
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    common = Counter(target_tokens) & Counter(predicted_tokens)
    num_same = sum(common.values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return (2 * precision * recall) / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(
    metric_fn: Callable[[str, str], float], prediction: str, ground_truths: List[str]
) -> float:
    """Best score over all reference answers."""
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(preds: PREDS_TYPE, targets: TARGETS_TYPE) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    """Validate + convert to the SQuAD dataset layout."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key string.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                f"Please make sure that 'answer' maps to a `SQuAD` format dictionary.\nSQuAD Format: {SQuAD_FORMAT}"
            )
    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    targets_dicts = [
        {"paragraphs": [{"qas": [{"answers": [{"text": t} for t in tgt["answers"]["text"]], "id": tgt["id"]}]}]}
        for tgt in targets
    ]
    return preds_dict, targets_dicts


def _squad_update(preds: Dict[str, str], target: List[Dict[str, Any]]) -> Tuple[float, float, int]:
    """The F1 and exact-match sums and the question count (host numbers)."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    return f1, exact_match, total


def _squad_compute(f1: torch.Tensor, exact_match: torch.Tensor, total: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Corpus averages times 100."""
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(
    preds: PREDS_TYPE, target: TARGETS_TYPE, device: Union[str, torch.device, None] = None
) -> Dict[str, torch.Tensor]:
    """SQuAD exact match and F1, float32 scalars on ``device`` (default: the
    current CUDA device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import squad
        >>> preds = [{"prediction_text": "the panda", "id": "1"}]
        >>> target = [{"answers": {"answer_start": [0], "text": ["the panda"]}, "id": "1"}]
        >>> result = squad(preds, target, device="cpu")
        >>> {k: round(float(v), 4) for k, v in result.items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    device = _text_device(device)
    preds_dict, target_dicts = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_dicts)
    sums = torch.tensor([f1, exact_match], dtype=torch.float32).to(device)
    return _squad_compute(sums[0], sums[1], torch.tensor(total, dtype=torch.int32, device=device))
