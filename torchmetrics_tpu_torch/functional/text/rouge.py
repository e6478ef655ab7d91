"""ROUGE score: rouge1 to rouge9, rougeL and rougeLsum.

The google-research rouge_scorer's definitions: per-sentence precision,
recall and F-measure, several references accumulated by the best F-measure
of the first key or by their average. The LCS lengths and clipped n-gram
overlaps of a whole batch each go through one native call. rougeLsum splits
sentences with a regex splitter (``nltk``'s is not bundled); a custom
splitter can be passed through the ``sentence_splitter`` hook.

Sentence scores are host floats; an update's reach the device as one float64
tensor, and the corpus value is their float64 mean rounded to float32, as the
JAX package forms it on the host.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.helper import _text_device
from torchmetrics_tpu_torch.native import batch_lcs, batch_ngram_hits_multi, lcs_length

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1, "rouge2": 2, "rouge3": 3, "rouge4": 4, "rouge5": 5,
    "rouge6": 6, "rouge7": 7, "rouge8": 8, "rouge9": 9, "rougeL": "L", "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+")


def _split_sentence(x: str) -> Sequence[str]:
    """Regex sentence splitter (stand-in for nltk.sent_tokenize, rouge.py:62-71)."""
    x = re.sub("<n>", "", x)
    return [s for s in _SENTENCE_RE.split(x.strip()) if s]


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    """precision/recall/fmeasure triple.

    Plain floats: scores are per-sentence host values (hundreds per call), so
    materialising a device scalar each would dominate the runtime; they become
    one array at aggregation time.
    """
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    fmeasure = 2 * precision * recall / (precision + recall)
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def _lcs_table(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> List[List[int]]:
    table = [[0] * (len(target_tokens) + 1) for _ in range(len(pred_tokens) + 1)]
    for i in range(1, len(pred_tokens) + 1):
        for j in range(1, len(target_tokens) + 1):
            if pred_tokens[i - 1] == target_tokens[j - 1]:
                table[i][j] = table[i - 1][j - 1] + 1
            else:
                table[i][j] = max(table[i - 1][j], table[i][j - 1])
    return table


def _lcs(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    """Length of the longest common subsequence.

    The native library's LCS; the Python DP table is built only where a
    backtracked LCS is needed (rougeLsum).
    """
    return lcs_length(pred_tokens, target_tokens)


def _backtracked_lcs_indices(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> List[int]:
    """Indices into target of one LCS."""
    table = _lcs_table(pred_tokens, target_tokens)
    i, j = len(pred_tokens), len(target_tokens)
    indices: List[int] = []
    while i > 0 and j > 0:
        if pred_tokens[i - 1] == target_tokens[j - 1]:
            indices.append(j - 1)
            i -= 1
            j -= 1
        elif table[i - 1][j] >= table[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return indices[::-1]


def _union_lcs(pred_tokens_list: Sequence[Sequence[str]], target_tokens: Sequence[str]) -> Sequence[str]:
    """Tokens of the union-LCS of a target sentence vs all pred sentences (rouge.py:144-163)."""
    union: set = set()
    for pred_tokens in pred_tokens_list:
        union |= set(_backtracked_lcs_indices(pred_tokens, target_tokens))
    return [target_tokens[i] for i in sorted(union)]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """Lowercase alnum normalization + split + optional stemming (rouge.py:166-199)."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _rouge_l_score(pred: Sequence[str], target: Sequence[str], lcs: Optional[int] = None) -> Dict[str, float]:
    """Rouge-L triple.

    ``lcs`` carries a precomputed LCS length from the batched native kernel
    (see ``_rouge_score_update``); without it the per-pair path is used.
    """
    pred_len, target_len = len(pred), len(target)
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return _compute_metrics(lcs if lcs is not None else _lcs(pred, target), pred_len, target_len)


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Dict[str, float]:
    """Rouge-Lsum via union-LCS over sentences."""
    pred_len = sum(map(len, pred))
    target_len = sum(map(len, target))
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}

    def _get_token_counts(sentences: Sequence[Sequence[str]]) -> Counter:
        ngrams: Counter = Counter()
        for sentence in sentences:
            ngrams.update(sentence)
        return ngrams

    pred_tokens_count = _get_token_counts(pred)
    target_tokens_count = _get_token_counts(target)
    hits = 0
    for tgt in target:
        lcs = _union_lcs(pred, tgt)
        for token in lcs:
            if pred_tokens_count[token] > 0 and target_tokens_count[token] > 0:
                hits += 1
                pred_tokens_count[token] -= 1
                target_tokens_count[token] -= 1
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    sentence_splitter: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sentence scores with multi-ref accumulation.

    Two passes: tokenize every (pred, target) pair first, so the ROUGE-L LCS
    lengths for the whole batch go through ONE native kernel crossing
    (native/edit_distance.cpp:tm_lcs_batch) instead of a Python DP per pair.
    """
    split_fn = sentence_splitter or _split_sentence
    results: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}

    def _tok(text: str) -> Sequence[str]:
        return _normalize_and_tokenize_text(text, stemmer, normalizer, tokenizer)

    tokenized: List[Tuple[Sequence[str], List[Sequence[str]], List[Tuple[Sequence[str], List[Sequence[str]]]]]] = []
    for pred_raw, target_raw in zip(preds, target):
        target_list = [target_raw] if isinstance(target_raw, str) else list(target_raw)
        pred = _tok(pred_raw)
        pred_lsum: List[Sequence[str]] = []
        if "Lsum" in rouge_keys_values:
            pred_lsum = [_tok(s) for s in split_fn(pred_raw)]
        tgt_entries: List[Tuple[Sequence[str], List[Sequence[str]]]] = []
        for target_raw_inner in target_list:
            tgt = _tok(target_raw_inner)
            tgt_lsum: List[Sequence[str]] = []
            if "Lsum" in rouge_keys_values:
                tgt_lsum = [_tok(s) for s in split_fn(target_raw_inner)]
            tgt_entries.append((tgt, tgt_lsum))
        tokenized.append((pred, pred_lsum, tgt_entries))

    # the LCS lengths and clipped n-gram overlaps for the whole batch each go
    # through ONE native kernel crossing; results are indexed by pair position
    # so repeated keys in rouge_keys_values read the same precomputed entry
    all_pairs = [(pred, tgt) for pred, _, tgt_entries in tokenized for tgt, _ in tgt_entries]
    lcs_by_pair: List[Optional[int]] = []
    if "L" in rouge_keys_values:
        nonempty = [(a, b) for a, b in all_pairs if a and b]
        it = iter(batch_lcs(nonempty).tolist())
        lcs_by_pair = [int(next(it)) if (a and b) else None for a, b in all_pairs]

    ngram_by_pair: Dict[int, List[Tuple[int, int, int]]] = {}
    int_keys = sorted({k for k in rouge_keys_values if isinstance(k, int)})
    if int_keys:
        per_n = batch_ngram_hits_multi(all_pairs, int_keys)
        for n in int_keys:
            ngram_by_pair[n] = list(zip(*(arr.tolist() for arr in per_n[n])))

    pair_idx = 0
    for pred, pred_lsum, tgt_entries in tokenized:
        list_results: List[Dict[Union[int, str], Dict[str, float]]] = []
        for tgt, tgt_lsum in tgt_entries:
            result_inner: Dict[Union[int, str], Dict[str, float]] = {}
            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    hits, pred_len, target_len = ngram_by_pair[rouge_key][pair_idx]
                    if 0 in (pred_len, target_len):
                        score = {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
                    else:
                        score = _compute_metrics(hits, pred_len, target_len)
                elif rouge_key == "L":
                    score = _rouge_l_score(pred, tgt, lcs=lcs_by_pair[pair_idx])
                else:  # Lsum
                    score = _rouge_lsum_score(pred_lsum, tgt_lsum)
                result_inner[rouge_key] = score
            list_results.append(result_inner)
            pair_idx += 1

        if accumulate == "best":
            key_curr = rouge_keys_values[0]
            all_fmeasure = [float(v[key_curr]["fmeasure"]) for v in list_results]
            highest_idx = max(range(len(all_fmeasure)), key=all_fmeasure.__getitem__)
            for rouge_key in rouge_keys_values:
                results[rouge_key].append(list_results[highest_idx][rouge_key])
        elif accumulate == "avg":
            for rouge_key in rouge_keys_values:
                avg = {
                    t: sum(r[rouge_key][t] for r in list_results) / len(list_results)
                    for t in ("precision", "recall", "fmeasure")
                }
                results[rouge_key].append(avg)
        else:
            raise ValueError(f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}")
    return results


SCORE_KINDS = ("fmeasure", "precision", "recall")


def _rouge_sentence_tensor(
    sentence_results: Dict[Union[int, str], List[Dict[str, float]]], device: torch.device
) -> torch.Tensor:
    """An update's sentence scores as one float64 ``(keys x 3, sentences)``
    tensor on ``device`` (rows key-major, then :data:`SCORE_KINDS`), in one
    copy."""
    rows = [[score[t] for score in scores] for scores in sentence_results.values() for t in SCORE_KINDS]
    width = len(rows[0]) if rows else 0
    return torch.from_numpy(np.asarray(rows, dtype=np.float64).reshape(len(rows), width)).to(device)


def _rouge_score_compute(sentence_results: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The float64 mean of each key's sentence scores, rounded to float32
    (0 with none)."""
    return {
        k: v.to(torch.float64).mean().to(torch.float32) if v.numel() else torch.tensor(0.0, device=v.device)
        for k, v in sentence_results.items()
    }


def _check_rouge_keys(rouge_keys: Union[str, Tuple[str, ...]]) -> Tuple[str, ...]:
    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    return rouge_keys


def _rouge_inputs(preds: Any, target: Any) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    """Lists of predictions and of each one's references."""
    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    return preds, target


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Union[str, torch.device, None] = None,
) -> Dict[str, torch.Tensor]:
    """ROUGE score: ``{key_fmeasure, key_precision, key_recall}`` for each key,
    float32 scalars on ``device`` (default: the current CUDA device).

    Example:
        >>> from torchmetrics_tpu_torch.functional import rouge_score
        >>> preds = ["the cat sat on the mat"]
        >>> target = [["a cat sat on the mat"]]
        >>> result = rouge_score(preds, target, device="cpu")
        >>> round(float(result['rouge1_fmeasure']), 4)
        0.8333
    """
    device = _text_device(device)
    if use_stemmer:
        raise ValueError(
            "Stemming requires the `nltk` PorterStemmer which is not bundled; pass a custom `normalizer` instead."
        )
    rouge_keys = _check_rouge_keys(rouge_keys)
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
    preds, target = _rouge_inputs(preds, target)
    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate=accumulate, normalizer=normalizer, tokenizer=tokenizer,
    )
    scores = _rouge_sentence_tensor(sentence_results, device)
    names = [f"rouge{k}_{t}" for k in sentence_results for t in SCORE_KINDS]
    return _rouge_score_compute(dict(zip(names, scores)))
