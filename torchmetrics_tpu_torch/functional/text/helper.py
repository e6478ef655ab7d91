"""Host-side text helpers: tokenised edit distances, TER's traced
Levenshtein DP, n-gram counting and input checks.

Strings are host data: these helpers return plain Python or numpy numbers,
and the callers fold them into state on the metric's device once an update.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.native import batch_edit_distance
from torchmetrics_tpu_torch.native import edit_distance as _native_edit_distance

_INT_INFINITY = int(1e16)


def _text_device(device: Union[str, torch.device, None]) -> torch.device:
    """Where a string functional puts its result: the current CUDA device
    unless the caller names another (there is no input tensor to take it
    from)."""
    return resolve_device(device)


def _on_device(value: Any, device: torch.device, what: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A hook output on ``device``: a tensor there as it is (cast to
    ``dtype``), a tensor elsewhere refused, host data (numpy, lists) copied."""
    if isinstance(value, torch.Tensor):
        if value.device != device:
            raise RuntimeError(
                f"the model returned {what} on {value.device} but the metric runs on {device}; tensors are"
                " never copied across devices implicitly"
            )
        return value if dtype is None else value.to(dtype)
    value = np.asarray(value)
    if dtype is None and value.dtype == np.float64:
        dtype = torch.float32  # host floats are read as float32, as the JAX package reads them
    return torch.as_tensor(value, dtype=dtype).to(device)


def _batch_distances(preds: Sequence[str], target: Sequence[str], char_level: bool = False):
    """Tokenise every (pred, target) pair (words, or characters with
    ``char_level``) and run one batched native Levenshtein call. Returns
    (token pairs, int64 distances)."""
    if char_level:
        pairs = [(list(p_), list(t_)) for p_, t_ in zip(preds, target)]
    else:
        pairs = [(p_.split(), t_.split()) for p_, t_ in zip(preds, target)]
    return pairs, batch_edit_distance(pairs)


def _edit_distance(prediction_tokens: Sequence, reference_tokens: Sequence, substitution_cost: int = 1) -> int:
    """Levenshtein distance of two token sequences (the native library)."""
    return _native_edit_distance(prediction_tokens, reference_tokens, substitution_cost)


class _LevenshteinEditDistance:
    """Edit distance against a fixed reference with its full trace, for TER's
    shift search.

    sacrebleu's lib_ter DP: a beam of width 25 around the length-ratio
    pseudo-diagonal, ties preferring substitute/keep, then consuming a
    prediction token, then a reference token; the backtracked trace is then
    flipped, so that in the returned string ``'i'`` consumes a hypothesis
    token and ``'d'`` a reference token. The shift search reads alignments
    off this trace, so every tie is broken as the JAX package breaks it.

    ``__call__(pred_tokens) -> (distance, trace)``; trace characters:
    ``'e'`` keep, ``'s'`` substitute, ``'i'`` hypothesis, ``'d'`` reference.
    """

    _BEAM_WIDTH = 25
    _INF = _INT_INFINITY

    def __init__(self, reference_tokens: List[str], op_insert: int = 1, op_delete: int = 1, op_substitute: int = 1) -> None:
        self.reference_tokens = reference_tokens
        self.reference_len = len(reference_tokens)
        self.op_insert = op_insert
        self.op_delete = op_delete
        self.op_substitute = op_substitute

    def __call__(self, prediction_tokens: List[str]) -> Tuple[int, str]:
        m, n = len(prediction_tokens), self.reference_len
        # cells: (cost, op), op before the flip: 'd' consumes a prediction
        # token (a row step), 'i' a reference token
        dist = [[(self._INF, "?")] * (n + 1) for _ in range(m + 1)]
        dist[0] = [(j * self.op_insert, "i") for j in range(n + 1)]
        length_ratio = n / m if prediction_tokens else 1.0
        beam = (
            math.ceil(length_ratio / 2 + self._BEAM_WIDTH)
            if length_ratio / 2 > self._BEAM_WIDTH
            else self._BEAM_WIDTH
        )
        for i in range(1, m + 1):
            pseudo_diag = math.floor(i * length_ratio)
            min_j = max(0, pseudo_diag - beam)
            max_j = n + 1 if i == m else min(n + 1, pseudo_diag + beam)
            p_tok = prediction_tokens[i - 1]
            for j in range(min_j, max_j):
                if j == 0:
                    dist[i][j] = (dist[i - 1][j][0] + self.op_delete, "d")
                else:
                    if p_tok == self.reference_tokens[j - 1]:
                        cost_sub, op_sub = self.op_nothing, "e"
                    else:
                        cost_sub, op_sub = self.op_substitute, "s"
                    best = (dist[i - 1][j - 1][0] + cost_sub, op_sub)
                    cand = dist[i - 1][j][0] + self.op_delete
                    if cand < best[0]:
                        best = (cand, "d")
                    cand = dist[i][j - 1][0] + self.op_insert
                    if cand < best[0]:
                        best = (cand, "i")
                    dist[i][j] = best
        # backtrack, then flip i <-> d (rewrite b -> a instead of a -> b)
        trace = []
        i, j = m, n
        while i > 0 or j > 0:
            op = dist[i][j][1]
            trace.append(op)
            if op in ("e", "s"):
                i, j = i - 1, j - 1
            elif op == "d":
                i -= 1
            elif op == "i":
                j -= 1
            else:  # a cell the beam left unreached; no valid path ends there
                raise RuntimeError("edit-distance backtrack escaped the beam")
        flip = {"i": "d", "d": "i"}
        return dist[m][n][0], "".join(flip.get(op, op) for op in reversed(trace))

    @property
    def op_nothing(self) -> int:
        return 0


def _count_ngrams(tokens: Sequence, max_n: int) -> Counter:
    """Counts of every n-gram for n in [1, max_n]."""
    counter: Counter = Counter()
    for n in range(1, max_n + 1):
        for j in range(len(tokens) - n + 1):
            counter[tuple(tokens[j : j + n])] += 1
    return counter


def _ngram_counts_by_order(tokens: Sequence, max_n: int) -> Dict[int, Counter]:
    """N-gram counts by order: ``{n: Counter}`` for n in [1, max_n]."""
    out: Dict[int, Counter] = {n: Counter() for n in range(1, max_n + 1)}
    for n in range(1, max_n + 1):
        c = out[n]
        for j in range(len(tokens) - n + 1):
            c[tuple(tokens[j : j + n])] += 1
    return out


def _validate_text_inputs(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]
) -> Tuple[Sequence[str], Sequence[str]]:
    preds = [preds] if isinstance(preds, str) else list(preds)
    target = [target] if isinstance(target, str) else list(target)
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    return preds, target
