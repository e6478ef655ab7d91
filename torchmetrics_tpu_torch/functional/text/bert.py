"""BERTScore with a pluggable embedding model.

Contextual embeddings of candidate and reference sentences, token-pair
cosine similarities, greedy matching, optionally IDF-weighted.

The model is a hook: ``user_model`` maps a list of sentences to
``(embeddings [N, L, D], mask [N, L])`` or to ``(embeddings, mask,
token_ids [N, L])``, whose ids align the IDF weights with subword positions.
It may return numpy arrays (copied to ``device``) or torch tensors, which
must already lie on ``device`` and are used in place. Without a hook, a
``transformers`` AutoModel runs on ``device`` from local weights only
(nothing is downloaded). The greedy match runs on ``device``, batched over
sentence pairs with one ``bmm``.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.helper import _on_device, _text_device


def _simple_tokenize(text: str) -> List[str]:
    return text.lower().split()


def _compute_idf(corpus: Sequence[str], tokenizer: Callable[[str], List[str]]) -> Dict[str, float]:
    """Smoothed IDF over the reference corpus."""
    num_docs = len(corpus)
    df: Counter = Counter()
    for doc in corpus:
        df.update(set(tokenizer(doc)))
    return {tok: math.log((num_docs + 1) / (cnt + 1)) for tok, cnt in df.items()}


def _host(value: Any) -> np.ndarray:
    """Token ids or a mask as a numpy array (ids are host data: the IDF
    table is built on the host)."""
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _greedy_cosine_scores(
    pred_emb: torch.Tensor,  # [N, Lp, D]
    pred_mask: torch.Tensor,  # [N, Lp] bool
    target_emb: torch.Tensor,  # [N, Lt, D]
    target_mask: torch.Tensor,  # [N, Lt] bool
    pred_idf: torch.Tensor,  # [N, Lp]
    target_idf: torch.Tensor,  # [N, Lt]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy-matched precision, recall and F1 of every sentence pair.

    Every candidate token matches its most similar reference token
    (precision) and vice versa (recall), IDF-weighted; padded pairs hold
    -1e9 and the weight sums are clamped at 1e-12.
    """
    pred_norm = pred_emb / torch.linalg.vector_norm(pred_emb, dim=-1, keepdim=True).clamp_min(1e-12)
    target_norm = target_emb / torch.linalg.vector_norm(target_emb, dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.bmm(pred_norm, target_norm.transpose(1, 2))  # [N, Lp, Lt]
    sim = torch.where(pred_mask[:, :, None] & target_mask[:, None, :], sim, -1e9)

    pred_w = pred_idf * pred_mask
    target_w = target_idf * target_mask
    precision = torch.sum(sim.amax(dim=2) * pred_w, dim=1) / torch.sum(pred_w, dim=1).clamp_min(1e-12)
    recall = torch.sum(sim.amax(dim=1) * target_w, dim=1) / torch.sum(target_w, dim=1).clamp_min(1e-12)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-12)
    return precision, recall, f1


def _default_transformers_embedder(
    model_name_or_path: str, max_length: int, device: torch.device
) -> Callable[[List[str]], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """A ``transformers`` encoder on ``device``, from local weights only.

    Returns ``(embeddings, mask, token_ids)``; special tokens ([CLS], [SEP],
    padding) are masked out of the matching.
    """
    try:
        from transformers import AutoModel, AutoTokenizer
    except ImportError as err:  # pragma: no cover
        raise ModuleNotFoundError(
            "`bert_score` needs either a `user_model` callable or the `transformers` package with local weights."
        ) from err
    tok = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
    model = AutoModel.from_pretrained(model_name_or_path, local_files_only=True).to(device)
    model.eval()
    special_ids = torch.tensor(sorted(set(tok.all_special_ids)), device=device)

    def embed(sentences: List[str]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        enc = tok(sentences, return_tensors="pt", padding=True, truncation=True, max_length=max_length).to(device)
        with torch.no_grad():
            out = model(**enc).last_hidden_state
        ids = enc["input_ids"]
        mask = enc["attention_mask"].bool() & ~torch.isin(ids, special_ids)
        return out, mask, ids

    return embed


def _id_idf(target_ids: np.ndarray, target_mask: np.ndarray, num_docs: int) -> Callable[[np.ndarray], np.ndarray]:
    """IDF keyed by the model's token ids over the reference corpus, mapped
    onto each position by its own id (unseen ids: log(N + 1))."""
    df: Counter = Counter()
    for row, mrow in zip(target_ids, target_mask):
        df.update(set(row[mrow].tolist()))
    default_idf = math.log(num_docs + 1)
    idf_map = {tid: math.log((num_docs + 1) / (cnt + 1)) for tid, cnt in df.items()}

    def ids_to_idf(ids_mat: np.ndarray) -> np.ndarray:
        uniq, inverse = np.unique(ids_mat, return_inverse=True)
        values = np.asarray([idf_map.get(int(t), default_idf) for t in uniq], dtype=np.float32)
        return values[inverse].reshape(ids_mat.shape)

    return ids_to_idf


def bert_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Any] = None,
    user_model: Optional[Callable[[List[str]], Tuple[Any, Any]]] = None,
    user_tokenizer: Optional[Callable[[str], List[str]]] = None,
    verbose: bool = False,
    idf: bool = False,
    max_length: int = 512,
    batch_size: int = 64,
    rescale_with_baseline: bool = False,
    baseline: Optional[Any] = None,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, torch.Tensor]:
    """BERTScore precision, recall and F1 of every sentence pair, on
    ``device`` (default: the current CUDA device).

    Args:
        preds: candidate sentence(s).
        target: reference sentence(s).
        user_model: callable ``sentences -> (embeddings [N, L, D], mask [N, L])``
            or ``(embeddings, mask, token_ids [N, L])``; torch tensors must
            lie on ``device``.
        model_name_or_path: ``transformers`` model id or path of the default
            embedder (local files only).
        idf: weight token matches by the reference corpus' IDF.
        rescale_with_baseline: linear rescale ``(s - b) / (1 - b)`` with the
            given ``baseline`` triple (precision, recall, F1).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import bert_score
        >>> def user_model(sentences):  # a toy embedder: one-hot words
        ...     vocab = {w: i for i, w in enumerate(sorted({w for s in sentences for w in s.split()}))}
        ...     width = max(len(s.split()) for s in sentences)
        ...     emb = torch.zeros(len(sentences), width, len(vocab))
        ...     mask = torch.zeros(len(sentences), width, dtype=torch.bool)
        ...     for i, s in enumerate(sentences):
        ...         for j, w in enumerate(s.split()):
        ...             emb[i, j, vocab[w]] = 1.0
        ...             mask[i, j] = True
        ...     return emb, mask
        >>> out = bert_score(["the cat sat"], ["the cat sat"], user_model=user_model, device="cpu")
        >>> [round(float(out[k][0]), 4) for k in ("precision", "recall", "f1")]
        [1.0, 1.0, 1.0]
    """
    device = _text_device(device)
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [target] if isinstance(target, str) else list(target)
    if len(preds_l) != len(target_l):
        raise ValueError(f"Number of predicted and reference sentences must match: {len(preds_l)} != {len(target_l)}")
    if not preds_l:
        empty = torch.zeros(0, device=device)
        return {"precision": empty, "recall": empty.clone(), "f1": empty.clone()}

    if user_model is None:
        user_model = _default_transformers_embedder(model_name_or_path or "roberta-large", max_length, device)

    pred_out = user_model(preds_l)
    target_out = user_model(target_l)
    pred_emb = _on_device(pred_out[0], device, "embeddings")
    target_emb = _on_device(target_out[0], device, "embeddings")
    pred_mask = _on_device(pred_out[1], device, "a mask", torch.bool)
    target_mask = _on_device(target_out[1], device, "a mask", torch.bool)

    if not idf:
        pred_idf = torch.ones(pred_emb.shape[:2], device=device)
        target_idf = torch.ones(target_emb.shape[:2], device=device)
    elif len(pred_out) > 2 and len(target_out) > 2:
        ids_to_idf = _id_idf(_host(target_out[2]), _host(target_out[1]).astype(bool), len(target_l))
        pred_idf = torch.from_numpy(ids_to_idf(_host(pred_out[2]))).to(device)
        target_idf = torch.from_numpy(ids_to_idf(_host(target_out[2]))).to(device)
    else:
        # a 2-tuple hook: word-level IDF, positions following the
        # tokenizer's word order
        tok_fn = user_tokenizer or _simple_tokenize
        idf_map = _compute_idf(target_l, tok_fn)

        def idf_rows(sentences: List[str], width: int) -> torch.Tensor:
            rows = np.ones((len(sentences), width), dtype=np.float32)
            for r, sent in enumerate(sentences):
                for i, t in enumerate(tok_fn(sent)[:width]):
                    rows[r, i] = idf_map.get(t, math.log(len(target_l) + 1))
            return torch.from_numpy(rows).to(device)

        pred_idf = idf_rows(preds_l, pred_emb.shape[1])
        target_idf = idf_rows(target_l, target_emb.shape[1])

    p, r, f = _greedy_cosine_scores(pred_emb, pred_mask, target_emb, target_mask, pred_idf, target_idf)
    if rescale_with_baseline:
        if baseline is None:
            raise ValueError(
                "`rescale_with_baseline` requires a `baseline` array [precision_b, recall_b, f1_b]"
                " (baseline files are not downloaded; pass them explicitly)."
            )
        b = torch.as_tensor(np.asarray(_host(baseline)), dtype=torch.float32).to(device)
        p = (p - b[0]) / (1 - b[0])
        r = (r - b[1]) / (1 - b[1])
        f = (f - b[2]) / (1 - b[2])
    return {"precision": p, "recall": r, "f1": f}
