"""Perplexity, the text metric that runs on the device.

``-log p[t] = logsumexp(logits) - logits[t]``: the gathered-logit identity
reads the (N, V) logits for one reduction per row and never writes a full
log-probability array. The log-sum-exp runs over row chunks of at most
:data:`_LSE_CHUNK_ELEMENTS` logits, so its (rows, V) temporary stays bounded
whatever the batch (1.65 GB of logits at GPT-2's vocabulary and a batch of
8 x 1,024 tokens); each row's value is the same as unchunked.

``ignore_index`` positions are masked out and gather index 0. A target
outside [0, V) that is not masked gathers a clamped index and its log
probability is written NaN (as JAX's out-of-range gather fills NaN), so it
poisons the total instead of faulting the device. The two outputs, a float32
sum and an int32 count, are summed across processes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: the most logits one log-sum-exp chunk reads (its temporary: 256 MiB of
#: float32)
_LSE_CHUNK_ELEMENTS = 1 << 26


def _check_shape_and_type_consistency(preds: torch.Tensor, target: torch.Tensor) -> None:
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if tuple(preds.shape[:2]) != tuple(target.shape):
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    if not preds.is_floating_point():
        raise TypeError(f"Input tensor `preds` is expected to be of floating point type but got {preds.dtype}.")
    if preds.is_complex() or target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of integer type but got {target.dtype}.")
    if target.device != preds.device:
        raise RuntimeError(
            f"Perplexity: `target` is on {target.device} but `preds` on {preds.device}; inputs are never"
            " copied across devices implicitly"
        )


def _logsumexp_rows(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` of every row of the float32 (N, V) logits, in row chunks
    of at most :data:`_LSE_CHUNK_ELEMENTS` elements."""
    rows = max(1, _LSE_CHUNK_ELEMENTS // max(1, logits.shape[1]))
    if logits.shape[0] <= rows:
        return torch.logsumexp(logits, dim=1)
    return torch.cat([torch.logsumexp(chunk, dim=1) for chunk in torch.split(logits, rows)])


def _perplexity_update(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sum of ``-log p[target]`` (float32) and the token count (int32)
    over the unmasked positions, on the inputs' device."""
    _check_shape_and_type_consistency(preds, target)
    logits = preds.reshape(-1, preds.shape[-1]).to(torch.float32)
    target_flat = target.reshape(-1)
    if ignore_index is not None:
        mask = target_flat != ignore_index
        target_flat = torch.where(mask, target_flat, 0)
    else:
        mask = torch.ones_like(target_flat, dtype=torch.bool)
    vocab = logits.shape[1]
    oob = (target_flat < 0) | (target_flat >= vocab)
    index = target_flat.clamp(0, max(vocab - 1, 0)).to(torch.int64)
    token_logits = torch.gather(logits, 1, index[:, None]).squeeze(1)
    token_logits = torch.where(oob, torch.nan, token_logits)
    total_log_probs = -torch.sum((token_logits - _logsumexp_rows(logits)) * mask)
    count = mask.sum(dtype=torch.int32)
    return total_log_probs, count


def _perplexity_compute(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The exponential of the mean negative log-likelihood."""
    return torch.exp(total / count)


def perplexity(preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None) -> torch.Tensor:
    """Perplexity of a language model's token predictions, on the inputs'
    device.

    Args:
        preds: logits of shape [batch_size, seq_len, vocab_size]
        target: token ids of shape [batch_size, seq_len], on ``preds``' device
        ignore_index: target id excluded from the score (e.g. padding)

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import perplexity
        >>> probs = torch.full((1, 4, 6), 1 / 6)
        >>> target = torch.tensor([[0, 1, 2, 3]])
        >>> round(float(perplexity(probs, target)), 4)
        6.0
    """
    total, count = _perplexity_update(torch.as_tensor(preds), torch.as_tensor(target), ignore_index)
    return _perplexity_compute(total, count)
