"""Data-manipulation utilities (``dim_zero_*`` reducers and ``select_topk``)."""
from __future__ import annotations

from typing import Any, List, Sequence, Union

import torch


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor]]) -> torch.Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    if isinstance(x, torch.Tensor):
        return x
    x = [torch.atleast_1d(torch.as_tensor(el)) for el in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    return torch.max(x, dim=0).values


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    return torch.min(x, dim=0).values


def _flatten(x: Sequence) -> list:
    """Flatten one level of nesting."""
    return [item for sublist in x for item in sublist]


def _flatten_dict(x: dict) -> tuple:
    """Flatten one level of nested dicts; returns (new_dict, duplicates_found)."""
    new_dict = {}
    duplicates = False
    for key, value in x.items():
        if isinstance(value, dict):
            for k, v in value.items():
                if k in new_dict:
                    duplicates = True
                new_dict[k] = v
        else:
            if key in new_dict:
                duplicates = True
            new_dict[key] = value
    return new_dict, duplicates


def to_onehot(label_tensor: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, ...) integer labels to (N, C, ...) int32 one-hot.

    Example:
        >>> import torch
        >>> to_onehot(torch.tensor([0, 2]), num_classes=3).tolist()
        [[1, 0, 0], [0, 0, 1]]
    """
    label_tensor = torch.as_tensor(label_tensor)
    classes = torch.arange(num_classes, device=label_tensor.device).reshape((1, num_classes) + (1,) * (label_tensor.ndim - 1))
    return (label_tensor.unsqueeze(1) == classes).to(torch.int32)


def to_categorical(x: torch.Tensor, argmax_dim: int = 1) -> torch.Tensor:
    """Probabilities or logits to integer labels by argmax.

    Example:
        >>> import torch
        >>> to_categorical(torch.tensor([[0.1, 0.7, 0.2], [0.6, 0.1, 0.3]])).tolist()
        [1, 0]
    """
    return torch.argmax(torch.as_tensor(x), dim=argmax_dim)


def allclose(tensor1: torch.Tensor, tensor2: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """``torch.allclose`` with ``tensor2`` cast to ``tensor1``'s dtype."""
    tensor1 = torch.as_tensor(tensor1)
    return bool(torch.allclose(tensor1, torch.as_tensor(tensor2, dtype=tensor1.dtype, device=tensor1.device), rtol=rtol, atol=atol))


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """int32 0/1 mask of the top-k entries along ``dim``; ``topk == 1`` takes
    the first maximum, as ``argmax`` does in both frameworks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utils.data import select_topk
        >>> select_topk(torch.tensor([[0.1, 0.7, 0.2], [0.6, 0.1, 0.3]]), topk=2).tolist()
        [[0, 1, 1], [1, 0, 1]]
    """
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.topk(prob_tensor, topk, dim=dim).indices
    return torch.zeros_like(prob_tensor, dtype=torch.int32).scatter_(dim, idx, 1)


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze every one-element tensor in a (nested) result to 0-d."""
    if isinstance(data, torch.Tensor):
        return data.squeeze() if data.numel() == 1 else data
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(v) for v in data)
    return data


def compact_scatter(bufs: Sequence[torch.Tensor], values: Sequence[torch.Tensor], valid: torch.Tensor, count: torch.Tensor):
    """Scatter a batch's VALID samples into fixed-capacity state buffers.

    Valid entries go to contiguous slots starting at ``count``; invalid ones
    and those past the end of the buffer are dropped. The sentinel is the
    buffer's actual length, so buffers that grew by concatenation still
    scatter safely. Nothing reads back to the host: dropped entries land in
    one spare slot that is cut off. Returns ``(new_bufs, new_count)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utils.data import compact_scatter
        >>> (buf,), count = compact_scatter([torch.zeros(3)], [torch.tensor([1.0, 2.0, 3.0])],
        ...                                 torch.tensor([True, False, True]), torch.tensor(0))
        >>> buf.tolist(), int(count)
        ([1.0, 3.0, 0.0], 2)
    """
    v = valid.reshape(-1)
    sentinel = bufs[0].shape[0]
    positions = torch.where(v, count + torch.cumsum(v.to(torch.int64), 0) - 1, torch.full_like(v, sentinel, dtype=torch.int64))
    positions = torch.clamp(positions, max=sentinel)
    new_bufs = []
    for b, x in zip(bufs, values):
        spare = torch.cat([b, b.new_zeros((1,))])
        spare.scatter_(0, positions, x.reshape(-1).to(b.dtype))
        new_bufs.append(spare[:sentinel])
    return new_bufs, count + v.sum().to(count.dtype)


def compact_readout(bufs: Sequence[torch.Tensor], valid_buffer: torch.Tensor, sample_count: torch.Tensor, owner: str):
    """Read capacity buffers: warn when more valid samples arrived than the
    buffers hold, and return the filled rows of each buffer."""
    from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

    if int(sample_count) > valid_buffer.shape[0]:
        rank_zero_warn(
            f"{owner} capacity buffer overflowed: saw {int(sample_count)} valid samples"
            f" but kept the first {valid_buffer.shape[0]}.",
            UserWarning,
        )
    return [b[valid_buffer] for b in bufs]
