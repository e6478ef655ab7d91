"""Fused top-k retrieval statistics over the padded query grid.

Every padded retrieval metric (functional/retrieval/_padded.py) evaluates on
one ``(Q, L)`` grid of targets in retrieval order. Precision@k, recall@k,
fall-out@k and hit-rate@k all read four masked row sums of that grid, which
one sweep gives together::

    [hits@k, total_relevant, inverse_hits@k, total_inverse]  per query.

Two bodies behind the ``"retrieval_topk_stats"`` entry of the dispatch seam
(ops/kernels.py):

- :func:`_topk_stats_cuda` launches the hand-written Hopper kernel in
  ``csrc/retrieval_topk_stats.cu`` (the port of the JAX package's Pallas
  kernel ``ops/topk_kernel.py:_topk_stats_pallas``); it serves every CUDA
  tensor;
- :func:`_topk_stats_reference`, the plain PyTorch version: the padded
  metrics' masked sums. It serves CPU tensors and is the oracle the kernel is
  held against on the card.

With 0/1 targets, which the metric paths validate, the sums are integers in
float32 and both bodies are bit-equal.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from torchmetrics_tpu_torch.ops import kernels, native

#: launches of the CUDA kernel in this process (a plain counter that a run
#: resets and reads to show its main path went through the kernel)
launches = 0


def _topk_stats_reference(ranked_target: torch.Tensor, counts: torch.Tensor, top_k: int) -> torch.Tensor:
    """Plain PyTorch version: ``(Q, L)`` targets and ``(Q,)`` counts ->
    ``(Q, 4)`` float32 ``[hits@k, total, inv_hits@k, inv_total]``, with
    ``k = min(top_k, count)`` (``top_k < 0``: the whole row)."""
    t = ranked_target.to(torch.float32)
    pos = torch.arange(t.shape[-1], device=t.device)[None, :]
    c = counts[:, None]
    k = c if top_k < 0 else torch.clamp(c, max=top_k)
    mask = (pos < k).to(t.dtype)
    inv = torch.where(pos < c, 1.0 - t, torch.zeros((), dtype=t.dtype, device=t.device))
    return torch.stack([(t * mask).sum(-1), t.sum(-1), (inv * mask).sum(-1), inv.sum(-1)], dim=1)


@functools.lru_cache(maxsize=None)
def _entry() -> ctypes._CFuncPtr:
    """The kernel's C entry point, built and typed once."""
    fn = native.load("retrieval_topk_stats").tm_retrieval_topk_stats
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _topk_stats_cuda(ranked_target: torch.Tensor, counts: torch.Tensor, top_k: int) -> torch.Tensor:
    """Launch ``csrc/retrieval_topk_stats.cu`` on ``torch.cuda.current_stream()``.

    Takes ``ranked_target`` float32 ``(Q, L)`` and ``counts`` int32 ``(Q,)``,
    both contiguous on one CUDA device; raises on anything else. Returns a
    fresh float32 ``(Q, 4)``; with ``Q == 0`` it returns it without a launch."""
    global launches
    if ranked_target.dtype != torch.float32 or counts.dtype != torch.int32:
        raise TypeError(
            "retrieval_topk_stats kernel takes float32 ranked targets and int32 counts,"
            f" got {ranked_target.dtype} and {counts.dtype}"
        )
    if ranked_target.ndim != 2 or tuple(counts.shape) != (ranked_target.shape[0],):
        raise ValueError(
            "retrieval_topk_stats kernel takes ranked targets (Q, L) and counts (Q,),"
            f" got {tuple(ranked_target.shape)} and {tuple(counts.shape)}"
        )
    if not (ranked_target.is_contiguous() and counts.is_contiguous()):
        raise ValueError("retrieval_topk_stats kernel takes contiguous ranked targets and counts")
    if ranked_target.device.type != "cuda" or counts.device != ranked_target.device:
        raise ValueError(
            "retrieval_topk_stats kernel takes ranked targets and counts on one CUDA device,"
            f" got {ranked_target.device} and {counts.device}"
        )
    q, length = ranked_target.shape
    out = torch.empty((q, 4), dtype=torch.float32, device=ranked_target.device)
    if q == 0:
        return out
    launch = _entry()
    with torch.cuda.device(ranked_target.device):
        stream = native.current_stream(ranked_target.device.index)
        err = launch(ranked_target.data_ptr(), counts.data_ptr(), out.data_ptr(), q, length, int(top_k), stream)
    if err != 0:
        raise RuntimeError(f"retrieval_topk_stats kernel launch failed with CUDA error {err}")
    launches += 1
    return out


kernels.register_kernel(
    kernels.KernelSpec(
        name="retrieval_topk_stats",
        reference=_topk_stats_reference,
        cuda=_topk_stats_cuda,
    )
)


def retrieval_topk_stats(ranked_target: torch.Tensor, counts: torch.Tensor, top_k: Optional[int]) -> torch.Tensor:
    """``(Q, 4)`` ``[hits@k, total_rel, inv_hits@k, total_inv]`` through the
    dispatch seam, memoized on the identity of ``(ranked_target, counts)``
    inside a :class:`~torchmetrics_tpu_torch.ops.kernels.shared_scope`, so
    metrics reading the same grid share one sweep. ``top_k=None`` takes each
    query's whole document list.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.ops.topk_kernel import retrieval_topk_stats
        >>> grid = torch.tensor([[1.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
        >>> retrieval_topk_stats(grid, torch.tensor([4, 3], dtype=torch.int32), top_k=2).tolist()
        [[1.0, 2.0, 1.0, 2.0], [1.0, 1.0, 1.0, 2.0]]
    """
    k = -1 if top_k is None else int(top_k)

    def build() -> torch.Tensor:
        return kernels.dispatch(
            "retrieval_topk_stats",
            ranked_target.to(torch.float32).contiguous(),
            counts.to(torch.int32).contiguous(),
            k,
        )

    return kernels.shared_result((ranked_target, counts), ("topk", k), build)
