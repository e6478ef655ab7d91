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
float32 and both bodies are bit-equal. The kernel's wrapper is on the lean
launch path of ``ops/native.py``.
"""
from __future__ import annotations

import ctypes
import functools
import sys
from typing import Optional

import torch

from torchmetrics_tpu_torch.ops import kernels, launch_counts, native

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
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _refuse(ranked_target: torch.Tensor, counts: torch.Tensor) -> None:
    """Raise the error that says why :func:`_topk_stats_cuda` cannot take
    these arguments (its one combined test failed)."""
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
    raise ValueError(
        "retrieval_topk_stats kernel takes ranked targets and counts on one CUDA device,"
        f" got {ranked_target.device} and {counts.device}"
    )


def _fits(ranked_target: torch.Tensor, counts: torch.Tensor, device: int) -> bool:
    """The wrapper's one combined test: whether the kernel takes these
    arguments with both on ``device`` (a ``get_device()`` index)."""
    return (
        ranked_target.dtype is torch.float32 and counts.dtype is torch.int32
        and ranked_target.dim() == 2 and counts.dim() == 1 and counts.shape[0] == ranked_target.shape[0]
        and ranked_target.is_contiguous() and counts.is_contiguous() and counts.get_device() == device
    )


def _topk_stats_cuda(ranked_target: torch.Tensor, counts: torch.Tensor, top_k: int) -> torch.Tensor:
    """Launch ``csrc/retrieval_topk_stats.cu`` on ``torch.cuda.current_stream()``.

    Takes ``ranked_target`` float32 ``(Q, L)`` and ``counts`` int32 ``(Q,)``,
    both contiguous on one CUDA device; raises on anything else. Returns a
    fresh float32 ``(Q, 4)``; with ``Q == 0`` it returns it without a launch.
    The kernel picks the lanes that sum a row from L.

    The lean launch path: one combined test of the arguments (the detailed
    errors come from :func:`_refuse` only when it fails), the device guard in
    the C entry, the output the only allocation."""
    device = ranked_target.get_device()
    if device < 0 or not _fits(ranked_target, counts, device):
        _refuse(ranked_target, counts)
    q, length = ranked_target.shape
    out = torch.empty((q, 4), dtype=torch.float32, device=device)
    if q == 0:
        return out
    err = _entry()(
        device, ranked_target.data_ptr(), counts.data_ptr(), out.data_ptr(), q, length, top_k,
        native.current_stream(device),
    )
    if err != 0:
        raise RuntimeError(f"retrieval_topk_stats kernel launch failed with CUDA error {err}")
    launch_counts.add(sys.modules[__name__], "launches", 1)
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
        grid = ranked_target if ranked_target.dtype is torch.float32 else ranked_target.to(torch.float32)
        kept = counts if counts.dtype is torch.int32 else counts.to(torch.int32)
        return kernels.dispatch(
            "retrieval_topk_stats",
            grid if grid.is_contiguous() else grid.contiguous(),
            kept if kept.is_contiguous() else kept.contiguous(),
            k,
        )

    return kernels.shared_result((ranked_target, counts), ("topk", k), build)
