"""Bit-exact fingerprint folds of state segments: XOR and wrapping sum of words.

A fingerprint is the pair (XOR, sum mod 2**32) over a segment's 32-bit
words: a 4-byte element is one word, an 8-byte element two, and 1- and
2-byte elements (bools too) are zero-extended through their unsigned view.
A segment is a whole leaf of a state tree or one row of a stacked leaf's
leading axis (``integrity.py`` builds both from a tree). Both folds are
order-insensitive, so any schedule gives the same words as the JAX
package's fold (``torchmetrics_tpu/integrity.py:_device_leaf_fp``).

Two bodies behind the ``"fingerprint"`` entry of the dispatch seam
(``ops/kernels.py``):

- :func:`_fingerprint_cuda` launches ``csrc/fingerprint.cu``, one launch
  for every segment given (a table of pointer, unit count and width a
  segment, in the launch's parameters up to 128 segments); it serves every
  CUDA tensor and refuses what it cannot take;
- :func:`_fingerprint_reference`, the plain PyTorch version: XOR by halving
  ``bitwise_xor`` passes and the sum as an int64 sum of the widened words,
  masked to 32 bits, both in chunks of :data:`CHUNK_WORDS` words, with no
  ``uint32`` arithmetic (the CPU build has none). It serves CPU tensors and
  is the oracle the kernel is held against on the card.

The JAX package folds with XLA, not Pallas: this kernel replaces no Pallas
site.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.ops import kernels, native

#: launches of the CUDA kernel in this process (a plain counter that a run
#: resets and reads to show its main path went through the kernel)
launches = 0

#: words a plain-body pass takes at once: its temporaries stay below 512 MB
#: (the int64 widening of a chunk) whatever the leaf's size
CHUNK_WORDS = 1 << 26


#: segments whose table rides in the kernel's launch parameters
#: (``csrc/fingerprint.cu``, ``kInlineSegments``); a larger table is copied
INLINE_SEGMENTS = 128

_UNITS = {4: torch.int32, 2: torch.int16, 1: torch.uint8}


def _width(t: torch.Tensor) -> int:
    """The bytes of the unit the fold reads: 4 (int32 words) for elements of
    4 bytes or more, 2 (halfwords) for 2-byte elements, 1 for 1-byte
    elements and bools."""
    size = t.element_size()
    return 4 if size >= 4 else size


def _unit_view(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The flat contiguous leaf as the units the fold reads, and their width."""
    width = _width(t)
    if t.numel() == 0:  # an empty view has no stride to reinterpret
        return torch.empty(0, dtype=_UNITS[width], device=t.device), width
    return t.reshape(-1).view(_UNITS[width]), width


def _word_chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """The leaf's zero-extended 32-bit words as int32 chunks of at most
    :data:`CHUNK_WORDS` words."""
    units, width = _unit_view(t)
    for lo in range(0, units.numel(), CHUNK_WORDS):
        chunk = units[lo:lo + CHUNK_WORDS]
        if width == 2:
            chunk = chunk.to(torch.int32) & 0xFFFF
        elif width == 1:
            chunk = chunk.to(torch.int32)
        yield chunk


def _xor_fold(words: torch.Tensor) -> torch.Tensor:
    """XOR of an int32 vector by halving passes: a one-element tensor."""
    while words.numel() > 1:
        half = words.numel() // 2
        folded = torch.bitwise_xor(words[:half], words[half:2 * half])
        if words.numel() % 2:
            folded[:1].bitwise_xor_(words[-1:])
        words = folded
    return words


def _fingerprint_reference(*segments: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(S, 2)`` uint32 ``[xor, sum mod 2**32]`` of
    each segment, on the segments' device."""
    device = segments[0].device
    rows = []
    for seg in segments:
        xor = torch.zeros(1, dtype=torch.int32, device=device)
        total = torch.zeros((), dtype=torch.int64, device=device)
        for chunk in _word_chunks(seg.contiguous()):
            if chunk.numel():
                xor = torch.bitwise_xor(xor, _xor_fold(chunk))
                total = (total + (chunk.to(torch.int64) & 0xFFFFFFFF).sum()) & 0xFFFFFFFF
        rows.append(torch.stack([xor[0].to(torch.int64) & 0xFFFFFFFF, total]))
    both = torch.stack(rows)
    return torch.where(both >= 1 << 31, both - (1 << 32), both).to(torch.int32).view(torch.uint32)


@functools.lru_cache(maxsize=None)
def _entry() -> ctypes._CFuncPtr:
    """The kernel's C entry point, built and typed once."""
    fn = native.load("fingerprint").tm_fingerprint
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _refuse(segments: Sequence[torch.Tensor], device: int) -> None:
    """Raise the error that says why :func:`_fingerprint_cuda` cannot take
    these segments."""
    for i, seg in enumerate(segments):
        if seg.get_device() != device or device < 0:
            raise ValueError(
                f"fingerprint kernel takes segments on one CUDA device, got {seg.device} at segment {i}"
                f" (segment 0 on {segments[0].device})"
            )
        if not seg.is_contiguous():
            raise ValueError(f"fingerprint kernel takes contiguous segments; segment {i} is not (call .contiguous())")
    raise ValueError("fingerprint kernel: a segment of 4-byte words is not 4-byte aligned")


def _fingerprint_cuda(*segments: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/fingerprint.cu`` once for every segment, on
    ``torch.cuda.current_stream()``.

    Takes contiguous tensors of any dtype on one CUDA device; raises on
    anything else. Returns a fresh ``(S, 2)`` uint32 on that device. A
    segment table (pointer, units, width) of up to :data:`INLINE_SEGMENTS`
    segments rides in the launch's parameters; a larger one reaches the card
    by a pinned, non-blocking copy on the same stream. Either way the call
    never waits for the card."""
    global launches
    device = segments[0].get_device()
    table = []
    max_units = 0
    for seg in segments:
        if device < 0 or seg.get_device() != device or not seg.is_contiguous():
            _refuse(segments, device)
        width = _width(seg)
        units = seg.numel() * seg.element_size() // width
        if width == 4 and seg.data_ptr() % 4:
            _refuse(segments, device)
        table += (seg.data_ptr(), units, width)
        max_units = max(max_units, units)
    host_table, table_dev = None, None
    if len(segments) <= INLINE_SEGMENTS:
        host_table = (ctypes.c_int64 * len(table))(*table)
    else:
        table_dev = torch.tensor(table, dtype=torch.int64).pin_memory().to(device, non_blocking=True)
    out = torch.empty((len(segments), 2), dtype=torch.int32, device=device)
    err = _entry()(
        device, host_table, None if table_dev is None else table_dev.data_ptr(), len(segments), max_units,
        out.data_ptr(), native.current_stream(device),
    )
    if err != 0:
        raise RuntimeError(f"fingerprint kernel launch failed with CUDA error {err}")
    launches += 1
    return out.view(torch.uint32)


kernels.register_kernel(kernels.KernelSpec(name="fingerprint", reference=_fingerprint_reference, cuda=_fingerprint_cuda))


def fingerprint_segments(segments: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(S, 2)`` uint32 ``[xor, sum mod 2**32]`` of every segment in one
    dispatch (one kernel launch on the card); the device of the first
    segment picks the body. Segments must be contiguous.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.ops.fingerprint import fingerprint_segments
        >>> fingerprint_segments([torch.tensor([1, 2, 3], dtype=torch.int32), torch.ones(3, dtype=torch.bool)]).tolist()
        [[0, 6], [1, 3]]
    """
    if not segments:
        return torch.zeros((0, 2), dtype=torch.int32).view(torch.uint32)
    device = segments[0].device
    if any(seg.device != device for seg in segments):
        raise ValueError(f"fingerprint: segments lie on several devices ({sorted({str(s.device) for s in segments})})")
    return kernels.dispatch("fingerprint", *segments)
