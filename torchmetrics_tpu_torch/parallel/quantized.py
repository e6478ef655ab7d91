"""Block-quantized collectives for metric state.

The counterpart of the JAX package's ``parallel/quantized.py`` on
``torch.distributed``. Float state crosses the wire as int8 or int16 codes
with one float32 max-abs scale per block, instead of float32:

- :func:`quantized_all_reduce`: the primitive behind
  ``sync_precision="quantized"``: every rank gathers every rank's codes and
  scales, dequantizes per source rank and applies the declared reduction
  (sum/mean/max/min), so the result is identical on every rank;
- :func:`quantized_all_gather`: the gather of float ``cat``/``None`` states;
- :func:`encode_canonical` / :func:`decode_canonical`: the host-side wire
  format of a folded state export.

Wire format (one tensor)::

    codes  : int8|int16, shape (ceil(size/block), block)   (zero-padded tail)
    scales : float32,    shape (ceil(size/block),)
    scale_b = max|x[block_b]| / (2**(bits-1) - 1)

The codes are computed in the JAX package's order of operations (float32
blocks, ``max(abs)``, divide by the scale, round half to even, clip), so
they are bit-equal to its codes. Rounding costs at most half a step an
element; :func:`reduce_error_bound` gives the bound of a reduction from the
stacked per-rank contributions.

Integer and bool states always sync exactly: :func:`block_encode` raises
``TypeError`` on them. FID's moment sums are float32 states in the port
(the float64 is formed at compute), so they quantize as any float32 state.
A float64 state is encoded through its float32 image and decoded back to
float64: the bound then holds up to that rounding (about 2^-24 of the
value), which the reference does not see because it has no float64 state.

Gloo carries int8 but refuses int16 ("Invalid scalar type"), so the codes
travel as a byte view (``uint8``, two bytes an int16 code) and are viewed
back on arrival; the scales ride beside them as float32. The bytes on the
wire are the same.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from torchmetrics_tpu_torch.parallel.sync import Reduction, sync_value

__all__ = [
    "DEFAULT_BITS",
    "DEFAULT_BLOCK",
    "SYNC_PRECISIONS",
    "SYNC_PRECISION_ENV",
    "block_decode",
    "block_encode",
    "decode_canonical",
    "default_sync_precision",
    "encode_canonical",
    "quantized_all_gather",
    "quantized_all_reduce",
    "quantized_sync",
    "quantized_wire_bytes",
    "reduce_error_bound",
    "state_wire_bytes",
    "wire_payload_bytes",
]

_INT_DTYPES = {8: torch.int8, 16: torch.int16}

#: env var holding the process-wide default sync precision ("exact" | "quantized")
SYNC_PRECISION_ENV = "TORCHMETRICS_TPU_SYNC_PRECISION"

SYNC_PRECISIONS = ("exact", "quantized")

#: default code width (bits) and block size (elements a scale)
DEFAULT_BITS = 8
DEFAULT_BLOCK = 256

#: a resolved per-state quantization spec: None = exact, else (bits, block)
QSpec = Optional[Tuple[int, int]]


def default_sync_precision() -> str:
    """The environment-configured sync precision (``TORCHMETRICS_TPU_SYNC_PRECISION``):
    ``"exact"`` (default) or ``"quantized"`` (every float state takes the
    block-quantized reduce; integer states stay exact regardless)."""
    raw = os.environ.get(SYNC_PRECISION_ENV, "").strip().lower()
    if not raw:
        return "exact"
    if raw not in SYNC_PRECISIONS:
        raise ValueError(f"{SYNC_PRECISION_ENV} must be one of {SYNC_PRECISIONS}, got {raw!r}")
    return raw


def _qmax(bits: int) -> float:
    if bits not in _INT_DTYPES:
        raise ValueError(f"bits must be one of {sorted(_INT_DTYPES)}, got {bits}")
    return float(2 ** (bits - 1) - 1)


def block_encode(x: torch.Tensor, bits: int = DEFAULT_BITS, block_size: int = DEFAULT_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-abs symmetric per-block quantization: ``(codes, scales)``.

    ``codes`` is ``(n_blocks, block_size)`` int8/int16 (zero-padded tail),
    ``scales`` ``(n_blocks,)`` float32, both on ``x``'s device. Raises
    ``TypeError`` on integer or bool input: counts never round.
    """
    qmax = _qmax(bits)
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if not x.is_floating_point():
        raise TypeError(
            f"block_encode: refusing to quantize non-float dtype {x.dtype}; integer-exact"
            " states (counts, bincounts) must take the exact reduce path"
        )
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block_size)
    absmax = blocks.abs().amax(dim=1) if blocks.shape[0] else blocks.new_zeros(0)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which rounds differently from the JAX package's division
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax), torch.ones_like(absmax)).to(torch.float32)
    codes = torch.clamp(torch.round(blocks / scales[:, None]), -qmax, qmax).to(_INT_DTYPES[bits])
    return codes, scales


def block_decode(codes: torch.Tensor, scales: torch.Tensor, size: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`block_encode`: dequantize, trim and restore shape
    and dtype. Leading axes of ``codes``/``scales`` (a per-rank stack) stay."""
    deq = codes.to(torch.float32) * scales.to(torch.float32)[..., None]
    return deq.reshape(tuple(deq.shape[:-2]) + (-1,))[..., :size].reshape(shape).to(dtype)


def _gather_codes(codes: torch.Tensor, scales: torch.Tensor, group: Any, timeout: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's codes and scales, stacked ``(W, n_blocks, block)`` and
    ``(W, n_blocks)``: two gathers through the sync module's seams."""
    from torchmetrics_tpu_torch.parallel import sync as _sync

    world = dist.get_world_size(group)
    # the codes travel as their bytes: gloo refuses int16 tensors
    payload = codes.contiguous().view(torch.uint8)
    g_codes = [torch.empty_like(payload) for _ in range(world)]
    g_scales = [torch.empty_like(scales) for _ in range(world)]
    w1 = _sync._all_gather(g_codes, payload, group)
    w2 = _sync._all_gather(g_scales, scales.contiguous(), group)
    _sync._wait(w1, timeout, "quantized code gather")
    _sync._wait(w2, timeout, "quantized scale gather")
    return torch.stack(g_codes).view(codes.dtype), torch.stack(g_scales)


def quantized_all_reduce(
    x: torch.Tensor,
    reduction: str = "sum",
    bits: int = DEFAULT_BITS,
    block_size: int = DEFAULT_BLOCK,
    group: Any = None,
    timeout: Optional[float] = None,
) -> torch.Tensor:
    """All-reduce ``x`` across ``group`` with int codes and per-block scales
    on the wire. Each rank encodes against its own scales; every rank
    gathers all codes and scales, dequantizes per source rank and applies
    ``reduction``. The result matches the exact collective within
    :func:`reduce_error_bound` and is identical on every rank."""
    if reduction not in ("sum", "mean", "max", "min"):
        raise ValueError(f"quantized_all_reduce supports sum/mean/max/min, got {reduction!r}")
    codes, scales = block_encode(x, bits=bits, block_size=block_size)
    g_codes, g_scales = _gather_codes(codes, scales, group, timeout)
    deq = g_codes.to(torch.float32) * g_scales[..., None]
    if reduction == "sum":
        acc = deq.sum(0)
    elif reduction == "mean":
        acc = deq.mean(0)
    elif reduction == "max":
        acc = deq.amax(0)
    else:
        acc = deq.amin(0)
    return acc.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


def quantized_all_gather(
    x: torch.Tensor,
    bits: int = DEFAULT_BITS,
    block_size: int = DEFAULT_BLOCK,
    group: Any = None,
    timeout: Optional[float] = None,
) -> torch.Tensor:
    """All-gather ``x`` (the same shape on every rank) with an int payload:
    ``(W, *x.shape)``, each element within half a step of its block's scale."""
    x = torch.atleast_1d(x)
    codes, scales = block_encode(x, bits=bits, block_size=block_size)
    g_codes, g_scales = _gather_codes(codes, scales, group, timeout)
    return block_decode(g_codes, g_scales, x.numel(), (g_codes.shape[0],) + tuple(x.shape), x.dtype)


def reduce_error_bound(stacked: Any, reduction: str, bits: int = DEFAULT_BITS, block_size: int = DEFAULT_BLOCK) -> np.ndarray:
    """Elementwise bound on ``|quantized_reduce - exact_reduce|`` from the
    stacked per-rank contributions ``(W, *shape)`` (host float64)."""
    if isinstance(stacked, torch.Tensor):
        stacked = stacked.detach().cpu().numpy()
    arr = np.asarray(stacked, dtype=np.float64)
    world = arr.shape[0]
    flat = arr.reshape(world, -1)
    size = flat.shape[1]
    pad = (-size) % block_size
    blocks = np.pad(flat, ((0, 0), (0, pad))).reshape(world, -1, block_size)
    absmax = np.abs(blocks).max(axis=2)
    per_shard = absmax / (2.0 * _qmax(bits))
    if reduction == "sum":
        per_block = per_shard.sum(axis=0)
    elif reduction == "mean":
        per_block = per_shard.mean(axis=0)
    else:  # max/min: the winning rank is off by at most its own half step
        per_block = per_shard.max(axis=0)
    per_elem = np.repeat(per_block, block_size)[:size]
    return per_elem.reshape(arr.shape[1:])


#: bytes of one float32 scale on the wire
_SCALE_BYTES = 4


def quantized_wire_bytes(num_elements: int, bits: int, block_size: int) -> Dict[str, int]:
    """Payload bytes one rank sends for ``num_elements`` quantized values:
    ``{"codes", "scales", "total"}``."""
    n_blocks = -(-int(num_elements) // int(block_size))
    codes = n_blocks * block_size * (bits // 8)
    scales = n_blocks * _SCALE_BYTES
    return {"codes": codes, "scales": scales, "total": codes + scales}


def _is_float_dtype(dtype: Any) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return bool(np.issubdtype(np.dtype(dtype), np.floating))


def state_wire_bytes(
    states: Dict[str, Any],
    reductions: Dict[str, Reduction],
    qspecs: Optional[Dict[str, QSpec]] = None,
) -> Dict[str, int]:
    """Bytes one rank sends to sync ``states`` once, from shapes and dtypes
    alone: ``{"exact", "codes", "scales", "total"}``."""
    out = {"exact": 0, "codes": 0, "scales": 0}
    for name, value in states.items():
        for v in value if isinstance(value, (list, tuple)) else [value]:
            if not hasattr(v, "dtype"):
                v = np.asarray(v)
            size = int(np.prod(tuple(v.shape))) if len(tuple(v.shape)) else 1
            itemsize = v.element_size() if isinstance(v, torch.Tensor) else np.dtype(v.dtype).itemsize
            q = (qspecs or {}).get(name)
            if q is not None and _is_float_dtype(v.dtype):
                qb = quantized_wire_bytes(size, *q)
                out["codes"] += qb["codes"]
                out["scales"] += qb["scales"]
            else:
                out["exact"] += size * itemsize
    out["total"] = out["exact"] + out["codes"] + out["scales"]
    return out


#: wire-format version stamp of every encoded payload
WIRE_VERSION = 1


def encode_canonical(
    states: Dict[str, Any],
    qspecs: Optional[Dict[str, QSpec]] = None,
    bits: int = DEFAULT_BITS,
    block_size: int = DEFAULT_BLOCK,
) -> Dict[str, Any]:
    """Encode a folded host state into the uplink wire format: float fields
    marked quantized (by ``qspecs``, or every float field when it is None)
    become codes and scales; integer and bool fields ride raw."""
    fields: Dict[str, Any] = {}
    for name, value in states.items():
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        q = qspecs.get(name, None) if qspecs is not None else (bits, block_size)
        if q is not None and np.issubdtype(arr.dtype, np.floating):
            b, blk = q
            codes, scales = block_encode(torch.from_numpy(np.ascontiguousarray(arr)), bits=b, block_size=blk)
            fields[name] = {
                "enc": "q",
                "bits": int(b),
                "block": int(blk),
                "codes": codes.numpy(),
                "scales": scales.numpy(),
                "shape": tuple(int(d) for d in arr.shape),
                "dtype": str(arr.dtype),
            }
        else:
            fields[name] = {"enc": "raw", "data": arr}
    return {"wire_version": WIRE_VERSION, "fields": fields}


def decode_canonical(wire: Dict[str, Any]) -> Dict[str, Any]:
    """Decode an :func:`encode_canonical` payload back to host numpy arrays."""
    if wire.get("wire_version") != WIRE_VERSION:
        raise ValueError(f"unknown wire_version {wire.get('wire_version')!r} (expected {WIRE_VERSION})")
    out: Dict[str, Any] = {}
    for name, f in wire["fields"].items():
        if f["enc"] == "raw":
            out[name] = np.asarray(f["data"])
        else:
            size = int(np.prod(f["shape"])) if f["shape"] else 1
            deq = np.asarray(f["codes"], dtype=np.float32) * np.asarray(f["scales"])[..., None]
            out[name] = deq.reshape(-1)[:size].reshape(f["shape"]).astype(f["dtype"])
    return out


def wire_payload_bytes(wire: Dict[str, Any]) -> int:
    """Total bytes of one encoded payload (codes + scales + raw)."""
    total = 0
    for f in wire["fields"].values():
        if f["enc"] == "raw":
            total += int(np.asarray(f["data"]).nbytes)
        else:
            total += int(np.asarray(f["codes"]).nbytes) + int(np.asarray(f["scales"]).nbytes)
    return total


def quantized_sync(bits: int = DEFAULT_BITS) -> Callable[[Any, Reduction, Any], Any]:
    """A drop-in ``dist_sync_fn``: a quantized gather for float ``cat``/``None``
    states of the same shape on every rank; everything else takes the exact
    :func:`~torchmetrics_tpu_torch.parallel.sync.sync_value`. For the reduce
    path of sum-family states use ``sync_precision="quantized"``.

    Example:
        >>> from torchmetrics_tpu_torch.parallel import quantized_sync
        >>> from torchmetrics_tpu_torch.aggregation import CatMetric
        >>> metric = CatMetric(dist_sync_fn=quantized_sync(bits=8), device="cpu")
        >>> metric.dist_sync_fn.__name__
        'quantized_sync_8'
    """

    def _sync(value: Any, reduction: Reduction, group: Any = None) -> Any:
        is_list = isinstance(value, (list, tuple))
        if reduction in ("cat", None) and not callable(reduction):
            payload = value
            if is_list:
                if len(payload) == 0:
                    return payload
                payload = torch.cat([torch.atleast_1d(v) for v in payload])
            if payload.is_floating_point():
                gathered = quantized_all_gather(payload, bits=bits, group=group)
                out = gathered.reshape((-1,) + tuple(gathered.shape[2:])) if reduction == "cat" else gathered
                return [out] if is_list else out
        return sync_value(value, reduction, group)

    _sync.__name__ = f"quantized_sync_{bits}"
    return _sync


quantized_sync_int8 = partial(quantized_sync, 8)
quantized_sync_int16 = partial(quantized_sync, 16)

