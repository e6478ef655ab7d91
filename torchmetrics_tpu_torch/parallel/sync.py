"""Cross-process state sync on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/sync.py``, whose collectives
are XLA's ``psum``/``pmean``/``pmax``/``pmin`` and ``all_gather`` over a
mesh axis. Here a process group (gloo on the CPU, NCCL on the card) takes
their place:

- ``sum``/``mean``/``max``/``min`` tensor states are grouped by (reduction,
  dtype), ravelled into ONE fresh flat buffer per group and reduced by one
  ``all_reduce``, then split back: a stat-scores quartet costs one
  collective. ``torch.distributed.all_reduce`` writes in place, so the
  buffer is always a new one, even for a group of one field: compute-group
  followers share their leader's state tensors, and ``unsync`` restores the
  tensors the sync read. Gloo has no ``AVG``, so ``mean`` is a ``sum``
  divided by the world size (an integer ``mean`` comes back float32, as
  ``lax.pmean`` returns it).
- ``cat``/``None``/callable reductions, bool states (NCCL reduces a bool
  ``SUM`` as ``MAX``) and list states take a gather each. Unlike the JAX
  package's static shapes, each process's list states have their own
  length, so one small metadata gather first exchanges every gathered
  field's leading size, trailing shape and dtype; then each field's
  payload, padded to the longest rank's, is gathered and trimmed. A rank
  whose list is empty still enters every collective and learns the dtype
  and trailing shape it lacks from its peers. Every decision after the
  metadata gather is made from gathered data, so all ranks raise together
  when the ranks disagree.
- ``cat`` concatenates the ranks' values; ``None`` stacks one entry per
  rank (for a list state, the ranks' concatenations as a list, since their
  lengths may differ); a callable receives the stack.

Every collective goes through the module-level seams :func:`_all_reduce`
and :func:`_all_gather` (``async_op=True``), which count what they issue
(``all_reduces``, ``all_gathers``) and which tests patch to count, hang or
break the collectives. A ``timeout`` bounds each wait on a work handle and
raises :class:`~torchmetrics_tpu_torch.utils.exceptions.SyncTimeoutError`
when it expires (counted ``sync.timeouts``, with a flight breadcrumb; a
collective's own failure counts ``sync.gather_errors``). Each sync is one
``tm_tpu.sync.gather`` span and adds its payload to ``sync.bytes_on_wire``.
Under NCCL a timed-out collective leaves the communicator
in an unknown state (PyTorch's watchdog may abort the process), so a
timeout there is a signal to checkpoint and exit, not to retry.

A state must lie on a device the group's backend takes (gloo: the CPU,
NCCL: CUDA); any other raises, naming both. Nothing is copied across
devices.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch
import torch.distributed as dist

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.utils.exceptions import SyncTimeoutError

Reduction = Union[str, Callable, None]

#: env var holding the default bound of a cross-process sync (seconds, float)
SYNC_TIMEOUT_ENV = "TORCHMETRICS_TPU_SYNC_TIMEOUT"

#: env var holding the process-wide default reduction policy ("step" | "deferred")
REDUCE_POLICY_ENV = "TORCHMETRICS_TPU_REDUCE"

REDUCE_POLICIES = ("step", "deferred")

#: valid ``on_sync_failure`` policies: propagate, keep local-only state,
#: retry with backoff, or serve the last successfully synced compute value
#: with staleness metadata (``quarantine.DegradedValue``)
SYNC_FAILURE_POLICIES = ("raise", "local", "retry", "last_good")

_FUSED_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

#: the device types each backend takes
_BACKEND_DEVICES = {"gloo": {"cpu"}, "nccl": {"cuda"}}

#: the dtypes a gathered field may have, coded by position in the metadata
_DTYPES = (
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.complex64, torch.complex128,
)
#: trailing dimensions a gathered field may have
_MAX_TRAILING = 8

#: collectives issued through the seams; a caller sets them to 0 and reads them
all_reduces = 0
all_gathers = 0


def default_sync_timeout() -> Optional[float]:
    """The environment-configured sync bound (``TORCHMETRICS_TPU_SYNC_TIMEOUT``), or None."""
    raw = os.environ.get(SYNC_TIMEOUT_ENV, "").strip()
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(f"{SYNC_TIMEOUT_ENV} must be a number of seconds, got {raw!r}")
    return value if value > 0 else None


def default_reduce_policy() -> str:
    """The environment-configured reduction policy (``TORCHMETRICS_TPU_REDUCE``):
    ``"step"`` (default) or ``"deferred"``, which accumulates locally and
    applies each state's declared reduction once, at ``compute()``/``sync()``."""
    raw = os.environ.get(REDUCE_POLICY_ENV, "").strip().lower()
    if not raw:
        return "step"
    if raw not in REDUCE_POLICIES:
        raise ValueError(f"{REDUCE_POLICY_ENV} must be one of {REDUCE_POLICIES}, got {raw!r}")
    return raw


def _all_reduce(tensor: torch.Tensor, op: Any, group: Any) -> Any:
    """Reduce ``tensor`` (a buffer this module allocated) in place across the
    group; returns the work handle."""
    global all_reduces
    all_reduces += 1
    return dist.all_reduce(tensor, op=op, group=group, async_op=True)


def _all_gather(outputs: List[torch.Tensor], tensor: torch.Tensor, group: Any) -> Any:
    """Gather ``tensor`` from every rank into ``outputs``; returns the work handle."""
    global all_gathers
    all_gathers += 1
    return dist.all_gather(outputs, tensor, group=group, async_op=True)


def _wait(work: Any, timeout: Optional[float], what: str) -> None:
    """Wait for one collective, at most ``timeout`` seconds when given.

    Polls ``is_completed()`` rather than ``wait(timeout)``, whose expiry is
    a backend-specific ``RuntimeError``; the final ``wait()`` surfaces the
    collective's own error (and, under NCCL, orders the current stream
    after it)."""
    if timeout is not None:
        deadline = time.monotonic() + timeout
        pause = 1e-5
        while not work.is_completed():
            if time.monotonic() >= deadline:
                obs.counter_inc("sync.timeouts")
                raise obs.flighted(
                    SyncTimeoutError(f"cross-process sync ({what}) did not complete within {timeout}s"),
                    domain="sync",
                    kind="sync_timeout",
                    timeout_s=timeout,
                )
            time.sleep(pause)
            pause = min(2 * pause, 1e-3)
    try:
        work.wait()
    except Exception:
        obs.counter_inc("sync.gather_errors")
        raise


def _backend_devices(group: Any) -> Optional[Set[str]]:
    """The device types the group's backend takes, or None when unknown.
    A mixed backend reads like ``"cpu:gloo,cuda:nccl"``."""
    backend = str(dist.get_backend(group))
    if ":" in backend:
        return {part.split(":")[0] for part in backend.split(",")}
    return _BACKEND_DEVICES.get(backend)


def _default_device(group: Any) -> torch.device:
    """Where the sync's own buffers live when the caller names no device:
    the current CUDA device for a backend that takes CUDA, else the CPU.
    Decided from the backend alone, so every rank decides alike."""
    devices = _backend_devices(group)
    if devices is not None and "cuda" in devices:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _check_devices(states: Dict[str, Any], group: Any, device: torch.device) -> None:
    devices = _backend_devices(group)
    if devices is None:
        return
    backend = dist.get_backend(group)
    if device.type not in devices:
        raise RuntimeError(f"sync: the {backend!r} backend cannot take tensors on {device}")
    for name, value in states.items():
        for t in value if isinstance(value, (list, tuple)) else [value]:
            if isinstance(t, torch.Tensor) and t.device.type not in devices:
                raise RuntimeError(
                    f"sync: state {name!r} lies on {t.device}, which the {backend!r} backend cannot take;"
                    " states are never copied across devices implicitly (build the metric on a device"
                    " the process group's backend serves)"
                )


def _payload(value: Any) -> Optional[torch.Tensor]:
    """The tensor a gathered field sends: a list concatenated (None when it
    is empty), a tensor at least 1-D."""
    if isinstance(value, (list, tuple)):
        if not value:
            return None
        return torch.cat([torch.atleast_1d(v) for v in value], dim=0)
    return torch.atleast_1d(value)


def _meta_row(payload: Optional[torch.Tensor]) -> List[int]:
    """A gathered field's metadata: leading size, trailing rank, dtype code
    and trailing dims; an empty list sends rank and dtype -1."""
    row = [0, -1, -1] + [0] * _MAX_TRAILING
    if payload is None:
        return row
    trailing = tuple(payload.shape[1:])
    row[0], row[1] = int(payload.shape[0]), len(trailing)
    row[2] = _DTYPES.index(payload.dtype) if payload.dtype in _DTYPES else -2
    row[3 : 3 + min(len(trailing), _MAX_TRAILING)] = trailing[:_MAX_TRAILING]
    return row


def _agreed_layout(name: str, rows: List[List[int]]) -> Optional[Tuple[torch.dtype, Tuple[int, ...]]]:
    """The dtype and trailing shape every rank that holds data agrees on
    (None when no rank holds any); raises, on every rank alike, otherwise."""
    known = [r for r in rows if r[1] >= 0]
    if not known:
        return None
    for r in known:
        if r[1] > _MAX_TRAILING:
            raise ValueError(f"sync: state {name!r} has {r[1]} trailing dimensions; at most {_MAX_TRAILING} are synced")
        if r[2] < 0:
            raise ValueError(f"sync: state {name!r} has a dtype the sync does not carry")
    layouts = {(r[2], tuple(r[3 : 3 + r[1]])) for r in known}
    if len(layouts) != 1:
        found = sorted((str(_DTYPES[code]), shape) for code, shape in layouts)
        raise ValueError(f"sync: the ranks hold state {name!r} with different dtypes or trailing shapes: {found}")
    code, trailing = layouts.pop()
    return _DTYPES[code], trailing


def _stack(name: str, pieces: List[torch.Tensor], reduction: Reduction) -> torch.Tensor:
    if len({tuple(p.shape) for p in pieces}) != 1:
        raise ValueError(
            f"sync: state {name!r} has a different length on each rank, which its reduction"
            f" {reduction!r} cannot stack; declare it with dist_reduce_fx='cat'"
        )
    return torch.stack(pieces)


def reduce_stacked(gathered: torch.Tensor, reduction: Reduction) -> torch.Tensor:
    """Collapse the leading rank axis of a stacked value per the declared
    reduction (``mean`` is the sum over the world size, as ``lax.pmean``;
    an integer or bool ``mean`` comes back float32)."""
    if reduction == "sum":
        return gathered.sum(0)
    if reduction == "mean":
        return gathered.sum(0) / gathered.shape[0]
    if reduction == "max":
        return torch.amax(gathered, 0)
    if reduction == "min":
        return torch.amin(gathered, 0)
    if reduction == "cat":
        return gathered.reshape((-1,) + tuple(gathered.shape[2:]))
    if callable(reduction):
        return reduction(gathered)
    return gathered


def reduction_identity(reduction: Reduction, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The identity element of a declared ``dist_reduce_fx`` for ``dtype``:
    the value a masked-out contributor must carry so it cannot perturb the
    fold.

    - ``sum``/``mean``/``cat``/``None``: 0;
    - ``max``: ``-inf`` for floats, the dtype's minimum for ints, False for bool;
    - ``min``: ``+inf`` for floats, the dtype's maximum for ints, True for bool;
    - callables: None (no derivable identity; mask structurally instead).
    """
    if callable(reduction):
        return None
    if reduction in ("max", "min"):
        lo = reduction == "max"
        if dtype == torch.bool:
            return torch.tensor(not lo, dtype=dtype)
        if dtype.is_floating_point:
            return torch.tensor(-torch.inf if lo else torch.inf, dtype=dtype)
        info = torch.iinfo(dtype)
        return torch.tensor(info.min if lo else info.max, dtype=dtype)
    return torch.zeros((), dtype=dtype)


def live_window_mask(head: Any, window: int, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Boolean mask of the ring slots holding LIVE windows, ``head.shape + (window,)``.

    ``head`` is the monotonic window clock: an int, or an integer tensor of
    any shape (one clock per lane), whose device the mask takes (``device``
    places an int's mask). Slot ``head % window`` houses the open window and
    older slots wrap behind it. Before the clock has wrapped once
    (``head < window - 1``) the slots not yet opened hold defaults, which
    are not the fold identity of every family (a ``max`` state may default
    to 0): the mask lets the fold replace them with
    :func:`reduction_identity`. Plain tensor arithmetic, no host read.
    """
    if isinstance(head, torch.Tensor):
        device = head.device
        head = head.to(torch.int64).unsqueeze(-1)
    slots = torch.arange(window, device=device)
    age = torch.remainder(head % window - slots, window)
    return (head - age) >= 0


def fold_window_slots(value: torch.Tensor, reduction: Reduction, live: torch.Tensor) -> torch.Tensor:
    """Collapse the WINDOW axis of a ring-stacked state field into the
    sliding-window aggregate, masking dead slots with the reduction identity.

    ``live`` is :func:`live_window_mask`'s mask; its shape is the leading
    dims of ``value`` up to and including the window axis, so a ``(W,)``
    mask folds axis 0 and a laned ``(lanes, W)`` mask folds axis 1 lane by
    lane. Ring slots are disjoint segments of one accumulation stream, so
    ``sum`` and ``mean`` states both ADD across them (the mean fold is
    linear over contributors) and ``max``/``min`` take the masked extremum.
    The fold keeps the state's dtype (``torch.sum`` would widen int32 to
    int64 where ``jnp.sum`` keeps it). ``cat``/``None``/callable families
    have no identity-masked fold: windows.py keeps those metrics on the
    eager per-window path and never calls this.
    """
    if callable(reduction) or reduction in ("cat", None):
        raise ValueError(
            f"fold_window_slots is undefined for {reduction!r} reductions; eager"
            " per-window states merge through Metric.merge_states instead"
        )
    axis = live.ndim - 1
    mask = live.reshape(tuple(live.shape) + (1,) * (value.ndim - live.ndim))
    # a Python scalar fill: no host-to-device copy of the identity
    masked = value.masked_fill(~mask, reduction_identity(reduction, value.dtype).item())
    if reduction in ("sum", "mean"):
        return masked.sum(axis, dtype=value.dtype)
    if reduction == "max":
        return torch.amax(masked, axis)
    return torch.amin(masked, axis)


def sync_states(
    states: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Any = None,
    timeout: Optional[float] = None,
    device: Union[str, torch.device, None] = None,
    qspecs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Apply the declared reductions to every state field across ``group``
    (None: the world) and return the synced states; the inputs are read,
    never written.

    Collectives: one ``all_reduce`` per (reduction, dtype) group of
    ``sum``/``mean``/``max``/``min`` tensor fields; when any field is
    gathered, one metadata ``all_gather`` for all of them and one payload
    ``all_gather`` for each that holds data on some rank. ``timeout`` bounds
    each wait. ``device`` holds the sync's own buffers (default: from the
    backend, see :func:`_default_device`).

    ``qspecs`` (``Metric._sync_qspecs()``) maps a field to ``None`` (exact)
    or ``(bits, block)``: a float ``sum``/``mean``/``max``/``min`` field so
    marked joins a group keyed by (reduction, dtype, bits, block), which is
    ravelled once, block-encoded once and reduced through
    :func:`~torchmetrics_tpu_torch.parallel.quantized.quantized_all_reduce`
    (two gathers: codes and scales). Integer and bool fields take the exact
    path whatever their spec. Gathered (``cat``/``None``) fields stay exact:
    their lengths differ by rank, which the fixed-size codes cannot carry.

    Example (a one-process gloo world):
        >>> import tempfile, torch, torch.distributed as dist
        >>> from torchmetrics_tpu_torch.parallel import sync_states
        >>> store = tempfile.mkdtemp() + "/store"
        >>> dist.init_process_group("gloo", init_method="file://" + store, world_size=1, rank=0)
        >>> out = sync_states({"tp": torch.tensor(3), "seen": [torch.tensor([1.0, 2.0])]}, {"tp": "sum", "seen": "cat"})
        >>> out["tp"].item(), out["seen"][0].tolist()
        (3, [1.0, 2.0])
        >>> dist.destroy_process_group()
    """
    attrs = {"timeout_s": timeout} if timeout is not None else {"bounded": False}
    with obs.span(obs.SPAN_SYNC_GATHER, **attrs):
        return _sync_states(states, reductions, group, timeout, device, qspecs or {})


def _sync_states(
    states: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Any,
    timeout: Optional[float],
    device: Union[str, torch.device, None],
    qspecs: Dict[str, Any],
) -> Dict[str, Any]:
    device = _default_device(group) if device is None else torch.device(device)
    _check_devices(states, group, device)
    world = dist.get_world_size(group)
    fused: Dict[Tuple[str, torch.dtype], List[Tuple[str, torch.Tensor]]] = {}
    qfused: Dict[Tuple[Any, ...], List[Tuple[str, torch.Tensor]]] = {}
    gathered: List[Tuple[str, Any, Reduction, Optional[torch.Tensor]]] = []
    for name, value in states.items():
        fx = reductions.get(name)
        if fx in _FUSED_OPS and isinstance(value, torch.Tensor) and value.dtype != torch.bool:
            q = qspecs.get(name)
            if q is not None and value.is_floating_point():
                qfused.setdefault((fx, value.dtype, int(q[0]), int(q[1])), []).append((name, value))
            else:
                fused.setdefault((fx, value.dtype), []).append((name, value))
        else:
            gathered.append((name, value, fx, _payload(value)))

    # one fresh flat buffer per group: torch.cat always allocates
    reduces = []
    for (fx, _), items in fused.items():
        flat = torch.cat([t.reshape(-1) for _, t in items])
        obs.counter_inc("sync.bytes_on_wire", flat.numel() * flat.element_size())
        reduces.append((fx, items, flat, _all_reduce(flat, _FUSED_OPS[fx], group)))

    gathers = []
    if gathered:
        meta = torch.tensor([_meta_row(p) for *_, p in gathered], dtype=torch.int64, device=device)
        metas = [torch.empty_like(meta) for _ in range(world)]
        _wait(_all_gather(metas, meta, group), timeout, "metadata gather")
        table = torch.stack(metas).tolist()  # (world, fields, width): one host read
        for i, (name, value, fx, payload) in enumerate(gathered):
            rows = [table[r][i] for r in range(world)]
            layout = _agreed_layout(name, rows)
            sizes = [r[0] for r in rows]
            if layout is None or max(sizes) == 0:
                gathers.append((name, value, fx, layout, sizes, None, None))
                continue
            dtype, trailing = layout
            longest = max(sizes)
            if payload is not None and payload.shape[0] == longest:
                send = payload.contiguous()
            else:  # padded to the longest rank's length, trimmed after the gather
                send = torch.zeros((longest,) + trailing, dtype=dtype, device=device)
                if payload is not None:
                    send[: payload.shape[0]] = payload
            outs = [torch.empty_like(send) for _ in range(world)]
            obs.counter_inc("sync.bytes_on_wire", send.numel() * send.element_size())
            gathers.append((name, value, fx, layout, sizes, outs, _all_gather(outs, send, group)))

    quantized: Dict[str, torch.Tensor] = {}
    if qfused:
        from torchmetrics_tpu_torch.parallel import quantized as _q

        for (fx, _, bits, block), items in qfused.items():
            # the quantized analogue of the fused reduce: one ravel, one
            # encode, one gather of codes and one of scales per group
            flat = torch.cat([t.reshape(-1) for _, t in items])
            obs.counter_inc("sync.quantized_reduces")
            obs.counter_inc("sync.bytes_on_wire", _q.quantized_wire_bytes(flat.numel(), bits, block)["total"])
            reduced = _q.quantized_all_reduce(flat, fx, bits=bits, block_size=block, group=group, timeout=timeout)
            for (name, t), part in zip(items, torch.split(reduced, [t.numel() for _, t in items])):
                quantized[name] = part.reshape(t.shape)

    with obs.device_span(obs.SPAN_REDUCE):
        out = _finish(states, reduces, gathers, world, timeout, device, quantized)
    return out


def _finish(
    states: Dict[str, Any],
    reduces: list,
    gathers: list,
    world: int,
    timeout: Optional[float],
    device: torch.device,
    quantized: Dict[str, torch.Tensor],
) -> Dict[str, Any]:
    """Wait for the collectives and fold them into the synced states."""
    out: Dict[str, Any] = dict(quantized)
    for fx, items, flat, work in reduces:
        _wait(work, timeout, f"all_reduce of {fx} {items[0][1].dtype}")
        if fx == "mean":
            flat = flat / world
        for (name, t), part in zip(items, torch.split(flat, [t.numel() for _, t in items])):
            out[name] = part.reshape(t.shape)
    for name, value, fx, layout, sizes, outs, work in gathers:
        is_list = isinstance(value, (list, tuple))
        if layout is None:  # an empty list on every rank
            out[name] = []
            continue
        dtype, trailing = layout
        if work is None:
            pieces = [torch.empty((0,) + trailing, dtype=dtype, device=device) for _ in sizes]
        else:
            _wait(work, timeout, f"gather of {name!r}")
            pieces = [o[:n] for o, n in zip(outs, sizes)]
        if fx == "cat":
            result = torch.cat(pieces)
        elif fx is None and is_list:
            out[name] = pieces
            continue
        else:
            result = reduce_stacked(_stack(name, pieces, fx), fx)
        out[name] = [result] if is_list else result
    return {name: out[name] for name in states}


def sync_value(
    value: Any,
    reduction: Reduction,
    group: Any = None,
    timeout: Optional[float] = None,
    device: Union[str, torch.device, None] = None,
) -> Any:
    """Sync one state value (a tensor, or a list of tensors) across ``group``."""
    return sync_states({"value": value}, {"value": reduction}, group, timeout, device)["value"]


def gather_all_tensors(result: torch.Tensor, group: Any = None) -> List[torch.Tensor]:
    """Every rank's ``result``, as a list indexed by rank; the leading sizes
    may differ between ranks (one metadata gather, one padded gather)."""
    if result.ndim == 0:
        return [p.reshape(()) for p in gather_all_tensors(result.reshape(1), group)]
    return sync_value([result], None, group, device=result.device)


def host_sync_value(
    value: Any, reduction: Reduction, timeout: Optional[float] = None, group: Any = None
) -> Any:
    """Gather one state value from every process and reduce it per
    ``reduction`` (the JAX package's ``process_allgather`` path; here the
    same collectives as :func:`sync_value`), bounded by ``timeout``."""
    return sync_value(value, reduction, group, timeout)


# ---------------------------------------------------------------------------
# Deferred reduction: stacked per-shard state, reduced once at the read point
# ---------------------------------------------------------------------------
#
# Under the deferred policy a state carries a leading shard axis: the JAX
# package places it on the mesh's data axis (one device a shard, stepped in
# ``shard_map``). The port has no mesh: the stack lives on this process's
# device, each shard is updated by plain ``functional_update`` calls on its
# slice, and one rank of a ``torch.distributed`` world stands for one mesh
# device. The read point folds the local shard axis per declared reduction
# and then syncs across the process group, so the fold is exact for
# sum/max/min and for a mean over equal shard counts.


def local_accumulate_spec(states: Any, axis_name: str = "batch") -> Any:
    """Per tensor leaf, the axis of a stacked state the shard axis occupies
    (always 0). The JAX package returns a ``PartitionSpec`` tree for
    ``shard_map``; the port has no mesh and keeps the name and the tree
    shape (``axis_name`` is accepted and ignored)."""
    if isinstance(states, dict):
        return {k: local_accumulate_spec(v, axis_name) for k, v in states.items()}
    return 0


def init_sharded_states(init: Any, num_shards: int) -> Any:
    """Stack a fresh state tree into the sharded layout: each tensor leaf
    gains a leading shard axis of ``num_shards`` copies of its default (a
    contiguous tensor; nested dicts recurse)."""
    if isinstance(init, dict):
        return {k: init_sharded_states(v, num_shards) for k, v in init.items()}
    if isinstance(init, torch.Tensor):
        return init.unsqueeze(0).expand((int(num_shards),) + tuple(init.shape)).contiguous()
    return init


def unshard_local_state(state: Any) -> Any:
    """Drop a leading shard axis of size 1 (one shard's slice of a stack),
    yielding the plain state ``functional_update`` expects."""
    if isinstance(state, dict):
        return {k: unshard_local_state(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        if state.ndim < 1 or state.shape[0] != 1:
            raise ValueError(f"unshard_local_state expects a leading shard axis of size 1, got shape {tuple(state.shape)}")
        return state.squeeze(0)
    return state


def reshard_local_state(state: Any) -> Any:
    """Re-add the leading shard axis of size 1 after a local update."""
    if isinstance(state, dict):
        return {k: reshard_local_state(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.unsqueeze(0)
    return state


def fold_stacked(value: torch.Tensor, reduction: Reduction) -> torch.Tensor:
    """Collapse the leading shard axis of one stacked field per its declared
    reduction, keeping the field's dtype for ``sum`` (``torch.sum`` would
    widen int32 to int64 where the JAX package keeps it); the other
    families as :func:`reduce_stacked`."""
    if reduction == "sum" and value.dtype != torch.bool:
        return value.sum(0, dtype=value.dtype)
    return reduce_stacked(value, reduction)


def fold_sharded_states(states: Dict[str, Any], reductions: Dict[str, Reduction]) -> Dict[str, Any]:
    """Out-of-world fold of a stacked sharded state (leading axis = shards):
    collapse the shard axis of every field per its declared reduction. What
    ``Metric.load_state(..., sharded=True)`` folds on demand."""
    with obs.device_span(obs.SPAN_REDUCE):
        return {k: fold_stacked(v, reductions.get(k)) if isinstance(v, torch.Tensor) else v for k, v in states.items()}


def reduce_sharded_states(
    states: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Any = None,
    qspecs: Optional[Dict[str, Any]] = None,
    timeout: Optional[float] = None,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Any]:
    """The deferred read point: fold the local shard axis of every field,
    then, in an initialised process group, apply the declared reductions
    across ranks through ONE :func:`sync_states` (``qspecs`` routes marked
    float fields through the quantized reduce). Without a process group the
    fold alone is the result."""
    folded = fold_sharded_states(states, reductions)
    if not (dist.is_available() and dist.is_initialized()):
        return folded
    return sync_states(folded, reductions, group, timeout=timeout, device=device, qspecs=qspecs)


# ---------------------------------------------------------------------------
# Tensor-reduction helpers with the reference's API (utilities/distributed.py)
# ---------------------------------------------------------------------------


def reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    """Reduce a tensor ('elementwise_mean' | 'sum' | 'none')."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(
    num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor, class_reduction: Optional[str] = "none"
) -> torch.Tensor:
    """Per-class fraction num/denom with a class-level reduction."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), torch.zeros_like(fraction), fraction)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")


__all__: Sequence[str] = [
    "REDUCE_POLICIES",
    "REDUCE_POLICY_ENV",
    "SYNC_FAILURE_POLICIES",
    "SYNC_TIMEOUT_ENV",
    "class_reduce",
    "default_reduce_policy",
    "default_sync_timeout",
    "fold_sharded_states",
    "fold_stacked",
    "fold_window_slots",
    "gather_all_tensors",
    "host_sync_value",
    "init_sharded_states",
    "live_window_mask",
    "local_accumulate_spec",
    "reduce",
    "reduce_sharded_states",
    "reduce_stacked",
    "reduction_identity",
    "reshard_local_state",
    "sync_states",
    "sync_value",
    "unshard_local_state",
]
