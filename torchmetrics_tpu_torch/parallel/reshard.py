"""Elastic topology: the one N->M reshard seam and the shard shadow.

The counterpart of the JAX package's ``parallel/reshard.py``:

- :func:`fold_canonical` collapses a stacked sharded state (leading axis =
  shards) to the topology-neutral canonical form, the value the declared
  ``dist_reduce_fx`` gives at the read point;
- :func:`expand_canonical` reinstalls a canonical value onto M shards so
  the next fold returns it exactly and later local accumulation stays exact;
- :func:`merge_folded` combines two canonical segments (a carried baseline
  and a freshly folded value) per the declared reduction;
- :func:`reshard_states` is the N->M path built from the two halves; the
  elastic checkpoint restore and ``Metric.reshard_state`` call it;
- :class:`ShardShadow` is a bounded-lag host copy of the folded reduce,
  refreshed on the read pipeline (``ops/async_read.py``).

Exactness per reduction family:

====== ============================== ===============================
family fold (shard axis)              expand onto M shards
====== ============================== ===============================
sum    add                            canonical in shard 0, zeros elsewhere
mean   linear (mean over shards)      canonical replicated on every shard
max    idempotent                     canonical replicated
min    idempotent                     canonical replicated
====== ============================== ===============================

``cat``, ``None`` and callable reductions cannot be re-split into a uniform
stack: :func:`expand_canonical` refuses them with
:class:`~torchmetrics_tpu_torch.utils.exceptions.TopologyMismatchError`.
Everything here works on tensors and is written out of place.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.parallel.sync import Reduction, fold_stacked, reduction_identity
from torchmetrics_tpu_torch.utils.exceptions import TopologyMismatchError

__all__ = [
    "SHARD_LOSS_POLICIES",
    "ShardLayout",
    "ShardShadow",
    "expand_canonical",
    "fold_canonical",
    "layout_of",
    "merge_folded",
    "reshard_states",
]

#: reduction families an elastic reshard can re-split exactly into the stack
_IN_STACK = ("sum", "mean", "max", "min")

#: reserved keys a state export may carry that are no declared field
_RESERVED = ("_update_count", "_sharded_shards", "_window_meta")


class ShardLayout(NamedTuple):
    """How many shards the leading axis of a stacked state carries.
    ``axis_name`` is metadata only (the JAX package's mesh axis)."""

    num_shards: int
    axis_name: Optional[str] = None


def layout_of(states: Dict[str, Any]) -> ShardLayout:
    """The :class:`ShardLayout` of a stacked state tree, from its first
    tensor leaf of rank >= 1."""
    for v in states.values():
        if isinstance(v, dict):
            return layout_of(v)
        arr = v if isinstance(v, torch.Tensor) else np.asarray(v)
        if getattr(arr, "ndim", 0) >= 1:
            return ShardLayout(int(arr.shape[0]))
    raise obs.flighted(
        TopologyMismatchError("cannot infer shard layout: no array leaf carries a shard axis"),
        domain="reshard",
    )


def _strip_reserved(states: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in states.items() if k not in _RESERVED}


def _as_tensor(v: Any) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def fold_canonical(
    states: Dict[str, Any],
    reductions: Dict[str, Reduction],
    class_layouts: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Collapse the leading shard axis of every field per its reduction (the
    reserved count and shard-mark keys are stripped). ``class_layouts``
    (field -> ``ClassShardLayout``) also gathers class-stacked fields back
    to their dense class axis, so the canonical form is neutral to both
    topologies."""
    from torchmetrics_tpu_torch.parallel.class_shard import gather_dense

    folded = {k: fold_stacked(_as_tensor(v), reductions.get(k)) for k, v in _strip_reserved(states).items()}
    for name, layout in (class_layouts or {}).items():
        if name in folded:
            folded[name] = gather_dense(folded[name], layout)
    return folded


def expand_canonical(
    canonical: Dict[str, Any],
    reductions: Dict[str, Reduction],
    num_shards: int,
    class_layouts: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Reinstall a canonical state onto ``num_shards`` shards (the table in
    the module docstring). ``class_layouts`` re-splits dense class axes into
    the target's class stack (identity-padded) first. Raises
    :class:`TopologyMismatchError` for ``cat``, ``None`` and callable fields."""
    from torchmetrics_tpu_torch.parallel.class_shard import identity_pad_value, stack_dense

    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    out: Dict[str, Any] = {}
    for name, value in _strip_reserved(canonical).items():
        fx = reductions.get(name)
        if fx not in _IN_STACK:
            raise obs.flighted(
                TopologyMismatchError(
                    f"field {name!r} (dist_reduce_fx={fx!r}) cannot be re-split into a"
                    f" {num_shards}-shard stack; carry it as a baseline (merge_folded)"
                    " or restore on the saved topology"
                ),
                domain="reshard",
            )
        arr = _as_tensor(value)
        layout = (class_layouts or {}).get(name)
        if layout is not None:
            arr = stack_dense(arr, layout, pad_value=identity_pad_value(fx, arr.dtype))
        if fx == "sum":
            ident = reduction_identity(fx, arr.dtype).to(arr.device)
            rest = ident.expand((num_shards - 1,) + tuple(arr.shape))
            out[name] = torch.cat([arr.unsqueeze(0), rest])
        else:  # mean (linear fold), max/min (idempotent): replicate exactly
            out[name] = arr.unsqueeze(0).expand((num_shards,) + tuple(arr.shape)).contiguous()
    return out


def merge_folded(baseline: Dict[str, Any], fresh: Dict[str, Any], reductions: Dict[str, Reduction]) -> Dict[str, Any]:
    """Combine two canonical segments of one accumulation per reduction.
    ``sum`` and ``mean`` ADD (the shard fold is linear), ``max``/``min``
    take the extremum, ``cat`` concatenates; ``None`` and callables raise."""
    out: Dict[str, Any] = {}
    for name, b in baseline.items():
        fx = reductions.get(name)
        bt, v = _as_tensor(b), _as_tensor(fresh[name])
        if fx in ("sum", "mean"):
            out[name] = bt + v
        elif fx == "max":
            out[name] = torch.maximum(bt, v)
        elif fx == "min":
            out[name] = torch.minimum(bt, v)
        elif fx == "cat":
            out[name] = torch.cat([torch.atleast_1d(bt), torch.atleast_1d(v)])
        else:
            raise obs.flighted(
                TopologyMismatchError(
                    f"field {name!r} (dist_reduce_fx={fx!r}) has no derivable segment merge;"
                    " elastic restore cannot carry it across a topology change"
                ),
                domain="reshard",
            )
    for name, v in fresh.items():
        if name not in out:
            out[name] = v
    return out


def reshard_states(
    states: Dict[str, Any],
    from_layout: ShardLayout,
    to_layout: ShardLayout,
    reductions: Dict[str, Reduction],
    class_layouts: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The N->M re-split: fold ``states`` (``from_layout.num_shards``
    leading) to canonical, then expand onto ``to_layout.num_shards``. Exact
    for sum/mean/max/min; ``cat``/``None``/callable fields raise
    :class:`TopologyMismatchError`. N == M returns the stack unchanged
    (reserved keys stripped). One ``tm_tpu.reshard`` span and one
    ``shards.resharded`` count a re-split."""
    got = layout_of(states)
    if got.num_shards != from_layout.num_shards:
        raise obs.flighted(
            TopologyMismatchError(
                f"state carries {got.num_shards} shards but from_layout declares {from_layout.num_shards}",
                saved={"num_shards": from_layout.num_shards},
                current={"num_shards": got.num_shards},
            ),
            domain="reshard",
        )
    if from_layout.num_shards == to_layout.num_shards:
        return _strip_reserved(states)
    with obs.span(obs.SPAN_RESHARD, src=from_layout.num_shards, dst=to_layout.num_shards):
        obs.counter_inc("shards.resharded")
        return expand_canonical(
            fold_canonical(states, reductions, class_layouts), reductions, to_layout.num_shards, class_layouts
        )


#: valid ``on_shard_loss`` policies
SHARD_LOSS_POLICIES = ("raise", "degraded", "restore")


class ShardShadow:
    """Bounded-lag host copy of a deferred accumulation's folded reduce.

    Every ``every_n_steps`` local steps the owner hands :meth:`observe` an
    already-folded state tree (``{leader: {field: tensor}}``, fresh tensors
    the step loop will not write: updates are out of place). The read
    pipeline's worker waits for the device, copies to the host, merges an
    optional carried baseline segment and installs the result as the
    freshest shadow; the step loop never waits. The freshest completed
    refresh is the recovery anchor on shard loss
    (:class:`~torchmetrics_tpu_torch.utils.exceptions.ShardLossError`).
    """

    def __init__(self, reductions_of: Callable[[], Dict[str, Dict[str, Reduction]]], every_n_steps: int = 8) -> None:
        if every_n_steps < 1:
            raise ValueError(f"every_n_steps must be >= 1, got {every_n_steps}")
        self.every_n_steps = int(every_n_steps)
        self._reductions_of = reductions_of
        self._lock = threading.Lock()
        #: freshest completed refresh: (canonical host tree, step counter)
        self._shadow: Optional[Tuple[Dict[str, Dict[str, Any]], int]] = None
        self._last_submitted = -every_n_steps  # the first observe() always refreshes
        self.stats: Dict[str, int] = {"refreshes": 0, "submitted": 0, "errors": 0}

    def due(self, step_count: int) -> bool:
        """True when the cadence says a refresh should be submitted now."""
        return step_count - self._last_submitted >= self.every_n_steps

    def observe(self, folded_device: Any, step_count: int, baseline: Optional[Dict[str, Any]] = None) -> Any:
        """Stage one refresh on the read pipeline; returns its future."""
        from torchmetrics_tpu_torch.ops.async_read import get_pipeline, submission_event

        self._last_submitted = int(step_count)
        self.stats["submitted"] += 1
        event = submission_event(folded_device)
        with obs.span(obs.SPAN_SHADOW, phase="submit", step=int(step_count)):
            return get_pipeline().submit(
                lambda: self._refresh_job(event, folded_device, int(step_count), baseline),
                owner="ShardShadow.refresh",
            )

    def _refresh_job(self, event: Any, folded_device: Any, step_count: int, baseline: Optional[Dict[str, Any]]) -> None:
        """WORKER-SIDE ONLY: wait for the device, host copy, install."""
        from torchmetrics_tpu_torch.ops.async_read import fetch_host, materialize, wait_submitted
        from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

        try:
            with obs.span(obs.SPAN_SHADOW, phase="refresh", step=int(step_count)):
                wait_submitted(event)
                ready = materialize(folded_device)
                host = {leader: {f: fetch_host(v) for f, v in sub.items()} for leader, sub in ready.items()}
            if baseline is not None:
                reds = self._reductions_of()
                host = {
                    leader: {
                        f: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                        for f, v in merge_folded(baseline[leader], sub, reds[leader]).items()
                    }
                    for leader, sub in host.items()
                }
            with self._lock:
                if self._shadow is None or step_count >= self._shadow[1]:
                    self._shadow = (host, step_count)
            self.stats["refreshes"] += 1
            obs.counter_inc("shards.shadow_refreshes")
        except Exception as err:
            # a failed refresh keeps the previous shadow as the anchor
            self.stats["errors"] += 1
            obs.counter_inc("shards.shadow_errors")
            obs.fault_breadcrumb("shadow_refresh_failed", domain="shadow", data={"error": f"{type(err).__name__}: {err}"})
            rank_zero_debug(f"shard shadow refresh failed: {type(err).__name__}: {err}")

    def snapshot(self) -> Optional[Tuple[Dict[str, Dict[str, Any]], int]]:
        """The freshest completed refresh as ``(canonical_host_state,
        step_counter)``, or None before the first one."""
        with self._lock:
            if self._shadow is None:
                return None
            host, count = self._shadow
            return {k: dict(v) for k, v in host.items()}, count

    def seed(self, canonical: Dict[str, Dict[str, Any]], step_count: int) -> None:
        """Install a known-good canonical value directly (restore-time seed)."""
        host = {
            leader: {f: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for f, v in sub.items()}
            for leader, sub in canonical.items()
        }
        with self._lock:
            self._shadow = (host, int(step_count))
        self._last_submitted = int(step_count)

    def updates_behind(self, live_step_count: int) -> Optional[int]:
        """How many committed steps the shadow trails the live state by
        (None before the first completed refresh)."""
        with self._lock:
            if self._shadow is None:
                return None
            return max(0, int(live_step_count) - self._shadow[1])
