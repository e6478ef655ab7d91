"""``WrapperMetric`` and the stacked-state helpers the wrappers share.

A wrapper lives on its base metric's device: the ``device`` keyword, when
given, must name that device (the base is never copied across devices). The
wrapper itself never syncs; its children do.

The functional paths of BootStrapper, MultioutputWrapper and Running keep
the JAX package's stacked layout, every state leaf with a leading ``(n, ...)``
replicate, output or slot axis. JAX maps the base's pure functions over that
axis with ``vmap``; the port's kernels are bound through ctypes and cannot be
batched that way, so the port loops over the axis (:func:`_unstack`), applies
the base's function to each slice and stacks the results again
(:func:`_tree_stack`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from torchmetrics_tpu_torch.metric import Metric, resolve_device


def _on_base_device(device: torch.device, kwargs: Dict[str, Any], owner: str) -> Dict[str, Any]:
    """``kwargs`` with ``device`` set to the base metric's ``device``; an
    explicit ``device=`` naming another device raises."""
    asked = kwargs.get("device")
    if asked is not None and resolve_device(asked) != device:
        raise ValueError(
            f"{owner}: `device={asked}` differs from the wrapped metric's device {device}; a wrapper"
            " lives on its base metric's device (move the base with `.to(...)` first)"
        )
    return {**kwargs, "device": device}


def _require_mergeable_tensor_states(base: Metric, path_name: str) -> None:
    """Reject base metrics whose states cannot be carried through the stacked
    merge fold: list states and 'cat'/custom reductions change leaf shapes."""
    bad = [
        name
        for name, fx in base._reductions.items()
        if isinstance(base._defaults.get(name), list) or fx not in ("sum", "mean", "max", "min")
    ]
    if bad:
        raise ValueError(
            f"The functional {path_name} path supports tensor states with sum/mean/max/min"
            f" reductions only; state(s) {bad} use list or 'cat'/custom reductions whose"
            " merges change leaf shapes and cannot be carried through a traced step."
        )


def _tree_stack(trees: List[Any], device: Optional[torch.device] = None) -> Any:
    """Stack matching dicts of tensors leaf by leaf along a new leading axis;
    plain numbers (an exported update count) become a tensor on ``device``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees], device) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return torch.tensor(trees, device=device)


def _tree_index(tree: Any, i: int) -> Any:
    """Slice ``i`` of every leaf of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree: Any) -> Any:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` slices of a stacked tree."""
    return [_tree_index(tree, i) for i in range(n)]


def _stacked_state(metrics: List[Metric]) -> Any:
    """Children's live states in the functional stacked ``(n, ...)`` layout,
    or a per-child ``replicates`` snapshot list when list ("cat") states make
    stacking impossible (poisson bootstrap resamples, cat states of
    differing lengths)."""
    states = [m.state() for m in metrics]
    if any(isinstance(d, list) for d in metrics[0]._defaults.values()):
        return {"replicates": states}
    return _tree_stack(states, metrics[0].device)


def _load_stacked_state(metrics: List[Metric], state: Any, update_count: Optional[int] = None) -> None:
    """Inverse of :func:`_stacked_state`, validating the replicate count.
    ``update_count`` is forwarded to every child so wrapper and children
    agree after a restore."""
    if isinstance(state, dict) and "replicates" in state:
        reps = state["replicates"]
        if len(reps) != len(metrics):
            raise ValueError(f"state holds {len(reps)} replicate states but this wrapper has {len(metrics)}")
        for m, st in zip(metrics, reps):
            m.load_state(st, update_count=update_count)
        return
    leaf = _first_leaf(state)
    if tuple(leaf.shape[:1]) != (len(metrics),):
        raise ValueError(
            f"state leading dimension {tuple(leaf.shape[:1]) or 'scalar'} does not match this"
            f" wrapper's {len(metrics)} child metrics"
        )
    for i, m in enumerate(metrics):
        m.load_state(_tree_index(state, i), update_count=update_count)


def _stacked_init(base: Metric, n: int) -> Dict[str, Any]:
    """``n`` copies of the base default state stacked along a new leading
    axis: the state layout of the wrappers' functional paths."""
    bad = [name for name, default in base._defaults.items() if isinstance(default, list)]
    if bad:
        raise ValueError(
            f"{type(base).__name__} holds list ('cat') state(s) {bad} whose per-update"
            " dynamic shapes cannot be stacked into a static replicate axis; the functional"
            " wrapper paths require tensor states (e.g. capacity-buffered variants)."
        )
    return _tree_stack([base.init_state() for _ in range(n)])


def _stacked_sync(base: Metric, state: Dict[str, Any], n: int, process_group: Any = None) -> Dict[str, Any]:
    """Sync a stacked state across processes by the base's declared
    reductions. Sum, mean, max and min act elementwise, so the stacked leaves
    sync in one pass (one collective per reduction and dtype for all ``n``
    slices); any other reduction syncs slice by slice."""
    if all(fx in ("sum", "mean", "max", "min") for fx in base._reductions.values()):
        return base.functional_sync(state, process_group)
    return _tree_stack([base.functional_sync(st, process_group) for st in _unstack(state, n)])


class WrapperMetric(Metric):
    """Abstract base for wrappers; the wrapper itself never syncs (children do)."""

    def sync(self, *args: Any, **kwargs: Any) -> None:
        pass

    def unsync(self, *args: Any, **kwargs: Any) -> None:
        pass

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError

    def compute(self) -> Any:
        raise NotImplementedError
