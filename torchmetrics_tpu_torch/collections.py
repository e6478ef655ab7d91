"""MetricCollection with compute groups.

Accepts a list/dict of metrics, renames outputs with prefix/postfix, and
filters kwargs per metric. **Compute groups**: after the first update, metrics
whose states compare equal merge into groups; thereafter only the group
leader is updated and followers point at the leader's state tensors (updates
replace tensors, never mutate them, so sharing is safe).

Every update/forward runs inside one :class:`~torchmetrics_tpu_torch.ops.kernels.shared_scope`:
the classification leaders of one call then share a single confusion-count
kernel launch (ops/fused_classification.py), and nothing is memoized past
the call.

Once the groups are resolved, the collection's captured executor
(``ops/executor.py``, on by default on the card) runs every group leader's
update, or the whole forward, as one replay.
"""
from __future__ import annotations

import os
from contextlib import nullcontext
from copy import deepcopy
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.metric import Metric, _metric_call, resolve_device
from torchmetrics_tpu_torch.ops.kernels import gate_snapshot, shared_scope
from torchmetrics_tpu_torch.parallel.sync import (
    REDUCE_POLICIES,
    fold_sharded_states,
    init_sharded_states,
    sync_states,
)
from torchmetrics_tpu_torch.utils.data import _flatten_dict
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_PREFIX_SUFFIX_ERROR = "Expected input `{}` to be a string, but got {}"



class MetricCollection:
    """Dict-like collection of metrics sharing update calls.

    Args:
        metrics: single metric, list/tuple of metrics, or dict name -> metric.
        prefix / postfix: added to each output key.
        compute_groups: True (auto-detect), False (disable), or an explicit
            list of lists of metric names.
        device: where every member's state lives; ``None`` (default) is the
            current CUDA device and raises without one, ``"cpu"`` opts out.
            Members on another device are moved there.
        reduce: the reduction policy applied to EVERY member: ``"step"`` or
            ``"deferred"`` (local accumulation, each declared reduction
            applied once at the read point). ``None`` (default) leaves each
            member's own policy.
        executor: route the collection's ``update``/``forward`` through ONE
            captured dispatch once the compute groups are resolved
            (``ops/executor.py``); ``None`` (default) follows
            ``TORCHMETRICS_TPU_EXECUTOR`` on the card and is off on the CPU;
            ``False`` keeps the per-group loop (members may still use their
            own executors). It engages while every group leader's own
            executor is enabled and eligible; where it does not, the
            members run eagerly.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MetricCollection
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy, BinaryPrecision
        >>> coll = MetricCollection([BinaryAccuracy(device="cpu"), BinaryPrecision(device="cpu")], device="cpu")
        >>> coll.update(torch.tensor([0.2, 0.8, 0.3, 0.6]), torch.tensor([0, 1, 1, 0]))
        >>> {k: round(float(v), 4) for k, v in coll.compute().items()}
        {'BinaryAccuracy': 0.5, 'BinaryPrecision': 0.5}
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        device: Union[str, torch.device, None] = None,
        reduce: Optional[str] = None,
        executor: Optional[bool] = None,
    ) -> None:
        if reduce is not None and reduce not in REDUCE_POLICIES:
            raise ValueError(f"Expected keyword argument `reduce` to be one of {REDUCE_POLICIES} but got {reduce}")
        if executor is not None and not isinstance(executor, bool):
            raise ValueError(f"Expected keyword argument `executor` to be a `bool` but got {executor}")
        self._executor_enabled = executor
        self._executor_obj: Optional[Any] = None
        self.reduce_policy = reduce
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._device = resolve_device(device)
        self._modules: Dict[str, Metric] = {}
        self.add_metrics(metrics, *additional_metrics)

    # --------------------------------------------------------------- plumbing
    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(_PREFIX_SUFFIX_ERROR.format(name, arg))

    @property
    def device(self) -> torch.device:
        return self._device

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Add metrics to the collection."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                raise ValueError(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )
        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `torchmetrics_tpu_torch.Metric` or `torchmetrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[f"{name}_{k}"] = v
        elif isinstance(metrics, (list, tuple)):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `torchmetrics_tpu_torch.Metric` or `torchmetrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")
        for m in self._modules.values():
            if m.device != self._device:
                m.to(self._device)
        if self.__dict__.get("reduce_policy") is not None:
            for name, m in self._modules.items():
                if self.reduce_policy == "deferred" and m.dist_sync_on_step:
                    raise ValueError(
                        f"Member {name!r} has dist_sync_on_step=True, which conflicts with the"
                        " collection's reduce='deferred' policy (a per-step sync IS the step policy)"
                    )
                m.reduce_policy = self.reduce_policy
        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {i: [name] for i, name in enumerate(self._modules)}

    def _init_compute_groups(self) -> None:
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for v in self._groups.values():
                for metric in v:
                    if metric not in self._modules:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the collection."
                        )
            self._groups_checked = True
        else:
            # start with all metrics in their own group; merged after first update
            self._groups = {i: [name] for i, name in enumerate(self._modules)}

    # ----------------------------------------------------------- dict protocol
    def keys(self, keep_base: bool = False) -> Iterable[str]:
        if keep_base:
            return self._modules.keys()
        return [self._set_name(k) for k in self._modules]

    def values(self) -> Iterable[Metric]:
        return self._modules.values()

    def items(self, keep_base: bool = False, copy_state: bool = False) -> Iterable[Tuple[str, Metric]]:
        """Name, member pairs (``copy_state`` is accepted as in the JAX
        package: members are handed out as they are)."""
        if keep_base:
            return self._modules.items()
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    def __getitem__(self, key: str) -> Metric:
        if key in self._modules:
            return self._modules[key]
        for k in self._modules:
            if self._set_name(k) == key:
                return self._modules[k]
        raise KeyError(key)

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self.keys()

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    @property
    def update_count(self) -> int:
        """Updates committed into the collection (group leaders advance in lockstep)."""
        return max((m.update_count for m in self._modules.values()), default=0)

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state.pop("_update_observers", None)  # autosavers and fault hooks stay with the original
        state["_executor_obj"] = None  # captured graphs are process-local
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self.__dict__.setdefault("_executor_obj", None)
        self.__dict__.setdefault("_executor_enabled", None)

    # ---------------------------------------------------- captured dispatch
    def _executor_on(self) -> bool:
        enabled = self.__dict__.get("_executor_enabled")
        if enabled is not None:
            return enabled
        from torchmetrics_tpu_torch.ops.executor import executor_enabled_default

        return self._device.type == "cuda" and executor_enabled_default()

    def _get_executor(self) -> Any:
        """The lazily built collection executor, or None when it is off."""
        if not self._executor_on():
            return None
        if self._executor_obj is None:
            from torchmetrics_tpu_torch.ops.executor import CollectionExecutor

            self._executor_obj = CollectionExecutor(self)
        return self._executor_obj

    def _consult_store(self) -> None:
        """Once the compute groups are known, the executor reads the
        collection's stored profile and builds its keys before its first
        call (``ops/compile_cache.py``)."""
        ex = self._get_executor()
        if ex is not None and ex._leader_executors() is not None:
            ex.consult_store()

    def _resolve_groups_for_warmup(self, args: tuple, kwargs: dict) -> None:
        if args and self._enable_compute_groups and not self._groups_checked:
            self.resolve_compute_groups(*args, **kwargs)
            self._compute_groups_create_state_ref()

    def warmup(self, batch_specs: Any, forward: bool = False, ladder: bool = True, background: bool = False) -> Any:
        """Build the collection's executor keys ahead of traffic (see
        :meth:`Metric.warmup` for the spec forms). The compute groups are
        resolved from the first spec's zero dummies first (the live states
        are untouched), so the keys are those ``update``/``forward`` hit."""
        from torchmetrics_tpu_torch.ops.executor import _normalize_warmup_specs

        specs = _normalize_warmup_specs(batch_specs, self._device)
        if specs:
            self._resolve_groups_for_warmup(*specs[0])
        ex = self._get_executor()
        if ex is None:
            return {"warmed": 0, "already_warm": 0, "skipped": ["executor disabled"], "seconds": 0.0}
        return ex.warmup(specs, forward=forward, ladder=ladder, background=background)

    def warmup_from_manifest(self, manifest: Any, background: bool = False) -> Any:
        """Build exactly the call shapes a :meth:`shape_profile` manifest
        recorded, the dict or a path :meth:`save_shape_profile` wrote
        (resolving the groups from its first spec)."""
        from torchmetrics_tpu_torch.ops.compile_cache import dummy_from_spec, load_shape_manifest

        if isinstance(manifest, (str, os.PathLike)):
            manifest = load_shape_manifest(os.fspath(manifest))
        specs = manifest.get("specs") or []
        if specs:
            self._resolve_groups_for_warmup(*dummy_from_spec(specs[0], self._device))
        ex = self._get_executor()
        if ex is None:
            return {"warmed": 0, "already_warm": 0, "skipped": ["executor disabled"], "seconds": 0.0}
        return ex.warmup_from_manifest(manifest, background=background)

    def shape_profile(self) -> Dict[str, Any]:
        """Replayable manifest of the call shapes the collection's executor
        has served (see :meth:`Metric.shape_profile`)."""
        ex = self._get_executor()
        if ex is None:
            from torchmetrics_tpu_torch.ops.executor import PROFILE_VERSION

            return {"profile_version": PROFILE_VERSION, "owner": type(self).__name__, "specs": []}
        return ex.shape_profile()

    def save_shape_profile(self, path: str) -> str:
        """Atomically write :meth:`shape_profile` as JSON at ``path``."""
        from torchmetrics_tpu_torch.ops.compile_cache import save_shape_manifest

        return save_shape_manifest(path, self.shape_profile())

    def set_background_compile(self, enabled: Optional[bool]) -> None:
        """Override stall-free background captures for the collection's
        executor and every member's (see :meth:`Metric.set_background_compile`;
        ``None`` restores the environment's default)."""
        ex = self._get_executor()
        if ex is not None:
            ex.set_background_compile(enabled)
        for m in self._modules.values():
            m.set_background_compile(enabled)

    # ------------------------------------------------------ update observers
    def add_update_observer(self, callback: Any) -> Any:
        """Register ``callback(collection)`` to fire once after every
        committed collection-level ``update``/``forward``: the autosave
        trigger point (``io/checkpoint.py``). Returns a detach function."""
        observers = self.__dict__.setdefault("_update_observers", [])
        observers.append(callback)

        def detach() -> None:
            current = self.__dict__.get("_update_observers")
            if current is not None and callback in current:
                current.remove(callback)

        return detach

    def _notify_update(self) -> None:
        observers = self.__dict__.get("_update_observers")
        if observers:
            for callback in tuple(observers):
                callback(self)

    @property
    def executor_status(self) -> Dict[str, Any]:
        """The collection executor's diagnosis plus each member's (see
        :attr:`Metric.executor_status`)."""
        from torchmetrics_tpu_torch.ops.executor import executor_stats

        enabled = self._executor_on()
        stats = executor_stats(self)
        return {
            "enabled": enabled,
            "engaged": stats["calls"] > 0,
            "fallback_reason": None if enabled is False else stats.get("fallback_reason"),
            "deferred_pending": any(m.deferred_pending for m in self._modules.values()),
            "stats": stats,
            "kernels": gate_snapshot(),
            "members": {name: m.executor_status for name, m in self._modules.items()},
        }

    # ------------------------------------------------------------- metric API
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each compute group's leader once (every member before the
        groups are resolved), all inside one fusion scope; once they are, the
        collection's executor runs every leader's update as one dispatch
        when it can. With the collection's executor on, the members never
        use their own (they run eagerly where it does not run them); with
        ``executor=False`` they may."""
        ex = None
        if self._groups_checked:
            ex = self._get_executor()
            if ex is not None and ex.run_update(args, kwargs):
                self._compute_groups_create_state_ref()
                # each leader committed an update, as in the per-group loop:
                # its own observers (an autosaver, an integrity auditor) fire
                for cg in self._groups.values():
                    self._modules[cg[0]]._notify_update()
                self._notify_update()
                return
            members = [self._modules[cg[0]] for cg in self._groups.values()]
        else:
            members = list(self._modules.values())
        # with the collection's executor on, it is the one executor: members
        # run eagerly here (before the groups resolve, or where it cannot
        # engage), sharing their count launches as the eager loop does
        with shared_scope(), _metric_call(self) if self._executor_on() else nullcontext():
            for m in members:
                m.update(*args, **m._filter_kwargs(**kwargs))
        if self._groups_checked:
            if ex is not None:
                ex.eager_done()  # the eager trial of a captured key, if this was one
            self._compute_groups_create_state_ref()
        elif self._enable_compute_groups:
            self._merge_compute_groups()
            self._compute_groups_create_state_ref()
            self._groups_checked = True
            self._consult_store()
        self._notify_update()

    def _merge_compute_groups(self, trial_states: Optional[Dict[str, Dict[str, Any]]] = None) -> None:
        """Union groups whose states compare equal, O(n^2). With
        ``trial_states`` (name -> state) the comparison runs on those instead
        of the live states."""
        num_groups = len(self._groups)
        while True:
            for cg_idx1, cg_members1 in deepcopy(self._groups).items():
                for cg_idx2, cg_members2 in deepcopy(self._groups).items():
                    if cg_idx1 == cg_idx2:
                        continue
                    n1, n2 = cg_members1[0], cg_members2[0]
                    if self._equal_metric_states(
                        self._modules[n1],
                        self._modules[n2],
                        None if trial_states is None else trial_states[n1],
                        None if trial_states is None else trial_states[n2],
                    ):
                        self._groups[cg_idx1].extend(self._groups.pop(cg_idx2))
                        break
                else:
                    continue
                break
            if num_groups == len(self._groups):
                break
            num_groups = len(self._groups)
        self._groups = {i: v for i, v in enumerate(self._groups.values())}

    @staticmethod
    def _equal_metric_states(
        metric1: Metric,
        metric2: Metric,
        state1: Optional[Dict[str, Any]] = None,
        state2: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """True if both metrics hold identical states."""
        if not metric1._defaults or not metric2._defaults:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        if metric1._reductions != metric2._reductions:
            return False
        state1 = state1 if state1 is not None else metric1._state
        state2 = state2 if state2 is not None else metric2._state

        def same(a: torch.Tensor, b: torch.Tensor) -> bool:
            return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)

        for key in metric1._defaults:
            s1, s2 = state1[key], state2[key]
            if type(s1) != type(s2):  # noqa: E721
                return False
            if isinstance(s1, list):
                if len(s1) != len(s2) or not all(same(a, b) for a, b in zip(s1, s2)):
                    return False
            elif not same(s1, s2):
                return False
        return True

    def _compute_group_followers(self) -> set:
        """The names that share a leader's state (none before the groups are
        resolved)."""
        if not self._groups_checked:
            return set()
        return {name for cg in self._groups.values() for name in cg[1:]}

    def _compute_groups_create_state_ref(self) -> None:
        """Point follower states at the leader's tensors."""
        for cg in self._groups.values():
            m0 = self._modules[cg[0]]
            if len(cg) > 1:
                # the group's tensors are aliased by design: a leader's own
                # executor copies in every call (the collection's manages the
                # group as a whole)
                m0.__dict__["_state_shared"] = True
            for name in cg[1:]:
                follower = self._modules[name]
                for state in m0._defaults:
                    val = m0._state[state]
                    follower._state[state] = list(val) if isinstance(val, list) else val
                follower.__dict__["_state_shared"] = True
                follower.__dict__["_slot_ids"] = m0.__dict__.get("_slot_ids", frozenset())
                follower._update_count = m0._update_count
                follower._computed = None
                # followers read the leader's tensors: their deferred flags
                # describe the same state
                follower.__dict__["_reduced"] = m0.__dict__.get("_reduced", True)
                follower.__dict__["_pending_shards"] = m0.__dict__.get("_pending_shards")

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Batch values for every metric, one shared update per compute group.

        For groups whose members are all ``full_state_update=False``, the
        leader's batch state is computed once and every member derives both
        its batch value and its global-state merge from it.
        """
        res: Dict[str, Any] = {}
        if self._groups_checked and self._enable_compute_groups:
            ex = self._get_executor()
            fused = None if ex is None else ex.run_forward(args, kwargs)
            if fused is not None:
                self._compute_groups_create_state_ref()
                out, _ = _flatten_dict({self._set_name(k): v for k, v in fused.items()})
                self._notify_update()
                return out
        with shared_scope(), _metric_call(self) if self._executor_on() else nullcontext():
            if self._groups_checked and self._enable_compute_groups:
                for cg in self._groups.values():
                    self._forward_group(cg, res, args, kwargs)
                self._compute_groups_create_state_ref()
            else:
                res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self._modules.items()}
                if self._enable_compute_groups and not self._groups_checked:
                    self._merge_compute_groups()
                    self._compute_groups_create_state_ref()
                    self._groups_checked = True
        res, _ = _flatten_dict({self._set_name(k): v for k, v in res.items()})
        self._notify_update()
        return res

    def _forward_group(self, cg: List[str], res: Dict[str, Any], args: tuple, kwargs: dict) -> None:
        members = [(n, self._modules[n]) for n in cg]
        m0 = members[0][1]
        if len(cg) == 1 or not all(m.full_state_update is False and not m.dist_sync_on_step for _, m in members):
            for name, m in members:
                res[name] = m(*args, **m._filter_kwargs(**kwargs))
            return
        # transactional like Metric._forward_reduce_state_update: a raise from
        # the batch update, the merge, or any member's compute restores the
        # leader's pre-call state and count
        global_state = m0._state_snapshot()
        pre_count, pre_computed = m0._update_count, m0._computed
        try:
            batch_state = m0.functional_update(m0.functional_init(), *args, **m0._filter_kwargs(**kwargs))
            m0._state = {k: (list(v) if isinstance(v, list) else v) for k, v in batch_state.items()}
            m0._update_count += 1
            m0._reduce_states(global_state)
            m0._computed = None
            for name, m in members:
                res[name] = m.functional_compute(batch_state)
        except BaseException:
            m0._rollback(global_state, pre_count, pre_computed)
            raise

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def compute(self) -> Dict[str, Any]:
        return self._flatten_results({k: m.compute() for k, m in self._modules.items()})

    def compute_async(self) -> Any:
        """Non-blocking :meth:`compute`: one
        :class:`~torchmetrics_tpu_torch.ops.async_read.MetricFuture` resolving
        to the renamed, flattened result dict a blocking ``compute()`` would
        return for every member's state as of this call. Each member snapshots
        its own state here, and the worker runs the member bodies as ONE
        pipeline job."""
        from torchmetrics_tpu_torch.ops import async_read as _async

        owner = type(self).__name__
        with obs.span(obs.SPAN_COMPUTE_ASYNC, suffix=owner):
            bodies = {name: m._prepare_async_read() for name, m in self._modules.items()}

            def job() -> Dict[str, Any]:
                return self._flatten_results({name: body() for name, body in bodies.items()})

            return _async.get_pipeline().submit(job, owner=owner, submitted_count=int(self.update_count))

    def _flatten_results(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Flatten dict-valued metric results with prefix dedup."""
        _, duplicates = _flatten_dict({k: v for k, v in result.items() if isinstance(v, dict)})
        flat = {}
        for k, res in result.items():
            if isinstance(res, dict):
                for sub_k, sub_v in res.items():
                    flat[f"{self._set_name(k)}_{sub_k}" if duplicates else self._set_name(sub_k)] = sub_v
            else:
                flat[self._set_name(k)] = res
        return flat

    # ------------------------------------------------------ pure/functional API
    #
    # Collection states live in a dict keyed by compute-group leader, so a
    # step pays one `update` per GROUP, not per metric. Auto-grouping compares
    # post-update states: call `resolve_compute_groups(example_batch)` once
    # (or pass an explicit `compute_groups=[[...]]`) before the first
    # functional_update.

    def resolve_compute_groups(self, *args: Any, **kwargs: Any) -> Dict[int, List[str]]:
        """Resolve compute groups from one example batch without touching live
        state: every member's ``functional_update`` runs on a fresh state and
        members whose resulting states compare equal are unioned. Idempotent.

        Example:
            >>> import torch
            >>> from torchmetrics_tpu_torch import MetricCollection
            >>> from torchmetrics_tpu_torch.classification import MulticlassF1Score, MulticlassRecall
            >>> coll = MetricCollection(
            ...     [MulticlassF1Score(num_classes=3, device="cpu"), MulticlassRecall(num_classes=3, device="cpu")],
            ...     device="cpu")
            >>> preds, target = torch.tensor([0, 1, 2, 1]), torch.tensor([0, 2, 2, 1])
            >>> sorted(len(g) for g in coll.resolve_compute_groups(preds, target).values())
            [2]
            >>> states = coll.functional_update(coll.functional_init(), preds, target)
            >>> {k: round(float(v), 4) for k, v in sorted(coll.functional_compute(states).items())}
            {'MulticlassF1Score': 0.7778, 'MulticlassRecall': 0.8333}
        """
        if self._enable_compute_groups and not self._groups_checked:
            with shared_scope():
                trial = {
                    name: m.functional_update(m.functional_init(), *args, **m._filter_kwargs(**kwargs))
                    for name, m in self._modules.items()
                }
            self._merge_compute_groups(trial_states=trial)
            self._groups_checked = True
        return self._groups

    def functional_init(self) -> Dict[str, Dict[str, Any]]:
        """Fresh default states, one per compute-group leader."""
        return {cg[0]: self._modules[cg[0]].functional_init() for cg in self._groups.values()}

    def functional_update(self, states: Dict[str, Dict[str, Any]], *args: Any, **kwargs: Any) -> Dict[str, Dict[str, Any]]:
        """Pure update: one leader ``functional_update`` per compute group,
        sharing one counting kernel launch through the fusion scope."""
        out: Dict[str, Dict[str, Any]] = {}
        with shared_scope():
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                out[cg[0]] = m0.functional_update(states[cg[0]], *args, **m0._filter_kwargs(**kwargs))
        return out

    # ------------------------------------------------- sharded (deferred) API
    def init_sharded_states(self, num_shards: int) -> Dict[str, Dict[str, Any]]:
        """Fresh states in the deferred layout (a leading shard axis on every
        field), one tree per group leader. Step shard ``s`` with
        :meth:`functional_update` on ``{leader: {k: v[s]}}``."""
        return init_sharded_states(self.functional_init(), num_shards)

    def sharded_state_spec(self, axis_name: str = "batch") -> Dict[str, Any]:
        """Per leader and field, the axis the shard axis occupies (0); see
        :meth:`Metric.sharded_state_spec`."""
        return {cg[0]: self._modules[cg[0]].sharded_state_spec(axis_name) for cg in self._groups.values()}

    def reduce_sharded_states(
        self, states: Dict[str, Dict[str, Any]], process_group: Any = None
    ) -> Dict[str, Dict[str, Any]]:
        """The deferred read point of the whole collection: fold every
        leader's local shard axis, then, in an initialised process group,
        ONE :meth:`functional_sync` (one collective per reduction, dtype and
        quantization spec across every compute group)."""
        folded = {
            leader: fold_sharded_states(
                {k: v for k, v in sub.items() if k not in Metric._RESERVED_STATE_KEYS}, self._modules[leader]._reductions
            )
            for leader, sub in states.items()
        }
        if not any(m.distributed_available_fn() for m in self._modules.values()):
            return folded
        return self.functional_sync(folded, process_group)

    def reshard_states(self, states: Dict[str, Dict[str, Any]], to_num_shards: int) -> Dict[str, Dict[str, Any]]:
        """Re-split every leader's stacked state onto ``to_num_shards``
        through :meth:`Metric.reshard_state` (``parallel/reshard.py``)."""
        return {leader: self._modules[leader].reshard_state(sub, to_num_shards) for leader, sub in states.items()}

    def functional_sync(
        self, states: Dict[str, Dict[str, Any]], process_group: Any = None
    ) -> Dict[str, Dict[str, Any]]:
        """Pure sync with cross-group fusion: ``states -> states`` reduced
        across ranks.

        Every plain leader's fields (and its ``"_update_count"``, an int64
        ``sum``) go through ONE :func:`~torchmetrics_tpu_torch.parallel.sync.sync_states`
        per process group, so a collection of count metrics costs one
        ``all_reduce`` per (reduction, dtype) for the whole collection, and
        all its list fields one metadata gather. A leader with its own
        ``dist_sync_fn``, or a subclass overriding ``functional_sync``, keeps
        its own path. ``process_group`` overrides each leader's own.
        """
        count_key = Metric._STATE_COUNT_KEY
        out: Dict[str, Dict[str, Any]] = {}
        by_group: Dict[int, Tuple[Any, List[str]]] = {}
        for leader, st in states.items():
            m = self._modules[leader]
            if m.dist_sync_fn is not None or type(m).functional_sync is not Metric.functional_sync:
                out[leader] = m.functional_sync(st, process_group)
                continue
            group = process_group if process_group is not None else m.process_group
            by_group.setdefault(id(group), (group, []))[1].append(leader)
        for group, leaders in by_group.values():
            flat: Dict[str, Any] = {}
            reductions: Dict[str, Any] = {}
            qspecs: Dict[str, Any] = {}
            for leader in leaders:
                # each leader's resolved precision rides into the fused call:
                # a quantized field fuses only with same-(bits, block) peers
                for field, spec in self._modules[leader]._sync_qspecs().items():
                    qspecs[f"{leader}\x00{field}"] = spec
                for field, value in states[leader].items():
                    key = f"{leader}\x00{field}"
                    if field == count_key:
                        flat[key] = torch.as_tensor(value, dtype=torch.int64, device=self._device)
                        reductions[key] = "sum"
                    else:
                        flat[key] = value
                        reductions[key] = self._modules[leader]._reductions.get(field)
            timeouts = [self._modules[leader].sync_timeout for leader in leaders]
            timeout = min((t for t in timeouts if t is not None), default=None)
            synced = sync_states(flat, reductions, group, timeout=timeout, device=self._device, qspecs=qspecs)
            for leader in leaders:
                out[leader] = {field: synced[f"{leader}\x00{field}"] for field in states[leader]}
        return {leader: out[leader] for leader in states}

    def functional_compute(self, states: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Pure compute: every member reads its group leader's state."""
        result: Dict[str, Any] = {}
        for cg in self._groups.values():
            st = states[cg[0]]
            for name in cg:
                result[name] = self._modules[name].functional_compute(st)
        return self._flatten_results(result)

    def functional_forward(
        self, states: Dict[str, Dict[str, Any]], *args: Any, update_count: Optional[int] = None, **kwargs: Any
    ) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, Any]]:
        """Pure forward: ``(states, batch) -> (states', batch_values)``; pass
        ``update_count`` so ``"mean"``-reduced states merge count-weighted."""
        new_states: Dict[str, Dict[str, Any]] = {}
        result: Dict[str, Any] = {}
        counts = (update_count, 1) if update_count is not None else None
        with shared_scope():
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                batch_state = m0.functional_update(m0.functional_init(), *args, **m0._filter_kwargs(**kwargs))
                new_states[cg[0]] = m0.merge_states(states[cg[0]], batch_state, counts=counts)
                for name in cg:
                    result[name] = self._modules[name].functional_compute(batch_state)
        return new_states, self._flatten_results(result)

    def merge_states(
        self,
        a: Dict[str, Dict[str, Any]],
        b: Dict[str, Dict[str, Any]],
        counts: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, Dict[str, Any]]:
        """Merge two collection states per each leader's declared reductions."""
        return {leader: self._modules[leader].merge_states(a[leader], b[leader], counts=counts) for leader in a}

    def state(self) -> Dict[str, Dict[str, Any]]:
        """Live states in the functional layout: one state per group leader."""
        return {cg[0]: self._modules[cg[0]].state() for cg in self._groups.values()}

    def state_spec(self) -> Dict[str, Any]:
        """Per-group-leader :meth:`Metric.state_spec`."""
        return {cg[0]: self._modules[cg[0]].state_spec() for cg in self._groups.values()}

    def load_state(
        self,
        states: Dict[str, Dict[str, Any]],
        update_count: Optional[int] = None,
        validate: str = "strict",
        check_finite: bool = False,
        sharded: Optional[bool] = None,
    ) -> None:
        """Install leader-keyed states into every member of each group
        (``sharded`` as in :meth:`Metric.load_state`).

        The saved keys reflect the SOURCE collection's groups, which may be
        coarser than this one's (saved after auto-grouping, loaded into a
        fresh collection with singleton groups). A leader missing from
        ``states`` takes the unique saved state whose field names, shapes and
        dtypes match its own defaults; ambiguity raises.
        """

        def signature(st: Dict[str, Any], reserved: Tuple[str, ...], saved: bool = True) -> tuple:
            # a stacked (sharded) saved state matches by its per-shard shape
            stacked = sharded or (sharded is None and st.get(Metric._STATE_SHARDS_KEY) is not None)
            lead = 1 if (saved and stacked) else 0
            return tuple(
                sorted(
                    (k, tuple(getattr(v, "shape", ()))[lead:], str(getattr(v, "dtype", "")).replace("torch.", ""))
                    for k, v in st.items()
                    if k not in reserved
                )
            )

        for cg in self._groups.values():
            if cg[0] in states:
                st = states[cg[0]]
            else:
                reserved = self._modules[cg[0]]._RESERVED_STATE_KEYS
                want = signature(self._modules[cg[0]].functional_init(), reserved, saved=False)
                cands = [k for k, v in states.items() if signature(v, reserved) == want]
                if len(cands) != 1:
                    raise KeyError(
                        f"state missing group leader {cg[0]!r} and"
                        f" {'no' if not cands else 'multiple'} saved states match its layout"
                        f" (candidates: {cands}); save and load with the same compute-group"
                        " resolution to disambiguate"
                    )
                st = states[cands[0]]
                if cands[0] not in self._modules:
                    rank_zero_warn(
                        f"load_state: group leader {cg[0]!r} not in saved states; matched saved"
                        f" state {cands[0]!r} (not a member of this collection) by field-layout"
                        " signature only. Verify the states were saved from an equivalent"
                        " collection."
                    )
            for name in cg:
                extra = {} if sharded is None else {"sharded": sharded}
                self._modules[name].load_state(
                    st, update_count=update_count, validate=validate, check_finite=check_finite, **extra
                )

    def reset(self) -> None:
        for m in self._modules.values():
            m.reset()
        if self._enable_compute_groups and self._groups_checked:
            self._compute_groups_create_state_ref()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix is not None:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix is not None:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def to(self, device: Union[str, torch.device]) -> "MetricCollection":
        self._device = resolve_device(device)
        self._executor_obj = None  # its slots and graphs live on the old device
        for m in self._modules.values():
            m.to(self._device)
        if self._groups_checked:
            self._compute_groups_create_state_ref()
        return self

    def plot(self, val: Optional[Dict[str, Any]] = None, ax: Any = None, together: bool = False) -> Any:
        """Plot every member's value (by default ``compute()``) into one
        axes, a point or a line per member; needs matplotlib. ``together``
        is accepted as in the JAX package, which draws one axes either way."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(val, ax=ax)

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    def windowed(self, window: int = 8, lateness: int = 0, **kwargs: Any) -> Any:
        """A :class:`~torchmetrics_tpu_torch.windows.WindowedCollection`
        stacking W per-window copies of every member's state on a ring axis:
        the whole suite advances its windows together (``windows.py``)."""
        from torchmetrics_tpu_torch.windows import WindowedCollection

        return WindowedCollection(self, window=window, lateness=lateness, **kwargs)

    def laned(self, capacity: int = 8, max_capacity: Optional[int] = None, **kwargs: Any) -> Any:
        """A :class:`~torchmetrics_tpu_torch.lanes.LanedCollection` holding N
        independent copies of every member's state, all sharing one
        session-to-lane table: the whole suite advances per traffic round
        (``lanes.py``)."""
        from torchmetrics_tpu_torch.lanes import LanedCollection

        return LanedCollection(self, capacity=capacity, max_capacity=max_capacity, **kwargs)

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        for k, v in self._modules.items():
            repr_str += f"\n  {k}: {v!r},"
        return repr_str + "\n)"
