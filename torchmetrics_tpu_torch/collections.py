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
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.metric import Metric, resolve_device
from torchmetrics_tpu_torch.ops.kernels import shared_scope
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
    ) -> None:
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

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:
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

    # ------------------------------------------------------------- metric API
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each compute group's leader once (every member before the
        groups are resolved), all inside one fusion scope."""
        members = (
            [self._modules[cg[0]] for cg in self._groups.values()]
            if self._groups_checked
            else list(self._modules.values())
        )
        with shared_scope():
            for m in members:
                m.update(*args, **m._filter_kwargs(**kwargs))
        if self._groups_checked:
            self._compute_groups_create_state_ref()
        elif self._enable_compute_groups:
            self._merge_compute_groups()
            self._compute_groups_create_state_ref()
            self._groups_checked = True

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

    def _compute_groups_create_state_ref(self) -> None:
        """Point follower states at the leader's tensors."""
        for cg in self._groups.values():
            m0 = self._modules[cg[0]]
            for name in cg[1:]:
                follower = self._modules[name]
                for state in m0._defaults:
                    val = m0._state[state]
                    follower._state[state] = list(val) if isinstance(val, list) else val
                follower._update_count = m0._update_count
                follower._computed = None

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Batch values for every metric, one shared update per compute group.

        For groups whose members are all ``full_state_update=False``, the
        leader's batch state is computed once and every member derives both
        its batch value and its global-state merge from it.
        """
        res: Dict[str, Any] = {}
        with shared_scope():
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
    ) -> None:
        """Install leader-keyed states into every member of each group.

        The saved keys reflect the SOURCE collection's groups, which may be
        coarser than this one's (saved after auto-grouping, loaded into a
        fresh collection with singleton groups). A leader missing from
        ``states`` takes the unique saved state whose field names, shapes and
        dtypes match its own defaults; ambiguity raises.
        """

        def signature(st: Dict[str, Any]) -> tuple:
            return tuple(
                sorted(
                    (k, tuple(getattr(v, "shape", ())), str(getattr(v, "dtype", "")).replace("torch.", ""))
                    for k, v in st.items()
                    if k != Metric._STATE_COUNT_KEY
                )
            )

        for cg in self._groups.values():
            if cg[0] in states:
                st = states[cg[0]]
            else:
                want = signature(self._modules[cg[0]].functional_init())
                cands = [k for k, v in states.items() if signature(v) == want]
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
                self._modules[name].load_state(
                    st, update_count=update_count, validate=validate, check_finite=check_finite
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
        for m in self._modules.values():
            m.to(self._device)
        if self._groups_checked:
            self._compute_groups_create_state_ref()
        return self

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        for k, v in self._modules.items():
            repr_str += f"\n  {k}: {v!r},"
        return repr_str + "\n)"
