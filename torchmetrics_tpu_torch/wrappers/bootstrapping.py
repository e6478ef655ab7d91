"""BootStrapper: confidence estimates of a base metric from resampled batches.

Keeps ``num_bootstraps`` copies of the base metric; every update feeds each
copy a poisson or multinomial resample of the batch, and ``compute`` gives
the mean, standard deviation, quantiles or raw values over the copies.

The resample indices come from ``np.random.RandomState(seed)``, as in the
JAX package, so one seed gives both packages the same resamples. The
indices then move to the input's device (one small host-to-device copy a
replicate) and the batch is indexed there with ``index_select``: the batch
itself is never copied to the host.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import (
    WrapperMetric,
    _load_stacked_state,
    _on_base_device,
    _stacked_init,
    _stacked_state,
    _stacked_sync,
    _tree_map,
    _tree_stack,
    _unstack,
)


def _bootstrap_sampler(size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Resample indices of a batch of ``size``: poisson counts per sample
    (variable length) or ``size`` draws with replacement."""
    rng = rng or np.random
    if sampling_strategy == "poisson":
        p = rng.poisson(1, size)
        return np.repeat(np.arange(size), p)
    if sampling_strategy == "multinomial":
        return rng.randint(0, size, size)
    raise ValueError("Unknown sampling strategy")


def _batch_size(args: Sequence[Any], kwargs: Dict[str, Any]) -> int:
    sizes = [a.shape[0] for a in args if hasattr(a, "shape") and a.ndim > 0]
    sizes += [v.shape[0] for v in kwargs.values() if hasattr(v, "shape") and v.ndim > 0]
    if not sizes:
        raise ValueError("None of the input contained any tensor, so no sampling could be done")
    return sizes[0]


def _take(x: Any, idx: torch.Tensor) -> Any:
    """Rows ``idx`` of a batched tensor, indexed on its device; anything
    else passes through."""
    if isinstance(x, torch.Tensor) and x.ndim > 0:
        return x.index_select(0, idx)
    return x


def _quantile(vals: torch.Tensor, q: Any) -> torch.Tensor:
    """``jnp.quantile``'s default (linear interpolation) along the first axis."""
    return torch.quantile(vals, torch.as_tensor(q, dtype=vals.dtype, device=vals.device), dim=0)


class BootStrapper(WrapperMetric):
    """Bootstrapped confidence estimates of a base metric.

    Each update feeds every internal copy a poisson/multinomial resample of
    the batch; compute reports mean/std (and optional quantile/raw) across
    copies. Lives on the base metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import BootStrapper
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> preds = torch.tensor([0.2, 0.8, 0.3, 0.6])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> boot = BootStrapper(BinaryAccuracy(device="cpu"), num_bootstraps=4, seed=42)
        >>> boot.update(preds, target)
        >>> sorted(boot.compute().keys())
        ['mean', 'std']
    """

    full_state_update: Optional[bool] = True
    # every update draws a fresh host-side resample: a replay would repeat
    # one sample pattern for good
    executor_compatible: bool = False

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float], torch.Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of torchmetrics_tpu_torch.Metric but received {base_metric}"
            )
        super().__init__(**_on_base_device(base_metric.device, kwargs, "BootStrapper"))
        self.metrics: List[Metric] = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling} but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.RandomState(seed)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Feed each copy its resample of the batch (an empty poisson
        resample is skipped)."""
        size = _batch_size(args, kwargs)
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(size, self.sampling_strategy, self._rng)
            if sample_idx.size == 0:
                continue
            idx_t = torch.from_numpy(sample_idx)
            if self.device.type == "cuda":  # a stream-ordered copy: the host does not wait for the card
                idx_t = idx_t.pin_memory().to(self.device, non_blocking=True)
            new_args = [_take(a, idx_t) for a in args]
            new_kwargs = {k: _take(v, idx_t) for k, v in kwargs.items()}
            self.metrics[idx].update(*new_args, **new_kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        """Mean/std/quantile/raw over the copies' computes."""
        return self._summary(torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0))

    def _summary(self, vals: Any) -> Dict[str, Any]:
        """The requested statistics over the leading replicate axis of every
        leaf of ``vals`` (a tensor, or a dict of them)."""
        output_dict: Dict[str, Any] = {}
        if self.mean:
            output_dict["mean"] = _tree_map(lambda v: v.mean(0), vals)
        if self.std:
            output_dict["std"] = _tree_map(lambda v: v.std(0, correction=1), vals)
        if self.quantile is not None:
            output_dict["quantile"] = _tree_map(lambda v: _quantile(v, self.quantile), vals)
        if self.raw:
            output_dict["raw"] = vals
        return output_dict

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        return self.compute()

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()

    # ------------------------------------------------------ pure/functional API
    #
    # State leaves carry a leading ``num_bootstraps`` axis. Resampling must
    # have a fixed shape, so the functional path takes multinomial
    # (with-replacement, size-n) index matrices; poisson resamples exist only
    # on the stateful path.

    def functional_init(self) -> Dict[str, Any]:
        """Fresh default state with a leading ``num_bootstraps`` axis per leaf."""
        return _stacked_init(self.metrics[0], self.num_bootstraps)

    def functional_update(
        self, state: Dict[str, Any], *args: Any, key: Optional[torch.Generator] = None, indices: Any = None, **kwargs: Any
    ) -> Dict[str, Any]:
        """Pure update: ``(stacked_state, batch) -> stacked_state'``.

        Pass a ``torch.Generator`` as ``key`` (multinomial strategy only: a
        fixed-shape resample drawn on the generator's device) or an explicit
        ``indices`` array of shape ``(num_bootstraps, batch)`` selecting each
        replicate's resample.

        Example:
            >>> import torch
            >>> from torchmetrics_tpu_torch import MeanMetric
            >>> from torchmetrics_tpu_torch.wrappers import BootStrapper
            >>> boot = BootStrapper(MeanMetric(device="cpu"), num_bootstraps=4, sampling_strategy="multinomial")
            >>> state = boot.functional_init()
            >>> state = boot.functional_update(state, torch.tensor([1.0, 2.0, 3.0, 4.0]),
            ...                                key=torch.Generator().manual_seed(0))
            >>> out = boot.functional_compute(state)
            >>> sorted(out) == ['mean', 'std'] and bool(out['std'] >= 0)
            True
        """
        base = self.metrics[0]
        size = _batch_size(args, kwargs)
        if indices is None:
            if key is None:
                raise ValueError("functional_update needs either a `key` or an explicit `indices` array")
            if self.sampling_strategy != "multinomial":
                raise ValueError(
                    "The functional bootstrap path requires sampling_strategy='multinomial': poisson"
                    " resamples have data-dependent length and cannot be traced with static shapes."
                )
            indices = torch.randint(0, size, (self.num_bootstraps, size), generator=key, device=key.device)
        indices = torch.as_tensor(indices).to(self.device)
        if indices.ndim != 2 or indices.shape[0] != self.num_bootstraps:
            raise ValueError(
                f"Expected `indices` of shape (num_bootstraps={self.num_bootstraps}, n) but got {tuple(indices.shape)}"
            )
        out = []
        for idx, st in zip(indices, _unstack(state, self.num_bootstraps)):
            new_args = [_take(a, idx) for a in args]
            new_kwargs = {k: _take(v, idx) for k, v in kwargs.items()}
            out.append(base.functional_update(st, *new_args, **new_kwargs))
        return _tree_stack(out)

    def functional_sync(self, state: Dict[str, Any], process_group: Any = None) -> Dict[str, Any]:
        """Per-replicate sync by the base's declared reductions."""
        return _stacked_sync(self.metrics[0], state, self.num_bootstraps, process_group)

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any], counts: Any = None) -> Dict[str, Any]:
        """Replicate-wise merge: sum/mean/max/min folds are elementwise, so the
        base metric's merge applies directly to the stacked leaves."""
        return self.metrics[0].merge_states(a, b, counts=counts)

    def state(self) -> Dict[str, Any]:
        """Live per-replicate states in the functional stacked layout (or a
        ``replicates`` snapshot list for list-state bases)."""
        return _stacked_state(self.metrics)

    def load_state(self, state: Dict[str, Any], update_count: Optional[int] = None) -> None:
        _load_stacked_state(self.metrics, state, update_count=update_count)
        self._computed = None
        self._update_count = self._restored_count(update_count)

    def functional_compute(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Mean/std/quantile/raw across the replicate axis."""
        base = self.metrics[0]
        vals = _tree_stack([base.functional_compute(st) for st in _unstack(state, self.num_bootstraps)])
        return self._summary(vals)
