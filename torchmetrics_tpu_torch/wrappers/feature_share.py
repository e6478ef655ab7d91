"""FeatureShare: one cached feature network shared by several metrics.

Model-backed metrics hold a ``feature_extractor`` (or other named) callable;
FeatureShare replaces every member's callable with ONE memoizing wrapper of
the first member's, so a single forward pass serves FID, KID and MiFID. The
members must therefore read the same network at the same tap (FID, KID and
MiFID at ``feature=2048``; the Inception Score reads another tap).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric


class NetworkCache:
    """Memoize a feature function by input object identity.

    Tensors are keyed on ``id`` and shape. Each entry keeps its inputs alive
    beside the result, so an id cannot be recycled while its entry exists;
    the cache therefore holds up to ``max_size`` input batches and their
    features (on the card, where they live).
    """

    def __init__(self, network: Callable, max_size: int = 100) -> None:
        self.network = network
        self.max_size = max_size
        self._cache: "OrderedDict[tuple, Any]" = OrderedDict()

    @staticmethod
    def _key_part(v: Any) -> Any:
        if hasattr(v, "shape"):
            return (id(v), tuple(v.shape))
        return v

    def __call__(self, x: Any, *args: Any, **kwargs: Any) -> Any:
        key = (
            self._key_part(x),
            tuple(self._key_part(a) for a in args),
            tuple(sorted((k, self._key_part(v)) for k, v in kwargs.items())),
        )
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key][-1]
        out = self.network(x, *args, **kwargs)
        self._cache[key] = (x, args, kwargs, out)
        if len(self._cache) > self.max_size:
            self._cache.popitem(last=False)
        return out


class FeatureShare(MetricCollection):
    """MetricCollection that shares one cached feature extractor across
    members; it lives on its first member's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import FeatureShare
        >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance, KernelInceptionDistance
        >>> extractor = lambda x: x.mean(dim=(2, 3))
        >>> fs = FeatureShare([
        ...     FrechetInceptionDistance(feature_extractor=extractor, num_features=3, device="cpu"),
        ...     KernelInceptionDistance(feature_extractor=extractor, subsets=2, subset_size=3, device="cpu"),
        ... ])  # one extractor pass serves both metrics
        >>> real = (torch.arange(4 * 3 * 8 * 8).reshape(4, 3, 8, 8) % 255) / 255.0
        >>> fs.update(real, real=True)
        >>> fs.update(real * 0.7, real=False)
        >>> sorted(fs.compute().keys())
        ['FrechetInceptionDistance', 'KernelInceptionDistance']
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        max_cache_size: Optional[int] = None,
        extractor_attribute: str = "feature_extractor",
    ) -> None:
        members = [metrics] if isinstance(metrics, Metric) else list(metrics.values() if isinstance(metrics, dict) else metrics)
        super().__init__(metrics, device=members[0].device if members else None)
        if max_cache_size is None:
            max_cache_size = len(self)
        if not isinstance(max_cache_size, int):
            raise TypeError(f"max_cache_size should be an integer, but got {max_cache_size}")
        self.extractor_attribute = extractor_attribute

        extractors: List[Callable] = []
        for name, metric in self.items(keep_base=True, copy_state=False):
            fn = getattr(metric, extractor_attribute, None)
            if fn is None:
                raise AttributeError(
                    f"Tried to extract the network to share from the metric {name}, but it had no attribute"
                    f" {extractor_attribute!r}. Please raise an issue or pick metrics exposing one."
                )
            extractors.append(fn)

        shared = NetworkCache(extractors[0], max_size=max_cache_size)
        for _, metric in self.items(keep_base=True, copy_state=False):
            setattr(metric, extractor_attribute, shared)
