"""Carry an exported metric state across from the JAX package."""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric


def _to_tensors(state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    def leaf(v: Any) -> Any:
        if isinstance(v, (list, tuple)):
            return [torch.tensor(np.asarray(el)).to(device) for el in v]
        return torch.tensor(np.asarray(v)).to(device)

    return {k: (int(np.asarray(v)) if k == Metric._STATE_COUNT_KEY else leaf(v)) for k, v in state.items()}


def load_numpy_state(target: Union[Metric, MetricCollection], state: Dict[str, Any]) -> None:
    """Load a JAX-package ``state()`` export into a port metric or collection.

    ``state`` is the export with every leaf converted to numpy by the caller
    (``_update_count`` included): one field dict for a metric, or one per
    compute-group leader for a collection. Leaves are placed on the target's
    device and cast to its declared dtypes; shapes and structure are checked
    as in ``load_state``, and accumulation continues from the loaded count.

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.classification import BinaryStatScores
        >>> from torchmetrics_tpu_torch.utils.convert import load_numpy_state
        >>> m = BinaryStatScores(device="cpu")
        >>> exported = {k: np.asarray(v, np.int32) for k, v in dict(tp=3, fp=1, tn=4, fn=2).items()}
        >>> load_numpy_state(m, {**exported, "_update_count": 2})
        >>> m.compute().tolist(), m.update_count
        ([3, 1, 4, 2, 5], 2)
    """
    if isinstance(target, MetricCollection):
        states = {leader: _to_tensors(st, target.device) for leader, st in state.items()}
        target.load_state(states, validate="cast")
    else:
        target.load_state(_to_tensors(state, target.device), validate="cast")
