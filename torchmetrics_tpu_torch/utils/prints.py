"""Rank-zero-only warnings and log lines (rank = ``torch.distributed`` rank
when a process group is initialised, else 0)."""
from __future__ import annotations

import logging
import warnings
from functools import partial, wraps
from typing import Any, Callable

import torch

log = logging.getLogger("torchmetrics_tpu_torch")


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _process_zero_only(fn: Callable) -> Callable:
    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _rank() != 0:
            return None
        return fn(*args, **kwargs)

    return wrapped_fn


@_process_zero_only
def rank_zero_warn(message: str, category: type = UserWarning, stacklevel: int = 3, **kwargs: Any) -> None:
    warnings.warn(message, category=category, stacklevel=stacklevel, **kwargs)


rank_zero_info = _process_zero_only(partial(log.info))
rank_zero_debug = _process_zero_only(partial(log.debug))
