"""Functional metrics (pure functions of tensors)."""
from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.classification import __all__ as _classification_all

__all__ = list(_classification_all)
