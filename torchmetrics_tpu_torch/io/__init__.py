"""Transient-failure policy of the cross-process sync (``io/retry.py``)."""
from torchmetrics_tpu_torch.io.retry import RetryPolicy, backoff_delays, call_with_retries, default_sync_retries

__all__ = ["RetryPolicy", "backoff_delays", "call_with_retries", "default_sync_retries"]
