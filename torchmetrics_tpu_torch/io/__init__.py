"""Durability: the atomic snapshot store, autosave and preemption flush
(``io/checkpoint.py``), and the transient-failure policy of the sync and
the executor's dispatch, with the stall watchdog (``io/retry.py``)."""
from torchmetrics_tpu_torch.io.checkpoint import (
    Autosaver,
    PreemptionHandle,
    atomic_write_bytes,
    install_preemption_handler,
    load_manifest,
    restore_state,
    save_state,
)
from torchmetrics_tpu_torch.io.retry import (
    RetryPolicy,
    backoff_delays,
    call_with_retries,
    default_dispatch_deadline,
    default_dispatch_retries,
    default_sync_retries,
    stall_watchdog,
)

__all__ = [
    "Autosaver",
    "PreemptionHandle",
    "RetryPolicy",
    "atomic_write_bytes",
    "backoff_delays",
    "call_with_retries",
    "default_dispatch_deadline",
    "default_dispatch_retries",
    "default_sync_retries",
    "install_preemption_handler",
    "load_manifest",
    "restore_state",
    "save_state",
    "stall_watchdog",
]
