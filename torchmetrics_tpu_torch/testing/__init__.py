"""Testing utilities: the fault-injection primitives of the port's runtime
layers (``testing/faults.py``), public so downstream evaluation stacks can
test their own metric pipelines the same way."""
from torchmetrics_tpu_torch.testing.faults import (
    FaultInjected,
    PreemptionInjected,
    corrupt_state,
    fail_lane_dispatch,
    grow_world,
    pause_async_reads,
    poison_batch,
    poison_session,
    preempt_after,
    raise_in_compute,
    raise_in_update,
    shrink_world,
    torn_write,
)

__all__ = [
    "FaultInjected",
    "PreemptionInjected",
    "corrupt_state",
    "fail_lane_dispatch",
    "grow_world",
    "pause_async_reads",
    "poison_batch",
    "poison_session",
    "preempt_after",
    "raise_in_compute",
    "raise_in_update",
    "shrink_world",
    "torn_write",
]
