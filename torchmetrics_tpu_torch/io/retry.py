"""Capped exponential backoff for the cross-process sync.

A sync fails in two time signatures. A *transient* failure (a collective
aborted while a peer restarts) succeeds on a re-attempt seconds later, so
``Metric(on_sync_failure="retry")`` re-runs the whole sync with capped
exponential backoff and jitter before it propagates. A *stall* (a peer that
died) never returns; ``sync_timeout`` turns it into a
:class:`~torchmetrics_tpu_torch.utils.exceptions.SyncTimeoutError` first.

The count of re-attempts is ``sync_retries`` or, when that is not given,
``TORCHMETRICS_TPU_SYNC_RETRIES`` (default 3).
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple, Type, Union

from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

#: env var: how many times a failed sync re-attempts under
#: ``on_sync_failure="retry"`` (int >= 0)
SYNC_RETRIES_ENV = "TORCHMETRICS_TPU_SYNC_RETRIES"

#: the retry count when ``on_sync_failure="retry"`` is chosen and neither
#: ``sync_retries`` nor the env var is set
DEFAULT_SYNC_RETRIES = 3


def default_sync_retries() -> int:
    """Retry count for ``on_sync_failure="retry"`` (``TORCHMETRICS_TPU_SYNC_RETRIES``)."""
    raw = os.environ.get(SYNC_RETRIES_ENV, "").strip()
    if not raw:
        return DEFAULT_SYNC_RETRIES
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{SYNC_RETRIES_ENV} must be an integer retry count, got {raw!r}")
    if value < 0:
        raise ValueError(f"{SYNC_RETRIES_ENV} must be >= 0, got {value}")
    return value


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with jitter.

    ``delay(k) = min(max_delay, base_delay * multiplier**k) * (1 + U(-jitter, jitter))``
    for attempt k in [0, max_retries). ``jitter=0`` makes the schedule
    deterministic; the default de-synchronises ranks retrying the same
    rendezvous.
    """

    max_retries: int = 3
    base_delay: float = 0.05
    max_delay: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.25

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be >= 0")
        if not 0 <= self.jitter < 1:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")


def backoff_delays(policy: RetryPolicy, seed: Optional[int] = None) -> Iterator[float]:
    """The policy's delay schedule, one value per retry attempt.

    >>> [round(d, 3) for d in backoff_delays(RetryPolicy(max_retries=4, jitter=0.0))]
    [0.05, 0.1, 0.2, 0.4]
    """
    rng = random.Random(seed)
    for k in range(policy.max_retries):
        delay = min(policy.max_delay, policy.base_delay * policy.multiplier**k)
        if policy.jitter:
            delay *= 1.0 + rng.uniform(-policy.jitter, policy.jitter)
        yield delay


def call_with_retries(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    retry_on: Union[Type[BaseException], Tuple[Type[BaseException], ...]] = Exception,
    no_retry_on: Tuple[Type[BaseException], ...] = (),
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    what: str = "call",
) -> Any:
    """Run ``fn`` with up to ``policy.max_retries`` backed-off re-attempts.

    ``no_retry_on`` exceptions propagate at once even when they match
    ``retry_on``; once the budget is spent the last failure propagates.
    ``on_retry(attempt, error, delay)`` fires before each sleep (else a
    rank-zero debug line is logged).
    """
    delays = backoff_delays(policy)
    attempt = 0
    while True:
        try:
            return fn()
        except no_retry_on:
            raise
        except retry_on as err:
            delay = next(delays, None)
            if delay is None:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, err, delay)
            else:
                rank_zero_debug(
                    f"torchmetrics_tpu_torch retry: {what} failed ({type(err).__name__}: {err});"
                    f" attempt {attempt}/{policy.max_retries} in {delay:.3f}s"
                )
            sleep(delay)
