"""Transient-failure policy: capped exponential backoff and the stall watchdog.

A sync or a dispatch fails in two time signatures. A *transient* failure (a
collective aborted while a peer restarts) succeeds on a re-attempt seconds
later, so it is re-run with capped exponential backoff and jitter before it
propagates. A *stall* (a peer that died, a wedged call) never returns; a
deadline turns it into a typed error the caller can checkpoint and exit on.

The seams that use them:

- ``Metric(on_sync_failure="retry")``: the whole sync re-runs,
  ``sync_retries`` or ``TORCHMETRICS_TPU_SYNC_RETRIES`` (default 3) times;
  ``sync_timeout`` bounds each collective
  (:class:`~torchmetrics_tpu_torch.utils.exceptions.SyncTimeoutError`).
- ``TORCHMETRICS_TPU_DISPATCH_RETRIES``: the captured executor's warm
  dispatch re-runs (default 0) after the live state was kept at its pre-call
  slot (``ops/executor.py``).
- ``TORCHMETRICS_TPU_DISPATCH_DEADLINE``: seconds before an executor
  dispatch is declared stalled
  (:class:`~torchmetrics_tpu_torch.utils.exceptions.DispatchStallError`;
  off when unset).
"""
from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Generator, Iterator, Optional, Tuple, Type, Union

from torchmetrics_tpu_torch.utils.exceptions import DispatchStallError
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug

#: env var: how many times a failed sync re-attempts under
#: ``on_sync_failure="retry"`` (int >= 0)
SYNC_RETRIES_ENV = "TORCHMETRICS_TPU_SYNC_RETRIES"

#: env var: how many times a failed WARM executor dispatch re-attempts
#: (after the live state was kept at its pre-call slot) before propagating;
#: 0 (default) restores and raises
DISPATCH_RETRIES_ENV = "TORCHMETRICS_TPU_DISPATCH_RETRIES"

#: env var: seconds before an executor dispatch is declared stalled
#: (DispatchStallError); unset or 0 disables the watchdog
DISPATCH_DEADLINE_ENV = "TORCHMETRICS_TPU_DISPATCH_DEADLINE"

#: the retry count when ``on_sync_failure="retry"`` is chosen and neither
#: ``sync_retries`` nor the env var is set
DEFAULT_SYNC_RETRIES = 3


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer retry count, got {raw!r}")
    if value < 0:
        raise ValueError(f"{name} must be >= 0, got {value}")
    return value


def default_sync_retries() -> int:
    """Retry count for ``on_sync_failure="retry"`` (``TORCHMETRICS_TPU_SYNC_RETRIES``)."""
    return _env_int(SYNC_RETRIES_ENV, DEFAULT_SYNC_RETRIES)


def default_dispatch_retries() -> int:
    """Warm-dispatch retry count (``TORCHMETRICS_TPU_DISPATCH_RETRIES``, default 0)."""
    return _env_int(DISPATCH_RETRIES_ENV, 0)


def default_dispatch_deadline() -> Optional[float]:
    """Watchdog deadline in seconds (``TORCHMETRICS_TPU_DISPATCH_DEADLINE``), or None."""
    raw = os.environ.get(DISPATCH_DEADLINE_ENV, "").strip()
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(f"{DISPATCH_DEADLINE_ENV} must be a number of seconds, got {raw!r}")
    return value if value > 0 else None


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
    no_retry_on: Tuple[Type[BaseException], ...] = (DispatchStallError,),
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    what: str = "call",
) -> Any:
    """Run ``fn`` with up to ``policy.max_retries`` backed-off re-attempts.

    ``no_retry_on`` exceptions propagate at once even when they match
    ``retry_on`` (a :class:`DispatchStallError` by default: re-running a
    call that just hung for its whole deadline would park the loop for
    another one); once the budget is spent the last failure propagates.
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


# --------------------------------------------------------------- watchdog


@contextmanager
def stall_watchdog(
    deadline: Optional[float],
    what: str = "captured dispatch",
    status: Optional[Callable[[], Any]] = None,
) -> Generator[None, None, None]:
    """Bound a blocking call: raise :class:`DispatchStallError` at
    ``deadline`` seconds instead of hanging the loop.

    A wedged call blocks where no Python timeout reaches, so a watchdog
    thread delivers a real SIGINT to the main thread
    (``signal.pthread_kill``, which wakes a blocked syscall; the flag-only
    ``interrupt_main`` is the fallback) and the resulting
    ``KeyboardInterrupt`` becomes the typed error, carrying ``status()``
    breadcrumbs (the executor's stats). An application's own SIGINT handler
    (the preemption handler's flush) runs first.

    Only the MAIN thread can be interrupted: elsewhere the watchdog is a
    no-op (logged at debug level). ``deadline`` None or <= 0 disables it. The
    stalled call itself cannot be cancelled: treat a stall as the cue to
    checkpoint and exit, not to retry.
    """
    if deadline is None or deadline <= 0:
        yield
        return
    if threading.current_thread() is not threading.main_thread():
        rank_zero_debug(f"torchmetrics_tpu_torch stall_watchdog: not on the main thread; {what} runs unguarded")
        yield
        return
    main_ident = threading.main_thread().ident
    done = threading.Event()
    fired = threading.Event()

    def deliver() -> None:
        import signal as _signal

        try:
            _signal.pthread_kill(main_ident, _signal.SIGINT)
            return
        except (AttributeError, ProcessLookupError, OSError):
            pass
        import _thread

        _thread.interrupt_main()

    def watch() -> None:
        if not done.wait(deadline) and not done.is_set():
            fired.set()
            deliver()

    watcher = threading.Thread(target=watch, name="tm_tpu_watchdog", daemon=True)
    watcher.start()
    try:
        yield
    except KeyboardInterrupt:
        done.set()
        if fired.is_set():
            breadcrumbs = None
            if status is not None:
                try:
                    breadcrumbs = status()
                except Exception as err:  # breadcrumbs never mask the stall itself
                    rank_zero_debug(f"torchmetrics_tpu_torch stall_watchdog: status() failed ({err})")
            from torchmetrics_tpu_torch import obs  # deferred: io.retry loads before obs on some paths

            obs.counter_inc("watchdog.stalls")
            raise obs.flighted(
                DispatchStallError(
                    f"{what} did not complete within {deadline}s (stalled call;"
                    " checkpoint local state and restart this process)"
                    + (f"; executor_status={breadcrumbs}" if breadcrumbs is not None else ""),
                    executor_status=breadcrumbs,
                ),
                domain="dispatch",
                kind="dispatch_stall",
                persist=True,
                what=what,
                deadline_s=deadline,
                executor_status=breadcrumbs,
            ) from None
        raise
    else:
        done.set()
        if fired.is_set():
            # the call returned inside the race window after the watchdog
            # fired: absorb the in-flight interrupt here, not at a later
            # bytecode
            t_end = time.monotonic() + 0.2
            try:
                while time.monotonic() < t_end:
                    time.sleep(0.005)
                rank_zero_debug(f"torchmetrics_tpu_torch stall_watchdog: {what} completed at the deadline")
            except KeyboardInterrupt:
                pass
    finally:
        done.set()
