"""Framework exceptions (the subset of the JAX package's surface the port raises)."""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API."""


class TorchMetricsUserWarning(UserWarning):
    """Warning raised on questionable usage of the metric API."""


class StateCorruptionError(TorchMetricsUserError, KeyError):
    """A state pytree failed validation on restore.

    Raised by ``Metric.load_state(..., validate="strict"|"cast")`` when the
    incoming state's structure, shapes, dtypes, devices or (optionally)
    finiteness do not match the metric's :meth:`Metric.state_spec`. Also a
    ``KeyError`` so callers catching a missing-field error keep working.
    """

    def __str__(self) -> str:  # KeyError.__str__ repr-quotes the message
        return Exception.__str__(self)


class SyncTimeoutError(TorchMetricsUserError, TimeoutError):
    """A bounded cross-process sync did not complete within ``sync_timeout``.

    Raised by ``parallel/sync.py`` when a collective's work handle has not
    completed by the deadline and the metric's ``on_sync_failure`` policy is
    ``"raise"`` (under ``"local"`` the metric degrades to local-only state
    instead, flagged via ``Metric.last_sync_ok``; under ``"retry"`` the sync
    is retried with capped exponential backoff first, ``io/retry.py``).
    """
