"""Framework exceptions (the subset of the JAX package's surface the slice raises)."""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API."""


class StateCorruptionError(TorchMetricsUserError, KeyError):
    """A state pytree failed validation on restore.

    Raised by ``Metric.load_state(..., validate="strict"|"cast")`` when the
    incoming state's structure, shapes, dtypes, devices or (optionally)
    finiteness do not match the metric's :meth:`Metric.state_spec`. Also a
    ``KeyError`` so callers catching a missing-field error keep working.
    """

    def __str__(self) -> str:  # KeyError.__str__ repr-quotes the message
        return Exception.__str__(self)
