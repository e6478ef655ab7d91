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


class CheckpointCorruptionError(StateCorruptionError):
    """A durable snapshot file is torn, truncated, or bit-rotted.

    Raised by ``torchmetrics_tpu_torch.io.checkpoint.restore_state`` when the
    file fails structural parsing (bad magic/manifest), its payload hash does
    not match the manifest (the torn-write signature), or a per-leaf sha256
    mismatches (bit flip). Distinct from a plain :class:`StateCorruptionError`
    (a well-formed file whose *contents* fail the metric's spec); a rotating
    store skips both in favour of an older valid snapshot.
    """


class TopologyMismatchError(StateCorruptionError):
    """A snapshot's saved topology does not match the restoring world.

    Raised by ``restore_state(..., topology="strict")`` when the manifest's
    topology block (shard layout, class sharding) disagrees with the world
    the restore runs in, and by ``topology="elastic"`` when the re-split it
    would need belongs to ``parallel/reshard.py``, which the port does not
    have yet. A rotating-store scan treats it like a torn file. Carries
    ``saved`` and ``current`` topology descriptors for diagnostics.
    """

    def __init__(self, message: str, saved=None, current=None) -> None:
        super().__init__(message)
        self.saved = saved
        self.current = current


class StateDivergenceError(StateCorruptionError):
    """Live or installed state failed a bit-exact fingerprint check.

    Raised by ``restore_state`` when the state a metric installed does not
    fingerprint-match the snapshot's pre-save fingerprints (surface
    ``"restore"``). A :class:`StateCorruptionError`, so a rotating-store scan
    falls back to the next older snapshot. Carries the attribution:
    ``surface``, the offending ``field``, the ``shard`` when one is
    implicated, and the ``expected``/``observed`` fingerprint words.
    """

    def __init__(self, message: str, surface=None, field=None, shard=None, expected=None, observed=None) -> None:
        super().__init__(message)
        self.surface = surface
        self.field = field
        self.shard = shard
        self.expected = expected
        self.observed = observed


class ShardLossError(TorchMetricsUserError):
    """A shard of deferred (locally accumulated) state is gone.

    The deferred layout keeps unreduced state only in its shards; losing one
    loses its accumulated counts. The bounded-lag host shadow
    (``parallel/reshard.py:ShardShadow``) is what a caller serves or
    reinstalls instead. Carries the (believed) lost ``shard`` index.
    """

    def __init__(self, message: str, shard=None) -> None:
        super().__init__(message)
        self.shard = shard


class LaneFaultError(TorchMetricsUserError):
    """A fault attributed to ONE session's lane in a laned dispatch.

    Raised by the lane fault-containment layer (``quarantine.py``,
    ``lanes.py``) when admission screening rejects a session's row, a
    dispatch failure is attributed to a session, or a read-point health scan
    finds a lane poisoned, under the ``on_lane_fault="raise"`` policy.
    Carries the attribution (``session_id``, ``lane``, ``where``) so callers,
    and the router's containment loop, can act on the single offending
    session instead of the whole dispatch.
    """

    def __init__(self, message: str, session_id=None, lane=None, where=None) -> None:
        super().__init__(message)
        self.session_id = session_id
        self.lane = lane
        self.where = where


class FleetProtocolError(TorchMetricsUserError):
    """A fleet delta-protocol invariant was violated (``fleet/``).

    Raised by the exactly-once uplink ledger and its neighbours when a delta
    cannot be merged safely: a delta offered to another leaf's ledger, an
    unknown delta kind or a non-positive epoch, a reduction with no wire
    mode, a ``cat`` field that shrank between exports, traffic for a leaf
    the aggregator does not own, or a degraded global read refused under
    ``allow_degraded=False``. Carries the attribution (``leaf``, ``epoch``,
    ``node``) so a handler can act on the one offending uplink instead of
    the whole fleet.
    """

    def __init__(self, message: str, leaf=None, epoch=None, node=None) -> None:
        super().__init__(message)
        self.leaf = leaf
        self.epoch = epoch
        self.node = node
