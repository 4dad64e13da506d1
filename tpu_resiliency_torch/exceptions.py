"""Package-wide exception types.

A copy of ``tpu_resiliency/exceptions.py`` (the port imports nothing of the JAX
package). Analogue of the reference's ``inprocess/exception.py`` (RestartError /
RestartAbort / HealthCheckError / InternalError / TimeoutError family).
"""

from __future__ import annotations


class ResiliencyError(Exception):
    """Base class for all tpu_resiliency_torch errors."""


class StoreError(ResiliencyError):
    """Coordination-store protocol or transport failure."""


class StoreTransportError(StoreError):
    """The store connection died mid-operation (reset, EOF, socket error).

    Distinct from :class:`StoreError` proper so the client's retry layer can
    tell a recoverable transport blip (reconnect and reissue) from a server-side
    failure (an error *response* — retrying would repeat the same answer)."""


class StoreShutdownError(StoreTransportError):
    """The server announced teardown while this op was parked: it did not
    complete and the endpoint is going away.

    A transport-class failure (HA clique clients fail it over to the
    successor shard exactly like a SIGKILL'd shard) — but definitive, so the
    retry layer fails fast instead of burning its budget reconnecting to a
    server that just said goodbye."""


class StoreTimeoutError(StoreError, TimeoutError):
    """A blocking store operation (get/wait/barrier) timed out."""


class BarrierTimeout(StoreTimeoutError):
    """A distributed barrier did not complete within its timeout."""


class BarrierOverflow(StoreError):
    """More participants arrived at a barrier than its declared world size.

    The reference detects the same condition in ``inprocess/store.py:200-202``.
    """


class RestartError(ResiliencyError):
    """Base class for in-process restart errors."""


class RestartAbort(RestartError):
    """Terminal condition: the restart loop must stop retrying (reference
    ``inprocess/initialize.py:53-93`` raises this from RetryController)."""


class HealthCheckError(ResiliencyError):
    """A rank failed its post-fault health check and must not rejoin."""


class InternalError(ResiliencyError):
    """Invariant violation inside the resiliency machinery itself."""


class FaultToleranceError(ResiliencyError):
    """Watchdog / rank-monitor protocol failure."""


class CheckpointError(ResiliencyError):
    """Checkpoint save/load/replication failure."""
