"""Resilient execution for the port's streamed fits.

Counterpart of ``keystone_tpu/resilience``:

* :mod:`.retry`: :class:`RetryPolicy` (exponential backoff with seeded
  jitter, per-attempt timeout, retryable classification) around chunk
  staging, and the producer watchdog's :class:`IngestTimeoutError`;
* :mod:`.quarantine`: :class:`Quarantine`, skip-but-account for corrupt
  records under a ``max_bad_fraction`` budget;
* :mod:`.stream_checkpoint`: :class:`StreamCheckpoint` and
  :func:`fit_fingerprint`, the atomic snapshot and bit-identical resume
  of a streamed fit;
* :mod:`.faults`: :class:`FaultPlan` / :func:`inject` /
  :func:`corrupt`, seeded fault injection at the ingest, serving and
  coordination sites, with the host-level kinds of a world.

Every event goes through :mod:`.events` into the ``resilience.*``
counters, the flight recorder and the active trace.
"""
from .events import record_event, set_process_dimension
from .faults import (
    HOST_DEATH_EXIT_CODE,
    FaultPlan,
    FaultSpec,
    InjectedFaultError,
    PartitionError,
    corrupt,
    inject,
)
from .quarantine import (
    CorruptRecordError,
    Quarantine,
    QuarantineBudgetExceededError,
    drop_quarantined_rows,
)
from .retry import (
    AttemptTimeoutError,
    IngestTimeoutError,
    RetryExhaustedError,
    RetryPolicy,
    TransientError,
    default_retry_policy,
)
from .stream_checkpoint import (
    CheckpointCorruptError,
    CheckpointMismatchError,
    StreamCheckpoint,
    fit_fingerprint,
)

# the JAX package's public names; `corrupt` is imported above and stays
# importable from here
__all__ = [
    "AttemptTimeoutError",
    "HOST_DEATH_EXIT_CODE",
    "CheckpointCorruptError",
    "CheckpointMismatchError",
    "CorruptRecordError",
    "FaultPlan",
    "FaultSpec",
    "IngestTimeoutError",
    "InjectedFaultError",
    "PartitionError",
    "Quarantine",
    "QuarantineBudgetExceededError",
    "drop_quarantined_rows",
    "set_process_dimension",
    "RetryExhaustedError",
    "RetryPolicy",
    "StreamCheckpoint",
    "TransientError",
    "default_retry_policy",
    "fit_fingerprint",
    "inject",
    "record_event",
]
