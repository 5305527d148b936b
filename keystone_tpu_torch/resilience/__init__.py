"""Resilient execution for the port's streamed fits.

Counterpart of ``keystone_tpu/resilience`` on one process:

* :mod:`.retry`: :class:`RetryPolicy` (exponential backoff with seeded
  jitter, per-attempt timeout, retryable classification) around chunk
  staging, and the producer watchdog's :class:`IngestTimeoutError`;
* :mod:`.quarantine`: :class:`Quarantine`, skip-but-account for corrupt
  records under a ``max_bad_fraction`` budget;
* :mod:`.stream_checkpoint`: :class:`StreamCheckpoint` and
  :func:`fit_fingerprint`, the atomic snapshot and bit-identical resume
  of a streamed fit;
* :mod:`.faults`: :class:`FaultPlan` / :func:`inject` /
  :func:`corrupt`, seeded fault injection at the ingest sites.

Every event goes through :mod:`.events` into the ``resilience.*``
counters, the flight recorder and the active trace.
"""
from .events import record_event
from .faults import FaultPlan, FaultSpec, InjectedFaultError, corrupt, inject
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

# the JAX package's public names less the world-level ones (ROADMAP
# A11: HOST_DEATH_EXIT_CODE, PartitionError, set_process_dimension);
# `corrupt` is imported above and stays importable from here
__all__ = [
    "AttemptTimeoutError",
    "CheckpointCorruptError",
    "CheckpointMismatchError",
    "CorruptRecordError",
    "FaultPlan",
    "FaultSpec",
    "IngestTimeoutError",
    "InjectedFaultError",
    "Quarantine",
    "QuarantineBudgetExceededError",
    "drop_quarantined_rows",
    "RetryExhaustedError",
    "RetryPolicy",
    "StreamCheckpoint",
    "TransientError",
    "default_retry_policy",
    "fit_fingerprint",
    "inject",
    "record_event",
]
