"""One funnel for resilience telemetry.

Counterpart of ``keystone_tpu/resilience/events.py``. Every resilience
event (a retry, a quarantined record, a checkpoint save or restore, a
watchdog trip, an injected fault) goes through :func:`record_event`,
which counts ``resilience.<event>`` in the process
:class:`~keystone_tpu_torch.observability.metrics.MetricsRegistry`, marks
an instant on the flight recorder's timeline (on the thread it fired
from) and, with a trace active, appends the entry to the trace's
resilience stream. The vocabulary:

    retry, retry_exhausted, quarantine, checkpoint_save,
    checkpoint_restore, watchdog_trip, fault_injected

The JAX package adds a ``process_id`` field under a multi-host world;
the port has one process until the multi-GPU slice (ROADMAP A11).
"""
from __future__ import annotations

from typing import Any

from ..observability.metrics import MetricsRegistry
from ..observability.timeline import record_instant
from ..observability.trace import current_trace


def record_event(event: str, **fields: Any) -> None:
    """Count ``resilience.<event>``, mark it on the timeline and trace
    the structured entry."""
    MetricsRegistry.get_or_create().counter(f"resilience.{event}").inc()
    record_instant(event, "resilience", args=fields or None)
    trace = current_trace()
    if trace is not None:
        trace.record_resilience({"event": event, **fields})
