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

Under a world of more than one rank every event carries a
``process_id`` field: :func:`set_process_dimension` declares the rank
once (``parallel.mesh.initialize_distributed`` calls it), so the funnel
reads one module global and never asks the process group.
"""
from __future__ import annotations

from typing import Any

from ..observability.metrics import MetricsRegistry
from ..observability.timeline import record_instant
from ..observability.trace import current_trace


def record_event(event: str, **fields: Any) -> None:
    """Count ``resilience.<event>``, mark it on the timeline and trace
    the structured entry (with ``process_id`` under a world)."""
    if _PROCESS_ID is not None and "process_id" not in fields:
        fields["process_id"] = _PROCESS_ID
    MetricsRegistry.get_or_create().counter(f"resilience.{event}").inc()
    record_instant(event, "resilience", args=fields or None)
    trace = current_trace()
    if trace is not None:
        trace.record_resilience({"event": event, **fields})


#: this process's rank under a world of more than one, else None
_PROCESS_ID = None


def set_process_dimension(process_id) -> None:
    """Declare this process's rank, so every later resilience event
    carries ``process_id``; None clears it."""
    global _PROCESS_ID
    _PROCESS_ID = None if process_id is None else int(process_id)
