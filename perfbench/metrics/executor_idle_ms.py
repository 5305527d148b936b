"""executor_idle_ms.<unit>: device-idle milliseconds a profiled unit in
which the host's innermost program span was the pipeline API's
(``execute:`` or a node span ``<label>#<id>`` with no solver, optimizer
or ingest span inside it open; ``spans.py``)."""
from perfbench.spans import EXECUTOR, idle_ms


def read(r):
    return idle_ms(r, EXECUTOR)
