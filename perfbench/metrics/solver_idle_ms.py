"""solver_idle_ms.<unit>: device-idle milliseconds a profiled unit in which
the host's innermost program span was the block solver's (``factor:``,
``block:``, ``accumulate:``, ``merge:``: its host reads and launches;
``spans.py``)."""
from perfbench.spans import SOLVER, idle_ms


def read(r):
    return idle_ms(r, SOLVER)
