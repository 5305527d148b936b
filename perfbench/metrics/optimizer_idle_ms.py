"""optimizer_idle_ms.<unit>: device-idle milliseconds a profiled unit in
which the host's innermost program span was the workflow optimizer's
(``optimize:``; ``spans.py``)."""
from perfbench.spans import OPTIMIZER, idle_ms


def read(r):
    return idle_ms(r, OPTIMIZER)
