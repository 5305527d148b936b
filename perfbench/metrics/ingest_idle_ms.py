"""ingest_idle_ms.<unit>: device-idle milliseconds a profiled unit in which
the host's innermost program span was the streamed ingest's (``stall:``:
the chunk loop waiting for a staged chunk; ``spans.py``)."""
from perfbench.spans import INGEST, idle_ms


def read(r):
    return idle_ms(r, INGEST)
