"""Utilities of the port (counterpart of ``keystone_tpu/utils``): the
pipeline checkpoint (``checkpoint.py``), in-place carry updates
(``donation.py``), the declared lock discipline (``guarded.py``), the
bounded memo (``lru.py``) and the profiler trace (``profiling.py``).

The re-exports are lazy (PEP 562): ``utils.guarded`` is imported by the
observability layer's class definitions, and an eager ``checkpoint``
import here would pull the workflow and observability back in while
they initialize."""
from typing import Any

__all__ = [
    "donation_enabled",
    "load_pipeline",
    "load_state",
    "save_pipeline",
    "save_state",
    "StepTimer",
    "trace",
]

_HOMES = {
    "donation_enabled": "donation",
    "load_pipeline": "checkpoint",
    "load_state": "checkpoint",
    "save_pipeline": "checkpoint",
    "save_state": "checkpoint",
    "StepTimer": "profiling",
    "trace": "profiling",
}


def __getattr__(name: str) -> Any:
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{home}", __name__), name)
