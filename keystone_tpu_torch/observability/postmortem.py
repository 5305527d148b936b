"""Crash post-mortems: dump the telemetry plane when a fit dies.

Counterpart of ``keystone_tpu/observability/postmortem.py``. A streamed
fit that dies leaves one exception line; the flight recorder's last
spans, the metrics and the numerics health series explain it, and they
die with the process. So the failure paths dump them first:

* :func:`dump_postmortem` writes one JSON artifact: the reason and its
  context, a :meth:`MetricsRegistry.snapshot`, the flight recorder's
  Chrome trace (Perfetto loads it as it is) and the numerics plane's
  recent health series, to ``$KEYSTONE_TORCH_POSTMORTEM_DIR`` (default
  ``~/.keystone_tpu_torch/postmortems``). ``KEYSTONE_TORCH_POSTMORTEM=0``
  turns dumping off.
* :func:`attach_postmortem` dumps, stores the path on the exception
  (``exc.postmortem_path``) and appends ``[post-mortem: <path>]`` to its
  message. The ingest watchdog, ``RetryPolicy``'s exhaustion, the HBM
  budget checks and the numerics tripwires raise through it.
* An interpreter exit under a live stream dumps too
  (``parallel/streaming.py``).

Dumping is best-effort: a failure inside the dump returns None and
leaves the exception as it was. Crash reporting never masks the crash.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

from .metrics import MetricsRegistry
from .timeline import flight_recorder

_SEQ = 0
_SEQ_LOCK = threading.Lock()


def postmortem_enabled() -> bool:
    return os.environ.get("KEYSTONE_TORCH_POSTMORTEM", "1") != "0"


def postmortem_dir() -> Path:
    override = os.environ.get("KEYSTONE_TORCH_POSTMORTEM_DIR")
    if override:
        return Path(override)
    return Path.home() / ".keystone_tpu_torch" / "postmortems"


def dump_postmortem(reason: str,
                    context: Optional[Dict[str, Any]] = None
                    ) -> Optional[str]:
    """Write one post-mortem artifact; its path, or None when dumping is
    off or failed."""
    if not postmortem_enabled():
        return None
    global _SEQ
    try:
        directory = postmortem_dir()
        directory.mkdir(parents=True, exist_ok=True)
        with _SEQ_LOCK:
            _SEQ += 1
            seq = _SEQ
        path = directory / f"postmortem-{reason}-{os.getpid()}-{seq}.json"
        try:
            from .numerics import health_snapshot

            numerics = health_snapshot()
        except Exception:
            numerics = None
        blob = {
            "reason": reason,
            "time_unix": time.time(),
            "pid": os.getpid(),
            "context": context or {},
            "metrics": MetricsRegistry.get_or_create().snapshot(),
            "flight_recorder": flight_recorder().to_chrome_trace(),
            "numerics": numerics,
        }
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, default=str)
        os.replace(tmp, path)
        return str(path)
    except Exception:
        return None


def attach_postmortem(exc: BaseException, reason: str,
                      context: Optional[Dict[str, Any]] = None
                      ) -> BaseException:
    """Dump a post-mortem for ``exc`` and name it in the message;
    returns ``exc`` so a raise site stays one line::

        raise attach_postmortem(IngestTimeoutError(...), "ingest_timeout",
                                {"chunk": seen})
    """
    path = dump_postmortem(reason, context)
    exc.postmortem_path = path
    if path and exc.args and isinstance(exc.args[0], str):
        exc.args = (exc.args[0] + f" [post-mortem: {path}]", *exc.args[1:])
    return exc
