"""Crash post-mortems: dump the telemetry plane when a fit dies.

Counterpart of ``keystone_tpu/observability/postmortem.py``. A streamed
fit that dies leaves one exception line; the flight recorder's last
spans, the metrics and the numerics health series explain it, and they
die with the process. So the failure paths dump them first:

* :func:`dump_postmortem` writes one JSON artifact: the reason and its
  context, a :meth:`MetricsRegistry.snapshot`, the flight recorder's
  Chrome trace (Perfetto loads it as it is), the capture observatory's
  snapshot and per-site table (``compilelog.executable_table``: which
  captured CUDA graphs held pool memory, for a device OOM) and the
  numerics plane's recent health series, to ``$KEYSTONE_TORCH_POSTMORTEM_DIR`` (default
  ``~/.keystone_tpu_torch/postmortems``). ``KEYSTONE_TORCH_POSTMORTEM=0``
  turns dumping off.
* :func:`attach_postmortem` dumps, stores the path on the exception
  (``exc.postmortem_path``) and appends ``[post-mortem: <path>]`` to its
  message. The ingest watchdog, ``RetryPolicy``'s exhaustion, the HBM
  budget checks and the numerics tripwires raise through it.
* :func:`attach_postmortem_async` names the path at once and leaves the
  writing to one writer thread: the serving worker's failed batches take
  it, so a dump (the whole flight recorder, as JSON) never stalls the
  requests queued behind the batch. The artifact holds the state at the
  time it is written, a moment after the failure;
  :func:`wait_postmortems` waits for the writes handed over (the plane's
  ``close`` and the interpreter's exit wait for them).
* An interpreter exit under a live stream dumps too
  (``parallel/streaming.py``).

Dumping is best-effort: a failure inside the dump returns None and
leaves the exception as it was. Crash reporting never masks the crash.
"""
from __future__ import annotations

import atexit
import json
import os
import queue
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


def _reserve_path(reason: str) -> Path:
    """The artifact's path: the directory made, the sequence drawn."""
    global _SEQ
    directory = postmortem_dir()
    directory.mkdir(parents=True, exist_ok=True)
    with _SEQ_LOCK:
        _SEQ += 1
        seq = _SEQ
    return directory / f"postmortem-{reason}-{os.getpid()}-{seq}.json"


def _write(path: Path, reason: str,
           context: Optional[Dict[str, Any]]) -> None:
    try:
        from .compilelog import compile_observatory, executable_table

        compiles = compile_observatory().snapshot()
        executables = executable_table()
    except Exception:
        compiles, executables = None, []
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
        "compiles": compiles,
        "executables": executables,
        "numerics": numerics,
    }
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=1, default=str)
    os.replace(tmp, path)


def dump_postmortem(reason: str,
                    context: Optional[Dict[str, Any]] = None
                    ) -> Optional[str]:
    """Write one post-mortem artifact; its path, or None when dumping is
    off or failed."""
    if not postmortem_enabled():
        return None
    try:
        path = _reserve_path(reason)
        _write(path, reason, context)
        return str(path)
    except Exception:
        return None


#: dumps handed to the writer thread: (path, reason, context)
_WRITES: "queue.SimpleQueue" = queue.SimpleQueue()
#: handed over and not yet written (or failed)
_PENDING = 0
_PENDING_COND = threading.Condition()
_WRITER: Optional[threading.Thread] = None
_WRITER_LOCK = threading.Lock()


def _writer_loop() -> None:
    global _PENDING
    while True:
        path, reason, context = _WRITES.get()
        try:
            _write(path, reason, context)
        except Exception:
            pass  # best-effort, as dump_postmortem: the path stays unwritten
        finally:
            with _PENDING_COND:
                _PENDING -= 1
                _PENDING_COND.notify_all()


def _ensure_writer() -> None:
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None or not _WRITER.is_alive():
            _WRITER = threading.Thread(target=_writer_loop, daemon=True,
                                       name="keystone-postmortem-writer")
            _WRITER.start()


def dump_postmortem_async(reason: str,
                          context: Optional[Dict[str, Any]] = None
                          ) -> Optional[str]:
    """:func:`dump_postmortem` with the writing left to the writer
    thread: returns the path the artifact will have at once (None when
    dumping is off or the directory cannot be made)."""
    global _PENDING
    if not postmortem_enabled():
        return None
    try:
        path = _reserve_path(reason)
    except Exception:
        return None
    with _PENDING_COND:
        _PENDING += 1
    _ensure_writer()
    _WRITES.put_nowait((path, reason, context))
    return str(path)


def wait_postmortems(timeout_s: float = 10.0) -> bool:
    """Wait until every dump handed to the writer thread is written;
    False if some are still pending after ``timeout_s``."""
    with _PENDING_COND:
        return _PENDING_COND.wait_for(lambda: _PENDING == 0, timeout_s)


atexit.register(wait_postmortems, 5.0)


def _attach(exc: BaseException, path: Optional[str]) -> BaseException:
    exc.postmortem_path = path
    if path and exc.args and isinstance(exc.args[0], str):
        exc.args = (exc.args[0] + f" [post-mortem: {path}]", *exc.args[1:])
    return exc


def attach_postmortem(exc: BaseException, reason: str,
                      context: Optional[Dict[str, Any]] = None
                      ) -> BaseException:
    """Dump a post-mortem for ``exc`` and name it in the message;
    returns ``exc`` so a raise site stays one line::

        raise attach_postmortem(IngestTimeoutError(...), "ingest_timeout",
                                {"chunk": seen})
    """
    return _attach(exc, dump_postmortem(reason, context))


def attach_postmortem_async(exc: BaseException, reason: str,
                            context: Optional[Dict[str, Any]] = None
                            ) -> BaseException:
    """:func:`attach_postmortem` through :func:`dump_postmortem_async`:
    the path is on the exception at once, the artifact follows."""
    return _attach(exc, dump_postmortem_async(reason, context))
