"""Retry with exponential backoff and jitter, and the ingest watchdog's
error.

Counterpart of ``keystone_tpu/resilience/retry.py``, with the same
arithmetic, so one seed gives one backoff schedule in both packages:

* classification: only :meth:`RetryPolicy.is_retryable` exceptions are
  retried. Transient failures (``TransientError``, timeouts, a plain
  ``OSError``) are; deterministic ones (a missing file, a permission, a
  :class:`~.quarantine.CorruptRecordError`) are not;
* backoff: ``backoff_s * multiplier ** (attempt - 1)`` capped at
  ``max_backoff_s``, stretched by up to ``jitter`` of a uniform draw
  from a numpy ``RandomState(seed)``;
* per-attempt timeout: with ``attempt_timeout_s`` an attempt runs on a
  helper thread and is abandoned, as a transient failure, when it
  overruns (the abandoned daemon thread may linger until its call
  returns).

Every retry feeds ``resilience.retry`` and the active trace;
exhaustion raises :class:`RetryExhaustedError` (the last failure as
``__cause__``) with a post-mortem.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional, Tuple, Type

import numpy as np

from ..utils.guarded import TracedLock, guarded_by
from .events import record_event
from .quarantine import CorruptRecordError


class TransientError(Exception):
    """Base class of failures worth retrying."""


class AttemptTimeoutError(TransientError):
    """An attempt overran its per-attempt timeout."""


class RetryExhaustedError(RuntimeError):
    """Every attempt failed; ``__cause__`` is the last failure."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(f"{site}: all {attempts} attempt(s) failed; last "
                         f"error: {type(last).__name__}: {last}")
        self.site = site
        self.attempts = attempts


class IngestTimeoutError(RuntimeError):
    """The streaming consumer's producer watchdog tripped: the producer
    died without finishing the stream, or sent no chunk within the
    stream's ``stall_timeout_s`` (default None: no deadline, a dead
    producer still raises at once)."""


DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    TransientError, TimeoutError, InterruptedError, ConnectionError, OSError)

DEFAULT_NON_RETRYABLE: Tuple[Type[BaseException], ...] = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, CorruptRecordError)


@guarded_by("_lock", "_rng")
class RetryPolicy:
    """Configurable retry and backoff; one instance may be shared across
    threads (the jitter draws are locked)."""

    def __init__(self, max_attempts: int = 3, backoff_s: float = 0.05,
                 multiplier: float = 2.0, max_backoff_s: float = 2.0,
                 jitter: float = 0.5,
                 attempt_timeout_s: Optional[float] = None,
                 retryable: Tuple[Type[BaseException], ...]
                 = DEFAULT_RETRYABLE,
                 non_retryable: Tuple[Type[BaseException], ...]
                 = DEFAULT_NON_RETRYABLE,
                 seed: int = 0):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.multiplier = float(multiplier)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.attempt_timeout_s = attempt_timeout_s
        self.retryable = tuple(retryable)
        self.non_retryable = tuple(non_retryable)
        self._rng = np.random.RandomState(seed)
        self._lock = TracedLock("retry.jitter")

    def __repr__(self) -> str:
        timeout = ("none" if self.attempt_timeout_s is None
                   else f"{self.attempt_timeout_s:g}s")
        return (f"RetryPolicy(attempts={self.max_attempts}, "
                f"backoff={self.backoff_s:g}s*{self.multiplier:g}^k"
                f"<={self.max_backoff_s:g}s, jitter={self.jitter:g}, "
                f"attempt_timeout={timeout})")

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable) and not isinstance(
            exc, self.non_retryable)

    def backoff(self, attempt: int) -> float:
        """Sleep before attempt ``attempt + 1`` (``attempt`` 1-based)."""
        base = min(self.backoff_s * self.multiplier ** (attempt - 1),
                   self.max_backoff_s)
        with self._lock:
            j = float(self._rng.rand())
        return base * (1.0 + self.jitter * j)

    def _attempt(self, fn: Callable[..., Any], args, kwargs) -> Any:
        if self.attempt_timeout_s is None:
            return fn(*args, **kwargs)
        done = threading.Event()
        box: list = []

        def run():
            try:
                box.append(("ok", fn(*args, **kwargs)))
            except BaseException as exc:
                box.append(("err", exc))
            finally:
                done.set()

        threading.Thread(target=run, daemon=True,
                         name="keystone-torch-retry-attempt").start()
        if not done.wait(self.attempt_timeout_s):
            raise AttemptTimeoutError(
                f"attempt exceeded {self.attempt_timeout_s:g}s (abandoned; "
                "counted as transient)")
        kind, value = box[0]
        if kind == "err":
            raise value
        return value

    def call(self, fn: Callable[..., Any], *args: Any,
             site: str = "retry", **kwargs: Any) -> Any:
        """Run ``fn`` under the policy: a non-retryable exception
        propagates at once; retryable ones are retried with backoff and
        finally wrapped in :class:`RetryExhaustedError`."""
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return self._attempt(fn, args, kwargs)
            except BaseException as exc:
                if not self.is_retryable(exc):
                    raise
                last = exc
                record_event("retry", site=site, attempt=attempt,
                             error=f"{type(exc).__name__}: {exc}")
                if attempt < self.max_attempts:
                    time.sleep(self.backoff(attempt))
        record_event("retry_exhausted", site=site, attempts=self.max_attempts,
                     error=f"{type(last).__name__}: {last}")
        from ..observability.postmortem import attach_postmortem

        raise attach_postmortem(
            RetryExhaustedError(site, self.max_attempts, last),
            "retry_exhausted",
            {"site": site, "attempts": self.max_attempts,
             "last_error": f"{type(last).__name__}: {last}",
             "policy": repr(self)}) from last


_DEFAULT_POLICY: Optional[RetryPolicy] = None
_DEFAULT_POLICY_LOCK = threading.Lock()


def default_retry_policy() -> RetryPolicy:
    """The shared default policy (3 attempts, 50 ms base backoff): every
    site without its own policy draws from one seeded jitter stream."""
    global _DEFAULT_POLICY
    policy = _DEFAULT_POLICY
    if policy is None:
        with _DEFAULT_POLICY_LOCK:
            policy = _DEFAULT_POLICY
            if policy is None:
                policy = _DEFAULT_POLICY = RetryPolicy()
    return policy


def reset_default_retry_policy() -> None:
    """Drop the shared default policy, so its jitter stream restarts
    from its seed (tests)."""
    global _DEFAULT_POLICY
    with _DEFAULT_POLICY_LOCK:
        _DEFAULT_POLICY = None
