"""SLO accounting for the serving plane: error budgets, not averages.

Counterpart of ``keystone_tpu/observability/slo.py``:

* :class:`SloPolicy` — the objective: a per-request latency threshold
  and an availability target over a rolling window of good/bad request
  outcomes (a request is good when it succeeded within the threshold;
  the burn rate is how many times faster than "exactly on target" the
  error budget is spent).
* :class:`SloTracker` — per-model rolling windows fed by the serving
  worker (one :meth:`~SloTracker.record` per request), published as the
  ``serving.availability`` / ``serving.error_budget_burn_rate`` gauges
  (aggregate and per model) and the ``GET /slo`` body.
* a window that falls below its target raises no error on the worker:
  :func:`record_slo_event` counts ``slo.violation`` and leaves an
  instant on the flight recorder, a post-mortem naming the model and
  the window embeds the slowest exemplar traces
  (``observability/reqtrace.py``), the dressed :class:`SloViolation` is
  stored (``last_violation``, the bounded ``violations`` log) and the
  window starts over, so one bad stretch writes one post-mortem.

Thread model: ``record`` runs on the serving worker per request,
``state`` on scrape threads; the windows and totals are guarded by a
plain lock, and the post-mortem is written outside it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

from ..utils.guarded import guarded_by
from .metrics import MetricsRegistry
from .timeline import record_instant


class SloViolation(RuntimeError):
    """An availability target was violated over a full window. Dressed
    with ``postmortem_path`` by the tracker (``attach_postmortem``);
    stored, never raised from the serving worker."""


def record_slo_event(event: str, **fields: Any) -> None:
    """One SLO event: the ``slo.<event>`` counter and an instant on the
    flight recorder (``violation`` / ``recovered``)."""
    MetricsRegistry.get_or_create().counter(f"slo.{event}").inc()
    record_instant(event, "slo", args=fields or None)


@dataclass(frozen=True)
class SloPolicy:
    """One serving objective. ``latency_threshold_ms`` is the
    good-request bound; ``availability_target`` the good fraction the
    rolling window must hold; ``window`` the window size in requests;
    ``min_count`` how many requests must be observed before the window
    is judged at all (a cold window of 3 requests with one straggler
    is not a 33% outage)."""

    latency_threshold_ms: float = 1000.0
    availability_target: float = 0.99
    window: int = 256
    min_count: int = 64

    def __post_init__(self):
        if self.latency_threshold_ms <= 0:
            raise ValueError("latency_threshold_ms must be > 0")
        if not 0.0 < self.availability_target < 1.0:
            raise ValueError("availability_target must be in (0, 1)")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if not 1 <= self.min_count <= self.window:
            raise ValueError("min_count must be in [1, window]")

    def burn_rate(self, availability: float) -> float:
        """How many times faster than target the error budget burns:
        observed bad fraction over the allowed bad fraction. 1.0 =
        exactly on target; >1 = the budget runs out early."""
        return (1.0 - availability) / (1.0 - self.availability_target)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "latency_threshold_ms": self.latency_threshold_ms,
            "availability_target": self.availability_target,
            "window": self.window,
            "min_count": self.min_count,
        }


class _Window:
    """One model's rolling outcome window (True = good)."""

    __slots__ = ("outcomes", "good")

    def __init__(self, size: int):
        self.outcomes: Deque[bool] = deque(maxlen=size)
        self.good = 0

    def push(self, ok: bool) -> None:
        if len(self.outcomes) == self.outcomes.maxlen:
            self.good -= 1 if self.outcomes[0] else 0
        self.outcomes.append(ok)
        self.good += 1 if ok else 0

    def availability(self) -> float:
        return self.good / len(self.outcomes) if self.outcomes else 1.0


@guarded_by("_lock", "_windows", "_violations", "_good_total",
            "_bad_total")
class SloTracker:
    """Rolling-window SLO accounting; see the module docstring."""

    #: violations retained for the ``/slo`` body (bounded — a flapping
    #: SLO must not grow the tracker)
    MAX_VIOLATIONS = 16

    def __init__(self, policy: Optional[SloPolicy] = None):
        self.policy = policy or SloPolicy()
        self._windows: Dict[str, _Window] = {}
        self._violations: Deque[Dict[str, Any]] = deque(
            maxlen=self.MAX_VIOLATIONS)
        self._good_total = 0
        self._bad_total = 0
        self.last_violation: Optional[SloViolation] = None
        # plain lock: record() is the serving worker's per-request hot
        # path, and the escalation dump runs outside the hold anyway
        self._lock = threading.Lock()

    # -- the per-request feed ----------------------------------------------
    def record(self, model: str, latency_ms: Optional[float],
               ok: bool = True) -> Optional[Dict[str, Any]]:
        """Record one request outcome. ``ok=False`` (a failed batch) or
        a latency over the threshold counts against the budget. When
        the model's window — at ``min_count`` or more observations —
        drops below the availability target, escalate ONCE: event +
        ``serving.slo_violations_total`` + post-mortem, then reset that
        window. Returns the violation record (also stored), or None."""
        good = bool(ok) and latency_ms is not None \
            and latency_ms <= self.policy.latency_threshold_ms
        tripped: Optional[Dict[str, Any]] = None
        with self._lock:
            win = self._windows.get(model)
            if win is None:
                win = self._windows[model] = _Window(self.policy.window)
            win.push(good)
            if good:
                self._good_total += 1
            else:
                self._bad_total += 1
            count = len(win.outcomes)
            availability = win.availability()
            if (not good and count >= self.policy.min_count
                    and availability < self.policy.availability_target):
                tripped = {
                    "model": model,
                    "window": {
                        "count": count,
                        "good": win.good,
                        "bad": count - win.good,
                        "availability": round(availability, 6),
                    },
                    "burn_rate": round(
                        self.policy.burn_rate(availability), 4),
                    "policy": self.policy.as_dict(),
                    "time_unix": time.time(),
                }
                # one bad stretch = one post-mortem: the window starts
                # over and must re-fill to min_count before re-judging
                self._windows[model] = _Window(self.policy.window)
            agg_avail, agg_burn = self._aggregate_locked()
            model_avail = availability if tripped is None else 1.0
        self._publish(model, model_avail, agg_avail, agg_burn)
        if tripped is not None:
            self._escalate(tripped)
        return tripped

    def _aggregate_locked(self) -> tuple:
        counts = sum(len(w.outcomes) for w in self._windows.values())
        good = sum(w.good for w in self._windows.values())
        avail = good / counts if counts else 1.0
        return avail, self.policy.burn_rate(avail)

    def _publish(self, model: str, model_avail: float,
                 agg_avail: float, agg_burn: float) -> None:
        reg = MetricsRegistry.get_or_create()
        reg.gauge("serving.availability").set(agg_avail)
        reg.gauge("serving.error_budget_burn_rate").set(agg_burn)
        reg.gauge(f"serving.availability.{model}").set(model_avail)
        reg.gauge(f"serving.error_budget_burn_rate.{model}").set(
            self.policy.burn_rate(model_avail))

    def _escalate(self, tripped: Dict[str, Any]) -> None:
        """Event + counter + post-mortem for one violated window. Runs
        on the worker thread but OUTSIDE every lock; the serving path
        itself never raises for an SLO trip."""
        from .postmortem import attach_postmortem
        from .reqtrace import exemplar_reservoir
        from .timeline import flight_recorder

        # the reservoir offers ride the worker's deferred thunks: run
        # them so the post-mortem embeds every batch up to this trip
        flight_recorder().flush()
        model = tripped["model"]
        window = tripped["window"]
        MetricsRegistry.get_or_create().counter(
            "serving.slo_violations_total").inc()
        record_slo_event("violation", model=model, **window)
        exc = SloViolation(
            f"SLO violated for model {model!r}: availability "
            f"{window['availability']:.4f} < target "
            f"{self.policy.availability_target} over {window['count']} "
            f"requests (threshold {self.policy.latency_threshold_ms:g} "
            "ms)")
        attach_postmortem(exc, "slo_violation", context={
            **tripped,
            "exemplars": exemplar_reservoir().slowest_trees(
                8, model=model),
        })
        tripped["postmortem"] = getattr(exc, "postmortem_path", None)
        with self._lock:
            self._violations.append(tripped)
            self.last_violation = exc

    # -- views -------------------------------------------------------------
    def totals(self) -> tuple:
        """Lifetime ``(good, bad)`` counts (an availability
        window is a delta of these)."""
        with self._lock:
            return self._good_total, self._bad_total

    def availability(self) -> float:
        """Aggregate rolling availability across models."""
        with self._lock:
            return self._aggregate_locked()[0]

    def state(self) -> Dict[str, Any]:
        """JSON-able tracker state (the ``GET /slo`` body)."""
        with self._lock:
            agg_avail, agg_burn = self._aggregate_locked()
            models = {}
            for name, win in sorted(self._windows.items()):
                count = len(win.outcomes)
                avail = win.availability()
                models[name] = {
                    "count": count,
                    "good": win.good,
                    "bad": count - win.good,
                    "availability": round(avail, 6),
                    "burn_rate": round(self.policy.burn_rate(avail), 4),
                }
            violations = list(self._violations)
            good, bad = self._good_total, self._bad_total
        return {
            "policy": self.policy.as_dict(),
            "availability": round(agg_avail, 6),
            "burn_rate": round(agg_burn, 4),
            "totals": {"good": good, "bad": bad},
            "models": models,
            "violations": violations,
        }
