"""The serving chaos catalogue: seeded traffic, seeded faults and
asserted SLO floors.

Counterpart of ``keystone_tpu/serving/scenarios``. Each scenario is one
reproducible experiment against a real :class:`~..plane.ServingPlane`
(its captured buckets on CUDA, the bounded queue, the worker, nothing
mocked): a :class:`~..loadgen.LoadSpec` builds the traffic, an optional
:class:`~...resilience.faults.FaultPlan` the weather, and the scenario
asserts p99 and availability floors, the JAX catalogue's. Every floor
violation writes a post-mortem naming the scenario and the seed.

:func:`run_scenario` also holds every run to the invariants of the
substrate:

* **clean or classified** — zero ``unclassified`` outcomes;
* **no wedged worker** — after the replay a probe request to every
  ready model must resolve, and ``close()`` must join the worker;
* **no dispatch past a deadline** — a request already expired when its
  batch reached the worker must end in ``DeadlineExpiredError``
  (:func:`_guard_dispatch`, a wrapper the harness puts around the
  plane's batch entry; the serving path itself is untouched).

The catalogue: ``burst``, ``diurnal``, ``zipf_churn``,
``straggler_dispatch``, ``poisoned_batch``, ``overload_shed``, and the
fleet pair ``replica_death`` / ``migration_under_load`` (N planes
behind real HTTP replicas and the router, a scenario-owned ``run_fn``).
Every scenario serves one model family (``LinearMapEstimator`` at
``MODEL_D, MODEL_K``) on one bucket ladder (``MAX_BATCH``), on the
device ``run_scenario`` is given (``device="cpu"`` in the tests).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ...observability.metrics import MetricsRegistry
from ...ops.device import DEFAULT_DEVICE
from ...observability.postmortem import dump_postmortem
from ...observability.slo import SloPolicy
from ...resilience.faults import FaultPlan
from ..batcher import DeadlineExpiredError
from ..loadgen import LoadSpec, LoadTrace, ReplayReport, generate_trace, replay

#: one model family for the whole catalogue (see the module docstring)
MODEL_D, MODEL_K = 6, 2
MAX_BATCH = 8


@dataclass(frozen=True)
class Floors:
    """The per-scenario SLO floors a run must beat: p99 of OK requests
    (ms, generous: they catch regressions in kind) and the availability
    of accepted requests."""

    p99_ms: float
    availability: float


@dataclass(frozen=True)
class Scenario:
    """One catalogue entry. ``spec_fn(seed)`` builds the traffic;
    ``plan_fn(seed)`` the fault plan (None = fair weather);
    ``check(result)`` returns EXTRA violation strings (scenario-
    specific invariants: 'rejections carried Retry-After', 'worker
    survived the poisoned batch', ...)."""

    name: str
    describe: str
    floors: Floors
    spec_fn: Callable[[int], LoadSpec]
    plan_fn: Callable[[int], Optional[FaultPlan]] = lambda seed: None
    check: Optional[Callable[["ScenarioResult"], List[str]]] = None
    queue_depth: int = 64
    submit_timeout_s: float = 0.25
    senders: int = 6
    #: a scenario that brings its own substrate (the fleet scenarios
    #: run N planes behind real HTTP instead of one in-process plane):
    #: ``run_fn(scenario, trace, seed, time_scale, violations, device)``
    #: owns build, replay and teardown and returns ``(report,
    #: injections)``; the harness keeps the shared epilogue (floors,
    #: clean or classified, the chaos.* counters, the post-mortem). None:
    #: the single-plane substrate.
    run_fn: Optional[Callable[
        ["Scenario", LoadTrace, int, float, List[str], Any],
        Tuple[ReplayReport, int]]] = None


@dataclass
class ScenarioResult:
    """One run's verdict: the replay report, the floors it was judged
    against, every violation (empty = CLEAN), and — when violated —
    the post-mortem artifact path naming scenario and seed."""

    scenario: str
    seed: int
    floors: Floors
    report: ReplayReport
    p99_ms: float
    availability: float
    injections: int
    violations: List[str] = field(default_factory=list)
    postmortem_path: Optional[str] = None
    wall_s: float = 0.0

    @property
    def clean(self) -> bool:
        return not self.violations

    def summary(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "seed": self.seed,
            "clean": self.clean,
            "violations": list(self.violations),
            "p99_ms": round(self.p99_ms, 3),
            "availability": round(self.availability, 4),
            "floors": {"p99_ms": self.floors.p99_ms,
                       "availability": self.floors.availability},
            "injections": self.injections,
            "postmortem": self.postmortem_path,
            "report": self.report.summary(),
        }


#: the catalogue; populated by the scenario modules at import
SCENARIOS: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def _fit_catalogue_model(seed: int, device=DEFAULT_DEVICE) -> Any:
    """One small fitted pipeline of the shared (d, k) family, on
    ``device``."""
    from ...nodes.learning.linear import LinearMapEstimator
    from ...parallel.dataset import ArrayDataset

    r = np.random.RandomState(1000 + seed)
    X = r.rand(48, MODEL_D).astype(np.float32)
    Y = r.rand(48, MODEL_K).astype(np.float32)
    return LinearMapEstimator(lam=1e-3).with_data(
        ArrayDataset.from_numpy(X, device),
        ArrayDataset.from_numpy(Y, device)).fit()


def _input_for(model: str, n: int) -> np.ndarray:
    # deterministic-by-(model, n) payloads: cheap, finite, shaped right
    return np.full((n, MODEL_D), 0.5, dtype=np.float32)


def _guard_dispatch(plane: Any, violations: List[str]) -> None:
    """Wrap the plane worker's batch entry point with the no-dispatch-
    past-deadline check: any request already expired when its batch
    reached the worker must end in DeadlineExpiredError (a result would
    mean device time spent on an answer nobody can use). A wrapper of
    the harness; the serving path is untouched."""
    orig = plane._serve_batch

    def checked(requests):
        now = time.perf_counter()
        expired = [r for r in requests if r.expired(now)]
        orig(requests)
        for r in expired:
            exc = r.future.exception() if r.future.done() else None
            if not isinstance(exc, DeadlineExpiredError):
                violations.append(
                    "deadline_dispatch: request for "
                    f"{r.model!r} was expired on batch entry but got "
                    f"{type(exc).__name__ if exc else 'a result'} "
                    "instead of DeadlineExpiredError")

    plane._serve_batch = checked


def run_scenario(name: str, seed: int, time_scale: float = 1.0,
                 duration_s: Optional[float] = None,
                 device=DEFAULT_DEVICE) -> ScenarioResult:
    """Run one catalogue scenario at one seed on ``device``; see the
    module docstring. ``duration_s`` overrides the spec's window (tests
    shorten it); ``time_scale`` stretches the arrival clock without
    touching the event sequence."""
    import dataclasses

    from ..plane import ServingPlane

    scenario = SCENARIOS.get(name)
    if scenario is None:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(know {sorted(SCENARIOS)})")
    spec = scenario.spec_fn(seed)
    if duration_s is not None:
        spec = dataclasses.replace(spec, duration_s=float(duration_s))
        churn = tuple(c for c in spec.churn if c.t_s < spec.duration_s)
        spec = dataclasses.replace(spec, churn=churn)
    trace = generate_trace(spec)
    reg = MetricsRegistry.get_or_create()
    violations: List[str] = []
    t_run = time.perf_counter()

    if scenario.run_fn is not None:
        # custom substrate (fleet scenarios); the epilogue below still
        # judges the result exactly like every other catalogue entry
        report, injections = scenario.run_fn(scenario, trace, seed,
                                             time_scale, violations,
                                             device)
    else:
        # a live SLO policy sized to the scenario window, so the SLO
        # plane (rolling windows, burn rate, its own post-mortems) is
        # exercised by every run rather than idling at defaults
        plane = ServingPlane(
            max_batch=MAX_BATCH, queue_depth=scenario.queue_depth,
            slo_policy=SloPolicy(
                latency_threshold_ms=scenario.floors.p99_ms,
                availability_target=0.5, window=256,
                min_count=64),
            postmortem_min_interval_s=0.0, device=device)
        _guard_dispatch(plane, violations)
        plane.start()
        worker = None
        plan = scenario.plan_fn(seed)
        injections = 0
        try:
            for model in spec.models:
                plane.admit(model, _fit_catalogue_model(seed, device),
                            (np.zeros((MODEL_D,), np.float32)))
            worker = plane._worker
            if plan is not None:
                with plan:
                    report = replay(
                        trace, plane, _input_for,
                        senders=scenario.senders,
                        time_scale=time_scale,
                        submit_timeout_s=scenario.submit_timeout_s)
                injections = plan.injections()
            else:
                report = replay(
                    trace, plane, _input_for,
                    senders=scenario.senders,
                    time_scale=time_scale,
                    submit_timeout_s=scenario.submit_timeout_s)

            # zero-wedged-workers probe: every READY resident must
            # still answer (the queue drains, the worker is alive)
            for model in list(plane._live):
                try:
                    plane.predict(model, _input_for(model, 1),
                                  timeout_s=10.0)
                except BaseException as exc:
                    violations.append(
                        f"wedged_worker: post-chaos probe for "
                        f"{model!r} failed: "
                        f"{type(exc).__name__}: {exc}")
        finally:
            plane.close()
        if worker is not None and worker.is_alive():
            violations.append(
                "wedged_worker: the plane worker thread survived "
                "close() — the queue is wedged")

    p99 = report.p99_ms()
    availability = report.availability()
    if report.outcomes["unclassified"]:
        violations.append(
            f"unclassified: {report.outcomes['unclassified']} requests "
            f"ended in UNKNOWN verdicts (sample: {report.errors[:3]})")
    if p99 > scenario.floors.p99_ms:
        violations.append(
            f"p99_floor: p99 {p99:.1f} ms breached the "
            f"{scenario.floors.p99_ms:.0f} ms floor")
    if availability < scenario.floors.availability:
        violations.append(
            f"availability_floor: availability {availability:.4f} fell "
            f"below the {scenario.floors.availability} floor")

    result = ScenarioResult(
        scenario=name, seed=seed, floors=scenario.floors, report=report,
        p99_ms=p99, availability=availability, injections=injections,
        violations=violations, wall_s=time.perf_counter() - t_run)
    if scenario.check is not None:
        violations.extend(scenario.check(result))

    reg.counter("chaos.runs_total").inc()
    reg.counter("chaos.injections_total").inc(injections)
    if violations:
        reg.counter("chaos.violations_total").inc()
        # the post-mortem NAMES scenario and seed: the full repro is
        # `run_scenario(scenario, seed)` — nothing else varies
        result.postmortem_path = dump_postmortem(
            "chaos_scenario_violation",
            context={"scenario": name, "seed": seed,
                     "violations": list(violations),
                     "floors": {"p99_ms": scenario.floors.p99_ms,
                                "availability":
                                    scenario.floors.availability},
                     "p99_ms": p99, "availability": availability,
                     "report": report.summary()})
    else:
        reg.counter("chaos.clean_total").inc()
    return result


def load_catalogue() -> Dict[str, Scenario]:
    """Import every scenario module (idempotent) and return the
    registry."""
    from . import (burst, diurnal, fleet_chaos, overload_shed,  # noqa: F401
                   poisoned_batch, straggler_dispatch, zipf_churn)

    return SCENARIOS
