"""``straggler_dispatch`` — a slow device, not a broken one.

Seeded ``straggler`` faults at ``serve.dispatch`` stretch a fraction
of batch dispatches by a fixed dwell — the slow-batch tail a
contended accelerator produces. Nothing errors: every request still
succeeds, but the tail moves. The floors assert the p99 stays bounded
(coalescing keeps the straggler's blast radius to its own batch) and
availability stays at fair-weather levels — a straggler is a latency
event, never an availability event.
"""
from __future__ import annotations

from typing import List, Optional

from ...resilience.faults import FaultPlan
from ..loadgen import LoadSpec
from . import Floors, Scenario, ScenarioResult, register


def _spec(seed: int) -> LoadSpec:
    return LoadSpec(
        seed=seed, duration_s=1.5, rate_rps=200.0, arrival="poisson",
        models=("straggler_a", "straggler_b"), zipf_s=1.1,
        sizes=(1, 2, 4))


def _plan(seed: int) -> Optional[FaultPlan]:
    return (FaultPlan(seed=seed)
            .add("serve.dispatch", kind="straggler", rate=0.15,
                 delay_s=0.08))


def _check(result: ScenarioResult) -> List[str]:
    out = []
    if result.injections < 1:
        out.append("no_injection: zero straggler dispatches fired")
    rep = result.report
    failed = (rep.outcomes["error"] + rep.outcomes["poisoned"]
              + rep.outcomes["unclassified"])
    if failed:
        out.append(f"straggler_broke_requests: {failed} requests "
                   "FAILED under straggler faults — a slow batch must "
                   "stay a latency event, not an availability event")
    return out


register(Scenario(
    name="straggler_dispatch",
    describe="15% of dispatches stretched 80 ms (seeded stragglers); "
             "tail bounded, availability untouched",
    floors=Floors(p99_ms=600.0, availability=0.99),
    spec_fn=_spec,
    plan_fn=_plan,
    check=_check,
))
