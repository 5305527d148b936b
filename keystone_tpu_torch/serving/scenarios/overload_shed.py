"""``overload_shed`` — sustained overload against graceful degradation.

The arrival rate is far past the plane's capacity, the queue is
deliberately shallow, and every request carries a deadline. The
graceful-degradation contract under that weather:

* the slot gate 429s the overflow FAST (short submit timeout), every
  rejection carrying a drain-rate ``Retry-After`` hint;
* requests that slip in but exceed their deadline while queued are
  SHED before dispatch — zero device time burned on answers nobody
  can use (the dispatch-guard wrapper checks every batch);
* the requests that ARE served stay fast: the p99 floor applies to
  the survivors, because a "successful" request slower than the
  deadline is the same failure with better manners.

Availability is honestly low here — the floor asserts the plane keeps
serving SOMETHING (no collapse-to-zero), while the rejected/shed
verdicts stay classified.
"""
from __future__ import annotations

from typing import List, Optional

from ...resilience.faults import FaultPlan
from ..loadgen import LoadSpec
from . import Floors, Scenario, ScenarioResult, register


def _spec(seed: int) -> LoadSpec:
    return LoadSpec(
        seed=seed, duration_s=0.8, rate_rps=1200.0, arrival="bursty",
        models=("overload_a",), zipf_s=1.0, sizes=(1, 2),
        burst_mult=3.0, burst_on_s=0.3, burst_off_s=0.1,
        deadline_ms=150.0)


def _plan(seed: int) -> Optional[FaultPlan]:
    # dispatch latency makes the overload bite on any device: each batch
    # pays 100 ms, so capacity is ~50 rps against a 1200 rps schedule.
    # The replay senders are closed-loop (in-flight <= senders), so
    # the scenario's senders (16) deliberately exceed queue_depth (8):
    # the queue backs up past the 150 ms deadline and the slot gate
    # actually runs dry.
    return (FaultPlan(seed=seed)
            .add("serve.dispatch", kind="latency", delay_s=0.10))


def _check(result: ScenarioResult) -> List[str]:
    out = []
    rep = result.report
    if rep.outcomes["rejected"] == 0:
        out.append("no_backpressure: sustained overload produced zero "
                   "429s — the slot gate is not bounding the queue")
    if rep.outcomes["rejected"] and rep.retry_after_seen == 0:
        out.append("no_retry_after: 429s carried no Retry-After hint")
    if rep.outcomes["shed"] == 0:
        out.append("no_shedding: no queued request was deadline-shed "
                   "under overload — expired work burned device time")
    if rep.outcomes["ok"] == 0:
        out.append("collapse: zero requests served under overload — "
                   "shedding must degrade, not kill")
    return out


register(Scenario(
    name="overload_shed",
    describe="3x-capacity bursts into a shallow queue with 150 ms "
             "deadlines: fast 429s w/ Retry-After, pre-dispatch sheds, "
             "survivors stay fast",
    floors=Floors(p99_ms=400.0, availability=0.10),
    spec_fn=_spec,
    plan_fn=_plan,
    check=_check,
    queue_depth=8,
    submit_timeout_s=0.05,
    senders=16,
))
