"""``poisoned_batch`` — NaN born between enqueue and collect.

Seeded ``corrupt`` faults at ``serve.dispatch`` poison the MERGED
batch value (the default NaN mutation) on two visits. The plane's
nonfinite guard must catch each poisoned batch at collect time and
fail EXACTLY that batch's requests with a classified
``PoisonedBatchError`` (500, post-mortem attached) — never hand a
client silent NaN predictions, and never wedge the worker: the very
next batch must serve clean. The availability floor prices in the two
lost batches; the checks assert the classification and the recovery.
"""
from __future__ import annotations

from typing import List, Optional

from ...resilience.faults import FaultPlan
from ..loadgen import LoadSpec
from . import Floors, Scenario, ScenarioResult, register


def _spec(seed: int) -> LoadSpec:
    return LoadSpec(
        seed=seed, duration_s=1.5, rate_rps=200.0, arrival="poisson",
        models=("poison_a", "poison_b"), zipf_s=1.1, sizes=(1, 2, 4))


def _plan(seed: int) -> Optional[FaultPlan]:
    # two poisoned batches, after the traffic is flowing (the warmup
    # zeros-batches must not eat the injections: corrupt rules only
    # fire at the value-carrying _serve_batch site, so `after` counts
    # real batches)
    return (FaultPlan(seed=seed)
            .add("serve.dispatch", kind="corrupt", after=3, count=2))


def _check(result: ScenarioResult) -> List[str]:
    out = []
    rep = result.report
    if result.injections < 1:
        out.append("no_injection: zero batches were poisoned")
    if rep.outcomes["poisoned"] == 0 and result.injections:
        out.append("unclassified_poison: batches were poisoned but no "
                   "request ended in PoisonedBatchError — the "
                   "nonfinite guard did not classify")
    if rep.outcomes["poisoned"] and not rep.postmortems:
        out.append("no_postmortem: poisoned requests carried no "
                   "post-mortem path")
    if rep.outcomes["ok"] == 0:
        out.append("no_recovery: zero OK requests — the worker did "
                   "not survive the poisoned batch")
    return out


register(Scenario(
    name="poisoned_batch",
    describe="2 seeded NaN-poisoned batches; classified 500s with "
             "post-mortems, worker survives, next batch clean",
    floors=Floors(p99_ms=400.0, availability=0.80),
    spec_fn=_spec,
    plan_fn=_plan,
    check=_check,
))
