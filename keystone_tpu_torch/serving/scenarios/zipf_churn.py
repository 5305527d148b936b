"""``zipf_churn`` — skewed popularity + admit/evict/readmit under live
load, with an injected admission fault mid-warmup.

Three models under Zipf popularity; the churn thread evicts and
readmits the tail models while the hot model keeps serving. One
injected ``serve.admit`` fault lands MID-WARMUP during a readmission:
the admission must roll back atomically (nothing half-registered, the
ledger released, the fence re-armed) and the NEXT readmission of the
same model must succeed — the rollback-then-retry path under real
traffic. Requests racing the churn get honest routing verdicts (404
not-admitted / 503 warming), which are classifications, not failures.
"""
from __future__ import annotations

from typing import List, Optional

from ...resilience.faults import FaultPlan
from ..loadgen import ChurnEvent, LoadSpec
from . import Floors, Scenario, ScenarioResult, register

_MODELS = ("churn_hot", "churn_warm", "churn_cold")


def _spec(seed: int) -> LoadSpec:
    return LoadSpec(
        seed=seed, duration_s=2.0, rate_rps=180.0, arrival="poisson",
        models=_MODELS, zipf_s=1.4, sizes=(1, 2, 4),
        churn=(
            ChurnEvent(t_s=0.35, action="evict", model="churn_cold"),
            ChurnEvent(t_s=0.70, action="readmit", model="churn_cold"),
            ChurnEvent(t_s=1.00, action="evict", model="churn_warm"),
            ChurnEvent(t_s=1.25, action="readmit", model="churn_warm"),
            # the retry after the injected mid-warmup failure below
            ChurnEvent(t_s=1.55, action="readmit", model="churn_warm"),
        ))


def _plan(seed: int) -> Optional[FaultPlan]:
    # one admission fault, landing mid-warmup of churn_warm's t=1.25
    # readmission — the t=1.55 churn event retries it. The plan is
    # installed around replay() only, so the startup admissions do not
    # count: the first serve.admit visits belong to churn_cold's
    # readmit (1 pre-mutation + 1 per warmup bucket), then churn_warm's
    # readmit follows. after=visits_before+2 skips churn_cold's full
    # pass plus churn_warm's pre-mutation and first bucket, firing on
    # the SECOND warmup bucket — genuinely mid-warmup.
    from ..batcher import BucketPolicy
    from . import MAX_BATCH

    buckets_per_admit = len(BucketPolicy(MAX_BATCH).rows())
    visits_before = 1 + buckets_per_admit
    return (FaultPlan(seed=seed)
            .add("serve.admit", kind="error",
                 after=visits_before + 2, count=1))


def _check(result: ScenarioResult) -> List[str]:
    out = []
    rep = result.report
    if result.injections < 1:
        out.append("no_injection: the mid-warmup admission fault "
                   "never fired")
    if rep.churn_failed < 1:
        out.append("no_rollback: the injected admission fault did not "
                   "surface as a failed churn action")
    if rep.churn_applied < 3:
        out.append(f"churn_stalled: only {rep.churn_applied} churn "
                   "actions applied — eviction/readmission wedged")
    if rep.outcomes["ok"] == 0:
        out.append("no_traffic: zero OK requests under churn")
    return out


register(Scenario(
    name="zipf_churn",
    describe="Zipf popularity, evict/readmit under load, one injected "
             "mid-warmup admission fault (atomic rollback + retry)",
    floors=Floors(p99_ms=500.0, availability=0.90),
    spec_fn=_spec,
    plan_fn=_plan,
    check=_check,
))
