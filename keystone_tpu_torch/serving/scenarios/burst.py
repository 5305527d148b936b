"""``burst`` — correlated arrival spikes against the bounded queue.

Fair-weather chaos: no injected faults, but the on/off arrival process
slams the queue with multi-request bursts that the pad-to-bucket
coalescer must absorb. The floors assert the plane rides bursts out
with high availability (the bounded queue may 429 the worst spike —
an honest, classified verdict — but never an unclassified failure).
"""
from __future__ import annotations

from typing import List

from ..loadgen import LoadSpec
from . import Floors, Scenario, ScenarioResult, register


def _spec(seed: int) -> LoadSpec:
    return LoadSpec(
        seed=seed, duration_s=1.5, rate_rps=260.0, arrival="bursty",
        models=("burst_a", "burst_b"), zipf_s=1.1, sizes=(1, 2, 4),
        burst_mult=4.0, burst_on_s=0.2, burst_off_s=0.2)


def _check(result: ScenarioResult) -> List[str]:
    out = []
    if result.report.outcomes["ok"] == 0:
        out.append("no_traffic: zero OK requests — the burst never "
                   "reached the plane")
    return out


register(Scenario(
    name="burst",
    describe="on/off arrival bursts, 2 models, fair weather",
    floors=Floors(p99_ms=400.0, availability=0.97),
    spec_fn=_spec,
    check=_check,
))
