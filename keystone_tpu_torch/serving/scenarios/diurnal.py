"""``diurnal`` — sinusoidal rate swing over the window.

The traffic a long-lived deployment actually sees, compressed: the
arrival rate sweeps from trough to peak and back within the window
(thinned Poisson). The floors assert the plane holds its tail through
the peak: a p99 that only looks good at the trough is what gating on
averages would hide.
"""
from __future__ import annotations

from typing import List

from ..loadgen import LoadSpec
from . import Floors, Scenario, ScenarioResult, register


def _spec(seed: int) -> LoadSpec:
    return LoadSpec(
        seed=seed, duration_s=1.6, rate_rps=220.0, arrival="diurnal",
        models=("diurnal_a", "diurnal_b"), zipf_s=1.2, sizes=(1, 2, 4),
        diurnal_amp=0.8, diurnal_period_s=1.6)


def _check(result: ScenarioResult) -> List[str]:
    out = []
    if result.report.outcomes["ok"] == 0:
        out.append("no_traffic: zero OK requests over the diurnal window")
    return out


register(Scenario(
    name="diurnal",
    describe="sinusoidal rate swing (trough->peak->trough), 2 models",
    floors=Floors(p99_ms=400.0, availability=0.97),
    spec_fn=_spec,
    check=_check,
))
