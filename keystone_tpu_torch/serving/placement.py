"""The fleet placement solver: bin-pack models across replicas.

Counterpart of ``keystone_tpu/serving/placement.py``, pure host
arithmetic. Given per-model demands (admission charge, observed QPS,
warmup cost) and per-replica device-memory budgets, it produces a
deterministic assignment of models to replicas that

1. **single-homes every model**: first-fit-decreasing by charge onto
   the least-loaded replica that fits, refusing loudly (the error names
   the model) when nothing fits anywhere; then
2. **replicates hot models**: per replica, a value-maximizing
   ``greedy_select`` (``workflow/optimizer/auto_cache.py``) over the
   models it does not host yet, value = observed QPS x warmup cost,
   halved per copy already placed (the currency the plane's eviction
   planner spends too).

Deterministic under fixed inputs (no RNG, no clock): ties break by
name, so the fleet controller can re-solve on every reactor tick and
diff against the live placement to plan migrations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from ..observability.metrics import MetricsRegistry


class PlacementError(RuntimeError):
    """No replica can host the named model under its HBM budget — the
    refusal names the model (never a silent drop)."""

    def __init__(self, message: str, model: Optional[str] = None):
        super().__init__(message)
        self.model = model


@dataclass(frozen=True)
class ModelDemand:
    """One model's placement inputs: the admission charge it costs a
    replica, and the demand (QPS x warmup) that justifies copies."""

    name: str
    charge_nbytes: float
    qps: float = 0.0
    warmup_s: float = 0.0

    def __post_init__(self):
        if self.charge_nbytes < 0:
            raise ValueError(
                f"model {self.name!r}: charge_nbytes must be >= 0")
        if self.qps < 0:
            raise ValueError(f"model {self.name!r}: qps must be >= 0")

    def value(self, copies: int = 0) -> float:
        """Marginal value of one MORE copy given ``copies`` already
        placed: QPS x recompute cost, halved per existing copy (the
        second replica absorbs half the traffic the first did). Zero
        for a cold model — replication is bought with observed demand,
        never speculation."""
        if self.qps <= 0.0:
            return 0.0
        return (self.qps * max(self.warmup_s, 1e-3)) / float(1 + copies)


@dataclass(frozen=True)
class Placement:
    """A solved fleet assignment: ``assignments[model]`` is the sorted
    tuple of replica ids hosting it (first entry = the single-homing
    choice), ``loads[replica]`` the charged bytes."""

    assignments: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    loads: Dict[str, float] = field(default_factory=dict)

    def replicas_for(self, model: str) -> Tuple[str, ...]:
        return self.assignments.get(model, ())

    def models_on(self, replica: str) -> Tuple[str, ...]:
        return tuple(sorted(m for m, reps in self.assignments.items()
                            if replica in reps))

    def copies(self) -> int:
        return sum(len(reps) for reps in self.assignments.values())

    def diff(self, target: "Placement"
             ) -> List[Tuple[str, str, str]]:
        """Migration steps from this placement to ``target``:
        ``("admit", model, replica)`` / ``("evict", model, replica)``
        tuples, admissions first (the migration contract: admit on the
        target, VERIFY, then evict on the source — capacity is briefly
        double-charged, never zero-charged)."""
        steps: List[Tuple[str, str, str]] = []
        models = sorted(set(self.assignments) | set(target.assignments))
        for model in models:
            have = set(self.assignments.get(model, ()))
            want = set(target.assignments.get(model, ()))
            for replica in sorted(want - have):
                steps.append(("admit", model, replica))
        for model in models:
            have = set(self.assignments.get(model, ()))
            want = set(target.assignments.get(model, ()))
            for replica in sorted(have - want):
                steps.append(("evict", model, replica))
        return steps


def plan_placement(demands: Iterable[ModelDemand],
                   replica_budgets: Mapping[str, Optional[float]],
                   ) -> Placement:
    """Solve a fleet placement; see the module docstring. ``None`` budgets
    are unbounded (every model fits). Raises :class:`PlacementError`
    naming the first model no replica can host. Deterministic: ties
    break by sorted name order, never by dict/hash order."""
    demands = sorted(demands, key=lambda d: d.name)
    if len({d.name for d in demands}) != len(demands):
        raise ValueError("duplicate model names in placement demands")
    if not replica_budgets:
        raise ValueError("placement needs at least one replica")
    replicas = sorted(replica_budgets)
    loads: Dict[str, float] = {r: 0.0 for r in replicas}
    assignments: Dict[str, List[str]] = {}

    def fits(replica: str, charge: float) -> bool:
        budget = replica_budgets[replica]
        return budget is None or loads[replica] + charge <= budget

    # -- phase 1: single-home, first-fit-decreasing by charge ---------------
    # big models place first (small ones fill the gaps they leave);
    # equal charges break by name, equal loads by replica id — the
    # whole solve is reproducible from its inputs alone
    for demand in sorted(demands,
                         key=lambda d: (-d.charge_nbytes, d.name)):
        eligible = [r for r in replicas if fits(r, demand.charge_nbytes)]
        if not eligible:
            MetricsRegistry.get_or_create().counter(
                "placement.infeasible_total").inc()
            mib = 1 << 20
            budgets = {r: (None if b is None else round(b / mib, 2))
                       for r, b in sorted(replica_budgets.items())}
            raise PlacementError(
                f"model {demand.name!r} "
                f"({demand.charge_nbytes / mib:.2f} MiB) fits no "
                f"replica: remaining capacity under budgets (MiB) "
                f"{budgets} is exhausted — add a replica, raise a "
                "budget, or shrink/quantize the model",
                model=demand.name)
        home = min(eligible, key=lambda r: (loads[r], r))
        assignments[demand.name] = [home]
        loads[home] += demand.charge_nbytes

    # -- phase 2: replicate hot models into leftover capacity ---------------
    # per replica (sorted — determinism again), a value-maximizing
    # greedy_select over the models it does not yet host; the marginal
    # value halves per copy already placed, so two equally hot models
    # replicate evenly instead of one hogging every replica
    from ..workflow.optimizer.auto_cache import greedy_select

    by_name = {d.name: d for d in demands}
    for replica in replicas:
        budget = replica_budgets[replica]
        if budget is None:
            # unbounded replicas don't replicate speculatively: with no
            # scarcity there is no placement question to answer, and
            # admitting every model everywhere just multiplies warmups
            continue
        remaining = budget - loads[replica]
        if remaining <= 0.0:
            continue
        resident = {m for m, reps in assignments.items()
                    if replica in reps}

        def candidates(selected, space_left,
                       _resident=resident):
            # gate cold models out HERE: greedy_select has no
            # improvement check, so a zero-value candidate would be
            # packed anyway just because it fits
            return [n for n in sorted(by_name)
                    if n not in _resident and n not in selected
                    and by_name[n].value(len(assignments[n])) > 0.0
                    and by_name[n].charge_nbytes < space_left]

        chosen = greedy_select(
            (), candidates,
            lambda n: by_name[n].charge_nbytes,
            lambda sel: -sum(by_name[n].value(len(assignments[n]))
                             for n in sel),
            remaining)
        for name in sorted(chosen):
            assignments[name].append(replica)
            loads[replica] += by_name[name].charge_nbytes

    placement = Placement(
        assignments={m: tuple(sorted(reps))
                     for m, reps in assignments.items()},
        loads=dict(loads))
    reg = MetricsRegistry.get_or_create()
    reg.counter("placement.solves_total").inc()
    reg.gauge("placement.replicated_models").set(
        sum(1 for reps in placement.assignments.values()
            if len(reps) > 1))
    return placement
