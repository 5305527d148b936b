"""The port's fleet placement solver (``keystone_tpu_torch/serving/
placement.py``) held against the JAX package's: on the same seeded
demands and budgets both give the same assignment and loads, exactly,
and refuse the same model; the port's own properties (budget safety,
determinism, the admit-before-evict diff) hold as the JAX suite pins
them."""
from __future__ import annotations

import numpy as np
import pytest

from keystone_tpu.serving.placement import ModelDemand as JModelDemand
from keystone_tpu.serving.placement import PlacementError as JPlacementError
from keystone_tpu.serving.placement import plan_placement as jplan
from keystone_tpu_torch.serving.placement import (ModelDemand, Placement,
                                                  PlacementError,
                                                  plan_placement)

MiB = 1 << 20


def _demands(rng: np.random.RandomState, n_models: int):
    """Seeded demand tuples: charges 1-64 MiB, about half the models
    hot."""
    out = []
    for i in range(n_models):
        hot = rng.rand() < 0.5
        out.append((f"m{i:02d}", float(rng.randint(1, 65)) * MiB,
                    float(rng.randint(10, 2000)) if hot else 0.0,
                    float(rng.rand() * 3.0) if hot else 0.0))
    return out


def _solve(plan, demand_cls, error_cls, demands, budgets):
    try:
        p = plan([demand_cls(*d) for d in demands], budgets)
    except error_cls as exc:
        return ("refused", exc.model)
    return (p.assignments, p.loads)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("n_replicas", [1, 2, 3, 5])
def test_placement_matches_the_jax_solver(seed, n_replicas):
    rng = np.random.RandomState(2000 + seed)
    demands = _demands(rng, n_models=10)
    budgets = {f"r{i}": float(rng.randint(96, 512)) * MiB
               for i in range(n_replicas)}
    if seed % 4 == 3:
        budgets["r0"] = None  # an unbounded replica in the mix
    ours = _solve(plan_placement, ModelDemand, PlacementError, demands,
                  budgets)
    theirs = _solve(jplan, JModelDemand, JPlacementError, demands, budgets)
    assert ours == theirs


@pytest.mark.parametrize("seed", range(6))
def test_never_exceeds_any_replica_budget(seed):
    rng = np.random.RandomState(3000 + seed)
    demands = [ModelDemand(*d) for d in _demands(rng, 8)]
    budgets = {f"r{i}": float(rng.randint(128, 384)) * MiB
               for i in range(3)}
    try:
        placement = plan_placement(demands, budgets)
    except PlacementError as exc:
        assert exc.model is not None
        return
    by_name = {d.name: d for d in demands}
    for replica, budget in budgets.items():
        charged = sum(by_name[m].charge_nbytes
                      for m in placement.models_on(replica))
        assert charged <= budget + 1e-6
        assert placement.loads[replica] == pytest.approx(charged)
    assert set(placement.assignments) == set(by_name)


def test_deterministic_under_reordered_inputs():
    rng = np.random.RandomState(4000)
    demands = [ModelDemand(*d) for d in _demands(rng, 9)]
    budgets = {f"r{i}": float(rng.randint(128, 512)) * MiB
               for i in range(3)}
    first = plan_placement(list(demands), budgets)
    again = plan_placement(list(reversed(demands)), dict(budgets))
    assert again.assignments == first.assignments
    assert again.loads == first.loads


def test_refusal_names_the_model_and_cold_models_stay_single():
    with pytest.raises(PlacementError) as err:
        plan_placement([ModelDemand("tiny", 4.0 * MiB),
                        ModelDemand("whale", 900.0 * MiB, qps=50.0)],
                       {"r0": 128.0 * MiB, "r1": 128.0 * MiB})
    assert err.value.model == "whale" and "whale" in str(err.value)
    placement = plan_placement(
        [ModelDemand("hot", 8 * MiB, qps=500.0, warmup_s=1.0),
         ModelDemand("cold", 8 * MiB)],
        {"r0": 64.0 * MiB, "r1": 64.0 * MiB})
    assert len(placement.replicas_for("hot")) == 2
    assert len(placement.replicas_for("cold")) == 1
    with pytest.raises(ValueError):
        plan_placement([ModelDemand("a", MiB), ModelDemand("a", MiB)],
                       {"r0": None})
    with pytest.raises(ValueError):
        plan_placement([ModelDemand("a", MiB)], {})


def test_diff_admits_before_evicting():
    have = Placement(assignments={"m": ("r0",)}, loads={"r0": 1.0})
    want = Placement(assignments={"m": ("r1",)}, loads={"r1": 1.0})
    assert have.diff(want) == [("admit", "m", "r1"), ("evict", "m", "r0")]
    assert want.diff(want) == []
