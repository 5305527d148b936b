"""Profile-under-budget greedy selection.

Counterpart of ``greedy_select`` in
``keystone_tpu/workflow/optimizer/auto_cache.py`` (reference
``AutoCacheRule.scala:526-549``). The serving plane's eviction plan
uses it; the rest of auto-caching comes with ROADMAP A6.
"""
from __future__ import annotations

from typing import Any, Callable, FrozenSet, Iterable, List


def greedy_select(initial: Iterable[Any],
                  candidates_fn: Callable[[FrozenSet, float], List[Any]],
                  mem_of: Callable[[Any], float],
                  objective: Callable[[FrozenSet], float],
                  budget: float) -> FrozenSet:
    """Starting from ``initial``, repeatedly add the candidate whose
    addition MINIMIZES ``objective(selected | {c})`` while the summed
    ``mem_of`` stays under ``budget``. ``candidates_fn(selected,
    space_left)`` returns the admissible additions for this step (it is
    called again every step). Returns the selected frozenset."""
    selected = set(initial)

    def used() -> float:
        return sum(mem_of(n) for n in selected)

    while used() < budget:
        cands = candidates_fn(frozenset(selected), budget - used())
        if not cands:
            break
        best = min(cands,
                   key=lambda c: objective(frozenset(selected | {c})))
        selected.add(best)
    return frozenset(selected)
