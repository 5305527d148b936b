"""Default optimizer.

Counterpart of ``keystone_tpu/workflow/optimizer/default.py``, cut down
to what the port has so far: saved-state load and unused-branch removal,
then common-subexpression elimination to a fixpoint. The node-level
solver choice, map fusion and auto-caching come in later slices.
"""
from __future__ import annotations

from typing import Sequence

from .rule import Batch, FixedPoint, Once, Optimizer
from .rules import (
    EquivalentNodeMergeRule,
    SavedStateLoadRule,
    UnusedBranchRemovalRule,
)


class DefaultOptimizer(Optimizer):
    @property
    def batches(self) -> Sequence[Batch]:
        return [
            Batch(
                "saved-state and pruning",
                Once(),
                [SavedStateLoadRule(), UnusedBranchRemovalRule()],
            ),
            Batch("CSE", FixedPoint(100), [EquivalentNodeMergeRule()]),
        ]


class NoOpOptimizer(Optimizer):
    """Pass-through optimizer (tests, debugging)."""

    @property
    def batches(self) -> Sequence[Batch]:
        return []
