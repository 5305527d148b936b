"""Default optimizer.

Counterpart of ``keystone_tpu/workflow/optimizer/default.py`` in the
JAX package's order: saved-state load and unused-branch removal,
common-subexpression elimination to a fixpoint, the node-level
cost-model choice (``node_rule.py``, once), and CSE again over the
spliced prefixes, which runs only where the node rule spliced. Map
fusion and auto-caching come in later slices.
"""
from __future__ import annotations

from typing import Sequence

from ..graph import Graph
from .node_rule import NodeOptimizationRule
from .rule import Batch, FixedPoint, Once, Optimizer
from .rules import (
    EquivalentNodeMergeRule,
    SavedStateLoadRule,
    UnusedBranchRemovalRule,
)


class _PostSpliceMerge(EquivalentNodeMergeRule):
    """CSE over what the node-level rule spliced. A graph the rule left
    as it was is the first CSE batch's fixpoint, and a pass over it,
    quadratic in the node count, would merge nothing."""

    def __init__(self, node_rule: NodeOptimizationRule):
        self.node_rule = node_rule

    def apply(self, graph: Graph) -> Graph:
        if not self.node_rule.splices:
            return graph
        return super().apply(graph)


class DefaultOptimizer(Optimizer):
    @property
    def batches(self) -> Sequence[Batch]:
        node_rule = NodeOptimizationRule()
        return [
            Batch(
                "saved-state and pruning",
                Once(),
                [SavedStateLoadRule(), UnusedBranchRemovalRule()],
            ),
            Batch("CSE", FixedPoint(100), [EquivalentNodeMergeRule()]),
            Batch("node-level optimization", Once(), [node_rule]),
            Batch("post-splice CSE", FixedPoint(100),
                  [_PostSpliceMerge(node_rule)]),
        ]


class NoOpOptimizer(Optimizer):
    """Pass-through optimizer (tests, debugging)."""

    @property
    def batches(self) -> Sequence[Batch]:
        return []
