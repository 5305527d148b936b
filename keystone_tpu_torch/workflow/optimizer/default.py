"""Default optimizer.

Counterpart of ``keystone_tpu/workflow/optimizer/default.py`` in the
JAX package's order: saved-state load and unused-branch removal,
common-subexpression elimination to a fixpoint, the node-level
cost-model choice (``node_rule.py``, once), CSE again over the spliced
prefixes (which runs only where the node rule spliced), and map and
gather fusion to a fixpoint (``fusion.py``). ``AutoCachingOptimizer``
adds profile-driven caching after them (``auto_cache.py``).
"""
from __future__ import annotations

from typing import Sequence

from ..graph import Graph
from .auto_cache import AutoCacheRule
from .fusion import GatherFusionRule, MapFusionRule
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
            Batch("map fusion", FixedPoint(1000),
                  [MapFusionRule(), GatherFusionRule()]),
        ]


class AutoCachingOptimizer(Optimizer):
    """The DefaultOptimizer's batches plus profile-driven caching
    (reference ``workflow/DefaultOptimizer.scala:19-26``). ``max_mem``
    None budgets 75% of the free memory of the graph's device."""

    def __init__(self, strategy: str = AutoCacheRule.GREEDY,
                 max_mem=None):
        self.strategy = strategy
        self.max_mem = max_mem

    @property
    def batches(self) -> Sequence[Batch]:
        return list(DefaultOptimizer().batches) + [
            Batch("auto-cache", Once(),
                  [AutoCacheRule(self.strategy, self.max_mem)]),
        ]


class NoOpOptimizer(Optimizer):
    """Pass-through optimizer (tests, debugging)."""

    @property
    def batches(self) -> Sequence[Batch]:
        return []
