"""Core graph rewrite rules.

Counterpart of ``keystone_tpu/workflow/optimizer/rules.py`` (reference
``workflow/graph/{EquivalentNodeMergeRule, UnusedBranchRemovalRule,
SavedStateLoadRule}.scala``).
"""
from __future__ import annotations

from typing import Dict

from ..env import PipelineEnv
from ..graph import Graph
from ..graph_ids import GraphId
from ..operators import ExpressionOperator
from ..prefix import compute_prefix
from .rule import Rule


class EquivalentNodeMergeRule(Rule):
    """Common-subexpression elimination: merge nodes whose operators are
    equal and whose dependency lists are identical
    (``EquivalentNodeMergeRule.scala:1-48``). Run to fixpoint so merges
    cascade down the DAG."""

    def apply(self, graph: Graph) -> Graph:
        buckets: list = []  # list of (op, deps, [node ids])
        for n in sorted(graph.nodes, key=lambda g: g.id):
            op = graph.get_operator(n)
            deps = graph.get_dependencies(n)
            for b_op, b_deps, ids in buckets:
                if b_deps == deps and b_op == op:
                    ids.append(n)
                    break
            else:
                buckets.append((op, deps, [n]))
        out = graph
        changed = False
        for _, _, ids in buckets:
            if len(ids) > 1:
                keep, rest = ids[0], ids[1:]
                for r in rest:
                    out = out.replace_dependency(r, keep).remove_node(r)
                changed = True
        return out if changed else graph


class UnusedBranchRemovalRule(Rule):
    """Remove nodes that no sink depends on, transitively
    (``UnusedBranchRemovalRule.scala:8-23``). Sources are kept: a
    pipeline's dangling input is part of its shape."""

    def apply(self, graph: Graph) -> Graph:
        needed: set = set()
        for k in graph.sinks:
            dep = graph.get_sink_dependency(k)
            needed.add(dep)
            needed |= graph.get_ancestors(dep)
        unused = [n for n in graph.nodes if n not in needed]
        if not unused:
            return graph
        out = graph
        for n in unused:
            out = out.remove_node(n)
        return out


class SavedStateLoadRule(Rule):
    """Substitute nodes whose logical prefix already has a computed value in
    the global state table with an ExpressionOperator holding that value
    (``SavedStateLoadRule.scala:8-18``)."""

    def apply(self, graph: Graph) -> Graph:
        state = PipelineEnv.get_or_create().state
        if not state:
            return graph
        out = graph
        changed = False
        memo: Dict[GraphId, object] = {}
        for n in sorted(graph.nodes, key=lambda g: g.id):
            op = graph.get_operator(n)
            if isinstance(op, ExpressionOperator):
                continue
            prefix = compute_prefix(graph, n, memo)  # type: ignore[arg-type]
            if prefix is not None and prefix in state:
                out = out.set_operator(n, ExpressionOperator(state[prefix]))
                out = out.set_dependencies(n, ())
                changed = True
        return out if changed else graph
