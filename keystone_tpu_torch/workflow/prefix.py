"""Logical prefix hashing for incremental cross-pipeline state reuse.

Counterpart of ``keystone_tpu/workflow/prefix.py`` (reference
``workflow/graph/Prefix.scala``): a node's Prefix is a structural hash
of its operator together with the prefixes of all its dependencies.
Nodes whose ancestry reaches an unconnected Source have no prefix.
Prefixes key the global ``PipelineEnv.state`` memo, so re-running a
pipeline (or another pipeline sharing a fitted prefix) reuses computed
expressions.

Prefixes are canonical under map and gather fusion, as in the JAX
package: a ``FusedTransformer([a, b, c])`` contributes the prefix of the
unfused ``a >> b >> c`` chain and a ``FusedGatherTransformer`` that of
the unfused gather of its branches. Fitted state is saved by the
executor on the optimized (fused) graph, while ``SavedStateLoadRule``
matches on the next run's raw (unfused) graph; without this the two
never meet, and a pipeline whose pre-estimator chain fuses refits on
every run.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .graph import Graph
from .graph_ids import GraphId, NodeId, SourceId
from .operators import Operator


def operator_prefix(op: Operator, dep_prefixes: Tuple) -> Tuple:
    """Prefix contribution of one operator given its dependencies'; a
    fused operator expands to the prefix of its unfused subgraph."""
    from .optimizer.fusion import FusedGatherTransformer, FusedTransformer

    if isinstance(op, FusedTransformer):
        (cur,) = dep_prefixes
        for stage in op.stages:
            cur = operator_prefix(stage, (cur,))
        return cur
    if isinstance(op, FusedGatherTransformer):
        from .pipeline import GatherTransformerOperator

        (p,) = dep_prefixes
        branch_ps = tuple(operator_prefix(b, (p,)) for b in op.branches)
        gather = GatherTransformerOperator(len(op.branches))
        return ("prefix", gather._cached_eq_key(), branch_ps)
    return ("prefix", op._cached_eq_key(), tuple(dep_prefixes))


def compute_prefix(
    graph: Graph, gid: GraphId, _memo: Optional[Dict[GraphId, Optional[Tuple]]] = None
) -> Optional[Tuple]:
    """Canonical structural prefix of ``gid`` in ``graph``, or None if it
    depends on an unconnected source."""
    memo: Dict[GraphId, Optional[Tuple]] = _memo if _memo is not None else {}
    if gid in memo:
        return memo[gid]
    if isinstance(gid, SourceId):
        memo[gid] = None
        return None
    assert isinstance(gid, NodeId)
    memo[gid] = None  # cycle guard; DAGs shouldn't cycle but be safe
    dep_prefixes = []
    for d in graph.get_dependencies(gid):
        p = compute_prefix(graph, d, memo)
        if p is None:
            memo[gid] = None
            return None
        dep_prefixes.append(p)
    result = operator_prefix(graph.get_operator(gid), tuple(dep_prefixes))
    memo[gid] = result
    return result
