"""Map and gather fusion: collapse linear chains of per-batch nodes, and
fan-outs of them feeding one gather, into one node.

Counterpart of ``keystone_tpu/workflow/optimizer/fusion.py`` (the
reference pays nothing for chains of ``rdd.map``: Spark pipelines narrow
transformations within a stage). The rules, their order and the fused
nodes' equality keys and labels are the JAX package's. What a fused node
buys differs: eager PyTorch compiles nothing, so fusion does not remove
a program per node; it removes the executor's memo entry per node (the
memo keeps every node's value for the executor's life, so a chain of N
nodes held N batches where the fused node holds one) and the dataset
wrapping between stages.

A fused node runs each stage through the stage's own batch path
(``apply_batch``) in turn, and the datum path through each stage's
``apply``, so a kernel a stage launches is launched exactly as it is
unfused. Only classes that say ``fusable`` fuse (see
``workflow/transformer.py``).

The fitted-param protocol composes: a fused node's ``apply_params`` is
the tuple of its stages' own params (read through the stages' per-device
caches) and ``apply_with_params`` threads them stage by stage.

Unlike the JAX package, the port keeps no process-wide memo of fused
instances: that memo exists there to keep each instance's compiled
programs warm, eager PyTorch has none, and here it would pin the fitted
stages and their device copies past the life of their pipeline.

Fused nodes stream: they inherit the default ``apply_dataset``, whose
stream branch applies the whole fused chain per chunk.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from ..graph import Graph
from ..graph_ids import NodeId
from ..transformer import Transformer
from .rule import Rule


def _is_combiner(op: Any) -> bool:
    from ...nodes.util import VectorCombiner

    return type(op) is VectorCombiner


def _gather_columns(branches: Sequence[Transformer], X: Any) -> Any:
    """``VectorCombiner`` of the branches' batches without their tuple:
    each branch's batch is written into its column block of one output as
    it is made, so the gathered features exist once and no second copy
    of them is made by a concatenation. The values are the
    concatenation's, bit for bit. Where the branches' outputs differ in
    width, type or leading shape, the rest are concatenated."""
    first = branches[0].apply_batch(X)
    w = first.shape[-1]
    out = first.new_empty(first.shape[:-1] + (w * len(branches),))
    out[..., :w] = first
    del first
    for i, b in enumerate(branches[1:], start=1):
        y = b.apply_batch(X)
        if y.shape != out.shape[:-1] + (w,) or y.dtype != out.dtype:
            rest = [y] + [c.apply_batch(X) for c in branches[i + 1:]]
            return torch.cat([out[..., :i * w]] + rest, dim=-1)
        out[..., i * w:(i + 1) * w] = y
    return out


class FusedTransformer(Transformer):
    """A chain of per-batch transformers applied as one node."""

    def __init__(self, stages: List[Transformer]):
        flat: List[Transformer] = []
        for s in stages:
            flat.extend(s.stages if isinstance(s, FusedTransformer) else [s])
        self.stages = flat

    def eq_key(self):
        return (FusedTransformer,
                tuple(s._cached_eq_key() for s in self.stages))

    def apply(self, x):
        for s in self.stages:
            x = s.apply(x)
        return x

    def apply_batch(self, X):
        stages, i = self.stages, 0
        while i < len(stages):
            s = stages[i]
            if (isinstance(s, FusedGatherTransformer) and i + 1 < len(stages)
                    and _is_combiner(stages[i + 1])):
                X = _gather_columns(s.branches, X)
                i += 2
                continue
            X = s.apply_batch(X)
            i += 1
        return X

    def apply_params(self, device):
        return tuple(s.apply_params(device) for s in self.stages)

    def apply_with_params(self, params, x):
        for s, p in zip(self.stages, params):
            x = s.apply_with_params(p, x)
        return x

    def label(self) -> str:
        return "Fused[" + " >> ".join(s.label() for s in self.stages) + "]"


class FusedGatherTransformer(Transformer):
    """N branches and their gather applied as one node: ``apply(x)`` is
    the per-item tuple of the branches' outputs that
    ``GatherTransformerOperator`` assembles from the unfused branch
    nodes, and ``apply_batch(X)`` the tuple of their batches."""

    def __init__(self, branches: List[Transformer]):
        self.branches = list(branches)

    def eq_key(self):
        return (FusedGatherTransformer,
                tuple(b._cached_eq_key() for b in self.branches))

    def apply(self, x):
        return tuple(b.apply(x) for b in self.branches)

    def apply_batch(self, X):
        return tuple(b.apply_batch(X) for b in self.branches)

    def apply_params(self, device):
        return tuple(b.apply_params(device) for b in self.branches)

    def apply_with_params(self, params, x):
        return tuple(b.apply_with_params(p, x)
                     for b, p in zip(self.branches, params))

    def label(self) -> str:
        return ("FusedGather[" +
                ", ".join(b.label() for b in self.branches) + "]")


def _consumers_and_sink_deps(graph: Graph):
    consumers: Dict = {}
    for nid, deps in graph.dependencies.items():
        for d in deps:
            consumers.setdefault(d, set()).add(nid)
    return consumers, set(graph.sink_dependencies.values())


def _fusable(op) -> bool:
    """The class-level answer (``Transformer.fusable``), and never a
    saveable stage (a cache point)."""
    return (isinstance(op, Transformer) and op.fusable
            and not getattr(op, "saveable", False))


class MapFusionRule(Rule):
    """Fuse one (producer, consumer) pair of fusable transformers per
    application; a FixedPoint batch drives whole chains to one node."""

    def apply(self, graph: Graph) -> Graph:
        consumers, sink_deps = _consumers_and_sink_deps(graph)

        for b in sorted(graph.nodes, key=lambda n: n.id):
            deps = graph.get_dependencies(b)
            if len(deps) != 1 or not isinstance(deps[0], NodeId):
                continue
            a = deps[0]
            op_a, op_b = graph.get_operator(a), graph.get_operator(b)
            if not (_fusable(op_a) and _fusable(op_b)):
                continue
            if consumers.get(a, set()) != {b} or a in sink_deps:
                continue  # a's output is needed elsewhere
            g = graph.set_operator(b, FusedTransformer([op_a, op_b]))
            g = g.set_dependencies(b, graph.get_dependencies(a))
            return g.remove_node(a)
        return graph


class GatherFusionRule(Rule):
    """Fuse a gather with its fusable single-input branches when every
    branch hangs off the same upstream node and feeds only the gather
    (MNIST's FFT branches, TIMIT's cosine branches). MapFusionRule then
    composes the fused gather with the combiner downstream and the chain
    upstream."""

    def apply(self, graph: Graph) -> Graph:
        from ..pipeline import GatherTransformerOperator

        consumers, sink_deps = _consumers_and_sink_deps(graph)

        for gth in sorted(graph.nodes, key=lambda n: n.id):
            if not isinstance(
                    graph.get_operator(gth), GatherTransformerOperator):
                continue
            deps = graph.get_dependencies(gth)
            if not deps or not all(isinstance(d, NodeId) for d in deps):
                continue
            ops = [graph.get_operator(d) for d in deps]
            if not all(_fusable(op) for op in ops):
                continue
            # every branch feeds only this gather (a CSE-merged duplicate
            # branch appears twice in deps, which is allowed), and all
            # branches hang off one upstream input
            srcs = set()
            ok = True
            for d in set(deps):
                if consumers.get(d, set()) != {gth} or d in sink_deps:
                    ok = False
                    break
                bdeps = graph.get_dependencies(d)
                if len(bdeps) != 1:
                    ok = False
                    break
                srcs.add(bdeps[0])
            if not ok or len(srcs) != 1:
                continue
            g = graph.set_operator(gth, FusedGatherTransformer(ops))
            g = g.set_dependencies(gth, (srcs.pop(),))
            for d in set(deps):
                g = g.remove_node(d)
            return g
        return graph
