"""Rule / RuleExecutor / Optimizer engine.

Counterpart of ``keystone_tpu/workflow/optimizer/rule.py`` (reference
``workflow/graph/Rule.scala`` and ``RuleExecutor.scala``): an Optimizer
is a sequence of batches of rewrite rules, each batch run either once or
iterated to a fixpoint (bounded), with the plan logged in DOT form at
debug level after every rewrite.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Sequence, Union

from ...observability.trace import current_trace
from ..graph import Graph

logger = logging.getLogger(__name__)


class Rule:
    """A graph-to-graph rewrite."""

    def apply(self, graph: Graph) -> Graph:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class Once:
    pass


@dataclass(frozen=True)
class FixedPoint:
    max_iterations: int = 100


Strategy = Union[Once, FixedPoint]


@dataclass(frozen=True)
class Batch:
    name: str
    strategy: Strategy
    rules: Sequence[Rule]


class Optimizer:
    """Executes rule batches (reference ``RuleExecutor.scala:29-84``)."""

    @property
    def batches(self) -> Sequence[Batch]:
        raise NotImplementedError

    def execute(self, graph: Graph) -> Graph:
        trace = current_trace()
        t_start = time.perf_counter() if trace is not None else 0.0
        current = graph
        for batch in self.batches:
            if isinstance(batch.strategy, Once):
                iters = 1
            else:
                iters = batch.strategy.max_iterations
            for _ in range(iters):
                before = current
                for rule in batch.rules:
                    t0 = time.perf_counter() if trace is not None else 0.0
                    after = rule.apply(current)
                    if after is not current:
                        if trace is not None:
                            trace.record_rule(
                                optimizer=type(self).__name__,
                                batch=batch.name, rule=rule.name,
                                nodes_before=len(current.nodes),
                                nodes_after=len(after.nodes),
                                wall_s=time.perf_counter() - t0)
                        if logger.isEnabledFor(logging.DEBUG):
                            logger.debug(
                                "rule %s (batch %s) rewrote plan:\n%s",
                                rule.name, batch.name,
                                after.to_dot(rule.name))
                    current = after
                if current == before:
                    break
            else:
                if isinstance(batch.strategy, FixedPoint):
                    logger.warning(
                        "batch %s did not reach fixpoint in %d iterations",
                        batch.name, iters)
        if trace is not None:
            trace.meta.setdefault("optimizer_runs", []).append({
                "optimizer": type(self).__name__,
                "batches": [b.name for b in self.batches],
                "nodes_in": len(graph.nodes),
                "nodes_out": len(current.nodes),
                "wall_s": time.perf_counter() - t_start,
            })
        return current
