"""Rule / RuleExecutor / Optimizer engine.

Counterpart of ``keystone_tpu/workflow/optimizer/rule.py`` (reference
``workflow/graph/Rule.scala`` and ``RuleExecutor.scala``): an Optimizer
is a sequence of batches of rewrite rules, each batch run either once or
iterated to a fixpoint (bounded), with the plan logged in DOT form at
debug level after every rewrite.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Sequence, Union

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
        current = graph
        for batch in self.batches:
            if isinstance(batch.strategy, Once):
                iters = 1
            else:
                iters = batch.strategy.max_iterations
            for _ in range(iters):
                before = current
                for rule in batch.rules:
                    after = rule.apply(current)
                    if after is not current and logger.isEnabledFor(
                            logging.DEBUG):
                        logger.debug(
                            "rule %s (batch %s) rewrote plan:\n%s",
                            rule.name, batch.name, after.to_dot(rule.name))
                    current = after
                if current == before:
                    break
            else:
                if isinstance(batch.strategy, FixedPoint):
                    logger.warning(
                        "batch %s did not reach fixpoint in %d iterations",
                        batch.name, iters)
        return current
