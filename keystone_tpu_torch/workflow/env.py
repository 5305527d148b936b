"""Process-global pipeline environment.

Counterpart of ``keystone_tpu/workflow/env.py`` (reference
``workflow/graph/PipelineEnv.scala``): holds (1) the global
``state`` table mapping logical Prefixes to already-computed Expressions —
the incremental-reuse memo shared across all pipelines in the session —
and (2) the globally configured Optimizer. Like the reference
(``GraphExecutor.scala:8,15``), this is not thread-safe: pipelines are
built and executed from one thread.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Tuple

from .expression import Expression

if TYPE_CHECKING:
    from .optimizer.rule import Optimizer


class PipelineEnv:
    _instance: Optional["PipelineEnv"] = None

    def __init__(self) -> None:
        self.state: Dict[Tuple, Expression] = {}
        self._optimizer: Optional["Optimizer"] = None

    @classmethod
    def get_or_create(cls) -> "PipelineEnv":
        if cls._instance is None:
            cls._instance = PipelineEnv()
        return cls._instance

    @property
    def optimizer(self) -> "Optimizer":
        if self._optimizer is None:
            from .optimizer.default import DefaultOptimizer

            self._optimizer = DefaultOptimizer()
        return self._optimizer

    def set_optimizer(self, optimizer: "Optimizer") -> None:
        self._optimizer = optimizer

    def clear_state(self) -> None:
        self.state.clear()

    @classmethod
    def reset(cls) -> None:
        """Drop the global env (tests)."""
        cls._instance = None
