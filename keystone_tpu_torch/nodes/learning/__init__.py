"""Learning nodes: solvers and models (reference ``nodes/learning``)."""
from .linear import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
    LinearMapEstimator,
    LinearMapper,
)
from .zca import ZCAWhitener, ZCAWhitenerEstimator

__all__ = [
    "BlockLeastSquaresEstimator",
    "BlockLinearMapper",
    "LinearMapEstimator",
    "LinearMapper",
    "ZCAWhitener",
    "ZCAWhitenerEstimator",
]
