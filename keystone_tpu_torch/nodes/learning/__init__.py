"""Learning nodes: solvers and models (reference ``nodes/learning``)."""
from .classifiers import SparseLinearMapper
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from .least_squares import LeastSquaresEstimator
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
    "DenseLBFGSwithL2",
    "LeastSquaresEstimator",
    "LinearMapEstimator",
    "LinearMapper",
    "SparseLBFGSwithL2",
    "SparseLinearMapper",
    "ZCAWhitener",
    "ZCAWhitenerEstimator",
]
