"""Learning nodes: solvers and models (reference ``nodes/learning``)."""
from .block_weighted import BlockWeightedLeastSquaresEstimator
from .classifiers import SparseLinearMapper
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from .least_squares import LeastSquaresEstimator
from .linear import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
    LinearMapEstimator,
    LinearMapper,
)
from .pca import (
    ApproximatePCAEstimator,
    BatchPCATransformer,
    ColumnPCAEstimator,
    DistributedColumnPCAEstimator,
    DistributedPCAEstimator,
    LocalColumnPCAEstimator,
    PCAEstimator,
    PCATransformer,
)
from .per_class_weighted import PerClassWeightedLeastSquaresEstimator
from .zca import ZCAWhitener, ZCAWhitenerEstimator

__all__ = [
    "ApproximatePCAEstimator",
    "BatchPCATransformer",
    "ColumnPCAEstimator",
    "DistributedColumnPCAEstimator",
    "DistributedPCAEstimator",
    "LocalColumnPCAEstimator",
    "PCAEstimator",
    "PCATransformer",
    "BlockLeastSquaresEstimator",
    "BlockWeightedLeastSquaresEstimator",
    "BlockLinearMapper",
    "DenseLBFGSwithL2",
    "LeastSquaresEstimator",
    "LinearMapEstimator",
    "LinearMapper",
    "PerClassWeightedLeastSquaresEstimator",
    "SparseLBFGSwithL2",
    "SparseLinearMapper",
    "ZCAWhitener",
    "ZCAWhitenerEstimator",
]
