"""Learning nodes: solvers and models (reference ``nodes/learning``)."""
from .block_weighted import BlockWeightedLeastSquaresEstimator
from .classifiers import (
    LinearDiscriminantAnalysis,
    LocalLeastSquaresEstimator,
    LogisticRegressionEstimator,
    LogisticRegressionModel,
    NaiveBayesEstimator,
    NaiveBayesModel,
    SparseLinearMapper,
)
from .gmm import (
    KMEANS_PLUS_PLUS_INITIALIZATION,
    RANDOM_INITIALIZATION,
    GaussianMixtureModel,
    GaussianMixtureModelEstimator,
)
from .kmeans import KMeansModel, KMeansPlusPlusEstimator
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
    "BlockLeastSquaresEstimator",
    "BlockLinearMapper",
    "LinearMapEstimator",
    "LinearMapper",
    "DenseLBFGSwithL2",
    "KMeansModel",
    "KMeansPlusPlusEstimator",
    "GaussianMixtureModel",
    "GaussianMixtureModelEstimator",
    "KMEANS_PLUS_PLUS_INITIALIZATION",
    "RANDOM_INITIALIZATION",
    "PCAEstimator",
    "PCATransformer",
    "BatchPCATransformer",
    "ColumnPCAEstimator",
    "LocalColumnPCAEstimator",
    "DistributedColumnPCAEstimator",
    "DistributedPCAEstimator",
    "ApproximatePCAEstimator",
    "ZCAWhitener",
    "ZCAWhitenerEstimator",
    "NaiveBayesEstimator",
    "NaiveBayesModel",
    "LogisticRegressionEstimator",
    "LogisticRegressionModel",
    "LinearDiscriminantAnalysis",
    "LocalLeastSquaresEstimator",
    "SparseLinearMapper",
    "SparseLBFGSwithL2",
    "LeastSquaresEstimator",
    "BlockWeightedLeastSquaresEstimator",
    "PerClassWeightedLeastSquaresEstimator",
]
