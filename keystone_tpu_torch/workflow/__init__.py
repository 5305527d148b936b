"""Workflow layer: typed composable pipelines over an optimizing DAG core.

Counterpart of ``keystone_tpu/workflow`` (the reference's ``workflow/graph``
package): typed pipelines over an optimizing DAG core.
"""
from .common import Cacher, Identity
from .env import PipelineEnv
from .estimator import Estimator, LambdaEstimator, estimator
from .executor import GraphExecutor
from .expression import (
    DatasetExpression,
    DatumExpression,
    Expression,
    TransformerExpression,
)
from .graph import Graph
from .graph_ids import GraphId, NodeId, SinkId, SourceId
from .label_estimator import LabelEstimator, LambdaLabelEstimator
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    ExpressionOperator,
    Operator,
    TransformerOperator,
)
from .pipeline import (
    FittedPipeline,
    GatherTransformerOperator,
    Pipeline,
    PipelineDataset,
    PipelineDatum,
    PipelineResult,
)
from .transformer import LambdaTransformer, Transformer, transformer

__all__ = [
    "Cacher",
    "Identity",
    "PipelineEnv",
    "Estimator",
    "LambdaEstimator",
    "estimator",
    "GraphExecutor",
    "Expression",
    "DatasetExpression",
    "DatumExpression",
    "TransformerExpression",
    "Graph",
    "GraphId",
    "NodeId",
    "SinkId",
    "SourceId",
    "LabelEstimator",
    "LambdaLabelEstimator",
    "Operator",
    "DatasetOperator",
    "DatumOperator",
    "DelegatingOperator",
    "EstimatorOperator",
    "ExpressionOperator",
    "TransformerOperator",
    "Pipeline",
    "PipelineDataset",
    "PipelineDatum",
    "PipelineResult",
    "FittedPipeline",
    "GatherTransformerOperator",
    "Transformer",
    "LambdaTransformer",
    "transformer",
]
