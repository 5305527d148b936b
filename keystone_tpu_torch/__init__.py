"""keystone_tpu_torch: the PyTorch / CUDA port of keystone_tpu.

The same pipeline framework as the JAX package ``keystone_tpu`` —
composable Transformer/Estimator pipelines over an optimizing DAG —
working on torch tensors on NVIDIA Hopper GPUs (one process per GPU,
``torch.distributed`` between them), with the JAX
package's Pallas TPU kernels rewritten by hand in CUDA C++. The port
never imports JAX or the JAX package. Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``.
"""
from .observability import (
    MetricsRegistry,
    PipelineTrace,
    current_trace,
    xprof_trace,
)
from .ops.device import resolve_device
from .parallel.dataset import ArrayDataset, Dataset, HostDataset, as_dataset
from .parallel.mesh import get_mesh, make_mesh, mesh_scope, set_mesh
from .parallel.streaming import StreamingDataset, fit_streaming, is_streamable
from .resilience import (
    FaultPlan,
    IngestTimeoutError,
    Quarantine,
    RetryPolicy,
)
from .workflow import (
    Cacher,
    Estimator,
    FittedPipeline,
    Identity,
    LabelEstimator,
    Pipeline,
    PipelineDataset,
    PipelineDatum,
    PipelineEnv,
    Transformer,
    transformer,
)

__version__ = "0.1.0"

# the JAX package's public names; `resolve_device`, the port's device
# choice, is imported above and stays importable here
__all__ = [
    "MetricsRegistry",
    "PipelineTrace",
    "current_trace",
    "xprof_trace",
    "ArrayDataset",
    "Dataset",
    "HostDataset",
    "StreamingDataset",
    "as_dataset",
    "fit_streaming",
    "is_streamable",
    "FaultPlan",
    "IngestTimeoutError",
    "Quarantine",
    "RetryPolicy",
    "get_mesh",
    "make_mesh",
    "mesh_scope",
    "set_mesh",
    "Cacher",
    "Estimator",
    "FittedPipeline",
    "Identity",
    "LabelEstimator",
    "Pipeline",
    "PipelineDataset",
    "PipelineDatum",
    "PipelineEnv",
    "Transformer",
    "transformer",
    "__version__",
]
