"""Static pipeline analysis: abstract interpretation and graph lints.

Counterpart of ``keystone_tpu/analysis``. A pipeline's whole DAG is known
before it runs; this package checks it. ``analyze`` propagates shape and
dtype specs through a workflow Graph by running each node's per-item
function on meta tensors (no device memory, no kernel launch);
``check_pipeline`` (``Pipeline.check``) adds the graph lints and the
static device-memory plan and returns an :class:`AnalysisReport`.

Entry points:

* ``pipeline.check(sample_spec)``                  library API
* ``python -m keystone_tpu_torch check <app>``     the command over the
  app registry (``keystone_tpu_torch.pipelines.CHECK_APPS``)

The tree-wide AST scans of the JAX package (``concurrency``, ``hotpath``
and the AST-only lints of ``diagnostics``) are ROADMAP A12b; ``spmd``
and ``sharding_flow_lint`` come with the multi-GPU port, A11.
"""
from .diagnostics import (
    AnalysisReport,
    apply_body_host_coercions,
    check_graph,
    check_pipeline,
    scan_metric_names,
)
from .interpreter import Analysis, Diagnostic, analyze
from .resources import (
    HbmPlan,
    ResourceEffect,
    StreamGeometry,
    plan_graph,
    serving_residency_nbytes,
)
from .spec import (
    DatasetSpec,
    DatumSpec,
    ShapeDtype,
    SparseSpec,
    SpecDataset,
    TransformerSpec,
    Unknown,
    as_input_spec,
    element_feature_dim,
    spec_dataset,
)

__all__ = [
    "Analysis",
    "AnalysisReport",
    "DatasetSpec",
    "DatumSpec",
    "Diagnostic",
    "HbmPlan",
    "ResourceEffect",
    "ShapeDtype",
    "SparseSpec",
    "SpecDataset",
    "StreamGeometry",
    "TransformerSpec",
    "Unknown",
    "analyze",
    "apply_body_host_coercions",
    "as_input_spec",
    "check_graph",
    "check_pipeline",
    "element_feature_dim",
    "plan_graph",
    "scan_metric_names",
    "serving_residency_nbytes",
    "spec_dataset",
]
