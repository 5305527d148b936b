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

* ``python -m keystone_tpu_torch.tools.lint``     the tree-wide static
  gate: the AST-only lints of ``diagnostics``, the concurrency passes
  (``concurrency``) and the hot-path and publication passes (``hotpath``)

* :mod:`.spmd`                                   the SPMD-safety passes
  over the port's ``torch.distributed`` sites (collective divergence,
  barrier and payload stability, collective axes, world checkpoints,
  unawaited rounds) and ``sharding_flow_lint``, the graph lint over
  rank-local streams
"""
from .concurrency import (
    blocking_under_lock,
    find_lock_cycles,
    guarded_field_races,
    guarded_sequence_hazards,
    lock_order_edges,
    scan_package,
)
from .diagnostics import (
    AnalysisReport,
    apply_body_host_coercions,
    check_graph,
    check_pipeline,
    scan_metric_names,
)
from .hotpath import (
    HOTPATH_SCAN_BUDGET_S,
    build_package,
    hotpath_hazards,
    published_field_hazards,
    scan_package as scan_package_hotpath,
    scan_source as scan_source_hotpath,
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
from .spmd import (
    barrier_stability,
    collective_axis_bindings,
    collective_divergence,
    scan_package as scan_package_spmd,
    sharding_flow_lint,
    world_checkpoint_consistency,
)

# the JAX package's public names; ShapeDtype, element_feature_dim, scan_metric_names and
# serving_residency_nbytes are imported above and stay importable here
__all__ = [
    "Analysis",
    "AnalysisReport",
    "DatasetSpec",
    "DatumSpec",
    "Diagnostic",
    "HOTPATH_SCAN_BUDGET_S",
    "HbmPlan",
    "ResourceEffect",
    "SparseSpec",
    "SpecDataset",
    "StreamGeometry",
    "TransformerSpec",
    "Unknown",
    "analyze",
    "apply_body_host_coercions",
    "as_input_spec",
    "barrier_stability",
    "blocking_under_lock",
    "build_package",
    "check_graph",
    "check_pipeline",
    "collective_axis_bindings",
    "collective_divergence",
    "find_lock_cycles",
    "guarded_field_races",
    "guarded_sequence_hazards",
    "hotpath_hazards",
    "lock_order_edges",
    "plan_graph",
    "published_field_hazards",
    "scan_package",
    "scan_package_hotpath",
    "scan_package_spmd",
    "scan_source_hotpath",
    "sharding_flow_lint",
    "spec_dataset",
    "world_checkpoint_consistency",
]
