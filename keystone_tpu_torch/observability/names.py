"""The port's metric-name and span-name catalogue.

Counterpart of ``keystone_tpu/observability/names.py``. Dashboards, the
sampler and the scrape surface address metrics by name across process
boundaries, so a renamed counter fails silently (a flat zero, not an
error). Every literal name the port passes to ``counter``, ``gauge``,
``histogram`` or ``timer`` is listed here; ``tests/test_torch_telemetry.py``
walks the port's syntax trees and fails on a name that is not.
Families with a dynamic tail (``resilience.<event>``,
``lock.wait_s.<lock>``) are catalogued as prefixes, which an f-string's
literal head must fall inside.

The live spans (``timeline.flight_span``, on the device trace's clock
while a profiler records) are named ``<head>:<tail>``, and the head
names the program's layer: :data:`SPAN_LAYERS` maps every head to its
layer, in the words of the benchmark's per-layer metrics
(``BENCHMARK.json``'s ``layer``). A span whose name holds ``#`` is a
pipeline node (``<label>#<id>``), of :data:`NODE_SPAN_LAYER`. The same
test fails on a literal span head that is not listed here.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Tuple

METRIC_NAMES: FrozenSet[str] = frozenset({
    # workflow/executor.py: always-on executor counters
    "executor.nodes_executed",
    "executor.memo_hits",
    "executor.prefix_hits",
    # parallel/streaming.py: streamed ingest and the streamed fit
    "streaming.ingest_stall_s",
    "streaming.prefetch_occupancy",
    "streaming.chunks_total",
    "streaming.h2d_bytes",
    "streaming.resident_bytes",
    "streaming.carry_bytes",
    # resilience/stream_checkpoint.py: the cost of a snapshot, split
    # into the carry's device-to-host copy and the file write, and of a
    # restore
    "checkpoint.d2h_s",
    "checkpoint.write_s",
    "checkpoint.restore_s",
    # parallel/distributed.py: the world's coordination rounds
    "coord.world_size",         # gauge: ranks in the live world
    "coord.rounds_total",       # counter: rounds awaited
    "coord.barrier_wait_s",     # histogram: blocked at an await/barrier
    "coord.overlap_occupancy",  # gauge: 1 - blocked await / round wall
    "coord.merge_s",            # histogram: the finalize carry merge
    # utils/guarded.py: lock contention
    "lock.contended_total",
    # observability/sampler.py: probes, published as gauges
    "process.rss_bytes",
    "streaming.stage_queue_depth",
    "prefix.memo_bytes",       # the prefix memo's computed entries'
    "prefix.memo_entries",     # device bytes, and their count
    # observability/numerics.py: the data-health plane
    "numerics.health_words",
    "numerics.nan_total",
    "numerics.inf_total",
    "numerics.solves_total",
    "numerics.breakdown_total",
    "numerics.pivot_ratio",
    "numerics.residual_rel",
    "numerics.health_age_s",
    "numerics.quant_rel_error",
    "numerics.quant_error",
    # serving/: the serving plane
    "serving.requests_total",
    "serving.rows_total",
    "serving.batches_total",
    "serving.rejected_total",
    "serving.errors_total",
    "serving.evictions_total",
    "serving.shed_total",
    "serving.deadline_expired_total",
    "serving.admission_rejected_total",
    "serving.queue_depth",
    "serving.warmup_s",
    "serving.poisoned_batches_total",
    "serving.queue_wait_s",
    "serving.models_resident",
    "serving.models_warming",
    "serving.hbm_budget_bytes",
    "serving.hbm_charged_bytes",
    "serving.request_ms",
    "serving.batch_ms",
    "serving.batch_fill",
    # serving/graphs.py: parked graph pools, their reuse and release
    # behind the process's gate
    "serving.pool_reuses",
    "serving.pool_allocations",
    "serving.pool_releases",
    "serving.pool_release_s",
    "serving.gate_wait_s",
    # observability/compilelog.py: the capture observatory; a capture
    # recorded under an armed fence is a steady-state capture, a bug
    "compile.count",
    "compile.wall_s",
    "compile.unexpected_total",
    # observability/slo.py: rolling-window error budgets
    "serving.availability",
    "serving.error_budget_burn_rate",
    "serving.slo_violations_total",
    # serving/plane.py: the batch-level drift phase
    "serving.phase_ms.drift_score",
    # serving/placement.py, router.py, fleet.py: the fleet
    "placement.solves_total",
    "placement.infeasible_total",
    "placement.replicated_models",
    "router.requests_total",
    "router.spill_total",
    "router.unavailable_total",
    "router.replicas_live",
    "router.rebalance_total",
    "fleet.models_placed",
    "fleet.replica_deaths_total",
    # serving/scenarios: the chaos catalogue's runs
    "chaos.runs_total",
    "chaos.injections_total",
    "chaos.violations_total",
    "chaos.clean_total",
})

METRIC_PREFIXES: Tuple[str, ...] = (
    "resilience.",   # resilience/events.py: one counter per event kind
    "lock.wait_s.",  # utils/guarded.py: one histogram per traced lock
    "numerics.",     # observability/numerics.py: one counter per event
    # serving/plane.py: the per-model families
    "serving.request_ms.",
    "serving.batch_fill.",
    "serving.rejected_total.",
    "serving.queue_wait_s.",
    "serving.phase_ms.",   # serving/plane.py: per phase, and per model
    "serving.availability.",           # observability/slo.py: per model
    "serving.error_budget_burn_rate.",
    "slo.",                # observability/slo.py: one counter per event
    "router.spill_total.",  # serving/router.py: per model
)


PIPELINE_LAYER = "pipeline API (fit and apply entry points)"
SOLVER_LAYER = "block solver and library kernels"

#: live span head -> the layer it times
SPAN_LAYERS: Dict[str, str] = {
    # workflow/pipeline.py: Pipeline.fit's body and PipelineResult.get
    "execute": PIPELINE_LAYER,
    # workflow/optimizer/rule.py: Optimizer.execute, per optimizer class
    "optimize": "workflow optimizer",
    # ops/linalg.py::bcd_core and nodes/learning/linear.py::gram_bcd:
    # each block's factor and each block update, per solver site
    "factor": SOLVER_LAYER,
    "block": SOLVER_LAYER,
    # parallel/streaming.py::fit_streaming: the carry's accumulate and
    # the world's merge
    "accumulate": SOLVER_LAYER,
    "merge": SOLVER_LAYER,
    # parallel/streaming.py: the consumer's wait for a staged chunk
    "stall": "streamed ingest",
}

#: the layer of a node span (``<label>#<id>``, workflow/executor.py)
NODE_SPAN_LAYER = PIPELINE_LAYER


def span_layer(name: str) -> Optional[str]:
    """The layer a live span of ``name`` times, or None for a name that
    is no catalogued span."""
    if "#" in name:
        return NODE_SPAN_LAYER
    return SPAN_LAYERS.get(name.split(":", 1)[0]) if ":" in name else None


def is_catalogued(name: str) -> bool:
    """True when ``name`` is listed, or falls inside a listed prefix."""
    return name in METRIC_NAMES or any(name.startswith(p)
                                       for p in METRIC_PREFIXES)


def is_catalogued_prefix(head: str) -> bool:
    """True when an f-string's literal head lands inside a listed prefix
    family."""
    return bool(head) and any(head.startswith(p) for p in METRIC_PREFIXES)
