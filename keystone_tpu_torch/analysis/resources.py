"""Static device-memory planning over the abstract interpretation.

Counterpart of ``keystone_tpu/analysis/resources.py``. From the shape and
dtype specs ``analysis.interpreter`` infers, plus (for streams) chunk
geometry, every node gets a :class:`ResourceEffect` (output bytes,
transient peak, accumulator carry), and a topo-order planner folds the
effects into a per-pipeline :class:`HbmPlan`: the pipeline's peak device
footprint on the card, known before a buffer is allocated.

The plan sizes what the port holds, which differs from the JAX package
in three places:

* **The executor memo.** The port's ``GraphExecutor`` memoizes every
  node's value for the life of the fit (``workflow/executor.py``), so an
  output stays live to the end of the plan; the JAX planner releases a
  value after its last consumer. ``plan_graph(memo_held=False)`` gives
  the JAX package's liveness.
* **SIFT band operators.** On the card each scale's two band pairs
  (smoothing, then keypoint-major sampling) are held as float32 device
  copies in the banded kernel's 256-pair LRU cache
  (``ops/kernels.py::_band_pair_on``); the bin-major sampling operator
  the JAX package also charges is a host array here. The live maps
  (int32, a few entries a 32-row tile) are not counted.
* **Fisher-vector workspace.** The ``fv_moments`` kernel writes the
  moment sums, ``K + 2 D K`` floats, and never the (nDesc, K) posteriors
  the JAX package's CPU path charges; its partial-sum scratch is planned
  by the built library and is not counted here.

The stream's charges are the runtime residency ledger's
(``parallel/streaming.py::_Residency``), one sizer for both:
``StreamingDataset.static_plan_nbytes`` is :meth:`StreamGeometry.
plan_nbytes` of the stream's geometry, the number ``plan_graph`` charges
at the stream's node. A served model's CUDA-graph pools are probed at
admission (``serving/residency.py``); :func:`serving_residency_nbytes`
adds them when they are known.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..workflow.graph_ids import GraphId, NodeId, SinkId
from .spec import (
    DatasetSpec,
    DatumSpec,
    ShapeDtype,
    TransformerSpec,
    element_feature_dim,
    element_leaves,
)


# -- stream geometry ------------------------------------------------------------

@dataclass(frozen=True)
class StreamGeometry:
    """Static chunk geometry of one ``StreamingDataset``: what the
    planner needs to reproduce the residency ledger's charges without
    consuming the stream."""

    chunk_rows: int          # padded rows a staged chunk
    prefetch_depth: int
    wire_row_nbytes: float   # bytes a row at the wire dtype
    work_row_nbytes: float   # bytes a row at the compute dtype
    cast: bool = False       # wire dtype != compute dtype
    #: True on specs propagated through a stream-consuming node: the
    #: ledger is shared with the root stream, so a derived view must not
    #: charge the same buffer again
    shared: bool = False

    def as_shared(self) -> "StreamGeometry":
        return dataclasses.replace(self, shared=True)

    def staged_chunk_nbytes(self) -> float:
        return float(self.chunk_rows) * self.wire_row_nbytes

    def working_chunk_nbytes(self) -> float:
        return float(self.chunk_rows) * self.work_row_nbytes

    def plan_nbytes(self) -> float:
        """The residency bound of one live iteration: ``prefetch_depth``
        staged wire chunks, one working chunk at the compute width and,
        when a cast runs, one transient wire chunk."""
        staged = self.staged_chunk_nbytes()
        return (self.prefetch_depth * staged + self.working_chunk_nbytes()
                + (staged if self.cast else 0.0))


# -- per-node effects ------------------------------------------------------------

@dataclass(frozen=True)
class ResourceEffect:
    """One node's static device-memory contribution: ``out_nbytes`` stays
    live (to the end under the executor memo), ``transient_nbytes`` only
    while the node runs, ``carry_nbytes`` is a streamed fit's accumulator
    (charged like a transient, reported apart), ``item_nbytes`` the
    per-item activation where ``n`` is unknown (the apply path's unit).
    ``resolved`` is False when the spec did not determine the bytes: the
    planner charges zero and lists the node rather than invent a
    number."""

    out_nbytes: float = 0.0
    transient_nbytes: float = 0.0
    carry_nbytes: float = 0.0
    item_nbytes: Optional[float] = None
    resolved: bool = True
    note: str = ""


def element_nbytes(element: Any) -> Optional[float]:
    """Bytes of one item, or None when a leaf is opaque or sparse."""
    total = 0.0
    for leaf in element_leaves(element):
        if not isinstance(leaf, ShapeDtype):
            return None
        total += leaf.nbytes
    return total


def padded_rows(n: int, shards: int) -> int:
    """Rows a resident batch of ``n`` items occupies after padding
    (``parallel.dataset.padded_rows``: the planner charges what the
    dataset pads)."""
    from ..parallel.dataset import padded_rows as _rows

    return _rows(n, shards)


def spec_effect(spec: Any, data_shards: int) -> ResourceEffect:
    """The default effect derived from a node's output spec."""
    if isinstance(spec, DatasetSpec):
        if spec.streaming:
            geom = spec.geometry
            if geom is None:
                return ResourceEffect(
                    resolved=False,
                    note="streaming dataset with opaque chunk geometry")
            if geom.shared:
                # a derived view: the root stream's node charged the
                # buffer; what is new here is one transformed chunk
                per_item = element_nbytes(spec.element)
                if per_item is None:
                    return ResourceEffect(
                        resolved=False,
                        note="stream view with unsized transformed "
                             "element (buffer charged at the root)")
                return ResourceEffect(
                    out_nbytes=float(geom.chunk_rows) * per_item,
                    note="stream view (buffer charged at the root; "
                         "one transformed chunk here)")
            return ResourceEffect(out_nbytes=geom.plan_nbytes(),
                                  note="stream residency bound")
        per_item = element_nbytes(spec.element)
        if spec.host:
            return ResourceEffect(out_nbytes=0.0, item_nbytes=per_item,
                                  note="host-resident (zero device bytes)")
        if per_item is None:
            return ResourceEffect(resolved=False,
                                  note="element not fully specified")
        if spec.n is None:
            return ResourceEffect(out_nbytes=0.0, item_nbytes=per_item,
                                  note="n unknown (per-item only)")
        return ResourceEffect(
            out_nbytes=float(padded_rows(spec.n, data_shards)) * per_item)
    if isinstance(spec, DatumSpec):
        per = element_nbytes(spec.element)
        if per is None:
            return ResourceEffect(resolved=False,
                                  note="datum element not specified")
        return ResourceEffect(out_nbytes=per, item_nbytes=per)
    if isinstance(spec, TransformerSpec):
        return ResourceEffect(out_nbytes=0.0, note="transformer")
    return ResourceEffect(resolved=False, note="unknown spec")


# -- estimator sizes ---------------------------------------------------------------

def _data_label_dims(dep_specs: Sequence[Any]):
    d = element_feature_dim(dep_specs[0]) if dep_specs else None
    k = element_feature_dim(dep_specs[1]) if len(dep_specs) > 1 else None
    return d, k


def gram_carry_nbytes(dep_specs: Sequence[Any]) -> Optional[float]:
    """float32 Gram/cross/sums carry of the least-squares family, ``G (d,
    d) + C (d, k) + sx (d) + sy (k)``: also the Gram workspace a resident
    normal-equations solve makes."""
    d, k = _data_label_dims(dep_specs)
    if d is None:
        return None
    k = k or 0
    return 4.0 * (d * d + d * k + d + k)


def linear_model_nbytes(dep_specs: Sequence[Any]) -> Optional[float]:
    """float32 fitted linear model: weights (d, k), intercept (k,),
    feature means (d,)."""
    d, k = _data_label_dims(dep_specs)
    if d is None or k is None:
        return None
    return 4.0 * (d * k + d + k)


def moments_carry_nbytes(dep_specs: Sequence[Any]) -> Optional[float]:
    """Column-moment carry (sums and sums of squares) of the scaler."""
    d, _ = _data_label_dims(dep_specs)
    return None if d is None else 2.0 * 4.0 * d


# -- kernel workspace ----------------------------------------------------------------

def fv_apply_transient_nbytes(d: int, k: int,
                              n_desc: Optional[int]) -> Optional[float]:
    """Per-item workspace of the Fisher-vector apply on the card: the
    ``fv_moments`` kernel's moment sums, ``K + 2 D K`` floats (the
    posteriors stay in registers). ``n_desc`` is not needed: the kernel
    takes every descriptor count."""
    return 4.0 * float(k + 2 * d * k)


def sift_band_operator_nbytes(height: int, width: int, step: int,
                              bin_size: int, num_scales: int,
                              scale_step: int) -> float:
    """Device bytes of one dense-SIFT configuration's band operators on
    the card: for each scale the smoothing pair (H, H) + (W, W) and the
    keypoint-major sampling pair (NBP ny, H) + (NBP nx, W), float32, held
    by the banded kernel's LRU cache across every image of the
    configuration."""
    from ..ops.sift import NBP, _keypoint_grid, _scale_params

    total = 0.0
    for scale in range(num_scales):
        s, bs, lo = _scale_params(scale, step, bin_size, num_scales,
                                  scale_step)
        total += 4.0 * (height * height + width * width)
        extent = float(bs * NBP)
        ny = len(_keypoint_grid(height, lo, height - 1, s, extent))
        nx = len(_keypoint_grid(width, lo, width - 1, s, extent))
        total += 4.0 * (NBP * ny * height + NBP * nx * width)
    return total


def transform_workspace_effect(per_item_fn, data_specs: Sequence[Any],
                               out_spec: Any, data_shards: int
                               ) -> Optional[ResourceEffect]:
    """The spec-derived effect of an apply node plus its declared per-item
    device workspace, which scales with the batch for a resident dataset
    of known size and is charged once an item otherwise (one chunk's
    items for a stream). None, deferring to the derived effect, when the
    workspace does not resolve."""
    data = [s for s in data_specs if isinstance(s, (DatasetSpec, DatumSpec))]
    if not callable(per_item_fn) or not data:
        return None
    per_item = per_item_fn(data[0].element)
    if per_item is None:
        return None
    if getattr(data[0], "streaming", False):
        geom = getattr(data[0], "geometry", None)
        items = geom.chunk_rows if geom is not None else 1
    else:
        n = getattr(data[0], "n", None)
        items = 1 if n is None else padded_rows(n, data_shards)
    base = spec_effect(out_spec, data_shards)
    return dataclasses.replace(
        base, transient_nbytes=base.transient_nbytes + float(per_item) * items,
        note=(base.note + "; " if base.note else "") + "apply kernel workspace")


def delegate_resource_effect(dep_specs: Sequence[Any], out_spec: Any,
                             data_shards: int) -> Optional[ResourceEffect]:
    """Effect of a Delegate (fitted-transformer apply) node: the output
    charge plus the fitted transformer's declared apply workspace."""
    t = dep_specs[0] if dep_specs else None
    return transform_workspace_effect(
        getattr(t, "apply_transient_nbytes", None), dep_specs[1:],
        out_spec, data_shards)


def estimator_resource_effect(estimator: Any,
                              dep_specs: Sequence[Any]) -> ResourceEffect:
    """Effect of an estimator node: the fitted model stays live; the
    accumulator carry (the resident solver's Gram workspace) is charged
    during the fit. Sizes come from the optional ``carry_nbytes`` /
    ``fitted_nbytes`` hooks; an estimator with neither resolves to zero
    bytes and is listed as unresolved."""
    carry_fn = getattr(estimator, "carry_nbytes", None)
    fitted_fn = getattr(estimator, "fitted_nbytes", None)
    carry = carry_fn(dep_specs) if callable(carry_fn) else None
    fitted = fitted_fn(dep_specs) if callable(fitted_fn) else None
    declared = callable(carry_fn) or callable(fitted_fn)
    resolved = declared and not (
        (callable(carry_fn) and carry is None)
        or (callable(fitted_fn) and fitted is None))
    return ResourceEffect(
        out_nbytes=float(fitted or 0.0),
        carry_nbytes=float(carry or 0.0),
        resolved=resolved,
        note="" if declared else "estimator declares no carry/fitted size")


# -- serving residency --------------------------------------------------------------

def serving_residency_nbytes(model_nbytes: float, plan: "HbmPlan",
                             bucket_rows: int,
                             graph_nbytes: float = 0.0) -> Optional[float]:
    """The admission charge of one served model at its largest bucket:
    ``model_nbytes + bucket_rows x apply_item_nbytes``, plus the CUDA
    graphs' pools and static inputs (``graph_nbytes``) where the plane
    captures them, which only a probe capture on the card measures
    (``serving/residency.py::model_charge``); a device-free check passes
    0. None when the plan could not size the per-item activation: the
    caller must probe rather than admit on an invented number."""
    item = float(plan.apply_item_nbytes)
    if item <= 0.0 and plan.unresolved:
        return None
    return (float(model_nbytes) + float(bucket_rows) * item
            + float(graph_nbytes))


# -- the plan -------------------------------------------------------------------------

@dataclass
class HbmPlan:
    """One pipeline's static device-memory plan.

    ``fit_peak_nbytes`` is the peak over the fit path's topo order: the
    live outputs plus the running node's transient and carry.
    ``model_nbytes`` is the fitted state that persists (the apply path's
    resident cost); ``apply_item_nbytes`` the widest per-item activation
    on the unknown-``n`` apply path. Nodes whose bytes could not be
    derived are charged zero and listed in ``unresolved``."""

    name: str
    entries: List[Dict[str, Any]] = field(default_factory=list)
    fit_peak_nbytes: float = 0.0
    peak_node: Optional[int] = None
    model_nbytes: float = 0.0
    apply_item_nbytes: float = 0.0
    unresolved: List[str] = field(default_factory=list)

    def over_budget(self, budget: Optional[float]) -> bool:
        return budget is not None and self.fit_peak_nbytes > float(budget)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "fit_peak_nbytes": self.fit_peak_nbytes,
            "peak_node": self.peak_node,
            "model_nbytes": self.model_nbytes,
            "apply_item_nbytes": self.apply_item_nbytes,
            "unresolved": list(self.unresolved),
            "entries": list(self.entries),
        }

    def summary(self) -> str:
        mib = 1 << 20
        lines = [
            f"static HBM plan {self.name!r}: fit peak "
            f"{self.fit_peak_nbytes / mib:.2f} MiB"
            + (f" @ node {self.peak_node}"
               if self.peak_node is not None else "")
            + f", fitted models {self.model_nbytes / mib:.2f} MiB, "
            f"apply {self.apply_item_nbytes / 1024.0:.1f} KiB/item"]
        if self.unresolved:
            lines.append(
                f"  unresolved ({len(self.unresolved)}): "
                + ", ".join(self.unresolved[:6])
                + (" ..." if len(self.unresolved) > 6 else ""))
        return "\n".join(lines)


def plan_graph(analysis: Any, name: str = "graph",
               data_shards: Optional[int] = None,
               memo_held: bool = True) -> HbmPlan:
    """Fold per-node :class:`ResourceEffect` s into an :class:`HbmPlan`
    over the topo order (``Graph.linearize``). With ``memo_held`` (the
    port's executor) an output stays live to the end; without it, the
    JAX package's liveness, an output is released after its last
    consumer's step (sink-held values stay). A node's transient and
    carry are charged at its own step. Reads only specs and integer
    geometry. ``data_shards`` is 1 on one GPU (ROADMAP A11)."""
    data_shards = 1 if data_shards is None else int(data_shards)
    graph = analysis.graph
    order = [g for g in graph.linearize() if not isinstance(g, SinkId)]
    pos = {gid: i for i, gid in enumerate(order)}
    last_use: Dict[GraphId, int] = {}
    for n in graph.nodes:
        for d in graph.get_dependencies(n):
            if d in pos:
                last_use[d] = max(last_use.get(d, -1), pos[n])
    sink_held = {graph.get_sink_dependency(k) for k in graph.sinks}

    plan = HbmPlan(name)
    live: Dict[GraphId, float] = {}
    for i, gid in enumerate(order):
        spec = analysis.value(gid)
        eff = spec_effect(spec, data_shards)
        label = "Source"
        if isinstance(gid, NodeId):
            op = graph.get_operator(gid)
            label = op.label()
            dep_specs = [analysis.value(d)
                         for d in graph.get_dependencies(gid)]
            override = op.resource_effect(dep_specs, spec,
                                          data_shards=data_shards)
            if override is not None:
                eff = override
        live[gid] = eff.out_nbytes
        step = sum(live.values()) + eff.transient_nbytes + eff.carry_nbytes
        if step > plan.fit_peak_nbytes:
            plan.fit_peak_nbytes = step
            plan.peak_node = gid.id
        if eff.carry_nbytes or (isinstance(gid, NodeId) and isinstance(
                spec, TransformerSpec)):
            plan.model_nbytes += eff.out_nbytes
        if eff.item_nbytes:
            plan.apply_item_nbytes = max(plan.apply_item_nbytes,
                                         eff.item_nbytes)
        if not eff.resolved:
            plan.unresolved.append(f"node {gid.id} [{label}]"
                                   + (f": {eff.note}" if eff.note else ""))
        plan.entries.append({
            "node_id": gid.id,
            "operator": label,
            "out_nbytes": eff.out_nbytes,
            "transient_nbytes": eff.transient_nbytes,
            "carry_nbytes": eff.carry_nbytes,
            "item_nbytes": eff.item_nbytes,
            "live_nbytes": step,
            "resolved": eff.resolved,
            "note": eff.note,
        })
        if not memo_held:
            for d in [d for d in live
                      if d not in sink_held and last_use.get(d, -1) <= i
                      and d is not gid]:
                del live[d]
    return plan


def stream_plan_nbytes(stream: Any) -> Optional[float]:
    """The plan's charge at a root stream's node (the one sizer
    ``StreamingDataset.static_plan_nbytes`` reads), None for an opaque
    source."""
    from .spec import dataset_spec

    spec = dataset_spec(stream)
    if not isinstance(spec, DatasetSpec) or spec.geometry is None:
        return None
    return spec_effect(spec, 1).out_nbytes

