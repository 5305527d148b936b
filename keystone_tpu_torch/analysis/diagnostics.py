"""Rule-based graph lints and the check report.

Counterpart of the graph half of ``keystone_tpu/analysis/diagnostics.py``.
Propagation errors (shape and dtype mismatches, host reads refused by
the meta device) come from ``interpreter.analyze``; this module adds the
structural lints:

* ``unbound-source``       a sink-reachable value depends on a source no
                           input spec was bound to
* ``dead-branch``          nodes no sink depends on (skipped at run time;
                           almost always a mis-wired graph)
* ``dtype-narrowing``      a node's output drops float width against its
                           inputs (f32 -> bf16/f16) without being an
                           explicit cast
* ``host-sync``            (static form) a device node's ``apply`` body
                           reads its item on the host: ``.item()``,
                           ``.tolist()``, ``.cpu()``, ``.numpy()``,
                           ``bool/int/float(item)`` or ``np.asarray(item)``
* ``fusion-prefix-hazard`` a saveable node's logical prefix changes under
                           map/gather fusion, so saved fitted state could
                           never be matched again
* ``non-streamable-fit``   an estimator fed a StreamingDataset without the
                           accumulate/finalize protocol (or streamed labels
                           beside resident data)
* ``host-stage-on-stream`` a host stage consumes a stream, whose chunks
                           lie on the device

plus :func:`scan_metric_names`, the metric-name drift check against
``observability/names.py``. ``sharding_flow_lint`` comes with the
multi-GPU port (ROADMAP A11); the AST-only lints of the JAX module
(casts before transfer, swallow-all handlers, NaN silencers, donation
and recompile hazards) with ROADMAP A12b.
"""
from __future__ import annotations

import ast
import inspect
import json
import textwrap
from dataclasses import asdict
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from ..workflow.graph import Graph
from ..workflow.graph_ids import GraphId, SourceId
from .interpreter import (
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    Analysis,
    Diagnostic,
    analyze,
)
from .spec import (
    AbstractValue,
    DatasetSpec,
    DatumSpec,
    ShapeDtype,
    Unknown,
    as_input_spec,
    element_leaves,
    format_element,
)


# -- structural lints ---------------------------------------------------------

def _sink_reachable(graph: Graph) -> set:
    needed: set = set()
    for k in graph.sinks:
        dep = graph.get_sink_dependency(k)
        needed.add(dep)
        needed |= graph.get_ancestors(dep)
    return needed


def unbound_source_lint(
    graph: Graph, source_specs: Mapping[SourceId, AbstractValue]
) -> List[Diagnostic]:
    out = []
    needed = _sink_reachable(graph)
    for s in sorted(graph.sources, key=lambda g: g.id):
        if s in source_specs:
            continue
        if s in needed:
            out.append(Diagnostic(
                code="unbound-source", severity=SEVERITY_ERROR,
                node_id=s.id, operator="Source",
                message=("a sink-reachable value depends on source "
                         f"{s.id} but no input spec was bound to it")))
    return out


def dead_branch_lint(graph: Graph) -> List[Diagnostic]:
    needed = _sink_reachable(graph)
    out = []
    for n in sorted(graph.nodes, key=lambda g: g.id):
        if n not in needed:
            out.append(Diagnostic(
                code="dead-branch", severity=SEVERITY_WARNING,
                node_id=n.id, operator=graph.get_operator(n).label(),
                message="no sink depends on this node; it will never "
                        "execute (mis-wired branch?)"))
    return out


def _float_widths(spec: AbstractValue) -> List[int]:
    element = getattr(spec, "element", None)
    if element is None:
        return []
    return [torch.finfo(leaf.dtype).bits for leaf in element_leaves(element)
            if isinstance(leaf, ShapeDtype) and leaf.dtype.is_floating_point]


def dtype_narrowing_lint(analysis: Analysis) -> List[Diagnostic]:
    graph = analysis.graph
    out = []
    for n in sorted(graph.nodes, key=lambda g: g.id):
        op = graph.get_operator(n)
        if getattr(op, "narrowing_ok", False):
            continue  # explicit casts narrow on purpose
        out_w = _float_widths(analysis.value(n))
        if not out_w:
            continue
        in_w: List[int] = []
        for d in graph.get_dependencies(n):
            in_w.extend(_float_widths(analysis.value(d)))
        if in_w and min(out_w) < min(in_w):
            out.append(Diagnostic(
                code="dtype-narrowing", severity=SEVERITY_WARNING,
                node_id=n.id, operator=op.label(),
                message=(f"output narrows floats to {min(out_w)}-bit from "
                         f"{min(in_w)}-bit inputs; silent precision loss "
                         "across a node boundary (mark the operator "
                         "`narrowing_ok = True` if intentional)")))
    return out


# -- host-sync AST lint --------------------------------------------------------

#: tensor methods that copy a device value to the host and wait for it
_HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
#: builtins whose call on a tensor reads its value on the host
_HOST_READ_BUILTINS = {"bool", "int", "float"}
#: numpy coercions of a tensor (``np.asarray`` calls ``.numpy()``)
_NUMPY_COERCIONS = {"asarray", "array", "ascontiguousarray"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}


#: attributes and methods that read a tensor's metadata, not its data
_METADATA_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_METADATA_CALLS = {"dim", "size", "numel", "len", "isinstance", "type"}


def _names_in(node) -> set:
    """Names whose DATA ``node`` reads: a name reached only through its
    metadata (``x.shape``, ``x.dim()``, ``len(x)``) does not count."""
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute) and node.attr in _METADATA_ATTRS:
        return set()
    if isinstance(node, ast.Call):
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(
            f, "id", None)
        if name in _METADATA_CALLS:
            return set()
    out: set = set()
    for child in ast.iter_child_nodes(node):
        out |= _names_in(child)
    return out


def host_coercions_in_funcdef(fdef) -> List[tuple]:
    """``(lineno, description)`` for each host read of a value computed
    from one of ``fdef``'s own parameters: ``x.item()``, ``x.tolist()``,
    ``x.cpu()``, ``x.numpy()``, ``bool(x)`` / ``int(x)`` / ``float(x)``
    and ``np.asarray(x)`` (or ``np.array``), where ``x`` is an
    expression over a parameter (``(x * 2).sum().item()`` counts). Reads
    of static config (seeds, index tables) are not flagged."""
    params = {a.arg for a in fdef.args.args[1:]}  # skip self
    hits = []
    for node in ast.walk(fdef):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_READ_METHODS \
                and not (isinstance(f.value, ast.Name)
                         and f.value.id in _NUMPY_ALIASES):
            used = _names_in(f.value) & params
            if used:
                hits.append((node.lineno,
                             f"{sorted(used)[0]}...{f.attr}()"))
            continue
        if not node.args:
            continue
        arg_names = _names_in(node.args[0]) & params
        if not arg_names:
            continue
        if isinstance(f, ast.Name) and f.id in _HOST_READ_BUILTINS:
            hits.append((node.lineno, f"{f.id}({sorted(arg_names)[0]})"))
        elif (isinstance(f, ast.Attribute)
              and isinstance(f.value, ast.Name)
              and f.value.id in _NUMPY_ALIASES
              and f.attr in _NUMPY_COERCIONS):
            hits.append((node.lineno,
                         f"{f.value.id}.{f.attr}({sorted(arg_names)[0]})"))
    return hits


def apply_body_host_coercions(cls) -> List[str]:
    """The host reads of the item in ``cls.apply``: the static (AST)
    form of the host-sync lint. Host stages are exempt."""
    from ..workflow.transformer import HostTransformer, Transformer

    if not (isinstance(cls, type) and issubclass(cls, Transformer)):
        return []
    if issubclass(cls, HostTransformer):
        return []  # host stages have host semantics by design
    fn = cls.__dict__.get("apply")
    if fn is None:
        return []
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError, SyntaxError):
        return []
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    return [what for _, what in host_coercions_in_funcdef(fdef)]


def host_sync_lint(graph: Graph) -> List[Diagnostic]:
    out = []
    seen_types = set()
    for n in sorted(graph.nodes, key=lambda g: g.id):
        op = graph.get_operator(n)
        stages = getattr(op, "stages", None) or getattr(
            op, "branches", None) or [op]
        for stage in stages:
            if type(stage) in seen_types:
                continue
            seen_types.add(type(stage))
            hits = apply_body_host_coercions(type(stage))
            if hits:
                out.append(Diagnostic(
                    code="host-sync", severity=SEVERITY_ERROR,
                    node_id=n.id, operator=stage.label(),
                    message=(f"apply() reads its item on the host via "
                             f"{', '.join(hits)}: a device sync per item; "
                             "keep it in torch or use a HostTransformer")))
    return out


# -- metric-name drift -----------------------------------------------------------

#: metric-factory method names whose first argument is a metric name
_METRIC_FACTORIES = frozenset({"counter", "gauge", "histogram", "timer"})


def metric_name_drift(tree) -> List[tuple]:
    """``(lineno, code, description)`` for every ``counter(...)`` /
    ``gauge(...)`` / ``histogram(...)`` / ``timer(...)`` call whose
    metric name is not in the catalogue (``observability/names.py``).
    Literal names must be catalogued (or lie under a catalogued prefix);
    f-strings must open with a catalogued prefix; a bare variable is
    uncheckable and passes."""
    from ..observability.names import (
        METRIC_PREFIXES,
        is_catalogued,
        is_catalogued_prefix,
    )

    hits: List[tuple] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_FACTORIES
                and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if not is_catalogued(arg.value):
                hits.append((
                    node.lineno, "metric-name-drift",
                    f".{node.func.attr}({arg.value!r}) uses an "
                    "uncatalogued metric name: add it to "
                    "observability/names.py (dashboards and benchdiff "
                    "address metrics by name)"))
        elif isinstance(arg, ast.JoinedStr):
            head = ""
            if arg.values and isinstance(arg.values[0], ast.Constant) \
                    and isinstance(arg.values[0].value, str):
                head = arg.values[0].value
            if not is_catalogued_prefix(head):
                hits.append((
                    node.lineno, "metric-name-drift",
                    f".{node.func.attr}(f\"{head}...\") does not open "
                    "with a catalogued metric-name prefix "
                    f"({', '.join(METRIC_PREFIXES)}): dynamic metric "
                    "families must be declared in observability/names.py "
                    "METRIC_PREFIXES"))
    return sorted(set(hits))


def scan_metric_names(pkg_root) -> List[dict]:
    """:func:`metric_name_drift` over a package tree, as
    ``[{file, lineno, code, message}]``."""
    from pathlib import Path

    pkg_root = Path(pkg_root)
    out: List[dict] = []
    for path in sorted(pkg_root.rglob("*.py")):
        rel = path.relative_to(pkg_root.parent)
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError:
            continue
        for lineno, code, msg in metric_name_drift(tree):
            out.append({"file": str(rel), "lineno": lineno,
                        "code": code, "message": msg})
    return out


# -- streaming lints ---------------------------------------------------------------

def _stages(op):
    return getattr(op, "stages", None) or getattr(op, "branches", None) \
        or [op]


def _streamed(analysis: Analysis, gid: GraphId) -> bool:
    value = analysis.value(gid)
    return isinstance(value, DatasetSpec) and value.streaming


def host_stage_on_stream_lint(analysis: Analysis) -> List[Diagnostic]:
    """Host stages cannot consume a StreamingDataset (its chunks lie on
    the device; ``HostTransformer.apply_dataset`` raises at run time):
    flag it before anything runs, naming the stage."""
    from ..workflow.transformer import HostTransformer

    graph = analysis.graph
    out = []
    for n in sorted(graph.nodes, key=lambda g: g.id):
        host = [s for s in _stages(graph.get_operator(n))
                if isinstance(s, HostTransformer)]
        if not host:
            continue
        if any(_streamed(analysis, d) for d in graph.get_dependencies(n)):
            out.append(Diagnostic(
                code="host-stage-on-stream", severity=SEVERITY_ERROR,
                node_id=n.id, operator=host[0].label(),
                message=(
                    f"host stage {host[0].label()!r} consumes a streaming "
                    "dataset; chunks are device-resident and a host stage "
                    "would copy every one back (this raises at run time). "
                    "Run host stages before building the stream, or "
                    "materialize() it")))
    return out


def non_streamable_fit_lint(analysis: Analysis) -> List[Diagnostic]:
    """Estimators fed a streaming dataset must have the accumulate /
    finalize protocol (``parallel.streaming.is_streamable``), or ``fit``
    raises at run time after the upstream pipeline has run; and the data
    input must stream where the labels do (the chunk loop is driven by
    the data)."""
    from ..parallel.streaming import is_streamable
    from ..workflow.operators import EstimatorOperator

    graph = analysis.graph
    out = []
    for n in sorted(graph.nodes, key=lambda g: g.id):
        op = graph.get_operator(n)
        if not isinstance(op, EstimatorOperator):
            continue
        streamed = [_streamed(analysis, d)
                    for d in graph.get_dependencies(n)]
        if not any(streamed):
            continue
        if not is_streamable(op):
            out.append(Diagnostic(
                code="non-streamable-fit", severity=SEVERITY_ERROR,
                node_id=n.id, operator=op.label(),
                message=(
                    f"estimator {op.label()!r} fits on a streaming dataset "
                    "but implements no accumulate(carry, chunk[, labels]) / "
                    "finalize(carry) protocol; the fit would have to "
                    "materialize the whole stream on the device. Use a "
                    "streamable estimator (the least-squares family, "
                    "StandardScaler) or materialize() the stream")))
        elif not streamed[0]:
            out.append(Diagnostic(
                code="non-streamable-fit", severity=SEVERITY_ERROR,
                node_id=n.id, operator=op.label(),
                message=(
                    f"estimator {op.label()!r} has a streaming LABELS input "
                    "but resident data; the streamed chunk loop is driven "
                    "by the data input. Stream the data too (aligned chunk "
                    "sizes), or materialize() the labels")))
    return out


# -- fusion/prefix hazard -----------------------------------------------------------

def _fusion_fixpoint(graph: Graph) -> Graph:
    from ..workflow.optimizer.fusion import GatherFusionRule, MapFusionRule

    rules = [MapFusionRule(), GatherFusionRule()]
    for _ in range(1000):
        nxt = graph
        for r in rules:
            nxt = r.apply(nxt)
        if nxt is graph:
            return graph
        graph = nxt
    return graph


def fusion_prefix_lint(
    graph: Graph, fuse: Optional[Callable[[Graph], Graph]] = None
) -> List[Diagnostic]:
    """Saveable nodes must keep their logical prefix under map/gather
    fusion, or fitted state saved by an optimized run can never be
    matched on a later raw graph: compare each saveable node's prefix
    before and after the fusion rules."""
    from ..workflow.executor import is_saveable
    from ..workflow.prefix import compute_prefix

    pre_memo: Dict[GraphId, Any] = {}
    pre = {n: compute_prefix(graph, n, pre_memo)
           for n in graph.nodes if is_saveable(graph.get_operator(n))}
    pre = {n: p for n, p in pre.items() if p is not None}
    if not pre:
        return []
    fused = (fuse or _fusion_fixpoint)(graph)
    if fused is graph:
        return []
    out = []
    post_memo: Dict[GraphId, Any] = {}
    for n, p in sorted(pre.items(), key=lambda kv: kv[0].id):
        if n not in fused.nodes:
            continue  # the saveable node itself was rewritten away
        if compute_prefix(fused, n, post_memo) != p:
            out.append(Diagnostic(
                code="fusion-prefix-hazard", severity=SEVERITY_ERROR,
                node_id=n.id, operator=graph.get_operator(n).label(),
                message=("logical prefix changes under map/gather fusion; "
                         "saved fitted state for this node would never be "
                         "matched again (canonicalize the fused operator's "
                         "prefix, workflow/prefix.py)")))
    return out


# -- report ----------------------------------------------------------------------------

class AnalysisReport:
    """One static check's outcome: the abstract value of each node, all
    diagnostics and the static device-memory plan
    (:class:`~keystone_tpu_torch.analysis.resources.HbmPlan`)."""

    def __init__(self, name: str, analysis: Analysis,
                 diagnostics: List[Diagnostic], plan: Any = None):
        self.name = name
        self.analysis = analysis
        self.diagnostics = diagnostics
        self.plan = plan

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == SEVERITY_ERROR]

    def resolved_nodes(self) -> int:
        return sum(1 for n in self.analysis.graph.nodes
                   if not isinstance(self.analysis.value(n), Unknown))

    def to_dict(self) -> Dict[str, Any]:
        graph = self.analysis.graph
        nodes = [{"node_id": n.id,
                  "operator": graph.get_operator(n).label(),
                  "spec": repr(self.analysis.value(n))}
                 for n in sorted(graph.nodes, key=lambda g: g.id)]
        return {
            "name": self.name,
            "nodes": nodes,
            "diagnostics": [asdict(d) for d in self.diagnostics],
            "plan": None if self.plan is None else self.plan.to_dict(),
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def summary(self) -> str:
        graph = self.analysis.graph
        lines = [f"Static check {self.name!r}: {len(graph.nodes)} nodes, "
                 f"{self.resolved_nodes()} with resolved specs, "
                 f"{len(self.diagnostics)} diagnostic(s)",
                 f"{'node':>6} {'operator':<34} spec"]
        for n in sorted(graph.nodes, key=lambda g: g.id):
            spec = self.analysis.value(n)
            if isinstance(spec, (DatasetSpec, DatumSpec)):
                shown = (format_element(spec.element)
                         + (f" x n={spec.n}"
                            if isinstance(spec, DatasetSpec) else ""))
            else:
                shown = repr(spec)
            lines.append(f"{n.id:>6} {graph.get_operator(n).label()[:34]:<34}"
                         f" {shown}")
        if self.plan is not None:
            lines.append(self.plan.summary())
        if self.diagnostics:
            lines.append("diagnostics:")
            lines.extend(f"  {d}" for d in self.diagnostics)
        else:
            lines.append("no diagnostics: pipeline is statically clean")
        return "\n".join(lines)


def check_graph(
    graph: Graph,
    source_specs: Optional[Mapping[SourceId, AbstractValue]] = None,
    name: str = "graph",
    hbm_budget: Optional[float] = None,
) -> AnalysisReport:
    """The abstract interpreter, every graph lint and the static HBM
    planner over ``graph``. ``hbm_budget`` (bytes) adds an ``hbm-budget``
    error when the plan's fit-path peak exceeds it: the device-free form
    of the runtime budget check."""
    from .resources import plan_graph

    source_specs = dict(source_specs or {})
    analysis = analyze(graph, source_specs)
    diagnostics = list(analysis.diagnostics)
    diagnostics += unbound_source_lint(graph, source_specs)
    diagnostics += dead_branch_lint(graph)
    diagnostics += dtype_narrowing_lint(analysis)
    diagnostics += host_sync_lint(graph)
    diagnostics += fusion_prefix_lint(graph)
    diagnostics += non_streamable_fit_lint(analysis)
    diagnostics += host_stage_on_stream_lint(analysis)
    plan = plan_graph(analysis, name=name)
    if plan.over_budget(hbm_budget):
        mib = 1 << 20
        diagnostics.append(Diagnostic(
            code="hbm-budget", severity=SEVERITY_ERROR,
            node_id=plan.peak_node, operator="",
            message=(
                f"static HBM plan peaks at "
                f"{plan.fit_peak_nbytes / mib:.2f} MiB "
                f"(node {plan.peak_node}) > budget "
                f"{float(hbm_budget) / mib:.2f} MiB: the fit would "
                "violate its budget at run time; shrink the resident "
                "working set (stream the fit, reduce chunk/prefetch "
                "geometry, cache fewer intermediates)")))
    return AnalysisReport(name, analysis, diagnostics, plan=plan)


def check_pipeline(pipeline, sample: Any = None, name: str = "pipeline",
                   hbm_budget: Optional[float] = None) -> AnalysisReport:
    """``Pipeline.check``'s engine: bind ``sample`` (an input spec, see
    ``spec.as_input_spec``) to the pipeline's dangling source and check
    the whole graph."""
    p = pipeline.to_pipeline()
    specs = {}
    if sample is not None:
        specs[p._source] = as_input_spec(sample)
    return check_graph(p._graph, specs, name=name, hbm_budget=hbm_budget)
