"""Abstract interpretation of a workflow Graph.

Counterpart of ``keystone_tpu/analysis/interpreter.py``. Walks the DAG in
topological order (``Graph.linearize``), calling each operator's
``abstract_eval`` on its dependencies' abstract values
(``analysis.spec``). Per-item functions run on meta tensors, so no
device memory is allocated, no kernel launches and no data is read.

Failures during a node's abstract evaluation become diagnostics:

* a shape or dtype error                 -> ``shape-mismatch``
* a host read of a device value          -> ``host-sync``: the meta
  device refuses ``.item()`` (and ``bool`` / ``int`` / ``float`` of a
  tensor), ``.tolist()``, ``.cpu()``, ``.numpy()`` / ``np.asarray`` and
  data-dependent shapes (``nonzero``, boolean masks, ``unique``): each
  is a device-to-host round trip inside a device node's ``apply`` that
  serializes the pipeline on a card

and the failing node's output becomes :class:`~.spec.Unknown`, so one
real error does not cascade into follow-on reports.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

from ..workflow.graph import Graph
from ..workflow.graph_ids import GraphId, NodeId, SinkId, SourceId
from .spec import AbstractValue, Unknown

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

#: what the meta device says when a value's data is asked for: the
#: torch form of JAX's tracer-conversion errors
_HOST_READ_MESSAGES = (
    "cannot be called on meta tensors",          # .item(), bool/int/float
    "Cannot copy out of meta tensor",            # .cpu(), .tolist(), .to
    "can't convert meta device type tensor",     # .numpy(), np.asarray
    "data-independent implementation does not exist",  # nonzero, masks
    "data-dependent",
    "data dependent",
    "with Meta tensors, but there was no fake impl or Meta kernel",
)


@dataclass
class Diagnostic:
    """One statically detected problem."""

    code: str            # lint identifier, e.g. "shape-mismatch"
    severity: str        # "error" | "warning"
    node_id: Optional[int]
    operator: str        # operator label (or "" for graph-level lints)
    message: str

    def __str__(self) -> str:
        where = f" @ node {self.node_id}" if self.node_id is not None else ""
        op = f" [{self.operator}]" if self.operator else ""
        return f"{self.severity}: {self.code}{where}{op}: {self.message}"


@dataclass
class Analysis:
    """Abstract values per graph id plus propagation diagnostics."""

    graph: Graph
    values: Dict[GraphId, AbstractValue] = field(default_factory=dict)
    diagnostics: List[Diagnostic] = field(default_factory=list)

    def value(self, gid: GraphId) -> AbstractValue:
        return self.values.get(gid, Unknown("not analyzed"))


def classify_failure(exc: BaseException) -> str:
    """Map an abstract-evaluation exception to a lint code: a host read
    refused by the meta device is ``host-sync``, anything else
    ``shape-mismatch``."""
    text = str(exc)
    if isinstance(exc, (RuntimeError, NotImplementedError, TypeError)) \
            and any(m in text for m in _HOST_READ_MESSAGES):
        return "host-sync"
    return "shape-mismatch"


def _first_line(exc: BaseException) -> str:
    text = str(exc).strip()
    return text.splitlines()[0] if text else type(exc).__name__


def _memo_key(op, dep_specs) -> Optional[tuple]:
    """The key under which a transformer's output spec may be reused: an
    equal operator (``eq_key``, the equality CSE merges by) on equal data
    specs gives an equal spec. None where that does not hold or the key
    does not hash."""
    from ..workflow.operators import TransformerOperator
    from .spec import DatasetSpec, DatumSpec

    if not isinstance(op, TransformerOperator) or not all(
            isinstance(d, (DatasetSpec, DatumSpec)) for d in dep_specs):
        return None
    key = (type(op), op._cached_eq_key(), tuple(dep_specs))
    try:
        hash(key)
    except TypeError:
        return None
    return key


def analyze(
    graph: Graph,
    source_specs: Optional[Mapping[SourceId, AbstractValue]] = None,
    memo: Optional[Dict[tuple, AbstractValue]] = None,
) -> Analysis:
    """Propagate abstract values through ``graph``.

    ``source_specs`` binds dangling sources (a pipeline's runtime input)
    to input specs; unbound sources propagate Unknown (and are reported
    by the ``unbound-source`` lint in ``diagnostics.py`` if anything
    reachable from a sink consumes them). ``memo`` (a dict the caller
    keeps) reuses the output spec of an equal transformer on equal
    inputs, within this call and across calls: a graph holding the same
    SIFT chain twice, or the node rule's analysis after a splice, runs
    each distinct per-item function on meta tensors once."""
    source_specs = dict(source_specs or {})
    memo = {} if memo is None else memo
    result = Analysis(graph)
    values = result.values
    for gid in graph.linearize():
        if isinstance(gid, SourceId):
            values[gid] = source_specs.get(gid, Unknown("unbound source"))
            continue
        if isinstance(gid, SinkId):
            values[gid] = values.get(
                graph.get_sink_dependency(gid), Unknown("missing dep"))
            continue
        assert isinstance(gid, NodeId)
        op = graph.get_operator(gid)
        dep_specs = [values.get(d, Unknown("missing dep"))
                     for d in graph.get_dependencies(gid)]
        key = _memo_key(op, dep_specs)
        if key is not None and key in memo:
            values[gid] = memo[key]
            continue
        try:
            values[gid] = op.abstract_eval(dep_specs)
            if key is not None:
                memo[key] = values[gid]
        except Exception as exc:  # classified into a diagnostic
            code = classify_failure(exc)
            if code == "host-sync":
                msg = ("per-item apply reads a device value on the host "
                       f"({_first_line(exc)}); wrap in a HostTransformer "
                       "or keep the computation in torch on the device")
            else:
                msg = _first_line(exc)
            result.diagnostics.append(Diagnostic(
                code=code, severity=SEVERITY_ERROR, node_id=gid.id,
                operator=op.label(), message=msg))
            values[gid] = Unknown(f"abstract eval failed: {code}")
    return result
