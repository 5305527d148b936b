"""The program's own spans in a traced run: each idle stretch of the
units' span charged to the layer the host was in.

The program names each of its live spans after its layer
(``keystone_tpu_torch/observability/names.py::SPAN_LAYERS``) and, while
the profiler records, lays it into the trace as a ``record_function``
range on the profiler's clock. :data:`LAYERS` is a frozen copy of that
table (a test holds the two equal), so the yardstick does not move when
the program's table does. An idle stretch (no kernel, copy or set on
the device) is split by the innermost program span open at each
instant: the latest started among the host events whose names the table
knows. The harness's own annotations (``perfbench.unit``,
``pipeline.build``, ``pipeline.fit``, ``pipeline.apply``) and the
profiler's operator events are no program span. Idle that no program
span covers is charged to None.

Reads only a :class:`~perfbench.trace.Summary`'s ``host``, ``device``
and ``window``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from perfbench.trace import gaps

INGEST = "streamed ingest"
SOLVER = "block solver and library kernels"
OPTIMIZER = "workflow optimizer"
EXECUTOR = "pipeline API (fit and apply entry points)"

#: span head (the name before its first ``:``) -> layer
LAYERS: Dict[str, str] = {
    "stall": INGEST,
    "factor": SOLVER,
    "block": SOLVER,
    "accumulate": SOLVER,
    "merge": SOLVER,
    "optimize": OPTIMIZER,
    "execute": EXECUTOR,
}

#: the layer of a node span (a name holding ``#``: ``<label>#<id>``)
NODE_LAYER = EXECUTOR


def layer_of(name: str) -> Optional[str]:
    """The layer of the host event ``name``, or None for an event that is
    no program span."""
    if "#" in name:
        return NODE_LAYER
    return LAYERS.get(name.split(":", 1)[0]) if ":" in name else None


def program_spans(summary) -> List[Tuple[float, float, str]]:
    """``(start, end, layer)`` of every program span in the trace."""
    out = []
    for name, a, b in summary.host:
        layer = layer_of(name)
        if layer is not None:
            out.append((a, b, layer))
    return out


def segments(spans, lo: float, hi: float
             ) -> List[Tuple[float, float, Optional[str]]]:
    """[lo, hi] cut where the innermost open span of ``spans`` (the
    latest started; of two started together, the first to end) changes:
    ``(start, end, its layer or None)``."""
    spans = sorted(s for s in spans if s[1] > lo and s[0] < hi)
    cuts = sorted({lo, hi, *(t for a, b, _ in spans for t in (a, b)
                             if lo < t < hi)})
    out: List[Tuple[float, float, Optional[str]]] = []
    active: List[Tuple[float, float, str]] = []
    nxt = 0
    for c0, c1 in zip(cuts, cuts[1:]):
        while nxt < len(spans) and spans[nxt][0] <= c0:
            active.append(spans[nxt])
            nxt += 1
        active = [s for s in active if s[1] >= c1]
        layer = (max(active, key=lambda s: (s[0], -s[1]))[2] if active
                 else None)
        if out and out[-1][2] == layer and out[-1][1] == c0:
            out[-1] = (out[-1][0], c1, layer)
        else:
            out.append((c0, c1, layer))
    return out


def idle_by_layer(summary) -> Dict[Optional[str], float]:
    """Seconds of the units' span in which the device was idle, by the
    layer of the innermost program span open then (None: none open)."""
    lo, hi = summary.window
    idle = gaps([(a, b) for _, a, b, _ in summary.device], lo, hi)
    segs = segments(program_spans(summary), lo, hi)
    out: Dict[Optional[str], float] = {}
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, layer = segs[k]
            width = min(b, s1) - max(a, s0)
            if width > 0:
                out[layer] = out.get(layer, 0.0) + width
            k += 1
    return out


def idle_ms(r, layer: str) -> Optional[float]:
    """Milliseconds a profiled unit the device idled while the host was
    in ``layer``; None where the units' span holds no span of the layer
    (a program without these spans) or no unit was profiled."""
    lo, hi = r.trace.window
    if not r.work or not any(s_layer == layer and b > lo and a < hi
                             for a, b, s_layer in program_spans(r.trace)):
        return None
    return 1e3 * idle_by_layer(r.trace).get(layer, 0.0) / len(r.work)
