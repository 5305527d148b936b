"""Profile-driven automatic caching.

Counterpart of ``keystone_tpu/workflow/optimizer/auto_cache.py``
(reference ``workflow/AutoCacheRule.scala``). The reference profiles
each node on small samples of the data, extrapolates its time and
memory linearly to the full size, and inserts ``Cacher`` nodes, greedily
under a memory budget or aggressively at every reused output. Here, as
in the JAX package, a dataset is a tensor on the device, and a Cacher
makes its node's value enter the cross-pipeline prefix memo, where it
stays resident and is reused across fits and applies.

The planning (``get_runs`` with node weights, the linear
generalization, the aggressive and the greedy selection) is the JAX
package's. The differences:

* ``profile_graph`` runs each node on the sample itself, without a
  ``GraphExecutor``, so the sampled fits never enter the global prefix
  memo; and it synchronizes the value's CUDA device before reading the
  clock, as the JAX package blocks on the value.
* The budget (``_device_mem_budget``) is 75% of the free memory of the
  graph's CUDA device as ``torch.cuda.mem_get_info`` reads it; only for
  a graph on the CPU is it the JAX package's fallback, 75% of 8 GiB.
* One device and no mesh: the sample at scale s holds s items, and each
  scale is profiled once (the JAX package's ``num_trials`` is 1 at
  every caller).
* The sampled executions run under ``tracing_disabled`` and the choice
  goes to the active trace (``record_auto_cache``), as in the JAX
  package.

``greedy_select`` also serves the serving plane's eviction plan.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from ...observability.trace import current_trace, tracing_disabled
from ...parallel.dataset import (
    ArrayDataset,
    HostDataset,
    device_nbytes,
    is_streaming,
    tree_leaves,
)
from ..common import Cacher
from ..graph import Graph
from ..graph_ids import NodeId
from ..operators import (
    DatasetOperator,
    EstimatorOperator,
    ExpressionOperator,
    Operator,
)
from .node_rule import _dataset_len, _sample_dataset
from .rule import Rule

#: the JAX package's device-memory assumption where no device reports
#: its memory (here: a graph on the CPU)
_FALLBACK_DEVICE_BYTES = 8 * (1 << 30)


@dataclass
class Profile:
    """One node's cost (reference ``AutoCacheRule.scala:9-11``): time in
    ns and the device bytes of its output."""

    ns: float = 0.0
    mem: float = 0.0


@dataclass
class SampleProfile:
    scale: int
    profile: Profile


def node_weight(op: Operator) -> int:
    """Passes an operator makes over its inputs (reference WeightedNode,
    ``AutoCacheRule.scala:20-32``); iterative solvers export ``weight``."""
    return int(getattr(op, "weight", 1))


def _children_with_multiplicity(graph: Graph) -> Dict[NodeId, List[NodeId]]:
    out: Dict[NodeId, List[NodeId]] = {n: [] for n in graph.nodes}
    for n in graph.nodes:
        for dep in graph.get_dependencies(n):
            if isinstance(dep, NodeId):
                out[dep].append(n)
    return out


def get_runs(
    graph: Graph,
    children: Dict[NodeId, List[NodeId]],
    cache: frozenset,
    weights: Dict[NodeId, int],
) -> Dict[NodeId, int]:
    """Estimated executions of each node given a cache set, accumulated
    in reverse topological order (reference ``AutoCacheRule.scala:46-71``)."""
    runs: Dict[NodeId, int] = {}
    order = [g for g in graph.linearize() if isinstance(g, NodeId)]
    for node in reversed(order):
        kids = children.get(node, [])
        if not kids:
            runs[node] = 1
        else:
            runs[node] = sum(
                weights[c] if c in cache else weights[c] * runs[c]
                for c in kids
            )
    return runs


def init_cache_set(graph: Graph) -> frozenset:
    """Nodes whose results are cached already (reference
    ``AutoCacheRule.scala:76-84``): estimator fits, saved expressions and
    Cachers."""
    return frozenset(
        n for n in graph.nodes
        if isinstance(graph.get_operator(n),
                      (EstimatorOperator, ExpressionOperator, Cacher)))


def _data_outputting(graph: Graph, node: NodeId) -> bool:
    """Only dataset-producing, non-Cacher nodes get a Cacher (reference
    ``makeCachedPipeline``, ``AutoCacheRule.scala:388-396``)."""
    op = graph.get_operator(node)
    return not isinstance(op, (Cacher, EstimatorOperator,
                               ExpressionOperator))


def generalize_profiles(new_scale: int,
                        samples: Sequence[SampleProfile]) -> Profile:
    """Fit y = a * scale + b per metric by least squares, the
    coefficients clamped at 0, and extrapolate to ``new_scale``
    (reference ``AutoCacheRule.scala:91-122``)."""

    def model(pairs: List[Tuple[int, float]]) -> float:
        X = np.array([[s, 1.0] for s, _ in pairs])
        y = np.array([v for _, v in pairs])
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        coef = np.maximum(coef, 0.0)
        return float(coef[0] * new_scale + coef[1])

    return Profile(
        ns=model([(sp.scale, sp.profile.ns) for sp in samples]),
        mem=model([(sp.scale, sp.profile.mem) for sp in samples]),
    )


def _result_mem(value: Any) -> float:
    # one memory-accounting definition with the streamed fit's budget
    return device_nbytes(value)


def _first_tensor(value: Any) -> Optional[torch.Tensor]:
    """A tensor the value holds, if any (its device is the value's)."""
    if isinstance(value, ArrayDataset):
        value = value.data
    elif isinstance(value, HostDataset):
        value = value.items[0] if value.items else None
    elif is_streaming(value) or value is None:
        return None
    return next((t for t in tree_leaves(value)
                 if isinstance(t, torch.Tensor)), None)


def _synchronize(value: Any) -> None:
    """Wait for the value's CUDA device, so that the clock read after
    reads the work and not its launch. A value holding no tensor (a
    fitted model) waits for the current CUDA device, if one is in use."""
    t = _first_tensor(value)
    if t is not None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
    elif torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_graph(graph: Graph, scales: Sequence[int],
                  num_trials: int = 1) -> Dict[NodeId, Profile]:
    """Run the part of the graph that does not depend on the runtime
    source on sampled datasets at each scale, timing each node and
    measuring its output, then extrapolate to the full size (reference
    ``profileInstructions``, ``AutoCacheRule.scala:132-361``). Each node
    runs ``num_trials`` times a scale, each trial anew from the sampled
    sources, its dependencies' values of that trial already made; every
    trial is one sample of the fit."""
    full_n = 0
    for n in graph.nodes:
        op = graph.get_operator(n)
        if isinstance(op, DatasetOperator):
            full_n = max(full_n, _dataset_len(op.dataset))

    samples_by_node: Dict[NodeId, List[SampleProfile]] = {}
    unexec = graph.source_descendants()
    order = [n for n in graph.linearize()
             if isinstance(n, NodeId) and n not in unexec]

    for scale in scales:
        items = int(scale)
        sampled = graph
        for n in graph.nodes:
            op = graph.get_operator(n)
            if isinstance(op, DatasetOperator):
                sampled = sampled.set_operator(
                    n, DatasetOperator(_sample_dataset(op.dataset, items)))
        for _ in range(num_trials):
            values: Dict[NodeId, Any] = {}
            for node in order:
                op = sampled.get_operator(node)
                deps = [values[d] for d in sampled.get_dependencies(node)]
                t0 = time.monotonic()
                with tracing_disabled():
                    # sampled runs share node ids with the real graph:
                    # keep them out of the per-node records and executor
                    # metrics
                    expr = op.execute(deps)
                    value = expr.get()
                _synchronize(value)
                elapsed = (time.monotonic() - t0) * 1e9
                values[node] = expr
                samples_by_node.setdefault(node, []).append(
                    SampleProfile(items, Profile(elapsed,
                                                 _result_mem(value))))
            del values

    return {
        node: generalize_profiles(full_n, sps)
        for node, sps in samples_by_node.items()
    }


def estimate_cached_run_time(
    graph: Graph,
    children: Dict[NodeId, List[NodeId]],
    cached: frozenset,
    profiles: Dict[NodeId, Profile],
) -> float:
    """Total time estimate given a cache set
    (reference ``AutoCacheRule.scala:367-381``)."""
    weights = {n: node_weight(graph.get_operator(n)) for n in graph.nodes}
    runs = get_runs(graph, children, cached, weights)
    total = 0.0
    for n in graph.nodes:
        executions = 1 if n in cached else runs[n]
        total += profiles.get(n, Profile()).ns * executions
    return total


def make_cached_graph(graph: Graph, to_cache: frozenset) -> Graph:
    """Insert a Cacher after each selected node and point its consumers
    at it (reference ``makeCachedPipeline``, ``AutoCacheRule.scala:386-412``)."""
    for node in sorted(to_cache, key=lambda n: n.id):
        if node not in graph.nodes or not _data_outputting(graph, node):
            continue
        consumers = [
            c for c in graph.nodes
            if node in graph.get_dependencies(c)
        ]
        sink_consumers = [
            s for s in graph.sinks if graph.get_sink_dependency(s) == node
        ]
        graph, cacher_id = graph.add_node(Cacher(), (node,))
        for c in consumers:
            deps = tuple(
                cacher_id if d == node else d
                for d in graph.get_dependencies(c)
            )
            graph = graph.set_dependencies(c, deps)
        for s in sink_consumers:
            graph = graph.set_sink_dependency(s, cacher_id)
    return graph


def greedy_select(initial: Iterable[Any],
                  candidates_fn: Callable[[FrozenSet, float], List[Any]],
                  mem_of: Callable[[Any], float],
                  objective: Callable[[FrozenSet], float],
                  budget: float) -> FrozenSet:
    """The profile-under-budget greedy loop (reference
    ``AutoCacheRule.scala:526-549``). Starting from ``initial``,
    repeatedly add the candidate whose addition MINIMIZES
    ``objective(selected | {c})`` while the summed ``mem_of`` stays under
    ``budget``. ``candidates_fn(selected, space_left)`` returns the
    admissible additions for this step (it is called again every step).
    Returns the selected frozenset. It serves ``AutoCacheRule`` and the
    serving plane's eviction plan."""
    selected = set(initial)

    def used() -> float:
        return sum(mem_of(n) for n in selected)

    while used() < budget:
        cands = candidates_fn(frozenset(selected), budget - used())
        if not cands:
            break
        best = min(cands,
                   key=lambda c: objective(frozenset(selected | {c})))
        selected.add(best)
    return frozenset(selected)


def _graph_device(graph: Graph) -> torch.device:
    """The device the graph's constant datasets lie on: the first CUDA
    device among them, else the CPU."""
    for n in sorted(graph.nodes, key=lambda g: g.id):
        op = graph.get_operator(n)
        if isinstance(op, DatasetOperator):
            dev = getattr(op.dataset, "device", None)
            if dev is None:
                t = _first_tensor(op.dataset)
                dev = None if t is None else t.device
            if dev is not None and torch.device(dev).type == "cuda":
                return torch.device(dev)
    return torch.device("cpu")


def _device_mem_budget(device=None) -> float:
    """75% of the device's free memory (reference
    ``AutoCacheRule.scala:480``). On a CUDA device the free bytes are
    read from that device (``torch.cuda.mem_get_info``) when the budget
    is asked for. On the CPU there is no device memory to read, and the
    answer is the JAX package's for a platform with no memory stats:
    75% of 8 GiB."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return 0.75 * free
    return 0.75 * _FALLBACK_DEVICE_BYTES


class AutoCacheRule(Rule):
    """``strategy`` is "aggressive" or "greedy"
    (reference ``AutoCacheRule.scala:515-523,526-549``); the greedy
    strategy profiles ``num_trials`` runs at each of ``scales``."""

    AGGRESSIVE = "aggressive"
    GREEDY = "greedy"

    def __init__(
        self,
        strategy: str = GREEDY,
        max_mem: Optional[float] = None,
        scales: Sequence[int] = (2, 4),
        num_trials: int = 1,
    ):
        assert strategy in (self.AGGRESSIVE, self.GREEDY)
        self.strategy = strategy
        self.max_mem = max_mem
        self.scales = tuple(scales)
        self.num_trials = num_trials

    def _aggressive(self, graph: Graph) -> Graph:
        children = _children_with_multiplicity(graph)
        weights = {n: node_weight(graph.get_operator(n)) for n in graph.nodes}
        downstream_of_source = graph.source_descendants()
        to_cache = frozenset(
            n for n in graph.nodes
            if sum(weights[c] for c in children[n]
                   if c not in downstream_of_source) > 1
        )
        trace = current_trace()
        if trace is not None:
            trace.record_auto_cache({
                "strategy": self.AGGRESSIVE,
                "selected": sorted(n.id for n in to_cache),
                "selected_operators": {
                    n.id: graph.get_operator(n).label() for n in to_cache}})
        return make_cached_graph(graph, to_cache)

    def _greedy(self, graph: Graph) -> Graph:
        profiles = profile_graph(graph, self.scales, self.num_trials)
        children = _children_with_multiplicity(graph)
        weights = {n: node_weight(graph.get_operator(n)) for n in graph.nodes}
        # a node downstream of the runtime source runs once per input and
        # is never reused across inputs
        downstream_of_source = graph.source_descendants()
        budget = (self.max_mem if self.max_mem is not None
                  else _device_mem_budget(_graph_device(graph)))

        def candidates(selected: frozenset, space_left: float):
            # run counts shift as the cache set grows, so they are
            # recomputed every selection step
            runs = get_runs(graph, children, selected, weights)
            return [
                n for n in graph.nodes
                if n not in selected and runs[n] > 1
                and n not in downstream_of_source
                and profiles.get(n, Profile()).mem < space_left
                and _data_outputting(graph, n)
            ]

        initial = init_cache_set(graph)
        cached = greedy_select(
            initial, candidates,
            lambda n: profiles.get(n, Profile()).mem,
            lambda sel: estimate_cached_run_time(
                graph, children, sel, profiles),
            budget)
        to_cache = frozenset(cached - initial)
        trace = current_trace()
        if trace is not None:
            # what was measured, what was chosen and under what budget,
            # so "was the cache choice right?" is answerable offline
            trace.record_auto_cache({
                "strategy": self.GREEDY,
                "budget_bytes": float(budget),
                "mem_used_bytes": float(sum(
                    profiles.get(n, Profile()).mem for n in cached)),
                "profiles": {n.id: {"ns": p.ns, "mem": p.mem}
                             for n, p in sorted(profiles.items(),
                                                key=lambda kv: kv[0].id)},
                "profile_scales": list(self.scales),
                "initially_cached": sorted(n.id for n in initial),
                "selected": sorted(n.id for n in to_cache),
                "selected_operators": {
                    n.id: graph.get_operator(n).label() for n in to_cache},
                "estimated_uncached_s": estimate_cached_run_time(
                    graph, children, initial, profiles) / 1e9,
                "estimated_cached_s": estimate_cached_run_time(
                    graph, children, frozenset(cached), profiles) / 1e9})
        return make_cached_graph(graph, to_cache)

    def apply(self, graph: Graph) -> Graph:
        if self.strategy == self.AGGRESSIVE:
            return self._aggressive(graph)
        return self._greedy(graph)
