"""Cost-model-driven least-squares solver choice.

Counterpart of ``keystone_tpu/nodes/learning/least_squares.py``
(reference ``nodes/learning/LeastSquaresEstimator.scala``): the flagship
node-level optimization. ``LeastSquaresEstimator`` chooses among
DenseLBFGS, Sparsify -> SparseLBFGS, Densify -> BlockLeastSquares(1000,
3) and Densify -> the exact normal equations by evaluating each solver's
cost model at the workload shape (n, d, k, sparsity, machines). The node
rule (``workflow/optimizer/node_rule.py``) measures the shape on a
sampled execution; a streamed fit chooses at ``finalize`` from the exact
accumulated shape, among the solvers that can finish from the Gram
carry.

Weights: the port's defaults are the reference's EC2 calibration
(``REFERENCE_EC2_WEIGHTS``, LeastSquaresEstimator.scala:17,26-31) with
no dispatch-latency term. The JAX package's shipped defaults were
measured on another device and are not carried over; until a
calibration on the card exists, the choice surface is the reference's.
A calibration artifact (JSON with the four weights) is read from
``KEYSTONE_TORCH_COST_CALIBRATION`` or from
``build/keystone_tpu_torch/cost_model_calibration.json`` in the
checkout, never from the JAX package's path.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ...observability.trace import current_trace
from ...parallel.dataset import ArrayDataset, Dataset, tree_leaves
from ...parallel.streaming import is_streamable
from ...workflow.optimizable import NodeChoice, OptimizableLabelEstimator
from ..util import Densify
from ..util.sparse import SparseVector, Sparsify
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from .linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
    accumulate_gram_carry,
)

#: The reference's EC2 calibration on 16 x r3.4xlarge
#: (LeastSquaresEstimator.scala:17,26-31): seconds per flop, per element
#: scanned and per element sent, and no dispatch-latency term.
REFERENCE_EC2_WEIGHTS = {
    "cpu_weight": 3.8e-4,
    "mem_weight": 2.9e-1,
    "network_weight": 1.32,
    "lat_weight": 0.0,
}

CALIBRATION_ENV = "KEYSTONE_TORCH_COST_CALIBRATION"
DEFAULT_CALIBRATION_PATH = str(
    Path(__file__).resolve().parents[3] / "build" / "keystone_tpu_torch"
    / "cost_model_calibration.json")

_WEIGHT_KEYS = ("cpu_weight", "mem_weight", "network_weight", "lat_weight")

#: resolved path -> (weights, provenance)
_CALIBRATION_CACHE: Dict[str, Tuple[Dict[str, float], Dict]] = {}


def load_calibration(
        path: Optional[str] = None) -> Tuple[Dict[str, float], Dict]:
    """The cost-model weights and their provenance.

    Weights come from the calibration artifact when one is present and
    valid (all four weights finite, the three compute weights positive,
    the latency weight non-negative, and a recorded model-vs-measurement
    agreement, if any, above half), else the shipped
    ``REFERENCE_EC2_WEIGHTS``. ``provenance`` carries ``source``
    (``"artifact"`` / ``"shipped_defaults"``) and the artifact's
    timestamp, hostname and device."""
    candidate = (path or os.environ.get(CALIBRATION_ENV)
                 or DEFAULT_CALIBRATION_PATH)
    cached = _CALIBRATION_CACHE.get(candidate)
    if cached is not None:
        return cached
    weights = dict(REFERENCE_EC2_WEIGHTS)
    provenance: Dict = {
        "source": "shipped_defaults",
        "note": ("the reference's EC2 calibration; no calibration on the "
                 "card exists yet"),
    }
    try:
        with open(candidate) as f:
            blob = json.load(f)
        parsed = {k: float(blob[k]) for k in _WEIGHT_KEYS}
        ok = all(np.isfinite(v) for v in parsed.values()) and all(
            parsed[k] > 0 for k in ("cpu_weight", "mem_weight",
                                    "network_weight")
        ) and parsed["lat_weight"] >= 0
        # weights whose recorded model-vs-measurement agreement was at
        # most half are not trusted
        agreement = str(blob.get("agreement", ""))
        if ok and "/" in agreement:
            try:
                hits, total = (int(p) for p in agreement.split("/", 1))
                ok = 2 * hits > total
            except ValueError:
                pass
        if ok:
            weights = parsed
            provenance = {
                "source": "artifact",
                "path": candidate,
                "timestamp": blob.get("timestamp"),
                "hostname": blob.get("hostname"),
                "device": blob.get("device"),
            }
        else:
            provenance["note"] = (
                f"calibration artifact {candidate} has out-of-range "
                "weights; using shipped defaults")
    except FileNotFoundError:
        pass
    except (OSError, ValueError, KeyError, TypeError) as exc:
        provenance["note"] = (
            f"calibration artifact {candidate} unreadable ({exc}); "
            "using shipped defaults")
    _CALIBRATION_CACHE[candidate] = (weights, provenance)
    return weights, provenance


def clear_calibration_cache() -> None:
    """Drop memoized calibration lookups (tests, recalibration)."""
    _CALIBRATION_CACHE.clear()


def estimate_sparsity(sample: Dataset) -> float:
    """Mean fraction of active entries per item
    (reference ``LeastSquaresEstimator.scala:68``)."""
    if isinstance(sample, ArrayDataset):
        arr = tree_leaves(sample.data)[0][:sample.n]
        return float(int(torch.count_nonzero(arr)) / max(arr.numel(), 1))
    fracs = []
    for it in sample.collect():
        if isinstance(it, SparseVector):
            fracs.append(it.nnz / max(it.size, 1))
        elif isinstance(it, torch.Tensor):
            fracs.append(int(torch.count_nonzero(it)) / max(it.numel(), 1))
        else:
            arr = np.asarray(it)
            fracs.append(np.count_nonzero(arr) / max(arr.size, 1))
    return float(np.mean(fracs)) if fracs else 1.0


def _item_dim(sample: Dataset) -> int:
    if isinstance(sample, ArrayDataset):
        return int(tree_leaves(sample.data)[0].shape[-1])
    first = sample.collect()[0]
    return first.size if isinstance(first, SparseVector) else int(
        first.shape[-1])


class LeastSquaresEstimator(OptimizableLabelEstimator):
    """Auto-selecting least-squares solver
    (reference ``LeastSquaresEstimator.scala:27-86``). Weights not given
    come from ``load_calibration``; ``num_machines`` defaults to the
    rule's count (1: one GPU)."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import labels_width_fit

        return labels_width_fit(dep_specs)

    # -- static HBM planning (analysis.resources) --------------------------
    def carry_nbytes(self, dep_specs):
        # every Gram-capable candidate finishes from the one shared
        # Gram/cross carry, so the carry is solver-independent
        from ...analysis.resources import gram_carry_nbytes

        return gram_carry_nbytes(dep_specs)

    def fitted_nbytes(self, dep_specs):
        from ...analysis.resources import linear_model_nbytes

        return linear_model_nbytes(dep_specs)

    def __init__(self, lam: float = 0.0, num_machines: Optional[int] = None,
                 cpu_weight: Optional[float] = None,
                 mem_weight: Optional[float] = None,
                 network_weight: Optional[float] = None,
                 num_iterations: int = 20,
                 lat_weight: Optional[float] = None):
        calibrated, provenance = load_calibration()
        explicit = {
            "cpu_weight": cpu_weight,
            "mem_weight": mem_weight,
            "network_weight": network_weight,
            "lat_weight": lat_weight,
        }
        if any(v is not None for v in explicit.values()):
            provenance = {"source": "explicit", "overrides": sorted(
                k for k, v in explicit.items() if v is not None)}
        self.lam = lam
        self.num_machines = num_machines
        for key, value in explicit.items():
            setattr(self, key, calibrated[key] if value is None else value)
        self.num_iterations = num_iterations
        self._weight_provenance = provenance  # underscore: not in eq_key

    @property
    def options(self) -> Sequence[Tuple[object, NodeChoice]]:
        """(cost-model solver, choice) pairs
        (reference ``LeastSquaresEstimator.scala:36-53``)."""
        dense = DenseLBFGSwithL2(
            lam=self.lam, num_iterations=self.num_iterations)
        sparse = SparseLBFGSwithL2(
            lam=self.lam, num_iterations=self.num_iterations)
        block = BlockLeastSquaresEstimator(1000, 3, lam=self.lam)
        exact = LinearMapEstimator(lam=self.lam)
        return [
            (dense, NodeChoice(dense, (Densify(),))),
            (sparse, NodeChoice(sparse, (Sparsify(),))),
            (block, NodeChoice(block, (Densify(),))),
            (exact, NodeChoice(exact, (Densify(),))),
        ]

    @property
    def default(self):
        return DenseLBFGSwithL2(
            lam=self.lam, num_iterations=self.num_iterations)

    @property
    def weight(self) -> int:
        """The default solver's passes (auto-caching's run counts)."""
        return self.default.weight

    def _fit(self, ds: Dataset, labels: Dataset):
        # when the node-level rule has not sampled: densify host data for
        # the dense default
        if not isinstance(ds, ArrayDataset):
            ds = Densify().apply_dataset(ds)
        if not isinstance(labels, ArrayDataset):
            labels = Densify().apply_dataset(labels)
        return self.default._fit(ds, labels)

    # -- streaming fit (accumulate/finalize protocol) ----------------------
    def accumulate(self, carry, chunk, labels):
        """A streamed fit accumulates the linear family's Gram / cross
        carry; every Gram-capable candidate can finish from it, so the
        choice waits for :meth:`finalize`, where n, d and k are known
        exactly."""
        return accumulate_gram_carry(carry, chunk, labels)

    def finalize(self, carry):
        """The cost-model choice among the solvers that can finish from
        the one-pass carry, at the accumulated shape (density 1.0), then
        that solver's finalize."""
        G, C, _, _, n = carry
        d, k = int(G.shape[0]), int(C.shape[1])
        choice = self._choose(n, d, k, 1.0, self.num_machines or 1,
                              streaming=True, shape_source="streamed")
        return choice.node.finalize(carry)

    def optimize(self, sample: Dataset, sample_labels: Dataset, n: int,
                 num_machines: int) -> NodeChoice:
        d = _item_dim(sample)
        k = _item_dim(sample_labels)
        sparsity = estimate_sparsity(sample)
        return self._choose(n, d, k, sparsity,
                            self.num_machines or num_machines,
                            shape_source="sampled")

    def optimize_static(self, spec, n: int, num_machines: int,
                        labels_spec=None) -> Optional[NodeChoice]:
        """The cost-model choice from statically inferred (n, d, k,
        sparsity): no sampled execution, no device time. ``sparsity`` is
        the analyzer's STRUCTURAL density (1.0 for dense-stored
        elements), not the value-level density ``estimate_sparsity``
        measures, so dense-stored data ranks as dense. A stream's choice
        is restricted to the solvers that finish from the one-pass carry.
        None (the sampled fallback) when a cost input is unresolved, such
        as sparse host elements of unknown density."""
        from ...analysis.spec import element_feature_dim

        d = element_feature_dim(spec)
        k = element_feature_dim(labels_spec) if labels_spec is not None \
            else None
        sparsity = getattr(spec, "sparsity", None)
        if d is None or k is None or sparsity is None:
            return None
        return self._choose(n, d, k, sparsity,
                            self.num_machines or num_machines,
                            streaming=getattr(spec, "streaming", False),
                            shape_source="static")

    def costs(self, n: int, d: int, k: int, sparsity: float, machines: int,
              streaming: bool = False):
        """[(cost, solver, choice)] for every candidate, in the order of
        ``options``; ``streaming=True`` keeps only the solvers that can
        fit from the one-pass Gram carry (the L-BFGS candidates need
        repeated passes over the data, and Sparsify is a host stage)."""
        options = self.options
        if streaming:
            options = [(solver, choice) for solver, choice in options
                       if is_streamable(choice.node)]
        return [(solver.cost(n, d, k, sparsity, machines, self.cpu_weight,
                             self.mem_weight, self.network_weight,
                             lat_w=self.lat_weight), solver, choice)
                for solver, choice in options]

    def _choose(self, n: int, d: int, k: int, sparsity: float,
                machines: int, streaming: bool = False,
                shape_source: Optional[str] = None) -> NodeChoice:
        """The cheapest candidate; the decision goes on the active trace
        with where its shape came from (``shape_source``: ``static``,
        ``sampled`` or ``streamed``; by default ``streamed`` for a
        streaming choice, else ``sampled``)."""
        costs = self.costs(n, d, k, sparsity, machines, streaming)
        _, best = min((cost, i) for i, (cost, _, _) in enumerate(costs))
        choice = costs[best][2]
        trace = current_trace()
        if trace is not None:
            # the whole decision: the workload shape, every candidate's
            # cost, the pick and where the weights came from
            trace.record_solver_decision({
                "estimator": type(self).__name__,
                "n": n, "d": d, "k": k, "sparsity": sparsity,
                "num_machines": machines,
                "costs": {type(solver).__name__: cost
                          for cost, solver, _ in costs},
                "chosen": type(choice.node).__name__,
                "weights": {"cpu_weight": self.cpu_weight,
                            "mem_weight": self.mem_weight,
                            "network_weight": self.network_weight,
                            "lat_weight": self.lat_weight},
                "provenance": dict(self._weight_provenance),
                "shape_source": shape_source or (
                    "streamed" if streaming else "sampled"),
                "streaming_restricted": streaming,
            })
        return choice
