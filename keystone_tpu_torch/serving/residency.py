"""Device-memory admission control for the serving plane.

Counterpart of ``keystone_tpu/serving/residency.py``. Models are
admitted under an explicit device-memory budget: a fitted pipeline is
admitted only when its charge, persistent fitted state plus the
per-item activation times the largest bucket, fits beside the models
already warm.

* :func:`model_charge` — one model's :class:`ModelCharge`. The JAX
  package sizes it from its static planner (``analysis/resources.py``).
  The port's planner (``keystone_tpu_torch/analysis/resources.py``)
  sizes the static part for ``check --replicas``, but cannot see a CUDA
  graph's pool; so admission takes the model bytes from its own
  :func:`fitted_model_nbytes` and the per-item activation from a
  one-item probe apply, and records ``source="probed"``. On a CUDA device the plane serves each bucket
  from a captured CUDA graph, and the charge also covers the graphs:
  each graph owns a private memory pool and a static input. A probe
  capture of each bucket the plane will capture measures that bucket's
  pool (:func:`graph_pool_nbytes`) and drops it; the charge takes every
  probed pool, plus every static input.
* :class:`ResidencyLedger` — the charged-bytes ledger: admission charges
  the newcomer after re-checking the budget under the ledger lock, or
  raises :class:`AdmissionError` without changing anything.

Which models to keep when space runs out is decided by the plane
(``serving/plane.py``); this module only accounts and enforces.
"""
from __future__ import annotations

import threading
import types
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..observability.compilelog import capture_lock
from ..observability.metrics import MetricsRegistry
from ..parallel.dataset import ArrayDataset, bucketed_dataset, device_nbytes
from ..utils.guarded import guarded_by

#: per-instance caches of device copies, not fitted state
_CACHE_ATTRS = frozenset({"_params_cache", "_eq_key_val"})


class AdmissionError(MemoryError):
    """A model admission would exceed the serving budget, even after
    every allowed eviction. The message names the charge, the budget and
    what is resident."""


@dataclass(frozen=True)
class ModelCharge:
    """One served model's admission charge: ``model_nbytes`` of fitted
    state, ``item_nbytes`` of activation per request row, charged at the
    largest bucket (``bucket_rows``) so a full bucket never breaks the
    budget at run time. ``source`` says how it was sized."""

    model_nbytes: float
    item_nbytes: float
    bucket_rows: int
    source: str = "probed"
    #: the captured graphs' pools and static inputs (0 on the CPU)
    graph_nbytes: float = 0.0
    #: the pools alone, as the probe captures measured them
    pool_nbytes: float = 0.0
    #: >1: the charge is ONE rank's under the sharded apply
    #: (``parallel/spmd_apply.py``): the shardable fitted bytes divide
    #: over the data axis, one gather transient is charged, and the
    #: activation is this rank's row shard of the bucket
    data_shards: int = 1
    shardable_nbytes: float = 0.0
    gather_nbytes: float = 0.0

    def activation_nbytes(self) -> float:
        shards = max(int(self.data_shards), 1)
        rows = -(-int(self.bucket_rows) // shards)
        return float(self.item_nbytes) * float(rows)

    def total_nbytes(self) -> float:
        shards = max(int(self.data_shards), 1)
        shardable = min(float(self.shardable_nbytes),
                        float(self.model_nbytes))
        resident = float(self.model_nbytes) - shardable + shardable / shards
        gather = float(self.gather_nbytes) if shards > 1 else 0.0
        return (resident + gather + self.activation_nbytes()
                + float(self.graph_nbytes))


def fitted_model_nbytes(graph: Any) -> float:
    """Bytes of the fitted parameters a transformer-only pipeline keeps
    while it is served: every array or tensor of at least one dimension
    held by the graph's operators (weights, intercepts, scaler moments,
    filters), nested objects included, the cached device copies
    (``_params_cache``) excluded. Counted at the stored width: a mapper
    quantized on the apply path stores float32, and its narrow copy
    lives beside the float32 one while it serves, so this is an upper
    bound on the model alone."""
    seen: set = set()

    def walk(value: Any) -> float:
        if isinstance(value, torch.Tensor):
            return float(value.element_size() * value.numel()) \
                if value.dim() > 0 else 0.0
        if isinstance(value, np.ndarray):
            return float(value.nbytes) if value.ndim > 0 else 0.0
        if isinstance(value, (list, tuple)):
            return sum(walk(v) for v in value)
        if isinstance(value, dict):
            return sum(walk(v) for v in value.values())
        if (hasattr(value, "__dict__") and id(value) not in seen
                and not isinstance(value, (types.FunctionType,
                                           types.MethodType,
                                           types.ModuleType, type))):
            seen.add(id(value))
            return sum(walk(v) for k, v in vars(value).items()
                       if k not in _CACHE_ATTRS)
        return 0.0

    return sum(walk(graph.get_operator(n)) for n in graph.nodes)


def _probe_item_nbytes(fitted: Any, zero_item: Any, device) -> float:
    """Apply ONE zero item on ``device`` and read the device bytes of
    input plus output per row: a measurement, at the cost of one small
    apply before the admission decision."""
    ds = ArrayDataset.from_numpy(zero_item, device)
    out = fitted.apply(ds).get()
    rows = max(getattr(out, "padded_n", 1), 1)
    return (device_nbytes(ds) / max(ds.padded_n, 1)
            + device_nbytes(out) / rows)


def graph_pool_nbytes(pool: Any, device) -> float:
    """Bytes the caching allocator holds for one CUDA graph memory pool
    (``graph.pool()``): the segments of that pool on ``device``."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    total = 0.0
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            raise RuntimeError(
                "torch.cuda.memory_snapshot() gives no segment_pool_id: "
                "this PyTorch cannot attribute memory to a graph pool")
        if (seg.get("device") == index
                and tuple(seg["segment_pool_id"]) == tuple(pool)):
            total += float(seg["total_size"])
    return total


def _probe_pool_nbytes(fitted: Any, zero_item: Any, bucket_rows: int,
                       device: torch.device) -> float:
    """Capture the apply of a zero bucket of ``bucket_rows`` rows into a
    private pool, as the plane captures it, read the pool's bytes, then
    drop the graph and give its pool back. The eager apply before it
    does the lazy set-up (launch plans, quantized weights) outside the
    graph, as the plane's warmup does. The capture is a measurement,
    not a served graph: the observatory does not record it."""
    from .graphs import capture_apply, warm_apply

    zeros = pytree.tree_map(lambda x: np.repeat(x, bucket_rows, axis=0),
                            zero_item)
    ds = bucketed_dataset(zeros, bucket_rows, bucket_rows, device)
    with capture_lock():
        warm_apply(fitted, ds.data, bucket_rows, device)
        graph, out, _ = capture_apply(
            fitted, ds.data, bucket_rows, device,
            f"the sizing probe ({bucket_rows} rows)")
    nbytes = graph_pool_nbytes(graph.pool(), device)
    del out, graph, ds
    with capture_lock():
        torch.cuda.empty_cache()
    return nbytes


def model_charge(fitted: Any, zero_item: Any, bucket_rows: int,
                 device, graph_rows: Sequence[int] = (),
                 data_shards: int = 1) -> ModelCharge:
    """The admission charge of ``fitted`` (a fitted pipeline) serving
    items like ``zero_item`` (host arrays of one row, leading dim 1) at a
    largest bucket of ``bucket_rows`` rows on ``device``. Model bytes from
    :func:`fitted_model_nbytes`, the per-item activation from a one-item
    probe apply (the static planner the JAX package sizes it with is not
    ported yet), hence ``source="probed"``. ``graph_rows`` lists the
    bucket rows of every graph the plane will capture (CUDA only): each
    is charged its own probed pool and its own static input.
    ``data_shards > 1`` sizes ONE rank's charge under the sharded apply:
    the mappers' weights row-shard at rest (their
    ``sharded_apply_nbytes`` hooks), one gather transient is charged, and
    the activation is the rank's row shard of the bucket."""
    from ..analysis.resources import sharded_apply_nbytes

    dev = torch.device(device)
    graph = fitted.to_pipeline().graph
    item = _probe_item_nbytes(fitted, zero_item, dev)
    pools = 0.0
    static = 0.0
    if graph_rows and dev.type == "cuda":
        in_row = sum(float(np.asarray(leaf).nbytes)
                     for leaf in pytree.tree_leaves(zero_item))
        for rows in graph_rows:
            pools += _probe_pool_nbytes(fitted, zero_item, int(rows), dev)
            static += in_row * int(rows)
    shards = max(int(data_shards), 1)
    shardable, gather = (sharded_apply_nbytes(graph) if shards > 1
                         else (0.0, 0.0))
    return ModelCharge(model_nbytes=fitted_model_nbytes(graph),
                       item_nbytes=item, bucket_rows=int(bucket_rows),
                       source="probed", graph_nbytes=pools + static,
                       pool_nbytes=pools, data_shards=shards,
                       shardable_nbytes=shardable, gather_nbytes=gather)


@guarded_by("_lock", "_charges")
class ResidencyLedger:
    """Charged-bytes accounting for warm served models. :meth:`admit`
    re-checks the budget and charges in one lock hold, raising
    :class:`AdmissionError` without changing anything when the charge
    would not fit. The plan-evict-charge sequence is serialized by the
    owning plane's lock; this ledger is the accounting backstop."""

    def __init__(self, budget: Optional[float]):
        self.budget = None if budget is None else float(budget)
        self._charges: Dict[str, float] = {}
        self._lock = threading.Lock()

    def used(self) -> float:
        with self._lock:
            return sum(self._charges.values())

    def charge_of(self, name: str) -> float:
        with self._lock:
            return self._charges.get(name, 0.0)

    def resident(self) -> Dict[str, float]:
        """A copy of every model's charge, taken under the lock."""
        with self._lock:
            return dict(self._charges)

    def admit(self, name: str, nbytes: float) -> None:
        """Charge ``nbytes`` for ``name`` after re-checking the budget
        under the ledger lock; raises :class:`AdmissionError`, changing
        nothing, when it would be exceeded."""
        nbytes = float(nbytes)
        with self._lock:
            used = sum(self._charges.values())
            if self.budget is not None and used + nbytes > self.budget:
                mib = 1 << 20
                raise AdmissionError(
                    f"admitting {name!r} ({nbytes / mib:.2f} MiB) would "
                    f"put serving residency at {(used + nbytes) / mib:.2f}"
                    f" MiB > budget {self.budget / mib:.2f} MiB "
                    f"(resident: {sorted(self._charges) or 'none'})")
            self._charges = {**self._charges, name: nbytes}
        self._publish()

    def release(self, name: str) -> float:
        with self._lock:
            freed = self._charges.pop(name, 0.0)
        self._publish()
        return freed

    def _publish(self) -> None:
        # outside the ledger lock: the scrape only needs fresh totals
        reg = MetricsRegistry.get_or_create()
        reg.gauge("serving.hbm_charged_bytes").set(self.used())
        if self.budget is not None:
            reg.gauge("serving.hbm_budget_bytes").set(self.budget)
