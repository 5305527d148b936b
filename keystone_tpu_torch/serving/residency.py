"""Device-memory admission control for the serving plane.

Counterpart of ``keystone_tpu/serving/residency.py``. Models are
admitted under an explicit device-memory budget: a fitted pipeline is
admitted only when its charge, persistent fitted state plus the
per-item activation times the largest bucket, fits beside the models
already warm.

* :func:`model_charge` — one model's :class:`ModelCharge`, step for step
  the JAX package's: the pipeline is ``check``-ed on the one-item spec
  with unknown ``n`` (the apply-path view), :func:`fitted_model_nbytes`
  sizes the resident parameters and
  ``analysis/resources.py::serving_residency_nbytes`` the charge, with
  the plan's ``apply_item_nbytes`` as the activation:
  ``source="static-plan"``, and no device work. Only a plan that
  cannot size the activation falls back to a one-item probe apply
  (``source="probed"``). That much is planned. The CUDA graphs are the
  port's own and are measured, never planned (the plan models no
  intermediate inside a node, ROADMAP C19): on a CUDA device the plane
  serves each bucket from a captured graph, which owns a private memory
  pool and a static input, and the charge takes each graph's pool as
  the plane's own admission capture measured it
  (:func:`graph_pool_nbytes`), plus each static input. Those captures
  are the graphs the plane then serves: admission captures nothing only
  to measure it.
* :func:`measure_graph_pools` — the pools of a model's bucket graphs for
  a caller with no plane (the fleet controller's charge): captured as a
  plane captures them, measured, then dropped, their pools released
  behind the serving gate (``serving/graphs.py``).
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
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..observability.compilelog import capture_lock
from ..observability.metrics import MetricsRegistry
from ..ops.device import DEFAULT_DEVICE
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
    budget at run time. ``source`` says how the activation was sized:
    ``static-plan`` or ``probed``."""

    model_nbytes: float
    item_nbytes: float
    bucket_rows: int
    source: str = "static-plan"
    #: >1: the charge is ONE rank's under the sharded apply
    #: (``parallel/spmd_apply.py``): the shardable fitted bytes divide
    #: over the data axis, one gather transient is charged, and the
    #: activation is this rank's row shard of the bucket
    data_shards: int = 1
    shardable_nbytes: float = 0.0
    gather_nbytes: float = 0.0
    #: the captured graphs' pools and static inputs (0 on the CPU)
    graph_nbytes: float = 0.0
    #: the pools alone, as their captures measured them
    pool_nbytes: float = 0.0

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
    input plus output per row: the fallback for a plan that cannot size
    the activation (its ``unresolved`` contract), at the cost of one
    small apply before the admission decision."""
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


def _item_spec(zero_item: Any) -> Any:
    """The ``check`` spec of ONE item from host arrays of one row
    (leading dim 1): a :class:`~..analysis.spec.ShapeDtype` per leaf."""
    from ..analysis.spec import ShapeDtype

    return pytree.tree_map(
        lambda leaf: ShapeDtype(np.shape(leaf)[1:], np.asarray(leaf).dtype),
        zero_item)


def measure_graph_pools(fitted: Any, zero_item: Any,
                        graph_rows: Sequence[int], device
                        ) -> Dict[int, float]:
    """``rows -> pool bytes`` of the graph a CUDA plane captures for each
    bucket in ``graph_rows``, measured from captures made the plane's way
    (one eager apply on the capture stream, then the capture of a zero
    bucket), for a caller that holds no plane: the fleet controller
    sizes a model's charge before any replica admits it. The graphs are
    dropped at once and their pools given back behind the serving gate,
    never while a serving batch is in flight; the call returns once
    they are. Nothing on the CPU."""
    from .graphs import (capture_apply, release_gate, release_to_device,
                         warm_apply)

    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    out: Dict[int, float] = {}
    graphs = []
    for rows in graph_rows:
        zeros = pytree.tree_map(lambda x: np.repeat(x, rows, axis=0),
                                zero_item)
        ds = bucketed_dataset(zeros, rows, rows, dev)
        with capture_lock():
            warm_apply(fitted, ds.data, rows, dev)
            graph, _, _ = capture_apply(
                fitted, ds.data, rows, dev,
                f"the pool measurement ({rows} rows)")
        out[int(rows)] = graph_pool_nbytes(graph.pool(), dev)
        graphs.append(graph)
    release_gate().release(lambda: release_to_device(graphs), wait=True)
    return out


def model_charge(fitted: Any, sample_struct: Any, bucket_rows: int,
                 name: str = "model", data_shards: int = 1, *,
                 device=DEFAULT_DEVICE,
                 graph_pools: Optional[Mapping[int, float]] = None
                 ) -> ModelCharge:
    """The admission charge of ``fitted`` (a fitted pipeline) serving
    items like ``sample_struct`` (host arrays of ONE item each, leading
    dim 1, where the JAX package takes a ``ShapeDtypeStruct`` tree) at a
    largest bucket of ``bucket_rows`` rows on ``device``.

    Device-free when the static plan resolves, as the JAX package's: the
    pipeline is ``check``-ed on the item spec with unknown ``n``,
    ``fitted_model_nbytes`` sizes the resident parameters and the plan's
    ``apply_item_nbytes`` the activation (``source="static-plan"``). A
    plan that cannot size the activation falls back to the one-item
    probe apply (``source="probed"``). ``graph_pools`` maps the bucket
    rows of every graph the plane captured (CUDA only) to the pool bytes
    that capture measured: each is charged its pool and its static
    input. ``data_shards > 1`` sizes ONE rank's charge under the sharded
    apply: the mappers' weights row-shard at rest (their
    ``sharded_apply_nbytes`` hooks), one gather transient is charged,
    and the activation is the rank's row shard of the bucket."""
    from ..analysis.resources import (serving_residency_nbytes,
                                      sharded_apply_nbytes)

    graph = fitted.to_pipeline().graph
    report = fitted.check(_item_spec(sample_struct), name=f"serve:{name}")
    model_b = float(fitted_model_nbytes(graph))
    shards = max(int(data_shards), 1)
    shardable = gather = 0.0
    if shards > 1:
        shardable, gather = sharded_apply_nbytes(graph)
    pools = {int(r): float(b) for r, b in (graph_pools or {}).items()}
    in_row = sum(float(np.asarray(leaf).nbytes)
                 for leaf in pytree.tree_leaves(sample_struct))
    pool_b = float(sum(pools.values()))
    graph_b = pool_b + in_row * sum(pools)
    total = serving_residency_nbytes(
        model_b, report.plan, bucket_rows, graph_nbytes=graph_b,
        data_shards=shards, shardable_nbytes=shardable,
        gather_nbytes=gather)
    if total is not None:
        item, source = float(report.plan.apply_item_nbytes), "static-plan"
    else:
        item = _probe_item_nbytes(fitted, sample_struct, torch.device(device))
        source = "probed"
    return ModelCharge(model_nbytes=model_b, item_nbytes=item,
                       bucket_rows=int(bucket_rows), source=source,
                       graph_nbytes=graph_b, pool_nbytes=pool_b,
                       data_shards=shards, shardable_nbytes=shardable,
                       gather_nbytes=gather)


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
