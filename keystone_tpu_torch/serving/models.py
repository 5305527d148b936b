"""The model-record layer of the serving plane.

Counterpart of ``keystone_tpu/serving/models.py``: what describes ONE
served model — the live :class:`ServedModel` record with its QPS window
and retention value, the host-side :class:`_EvictedModel` remainder that
readmission restores bit-identically from — and the helpers admission
and warmup use: the item spec, zero batches, weight-type narrowing, the
non-finite guard, and the probe for a fit's drift baseline
(``model.numerics_baseline``) that the plane scores served inputs
against.
"""
from __future__ import annotations

import io
import itertools
import pickle
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..nodes.learning.linear import (
    BlockLinearMapper,
    LinearMapper,
    StandardScalerModel,
    _canon_weight_dtype,
)
from ..observability.metrics import MetricsRegistry
from .residency import ModelCharge

#: seconds of request history the QPS estimate looks back over
_QPS_WINDOW_S = 30.0

#: one token per admission: the key of its captured graphs, so a late
#: capture for an evicted entry can never serve a readmitted one
_ADMISSIONS = itertools.count(1)


@dataclass(frozen=True)
class ItemSpec:
    """Shape and numpy dtype of ONE request item (no leading batch
    dimension): the port's counterpart of the ``jax.ShapeDtypeStruct`` a
    model is admitted with. A sample may be one spec or a tuple of them
    (a pytree, flattened with ``torch.utils._pytree``)."""

    shape: Tuple[int, ...]
    dtype: np.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))


def is_spec(x: Any) -> bool:
    return isinstance(x, ItemSpec)


def spec_leaves(sample: Any):
    return pytree.tree_leaves(sample, is_leaf=is_spec)


@dataclass
class ServedModel:
    """One warm resident model. Its mutable serving stats are touched
    only under the owning plane's lock."""

    name: str
    fitted: Any                      # the working Pipeline
    blob: bytes                      # canonical pickle (readmission source)
    sample: Any                      # ItemSpec pytree of ONE item
    charge: ModelCharge
    buckets: Tuple[int, ...]
    weight_dtype: Optional[str] = None
    ready: bool = False
    warmup_s: float = 0.0
    last_used_s: float = field(default_factory=time.perf_counter)
    served_rows: int = 0
    served_requests: int = 0
    batches: int = 0
    baseline: Any = None             # DriftBaseline or None
    drift_disabled: bool = False
    _recent: Deque[Tuple[float, int]] = field(default_factory=deque)
    token: int = field(default_factory=lambda: next(_ADMISSIONS))
    #: CUDA graph captures of this admission, their wall seconds and the
    #: bytes of their private memory pools (0 on the CPU)
    captures: int = 0
    capture_s: float = 0.0
    graph_pool_nbytes: float = 0.0

    def note_served(self, rows: int, requests: int, now: float) -> None:
        self.last_used_s = now
        self.served_rows += rows
        self.served_requests += requests
        self.batches += 1
        self._recent.append((now, rows))
        while self._recent and self._recent[0][0] < now - _QPS_WINDOW_S:
            self._recent.popleft()

    def qps(self, now: Optional[float] = None) -> float:
        """Observed rows per second over the recent window (0 before any
        traffic): the demand half of the retention value."""
        if not self._recent:
            return 0.0
        now = time.perf_counter() if now is None else now
        span = max(now - self._recent[0][0], 1e-3)
        return sum(r for _, r in self._recent) / span

    def retention_value(self, now: Optional[float] = None) -> float:
        """LRU-with-cost: observed QPS x recompute (warmup) cost, recency
        as a tiebreak so two idle models evict least recently used
        first."""
        return (self.qps(now) * max(self.warmup_s, 1e-3)
                + 1e-9 * self.last_used_s)

    def state(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "ready": self.ready,
            "weight_dtype": self.weight_dtype,
            "drift_baseline": self.baseline is not None
            and not self.drift_disabled,
            "charge_nbytes": self.charge.total_nbytes(),
            "charge_graph_nbytes": self.charge.graph_nbytes,
            "charge_pool_nbytes": self.charge.pool_nbytes,
            "captures": self.captures,
            "capture_s": round(self.capture_s, 6),
            "graph_pool_nbytes": self.graph_pool_nbytes,
            "charge_source": self.charge.source,
            "buckets": list(self.buckets),
            "warmup_s": round(self.warmup_s, 4),
            "served_rows": self.served_rows,
            "served_requests": self.served_requests,
            "batches": self.batches,
            "qps": round(self.qps(), 3),
        }


@dataclass
class _EvictedModel:
    """Host-side remainder of an evicted model: everything readmission
    needs to serve bit-identically again."""

    blob: bytes
    sample: Any
    weight_dtype: Optional[str]


def _count_nonfinite(outputs: Any) -> int:
    """Non-finite values in a host output pytree (float leaves only)."""
    total = 0
    for leaf in pytree.tree_leaves(outputs):
        arr = np.asarray(leaf)
        if arr.size and np.issubdtype(arr.dtype, np.floating):
            total += int(arr.size) - int(np.isfinite(arr).sum())
    return total


def _zeros_batch(sample: Any, rows: int) -> Any:
    return pytree.tree_map(
        lambda s: np.zeros((rows,) + s.shape, s.dtype), sample,
        is_leaf=is_spec)


def _apply_weight_dtype(graph: Any, weight_dtype: Optional[str]) -> int:
    """Narrow every quantizable mapper in ``graph`` that did not choose a
    weight type itself (an explicit per-model choice wins). Only a plain
    (or absent) StandardScalerModel feature scaler keeps the quantized
    apply one affine, so mappers with another scaler stay float32. The
    mapper's cached device params (``_params_cache``) and equality key
    are dropped: they hold the float32 weights, and a mapper narrowed
    after an apply would otherwise go on serving them."""
    wd = _canon_weight_dtype(weight_dtype)
    if wd is None:
        return 0
    changed = 0
    for node in graph.nodes:
        op = graph.get_operator(node)
        if not isinstance(op, (LinearMapper, BlockLinearMapper)):
            continue
        if op.weight_dtype is not None:
            continue
        scaler = getattr(op, "feature_scaler", None)
        if scaler is not None and type(scaler) is not StandardScalerModel:
            continue
        op.weight_dtype = wd
        op.__dict__.pop("_params_cache", None)
        op.__dict__.pop("_eq_key_val", None)
        changed += 1
    return changed


def _tensor_from_bytes(data: bytes, dtype: str, shape: Tuple[int, ...],
                       device: str, requires_grad: bool) -> torch.Tensor:
    """Rebuild a tensor that :func:`canonical_dumps` wrote, into memory
    of its own (aligned as any allocation, not the pickle's buffer)."""
    flat = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if data
            else torch.empty(0, dtype=torch.uint8))
    t = flat.view(getattr(torch, dtype)).reshape(shape).to(device,
                                                           copy=True)
    return t.requires_grad_(requires_grad)


class _CanonicalPickler(pickle.Pickler):
    """Pickles a tensor by value: its bytes, type, shape and device.
    PyTorch's own reduction names each storage by its address, so the
    same model pickled in two processes (or twice in one) gives other
    bytes, and a sha256 of them would verify nothing."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            host = obj.detach().cpu().contiguous().reshape(-1)
            raw = host.view(torch.uint8).numpy().tobytes() \
                if host.numel() else b""
            return _tensor_from_bytes, (
                raw, str(obj.dtype).replace("torch.", ""),
                tuple(obj.shape), str(obj.device), bool(obj.requires_grad))
        return NotImplemented


def canonical_dumps(obj: Any) -> bytes:
    """The canonical bytes of a served model: a pickle whose tensors are
    written by value, so ``canonical_dumps(pickle.loads(b)) == b`` in any
    process. Its sha256 is the fleet's bit-identity verdict."""
    buf = io.BytesIO()
    _CanonicalPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _find_baseline(graph: Any) -> Any:
    """The first fit-time drift sketch riding the fitted operators
    (``model.numerics_baseline``, attached by ``fit_streaming``)."""
    for node in graph.nodes:
        baseline = getattr(graph.get_operator(node), "numerics_baseline",
                           None)
        if baseline is not None:
            return baseline
    return None


def _evicted_record(entry: ServedModel) -> _EvictedModel:
    """Host-side remainder for one eviction (also counts it); the dict
    changes stay at the call sites, under the plane lock."""
    MetricsRegistry.get_or_create().counter("serving.evictions_total").inc()
    return _EvictedModel(blob=entry.blob, sample=entry.sample,
                         weight_dtype=entry.weight_dtype)


def _as_host(leaf: Any, dtype: np.dtype) -> np.ndarray:
    """A request leaf as a host array of the admitted dtype."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf, dtype=dtype)
