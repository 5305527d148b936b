"""Device-memory admission control for the serving plane.

Counterpart of ``keystone_tpu/serving/residency.py``. Models are
admitted under an explicit device-memory budget: a fitted pipeline is
admitted only when its charge, persistent fitted state plus the
per-item activation times the largest bucket, fits beside the models
already warm.

* :func:`model_charge` — one model's :class:`ModelCharge`. The JAX
  package sizes it from its static planner (``analysis/resources.py``),
  which the port does not have yet (ROADMAP A12). So the port takes the
  model bytes from its own :func:`fitted_model_nbytes` and the per-item
  activation from a one-item probe apply, and records
  ``source="probed"``.
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
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..observability.metrics import MetricsRegistry
from ..parallel.dataset import ArrayDataset, device_nbytes

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

    def activation_nbytes(self) -> float:
        return float(self.item_nbytes) * float(self.bucket_rows)

    def total_nbytes(self) -> float:
        return float(self.model_nbytes) + self.activation_nbytes()


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


def model_charge(fitted: Any, zero_item: Any, bucket_rows: int,
                 device) -> ModelCharge:
    """The admission charge of ``fitted`` (a fitted pipeline) serving
    items like ``zero_item`` (host arrays of one row, leading dim 1) at a
    largest bucket of ``bucket_rows`` rows on ``device``. Model bytes from
    :func:`fitted_model_nbytes`, the per-item activation from a one-item
    probe apply (the static planner the JAX package sizes it with is not
    ported yet), hence ``source="probed"``."""
    graph = fitted.to_pipeline().graph
    return ModelCharge(model_nbytes=fitted_model_nbytes(graph),
                       item_nbytes=_probe_item_nbytes(fitted, zero_item,
                                                      device),
                       bucket_rows=int(bucket_rows), source="probed")


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
