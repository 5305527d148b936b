"""Seeded, deterministic fault injection at named sites.

Counterpart of ``keystone_tpu/resilience/faults.py``. The resilience
guarantees need tests that run the real code paths, so the ingest code
calls :func:`inject` (and :func:`corrupt`) at named sites:

====================  ==================================================
site                  where
====================  ==================================================
``ingest.read``       per tar-member raw read attempt
                      (``loaders.image_loader_utils._iter_tar_entries``)
``ingest.decode``     per image decode attempt (the tar decode pool,
                      ``loaders.image_loader_utils._decode_with_retry``)
``ingest.produce``    per chunk in the prefetch producer loop
``ingest.stage``      per chunk staging attempt (``_Stager.stage``, after
                      the host fill, before the copy to the device);
                      ``corrupt`` rules act on the host chunk before it
                      is staged
``serve.enqueue``     per serving request submit, before the slot gate
``serve.dispatch``    per micro-batch, before the device work; a
                      ``corrupt`` rule poisons the merged host batch, a
                      ``straggler`` stretches the batch
``serve.admit``       per admission: once before the plane changes, then
                      once per warmup bucket (a fault there rolls the
                      admission back)
``serve.evict``       per explicit eviction, before any change
====================  ==================================================

``inject`` is one global read when no plan is active. Under
``with FaultPlan(seed) as plan:`` each visit consults the plan's specs:

* ``kind="error"`` raises (default :class:`InjectedFaultError`, a
  transient failure the retry path absorbs; ``error=`` for others);
* ``kind="latency"`` sleeps ``delay_s``; ``kind="straggler"`` does too,
  with a default of 0.25 s (a sustained slowdown, not a blip);
* ``kind="hang"`` blocks until the plan exits, the caller's ``abort``
  goes true, or ``delay_s`` passes;
* ``kind="corrupt"`` mutates the value at a value-carrying site: by
  default NaN into the first element of the first float leaf.

``after`` skips the first visits, ``count`` caps the injections and
``rate`` draws from the plan's ``RandomState(seed)``, one draw per
visit past ``after`` and under ``count``, as the JAX package draws.

The JAX package's world-level kinds (``host_death``, ``partition``) and
the ``process_id`` gate wait for the multi-GPU slice (ROADMAP A11): the
port has no world to gate them by yet.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..utils.guarded import TracedLock, guarded_by
from .events import record_event
from .retry import TransientError


class InjectedFaultError(TransientError):
    """The default injected failure: transient, so retries absorb it."""


_KINDS = ("error", "latency", "hang", "corrupt", "straggler")


@dataclass
class FaultSpec:
    """One injection rule at one site."""

    site: str
    kind: str = "error"
    rate: float = 1.0            # per-visit injection probability
    after: int = 0               # skip the first `after` visits
    count: Optional[int] = None  # at most this many injections
    error: Optional[Callable[[str], BaseException]] = None
    delay_s: float = 0.05        # latency duration / hang cap
    mutate: Optional[Callable[[Any], Any]] = None
    visits: int = field(default=0, compare=False)
    injected: int = field(default=0, compare=False)


def _poison_nan(value: Any) -> Any:
    """NaN into the first element of the first float leaf of a host
    chunk (an array or a tuple of arrays); the leaf is copied, because a
    source may hand out views of long-lived buffers."""
    done = False

    def walk(v):
        nonlocal done
        if isinstance(v, (tuple, list)):
            return type(v)(walk(x) for x in v)
        arr = np.asarray(v)
        if not done and np.issubdtype(arr.dtype, np.floating) and arr.size:
            arr = arr.copy()
            arr.reshape(-1)[0] = np.nan
            done = True
        return arr

    return walk(value)


_ACTIVE: Optional["FaultPlan"] = None


@guarded_by("_lock", "log", "_rng")
class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules, active inside ``with``::

        plan = FaultPlan(seed=7).add("ingest.stage", rate=0.3)
        with plan:
            fit_streaming(est, stream, labels)
        assert plan.injections("ingest.stage") > 0
    """

    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._lock = TracedLock("faults")
        self._release = threading.Event()
        self.log: List[Dict[str, Any]] = []

    def add(self, site: str, kind: str = "error", rate: float = 1.0,
            after: int = 0, count: Optional[int] = None,
            error: Optional[Callable[[str], BaseException]] = None,
            delay_s: Optional[float] = None,
            mutate: Optional[Callable[[Any], Any]] = None) -> "FaultPlan":
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (the host-level "
                             "kinds wait for the multi-GPU port)")
        if not 0.0 < rate <= 1.0:
            raise ValueError("rate must be in (0, 1]")
        if delay_s is None:
            delay_s = 0.25 if kind == "straggler" else 0.05
        self._specs.setdefault(site, []).append(FaultSpec(
            site=site, kind=kind, rate=rate, after=int(after), count=count,
            error=error, delay_s=float(delay_s), mutate=mutate))
        return self

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("another FaultPlan is already active")
        self._release.clear()
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None
        self._release.set()  # wake every hung site

    def injections(self, site: Optional[str] = None) -> int:
        with self._lock:
            return len([e for e in self.log
                        if site is None or e["site"] == site])

    def _fires(self, spec: FaultSpec, site: str, context: Any) -> bool:
        """The visit/after/count/rate gate of one spec (one RNG draw per
        gated visit)."""
        with self._lock:
            spec.visits += 1
            if spec.visits <= spec.after:
                return False
            if spec.count is not None and spec.injected >= spec.count:
                return False
            if spec.rate < 1.0 and float(self._rng.rand()) >= spec.rate:
                return False
            spec.injected += 1
            self.log.append({"site": site, "kind": spec.kind,
                             "context": context})
        record_event("fault_injected", site=site, kind=spec.kind,
                     context=str(context))
        return True

    def fire(self, site: str, context: Any,
             abort: Optional[Callable[[], bool]] = None) -> None:
        for spec in self._specs.get(site, ()):
            if spec.kind == "corrupt" or not self._fires(spec, site,
                                                         context):
                continue
            if spec.kind in ("latency", "straggler"):
                time.sleep(spec.delay_s)
            elif spec.kind == "hang":
                deadline = time.perf_counter() + spec.delay_s
                while (not self._release.wait(0.02)
                       and not (abort is not None and abort())
                       and time.perf_counter() < deadline):
                    pass
            else:
                msg = f"injected fault at {site} ({context})"
                raise (spec.error(msg) if spec.error is not None
                       else InjectedFaultError(msg))

    def mutate_value(self, site: str, value: Any, context: Any) -> Any:
        for spec in self._specs.get(site, ()):
            if spec.kind == "corrupt" and self._fires(spec, site, context):
                value = (spec.mutate or _poison_nan)(value)
        return value


def inject(site: str, context: Any = None,
           abort: Optional[Callable[[], bool]] = None) -> None:
    """The per-site hook: a no-op unless a :class:`FaultPlan` is active.
    ``abort`` ends a long ``hang`` early when the caller shuts down."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(site, context, abort)


def corrupt(site: str, value: Any, context: Any = None) -> Any:
    """The value-carrying hook: ``value`` untouched unless an active plan
    has a ``corrupt`` rule at ``site``."""
    plan = _ACTIVE
    if plan is None:
        return value
    return plan.mutate_value(site, value, context)
