"""The serving plane: warm multi-model residency and the batch worker.

Counterpart of ``keystone_tpu/serving/plane.py``, single process, one
device. ``ServingPlane`` is the object behind ``python -m
keystone_tpu_torch serve``: fitted pipelines are ADMITTED into it
(charged against a device-memory budget, warmed bucket by bucket),
requests are SUBMITTED to it (micro-batched behind the bounded queue),
and it reports through the port's metrics registry.

* **Admission.** The pipeline is canonicalized through a pickle round
  trip (the caller's object is never changed), the requested
  ``weight_dtype`` is applied to its quantizable mappers, and its
  Cacher stages are made pass-throughs: a served batch must not enter
  the prefix memo, which would keep every request's features on the
  device for the life of the process. The charge
  (``serving/residency.py``) must fit the budget, after evicting the
  ready residents of least retention value (observed QPS x warmup cost,
  the auto-cache greedy); the ledger re-checks it as a backstop. Every
  bucket is then applied once at full and once at partial fill, so the
  kernel libraries are loaded, the weights quantized and the device
  buffers sized before the model turns ready; a failed warmup rolls the
  admission back. Evicted models keep their canonical pickled bytes on
  the host, so eviction and readmission round-trip to bit-identical
  predictions.
* **Requests.** ``submit`` reads the ready models from ``_live``, a dict
  that is only ever rebound whole under the lock, so the request path
  takes no lock. One worker thread drains the batcher: it sheds requests
  past their deadline, merges the rest into one padded bucket, applies
  the model, fails the batch if the outputs are not finite
  (:class:`PoisonedBatchError`), and resolves each request's future with
  its own rows.
* **Metrics.** ``serving.request_ms`` and ``serving.queue_wait_s``
  (aggregate and per model), ``serving.batch_ms``, ``serving.batch_fill``
  (aggregate and per model), the ``requests_total``, ``rows_total``,
  ``batches_total``, ``errors_total`` and ``evictions_total`` counters,
  and the ``hbm_charged_bytes`` and ``models_resident`` gauges.

Left out, each to its ROADMAP item: the mesh and ``data_shards`` (A11);
the ``serve.*`` fault sites, post-mortems and drift scoring, request
traces, the SLO tracker and flight-recorder spans (A10). The JAX package
fences steady-state recompiles; its counterpart here, capturing each
bucket's apply as a CUDA graph at admission, comes in a later PR: this
one warms every bucket but does not capture it.

Thread model: caller and handler threads run ``admit`` / ``submit``;
one worker thread drains the batcher. ``_models``, ``_evicted``,
``_warming``, ``_expected`` and ``_admitted_total`` are guarded by
``_lock``; device work (warmup, batches) runs outside it.
"""
from __future__ import annotations

import pickle
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from torch.utils import _pytree as pytree

from ..observability.metrics import MetricsRegistry
from ..ops.device import DEFAULT_DEVICE, resolve_device
from ..parallel.dataset import ArrayDataset, bucketed_dataset
from ..workflow.common import Identity
from ..workflow.executor import is_saveable
from ..workflow.optimizer.auto_cache import greedy_select
from ..workflow.pipeline import Pipeline
from .batcher import (BucketPolicy, DeadlineExpiredError, MicroBatcher,
                      Request)
from .models import (ItemSpec, ServedModel, _apply_weight_dtype, _as_host,
                     _count_nonfinite, _EvictedModel, _evicted_record,
                     _zeros_batch, is_spec, spec_leaves)
from .residency import AdmissionError, ResidencyLedger, model_charge


class ModelNotAdmitted(LookupError):
    """The named model is not resident (never admitted, or evicted)."""


class ModelWarming(RuntimeError):
    """The named model is admitted but still warming; retry after
    ``/healthz`` reports ready."""


class PoisonedBatchError(RuntimeError):
    """A batch came back with non-finite outputs. Exactly this batch's
    requests fail (HTTP 500); the worker and the queue go on."""


def _without_cachers(pipeline: Pipeline) -> Pipeline:
    """The pipeline with every saveable stage (a Cacher) replaced by a
    pass-through, so applying it never writes the prefix memo."""
    graph = pipeline.graph
    for node in graph.nodes:
        if is_saveable(graph.get_operator(node)):
            graph = graph.set_operator(node, Identity())
    return Pipeline(graph, pipeline._source, pipeline._sink)


class ServingPlane:
    """Warm multi-model serving under a device-memory budget on one
    device; see the module docstring. Usable as a context manager
    (``close`` stops the worker and fails what is still queued)."""

    def __init__(self, hbm_budget: Optional[float] = None,
                 max_batch: int = 64, queue_depth: int = 128,
                 default_weight_dtype: Optional[str] = None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.policy = BucketPolicy(max_batch)
        self.ledger = ResidencyLedger(hbm_budget)
        self.batcher = MicroBatcher(queue_depth)
        self.default_weight_dtype = default_weight_dtype
        self._models: Dict[str, ServedModel] = {}
        #: the ready residents, read without the lock by submit; only
        #: ever rebound whole under it (_publish_locked / close)
        self._live: Dict[str, ServedModel] = {}
        self._evicted: Dict[str, _EvictedModel] = {}
        self._warming = 0
        self._expected = 0
        self._admitted_total = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        if hbm_budget is not None:
            MetricsRegistry.get_or_create().gauge(
                "serving.hbm_budget_bytes").set(float(hbm_budget))

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "ServingPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self) -> "ServingPlane":
        """Start the batch worker (idempotent)."""
        with self._lock:
            if self._worker is None and not self._closed:
                self._stop = threading.Event()
                self._worker = threading.Thread(
                    target=self._worker_loop, name="keystone-serving-worker",
                    daemon=True)
                self._worker.start()
        return self

    def close(self) -> None:
        """Stop the worker and fail every queued request."""
        with self._lock:
            self._closed = True
            # lock-free submitters now fall to the locked path, which
            # sees the batcher refuse
            self._live = {}
            worker, self._worker = self._worker, None
            self._stop.set()
        if worker is not None:
            worker.join(timeout=10.0)
        for req in self.batcher.close():
            if not req.future.done():
                req.future.set_exception(RuntimeError("serving plane closed"))

    # -- readiness ---------------------------------------------------------
    def expect_models(self, count: int) -> None:
        """Declare how many admissions readiness waits for (the serve CLI
        calls it before binding the port, so ``/healthz`` reports
        not-ready until the last listed model has warmed)."""
        with self._lock:
            self._expected = max(int(count), 0)

    def ready(self) -> bool:
        """True when no warmup is in flight, every admitted model is
        ready and at least ``expect_models`` admissions have COMPLETED
        (counted cumulatively: a startup admission that evicts an
        earlier one must not hold readiness at 503)."""
        with self._lock:
            return self._ready_locked()

    def _ready_locked(self) -> bool:
        return (self._warming == 0
                and self._admitted_total >= self._expected
                and all(e.ready for e in self._models.values()))

    # -- admission ---------------------------------------------------------
    def admit(self, name: str, fitted: Any, sample: Any,
              weight_dtype: Optional[str] = "default") -> ServedModel:
        """Admit a fitted pipeline as a warm served model.

        ``sample`` describes ONE request item: an :class:`ItemSpec` (or
        a tuple of them), ``(shape, dtype)``, or an array. ``weight_dtype``
        ``"default"`` means the plane's default. Raises
        :class:`~.residency.AdmissionError`, changing nothing, when the
        model cannot fit even after every allowed eviction."""
        sample = self._as_sample_spec(sample)
        wd = (self.default_weight_dtype if weight_dtype == "default"
              else weight_dtype)
        try:
            working = pickle.loads(pickle.dumps(fitted))
        except Exception as exc:
            raise TypeError(
                f"model {name!r} is not picklable ({exc}) — serving keeps "
                "a canonical pickled copy so eviction / readmission "
                "round-trips bit-identically (the constraint save_pipeline "
                "imposes too). Replace closures and lambdas in the pipeline "
                "with module-level functions or Transformer subclasses."
            ) from exc
        # a Pipeline, so .apply binds a dataset (a bare Transformer keeps
        # .apply for its per-item function); its operators are shared
        # with `working`, so the blob carries the applied weight type
        pipeline = working.to_pipeline()
        _apply_weight_dtype(pipeline.graph, wd)
        blob = pickle.dumps(working)
        pipeline = _without_cachers(pipeline)
        buckets = self.policy.rows()
        charge = model_charge(pipeline, _zeros_batch(sample, 1), buckets[-1],
                              self.device)
        entry = ServedModel(name=name, fitted=pipeline, blob=blob,
                            sample=sample, charge=charge, buckets=buckets,
                            weight_dtype=wd)
        with self._lock:
            if self._closed:
                raise RuntimeError("serving plane closed")
            if name in self._models:
                raise ValueError(f"model {name!r} is already admitted")
            victims = self._plan_evictions_locked(charge.total_nbytes())
            for victim in victims:
                dropped = self._models.pop(victim)
                self.ledger.release(victim)
                self._evicted[victim] = _evicted_record(dropped)
            # the backstop: raises without a change if the plan was wrong
            self.ledger.admit(name, charge.total_nbytes())
            self._models[name] = entry
            # a readmitted name leaves the evicted set; kept aside so a
            # failed warmup can restore it
            prior_evicted = self._evicted.pop(name, None)
            self._warming += 1
            self._publish_locked()
        try:
            t0 = time.perf_counter()
            self._warm(entry)
            entry.warmup_s = time.perf_counter() - t0
        except BaseException:
            self._finish_warmup(entry, ok=False,
                                restore_evicted=prior_evicted)
            raise
        MetricsRegistry.get_or_create().histogram(
            "serving.warmup_s").observe(entry.warmup_s)
        self._finish_warmup(entry, ok=True)
        return entry

    def _finish_warmup(self, entry: ServedModel, ok: bool,
                       restore_evicted: Optional[_EvictedModel] = None
                       ) -> None:
        """Mark the model ready, or roll its registration back (restoring
        the evicted record a readmission popped), in one lock hold."""
        with self._lock:
            if ok:
                entry.ready = True
                self._admitted_total += 1
            else:
                self._models.pop(entry.name, None)
                self.ledger.release(entry.name)
                if restore_evicted is not None:
                    self._evicted[entry.name] = restore_evicted
            self._warming -= 1
            self._publish_locked()

    def evict(self, name: str) -> None:
        """Evict a resident model; its canonical bytes stay on the host
        for :meth:`readmit`. All changes happen in one lock hold."""
        with self._lock:
            if name not in self._models:
                raise ModelNotAdmitted(f"model {name!r} is not resident")
            entry = self._models.pop(name)
            self.ledger.release(name)
            self._evicted[name] = _evicted_record(entry)
            self._publish_locked()

    def readmit(self, name: str) -> ServedModel:
        """Admit an evicted model again from its canonical pickled bytes:
        the same bytes and the same quantization, so the same
        predictions, bit for bit."""
        with self._lock:
            evicted = self._evicted.get(name)
        if evicted is None:
            raise ModelNotAdmitted(
                f"model {name!r} was never evicted from this plane")
        return self.admit(name, pickle.loads(evicted.blob), evicted.sample,
                          weight_dtype=evicted.weight_dtype)

    def _plan_evictions_locked(self, needed: float) -> List[str]:
        """Which ready residents to evict so ``needed`` bytes fit: keep
        the set of highest retention value that fits the remaining
        budget (the auto-cache greedy), evict the rest. Warming models
        are never victims. Raises AdmissionError when ``needed`` exceeds
        the whole budget or what warming models leave of it."""
        budget = self.ledger.budget
        if budget is None:
            return []
        mib = 1 << 20
        if needed > budget:
            MetricsRegistry.get_or_create().counter(
                "serving.admission_rejected_total").inc()
            raise AdmissionError(
                f"model charge {needed / mib:.2f} MiB exceeds the whole "
                f"serving budget {budget / mib:.2f} MiB — refusing "
                "admission (shrink the model, quantize it, or lower "
                "max_batch)")
        if budget - self.ledger.used() >= needed:
            return []
        now = time.perf_counter()
        evictable = {n: e for n, e in self._models.items() if e.ready}
        pinned = sum(self.ledger.charge_of(n)
                     for n in self._models if n not in evictable)

        def candidates(selected, space_left):
            return [n for n in evictable if n not in selected
                    and self.ledger.charge_of(n) < space_left]

        keep = greedy_select(
            (), candidates, lambda n: self.ledger.charge_of(n),
            lambda sel: -sum(evictable[n].retention_value(now)
                             for n in sel),
            budget - needed - pinned)
        kept = pinned + sum(self.ledger.charge_of(n) for n in keep)
        if kept + needed > budget:
            MetricsRegistry.get_or_create().counter(
                "serving.admission_rejected_total").inc()
            raise AdmissionError(
                f"cannot make room for {needed / mib:.2f} MiB under the "
                f"{budget / mib:.2f} MiB budget: {kept / mib:.2f} MiB is "
                "held by warming models")
        return [n for n in evictable if n not in keep]

    def _publish_locked(self) -> None:
        """Rebind ``_live`` to a fresh dict of the ready residents (never
        changed in place: a lock-free reader sees the old dict or the
        new one) and update the gauges. Lock held."""
        self._live = {n: e for n, e in self._models.items() if e.ready}
        reg = MetricsRegistry.get_or_create()
        reg.gauge("serving.models_resident").set(len(self._live))
        reg.gauge("serving.models_warming").set(self._warming)

    def _warm(self, entry: ServedModel) -> None:
        """Apply every bucket once full and once partially filled (the
        padded rows past n take the masking path)."""
        for bucket in entry.buckets:
            self._execute(entry, _zeros_batch(entry.sample, bucket), bucket)
            if bucket > 1:
                self._execute(entry, _zeros_batch(entry.sample, bucket - 1),
                              bucket - 1)

    # -- request path ------------------------------------------------------
    def submit(self, name: str, x: Any, timeout_s: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Queue one request; returns a Future of the model output for
        exactly the submitted rows. ``x`` is one item (the admitted
        sample's shape) or a batch of them, at most the largest bucket.
        A request still queued ``deadline_ms`` after submission is shed
        before dispatch (the future raises DeadlineExpiredError)."""
        entry = self._live.get(name)
        if entry is None:
            with self._lock:
                entry = self._models.get(name)
                if entry is None:
                    known = sorted(self._models) + [
                        f"{k} (evicted)" for k in sorted(self._evicted)]
                    raise ModelNotAdmitted(
                        f"model {name!r} is not resident "
                        f"(known: {known or 'none'})")
                if not entry.ready:
                    raise ModelWarming(f"model {name!r} is still warming")
        x_tree, n = self._normalize(name, entry.sample, x)
        return self.batcher.submit(name, x_tree, n, timeout_s=timeout_s,
                                   deadline_ms=deadline_ms)

    def predict(self, name: str, x: Any, timeout_s: float = 60.0,
                deadline_ms: Optional[float] = None):
        """Submit and wait."""
        return self.submit(name, x, deadline_ms=deadline_ms).result(
            timeout=timeout_s)

    def _normalize(self, name: str, sample: Any, x: Any) -> Tuple[Any, int]:
        specs = spec_leaves(sample)
        leaves = pytree.tree_leaves(x)
        if len(leaves) != len(specs):
            raise ValueError(
                f"request for {name!r} has {len(leaves)} leaves, the "
                f"admitted sample has {len(specs)}")
        ns = set()
        out_leaves = []
        for leaf, spec in zip(leaves, specs):
            arr = _as_host(leaf, spec.dtype)
            if arr.shape == spec.shape:
                arr = arr[None]
            elif arr.shape[1:] != spec.shape:
                raise ValueError(
                    f"request leaf shape {arr.shape} matches neither item "
                    f"{spec.shape} nor (n, *item) for model {name!r}")
            ns.add(arr.shape[0])
            out_leaves.append(arr)
        if len(ns) != 1:
            raise ValueError(
                f"request leaves disagree on row count: {sorted(ns)}")
        n = ns.pop()
        if n > self.policy.max_rows():
            raise ValueError(
                f"request of {n} rows exceeds the largest bucket "
                f"({self.policy.max_rows()}) — split it")
        rebuilt = pytree.tree_unflatten(
            out_leaves, pytree.tree_structure(sample, is_leaf=is_spec))
        return rebuilt, int(n)

    @staticmethod
    def _as_sample_spec(sample: Any) -> Any:
        if isinstance(sample, ItemSpec):
            return sample
        if (isinstance(sample, tuple) and len(sample) == 2
                and isinstance(sample[0], (tuple, list))):
            return ItemSpec(tuple(sample[0]), np.dtype(sample[1]))
        if hasattr(sample, "shape") and hasattr(sample, "dtype"):
            return ItemSpec(tuple(sample.shape),
                            np.dtype(str(sample.dtype).replace("torch.", "")))
        leaves = spec_leaves(sample)
        if leaves and all(is_spec(leaf) for leaf in leaves):
            return sample
        raise TypeError(
            "sample must describe ONE request item: an ItemSpec (or a "
            "tuple of them), (shape, dtype), or an array")

    # -- execution ---------------------------------------------------------
    def _execute(self, entry: ServedModel, x_tree: Any, n: int):
        """One padded-bucket apply; returns the outputs for exactly n
        rows and the staged dataset."""
        ds = bucketed_dataset(x_tree, n, self.policy.bucket_for(max(n, 1)),
                              self.device)
        return self._collect(entry, ds), ds

    @staticmethod
    def _collect(entry: ServedModel, ds: ArrayDataset):
        """Apply the model to a staged bucket and bring the n real rows
        to the host (which waits for the device)."""
        return entry.fitted.apply(ds).get().numpy()

    def _worker_loop(self) -> None:
        max_rows = self.policy.max_rows()
        while not self._stop.is_set():
            batch = self.batcher.take(max_rows, timeout_s=0.05)
            if batch:
                self._serve_batch(batch)

    def _serve_batch(self, requests: List[Request]) -> None:
        taken = len(requests)
        reg = MetricsRegistry.get_or_create()
        try:
            requests = self._shed_expired(requests, reg)
            if not requests:
                return
            name = requests[0].model
            with self._lock:
                entry = self._models.get(name)
            if entry is None or not entry.ready:
                raise ModelNotAdmitted(
                    f"model {name!r} was evicted while queued")
            rows = sum(r.n for r in requests)
            t_merge = time.perf_counter()
            merged = pytree.tree_map(
                lambda *leaves: np.concatenate(leaves, axis=0),
                requests[0].x, *[r.x for r in requests[1:]])
            t0 = time.perf_counter()
            outputs, ds = self._execute(entry, merged, rows)
            t_done = time.perf_counter()
            # never hand clients NaN/inf predictions
            bad = _count_nonfinite(outputs)
            if bad:
                raise PoisonedBatchError(
                    f"batch for {name!r} produced {bad} non-finite output "
                    f"value(s) over {rows} rows — failing this batch's "
                    "requests; the worker goes on")
            fill = rows / float(ds.padded_n)
            offset = 0
            for req in requests:
                req.future.set_result(self._slice_rows(outputs, offset,
                                                       req.n))
                offset += req.n
            now = time.perf_counter()
            reg.counter("serving.requests_total").inc(len(requests))
            reg.counter("serving.rows_total").inc(rows)
            reg.counter("serving.batches_total").inc()
            reg.histogram("serving.batch_ms").observe((t_done - t0) * 1e3)
            reg.histogram("serving.batch_fill").observe(fill)
            reg.histogram(f"serving.batch_fill.{name}").observe(fill)
            for req in requests:
                wait_ms = (now - req.enqueued_s) * 1e3
                reg.histogram("serving.request_ms").observe(wait_ms)
                reg.histogram(f"serving.request_ms.{name}").observe(wait_ms)
                # queued time, enqueue to the start of the merge
                qwait_s = max(t_merge - req.enqueued_s, 0.0)
                reg.histogram("serving.queue_wait_s").observe(qwait_s)
                reg.histogram(f"serving.queue_wait_s.{name}").observe(
                    qwait_s)
            with self._lock:
                entry.note_served(rows, len(requests), now)
        except BaseException as exc:  # noqa: BLE001 - every future is failed
            self._fail_batch(requests, exc, reg)
        finally:
            self.batcher.done(taken)

    def _shed_expired(self, requests: List[Request],
                      reg: MetricsRegistry) -> List[Request]:
        """Fail every member past its deadline before dispatch and return
        the rest. One clock read decides for the whole batch."""
        now = time.perf_counter()
        live = [r for r in requests if not r.expired(now)]
        if len(live) == len(requests):
            return live
        shed = [r for r in requests if r.expired(now)]
        for req in shed:
            if not req.future.done():
                req.future.set_exception(DeadlineExpiredError(
                    f"request for {req.model!r} spent "
                    f"{(now - req.enqueued_s) * 1e3:.1f} ms queued, past "
                    "its deadline — shed before dispatch"))
        reg.counter("serving.deadline_expired_total").inc(len(shed))
        reg.counter("serving.shed_total").inc(len(shed))
        return live

    @staticmethod
    def _fail_batch(requests: List[Request], exc: BaseException,
                    reg: MetricsRegistry) -> None:
        """Count the failure and fail every future not yet resolved."""
        reg.counter("serving.errors_total").inc()
        if isinstance(exc, PoisonedBatchError):
            reg.counter("serving.poisoned_batches_total").inc()
        for req in requests:
            if not req.future.done():
                req.future.set_exception(exc)

    @staticmethod
    def _slice_rows(outputs: Any, offset: int, n: int) -> Any:
        return pytree.tree_map(lambda leaf: leaf[offset:offset + n],
                               outputs)

    # -- introspection -----------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """JSON-able plane state (the ``/models`` body); the verdict, the
        model list and the evicted set come from one lock hold."""
        with self._lock:
            ready = self._ready_locked()
            models = [e.state() for e in self._models.values()]
            evicted = sorted(self._evicted)
            warming = self._warming
        return {
            "ready": ready,
            "warming": warming,
            "device": str(self.device),
            "hbm_budget_bytes": self.ledger.budget,
            "hbm_charged_bytes": self.ledger.used(),
            "buckets": list(self.policy.rows()),
            "queue_depth": self.batcher.depth(),
            "models": sorted(models, key=lambda m: m["name"]),
            "evicted": evicted,
        }
