"""The serving plane: warm multi-model residency and the batch workers.

Counterpart of ``keystone_tpu/serving/plane.py``, one device.
``ServingPlane`` is the object behind ``python -m keystone_tpu_torch
serve`` and behind each fleet replica: fitted pipelines are ADMITTED
into it (charged against a device-memory budget, warmed and captured
bucket by bucket), requests are SUBMITTED to it (micro-batched behind
the bounded queue), and it reports through the port's metrics registry,
flight recorder, request traces and SLO tracker.

* **Admission.** The pipeline is canonicalized through a pickle round
  trip (the caller's object is never changed), the requested
  ``weight_dtype`` is applied to its quantizable mappers, and its
  Cacher stages are made pass-throughs: a served batch must not enter
  the prefix memo. The charge (``serving/residency.py``) must fit the
  budget, after evicting the ready residents of least retention value
  (observed QPS x warmup cost, the auto-cache greedy); the ledger
  re-checks it as a backstop. ``serve.admit`` is a fault site before
  any change and once per warmup bucket; a failed warmup rolls the
  admission back. Evicted models keep their canonical pickled bytes on
  the host, so eviction and readmission round-trip to bit-identical
  predictions.
* **Captured buckets (CUDA).** The JAX plane warms every bucket's
  program and then arms a compile fence; the port captures every
  bucket's apply as a CUDA graph (``serving/graphs.py``), one graph a
  bucket with every row real, after one eager apply that does the lazy
  set-up. A request's rows are copied into the graph's static input,
  the rows past them zeroed, the graph replayed and the request's rows
  brought back: every served stage is row-wise, so one graph serves
  every request size up to its bucket with the eager apply's bits (the
  JAX plane warms a full and a partial fill because they are two XLA
  programs; here they would be one graph). The graphs live in a
  bounded memo keyed ``(admission, bucket)`` (``utils/lru.py``);
  eviction drops an admission's graphs and releases their pools. Each
  graph has a private memory pool, which the admission charge covers,
  and its own lock (two workers never replay one graph at once; they
  may replay two). Once no admission is
  warming, the plane arms the observatory's ``serving:steady-state``
  fence (``observability/compilelog.py``): a bucket reached in steady
  state that was never captured is captured then and counted in
  ``compile.unexpected_total`` (:meth:`ServingPlane.
  unexpected_recompiles`). A capture that fails refuses the admission
  with a :class:`~.graphs.CaptureError` naming the operation; nothing
  on CUDA falls back to the eager apply. A CPU plane captures nothing
  and runs the eager apply.
* **Requests.** ``submit`` reads the ready models from ``_live``, a dict
  only ever rebound whole under the lock, so the request path takes no
  plane lock. ``workers`` threads (default 1,
  ``KEYSTONE_TORCH_SERVE_WORKERS``) drain the batcher: shed requests
  past their deadline, merge the rest into one padded bucket
  (``serve.dispatch`` is the fault site, where a ``corrupt`` rule
  poisons the merged batch), apply, fail the batch if the outputs are
  not finite (:class:`PoisonedBatchError`, with a throttled
  post-mortem), and resolve each request's future with its rows.
* **Observability.** ``serving.request_ms`` / ``serving.queue_wait_s`` /
  ``serving.batch_fill`` (aggregate and per model), ``serving.batch_ms``
  and the counters; each request's :class:`~..observability.reqtrace.
  ReqTrace` phases feed ``serving.phase_ms.<phase>``, one
  ``request:<model>`` span per request and one ``batch:<model>`` span
  per batch, linked by flow ids (built off the request path: one
  deferred thunk per batch), and the slowest-N exemplar reservoir;
  every request's outcome feeds the rolling-window SLO tracker
  (``self.slo``); every ``drift_every`` batches a model whose fit left a
  drift baseline has its inputs scored (``score_drift``), after the
  batch's futures resolve.

Left out, to its ROADMAP item: the mesh and ``data_shards`` (A11).

Thread model: caller and handler threads run ``admit`` / ``submit``;
``workers`` threads drain the batcher. ``_models``, ``_evicted``,
``_warming``, ``_expected`` and ``_admitted_total`` are guarded by
``_lock``; device work (warmup, captures, batches) runs outside it.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..observability.compilelog import (capture_lock, compile_observatory,
                                        observed_capture)
from ..observability.metrics import MetricsRegistry
from ..observability.reqtrace import PHASES, exemplar_reservoir, \
    mint_flow_id
from ..observability.timeline import flight_recorder
from ..ops.device import DEFAULT_DEVICE, resolve_device
from ..parallel.dataset import bucketed_dataset
from ..resilience.faults import corrupt, inject
from ..utils.guarded import TracedLock, guarded_by
from ..utils.lru import LruMemo
from ..workflow.common import Identity
from ..workflow.executor import is_saveable
from ..workflow.optimizer.auto_cache import greedy_select
from ..workflow.pipeline import Pipeline
from .batcher import (BucketPolicy, DeadlineExpiredError, MicroBatcher,
                      Request)
from .graphs import GRAPHS_KEPT, BucketGraph, capture_apply, warm_apply
from .models import (ItemSpec, ServedModel, _apply_weight_dtype, _as_host,
                     canonical_dumps,
                     _count_nonfinite, _EvictedModel, _evicted_record,
                     _find_baseline, _zeros_batch, is_spec, spec_leaves)
from .residency import (AdmissionError, ResidencyLedger, graph_pool_nbytes,
                        model_charge)


class ModelNotAdmitted(LookupError):
    """The named model is not resident (never admitted, or evicted)."""


class ModelWarming(RuntimeError):
    """The named model is admitted but still warming; retry after
    ``/healthz`` reports ready."""


class PoisonedBatchError(RuntimeError):
    """A batch came back with non-finite outputs. Exactly this batch's
    requests fail (HTTP 500, post-mortem attached); the workers and the
    queue go on."""


def _without_cachers(pipeline: Pipeline) -> Pipeline:
    """The pipeline with every saveable stage (a Cacher) replaced by a
    pass-through, so applying it never writes the prefix memo."""
    graph = pipeline.graph
    for node in graph.nodes:
        if is_saveable(graph.get_operator(node)):
            graph = graph.set_operator(node, Identity())
    return Pipeline(graph, pipeline._source, pipeline._sink)


def graph_rows(policy: BucketPolicy, device) -> List[int]:
    """The bucket rows of every graph a plane on ``device`` captures for
    one model, one a bucket (none on the CPU): what the admission charge
    covers."""
    if torch.device(device).type != "cuda":
        return []
    return list(policy.rows())


@guarded_by("_lock", "_models", "_evicted", "_warming", "_expected",
            "_admitted_total")
class ServingPlane:
    """Warm multi-model serving under a device-memory budget on one
    device; see the module docstring. Usable as a context manager
    (``close`` stops the workers, fails what is still queued and
    disarms the steady-state fence)."""

    def __init__(self, hbm_budget: Optional[float] = None,
                 max_batch: int = 64, queue_depth: int = 128,
                 default_weight_dtype: Optional[str] = None,
                 drift_every: int = 32,
                 policy: Optional[BucketPolicy] = None,
                 steady_fence: bool = True,
                 slo_policy: Any = None,
                 nonfinite_guard: bool = True,
                 postmortem_min_interval_s: float = 30.0,
                 workers: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        from ..observability.slo import SloTracker

        self.device = resolve_device(device)
        self.policy = policy or BucketPolicy(max_batch)
        self.ledger = ResidencyLedger(hbm_budget)
        self.batcher = MicroBatcher(queue_depth)
        #: rolling-window error budgets, fed one outcome per request
        #: (``GET /slo``)
        self.slo = SloTracker(slo_policy)
        self.drift_every = max(int(drift_every), 1)
        self.default_weight_dtype = default_weight_dtype
        self.steady_fence = steady_fence
        #: fail a batch whose outputs hold NaN/inf instead of handing
        #: clients poisoned predictions
        self.nonfinite_guard = bool(nonfinite_guard)
        #: at most one batch-failure post-mortem per this many seconds
        #: (the scenario harness sets 0 to keep every one)
        self.postmortem_min_interval_s = float(postmortem_min_interval_s)
        self._last_batch_pm_s = -1e18
        self._models: Dict[str, ServedModel] = {}
        #: the ready residents, read without the lock by submit; only
        #: ever rebound whole under it (_publish_locked / close)
        self._live: Dict[str, ServedModel] = {}
        self._evicted: Dict[str, _EvictedModel] = {}
        self._warming = 0
        self._expected = 0
        self._admitted_total = 0
        self._fence_armed = False
        self._lock = TracedLock("serving.plane")
        #: one admission's device work at a time: a capture's launch
        #: count is the kernel launches made while it ran
        self._admit_lock = threading.Lock()
        self._stop = threading.Event()
        if workers is None:
            workers = int(os.environ.get("KEYSTONE_TORCH_SERVE_WORKERS",
                                         "1") or "1")
        self.workers = max(int(workers), 1)
        self._worker: Optional[threading.Thread] = None
        self._workers: List[threading.Thread] = []
        self._worker_tid = 0
        self._worker_name = "keystone-serving-worker"
        self._closed = False
        #: per-model phase histogram handles, resolved once per model and
        #: dropped with it; rebuilt when the registry instance changes
        self._phase_reg: Any = None
        self._phase_hists: Dict[str, Dict[str, Tuple[Any, Any]]] = {}
        #: (admission token, bucket) -> BucketGraph (CUDA only)
        self._graphs = LruMemo(GRAPHS_KEPT)
        if hbm_budget is not None:
            MetricsRegistry.get_or_create().gauge(
                "serving.hbm_budget_bytes").set(float(hbm_budget))

    @property
    def captures_graphs(self) -> bool:
        """True on a CUDA plane: every bucket is served from a graph."""
        return self.device.type == "cuda"

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "ServingPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self) -> "ServingPlane":
        """Start the batch workers (idempotent)."""
        with self._lock:
            if self._worker is None and not self._closed:
                self._stop = threading.Event()
                for i in range(self.workers):
                    self._workers.append(threading.Thread(
                        target=self._worker_loop, args=(i == 0,),
                        name=("keystone-serving-worker" if i == 0
                              else f"keystone-serving-worker-{i}"),
                        daemon=True))
                self._worker = self._workers[0]
                for t in self._workers:
                    t.start()
        return self

    def close(self) -> None:
        """Stop the workers, fail every queued request, disarm the
        steady-state fence and release the captured graphs."""
        with self._lock:
            self._closed = True
            # lock-free submitters now fall to the locked path, which
            # sees the batcher refuse
            self._live = {}
            workers, self._workers = list(self._workers), []
            self._worker = None
            self._stop.set()
            if self._fence_armed:
                self._fence_armed = False
                compile_observatory().disarm_fence()
        for worker in workers:
            worker.join(timeout=10.0)
        for req in self.batcher.close():
            if not req.future.done():
                req.future.set_exception(RuntimeError("serving plane closed"))
        if self._graphs.clear():
            self._release_pools()
        # the workers are gone: materialize what they deferred
        flight_recorder().flush()

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
        model cannot fit even after every allowed eviction, and a
        :class:`~.graphs.CaptureError` (after rolling back) when a
        bucket's apply cannot be captured."""
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
        # a Pipeline, so .apply binds a dataset; its operators are
        # shared with `working`, so the blob carries the weight type
        pipeline = working.to_pipeline()
        _apply_weight_dtype(pipeline.graph, wd)
        blob = canonical_dumps(working)
        pipeline = _without_cachers(pipeline)
        buckets = self.policy.rows()
        with self._admit_lock:
            charge = model_charge(pipeline, _zeros_batch(sample, 1),
                                  buckets[-1], self.device,
                                  graph_rows(self.policy, self.device))
        entry = ServedModel(name=name, fitted=pipeline, blob=blob,
                            sample=sample, charge=charge, buckets=buckets,
                            weight_dtype=wd,
                            baseline=_find_baseline(pipeline.graph))
        # before any change: an injected fault here refuses atomically
        inject("serve.admit", context=name)
        with self._lock:
            if self._closed:
                raise RuntimeError("serving plane closed")
            if name in self._models:
                raise ValueError(f"model {name!r} is already admitted")
            victims = self._plan_evictions_locked(charge.total_nbytes())
            dropped = []
            for victim in victims:
                gone = self._models.pop(victim)
                self.ledger.release(victim)
                self._evicted[victim] = _evicted_record(gone)
                self._phase_hists.pop(victim, None)
                dropped.append(gone.token)
            # the backstop: raises without a change if the plan was wrong
            self.ledger.admit(name, charge.total_nbytes())
            self._models[name] = entry
            # a readmitted name leaves the evicted set; kept aside so a
            # failed warmup can restore it
            prior_evicted = self._evicted.pop(name, None)
            self._warming += 1
            if self._fence_armed:
                # warmup captures are expected: the fence steps aside
                # until no warmup is in flight
                self._fence_armed = False
                compile_observatory().disarm_fence()
            self._publish_locked()
        for token in dropped:
            self._drop_graphs(token)
        try:
            t0 = time.perf_counter()
            with self._admit_lock:
                self._warm(entry)
            entry.warmup_s = time.perf_counter() - t0
        except BaseException:
            self._finish_warmup(entry, ok=False,
                                restore_evicted=prior_evicted)
            self._drop_graphs(entry.token)
            raise
        MetricsRegistry.get_or_create().histogram(
            "serving.warmup_s").observe(entry.warmup_s)
        self._finish_warmup(entry, ok=True)
        return entry

    def _finish_warmup(self, entry: ServedModel, ok: bool,
                       restore_evicted: Optional[_EvictedModel] = None
                       ) -> None:
        """Mark the model ready, or roll its registration back (restoring
        the evicted record a readmission popped), leave the warming count
        and re-arm the fence once no warmup is in flight: one lock
        hold."""
        with self._lock:
            if ok:
                entry.ready = True
                self._admitted_total += 1
            else:
                self._models.pop(entry.name, None)
                self.ledger.release(entry.name)
                self._phase_hists.pop(entry.name, None)
                if restore_evicted is not None:
                    self._evicted[entry.name] = restore_evicted
            self._warming -= 1
            self._sync_fence()
            self._publish_locked()

    def evict(self, name: str) -> None:
        """Evict a resident model; its canonical bytes stay on the host
        for :meth:`readmit`, its graphs are released. ``serve.evict``
        fires before any change, so a fault leaves the model serving."""
        inject("serve.evict", context=name)
        with self._lock:
            if name not in self._models:
                raise ModelNotAdmitted(f"model {name!r} is not resident")
            entry = self._models.pop(name)
            self.ledger.release(name)
            self._evicted[name] = _evicted_record(entry)
            self._phase_hists.pop(name, None)
            self._publish_locked()
        self._drop_graphs(entry.token)

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

    def _sync_fence(self) -> None:
        """Arm the steady-state fence exactly when no warmup is in
        flight. Lock held."""
        if not self.steady_fence or self._closed:
            return
        if self._warming == 0 and not self._fence_armed:
            compile_observatory().arm_fence("serving:steady-state")
            self._fence_armed = True

    def _publish_locked(self) -> None:
        """Rebind ``_live`` to a fresh dict of the ready residents (never
        changed in place: a lock-free reader sees the old dict or the
        new one) and update the gauges. Lock held."""
        self._live = {n: e for n, e in self._models.items() if e.ready}
        reg = MetricsRegistry.get_or_create()
        reg.gauge("serving.models_resident").set(len(self._live))
        reg.gauge("serving.models_warming").set(self._warming)

    # -- warmup and capture ------------------------------------------------
    def _warm(self, entry: ServedModel) -> None:
        """Every bucket: on CUDA applied once eagerly and captured, on
        the CPU applied once. Then one drift score checks that the
        baseline, if any, matches the request space. The numerics gauges
        stay untouched (a zero batch is not traffic)."""
        from ..observability.numerics import numerics_suppressed

        for bucket in entry.buckets:
            # a fault between buckets must roll the whole admission back
            inject("serve.admit", context=(entry.name, bucket))
            if self.captures_graphs:
                self._capture(entry, bucket, "admission")
            else:
                self._eager(entry, _zeros_batch(entry.sample, bucket),
                            bucket)
        if entry.baseline is not None:
            ds = bucketed_dataset(_zeros_batch(entry.sample, 1), 1, 1,
                                  self.device)
            try:
                with numerics_suppressed():
                    self._score_drift(entry, ds)
            except ValueError:
                self._disable_drift(entry)

    def _capture(self, entry: ServedModel, bucket: int,
                 trigger: str) -> BucketGraph:
        """Capture one bucket's apply, every row real, after one eager
        apply of the same static input on the capture stream, and keep
        it in the memo. Recorded by the observatory under ``trigger``."""
        static = pytree.tree_map(
            lambda s: torch.zeros((bucket,) + s.shape,
                                  dtype=torch.from_numpy(
                                      np.zeros((), s.dtype)).dtype,
                                  device=self.device),
            entry.sample, is_leaf=is_spec)
        with capture_lock():
            warm_apply(entry.fitted, static, bucket, self.device)
        site = f"serve:{entry.name}:{bucket}"
        with observed_capture(site, trigger) as stats:
            graph, out, launches = capture_apply(
                entry.fitted, static, bucket, self.device,
                f"bucket {bucket} of model {entry.name!r}")
            pool = graph_pool_nbytes(graph.pool(), self.device)
            stats.update({"bucket": bucket, "pool_nbytes": pool,
                          "launches": float(sum(launches.values()))})
        bg = BucketGraph(graph, static, out.data, bucket, launches, pool,
                         site)
        if self._graphs.put((entry.token, bucket), bg):
            self._release_pools()
        with self._lock:
            entry.captures += 1
            entry.capture_s += stats["wall_s"]
            entry.graph_pool_nbytes += pool
            live = self._models.get(entry.name) is entry
        if not live:
            # evicted while this capture ran: nothing may keep its graph
            self._drop_graphs(entry.token)
        return bg

    def _graph_for(self, entry: ServedModel, bucket: int) -> BucketGraph:
        """The captured graph of a bucket; a miss (a bucket never
        captured, or one the memo dropped) is captured now, and counted
        as unexpected once the fence is armed."""
        bg = self._graphs.get((entry.token, bucket))
        if bg is None:
            with self._admit_lock:
                bg = self._graphs.get((entry.token, bucket))
                if bg is None:
                    bg = self._capture(entry, bucket, "bucket_miss")
        return bg

    def _drop_graphs(self, token: int) -> None:
        """Release every graph of one admission."""
        if self._graphs.pop_where(lambda key: key[0] == token):
            self._release_pools()

    def _release_pools(self) -> None:
        """Give the pools of dropped graphs back to the device (called
        once the memo's reference is gone; a worker mid-replay keeps its
        graph alive until it returns, and that pool goes at the next
        release)."""
        if self.captures_graphs:
            with capture_lock():
                torch.cuda.empty_cache()

    # -- request path ------------------------------------------------------
    def submit(self, name: str, x: Any, timeout_s: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Queue one request; returns a Future of the model output for
        exactly the submitted rows. ``x`` is one item (the admitted
        sample's shape) or a batch of them, at most the largest bucket.
        A request still queued ``deadline_ms`` after submission is shed
        before dispatch (the future raises DeadlineExpiredError)."""
        return self.submit_request(name, x, timeout_s=timeout_s,
                                   deadline_ms=deadline_ms).future

    def submit_request(self, name: str, x: Any,
                       timeout_s: Optional[float] = None,
                       deadline_ms: Optional[float] = None) -> Request:
        """:meth:`submit`, returning the whole request (``request.trace``
        carries its trace id and phase stamps)."""
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
        return self.batcher.submit_request(name, x_tree, n,
                                           timeout_s=timeout_s,
                                           deadline_ms=deadline_ms)

    def predict(self, name: str, x: Any, timeout_s: float = 60.0,
                deadline_ms: Optional[float] = None):
        """Submit and wait."""
        return self.submit(name, x, deadline_ms=deadline_ms).result(
            timeout=timeout_s)

    def predict_traced(self, name: str, x: Any, timeout_s: float = 60.0,
                       deadline_ms: Optional[float] = None):
        """:meth:`predict`, returning ``(output, trace_id)``; the trace id
        is ``""`` when tracing is off (the HTTP handler serves it as the
        ``X-Keystone-Trace`` header)."""
        req = self.submit_request(name, x, deadline_ms=deadline_ms)
        out = req.future.result(timeout=timeout_s)
        return out, ("" if req.trace is None else req.trace.trace_id)

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
    def _execute(self, entry: ServedModel, x_tree: Any, n: int
                 ) -> Tuple[Any, int]:
        """One padded-bucket apply; returns the outputs for exactly n
        rows (host numpy) and the bucket. A CUDA plane replays the
        bucket's graph, a CPU plane applies eagerly."""
        bucket = self.policy.bucket_for(max(n, 1))
        if not self.captures_graphs:
            return self._eager(entry, x_tree, n), bucket
        return self._graph_for(entry, bucket).replay(x_tree, n), bucket

    def _eager(self, entry: ServedModel, x_tree: Any, n: int) -> Any:
        """Stage a padded bucket and apply the model eagerly (the CPU
        path; on CUDA the parity reference of a replay)."""
        ds = bucketed_dataset(x_tree, n, self.policy.bucket_for(max(n, 1)),
                              self.device)
        return entry.fitted.apply(ds).get().numpy()

    def _score_drift(self, entry: ServedModel, ds: Any) -> None:
        from ..observability.numerics import score_drift

        score_drift(entry.baseline, ds)

    def _disable_drift(self, entry: ServedModel) -> None:
        from ..observability.numerics import record_numerics_event

        entry.drift_disabled = True
        entry.baseline = None
        record_numerics_event(
            "drift_unscorable", model=entry.name,
            reason="request space is not the sketched feature space "
                   "(the baseline rides an upstream stage)")

    def _phase_instruments(self, name: str) -> Dict[str, Tuple[Any, Any]]:
        """``phase -> (aggregate, per-model)`` histogram pairs for one
        model, resolved once; dropped with the model, and all dropped
        when the registry instance changes (tests reset it)."""
        reg = MetricsRegistry.get_or_create()
        if reg is not self._phase_reg:
            self._phase_reg = reg
            self._phase_hists = {}
        pairs = self._phase_hists.get(name)
        if pairs is None:
            pairs = {ph: (reg.histogram(f"serving.phase_ms.{ph}"),
                          reg.histogram(f"serving.phase_ms.{ph}.{name}"))
                     for ph in PHASES}
            self._phase_hists[name] = pairs
        return pairs

    # -- the workers -------------------------------------------------------
    def _worker_loop(self, primary: bool = True) -> None:
        if primary:
            t = threading.current_thread()
            self._worker_tid = t.ident or 0
            self._worker_name = t.name
        max_rows = self.policy.max_rows()
        while not self._stop.is_set():
            batch = self.batcher.take(max_rows, timeout_s=0.05)
            if batch:
                self._serve_batch(batch)
            else:
                # idle: materialize the deferred telemetry
                flight_recorder().flush()

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
            # a corrupt rule poisons the merged batch where a bad client
            # payload or a host memory flip would land
            merged = corrupt("serve.dispatch", merged, context=name)
            # abort= ends a hang injection at shutdown
            inject("serve.dispatch", context=name, abort=self._stop.is_set)
            t0 = time.perf_counter()
            outputs, bucket = self._execute(entry, merged, rows)
            t_done = time.perf_counter()
            if self.nonfinite_guard:
                bad = _count_nonfinite(outputs)
                if bad:
                    raise PoisonedBatchError(
                        f"batch for {name!r} produced {bad} non-finite "
                        f"output value(s) over {rows} rows — failing this "
                        "batch's requests; the worker goes on")
            fill = rows / float(bucket)
            offset = 0
            for req in requests:
                out_i = self._slice_rows(outputs, offset, req.n)
                offset += req.n
                tr = req.trace
                if tr is not None:
                    # every stamp before the future resolves: a trace
                    # the submitter can see is immutable
                    tr.dispatch_s = t0
                    tr.done_s = t_done
                    tr.bucket = bucket
                    tr.fill = fill
                    tr.responded_s = time.perf_counter()
                req.future.set_result(out_i)
            now = time.perf_counter()
            reg.counter("serving.requests_total").inc(len(requests))
            reg.counter("serving.rows_total").inc(rows)
            reg.counter("serving.batches_total").inc()
            reg.histogram("serving.batch_ms").observe((t_done - t0) * 1e3)
            reg.histogram("serving.batch_fill").observe(fill)
            reg.histogram(f"serving.batch_fill.{name}").observe(fill)
            traced = []
            for req in requests:
                tr = req.trace
                if tr is not None and tr.complete():
                    traced.append(tr)
                    wait_ms = tr.request_ms()
                else:
                    wait_ms = (now - req.enqueued_s) * 1e3
                reg.histogram("serving.request_ms").observe(wait_ms)
                reg.histogram(f"serving.request_ms.{name}").observe(wait_ms)
                # queued time, enqueue to the start of the merge
                qwait_s = max(t_merge - req.enqueued_s, 0.0)
                reg.histogram("serving.queue_wait_s").observe(qwait_s)
                reg.histogram(f"serving.queue_wait_s.{name}").observe(
                    qwait_s)
                self.slo.record(name, wait_ms)
            if traced:
                self._record_batch_trace(name, traced, t_merge, bucket,
                                         fill)
            with self._lock:
                entry.note_served(rows, len(requests), now)
                score_now = (not entry.drift_disabled
                             and entry.baseline is not None
                             and entry.batches % self.drift_every == 0)
            if score_now:
                # after the futures resolved: drift work adds no request
                # latency (a batch-level phase)
                t_drift = time.perf_counter()
                ds = bucketed_dataset(merged, rows, bucket, self.device)
                try:
                    self._score_drift(entry, ds)
                except ValueError:
                    self._disable_drift(entry)
                reg.histogram("serving.phase_ms.drift_score").observe(
                    (time.perf_counter() - t_drift) * 1e3)
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
                self.slo.record(req.model, None, ok=False)
        reg.counter("serving.deadline_expired_total").inc(len(shed))
        reg.counter("serving.shed_total").inc(len(shed))
        return live

    def _fail_batch(self, requests: List[Request], exc: BaseException,
                    reg: MetricsRegistry) -> None:
        """Count the failure, attach one throttled post-mortem (not for a
        routing verdict), and fail every future not yet resolved,
        recording one SLO outcome for each request failed here."""
        name = requests[0].model
        reg.counter("serving.errors_total").inc()
        if isinstance(exc, PoisonedBatchError):
            reg.counter("serving.poisoned_batches_total").inc()
        if not isinstance(exc, (ModelNotAdmitted, ModelWarming)):
            now = time.perf_counter()
            if now - self._last_batch_pm_s >= self.postmortem_min_interval_s:
                self._last_batch_pm_s = now
                from ..observability.postmortem import attach_postmortem

                attach_postmortem(exc, "serving_batch_failure", context={
                    "model": name,
                    "requests": len(requests),
                    "rows": sum(r.n for r in requests),
                    "error": f"{type(exc).__name__}: {exc}",
                })
        for req in requests:
            if not req.future.done():
                req.future.set_exception(exc)
                self.slo.record(name, None, ok=False)

    def _record_batch_trace(self, name: str, traces: List[Any],
                            start_s: float, bucket: int,
                            fill: float) -> None:
        """One ``request:`` span per completed member and the ``batch:``
        span they rode, linked by flow ids; the traces also feed the
        exemplar reservoir and the phase histograms. All of it runs at
        the recorder's next flush (one deferred thunk); with the
        recorder off, the reservoir and histograms are fed inline."""
        rec = flight_recorder()
        batch_id = mint_flow_id()
        if self.workers > 1:
            wt = threading.current_thread()
            tid, thread = wt.ident or 0, wt.name
        else:
            tid, thread = self._worker_tid, self._worker_name
        if rec.enabled:
            members = tuple(traces)
            rec.defer(lambda: self._materialize_batch_telemetry(
                rec, name, members, start_s, bucket, fill, batch_id, tid,
                thread))
        else:
            reservoir = exemplar_reservoir()
            for tr in traces:
                tr.batch_id = batch_id
                reservoir.offer(tr)
            self._observe_phases(name, traces)

    def _observe_phases(self, name: str, traces: Any) -> None:
        pairs = self._phase_instruments(name)
        for tr in traces:
            for phase, ms in tr.phases_ms().items():
                agg, per_model = pairs[phase]
                agg.observe(ms)
                per_model.observe(ms)

    def _materialize_batch_telemetry(self, rec: Any, name: str,
                                     traces: tuple, start_s: float,
                                     bucket: int, fill: float,
                                     batch_id: int, tid: int,
                                     thread: str) -> None:
        """The deferred half of :meth:`_record_batch_trace`."""
        reservoir = exemplar_reservoir()
        for tr in traces:
            tr.batch_id = batch_id
            reservoir.offer(tr)
        self._observe_phases(name, traces)
        end_s = start_s
        req_span = "request:" + name
        for tr in traces:
            end_s = max(end_s, tr.responded_s)
            rec.record(req_span, "serving", tr.enqueued_s,
                       tr.responded_s - tr.enqueued_s,
                       args={"trace_id": tr.trace_id, "n": tr.n,
                             "batch": batch_id, "flow_out": tr.flow_id,
                             "phases_ms": tr.phases_ms()},
                       tid=tid, thread=thread)
        rec.record("batch:" + name, "serving", start_s, end_s - start_s,
                   args={"batch": batch_id, "bucket": bucket,
                         "fill": round(fill, 4), "requests": len(traces),
                         "flow_in": [tr.flow_id for tr in traces]},
                   tid=tid, thread=thread)

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
            "graphs": len(self._graphs),
            "models": sorted(models, key=lambda m: m["name"]),
            "evicted": evicted,
        }

    def unexpected_recompiles(self) -> float:
        """The ``compile.unexpected_total`` counter: with the steady-state
        fence armed, any rise across a serving window is a capture that
        should have happened at admission."""
        return MetricsRegistry.get_or_create().counter(
            "compile.unexpected_total").value
