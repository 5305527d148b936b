"""The fleet controller: canonical blobs, verified migration, death
recovery, and the reactor that scales on measured telemetry.

Counterpart of ``keystone_tpu/serving/fleet.py``. The controller owns
the fleet's model bytes. Each model is registered once and
canonicalized exactly as a plane's ``admit`` would (pickle round trip,
``to_pipeline``, the weight type applied, pickle again), so a replica
admitting the shipped blob reproduces it bit for bit; it is stamped
with its sha256 and its admission charge (``serving/residency.py``,
the charge the replicas' planes take, captured graphs included on
CUDA). Placement is a pure solve (:func:`~.placement.plan_placement`)
over those demands and the replicas' budgets, and every change to the
fleet is the difference between the live placement and a fresh solve,
applied in the one safe order:

    admit on the target -> VERIFY (the replica's sha256 equals the
    canonical one; a mismatch aborts with the model still live on the
    source) -> evict on the source.

Capacity is briefly charged twice during a migration, never zero
times, and bytes never take a lossy hop.

**Death** uses the same machinery: a failed health probe removes the
replica from the router (its models re-route to surviving copies, or
refuse with 503), counts ``fleet.replica_deaths_total`` and re-solves
over the survivors, re-admitting the lost models from canonical bytes,
verified the same way.

**Autoscaling** (:class:`FleetAutoscaler`) reacts to measured serving
telemetry: sustained queue depth across the fleet scales up through a
caller-supplied provisioner; a fleet idle for long enough drains its
highest-numbered replica (migrate off, verify, retire). ``tick()`` is
synchronous and deterministic given what it reads; ``run_reactor`` is
the wall-clock thread around it.
"""
from __future__ import annotations

import pickle
import threading
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from ..observability.metrics import MetricsRegistry
from ..ops.device import DEFAULT_DEVICE, resolve_device
from .batcher import BucketPolicy
from .models import _apply_weight_dtype, _zeros_batch, canonical_dumps
from .placement import ModelDemand, Placement, plan_placement
from .plane import ServingPlane, _without_cachers, graph_rows
from .residency import measure_graph_pools, model_charge
from .router import FleetRouter


class FleetError(RuntimeError):
    """A fleet mutation failed loudly (sha mismatch, missing replica,
    refused admission) — the fleet never papers over a failed step."""


@dataclass(frozen=True)
class FleetModel:
    """One registered model: canonical bytes + placement demand."""

    name: str
    blob: bytes
    sample: Any
    weight_dtype: Optional[str]
    sha256: str
    charge_nbytes: float
    qps: float = 0.0
    warmup_s: float = 0.0

    def demand(self) -> ModelDemand:
        return ModelDemand(name=self.name,
                           charge_nbytes=self.charge_nbytes,
                           qps=self.qps, warmup_s=self.warmup_s)


def canonicalize(fitted: Any, sample: Any,
                 weight_dtype: Optional[str],
                 bucket_rows: int = 64,
                 device=DEFAULT_DEVICE) -> Tuple[bytes, float]:
    """Mint the canonical blob and the admission charge of ``fitted``:
    the byte-producing steps of ``ServingPlane.admit``, run once by the
    controller, so every replica's blob is checked against one sha256.
    The charge is the one a plane on ``device`` with a largest bucket
    of ``bucket_rows`` takes: the static plan's, plus on CUDA its
    graphs' pools, which the controller measures from captures of its
    own (``residency.measure_graph_pools``), and their static inputs."""
    dev = resolve_device(device)
    working = pickle.loads(pickle.dumps(fitted))
    pipeline = working.to_pipeline()
    _apply_weight_dtype(pipeline.graph, weight_dtype)
    blob = canonical_dumps(working)
    spec = ServingPlane._as_sample_spec(sample)
    policy = BucketPolicy(bucket_rows)
    served = _without_cachers(pipeline)
    item = _zeros_batch(spec, 1)
    pools = measure_graph_pools(served, item, graph_rows(policy, dev), dev)
    charge = model_charge(served, item, policy.max_rows(), device=dev,
                          graph_pools=pools)
    return blob, charge.total_nbytes()


class FleetController:
    """See the module docstring. ``budgets`` maps replica id -> device
    memory budget in bytes (None: unbounded); the replicas are the
    router's clients, and the controller addresses them only through
    the router's membership, so the two cannot disagree about who is in
    the fleet. ``device`` is where the replicas serve: it decides the
    charge (:func:`canonicalize`)."""

    def __init__(self, router: FleetRouter,
                 budgets: Optional[Mapping[str, Optional[float]]] = None,
                 bucket_rows: int = 64, device=DEFAULT_DEVICE):
        self.router = router
        self.bucket_rows = int(bucket_rows)
        self.device = resolve_device(device)
        self._budgets: Dict[str, Optional[float]] = dict(budgets or {})
        self._models: Dict[str, FleetModel] = {}
        self._placement = Placement()
        # cold-path mutual exclusion (register/rebalance/death); the
        # request path never takes this lock
        self._lock = threading.RLock()

    # -- registration -------------------------------------------------------
    def register(self, name: str, fitted: Any, sample: Any,
                 weight_dtype: Optional[str] = None,
                 qps: float = 0.0, warmup_s: float = 0.0) -> FleetModel:
        """Canonicalize and register a model with the fleet. Placement
        happens on the next :meth:`rebalance` — registration is pure
        bookkeeping."""
        import hashlib

        blob, charge = canonicalize(fitted, sample, weight_dtype,
                                    self.bucket_rows, self.device)
        model = FleetModel(
            name=name, blob=blob, sample=sample,
            weight_dtype=weight_dtype,
            sha256=hashlib.sha256(blob).hexdigest(),
            charge_nbytes=charge, qps=float(qps),
            warmup_s=float(warmup_s))
        with self._lock:
            if name in self._models:
                raise ValueError(
                    f"model {name!r} is already registered")
            self._models[name] = model
        return model

    def note_demand(self, name: str, qps: Optional[float] = None,
                    warmup_s: Optional[float] = None) -> None:
        """Fold observed demand (scraped QPS, measured warmup wall)
        into a model's placement inputs — the signal the next
        rebalance replicates hot models with."""
        with self._lock:
            model = self._models[name]
            self._models[name] = replace(
                model,
                qps=model.qps if qps is None else float(qps),
                warmup_s=(model.warmup_s if warmup_s is None
                          else float(warmup_s)))

    def set_budget(self, replica_id: str,
                   budget: Optional[float]) -> None:
        with self._lock:
            self._budgets[replica_id] = budget

    @property
    def placement(self) -> Placement:
        return self._placement

    # -- solve + apply ------------------------------------------------------
    def _live_budgets(self) -> Dict[str, Optional[float]]:
        live = self.router.replica_ids()
        return {rid: self._budgets.get(rid) for rid in live}

    def solve(self) -> Placement:
        """A fresh placement over the LIVE replicas — pure, applies
        nothing."""
        with self._lock:
            demands = [m.demand() for m in self._models.values()]
            return plan_placement(demands, self._live_budgets())

    def rebalance(self) -> List[Tuple[str, str, str]]:
        """Solve, diff against the live placement, apply (admit ->
        verify -> evict), republish the routing table. Returns the
        applied steps. One failed step raises :class:`FleetError` with
        everything already applied left in place — re-running
        ``rebalance`` resumes from the surviving state."""
        with self._lock:
            target = self.solve()
            steps = self._placement.diff(target)
            for kind, name, replica_id in steps:
                if kind == "admit":
                    self._admit_step(name, replica_id)
                else:
                    self._evict_step(name, replica_id)
            self._placement = target
        self.router.refresh()
        if steps:
            MetricsRegistry.get_or_create().counter(
                "router.rebalance_total").inc()
        return steps

    def _admit_step(self, name: str, replica_id: str) -> None:
        model = self._models[name]
        try:
            client = self.router.client(replica_id)
        except KeyError:
            raise FleetError(
                f"admit {name!r}: replica {replica_id!r} is not in "
                "the fleet") from None
        got = client.admit_blob(model.name, model.blob, model.sample,
                                model.weight_dtype)
        if got != model.sha256:
            # the replica holds DIFFERENT bytes than the canon — evict
            # the impostor copy before anything routes to it
            try:
                client.evict(name)
            finally:
                raise FleetError(
                    f"migration of {name!r} to {replica_id!r} is not "
                    f"bit-identical: canonical sha256 {model.sha256} "
                    f"!= admitted {got} — aborted with the source "
                    "copy still live")

    def _evict_step(self, name: str, replica_id: str) -> None:
        try:
            client = self.router.client(replica_id)
        except KeyError:
            return  # the source died mid-migration: nothing to evict
        client.evict(name)

    # -- membership ---------------------------------------------------------
    def add_replica(self, client: Any,
                    budget: Optional[float] = None) -> None:
        """Scale-up: join a replica (fresh and empty) to the fleet and
        rebalance onto it."""
        with self._lock:
            self._budgets[client.replica_id] = budget
        self.router.add_replica(client)
        self.rebalance()

    def drain_replica(self, replica_id: str) -> None:
        """Scale-down, the safe order: re-solve WITHOUT the victim,
        migrate its models off (admit->verify->evict), then retire it.
        The victim serves until its last model leaves."""
        with self._lock:
            budgets = self._live_budgets()
            if replica_id not in budgets:
                raise FleetError(
                    f"drain: replica {replica_id!r} is not live")
            if len(budgets) == 1:
                raise FleetError(
                    "drain refused: cannot retire the last replica")
            del budgets[replica_id]
            demands = [m.demand() for m in self._models.values()]
            target = plan_placement(demands, budgets)
            for kind, name, rid in self._placement.diff(target):
                if kind == "admit":
                    self._admit_step(name, rid)
                else:
                    self._evict_step(name, rid)
            self._placement = target
            self._budgets.pop(replica_id, None)
        self.router.remove_replica(replica_id)
        MetricsRegistry.get_or_create().counter(
            "router.rebalance_total").inc()

    def handle_death(self, replica_id: str) -> List[Tuple[str, str, str]]:
        """A replica stopped answering: remove it, count it, re-solve
        over the survivors, re-admit the lost models from canonical
        bytes (verified — recovery is a migration, not a guess)."""
        MetricsRegistry.get_or_create().counter(
            "fleet.replica_deaths_total").inc()
        self.router.remove_replica(replica_id)
        with self._lock:
            self._budgets.pop(replica_id, None)
            # forget the dead copies so the diff re-admits elsewhere
            # instead of trying to evict from a corpse
            survivors = {
                m: tuple(r for r in reps if r != replica_id)
                for m, reps in self._placement.assignments.items()}
            self._placement = Placement(
                assignments={m: reps for m, reps in survivors.items()
                             if reps},
                loads={r: v for r, v in self._placement.loads.items()
                       if r != replica_id})
        return self.rebalance()

    def probe(self) -> List[str]:
        """Health-check every fleet replica; dead ones go through
        :meth:`handle_death`. Returns the ids that died."""
        dead = []
        for rid in self.router.replica_ids():
            try:
                verdict = self.router.client(rid).probe()
            except KeyError:
                continue
            if verdict == "dead":
                dead.append(rid)
        for rid in dead:
            self.handle_death(rid)
        return dead

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "models": sorted(self._models),
                "budgets": dict(self._budgets),
                "placement": {m: list(reps) for m, reps in
                              sorted(self._placement.assignments.items())},
            }


class FleetAutoscaler:
    """The reactor: every tick probes for deaths and turns measured
    congestion into membership changes. ``provisioner`` is a zero-arg
    callable returning a fresh (empty) replica client: how a new replica
    comes to exist is the deployment's business (a subprocess, or a
    plane in process); whether one should exist is the reactor's, and it
    decides only from what it reads of the replicas."""

    def __init__(self, controller: FleetController,
                 provisioner: Optional[Callable[[], Any]] = None,
                 replica_budget: Optional[float] = None,
                 scale_up_queue_depth: int = 32,
                 scale_down_queue_depth: int = 2,
                 min_replicas: int = 1,
                 max_replicas: int = 8,
                 sustain_ticks: int = 3):
        self.controller = controller
        self.provisioner = provisioner
        self.replica_budget = replica_budget
        self.scale_up_queue_depth = int(scale_up_queue_depth)
        self.scale_down_queue_depth = int(scale_down_queue_depth)
        self.min_replicas = max(int(min_replicas), 1)
        self.max_replicas = int(max_replicas)
        #: consecutive ticks a signal must hold before acting — one
        #: bursty scrape must not flap the fleet
        self.sustain_ticks = max(int(sustain_ticks), 1)
        self._hot_ticks = 0
        self._idle_ticks = 0

    def _depths(self) -> Dict[str, int]:
        router = self.controller.router
        depths = {}
        for rid in router.replica_ids():
            try:
                depths[rid] = router.client(rid).queue_depth()
            except (KeyError, ConnectionError, OSError):
                continue
        return depths

    def tick(self) -> Optional[str]:
        """One reactor step; returns the action taken (``"death"``,
        ``"scale_up"``, ``"scale_down"``, ``"rebalance"``) or None."""
        if self.controller.probe():
            self._hot_ticks = self._idle_ticks = 0
            return "death"
        depths = self._depths()
        n = len(depths)
        if not depths:
            return None
        mean_depth = sum(depths.values()) / n
        if mean_depth >= self.scale_up_queue_depth:
            self._hot_ticks += 1
            self._idle_ticks = 0
        elif max(depths.values()) <= self.scale_down_queue_depth:
            self._idle_ticks += 1
            self._hot_ticks = 0
        else:
            self._hot_ticks = self._idle_ticks = 0
        if (self._hot_ticks >= self.sustain_ticks
                and self.provisioner is not None
                and n < self.max_replicas):
            self._hot_ticks = 0
            self.controller.add_replica(self.provisioner(),
                                        budget=self.replica_budget)
            return "scale_up"
        if (self._idle_ticks >= self.sustain_ticks
                and n > self.min_replicas):
            self._idle_ticks = 0
            victim = max(self.controller.router.replica_ids())
            self.controller.drain_replica(victim)
            return "scale_down"
        # demand drift without membership change: apply any pending
        # replication the latest note_demand() calls justify
        with self.controller._lock:
            pending = self.controller._placement.diff(
                self.controller.solve())
        if pending:
            self.controller.rebalance()
            return "rebalance"
        return None


def run_reactor(autoscaler: FleetAutoscaler,
                stop: threading.Event,
                interval_s: float = 1.0) -> threading.Thread:
    """The wall-clock wrapper: tick until ``stop`` is set. Daemon
    thread — join it via the returned handle after setting ``stop``."""

    def loop():
        while not stop.wait(interval_s):
            try:
                autoscaler.tick()
            except FleetError:
                # a failed step leaves applied work in place; the next
                # tick re-solves from the surviving state
                continue

    t = threading.Thread(target=loop, name="keystone-fleet-reactor",
                         daemon=True)
    t.start()
    return t
