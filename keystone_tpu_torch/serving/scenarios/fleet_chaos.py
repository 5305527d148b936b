"""Fleet chaos: ``replica_death`` and ``migration_under_load``.

Both scenarios bring their own substrate (``Scenario.run_fn``): N
in-process serving planes, each behind a real HTTP replica server
(predict and admin surfaces), fronted by the real-HTTP fleet router:
requests travel loadgen -> router socket -> replica socket -> plane,
the wire path of a deployment, inside one process.

``replica_death`` — the death drill: mid-replay, the replica
hosting the routing table's models is killed COLD (server down, plane
closed, no drain), the reactor's next probe notices, counts
``fleet.replica_deaths_total``, re-solves placement over the
survivors, and re-admits the lost models from the controller's
canonical bytes (sha-verified). The floors assert the p99 spike stays
bounded and the availability dip stays classified: every request that
died with the replica ends as a counted 503/429/error verdict — zero
unclassified damage.

``migration_under_load`` — the placement churn drill: while traffic
flows, the controller learns one model went hot (``note_demand``),
rebalances (replicating it — admission under live load), then DRAINS a
replica (admit on target -> sha verify -> evict on source, capacity
double-charged never zero-charged) and scales back up. The checks
assert the moves actually happened (``router.rebalance_total``
advanced), every migrated copy was bit-identical (any sha mismatch
raises and fails the run), and the fleet still answers for every model
afterwards.

Both scenarios assert the shared catalogue invariants through the
standard harness epilogue — floors, clean-or-classified, chaos.*
counters, post-mortem on violation.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from ...observability.metrics import MetricsRegistry
from ...observability.slo import SloPolicy
from ..loadgen import (HttpServingClient, LoadSpec, LoadTrace,
                       ReplayReport, replay)
from . import (MAX_BATCH, MODEL_D, Floors, Scenario, ScenarioResult,
               _fit_catalogue_model, _input_for, register)

#: the fleet scenarios' model family: three names, one hot
_MODELS = ("hot", "warm", "cold")


def _build_fleet(scenario: Scenario, seed: int, n_replicas: int,
                 hot_qps: float, device: Any):
    """N planes, each behind a real-HTTP replica server, fronted by
    the real-HTTP router; models registered with the controller and
    placed via the solver under FINITE per-replica budgets (sized to
    ~3.3 model charges, so replication is an earned placement decision
    with real scarcity, not an unbounded spray). Returns everything
    teardown needs."""
    from ..fleet import FleetController
    from ..plane import ServingPlane
    from ..replica import serve_replica
    from ..router import FleetRouter, HttpReplicaClient, serve_router

    planes, servers, clients = [], [], []
    for i in range(n_replicas):
        plane = ServingPlane(
            max_batch=MAX_BATCH, queue_depth=scenario.queue_depth,
            slo_policy=SloPolicy(
                latency_threshold_ms=scenario.floors.p99_ms,
                availability_target=0.5, window=256, min_count=64),
            postmortem_min_interval_s=0.0, device=device)
        plane.start()
        server = serve_replica(plane)
        planes.append(plane)
        servers.append(server)
        clients.append(HttpReplicaClient(
            f"r{i}", "127.0.0.1", server.server_port,
            stats_ttl_s=0.05))
    router = FleetRouter(clients, spill_queue_depth=max(
        scenario.queue_depth // 2, 4))
    controller = FleetController(router, device=device)
    fitted = _fit_catalogue_model(seed, device)
    sample = np.zeros((MODEL_D,), np.float32)
    hot = controller.register("hot", fitted, sample, qps=hot_qps,
                              warmup_s=1.0)
    controller.register("warm", fitted, sample, qps=60.0, warmup_s=0.5)
    controller.register("cold", fitted, sample)
    for client in clients:
        controller.set_budget(client.replica_id,
                              3.3 * hot.charge_nbytes)
    controller.rebalance()
    router_server = serve_router(router)
    return planes, servers, clients, router, controller, router_server


def _teardown(planes, servers, router_server) -> None:
    # the scenario may have already killed a server/plane mid-run:
    # a second shutdown/close is allowed to find a corpse
    router_server.shutdown()
    for server in servers:
        try:
            server.shutdown()
        except (OSError, RuntimeError):
            pass
    for plane in planes:
        try:
            plane.close()
        except (OSError, RuntimeError):
            pass


def _probe_all(router, violations: List[str], label: str) -> None:
    """Every registered model must still answer through the router —
    the fleet's zero-wedged-workers invariant."""
    payload = json.dumps(
        {"instances": [[0.5] * MODEL_D]}).encode()
    for model in _MODELS:
        try:
            status, body, _ = router.predict_raw(model, payload)
        except BaseException as exc:
            violations.append(
                f"{label}: post-chaos probe for {model!r} raised "
                f"{type(exc).__name__}: {exc}")
            continue
        if status != 200:
            violations.append(
                f"{label}: post-chaos probe for {model!r} answered "
                f"{status}: {body[:120].decode(errors='replace')}")


def _replay_http(scenario: Scenario, trace: LoadTrace, port: int,
                 time_scale: float) -> ReplayReport:
    client = HttpServingClient("127.0.0.1", port)
    return replay(trace, client, _input_for,
                  senders=scenario.senders, time_scale=time_scale,
                  submit_timeout_s=scenario.submit_timeout_s)


# -- replica_death -----------------------------------------------------------

def _run_replica_death(scenario: Scenario, trace: LoadTrace, seed: int,
                       time_scale: float, violations: List[str],
                       device: Any) -> Tuple[ReplayReport, int]:
    from ..fleet import FleetAutoscaler

    reg = MetricsRegistry.get_or_create()
    deaths_before = reg.counter("fleet.replica_deaths_total").value
    built = _build_fleet(scenario, seed, n_replicas=3, hot_qps=800.0,
                         device=device)
    planes, servers, clients, router, controller, router_server = built
    autoscaler = FleetAutoscaler(controller, sustain_ticks=10**6)
    half_s = trace.spec.duration_s * time_scale * 0.5
    killed: Dict[str, Any] = {}

    def killer():
        time.sleep(half_s)
        # kill whichever replica hosts the MOST models: maximal
        # redistribution, no drain, no goodbye
        placement = controller.placement
        count: Dict[str, int] = {}
        for reps in placement.assignments.values():
            for rid in reps:
                count[rid] = count.get(rid, 0) + 1
        victim = max(sorted(count), key=lambda r: count[r])
        idx = clients.index(next(c for c in clients
                                 if c.replica_id == victim))
        servers[idx].shutdown()
        planes[idx].close()
        killed["victim"] = victim
        killed["models"] = count[victim]
        # the reactor's probe tick is the recovery path under test
        try:
            killed["action"] = autoscaler.tick()
        except BaseException as exc:
            violations.append(
                f"replica_death: recovery raised "
                f"{type(exc).__name__}: {exc}")

    thread = threading.Thread(target=killer, daemon=True,
                              name="chaos-replica-killer")
    thread.start()
    try:
        report = _replay_http(scenario, trace,
                              router_server.server_port, time_scale)
        thread.join(timeout=30.0)
        if killed.get("action") != "death":
            violations.append(
                "replica_death: the reactor tick did not classify the "
                f"kill as a death (got {killed.get('action')!r})")
        deaths = reg.counter("fleet.replica_deaths_total").value \
            - deaths_before
        if deaths != 1:
            violations.append(
                f"replica_death: expected exactly 1 counted death, "
                f"got {deaths:g}")
        victim = killed.get("victim")
        if victim is not None and victim in router.replica_ids():
            violations.append(
                f"replica_death: dead replica {victim!r} still in the "
                "routing membership")
        table = router.state()["models"]
        missing = [m for m in _MODELS if not table.get(m)]
        if missing:
            violations.append(
                f"replica_death: models {missing} unroutable after "
                "recovery — redistribution incomplete")
        _probe_all(router, violations, "replica_death")
    finally:
        _teardown(planes, servers, router_server)
    return report, 1  # one injected fault: the kill


def _check_replica_death(result: ScenarioResult) -> List[str]:
    out: List[str] = []
    # the dip must be CLASSIFIED: whatever the kill cost shows up as
    # counted rejected/error verdicts, never unclassified (the harness
    # already asserts unclassified == 0; here we assert the run
    # actually went THROUGH the outage rather than around it)
    if result.report.outcomes["ok"] == 0:
        out.append("replica_death: no request succeeded — the fleet "
                   "never served")
    return out


register(Scenario(
    name="replica_death",
    describe="kill the busiest of 3 replicas cold mid-replay; the "
             "reactor must notice, re-place its models from canonical "
             "bytes (sha-verified), and keep every refusal classified",
    floors=Floors(p99_ms=400.0, availability=0.90),
    spec_fn=lambda seed: LoadSpec(
        seed=900 + seed, duration_s=2.4, rate_rps=90.0,
        arrival="poisson", models=_MODELS, zipf_s=1.2,
        sizes=(1, 2, 4)),
    check=_check_replica_death,
    queue_depth=64,
    submit_timeout_s=0.25,
    senders=6,
    run_fn=_run_replica_death,
))


# -- migration_under_load ----------------------------------------------------

def _run_migration(scenario: Scenario, trace: LoadTrace, seed: int,
                   time_scale: float, violations: List[str],
                   device: Any) -> Tuple[ReplayReport, int]:
    reg = MetricsRegistry.get_or_create()
    moves_before = reg.counter("router.rebalance_total").value
    # "hot" starts COLD (qps 0): the copy it gains mid-run must be
    # bought by the note_demand signal, not by initial placement
    built = _build_fleet(scenario, seed, n_replicas=2, hot_qps=0.0,
                         device=device)
    planes, servers, clients, router, controller, router_server = built
    window_s = trace.spec.duration_s * time_scale
    done: Dict[str, Any] = {}

    def migrator():
        try:
            # 1/3 in: "hot" got hotter — rebalance replicates it onto
            # the second replica (admission + sha verify under load)
            time.sleep(window_s / 3.0)
            controller.note_demand("hot", qps=5000.0, warmup_s=2.0)
            controller.rebalance()
            done["replicated"] = len(
                controller.placement.replicas_for("hot"))
            # 2/3 in: drain r1 — every model it hosts migrates to r0
            # (admit -> verify -> evict), then r1 leaves the fleet
            time.sleep(window_s / 3.0)
            controller.drain_replica("r1")
            done["drained"] = True
        except BaseException as exc:
            violations.append(
                f"migration_under_load: {type(exc).__name__}: {exc}")

    thread = threading.Thread(target=migrator, daemon=True,
                              name="chaos-migrator")
    thread.start()
    try:
        report = _replay_http(scenario, trace,
                              router_server.server_port, time_scale)
        thread.join(timeout=30.0)
        if done.get("replicated", 0) < 2:
            violations.append(
                "migration_under_load: the hot model did not gain a "
                f"copy (copies: {done.get('replicated')})")
        if not done.get("drained"):
            violations.append(
                "migration_under_load: the drain never completed")
        if "r1" in router.replica_ids():
            violations.append(
                "migration_under_load: drained replica r1 is still "
                "in the fleet")
        moves = reg.counter("router.rebalance_total").value \
            - moves_before
        if moves < 2:
            violations.append(
                f"migration_under_load: expected >= 2 counted "
                f"rebalances (replicate + drain), got {moves:g}")
        table = router.state()["models"]
        missing = [m for m in _MODELS if not table.get(m)]
        if missing:
            violations.append(
                f"migration_under_load: models {missing} unroutable "
                "after the drain")
        _probe_all(router, violations, "migration_under_load")
    finally:
        _teardown(planes, servers, router_server)
    return report, 2  # two injected mutations: replicate + drain


register(Scenario(
    name="migration_under_load",
    describe="replicate a newly-hot model and drain a replica while "
             "traffic flows; every move admit->sha-verify->evict, "
             "zero unclassified outcomes",
    floors=Floors(p99_ms=400.0, availability=0.95),
    spec_fn=lambda seed: LoadSpec(
        seed=950 + seed, duration_s=2.4, rate_rps=80.0,
        arrival="bursty", models=_MODELS, zipf_s=1.3,
        sizes=(1, 2)),
    queue_depth=64,
    submit_timeout_s=0.25,
    senders=6,
    run_fn=_run_migration,
))
