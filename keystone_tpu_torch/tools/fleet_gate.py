"""The fleet gate: the replica-death drill.

    python -m keystone_tpu_torch.tools.fleet_gate [--device cuda|cpu]

Counterpart of the repository's ``tools/fleet_gate.py``, out of process:

1. three replica servers start as SUBPROCESSES (``python -m
   keystone_tpu_torch.serving.replica``), each a ``ServingPlane`` behind
   the real-HTTP predict and admin surfaces, on ``--device`` (three CUDA
   contexts on one card);
2. three models are registered with the in-process ``FleetController``
   (one canonical pickled copy each, sha256-stamped), placed under
   finite per-replica budgets and admitted over ``/admin/admit``; each
   replica's reported sha must equal the canonical one;
3. the real-HTTP ``FleetRouter`` fronts the fleet and a seeded loadgen
   trace goes through it (loadgen -> router socket -> replica socket ->
   plane);
4. mid-replay, the replica hosting the most models is SIGKILLed;
5. the reactor tick (``FleetAutoscaler``) must classify the death, drop
   the replica from the membership, re-solve placement over the
   survivors and re-admit the lost models from the canonical bytes,
   sha-verified;
6. afterwards every model answers 200 through the router, every copy's
   sha matches, the served requests' p99 stays under ``P99_FLOOR_MS``,
   and every outcome of the replay is classified: no unclassified
   outcome and no raw error.

Exit 0 clean, 1 with a named reason. Every replica process is killed on
every path and the killer thread is joined with a timeout.
"""
from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np

from . import gates

NAME = "fleet gate"
READY_TIMEOUT_S = 240.0
N_REPLICAS = 3
DIMS = {"alpha": (24, 3), "beta": (32, 4), "gamma": (16, 2)}
P99_FLOOR_MS = 500.0


def main(argv=None) -> int:
    args = gates.parser(__doc__.splitlines()[0]).parse_args(argv)
    device = gates.resolve(NAME, args.device)
    if device is None:
        return 2
    procs = [gates.spawn(["keystone_tpu_torch.serving.replica", "--port",
                          "0", "--max-batch", "16", "--queue-depth", "128",
                          "--device", str(device)])
             for _ in range(N_REPLICAS)]
    try:
        return _drill(procs, device)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        gates.stop(procs)


def _drill(procs, device) -> int:
    from ..observability.metrics import MetricsRegistry
    from ..serving.fleet import FleetController
    from ..serving.models import ItemSpec
    from ..serving.router import FleetRouter, HttpReplicaClient, serve_router

    reg = MetricsRegistry.get_or_create()
    deaths0 = reg.counter("fleet.replica_deaths_total").value
    deadline = time.monotonic() + READY_TIMEOUT_S
    clients = []
    for i, proc in enumerate(procs):
        bound = gates.read_until(proc, r"replica on ([\d.]+):(\d+)",
                                 deadline, f"replica r{i}")
        if bound is None:
            return gates.fail(NAME, f"replica {i} printed no bind line "
                                    "(it crashed or wedged)")
        clients.append(HttpReplicaClient(f"r{i}", bound.group(1),
                                         int(bound.group(2)),
                                         stats_ttl_s=0.05))
    print(f"{NAME}: {N_REPLICAS} replicas up on {device}, ports "
          f"{[c.port for c in clients]}", flush=True)
    router = FleetRouter(clients, spill_queue_depth=8)
    controller = FleetController(router, device=device)
    registered = {}
    for seed, (name, (d, k)) in enumerate(sorted(DIMS.items())):
        fitted, _ = gates.fit_linear(d, k, seed, device)
        qps = 300.0 if name == "alpha" else 0.0
        registered[name] = controller.register(
            name, fitted, ItemSpec((d,), np.float32), qps=qps,
            warmup_s=1.0 if qps else 0.0)
    biggest = max(m.charge_nbytes for m in registered.values())
    for client in clients:
        controller.set_budget(client.replica_id, 3.3 * biggest)
    steps = controller.rebalance()
    if not steps:
        return gates.fail(NAME, "the first rebalance applied no step")
    canonical = {name: m.sha256 for name, m in registered.items()}
    bad = _sha_mismatch(clients, canonical, skip=None)
    if bad:
        return gates.fail(NAME, f"after placement: {bad}")
    table = router.state()["models"]
    missing = [m for m in DIMS if not table.get(m)]
    if missing:
        return gates.fail(NAME, f"models {missing} unroutable after "
                                "placement")
    print(f"{NAME}: placed in {len(steps)} step(s): "
          f"{ {m: table[m] for m in sorted(table)} }", flush=True)

    server = serve_router(router)
    try:
        return _replay_and_kill(procs, clients, router, controller,
                                server.server_port, canonical, reg,
                                deaths0)
    finally:
        server.shutdown()
        server.server_close()


def _sha_mismatch(clients, canonical, skip):
    for client in clients:
        if client.replica_id == skip:
            continue
        for name, sha in client.model_shas().items():
            if sha != canonical[name]:
                return (f"{client.replica_id} hosts {name!r} with sha "
                        f"{sha[:12]} != canonical {canonical[name][:12]}")
    return None


def _replay_and_kill(procs, clients, router, controller, rport, canonical,
                     reg, deaths0) -> int:
    from ..serving.fleet import FleetAutoscaler
    from ..serving.loadgen import (HttpServingClient, LoadSpec,
                                   generate_trace, replay)

    spec = LoadSpec(seed=31, duration_s=3.0, rate_rps=90.0,
                    arrival="poisson", models=tuple(sorted(DIMS)),
                    zipf_s=1.2, sizes=(1, 2, 4))
    trace = generate_trace(spec)
    data = {name: np.random.RandomState(100 + i).rand(
        8, DIMS[name][0]).astype(np.float32)
        for i, name in enumerate(sorted(DIMS))}
    autoscaler = FleetAutoscaler(controller, sustain_ticks=10 ** 6)
    killed = {}

    def killer():
        time.sleep(1.5)
        count = {}
        for reps in controller.placement.assignments.values():
            for rid in reps:
                count[rid] = count.get(rid, 0) + 1
        victim = max(sorted(count), key=lambda rid: count[rid])
        idx = next(i for i, c in enumerate(clients)
                   if c.replica_id == victim)
        procs[idx].kill()  # SIGKILL: no drain
        procs[idx].wait(timeout=30)
        killed["victim"] = victim
        try:
            killed["action"] = autoscaler.tick()
        except Exception as exc:  # noqa: BLE001 - the gate's verdict
            killed["error"] = f"{type(exc).__name__}: {exc}"

    thread = threading.Thread(target=killer, daemon=True,
                              name="fleet-gate-killer")
    thread.start()
    report = replay(trace, HttpServingClient("127.0.0.1", rport),
                    lambda m, n: data[m][:n], senders=6,
                    submit_timeout_s=5.0, result_timeout_s=30.0)
    thread.join(timeout=60.0)
    if thread.is_alive():
        return gates.fail(NAME, "the kill and the reactor tick did not "
                                "finish within 60 s")
    if "error" in killed:
        return gates.fail(NAME, f"the recovery raised {killed['error']}")
    if killed.get("action") != "death":
        return gates.fail(NAME, f"the reactor tick did not classify the "
                                f"kill as a death (got "
                                f"{killed.get('action')!r})")
    deaths = reg.counter("fleet.replica_deaths_total").value - deaths0
    if deaths != 1:
        return gates.fail(NAME, f"expected exactly 1 counted death, got "
                                f"{deaths:g}")
    victim = killed["victim"]
    if victim in router.replica_ids():
        return gates.fail(NAME, f"the dead replica {victim!r} is still in "
                                "the membership")
    table = router.state()["models"]
    missing = [m for m in DIMS if not table.get(m)]
    if missing:
        return gates.fail(NAME, f"models {missing} unroutable after the "
                                "death")
    bad = _sha_mismatch(clients, canonical, skip=victim)
    if bad:
        return gates.fail(NAME, f"after the death: {bad}")
    for name in sorted(DIMS):
        body = json.dumps({"instances": [[0.5] * DIMS[name][0]]}).encode()
        status, raw, _ = gates.post_json("127.0.0.1", rport,
                                         f"/predict/{name}", body, 10.0)
        if status != 200:
            return gates.fail(NAME, f"after the death {name!r} answered "
                                    f"{status}: {raw[:120]!r}")
    oc = report.outcomes
    if oc["unclassified"]:
        return gates.fail(NAME, f"{oc['unclassified']} unclassified "
                                f"outcome(s): {report.errors[:4]}")
    if oc["error"]:
        return gates.fail(NAME, f"{oc['error']} raw error(s) through the "
                                f"router: {report.errors[:4]}")
    if oc["ok"] == 0:
        return gates.fail(NAME, "no request was served")
    p99 = report.p99_ms()
    if p99 > P99_FLOOR_MS:
        return gates.fail(NAME, f"p99 {p99:.1f} ms over the "
                                f"{P99_FLOOR_MS:.0f} ms drill floor")
    refused = oc["rejected"] + oc["warming"] + oc["not_admitted"]
    print(f"{NAME}: killed {victim}; {oc['ok']} served, {refused} "
          f"classified refusal(s), p99 {p99:.1f} ms, re-placement "
          "sha-verified", flush=True)
    print(f"{NAME}: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
