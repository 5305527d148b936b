"""The port's serving fleet (``keystone_tpu_torch/serving/{router,fleet,
replica}.py``), on the CPU: rendezvous routing with honest spill, the
canonical-bytes controller (admit -> sha verify -> evict), death
recovery and the reactor, driven on duck-typed replicas as the JAX
suite drives them (``tests/test_fleet.py``), with the rendezvous scores
held equal to the JAX package's; then the real transports: in-process
planes behind the HTTP router, and one ``--device cpu`` replica
subprocess taking its model over HTTP, sha-verified, served through the
router and evicted. Every wait has a timeout."""
from __future__ import annotations

import hashlib
import json
import os
import queue
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from keystone_tpu.serving.router import _rendezvous_score as jscore
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.serving import (FleetAutoscaler, FleetController,
                                        FleetError, FleetRouter,
                                        HttpReplicaClient, ItemSpec,
                                        LocalReplicaClient, ModelNotAdmitted,
                                        QueueFullError, ServingPlane,
                                        serve_router)
from keystone_tpu_torch.serving.models import canonical_dumps
from keystone_tpu_torch.serving.replica import serve_replica
from keystone_tpu_torch.serving.router import _rendezvous_score

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, K = 6, 2
TIMEOUT = 60


class FakeReplica:
    """A duck-typed replica client with knobs for depth, refusal and
    death (the JAX suite's double)."""

    def __init__(self, replica_id, depth=0):
        self.replica_id = replica_id
        self.depth = depth
        self.hosted = {}
        self.dead = False
        self.refuse = None

    def _check_alive(self):
        if self.dead:
            raise ConnectionError(f"replica {self.replica_id} is down")

    def models(self):
        self._check_alive()
        return tuple(sorted(self.hosted))

    def model_shas(self):
        self._check_alive()
        return dict(self.hosted)

    def queue_depth(self):
        self._check_alive()
        return self.depth

    def submit_request(self, name, x, timeout_s=None, deadline_ms=None):
        self._check_alive()
        if self.refuse is not None:
            raise self.refuse
        return (self.replica_id, name)

    def predict_raw(self, name, raw):
        self._check_alive()
        if self.refuse is not None:
            return 429, b'{"error": "full"}\n', None
        return 200, b'{"predictions": []}\n', None

    def admit_blob(self, name, blob, sample, weight_dtype):
        self._check_alive()
        sha = hashlib.sha256(blob).hexdigest()
        self.hosted[name] = sha
        return sha

    def evict(self, name):
        self._check_alive()
        self.hosted.pop(name, None)

    def probe(self):
        return "dead" if self.dead else "ready"


_FITTED = {}


def _fitted(seed=0):
    if seed not in _FITTED:
        r = np.random.RandomState(seed)
        _FITTED[seed] = LinearMapEstimator(lam=1e-3).with_data(
            ArrayDataset.from_numpy(r.rand(64, D).astype(np.float32), "cpu"),
            ArrayDataset.from_numpy(r.rand(64, K).astype(np.float32),
                                    "cpu")).fit()
    return _FITTED[seed]


def _sample():
    return ItemSpec((D,), np.float32)


def _fleet(n=3, names=("m",), depth=0):
    replicas = [FakeReplica(f"r{i}", depth=depth) for i in range(n)]
    for rep in replicas:
        for name in names:
            rep.hosted[name] = "sha-" + name
    return replicas, FleetRouter(replicas, spill_queue_depth=8)


def _controller(n=2):
    replicas = [FakeReplica(f"r{i}") for i in range(n)]
    router = FleetRouter(replicas)
    return replicas, router, FleetController(router, device="cpu")


# -- routing -----------------------------------------------------------------

@pytest.mark.parametrize("pair", [("m", "r0"), ("m", "r1"), ("cifar_bf16",
                                                             "r2")])
def test_rendezvous_score_equals_the_jax_routers(pair):
    assert _rendezvous_score(*pair) == jscore(*pair)


def test_primary_is_stable_under_membership():
    replicas, router = _fleet(n=4)
    _, primary = router._route("m")
    bystander = next(r for r in replicas if r is not primary)
    router.remove_replica(bystander.replica_id)
    assert router._route("m")[1] is primary
    router.remove_replica(primary.replica_id)
    survivors = [r for r in replicas if r not in (primary, bystander)]
    assert router._route("m")[1] is max(
        survivors, key=lambda r: _rendezvous_score("m", r.replica_id))
    with pytest.raises(ModelNotAdmitted):
        router.submit_request("ghost", None)
    assert router.predict_raw("ghost", b"{}")[0] == 404


def test_spill_on_congestion_refusal_and_death():
    replicas, router = _fleet(n=2)
    _, primary = router._route("m")
    sibling = next(r for r in replicas if r is not primary)
    reg = MetricsRegistry.get_or_create()
    spills0 = reg.counter("router.spill_total").value
    primary.depth = 100
    assert router.submit_request("m", None)[0] == sibling.replica_id
    assert reg.counter("router.spill_total").value == spills0 + 1
    primary.depth = 0
    primary.refuse = QueueFullError("full", retry_after_s=0.5)
    assert router.submit_request("m", None)[0] == sibling.replica_id
    primary.refuse = None
    primary.dead = True
    assert router.submit_request("m", None)[0] == sibling.replica_id


def test_every_refusal_is_classified_with_retry_after():
    replicas, router = _fleet(n=2)
    for rep in replicas:
        rep.refuse = QueueFullError("full", retry_after_s=0.5)
    with pytest.raises(QueueFullError):
        router.submit_request("m", None)
    status, _, headers = router.predict_raw("m", b"{}")
    assert status in (429, 503) and "Retry-After" in (headers or {})
    for rep in replicas:
        rep.refuse, rep.dead = None, True
    with pytest.raises(QueueFullError):
        router.submit_request("m", None)
    status, _, headers = router.predict_raw("m", b"{}")
    assert status == 503 and "Retry-After" in (headers or {})


def test_refresh_rebuilds_from_what_replicas_host():
    replicas, router = _fleet(n=2, names=("a", "b"))
    replicas[0].hosted.pop("a")
    replicas[1].dead = True
    router.refresh()
    table = router.state()["models"]
    assert table.get("b") == ["r0"] and "a" not in table


# -- the controller ------------------------------------------------------------

def test_register_rebalance_and_sha_verification():
    replicas, router, controller = _controller(n=2)
    charges = [controller.register(n, _fitted(i), _sample()).charge_nbytes
               for i, n in enumerate(("a", "b", "c"))]
    with pytest.raises(ValueError):
        controller.register("a", _fitted(), _sample())
    for rep in replicas:
        controller.set_budget(rep.replica_id, 3.3 * max(charges))
    steps = controller.rebalance()
    assert steps and all(kind == "admit" for kind, _, _ in steps)
    canonical = {m: controller._models[m].sha256 for m in ("a", "b", "c")}
    assert set(router.state()["models"]) == set(canonical)
    for rep in replicas:
        for name, sha in rep.model_shas().items():
            assert sha == canonical[name]
    # the canonical bytes are the same in any process: pickled again
    # they hash the same
    import pickle
    blob = controller._models["a"].blob
    assert canonical_dumps(pickle.loads(blob)) == blob


def test_sha_mismatch_aborts_and_evicts_the_impostor():
    replicas, _, controller = _controller(n=1)
    controller.register("m", _fitted(), _sample())

    def bad_admit(name, blob, sample, weight_dtype):
        replicas[0].hosted[name] = "not-the-canonical-sha"
        return "not-the-canonical-sha"

    replicas[0].admit_blob = bad_admit
    with pytest.raises(FleetError, match="bit-identical"):
        controller.rebalance()
    assert "m" not in replicas[0].hosted


def test_death_drain_and_demand():
    replicas, router, controller = _controller(n=3)
    for i, name in enumerate(("a", "b")):
        controller.register(name, _fitted(i), _sample())
    controller.rebalance()
    reg = MetricsRegistry.get_or_create()
    deaths0 = reg.counter("fleet.replica_deaths_total").value
    victim = controller.placement.assignments["a"][0]
    next(r for r in replicas if r.replica_id == victim).dead = True
    controller.handle_death(victim)
    assert reg.counter("fleet.replica_deaths_total").value == deaths0 + 1
    assert victim not in router.replica_ids()
    assert set(router.state()["models"]) == {"a", "b"}
    live = router.replica_ids()
    controller.drain_replica(live[-1])
    assert router.replica_ids() == live[:-1]
    with pytest.raises(FleetError, match="last replica"):
        controller.drain_replica(live[0])


def test_reactor_death_scale_up_down_and_rebalance():
    replicas, router, controller = _controller(n=2)
    model = controller.register("m", _fitted(), _sample())
    for rid in ("r0", "r1"):
        controller.set_budget(rid, 3.3 * model.charge_nbytes)
    controller.rebalance()
    scaler = FleetAutoscaler(controller, scale_up_queue_depth=10**6,
                             scale_down_queue_depth=-1,
                             sustain_ticks=10**6)
    controller.note_demand("m", qps=5000.0, warmup_s=2.0)
    assert scaler.tick() == "rebalance"
    assert len(router.state()["models"]["m"]) == 2
    replicas[0].dead = True
    assert scaler.tick() == "death"
    minted = []

    def provision():
        rep = FakeReplica(f"r{9 + len(minted)}")
        minted.append(rep)
        return rep

    up = FleetAutoscaler(controller, provisioner=provision,
                         scale_up_queue_depth=16, sustain_ticks=2,
                         max_replicas=4)
    replicas[1].depth = 100
    assert up.tick() is None
    assert up.tick() == "scale_up"
    assert minted[0].replica_id in router.replica_ids()
    replicas[1].depth = 0
    down = FleetAutoscaler(controller, scale_down_queue_depth=2,
                           sustain_ticks=2, min_replicas=1)
    assert down.tick() is None
    assert down.tick() == "scale_down"
    assert router.replica_ids() == ("r1",)


# -- the real transports ---------------------------------------------------------

def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, json.loads(resp.read())


def _expected(fitted, X):
    return fitted.apply(ArrayDataset.from_numpy(X, "cpu")).numpy()


def test_local_planes_behind_the_http_router():
    planes = [ServingPlane(max_batch=8, device="cpu").start()
              for _ in range(2)]
    servers = [serve_replica(p) for p in planes]
    clients = [HttpReplicaClient(f"r{i}", "127.0.0.1", s.server_port)
               for i, s in enumerate(servers)]
    router = FleetRouter(clients + [LocalReplicaClient("local", planes[0])])
    controller = FleetController(router, device="cpu")
    router_server = serve_router(router)
    try:
        controller.register("m", _fitted(3), _sample())
        controller.rebalance()
        X = np.random.RandomState(4).rand(5, D).astype(np.float32)
        status, out = _post(router_server.server_port, "/predict/m",
                            {"instances": X.tolist()})
        assert status == 200
        np.testing.assert_allclose(np.asarray(out["predictions"]),
                                   _expected(_fitted(3), X), rtol=1e-6,
                                   atol=1e-6)
    finally:
        router_server.shutdown()
        for s in servers:
            s.shutdown()
        for p in planes:
            p.close()


def test_cpu_replica_subprocess_over_http():
    """A real replica process: ``replica on HOST:PORT``, an admission
    over HTTP whose sha equals the controller's canonical sha, a predict
    through the router, the launch counters, an eviction."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch.serving.replica",
         "--port", "0", "--device", "cpu", "--max-batch", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    router_server = None
    try:
        line = lines.get(timeout=TIMEOUT)
        while not line.startswith("replica on "):
            line = lines.get(timeout=TIMEOUT)
        port = int(line.strip().rsplit(":", 1)[1])
        client = HttpReplicaClient("r0", "127.0.0.1", port)
        router = FleetRouter([client])
        controller = FleetController(router, device="cpu", bucket_rows=8)
        model = controller.register("m", _fitted(5), _sample())
        assert controller.rebalance() == [("admit", "m", "r0")]
        assert client.model_shas() == {"m": model.sha256}
        router_server = serve_router(router)
        X = np.random.RandomState(6).rand(3, D).astype(np.float32)
        status, out = _post(router_server.server_port, "/predict/m",
                            {"instances": X.tolist()})
        assert status == 200
        np.testing.assert_allclose(np.asarray(out["predictions"]),
                                   _expected(_fitted(5), X), rtol=1e-6,
                                   atol=1e-6)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/admin/launches",
                timeout=TIMEOUT) as resp:
            launches = json.loads(resp.read())
        assert set(launches) == {"kernels", "replayed"}
        assert client.probe() == "ready"
        client.evict("m")
        assert client.models() == ()
    finally:
        if router_server is not None:
            router_server.shutdown()
        proc.terminate()
        proc.wait(timeout=TIMEOUT)
    assert proc.returncode in (0, -15)
