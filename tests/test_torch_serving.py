"""The port's serving plane (``keystone_tpu_torch/serving`` and ``python
-m keystone_tpu_torch serve``), on the CPU, held against the JAX
package's where both can be driven the same way:

* the bucket ladder and the micro-batcher (coalescing, ceiling, slot
  gate, close), the batcher's take groupings identical to the JAX
  package's on the same submission sequence;
* three models hot under an asserted budget, an over-budget admission
  refused without changes, eviction by retention value, eviction and
  readmission bit-identical, the weight-type defaults, readiness, the
  HTTP statuses 200 / 404 / 503 / 429 / 504 / 400 / 500, the greedy
  selection, checkpoints and the ``serve`` command;
* the slice as a whole: a RandomPatchCifar fitted by the JAX package,
  carried across with ``convert.py`` and served by both planes at f32,
  bf16 and int8.

Every future and join waits with a timeout, so a hang fails the test.
"""
import json
import os
import pickle
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.serving import MicroBatcher as JMicroBatcher
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.serving import (
    AdmissionError,
    BucketPolicy,
    DeadlineExpiredError,
    ItemSpec,
    MicroBatcher,
    ModelNotAdmitted,
    QueueFullError,
    ServingPlane,
    fitted_model_nbytes,
    predict_response,
    serve,
)
from keystone_tpu_torch.utils.checkpoint import (
    CheckpointCorruptError,
    load_pipeline,
    save_pipeline,
)
from keystone_tpu_torch.workflow.optimizer.auto_cache import greedy_select
from keystone_tpu_torch.workflow.transformer import Transformer, transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30


def _make_fitted(d, k, seed=0, n=96, **est_kw):
    r = np.random.RandomState(seed)
    X = r.rand(n, d).astype(np.float32)
    Y = r.rand(n, k).astype(np.float32)
    fitted = LinearMapEstimator(lam=1e-3, **est_kw).with_data(
        ArrayDataset.from_numpy(X, "cpu"),
        ArrayDataset.from_numpy(Y, "cpu")).fit()
    return fitted, X, Y


def _apply(fitted, X):
    return fitted.apply(ArrayDataset.from_numpy(X, "cpu")).numpy()


def _sample(d):
    return ItemSpec((d,), np.float32)


def _charge(fitted, d, rows=16):
    """The charge a max_batch=16 plane will compute for ``fitted``."""
    from keystone_tpu_torch.serving.residency import model_charge

    return model_charge(fitted, np.zeros((1, d), np.float32), rows, "cpu")


@pytest.fixture
def plane_factory():
    planes = []

    def make(**kw):
        kw.setdefault("max_batch", 16)
        kw.setdefault("device", "cpu")
        plane = ServingPlane(**kw)
        planes.append(plane)
        return plane

    yield make
    for plane in planes:
        plane.close()


# -- a node whose batches can be held, for the queue-state statuses ---------

GATE = threading.Event()
ENTERED = threading.Event()
ARMED = [False]


class BlockingNode(Transformer):
    """Doubles its input; while armed, a batch of two or more rows waits
    on GATE (a one-row probe passes, so admission can register first)."""

    def apply(self, x):
        return self.apply_batch(x[None])[0]

    def apply_batch(self, X):
        if ARMED[0] and X.shape[0] >= 2:
            ENTERED.set()
            GATE.wait(timeout=TIMEOUT)
        return X * 2.0


def _arm(on: bool) -> None:
    ENTERED.clear()
    if on:
        GATE.clear()
    else:
        GATE.set()
    ARMED[0] = on


# -- bucket policy and batcher -------------------------------------------------

def test_bucket_policy_ladder_and_ceiling():
    assert BucketPolicy(64).rows() == (1, 2, 4, 8, 16, 32, 64)
    assert BucketPolicy(5).rows() == (1, 2, 4, 5)
    from keystone_tpu.serving import BucketPolicy as JBucketPolicy

    for m in (1, 5, 16, 48, 64):
        assert BucketPolicy(m).rows() == JBucketPolicy(m).rows(1)
    policy = BucketPolicy(64)
    assert [policy.bucket_for(n) for n in (1, 3, 9, 64)] == [1, 4, 16, 64]
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        policy.bucket_for(65)
    with pytest.raises(ValueError):
        BucketPolicy(0)


def test_batcher_coalesces_same_model_fifo_for_others():
    batcher = MicroBatcher(queue_depth=16)
    futs = [batcher.submit("a", np.zeros((2, 4)), 2) for _ in range(3)]
    batcher.submit("b", np.zeros((1, 4)), 1)
    batcher.submit("a", np.zeros((2, 4)), 2)
    batch = batcher.take(max_rows=16)
    assert [r.model for r in batch] == ["a"] * 4
    assert sum(r.n for r in batch) == 8
    assert [r.future for r in batch[:3]] == futs
    nxt = batcher.take(max_rows=16)
    assert [r.model for r in nxt] == ["b"]
    batcher.done(len(batch) + len(nxt))
    assert batcher.take(max_rows=16, timeout_s=0.01) == []


def test_batcher_respects_the_bucket_ceiling():
    batcher = MicroBatcher(queue_depth=16)
    for _ in range(5):
        batcher.submit("a", np.zeros((3, 2)), 3)
    batch = batcher.take(max_rows=8)
    assert sum(r.n for r in batch) <= 8 and len(batch) == 2
    assert batcher.depth() == 3
    batcher.done(len(batch))


def test_batcher_slot_gate_bounds_the_queue_and_refuses_fast():
    batcher = MicroBatcher(queue_depth=2, submit_timeout_s=0.05)
    reg = MetricsRegistry.get_or_create()
    rejected0 = reg.counter("serving.rejected_total").value
    batcher.submit("a", np.zeros((1, 2)), 1)
    batcher.submit("a", np.zeros((1, 2)), 1)
    with pytest.raises(QueueFullError) as exc:
        batcher.submit("a", np.zeros((1, 2)), 1)
    assert exc.value.retry_after_s >= 0.05
    assert reg.counter("serving.rejected_total").value == rejected0 + 1
    taken = batcher.take(max_rows=8)
    batcher.done(len(taken))  # slots freed: submit admits again
    batcher.submit("a", np.zeros((1, 2)), 1)


def test_batcher_close_drains_and_refuses():
    batcher = MicroBatcher(queue_depth=4)
    fut = batcher.submit("a", np.zeros((1, 2)), 1)
    drained = batcher.close()
    assert [r.future for r in drained] == [fut]
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit("a", np.zeros((1, 2)), 1)


def _groupings(batcher, sequence, max_rows):
    for model, n in sequence:
        batcher.submit(model, np.zeros((n, 2), np.float32), n)
    groups = []
    while True:
        group = batcher.take(max_rows=max_rows, timeout_s=0.01)
        if not group:
            return groups
        groups.append([(r.model, r.n) for r in group])
        batcher.done(len(group))


def test_batcher_groupings_match_the_jax_package():
    rng = np.random.RandomState(7)
    sequence = [(str(rng.choice(["a", "b", "c"], p=[0.5, 0.3, 0.2])),
                 int(rng.randint(1, 9))) for _ in range(60)]
    ours = _groupings(MicroBatcher(queue_depth=64), sequence, 16)
    theirs = _groupings(JMicroBatcher(queue_depth=64), sequence, 16)
    assert ours == theirs
    assert sum(len(g) for g in ours) == 60 and len(ours) < 60


# -- admission, residency, eviction ------------------------------------------

def test_three_models_hot_under_an_asserted_budget(plane_factory):
    """Three models warm under an asserted budget; the fourth, larger
    than the budget, is refused without changing anything; eviction and
    readmission round-trip bit-identically."""
    dims = [(24, 3, 1), (32, 4, 2), (40, 5, 3)]
    models = {f"m{d}": _make_fitted(d, k, seed) for d, k, seed in dims}
    big, _, _ = _make_fitted(512, 64, seed=9)
    charges = {name: _charge(f, X.shape[1])
               for name, (f, X, _) in models.items()}
    budget = sum(c.total_nbytes() for c in charges.values()) + 1024
    plane = plane_factory(hbm_budget=budget, queue_depth=64)
    plane.start()
    for name, (fitted, X, _) in models.items():
        entry = plane.admit(name, fitted, _sample(X.shape[1]))
        assert entry.charge == charges[name] and entry.charge.source == \
            "probed"
        assert entry.charge.model_nbytes == fitted_model_nbytes(
            fitted.to_pipeline().graph)
    state = plane.state()
    assert state["ready"] and len(state["models"]) == 3
    assert state["hbm_charged_bytes"] <= budget

    reg = MetricsRegistry.get_or_create()
    rejected0 = reg.counter("serving.admission_rejected_total").value
    with pytest.raises(AdmissionError, match="refusing"):
        plane.admit("big", big, _sample(512))
    assert reg.counter(
        "serving.admission_rejected_total").value == rejected0 + 1
    after = plane.state()
    assert sorted(m["name"] for m in after["models"]) == sorted(models)
    assert after["hbm_charged_bytes"] == state["hbm_charged_bytes"]

    outputs = {}
    for name, (fitted, X, _) in models.items():
        for n in (1, 3, 7, 8, 9, 15, 16):
            np.testing.assert_allclose(plane.predict(name, X[:n]),
                                       _apply(fitted, X[:n]),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(plane.predict(name, X[0]),
                                   _apply(fitted, X[:1]), rtol=1e-5,
                                   atol=1e-5)
        outputs[name] = plane.predict(name, X[:6])
    assert reg.gauge("serving.models_resident").value == 3

    evictions0 = reg.counter("serving.evictions_total").value
    plane.evict("m32")
    assert reg.counter("serving.evictions_total").value == evictions0 + 1
    with pytest.raises(ModelNotAdmitted):
        plane.predict("m32", models["m32"][1][:2])
    plane.readmit("m32")
    again = plane.predict("m32", models["m32"][1][:6])
    assert np.array_equal(outputs["m32"], again)
    assert "m32" not in plane.state()["evicted"]


def test_admission_evicts_the_lowest_value_resident(plane_factory):
    a, _, _ = _make_fitted(24, 3, seed=1)
    b, bX, _ = _make_fitted(24, 3, seed=2)
    c, _, _ = _make_fitted(24, 3, seed=3)
    budget = _charge(a, 24).total_nbytes() * 2 + 64  # room for two
    plane = plane_factory(hbm_budget=budget)
    plane.start()
    plane.admit("a", a, _sample(24))
    plane.admit("b", b, _sample(24))
    for _ in range(4):  # b gets observed QPS; a stays idle
        plane.predict("b", bX[:4])
    plane.admit("c", c, _sample(24))
    state = plane.state()
    assert sorted(m["name"] for m in state["models"]) == ["b", "c"]
    assert state["evicted"] == ["a"]
    assert state["hbm_charged_bytes"] <= budget


def test_refused_admission_leaves_existing_models_serving(plane_factory):
    fitted, X, _ = _make_fitted(24, 3, seed=5)
    plane = plane_factory(hbm_budget=_charge(fitted, 24).total_nbytes() + 64)
    plane.start()
    plane.admit("only", fitted, _sample(24))
    big, _, _ = _make_fitted(256, 32, seed=6)
    with pytest.raises(AdmissionError):
        plane.admit("big", big, _sample(256))
    assert plane.predict("only", X[:3]).shape == (3, 3)
    with pytest.raises(ValueError, match="already admitted"):
        plane.admit("only", fitted, _sample(24))


def test_unpicklable_pipeline_admission_names_the_constraint(plane_factory):
    fitted, _, _ = _make_fitted(16, 3, seed=6)
    pipe = transformer(lambda x: x * 2.0).to_pipeline().and_then(
        fitted.to_pipeline())
    with pytest.raises(TypeError, match="not picklable"):
        plane_factory().admit("bad", pipe, _sample(16))


def test_default_weight_dtype_quantizes_and_round_trips(plane_factory):
    fitted, X, _ = _make_fitted(32, 4, seed=7)
    f32 = _apply(fitted, X[:8])  # caches float32 params on the caller's
    plane = plane_factory(default_weight_dtype="bf16")
    plane.start()
    entry = plane.admit("q", fitted, _sample(32))
    assert entry.weight_dtype == "bf16"
    quantized = plane.predict("q", X[:8])
    # the bf16 answer, not the cached float32 one
    bf16, _, _ = _make_fitted(32, 4, seed=7, weight_dtype="bf16")
    np.testing.assert_array_equal(quantized, _apply(bf16, X[:8]))
    assert not np.array_equal(quantized, f32)
    np.testing.assert_allclose(quantized, f32, rtol=0.05, atol=0.05)
    plane.evict("q")
    plane.readmit("q")
    assert np.array_equal(quantized, plane.predict("q", X[:8]))
    # the caller's pipeline is untouched
    mapper = [op for op in fitted.to_pipeline().graph.operators.values()
              if hasattr(op, "weight_dtype")]
    assert [m.weight_dtype for m in mapper] == [None]


def test_explicit_model_weight_dtype_wins_over_the_plane_default(
        plane_factory):
    fitted, X, _ = _make_fitted(32, 4, seed=8, weight_dtype="int8")
    plane = plane_factory(default_weight_dtype="bf16")
    plane.start()
    entry = plane.admit("m", fitted, _sample(32))
    dtypes = {op.weight_dtype for op in entry.fitted.graph.operators.values()
              if hasattr(op, "weight_dtype")}
    assert dtypes == {"int8"}
    explicit = plane.admit("f", fitted, _sample(32), weight_dtype=None)
    assert explicit.weight_dtype is None


def test_ready_waits_for_expected_admissions(plane_factory):
    fitted, _, _ = _make_fitted(24, 3, seed=4)
    plane = plane_factory()
    plane.expect_models(2)
    assert not plane.ready()
    plane.admit("one", fitted, _sample(24))
    assert not plane.ready()
    fitted2, _, _ = _make_fitted(24, 4, seed=5)
    plane.admit("two", fitted2, _sample(24))
    assert plane.ready()


def test_startup_eviction_does_not_wedge_readiness(plane_factory):
    a, _, _ = _make_fitted(24, 3, seed=1)
    b, _, _ = _make_fitted(24, 3, seed=2)
    plane = plane_factory(hbm_budget=_charge(a, 24).total_nbytes() + 64)
    plane.expect_models(2)
    plane.admit("a", a, _sample(24))
    assert not plane.ready()
    plane.admit("b", b, _sample(24))  # evicts a: room for one only
    assert [m["name"] for m in plane.state()["models"]] == ["b"]
    assert plane.ready()


def test_concurrent_submits_coalesce_into_batches(plane_factory):
    fitted, X, _ = _make_fitted(24, 3, seed=11)
    plane = plane_factory(queue_depth=64)
    plane.start()
    plane.admit("m", fitted, _sample(24))
    reg = MetricsRegistry.get_or_create()
    req0 = reg.counter("serving.requests_total").value
    batch0 = reg.counter("serving.batches_total").value
    rows0 = reg.counter("serving.rows_total").value
    futures = {i: plane.submit("m", X[i:i + 2]) for i in range(12)}
    for i, fut in futures.items():
        np.testing.assert_allclose(fut.result(timeout=TIMEOUT),
                                   _apply(fitted, X[i:i + 2]), rtol=1e-5,
                                   atol=1e-5)
    assert reg.counter("serving.requests_total").value - req0 == 12
    assert reg.counter("serving.rows_total").value - rows0 == 24
    assert reg.counter("serving.batches_total").value - batch0 <= 12
    assert reg.histogram("serving.batch_fill.m").count >= 1
    assert reg.histogram("serving.request_ms.m").count >= 12
    assert reg.histogram("serving.queue_wait_s.m").count >= 12


def test_greedy_select_maximizes_value_under_the_budget():
    sizes = {"a": 4.0, "b": 3.0, "c": 2.0, "d": 1.0}
    value = {"a": 10.0, "b": 1.0, "c": 8.0, "d": 3.0}

    def candidates(selected, space_left):
        return [n for n in sizes if n not in selected
                and sizes[n] <= space_left]

    keep = greedy_select((), candidates, sizes.get,
                         lambda sel: -sum(value[n] for n in sel), 7.0)
    assert keep == frozenset({"a", "c", "d"})
    assert greedy_select(("b",), candidates, sizes.get,
                         lambda sel: -sum(value[n] for n in sel),
                         4.0) == frozenset({"b", "d"})


# -- HTTP -------------------------------------------------------------------

def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as rsp:
        return rsp.status, json.loads(rsp.read())


def _status(fn):
    try:
        fn()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers
    return 200, None


def test_http_predict_two_models_and_error_statuses(plane_factory):
    f1, X1, _ = _make_fitted(24, 3, seed=1)
    f2, X2, _ = _make_fitted(32, 4, seed=2)
    plane = plane_factory(queue_depth=32)
    plane.start()
    plane.admit("alpha", f1, _sample(24))
    plane.admit("beta", f2, _sample(32))
    server = serve(plane)
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        for name, X, fitted in (("alpha", X1, f1), ("beta", X2, f2)):
            status, out = _post(base, f"/predict/{name}",
                                {"instances": X[:3].tolist()})
            assert status == 200 and out["rows"] == 3
            np.testing.assert_allclose(np.asarray(out["predictions"]),
                                       _apply(fitted, X[:3]), rtol=1e-5,
                                       atol=1e-5)
        status, out = _post(base, "/predict/alpha", X1[:2].tolist())
        assert status == 200 and out["rows"] == 2
        with urllib.request.urlopen(base + "/models", timeout=TIMEOUT) as r:
            state = json.loads(r.read())
        assert sorted(m["name"] for m in state["models"]) == \
            ["alpha", "beta"]
        with urllib.request.urlopen(base + "/metrics", timeout=TIMEOUT) as r:
            text = r.read().decode()
        assert "keystone_serving_requests_total_total" in text
        assert 'keystone_serving_request_ms_alpha{quantile="0.99"}' in text
        with urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT) as r:
            assert r.status == 200
        nan = np.full((1, 24), np.nan).tolist()
        for path, payload, expect in (
                ("/predict/ghost", {"instances": [[0.0] * 24]}, 404),
                ("/predict/alpha", {"instances": []}, 400),
                ("/predict/alpha", {"instances": [[0.0] * 7]}, 400),
                ("/predict/alpha", {"instances": [[0.0] * 24],
                                    "deadline_ms": -1}, 400),
                ("/predict/alpha", {"instances": nan}, 500)):
            code, _ = _status(lambda: _post(base, path, payload))
            assert code == expect, (path, payload, code)
        req = urllib.request.Request(base + "/predict/alpha", data=b"{bad")
        assert _status(lambda: urllib.request.urlopen(
            req, timeout=TIMEOUT))[0] == 400
    finally:
        server.shutdown()
    reg = MetricsRegistry.get_or_create()
    assert reg.counter("serving.poisoned_batches_total").value >= 1


def test_http_statuses_for_warming_full_and_shed(plane_factory):
    """503 while a model warms (and /healthz 503), 429 with Retry-After
    when the queue is full, 504 for a request shed past its deadline."""
    plane = plane_factory(queue_depth=2)
    plane.start()
    server = serve(plane)
    base = f"http://127.0.0.1:{server.server_port}"
    x = np.ones((2, 4), np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()
    try:
        _arm(False)
        plane.admit("slow", BlockingNode().to_pipeline(), _sample(4))
        _arm(True)
        held = plane.submit("slow", x)            # the worker holds it
        assert ENTERED.wait(TIMEOUT)
        ready_evt = plane.batcher._ready
        assert not ready_evt.is_set()
        shed = {}
        t = threading.Thread(target=lambda: shed.setdefault(
            "r", predict_response(plane, "slow", json.dumps(
                {"instances": x.tolist(), "deadline_ms": 1}).encode())))
        t.start()
        assert ready_evt.wait(TIMEOUT)            # queued behind it
        plane.batcher.submit_timeout_s = 0.05     # both slots are taken
        status, _, headers = predict_response(plane, "slow", body)
        assert status == 429 and int(headers["Retry-After"]) >= 1
        code, hdrs = _status(lambda: _post(base, "/predict/slow",
                                           {"instances": x.tolist()}))
        assert code == 429 and int(hdrs["Retry-After"]) >= 1
        GATE.set()
        np.testing.assert_array_equal(held.result(timeout=TIMEOUT), x * 2)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive() and shed["r"][0] == 504

        # a second model warming: 503 for it, /healthz 503 meanwhile
        _arm(True)
        admitted = {}
        a = threading.Thread(target=lambda: admitted.setdefault(
            "e", plane.admit("warm", BlockingNode().to_pipeline(),
                             _sample(4))))
        a.start()
        assert ENTERED.wait(TIMEOUT)
        assert predict_response(plane, "warm", body)[0] == 503
        assert _status(lambda: urllib.request.urlopen(
            base + "/healthz", timeout=TIMEOUT))[0] == 503
        GATE.set()
        a.join(timeout=TIMEOUT)
        assert not a.is_alive() and admitted["e"].ready
        assert predict_response(plane, "warm", body)[0] == 200
        assert _status(lambda: urllib.request.urlopen(
            base + "/healthz", timeout=TIMEOUT))[0] == 200
    finally:
        _arm(False)
        server.shutdown()


def test_deadline_shed_fails_the_future_before_dispatch(plane_factory):
    plane = plane_factory(queue_depth=4)
    plane.start()
    _arm(False)
    plane.admit("slow", BlockingNode().to_pipeline(), _sample(4))
    _arm(True)
    x = np.ones((2, 4), np.float32)
    try:
        held = plane.submit("slow", x)
        assert ENTERED.wait(TIMEOUT)
        late = plane.submit("slow", x, deadline_ms=1)
        time.sleep(0.01)  # the deadline passes while the worker is held
        GATE.set()
        held.result(timeout=TIMEOUT)
        with pytest.raises(DeadlineExpiredError):
            late.result(timeout=TIMEOUT)
    finally:
        _arm(False)
    assert MetricsRegistry.get_or_create().counter(
        "serving.shed_total").value >= 1


# -- checkpoints and the serve command ---------------------------------------

def test_checkpoint_round_trip_and_corrupt_files(tmp_path):
    fitted, X, _ = _make_fitted(24, 3, seed=3, weight_dtype="int8")
    path = str(tmp_path / "m.pkl")
    save_pipeline(fitted, path)
    loaded = load_pipeline(path, device="cpu")
    np.testing.assert_array_equal(_apply(loaded, X[:5]), _apply(fitted,
                                                                X[:5]))
    with open(path, "rb") as f:
        blob = f.read()
    assert not any(name.startswith(os.path.basename(path) + ".tmp")
                   for name in os.listdir(tmp_path))
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        load_pipeline(str(bad), device="cpu")
    other = tmp_path / "other.pkl"
    other.write_bytes(pickle.dumps({"format": "keystone-checkpoint",
                                    "version": 1, "kind": "state",
                                    "payload": {}}))
    with pytest.raises(CheckpointCorruptError, match="'state'"):
        load_pipeline(str(other), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_pipeline(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingPlane()


def _serve_cmd(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch", "serve", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_serve_command_drives_a_saved_model(tmp_path):
    fitted, X, _ = _make_fitted(24, 3, seed=12)
    path = str(tmp_path / "m.pkl")
    save_pipeline(fitted, path)
    proc = _serve_cmd(f"m={path}@24", "--port", "0", "--device", "cpu",
                      "--weight-dtype", "int8")
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    try:
        seen = []
        while not seen or not seen[-1].startswith("serving ready"):
            seen.append(lines.get(timeout=60))
        assert seen[-1].startswith("serving ready (1 models)"), seen
        port = int(seen[0].rsplit(":", 1)[1])
        assert any("weight_dtype int8" in s for s in seen), seen
        base = f"http://127.0.0.1:{port}"
        status, out = _post(base, "/predict/m", {"instances": X[:4].tolist()})
        want, _, _ = _make_fitted(24, 3, seed=12, weight_dtype="int8")
        np.testing.assert_allclose(np.asarray(out["predictions"]),
                                   _apply(want, X[:4]), rtol=1e-6,
                                   atol=1e-6)
    finally:
        proc.terminate()
        proc.wait(timeout=TIMEOUT)
    assert proc.returncode in (0, -15)


def test_serve_command_refuses_what_is_not_ported(tmp_path):
    from keystone_tpu_torch.__main__ import main

    assert main(["serve", "m=x.pkl@3", "--slo-latency-ms", "50"]) == 2
    assert main(["serve", "m=x.pkl@3", "--drift-every", "8"]) == 2
    assert main(["serve"]) == 2
    assert main(["fit"]) == 2


# -- the slice as a whole ------------------------------------------------------

def _rpc_ops(graph):
    return {type(op).__name__: op for op in graph.operators.values()}


def test_served_random_patch_cifar_matches_the_jax_plane():
    """A RandomPatchCifar fitted by the JAX package (16 filters, 256
    surrogate images), carried across, served by the JAX plane and the
    port's at f32, bf16 and int8 on the same seeded requests: identical
    f32 predictions with mapper scores within 1e-4 of the largest; the
    quantized models hold the parity bars against each other with
    bit-identical weights."""
    from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
    from keystone_tpu.nodes.util import (
        ClassLabelIndicatorsFromIntLabels as JLabels,
    )
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.pipelines.images.cifar import random_patch_cifar as jrpc
    from keystone_tpu.serving import ServingPlane as JServingPlane
    from keystone_tpu.serving.models import (
        _apply_weight_dtype as japply_weight_dtype,
    )
    from keystone_tpu.workflow.common import Cacher as JCacher
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
    from keystone_tpu_torch.pipelines.images.cifar import (
        random_patch_cifar as trpc,
    )

    (tr_x, tr_y), (te_x, _) = make_surrogate_cifar(256, 48)
    train = JLabeledData(JArrayDataset.from_numpy(tr_x),
                         JArrayDataset.from_numpy(tr_y.astype(np.int32)))
    config = jrpc.RandomCifarConfig(num_filters=16, lam=10.0, seed=0)
    filters, whitener = jrpc.learn_filters(train.data, config)
    labels = (JLabels(10) >> JCacher("labels"))(train.labels)
    jfit = jrpc.build_pipeline(filters, whitener, config, train.data,
                               labels).fit()
    ops = _rpc_ops(jfit._graph)
    fused, scaler, mapper = (ops["FusedConvRectifyPool"],
                             ops["StandardScalerModel"],
                             ops["BlockLinearMapper"])
    tfit = convert.from_reference_arrays({
        "filters": fused.filters, "whitener_means": fused.whitener_means,
        "scaler_mean": np.asarray(scaler.mean),
        "scaler_std": np.asarray(scaler.std),
        "weights": np.asarray(mapper.weights),
        "feature_means": np.asarray(mapper.feature_means),
        "intercept": np.asarray(mapper.intercept)}, device="cpu",
        config=trpc.RandomCifarConfig(num_filters=16))

    # the JAX plane serves the same fitted operators without the Cacher:
    # with it, its prefix memo keys each request's dataset by id() and
    # can answer a request with an earlier one's predictions (ROADMAP C5)
    jserved = (fused >> scaler >> mapper >> ops["MaxClassifier"]).fit()
    rng = np.random.RandomState(4)
    sizes, total = [], 0
    while total < len(te_x):
        sizes.append(min(int(rng.randint(1, 9)), len(te_x) - total))
        total += sizes[-1]
    requests = np.split(te_x, np.cumsum(sizes)[:-1])
    jfeat = (fused >> scaler).apply(JArrayDataset.from_numpy(te_x)).numpy()
    jplane = JServingPlane(max_batch=8)
    tplane = ServingPlane(max_batch=8, device="cpu")
    served, scores, weights = {}, {}, {}
    try:
        jplane.start()
        tplane.start()
        for wd in (None, "bf16", "int8"):
            name = f"rpc_{wd or 'f32'}"
            jentry = jplane.admit(name, jserved, jax.ShapeDtypeStruct(
                (32, 32, 3), np.float32), weight_dtype=wd)
            tentry = tplane.admit(name, tfit, ItemSpec((32, 32, 3),
                                                       np.float32),
                                  weight_dtype=wd)
            served[name] = [np.concatenate([p.predict(name, r)
                                            for r in requests])
                            for p in (jplane, tplane)]
            # the JAX plane fuses the chain; its scores are taken from a
            # copy of the mapper narrowed by the plane's own function
            jm = pickle.loads(pickle.dumps(mapper))
            japply_weight_dtype(jm.to_pipeline().graph, wd)
            tops = _rpc_ops(tentry.fitted.graph)
            tm = tops["BlockLinearMapper"]
            tfeat = (tops["FusedConvRectifyPool"] >> tops[
                "StandardScalerModel"]).apply(
                ArrayDataset.from_numpy(te_x, "cpu")).numpy()
            scores[name] = (
                jm.apply_dataset(JArrayDataset.from_numpy(jfeat)).numpy(),
                tm.apply_batch(torch.as_tensor(tfeat)).numpy())
            weights[name] = (np.asarray(jm.apply_params()[0]),
                             tm.apply_params(torch.device("cpu"))[0])
            assert jentry.weight_dtype == tentry.weight_dtype == wd
    finally:
        jplane.close()
        tplane.close()

    jpred, tpred = served["rpc_f32"]
    np.testing.assert_array_equal(tpred, jpred)
    js, ts = scores["rpc_f32"]
    assert np.abs(ts - js).max() <= 1e-4 * np.abs(js).max()
    for name, min_agree, max_rel in (("rpc_bf16", 0.999, 0.02),
                                     ("rpc_int8", 0.98, 0.03)):
        jpred, tpred = served[name]
        assert np.mean(jpred == tpred) >= min_agree, name
        js, ts = scores[name]
        assert np.abs(ts - js).max() <= max_rel * np.abs(js).max(), name
        jW, tW = weights[name]
        bits = tW.view(torch.int16).numpy() if tW.dtype == torch.bfloat16 \
            else tW.numpy()
        np.testing.assert_array_equal(
            bits, jW.view(np.int16) if jW.dtype.name == "bfloat16" else jW)
    # the quantized models stay within the bars of the f32 model too
    f32 = scores["rpc_f32"][1]
    for name, min_agree, max_rel in (("rpc_bf16", 0.999, 0.02),
                                     ("rpc_int8", 0.98, 0.03)):
        q = scores[name][1]
        assert np.mean(q.argmax(1) == f32.argmax(1)) >= min_agree, name
        assert np.abs(q - f32).max() <= max_rel * np.abs(f32).max(), name
