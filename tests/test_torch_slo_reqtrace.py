"""The port's request traces, SLO tracker and drift scoring
(``keystone_tpu_torch/observability/{reqtrace,slo,numerics}.py``) held
against the JAX package's on the same inputs:

* the same stream of request outcomes gives the same ``SloTracker.
  state()`` (violations compared without their wall-clock time and
  post-mortem path) and the same gauges;
* the same completed traces offered in the same order give the same
  reservoir order, per model and merged;
* ``score_drift`` on the same baseline and batch gives the same PSI
  within 1e-6;

and the port's own wiring: phases telescope to the request time, the
flight recorder exports the request -> batch flow links, a served CPU
request reconciles its trace, spans and histograms, and the HTTP
surface answers ``X-Keystone-Trace``, ``/slo`` and ``/debug/slow``."""
from __future__ import annotations

import json
import os
import urllib.request

import numpy as np
import pytest

from keystone_tpu.observability import numerics as jnumerics
from keystone_tpu.observability.reqtrace import \
    ExemplarReservoir as JReservoir
from keystone_tpu.observability.reqtrace import ReqTrace as JReqTrace
from keystone_tpu.observability.slo import SloPolicy as JSloPolicy
from keystone_tpu.observability.slo import SloTracker as JSloTracker
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.observability import numerics
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.observability.reqtrace import (
    ExemplarReservoir,
    ReqTrace,
    exemplar_reservoir,
    reset_exemplars,
    tracing_suppressed,
)
from keystone_tpu_torch.observability.slo import (SloPolicy, SloTracker,
                                                  SloViolation)
from keystone_tpu_torch.observability.timeline import (flight_recorder,
                                                       reset_flight_recorder)
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.serving import ItemSpec, ServingPlane, serve

D, K = 6, 2
TIMEOUT = 30


@pytest.fixture(autouse=True)
def _fresh_planes(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("KEYSTONE_POSTMORTEM_DIR", str(tmp_path))
    MetricsRegistry.reset()
    reset_flight_recorder()
    reset_exemplars()
    yield
    reset_exemplars()


def _outcomes(seed):
    """A seeded stream of (model, latency_ms or None, ok)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(400):
        model = ("a", "b", "c")[r.randint(3)]
        if r.rand() < 0.08:
            out.append((model, None, False))
        else:
            out.append((model, float(r.exponential(40.0)), True))
    return out


def _strip(state):
    for v in state["violations"]:
        v.pop("time_unix", None)
        v.pop("postmortem", None)
    return state


@pytest.mark.parametrize("seed", range(4))
def test_slo_state_matches_the_jax_tracker(seed):
    kw = dict(latency_threshold_ms=60.0, availability_target=0.9,
              window=32, min_count=16)
    ours, theirs = SloTracker(SloPolicy(**kw)), JSloTracker(JSloPolicy(**kw))
    tripped = 0
    for model, ms, ok in _outcomes(seed):
        a = ours.record(model, ms, ok=ok)
        b = theirs.record(model, ms, ok=ok)
        assert (a is None) == (b is None)
        tripped += a is not None
    assert _strip(ours.state()) == _strip(theirs.state())
    assert ours.totals() == theirs.totals()
    assert ours.availability() == theirs.availability()
    assert tripped > 0
    assert isinstance(ours.last_violation, SloViolation)
    assert MetricsRegistry.get_or_create().counter(
        "serving.slo_violations_total").value == tripped


def test_slo_policy_validation_and_burn_rate():
    p = SloPolicy(latency_threshold_ms=100, availability_target=0.9,
                  window=10, min_count=5)
    assert p.burn_rate(0.8) == pytest.approx(2.0)
    for bad in (dict(latency_threshold_ms=0), dict(availability_target=1.0),
                dict(window=0), dict(window=4, min_count=5)):
        with pytest.raises(ValueError):
            SloPolicy(**bad)


def _stamp(tr, base, deltas):
    tr.enqueued_s = base
    tr.taken_s = base + deltas[0]
    tr.dispatch_s = tr.taken_s + deltas[1]
    tr.done_s = tr.dispatch_s + deltas[2]
    tr.responded_s = tr.done_s + deltas[3]
    return tr


def test_reservoir_order_matches_the_jax_reservoir():
    r = np.random.RandomState(3)
    ours, theirs = ExemplarReservoir(cap=5), JReservoir(cap=5)
    for i in range(120):
        model = ("a", "b")[r.randint(2)]
        deltas = tuple(float(x) for x in r.exponential(0.004, size=4))
        base = 100.0 + i
        mine = _stamp(ReqTrace(i + 1, model, 1 + i % 4, base), base, deltas)
        jax_tr = _stamp(JReqTrace(i + 1, model, 1 + i % 4, base), base,
                        deltas)
        assert ours.offer(mine) == theirs.offer(jax_tr)
    for model in ("a", "b", None):
        assert [t.flow_id for t in ours.slowest(8, model=model)] == \
            [t.flow_id for t in theirs.slowest(8, model=model)]
        assert [t.request_ms() for t in ours.slowest(8, model=model)] == \
            [t.request_ms() for t in theirs.slowest(8, model=model)]


def test_phases_telescope_and_flows_export():
    tr = _stamp(ReqTrace.new("m", 3), 10.0, (0.001, 0.002, 0.003, 0.0005))
    assert sum(tr.phases_ms().values()) == pytest.approx(tr.request_ms(),
                                                         abs=1e-9)
    assert ReqTrace.new("m", 1).phases_ms() == {}
    rec = flight_recorder()
    rec.defer(lambda: rec.record("request:m", "serving", 10.0, 0.0065,
                                 args={"flow_out": tr.flow_id}))
    rec.record("batch:m", "serving", 10.001, 0.005,
               args={"flow_in": [tr.flow_id]})
    events = rec.to_chrome_trace()["traceEvents"]
    flows = [e for e in events if e.get("ph") in ("s", "f")]
    assert {e["ph"] for e in flows} == {"s", "f"}
    assert {e["id"] for e in flows} == {tr.flow_id}


def test_score_drift_matches_the_jax_score():
    r = np.random.RandomState(9)
    F, B = 6, 10
    cols = np.arange(F, dtype=np.int32) * 3
    lo = r.rand(F).astype(np.float32) - 0.5
    interior = (lo[:, None] + np.linspace(0.1, 0.9, B - 1,
                                          dtype=np.float32)[None, :]
                ).astype(np.float32)
    counts = r.randint(0, 50, size=(F, B)).astype(np.float32)
    X = (r.rand(40, 18).astype(np.float32) * 1.4 - 0.6)
    ours = numerics.score_drift(
        numerics.DriftBaseline(cols, interior, counts, 500.0), X,
        threshold=0.2)
    theirs = jnumerics.score_drift(
        jnumerics.DriftBaseline(cols, interior, counts, 500.0), X,
        threshold=0.2)
    assert ours["rows"] == theirs["rows"] == 40.0
    np.testing.assert_allclose(ours["per_col"], theirs["per_col"],
                               rtol=0, atol=1e-6)
    assert abs(ours["psi_max"] - theirs["psi_max"]) <= 1e-6
    assert ours["warned"] == theirs["warned"]
    with pytest.raises(ValueError):
        numerics.score_drift(numerics.DriftBaseline(
            cols, interior, counts, 500.0), X[:, :5])


def _fitted():
    r = np.random.RandomState(0)
    return LinearMapEstimator(lam=1e-3).with_data(
        ArrayDataset.from_numpy(r.rand(64, D).astype(np.float32), "cpu"),
        ArrayDataset.from_numpy(r.rand(64, K).astype(np.float32),
                                "cpu")).fit()


def test_served_request_reconciles_its_trace_and_spans():
    with ServingPlane(max_batch=8, device="cpu") as plane:
        plane.admit("m", _fitted(), ItemSpec((D,), np.float32))
        out, trace_id = plane.predict_traced(
            "m", np.ones((3, D), np.float32), timeout_s=TIMEOUT)
        assert out.shape == (3, K) and trace_id.startswith("req-")
        with tracing_suppressed():
            req = plane.submit_request("m", np.ones((2, D), np.float32))
            req.future.result(timeout=TIMEOUT)
            assert req.trace is None
    spans = flight_recorder().spans()
    reqs = [s for s in spans if s.name == "request:m"]
    batches = [s for s in spans if s.name == "batch:m"]
    assert len(reqs) == 1 and batches
    assert reqs[0].args["trace_id"] == trace_id
    assert reqs[0].args["flow_out"] in batches[0].args["flow_in"]
    phases = reqs[0].args["phases_ms"]
    assert sum(phases.values()) == pytest.approx(reqs[0].dur_s * 1e3,
                                                 rel=1e-6)
    reg = MetricsRegistry.get_or_create()
    assert reg.histogram("serving.phase_ms.dispatch.m").count == 1
    assert exemplar_reservoir().slowest(1, model="m")[0].trace_id == \
        trace_id


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def test_http_trace_header_slo_and_debug_slow():
    policy = SloPolicy(latency_threshold_ms=5000.0,
                       availability_target=0.5, window=16, min_count=4)
    with ServingPlane(max_batch=8, device="cpu",
                      slo_policy=policy) as plane:
        plane.admit("m", _fitted(), ItemSpec((D,), np.float32))
        server = serve(plane, port=0)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_port}/predict/m",
                data=json.dumps({"instances": [[0.5] * D] * 2}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                trace_id = resp.headers["X-Keystone-Trace"]
            assert trace_id.startswith("req-")
            _, _, slo = _get(server.server_port, "/slo")
            assert slo["policy"]["latency_threshold_ms"] == 5000.0
            assert slo["models"]["m"]["good"] == 1
            _, _, slow = _get(server.server_port, "/debug/slow?n=4&model=m")
            assert [t["trace_id"] for t in slow["slowest"]] == [trace_id]
        finally:
            server.shutdown()
