"""The port's load generator (``keystone_tpu_torch/serving/loadgen.py``)
held against the JAX package's: the same ``LoadSpec`` gives the same
events, field for field, for every arrival process; the trace pinned by
sha256 in the JAX suite has the same sha256 here; and a replay against a
CPU plane, in process and over HTTP, classifies every outcome."""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from keystone_tpu.serving.loadgen import ChurnEvent as JChurnEvent
from keystone_tpu.serving.loadgen import LoadSpec as JLoadSpec
from keystone_tpu.serving.loadgen import generate_trace as jgenerate
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.serving import (ItemSpec, QueueFullError,
                                        ServingPlane, serve)
from keystone_tpu_torch.serving.loadgen import (ChurnEvent,
                                                HttpServingClient, LoadSpec,
                                                ReplayReport, _classify,
                                                generate_trace, replay)

D, K = 6, 2

SPECS = [
    dict(seed=0, duration_s=1.0, rate_rps=50.0, arrival="poisson",
         models=("a", "b", "c"), zipf_s=1.2, sizes=(1, 2, 4)),
    dict(seed=7, duration_s=1.5, rate_rps=260.0, arrival="bursty",
         models=("x", "y"), zipf_s=1.1, sizes=(1, 2, 4), burst_mult=4.0,
         burst_on_s=0.2, burst_off_s=0.2),
    dict(seed=3, duration_s=1.6, rate_rps=220.0, arrival="diurnal",
         models=("d1", "d2"), zipf_s=1.2, sizes=(1, 2, 4, 8, 64),
         diurnal_amp=0.8, diurnal_period_s=1.6),
    dict(seed=11, duration_s=0.8, rate_rps=1200.0, arrival="bursty",
         models=("o",), zipf_s=1.0, sizes=(1, 2), burst_mult=3.0,
         burst_on_s=0.3, burst_off_s=0.1, deadline_ms=150.0),
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["arrival"] +
                         str(s["seed"]))
def test_trace_matches_the_jax_generator(spec):
    churn = ((0.5, "evict", spec["models"][-1]),
             (0.2, "readmit", spec["models"][-1]))
    ours = generate_trace(LoadSpec(
        **spec, churn=tuple(ChurnEvent(*c) for c in churn)))
    theirs = jgenerate(JLoadSpec(
        **spec, churn=tuple(JChurnEvent(*c) for c in churn)))
    assert len(ours.arrivals) == len(theirs.arrivals) > 10
    assert [(e.t_s, e.model, e.n, e.seq) for e in ours.arrivals] == \
        [(e.t_s, e.model, e.n, e.seq) for e in theirs.arrivals]
    assert [(c.t_s, c.action, c.model) for c in ours.churn] == \
        [(c.t_s, c.action, c.model) for c in theirs.churn]
    assert ours.churn[0].t_s < ours.churn[1].t_s


def test_trace_sha_equals_the_jax_pin():
    """The trace ``tests/test_fleet.py`` pins, serialized the same way,
    hashes to the same sha256 the JAX suite pins."""
    spec = LoadSpec(seed=31, duration_s=3.0, rate_rps=90.0,
                    arrival="poisson", models=("alpha", "beta", "gamma"),
                    zipf_s=1.2, sizes=(1, 2, 4))
    canon = json.dumps([[repr(ev.t_s), ev.model, ev.n, ev.seq]
                        for ev in generate_trace(spec).arrivals],
                       separators=(",", ":")).encode()
    assert hashlib.sha256(canon).hexdigest() == (
        "5d3894809a7c3fb96666558c4f4829061e5125a79cd76a4e0cbdfbe7bc02c59e")


def test_spec_validation():
    with pytest.raises(ValueError):
        LoadSpec(arrival="square")
    with pytest.raises(ValueError):
        LoadSpec(duration_s=0.0)
    with pytest.raises(ValueError):
        LoadSpec(models=())
    with pytest.raises(ValueError):
        LoadSpec(diurnal_amp=1.0)


def test_report_accounting():
    rep = ReplayReport()
    rep.outcomes.update(ok=8, rejected=3, shed=1, not_admitted=1)
    rep.latencies_ms.extend([1.0, 2.0, 3.0, 100.0])
    assert rep.total == 13 and rep.accepted == 9
    assert rep.availability() == pytest.approx(8 / 9)
    assert rep.p50_ms() == pytest.approx(2.5)
    assert rep.summary()["outcomes"]["rejected"] == 3
    assert _classify(QueueFullError("x")) == "rejected"
    assert _classify(KeyError("x")) == "unclassified"


def _plane():
    r = np.random.RandomState(0)
    fitted = LinearMapEstimator(lam=1e-3).with_data(
        ArrayDataset.from_numpy(r.rand(64, D).astype(np.float32), "cpu"),
        ArrayDataset.from_numpy(r.rand(64, K).astype(np.float32),
                                "cpu")).fit()
    plane = ServingPlane(max_batch=8, device="cpu").start()
    for name in ("a", "b"):
        plane.admit(name, fitted, ItemSpec((D,), np.float32))
    return plane


def _input(model, n):
    return np.full((n, D), 0.5, np.float32)


def test_replay_in_process_and_over_http_classifies_everything():
    plane = _plane()
    server = serve(plane, port=0)
    try:
        trace = generate_trace(LoadSpec(
            seed=5, duration_s=0.4, rate_rps=150.0, models=("a", "b", "c"),
            sizes=(1, 2, 4)))
        local = replay(trace, plane, _input, senders=4)
        remote = replay(trace, HttpServingClient("127.0.0.1",
                                                 server.server_port),
                        _input, senders=4)
    finally:
        server.shutdown()
        plane.close()
    for rep in (local, remote):
        assert rep.total == len(trace.arrivals)
        assert rep.outcomes["unclassified"] == 0
        # "c" was never admitted: routing verdicts, not failures
        want_c = sum(1 for e in trace.arrivals if e.model == "c")
        assert rep.outcomes["not_admitted"] == want_c
        assert rep.outcomes["ok"] == rep.total - want_c
        assert rep.availability() == 1.0
