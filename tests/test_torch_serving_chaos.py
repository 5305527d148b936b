"""The port's chaos catalogue (``keystone_tpu_torch/serving/scenarios``)
and the ``serve.*`` fault sites, on CPU planes:

* every scenario of the JAX catalogue runs here at its JAX floors, at
  its catalogue seed, with zero unclassified outcomes and zero wedged
  workers (windows shortened as the JAX suite shortens them; the churn
  and fleet scenarios keep their full windows, which their checks need);
* the catalogue is the JAX catalogue: the same names and the same
  floors;
* graceful degradation at each fault site: a deadline shed before
  dispatch, a poisoned batch failing classified with a post-mortem while
  the worker goes on, a hung dispatch ending at close, an admission
  fault mid-warmup rolled back atomically, an eviction fault leaving the
  model serving, a failed batch epilogue recording each request once.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from keystone_tpu.serving.scenarios import load_catalogue as jcatalogue
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.resilience import FaultPlan
from keystone_tpu_torch.resilience.retry import TransientError
from keystone_tpu_torch.serving import (DeadlineExpiredError, ItemSpec,
                                        PoisonedBatchError, ServingPlane)
from keystone_tpu_torch.serving.scenarios import (load_catalogue,
                                                  run_scenario)

D, K = 6, 2
TIMEOUT = 10.0

#: the window each scenario runs here (None: its catalogue window)
WINDOWS = {"burst": 0.6, "diurnal": 0.8, "straggler_dispatch": 0.6,
           "poisoned_batch": 0.6, "overload_shed": 0.3, "zipf_churn": None,
           "replica_death": None, "migration_under_load": None}


@pytest.fixture(autouse=True)
def _postmortems(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR", str(tmp_path))


def test_catalogue_matches_the_jax_catalogue():
    ours, theirs = load_catalogue(), jcatalogue()
    assert sorted(ours) == sorted(theirs) == sorted(WINDOWS)
    for name, sc in ours.items():
        assert sc.floors.p99_ms == theirs[name].floors.p99_ms
        assert sc.floors.availability == theirs[name].floors.availability
        assert sc.queue_depth == theirs[name].queue_depth
        assert sc.senders == theirs[name].senders
        assert sc.spec_fn(0) == sc.spec_fn(0)


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_scenario_runs_clean_at_the_jax_floors(name):
    load_catalogue()  # the registry fills on import of the scenarios
    res = run_scenario(name, seed=0, duration_s=WINDOWS[name], device="cpu")
    assert res.report.outcomes["unclassified"] == 0
    assert res.clean, (res.violations, res.report.summary())
    assert res.p99_ms <= res.floors.p99_ms
    assert res.availability >= res.floors.availability


def _fitted():
    r = np.random.RandomState(0)
    X = r.rand(96, D).astype(np.float32)
    return LinearMapEstimator(lam=1e-3).with_data(
        ArrayDataset.from_numpy(X, "cpu"),
        ArrayDataset.from_numpy(r.rand(96, K).astype(np.float32),
                                "cpu")).fit(), X


@pytest.fixture
def plane_factory():
    planes = []

    def make(**kw):
        kw.setdefault("max_batch", 8)
        plane = ServingPlane(device="cpu", **kw).start()
        planes.append(plane)
        return plane

    yield make
    for plane in planes:
        plane.close()


def _served(make, **kw):
    fitted, X = _fitted()
    plane = make(**kw)
    plane.admit("m", fitted, ItemSpec((D,), np.float32))
    return plane, X


def test_deadline_shed_before_dispatch(plane_factory):
    plane, X = _served(plane_factory)
    executed = []
    orig = plane._execute
    plane._execute = lambda *a: executed.append(a) or orig(*a)
    reg = MetricsRegistry.get_or_create()
    shed0 = reg.counter("serving.shed_total").value
    req = plane.submit_request("m", X[:2], deadline_ms=1e-4)
    with pytest.raises(DeadlineExpiredError):
        req.future.result(timeout=TIMEOUT)
    assert executed == []
    assert reg.counter("serving.shed_total").value == shed0 + 1
    assert plane.predict("m", X[:3], timeout_s=TIMEOUT).shape == (3, K)


def test_poisoned_batch_fails_classified_and_worker_survives(plane_factory):
    plane, X = _served(plane_factory, postmortem_min_interval_s=0.0)
    with FaultPlan(0).add("serve.dispatch", kind="corrupt", count=1):
        with pytest.raises(PoisonedBatchError) as err:
            plane.predict("m", X[:4], timeout_s=TIMEOUT)
    assert getattr(err.value, "postmortem_path", None)
    assert np.isfinite(plane.predict("m", X[:4], timeout_s=TIMEOUT)).all()


def test_hang_injection_ends_at_close(plane_factory):
    plane, X = _served(plane_factory)
    with FaultPlan(0).add("serve.dispatch", kind="hang", delay_s=8.0,
                          count=1):
        plane.submit("m", X[:2])
        time.sleep(0.3)
        worker = plane._worker
        t0 = time.perf_counter()
        plane.close()
        assert time.perf_counter() - t0 < 5.0
    assert not worker.is_alive()


def test_admit_fault_mid_warmup_rolls_back(plane_factory):
    fitted, X = _fitted()
    plane = plane_factory()
    with FaultPlan(0).add("serve.admit", kind="error", after=1,
                          count=1) as fp:
        with pytest.raises(TransientError):
            plane.admit("m", fitted, ItemSpec((D,), np.float32))
        assert fp.injections("serve.admit") == 1
    s = plane.state()
    assert s["models"] == [] and s["warming"] == 0
    assert plane.ledger.used() == 0 and plane.ready()
    plane.admit("m", fitted, ItemSpec((D,), np.float32))
    assert plane.predict("m", X[:2], timeout_s=TIMEOUT).shape == (2, K)


def test_evict_fault_leaves_the_model_serving(plane_factory):
    plane, X = _served(plane_factory)
    with FaultPlan(0).add("serve.evict", kind="error", count=1):
        with pytest.raises(TransientError):
            plane.evict("m")
    assert "m" not in plane.state()["evicted"]
    assert plane.predict("m", X[:2], timeout_s=TIMEOUT).shape == (2, K)
    plane.evict("m")
    assert plane.state()["evicted"] == ["m"]


def test_enqueue_fault_refuses_before_the_slot_gate(plane_factory):
    plane, X = _served(plane_factory)
    with FaultPlan(0).add("serve.enqueue", kind="error", count=1):
        with pytest.raises(TransientError):
            plane.submit("m", X[:1])
    assert plane.batcher.depth() == 0
    assert plane.predict("m", X[:1], timeout_s=TIMEOUT).shape == (1, K)


def test_failed_epilogue_records_each_request_once(plane_factory):
    plane, X = _served(plane_factory, postmortem_min_interval_s=0.0)
    reg = MetricsRegistry.get_or_create()
    errors0 = reg.counter("serving.errors_total").value

    def boom(*a, **kw):
        raise RuntimeError("late epilogue failure")

    plane._record_batch_trace = boom
    good0, bad0 = plane.slo.totals()
    assert plane.predict("m", X[:2], timeout_s=TIMEOUT).shape == (2, K)
    deadline = time.monotonic() + 5.0
    while (reg.counter("serving.errors_total").value == errors0
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert reg.counter("serving.errors_total").value == errors0 + 1
    good, bad = plane.slo.totals()
    assert (good - good0, bad - bad0) == (1, 0)
