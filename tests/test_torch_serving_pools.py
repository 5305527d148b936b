"""The serving plane's admission charge and its graph pools, on the CPU.

The charge: ``keystone_tpu_torch.serving.residency.model_charge``
against ``keystone_tpu.serving.residency.model_charge`` on the same
seeded ``LinearMapEstimator`` pipelines (the static plan, at one and two
data shards), and on a pipeline whose plan cannot size the activation
(the probe, in both packages). Charges agree to a relative 1e-9.

The pools: a CPU plane captures nothing, so these tests serve through
:class:`FakeGraphPlane`, a plane whose one capture step
(``ServingPlane._new_graph``) makes a stand-in graph that replays the
eager apply and records which pool it was given; everything else (the
admission, the memo, the free list, the release gate, the workers) is
the plane's own, with the release callable injected
(``graphs.GraphPools(release=...)``).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.parallel.dataset import ArrayDataset, \
    bucketed_dataset
from keystone_tpu_torch.serving import (ItemSpec, ModelNotAdmitted,
                                       ModelWarming, ServingPlane)
from keystone_tpu_torch.serving.graphs import (GraphPools, ReleaseGate,
                                               release_gate)
from keystone_tpu_torch.serving.residency import model_charge
from keystone_tpu_torch.workflow.transformer import Transformer

from test_torch_concurrency_sched import chaos

TIMEOUT = 30
#: the charges of the two packages agree to this relative tolerance
CHARGE_RTOL = 1e-9


# -- the charge against the JAX package --------------------------------------------

def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    return jax


def _linear_pair(d, k, seed):
    from keystone_tpu.nodes.learning.linear import \
        LinearMapEstimator as JLinearMapEstimator
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset

    r = np.random.RandomState(seed)
    X = r.rand(96, d).astype(np.float32)
    Y = r.rand(96, k).astype(np.float32)
    ours = LinearMapEstimator(lam=1e-3).with_data(
        ArrayDataset.from_numpy(X, "cpu"),
        ArrayDataset.from_numpy(Y, "cpu")).fit()
    theirs = JLinearMapEstimator(lam=1e-3).with_data(
        JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(Y)).fit()
    return ours, theirs


def _same_charge(ours, theirs):
    assert ours.source == theirs.source
    for field in ("model_nbytes", "item_nbytes"):
        assert getattr(ours, field) == pytest.approx(
            getattr(theirs, field), rel=CHARGE_RTOL), field
    assert ours.total_nbytes() == pytest.approx(theirs.total_nbytes(),
                                                rel=CHARGE_RTOL)
    assert ours.graph_nbytes == 0.0


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("d,k,seed", [(24, 3, 1), (32, 4, 2), (256, 10, 3)])
def test_charge_is_the_jax_packages_static_plan(d, k, seed, shards):
    from keystone_tpu.serving.residency import model_charge as jcharge

    jax = _jax()
    ours, theirs = _linear_pair(d, k, seed)
    got = model_charge(ours, np.zeros((1, d), np.float32), 16,
                       data_shards=shards, device="cpu")
    want = jcharge(theirs, jax.ShapeDtypeStruct((d,), np.float32), 16,
                   data_shards=shards)
    assert got.source == "static-plan"
    _same_charge(got, want)
    if shards > 1:
        assert got.shardable_nbytes == pytest.approx(want.shardable_nbytes)
        assert got.gather_nbytes == pytest.approx(want.gather_nbytes)


class _HostWiden(Transformer):
    """A host stage the analyzer cannot see through: 16 values a row,
    computed on the host from the rows it is given."""

    def apply(self, x):
        return self.apply_batch(x[None])[0]

    def apply_batch(self, X):
        H = np.asarray(X.cpu())
        return torch.as_tensor(np.ones((H.shape[0], 16), np.float32)
                               + H.sum())


def _jax_host_widen():
    import jax.numpy as jnp
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.workflow.transformer import Transformer as JTransformer

    class JHostWiden(JTransformer):
        def apply(self, x):
            return jnp.asarray(np.ones((16,), np.float32)
                               + np.asarray(x).sum())

        def apply_dataset(self, ds):
            H = np.asarray(ds.data)
            return JArrayDataset.from_numpy(
                np.ones((H.shape[0], 16), np.float32) + H.sum())

    return JHostWiden()


@pytest.mark.parametrize("shards", [1, 2])
def test_an_unresolved_plan_is_probed_in_both_packages(shards):
    """A zero-width item through a host stage: the plan sizes no
    activation and lists the stage unresolved, so both packages probe
    one item."""
    from keystone_tpu.serving.residency import model_charge as jcharge

    jax = _jax()
    got = model_charge(_HostWiden().to_pipeline(),
                       np.zeros((1, 0), np.float32), 16,
                       data_shards=shards, device="cpu")
    want = jcharge(_jax_host_widen().to_pipeline(),
                   jax.ShapeDtypeStruct((0,), np.float32), 16,
                   data_shards=shards)
    assert got.source == want.source == "probed"
    assert got.item_nbytes == 64.0
    _same_charge(got, want)


# -- the release gate ----------------------------------------------------------------

def _until(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.002)


def test_a_release_asked_in_flight_runs_after_the_batch_ends():
    gate = ReleaseGate()
    in_batch, end_batch = threading.Event(), threading.Event()
    ran, entered_late = [], threading.Event()

    def worker():
        with gate.batch():
            in_batch.set()
            end_batch.wait(TIMEOUT)

    def late_worker():
        with gate.batch():
            entered_late.set()

    t = threading.Thread(target=worker)
    t.start()
    assert in_batch.wait(TIMEOUT)
    gate.release(lambda: ran.append(gate.stats()["inflight"]))
    time.sleep(0.05)
    assert ran == []                         # the batch is in flight
    late = threading.Thread(target=late_worker)
    late.start()
    time.sleep(0.05)
    assert not entered_late.is_set()         # a pending release holds it
    end_batch.set()
    t.join(TIMEOUT)
    _until(lambda: ran and entered_late.is_set())
    late.join(TIMEOUT)
    assert ran == [0]
    stats = gate.stats()
    assert stats["releases"] == 1 and len(stats["release_s"]) == 1
    assert stats["max_wait_s"] > 0 and stats["inflight"] == 0


def test_wait_drained_waits_only_for_batches_of_older_epochs():
    gate = ReleaseGate()
    holds = {name: threading.Event() for name in ("old", "new")}
    inside = {name: threading.Event() for name in ("old", "new")}

    def worker(name):
        with gate.batch():
            inside[name].set()
            holds[name].wait(TIMEOUT)

    old = threading.Thread(target=worker, args=("old",))
    old.start()
    assert inside["old"].wait(TIMEOUT)
    epoch = gate.mark()
    new = threading.Thread(target=worker, args=("new",))
    new.start()
    assert inside["new"].wait(TIMEOUT)
    drained = threading.Event()
    waiter = threading.Thread(
        target=lambda: (gate.wait_drained(epoch), drained.set()))
    waiter.start()
    time.sleep(0.05)
    assert not drained.is_set()
    holds["old"].set()
    assert drained.wait(TIMEOUT)             # the newer batch goes on
    assert gate.stats()["inflight"] == 1
    holds["new"].set()
    for t in (old, new, waiter):
        t.join(TIMEOUT)


def test_a_failing_release_reaches_a_waiting_caller_and_opens_the_gate():
    gate = ReleaseGate()

    def boom():
        raise RuntimeError("release failed")

    with pytest.raises(RuntimeError, match="release failed"):
        gate.release(boom, wait=True)
    with gate.batch():
        assert gate.stats()["inflight"] == 1


def test_gate_under_many_workers_runs_releases_only_between_batches():
    """More workers than cores enter and leave batches while releases
    are asked for, at a short switch interval: every release sees no
    batch in flight, every batch sees no release running, and the
    counts end at zero."""
    import sys

    gate = ReleaseGate()
    running = [0, 0]          # [batches inside, releases inside]
    lock = threading.Lock()
    errors, stop = [], threading.Event()
    workers = (os.cpu_count() or 4) + 4

    def batch_loop():
        while not stop.is_set():
            with gate.batch():
                with lock:
                    running[0] += 1
                    if running[1]:
                        errors.append("batch beside a release")
                time.sleep(0)
                with lock:
                    running[0] -= 1

    def release():
        with lock:
            running[1] += 1
            if running[0]:
                errors.append("release beside a batch")
        time.sleep(0)
        with lock:
            running[1] -= 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=batch_loop)
                   for _ in range(workers)]
        for t in threads:
            t.start()
        for i in range(40):
            gate.release(release, wait=(i % 8 == 7))
        gate.release(release, wait=True)
    finally:
        stop.set()
        for t in threads:
            t.join(TIMEOUT)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    stats = gate.stats()
    assert stats["releases"] == 41 and stats["inflight"] == 0


# -- a plane whose captures are stand-ins ----------------------------------------------

class FakeGraph:
    """A stand-in for a captured bucket: replays the eager apply, holds
    one pool id, and refuses to share it with another live graph."""

    live_by_pool = {}
    lock = threading.Lock()

    def __init__(self, fitted, bucket, pool_id, nbytes):
        self.fitted = fitted
        self.bucket = bucket
        self.pool_id = pool_id
        self.pool_nbytes = float(nbytes)
        self.wall_s = 0.0
        self.retired = False
        with FakeGraph.lock:
            holder = FakeGraph.live_by_pool.get(pool_id)
            assert holder is None or holder.retired, \
                f"pool {pool_id} would serve two live graphs"
            FakeGraph.live_by_pool[pool_id] = self

    def pool(self):
        return self.pool_id

    def retire(self):
        self.retired = True

    def replay(self, x_tree, n):
        assert not self.retired, "a retired graph was replayed"
        ds = bucketed_dataset(x_tree, n, self.bucket, "cpu")
        out = self.fitted.apply(ds).get().numpy()
        time.sleep(0.001)     # the device's share of a replay
        # a pool reused while its old graph still ran would be overwritten
        assert not self.retired, "a graph was retired while it replayed"
        return out


class FakeGraphPlane(ServingPlane):
    """A CPU plane that serves every bucket from a :class:`FakeGraph`;
    its pools are released through ``release``."""

    captures_graphs = True
    _ids = iter(range(1, 1 << 30))

    def __init__(self, release=None, **kw):
        kw.setdefault("device", "cpu")
        kw.setdefault("max_batch", 8)
        super().__init__(**kw)
        self.released = []
        self.pools_given = []
        self.triggers = []
        if release is None:
            def release(graphs):
                self.released.append(
                    (len(graphs), release_gate().stats()["inflight"]))
                graphs.clear()
        self._pools = GraphPools(self._free_bound, release=release)

    def _new_graph(self, name, fitted, sample, bucket, trigger, holder):
        pool = holder.pool() if holder is not None else next(self._ids)
        self.pools_given.append((name, bucket, pool, holder is not None))
        self.triggers.append(trigger)
        return FakeGraph(fitted, bucket, pool, 1000.0 * bucket)


D, K = 6, 2


def _fitted(seed=0, d=D, k=K):
    r = np.random.RandomState(seed)
    X = r.rand(64, d).astype(np.float32)
    Y = r.rand(64, k).astype(np.float32)
    return LinearMapEstimator(lam=1e-3).with_data(
        ArrayDataset.from_numpy(X, "cpu"),
        ArrayDataset.from_numpy(Y, "cpu")).fit(), X


def _apply(fitted, X):
    return fitted.apply(ArrayDataset.from_numpy(X, "cpu")).numpy()


@pytest.fixture
def planes():
    made = []

    def make(**kw):
        plane = FakeGraphPlane(**kw)
        made.append(plane)
        return plane.start()

    yield make
    for plane in made:
        plane.close()


def _counter(name):
    return MetricsRegistry.get_or_create().counter(name).value


def _budget_for(models, extra=0.0):
    """A budget of the models' charges on a FakeGraphPlane, plus
    ``extra`` bytes."""
    probe = FakeGraphPlane()
    try:
        total = 0.0
        for i, (fitted, _) in enumerate(models):
            total += probe.admit(f"p{i}", fitted,
                                 ItemSpec((D,), np.float32)
                                 ).charge.total_nbytes()
    finally:
        probe.close()
    return total + extra


def test_admission_serves_the_graphs_its_charge_measured(planes):
    fitted, X = _fitted(1)
    plane = planes()
    e = plane.admit("m", fitted, ItemSpec((D,), np.float32))
    buckets = list(plane.policy.rows())
    assert e.captures == len(buckets) and len(plane._graphs) == len(buckets)
    assert [b for _, b, _, _ in plane.pools_given] == buckets
    assert e.charge.source == "static-plan"
    assert e.charge.pool_nbytes == e.graph_pool_nbytes == \
        1000.0 * sum(buckets)
    in_row = 4 * D
    assert e.charge.graph_nbytes == pytest.approx(
        e.charge.pool_nbytes + in_row * sum(buckets))
    for n in (1, 3, 8):
        np.testing.assert_allclose(plane.predict("m", X[:n],
                                                 timeout_s=TIMEOUT),
                                   _apply(fitted, X[:n]), rtol=1e-6,
                                   atol=1e-6)


def test_readmission_takes_its_pools_from_the_free_list(planes):
    models = [_fitted(2), _fitted(3)]
    plane = planes(hbm_budget=_budget_for(models))
    spec = ItemSpec((D,), np.float32)
    for i, (fitted, _) in enumerate(models):
        plane.admit(f"m{i}", fitted, spec)
    X = models[0][1]
    before = plane.predict("m0", X[:5], timeout_s=TIMEOUT)
    first = {b: p for name, b, p, _ in plane.pools_given if name == "m0"}
    reuses0 = _counter("serving.pool_reuses")
    plane.evict("m0")
    assert len(plane._pools) == len(first) and plane.released == []
    plane.readmit("m0")
    again = {b: (p, reused) for name, b, p, reused
             in plane.pools_given[-len(first):]}
    assert again == {b: (p, True) for b, p in first.items()}
    assert _counter("serving.pool_reuses") - reuses0 == len(first)
    assert len(plane._pools) == 0 and plane.released == []
    np.testing.assert_array_equal(
        plane.predict("m0", X[:5], timeout_s=TIMEOUT), before)


def test_evict_returns_while_an_injected_release_blocks(planes):
    """An admission that evicts the one resident parks its pools past
    the headroom left, so a release is asked for; the injected release
    blocks, and an eviction meanwhile returns at once."""
    hold, started, done = threading.Event(), threading.Event(), []

    def blocking_release(graphs):
        started.set()
        hold.wait(TIMEOUT)
        done.append(len(graphs))

    m0, m1 = _fitted(4), _fitted(14)
    plane = planes(release=blocking_release,
                   hbm_budget=_budget_for([m0], extra=100.0))
    spec = ItemSpec((D,), np.float32)
    plane.admit("m0", m0[0], spec)
    try:
        plane.admit("m1", m1[0], spec)       # evicts m0
        assert started.wait(TIMEOUT)
        assert plane.state()["evicted"] == ["m0"]
        t0 = time.perf_counter()
        plane.evict("m1")
        assert time.perf_counter() - t0 < TIMEOUT / 2
        assert done == [] and plane.state()["evicted"] == ["m0", "m1"]
        # m1's pools stay parked: the headroom is back
        assert len(plane._pools) == len(plane.policy.rows())
    finally:
        hold.set()
    _until(lambda: done)
    assert done == [len(plane.policy.rows())]


def test_a_plane_without_budget_parks_up_to_its_own_peak(planes):
    """With no budget, evicting the only model keeps its pools (the
    plane held them before) and its readmission reuses them."""
    fitted, _ = _fitted(15)
    plane = planes()
    spec = ItemSpec((D,), np.float32)
    plane.admit("m", fitted, spec)
    buckets = len(plane.policy.rows())
    plane.evict("m")
    assert len(plane._pools) == buckets and plane.released == []
    plane.readmit("m")
    assert len(plane._pools) == 0 and plane.released == []
    assert [r for _, _, _, r in plane.pools_given[-buckets:]] == \
        [True] * buckets


def test_close_runs_every_pending_release(planes):
    models = [_fitted(5), _fitted(6)]
    plane = planes(hbm_budget=_budget_for(models))
    spec = ItemSpec((D,), np.float32)
    for i, (fitted, _) in enumerate(models):
        plane.admit(f"m{i}", fitted, spec)
    plane.evict("m1")
    buckets = len(plane.policy.rows())
    assert len(plane._pools) == buckets and plane.released == []
    releases0 = release_gate().stats()["releases"]
    plane.close()
    # one release, waited for, of the parked pools and the live graphs
    assert plane.released == [(2 * buckets, 0)]
    assert release_gate().stats()["releases"] == releases0 + 1
    assert len(plane._pools) == 0 and len(plane._graphs) == 0


def test_the_free_list_is_bounded_by_the_ledger_headroom(planes):
    """Three models fill the budget; a fourth evicts one, whose parked
    pools pass the headroom left: they are released, outside any batch."""
    models = [_fitted(s) for s in (7, 8, 9)]
    plane = planes(hbm_budget=_budget_for(models, extra=100.0))
    spec = ItemSpec((D,), np.float32)
    for i, (fitted, _) in enumerate(models):
        plane.admit(f"m{i}", fitted, spec)
    assert plane.released == []
    plane.admit("m3", _fitted(10)[0], spec)
    _until(lambda: plane.released)
    assert plane.released == [(len(plane.policy.rows()), 0)]
    assert plane._pools.nbytes() <= plane._free_bound()
    assert len(plane.state()["evicted"]) == 1


def test_a_refused_admission_parks_its_graphs(planes):
    fitted, _ = _fitted(11)
    plane = planes(hbm_budget=1.0)
    with pytest.raises(MemoryError):
        plane.admit("m", fitted, ItemSpec((D,), np.float32))
    state = plane.state()
    assert state["models"] == [] and state["warming"] == 0
    assert len(plane._graphs) == 0
    # a 1-byte budget leaves no headroom: the parked pools are released
    _until(lambda: plane.released)
    assert plane.released == [(len(plane.policy.rows()), 0)]


# -- evict, readmit and a worker's batch under the schedule harness -----------------

def _churn_one_seed(seed, planes):
    fitted, X = _fitted(12)
    other, _ = _fitted(13)
    plane = planes(hbm_budget=_budget_for([(fitted, X), (other, X)]))
    spec = ItemSpec((D,), np.float32)
    plane.admit("hot", other, spec)
    plane.admit("m", fitted, spec)
    # what the model served before any churn: every answer after an
    # eviction and readmission must be these bits
    want = {n: plane.predict("m", X[:n], timeout_s=TIMEOUT)
            for n in (1, 3, 8)}
    for n in (1, 3, 8):
        np.testing.assert_allclose(want[n], _apply(fitted, X[:n]),
                                   rtol=1e-6, atol=1e-6)
    errors, stop = [], threading.Event()
    answered = []

    def client():
        while not stop.is_set():
            for n in (1, 3, 8):
                try:
                    got = plane.predict("m", X[:n], timeout_s=TIMEOUT)
                except (ModelNotAdmitted, ModelWarming):
                    continue
                except Exception as exc:  # noqa: BLE001 - fails the test
                    errors.append(repr(exc))
                    continue
                if not np.array_equal(got, want[n]):
                    errors.append(n)
                answered.append(n)

    reuses0 = _counter("serving.pool_reuses")
    with chaos(seed=seed, sleep_p=0.3, max_sleep_s=2e-4):
        t = threading.Thread(target=client)
        t.start()
        try:
            for _ in range(3):
                # each cycle starts once the client has been answered
                # again: the worker's batches interleave with the churn
                seen = len(answered)
                _until(lambda: len(answered) > seen or errors)
                plane.evict("m")
                plane.readmit("m")
        finally:
            stop.set()
            t.join(TIMEOUT)
    assert not errors, (seed, errors)
    assert answered, seed
    assert plane.released == [], seed
    buckets = len(plane.policy.rows())
    assert _counter("serving.pool_reuses") - reuses0 == 3 * buckets, seed
    # every capture was an admission's: a batch that raced an eviction
    # got a routing verdict, never a capture of an evicted model
    assert set(plane.triggers) == {"admission"}, seed
    plane.close()
    assert all(inflight == 0 for _, inflight in plane.released), seed


def test_evict_readmit_and_a_batch_interleave_at_bounded_seeds(planes):
    for seed in range(6):
        _churn_one_seed(seed, planes)
