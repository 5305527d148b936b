"""Deterministic-interleaving schedules over the port's instrumented
primitives, and seeded stress.

The schedule harness lives here (the JAX package's is
``tests/sched.py``): :class:`DeterministicScheduler` runs the threads it
spawned one at a time between yield points, picking who runs next from
a script (a regression schedule) or a seeded RNG; the yield points are
every ``TracedLock`` / ``TracedSemaphore`` operation (through
``utils.guarded.set_sched_hook``) and explicit ``yield_point`` calls that
mark a racy window. :func:`chaos` perturbs the same points with seeded
sleeps, for real threaded paths (the prefetcher).

Each historical race of the JAX package that has a counterpart in the
port carries a schedule that reproduces it on an unfixed copy and
passes on the port: the resilience-stats read-modify-write, the
residency-ledger close, the histogram and flight-recorder ring writers
and the capture-site stats; then the prefetcher's seeded fuzz at
bounded seeds. Nothing here imports JAX or the JAX package, so the file
also runs where JAX is absent (``tools/ci.py`` on the card, with
``--noconftest``).
"""
import contextlib
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import pytest

from keystone_tpu_torch.observability.compilelog import CompileObservatory
from keystone_tpu_torch.observability.metrics import Histogram
from keystone_tpu_torch.observability.timeline import FlightRecorder
from keystone_tpu_torch.observability.trace import PipelineTrace
from keystone_tpu_torch.parallel.streaming import (StreamingDataset,
                                                   _IterLedger, _Residency)
from keystone_tpu_torch.utils import guarded
from keystone_tpu_torch.utils.guarded import TracedLock, TracedSemaphore


# -- the harness ------------------------------------------------------------------

class ScheduleError(RuntimeError):
    """The schedule could not go on (a real deadlock, or max_steps)."""


class _TState:
    __slots__ = ("name", "thread", "parked", "finished", "tag")

    def __init__(self, name: str):
        self.name = name
        self.thread: Optional[threading.Thread] = None
        self.parked = False
        self.finished = False
        self.tag = ""


class DeterministicScheduler:
    """Cooperative scripted or seeded scheduler: every spawned thread
    starts parked; at each step the one picked (by ``picks``, thread
    names or substrings, then by the seeded RNG) runs to its next yield
    point. ``run`` re-raises the first exception a spawned thread died
    with; threads it did not spawn pass through yield points."""

    def __init__(self, seed: int = 0, picks: Optional[List[str]] = None,
                 max_steps: int = 20000):
        self._rng = random.Random(seed)
        self._picks = list(picks or [])
        self._max_steps = int(max_steps)
        self._cv = threading.Condition()
        self._by_thread: Dict[threading.Thread, _TState] = {}
        self._states: List[_TState] = []
        self._errors: List[tuple] = []
        self._stopping = False
        self.steps: List[str] = []

    def spawn(self, fn: Callable[..., Any], *args: Any,
              name: Optional[str] = None, **kwargs: Any) -> str:
        name = name or f"t{len(self._states)}"
        st = _TState(name)

        def body():
            self._park(st, "start")
            try:
                fn(*args, **kwargs)
            except BaseException as exc:  # re-raised by run()
                with self._cv:
                    self._errors.append((name, exc))
            finally:
                with self._cv:
                    st.finished = True
                    st.parked = False
                    self._cv.notify_all()

        st.thread = threading.Thread(target=body, name=f"sched-{name}",
                                     daemon=True)
        self._states.append(st)
        self._by_thread[st.thread] = st
        return name

    def yield_point(self, tag: str = "") -> None:
        st = self._by_thread.get(threading.current_thread())
        if st is None or self._stopping:
            return
        self._park(st, tag)

    def _park(self, st: _TState, tag: str) -> None:
        with self._cv:
            st.parked = True
            st.tag = tag
            self._cv.notify_all()
            while st.parked and not self._stopping:
                self._cv.wait(0.5)

    def _choose(self, parked: List[_TState]) -> _TState:
        while self._picks:
            pick = self._picks.pop(0)
            for st in parked:
                if st.name == pick or pick in st.name:
                    return st
        return self._rng.choice(sorted(parked, key=lambda s: s.name))

    def run(self, timeout: float = 30.0) -> None:
        for st in self._states:
            st.thread.start()
        deadline = time.monotonic() + timeout
        steps = 0
        try:
            with self._cv:
                while not self._errors:
                    live = [s for s in self._states if not s.finished]
                    if not live:
                        break
                    parked = [s for s in live if s.parked]
                    if len(parked) < len(live):
                        if not self._cv.wait(max(deadline - time.monotonic(),
                                                 0.01)):
                            raise ScheduleError(
                                "schedule stalled: "
                                f"{[s.name for s in live if not s.parked]} "
                                f"neither parked nor finished in "
                                f"{timeout:g}s")
                        continue
                    steps += 1
                    if steps > self._max_steps:
                        raise ScheduleError(f"more than {self._max_steps} "
                                            "steps")
                    nxt = self._choose(parked)
                    self.steps.append(f"{nxt.name}:{nxt.tag}")
                    nxt.parked = False
                    self._cv.notify_all()
        finally:
            with self._cv:
                self._stopping = True
                for s in self._states:
                    s.parked = False
                self._cv.notify_all()
            for s in self._states:
                s.thread.join(timeout=2.0)
        if self._errors:
            raise self._errors[0][1]

    def __enter__(self) -> "DeterministicScheduler":
        guarded.set_sched_hook(self.yield_point)
        return self

    def __exit__(self, *exc) -> None:
        guarded.set_sched_hook(None)


@contextlib.contextmanager
def chaos(seed: int = 0, sleep_p: float = 0.3, max_sleep_s: float = 1e-4):
    """Seeded perturbation at every TracedLock / TracedSemaphore yield
    point: a tiny sleep, a bare GIL yield, or nothing."""
    rng = random.Random(seed)
    lock = threading.Lock()

    def hook(tag: str) -> None:
        with lock:
            r = rng.random()
        if r < sleep_p:
            time.sleep(r * max_sleep_s)
        elif r < 2 * sleep_p:
            time.sleep(0)

    guarded.set_sched_hook(hook)
    try:
        yield
    finally:
        guarded.set_sched_hook(None)


@pytest.fixture(autouse=True)
def _clean_hook():
    """The hook is process-wide: never leak one across tests."""
    yield
    guarded.set_sched_hook(None)


# -- the harness itself -------------------------------------------------------------

def test_scripted_picks_order_is_deterministic():
    log = []

    def worker(tag, sched):
        sched.yield_point(f"{tag}.mid")
        log.append(tag)

    sched = DeterministicScheduler(picks=["b", "b", "a", "a"])
    sched.spawn(worker, "a", sched, name="a")
    sched.spawn(worker, "b", sched, name="b")
    with sched:
        sched.run()
    assert log == ["b", "a"]


def test_seeded_schedules_replay_exactly():
    def run_once(seed):
        log = []

        def worker(tag, sched):
            for i in range(3):
                sched.yield_point(f"{tag}.{i}")
                log.append(f"{tag}{i}")

        sched = DeterministicScheduler(seed=seed)
        for t in ("a", "b", "c"):
            sched.spawn(worker, t, sched, name=t)
        with sched:
            sched.run()
        return log

    assert run_once(7) == run_once(7)
    assert any(run_once(7) != run_once(s) for s in range(1, 6))


def test_unregistered_threads_pass_through_yield_points():
    sched = DeterministicScheduler()
    done = threading.Event()

    def outsider():
        sched.yield_point("outsider")
        done.set()

    t = threading.Thread(target=outsider)
    t.start()
    t.join(timeout=5)
    assert done.is_set()


def test_spawned_thread_exception_propagates():
    def boom(sched):
        sched.yield_point("pre")
        raise ValueError("from schedule")

    sched = DeterministicScheduler()
    sched.spawn(boom, sched, name="boom")
    with sched, pytest.raises(ValueError, match="from schedule"):
        sched.run()


def test_traced_lock_waiters_park_instead_of_blocking():
    """A thread waiting on a TracedLock held by a parked sibling parks
    at a yield point: what keeps the scheduler live."""
    lock = TracedLock("t.park")
    order = []

    def holder(sched):
        with lock:
            sched.yield_point("holding")
            order.append("holder")

    def waiter():
        with lock:
            order.append("waiter")

    sched = DeterministicScheduler(picks=["h", "h", "w", "w", "h"])
    sched.spawn(holder, sched, name="h")
    sched.spawn(waiter, name="w")
    with sched:
        sched.run()
    assert order == ["holder", "waiter"]
    assert any(step.startswith("w:lock.wait:t.park")
               for step in sched.steps)


def test_traced_semaphore_waiters_park_too():
    sem = TracedSemaphore("t.sem", 1)
    order = []

    def holder(sched):
        sem.acquire()
        sched.yield_point("holding")
        order.append("holder")
        sem.release()

    def waiter():
        assert sem.acquire(timeout=5.0)
        order.append("waiter")
        sem.release()

    sched = DeterministicScheduler(picks=["h", "h", "w", "w", "h"])
    sched.spawn(holder, sched, name="h")
    sched.spawn(waiter, name="w")
    with sched:
        sched.run()
    assert order == ["holder", "waiter"]


class _CountingLock:
    """Stands in for a TracedLock's inner ``threading.Lock``, counting
    the calls the wrapper makes."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        self.calls.append(("acquire", blocking))
        return self._lock.acquire(blocking, timeout)

    def release(self):
        self.calls.append(("release",))
        self._lock.release()

    def locked(self):
        return self._lock.locked()


def test_traced_lock_fast_path_without_a_hook_is_one_try_acquire():
    """With no hook set, an uncontended acquire is the hook read and one
    non-blocking acquire of the inner lock, and nothing else."""
    assert guarded.sched_hook() is None
    lock = TracedLock("t.fast")
    inner = _CountingLock()
    lock._lock = inner
    with lock:
        pass
    assert inner.calls == [("acquire", False), ("release",)]
    sem = TracedSemaphore("t.fast.sem", 1)
    assert sem.acquire(blocking=False) and not sem.acquire(blocking=False)
    sem.release()


def test_a_set_hook_sees_every_operation_in_order():
    tags = []
    guarded.set_sched_hook(tags.append)
    lock = TracedLock("t.tags")
    sem = TracedSemaphore("t.tags", 1)
    with lock:
        pass
    sem.acquire()
    sem.release()
    guarded.set_sched_hook(None)
    assert tags == ["lock.acquire:t.tags", "lock.release:t.tags",
                    "sem.acquire:t.tags", "sem.release:t.tags"]


def test_traced_lock_timeout_and_nonblocking_under_a_hook():
    with chaos(seed=3):
        lock = TracedLock("t.timeouts")
        lock.acquire()
        assert not lock.acquire(blocking=False)
        assert not lock.acquire(timeout=0.05)
        lock.release()
        assert lock.acquire(timeout=0.05)
        lock.release()


# -- historical race 1: the resilience-stats read-modify-write ---------------------

class _YieldingDict(dict):
    """Parks after a read, inside the read-modify-write window: the
    same instrumented dict backs the unfixed copy and the port, so the
    lock is the only difference under a schedule."""

    def __init__(self, sched):
        super().__init__()
        self._sched = sched

    def get(self, key, default=None):
        value = super().get(key, default)
        self._sched.yield_point("dict.get")
        return value

    def setdefault(self, key, default=None):
        value = super().get(key)
        self._sched.yield_point("dict.setdefault")
        return super().setdefault(key, default) if value is None else value


class _UnfixedTrace(PipelineTrace):
    """``record_resilience`` without its lock."""

    def record_resilience(self, entry):
        event = str(entry.get("event", "other"))
        self.resilience_stats[event] = (
            self.resilience_stats.get(event, 0) + 1)
        self.resilience.append(entry)


_INTERLEAVE = ["a", "b"] * 12


def _drive_records(trace_obj, picks=None, seed=0, names=("a", "b")):
    sched = (DeterministicScheduler(picks=list(picks)) if picks is not None
             else DeterministicScheduler(seed=seed))
    trace_obj.resilience_stats = _YieldingDict(sched)
    for name in names:
        sched.spawn(trace_obj.record_resilience, {"event": "retry"},
                    name=name)
    with sched:
        sched.run()
    return int(dict.get(trace_obj.resilience_stats, "retry", 0))


def test_resilience_rmw_race_reproduces_on_unfixed_copy():
    assert _drive_records(_UnfixedTrace("sched"), _INTERLEAVE) == 1


def test_resilience_rmw_is_exact_on_the_port():
    assert _drive_records(PipelineTrace("sched"), _INTERLEAVE) == 2
    for seed in range(40):
        tr = PipelineTrace("sched")
        assert _drive_records(tr, seed=seed, names=("a", "b", "c")) == 3, \
            f"seed {seed}"
        assert len(tr.resilience) == 3


# -- historical race 2: the residency-ledger close ---------------------------------

_CLOSE_SCHEDULE = ["consumer", "consumer", "producer"] + ["producer"] * 8


def test_ledger_close_race_reproduces_on_unfixed_teardown():
    """The consumer closes the shared ledger while the producer is still
    mid-stage, and the producer never closes its own share: the stage
    that lands after the close inflates the residency for good."""
    res, it = _Residency(), _IterLedger()

    def producer(sched):
        sched.yield_point("mid-stage")
        res.stage(it, 100.0)

    def consumer():
        res.close(it)

    sched = DeterministicScheduler(picks=list(_CLOSE_SCHEDULE))
    sched.spawn(producer, sched, name="producer")
    sched.spawn(consumer, name="consumer")
    with sched:
        sched.run()
    assert res.live() == 100.0


def test_ledger_close_drains_in_both_orders_on_the_ports_contract():
    """The port's teardown contract (the producer closes its share once
    it sees stop; close is idempotent) drains the ledger under the
    leaking schedule and the benign one."""
    for picks in (_CLOSE_SCHEDULE, ["producer"] * 8 + ["consumer"] * 4):
        res, it = _Residency(), _IterLedger()
        stop = threading.Event()

        def producer(sched):
            sched.yield_point("mid-stage")
            res.stage(it, 100.0)
            if stop.is_set():
                res.close(it)

        def consumer():
            stop.set()
            res.close(it)

        sched = DeterministicScheduler(picks=list(picks))
        sched.spawn(producer, sched, name="producer")
        sched.spawn(consumer, name="consumer")
        with sched:
            sched.run()
        assert res.live() == 0.0, picks


def test_real_stream_early_exit_drains_the_ledger():
    """A real prefetched stream left after its second chunk, under seeded
    chaos at every lock and semaphore operation: nothing stays charged."""
    X = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    for seed in range(8):
        stream = StreamingDataset.from_numpy(X, 16, device="cpu")
        with chaos(seed=seed):
            chunks = stream.chunks()
            for i, _ in enumerate(chunks):
                if i == 1:
                    break
            chunks.close()
        deadline = time.monotonic() + 5.0
        while stream.buffered_nbytes() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert stream.buffered_nbytes() == 0.0, f"seed {seed}"


# -- historical race 3: the histogram and flight-recorder ring writers -------------

class _HistogramReplica:
    """``Histogram.observe``'s count update with its window marked:
    unlocked (the unfixed shape) or under a TracedLock (the port's
    shape, whose waiters park)."""

    def __init__(self, locked):
        self.count = 0
        self.locked = locked
        self._lock = TracedLock("hist.replica")

    def observe(self, sched):
        if self.locked:
            with self._lock:
                c = self.count
                sched.yield_point("rmw")
                self.count = c + 1
        else:
            c = self.count
            sched.yield_point("rmw")
            self.count = c + 1


def _drive_observes(locked, picks=None, seed=0, names=("a", "b")):
    h = _HistogramReplica(locked)
    sched = (DeterministicScheduler(picks=list(picks)) if picks is not None
             else DeterministicScheduler(seed=seed))
    for name in names:
        sched.spawn(h.observe, sched, name=name)
    with sched:
        sched.run()
    return h.count


def test_histogram_rmw_race_reproduces_unlocked():
    assert _drive_observes(False, ["a", "b"] * 8) == 1


def test_histogram_rmw_locked_shape_survives():
    assert _drive_observes(True, ["a", "b"] * 8) == 2
    for seed in range(20):
        assert _drive_observes(True, seed=seed, names="abc") == 3, \
            f"seed {seed}"


def test_shipped_histogram_exact_under_thread_hammer():
    h = Histogram("hammer")
    n, per = 8, 4000
    threads = [threading.Thread(
        target=lambda: [h.observe(1.0) for _ in range(per)])
        for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert h.count == n * per and h.total == float(n * per)
    assert len(h._tail) == Histogram.TAIL


class _RingReplica:
    """``FlightRecorder.record``'s slot write and index bump with the
    window marked, unlocked or under a TracedLock."""

    def __init__(self, locked, capacity=4):
        self.ring = [None] * capacity
        self.idx = 0
        self.total = 0
        self.locked = locked
        self._lock = TracedLock("ring.replica")

    def _record(self, sched, name):
        i = self.idx
        sched.yield_point("ring.rmw")
        self.ring[i % len(self.ring)] = name
        self.idx = i + 1
        self.total += 1

    def record(self, sched, name):
        if self.locked:
            with self._lock:
                self._record(sched, name)
        else:
            self._record(sched, name)


def _drive_ring(locked, picks, names=("a", "b"), capacity=4):
    ring = _RingReplica(locked, capacity)
    sched = DeterministicScheduler(picks=list(picks))
    for name in names:
        sched.spawn(ring.record, sched, f"span-{name}", name=name)
    with sched:
        sched.run()
    return ring


def test_ring_writer_race_reproduces_unlocked():
    ring = _drive_ring(False, ["a", "b"] * 8)
    assert len([s for s in ring.ring if s is not None]) == 1


def test_ring_writer_locked_shape_survives_and_wraps():
    ring = _drive_ring(True, ["a", "b"] * 8)
    assert sorted(s for s in ring.ring if s) == ["span-a", "span-b"]
    for picks in (["a", "b", "c"] * 6, ["c", "b", "a"] * 6):
        ring = _drive_ring(True, picks, names="abc", capacity=2)
        assert ring.total == 3 and ring.idx == 3
        assert sum(s is not None for s in ring.ring) == 2
        assert _drive_ring(False, picks, names="abc", capacity=2).idx < 3


def test_shipped_flight_recorder_exact_under_thread_hammer():
    rec = FlightRecorder(capacity=64, enabled=True)
    n, per = 8, 500
    threads = [threading.Thread(
        target=lambda: [rec.record("s", "hammer", 0.0, 0.0)
                        for _ in range(per)])
        for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert rec.total_recorded == n * per
    assert len(rec.spans()) == 64
    assert rec.dropped() == n * per - 64


# -- historical race 4: the capture-site stats --------------------------------------

def _unfixed_note_replay(obs, name):
    """The check-then-publish shape: the site looked up, created and
    published outside one lock hold, so two first replays each publish a
    fresh record and one count is lost with the orphaned dict."""
    site = obs._sites.get(name)
    if site is None:
        site = {"calls": 0, "captures": 0, "pool_nbytes": 0.0}
        with obs._lock:
            obs._sites[name] = site
    with obs._lock:
        site["calls"] += 1


def _drive_replays(fixed, picks=None, seed=0, names=("a", "b")):
    sched = (DeterministicScheduler(picks=list(picks)) if picks is not None
             else DeterministicScheduler(seed=seed))
    obs = CompileObservatory()
    obs._lock = TracedLock("test.observatory")  # waiters park
    obs._sites = _YieldingDict(sched)
    for name in names:
        sched.spawn(obs.note_replay if fixed else
                    (lambda: _unfixed_note_replay(obs, "site")),
                    *(("site",) if fixed else ()), name=name)
    with sched:
        sched.run()
    return obs


def test_capture_stats_lost_update_reproduces_on_unfixed_copy():
    obs = _drive_replays(False, ["a", "b"] * 8)
    assert dict.get(obs._sites, "site")["calls"] == 1


def test_capture_stats_are_exact_on_the_port():
    obs = _drive_replays(True, ["a", "b"] * 8)
    assert dict.get(obs._sites, "site")["calls"] == 2
    for seed in range(20):
        obs = _drive_replays(True, seed=seed, names=("a", "b", "c"))
        assert dict.get(obs._sites, "site")["calls"] == 3, f"seed {seed}"
        assert len(obs._sites) == 1


# -- the prefetcher's seeded fuzz ----------------------------------------------------

def _fuzz_one_seed(seed, X, **kw):
    stream = StreamingDataset.from_numpy(X, 16, device="cpu", **kw)
    with chaos(seed=seed):
        got = np.concatenate([c.numpy() for c in stream.chunks()], axis=0)
    np.testing.assert_array_equal(got, X.astype(got.dtype))
    assert stream.buffered_nbytes() == 0.0, f"seed {seed}"


def test_prefetcher_fuzz_bounded_seeds():
    """Every row in order and a drained ledger, under seeded perturbation
    at every lock and semaphore operation of the slot-gated staging."""
    X = np.arange(48 * 8, dtype=np.float32).reshape(48, 8)
    for seed in range(25):
        _fuzz_one_seed(seed, X)


def test_prefetcher_fuzz_wire_cast_seeds():
    """A few seeds through a narrow wire and the device cast, into a
    streamed StandardScaler fit."""
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.parallel.streaming import fit_streaming

    X = (np.arange(48 * 8) % 251).astype(np.uint8).reshape(48, 8)
    for seed in range(5):
        stream = StreamingDataset.from_numpy(X, 16, device="cpu",
                                             compute_dtype=np.float32)
        with chaos(seed=seed):
            model = fit_streaming(StandardScaler(), stream)
        np.testing.assert_allclose(np.asarray(model.mean),
                                   X.astype(np.float32).mean(axis=0),
                                   rtol=1e-5)
        assert stream.buffered_nbytes() == 0.0
