"""The port's resilience plane against ``keystone_tpu.resilience``: fault
plans, retry and backoff, the quarantine, checkpoint and bit-identical
resume of streamed fits, the producer watchdog, the exit teardown of a
live stream, and the in-place carry switch.

Every port stream lives on the CPU (``device="cpu"``). Bars, as stated
per test: the fault plans' firings and the backoff schedules of one seed
are the same in both packages exactly; quarantine states are equal; a
resumed fit's weights are the port's uninterrupted weights bit for bit,
and both lie within 1e-5 of the largest JAX weight (the bar of
``tests/test_resilience.py``); the donation switch gives the same bits.
"""
import glob
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu import resilience as jres
from keystone_tpu.resilience import faults as jfaults
from keystone_tpu.nodes.learning.least_squares import (
    LeastSquaresEstimator as JLeastSquares,
)
from keystone_tpu.nodes.learning.linear import (
    LinearMapEstimator as JLinearMap,
)
from keystone_tpu.parallel.streaming import StreamingDataset as JStream
from keystone_tpu.parallel.streaming import fit_streaming as jfit_streaming
from keystone_tpu_torch import resilience as tres
from keystone_tpu_torch.nodes.learning.least_squares import (
    LeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.learning.linear import (
    LinearMapEstimator,
    accumulate_gram_carry,
)
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.observability.numerics import reset_health_series
from keystone_tpu_torch.observability.timeline import (
    flight_recorder,
    reset_flight_recorder,
)
from keystone_tpu_torch.observability.trace import PipelineTrace
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.parallel.streaming import (
    StreamingDataset,
    fit_streaming,
)
from keystone_tpu_torch.resilience.retry import reset_default_retry_policy
from keystone_tpu_torch.utils import donation
from keystone_tpu_torch.utils.guarded import TracedLock, guarded_by

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_planes(tmp_path, monkeypatch):
    """The port's process-global planes, reset per test; post-mortems go
    to the test's directory."""
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR",
                       str(tmp_path / "postmortems"))
    # the shipped cost weights: a calibration artifact the tool left in
    # the checkout's build/ must not move a streamed fit's solver here
    monkeypatch.setenv("KEYSTONE_TORCH_COST_CALIBRATION",
                       str(tmp_path / "no-calibration.json"))
    MetricsRegistry.reset()
    reset_flight_recorder()
    reset_health_series()
    reset_default_retry_policy()
    yield
    MetricsRegistry.reset()
    reset_flight_recorder()
    reset_health_series()


def _xy(n=200, d=12, k=3, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * (1.0 + rng.rand(d))).astype(np.float32)
    Y = (X @ rng.randn(d, k) + 0.1 * rng.randn(n, k)).astype(np.float32)
    return X, Y


def _stream(X, chunk_size, **kw):
    return StreamingDataset.from_numpy(X, chunk_size, device="cpu", tag="kr",
                                       **kw)


# -- fault plans and backoff -------------------------------------------------

def _firings(pkg, seed, rate, after, count, visits=60):
    plan = pkg.FaultPlan(seed=seed).add("ingest.stage", rate=rate,
                                        after=after, count=count)
    fired = []
    with plan:
        for i in range(visits):
            try:
                pkg.inject("ingest.stage", context=i)
            except pkg.InjectedFaultError:
                fired.append(i)
    return fired, [e["context"] for e in plan.log]


@pytest.mark.parametrize("seed,rate,after,count", [
    (0, 0.3, 0, None), (7, 0.5, 3, 5), (11, 1.0, 10, 1), (3, 0.1, 0, None)])
def test_fault_plan_firings_match_jax(seed, rate, after, count):
    """Same seed and spec: the same visits fire in both packages."""
    assert _firings(tres, seed, rate, after, count) == _firings(
        jres, seed, rate, after, count)


@pytest.mark.parametrize("seed,rate,after", [(0, 1.0, 5), (4, 0.4, 2)])
def test_corrupt_rule_poisons_like_jax(seed, rate, after):
    """``corrupt`` rules poison the same chunks the same way: NaN into
    the first element of the first float leaf, integer leaves
    untouched, the source's array not written."""
    out = {}
    for pkg, corrupt in ((tres, tres.corrupt), (jres, jfaults.corrupt)):
        plan = pkg.FaultPlan(seed=seed).add("ingest.stage", kind="corrupt",
                                            rate=rate, after=after, count=3)
        poisoned = []
        with plan:
            for i in range(20):
                x = np.full((4, 3), float(i), np.float32)
                y = np.arange(4, dtype=np.int32)
                got = corrupt("ingest.stage", (x, y), context=i)
                assert not np.isnan(x).any()
                np.testing.assert_array_equal(got[1], y)
                if np.isnan(got[0]).any():
                    assert np.isnan(got[0]).sum() == 1
                    assert np.isnan(got[0][0, 0])
                    poisoned.append(i)
        out[pkg] = poisoned
    assert out[tres] == out[jres] and out[tres]


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_backoff_schedule_matches_jax(seed):
    """``RetryPolicy.backoff`` of one seed: the same schedule exactly."""
    kw = dict(backoff_s=0.05, multiplier=2.0, max_backoff_s=0.3, jitter=0.5,
              seed=seed)
    tp, jp = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    attempts = [1, 2, 3, 4, 5, 1, 2, 7]
    assert [tp.backoff(a) for a in attempts] == [
        jp.backoff(a) for a in attempts]
    assert repr(tp) == repr(jp)


def test_retry_classification_matches_jax():
    for t_exc, j_exc in [
            (tres.TransientError("t"), jres.TransientError("t")),
            (tres.AttemptTimeoutError("a"), jres.AttemptTimeoutError("a")),
            (OSError("io"), OSError("io")),
            (TimeoutError("to"), TimeoutError("to")),
            (FileNotFoundError("f"), FileNotFoundError("f")),
            (tres.CorruptRecordError("c"), jres.CorruptRecordError("c")),
            (ValueError("v"), ValueError("v"))]:
        assert tres.RetryPolicy().is_retryable(t_exc) == \
            jres.RetryPolicy().is_retryable(j_exc), type(t_exc).__name__


def test_retry_call_recovers_then_exhausts_with_a_postmortem(tmp_path):
    calls = []

    def flaky(fails):
        calls.append(1)
        if len(calls) <= fails:
            raise tres.TransientError(f"transient {len(calls)}")
        return "ok"

    policy = tres.RetryPolicy(max_attempts=3, backoff_s=0.001)
    assert policy.call(flaky, 2, site="test.site") == "ok"
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(tres.RetryExhaustedError) as info:
        policy.call(flaky, 10, site="test.site")
    assert isinstance(info.value.__cause__, tres.TransientError)
    path = info.value.postmortem_path
    assert path and os.path.exists(path) and path in str(info.value)
    blob = json.loads(open(path).read())
    assert blob["reason"] == "retry_exhausted"
    assert blob["context"]["site"] == "test.site"
    counters = MetricsRegistry.get_or_create().snapshot()["counters"]
    assert counters["resilience.retry"] == 2 + 3
    assert counters["resilience.retry_exhausted"] == 1
    with pytest.raises(ValueError):  # not retryable: raised at once
        policy.call(lambda: (_ for _ in ()).throw(ValueError("v")))


def test_retry_attempt_timeout_counts_as_transient():
    policy = tres.RetryPolicy(max_attempts=2, backoff_s=0.001,
                              attempt_timeout_s=0.05)
    with pytest.raises(tres.RetryExhaustedError) as info:
        policy.call(time.sleep, 0.5)
    assert isinstance(info.value.__cause__, tres.AttemptTimeoutError)


# -- quarantine ----------------------------------------------------------------

def _quarantine_ops(pkg, q):
    q.record_ok(40)
    for i in (3, 9, 3, 17):  # the repeat is counted once
        q.quarantine(f"a.tar::{i}.jpg", "truncated")
    q.record_ok(10)
    return q.state()


def test_quarantine_state_matches_jax():
    states = [_quarantine_ops(pkg, pkg.Quarantine(max_bad_fraction=0.2,
                                                  min_records=10))
              for pkg in (tres, jres)]
    assert states[0] == states[1]
    assert states[0]["bad_count"] == 3
    restored = {}
    for pkg in (tres, jres):
        q = pkg.Quarantine(max_bad_fraction=0.2, min_records=10)
        q.restore(states[0])
        q.quarantine("a.tar::9.jpg", "again")  # dedupes after restore
        restored[pkg] = (q.state(), q.seen(), q.summary())
    assert restored[tres] == restored[jres]


def test_quarantine_budget_trips_where_jax_does(tmp_path):
    trips = {}
    for pkg in (tres, jres):
        q = pkg.Quarantine(max_bad_fraction=0.05, min_records=20,
                           manifest_path=str(tmp_path / f"{id(pkg)}.jsonl"))
        q.record_ok(30)
        tripped = None
        for i in range(10):
            try:
                q.quarantine(f"s{i}", "bad")
            except pkg.QuarantineBudgetExceededError as exc:
                tripped = (i, str(exc))
                break
        trips[pkg] = tripped
        lines = open(tmp_path / f"{id(pkg)}.jsonl").read().splitlines()
        assert len(lines) == tripped[0] + 1
    assert trips[tres] == trips[jres] and trips[tres] is not None


def test_drop_quarantined_rows_matches_jax():
    labels = np.arange(12).reshape(6, 2)
    keys = [f"k{i}" for i in range(6)]
    out = {}
    for pkg in (tres, jres):
        q = pkg.Quarantine(max_bad_fraction=1.0)
        q.quarantine("k1", "bad")
        q.quarantine("k4", "bad")
        out[pkg] = pkg.drop_quarantined_rows(labels, keys, q)
    np.testing.assert_array_equal(out[tres], out[jres])
    with pytest.raises(ValueError, match="record_keys"):
        tres.drop_quarantined_rows(labels, keys[:3], tres.Quarantine())


# -- kill and resume -------------------------------------------------------------

def _weights(model):
    return np.asarray(torch.as_tensor(model.weights))


@pytest.mark.parametrize("estimator", ["linear_map", "least_squares"])
@pytest.mark.parametrize("chunk_size", [48, 64, 96])
def test_kill_and_resume_is_bit_identical(tmp_path, chunk_size, estimator):
    """A streamed fit killed at chunk 2 and resumed from its last
    snapshot gives the port's uninterrupted weights bit for bit; both
    lie within 1e-5 of the largest JAX weight of the same fit. 200 rows
    leave ragged tails at every chunk size."""
    X, Y = _xy(n=200)
    make = {"linear_map": (lambda: LinearMapEstimator(lam=0.1),
                           lambda: JLinearMap(lam=0.1)),
            "least_squares": (lambda: LeastSquaresEstimator(lam=0.1),
                              lambda: JLeastSquares(lam=0.1))}[estimator]
    uninterrupted = fit_streaming(make[0](), _stream(X, chunk_size), Y)
    ck = str(tmp_path / "ck")
    plan = tres.FaultPlan().add("ingest.produce", after=2, count=1,
                                error=RuntimeError)
    with plan, pytest.raises(RuntimeError, match="injected fault"):
        fit_streaming(make[0](), _stream(X, chunk_size), Y,
                      checkpoint_dir=ck, checkpoint_every=1)
    path = os.path.join(ck, "stream_fit.ckpt")
    with open(path, "rb") as f:
        assert pickle.load(f)["cursor"] == 2
    with PipelineTrace("resume") as tr:
        resumed = fit_streaming(make[0](), _stream(X, chunk_size), Y,
                                checkpoint_dir=ck, checkpoint_every=1)
    assert tr.resilience_stats.get("checkpoint_restore") == 1
    assert not os.path.exists(path)
    w_u, w_r = _weights(uninterrupted), _weights(resumed)
    np.testing.assert_array_equal(w_r, w_u)
    np.testing.assert_array_equal(np.asarray(resumed.intercept),
                                  np.asarray(uninterrupted.intercept))
    w_j = np.asarray(jfit_streaming(
        make[1](), JStream.from_numpy(X, chunk_size=chunk_size), Y).weights)
    assert np.abs(w_u - w_j).max() <= W_TOL * max(np.abs(w_j).max(), 1.0)


def test_resume_through_estimator_fit_options(tmp_path):
    """``Estimator.fit`` and ``LabelEstimator.fit`` forward the stream
    options; the scaler's and the solver's snapshots resume exactly."""
    X, Y = _xy(n=256, d=10)
    labels = ArrayDataset.from_numpy(Y, "cpu")

    def run(plan=None, **opts):
        scaler = StandardScaler().fit(
            _stream(X, 32), **({k: os.path.join(v, "s") if k ==
                                "checkpoint_dir" else v
                                for k, v in opts.items()}))
        est = LinearMapEstimator(lam=0.5)
        with plan or tres.FaultPlan():
            model = est.fit(scaler.apply_dataset(_stream(X, 32)), labels,
                            **opts)
        return scaler, model

    s_u, m_u = run()
    ck = str(tmp_path / "ck")
    kill = tres.FaultPlan().add("ingest.produce", after=5, count=1,
                                error=RuntimeError)
    with pytest.raises(RuntimeError):
        run(kill, checkpoint_dir=ck, checkpoint_every=2, hbm_budget=1e9)
    s_r, m_r = run(checkpoint_dir=ck, checkpoint_every=2, hbm_budget=1e9)
    np.testing.assert_array_equal(_weights(m_r), _weights(m_u))
    np.testing.assert_array_equal(s_r.mean, s_u.mean)
    np.testing.assert_array_equal(s_r.std, s_u.std)


def test_resident_fit_refuses_stream_options(tmp_path):
    X, Y = _xy(n=40)
    with pytest.raises(TypeError, match="StreamingDataset"):
        StandardScaler().fit(X, device="cpu", checkpoint_dir=str(tmp_path))
    with pytest.raises(TypeError, match="StreamingDataset"):
        LinearMapEstimator(lam=0.1).fit(X, Y, device="cpu",
                                        checkpoint_every=2)
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        LinearMapEstimator(lam=0.1).fit(_stream(X, 16), Y,
                                        checkpoint_every=2)


def test_fingerprint_mismatch_refuses_and_corrupt_file_raises(tmp_path):
    X, Y = _xy(n=96)
    ck = str(tmp_path / "ck")
    kill = tres.FaultPlan().add("ingest.produce", after=2, count=1,
                                error=RuntimeError)
    with kill, pytest.raises(RuntimeError):
        fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, 16), Y,
                      checkpoint_dir=ck, checkpoint_every=1)
    # another lam, another chunk size, other labels: each refused
    for est, chunk, labels in ((LinearMapEstimator(lam=0.2), 16, Y),
                               (LinearMapEstimator(lam=0.1), 32, Y),
                               (LinearMapEstimator(lam=0.1), 16, Y + 1)):
        with pytest.raises(tres.CheckpointMismatchError):
            fit_streaming(est, _stream(X, chunk), labels,
                          checkpoint_dir=ck, checkpoint_every=1)
    assert tres.fit_fingerprint(LinearMapEstimator(lam=0.1),
                                _stream(X, 16), Y) == \
        tres.fit_fingerprint(LinearMapEstimator(lam=0.1), _stream(X, 16), Y)
    path = os.path.join(ck, "stream_fit.ckpt")
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(tres.CheckpointCorruptError, match="truncated"):
        fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, 16), Y,
                      checkpoint_dir=ck)
    with open(path, "wb") as f:
        pickle.dump({"magic": "other"}, f)
    with pytest.raises(tres.CheckpointCorruptError, match="header"):
        tres.StreamCheckpoint(ck).load("x")


def test_quarantine_rides_the_checkpoint(tmp_path):
    X, Y = _xy(n=96)
    q = tres.Quarantine(max_bad_fraction=1.0)
    q.quarantine("a::1", "bad")
    ck = str(tmp_path / "ck")
    kill = tres.FaultPlan().add("ingest.produce", after=3, count=1,
                                error=RuntimeError)
    with kill, pytest.raises(RuntimeError):
        fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, 16), Y,
                      checkpoint_dir=ck, checkpoint_every=1, quarantine=q)
    q2 = tres.Quarantine(max_bad_fraction=1.0)
    fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, 16), Y,
                  checkpoint_dir=ck, checkpoint_every=1, quarantine=q2)
    assert q2.quarantined_keys() == {"a::1"}


# -- staging faults and the watchdog ---------------------------------------------

def test_transient_staging_faults_give_the_same_bits():
    X, Y = _xy(n=240)
    clean = fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, 12), Y)
    # seed 0's draws fire three times in a row at the 15th visit
    plan = tres.FaultPlan(seed=0).add("ingest.stage", rate=0.3)
    with plan:
        flaky = fit_streaming(
            LinearMapEstimator(lam=0.1),
            _stream(X, 12, retry_policy=tres.RetryPolicy(
                max_attempts=6, backoff_s=0.001)), Y)
    assert plan.injections("ingest.stage") > 0
    np.testing.assert_array_equal(_weights(flaky), _weights(clean))
    assert MetricsRegistry.get_or_create().snapshot()["counters"][
        "resilience.retry"] == plan.injections()


def test_stall_deadline_raises_ingest_timeout_with_postmortem():
    X, _ = _xy(n=128)
    plan = tres.FaultPlan().add("ingest.produce", kind="hang", after=1,
                                count=1, delay_s=5.0)
    t0 = time.perf_counter()
    with plan, pytest.raises(tres.IngestTimeoutError) as info:
        for _ in _stream(X, 32, stall_timeout_s=0.3).chunks():
            pass
    assert time.perf_counter() - t0 < 4.0
    assert "stall_timeout_s=0.3" in str(info.value)
    assert os.path.exists(info.value.postmortem_path)
    counters = MetricsRegistry.get_or_create().snapshot()["counters"]
    assert counters["resilience.watchdog_trip"] == 1


def test_dead_producer_raises_ingest_timeout(monkeypatch):
    """A producer thread that dies without a word (here: its queue put
    fails) turns into IngestTimeoutError, not a hang."""
    import keystone_tpu_torch.parallel.streaming as ts

    X, _ = _xy(n=64)

    class Dying(ts.queue.Queue):
        def put(self, item, *a, **kw):
            if threading.current_thread().name.startswith(
                    "keystone-torch-stream"):
                raise SystemExit  # the thread ends silently
            return super().put(item, *a, **kw)

    monkeypatch.setattr(ts.queue, "Queue", Dying)
    with pytest.raises(tres.IngestTimeoutError, match="producer thread died"):
        list(_stream(X, 16).chunks())


_EXIT_SCRIPT = r"""
import time
import numpy as np
from keystone_tpu_torch.parallel.streaming import StreamingDataset

def slow_chunks():
    for _ in range(1000):
        time.sleep(0.02)
        yield np.ones((16, 4), np.float32)

s = StreamingDataset(slow_chunks, chunk_size=16, device="cpu", tag="live")
it = s.chunks()
next(it)          # the prefetch producer is live
print("MID-STREAM-EXIT")
"""


def test_interpreter_exit_under_active_stream_is_clean(tmp_path):
    """Exit with a live stream: the teardown stops the producer, dumps a
    post-mortem holding its ingest spans, and leaves no thread noise."""
    env = dict(os.environ, KEYSTONE_TORCH_POSTMORTEM_DIR=str(tmp_path),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", _EXIT_SCRIPT],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-2000:])
    assert "MID-STREAM-EXIT" in proc.stdout
    for noise in ("Exception in thread", "cannot join", "Traceback"):
        assert noise not in proc.stderr, proc.stderr[-2000:]
    dumps = glob.glob(str(tmp_path /
                          "postmortem-exit_under_active_stream-*.json"))
    assert len(dumps) == 1, dumps
    blob = json.loads(open(dumps[0]).read())
    assert blob["context"]["live_streams"] == 1
    assert "ingest" in {e.get("cat")
                        for e in blob["flight_recorder"]["traceEvents"]}
    assert blob["metrics"]["counters"]["streaming.chunks_total"] >= 1


# -- in-place carries and locks ------------------------------------------------

def test_donation_switch_gives_the_same_bits(monkeypatch):
    """``KEYSTONE_TORCH_DONATE_CARRY=0`` copies each carry before its
    update (the caller's carry stays unwritten) and gives the same
    bits."""
    X, Y = _xy(n=200)
    sites = {s.name for s in donation.registered_donations()}
    assert {"accumulate_gram_carry", "StandardScaler.accumulate"} <= sites

    def fits():
        scaler = StandardScaler().fit(_stream(X, 48))
        model = fit_streaming(LinearMapEstimator(lam=0.1),
                              scaler.apply_dataset(_stream(X, 48)), Y)
        return scaler, model

    s_on, m_on = fits()
    monkeypatch.setenv("KEYSTONE_TORCH_DONATE_CARRY", "0")
    s_off, m_off = fits()
    np.testing.assert_array_equal(_weights(m_off), _weights(m_on))
    np.testing.assert_array_equal(s_off.std, s_on.std)
    chunk = ArrayDataset.from_numpy(X[:48], "cpu")
    labels = ArrayDataset.from_numpy(Y[:48], "cpu")
    carry = accumulate_gram_carry(None, chunk, labels)
    before = [t.clone() for t in carry[:4]]
    out = accumulate_gram_carry(carry, chunk, labels)
    assert all(torch.equal(a, b) for a, b in zip(carry[:4], before))
    assert not torch.equal(out[0], before[0])
    monkeypatch.setenv("KEYSTONE_TORCH_DONATE_CARRY", "1")
    out = accumulate_gram_carry(carry, chunk, labels)
    assert out[0] is carry[0]  # written in place


def test_traced_lock_records_contention():
    lock = TracedLock("test.lock")
    held = threading.Event()

    def holder():
        with lock:
            held.set()
            time.sleep(0.05)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(2.0)
    with PipelineTrace("locks") as tr:
        with lock:
            pass
    t.join(timeout=2.0)
    snap = MetricsRegistry.get_or_create().snapshot()
    assert snap["counters"]["lock.contended_total"] == 1
    assert snap["histograms"]["lock.wait_s.test.lock"]["count"] == 1
    assert tr.lock_waits["test.lock"]["count"] == 1
    assert any(s.name == "lock:test.lock" for s in flight_recorder().spans())

    @guarded_by("_lock", "a", "b")
    class Guarded:
        pass

    assert Guarded.__guarded_fields__ == {"a": "_lock", "b": "_lock"}
