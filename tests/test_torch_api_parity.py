"""The port's members that complete the JAX package's public surface,
held against ``keystone_tpu`` on the CPU: the optimizer's rule log and
``cache_hits`` of the trace, the solvers' objectives
(``compute_cost``), the block model's per-block evaluation
(``apply_and_evaluate``), the drift sketch's ``merge``, the quarantine's
budget accessors, and the registry's ``timer``, the sampler's
``snapshot`` and the residency ledger's ``resident``.

Bars, as stated per test: the rule log's ``(rule, nodes_before,
nodes_after)`` entries are equal as multisets and each pass's node
counts equal; objectives within 1e-4 relative of JAX's and of float64
numpy; each per-block partial within ``rtol = atol = 2e-3`` of JAX's
(the JAX test's bar); merged sketches, quarantine fractions and budget
messages equal exactly. Inputs are seeded numpy arrays at small shapes
(n <= 120, d <= 12); port tensors live on the CPU.
"""
import collections
import time

import numpy as np
import pytest
import torch

import keystone_tpu as jk
import keystone_tpu_torch as tk
from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.observability import metrics as jmetrics
from keystone_tpu.observability import numerics as jnum
from keystone_tpu.observability import sampler as jsampler
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.resilience import quarantine as jquar
from keystone_tpu.serving import residency as jres
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu_torch.nodes.learning import linear as tlinear
from keystone_tpu_torch.observability import metrics as tmetrics
from keystone_tpu_torch.observability import numerics as tnum
from keystone_tpu_torch.observability import sampler as tsampler
from keystone_tpu_torch.observability.trace import tracing_disabled
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.resilience import quarantine as tquar
from keystone_tpu_torch.serving import residency as tres
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.optimizer import rule as trule
from keystone_tpu_torch.workflow.optimizer.auto_cache import AutoCacheRule

RTOL_COST = 1e-4
TOL_PARTIAL = 2e-3


@pytest.fixture(autouse=True)
def fresh_state():
    for reset in (PipelineEnv.reset, JPipelineEnv.reset,
                  tmetrics.MetricsRegistry.reset,
                  jmetrics.MetricsRegistry.reset):
        reset()
    yield
    for reset in (PipelineEnv.reset, JPipelineEnv.reset,
                  tmetrics.MetricsRegistry.reset,
                  jmetrics.MetricsRegistry.reset):
        reset()


def _nodes(pkg):
    """The test's transformers and estimator, defined on ``pkg``."""

    class Scale(pkg.Transformer):
        def __init__(self, k):
            self.k = k

        def apply(self, x):
            return x * self.k

    class AddOne(pkg.Transformer):
        def apply(self, x):
            return x + 1

    class SumBranches(pkg.Transformer):
        def apply(self, xs):
            return xs[0] + xs[1]

    class Shift(pkg.Transformer):
        def __init__(self, b):
            self.b = b

        def apply(self, x):
            return x + (torch.as_tensor(self.b) if pkg is tk else self.b)

    class MeanCenter(pkg.Estimator):
        def _fit(self, ds):
            return Shift(-ds.numpy().mean(axis=0))

    return Scale, AddOne, SumBranches, MeanCenter


def _data(n=16, d=4, seed=0):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


def _stage(pkg, x):
    return (ArrayDataset.from_numpy(x, "cpu") if pkg is tk
            else JArrayDataset.from_numpy(x))


def _gather_log(pkg):
    Scale, _, SumBranches, _ = _nodes(pkg)
    x = _data()
    pipe = pkg.Pipeline.gather([Scale(2.0), Scale(2.0)]) >> SumBranches()
    with pkg.PipelineTrace("rules") as tr:
        out = pipe.apply(_stage(pkg, x)).numpy()
    np.testing.assert_allclose(out, x * 4.0, rtol=1e-6)
    return tr


# -- the optimizer's rule log -------------------------------------------------

def test_rule_log_matches_jax():
    """The gather of two equal Scales fires the same rewrites in both
    packages, the CSE merge among them, with the same pass node counts."""
    logs = {pkg: _gather_log(pkg) for pkg in (tk, jk)}
    entries = {pkg: collections.Counter(
        (e["rule"], e["nodes_before"], e["nodes_after"])
        for e in tr.optimizer_rules) for pkg, tr in logs.items()}
    assert entries[tk] == entries[jk]
    merge = [e for e in logs[tk].optimizer_rules
             if e["rule"] == "EquivalentNodeMergeRule"]
    assert merge and merge[0]["nodes_before"] > merge[0]["nodes_after"]
    assert all(e["wall_s"] >= 0.0 and e["optimizer"] == "DefaultOptimizer"
               for e in logs[tk].optimizer_rules)
    runs = {pkg: tr.meta["optimizer_runs"] for pkg, tr in logs.items()}
    assert [(r["optimizer"], r["batches"], r["nodes_in"], r["nodes_out"])
            for r in runs[tk]] == \
        [(r["optimizer"], r["batches"], r["nodes_in"], r["nodes_out"])
         for r in runs[jk]]
    assert runs[tk][0]["nodes_in"] > runs[tk][0]["nodes_out"]


def test_rule_log_survives_json_and_prints_in_the_summary():
    tr = _gather_log(tk)
    back = tk.PipelineTrace.from_json(tr.to_json())
    assert back.optimizer_rules == tr.optimizer_rules
    assert back.meta["optimizer_runs"] == tr.meta["optimizer_runs"]
    text = tr.summary()
    assert "optimizer rules fired:" in text
    assert "EquivalentNodeMergeRule [" in text


class _NoClock:
    """Stands in for the rule module's ``time``: any clock read fails."""

    def perf_counter(self):
        raise AssertionError("Optimizer.execute read the clock untraced")


def test_untraced_execute_reads_no_clock(monkeypatch):
    Scale, _, SumBranches, _ = _nodes(tk)
    monkeypatch.setattr(trule, "time", _NoClock())
    x = _data()
    pipe = tk.Pipeline.gather([Scale(2.0), Scale(2.0)]) >> SumBranches()
    np.testing.assert_allclose(pipe.apply(_stage(tk, x)).numpy(), x * 4.0,
                               rtol=1e-6)
    with tk.PipelineTrace("off") as tr, tracing_disabled():
        pipe.apply(_stage(tk, x)).numpy()
    assert not tr.optimizer_rules and "optimizer_runs" not in tr.meta


def test_auto_cache_profiling_records_no_rules():
    """The auto-cache rule's sampled executions run under
    ``tracing_disabled``: an optimizer pass inside them records no rule
    and no pass, while the rule's own report reaches the trace."""
    Scale, AddOne, _, _ = _nodes(tk)
    inner = []

    class ApplyThenScale(tk.Estimator):
        def _fit(self, ds):
            # a fit that runs a pipeline of its own: one optimizer pass
            inner.append((Scale(1.0) >> AddOne()).apply(ds).numpy())
            return Scale(2.0)

    train = _stage(tk, _data(n=64))
    graph = ApplyThenScale().with_data(train)._graph
    with tk.PipelineTrace("cache") as tr:
        AutoCacheRule(AutoCacheRule.GREEDY, max_mem=1e9).apply(graph)
    assert inner  # the profiling ran the inner pipeline
    assert tr.auto_cache and not tr.nodes
    assert not tr.optimizer_rules and "optimizer_runs" not in tr.meta


def test_cache_hits_follow_jax():
    """The second apply is served from the prefix memo: no hit on the
    first apply, the ``Saved`` record on the second, in both packages."""
    got = {}
    for pkg in (tk, jk):
        _, AddOne, _, MeanCenter = _nodes(pkg)
        ds = _stage(pkg, _data())
        pipe = AddOne().and_then(MeanCenter(), ds)
        with pkg.PipelineTrace("hits") as tr:
            pipe.apply(ds).numpy()
            first = list(tr.cache_hits())
            pipe.apply(ds).numpy()
        got[pkg] = (first, sorted(r.operator for r in tr.cache_hits()),
                    {e["rule"] for e in tr.optimizer_rules})
    assert got[tk][0] == [] and got[jk][0] == []
    assert "Saved" in got[tk][1]
    assert got[tk][1] == got[jk][1]
    assert "SavedStateLoadRule" in got[tk][2]
    assert got[tk][2] == got[jk][2]


# -- the solvers' objectives --------------------------------------------------

def _problem(n, d, k, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32)
    Y = (A @ W + rng.randn(k) + 0.01 * rng.randn(n, k)).astype(np.float32)
    return A, Y


def _objective64(pred, Y, lam, weights):
    resid = pred.astype(np.float64) - Y.astype(np.float64)
    return (np.sum(resid ** 2) / (2 * Y.shape[0])
            + lam / 2 * sum(np.sum(w.astype(np.float64) ** 2)
                            for w in weights))


@pytest.mark.parametrize("lam,with_b", [(0.7, True), (0.0, False)])
def test_linear_compute_cost_matches_jax_and_float64(lam, with_b):
    A, Y = _problem(120, 10, 3, 5)
    rng = np.random.RandomState(6)
    W = rng.randn(10, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32) if with_b else None
    want = _objective64(A @ W.astype(np.float64) + (0 if b is None else b),
                        Y, lam, [W])
    ref = jlinear.LinearMapEstimator.compute_cost(A, Y, lam, W, b)
    got = tlinear.LinearMapEstimator.compute_cost(
        torch.as_tensor(A), torch.as_tensor(Y), lam, torch.as_tensor(W),
        None if b is None else torch.as_tensor(b))
    # padded datasets (8 shards over 120 rows: none; 7: six pad rows)
    padded = tlinear.LinearMapEstimator.compute_cost(
        ArrayDataset.from_numpy(A, "cpu", shards=7),
        ArrayDataset.from_numpy(Y, "cpu", shards=7), lam, W, b)
    assert isinstance(got, float)
    for value in (got, padded):
        np.testing.assert_allclose(value, ref, rtol=RTOL_COST)
        np.testing.assert_allclose(value, want, rtol=RTOL_COST)


@pytest.mark.parametrize("lam,with_b", [(0.3, True), (0.0, False)])
def test_block_compute_cost_matches_jax_and_float64(lam, with_b):
    A, Y = _problem(100, 12, 2, 7)
    rng = np.random.RandomState(8)
    bounds = [(0, 5), (5, 10), (10, 12)]
    Ws = [rng.randn(hi - lo, 2).astype(np.float32) for lo, hi in bounds]
    b = rng.randn(2).astype(np.float32) if with_b else None
    blocks = [A[:, lo:hi] for lo, hi in bounds]
    pred = sum(blk.astype(np.float64) @ w for blk, w in zip(blocks, Ws))
    want = _objective64(pred + (0 if b is None else b), Y, lam, Ws)
    ref = jlinear.BlockLeastSquaresEstimator.compute_cost(blocks, Y, lam, Ws,
                                                          b)
    got = tlinear.BlockLeastSquaresEstimator.compute_cost(
        [ArrayDataset.from_numpy(blk, "cpu", shards=8) for blk in blocks],
        ArrayDataset.from_numpy(Y, "cpu", shards=8), lam,
        [torch.as_tensor(w) for w in Ws], b)
    np.testing.assert_allclose(got, ref, rtol=RTOL_COST)
    np.testing.assert_allclose(got, want, rtol=RTOL_COST)
    with pytest.raises(AssertionError, match="feature blocks"):
        tlinear.BlockLeastSquaresEstimator.compute_cost(
            [torch.as_tensor(blocks[0])], torch.as_tensor(Y), lam, Ws, b)


# -- the per-block evaluation -------------------------------------------------

def _fitted_blocks(n, seed):
    A, Y = _problem(n, 12, 3, seed)
    mapper = tlinear.BlockLeastSquaresEstimator(4, 4, 0.1).fit(
        ArrayDataset.from_numpy(A, "cpu"), ArrayDataset.from_numpy(Y, "cpu"))
    ref = jlinear.BlockLinearMapper(
        [w.numpy() for w in mapper.block_weights], 4,
        intercept=mapper.intercept.numpy(),
        feature_means=mapper.feature_means.numpy())
    return A, mapper, ref


@pytest.mark.parametrize("n,shards", [(96, 1), (101, 8)])
def test_apply_and_evaluate_matches_jax(n, shards):
    """Each partial (block sum + intercept, blocks centered by their
    means) agrees with JAX's; pad rows are zero where the port pads; the
    last equals ``apply``."""
    A, mapper, ref = _fitted_blocks(n, 9)
    bounds = mapper._block_bounds()
    assert bounds == ref._block_bounds() == [(0, 4), (4, 8), (8, 12)]
    seen, want = [], []
    mapper.apply_and_evaluate(
        [ArrayDataset.from_numpy(A[:, lo:hi], "cpu", shards=shards)
         for lo, hi in bounds], seen.append)
    ref.apply_and_evaluate([A[:, lo:hi] for lo, hi in bounds],
                           lambda ds: want.append(ds.numpy()))
    assert len(seen) == len(want) == 3
    partial = np.zeros((n, 3))
    for (lo, hi), w, ds, jax_out in zip(bounds, mapper.block_weights, seen,
                                        want):
        assert isinstance(ds, ArrayDataset) and ds.n == n
        data = ds.data.numpy()
        if shards > 1:
            assert data.shape[0] > n
        np.testing.assert_array_equal(data[n:], 0.0)
        np.testing.assert_allclose(data[:n], jax_out, rtol=TOL_PARTIAL,
                                   atol=TOL_PARTIAL)
        partial += ((A[:, lo:hi] - mapper.feature_means[lo:hi].numpy())
                    .astype(np.float64) @ w.numpy().astype(np.float64))
        np.testing.assert_allclose(data[:n],
                                   partial + mapper.intercept.numpy(),
                                   rtol=TOL_PARTIAL, atol=TOL_PARTIAL)
    np.testing.assert_allclose(
        seen[-1].data[:n].numpy(),
        mapper.apply_batch(torch.as_tensor(A)).numpy(),
        rtol=TOL_PARTIAL, atol=TOL_PARTIAL)


# -- the drift sketch's merge -------------------------------------------------

def _baselines(pkg, chunks):
    tracker = pkg.SketchTracker(source="s")
    for X in chunks:
        tracker.update(ArrayDataset.from_numpy(X, "cpu") if pkg is tnum
                       else JArrayDataset.from_numpy(X))
    return tracker.baseline()


def test_drift_merge_matches_jax_and_guards_geometry():
    rng = np.random.RandomState(3)
    chunks = [(rng.randn(64, 8) + i).astype(np.float32) for i in range(3)]
    merged, raised = {}, {}
    for pkg in (tnum, jnum):
        b1 = _baselines(pkg, chunks)
        b2 = pkg.DriftBaseline.from_state(b1.state())
        b2.counts = b2.counts[:, ::-1].copy()
        b2.rows = 17.0
        merged[pkg] = b1.merge(b2)
        other = _baselines(pkg, [c * 100.0 for c in chunks])
        with pytest.raises(ValueError, match="geometry") as info:
            b1.merge(other)
        raised[pkg] = str(info.value)
    t, j = merged[tnum], merged[jnum]
    assert isinstance(t, tnum.DriftBaseline)
    np.testing.assert_array_equal(t.cols, j.cols)
    np.testing.assert_array_equal(t.interior, j.interior)
    np.testing.assert_array_equal(t.counts, np.asarray(j.counts))
    assert t.rows == j.rows == 3 * 64 + 17.0 and t.source == j.source
    assert raised[tnum] == raised[jnum]


# -- the quarantine's budget --------------------------------------------------

def _budget_trail(pkg):
    """bad_fraction after each step, and each check_budget's outcome."""
    q = pkg.Quarantine(max_bad_fraction=0.2, min_records=10, label="t")
    trail = [q.bad_fraction()]
    q.record_ok(6)
    trail.append(q.bad_fraction())
    for i in range(4):
        try:
            q.quarantine(f"a.tar::{i}.jpg", "truncated")
            trail.append(("ok", q.bad_fraction()))
        except pkg.QuarantineBudgetExceededError as exc:
            trail.append(("raised", q.bad_fraction(), str(exc)))
        for source in (None, "b.tar::9.jpg"):
            try:
                q.check_budget(source)
                trail.append("within")
            except pkg.QuarantineBudgetExceededError as exc:
                trail.append(("over", str(exc)))
    return trail


def test_quarantine_budget_accessors_follow_jax():
    got, want = _budget_trail(tquar), _budget_trail(jquar)
    assert got == want
    assert got[0] == 0.0 and "within" in got
    assert any(isinstance(e, tuple) and e[0] == "over"
               and "b.tar::9.jpg" in e[1] for e in got)


# -- the small accessors ------------------------------------------------------

def test_residency_ledger_resident_follows_jax():
    views = {}
    for pkg in (tres, jres):
        ledger = pkg.ResidencyLedger(budget=100.0)
        ledger.admit("a", 10)
        ledger.admit("b", 20.5)
        ledger.release("a")
        ledger.admit("c", 30)
        view = ledger.resident()
        view["z"] = 1.0  # a copy: the ledger does not see it
        views[pkg] = (ledger.resident(), ledger.used())
    assert views[tres] == views[jres] == ({"b": 20.5, "c": 30.0}, 50.5)


def test_registry_timer_follows_jax():
    for pkg in (tmetrics, jmetrics):
        reg = pkg.MetricsRegistry()
        with reg.timer("parity.block_s"):
            time.sleep(0.002)
        hist = reg.snapshot()["histograms"]["parity.block_s"]
        assert hist["count"] == 1 and hist["total"] > 0.0, pkg


def test_sampler_snapshot_follows_jax():
    snaps = {}
    for pkg, mpkg in ((tsampler, tmetrics), (jsampler, jmetrics)):
        sampler = pkg.TelemetrySampler(interval_s=1.0, capacity=2,
                                       registry=mpkg.MetricsRegistry())
        sampler.add_probe("parity.probe", lambda: 3.0)
        for _ in range(3):
            sampler.sample_once()
        snap = sampler.snapshot()
        assert list(snap) == sampler.series_names()
        snap["parity.probe"].clear()  # a copy: the series keeps its points
        snaps[pkg] = [v for _, v in sampler.snapshot()["parity.probe"]]
    assert snaps[tsampler] == snaps[jsampler] == [3.0, 3.0]
