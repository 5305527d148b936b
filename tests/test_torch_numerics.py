"""The port's numerics plane against ``keystone_tpu.observability.numerics``:
health words, the deferred chunk monitor and its tripwire, the drift
sketch and its PSI, the fitted-model tripwire and the solver ledger.

Bars, as stated per test: health-word counts are equal exactly and the
moments (sum, sum of squares, min, max, mean, variance) within 1e-6
relative; the drift sketch's bin edges are equal and its bin counts
equal exactly; PSI within 1e-12 relative (both sides are float64 numpy
over the same counts); a resumed fit's drift baseline equals the uninterrupted
one's. Inputs are seeded numpy arrays at small shapes (n <= 200,
d <= 16); port tensors live on the CPU.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.observability import numerics as jnum
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu_torch import resilience as tres
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.observability import numerics as tnum
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.observability.timeline import (
    flight_recorder,
    reset_flight_recorder,
)
from keystone_tpu_torch.observability.trace import PipelineTrace
from keystone_tpu_torch.ops import linalg
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.parallel.streaming import (
    StreamingDataset,
    fit_streaming,
)

REL = 1e-6


@pytest.fixture(autouse=True)
def fresh_planes(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR",
                       str(tmp_path / "postmortems"))
    MetricsRegistry.reset()
    reset_flight_recorder()
    tnum.reset_health_series()
    yield
    MetricsRegistry.reset()
    reset_flight_recorder()
    tnum.reset_health_series()


def _stats_close(got, want):
    for key in ("finite", "nan", "inf"):
        assert got[key] == want[key], (key, got[key], want[key])
    for key in ("min", "max", "absmax", "mean", "var"):
        a, b = got[key], want[key]
        assert abs(a - b) <= REL * max(abs(b), 1e-30), (key, a, b)


@pytest.mark.parametrize("n,rows,d,poison", [
    (200, 200, 16, None), (150, 160, 16, None), (37, 48, 5, "nan"),
    (64, 64, 3, "inf"), (10, 16, 8, "both"), (20, 32, 4, "all")])
def test_health_word_matches_jax(n, rows, d, poison):
    """The masked health word of a padded chunk (and a second leaf that
    is not row-shaped) gives the JAX statistics."""
    rng = np.random.RandomState(n + d)
    X = np.zeros((rows, d), np.float32)
    X[:n] = rng.randn(n, d) * 3 + 1
    if poison in ("nan", "both"):
        X[2, 1] = np.nan
    if poison in ("inf", "both"):
        X[3, 0] = np.inf
        X[4, 2] = -np.inf
    if poison == "all":  # a leaf with no finite value keeps no bound
        X[:n] = np.nan
    other = rng.randn(7).astype(np.float32)
    mask = np.arange(rows) < n
    got = tnum.word_stats(tnum.health_word(
        (torch.as_tensor(X), torch.as_tensor(other)),
        torch.as_tensor(mask)).numpy())
    want = jnum.word_stats(np.asarray(jnum.health_word(
        (jnp.asarray(X), jnp.asarray(other)), jnp.asarray(mask))))
    _stats_close(got, want)
    # the streamed fit's form: the pad rows are the tail
    tail = tnum.word_stats(tnum.health_word(
        (torch.as_tensor(X), torch.as_tensor(other)),
        rows=(n, rows)).numpy())
    _stats_close(tail, want)
    plain_t = tnum.word_stats(tnum.health_word(torch.as_tensor(X)).numpy())
    plain_j = jnum.word_stats(np.asarray(jnum.health_word(jnp.asarray(X))))
    _stats_close(plain_t, plain_j)


def _sketch_pair(chunks):
    t, j = tnum.SketchTracker(source="s"), jnum.SketchTracker(source="s")
    for X in chunks:
        t.update(ArrayDataset.from_numpy(X, "cpu"))
        j.update(JArrayDataset.from_numpy(X))
    return t.baseline(), j.baseline()


@pytest.mark.parametrize("d,sizes", [(16, (64, 64, 48)), (5, (96, 40)),
                                     (100, (48, 48))])
def test_drift_sketch_bins_match_jax(d, sizes):
    rng = np.random.RandomState(d)
    chunks = [(rng.randn(s, d) * (1 + np.arange(d)) + i).astype(np.float32)
              for i, s in enumerate(sizes)]
    t, j = _sketch_pair(chunks)
    np.testing.assert_array_equal(t.cols, j.cols)
    np.testing.assert_array_equal(t.interior, j.interior)
    np.testing.assert_array_equal(t.counts, np.asarray(j.counts))
    assert t.rows == j.rows == sum(sizes)
    # PSI of a shifted histogram against the baseline, in both packages
    shifted = np.roll(t.counts, 1, axis=1) + 3.0
    np.testing.assert_allclose(t.psi(shifted), j.psi(shifted), rtol=1e-12)
    assert (t.psi(shifted) > 0).all() and np.allclose(t.psi(t.counts), 0)
    assert tnum.DriftBaseline.from_state(t.state()).rows == t.rows


def test_health_monitor_defers_and_names_the_chunk():
    """Words are read ``defer`` chunks late; a NaN chunk trips when its
    word is read, naming it, with the health series in a post-mortem."""
    mon = tnum.HealthMonitor("src", defer=2)
    mask = torch.ones(8, dtype=torch.bool)
    for i in range(4):
        x = torch.ones(8, 3) * i
        if i == 3:
            x[0, 0] = float("nan")
        mon.observe(i, x, mask=mask)
    assert mon.checked == 2  # chunks 0 and 1 read; 2 and 3 in flight
    with pytest.raises(tnum.NumericsError, match="chunk 3 of stream 'src'") \
            as info:
        mon.observe(4, torch.ones(8, 3), mask=mask)
        mon.observe(5, torch.ones(8, 3), mask=mask)
    blob = json.loads(open(info.value.postmortem_path).read())
    assert blob["reason"] == "numerics_tripwire"
    series = blob["context"]["recent_health"]
    assert [e["chunk"] for e in series] == [0, 1, 2, 3]
    assert blob["numerics"]["enabled"]
    counters = MetricsRegistry.get_or_create().snapshot()["counters"]
    assert counters["numerics.nan_total"] == 1
    assert counters["numerics.nonfinite"] == 1


def _xy(n=200, d=10, k=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    return X, (X @ rng.randn(d, k)).astype(np.float32)


def _stream(X, chunk, **kw):
    return StreamingDataset.from_numpy(X, chunk, device="cpu", tag="num",
                                       **kw)


@pytest.mark.parametrize("chunk", [48, 64, 96])
def test_streamed_fit_tripwire_names_the_chunk(chunk):
    X, Y = _xy()
    plan = tres.FaultPlan().add("ingest.stage", kind="corrupt", after=1,
                                count=1)
    with plan, pytest.raises(tnum.NumericsError,
                             match="chunk 1 of stream 'num'") as info:
        fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, chunk), Y)
    assert os.path.exists(info.value.postmortem_path)
    # the carry is never finalized into garbage weights
    accumulated = [s.args["chunk"] for s in flight_recorder().spans()
                   if s.name == "accumulate:num"]
    assert max(accumulated) <= 1 + 8


def test_numerics_switches(monkeypatch):
    """Under ``numerics_suppressed`` a poisoned stream fits without a
    tripwire (and without a baseline); the fitted-model tripwire then
    fires on the NaN it produced, unless ``KEYSTONE_TORCH_NUMERICS=0``."""
    from keystone_tpu_torch.nodes.stats import StandardScaler

    X, _ = _xy()
    plan = tres.FaultPlan().add("ingest.stage", kind="corrupt", after=0,
                                count=1)
    with plan, tnum.numerics_suppressed():
        model = StandardScaler().fit(_stream(X, 64))
    assert np.isnan(model.mean[0])
    assert getattr(model, "numerics_baseline", None) is None
    monkeypatch.setenv("KEYSTONE_TORCH_NUMERICS", "0")
    assert not tnum.numerics_active()
    tnum.check_fitted(model, "off")  # no tripwire while off
    monkeypatch.delenv("KEYSTONE_TORCH_NUMERICS")
    with pytest.raises(tnum.NumericsError, match="fitted model"):
        tnum.check_fitted(model, "on")
    assert MetricsRegistry.get_or_create().snapshot()["counters"][
        "numerics.nonfinite_model"] == 1


def test_fit_attaches_a_baseline_that_resume_keeps(tmp_path):
    X, Y = _xy(n=192)
    clean = fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, 32), Y)
    base = clean.numerics_baseline
    assert base.rows == 192 and base.counts.sum() == 192 * len(base.cols)
    ck = str(tmp_path / "ck")
    kill = tres.FaultPlan().add("ingest.produce", after=4, count=1,
                                error=RuntimeError)
    with kill, pytest.raises(RuntimeError):
        fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, 32), Y,
                      checkpoint_dir=ck, checkpoint_every=2)
    resumed = fit_streaming(LinearMapEstimator(lam=0.1), _stream(X, 32), Y,
                            checkpoint_dir=ck, checkpoint_every=2)
    np.testing.assert_array_equal(resumed.numerics_baseline.counts,
                                  base.counts)
    np.testing.assert_array_equal(resumed.numerics_baseline.interior,
                                  base.interior)


def test_solver_ledger_records_breakdowns():
    """The Cholesky gate's verdicts go to the ledger: a healthy solve's
    pivot ratio, a rank-deficient one's breakdown (the eigh fallback)."""
    rng = np.random.RandomState(0)
    A = torch.as_tensor(rng.randn(50, 6).astype(np.float32))
    b = torch.as_tensor(rng.randn(50, 2).astype(np.float32))
    with PipelineTrace("ledger") as tr:
        W = linalg.ridge_cho_solve(A.T @ A, A.T @ b, 0.1)
        dup = torch.cat([A, A[:, :1]], dim=1)
        W2 = linalg.ridge_cho_solve(dup.T @ dup, dup.T @ b, 0.0)
        linalg.bcd_core([A[:, :3], A[:, 3:]], b, 0.1, num_passes=2)
    assert bool(torch.isfinite(W).all()) and bool(torch.isfinite(W2).all())
    snap = MetricsRegistry.get_or_create().snapshot()
    assert snap["counters"]["numerics.solves_total"] == 4
    assert snap["counters"]["numerics.breakdown_total"] == 1
    assert snap["histograms"]["numerics.pivot_ratio"]["count"] >= 3
    assert tr.numerics_stats == {"breakdown": 1}
    assert tr.numerics[0]["site"] == "ridge_cho_solve"
    with tnum.numerics_suppressed():
        linalg.ridge_cho_solve(A.T @ A, A.T @ b, 0.1)
    assert MetricsRegistry.get_or_create().snapshot()["counters"][
        "numerics.solves_total"] == 4


def _band_and_input(two_sided):
    """SIFT's scale-0 smoothing bands of a 300 x 260 image and a seeded
    input with one NaN and one infinity inside the bands, in two of
    three channels (a dense two-sided product makes a poisoned channel
    all non-finite)."""
    from keystone_tpu_torch.ops import sift as tsift

    rng = np.random.RandomState(15)
    left, right = tsift._smooth_band(300, 6), tsift._smooth_band(260, 6)
    X = rng.rand(3, 300, 260).astype(np.float32)
    X[1, 150, 40] = np.nan
    X[0, 30, 200] = np.inf
    if not two_sided:
        return left, None, X[1]
    return left, right, X


@pytest.mark.parametrize("two_sided", [False, True])
def test_banded_nan_lands_where_jax_puts_it(two_sided):
    """The port's banded product on a CPU tensor (its plain version) and
    the JAX package's band contraction on the CPU (SIFT's einsum form, a
    dense product) on the same input with a NaN and an infinity: the
    same non-finite outputs, and the finite ones within 1e-5 of the
    largest."""
    from keystone_tpu.ops import sift as jsift
    from keystone_tpu_torch.ops import kernels

    left, right, X = _band_and_input(two_sided)
    np.testing.assert_array_equal(left, jsift._smooth_band(300, 6))
    got = kernels.banded_matmul(left, torch.as_tensor(X),
                                right=right).numpy()
    if two_sided:
        want = np.asarray(jnp.einsum("ih,chw,jw->cij", jnp.asarray(left),
                                     jnp.asarray(X), jnp.asarray(right)))
    else:
        want = np.asarray(jnp.dot(jnp.asarray(left), jnp.asarray(X)))
    bad = ~np.isfinite(want)
    assert bad.sum() > 0
    np.testing.assert_array_equal(~np.isfinite(got), bad)
    scale = np.abs(want[~bad]).max()
    assert np.abs(got[~bad] - want[~bad]).max() <= 1e-5 * scale


def test_banded_live_reach_lies_between_support_and_tpu_kernel():
    """Where the banded kernels carry a NaN (``banded_live_reach`` at
    their 32-row tiles): every output whose band row holds a nonzero at
    it, and inside what the JAX package's TPU kernel, run in interpret
    mode over its 128 x 128 live tiles, makes non-finite, itself inside
    the dense product's column."""
    from keystone_tpu.ops.pallas_kernels import banded_matmul as jbanded
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.ops import sift as tsift

    # 600 rows: five 128-row tiles, so the TPU kernel skips some blocks
    left = tsift._smooth_band(600, 6)
    X = np.random.RandomState(15).rand(600, 40).astype(np.float32)
    X[150, 5], X[400, 30] = np.nan, np.inf
    reach = kernels.banded_live_reach(left, torch.as_tensor(X),
                                      tile_rows=32).numpy()
    support = (left != 0).astype(np.float32) @ (~np.isfinite(X)) > 0
    tpu = ~np.isfinite(np.asarray(jbanded(left, jnp.asarray(X),
                                          interpret=True)))
    dense = ~np.isfinite(kernels.banded_matmul_plain(
        left, torch.as_tensor(X)).numpy())
    assert support.sum() > 0
    assert not (support & ~reach).any()
    assert not (reach & ~tpu).any()
    assert not (tpu & ~dense).any()
    assert reach.sum() < tpu.sum() < dense.sum()
