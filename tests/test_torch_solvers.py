"""The port's solvers and fitted nodes against ``keystone_tpu``: ZCA,
StandardScaler, sampling, ridge Cholesky with its eigh fallback, block
coordinate descent, LinearMapEstimator, the label/classifier nodes and
multiclass evaluation.

Same seeded numpy inputs through both packages, float32 on both sides
(the JAX solvers at HIGHEST precision, the port in true f32 on the CPU).
Tolerances: exact for row selection and integer outputs; rtol 1e-5 for
moments; 1e-4 relative for factorizations and solves, whose f32
rounding is amplified by the conditioning (the data here keep kappa
below ~1e3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.nodes.learning.zca import ZCAWhitenerEstimator as JZCA
from keystone_tpu.nodes.stats import StandardScaler as JScaler
from keystone_tpu.nodes.stats import sampling as jsampling
from keystone_tpu.ops import linalg as jlinalg
from keystone_tpu_torch.nodes.learning import linear as tlinear
from keystone_tpu_torch.nodes.learning.zca import ZCAWhitenerEstimator
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.nodes.stats import sampling as tsampling
from keystone_tpu_torch.ops import linalg as tlinalg
from keystone_tpu_torch.parallel.dataset import ArrayDataset


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _patches(n=400, d=27, seed=0):
    from keystone_tpu_torch.ops.image_ops import normalize_rows

    raw = np.random.RandomState(seed).rand(n, d).astype(np.float32) * 255
    return normalize_rows(torch.as_tensor(raw), 10.0).numpy()


# -- ZCA ---------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.1, 1.0])
def test_zca_whitener_and_means_match_reference(eps):
    mat = _patches()
    want = JZCA(eps).fit_single(mat)
    got = ZCAWhitenerEstimator(eps).fit_single(mat, device="cpu")
    np.testing.assert_allclose(got.means, want.means, rtol=1e-5, atol=1e-6)
    # W = V diag V^T does not depend on the SVD's sign choices
    assert _rel(got.whitener, want.whitener) < 1e-4
    x = torch.as_tensor(mat[:3])
    np.testing.assert_allclose(
        got.apply(x).numpy(), (mat[:3] - want.means) @ want.whitener,
        rtol=1e-4, atol=1e-4)


# -- StandardScaler ----------------------------------------------------------

@pytest.mark.parametrize("normalize_std", [True, False])
def test_standard_scaler_matches_reference(mesh8, normalize_std):
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset

    x = np.random.RandomState(1).randn(13, 6).astype(np.float32) * 3 + 2
    x[:, 4] = 5.0  # a constant column: degenerate std -> 1
    want = JScaler(normalize_std).fit(JArrayDataset.from_numpy(x))
    got = StandardScaler(normalize_std).fit(
        ArrayDataset.from_numpy(x, "cpu", shards=8))
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-6)
    if normalize_std:
        np.testing.assert_allclose(got.std, want.std, rtol=1e-5)
        assert got.std[4] == 1.0
    else:
        assert got.std is None and want.std is None
    batch = got.apply_dataset(ArrayDataset.from_numpy(x, "cpu")).numpy()
    ref = want.apply_dataset(JArrayDataset.from_numpy(x)).numpy()
    np.testing.assert_allclose(batch, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.apply(torch.as_tensor(x[2])).numpy(),
                               np.asarray(want.apply(jnp.asarray(x[2]))),
                               rtol=1e-5, atol=1e-5)


# -- sampling -----------------------------------------------------------------

@pytest.mark.parametrize("n,size", [(50, 10), (20, 100)])
def test_sampler_and_sample_rows_select_reference_rows(mesh8, n, size):
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset

    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    want = jsampling.Sampler(size, seed=3).apply_dataset(
        JArrayDataset.from_numpy(x)).numpy()
    got = tsampling.Sampler(size, seed=3).apply_dataset(
        ArrayDataset.from_numpy(x, "cpu", shards=8)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsampling.sample_rows(x, size, seed=4),
                                  jsampling.sample_rows(x, size, seed=4))


# -- ridge Cholesky and its fallback -----------------------------------------

def test_ridge_cho_solve_matches_reference():
    rng = np.random.RandomState(2)
    A = rng.randn(60, 12).astype(np.float32)
    Y = rng.randn(60, 3).astype(np.float32)
    G, C = A.T @ A, A.T @ Y
    want = np.asarray(jlinalg.ridge_cho_solve(jnp.asarray(G), jnp.asarray(C),
                                              0.5))
    got = tlinalg.ridge_cho_solve(torch.as_tensor(G), torch.as_tensor(C), 0.5)
    assert _rel(got.numpy(), want) < 1e-4


def test_duplicated_columns_at_lam_zero_take_the_eigh_fallback():
    """Duplicate feature columns at lam = 0 collapse the last pivot: the
    health gate rejects the factor and the clamped-eigh solve runs, in
    both packages, giving the same finite weights."""
    rng = np.random.RandomState(3)
    A = rng.randn(80, 6).astype(np.float32)
    A = np.concatenate([A, A[:, :2]], axis=1)  # exact duplicates
    Y = rng.randn(80, 2).astype(np.float32)
    G, C = A.T @ A, A.T @ Y
    _, ok = tlinalg.cholesky_factor(torch.as_tensor(G))
    assert not ok
    jL = jnp.linalg.cholesky(jnp.asarray(G))
    assert not bool(jlinalg._chol_health(jL, jnp.asarray(G))[0])
    want = np.asarray(jlinalg.ridge_cho_solve(jnp.asarray(G), jnp.asarray(C),
                                              0.0))
    got = tlinalg.ridge_cho_solve(torch.as_tensor(G), torch.as_tensor(C),
                                  0.0).numpy()
    assert np.isfinite(got).all()
    direct = tlinalg.eigh_solve(torch.as_tensor(G),
                                torch.as_tensor(C)).numpy()
    np.testing.assert_array_equal(got, direct)
    # the eigh fallback reproduces the least-squares predictions
    assert _rel(A @ got, A @ want) < 1e-3


def test_clamped_eigh_floor_matches_reference():
    rng = np.random.RandomState(4)
    B = rng.randn(5, 5).astype(np.float32)
    reg = B @ B.T
    reg[0, 0] -= 50.0  # make it indefinite
    V, wc = tlinalg.clamped_eigh(torch.as_tensor(reg))
    jV, jwc = jlinalg.clamped_eigh(jnp.asarray(reg))
    np.testing.assert_allclose(np.sort(wc.numpy()), np.sort(np.asarray(jwc)),
                               rtol=1e-4)
    assert float(wc.min()) > 0


# -- block coordinate descent ---------------------------------------------------

@pytest.mark.parametrize("num_blocks,num_iter", [(2, 1), (4, 1), (4, 3)])
def test_block_least_squares_matches_reference(num_blocks, num_iter):
    """2 blocks take the JAX package's unrolled body, 4 equal blocks its
    scan body; the port's Python loop visits blocks in the same order."""
    rng = np.random.RandomState(5 + num_blocks)
    n, bs, k = 96, 8, 3
    X = (rng.randn(n, num_blocks * bs) + rng.rand(num_blocks * bs)).astype(
        np.float32)
    Y = rng.randn(n, k).astype(np.float32)
    bounds = tuple((i * bs, (i + 1) * bs) for i in range(num_blocks))
    jW, jxm, jym = jlinear.block_least_squares(
        jnp.asarray(X), jnp.asarray(Y), n, 0.5, bounds, num_iter)
    tW, txm, tym = tlinear.block_least_squares(
        torch.as_tensor(X), torch.as_tensor(Y), n, 0.5, bounds, num_iter)
    np.testing.assert_allclose(txm.numpy(), np.asarray(jxm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tym.numpy(), np.asarray(jym), rtol=1e-5,
                               atol=1e-6)
    assert len(tW) == len(jW) == num_blocks
    for a, b in zip(tW, jW):
        assert _rel(a.numpy(), np.asarray(b)) < 1e-4


def test_block_least_squares_estimator_matches_reference(mesh8):
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset

    rng = np.random.RandomState(9)
    X = rng.randn(37, 20).astype(np.float32)
    Y = rng.randn(37, 4).astype(np.float32)
    want = jlinear.BlockLeastSquaresEstimator(8, 2, 1.0).fit(
        JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(Y))
    got = tlinear.BlockLeastSquaresEstimator(8, 2, 1.0).fit(
        ArrayDataset.from_numpy(X, "cpu", shards=8),
        ArrayDataset.from_numpy(Y, "cpu", shards=8))
    assert [w.shape[0] for w in got.block_weights] == [8, 8, 4]
    assert _rel(got.weights.numpy(), np.asarray(want.weights)) < 1e-4
    pred = got.apply_dataset(ArrayDataset.from_numpy(X, "cpu")).numpy()
    ref = want.apply_dataset(JArrayDataset.from_numpy(X)).numpy()
    assert _rel(pred, ref) < 1e-4
    assert _rel(got.apply(torch.as_tensor(X[5])).numpy(), ref[5]) < 1e-4


def test_linear_map_estimator_matches_reference(mesh8):
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset

    rng = np.random.RandomState(10)
    X = rng.randn(45, 7).astype(np.float32) + 3.0
    Y = rng.randn(45, 2).astype(np.float32)
    want = jlinear.LinearMapEstimator(0.1).fit(JArrayDataset.from_numpy(X),
                                               JArrayDataset.from_numpy(Y))
    got = tlinear.LinearMapEstimator(0.1).fit(
        ArrayDataset.from_numpy(X, "cpu", shards=8),
        ArrayDataset.from_numpy(Y, "cpu", shards=8))
    ref = want.apply_dataset(JArrayDataset.from_numpy(X)).numpy()
    pred = got.apply_dataset(ArrayDataset.from_numpy(X, "cpu")).numpy()
    assert _rel(pred, ref) < 1e-4
    assert _rel(got.apply(torch.as_tensor(X[3])).numpy(), ref[3]) < 1e-4


# -- labels, classifier, evaluation --------------------------------------------

def test_label_indicators_and_max_classifier_match_reference():
    from keystone_tpu.nodes import util as jutil
    from keystone_tpu_torch.nodes import util as tutil

    labels = np.array([0, 3, 9, 3, 1], np.int32)
    want = np.stack([np.asarray(
        jutil.ClassLabelIndicatorsFromIntLabels(10).apply(jnp.asarray(v)))
        for v in labels])
    got = tutil.ClassLabelIndicatorsFromIntLabels(10).apply_batch(
        torch.as_tensor(labels)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tutil.ClassLabelIndicatorsFromIntLabels(10).apply(
            torch.tensor(3)).numpy(), want[1])
    scores = np.random.RandomState(11).randn(5, 10).astype(np.float32)
    np.testing.assert_array_equal(
        tutil.MaxClassifier().apply_batch(torch.as_tensor(scores)).numpy(),
        np.asarray(jutil.MaxClassifier().apply(jnp.asarray(scores))))


def test_multiclass_evaluation_matches_reference():
    from keystone_tpu.evaluation.multiclass import evaluate_multiclass as jev
    from keystone_tpu_torch.evaluation.multiclass import (
        evaluate_multiclass as tev,
    )

    rng = np.random.RandomState(12)
    pred, actual = rng.randint(0, 4, 50), rng.randint(0, 4, 50)
    want = jev(pred, actual, 4)
    got = tev(ArrayDataset.from_numpy(pred, "cpu"), torch.as_tensor(actual), 4)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.total_error == want.total_error
    assert got.macro_f1 == pytest.approx(want.macro_f1)
    assert got.summary() == want.summary()
