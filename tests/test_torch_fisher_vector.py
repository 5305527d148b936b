"""GMM, k-means++ and the Fisher vector: the port against ``keystone_tpu``.

The same seeded inputs go through both packages. The FV moments' plain
version is held to the JAX package's bar for its Pallas kernel in
interpret mode, rtol = atol = 2e-4. The posteriors, the Fisher vector and
the fitted GMMs differ only by float32 summation order: 1e-4 of the
largest entry (1e-5 for the posteriors). The k-means++ choices are made
on the host from the same RandomState draws, so the centers are equal.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images import fisher_vector as jfv
from keystone_tpu.nodes.learning import gmm as jgmm
from keystone_tpu.nodes.learning import kmeans as jkmeans
from keystone_tpu.ops.pallas_kernels import fv_moments_pallas
from keystone_tpu.parallel.dataset import HostDataset as JHost
from keystone_tpu_torch import convert
from keystone_tpu_torch.nodes.images import fisher_vector as tfv
from keystone_tpu_torch.nodes.learning import gmm as tgmm
from keystone_tpu_torch.nodes.learning import kmeans as tkmeans
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset

RES = os.path.join(os.path.dirname(__file__), "resources")


def _gmm_params(rng, d, k):
    return (rng.randn(d, k).astype(np.float32),
            (0.5 + rng.rand(d, k)).astype(np.float32),
            rng.dirichlet(np.ones(k)).astype(np.float32))


def _codebook():
    base = os.path.join(RES, "images", "voc_codebook")
    return (os.path.join(base, "means.csv"),
            os.path.join(base, "variances.csv"), os.path.join(base, "priors"))


@pytest.mark.parametrize("d,k,n", [(64, 16, 513), (32, 8, 100), (7, 3, 12)])
def test_fv_moments_plain_matches_pallas_interpret(d, k, n):
    rng = np.random.RandomState(0)
    X = rng.randn(d, n).astype(np.float32)
    means, variances, weights = _gmm_params(rng, d, k)
    want = fv_moments_pallas(
        jnp.asarray(X), jnp.asarray(means), jnp.asarray(variances),
        jnp.asarray(weights), threshold=1e-4, interpret=True)
    before = dict(kernels.LAUNCHES)
    got = kernels.fv_moments(*(torch.as_tensor(a) for a in
                               (X, means, variances, weights)), 1e-4)
    assert kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("d,k,n", [(8, 5, 200), (80, 256, 64)])
def test_posteriors_match_jax(d, k, n):
    rng = np.random.RandomState(d + k)
    X = rng.randn(n, d).astype(np.float32)
    means, variances, weights = _gmm_params(rng, d, k)
    want = np.asarray(jgmm._posteriors(
        jnp.asarray(X), jnp.asarray(means.T), jnp.asarray(variances.T),
        jnp.asarray(weights), 1e-4))
    got = tgmm._posteriors(torch.as_tensor(X), torch.as_tensor(means.T),
                           torch.as_tensor(variances.T),
                           torch.as_tensor(weights), 1e-4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    # the transformer's datum and batch paths
    model = tgmm.GaussianMixtureModel(means, variances, weights)
    np.testing.assert_allclose(model.apply_batch(torch.as_tensor(X)).numpy(),
                               got, atol=1e-6)
    np.testing.assert_allclose(model.apply(torch.as_tensor(X[3])).numpy(),
                               got[3], atol=1e-6)


def test_fisher_vector_on_the_voc_codebook_matches_jax():
    """EncEvalSuite's VOC codebook (80 x 256), loaded by both packages,
    encoding the descriptors of the JAX package's codebook test."""
    jg = jgmm.GaussianMixtureModel.load(*_codebook())
    tg = tgmm.GaussianMixtureModel.load(*_codebook())
    assert tg.dim == 80 and tg.k == 256
    assert abs(tg.weights.sum() - 1.0) < 1e-3 and (tg.variances > 0).all()
    rng = np.random.RandomState(0)
    desc = (tg.means.T[rng.randint(0, 256, 50)]
            + 0.1 * rng.randn(50, 80).astype(np.float32)).astype(np.float32)
    want = np.asarray(jfv.FisherVector(jg).apply(desc.T))
    got = tfv.FisherVector(tg).apply(torch.as_tensor(desc.T)).numpy()
    assert got.shape == (80, 512) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # the same codebook carried across as arrays
    carried = convert.fisher_vector(jg.means, jg.variances, jg.weights,
                                    jg.weight_threshold)
    assert torch.equal(carried.apply(torch.as_tensor(desc.T)),
                       torch.as_tensor(got))


def test_gmm_save_load_round_trip(tmp_path):
    g = tgmm.GaussianMixtureModel.load(*_codebook())
    paths = [str(tmp_path / f) for f in ("m.csv", "v.csv", "w.csv")]
    g.save(*paths)
    back = tgmm.GaussianMixtureModel.load(*paths)
    for a in ("means", "variances", "weights"):
        np.testing.assert_allclose(getattr(back, a), getattr(g, a),
                                   rtol=1e-6)


def _count_em(monkeypatch, module):
    calls = []
    real = module._em_iter

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, "_em_iter", counted)
    return calls


def _fit_both(monkeypatch, X, **kw):
    jcalls = _count_em(monkeypatch, jgmm)
    tcalls = _count_em(monkeypatch, tgmm)
    jm = jgmm.GaussianMixtureModelEstimator(**kw).fit_matrix(X)
    tm = tgmm.GaussianMixtureModelEstimator(**kw).fit_matrix(
        torch.as_tensor(X))
    return jm, tm, len(jcalls), len(tcalls)


def _close_to_largest(got, want, tol=1e-4):
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("case", ["gmm_data", "seeded"])
def test_gmm_fit_matches_jax(monkeypatch, case):
    if case == "gmm_data":
        X = np.loadtxt(os.path.join(RES, "gmm_data.txt")).astype(np.float32)
        kw = dict(k=2, min_cluster_size=1, stop_tolerance=0.0,
                  max_iterations=30, seed=0)
    else:
        rng = np.random.RandomState(7)
        centers = rng.randn(4, 8).astype(np.float32) * 4
        X = (centers[rng.randint(0, 4, 2000)]
             + rng.randn(2000, 8).astype(np.float32))
        kw = dict(k=4, seed=3)
    jm, tm, jits, tits = _fit_both(monkeypatch, X, **kw)
    if case == "seeded":
        assert jits == tits, (jits, tits)
    else:
        # stop_tolerance 0 stops at the first decrease of the mean
        # log-likelihood, which at convergence is float32 rounding noise
        # (the costs step by one unit in the last place, about 5e-7 of
        # -4.9118977 on this fixture), so the stopping iteration may
        # differ by one between two summation orders
        assert abs(jits - tits) <= 1, (jits, tits)
    for a in ("means", "variances", "weights"):
        _close_to_largest(getattr(tm, a), getattr(jm, a))
    assert abs(tm.weights.sum() - 1.0) < 1e-4 and (tm.variances > 0).all()
    if case == "gmm_data":
        # the reference's two-cluster recovery bars
        v = tm.variances.T
        want = np.array([[1.0, 25.0], [25.0, 1.0]])
        assert (np.allclose(v, want, atol=2.0)
                or np.allclose(v, want[::-1], atol=2.0))


def test_random_initialization_matches_jax(monkeypatch):
    rng = np.random.RandomState(2)
    X = rng.randn(600, 5).astype(np.float32)
    jm, tm, jits, tits = _fit_both(monkeypatch, X, k=3,
                                   initialization_method="random", seed=1,
                                   min_cluster_size=5)
    assert jits == tits
    for a in ("means", "variances", "weights"):
        _close_to_largest(getattr(tm, a), getattr(jm, a))


@pytest.mark.parametrize("k,iters", [(4, 1), (6, 10)])
def test_kmeans_plus_plus_picks_the_same_centers(k, iters):
    rng = np.random.RandomState(k)
    X = rng.randn(2000, 8).astype(np.float32)
    jm = jkmeans.KMeansPlusPlusEstimator(k, iters, seed=5).fit_matrix(X)
    tm = tkmeans.KMeansPlusPlusEstimator(k, iters, seed=5).fit(
        ArrayDataset.from_numpy(X, "cpu"))
    np.testing.assert_allclose(tm.means, jm.means, rtol=1e-5, atol=1e-5)
    assign = tm.apply_batch(torch.as_tensor(X)).numpy()
    want = np.stack([np.asarray(jm.apply(x)) for x in X[:50]])
    np.testing.assert_array_equal(assign[:50], want)


def test_fv_estimator_fits_the_columns_gmm():
    """GMMFisherVectorEstimator fits through its default on the columns
    of per-item descriptor matrices, as the JAX estimator does."""
    rng = np.random.RandomState(4)
    items = [rng.randn(6, 90).astype(np.float32) + i for i in range(5)]
    jfit = jfv.GMMFisherVectorEstimator(3)._fit(JHost(items))
    tfit = tfv.GMMFisherVectorEstimator(3).fit(
        HostDataset([torch.as_tensor(m) for m in items]))
    assert isinstance(tfit, tfv.FisherVector)
    for a in ("means", "variances", "weights"):
        _close_to_largest(getattr(tfit.gmm, a), getattr(jfit.gmm, a))
    got = tfit.apply(torch.as_tensor(items[0])).numpy()
    want = np.asarray(jfit.apply(items[0]))
    _close_to_largest(got, want)
