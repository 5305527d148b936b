"""GMM, k-means++ and the Fisher vector: the port against ``keystone_tpu``.

The same seeded inputs go through both packages. The FV moments' plain
version, and the moments of the posteriors built from the kernel's GMM
terms (``kernels.fv_terms``), are held to the JAX package's bar for its
Pallas kernel in interpret mode, rtol = atol = 2e-4. The kernel's 3xTF32
products are emulated in plain PyTorch and held against float64 at the
card's bar, 1e-4 of the largest moment sum. The posteriors, the Fisher vector and
the fitted GMMs differ only by float32 summation order: 1e-4 of the
largest entry (1e-5 for the posteriors). The k-means++ choices are made
on the host from the same RandomState draws, so the centers are equal.
"""
import math
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


def _terms_posteriors(X, terms, threshold):
    """The kernel's posteriors of the columns of X (D, n) from its GMM
    terms: llh = c + x' . B - x'^2 . A with x' = x - g, then the max-shifted
    softmax, threshold and renormalization (``gmm._threshold_softmax``)."""
    xc = X - terms.center[:, None]
    llh = terms.c + xc.T @ terms.B - (xc * xc).T @ terms.A
    return tgmm._threshold_softmax(llh, threshold)


@pytest.mark.parametrize("d,k,n", [(64, 16, 513), (32, 8, 100), (7, 3, 12),
                                   (80, 257, 96)])
def test_fv_terms_match_pallas_interpret_and_posteriors(d, k, n):
    rng = np.random.RandomState(d + k)
    X = rng.randn(d, n).astype(np.float32)
    means, variances, weights = _gmm_params(rng, d, k)
    terms = kernels.fv_terms(*(torch.as_tensor(a) for a in
                               (means, variances, weights)))
    assert [tuple(t.shape) for t in terms] == [(d,), (d, k), (d, k), (k,)]
    assert all(t.is_contiguous() for t in terms)
    q = _terms_posteriors(torch.as_tensor(X), terms, 1e-4)
    # the centered terms round the llh at other places than the uncentered
    # form (float32, llh of order 1e2 here): posteriors move by up to about
    # 1.3e-5, so 3e-5 where the forms that share an order are held to 1e-5
    want_q = np.asarray(jgmm._posteriors(
        jnp.asarray(X.T), jnp.asarray(means.T), jnp.asarray(variances.T),
        jnp.asarray(weights), 1e-4))
    np.testing.assert_allclose(q.numpy(), want_q, rtol=0, atol=3e-5)
    plain_q = tgmm._posteriors(torch.as_tensor(X.T),
                               torch.as_tensor(means.T),
                               torch.as_tensor(variances.T),
                               torch.as_tensor(weights), 1e-4)
    np.testing.assert_allclose(q.numpy(), plain_q.numpy(), rtol=0, atol=3e-5)
    want = fv_moments_pallas(
        jnp.asarray(X), jnp.asarray(means), jnp.asarray(variances),
        jnp.asarray(weights), threshold=1e-4, interpret=True)
    Xt = torch.as_tensor(X)
    for g, w in zip((q.sum(0), Xt @ q, (Xt * Xt) @ q), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def _tf32(v):
    """float32 to TF32 as the kernel splits: the low 13 mantissa bits
    cleared."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's 3xTF32 products: big = tf32(v), small =
    tf32(v - big), (small*big + big*small) + big*big, float32 sums."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (asm @ bb + ab @ bsm) + ab @ bb


def test_fv_moments_3xtf32_emulation_holds_the_card_bar():
    """The kernel's arithmetic in plain PyTorch on descriptors drawn from
    the VOC codebook (80 x 256, means in the hundreds): centered terms,
    both products in 3xTF32, s0 in float32, the block reduce's
    un-centering. The moment sums stay within 1e-4 of the largest against
    float64 (the card's bar against the plain version) and within twice
    the plain float32 version's own error."""
    g = tgmm.GaussianMixtureModel.load(*_codebook())
    rng = np.random.RandomState(0)
    n, thr = 2048, 1e-4
    comp = rng.choice(g.k, n, p=g.weights / g.weights.sum())
    X = torch.as_tensor((g.means[:, comp] + np.sqrt(g.variances[:, comp])
                         * rng.randn(g.dim, n)).astype(np.float32))
    M, V, W = (torch.as_tensor(a) for a in (g.means, g.variances, g.weights))
    t = kernels.fv_terms(M, V, W)
    xc = X - t.center[:, None]
    feats = torch.cat([xc, xc * xc])                      # (2D, n)
    llh = _mm_3xtf32(feats.T, torch.cat([t.B, -t.A])) + t.c
    q = tgmm._threshold_softmax(llh, thr)
    s = _mm_3xtf32(feats, q)
    s0, s1c, s2c = q.sum(0), s[:g.dim], s[g.dim:]
    cen = t.center[:, None]
    emulated = (s0, s1c + cen * s0, s2c + 2 * cen * s1c + cen * cen * s0)
    X64 = X.double()
    q64 = tgmm._posteriors(X64.T, M.double().T, V.double().T, W.double(), thr)
    exact = (q64.sum(0), X64 @ q64, (X64 * X64) @ q64)
    plain = kernels.fv_moments_plain(X, M, V, W, thr)

    def err(got):
        return max(float((a.double() - b).abs().max() / b.abs().max())
                   for a, b in zip(got, exact))

    assert err(emulated) <= 1e-4, err(emulated)
    assert err(emulated) <= 2 * err(plain), (err(emulated), err(plain))


def test_fisher_vector_computes_its_kernel_terms_once_per_device(
        monkeypatch):
    calls = []
    real = tfv.fv_terms

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tfv, "fv_terms", counted)
    rng = np.random.RandomState(3)
    node = tfv.FisherVector(tgmm.GaussianMixtureModel(*_gmm_params(rng, 6, 4)))
    x = torch.as_tensor(rng.randn(6, 40).astype(np.float32))
    outs = [node.apply(x) for _ in range(3)]
    assert len(calls) == 1
    assert all(torch.equal(o, outs[0]) for o in outs)
    means, variances, weights, terms = node.apply_params(x.device)
    assert len(calls) == 1
    want = tfv._fisher_vector(x, means, variances, weights,
                              node.weight_threshold,
                              moments=kernels.fv_moments_plain)
    assert torch.equal(outs[0], want)
    assert math.isclose(float(terms.center.sum()), float(means.mean(1).sum()),
                        rel_tol=1e-6, abs_tol=1e-6)


def test_fisher_vector_past_the_card_kernels_resident_tiles_matches_jax():
    """D = 8, K = 4000: the llh tile of 4000 components does not fit one
    block's shared memory, so the card kernel walks the components in
    chunks (an earlier kernel refused this GMM). The port's FV (the plain
    version here) against the JAX package's, which computes this shape
    through its einsum form."""
    rng = np.random.RandomState(4000)
    X = rng.randn(8, 40).astype(np.float32)
    means, variances, weights = _gmm_params(rng, 8, 4000)
    want = np.asarray(jfv._fisher_vector(
        jnp.asarray(X), jnp.asarray(means), jnp.asarray(variances),
        jnp.asarray(weights), 1e-4, kernel_mode="einsum"))
    got = tfv._fisher_vector(*(torch.as_tensor(a) for a in
                               (X, means, variances, weights)), 1e-4).numpy()
    assert got.shape == want.shape == (8, 8000) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

