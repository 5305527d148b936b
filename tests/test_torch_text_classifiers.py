"""The port's text classifiers and their sparse products against the JAX
package's, on the CPU.

Mirrors the classifier cases of the JAX package's text tests. The same
seeded inputs go through both packages. Tolerances:

- naive Bayes ``pi`` / ``theta`` within 1e-6 (sums of binary term
  presences are integers, exact in float64; the logs are float64 cast
  to float32);
- logistic regression weights at a fixed iteration count (``tol = 0``)
  within 1e-4 of the largest weight: both run the same L-BFGS in
  float32, the sparse products summing in another order (the port's
  ``CSRMatrix`` row sums against the JAX package's scatter-add), and the
  stop test reads a float32 objective (ROADMAP C10), so the comparison
  is at a fixed count;
- LDA subspaces within 1e-6 (the largest principal angle, radians):
  eigenvectors are free in sign and scale;
- LocalLeastSquares weights within 1e-5 of the largest.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from keystone_tpu.nodes.learning import classifiers as jcls
from keystone_tpu.nodes.util.sparse import SparseVector as JSparseVector
from keystone_tpu.ops.lbfgs import lbfgs as jlbfgs
from keystone_tpu.parallel.dataset import (
    ArrayDataset as JArrayDataset,
    HostDataset as JHostDataset,
)
from keystone_tpu_torch.loaders.surrogate import (
    make_amazon_corpus,
    make_newsgroups_corpus,
)
from keystone_tpu_torch.nodes.learning import (
    LinearDiscriminantAnalysis,
    LocalLeastSquaresEstimator,
    LogisticRegressionEstimator,
    NaiveBayesEstimator,
    NaiveBayesModel,
)
from keystone_tpu_torch.nodes.learning.classifiers import (
    sparse_class_sums,
    sparse_logistic_objective,
)
from keystone_tpu_torch.nodes.nlp import (
    LowerCase,
    NGramsFeaturizer,
    Tokenizer,
    Trim,
)
from keystone_tpu_torch.nodes.stats import TermFrequency
from keystone_tpu_torch.nodes.util import CommonSparseFeatures
from keystone_tpu_torch.nodes.util.sparse import (
    CSRMatrix,
    SparseVector,
    sparse_batch,
)
from keystone_tpu_torch.ops import linalg
from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _vectorized(make, n, seed, features=100_000):
    """A corpus through the apps' featurization: bigram presence pairs,
    the most common features, SparseVectors."""
    docs, y = make(n, seed)
    tf = TermFrequency(lambda x: 1)
    stages = [Trim(), LowerCase(), Tokenizer(), NGramsFeaturizer([1, 2])]
    pairs = []
    for d in docs:
        for s in stages:
            d = s.apply(d)
        pairs.append(tf.apply(d))
    vec = CommonSparseFeatures(features).fit(HostDataset(pairs))
    return [vec.apply(p) for p in pairs], y


def _jax_items(items):
    return JHostDataset([JSparseVector(sv.indices, sv.values, sv.size)
                         for sv in items])


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def news():
    return _vectorized(make_newsgroups_corpus, 300, 1)


@pytest.fixture(scope="module")
def reviews():
    return _vectorized(make_amazon_corpus, 256, 1)


# -- the row-compressed matrix ---------------------------------------------------

def test_csr_float32_by_default_and_float64_on_request():
    rng = np.random.RandomState(0)
    dense = (rng.rand(37, 53) < 0.2) * rng.randn(37, 53)
    items = [SparseVector(np.nonzero(r)[0], r[np.nonzero(r)[0]], 53)
             for r in dense]
    idx, vals, d = sparse_batch(items)
    M = rng.randn(53, 4)
    A = CSRMatrix.from_padded(idx, vals, d, CPU)
    assert A.dtype == torch.float32 and A.values.dtype == torch.float32
    got = A.matmul(torch.as_tensor(M, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, dense.astype(np.float32) @ M,
                               rtol=1e-5, atol=1e-5)
    A64 = CSRMatrix.from_padded(idx, vals, d, CPU, torch.float64)
    At64 = A64.transpose()
    assert At64.dtype == torch.float64 and At64.values.dtype == torch.float64
    Y = rng.randn(37, 3)
    np.testing.assert_allclose(
        At64.matmul(torch.as_tensor(Y)).numpy(),
        dense.astype(np.float32).astype(np.float64).T @ Y, rtol=1e-12)
    with pytest.raises(ValueError):
        CSRMatrix.from_padded(idx, vals, d, CPU, torch.float16)


# -- naive Bayes -----------------------------------------------------------------

def test_sparse_class_sums_equal_the_host_loop_and_repeat(news):
    items, y = news
    idx, vals, d = sparse_batch(items)
    want = np.zeros((20, d))
    for sv, c in zip(items, y):
        want[c, sv.indices] += sv.values
    got = sparse_class_sums(idx, vals, d, y, 20, CPU)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, sparse_class_sums(idx, vals, d, y, 20, CPU))


def test_sparse_naive_bayes_equals_the_jax_one(news):
    items, y = news
    model = NaiveBayesEstimator(20).fit(
        HostDataset(items), ArrayDataset.from_numpy(y, CPU))
    jmodel = jcls.NaiveBayesEstimator(20).fit(
        _jax_items(items), JArrayDataset.from_numpy(y))
    assert model.pi.dtype == model.theta.dtype == torch.float32
    np.testing.assert_allclose(model.pi.numpy(), jmodel.pi, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(model.theta.numpy(), jmodel.theta, rtol=0,
                               atol=1e-6)
    # sparse scoring through SparseLinearMapper(theta.T, intercept=pi)
    test_items, _ = news
    scores = model.apply_dataset(HostDataset(test_items[:64])).numpy()
    jscores = np.asarray(jmodel.apply_dataset(
        _jax_items(test_items[:64])).numpy())
    assert _max_rel(scores, jscores) <= 1e-6
    np.testing.assert_array_equal(scores.argmax(1), jscores.argmax(1))
    # the datum path: one SparseVector
    assert _max_rel(model.apply(test_items[0]).numpy(), np.asarray(
        jmodel.apply(_jax_items(test_items[:1]).items[0]))) <= 1e-6


def test_dense_naive_bayes_equals_the_jax_one():
    rng = np.random.RandomState(4)
    X = rng.poisson(1.5, (90, 17)).astype(np.float32)
    y = rng.randint(0, 5, 90).astype(np.int32)
    model = NaiveBayesEstimator(5, lam=0.5).fit(
        ArrayDataset.from_numpy(X, CPU), ArrayDataset.from_numpy(y, CPU))
    jmodel = jcls.NaiveBayesEstimator(5, lam=0.5).fit(
        JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(y))
    np.testing.assert_allclose(model.pi.numpy(), jmodel.pi, atol=1e-6)
    np.testing.assert_allclose(model.theta.numpy(), jmodel.theta, atol=1e-6)
    got = model.apply_batch(torch.as_tensor(X)).numpy()
    want = np.asarray(jmodel.apply_dataset(JArrayDataset.from_numpy(X))
                      .numpy())
    assert _max_rel(got, want) <= 1e-6
    assert isinstance(pickle_round_trip(model).pi, torch.Tensor)


def pickle_round_trip(obj):
    import pickle

    return pickle.loads(pickle.dumps(obj))


def test_naive_bayes_refuses_a_label_out_of_range(news):
    items, y = news
    with pytest.raises(ValueError):
        NaiveBayesEstimator(3).fit(HostDataset(items),
                                   ArrayDataset.from_numpy(y, CPU))
    with pytest.raises(TypeError):
        NaiveBayesEstimator(3).fit(HostDataset(["a"]),
                                   ArrayDataset.from_numpy(y[:1], CPU))


# -- logistic regression ------------------------------------------------------------

def test_sparse_logistic_regression_equals_the_jax_one_at_fixed_iterations(
        reviews):
    items, y = reviews
    kw = dict(num_classes=2, reg_param=1e-3, num_iters=15,
              convergence_tol=0.0)
    model = LogisticRegressionEstimator(**kw).fit(
        HostDataset(items), ArrayDataset.from_numpy(y, CPU))
    jmodel = jcls.LogisticRegressionEstimator(**kw).fit(
        _jax_items(items), JArrayDataset.from_numpy(y))
    assert model._solve_stats["iterations"] == 15
    assert _max_rel(model.weights.numpy(), jmodel.weights) <= 1e-4
    preds = model.apply_dataset(HostDataset(items)).numpy()
    jpreds = np.asarray(jmodel.apply_dataset(_jax_items(items)).numpy())
    np.testing.assert_array_equal(preds, jpreds)
    assert int(model.apply(items[3])) == int(jpreds[3])


def test_dense_logistic_regression_equals_the_jax_one_at_fixed_iterations():
    rng = np.random.RandomState(5)
    X = rng.randn(120, 9).astype(np.float32)
    y = (X[:, :3].argmax(1)).astype(np.int32)
    kw = dict(num_classes=3, reg_param=1e-2, num_iters=12,
              convergence_tol=0.0)
    model = LogisticRegressionEstimator(**kw).fit(
        ArrayDataset.from_numpy(X, CPU), ArrayDataset.from_numpy(y, CPU))
    jmodel = jcls.LogisticRegressionEstimator(**kw).fit(
        JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(y))
    assert _max_rel(model.weights.numpy(), jmodel.weights) <= 1e-4
    np.testing.assert_array_equal(
        model.apply_batch(torch.as_tensor(X)).numpy(),
        np.asarray(jmodel.apply_dataset(JArrayDataset.from_numpy(X))
                   .numpy()))


def _jax_sparse_logistic_iterations(items, y, k, lam, num_iters, tol):
    """The JAX package's sparse objective, written as its
    ``_run_sparse_logistic`` writes it, through its ``lbfgs``: the
    iteration count its model does not keep."""
    idx, vals, d = sparse_batch(items)
    n = len(y)
    onehot = jax.nn.one_hot(jnp.asarray(y), k, dtype=jnp.float32)
    idx, vals = jnp.asarray(idx), jnp.asarray(vals)
    m = jnp.ones(n, jnp.float32)
    flat = idx.reshape(-1)

    def value_and_grad(W):
        logits = jnp.einsum("rs,rsk->rk", vals, W[idx])
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.sum(onehot * logp, axis=-1) * m
        loss = jnp.sum(ce) / n + 0.5 * lam * jnp.sum(W * W)
        G = (jnp.exp(logp) - onehot) * m[:, None]
        contrib = (vals[:, :, None] * G[:, None, :]).reshape(-1, k)
        return loss, jnp.zeros_like(W).at[flat].add(contrib) / n + lam * W

    res = jax.jit(lambda: jlbfgs(value_and_grad,
                                 jnp.zeros((d, k), jnp.float32),
                                 max_iters=num_iters, tol=tol))()
    return np.asarray(res.x), int(res.num_iters)


def test_sparse_logistic_at_the_apps_settings(reviews):
    """At the Amazon app's own settings (20 iterations, tol 1e-4, no
    penalty) the unregularized fit is ill-conditioned, and float32
    rounding grows over the iterations: the JAX package's own fit on one
    device lies 1.2e-3 of the largest weight from its fit on the test
    harness's eight (the scatter-add sums in another order). Both
    packages stop at the same iteration and predict alike, and the
    port's weights lie no farther from the JAX model's than twice that
    spread. With a penalty both stop early, at the same iteration,
    within 1e-4."""
    items, y = reviews
    for lam, bar in ((0.0, None), (1e-3, 1e-4)):
        model = LogisticRegressionEstimator(2, reg_param=lam,
                                            num_iters=20).fit(
            HostDataset(items), ArrayDataset.from_numpy(y, CPU))
        jmodel = jcls.LogisticRegressionEstimator(
            2, reg_param=lam, num_iters=20).fit(_jax_items(items),
                                                JArrayDataset.from_numpy(y))
        jW, jiters = _jax_sparse_logistic_iterations(items, y, 2, lam, 20,
                                                     1e-4)
        assert model._solve_stats["iterations"] == jiters
        bar = bar or 2.0 * _max_rel(jW, jmodel.weights)
        assert _max_rel(model.weights.numpy(), jmodel.weights) <= bar
        np.testing.assert_array_equal(
            model.apply_dataset(HostDataset(items)).numpy(),
            np.asarray(jmodel.apply_dataset(_jax_items(items)).numpy()))
    assert jiters < 20


def test_sparse_logistic_objective_repeats_its_bits_and_agrees_in_float64(
        reviews):
    items, y = reviews
    idx, vals, d = sparse_batch(items)
    W = torch.as_tensor(np.random.RandomState(0).randn(d, 2) * 0.1,
                        dtype=torch.float32)
    A = CSRMatrix.from_padded(idx, vals, d, CPU)
    vg = sparse_logistic_objective(A, A.transpose(), y, 2, 1e-3)
    (f1, g1), (f2, g2) = vg(W), vg(W)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)
    A64 = CSRMatrix.from_padded(idx, vals, d, CPU, torch.float64)
    f64, g64 = sparse_logistic_objective(A64, A64.transpose(), y, 2,
                                         1e-3)(W.double())
    assert abs(float(f1) - float(f64)) <= 1e-6 * abs(float(f64))
    assert _max_rel(g1.numpy(), g64.numpy()) <= 1e-5


# -- LDA, dual ridge ------------------------------------------------------------------

def _largest_principal_angle(A, B):
    Qa = np.linalg.qr(np.asarray(A, np.float64))[0]
    Qb = np.linalg.qr(np.asarray(B, np.float64))[0]
    s = np.linalg.svd(Qa.T @ Qb, compute_uv=False)
    return float(np.arccos(np.clip(s.min(), -1.0, 1.0)))


def test_lda_subspace_equals_the_jax_one():
    rng = np.random.RandomState(6)
    C, d, per = 4, 7, 60
    means = rng.randn(C, d) * 3.0
    X = np.concatenate([means[c] + rng.randn(per, d) for c in range(C)])
    X = X.astype(np.float32)
    y = np.repeat(np.arange(C), per).astype(np.int32)
    model = LinearDiscriminantAnalysis(C - 1).fit(
        ArrayDataset.from_numpy(X, CPU), ArrayDataset.from_numpy(y, CPU))
    jmodel = jcls.LinearDiscriminantAnalysis(C - 1).fit(
        JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(y))
    W = model.weights.numpy()
    assert W.shape == (d, C - 1) and W.dtype == np.float32
    assert _largest_principal_angle(W, np.asarray(jmodel.weights)) <= 1e-6


def test_local_least_squares_equals_the_jax_one():
    rng = np.random.RandomState(7)
    n, d, k = 24, 300, 3
    A = rng.randn(n, d).astype(np.float32) + 0.5
    B = (A @ rng.randn(d, k) * 0.05 + rng.randn(n, k) * 0.1).astype(
        np.float32)
    model = LocalLeastSquaresEstimator(2.0).fit(
        ArrayDataset.from_numpy(A, CPU), ArrayDataset.from_numpy(B, CPU))
    jmodel = jcls.LocalLeastSquaresEstimator(2.0).fit(
        JArrayDataset.from_numpy(A), JArrayDataset.from_numpy(B))
    assert _max_rel(model.weights.numpy(), jmodel.weights) <= 1e-5
    got = model.apply_batch(torch.as_tensor(A)).numpy()
    want = np.asarray(jmodel.apply_dataset(JArrayDataset.from_numpy(A))
                      .numpy())
    assert _max_rel(got, want) <= 1e-5


def test_local_least_squares_dual_falls_back_on_a_broken_factor():
    """A kernel whose Cholesky factor fails the health gate (duplicate
    rows, lam 0) takes the clamped eigendecomposition and stays finite."""
    rng = np.random.RandomState(8)
    A = rng.randn(6, 40).astype(np.float32)
    A = np.concatenate([A, A[:2]])
    Y = rng.randn(8, 2).astype(np.float32)
    W = linalg.local_least_squares_dual(torch.as_tensor(A),
                                        torch.as_tensor(Y), 0.0)
    assert W.shape == (40, 2) and bool(torch.isfinite(W).all())
