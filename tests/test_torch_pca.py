"""Column PCA: the port against ``keystone_tpu``.

Both packages fit the column PCA on the same seeded (16, 50) items, in
its local (centered SVD) and distributed (TSQR) forms. Both forms are
exact PCAs of the same sample, so after the MATLAB sign convention every
port basis agrees with every JAX basis within 1e-4 (float32 SVD and QR
rounding, with well-separated singular values on this data).
"""
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.learning import pca as jpca
from keystone_tpu.parallel.dataset import HostDataset as JHost
from keystone_tpu_torch import convert
from keystone_tpu_torch.nodes.learning import pca as tpca
from keystone_tpu_torch.ops import linalg
from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset

DIMS = 8


def _items(seed=0, count=12):
    rng = np.random.RandomState(seed)
    scales = np.linspace(3.0, 0.2, 16).astype(np.float32)[:, None]
    return [(rng.randn(16, 50).astype(np.float32) * scales + 0.5)
            for _ in range(count)]


@pytest.fixture(scope="module")
def jax_bases():
    items = _items()
    return {
        "local": jpca.LocalColumnPCAEstimator(DIMS)._fit(JHost(items)).pca_mat,
        "distributed": jpca.DistributedColumnPCAEstimator(DIMS)._fit(
            JHost(items)).pca_mat,
    }


@pytest.mark.parametrize("port", ["default", "local", "distributed"])
@pytest.mark.parametrize("ref", ["local", "distributed"])
def test_column_pca_matches_jax(jax_bases, port, ref):
    items = HostDataset([torch.as_tensor(m) for m in _items()])
    est = {"default": tpca.ColumnPCAEstimator(DIMS),
           "local": tpca.LocalColumnPCAEstimator(DIMS),
           "distributed": tpca.DistributedColumnPCAEstimator(DIMS)}[port]
    fitted = est.fit(items)
    assert isinstance(fitted, tpca.BatchPCATransformer)
    want = np.asarray(jax_bases[ref])
    assert fitted.pca_mat.shape == want.shape == (16, DIMS)
    np.testing.assert_allclose(fitted.pca_mat, want, rtol=0, atol=1e-4)


def test_default_is_the_distributed_pca():
    est = tpca.ColumnPCAEstimator(DIMS)
    assert isinstance(est.default, tpca.DistributedColumnPCAEstimator)


def test_column_pca_on_an_array_dataset():
    items = _items(seed=1, count=4)
    stacked = ArrayDataset.from_numpy(np.stack(items), "cpu")
    a = tpca.DistributedColumnPCAEstimator(DIMS).fit(stacked).pca_mat
    b = tpca.DistributedColumnPCAEstimator(DIMS).fit(
        HostDataset([torch.as_tensor(m) for m in items])).pca_mat
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_batch_pca_transformer_apply_matches_jax(jax_bases):
    pca_mat = np.asarray(jax_bases["distributed"])
    x = _items(seed=2, count=1)[0]
    want = np.asarray(jpca.BatchPCATransformer(pca_mat).apply(x))
    node = convert.pca_transformer(pca_mat)
    got = node.apply(torch.as_tensor(x)).numpy()
    assert got.shape == (DIMS, 50)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the vector form
    vec = tpca.PCATransformer(pca_mat)
    np.testing.assert_allclose(
        vec.apply_batch(torch.as_tensor(x.T)).numpy(), want.T, atol=1e-5)


def test_sign_convention_matches_jax():
    m = np.random.RandomState(3).randn(10, 6).astype(np.float32)
    np.testing.assert_array_equal(tpca.enforce_matlab_sign_convention(m),
                                  jpca.enforce_matlab_sign_convention(m))


def test_tsqr_r_has_a_nonnegative_diagonal_and_the_gram():
    A = torch.as_tensor(np.random.RandomState(4).randn(200, 12)
                        .astype(np.float32))
    R = linalg.tsqr_r(A)
    assert (torch.diagonal(R) >= 0).all()
    np.testing.assert_allclose((R.T @ R).numpy(), (A.T @ A).numpy(),
                               rtol=1e-4, atol=1e-3)
