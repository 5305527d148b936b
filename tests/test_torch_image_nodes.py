"""HOG, DAISY and the approximate PCA against the JAX package.

HOG and DAISY run on the same float32 images in both packages at three
sizes (``tests/resources/images/gantrycrane.png`` at 264 x 400 x 3, and
seeded images of 37 x 53 x 3 and 64 x 48 x 1). Both compute in float32
and differ only in summation order: the port builds HOG's cell
histograms by two interpolation matrix products where the JAX package
scatter-adds, and convolves DAISY's maps with ``torch.conv2d`` where the
JAX package uses ``lax.conv``. Features are at most 1 (HOG's are
clamped at 0.2 a block, DAISY's histograms unit-normalized), so the bar
is 1e-5 absolute (the sums read 2.4e-7 apart at most).

The approximate PCA draws the same sketch from ``RandomState(seed)`` in
both packages; on rows with a decaying spectrum its basis matches the
JAX package's column by column (signs fixed by the MATLAB convention)
within 1e-4, and its projector within 1e-5.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from keystone_tpu.nodes.images.daisy import DaisyExtractor as JDaisy
from keystone_tpu.nodes.images.daisy import conv2d_same as jconv
from keystone_tpu.nodes.images.hog import HogExtractor as JHog
from keystone_tpu.nodes.learning.pca import ApproximatePCAEstimator as JAPCA
from keystone_tpu.parallel.dataset import ArrayDataset as JArray
from keystone_tpu_torch.nodes.images import DaisyExtractor, HogExtractor
from keystone_tpu_torch.nodes.images.daisy import conv2d_same
from keystone_tpu_torch.nodes.learning import ApproximatePCAEstimator
from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset

TOL = 1e-5
RES = os.path.join(os.path.dirname(__file__), "resources", "images")


def _gantrycrane():
    img = Image.open(os.path.join(RES, "gantrycrane.png")).convert("RGB")
    return np.asarray(img, np.float32)


IMAGES = {
    "gantrycrane": _gantrycrane,
    "37x53x3": lambda: (np.random.RandomState(0).rand(37, 53, 3)
                        * 255).astype(np.float32),
    "64x48x1": lambda: np.random.RandomState(1).randint(
        0, 256, (64, 48, 1)).astype(np.float32),
}


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("bin_size", [8, 4])
def test_hog_matches_jax(name, bin_size):
    img = IMAGES[name]()
    want = np.asarray(JHog(bin_size).apply(jnp.asarray(img)))
    got = HogExtractor(bin_size).apply(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape and got.shape[1] == 32
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(IMAGES))
def test_daisy_matches_jax(name):
    img = IMAGES[name]()
    want = np.asarray(JDaisy().apply(jnp.asarray(img)))
    ext = DaisyExtractor()
    got = ext.apply(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape and got.shape[0] == ext.feature_size
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_daisy_other_geometry_matches_jax():
    img = IMAGES["37x53x3"]()
    kw = dict(daisy_t=4, daisy_q=2, daisy_r=5, daisy_h=6, pixel_border=6,
              stride=3)
    want = np.asarray(JDaisy(**kw).apply(jnp.asarray(img)))
    got = DaisyExtractor(**kw).apply(torch.as_tensor(img)).numpy()
    assert got.shape == (6 * (4 * 2 + 1), want.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("lx,ly", [(3, 3), (4, 7), (1, 6)])
def test_conv2d_same_is_a_true_convolution_like_jax(lx, ly):
    rng = np.random.RandomState(lx * 10 + ly)
    img = rng.rand(11, 13).astype(np.float32)
    fx, fy = rng.randn(lx), rng.randn(ly)
    got = conv2d_same(torch.as_tensor(img), fx, fy).numpy()
    want = np.asarray(jconv(jnp.asarray(img), fx, fy))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a kernel that is not symmetric shows the flip: a delta at (5, 6)
    # spreads into the kernels' outer product in their own order, from
    # the high side's padding before it
    delta = np.zeros((11, 13), np.float32)
    delta[5, 6] = 1.0
    out = conv2d_same(torch.as_tensor(delta), fx, fy).numpy()
    r0 = 5 - (lx - 1 - (lx - 1) // 2)
    c0 = 6 - (ly - 1 - (ly - 1) // 2)
    np.testing.assert_allclose(out[r0:r0 + lx, c0:c0 + ly],
                               np.outer(fx, fy), rtol=1e-6, atol=1e-7)


def test_the_extractors_map_a_dataset_of_ragged_images():
    imgs = [torch.as_tensor(IMAGES[n]()) for n in ("37x53x3", "64x48x1")]
    for node in (HogExtractor(), DaisyExtractor()):
        out = node.apply_dataset(HostDataset(imgs)).collect()
        for o, img in zip(out, imgs):
            assert torch.equal(o, node.apply(img))


def _decaying_rows(n, d, seed):
    rng = np.random.RandomState(seed)
    basis = np.linalg.qr(rng.randn(d, d))[0]
    return ((rng.randn(n, d) * 0.85 ** np.arange(d)) @ basis.T
            + 3.0).astype(np.float32)


@pytest.mark.parametrize("dims,q,seed", [(10, 10, 0), (6, 2, 3)])
def test_approximate_pca_matches_jax(dims, q, seed):
    X = _decaying_rows(1500, 48, seed)
    want = JAPCA(dims, q=q, seed=seed).fit(JArray.from_numpy(X)).pca_mat
    got = ApproximatePCAEstimator(dims, q=q, seed=seed).fit(
        ArrayDataset.from_numpy(X, "cpu")).pca_mat
    want = np.asarray(want)
    assert got.shape == want.shape == (48, dims)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got @ got.T, want @ want.T, rtol=0,
                               atol=1e-5)


def test_approximate_pca_draws_the_jax_sketch(monkeypatch):
    from keystone_tpu_torch.nodes.learning import pca

    seen = []
    real = pca._randomized_svd_vt
    monkeypatch.setattr(pca, "_randomized_svd_vt", lambda X, omega, q: (
        seen.append(omega.numpy().copy()) or real(X, omega, q)))
    X = _decaying_rows(300, 20, 1)
    ApproximatePCAEstimator(4, p=3, seed=7).approximate_pca(
        torch.as_tensor(X))
    want = np.random.RandomState(7).randn(20, 7).astype(np.float32)
    np.testing.assert_array_equal(seen[0], want)
    # and on a HostDataset of rows, the same basis as on the matrix
    rows = HostDataset([torch.as_tensor(x) for x in X])
    a = ApproximatePCAEstimator(4, seed=7).fit(rows).pca_mat
    b = ApproximatePCAEstimator(4, seed=7).approximate_pca(X)
    np.testing.assert_array_equal(a, b)
