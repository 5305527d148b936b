"""The port's image ops and image nodes against ``keystone_tpu``.

Same seeded numpy inputs through both packages. Window extraction,
pooling by max and vectorizing move values without arithmetic and are
compared exactly; the float32 convolutions and reductions sum in another
order and are held to rtol 1e-5 (atol 1e-4 on values of order 1e3).
The Convolver is also held to the SciPy golden of the reference's
ConvolverSuite, at the tolerance ``tests/test_golden_fixtures.py`` uses.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images import core as jcore
from keystone_tpu.ops import image_ops as jops
from keystone_tpu_torch.nodes.images import core as tcore
from keystone_tpu_torch.ops import image_ops as tops
from keystone_tpu_torch.parallel.dataset import ArrayDataset

RES = os.path.join(os.path.dirname(__file__), "resources")
RTOL, ATOL = 1e-5, 1e-4


def _img(shape=(12, 10, 3), seed=0, scale=255.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(
        np.float32)


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("size,stride", [(3, 1), (4, 2), (5, 3)])
def test_extract_windows_matches_reference(size, stride):
    img = _img()
    want = np.asarray(jops.extract_windows(jnp.asarray(img), size, stride))
    got = tops.extract_windows(_t(img), size, stride).numpy()
    np.testing.assert_array_equal(got, want)


def test_extract_windows_batched_equals_per_image():
    imgs = _img((3, 9, 9, 2))
    batched = tops.extract_windows(_t(imgs), 4, 2)
    for i in range(3):
        np.testing.assert_array_equal(
            batched[i].numpy(), tops.extract_windows(_t(imgs[i]), 4, 2).numpy())


@pytest.mark.parametrize("alpha", [1.0, 10.0])
def test_normalize_rows_matches_reference(alpha):
    mat = _img((20, 27), seed=1)
    want = np.asarray(jops.normalize_rows(jnp.asarray(mat), alpha))
    got = tops.normalize_rows(_t(mat), alpha).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("with_means", [True, False])
def test_filter_bank_convolve_matches_reference(normalize, with_means):
    img = _img((16, 14, 3), seed=2)
    rng = np.random.RandomState(3)
    filters = rng.randn(5, 4 * 4 * 3).astype(np.float32)
    means = rng.randn(48).astype(np.float32) if with_means else None
    want = np.asarray(jops.filter_bank_convolve(
        jnp.asarray(img), jnp.asarray(filters), 4, 3, normalize,
        None if means is None else jnp.asarray(means)))
    got = tops.filter_bank_convolve(
        _t(img), _t(filters), 4, 3, normalize,
        None if means is None else _t(means)).numpy()
    assert got.shape == want.shape == (13, 11, 5)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max() / 1e3))


@pytest.mark.parametrize("pixel_fn", ["identity", "abs", "square"])
@pytest.mark.parametrize("pool_fn", ["sum", "max", "mean"])
def test_pool_image_matches_reference(pixel_fn, pool_fn):
    img = _img((27, 27, 4), seed=4, scale=2.0) - 1.0
    want = np.asarray(jops.pool_image(jnp.asarray(img), 13, 14, pixel_fn,
                                      pool_fn))
    got = tops.pool_image(_t(img), 13, 14, pixel_fn, pool_fn).numpy()
    assert got.shape == want.shape == (2, 2, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_pool_regions_overlap_at_thirteen():
    assert tops.pool_regions(27, 13, 14) == [(0, 14), (13, 27)]


@pytest.mark.parametrize("chans", [1, 3, 4])
def test_to_grayscale_matches_reference(chans):
    img = _img((6, 5, chans), seed=5)
    want = np.asarray(jops.to_grayscale(jnp.asarray(img)))
    got = tops.to_grayscale(_t(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_to_grayscale_promotes_integer_images():
    img = _img((4, 4, 3), seed=6).astype(np.uint8)
    want = np.asarray(jops.to_grayscale(jnp.asarray(img)))
    got = tops.to_grayscale(_t(img))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)


# -- nodes, batch and datum paths ---------------------------------------------

def _node_pairs():
    rng = np.random.RandomState(7)
    filters = rng.randn(4, 3 * 3 * 3).astype(np.float32)
    return {
        "vectorizer": (jcore.ImageVectorizer(), tcore.ImageVectorizer()),
        "grayscaler": (jcore.GrayScaler(), tcore.GrayScaler()),
        "rectifier": (jcore.SymmetricRectifier(0.0, 0.25),
                      tcore.SymmetricRectifier(0.0, 0.25)),
        "pooler": (jcore.Pooler(4, 5, "abs", "max"),
                   tcore.Pooler(4, 5, "abs", "max")),
        "convolver": (jcore.Convolver(filters, 10, 10, 3),
                      tcore.Convolver(filters, 10, 10, 3)),
    }


@pytest.mark.parametrize("name", ["vectorizer", "grayscaler", "rectifier",
                                  "pooler", "convolver"])
def test_image_nodes_batch_and_datum_match_reference(mesh8, name):
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset

    jnode, tnode = _node_pairs()[name]
    imgs = _img((5, 10, 10, 3), seed=8) / 255.0 - 0.5
    want = jnode.apply_dataset(JArrayDataset.from_numpy(imgs)).numpy()
    got = tnode.apply_dataset(ArrayDataset.from_numpy(imgs, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    one = tnode.apply(_t(imgs[2])).numpy()
    np.testing.assert_allclose(one, want[2], rtol=RTOL, atol=1e-5)


def test_windower_matches_reference(mesh8):
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset

    imgs = _img((3, 8, 8, 3), seed=9)
    want = jcore.Windower(2, 4).apply_dataset(JArrayDataset.from_numpy(imgs))
    got = tcore.Windower(2, 4).apply_dataset(
        ArrayDataset.from_numpy(imgs, "cpu", shards=8))
    assert got.n == want.n == 3 * 9
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        tcore.Windower(2, 4).apply(_t(imgs[1])).numpy(),
        np.asarray(jcore.Windower(2, 4).apply(jnp.asarray(imgs[1]))))


def test_convolver_matches_scipy_golden():
    """Reference ConvolverSuite.scala:100-137, as in
    tests/test_golden_fixtures.py: convolving gantrycrane.png with the
    ascending 3x3x3 kernel reproduces the SciPy golden CSV."""
    from PIL import Image

    im = np.asarray(
        Image.open(os.path.join(RES, "images", "gantrycrane.png"))
    ).astype(np.float32)
    raw = np.loadtxt(os.path.join(RES, "images", "convolved.gantrycrane.csv"),
                     delimiter=",", ndmin=2)
    H, W = int(raw[:, 0].max()) + 1, int(raw[:, 1].max()) + 1
    golden = np.zeros((H, W))
    golden[raw[:, 0].astype(int), raw[:, 1].astype(int)] = raw[:, 2]

    k = np.arange(27, dtype=np.float32).reshape(3, 3, 3)  # (dy, dx, c)
    filt = k[::-1, ::-1, ::-1].reshape(1, -1)
    conv = tcore.Convolver(filt, im.shape[0], im.shape[1], 3,
                           normalize_patches=False)
    out = conv.apply(_t(im)).numpy()
    assert out.shape == (H, W, 1)
    np.testing.assert_allclose(out[..., 0], golden, rtol=1e-6, atol=1e-3)
