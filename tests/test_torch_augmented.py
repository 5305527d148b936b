"""RandomPatchCifarAugmented and what it needs: the port against
``keystone_tpu``.

* ``Cropper`` and ``CenterCornerPatcher`` against the JAX nodes, exact
  (indexing only). ``RandomPatcher`` and ``RandomFlipper`` draw through
  a ``torch.Generator``, which cannot reproduce ``jax.random``: their
  deterministic cores (``crop_patches``, ``flip_where``) are held exact
  against the JAX nodes given the offsets and flip mask the JAX nodes
  draw from their keys, and the port's own draws are held to their
  ranges, to a flip share within 0.02 of 0.5 over 20,000 rows (5 sigma
  is 0.018), and to depending only on (seed, row).
* ``evaluate_augmented`` (both policies) and ``evaluate_binary`` against
  the JAX functions: the same confusion matrices and metrics.
* The utility nodes (``LabelAugmenter``, ``VectorSplitter``, ``Cast``,
  ``DoubleToFloat``, the extractors) and ``utils/image_utils`` against
  their JAX counterparts, exact.
* The augmented app at a small size (128 / 64 surrogate CIFAR images,
  16 filters, 4 patches an image) through both packages: with the JAX
  package's draws fed to the port, the same augmented training set bit
  for bit and test errors within 0.02 (the learned filters agree within
  1e-3 of the largest, ``tests/test_torch_random_patch_cifar.py``, and
  the lam = 0 solve amplifies that); with the port's own draws, test
  errors within 0.08 of each other (64 test images: one standard error
  of an error near 0.5 is 0.0625 / sqrt(2) apart, so 0.08 is about 1.8
  of them; both beat the 0.9 of chance by far).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.evaluation import augmented as jaug
from keystone_tpu.evaluation import binary as jbin
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.nodes.images import core as jcore
from keystone_tpu.nodes import util as jutil
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.parallel.dataset import HostDataset as JHostDataset
from keystone_tpu.pipelines.images.cifar import (
    random_patch_cifar_augmented as japp,
)
from keystone_tpu.utils import image_utils as jimg
from keystone_tpu_torch.evaluation import augmented as taug
from keystone_tpu_torch.evaluation import binary as tbin
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
from keystone_tpu_torch.nodes.images import core as tcore
from keystone_tpu_torch.nodes import util as tutil
from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset
from keystone_tpu_torch.pipelines.images.cifar import (
    random_patch_cifar_augmented as tapp,
)
from keystone_tpu_torch.utils import image_utils as timg
from keystone_tpu_torch.workflow.env import PipelineEnv


def _imgs(n=16, h=32, w=32, seed=0):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 255).astype(
        np.float32)


# -- crops and flips ----------------------------------------------------------

def test_cropper_matches_jax():
    imgs = _imgs(4, 20, 24)
    j = jcore.Cropper(3, 5, 15, 22)
    t = tcore.Cropper(3, 5, 15, 22)
    np.testing.assert_array_equal(
        t.apply_batch(torch.as_tensor(imgs)).numpy(),
        np.stack([np.asarray(j.apply(jnp.asarray(i))) for i in imgs]))
    np.testing.assert_array_equal(t.apply(torch.as_tensor(imgs[1])).numpy(),
                                  np.asarray(j.apply(jnp.asarray(imgs[1]))))


@pytest.mark.parametrize("flips", [False, True])
def test_center_corner_patcher_matches_jax(flips):
    imgs = _imgs(6, 32, 30)
    j = jcore.CenterCornerPatcher(24, 20, horizontal_flips=flips)
    t = tcore.CenterCornerPatcher(24, 20, horizontal_flips=flips)
    want = j.apply_dataset(JArrayDataset.from_numpy(imgs)).numpy()
    got = t.apply_dataset(ArrayDataset.from_numpy(imgs, "cpu"))
    assert got.n == 6 * t.patches_per_image == len(want)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t.apply(torch.as_tensor(imgs[2])).numpy(),
        np.asarray(j.apply(jnp.asarray(imgs[2]))))


def _jax_patch_offsets(seed, rows, npp, H, W, px, py):
    """The offsets the JAX RandomPatcher draws for each row (its
    ``_make_batch``: a key folded with the row index, split in two)."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(seed), jnp.arange(rows))

    def one(key):
        kx, ky = jax.random.split(key)
        return (jax.random.randint(kx, (npp,), 0, H - px + 1),
                jax.random.randint(ky, (npp,), 0, W - py + 1))

    xs, ys = jax.vmap(one)(keys)
    return (torch.as_tensor(np.array(xs), dtype=torch.int64),
            torch.as_tensor(np.array(ys), dtype=torch.int64))


def _jax_flip_mask(seed, rows, prob):
    """The rows the JAX RandomImageTransformer transforms."""
    return torch.as_tensor(np.array(
        jax.random.uniform(jax.random.PRNGKey(seed), (rows,)) < prob))


def test_random_patcher_core_matches_jax_given_its_offsets():
    imgs = _imgs(16, 32, 32)          # 16 rows: no padding on JAX's mesh
    want = jcore.RandomPatcher(5, 24, 20, seed=3).apply_dataset(
        JArrayDataset.from_numpy(imgs)).numpy()
    xs, ys = _jax_patch_offsets(3, 16, 5, 32, 32, 24, 20)
    got = tcore.crop_patches(torch.as_tensor(imgs), xs, ys, 24, 20)
    assert got.shape == (16, 5, 24, 20, 3)
    np.testing.assert_array_equal(got.reshape(80, 24, 20, 3).numpy(), want)


def test_random_flipper_core_matches_jax_given_its_mask():
    imgs = _imgs(32, 8, 10)
    want = jcore.RandomFlipper(0.5, seed=7).apply_dataset(
        JArrayDataset.from_numpy(imgs)).numpy()
    hit = _jax_flip_mask(7, 32, 0.5)
    assert 0 < int(hit.sum()) < 32
    got = tcore.flip_where(torch.as_tensor(imgs), hit)
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_ports_own_draws():
    patcher = tcore.RandomPatcher(10, 24, 20, seed=1)
    xs, ys = patcher.offsets(2000, 32, 30)
    assert xs.shape == ys.shape == (2000, 10)
    assert int(xs.min()) == 0 and int(xs.max()) == 32 - 24
    assert int(ys.min()) == 0 and int(ys.max()) == 30 - 20
    # row i's draws depend only on (seed, i), not on the batch size
    xs8, ys8 = patcher.offsets(8, 32, 30)
    assert torch.equal(xs8, xs[:8]) and torch.equal(ys8, ys[:8])
    other, _ = tcore.RandomPatcher(10, 24, 20, seed=2).offsets(8, 32, 30)
    assert not torch.equal(other, xs8)
    flipper = tcore.RandomFlipper(0.5, seed=4)
    hit = flipper.mask(20000)
    assert abs(float(hit.double().mean()) - 0.5) < 0.02
    assert torch.equal(flipper.mask(100), hit[:100])
    assert float(tcore.RandomFlipper(0.1, seed=4).mask(20000)
                 .double().mean()) == pytest.approx(0.1, abs=0.01)
    # through the dataset path: the drawn crops and flips are applied
    imgs = _imgs(4, 32, 30)
    ds = ArrayDataset.from_numpy(imgs, "cpu")
    out = flipper.apply_dataset(patcher.apply_dataset(ds))
    assert out.n == 40 and out.data.shape == (40, 24, 20, 3)
    xs4, ys4 = patcher.offsets(4, 32, 30)
    want = tcore.flip_where(
        tcore.crop_patches(torch.as_tensor(imgs), xs4, ys4, 24, 20)
        .reshape(40, 24, 20, 3), flipper.mask(40))
    assert torch.equal(out.data, want)


def test_random_image_transformer_applies_its_transform():
    imgs = _imgs(12, 6, 6)
    node = tcore.RandomImageTransformer(0.5, lambda x: x.flip(-3), seed=9)
    out = node.apply_dataset(ArrayDataset.from_numpy(imgs, "cpu")).numpy()
    hit = node.mask(12).numpy()
    np.testing.assert_array_equal(out[hit], imgs[hit][:, ::-1])
    np.testing.assert_array_equal(out[~hit], imgs[~hit])
    assert node.apply(torch.as_tensor(imgs[0])).shape == (6, 6, 3)
    assert tcore.RandomFlipper(0.5, 1) == tcore.RandomFlipper(0.5, 1)
    assert tcore.RandomFlipper(0.5, 1) != tcore.RandomFlipper(0.5, 2)


def test_image_and_label_extractors():
    imgs = torch.as_tensor(_imgs(3, 4, 4))
    labels = torch.tensor([1, 0, 2])
    assert torch.equal(tcore.ImageExtractor().apply_batch((imgs, labels)),
                       imgs)
    assert torch.equal(tcore.LabelExtractor().apply_batch((imgs, labels)),
                       labels)
    item = (np.zeros((2, 2, 3)), 5)
    assert tcore.LabelExtractor().apply(item) == jcore.LabelExtractor(
    ).apply(item) == 5
    assert tcore.ImageExtractor().apply(item) is item[0]


# -- utility nodes ------------------------------------------------------------

def test_label_augmenter_matches_jax():
    labels = np.array([3, 1, 4, 1, 5], np.int32)
    want = jutil.LabelAugmenter(3).apply_dataset(
        JArrayDataset.from_numpy(labels)).numpy()
    got = tutil.LabelAugmenter(3).apply_dataset(
        ArrayDataset.from_numpy(labels, "cpu"))
    assert got.n == 15
    np.testing.assert_array_equal(got.numpy(), want)
    host = tutil.LabelAugmenter(2).apply_dataset(HostDataset(["a", "b"]))
    assert host.collect() == jutil.LabelAugmenter(2).apply_dataset(
        JHostDataset(["a", "b"])).collect() == ["a", "a", "b", "b"]


def test_splitter_and_casts_match_jax():
    x = np.arange(10, dtype=np.float64) * 1.5
    for bs, nf in ((4, None), (3, 9), (10, None)):
        want = jutil.VectorSplitter(bs, nf).apply(jnp.asarray(x))
        got = tutil.VectorSplitter(bs, nf).apply(torch.as_tensor(x))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    X = torch.as_tensor(np.stack([x, x + 1]))
    assert [t.shape for t in tutil.VectorSplitter(4).apply_batch(X)] == [
        (2, 4), (2, 4), (2, 2)]
    for dtype in ("int32", "float32", np.int16):
        got = tutil.Cast(dtype).apply(torch.as_tensor(x))
        want = np.asarray(jutil.Cast(dtype).apply(jnp.asarray(x)))
        assert str(got.numpy().dtype) == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)
    assert tutil.DoubleToFloat().apply(torch.as_tensor(x)).dtype == \
        torch.float32
    with pytest.raises(ValueError):
        tutil.Cast("no-such-type").apply(torch.as_tensor(x))


# -- evaluators ---------------------------------------------------------------

@pytest.mark.parametrize("policy", ["average", "borda"])
def test_evaluate_augmented_matches_jax(policy):
    rng = np.random.RandomState(0)
    names = np.repeat(rng.permutation(40), 5)
    labels = np.repeat(rng.randint(0, 6, 40), 5)[np.argsort(
        np.argsort(names, kind="stable"), kind="stable")]
    labels = np.array([labels[np.where(names == nm)[0][0]] for nm in names])
    preds = rng.randn(200, 6).astype(np.float32)
    want = jaug.evaluate_augmented(names, preds, labels, 6, policy)
    got = taug.evaluate_augmented(names, torch.as_tensor(preds), labels, 6,
                                  policy)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.total_error == want.total_error
    np.testing.assert_array_equal(taug.borda_policy(preds[:5]),
                                  jaug.borda_policy(preds[:5]))
    host = taug.AugmentedExamplesEvaluator().evaluate(
        HostDataset(list(names)), HostDataset([torch.as_tensor(p)
                                               for p in preds]),
        labels, 6, policy)
    np.testing.assert_array_equal(host.confusion, want.confusion)


def test_evaluate_augmented_refuses_disagreeing_labels():
    with pytest.raises(AssertionError, match="disagree"):
        taug.evaluate_augmented([0, 0], np.eye(2), [0, 1], 2)


def test_evaluate_binary_matches_jax():
    rng = np.random.RandomState(1)
    pred, act = rng.rand(500) < 0.4, rng.rand(500) < 0.5
    want = jbin.evaluate_binary(pred, act)
    got = tbin.evaluate_binary(torch.as_tensor(pred),
                               ArrayDataset.from_numpy(act, "cpu"))
    assert (got.tp, got.fp, got.tn, got.fn) == (want.tp, want.fp, want.tn,
                                               want.fn)
    for name in ("accuracy", "error", "recall", "precision", "specificity"):
        assert getattr(got, name) == pytest.approx(getattr(want, name))
    assert got.f_score(2.0) == pytest.approx(want.f_score(2.0))
    assert got.summary() == want.summary()
    merged = got.merge(got)
    assert merged.tp == 2 * got.tp
    empty = tbin.BinaryClassifierEvaluator().evaluate(
        np.zeros(4, bool), np.zeros(4, bool))
    assert np.isnan(empty.recall) and np.isnan(empty.precision)
    assert empty.accuracy == 1.0


# -- image utilities ------------------------------------------------------------

def test_image_utils_match_jax(tmp_path):
    img = _imgs(1, 9, 7)[0]
    t = torch.as_tensor(img)
    pairs = [
        (timg.crop(t, 1, 2, 6, 5), jimg.crop(img, 1, 2, 6, 5)),
        (timg.flip_horizontal(t), jimg.flip_horizontal(img)),
        (timg.flip_vertical(t), jimg.flip_vertical(img)),
        (timg.map_pixels(t, lambda x: x * 2 - 1),
         jimg.map_pixels(img, lambda x: x * 2 - 1)),
        (timg.pixel_combine(t, t), jimg.pixel_combine(img, img)),
        (timg.pixel_combine(t, t, torch.maximum),
         jimg.pixel_combine(img, img, jnp.maximum)),
    ] + list(zip(timg.split_channels(t), jimg.split_channels(img)))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(timg.to_grayscale(t).numpy(),
                               np.asarray(jimg.to_grayscale(img)),
                               rtol=1e-6, atol=1e-4)
    path = str(tmp_path / "img.png")
    timg.write_image(path, t)
    back = timg.load_image(path, device="cpu")
    want = jimg.load_image(path)
    np.testing.assert_array_equal(back.numpy(), want)
    np.testing.assert_array_equal(back.numpy(),
                                  np.clip(img, 0, 255).astype(np.uint8))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    assert timg.load_image(str(bad), device="cpu") is None


# -- the app ------------------------------------------------------------------

CONFIG = dict(num_filters=16, lam=0.01, num_random_patches_augment=4)
N_TRAIN, N_TEST = 128, 64


@pytest.fixture(scope="module")
def surrogate():
    (tr_x, tr_y), (te_x, te_y) = make_surrogate_cifar(N_TRAIN, N_TEST,
                                                      seed=0)
    return tr_x, tr_y.astype(np.int32), te_x, te_y.astype(np.int32)


def _jax_data(x, y):
    return JLabeledData(JArrayDataset.from_numpy(x),
                        JArrayDataset.from_numpy(y))


def _port_data(x, y):
    return LabeledData(ArrayDataset.from_numpy(x, "cpu"),
                       ArrayDataset.from_numpy(y, "cpu"))


@pytest.fixture(scope="module")
def jax_run(surrogate):
    tr_x, tr_y, te_x, te_y = surrogate
    _, ev = japp.run(japp.AugmentedConfig(**CONFIG),
                     train=_jax_data(tr_x, tr_y), test=_jax_data(te_x, te_y))
    return ev


@pytest.fixture
def jax_draws(monkeypatch):
    """Feed the port the draws the JAX nodes make."""
    def offsets(self, rows, H, W):
        return _jax_patch_offsets(self.seed, rows, self.num_patches, H, W,
                                  self.patch_size_x, self.patch_size_y)

    def mask(self, rows):
        return _jax_flip_mask(self.seed, rows, self.prob)

    monkeypatch.setattr(tcore.RandomPatcher, "offsets", offsets)
    monkeypatch.setattr(tcore.RandomImageTransformer, "mask", mask)


def test_augmented_training_set_matches_jax_given_its_draws(surrogate,
                                                            jax_draws):
    tr_x, tr_y, _, _ = surrogate
    cfg = japp.AugmentedConfig(**CONFIG)
    augment = jcore.RandomPatcher(cfg.num_random_patches_augment, 24, 24,
                                  seed=cfg.seed)
    want = jcore.RandomFlipper(0.5, seed=cfg.seed).apply_dataset(
        augment.apply_dataset(JArrayDataset.from_numpy(tr_x))).numpy()
    images, labels = tapp.augment_train(tapp.AugmentedConfig(**CONFIG),
                                        _port_data(tr_x, tr_y))
    np.testing.assert_array_equal(images.numpy(), want)
    np.testing.assert_array_equal(
        labels.get().numpy().argmax(1), np.repeat(tr_y, 4))


def test_augmented_app_matches_jax_given_its_draws(surrogate, jax_run,
                                                   jax_draws):
    tr_x, tr_y, te_x, te_y = surrogate
    PipelineEnv.reset()
    _, ev = tapp.run(tapp.AugmentedConfig(**CONFIG),
                     train=_port_data(tr_x, tr_y),
                     test=_port_data(te_x, te_y), device="cpu")
    assert abs(ev.total_error - jax_run.total_error) <= 0.02, (
        ev.total_error, jax_run.total_error)


def test_augmented_app_with_its_own_draws(surrogate, jax_run):
    tr_x, tr_y, te_x, te_y = surrogate
    PipelineEnv.reset()
    fitted, ev = tapp.run(tapp.AugmentedConfig(**CONFIG),
                          train=_port_data(tr_x, tr_y),
                          test=_port_data(te_x, te_y), device="cpu")
    assert ev.total == N_TEST
    assert ev.total_error < 0.8 and jax_run.total_error < 0.8
    assert abs(ev.total_error - jax_run.total_error) <= 0.08, (
        ev.total_error, jax_run.total_error)
    patches, ids = tapp.augment_test(ArrayDataset.from_numpy(te_x, "cpu"))
    assert patches.n == 10 * N_TEST and ids.tolist()[:11] == [0] * 10 + [1]
    scores = fitted(patches).get()
    assert scores.data.shape == (10 * N_TEST, 10)


def test_run_entry_point_refuses_to_fall_back_to_the_cpu(surrogate):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tr_x, tr_y, te_x, te_y = surrogate
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.run(tapp.AugmentedConfig(**CONFIG),
                 train=_port_data(tr_x, tr_y), test=_port_data(te_x, te_y))
