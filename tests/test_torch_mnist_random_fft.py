"""MnistRandomFFT: the port against ``keystone_tpu``.

The random-FFT nodes (RandomSignNode, PaddedFFT, LinearRectifier) and
VectorCombiner on the same seeded inputs within 1e-5 of the largest
output (float32 FFTs of two libraries); the whole app at ``num_ffts =
2`` on 400 / 100 images of the JAX app test's separable blobs
(``tests/test_mnist_random_fft.py``): predictions agree on >= 0.99 of
test images and the test errors within 0.01. The port's surrogate MNIST
generator is held bit for bit against ``bench.py::mnist_bench``'s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.nodes import stats as jstats
from keystone_tpu.nodes import util as jutil
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.pipelines.images.mnist import random_fft as jfft
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.surrogate import make_surrogate_mnist
from keystone_tpu_torch.nodes import stats as tstats
from keystone_tpu_torch.nodes import util as tutil
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.pipelines.images.mnist import random_fft as tfft
from keystone_tpu_torch.workflow.env import PipelineEnv

CENTERS = np.random.RandomState(42).randn(10, 784).astype(np.float32) * 2.0


def _blobs(n, seed):
    """The JAX app test's linearly separable 784-dim 10-class blobs."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    X = CENTERS[labels] + 0.5 * rng.randn(n, 784).astype(np.float32)
    return X.astype(np.float32), labels.astype(np.int32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("n", [784, 100, 1024, 5])
def test_padded_fft_matches_jax(n):
    x = np.random.RandomState(n).randn(6, n).astype(np.float32)
    node, ref = tstats.PaddedFFT(), jstats.PaddedFFT()
    want = np.stack([np.asarray(ref.apply(jnp.asarray(r))) for r in x])
    _close(node.apply_batch(torch.as_tensor(x)), want)
    _close(node.apply(torch.as_tensor(x[0])), want[0])
    padded = 1 << (n - 1).bit_length()
    assert want.shape[1] == padded // 2


def test_random_sign_and_rectifier_match_jax():
    x = np.random.RandomState(0).randn(5, 784).astype(np.float32)
    port_sign = tstats.RandomSignNode.create(784, seed=3)
    ref_sign = jstats.RandomSignNode.create(784, seed=3)
    np.testing.assert_array_equal(port_sign.signs, ref_sign.signs)
    np.testing.assert_array_equal(
        port_sign.apply_batch(torch.as_tensor(x)).numpy(),
        np.asarray(ref_sign.apply(jnp.asarray(x))))
    for max_val, alpha in ((0.0, 0.0), (0.1, 0.25)):
        port = tstats.LinearRectifier(max_val, alpha)
        ref = jstats.LinearRectifier(max_val, alpha)
        np.testing.assert_array_equal(
            port.apply_batch(torch.as_tensor(x)).numpy(),
            np.asarray(ref.apply(jnp.asarray(x))))


def test_vector_combiner_matches_jax():
    rng = np.random.RandomState(1)
    parts = [rng.randn(4, k).astype(np.float32) for k in (3, 5, 2)]
    got = tutil.VectorCombiner().apply_batch(
        tuple(torch.as_tensor(p) for p in parts))
    want = jutil.VectorCombiner().apply(tuple(jnp.asarray(p) for p in parts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = tutil.VectorCombiner().apply(tuple(torch.as_tensor(p[0])
                                             for p in parts))
    np.testing.assert_array_equal(one.numpy(), np.asarray(want)[0])


def test_featurizer_matches_jax():
    x, _ = _blobs(16, seed=5)
    config = tfft.MnistRandomFFTConfig(num_ffts=3, seed=2)
    got = tfft.build_featurizer(config).apply(
        ArrayDataset.from_numpy(x, "cpu")).get().numpy()
    want = jfft.build_featurizer(jfft.MnistRandomFFTConfig(
        num_ffts=3, seed=2)).apply(JArrayDataset.from_numpy(x)).get().numpy()
    assert got.shape == (16, 3 * 512)
    _close(got, want)


def test_mnist_random_fft_run_matches_jax(mesh8):
    train, test = _blobs(400, seed=0), _blobs(100, seed=1)
    kw = dict(num_ffts=2, block_size=512, lam=10.0, seed=0)
    jpipe, jtrain, jtest = jfft.run(
        jfft.MnistRandomFFTConfig(**kw),
        train=JLabeledData(JArrayDataset.from_numpy(train[0]),
                           JArrayDataset.from_numpy(train[1])),
        test=JLabeledData(JArrayDataset.from_numpy(test[0]),
                          JArrayDataset.from_numpy(test[1])))
    PipelineEnv.reset()
    tpipe, ttrain, ttest = tfft.run(
        tfft.MnistRandomFFTConfig(**kw),
        train=LabeledData(ArrayDataset.from_numpy(train[0], "cpu"),
                          ArrayDataset.from_numpy(train[1], "cpu")),
        test=LabeledData(ArrayDataset.from_numpy(test[0], "cpu"),
                         ArrayDataset.from_numpy(test[1], "cpu")),
        device="cpu")
    got = tpipe(ArrayDataset.from_numpy(test[0], "cpu")).get().numpy()
    want = np.asarray(jpipe(JArrayDataset.from_numpy(test[0])).get().numpy())
    assert np.mean(got == want) >= 0.99
    assert abs(ttest.total_error - jtest.total_error) <= 0.01
    assert abs(ttrain.total_error - jtrain.total_error) <= 0.01
    assert ttrain.total_error < 0.05
    # the datum path through the fitted pipeline
    one = tpipe.apply_datum(torch.as_tensor(test[0][0])).get()
    assert int(one) == got[0]


def test_surrogate_mnist_is_bench_generator(monkeypatch):
    """``make_surrogate_mnist`` against the data ``bench.py::mnist_bench``
    hands to the app (captured at the bench's small size)."""
    seen = {}

    class Captured(Exception):
        pass

    def capture(config, train, test):
        seen["train"], seen["test"] = train, test
        raise Captured

    monkeypatch.setattr(bench, "SMALL", True)
    monkeypatch.setattr(jfft, "run", capture)
    with pytest.raises(Captured):
        bench.mnist_bench()
    n_train, n_test = seen["train"].data.n, seen["test"].data.n
    (tx, ty), (vx, vy) = make_surrogate_mnist(n_train, n_test)
    np.testing.assert_array_equal(tx, seen["train"].data.numpy())
    np.testing.assert_array_equal(ty, seen["train"].labels.numpy())
    np.testing.assert_array_equal(vx, seen["test"].data.numpy())
    np.testing.assert_array_equal(vy, seen["test"].labels.numpy())


def test_run_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _blobs(8, seed=0)
    data = LabeledData(ArrayDataset.from_numpy(x, "cpu"),
                       ArrayDataset.from_numpy(y, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfft.run(tfft.MnistRandomFFTConfig(num_ffts=1), train=data,
                 test=data)
