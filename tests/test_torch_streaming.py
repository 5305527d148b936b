"""Streamed fits on the port: the prefetching StreamingDataset, the
accumulate/finalize protocol, and the streamed RandomPatchCifar fit,
held against the port's resident fits and against ``keystone_tpu``.

Inputs are seeded numpy arrays; every port stream lives on the CPU here
(``device="cpu"``), where the Gram kernel's wrapper takes its plain
version. Tolerances, as the JAX package's own streaming tests set them
(``tests/test_streaming.py``): streamed against resident weights within
1e-5 of the largest weight with identical argmax; scaler moments within
1e-5. Port against JAX: the same 1e-5 of the largest weight, both sides
accumulating float32 Grams in different orders.
"""
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.nodes.stats import StandardScaler as JScaler
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.parallel.streaming import StreamingDataset as JStream
from keystone_tpu.parallel.streaming import fit_streaming as jfit_streaming
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
)
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.parallel.dataset import (
    ArrayDataset,
    device_nbytes,
    ensure_array,
)
from keystone_tpu_torch.parallel.streaming import (
    StreamingDataset,
    fit_streaming,
    is_streamable,
)
from keystone_tpu_torch.pipelines.images.cifar import random_patch_cifar as trpc
from keystone_tpu_torch.workflow.common import Cacher
from keystone_tpu_torch.workflow.env import PipelineEnv

W_TOL = 1e-5


def _xy(n=600, d=24, k=3, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * (1.0 + rng.rand(d)) + rng.randn(d)).astype(
        np.float32)
    W = rng.randn(d, k).astype(np.float32)
    Y = (X @ W + 0.1 * rng.randn(n, k)).astype(np.float32)
    return X, Y


def _stream(x, chunk_size, **kw):
    return StreamingDataset.from_numpy(x, chunk_size, device="cpu", **kw)


def _argmax(model, X):
    out = model.apply_dataset(ArrayDataset.from_numpy(X, "cpu")).numpy()
    return np.argmax(out, axis=1)


def _close_weights(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= W_TOL * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


# -- the stream ---------------------------------------------------------------

def test_chunks_order_shapes_mask_and_ragged_tail():
    X = np.arange(100 * 4, dtype=np.float32).reshape(100, 4)
    chunks = list(_stream(X, 32).chunks())
    assert [c.n for c in chunks] == [32, 32, 32, 4]
    assert {c.padded_n for c in chunks} == {32}
    np.testing.assert_array_equal(
        np.concatenate([c.numpy() for c in chunks]), X)
    tail = chunks[-1]
    assert tail.mask.tolist() == [True] * 4 + [False] * 28
    assert np.all(tail.data.numpy()[4:] == 0)


def test_uint8_wire_restores_float32_on_integral_data():
    X = np.random.RandomState(1).randint(0, 256, (96, 8)).astype(np.float32)
    stream = _stream(X, 32, wire_dtype=np.uint8)
    chunks = list(stream.chunks())
    assert all(c.data.dtype == torch.float32 for c in chunks)
    np.testing.assert_array_equal(
        np.concatenate([c.numpy() for c in chunks]), X)
    assert stream.chunk_nbytes() == 32 * 8  # one byte per element staged
    # the plan charges the float32 working copy and the cast transient
    assert stream.static_plan_nbytes() == 2 * 32 * 8 + 32 * 8 * 4 + 32 * 8


def test_compute_dtype_casts_a_native_uint8_source():
    imgs = np.random.RandomState(2).randint(0, 256, (48, 6, 5), np.uint8)
    stream = _stream(imgs, 16, compute_dtype=np.float32)
    chunks = list(stream.chunks())
    assert all(c.data.dtype == torch.float32 for c in chunks)
    np.testing.assert_array_equal(
        np.concatenate([c.numpy() for c in chunks]), imgs.astype(np.float32))
    assert stream.peak_device_nbytes >= 16 * 6 * 5 * 4  # f32 working copy


def test_stream_iterates_again_and_pins_an_unknown_n():
    X = np.random.RandomState(3).rand(50, 3).astype(np.float32)

    def factory():
        for lo in range(0, 50, 16):
            yield X[lo:lo + 16]

    stream = StreamingDataset.from_chunks(factory, 16, device="cpu")
    with pytest.raises(TypeError):
        len(stream)
    assert sum(c.n for c in stream.chunks()) == 50
    assert len(stream) == 50
    assert sum(c.n for c in stream.chunks()) == 50
    assert stream.static_plan_nbytes() is None  # an opaque source


def test_source_error_propagates():
    def factory():
        yield np.zeros((8, 2), np.float32)
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(StreamingDataset.from_chunks(factory, 8, device="cpu").chunks())


def test_early_break_stops_the_producer():
    started = threading.active_count()

    def factory():
        for _ in range(1000):
            yield np.zeros((8, 2), np.float32)

    stream = StreamingDataset.from_chunks(factory, 8, device="cpu")
    for i, _ in enumerate(stream.chunks()):
        if i == 2:
            break
    deadline = time.time() + 5.0
    while threading.active_count() > started and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= started
    assert stream.buffered_nbytes() == 0.0


def test_residency_holds_depth_plus_one_with_slow_consumer():
    """At most prefetch_depth chunks staged plus one working: a consumer
    slower than the producer must not let it stage a (depth + 2)th chunk
    (slots are taken before staging, not after)."""
    n, d, chunk, depth = 512, 8, 64, 2
    X = np.random.RandomState(0).rand(n, d).astype(np.float32)
    stream = _stream(X, chunk, prefetch_depth=depth)
    bound = (depth + 1) * chunk * d * 4
    peaks = []
    for _ in stream.chunks():
        time.sleep(0.05)  # the producer runs far ahead
        peaks.append(stream.buffered_nbytes())
    assert max(peaks) <= bound, (max(peaks), bound)
    assert stream.peak_device_nbytes <= bound
    assert stream.static_plan_nbytes() == bound
    assert stream.buffered_nbytes() == 0.0


def test_residency_bounded_during_a_fit_and_budgets_enforced():
    n, d, chunk, depth = 2048, 16, 64, 2
    X = np.random.RandomState(0).rand(n, d).astype(np.float32)
    Y = np.random.RandomState(1).rand(n, 2).astype(np.float32)
    budget = (depth + 1) * chunk * d * 4 + 4096
    stream = _stream(X, chunk, prefetch_depth=depth, hbm_budget=budget)
    assert n * d * 4 > 5 * budget  # the data genuinely exceeds it
    seen = []
    probe = stream.map_chunks(
        lambda ad: (seen.append(device_nbytes(stream)), ad)[1])
    assert probe.hbm_budget == budget  # a view carries its root's budget
    fit_streaming(LinearMapEstimator(lam=0.1), probe, Y)
    assert seen and max(seen) <= budget
    assert stream.peak_device_nbytes <= budget
    # the static plan refuses before any chunk is staged ...
    tight = _stream(X, chunk, prefetch_depth=depth, hbm_budget=budget // 2)
    with pytest.raises(MemoryError, match="before any chunk"):
        fit_streaming(LinearMapEstimator(lam=0.1), tight, Y)
    assert tight.peak_device_nbytes == 0
    # ... and an opaque source trips the per-chunk check
    opaque = StreamingDataset.from_chunks(
        lambda: (X[i:i + chunk] for i in range(0, n, chunk)), chunk,
        device="cpu", hbm_budget=16.0)
    with pytest.raises(MemoryError, match="exceeded its HBM budget"):
        fit_streaming(LinearMapEstimator(lam=0.1), opaque, Y)
    assert opaque.buffered_nbytes() == 0.0


def test_concurrent_iterations_of_one_root_keep_the_ledger_consistent():
    """Data and labels views of one tuple-chunked root iterate at once (two
    producers and the consumer share the root's ledger) under a short
    thread switch interval: the ledger never goes negative, returns to
    zero, and the fit matches the resident one."""
    import sys

    X, Y = _xy(n=640, seed=5)
    both = _stream((X, Y), 64)

    def pick(i):
        return lambda ad: ArrayDataset(ad.data[i], ad.n)

    xs, ys = both.map_chunks(pick(0)), both.map_chunks(pick(1))
    lows = []
    probe = xs.map_chunks(
        lambda ad: (lows.append(both.buffered_nbytes()), ad)[1])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        model = fit_streaming(LinearMapEstimator(lam=0.1), probe, ys)
    finally:
        sys.setswitchinterval(interval)
    assert len(lows) == 10 and min(lows) >= 0.0
    assert both.buffered_nbytes() == 0.0
    resident = LinearMapEstimator(lam=0.1)._fit(
        ArrayDataset.from_numpy(X, "cpu"), ArrayDataset.from_numpy(Y, "cpu"))
    _close_weights(model.weights, resident.weights)


@pytest.mark.parametrize("case", ["short_labels_stream",
                                  "long_labels_stream",
                                  "misaligned_chunks", "long_resident"])
def test_misaligned_labels_raise(case):
    X, Y = _xy(n=200)
    data, labels = {
        "short_labels_stream": (_stream(X, 64), _stream(Y[:100], 64)),
        "long_labels_stream": (_stream(X[:128], 64), _stream(Y, 64)),
        "misaligned_chunks": (_stream(X, 64), _stream(Y, 50)),
        "long_resident": (_stream(X[:128], 64), Y),
    }[case]
    with pytest.raises(ValueError, match="misaligned|ended|exhausted"):
        fit_streaming(LinearMapEstimator(lam=0.1), data, labels)
    assert data.buffered_nbytes() == 0.0


def test_streamed_labels_with_resident_data_raise():
    X, Y = _xy(n=160)
    with pytest.raises(TypeError, match="labels are a StreamingDataset"):
        LinearMapEstimator(lam=0.1).fit(X, _stream(Y, 80), device="cpu")
    with pytest.raises(TypeError, match="labels are a StreamingDataset"):
        LinearMapEstimator(lam=0.1).fit_datasets(
            [ArrayDataset.from_numpy(X, "cpu"), _stream(Y, 80)])


def test_streams_are_never_promoted_implicitly():
    X, Y = _xy(n=64)
    with pytest.raises(TypeError, match="materialize"):
        ensure_array(_stream(X, 32))
    # a resident fit handed a stream refuses it rather than promote it
    with pytest.raises(TypeError, match="materialize"):
        LinearMapEstimator(lam=0.1)._fit(_stream(X, 32),
                                         ArrayDataset.from_numpy(Y, "cpu"))


def test_non_streamable_estimator_is_refused():
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitenerEstimator

    X, _ = _xy(n=64)
    assert not is_streamable(ZCAWhitenerEstimator())
    with pytest.raises(TypeError, match="accumulate"):
        fit_streaming(ZCAWhitenerEstimator(), _stream(X, 32))


def test_transformer_chain_applies_per_chunk():
    X, Y = _xy(n=200)
    ds = ArrayDataset.from_numpy(X, "cpu")
    scaler = StandardScaler()._fit(ds)
    model = LinearMapEstimator(lam=0.1)._fit(
        ds, ArrayDataset.from_numpy(Y, "cpu"))
    resident = model.apply_dataset(scaler.apply_dataset(ds)).numpy()
    stream = model.apply_dataset(scaler.apply_dataset(_stream(X, 64)))
    assert isinstance(stream, StreamingDataset)  # lazy, nothing ran yet
    np.testing.assert_allclose(stream.materialize().numpy(), resident,
                               rtol=1e-6, atol=1e-6)


# -- streamed against resident, inside the port --------------------------------

@pytest.mark.parametrize("chunk_size", [64, 96, 200])
def test_linear_map_streamed_matches_resident(chunk_size):
    X, Y = _xy()
    resident = LinearMapEstimator(lam=0.1)._fit(
        ArrayDataset.from_numpy(X, "cpu"), ArrayDataset.from_numpy(Y, "cpu"))
    streamed = fit_streaming(LinearMapEstimator(lam=0.1),
                             _stream(X, chunk_size), _stream(Y, chunk_size))
    _close_weights(streamed.weights, resident.weights)
    np.testing.assert_array_equal(_argmax(streamed, X), _argmax(resident, X))


@pytest.mark.parametrize("chunk_size", [96, 250])
def test_block_ls_streamed_matches_resident(chunk_size):
    X, Y = _xy()
    resident = BlockLeastSquaresEstimator(10, 3, lam=0.1)._fit(
        ArrayDataset.from_numpy(X, "cpu"), ArrayDataset.from_numpy(Y, "cpu"))
    streamed = fit_streaming(BlockLeastSquaresEstimator(10, 3, lam=0.1),
                             _stream(X, chunk_size),
                             ArrayDataset.from_numpy(Y, "cpu"))
    assert len(streamed.block_weights) == len(resident.block_weights) == 3
    _close_weights(streamed.weights, resident.weights)
    np.testing.assert_array_equal(_argmax(streamed, X), _argmax(resident, X))


@pytest.mark.parametrize("block_size,passes", [(8, 1), (10, 3)])
def test_gram_bcd_in_float64_matches_the_data_form(block_size, passes):
    """The Gram-form BCD and the data-form BCD are equal in exact
    arithmetic; in float64 on the same input they agree to float64
    rounding (1e-10 of the largest weight), so any gap between the two
    float32 fits is rounding, not algebra. The data form is written out
    here, independent of the port's solvers."""
    from keystone_tpu_torch.nodes.learning.linear import gram_bcd

    X, Y = (torch.as_tensor(a, dtype=torch.float64) for a in _xy(n=300))
    lam, d = 0.1, X.shape[1]
    bounds = [(lo, min(d, lo + block_size)) for lo in range(0, d, block_size)]
    A, Yc = X - X.mean(dim=0), Y - Y.mean(dim=0)
    want = torch.zeros((d, Y.shape[1]), dtype=torch.float64)
    for _ in range(passes):
        for lo, hi in bounds:
            Ab = A[:, lo:hi]
            rhs = Ab.T @ (Yc - A @ want + Ab @ want[lo:hi])
            want[lo:hi] = torch.linalg.solve(
                Ab.T @ Ab + lam * torch.eye(hi - lo, dtype=torch.float64), rhs)
    carry = (X.T @ X, X.T @ Y, X.sum(dim=0), Y.sum(dim=0), X.shape[0])
    Ws, x_mean, y_mean = gram_bcd(carry, lam, bounds, passes)
    got = torch.cat(Ws)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())
    np.testing.assert_allclose(x_mean.numpy(), X.mean(dim=0).numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(y_mean.numpy(), Y.mean(dim=0).numpy(),
                               rtol=1e-12)


def test_scaler_streamed_matches_resident():
    X, _ = _xy()
    resident = StandardScaler()._fit(ArrayDataset.from_numpy(X, "cpu"))
    streamed = StandardScaler().fit(_stream(X, 88))
    np.testing.assert_allclose(streamed.mean, resident.mean, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(streamed.std, resident.std, rtol=1e-5,
                               atol=1e-5)


def test_uint8_wire_streamed_fit_matches_resident():
    rng = np.random.RandomState(4)
    X = rng.randint(0, 256, size=(600, 24)).astype(np.float32)
    Y = (X @ rng.randn(24, 3) + 0.1 * rng.randn(600, 3)).astype(np.float32)
    resident = LinearMapEstimator(lam=0.1)._fit(
        ArrayDataset.from_numpy(X, "cpu"), ArrayDataset.from_numpy(Y, "cpu"))
    streamed = LinearMapEstimator(lam=0.1).fit(
        _stream(X, 96, wire_dtype=np.uint8), Y)
    _close_weights(streamed.weights, resident.weights)


# -- port against the JAX package --------------------------------------------------

@pytest.mark.parametrize("which", ["linear_map", "block_ls"])
def test_fit_streaming_matches_reference(mesh8, which):
    X, Y = _xy(n=400, d=20, k=3, seed=7)
    make = {"linear_map": (lambda m: m.LinearMapEstimator(lam=0.1)),
            "block_ls": (lambda m: m.BlockLeastSquaresEstimator(8, 2, 0.1))}
    from keystone_tpu_torch.nodes.learning import linear as tlinear

    want = jfit_streaming(make[which](jlinear), JStream.from_numpy(X, 96),
                          JArrayDataset.from_numpy(Y))
    got = fit_streaming(make[which](tlinear), _stream(X, 96), Y)
    _close_weights(got.weights, want.weights)


def test_scaler_fit_streaming_matches_reference(mesh8):
    X, _ = _xy(n=300, seed=8)
    want = jfit_streaming(JScaler(), JStream.from_numpy(X, 64))
    got = fit_streaming(StandardScaler(), _stream(X, 64))
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-5, atol=1e-5)


# -- the slice as a whole: streamed RandomPatchCifar -------------------------------

def _ops(fitted):
    g = fitted._graph
    return {type(g.get_operator(n)).__name__: g.get_operator(n)
            for n in g.nodes}


@pytest.fixture(scope="module")
def streamed_cifar():
    """RandomPatchCifar fitted on 96 surrogate images streamed in chunks
    of 40 (a ragged tail of 16) by both packages through
    ``build_pipeline(...).fit()``, with the JAX-learned filters and
    whitener fed to both, and ``materialize`` of both packages' streams
    patched to raise for the whole fit. The port's resident fit on the
    same data rides along."""
    from keystone_tpu.nodes.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu.pipelines.images.cifar import random_patch_cifar as jrpc
    from keystone_tpu.workflow.common import Cacher as JCacher
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels as TLabels,
    )

    (trx, trl), (tex, tel) = make_surrogate_cifar(96, 32)
    conf = dict(num_filters=8, lam=10.0, seed=0)
    jconf, tconf = (jrpc.RandomCifarConfig(**conf),
                    trpc.RandomCifarConfig(**conf))
    filters, jw = jrpc.learn_filters(JArrayDataset.from_numpy(trx), jconf)
    tw = convert.whitener_from_arrays(jw.means, jw.whitener)
    jlabels = (ClassLabelIndicatorsFromIntLabels(10) >> JCacher("labels"))(
        JArrayDataset.from_numpy(trl.astype(np.int32)))
    tlabels = (TLabels(10) >> Cacher("labels"))(
        ArrayDataset.from_numpy(trl.astype(np.int32), "cpu"))

    def boom(self):
        raise AssertionError("stream was materialized during pipeline fit")

    tstream = _stream(trx, 40)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JStream, "materialize", boom)
        mp.setattr(StreamingDataset, "materialize", boom)
        jfit = jrpc.build_pipeline(filters, jw, jconf,
                                   JStream.from_numpy(trx, chunk_size=40),
                                   jlabels).fit()
        tfit = trpc.build_pipeline(filters, tw, tconf, tstream,
                                   tlabels).fit()
    resident = trpc.build_pipeline(filters, tw, tconf,
                                   ArrayDataset.from_numpy(trx, "cpu"),
                                   tlabels).fit()
    return dict(jfit=jfit, tfit=tfit, resident=resident, tstream=tstream,
                test=tex, filters=filters, tw=tw)


def test_streamed_cifar_fit_matches_reference(streamed_cifar):
    s = streamed_cifar
    jpred = s["jfit"].apply(JArrayDataset.from_numpy(s["test"])).numpy()
    tpred = s["tfit"].apply(ArrayDataset.from_numpy(s["test"], "cpu")).numpy()
    np.testing.assert_array_equal(tpred, jpred)
    # features from the same filters differ by float32 rounding (the JAX
    # composed ops against the port's plain featurize), which the scaler
    # and the lam = 10 solve carry into the weights: 1e-4 of the largest
    # weight, the port's solver bar (measured 9.9e-6)
    jW = np.asarray(_ops(s["jfit"])["BlockLinearMapper"].weights)
    tW = _ops(s["tfit"])["BlockLinearMapper"].weights.numpy()
    assert tW.shape == jW.shape == (64, 10)
    assert np.abs(tW - jW).max() <= 1e-4 * np.abs(jW).max()


def test_streamed_cifar_fit_matches_the_resident_fit(streamed_cifar):
    s = streamed_cifar
    rW = _ops(s["resident"])["BlockLinearMapper"].weights.numpy()
    tW = _ops(s["tfit"])["BlockLinearMapper"].weights.numpy()
    _close_weights(tW, rW)
    test = ArrayDataset.from_numpy(s["test"], "cpu")
    np.testing.assert_array_equal(s["tfit"].apply(test).numpy(),
                                  s["resident"].apply(test).numpy())


def test_streamed_cifar_applies_chunk_by_chunk_and_per_datum(streamed_cifar):
    s = streamed_cifar
    want = s["tfit"].apply(ArrayDataset.from_numpy(s["test"], "cpu")).numpy()
    out = s["tfit"].apply(_stream(s["test"], 12)).get()
    assert isinstance(out, StreamingDataset)
    got = np.concatenate([c.numpy() for c in out.chunks()])
    np.testing.assert_array_equal(got, want)
    for i in (0, 13, 31):
        assert int(s["tfit"].apply_datum(
            torch.as_tensor(s["test"][i])).get()) == want[i]


def test_featurized_ragged_chunk_rows_are_rezeroed(streamed_cifar):
    """Featurizing a zero pad row gives -bias before rectification, which
    rectifies to nonzero features; the chunk's map_batch must zero the
    rows past n again before the Gram sees them."""
    from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool

    s = streamed_cifar
    means = np.random.RandomState(9).randn(108).astype(np.float32) * 20
    node = FusedConvRectifyPool(s["filters"], 32, 6,
                                whitener=convert.whitener_from_arrays(means))
    raw = node.apply_batch(torch.zeros(1, 32, 32, 3))
    assert float(raw.abs().max()) > 0  # a zero image featurizes nonzero
    chunks = list(node.apply_dataset(_stream(s["test"], 24)).chunks())
    assert [c.n for c in chunks] == [24, 8]
    assert float(chunks[-1].data[8:].abs().max()) == 0.0
    assert float(chunks[-1].data[:8].abs().max()) > 0


def test_streamed_fit_leaves_nothing_on_the_device(streamed_cifar):
    """After the fit the stream holds no staged chunk, and the prefix
    memo holds lazy streams, never chunks: a cached stream is the stream
    itself."""
    s = streamed_cifar
    stream = s["tstream"]
    assert stream.buffered_nbytes() == 0.0
    assert 0 < stream.peak_device_nbytes <= 3 * 40 * 32 * 32 * 3 * 4
    assert Cacher("x").apply_dataset(stream) is stream
    memo = [e.get() for e in PipelineEnv.get_or_create().state.values()
            if e.computed]
    streams = [v for v in memo if isinstance(v, StreamingDataset)]
    assert any(v._residency is stream._residency for v in streams)
    for v in streams:
        assert v.buffered_nbytes() == 0.0
        assert not any(isinstance(a, (torch.Tensor, ArrayDataset))
                       for a in vars(v).values())


def test_pipeline_streamed_fit_never_materializes(monkeypatch):
    from keystone_tpu_torch.workflow.transformer import transformer

    X, Y = _xy(n=320, d=16, k=3)

    def boom(self):
        raise AssertionError("stream was materialized during pipeline fit")

    monkeypatch.setattr(StreamingDataset, "materialize", boom)
    train = _stream(X, 128, tag="pipe")
    pipe = transformer(lambda x: x * 1.0).and_then(
        StandardScaler(), train).and_then(
        BlockLeastSquaresEstimator(8, 2, lam=1e-2), train,
        ArrayDataset.from_numpy(Y, "cpu"))
    fitted = pipe.fit()
    out = fitted.apply(ArrayDataset.from_numpy(X, "cpu")).get().numpy()
    assert out.shape == (320, 3)
    assert train.peak_device_nbytes > 0  # the fit consumed the stream
