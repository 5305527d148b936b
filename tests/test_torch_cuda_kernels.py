"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the CUDA kernels
have no CPU mode). They import neither JAX nor the JAX package, so they
also run on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Both sides compute in float32 and differ in summation order. Pooled
features reach ~1e4, so the featurize bar is rtol 1e-5 with atol 1e-5 of
the largest feature. The Gram kernel is held to the JAX package's bar for
its Gram kernel, 2e-4 of the largest entry. The quantized affine kernel and
its plain version apply the same dequantized weights in float32, so the
bar is 1e-5 of the largest output.
"""
import numpy as np
import pytest
import torch

from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool
from keystone_tpu_torch.nodes.learning.linear import (
    LinearMapEstimator,
    _quantize_weights,
)
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.parallel.streaming import StreamingDataset

RTOL, ATOL_REL = 1e-5, 1e-5


def _inputs(B, K, seed):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(B, 32, 32, 3) * 255).astype(np.float32)
    filters = rng.randn(K, 108).astype(np.float32)
    means = rng.randn(108).astype(np.float32)
    return imgs, filters, means


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,K", [(7, 100), (2, 1024), (1, 64)])
def test_cuda_kernel_matches_plain(cuda, B, K):
    imgs, filters, means = (torch.as_tensor(a, device=cuda)
                            for a in _inputs(B, K, seed=B + K))
    before = kernels.LAUNCHES["fused_cifar_featurize"]
    got = kernels.fused_cifar_featurize(imgs, filters, whitener_means=means)
    want = kernels.fused_cifar_featurize_plain(imgs, filters,
                                               whitener_means=means)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_cifar_featurize"] == before + 1
    _close(got.cpu().numpy(), want.cpu().numpy())


def test_cuda_datum_path_launches_the_kernel(cuda):
    imgs, filters, _ = _inputs(2, 32, seed=6)
    node = FusedConvRectifyPool(filters, 32, 6)
    before = kernels.LAUNCHES["fused_cifar_featurize"]
    one = node.apply(torch.as_tensor(imgs[1], device=cuda))
    assert kernels.LAUNCHES["fused_cifar_featurize"] == before + 1
    want = node.apply(torch.as_tensor(imgs[1]))
    _close(one.cpu().numpy(), want.numpy())


def test_cuda_rejects_shapes_the_kernel_does_not_take(cuda):
    imgs, filters, _ = _inputs(1, 8, seed=7)
    with pytest.raises(ValueError):
        kernels.fused_cifar_featurize(
            torch.as_tensor(imgs[:, :31], device=cuda),
            torch.as_tensor(filters, device=cuda))
    with pytest.raises(ValueError):
        kernels.fused_cifar_featurize(
            torch.as_tensor(imgs, device=cuda).double(),
            torch.as_tensor(filters, device=cuda))


@pytest.mark.parametrize("n,d,k", [(7, 3, 2), (100, 37, 5), (513, 128, 16),
                                   (1000, 130, 3)])
def test_cuda_gram_cross_matches_plain(cuda, n, d, k):
    rng = np.random.RandomState(n + d + k)
    X = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    Y = torch.as_tensor(rng.randn(n, k).astype(np.float32), device=cuda)
    G0 = torch.as_tensor(rng.randn(d, d).astype(np.float32), device=cuda)
    G0 = G0 + G0.T
    C0 = torch.as_tensor(rng.randn(d, k).astype(np.float32), device=cuda)
    before = kernels.LAUNCHES["gram_cross"]
    G, C = kernels.gram_cross(X, Y, G0.clone(), C0.clone())
    want_G, want_C = kernels.gram_cross_plain(X, Y, G0.clone(), C0.clone())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gram_cross"] == before + 1
    for got, want in ((G, want_G), (C, want_C)):
        err = float((got - want).abs().max())
        assert err <= 2e-4 * float(want.abs().max()), err
    assert torch.equal(G, G.T)  # the mirrored triangle is exact
    # a column slice (row stride > d) and a uint8 input
    Gs, _ = kernels.gram_cross(X[:, 1:], Y)
    np.testing.assert_allclose(Gs.cpu().numpy(), want_G.cpu().numpy()[1:, 1:]
                               - G0.cpu().numpy()[1:, 1:], rtol=0,
                               atol=2e-4 * float(want_G.abs().max()))
    # uint8 rows: promoted, not wrapped, and exact while every sum stays
    # an integer below 2^24 (at most 200 rows of 255^2)
    m = min(n, 200)
    U = torch.as_tensor(rng.randint(0, 256, (m, d), np.uint8), device=cuda)
    Gu, _ = kernels.gram_cross(U, Y[:m])
    Uf = U.double().cpu()
    np.testing.assert_array_equal(Gu.cpu().numpy(), (Uf.T @ Uf).numpy())


def test_cuda_gram_cross_into_a_carry_at_an_odd_offset(cuda):
    """G and C contiguous but 4 bytes past a 16-byte boundary, with row
    strides that are multiples of 4: the 16-byte epilogue must not be
    taken on them."""
    rng = np.random.RandomState(12)
    n, d, k = 300, 128, 4
    X = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    Y = torch.as_tensor(rng.randn(n, k).astype(np.float32), device=cuda)
    G = torch.zeros(d * d + 1, device=cuda)[1:].view(d, d)
    C = torch.zeros(d * k + 1, device=cuda)[1:].view(d, k)
    assert G.is_contiguous() and G.data_ptr() % 16 == 4
    kernels.gram_cross(X, Y, G, C)
    want_G, want_C = kernels.gram_cross_plain(X, Y)
    torch.cuda.synchronize()
    for got, want in ((G, want_G), (C, want_C)):
        err = float((got - want).abs().max())
        assert err <= 2e-4 * float(want.abs().max()), err


def test_cuda_streamed_fit_matches_the_cpu_fit(cuda):
    """A streamed fit staged through pinned buffers on a side stream, on a
    uint8 wire with a ragged tail, against the same fit on the CPU."""
    rng = np.random.RandomState(11)
    X = rng.randint(0, 256, size=(1000, 40)).astype(np.float32)
    Y = (X @ rng.randn(40, 3) + rng.randn(1000, 3)).astype(np.float32)
    fits = {}
    for dev in ("cpu", cuda):
        stream = StreamingDataset.from_numpy(X, 96, device=dev,
                                             wire_dtype=np.uint8)
        before = kernels.LAUNCHES["gram_cross"]
        fits[str(dev)] = LinearMapEstimator(lam=0.1).fit(stream, Y)
        launched = kernels.LAUNCHES["gram_cross"] - before
        assert launched == (11 if dev == cuda else 0)
        assert stream.buffered_nbytes() == 0.0
        assert stream.peak_device_nbytes <= stream.static_plan_nbytes()
    got = fits[str(cuda)].weights.cpu().numpy()
    want = fits["cpu"].weights.numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _quant_inputs(n, d, k, weight_dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    X = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=device)
    W = torch.as_tensor(rng.randn(d, k).astype(np.float32), device=device)
    Wq, scale = _quantize_weights(W, weight_dtype)
    vecs = [torch.as_tensor(v.astype(np.float32), device=device) for v in
            (rng.randn(d), 1.0 + rng.rand(d), rng.randn(k))]
    return X, Wq, scale, vecs[0], vecs[1], vecs[2]


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,k", [(1, 8192, 10), (64, 8192, 10),
                                   (4096, 8192, 10), (77, 50, 11),
                                   (33, 1000, 1000), (5, 3, 1)])
def test_cuda_quantized_affine_matches_plain(cuda, weight_dtype, n, d, k):
    args = _quant_inputs(n, d, k, weight_dtype, cuda, seed=n + d + k)
    before = kernels.LAUNCHES["quantized_affine"]
    got = kernels.quantized_affine(*args)
    want = kernels.quantized_affine_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantized_affine"] == before + 1
    assert got.shape == (n, k)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    # a fixed summation order: the same inputs give the same bits
    assert torch.equal(got, kernels.quantized_affine(*args))


def test_cuda_quantized_affine_takes_row_slices_and_refuses_the_rest(cuda):
    X, Wq, scale, mean, inv, b = _quant_inputs(40, 300, 7, "int8", cuda)
    big = torch.zeros((45, 305), device=cuda)
    big[3:43, 2:302] = X
    view = big[3:43, 2:302]           # row stride 305, offset 917 floats
    assert not view.is_contiguous() and view.stride(1) == 1
    got = kernels.quantized_affine(view, Wq, scale, mean, inv, b)
    want = kernels.quantized_affine_plain(X, Wq, scale, mean, inv, b)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError, match="unit column stride"):
        kernels.quantized_affine(X.T.contiguous().T, Wq, scale, mean, inv, b)
    with pytest.raises(ValueError, match="unit column stride"):
        kernels.quantized_affine(X.double(), Wq, scale, mean, inv, b)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.quantized_affine(X, Wq.T.contiguous().T, scale, mean, inv, b)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.quantized_affine(X, Wq, scale.cpu(), mean, inv, b)


def test_cuda_plane_launches_the_kernel_once_per_served_batch(cuda):
    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.serving import ItemSpec, ServingPlane

    rng = np.random.RandomState(9)
    X = rng.randn(96, 48).astype(np.float32)
    Y = rng.randn(96, 5).astype(np.float32)
    fitted = LinearMapEstimator(1e-2).with_data(X, Y, device=cuda).fit()
    reg = MetricsRegistry.get_or_create()
    with ServingPlane(max_batch=16, device=cuda) as plane:
        plane.admit("m", fitted, ItemSpec((48,), np.float32),
                    weight_dtype="int8")
        batches0 = reg.counter("serving.batches_total").value
        before = kernels.LAUNCHES["quantized_affine"]
        outs = [plane.predict("m", X[i:i + n])
                for i, n in ((0, 1), (1, 5), (6, 16), (22, 9))]
        served = reg.counter("serving.batches_total").value - batches0
        assert served == 4
        assert kernels.LAUNCHES["quantized_affine"] - before == served
    # the same quantized model applied directly
    mapper = LinearMapEstimator(1e-2, weight_dtype="int8").fit(
        X, Y, device=cuda)
    direct = mapper.apply_batch(torch.as_tensor(X[:31], device=cuda))
    np.testing.assert_allclose(np.concatenate(outs), direct.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    # the per-item apply is a one-row launch
    before = kernels.LAUNCHES["quantized_affine"]
    one = mapper.apply(torch.as_tensor(X[3], device=cuda))
    assert kernels.LAUNCHES["quantized_affine"] == before + 1
    np.testing.assert_allclose(one.cpu().numpy(), outs[1][2], rtol=1e-5,
                               atol=1e-5)
