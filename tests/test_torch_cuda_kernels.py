"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the CUDA kernels
have no CPU mode). They import neither JAX nor the JAX package, so they
also run on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Both sides compute in float32 and differ in summation order. Pooled
features reach ~1e4, so the featurize bar is rtol 1e-5 with atol 1e-5 of
the largest feature. The Gram kernel (3xTF32 products) is held to the JAX
package's bar for its Gram kernel, 2e-4 of the largest entry, and against
float64 to its own bar (``chip_smoke.GRAM_F64_ULPS``). The quantized
affine kernel and its plain version apply the same dequantized weights
in float32, so the bar is 1e-5 of the largest output. The banded products (one-sided and
two-sided) sum the same band entries in another order than the dense
plain products: 1e-5 of the largest output. The FV moments' plain
version writes the posteriors out and takes its exponentials in another
order, and the kernel's products run in 3xTF32 on centered terms: 1e-4
of the largest sum. The sparse L-BFGS fit (plain PyTorch, no kernel) on
the card against its CPU fit: 1e-4 of the largest weight, and the same
bits on a second fit.
"""
import numpy as np
import pytest
import torch

from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLinearMapper,
    LinearMapEstimator,
    _quantize_weights,
)
from keystone_tpu_torch.ops import kernels, sift
from keystone_tpu_torch.parallel.streaming import StreamingDataset
from keystone_tpu_torch.serving.graphs import REPLAYED_LAUNCHES
from keystone_tpu_torch.workflow.transformer import Transformer

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


@pytest.mark.parametrize("B,K", [(7, 100), (2, 1024), (1, 64), (64, 1024),
                                 (64, 100)])
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


def _geometry_inputs(B, K, S, C, seed):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(B, 32, 32, C) * 255).astype(np.float32)
    filters = rng.randn(K, S * S * C).astype(np.float32)
    means = rng.randn(S * S * C).astype(np.float32)
    return imgs, filters, means


@pytest.mark.parametrize("S,C,stride,size,R", [
    (6, 3, 9, 10, 9), (6, 3, 7, 8, 16), (9, 1, 13, 14, 4), (6, 4, 13, 14, 4),
    (5, 3, 4, 8, 36), (6, 3, 13, 14, 4)])
def test_cuda_kernel_matches_plain_at_every_geometry(cuda, S, C, stride,
                                                     size, R):
    """Pooling with 9, 16 and 36 regions, patch size 9 on one channel,
    four channels: one kernel takes them all; K = 200 is off the
    128-filter tile and B = 3 leaves most blocks without an image."""
    imgs, filters, means = (torch.as_tensor(a, device=cuda)
                            for a in _geometry_inputs(3, 200, S, C, seed=S))
    kw = dict(patch_size=S, channels=C, pool_stride=stride, pool_size=size,
              whitener_means=means)
    before = kernels.LAUNCHES["fused_cifar_featurize"]
    got = kernels.fused_cifar_featurize(imgs, filters, **kw)
    want = kernels.fused_cifar_featurize_plain(imgs, filters, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_cifar_featurize"] == before + 1
    assert got.shape == want.shape == (3, R * 2 * 200)
    _close(got.cpu().numpy(), want.cpu().numpy())
    # one thread sums each value in a fixed order: the same bits again
    assert torch.equal(got, kernels.fused_cifar_featurize(imgs, filters, **kw))


#: the featurize kernel against the float64 plain version: no worse than
#: this many times the float32 plain version's error (chip_smoke.py's
#: FEATURIZE_F64_RATIO)
FEATURIZE_F64_RATIO = 2.0


@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_kernel_against_float64(cuda, seed):
    """At B = 256, K = 1024, on chip_smoke.py's inputs (pixels in [0, 255),
    filters of 0.1 randn, whitener means of 20 randn), the kernel's 3xTF32
    product keeps the pooled features as close to float64 as the plain
    float32 version within FEATURIZE_F64_RATIO, and a second launch
    gives the same bits."""
    rng = np.random.RandomState(100 + seed)
    imgs = torch.as_tensor((rng.rand(256, 32, 32, 3) * 255).astype(
        np.float32), device=cuda)
    filters = torch.as_tensor((rng.randn(1024, 108) * 0.1).astype(
        np.float32), device=cuda)
    means = torch.as_tensor((rng.randn(108) * 20).astype(np.float32),
                            device=cuda)
    want = kernels.fused_cifar_featurize_plain(
        imgs.double(), filters.double(), whitener_means=means.double())
    got = kernels.fused_cifar_featurize(imgs, filters, whitener_means=means)
    plain = kernels.fused_cifar_featurize_plain(imgs, filters,
                                                whitener_means=means)
    k_err = float((got.double() - want).abs().max())
    p_err = float((plain.double() - want).abs().max())
    assert k_err <= FEATURIZE_F64_RATIO * p_err, (k_err, p_err)
    assert torch.equal(got, kernels.fused_cifar_featurize(
        imgs, filters, whitener_means=means))


@pytest.mark.parametrize("S,C,variant", [(6, 3, "registers"),
                                         (5, 3, "registers"),
                                         (6, 4, "streamed")])
def test_cuda_kernel_takes_the_instantiation_of_its_depth(cuda, S, C,
                                                          variant):
    """A patch of up to 112 values (the main path's 6 x 6 x 3 = 108) runs
    with every filter fragment in registers; a deeper one (6 x 6 x 4 =
    144) streams its further k-steps from the plan. Each is counted in
    its own FEATURIZE_VARIANTS entry and matches the plain version."""
    imgs, filters, means = (torch.as_tensor(a, device=cuda)
                            for a in _geometry_inputs(5, 130, S, C, seed=C))
    kw = dict(patch_size=S, channels=C, whitener_means=means)
    before = dict(kernels.FEATURIZE_VARIANTS)
    got = kernels.fused_cifar_featurize(imgs, filters, **kw)
    want = kernels.fused_cifar_featurize_plain(imgs, filters, **kw)
    torch.cuda.synchronize()
    after = dict(kernels.FEATURIZE_VARIANTS)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == variant) for k in after}
    _close(got.cpu().numpy(), want.cpu().numpy())


def test_cuda_datum_path_launches_the_kernel(cuda):
    imgs, filters, _ = _inputs(2, 32, seed=6)
    node = FusedConvRectifyPool(filters, 32, 6)
    before = kernels.LAUNCHES["fused_cifar_featurize"]
    one = node.apply(torch.as_tensor(imgs[1], device=cuda))
    assert kernels.LAUNCHES["fused_cifar_featurize"] == before + 1
    want = node.apply(torch.as_tensor(imgs[1]))
    _close(one.cpu().numpy(), want.numpy())


def test_cuda_node_params_are_the_plan_alone(cuda):
    """On the card the node's params hold the bank once, as the kernel's
    plan (the whitener means' bias folded in); it gives the same bits as
    the raw filters, and refuses means beside it."""
    imgs, filters, means = (torch.as_tensor(a, device=cuda)
                            for a in _inputs(3, 200, seed=8))

    class _Whitener:
        pass

    whitener = _Whitener()
    whitener.means = means.cpu().numpy()
    node = FusedConvRectifyPool(filters.cpu().numpy(), 32, 6,
                                whitener=whitener)
    plan, none = node.apply_params(cuda)
    assert isinstance(plan, kernels.FeaturizePlan) and none is None
    got = node.apply_batch(imgs)
    want = kernels.fused_cifar_featurize(imgs, filters, whitener_means=means)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="means"):
        kernels.fused_cifar_featurize(imgs, plan, whitener_means=means)
    with pytest.raises(ValueError, match="plan"):
        kernels.fused_cifar_featurize(imgs.cpu(), plan)


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
                                   (1000, 130, 3), (33, 127, 1),
                                   (65, 129, 16), (31, 255, 17),
                                   (1030, 257, 33)])
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


@pytest.mark.parametrize("n,d,k", [(1024, 8192, 10), (7, 3, 2), (33, 129, 17),
                                   (65, 129, 16), (1000, 255, 16),
                                   (1030, 257, 33)])
def test_cuda_gram_cross_against_float64(cuda, n, d, k):
    """The kernel's 3xTF32 products into a nonzero carry against the
    float64 sums, G and C each: within (8 + sqrt(slabs)) x 2^-24 of the
    largest entry, for the kernel's ceil(n / slab rows) slabs
    (``chip_smoke.GRAM_F64_ULPS``), and at the streamed fit's chunk shape
    no worse than 2x the plain float32 version's error; G exactly
    symmetric and the same bits on a second launch."""
    rng = np.random.RandomState(n + d + k)
    X = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    Y = torch.as_tensor(rng.randn(n, k).astype(np.float32), device=cuda)
    G0 = torch.as_tensor(rng.randn(d, d).astype(np.float32), device=cuda)
    G0 = (G0 + G0.T) * n ** 0.5
    C0 = torch.as_tensor(rng.randn(d, k).astype(np.float32), device=cuda)
    G, C = kernels.gram_cross(X, Y, G0.clone(), C0.clone())
    G2, C2 = kernels.gram_cross(X, Y, G0.clone(), C0.clone())
    want_G, want_C = kernels.gram_cross_plain(X, Y, G0.clone(), C0.clone())
    torch.cuda.synchronize()
    assert torch.equal(G, G2) and torch.equal(C, C2)
    assert torch.equal(G, G.T)
    slabs = -(-n // kernels.gram_slab_rows())
    bar = (8.0 + slabs ** 0.5) * 2.0 ** -24
    Xd = X.double()
    for got, plain, exact in (
            (G, want_G, G0.double() + Xd.T @ Xd),
            (C, want_C, C0.double() + Xd.T @ Y.double())):
        k_err = float((got.double() - exact).abs().max())
        p_err = float((plain.double() - exact).abs().max())
        assert k_err <= bar * float(exact.abs().max()), (k_err, bar)
        if (n, d, k) == (1024, 8192, 10):
            assert k_err <= 2.0 * p_err, (k_err, p_err)


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


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,k", [(64, 8192, 1), (64, 8192, 10),
                                   (64, 8192, 16), (64, 8192, 17),
                                   (300, 1000, 17), (3, 130, 16)])
def test_cuda_quantized_affine_column_variants(cuda, weight_dtype, n, d, k):
    """k = 1, 10 and 16 run one column tile of the nearest even width,
    k = 17 two tiles of 16; one launch a call, through a model's plan as
    from the raw operands, with the same bits."""
    args = _quant_inputs(n, d, k, weight_dtype, cuda, seed=n + k)
    plan = kernels.quant_plan(*args[1:])
    assert plan.kc >= min(k, 16) and plan.kc % 2 == 0
    before = kernels.LAUNCHES["quantized_affine"]
    got = kernels.quantized_affine(args[0], plan)
    assert kernels.LAUNCHES["quantized_affine"] == before + 1
    want = kernels.quantized_affine_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    assert torch.equal(got, kernels.quantized_affine(*args))
    assert torch.equal(got, kernels.quantized_affine(args[0], plan))
    with pytest.raises(ValueError, match="not"):
        kernels.quantized_affine(args[0][:, 1:], plan)
    with pytest.raises(TypeError):
        kernels.quantized_affine(args[0], plan, args[1])


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
        replayed = REPLAYED_LAUNCHES.get("quantized_affine", 0)
        outs = [plane.predict("m", X[i:i + n])
                for i, n in ((0, 1), (1, 5), (6, 16), (22, 9))]
        served = reg.counter("serving.batches_total").value - batches0
        assert served == 4
        # every bucket was captured at admission: each batch replays its
        # bucket's graph, whose capture recorded one launch
        assert kernels.LAUNCHES["quantized_affine"] == before
        assert REPLAYED_LAUNCHES["quantized_affine"] - replayed == served
    # the same quantized model applied directly; on the card its params
    # are the kernel's plan alone
    mapper = LinearMapEstimator(1e-2, weight_dtype="int8").fit(
        X, Y, device=cuda)
    params = mapper.apply_params(cuda)
    assert len(params) == 1 and isinstance(params[0], kernels.QuantPlan)
    direct = mapper.apply_batch(torch.as_tensor(X[:31], device=cuda))
    np.testing.assert_allclose(np.concatenate(outs), direct.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    # the per-item apply is a one-row launch
    before = kernels.LAUNCHES["quantized_affine"]
    one = mapper.apply(torch.as_tensor(X[3], device=cuda))
    assert kernels.LAUNCHES["quantized_affine"] == before + 1
    np.testing.assert_allclose(one.cpu().numpy(), outs[1][2], rtol=1e-5,
                               atol=1e-5)


def _band(rng, m, l, bw):
    band = np.zeros((m, l), np.float32)
    for j in range(m):
        c = min(int(j * l / max(m, 1)), l - 1)
        lo, hi = max(0, c - bw), min(l, c + bw + 1)
        band[j, lo:hi] = rng.randn(hi - lo)
    return band


@pytest.mark.parametrize("m,l,n", [(375, 375, 500), (340, 375, 4000),
                                   (97, 97, 33), (1, 5, 1), (33, 40, 65),
                                   (300, 1, 7), (70, 500, 129)])
def test_cuda_banded_matmul_matches_plain(cuda, m, l, n):
    rng = np.random.RandomState(m + l + n)
    band = _band(rng, m, l, 6)
    X = torch.as_tensor(rng.randn(l, n).astype(np.float32), device=cuda)
    before = kernels.LAUNCHES["banded_matmul"]
    got = kernels.banded_matmul(band, X)
    want = kernels.banded_matmul_plain(band, X)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_matmul"] == before + 1
    assert got.shape == (m, n) and got.is_contiguous()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    # one sequential sum per output: the same inputs give the same bits
    assert torch.equal(got, kernels.banded_matmul(band, X))


def test_cuda_banded_matmul_strided_rows_zero_sizes_and_refusals(cuda):
    rng = np.random.RandomState(21)
    band = _band(rng, 90, 120, 9)
    X = torch.as_tensor(rng.randn(120, 50).astype(np.float32), device=cuda)
    big = torch.zeros((125, 73), device=cuda)
    big[2:122, 5:55] = X
    view = big[2:122, 5:55]          # row stride 73, offset 151 floats
    assert not view.is_contiguous() and view.stride(1) == 1
    got = kernels.banded_matmul(band, view)
    want = kernels.banded_matmul_plain(band, X)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    before = kernels.LAUNCHES["banded_matmul"]
    assert kernels.banded_matmul(band, X[:, :0]).shape == (90, 0)
    assert kernels.banded_matmul(band[:0], X).shape == (0, 50)
    assert kernels.LAUNCHES["banded_matmul"] == before
    # an all-zero band writes zeros
    zero = kernels.banded_matmul(np.zeros((40, 120), np.float32), X)
    assert torch.equal(zero, torch.zeros_like(zero))
    with pytest.raises(ValueError, match="unit column stride"):
        kernels.banded_matmul(band, X.T.contiguous().T)
    with pytest.raises(ValueError, match="unit column stride"):
        kernels.banded_matmul(band, X.double())
    with pytest.raises(ValueError, match="not"):
        kernels.banded_matmul(band, X[:100])


def _sift_pair(h, w, scale, which):
    step, b, lo = sift._scale_params(scale, 4, 6, 5, 0)
    if which == "smooth":
        return sift._smooth_band(h, b), sift._smooth_band(w, b)
    return (sift._sampling_operator_interleaved(h, lo, step, b)[0],
            sift._sampling_operator_interleaved(w, lo, step, b)[0])


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("which", ["smooth", "sample"])
@pytest.mark.parametrize("scale", [0, 4])
@pytest.mark.parametrize("h,w", [(375, 500), (500, 375)])
def test_cuda_banded_two_sided_matches_plain_at_sift_pairs(cuda, h, w,
                                                           scale, which, C):
    left, right = _sift_pair(h, w, scale, which)
    rng = np.random.RandomState(h + scale + C)
    X = torch.as_tensor(rng.rand(C, h, w).astype(np.float32), device=cuda)
    before = kernels.LAUNCHES["banded_matmul"]
    got = kernels.banded_matmul(left, X, right=right)
    want = kernels.banded_matmul_plain(left, X, right=right)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_matmul"] == before + 1
    assert got.shape == (C, left.shape[0], right.shape[0])
    assert got.is_contiguous()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    # one sequential sum per value: the same inputs give the same bits
    assert torch.equal(got, kernels.banded_matmul(left, X, right=right))


@pytest.mark.parametrize("m,l,r,w,C", [(45, 61, 38, 47, 1), (33, 40, 70, 29, 8),
                                       (1, 5, 3, 2, 3), (97, 97, 65, 130, 2)])
def test_cuda_banded_two_sided_ragged_strided_and_zero(cuda, m, l, r, w, C):
    rng = np.random.RandomState(m + r)
    left, right = _band(rng, m, l, 6), _band(rng, r, w, 9)
    X = torch.as_tensor(rng.randn(C, l, w).astype(np.float32), device=cuda)
    big = torch.zeros((C + 1, l + 3, w + 5), device=cuda)
    big[1:, 2:l + 2, 3:w + 3] = X
    view = big[1:, 2:l + 2, 3:w + 3]       # channel and row strides
    assert not view.is_contiguous() and view.stride(-1) == 1
    got = kernels.banded_matmul(left, view, right=right)
    want = kernels.banded_matmul_plain(left, X, right=right)
    two_d = kernels.banded_matmul(left, view[0], right=right)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((two_d - want[0]).abs().max()) <= 1e-5 * scale
    zero = kernels.banded_matmul(np.zeros((m, l), np.float32), X, right=right)
    assert torch.equal(zero, torch.zeros_like(zero))
    with pytest.raises(ValueError, match="not"):
        kernels.banded_matmul(left, X[:, :, 1:], right=right)


def test_cuda_dense_sift_takes_the_banded_kernel(cuda):
    """At a VOC image size: 2 launches a scale, 10 an image, and
    descriptors inside the golden envelope of the einsum form on the
    card."""
    img = torch.as_tensor(np.random.RandomState(2).rand(375, 500)
                          .astype(np.float32), device=cuda)
    before = kernels.LAUNCHES["banded_matmul"]
    got = sift.dense_sift(img)
    assert kernels.LAUNCHES["banded_matmul"] == before + 10
    want = sift.dense_sift_plain(img)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (128, 47213)
    diff = (got - want).abs()
    assert float(diff.max()) <= 2.0 and float(diff.mean()) <= 0.15


def test_cuda_dense_sift_kernel_modes(cuda):
    """``kernel_mode="banded"`` is the kernel (the default on the card),
    ``"einsum"`` the plain form with no kernel launch; the two within
    phase 4d's descriptor bars (max 2, mean 0.15 quantized units, over
    the columns neither zeroes alone; such flips below 1e-4 of the
    columns); ``"banded"`` on a CPU image raises."""
    img = torch.as_tensor(np.random.RandomState(3).rand(375, 500)
                          .astype(np.float32), device=cuda)
    before = kernels.LAUNCHES["banded_matmul"]
    banded = sift.dense_sift(img, kernel_mode="banded")
    assert kernels.LAUNCHES["banded_matmul"] == before + 10
    einsum = sift.dense_sift(img, kernel_mode="einsum")
    assert kernels.LAUNCHES["banded_matmul"] == before + 10
    torch.cuda.synchronize()
    assert torch.equal(banded, sift.dense_sift(img))
    assert torch.equal(einsum, sift.dense_sift_plain(img))
    za, zb = banded.sum(0) == 0, einsum.sum(0) == 0
    diff = (banded - einsum).abs()[:, ~(za ^ zb)]
    assert float(diff.max()) <= 2.0 and float(diff.mean()) <= 0.15
    assert int((za ^ zb).sum()) <= 1e-4 * banded.shape[1]
    with pytest.raises(ValueError, match="needs a CUDA image"):
        sift.dense_sift(img.cpu(), kernel_mode="banded")


def _fv_inputs(D, K, n, device, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(D, n).astype(np.float32)
    means = rng.randn(D, K).astype(np.float32)
    variances = (0.5 + rng.rand(D, K)).astype(np.float32)
    weights = rng.dirichlet(np.ones(K)).astype(np.float32)
    return [torch.as_tensor(a, device=device)
            for a in (X, means, variances, weights)]


@pytest.mark.parametrize("D,K,n", [(80, 256, 1), (80, 256, 33),
                                   (80, 256, 511), (80, 256, 513),
                                   (80, 256, 4097), (80, 257, 1),
                                   (80, 257, 511), (80, 257, 513),
                                   (80, 257, 4097), (64, 16, 513),
                                   (7, 3, 12), (96, 100, 300),
                                   (8, 2000, 100), (300, 256, 100),
                                   (81, 256, 513), (128, 256, 513),
                                   (64, 512, 513)])
def test_cuda_fv_moments_matches_plain(cuda, D, K, n):
    """n = 1 and n off the 16-column tile; K = 257 off the 256 components
    a split accumulates (two component splits), K = 3 and 100 off the
    8-component tile, D = 7 off the 8-row tile, D = 96 past the 160
    accumulated rows (two row splits). [B; A] does not fit beside the
    tiles at (8, 2000), (300, 256), (81, 256), (128, 256) and (64, 512):
    the kernel takes it in chunks of rows."""
    args = _fv_inputs(D, K, n, cuda, seed=D + K + n)
    before = kernels.LAUNCHES["fv_moments"]
    got = kernels.fv_moments(*args, 1e-4)
    want = kernels.fv_moments_plain(*args, 1e-4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fv_moments"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err
    # partials added in block order: the same inputs give the same bits
    again = kernels.fv_moments(*args, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_cuda_fv_moments_strided_and_empty(cuda):
    X, means, variances, weights = _fv_inputs(80, 256, 700, cuda, seed=5)
    big = torch.zeros((80, 760), device=cuda)
    big[:, 30:730] = X
    got = kernels.fv_moments(big[:, 30:730], means, variances, weights, 1e-4)
    want = kernels.fv_moments_plain(X, means, variances, weights, 1e-4)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    before = kernels.LAUNCHES["fv_moments"]
    s0, s1, s2 = kernels.fv_moments(X[:, :0], means, variances, weights,
                                    1e-4)
    assert kernels.LAUNCHES["fv_moments"] == before
    assert float(s0.abs().sum() + s1.abs().sum() + s2.abs().sum()) == 0.0
    with pytest.raises(ValueError, match="unit column stride"):
        kernels.fv_moments(X.T.contiguous().T, means, variances, weights,
                           1e-4)
    # precomputed terms give the same bits as terms made in the call
    terms = kernels.fv_terms(means, variances, weights)
    got = kernels.fv_moments(X, means, variances, weights, 1e-4)
    cached = kernels.fv_moments(X, means, variances, weights, 1e-4,
                                terms=terms)
    assert all(torch.equal(a, b) for a, b in zip(got, cached))


#: (D, K, n, seed): seeds whose posteriors all lie at least 2.8e-4 (in
#: log) from the 1e-4 threshold in float64, so float32 rounding cannot
#: flip one across it (at K = 30000 most seeds put a posterior within
#: 1e-5 of it)
FV_WIDE = [(2, 30000, 1, 30), (8, 4000, 17, 1), (512, 256, 513, 768),
           (600, 300, 17, 900)]


@pytest.mark.parametrize("D,K,n,seed", FV_WIDE)
def test_cuda_fv_moments_matches_plain_past_the_resident_tiles(cuda, D, K, n,
                                                               seed):
    """Where the llh tile does not fit (K = 30000 at D = 2, K = 4000 at
    D = 8) the kernel walks the components in chunks, the column
    statistics in a first launch and the moments in a second;
    where the x' tiles do not fit (D = 512, 600) it stages rows of x'
    straight from X. Both match the plain version, with the same bits on
    a second launch."""
    args = _fv_inputs(D, K, n, cuda, seed=seed)
    before = kernels.LAUNCHES["fv_moments"]
    got = kernels.fv_moments(*args, 1e-4)
    want = kernels.fv_moments_plain(*args, 1e-4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fv_moments"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err
    again = kernels.fv_moments(*args, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D,K,n", [(8, 4000, 5000), (16, 2500, 3000)])
def test_cuda_fv_moments_past_the_llh_tile_over_many_tiles(cuda, D, K, n):
    """Components in chunks over many tiles a block (the column statistics
    of a first launch read back by the second), held against the plain
    version on the descriptors whose float64 posteriors all lie more than
    1e-3 (in log) from the threshold, where float32 rounding cannot flip
    one across it."""
    from keystone_tpu_torch.nodes.learning.gmm import _posteriors

    X, means, variances, weights = _fv_inputs(D, K, n, cuda, seed=D + n)
    q64 = _posteriors(X.T.double(), means.T.double(), variances.T.double(),
                      weights.double(), 0.0)
    clear = ((q64.log() - np.log(1e-4)).abs() > 1e-3).all(dim=1)
    assert int(clear.sum()) >= n // 4
    args = (X[:, clear].contiguous(), means, variances, weights)
    before = kernels.LAUNCHES["fv_moments"]
    got = kernels.fv_moments(*args, 1e-4)
    want = kernels.fv_moments_plain(*args, 1e-4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fv_moments"] == before + 1
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err
    again = kernels.fv_moments(*args, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_cuda_sparse_lbfgs_matches_the_cpu_fit_and_repeats_its_bits(cuda):
    """The sparse solver's row-compressed products on the card (plain
    PyTorch, fixed summation order): the fit agrees with the CPU fit
    within 1e-4 of the largest weight, and a second fit on the card
    gives the same bits."""
    from keystone_tpu_torch.nodes.learning.lbfgs import SparseLBFGSwithL2
    from keystone_tpu_torch.nodes.util.sparse import SparseVector
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset

    rng = np.random.RandomState(0)
    n, d = 512, 300
    items = HostDataset([SparseVector(rng.randint(0, d, 9), rng.randn(9), d)
                         for _ in range(n)])
    Y = rng.randn(n, 3).astype(np.float32)
    est = SparseLBFGSwithL2(lam=0.1, num_iterations=30)
    host = est.fit(items, ArrayDataset.from_numpy(Y, "cpu"))
    card = est.fit(items, ArrayDataset.from_numpy(Y, cuda))
    again = est.fit(items, ArrayDataset.from_numpy(Y, cuda))
    assert card.weights.device.type == "cuda"
    W = host.weights.numpy()
    assert np.abs(card.weights.cpu().numpy() - W).max() <= \
        1e-4 * np.abs(W).max()
    assert torch.equal(card.weights, again.weights)
    assert torch.equal(card.intercept, again.intercept)


def _text_rows(n, d, nnz, seed, binary):
    """Padded COO rows like the text path's (``sparse_batch``): term
    presences (binary) or weighted terms, and 20-class labels."""
    from keystone_tpu_torch.nodes.util.sparse import SparseVector, sparse_batch

    rng = np.random.RandomState(seed)
    items = [SparseVector(rng.choice(d, nnz, replace=False),
                          np.ones(nnz) if binary else rng.rand(nnz) * 3, d)
             for _ in range(n)]
    idx, vals, size = sparse_batch(items)
    return idx, vals, size, rng.randint(0, 20, n)


@pytest.mark.parametrize("binary", [True, False])
def test_cuda_naive_bayes_class_sums_repeat_and_match_the_cpu(cuda, binary):
    """The naive Bayes sums on the card (float64 Xᵀ times a one-hot, row
    sums in a fixed order, no atomics): the same bits on a second
    launch; equal to the CPU path for term presences (integer sums) and
    within 1e-12 of the largest sum for weighted terms."""
    from keystone_tpu_torch.nodes.learning.classifiers import (
        sparse_class_sums,
    )

    idx, vals, d, y = _text_rows(2048, 5000, 60, seed=1, binary=binary)
    card = sparse_class_sums(idx, vals, d, y, 20, cuda)
    again = sparse_class_sums(idx, vals, d, y, 20, cuda)
    host = sparse_class_sums(idx, vals, d, y, 20, "cpu")
    assert card.dtype == torch.float64 and card.device.type == "cuda"
    assert torch.equal(card, again)
    if binary:
        assert torch.equal(card.cpu(), host)
    else:
        err = float((card.cpu() - host).abs().max())
        assert err <= 1e-12 * float(host.abs().max()), err


def test_cuda_sparse_logistic_gradient_repeats_and_matches_the_cpu(cuda):
    """The logistic regression objective on the card (logits A W and
    gradient Aᵀ G through the transposed ``CSRMatrix``, no scatter): the
    same bits on a second evaluation, and the CPU's loss and gradient
    within 1e-5 of the largest."""
    from keystone_tpu_torch.nodes.learning.classifiers import (
        sparse_logistic_objective,
    )
    from keystone_tpu_torch.nodes.util.sparse import CSRMatrix

    idx, vals, d, y = _text_rows(4096, 8000, 80, seed=2, binary=True)
    y = y % 2
    W = np.random.RandomState(3).randn(d, 2).astype(np.float32) * 0.1
    out = {}
    for dev in (cuda, "cpu"):
        A = CSRMatrix.from_padded(idx, vals, d, dev)
        vg = sparse_logistic_objective(A, A.transpose(), y, 2, 1e-3)
        Wd = torch.as_tensor(W, device=dev)
        out[str(dev)] = (vg(Wd), vg(Wd))
    (f1, g1), (f2, g2) = out[str(cuda)]
    assert torch.equal(f1, f2) and torch.equal(g1, g2)
    fh, gh = out["cpu"][0]
    assert abs(float(f1) - float(fh)) <= 1e-5 * abs(float(fh))
    err = float((g1.cpu() - gh).abs().max())
    assert err <= 1e-5 * float(gh.abs().max()), err


def test_cuda_text_classifier_fits_repeat_and_match_the_cpu(cuda):
    """Naive Bayes and logistic regression fitted on the card from host
    SparseVectors: the same bits on a second fit; the CPU fit's NB
    parameters within 1e-6 and LR weights within 1e-4 of the largest,
    the same predictions."""
    from keystone_tpu_torch.nodes.learning import (
        LogisticRegressionEstimator,
        NaiveBayesEstimator,
    )
    from keystone_tpu_torch.nodes.util.sparse import SparseVector
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset

    idx, vals, d, y = _text_rows(1024, 3000, 40, seed=4, binary=True)
    items = HostDataset([SparseVector(i[v != 0], v[v != 0], d)
                         for i, v in zip(idx, vals)])
    for est, labels, tol in (
            (NaiveBayesEstimator(20), y, 1e-6),
            (LogisticRegressionEstimator(2, reg_param=1e-3, num_iters=15,
                                         convergence_tol=0.0), y % 2, 1e-4)):
        fits = [est.fit(items, ArrayDataset.from_numpy(
            labels.astype(np.int32), dev)) for dev in (cuda, cuda, "cpu")]
        card, again, host = fits
        params = ((lambda m: (m.pi, m.theta))
                  if isinstance(est, NaiveBayesEstimator)
                  else (lambda m: (m.weights,)))
        for a, b, h in zip(params(card), params(again), params(host)):
            assert a.device.type == "cuda" and torch.equal(a, b)
            err = float((a.cpu() - h).abs().max())
            assert err <= tol * max(float(h.abs().max()), 1.0), err
        preds = [m.apply_dataset(items).numpy() for m in (card, host)]
        np.testing.assert_array_equal(preds[0].argmax(-1) if preds[0].ndim > 1
                                      else preds[0],
                                      preds[1].argmax(-1) if preds[1].ndim > 1
                                      else preds[1])


# -- ImageNetSiftLcsFV's shapes -------------------------------------------------

def _sift_pair_step1(h, w, scale, which):
    """ImageNetSiftLcsFV's SIFT (step 4, bin 6, 5 scales, scale_step 1):
    the sampling step grows by one a scale."""
    step, b, lo = sift._scale_params(scale, 4, 6, 5, 1)
    if which == "smooth":
        return sift._smooth_band(h, b), sift._smooth_band(w, b)
    return (sift._sampling_operator_interleaved(h, lo, step, b)[0],
            sift._sampling_operator_interleaved(w, lo, step, b)[0])


@pytest.mark.parametrize("which,C", [("smooth", 1), ("sample", 8)])
@pytest.mark.parametrize("scale", [0, 4])
@pytest.mark.parametrize("h,w", [(480, 640), (640, 480)])
def test_cuda_banded_two_sided_at_imagenet_scale_step_1(cuda, h, w, scale,
                                                        which, C):
    """The two-sided contractions of a 480 x 640 (and 640 x 480) image at
    ``scale_step = 1``, whose sampling operators no VOC shape makes,
    against the plain version: 1e-5 of the largest output, the same bits
    twice."""
    left, right = _sift_pair_step1(h, w, scale, which)
    rng = np.random.RandomState(h + 7 * scale + C)
    X = torch.as_tensor(rng.rand(C, h, w).astype(np.float32), device=cuda)
    before = kernels.LAUNCHES["banded_matmul"]
    got = kernels.banded_matmul(left, X, right=right)
    want = kernels.banded_matmul_plain(left, X, right=right)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_matmul"] == before + 1
    assert got.shape == (C, left.shape[0], right.shape[0])
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert torch.equal(got, kernels.banded_matmul(left, X, right=right))


def test_cuda_dense_sift_at_imagenet_scale_step_1(cuda):
    """A 480 x 640 image at scale_step 1: 10 launches, 44,023 descriptors
    inside the golden envelope of the einsum form."""
    img = torch.as_tensor(np.random.RandomState(3).rand(480, 640)
                          .astype(np.float32), device=cuda)
    before = kernels.LAUNCHES["banded_matmul"]
    got = sift.dense_sift(img, 4, 6, 5, 1)
    assert kernels.LAUNCHES["banded_matmul"] == before + 10
    want = sift.dense_sift_plain(img, 4, 6, 5, 1)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (128, 44023)
    diff = (got - want).abs()
    assert float(diff.max()) <= 2.0 and float(diff.mean()) <= 0.15


@pytest.mark.parametrize("D,K,n", [
    (64, 16, 44023), (64, 16, 17024),            # ImageNetSiftLcsFV's two
    (64, 32, 5000), (64, 64, 5000), (64, 200, 1000), (128, 8, 1000),
    (300, 16, 100)])
def test_cuda_fv_moments_at_imagenet_and_small_k_shapes(cuda, D, K, n):
    """(D, K) = (64, 16) at the SIFT branch's 44,023 and the LCS branch's
    17,024 descriptors an image, and other GMMs whose component tiles
    leave warps to share them (the SMALLK instantiation: 1, 2 and 4 warp
    groups), on the descriptors whose float64 posteriors lie clear of the
    threshold (see the many-tiles test): 1e-4 of the largest sum, the
    same bits twice."""
    from keystone_tpu_torch.nodes.learning.gmm import _posteriors

    X, means, variances, weights = _fv_inputs(D, K, n, cuda, seed=D + K + n)
    q64 = _posteriors(X.T.double(), means.T.double(), variances.T.double(),
                      weights.double(), 0.0)
    clear = ((q64.log() - np.log(1e-4)).abs() > 1e-3).all(dim=1)
    assert int(clear.sum()) >= n // 2
    args = (X[:, clear].contiguous(), means, variances, weights)
    terms = kernels.fv_terms(means, variances, weights)
    before = kernels.LAUNCHES["fv_moments"]
    got = kernels.fv_moments(*args, 1e-4, terms=terms)
    want = kernels.fv_moments_plain(*args, 1e-4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fv_moments"] == before + 1
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    again = kernels.fv_moments(*args, 1e-4, terms=terms)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_cuda_weighted_solver_paths_agree(cuda):
    """The weighted block solver on the card at 300 classes: "woodbury"
    against "cholesky" within 2e-3 of the largest weight (the JAX
    package's bar between its two paths), "auto" taking woodbury, and
    the card's woodbury fit against the CPU's within 1e-4."""
    from keystone_tpu_torch.nodes.learning.block_weighted import (
        BlockWeightedLeastSquaresEstimator,
    )

    rng = np.random.RandomState(0)
    n, d, k = 1500, 256, 300
    X = rng.randn(n, d).astype(np.float32)
    y = rng.randint(0, k, n)
    L = -np.ones((n, k), np.float32)
    L[np.arange(n), y] = 1.0
    fits = {}
    for solver in ("cholesky", "woodbury", "auto"):
        est = BlockWeightedLeastSquaresEstimator(128, 2, 1e-2, 0.25,
                                                 solver=solver)
        fits[solver] = est.fit_arrays(X, L, device=cuda)
    assert fits["auto"]._solve_stats["solver"] == "woodbury"
    W = {s: m.weights.cpu().numpy() for s, m in fits.items()}
    scale = np.abs(W["cholesky"]).max()
    assert np.abs(W["woodbury"] - W["cholesky"]).max() <= 2e-3 * scale
    host = BlockWeightedLeastSquaresEstimator(
        128, 2, 1e-2, 0.25, solver="woodbury").fit_arrays(X, L, device="cpu")
    assert np.abs(W["woodbury"] - host.weights.numpy()).max() <= \
        1e-4 * scale


def _nan_case(name, dev):
    """(kernel call, plain call, reach) of one kernel on an input with one
    NaN: an image's first pixel, a Gram row's feature, a served row, a
    pixel inside SIFT's bands, a descriptor. reach is None where the
    kernel's non-finite outputs must be the plain version's, else the
    call giving the banded kernels' live-range reach."""
    rng = np.random.RandomState(15)
    if name == "fused_cifar_featurize":
        imgs, filters, means = (torch.as_tensor(a, device=dev)
                                for a in _inputs(4, 256, seed=15))
        imgs[0, 0, 0, 0] = float("nan")
        return (lambda: kernels.fused_cifar_featurize(
                    imgs, filters, whitener_means=means),
                lambda: kernels.fused_cifar_featurize_plain(
                    imgs, filters, whitener_means=means), None)
    if name == "gram_cross":
        X = torch.as_tensor(rng.randn(256, 300).astype(np.float32),
                            device=dev)
        Y = torch.as_tensor(rng.randn(256, 10).astype(np.float32),
                            device=dev)
        X[7, 11] = float("nan")
        return (lambda: kernels.gram_cross(X, Y),
                lambda: kernels.gram_cross_plain(X, Y), None)
    if name == "quantized_affine":
        X = torch.as_tensor(rng.randn(64, 512).astype(np.float32),
                            device=dev)
        W = torch.as_tensor((rng.randn(512, 10) * 0.01).astype(np.float32),
                            device=dev)
        Wq, scale = _quantize_weights(W, "int8")
        mean, inv, b = (torch.as_tensor(v.astype(np.float32), device=dev)
                        for v in (rng.randn(512), 1 + rng.rand(512),
                                  rng.randn(10)))
        X[3, 100] = float("nan")
        plan = kernels.quant_plan(Wq, scale, mean, inv, b)
        return (lambda: kernels.quantized_affine(X, plan),
                lambda: kernels.quantized_affine_plain(X, Wq, scale, mean,
                                                       inv, b), None)
    if name == "banded_matmul":
        step, bsz, lo = sift._scale_params(0, 4, 6, 5, 0)
        left, right = sift._smooth_band(120, bsz), sift._smooth_band(90, bsz)
        X = torch.as_tensor(rng.rand(2, 120, 90).astype(np.float32),
                            device=dev)
        X[1, 60, 40] = float("nan")
        Xo = X[0].clone()
        Xo[30, 20] = float("inf")
        return (lambda: (kernels.banded_matmul(left, X, right=right),
                         kernels.banded_matmul(left, Xo)),
                lambda: (kernels.banded_matmul_plain(left, X, right=right),
                         kernels.banded_matmul_plain(left, Xo)),
                lambda: (kernels.banded_live_reach(left, X, right=right),
                         kernels.banded_live_reach(left, Xo)))
    D, K, n = 80, 256, 1000
    X = torch.as_tensor(rng.randn(D, n).astype(np.float32), device=dev)
    means = torch.as_tensor(rng.randn(D, K).astype(np.float32), device=dev)
    var = torch.as_tensor((0.5 + rng.rand(D, K)).astype(np.float32),
                          device=dev)
    w = torch.as_tensor(rng.dirichlet(np.ones(K)).astype(np.float32),
                        device=dev)
    X[5, 100] = float("nan")
    return (lambda: kernels.fv_moments(X, means, var, w, 1e-4),
            lambda: kernels.fv_moments_plain(X, means, var, w, 1e-4), None)


@pytest.mark.parametrize("name", ["fused_cifar_featurize", "gram_cross",
                                  "quantized_affine", "banded_matmul",
                                  "fv_moments"])
def test_cuda_kernels_propagate_nan_as_plain(cuda, name):
    """A NaN (or an infinity) in a kernel's input lands where it lands in
    the plain version: the same non-finite outputs, none made finite. The
    banded kernels sum over each tile's live range, as the TPU kernel
    does, so theirs are exactly that range's reach, inside the plain
    version's dense reach."""
    kernel, plain, reach = _nan_case(name, cuda)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    ref = ([~torch.isfinite(w) for w in want] if reach is None
           else list(reach()))
    assert sum(int((~torch.isfinite(g)).sum()) for g in got) > 0
    for g, w, r in zip(got, want, ref):
        assert torch.equal(~torch.isfinite(g), r), name
        assert not bool((~torch.isfinite(g) & torch.isfinite(w)).any()), name


def test_cuda_health_monitor_replays_the_eager_word(cuda, tmp_path,
                                                    monkeypatch):
    """The numerics monitor's CUDA-graph word (from a geometry's second
    chunk on) reads as the eager word of the same chunk: counts equal,
    bounds equal, mean and variance within 1e-6 relative; a ragged tail
    takes the eager word; a NaN in a replayed chunk trips naming it."""
    import threading

    from keystone_tpu_torch.observability import numerics as num

    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR", str(tmp_path))
    rng = np.random.RandomState(11)
    chunks = [torch.as_tensor(rng.randn(64, 300).astype(np.float32) * 3 + 1,
                              device=cuda) for _ in range(5)]
    labels = torch.as_tensor(rng.randint(0, 10, (64, 1)).astype(np.int32),
                             device=cuda)
    monitor = num.HealthMonitor("s", defer=1)
    num.reset_health_series()
    for i, X in enumerate(chunks):
        rows = (40, 64) if i == 4 else (64, 64)
        monitor.observe(i, X, labels, rows=rows)
    monitor.flush()
    series = num.recent_health()
    key = (64 * 300 + 64, str(chunks[0].device), threading.get_ident())
    assert key in num._WORD_GRAPHS and len(series) == 5
    for i, (X, entry) in enumerate(zip(chunks, series)):
        n = 40 if i == 4 else 64
        want = num.word_stats(num.health_word(
            (X[:n], labels[:n])).cpu().numpy())
        for key in ("finite", "nan", "inf", "min", "max", "absmax"):
            assert entry[key] == want[key], (i, key)
        for key in ("mean", "var"):
            assert abs(entry[key] - want[key]) <= 1e-6 * abs(want[key])
    chunks[2][3, 7] = float("nan")
    monitor = num.HealthMonitor("s", defer=1)
    with pytest.raises(num.NumericsError, match="chunk 2 of stream 's'"):
        for i, X in enumerate(chunks[:4]):
            monitor.observe(i, X, labels, rows=(64, 64))
        monitor.flush()


# -- the serving plane's captured buckets ---------------------------------------

def _served_pipeline(cuda, seed=21, K=32):
    """A small served model on the card: the featurize node (K filters)
    then a least-squares mapper over its 8K features."""
    rng = np.random.RandomState(seed)
    imgs, filters, _ = _inputs(64, K, seed=seed)
    node = FusedConvRectifyPool(filters, 32, 6)
    feats = node.apply_batch(torch.as_tensor(imgs, device=cuda))
    Y = rng.randn(64, 10).astype(np.float32)
    mapper = LinearMapEstimator(1e-1).fit(feats.cpu().numpy(), Y,
                                          device=cuda)
    return node.and_then(mapper), imgs


def _plane(cuda, **kw):
    from keystone_tpu_torch.serving import ServingPlane

    kw.setdefault("max_batch", 16)
    return ServingPlane(device=cuda, **kw).start()


_SPEC = ((32, 32, 3), np.float32)


@pytest.mark.parametrize("weight_dtype", [None, "bf16", "int8"])
def test_cuda_graph_replay_equals_the_eager_apply(cuda, weight_dtype):
    """Every bucket is captured at admission, one graph a bucket; a
    replay gives the eager apply's bits on the same padded bucket at
    every request size up to it, and adds its capture's launches once
    per replay."""
    pipe, imgs = _served_pipeline(cuda)
    plane = _plane(cuda)
    try:
        e = plane.admit("m", pipe, _SPEC, weight_dtype=weight_dtype)
        assert e.captures == 5 and len(plane._graphs) == 5
        assert 0 < e.graph_pool_nbytes == e.charge.pool_nbytes
        for n in (16, 11, 8, 3, 1):
            got = plane._execute(e, imgs[:n], n)[0]
            want = plane._eager(e, imgs[:n], n)
            assert torch.equal(torch.from_numpy(got),
                               torch.from_numpy(want)), n
        bg = plane._graphs.get((e.token, 16))
        assert bg.launches["fused_cifar_featurize"] == 1
        assert bg.launches.get("quantized_affine", 0) == (
            0 if weight_dtype is None else 1)
        before = dict(REPLAYED_LAUNCHES)
        plane.predict("m", imgs[:13])
        assert {k: REPLAYED_LAUNCHES[k] - before.get(k, 0)
                for k in bg.launches} == bg.launches
    finally:
        plane.close()


def test_cuda_steady_traffic_captures_nothing(cuda):
    """After admission the steady-state fence is armed; traffic over
    every request size captures nothing, from several client threads."""
    from concurrent.futures import ThreadPoolExecutor

    from keystone_tpu_torch.observability.compilelog import \
        compile_observatory

    pipe, imgs = _served_pipeline(cuda)
    plane = _plane(cuda, workers=2)
    try:
        plane.admit("m", pipe, _SPEC, weight_dtype="int8")
        assert compile_observatory().fenced
        u0 = plane.unexpected_recompiles()
        c0 = compile_observatory().count_total()
        with ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(lambda n: plane.predict("m", imgs[:n]),
                                 [n % 16 + 1 for n in range(64)]))
        assert [len(o) for o in outs] == [n % 16 + 1 for n in range(64)]
        assert plane.unexpected_recompiles() == u0
        assert compile_observatory().count_total() == c0
    finally:
        plane.close()


def test_cuda_forced_bucket_miss_is_counted_once(cuda):
    from keystone_tpu_torch.observability.compilelog import \
        compile_observatory

    pipe, imgs = _served_pipeline(cuda)
    plane = _plane(cuda)
    try:
        e = plane.admit("m", pipe, _SPEC, weight_dtype="bf16")
        want = plane._eager(e, imgs[:5], 5)
        assert plane._graphs.pop_where(
            lambda k: k == (e.token, 8))
        u0 = plane.unexpected_recompiles()
        l0 = kernels.LAUNCHES["fused_cifar_featurize"]
        c0 = kernels.CAPTURED["fused_cifar_featurize"]
        got = plane.predict("m", imgs[:5])
        # the miss's warm apply ran the kernel; its capture only recorded
        # it, and the replay is counted apart
        assert kernels.LAUNCHES["fused_cifar_featurize"] - l0 == 1
        assert kernels.CAPTURED["fused_cifar_featurize"] - c0 == 1
        plane.predict("m", imgs[:6])
        assert plane.unexpected_recompiles() - u0 == 1
        rec = compile_observatory().unexpected_records()[-1]
        assert rec["trigger"] == "bucket_miss"
        assert rec["fence"] == "serving:steady-state"
        assert rec["name"] == "serve:m:8"
        assert np.array_equal(got, want)
    finally:
        plane.close()


def test_cuda_admission_under_live_traffic(cuda):
    """A second model is captured while the first one serves from its
    graphs on other threads: both answer right, nothing unexpected."""
    import threading

    pipe_a, imgs = _served_pipeline(cuda, seed=21)
    pipe_b, _ = _served_pipeline(cuda, seed=22)
    plane = _plane(cuda, workers=2)
    errors, stop = [], threading.Event()
    try:
        ea = plane.admit("a", pipe_a, _SPEC, weight_dtype="int8")
        want = {n: plane._eager(ea, imgs[:n], n) for n in (1, 5, 12)}
        u0 = plane.unexpected_recompiles()

        def client():
            while not stop.is_set():
                for n in (1, 5, 12):
                    if not np.array_equal(plane.predict("a", imgs[:n]),
                                          want[n]):
                        errors.append(n)

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        eb = plane.admit("b", pipe_b, _SPEC, weight_dtype="bf16")
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors and eb.captures == 5
        assert np.array_equal(plane.predict("b", imgs[:7]),
                              plane._eager(eb, imgs[:7], 7))
        assert plane.unexpected_recompiles() == u0
    finally:
        stop.set()
        plane.close()


def test_cuda_eviction_frees_the_graph_pools(cuda):
    from keystone_tpu_torch.serving.residency import graph_pool_nbytes

    pipe, imgs = _served_pipeline(cuda)
    plane = _plane(cuda)
    try:
        e = plane.admit("m", pipe, _SPEC, weight_dtype="int8")
        pools = [plane._graphs.get(k).graph.pool()
                 for k in plane._graphs.keys() if k[0] == e.token]
        held = sum(graph_pool_nbytes(p, cuda) for p in pools)
        assert held == e.graph_pool_nbytes > 0
        plane.predict("m", imgs[:3])
        plane.evict("m")
        # the pools are parked for the next capture of their rows, not
        # freed while the plane serves
        assert len(plane._graphs) == 0 and len(plane._pools) == 5
        assert sum(graph_pool_nbytes(p, cuda) for p in pools) == held
        e = plane.readmit("m")
        assert len(plane._graphs) == 5 and len(plane._pools) == 0
        # the readmission captured into the parked pools, nothing new
        assert sorted(tuple(plane._graphs.get(k).pool())
                      for k in plane._graphs.keys() if k[0] == e.token) \
            == sorted(tuple(p) for p in pools)
        assert sum(graph_pool_nbytes(p, cuda) for p in pools) == held
    finally:
        plane.close()


def test_cuda_readmission_reuses_pools_and_releases_nothing_in_flight(cuda):
    """Evictions and readmissions under traffic on two workers: each
    readmission records into the pools its eviction parked (the same
    pool ids, nothing allocated), gives the same bits, and no pool is
    released while the plane serves; close releases once, with no batch
    in flight."""
    import threading

    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.serving.graphs import release_gate

    reg = MetricsRegistry.get_or_create()
    pipe, imgs = _served_pipeline(cuda, seed=23)
    hot, _ = _served_pipeline(cuda, seed=24)
    plane = _plane(cuda, workers=2)
    errors, stop = [], threading.Event()
    try:
        plane.admit("hot", hot, _SPEC, weight_dtype="bf16")
        e = plane.admit("m", pipe, _SPEC, weight_dtype="int8")
        want = {n: plane.predict("hot", imgs[:n]) for n in (1, 5, 12)}
        before = plane.predict("m", imgs[:7])
        pools = sorted(tuple(plane._graphs.get(k).pool())
                       for k in plane._graphs.keys() if k[0] == e.token)
        gate0 = release_gate().stats()["releases"]
        reuses0 = reg.counter("serving.pool_reuses").value
        allocs0 = reg.counter("serving.pool_allocations").value
        u0 = plane.unexpected_recompiles()

        def client():
            while not stop.is_set():
                for n in (1, 5, 12):
                    if not np.array_equal(plane.predict("hot", imgs[:n]),
                                          want[n]):
                        errors.append(n)

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        for _ in range(3):
            plane.evict("m")
            e = plane.readmit("m")
            again = sorted(tuple(plane._graphs.get(k).pool())
                           for k in plane._graphs.keys()
                           if k[0] == e.token)
            assert again == pools
            assert np.array_equal(plane.predict("m", imgs[:7]), before)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        assert reg.counter("serving.pool_reuses").value - reuses0 == 15
        assert reg.counter("serving.pool_allocations").value == allocs0
        assert release_gate().stats()["releases"] == gate0
        assert plane.unexpected_recompiles() == u0
        assert e.graph_pool_nbytes == e.charge.pool_nbytes > 0
    finally:
        stop.set()
        plane.close()
    stats = release_gate().stats()
    assert stats["releases"] == gate0 + 1 and stats["inflight"] == 0


class _HostRead(Transformer):
    """A stage that reads a device value on the host: not capturable."""

    def apply(self, x):
        return x

    def apply_batch(self, X):
        return X * float(X.abs().max().item() > -1.0)


def test_cuda_a_failed_capture_refuses_the_admission_naming_the_op(cuda):
    from keystone_tpu_torch.serving import CaptureError

    pipe, imgs = _served_pipeline(cuda)
    bad = pipe.and_then(_HostRead())
    plane = _plane(cuda)
    try:
        with pytest.raises(CaptureError, match=r"test_torch_cuda_kernels"
                           r"\.py:\d+ \(apply_batch: .*\.item\(\)"):
            plane.admit("bad", bad, _SPEC)
        state = plane.state()
        assert state["models"] == [] and state["warming"] == 0
        assert plane.ledger.used() == 0 and len(plane._graphs) == 0
        plane.admit("m", pipe, _SPEC)
        assert len(plane.predict("m", imgs[:2])) == 2
    finally:
        plane.close()


def test_cuda_streamed_fit_fence_sees_the_word_capture_once(cuda):
    """The numerics monitor captures its word's graph at a geometry's
    second chunk, before the fit's fence arms: the observatory records
    it once (not unexpected), and a second fit of the geometry replays
    it and captures nothing."""
    from keystone_tpu_torch.observability.compilelog import \
        compile_observatory

    rng = np.random.RandomState(12)
    X = rng.randn(37 * 6, 29).astype(np.float32)   # a geometry of its own
    Y = rng.randn(37 * 6, 3).astype(np.float32)
    obs = compile_observatory()
    words0 = obs.by_name().get("numerics.health_word", 0)
    unexpected0 = obs.unexpected_total()
    for _ in range(2):
        LinearMapEstimator(lam=0.1).fit(
            StreamingDataset.from_numpy(X, 37, device=cuda), Y)
    assert obs.by_name().get("numerics.health_word", 0) - words0 == 1
    assert obs.unexpected_total() == unexpected0
    assert not obs.fenced


# -- HOG, DAISY and the tar stream on the card ---------------------------------
# HOG's histograms are two matrix products (no scatter-add, no atomics) and
# DAISY's maps cuDNN convolutions with TF32 off: the same bits on a second
# launch, and the CPU's float32 result within 1e-5 absolute (features of at
# most 1, other summation orders).

def _image_375x500():
    rng = np.random.RandomState(13)
    return (rng.rand(375, 500, 3) * 255).astype(np.float32)


@pytest.mark.parametrize("node", ["hog", "daisy"])
def test_cuda_hog_and_daisy_are_reproducible_and_match_the_cpu(cuda, node):
    from keystone_tpu_torch.nodes.images import DaisyExtractor, HogExtractor

    ext = HogExtractor() if node == "hog" else DaisyExtractor()
    img = _image_375x500()
    x = torch.as_tensor(img, device=cuda)
    first, second = ext.apply(x), ext.apply(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = ext.apply(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(first.cpu().numpy(), want, rtol=0, atol=1e-5)


def test_cuda_uint8_wire_stream_gives_the_float32_wire_chunks(cuda, tmp_path):
    """A tar of PNGs streamed uint8 over the link and cast on the card
    gives the chunks a float32-wire stream of the same tar gives, bit for
    bit, at a quarter of the staged bytes."""
    import io
    import tarfile

    from PIL import Image

    from keystone_tpu_torch.loaders.image_loader_utils import (
        stream_tar_images,
    )

    rng = np.random.RandomState(14)
    path = str(tmp_path / "imgs.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(10):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (16, 12, 3)).astype(
                np.uint8)).save(buf, format="PNG")
            info = tarfile.TarInfo(f"img{i:02d}.png")
            info.size = len(buf.getvalue())
            tf.addfile(info, io.BytesIO(buf.getvalue()))
    narrow = stream_tar_images([path], 4, device=cuda)
    wide = stream_tar_images([path], 4, decode_dtype=np.float32, device=cuda)
    got = [(c.n, c.data.clone()) for c in narrow.chunks()]
    want = [(c.n, c.data.clone()) for c in wide.chunks()]
    assert [n for n, _ in got] == [n for n, _ in want] == [4, 4, 2]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.is_cuda
        assert torch.equal(g, w)
    assert narrow.chunk_nbytes() * 4 == wide.chunk_nbytes()


def test_cuda_each_wrapper_counts_its_launchs_work(cuda):
    """Each wrapper adds the FLOPs and bytes of its launch, from the
    launch's shapes (``ops/work.py``), to ``kernels.WORK``: the per-node
    MFU of a traced run reads them."""
    from keystone_tpu_torch.ops import work

    def delta(name, fn):
        before = dict(kernels.WORK[name])
        fn()
        torch.cuda.synchronize()
        return (kernels.WORK[name]["flops"] - before["flops"],
                kernels.WORK[name]["bytes"] - before["bytes"])

    imgs, filters, means = (torch.as_tensor(a, device=cuda)
                            for a in _inputs(3, 100, seed=5))
    product, rest, nbytes = work.featurize_work(3, 100)
    assert delta("fused_cifar_featurize", lambda: kernels.fused_cifar_featurize(
        imgs, filters, whitener_means=means)) == (product + rest, nbytes)
    X = torch.randn(96, 40, device=cuda)
    Y = torch.randn(96, 3, device=cuda)
    assert delta("gram_cross", lambda: kernels.gram_cross(X, Y)) == \
        work.gram_work(96, 40, 3)
    g = torch.Generator().manual_seed(0)
    D, K, n = 8, 5, 33
    Xd = torch.randn(D, n, generator=g).to(cuda)
    m = torch.randn(D, K, generator=g).to(cuda)
    v = (torch.rand(D, K, generator=g) + 0.5).to(cuda)
    w = torch.full((K,), 1.0 / K, device=cuda)
    assert delta("fv_moments", lambda: kernels.fv_moments(
        Xd, m, v, w, 1e-4)) == work.fv_work(D, K, n)


def test_cuda_check_xla_runs_on_the_card(cuda):
    """``check --xla`` on the card: each per-item node of the CIFAR app
    runs once on a zero item, the plan's charge equals the bytes it
    outputs, the allocation peak is measured, and the featurize node
    launches its kernel."""
    from keystone_tpu_torch import pipelines
    from keystone_tpu_torch.analysis.resources import device_verify_plan

    target = pipelines.CHECK_APPS["cifar.random_patch"]()
    report = target.pipeline.check(target.input_spec, name=target.name)
    before = kernels.LAUNCHES["fused_cifar_featurize"]
    rows = device_verify_plan(report.analysis, report.plan, cuda)
    ok = [r for r in rows if r["status"] == "ok"]
    assert ok and all(r["plan_vs_device"] == 1.0 for r in ok)
    # a pass-through (a Cache) allocates nothing; the featurize node
    # allocates at least its output
    assert all(r["device_peak_bytes"] >= 0 for r in ok)
    fz = [r for r in ok if r["operator"] == "FusedConvRectifyPool"]
    assert fz and all(r["device_peak_bytes"] >= r["device_output_bytes"]
                      for r in fz)
    assert kernels.LAUNCHES["fused_cifar_featurize"] > before


def test_cuda_gates_pass_on_the_card(cuda):
    """The recompile, numerics and serving gates on the card, each as a
    subprocess under its own time limit: every bucket captured at
    admission and nothing after it, the tripwire both ways."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    for gate in ("recompile_gate", "numerics_gate", "serving_gate"):
        proc = subprocess.run(
            [sys.executable, "-m", f"keystone_tpu_torch.tools.{gate}",
             "--device", "cuda"], cwd=repo, capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, (gate, proc.stdout[-3000:],
                                      proc.stderr[-3000:])
        assert "PASS" in proc.stdout


def test_cuda_nccl_world_of_one_matches_no_world(cuda, tmp_path):
    """An NCCL world of one rank on the card: ``merge_carries``, the
    rank-sharded ``gram`` (the Gram kernel, then the gather) and
    ``sharded_apply`` of a float32 and an int8 block mapper give the same
    bits as the same calls without a world, and the kernels launch."""
    from keystone_tpu_torch.ops import linalg
    from keystone_tpu_torch.parallel.distributed import WorldCoordinator
    from keystone_tpu_torch.parallel.mesh import (
        initialize_distributed,
        shutdown_distributed,
        world_data_mesh,
    )
    from keystone_tpu_torch.parallel.spmd_apply import sharded_apply

    gen = torch.Generator(device="cpu").manual_seed(7)
    X = torch.randn(300, 256, generator=gen).to(cuda)
    W = torch.randn(256, 10, generator=gen)
    f32 = BlockLinearMapper([W[:128], W[128:]], 128,
                            intercept=torch.randn(10, generator=gen),
                            feature_means=torch.randn(256, generator=gen))
    q8 = BlockLinearMapper([W[:128], W[128:]], 128,
                           intercept=f32.intercept,
                           feature_means=f32.feature_means,
                           weight_dtype="int8")
    carry = (X.T @ X, X.sum(dim=0), 300)
    solo = (sharded_apply(f32, X), sharded_apply(q8, X),
            kernels.gram_cross(X, X[:, :0])[0])
    before = dict(kernels.LAUNCHES)
    w = initialize_distributed("file://" + str(tmp_path / "store"), 1, 0,
                               device="cuda", quiet=True)
    try:
        assert w.backend == "nccl"
        mesh = world_data_mesh()
        merged = WorldCoordinator("t").merge_carries(carry)
        got = (sharded_apply(f32, X, mesh), sharded_apply(q8, X, mesh),
               linalg.gram(X, mesh))
        torch.cuda.synchronize()
    finally:
        shutdown_distributed()
    assert torch.equal(merged[0], carry[0]) and merged[2] == 300
    for a, b in zip(got, solo):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["gram_cross"] == before["gram_cross"] + 1
    assert kernels.LAUNCHES["quantized_affine"] == \
        before["quantized_affine"] + 1


def test_cuda_gloo_world_gathers_card_tensors_through_pinned_memory(
        cuda, tmp_path):
    """Two ranks sharing the card meet over gloo (the backend rule), and
    the rank-sharded Gram of their card rows equals the whole's."""
    import sys

    from keystone_tpu_torch.parallel.distributed import DryrunWorld

    src = tmp_path / "in.npz"
    dst = tmp_path / "out.npz"
    X = np.random.RandomState(0).randn(64, 12).astype(np.float32)
    np.savez(src, X=X, Y=X[:, :3].copy())
    worker = str(tmp_path / "w.py")
    with open(worker, "w") as f:
        f.write(
            "import sys\n"
            "import numpy as np, torch\n"
            "from keystone_tpu_torch.ops import linalg\n"
            "from keystone_tpu_torch.parallel.mesh import *\n"
            "src, dst, pid, n, store = sys.argv[1:]\n"
            "w = initialize_distributed(store, int(n), int(pid),\n"
            "                           device='cuda', quiet=True)\n"
            "assert w.backend == 'gloo', w.rule\n"
            "X = np.load(src)['X']\n"
            "lo, hi = batch_rows(X.shape[0], world_data_mesh())\n"
            "G = linalg.gram(torch.as_tensor(X[lo:hi], device='cuda'),\n"
            "                world_data_mesh())\n"
            "if process_index() == 0:\n"
            "    np.save(dst, G.cpu().numpy())\n"
            "shutdown_distributed()\n")
    world = DryrunWorld(2, workdir=str(tmp_path / "w"), grace_s=30)
    codes = world.launch([sys.executable, worker, str(src),
                          str(dst)]).wait(timeout_s=300)
    assert codes == [0, 0], [world.output(p)[-2000:] for p in range(2)]
    G = np.load(str(dst) + ".npy")
    want = X.T.astype(np.float64) @ X
    assert np.abs(G - want).max() <= 1e-5 * np.abs(want).max()
