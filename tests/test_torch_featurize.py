"""``fused_cifar_featurize`` and ``FusedConvRectifyPool`` against
``keystone_tpu``.

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
it is held against the JAX package's Pallas kernel in interpret mode
(how ``tests/test_pallas_kernels.py`` runs it off-TPU) and against the
JAX composed ops (filter_bank_convolve -> rectify -> pool_image). Both
sides compute in float32 in a different summation order; pooled
features reach ~1e4, so the bar is rtol 1e-5 with atol 1e-5 of the
largest feature (the JAX package's own kernel-vs-composed bar is
rtol = atol = 2e-3).

The CUDA kernel itself is held against its plain version on the card
by ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images.core import (
    FusedConvRectifyPool as JFused,
)
from keystone_tpu.ops.image_ops import filter_bank_convolve, pool_image
from keystone_tpu.ops.pallas_kernels import fused_cifar_featurize as jfused
from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.parallel.dataset import ArrayDataset

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


def _composed_reference(imgs, filters, means, alpha=0.25):
    out = []
    for img in imgs:
        conv = filter_bank_convolve(
            jnp.asarray(img), jnp.asarray(filters), 6, 3, True,
            None if means is None else jnp.asarray(means))
        pos = jnp.maximum(0.0, conv - alpha)
        neg = jnp.maximum(0.0, -conv - alpha)
        out.append(np.asarray(pool_image(
            jnp.concatenate([pos, neg], -1), 13, 14, "identity",
            "sum")).reshape(-1))
    return np.stack(out)


@pytest.mark.parametrize("K", [8, 100])
@pytest.mark.parametrize("with_means", [False, True])
def test_plain_matches_pallas_interpret(K, with_means):
    imgs, filters, means = _inputs(2, K, seed=K)
    means = means if with_means else None
    want = np.asarray(jfused(
        jnp.asarray(imgs), jnp.asarray(filters),
        whitener_means=None if means is None else jnp.asarray(means),
        interpret=True))
    got = kernels.fused_cifar_featurize(
        torch.as_tensor(imgs), torch.as_tensor(filters),
        whitener_means=None if means is None else torch.as_tensor(means))
    assert got.shape == want.shape == (2, 4 * 2 * K)
    _close(got.numpy(), want)


@pytest.mark.parametrize("K", [8, 100])
@pytest.mark.parametrize("with_means", [False, True])
def test_plain_matches_composed_ops(K, with_means):
    imgs, filters, means = _inputs(2, K, seed=10 + K)
    means = means if with_means else None
    want = _composed_reference(imgs, filters, means)
    got = kernels.fused_cifar_featurize_plain(
        torch.as_tensor(imgs), torch.as_tensor(filters),
        whitener_means=None if means is None else torch.as_tensor(means))
    _close(got.numpy(), want)


def test_feature_layout_is_region_major_pos_then_neg():
    """Region r's block holds K pos values then K neg values; regions run
    x-major over the (0-13, 13-26) row and column ranges."""
    imgs, filters, _ = _inputs(1, 3, seed=3)
    t_imgs, t_filt = torch.as_tensor(imgs), torch.as_tensor(filters)
    out = kernels.fused_cifar_featurize_plain(t_imgs, t_filt)[0]
    from keystone_tpu_torch.ops.image_ops import filter_bank_convolve as tconv

    conv = tconv(t_imgs[0], t_filt, 6, 3, True)
    pos = torch.clamp_min(conv - 0.25, 0.0)
    neg = torch.clamp_min(-conv - 0.25, 0.0)
    regions = [(0, 14), (13, 27)]
    r = 0
    for x0, x1 in regions:
        for y0, y1 in regions:
            blk = out[r * 6:(r + 1) * 6]
            torch.testing.assert_close(blk[:3], pos[x0:x1, y0:y1].sum((0, 1)),
                                       rtol=1e-5, atol=1e-2)
            torch.testing.assert_close(blk[3:], neg[x0:x1, y0:y1].sum((0, 1)),
                                       rtol=1e-5, atol=1e-2)
            r += 1


def test_cpu_tensor_takes_plain_version_without_launching():
    imgs, filters, means = _inputs(2, 8, seed=4)
    before = dict(kernels.LAUNCHES)
    a = kernels.fused_cifar_featurize(torch.as_tensor(imgs),
                                      torch.as_tensor(filters),
                                      whitener_means=torch.as_tensor(means))
    b = kernels.fused_cifar_featurize_plain(
        torch.as_tensor(imgs), torch.as_tensor(filters),
        whitener_means=torch.as_tensor(means))
    assert torch.equal(a, b)
    assert kernels.LAUNCHES == before


def test_node_params_on_the_cpu_are_the_filters_and_means():
    """Off the card no launch plan is made: the node's params are its
    filters and whitener means, and a plan is refused for CPU images (it
    is made only for a CUDA device, where it takes the filters' place)."""
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener

    imgs, filters, means = _inputs(2, 8, seed=5)
    node = FusedConvRectifyPool(filters, 32, 6,
                                whitener=ZCAWhitener(np.eye(108), means))
    f, m = node.apply_params(torch.device("cpu"))
    assert kernels.featurize_plan(f, m) is None
    np.testing.assert_array_equal(f.numpy(), filters)
    np.testing.assert_array_equal(m.numpy(), means)
    plan = kernels.FeaturizePlan(f.T.contiguous(), torch.zeros(8), 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_cifar_featurize(torch.as_tensor(imgs), plan)
    with pytest.raises(ValueError, match="means"):
        kernels.fused_cifar_featurize(torch.as_tensor(imgs), plan,
                                      whitener_means=m)


def test_other_devices_raise(monkeypatch):
    imgs = torch.empty((1, 32, 32, 3), device="meta")
    filters = torch.empty((4, 108), device="meta")
    # a meta tensor (the static analyzer's shapes) takes the plain
    # version's shape logic and never a launch
    out = kernels.fused_cifar_featurize(imgs, filters)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 4 * 2 * 4)
    # a device that is neither a plain device nor CUDA raises
    monkeypatch.setattr(kernels, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_cifar_featurize(imgs, filters)


def test_sources_and_build_paths_are_in_the_package():
    for src in kernels.SOURCES.values():
        assert (kernels.CSRC_DIR / src).is_file()
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "keystone_tpu_torch")
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


@pytest.mark.parametrize("with_means", [False, True])
def test_node_batch_and_datum_paths_match_reference(mesh8, with_means):
    from keystone_tpu.nodes.learning.zca import ZCAWhitener as JZCA
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener

    imgs, filters, means = _inputs(5, 16, seed=5)
    eye = np.eye(108, dtype=np.float32)
    jw = JZCA(eye, means) if with_means else None
    tw = ZCAWhitener(eye, means) if with_means else None
    jnode = JFused(filters, 32, 6, 3, 13, 14, 0.25, whitener=jw)
    tnode = FusedConvRectifyPool(filters, 32, 6, 3, 13, 14, 0.25, whitener=tw)
    want = jnode.apply_dataset(JArrayDataset.from_numpy(imgs)).numpy()
    got = tnode.apply_dataset(ArrayDataset.from_numpy(imgs, "cpu")).numpy()
    _close(got, want)
    for i in (0, 4):
        want_one = np.asarray(jnode.apply(jnp.asarray(imgs[i])))
        _close(tnode.apply(torch.as_tensor(imgs[i])).numpy(), want_one)


@pytest.mark.parametrize("S,C,stride,size,R", [
    (6, 3, 7, 8, 16), (9, 1, 13, 14, 4), (6, 3, 9, 10, 9), (6, 4, 13, 14, 4)])
def test_plain_matches_reference_at_other_geometries(mesh8, S, C, stride,
                                                     size, R):
    """The geometries the card kernel takes since it dropped its region,
    patch-size and channel limits (``--poolStride 7 --poolSize 8``: 16
    regions; patch size 9 on one channel; four channels), through the
    plain version and the node, against the JAX node's composed path
    (off-TPU); the same bar as above."""
    from keystone_tpu.nodes.learning.zca import ZCAWhitener as JZCA
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener

    rng = np.random.RandomState(S * 10 + R)
    F = S * S * C
    imgs = (rng.rand(3, 32, 32, C) * 255).astype(np.float32)
    filters = rng.randn(12, F).astype(np.float32)
    means = rng.randn(F).astype(np.float32)
    eye = np.eye(F, dtype=np.float32)
    jnode = JFused(filters, 32, S, C, stride, size, 0.25,
                   whitener=JZCA(eye, means))
    want = jnode.apply_dataset(JArrayDataset.from_numpy(imgs)).numpy()
    assert want.shape == (3, R * 2 * 12)
    got = kernels.fused_cifar_featurize_plain(
        torch.as_tensor(imgs), torch.as_tensor(filters), 32, S, C, stride,
        size, whitener_means=torch.as_tensor(means))
    _close(got.numpy(), want)
    tnode = FusedConvRectifyPool(filters, 32, S, C, stride, size, 0.25,
                                 whitener=ZCAWhitener(eye, means))
    _close(tnode.apply_dataset(ArrayDataset.from_numpy(imgs, "cpu")).numpy(),
           want)


@pytest.mark.parametrize("stride,size", [(13, 14), (7, 8), (9, 10), (4, 8),
                                         (1, 2), (30, 2)])
@pytest.mark.parametrize("cut", [32, 64])
def test_run_ends_sum_every_region_membership_once(stride, size, cut):
    """The card kernel stages the patches in the order of
    ``kernels.featurize_columns`` (``cut`` patches a chunk) and pools
    along it: a run of columns summed until a class end, then added to
    the class's regions. That must give the plain pooling's
    region-membership counts: every patch staged once, each class one run
    of columns, the end bits marking exactly the class ends."""
    from keystone_tpu_torch.ops.image_ops import pool_regions

    OH = OW = 27
    P = OH * OW
    row, C = 32 * 3, 3
    table = kernels.featurize_columns(OH, OW, stride, size, row, C, cut)
    Pp = -(-P // cut) * cut
    assert table.shape == (Pp, 4) and table.dtype == np.int32
    offs = table[:P, 0]
    patches = (offs // row) * OW + (offs % row) // C
    assert sorted(patches.tolist()) == list(range(P))
    assert (offs == (patches // OW) * row + (patches % OW) * C).all()
    assert (table[P:, 0] == -1).all() and (table[P:, 1] == -1).all()
    ends = table[:, 1] >= 0
    words = table[:, 3].view(np.uint32)
    for g in range(0, Pp, 32):
        assert words[g] == sum(int(ends[g + i]) << i for i in range(32))
    assert (words[np.arange(Pp) % 32 != 0] == 0).all()
    ranges = pool_regions(OH, stride, size)
    nr = len(ranges)
    want = np.zeros((nr, nr, P), np.int64)
    for rx, (x0, x1) in enumerate(ranges):
        for ry, (y0, y1) in enumerate(ranges):
            for py in range(x0, x1):
                want[rx, ry, py * OW + y0:py * OW + y1] = 1
    got = np.zeros_like(want)
    start = 0
    seen = set()
    for j in range(P):
        rows, cols = table[j, 1], table[j, 2]
        if rows < 0:
            continue
        assert (rows, cols) not in seen         # each class one run
        seen.add((rows, cols))
        run = patches[start:j + 1]
        for rx in range(rows & 0xffff, (rows & 0xffff) + (rows >> 16)):
            for ry in range(cols & 0xffff, (cols & 0xffff) + (cols >> 16)):
                got[rx, ry, run] += 1
        start = j + 1
    assert start == P
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S,C,stride,size", [
    (6, 3, 13, 14), (6, 3, 7, 8), (5, 3, 4, 8), (9, 1, 13, 14)])
def test_column_table_pools_like_the_plain_version(S, C, stride, size):
    """The kernel's pooling in its own order on rectified values: per
    staged column, sums carried along the class's run and added to its
    regions at the class end (the end bits), then written region-major,
    K pos then K neg. It gives the plain version's pooled features."""
    rng = np.random.RandomState(S * 100 + stride)
    H = 32
    OH = H - S + 1
    P = OH * OH
    K = 5
    conv = rng.randn(P, K).astype(np.float64) * 3
    rect = np.concatenate([np.maximum(conv - 0.25, 0),
                           np.maximum(-conv - 0.25, 0)], axis=1)
    want = kernels.pool_image(torch.as_tensor(rect.reshape(OH, OH, 2 * K)),
                              stride, size, "identity", "sum")
    want = want.reshape(-1, 2 * K).numpy()
    table = kernels.featurize_columns(OH, OH, stride, size, H * C, C)
    nry = len(kernels.pool_regions(OH, stride, size))
    got = np.zeros((nry * nry, 2 * K))
    run = np.zeros(2 * K)
    for g in range(0, table.shape[0], 32):
        mask = int(table[g, 3].view(np.uint32))
        for j in range(g, g + 32):
            off = table[j, 0]
            if off >= 0:
                p = (off // (H * C)) * OH + (off % (H * C)) // C
                run += rect[p]
            if mask >> (j - g) & 1:
                rows, cols = table[j, 1], table[j, 2]
                for rx in range(rows & 0xffff,
                                (rows & 0xffff) + (rows >> 16)):
                    for ry in range(cols & 0xffff,
                                    (cols & 0xffff) + (cols >> 16)):
                        got[rx * nry + ry] += run
                run = np.zeros(2 * K)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("K,F", [(1024, 108), (100, 108), (200, 144),
                                 (1, 75)])
def test_filter_split_and_fragment_layout(K, F):
    """The plan's filter split, made once per model in torch: big has its
    13 low mantissa bits clear, small too, and big + small gives the
    filters within 2^-21 of each; laid out as the consumer threads hold
    their wgmma A fragments (``csrc/fused_featurize.cu``'s note), zero past
    K and past F."""
    rng = np.random.RandomState(K + F)
    filters = torch.as_tensor(rng.randn(K, F).astype(np.float32))
    big, small = kernels.split_tf32(filters)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1fff).abs().sum()) == 0
    err = (big.double() + small.double() - filters.double()).abs()
    assert bool((err <= filters.double().abs() * 2.0 ** -21).all())

    frags = kernels.featurize_fragments(filters)
    ks = kernels.featurize_ksteps(F)
    T = -(-K // 128)
    assert ks == max(14, -(-F // 8))
    assert frags.shape == (T, 2, ks, 4, 32, 8)
    assert frags.dtype == torch.float32 and frags.is_contiguous()
    want = np.zeros((T * 128, 8 * ks, 2), np.float32)
    want[:K, :F, 0] = big.numpy()
    want[:K, :F, 1] = small.numpy()
    got = frags.numpy()
    for tile in range(T):
        for wg in range(2):
            for k in range(ks):
                for warp in range(4):
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        f = tile * 128 + 64 * wg + 16 * warp + g
                        d = 8 * k + t
                        frag = [(f, d), (f + 8, d), (f, d + 4),
                                (f + 8, d + 4)]
                        np.testing.assert_array_equal(
                            got[tile, wg, k, warp, lane],
                            [want[ff, dd, 0] for ff, dd in frag]
                            + [want[ff, dd, 1] for ff, dd in frag])
