"""Dense SIFT and the banded product: the port against ``keystone_tpu``.

The same seeded images go through the JAX package's ``dense_sift`` (its
einsum form, and its banded form with the Pallas kernel in interpret
mode) and the port's (the einsum form on the CPU, and its banded form,
whose band products take the plain version on the CPU). Descriptors are
quantized to [0, 255]; the bar is the golden envelope of the JAX
package's SIFT tests (max |delta| <= 2, mean <= 0.15 quantized units)
and atol 5e-3, float32 summation order being the only difference. The
banded product's plain version is held to the Pallas kernel's bar in
the JAX package's tests, rtol = atol = 2e-4, one-sided and two-sided
(the Pallas kernel applied twice).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops import sift as jsift
from keystone_tpu.ops.pallas_kernels import banded_matmul as jbanded
from keystone_tpu_torch.nodes.images.extractors import (
    BatchSIFTExtractor,
    SIFTExtractor,
)
from keystone_tpu_torch.ops import kernels, sift

RES = os.path.join(os.path.dirname(__file__), "resources")
KW = dict(step=4, bin_size=4, num_scales=2, scale_step=1)


def _tile_rows():
    """The banded kernels' live-map tile height, read from their CUDA
    source (the library that reports it is built only on a card)."""
    src = os.path.join(os.path.dirname(kernels.__file__), os.pardir, "csrc",
                       "banded_matmul.cu")
    with open(src) as f:
        return int(re.search(r"constexpr int TM = (\d+);", f.read()).group(1))


def _envelope(got, want):
    assert got.shape == want.shape and got.shape[1] > 0
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 and diff.mean() <= 0.15, (diff.max(),
                                                       diff.mean())
    np.testing.assert_allclose(got, want, atol=5e-3)


@pytest.mark.parametrize("mode", ["einsum", "banded_interpret"])
@pytest.mark.parametrize("h,w", [(96, 128), (90, 110), (140, 150)])
def test_dense_sift_matches_jax(h, w, mode):
    img = np.random.RandomState(h + w).rand(h, w).astype(np.float32)
    want = np.asarray(jsift.dense_sift(jnp.asarray(img), kernel_mode=mode,
                                       **KW))
    got = sift.dense_sift(torch.as_tensor(img), **KW).numpy()
    _envelope(got, want)


@pytest.mark.parametrize("h,w", [(96, 128), (140, 150), (61, 47)])
def test_banded_form_matches_einsum_form(h, w):
    """The CUDA path's banded form (keypoint-major sampling rows, the
    transposed second smoothing, the final reshape) on the CPU, with the
    band products' plain version: the same descriptors as the einsum form.
    A row-order slip would keep the shape and fail the values."""
    img = torch.as_tensor(np.random.RandomState(3).rand(h, w)
                          .astype(np.float32))
    args = (KW["step"], KW["bin_size"], KW["num_scales"], KW["scale_step"])
    banded = sift._dense_sift(img, *args, sift._dsift_one_scale_banded)
    einsum = sift.dense_sift_plain(img, *args)
    _envelope(banded.numpy(), einsum.numpy())


def _random_band(rng, m, l, bw):
    band = np.zeros((m, l), np.float32)
    for j in range(m):
        lo = max(0, min(j, l - 1) - bw)
        hi = min(l, min(j, l - 1) + bw + 1)
        band[j, lo:hi] = rng.randn(hi - lo)
    return band


@pytest.mark.parametrize("m,l,n,bw", [
    (128, 128, 64, 9),
    (300, 300, 70, 21),
    (97, 97, 33, 5),
    (256, 512, 130, 41),
])
def test_banded_matmul_plain_matches_pallas_interpret(m, l, n, bw):
    rng = np.random.RandomState(0)
    band = _random_band(rng, m, l, bw)
    X = rng.randn(l, n).astype(np.float32)
    want = np.asarray(jbanded(band, jnp.asarray(X), interpret=True))
    before = dict(kernels.LAUNCHES)
    got = kernels.banded_matmul(band, torch.as_tensor(X)).numpy()
    assert kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_live_map_covers_every_nonzero_once():
    """The kernel's live map, on the band of the JAX package's tile-map
    test: every nonzero of a 32-row tile lies in the tile's column range,
    the range is contiguous (no column visited twice), and an all-zero
    tile gets the empty range."""
    band = np.zeros((512, 640), np.float32)
    for j in range(512):
        c = min(int(j * 1.2), 639)
        band[j, max(0, c - 30):c + 31] = 1.0
    band[250:260, :] = 0.0
    band[448:480, :] = 0.0  # one whole 32-row tile
    tr = _tile_rows()
    klo, khi = kernels.band_live_map(band, tr)
    assert len(klo) == len(khi) == 512 // tr
    for i in range(len(klo)):
        rows = band[i * tr:(i + 1) * tr]
        cols = np.nonzero(rows.any(axis=0))[0]
        assert 0 <= klo[i] <= khi[i] <= band.shape[1]
        if len(cols) == 0:
            assert klo[i] == khi[i] == 0
            continue
        assert klo[i] == cols[0] and khi[i] == cols[-1] + 1
        visited = np.arange(klo[i], khi[i])
        assert len(np.unique(visited)) == len(visited)


def test_live_map_is_narrow_at_voc_size():
    """At a VOC image's sizes the 32-row live ranges of the sampling
    operators are a fraction of the row length (the point of a map finer
    than the TPU's 128-column tiles)."""
    for length in (375, 500):
        for scale in (0, 4):
            step, b, lo = sift._scale_params(scale, 4, 6, 5, 0)
            T, _ = sift._sampling_operator_interleaved(length, lo, step, b)
            klo, khi = kernels.band_live_map(T, 32)
            assert (khi - klo).max() <= 128, (length, scale, khi - klo)


def test_dense_sift_descriptor_golden_gantrycrane():
    """The golden of tests/test_golden_fixtures.py (an independent
    NumPy/SciPy implementation of the same recipe) on the real
    gantrycrane.png, in quantized units, borderline contrast columns
    excluded as there."""
    from PIL import Image

    g = np.load(os.path.join(RES, "sift_golden_gantrycrane.npz"))
    want = g["descriptors"].astype(np.float32)
    prenorm = g["prenorm"]
    step, bin_size, num_scales, scale_step = (int(v) for v in g["config"])
    rgb = np.asarray(Image.open(os.path.join(RES, "images/gantrycrane.png"))
                     .convert("RGB"), np.float32) / 255.0
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    got = sift.dense_sift(torch.as_tensor(gray), step=step,
                          bin_size=bin_size, num_scales=num_scales,
                          scale_step=scale_step).numpy()
    assert got.shape == want.shape
    solid = np.abs(prenorm - sift.CONTRAST_THRESHOLD) > 1e-4
    assert solid.sum() > 3000
    diff = np.abs(got[:, solid] - want[:, solid])
    assert diff.max() <= 2.0, diff.max()
    assert diff.mean() <= 0.15, diff.mean()
    zero_want = want[:, solid].sum(0) == 0
    zero_got = got[:, solid].sum(0) == 0
    assert zero_want.sum() > 100
    assert np.array_equal(zero_want, zero_got)


@pytest.mark.parametrize("h,w", [(375, 500), (500, 375), (333, 500)])
def test_descriptor_count_matches_jax(h, w):
    assert sift.sift_descriptor_count(h, w) == jsift.sift_descriptor_count(
        h, w)
    if (h, w) == (375, 500):
        assert sift.sift_descriptor_count(h, w) == 47213


def test_extractors_match_dense_sift():
    img = np.random.RandomState(5).rand(64, 72, 1).astype(np.float32)
    t = torch.as_tensor(img)
    ext = SIFTExtractor(step=8, num_scales=2)
    want = sift.dense_sift(t[..., 0], 8, 6, 2, 0)
    assert torch.equal(ext.apply(t), want)
    assert ext.descriptor_count(64, 72) == want.shape[1]
    from keystone_tpu_torch.parallel.dataset import HostDataset

    out = BatchSIFTExtractor(step=8, num_scales=2).apply_dataset(
        HostDataset([t, t]))
    assert all(torch.equal(o, want) for o in out.collect())


def _sift_pairs(h, w, scale):
    """The two band pairs of one SIFT scale at the VOCSIFTFisher defaults:
    (left, right, channels) of the smoothing and of the binning."""
    step, b, lo = sift._scale_params(scale, 4, 6, 5, 0)
    Ty, _ = sift._sampling_operator_interleaved(h, lo, step, b)
    Tx, _ = sift._sampling_operator_interleaved(w, lo, step, b)
    return [(sift._smooth_band(h, b), sift._smooth_band(w, b), 1),
            (Ty, Tx, sift.NBO)]


@pytest.mark.parametrize("case", ["random", "sift_small", "channels"])
def test_two_sided_plain_matches_pallas_interpret_twice(case):
    """band @ X[c] @ right.T against the Pallas kernel applied twice (the
    second time to the transposed intermediate), ragged shapes."""
    rng = np.random.RandomState(1)
    if case == "random":
        band, right, C = _random_band(rng, 45, 61, 5), \
            _random_band(rng, 38, 47, 7), 1
    elif case == "sift_small":
        band, right, C = _sift_pairs(61, 47, 0)[1]
    else:
        band, right, C = _random_band(rng, 33, 40, 4), \
            _random_band(rng, 70, 29, 9), 8
    X = rng.randn(C, band.shape[1], right.shape[1]).astype(np.float32)
    want = np.stack([np.asarray(jbanded(
        right, jnp.asarray(np.asarray(jbanded(band, jnp.asarray(x),
                                              interpret=True)).T),
        interpret=True)).T for x in X])
    before = dict(kernels.LAUNCHES)
    got = kernels.banded_matmul(band, torch.as_tensor(X), right=right)
    two_d = kernels.banded_matmul(band, torch.as_tensor(X[0]), right=right)
    assert kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == (C, band.shape[0], right.shape[0])
    assert two_d.shape == got.shape[1:]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(two_d.numpy(), want[0], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h,w", [(375, 500), (500, 375)])
def test_right_side_live_map_covers_every_nonzero_once(h, w):
    """The live map of each right-hand SIFT operator, at VOC's sizes: every
    nonzero of a tile lies in the tile's one contiguous column range,
    which is exact; the widest ranges of both sides stay within the 97
    columns a side the two-sided kernel's patches are sized for; and the
    smoothing launch has an output tile for each of the 132 SMs."""
    tr = _tile_rows()
    for scale in (0, 4):
        for left, right, _ in _sift_pairs(h, w, scale):
            widths = []
            for band in (left, right):
                lo, hi = kernels.band_live_map(band, tr)
                assert len(lo) == -(-band.shape[0] // tr)
                for i in range(len(lo)):
                    cols = np.nonzero(band[i * tr:(i + 1) * tr].any(0))[0]
                    assert lo[i] == cols[0] and hi[i] == cols[-1] + 1
                    visited = np.arange(lo[i], hi[i])
                    assert len(np.unique(visited)) == len(visited)
                widths.append(int((hi - lo).max()))
            assert max(widths) <= 97, (scale, widths)
        smooth_tiles = -(-h // tr) * -(-w // tr)
        assert smooth_tiles >= 132


@pytest.mark.parametrize("h,w", [(61, 47), (96, 128), (90, 110)])
def test_two_sided_banded_form_matches_jax_in_two_calls_a_scale(h, w):
    """The banded form makes two two-sided band calls a scale, and its
    descriptors (plain band products on the CPU) lie in the golden
    envelope of the einsum form and of the JAX package's dense_sift."""
    img = np.random.RandomState(h * w).rand(h, w).astype(np.float32)
    args = (KW["step"], KW["bin_size"], KW["num_scales"], KW["scale_step"])
    calls = []
    real = sift.banded_matmul

    def record(band, X, right=None):
        calls.append((band.shape, tuple(X.shape), right.shape))
        return real(band, X, right=right)

    sift.banded_matmul = record
    try:
        banded = sift._dense_sift(torch.as_tensor(img), *args,
                                  sift._dsift_one_scale_banded).numpy()
    finally:
        sift.banded_matmul = real
    assert len(calls) == 2 * KW["num_scales"], calls
    assert [c[1][0] for c in calls[1::2]] == [sift.NBO] * KW["num_scales"]
    _envelope(banded, sift.dense_sift_plain(torch.as_tensor(img),
                                            *args).numpy())
    _envelope(banded, np.asarray(jsift.dense_sift(jnp.asarray(img), **KW)))
