"""The frozen counts against the program's own (``ops/work.py``) at
today's shapes, and the counts of whole units."""
from __future__ import annotations

import pytest

from keystone_tpu_torch.ops import work as program_work
from perfbench import work
from perfbench.work.featurize import featurize_work
from perfbench.work.solve import block_solve_flops, gram_work


@pytest.mark.parametrize("B,K", [(1024, 1024), (50000, 1024), (1, 100)])
def test_featurize_counts_are_the_programs(B, K):
    product, rest, nbytes = program_work.featurize_work(B, K)
    assert featurize_work(B, K) == (product + rest, nbytes)


@pytest.mark.parametrize("n,d,k", [(1024, 8192, 10), (848, 8192, 10),
                                   (4096, 4096, 147)])
def test_gram_counts_are_the_programs(n, d, k):
    # the same operations; the bytes of G's triangle where the program
    # counts all of G, read and written
    ops, nbytes = program_work.gram_work(n, d, k)
    assert gram_work(n, d, k) == (ops, nbytes - 8 * (d * d - d * (d + 1) // 2))


def test_peaks_are_the_programs():
    assert work.PEAK_FLOPS == program_work.PEAK_TF32_FLOPS
    assert work.PEAK_BYTES == program_work.PEAK_HBM_BYTES


def test_block_solve_counts_cifar_and_timit():
    # RandomPatchCifar: two 4096-wide blocks, one pass, 10 classes
    cifar = block_solve_flops(50000, 8192, 4096, 10, 1)
    assert cifar == 2 * (50000 * 4096 * 4097 + 4096 ** 3 // 3
                         + 4 * 50000 * 4096 * 10 + 2 * 4096 * 4096 * 10)
    # TIMIT at 32,768 frames: 50 blocks, 5 passes, 147 classes: about 5.0e13
    timit = block_solve_flops(32768, 204800, 4096, 147, 5)
    assert 4.9e13 < timit < 5.1e13


def test_shares_of_the_peaks():
    assert work.mfu(495e12, 1.0) == pytest.approx(100.0)
    assert work.roofline_share(0.0, 3.35e12, 2.0) == pytest.approx(50.0)
