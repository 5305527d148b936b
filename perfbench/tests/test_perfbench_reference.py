"""The plain reference and the seeded generators, at tiny sizes on the
CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import reference
from perfbench.data import cifar as cifar_data
from perfbench.data import timit as timit_data
from perfbench.reference import featurize as ref_featurize


def _ridge_f64(A, Y, lam):
    """The closed-form ridge solution in float64: (A^T A + lam I)^-1 A^T Y."""
    A, Y = np.asarray(A, np.float64), np.asarray(Y, np.float64)
    return np.linalg.solve(A.T @ A + lam * np.eye(A.shape[1]), A.T @ Y)


@pytest.mark.parametrize("widths,passes,tol", [
    ([12], 1, 1e-12),            # one block, one pass: the exact solve
    ([5, 7], 60, 1e-9),          # blocks converge to the exact solve
])
def test_block_ridge_against_a_closed_form_ridge(widths, passes, tol):
    g = np.random.RandomState(3)
    A = g.randn(40, sum(widths))
    Y = g.randn(40, 3)
    lam = 0.7
    At = torch.tensor(A)
    bounds = np.cumsum([0] + widths)
    Ws = reference.block_ridge(
        lambda b: At[:, bounds[b]:bounds[b + 1]], widths,
        torch.tensor(Y), lam, passes)
    W = torch.cat(Ws).numpy()
    exact = _ridge_f64(A, Y, lam)
    assert np.abs(W - exact).max() <= tol * np.abs(exact).max()


def test_the_reference_featurize_against_a_loop_over_patches():
    g = torch.Generator().manual_seed(5)
    imgs = torch.rand((2, 10, 10, 3), generator=g, dtype=torch.float64) * 255
    filters = torch.randn((4, 27), generator=g, dtype=torch.float64)
    means = torch.randn(27, generator=g, dtype=torch.float64)
    got = ref_featurize.featurize(imgs, filters, means, patch=3,
                                  pool_stride=4, pool_size=4, alpha=0.25)
    side = 8
    regions = ref_featurize.pool_regions(side, 4, 4)
    want = torch.zeros(2, len(regions), len(regions), 8, dtype=torch.float64)
    for b in range(2):
        for y in range(side):
            for x in range(side):
                p = imgs[b, y:y + 3, x:x + 3, :].reshape(-1)
                p = (p - p.mean()) / torch.sqrt(p.var() + 10.0) - means
                c = filters @ p
                r = torch.cat([(c - 0.25).clamp_min(0), (-c - 0.25).clamp_min(0)])
                for i, (y0, y1) in enumerate(regions):
                    for j, (x0, x1) in enumerate(regions):
                        if y0 <= y < y1 and x0 <= x < x1:
                            want[b, i, j] += r
    assert torch.allclose(got, want.reshape(2, -1), rtol=1e-10, atol=1e-10)


def test_generators_repeat_for_a_seed_and_differ_between_seeds():
    big = 2 ** 31 + 977
    (tr, te) = cifar_data.images(big, 64, 16, 2, "cpu")
    (tr2, te2) = cifar_data.images(big, 64, 16, 2, "cpu")
    assert torch.equal(tr[0][0], tr2[0][0]) and torch.equal(te[1], te2[1])
    assert not torch.equal(tr[0][0], tr[1][0])
    assert tr[0][0].shape == (64, 32, 32, 3)
    assert float(tr[0][0].min()) >= 0 and float(tr[0][0].max()) <= 255
    other = cifar_data.images(big + 1, 64, 16, 1, "cpu")[0][0][0]
    assert not torch.equal(other, tr[0][0])
    (f_tr, f_te) = timit_data.frames(big, 32, 8, 1, 147, 440, "cpu")
    assert f_tr[0][0].shape == (32, 440) and f_te[1].dtype == torch.int32
    assert torch.equal(f_tr[0][0], timit_data.frames(big, 32, 8, 1, 147, 440,
                                                     "cpu")[0][0][0])


def test_filters_are_whitened_unit_rows_whitened_back():
    (tr, _) = cifar_data.images(11, 128, 8, 1, "cpu")
    bank, W, mu = cifar_data.filters(11, tr[0][0], 8, 6, 0.1, 3000)
    assert bank.shape == (8, 108) and W.shape == (108, 108) and mu.shape == (108,)
    assert np.allclose(W, W.T, atol=1e-5)
    # each filter is a unit row times W^T: undoing W^T gives norm 1
    rows = bank @ np.linalg.inv(W.T.astype(np.float64))
    assert np.allclose(np.linalg.norm(rows, axis=1), 1.0, atol=1e-3)


def test_precision_restores_the_tf32_switches():
    before = torch.backends.cuda.matmul.allow_tf32
    with reference.precision(True):
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
