"""Work of the Gram kernel, the block solve and the scaler.

``gram_work`` counts the operations of
``keystone_tpu_torch/ops/work.py::gram_work`` and the bytes of the
symmetric carry's triangle (the program's own count has all of G); the
rest count the algorithm of ``BlockLeastSquaresEstimator`` and
``StandardScaler``.
"""
from __future__ import annotations

from typing import Tuple


def gram_work(n: int, d: int, k: int) -> Tuple[int, int]:
    """(operations, bytes) of one Gram-and-cross launch on X (n, d) and
    Y (n, k): the upper triangle of X^T X and X^T Y, 2 n (d (d + 1) / 2 +
    d k) operations; X and Y read once, G's upper triangle and C read and
    written once (G is symmetric: its triangle is all the algorithm
    needs to carry)."""
    tri = d * (d + 1) // 2
    ops = 2 * n * (tri + d * k)
    nbytes = 4 * (n * d + n * k + 2 * tri + 2 * d * k)
    return ops, nbytes


def block_solve_flops(n: int, d: int, block: int, k: int, passes: int) -> int:
    """Operations of block coordinate descent on n rows, d features in
    blocks of ``block`` and k label columns: once a block, its Gram's
    triangle (n w (w + 1)) and its Cholesky factor (w^3 / 3); each pass
    and block, the cross product with the residual and the residual's
    update (2 n w k each) and the two triangular solves (2 w^2 k)."""
    total = 0
    for lo in range(0, d, block):
        w = min(block, d - lo)
        total += n * w * (w + 1) + w ** 3 // 3
        total += passes * (4 * n * w * k + 2 * w * w * k)
    return total


def scaler_flops(n: int, d: int) -> int:
    """A ``StandardScaler`` fit's column sums and sums of squares (3 n d)
    and its application to the same rows (2 n d)."""
    return 5 * n * d


def linear_apply_flops(n: int, d: int, k: int) -> int:
    """Scaling and centering n rows (3 n d) and the product with the
    (d, k) weights (2 n d k)."""
    return 3 * n * d + 2 * n * d * k
