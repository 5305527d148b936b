"""Work counts of the five kernels: the FLOPs and bytes of one launch.

One source for every consumer: each wrapper in ``ops/kernels.py`` adds
its launch's counts to ``kernels.WORK`` (where ``LAUNCHES`` counts the
launch), ``observability/utilization.py`` reads them for the per-node
MFU and bandwidth of a traced run, and ``chip_smoke.py`` computes each
kernel's bound from them.

``flops`` are the model's operations, each multiply-add two, with no
credit for the 3xTF32 split (three TF32 products for each float32 one),
which the bounds charge instead. ``nbytes`` count each input read once
and each output written once. The peaks are the H100 SXM's published
dense rates and HBM3 bandwidth.
"""
from __future__ import annotations

from typing import Iterable, Tuple

#: H100 SXM peaks: dense float32 (non-tensor-core), dense TF32 tensor
#: core, HBM3 bytes a second
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def bound(ops: float, nbytes: float,
          peak: float = PEAK_F32_FLOPS) -> Tuple[float, str]:
    """(milliseconds, what bounds it): the larger of the operations'
    time at ``peak`` and the bytes' at the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def featurize_work(B: int, K: int, P: int = 729, F: int = 108, R: int = 4,
                   region_hits: int = 4 * 196,
                   pixels: int = 32 * 32 * 3) -> Tuple[int, int, int]:
    """(product operations, other operations, bytes) of
    ``fused_cifar_featurize`` on B images of ``pixels`` values and K
    filters, P patches of F values an image, R pooling regions holding
    ``region_hits`` patch memberships: the patch-by-filter products
    (2 P F K); the patch sums and sums of squares (3 P F), normalize and
    rectify (9 P K) and the pooled adds (2 K a membership). The defaults
    are the CIFAR geometry: 32 x 32 x 3 images, 6 x 6 patches, four
    14 x 14 regions."""
    product = B * 2 * P * F * K
    rest = B * (3 * P * F + 9 * P * K + 2 * K * region_hits)
    nbytes = 4 * (B * pixels + K * F + F + B * R * 2 * K)
    return product, rest, nbytes


def featurize_bound(B: int, K: int, **work) -> Tuple[int, float, str]:
    """(operations, bound ms, bound by) of ``fused_cifar_featurize``: the
    product in 3xTF32 at the TF32 tensor-core peak, the rest in float32
    at the float32 peak, one after the other; the bound is the larger of
    that time and the bytes'."""
    product, rest, nbytes = featurize_work(B, K, **work)
    t_ops = (3 * product / PEAK_TF32_FLOPS + rest / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (product + rest, max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def gram_work(n: int, d: int, k: int) -> Tuple[int, int]:
    """(operations, bytes) of ``gram_cross`` on X (n, d), Y (n, k): the
    upper triangle of XᵀX plus XᵀY, 2 n (d (d + 1) / 2 + d k)
    operations; X and Y read once, G and C read and written once."""
    ops = 2 * n * (d * (d + 1) // 2 + d * k)
    nbytes = 4 * (n * d + n * k + 2 * d * d + 2 * d * k)
    return ops, nbytes


def gram_bound(n: int, d: int, k: int) -> Tuple[int, float, str]:
    """(operations, bound ms, bound by) of ``gram_cross``: its products in
    3xTF32 at the TF32 tensor-core peak."""
    ops, nbytes = gram_work(n, d, k)
    ms, by = bound(3 * ops, nbytes, PEAK_TF32_FLOPS)
    return ops, ms, by


def quant_work(n: int, d: int, k: int, itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of ``quantized_affine`` on X (n, d) and Wq
    (d, k): the product (2 n d k) and the normalization (3 n d); X read
    once, Wq at its width, the four vectors and the output once."""
    ops = 2 * n * d * k + 3 * n * d
    nbytes = 4 * n * d + d * k * itemsize + 4 * (2 * d + 2 * k) + 4 * n * k
    return ops, nbytes


def banded_call_work(band_nnz: int, m: int, right_nnz: int, r: int,
                     C: int, l: int, w: int) -> Tuple[int, int]:
    """(operations, bytes) of one two-sided ``banded_matmul``, ``band @
    X[c] @ rightᵀ`` for X (C, l, w), a band (m, l) with ``band_nnz``
    nonzeros and a right band (r, w) with ``right_nnz``: the factored
    form's band work, 2 C (band_nnz w + m right_nnz); X read once, the
    output written once."""
    ops = 2 * C * (band_nnz * w + m * right_nnz)
    nbytes = 4 * (C * l * w + C * m * r)
    return ops, nbytes


def banded_work(calls: Iterable) -> Tuple[int, int]:
    """(operations, bytes) summed over ``(band, X, right)`` calls (an
    image's SIFT contractions)."""
    ops = nbytes = 0
    for band, X, right in calls:
        C = X.shape[0] if X.dim() == 3 else 1
        o, b = banded_call_work(int((band != 0).sum()), band.shape[0],
                                int((right != 0).sum()), right.shape[0],
                                C, X.shape[-2], X.shape[-1])
        ops += o
        nbytes += b
    return ops, nbytes


def fv_work(D: int, K: int, n: int) -> Tuple[int, int]:
    """(operations, bytes) of ``fv_moments`` on X (D, n) and a K-component
    GMM: the two products of the moment form, 4 n D K operations each;
    X, the GMM's three tensors and the moment sums read or written
    once."""
    ops = 8 * n * D * K
    nbytes = 4 * (D * n + 3 * D * K + K + K + 2 * D * K)
    return ops, nbytes


def fv_bound(D: int, K: int, n: int) -> Tuple[int, float, str]:
    """(operations, bound ms, bound by) of ``fv_moments``: both products
    in 3xTF32 at the TF32 tensor-core peak."""
    ops, nbytes = fv_work(D, K, n)
    ms, by = bound(3 * ops, nbytes, PEAK_TF32_FLOPS)
    return ops, ms, by
