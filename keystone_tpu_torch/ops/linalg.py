"""Dense linear algebra for the solvers, on one device.

Counterpart of ``keystone_tpu/ops/linalg.py`` on one device: Gram and
cross products, column means over zero-padded rows, the ridge Cholesky
solve with its breakdown gate and eigendecomposition fallback, the
normal equations through the fused Gram kernel, and block coordinate
descent. Everything runs in true float32
(``ops/device.py`` turns TF32 off), the counterpart of the JAX package's
``SOLVER_PRECISION = HIGHEST``, except the fused Gram kernel's products,
which run in 3xTF32 behind float64 bars (``ops/device.py``).

Inputs follow the ArrayDataset convention: the row count may exceed the
true ``n`` with zero padding, which is exact for every Gram and cross
product here; operations needing the true count (means) take ``n``.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from . import device as _device  # noqa: F401  (sets the TF32 policy)
from .kernels import gram_cross


def gram(A: torch.Tensor) -> torch.Tensor:
    """A^T A."""
    return A.T @ A


def cross(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^T B."""
    return A.T @ B


def distributed_mean(A: torch.Tensor, n: int) -> torch.Tensor:
    """Column means of a zero-padded matrix with true row count ``n``
    (reference ``MatrixUtils.computeMean``)."""
    if not torch.is_floating_point(A):
        A = A.to(torch.float32)
    return A.sum(dim=0) / n


#: Collapsed-pivot threshold on the scale-free ratio L_ii / sqrt(G_ii)
#: (each pivot against its own column mass, so badly scaled but
#: well-conditioned Grams never misfire). The JAX package measured exact
#: and near-duplicate columns at 2.5e-4..6.7e-4, smooth kappa=3e7
#: spectra at 2.4e-3 and kappa=1e6 at 1.1e-2.
_PIVOT_TAU = 1e-3


def chol_healthy(L: torch.Tensor, G: torch.Tensor) -> bool:
    """True when the Cholesky factor L of G is finite and has no
    collapsed pivot (min L_ii / sqrt(G_ii) > _PIVOT_TAU). Near rank
    deficiency (duplicate columns at lam ~ 0) can give a finite factor
    whose last pivot is rounding noise; the raw solve then returns finite
    but wildly oversized weights, which this gate catches."""
    dL = torch.diagonal(L, dim1=-2, dim2=-1).abs()
    dG = torch.sqrt(torch.clamp_min(
        torch.diagonal(G, dim1=-2, dim2=-1).abs(), 1e-30))
    return bool(torch.isfinite(L).all()) and float(
        torch.min(dL / dG)) > _PIVOT_TAU


def cholesky_factor(reg: torch.Tensor):
    """``(L, ok)``: the lower Cholesky factor of ``reg`` and whether it is
    healthy enough to solve with (LAPACK/cuSOLVER success and
    ``chol_healthy``)."""
    L, info = torch.linalg.cholesky_ex(reg)
    return L, int(info) == 0 and chol_healthy(L, reg)


def clamped_eigh(reg: torch.Tensor):
    """Eigendecomposition of symmetric ``reg`` with eigenvalues clamped to
    a floor scaled for f32 reconstruction safety (8*d*eps of the largest
    magnitude, at least 1e-6 relative): the one home of the
    breakdown-recovery clamp policy. Returns ``(V, wc)``."""
    w, V = torch.linalg.eigh(reg)
    d = reg.shape[-1]
    rel = max(1e-6, 8.0 * d * torch.finfo(reg.dtype).eps)
    floor = torch.clamp_min(w.abs().amax(dim=-1, keepdim=True) * rel, 1e-30)
    return V, torch.maximum(w, floor)


def eigh_solve(reg: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The clamped-eigenvalue solve of reg @ X = rhs."""
    V, wc = clamped_eigh(reg)
    return (V * (1.0 / wc)) @ (V.T @ rhs)


def finite_or_eigh_solve(W: torch.Tensor, reg_fn: Callable[[], torch.Tensor],
                         rhs: torch.Tensor, ok: bool) -> torch.Tensor:
    """W when the solve succeeded (``ok`` and finite), else the
    eigh-clamped solve of ``reg_fn() @ X = rhs``; ``reg_fn`` runs only
    when the fallback is taken."""
    if ok and bool(torch.isfinite(W).all()):
        return W
    return eigh_solve(reg_fn(), rhs)


def ridge_cho_solve(AtA: torch.Tensor, Atb: torch.Tensor,
                    lam: float) -> torch.Tensor:
    """Solve (AtA + lam*I) W = Atb by Cholesky. When the f32 factor breaks
    down or comes within a whisker of it, the clamped eigendecomposition
    recovers a finite, more strongly regularized solution instead of
    NaN or garbage weights."""
    d = AtA.shape[0]
    reg = AtA + lam * torch.eye(d, dtype=AtA.dtype, device=AtA.device)
    L, ok = cholesky_factor(reg)
    W = torch.cholesky_solve(Atb, L)
    return finite_or_eigh_solve(W, lambda: reg, Atb, ok)


def normal_equations(A: torch.Tensor, Y: torch.Tensor,
                     lam: float = 0.0) -> torch.Tensor:
    """Least squares / ridge by the normal equations,
    W = (A^T A + lam I)^-1 A^T Y (mlmatrix ``NormalEquations``): one pass
    of the fused Gram kernel over A (its plain version for CPU tensors)
    into zeroed G and C, then ``ridge_cho_solve``."""
    G, C = gram_cross(A, Y)
    return ridge_cho_solve(G, C, float(lam))


def bcd_core(blocks: Sequence[torch.Tensor], Y: torch.Tensor, lam: float,
             num_passes: int) -> List[torch.Tensor]:
    """Block coordinate descent for ridge regression over feature blocks
    (mlmatrix ``BlockCoordinateDescent.solveLeastSquaresWithL2``):
    maintain P = sum_i A_i W_i; per pass, per block in order, solve

        W_i <- (A_i^T A_i + lam I)^-1 A_i^T (Y - P + A_i W_i)

    then update P. Each block's Gram is pass-invariant, so it is factored
    once per solve; a block whose factor fails the health gate takes the
    eigh fallback every pass. The JAX package runs the same block order
    as a scan for four or more equal blocks and unrolled otherwise."""
    k = Y.shape[1]
    factors = []
    for A in blocks:
        reg = gram(A) + lam * torch.eye(A.shape[1], dtype=A.dtype,
                                        device=A.device)
        factors.append((reg,) + cholesky_factor(reg))
    Ws = [torch.zeros((A.shape[1], k), dtype=Y.dtype, device=Y.device)
          for A in blocks]
    pred = torch.zeros_like(Y)
    for _ in range(num_passes):
        for i, A in enumerate(blocks):
            rhs = cross(A, Y - pred + A @ Ws[i])
            reg, L, ok = factors[i]
            Wi = finite_or_eigh_solve(torch.cholesky_solve(rhs, L),
                                      lambda: reg, rhs, ok)
            pred = pred + A @ (Wi - Ws[i])
            Ws[i] = Wi
    return Ws


def tsqr_r(A: torch.Tensor) -> torch.Tensor:
    """R factor of A (reference: mlmatrix ``TSQR().qrR`` used by
    DistributedPCA.scala:47; ``keystone_tpu/ops/linalg.py::tsqr_r``). On
    one device the communication-avoiding tree is a single QR. The sign is
    normalized so R has a non-negative diagonal, as the JAX package
    normalizes it."""
    R = torch.linalg.qr(A.to(torch.float32), mode="r").R
    sign = torch.sign(torch.diagonal(R))
    sign = torch.where(sign == 0, 1.0, sign).to(R.dtype)
    return R * sign[:, None]
