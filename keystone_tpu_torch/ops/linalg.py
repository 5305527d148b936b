"""Dense linear algebra for the solvers.

Counterpart of ``keystone_tpu/ops/linalg.py``: Gram and cross products, column means over zero-padded rows, the ridge Cholesky
solve with its breakdown gate and eigendecomposition fallback, the
normal equations through the fused Gram kernel, and block coordinate
descent. Everything runs in true float32
(``ops/device.py`` turns TF32 off), the counterpart of the JAX package's
``SOLVER_PRECISION = HIGHEST``, except the fused Gram kernel's products,
which run in 3xTF32 behind float64 bars (``ops/device.py``).

Inputs follow the ArrayDataset convention: the row count may exceed the
true ``n`` with zero padding, which is exact for every Gram and cross
product here; operations needing the true count (means) take ``n``.

Rank-sharded rows. Every function taking ``mesh`` reads its input as this
rank's rows of a matrix sharded over the mesh's ``data`` axis
(``parallel/dataset.py::shard_dataset``), and returns the whole matrix's
result on every rank: the JAX package's "local GEMM + all-reduce",
written out, in a live world (of any size, one included). The local product of a Gram goes through the fused Gram
kernel (``gram_cross``) on a CUDA tensor, and each reduction is one
gather followed by a sum in rank order
(``parallel/distributed.py::world_sum``), never an all-reduce, so the
result is the same bits on every rank and on every relaunch. With
``mesh`` None, or a mesh of one data shard, the functions are the
single-device ones, unchanged. TSQR gathers only the R factors; block
coordinate descent sums each block's Gram once and its cross product
every pass, and splits the label columns over the ``model`` axis where
the mesh has one that divides them (``_class_split``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from . import device as _device  # noqa: F401  (sets the TF32 policy)
from ..observability.numerics import numerics_active, record_block_health, \
    record_solve_health
from ..observability.timeline import flight_span
from .kernels import gram_cross


def _sharded(mesh: Any) -> bool:
    """True when the rows are a rank's share under ``mesh`` in a live
    world (a world of one included: its reductions still go through the
    backend)."""
    from ..parallel.mesh import world

    return mesh is not None and world() is not None


def _world_sum(t: torch.Tensor, mesh: Any) -> torch.Tensor:
    from ..parallel.distributed import world_sum

    return world_sum(t, mesh)


def gram(A: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """A^T A. Over rank-sharded rows: the fused Gram kernel on this
    rank's rows, then the sum over the data group in rank order."""
    if not _sharded(mesh):
        return A.T @ A
    G, _ = gram_cross(A, A[:, :0])
    return _world_sum(G, mesh)


def cross(A: torch.Tensor, B: torch.Tensor, mesh: Any = None
          ) -> torch.Tensor:
    """A^T B, over rank-sharded rows co-sharded with ``B``."""
    if not _sharded(mesh):
        return A.T @ B
    return _world_sum(A.T @ B, mesh)


def distributed_mean(A: torch.Tensor, n: int, mesh: Any = None
                     ) -> torch.Tensor:
    """Column means of a zero-padded matrix with true row count ``n``
    (reference ``MatrixUtils.computeMean``). Over rank-sharded rows ``n``
    is this rank's count, and sums and counts add over the data group."""
    if not torch.is_floating_point(A):
        A = A.to(torch.float32)
    if not _sharded(mesh):
        return A.sum(dim=0) / n
    from ..parallel.distributed import world_scalar_sum

    total = world_scalar_sum(n, mesh)
    return _world_sum(A.sum(dim=0), mesh) / total


#: Collapsed-pivot threshold on the scale-free ratio L_ii / sqrt(G_ii)
#: (each pivot against its own column mass, so badly scaled but
#: well-conditioned Grams never misfire). The JAX package measured exact
#: and near-duplicate columns at 2.5e-4..6.7e-4, smooth kappa=3e7
#: spectra at 2.4e-3 and kappa=1e6 at 1.1e-2.
_PIVOT_TAU = 1e-3


def chol_health(L: torch.Tensor, G: torch.Tensor):
    """``(ok, ratio)``: whether the Cholesky factor L of G is finite and
    has no collapsed pivot, and the scale-free min pivot ratio
    L_ii / sqrt(G_ii) it is judged by (``ok`` needs ratio > _PIVOT_TAU).
    Near rank deficiency (duplicate columns at lam ~ 0) can give a
    finite factor whose last pivot is rounding noise; the raw solve then
    returns finite but wildly oversized weights, which this gate
    catches. Both values are read on the host; the numerics plane
    records them (``observability/numerics.py``)."""
    dL = torch.diagonal(L, dim1=-2, dim2=-1).abs()
    dG = torch.sqrt(torch.clamp_min(
        torch.diagonal(G, dim1=-2, dim2=-1).abs(), 1e-30))
    if not bool(torch.isfinite(L).all()):
        return False, float("nan")
    ratio = float(torch.min(dL / dG))
    return ratio > _PIVOT_TAU, ratio


def cholesky_health(reg: torch.Tensor):
    """``(L, ok, ratio)``: the lower Cholesky factor of ``reg``, whether
    it is healthy enough to solve with (LAPACK/cuSOLVER success and
    ``chol_health``), and its min pivot ratio (NaN when the factor
    failed)."""
    L, info = torch.linalg.cholesky_ex(reg)
    if int(info) != 0:
        return L, False, float("nan")
    ok, ratio = chol_health(L, reg)
    return L, ok, ratio


def cholesky_factor(reg: torch.Tensor):
    """``(L, ok)`` of :func:`cholesky_health`."""
    L, ok, _ = cholesky_health(reg)
    return L, ok


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


def ridge_cho_solve(AtA: torch.Tensor, Atb: torch.Tensor, lam: float,
                    site: str = "ridge_cho_solve") -> torch.Tensor:
    """Solve (AtA + lam*I) W = Atb by Cholesky. When the f32 factor breaks
    down or comes within a whisker of it, the clamped eigendecomposition
    recovers a finite, more strongly regularized solution instead of
    NaN or garbage weights. The gate's verdict and pivot ratio go to the
    numerics ledger under ``site``: one ``numerics.breakdown`` event per
    fallback taken. While the numerics plane is on, the raw solve's
    relative residual ``||reg W - Atb|| / (||Atb|| + 1e-30)`` goes with
    them: d^2 k flops and one host read, at the finalize, beside the
    d^3 / 3 of the factorization."""
    d = AtA.shape[0]
    reg = AtA + lam * torch.eye(d, dtype=AtA.dtype, device=AtA.device)
    L, ok, ratio = cholesky_health(reg)
    W = torch.cholesky_solve(Atb, L)
    ok = ok and bool(torch.isfinite(W).all())
    resid = None
    if numerics_active():
        resid = float(torch.linalg.vector_norm(reg @ W - Atb)
                      / (torch.linalg.vector_norm(Atb) + 1e-30))
    record_solve_health(site, ok, ratio, resid)
    return W if ok else eigh_solve(reg, Atb)


def normal_equations(A: torch.Tensor, Y: torch.Tensor,
                     lam: float = 0.0, mesh: Any = None) -> torch.Tensor:
    """Least squares / ridge by the normal equations,
    W = (A^T A + lam I)^-1 A^T Y (mlmatrix ``NormalEquations``): one pass
    of the fused Gram kernel over A (its plain version for CPU tensors)
    into zeroed G and C, summed over the data group for rank-sharded
    rows, then ``ridge_cho_solve``."""
    G, C = gram_cross(A, Y)
    if _sharded(mesh):
        G, C = _world_sum(G, mesh), _world_sum(C, mesh)
    return ridge_cho_solve(G, C, float(lam))


def local_least_squares_dual(A: torch.Tensor, Y: torch.Tensor,
                             lam: float) -> torch.Tensor:
    """Dual-form ridge for d >> n, W = Aᵀ ((A Aᵀ + lam I) \\ Y)
    (reference ``LocalLeastSquaresEstimator.scala:38-58``): a Cholesky
    solve of the (n, n) kernel behind the same health gate and
    eigendecomposition fallback as ``ridge_cho_solve``, recorded under
    ``dual_solve``."""
    n = A.shape[0]
    K = A @ A.T + lam * torch.eye(n, dtype=A.dtype, device=A.device)
    L, ok, ratio = cholesky_health(K)
    alpha = torch.cholesky_solve(Y, L)
    ok = ok and bool(torch.isfinite(alpha).all())
    record_solve_health("dual_solve", ok, ratio)
    alpha = finite_or_eigh_solve(alpha, lambda: K, Y, ok)
    return A.T @ alpha


def _class_split(k: int, mesh: Any):
    """``(lo, hi)`` of the label columns this rank solves when ``mesh``
    has a ``model`` axis of size m > 1 dividing k (the JAX package's
    ``_class_spec``: the Gram and factor work repeats over the model
    groups, the k-column cross products, solves and prediction updates
    split over them); None otherwise."""
    from ..parallel.mesh import MODEL_AXIS, world

    if mesh is None or world() is None:
        return None
    m = mesh.shape[MODEL_AXIS]
    if m <= 1 or k % m:
        return None
    _, j = mesh.coords()
    return j * (k // m), (j + 1) * (k // m)


def bcd_core(blocks: Sequence[torch.Tensor], Y: torch.Tensor, lam: float, *,
             num_passes: int, mesh: Any = None) -> List[torch.Tensor]:
    """Block coordinate descent for ridge regression over feature blocks
    (mlmatrix ``BlockCoordinateDescent.solveLeastSquaresWithL2``):
    maintain P = sum_i A_i W_i; per pass, per block in order, solve

        W_i <- (A_i^T A_i + lam I)^-1 A_i^T (Y - P + A_i W_i)

    then update P. Each block's Gram is pass-invariant, so it is factored
    once per solve; a block whose factor fails the health gate takes the
    eigh fallback every pass. Each factor (the Gram, the ridge term and
    the gate's host reads) is a ``factor:bcd_core`` span and each block
    update (with its finiteness read) a ``block:bcd_core`` span. The JAX
    package runs the same block order as a scan for four or more equal
    blocks and unrolled otherwise.

    Over rank-sharded rows (``mesh``) each block's Gram is the fused
    kernel's on this rank's rows summed over the data group, each pass's
    cross product a local product summed likewise, and P stays local;
    with a ``model`` axis dividing k each model group solves its slice
    of the label columns and the slices are gathered at the end."""
    split = _class_split(Y.shape[1], mesh)
    if split is not None:
        Y = Y[:, split[0]:split[1]]
    k = Y.shape[1]
    factors, ratios = [], []
    for i, A in enumerate(blocks):
        with flight_span("factor:bcd_core", "solve", block=i):
            reg = gram(A, mesh) + lam * torch.eye(A.shape[1], dtype=A.dtype,
                                                  device=A.device)
            L, ok, ratio = cholesky_health(reg)
        factors.append((reg, L, ok))
        ratios.append(ratio)
    record_block_health("bcd_core", [f[2] for f in factors], ratios)
    Ws = [torch.zeros((A.shape[1], k), dtype=Y.dtype, device=Y.device)
          for A in blocks]
    pred = torch.zeros_like(Y)
    for _ in range(num_passes):
        for i, A in enumerate(blocks):
            with flight_span("block:bcd_core", "solve", block=i):
                rhs = cross(A, Y - pred + A @ Ws[i], mesh)
                reg, L, ok = factors[i]
                Wi = finite_or_eigh_solve(torch.cholesky_solve(rhs, L),
                                          lambda: reg, rhs, ok)
                pred = pred + A @ (Wi - Ws[i])
            Ws[i] = Wi
    if split is not None:
        from ..parallel.distributed import world_concat
        from ..parallel.mesh import MODEL_AXIS

        Ws = [world_concat(W, mesh, MODEL_AXIS) for W in Ws]
    return Ws


def block_coordinate_descent(blocks: Sequence[torch.Tensor],
                             Y: torch.Tensor, lam: float, num_passes: int,
                             n_true: Optional[int] = None,
                             mesh: Any = None) -> List[torch.Tensor]:
    """:func:`bcd_core` over the blocks (the JAX entry point's name;
    ``n_true`` is accepted for its signature: padded rows are zero and
    change nothing)."""
    return bcd_core(blocks, Y, lam, num_passes=num_passes, mesh=mesh)


def solve_one_pass_l2(blocks: Sequence[torch.Tensor], Y: torch.Tensor,
                      lam: float, mesh: Any = None) -> List[torch.Tensor]:
    """Single-pass BCD (reference ``solveOnePassL2``,
    BlockLinearMapper.scala:234-236 when numIter == 1)."""
    return bcd_core(blocks, Y, lam, num_passes=1, mesh=mesh)


def _fix_r_sign(R: torch.Tensor) -> torch.Tensor:
    sign = torch.sign(torch.diagonal(R))
    sign = torch.where(sign == 0, 1.0, sign).to(R.dtype)
    return R * sign[:, None]


def tsqr_r(A: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """R factor of A (reference: mlmatrix ``TSQR().qrR`` used by
    DistributedPCA.scala:47; ``keystone_tpu/ops/linalg.py::tsqr_r``). On
    one device the communication-avoiding tree is a single QR. Over
    rank-sharded rows each rank factors its rows, the R factors alone
    are gathered (padded to d rows, zero rows changing nothing), stacked
    in data order and factored again. The sign is normalized so R has a
    non-negative diagonal, as the JAX package normalizes it, which makes
    the result the same for every shard count up to rounding."""
    A = A.to(torch.float32)
    R = torch.linalg.qr(A, mode="r").R
    if not _sharded(mesh):
        return _fix_r_sign(R)
    from ..parallel.distributed import world_gather
    from ..parallel.mesh import DATA_AXIS

    d = A.shape[1]
    padded = torch.zeros((d, d), dtype=R.dtype, device=R.device)
    padded[:R.shape[0]] = R
    parts = world_gather(padded)
    stacked = torch.cat([parts[r] for r in mesh.group(DATA_AXIS)])
    return _fix_r_sign(torch.linalg.qr(stacked, mode="r").R)
