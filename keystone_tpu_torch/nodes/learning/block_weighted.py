"""Weighted block-coordinate least squares.

Counterpart of ``keystone_tpu/nodes/learning/block_weighted.py``
(reference ``nodes/learning/BlockWeightedLeastSquares.scala``). Each
class's ridge solve mixes its own class statistics (weight
``mixture_weight``) with the population statistics (weight ``1 -
mixture_weight``), per pass per feature block (reference :102-320).

Layout: the feature matrix is regrouped on the device into a
class-major tensor ``Xcm (C, S, d)`` (class, slot within the class,
feature) by one gather, pad slots zero, as the JAX package regroups it
over its mesh; one device needs no class or slot padding beyond the
largest class, so C is the class count and S the largest class count.
Per-class statistics are batched products over the slot axis,
population statistics sums over both axes.

Memory: the per-class systems are built a chunk of classes at a time
under the JAX package's budget (``_CLASS_CHUNK_BYTES``, 1 GiB a chunk
tensor), so the (C, d_b, d_b) tensor is never whole: at ImageNet's 1000
classes and 4096-wide blocks it would take 67 GB. "woodbury" factors
the class-independent ``M = (1 - w) pop_cov + lam I`` once a block and
applies each class as a rank-(S + 2) correction; "cholesky" factors each
class's (d_b, d_b) system; "auto" takes woodbury where ``(S + 2) * 2 <=
d_b`` and ``lam > 0``, as the JAX package does.

Numerics: every product runs in the inputs' type, float32 in true
float32 (``ops/device.py`` turns TF32 off) or float64 for a reference
solve. A population factor or a chunk solve that fails (a Cholesky that
reports failure, or a non-finite result) is repaired on the same device
through ``ops.linalg.clamped_eigh``, as the JAX package repairs a
non-finite one; the fitted model's ``_solve_stats`` counts the repairs.

Rank-sharded rows (a dataset marked by ``shard_dataset``, the JAX
package's slots over ``data``): each rank lays out its own rows class
major, and every reduction over examples (the class counts, the
population and class statistics, each pass's cross products, each
class's Gram on the direct path) sums over the mesh's data group in rank
order (``parallel/distributed.py::world_sum``). The low-rank path needs
each class's rows themselves: a chunk's slots are gathered from the
ranks, each rank's padded to the largest rank's (pad slots give zero
rows of V and identity rows of the inner system, so nothing changes).
The solver choice and the class chunks follow the largest class count of
the whole, so every rank runs the same collectives; every rank solves to
the same weights, and the residual stays with the rank's rows.

Checkpoints (``checkpoint_path``): after every pass but the last the
model blocks and the class-major residual are written atomically
(``utils.checkpoint.SolverCheckpoint``); a fit of the same problem
resumes after the last saved pass and gives the same bits as an
uninterrupted fit. The JAX package keeps the model blocks only and
rebuilds the residual from them, which rounds differently. Over
rank-sharded rows each rank keeps its own file (``<path>.rank<r>``), and
a resume happens only where every rank saved the same pass.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ...observability.numerics import record_block_health
from ...ops import linalg
from ...ops.device import DEFAULT_DEVICE, resolve_device
from ...parallel.dataset import Dataset, ensure_array
from ...workflow.label_estimator import LabelEstimator
from .linear import BlockLinearMapper

#: Per-chunk budget for the batched (chunk, d_b, d_b) class covariance
#: and factor tensors (the JAX package's value): peak memory is
#: O(chunk * d_b^2) whatever the class count.
_CLASS_CHUNK_BYTES = 1 << 30


class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    """Per-class mixture-weighted ridge by block coordinate descent
    (reference ``BlockWeightedLeastSquares.scala``). Labels are +-1
    class indicators (one row a class); the fit is a
    ``BlockLinearMapper`` whose ``_solve_stats`` record the solver that
    ran, the class chunk, the chunk count and the repairs."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import labels_width_fit

        return labels_width_fit(dep_specs)

    # -- static HBM planning (analysis.resources) --------------------------
    def fitted_nbytes(self, dep_specs):
        from ...analysis.resources import linear_model_nbytes

        return linear_model_nbytes(dep_specs)

    def __init__(self, block_size: int, num_iter: int, lam: float,
                 mixture_weight: float, num_features: Optional[int] = None,
                 solver: str = "auto", checkpoint_path: Optional[str] = None):
        if solver not in ("auto", "cholesky", "woodbury"):
            raise ValueError(f"unknown solver {solver!r}")
        if solver == "woodbury" and lam <= 0.0:
            # M = (1-w) pop_cov + lam I must be invertible; with lam = 0 a
            # rank-deficient pop_cov would give NaN weights
            raise ValueError("solver='woodbury' requires lam > 0")
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.num_features = num_features
        self.solver = solver
        self.checkpoint_path = checkpoint_path

    @property
    def weight(self) -> int:
        """Passes over the input a fit makes (reference :44)."""
        return 3 * self.num_iter + 1

    def _fit(self, ds: Dataset, labels: Dataset) -> BlockLinearMapper:
        ds = ensure_array(ds)
        labels = ensure_array(labels, ds.device)
        return self._solve(ds.data, labels.data, ds.n, ds.tag, labels.tag,
                           ds.mesh)

    def fit_arrays(self, X, L, device=DEFAULT_DEVICE) -> BlockLinearMapper:
        """Fit on (n, d) features and (n, k) +-1 indicators given as
        arrays or tensors. Tensors stay where they lie; host arrays go to
        ``device``. Floating inputs keep their type (float64 gives a
        float64 reference solve), others become float32."""
        def stage(a):
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a), device=resolve_device(device))
            return t if t.is_floating_point() else t.to(torch.float32)

        X, L = stage(X), stage(L)
        return self._solve(X, L.to(X.device, X.dtype), X.shape[0])

    def _solve(self, X: torch.Tensor, L: torch.Tensor, n: int,
               ds_tag=None, labels_tag=None, mesh=None) -> BlockLinearMapper:
        d, k = X.shape[1], L.shape[1]
        dt, dev = X.dtype, X.device
        w, lam, bs = float(self.mixture_weight), float(self.lam), \
            self.block_size
        bounds = [(i, min(d, i + bs)) for i in range(0, d, bs)]
        rows = _Rows(mesh)

        # label metadata on the host: O(n) class ids
        class_idx = torch.argmax(L[:n], dim=1).cpu().numpy()
        local_counts = np.bincount(class_idx, minlength=k).astype(np.int64)
        perm, S = _class_major_perm(class_idx, local_counts, k)
        # the whole's counts and row count: every rank's decisions follow
        # them, so every rank runs the same collectives
        counts = rows.total(torch.as_tensor(local_counts)).numpy()
        n = int(rows.total(torch.tensor([int(n)]))[0])
        S = max(int(counts.max()) if counts.size else 1, 1)
        # joint label mean (reference :148-156)
        joint_label_mean = torch.as_tensor(
            2.0 * w + 2.0 * (1 - w) * counts / n - 1.0, dtype=dt, device=dev)

        perm_t = torch.as_tensor(perm, device=dev)
        Xcm = _to_class_major(X, perm_t)
        mask = (perm_t >= 0).to(dt)                          # (C, S)
        # the residual starts as the centered labels, zero on pad slots
        Rcm = (_to_class_major(L, perm_t) - joint_label_mean) * mask[..., None]
        counts_t = torch.as_tensor(counts, dtype=dt, device=dev)

        models = [torch.zeros((hi - lo, k), dtype=dt, device=dev)
                  for lo, hi in bounds]
        stats: List[Optional[tuple]] = [None] * len(bounds)
        factors: List[Optional[torch.Tensor]] = [None] * len(bounds)
        info = {"solver": None, "class_chunk": None, "chunks": 0, "S": S,
                "repairs": 0}

        ckpt, ckpt_key, start_pass = None, None, 0
        if self.checkpoint_path:
            from ...utils.checkpoint import SolverCheckpoint

            ckpt = SolverCheckpoint(self.checkpoint_path if mesh is None
                                    else f"{self.checkpoint_path}.rank"
                                    f"{mesh.coords()[0]}")
            # untagged data get a content fingerprint, so a checkpoint of
            # other data of the same shape never warm-starts this solve
            ckpt_key = (n, d, k, bs, self.num_iter, lam, w, self.solver,
                        str(dt), ds_tag or _data_fingerprint(Xcm),
                        labels_tag or _data_fingerprint(Rcm))
            saved = ckpt.load(ckpt_key)
            resume = saved is not None and saved["pass"] + 1 < self.num_iter
            if rows.mesh is not None:
                # resume only where every rank saved the same pass
                mine = saved["pass"] if resume else -1
                got = rows.gather(torch.tensor([mine]))
                resume = resume and all(int(p[0]) == mine for p in got)
            if resume:
                models = [torch.as_tensor(m, dtype=dt, device=dev)
                          for m in saved["models"]]
                Rcm = torch.as_tensor(saved["residual"], dtype=dt,
                                      device=dev)
                start_pass = saved["pass"] + 1

        for pass_idx in range(start_pass, self.num_iter):
            for b, (lo, hi) in enumerate(bounds):
                models[b], Rcm, stats[b], factors[b] = _block_pass_cm(
                    Xcm, Rcm, models[b], mask, counts_t, lo, hi, n, w, lam,
                    self.solver, stats[b], factors[b], info, rows)
            if ckpt is not None and pass_idx + 1 < self.num_iter:
                # a final-pass checkpoint has no consumer
                ckpt.save(ckpt_key, pass_idx, models, residual=Rcm)
        if ckpt is not None:
            ckpt.clear()

        # intercept from per-block sums: no concatenated (d, k) copy of
        # the joint means is made
        final_b = joint_label_mean - sum(
            (s[2].T * m).sum(dim=0) for s, m in zip(stats, models))
        model = BlockLinearMapper(models, bs, intercept=final_b)
        model._solve_stats = info
        return model


class _Rows:
    """Sums and gathers over the ranks' rows of one solve: the identity
    for a dataset that is not rank-sharded."""

    def __init__(self, mesh):
        self.mesh = mesh

    def total(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        from ...parallel.distributed import world_sum

        return world_sum(t, self.mesh)

    def gather(self, t: torch.Tensor):
        """Every rank of the data group's ``t``, in rank order."""
        from ...parallel.distributed import world_gather
        from ...parallel.mesh import DATA_AXIS

        parts = world_gather(t)
        return [parts[r] for r in self.mesh.group(DATA_AXIS)]

    def class_rows(self, Xb: torch.Tensor) -> torch.Tensor:
        """A chunk's (chunk, S, d_b) class-major rows with every rank's
        slots, each rank's padded to the largest rank's count (zero pad
        slots)."""
        if self.mesh is None:
            return Xb
        pad = max(int(p[0]) for p in self.gather(
            torch.tensor([Xb.shape[1]])))
        if Xb.shape[1] < pad:
            Xb = torch.cat([Xb, Xb.new_zeros(
                (Xb.shape[0], pad - Xb.shape[1], Xb.shape[2]))], dim=1)
        return torch.cat(self.gather(Xb.contiguous()), dim=1)


def _data_fingerprint(t: torch.Tensor) -> str:
    """Content identity for checkpoint keys: three float64 moments of a
    tensor already on the device, one small copy to the host."""
    z = t.to(torch.float64)
    s, s2, sa = torch.stack([z.sum(), (z * z).sum(), z.abs().sum()]).tolist()
    return f"fp:{s:.12e}:{s2:.12e}:{sa:.12e}"


def _class_major_perm(class_idx: np.ndarray, counts: np.ndarray,
                      n_classes: int):
    """Row permutation into the (C, S) class-major layout, rows of a
    class in their input order; S is the largest class count (at least
    one) and pad slots hold -1. Returns ``(perm, S)``."""
    S = max(int(counts.max()) if counts.size else 1, 1)
    order = np.argsort(class_idx, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    perm = np.full((n_classes, S), -1, np.int64)
    for c in range(n_classes):
        cnt = int(counts[c])
        perm[c, :cnt] = order[starts[c]: starts[c] + cnt]
    return perm, S


def _to_class_major(X: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(C, S, ...) gather of X's rows by ``perm``; pad slots (-1) zero."""
    C, S = perm.shape
    flat = perm.reshape(-1)
    keep = flat >= 0
    out = X.new_zeros((C * S,) + tuple(X.shape[1:]))
    out[keep] = X[flat[keep]]
    return out.reshape((C, S) + tuple(X.shape[1:]))


def _class_chunk(C: int, d_b: int, S: int = 0, itemsize: int = 4) -> int:
    """Classes a chunk under ``_CLASS_CHUNK_BYTES``: a (d_b, d_b)
    system a class for cholesky; for woodbury (``S`` given) the rank-(S +
    2) factors, about six such tensors live at the peak. ``itemsize`` is
    the solve's bytes an entry (4 in float32, as the JAX package counts;
    8 for a float64 reference solve)."""
    per_class = (itemsize * (S + 2) * d_b * 6 if S
                 else itemsize * d_b * d_b)
    return min(max(int(_CLASS_CHUNK_BYTES // max(per_class, 1)), 1), C)


def _block_stats_cm(Xb, counts, n, w, rows):
    """Population mean and covariance and per-class joint means
    (reference :195-206); pad slots of Xb are zero."""
    flat = Xb.reshape(-1, Xb.shape[2])
    pop_mean = rows.total(flat.sum(dim=0)) / n
    pop_cov = rows.total(flat.T @ flat) / n - torch.outer(pop_mean, pop_mean)
    class_means = rows.total(Xb.sum(dim=1)) / torch.clamp_min(
        counts, 1.0)[:, None]
    joint_means = w * class_means + (1 - w) * pop_mean
    return pop_mean, pop_cov, joint_means


def _pop_cholesky(pop_cov, w, lam, info):
    """The lower factor of M = (1 - w) pop_cov + lam I. Where it fails,
    the Cholesky of the clamped eigendecomposition's reconstruction, and
    failing that sqrt(max clamped eigenvalue) I (always finite)."""
    d_b = pop_cov.shape[0]
    eye = torch.eye(d_b, dtype=pop_cov.dtype, device=pop_cov.device)
    M = (1 - w) * pop_cov + lam * eye
    L, bad = torch.linalg.cholesky_ex(M)
    ok = int(bad) == 0 and bool(torch.isfinite(L).all())
    # the factor's verdict, already on the host; no pivot ratio is read
    # here (it would cost another sync per block)
    record_block_health("block_weighted_pop", [ok], [float("nan")])
    if ok:
        return L
    info["repairs"] += 1
    V, wc = linalg.clamped_eigh(M)
    L2, bad2 = torch.linalg.cholesky_ex((V * wc) @ V.T)
    if int(bad2) == 0 and bool(torch.isfinite(L2).all()):
        return L2
    return math.sqrt(float(wc.max())) * eye


def _block_pass_cm(Xcm, Rcm, model_b, mask, counts, lo, hi, n, w, lam,
                   solver, stats, pop_factor, info, rows):
    """One coordinate-descent step for one block (reference :237-292):
    block statistics and the population factor (first pass only; they
    are pass-invariant), the pass globals, the chunked per-class solves,
    and the residual update. Returns ``(model_b, Rcm, stats,
    pop_factor)``."""
    C = Xcm.shape[0]
    S = info["S"]       # the whole's largest class: the same on every rank
    d_b, k = hi - lo, Rcm.shape[2]
    if solver == "auto":
        solver = ("woodbury" if (S + 2) * 2 <= d_b and lam > 0.0
                  else "cholesky")
    chunk = _class_chunk(C, d_b, S if solver == "woodbury" else 0,
                         Xcm.element_size())
    # evenly spread classes over the chunks, as the JAX package does
    nch = -(-C // chunk)
    chunk = -(-C // nch)
    info.update(solver=solver, class_chunk=chunk)
    info["chunks"] += nch

    Xb = Xcm[:, :, lo:hi].contiguous()
    if stats is None:
        stats = _block_stats_cm(Xb, counts, n, w, rows)
        pop_factor = (_pop_cholesky(stats[1], w, lam, info)
                      if solver == "woodbury" else stats[1])
    pop_mean, _, joint_means = stats

    # pass globals: population cross-products, residual means and each
    # class's own residual column (pad slots of Rcm are zero)
    flat = Xb.reshape(-1, d_b)
    pop_xtr = rows.total(flat.T @ Rcm.reshape(-1, k)) / n      # (d_b, k)
    residual_mean = rows.total(Rcm.sum(dim=(0, 1))) / n        # (k,)
    c_ids = torch.clamp_max(torch.arange(C, device=Xb.device), k - 1)
    res = Rcm[torch.arange(C, device=Xb.device), :, c_ids]     # (C, S)

    delta = torch.empty((C, d_b), dtype=Xb.dtype, device=Xb.device)
    solve = _chunk_solve_woodbury if solver == "woodbury" else _chunk_solve
    for c0 in range(0, C, chunk):
        c1 = min(C, c0 + chunk)
        ids = c_ids[c0:c1]
        delta[c0:c1] = solve(
            Xb[c0:c1], res[c0:c1], counts[c0:c1], joint_means[c0:c1],
            model_b[:, ids].T, pop_xtr[:, ids].T, residual_mean[ids],
            pop_mean, pop_factor, w, lam, info, rows)
    delta = delta[:k].T                                        # (d_b, k)
    model_b = model_b + delta
    Rcm = Rcm - (flat @ delta).reshape(Rcm.shape) * mask[..., None]
    return model_b, Rcm, stats, pop_factor


def _chunk_stats(Xb, res, counts, joint_means, model_c, pop_xtr_c,
                 residual_mean_c, pop_mean, w, lam, rows):
    """Shared per-chunk statistics: class means, the mean difference from
    the population and the regularized right-hand side."""
    cnt = torch.clamp_min(counts, 1.0)
    class_means = rows.total(Xb.sum(dim=1)) / cnt[:, None]
    class_xtr = rows.total(torch.bmm(res[:, None, :], Xb)[:, 0]) \
        / cnt[:, None]
    mean_diff = class_means - pop_mean                         # (chunk, d_b)
    res_class_mean = rows.total(res.sum(dim=1)) / cnt
    mean_mixture_wt = residual_mean_c * (1 - w) + w * res_class_mean
    joint_xtr = ((1 - w) * pop_xtr_c + w * class_xtr
                 - joint_means * mean_mixture_wt[:, None])
    return cnt, class_means, mean_diff, joint_xtr - lam * model_c


def _chunk_solve(Xb, res, counts, joint_means, model_c, pop_xtr_c,
                 residual_mean_c, pop_mean, pop_cov, w, lam, info, rows):
    """Direct path: each class's (d_b, d_b) joint covariance

        (1-w) pop_cov + w class_cov + (1-w) w (mu_c - mu)(mu_c - mu)^T
        + lam I

    built in place and solved by a batched Cholesky; a chunk whose
    factor fails or whose solve is not finite takes the batched clamped
    eigendecomposition instead."""
    d_b = Xb.shape[2]
    cnt, class_means, mean_diff, rhs = _chunk_stats(
        Xb, res, counts, joint_means, model_c, pop_xtr_c, residual_mean_c,
        pop_mean, w, lam, rows)
    A = rows.total(torch.bmm(Xb.transpose(1, 2), Xb))
    A.mul_((w / cnt)[:, None, None])
    A.baddbmm_(class_means[:, :, None], class_means[:, None, :], alpha=-w)
    A.baddbmm_(mean_diff[:, :, None], mean_diff[:, None, :],
               alpha=(1 - w) * w)
    A.add_((1 - w) * pop_cov)
    A.diagonal(dim1=1, dim2=2).add_(lam)
    L, bad = torch.linalg.cholesky_ex(A)
    sol = torch.cholesky_solve(rhs[:, :, None], L)[:, :, 0]
    del L
    if bool((bad == 0).all()) and bool(torch.isfinite(sol).all()):
        return sol
    info["repairs"] += 1
    V, wc = linalg.clamped_eigh(A)
    return torch.einsum("cde,ce->cd", V,
                        torch.einsum("cfe,cf->ce", V, rhs) / wc)


def _chunk_solve_woodbury(Xb, res, counts, joint_means, model_c, pop_xtr_c,
                          residual_mean_c, pop_mean, pop_chol, w, lam, info,
                          rows):
    """Low-rank path: each class's system is A_c = M + V_c^T D V_c with
    M = (1-w) pop_cov + lam I (factored once a block) and

        V_c = [sqrt(w / n_c) X_c ; sqrt(w) mu_c ; sqrt((1-w) w)(mu_c - mu)]

    of rank S + 2, D = diag(1, ..., 1, -1, 1) (w class_cov = (w / n_c)
    X^T X - w mu mu^T gives the one negative direction). Woodbury with
    the shared factor turns the per-class work into products and one
    batched (S + 2) x (S + 2) solve: A^-1 = M^-1 - M^-1 V^T (D + V M^-1
    V^T)^-1 V M^-1. Pad slots give zero rows of V and identity rows of
    the inner system."""
    cnt, class_means, mean_diff, rhs = _chunk_stats(
        Xb, res, counts, joint_means, model_c, pop_xtr_c, residual_mean_c,
        pop_mean, w, lam, rows)
    Xb = rows.class_rows(Xb)          # every rank's slots of the class
    chunk, S, d_b = Xb.shape
    V = torch.cat([Xb * torch.sqrt(w / cnt)[:, None, None],
                   math.sqrt(w) * class_means[:, None, :],
                   math.sqrt((1 - w) * w) * mean_diff[:, None, :]], dim=1)
    signs = torch.ones(S + 2, dtype=Xb.dtype, device=Xb.device)
    signs[S] = -1.0
    minv_rhs = torch.cholesky_solve(rhs.T, pop_chol).T         # (chunk, d_b)
    minv_vt = torch.cholesky_solve(V.reshape(-1, d_b).T, pop_chol).T
    minv_vt = minv_vt.reshape(chunk, S + 2, d_b)               # M^-1 v_i rows
    K = torch.bmm(V, minv_vt.transpose(1, 2)) + torch.diag(signs)
    u = torch.bmm(V, minv_rhs[:, :, None])
    y = torch.linalg.solve(K, u)                               # (chunk, S+2, 1)
    return minv_rhs - torch.bmm(y.transpose(1, 2), minv_vt)[:, 0]
