"""L-BFGS with Armijo backtracking, on one device.

Counterpart of ``keystone_tpu/ops/lbfgs.py`` (reference: Breeze's LBFGS
driven by ``nodes/learning/LBFGS.scala:79-121``): the two-loop recursion
over a circular history of ``num_corrections`` (s, y) pairs, a
curvature-skip guard on history updates (a pair with sᵀy <= 1e-10 is not
stored), a steepest-descent restart when the direction is not a descent
direction, a first step scaled by 1 / max(|g|, 1), Armijo backtracking
from t = 1 (halving, at most ``ls_max_steps`` times), and Breeze's stop:
relative improvement of the objective below ``tol``.

The JAX package runs the loop as one ``lax.while_loop`` on the device.
Here the loop is Python, and the host reads what its branches need: each
objective evaluation's value together with that point's curvature sᵀy
and the step's slope gᵀd, one read of three floats an evaluation (the
Armijo test, then the history guard and the stop test on the accepted
point), each test in float32 as the device loop makes it. The direction, its
descent test and the step scaling stay on the device. Everything runs in
true float32 (``ops/device.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from . import device as _device  # noqa: F401  (sets the TF32 policy)


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    f: float
    num_iters: int
    #: backtracking halvings over the whole solve
    line_search_steps: int
    #: objective evaluations, each one host read of three floats
    evaluations: int


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _direction(g, S, Y, rho, k, m):
    """Two-loop recursion over the circular (m, dim) history holding the
    last min(k, m) pairs."""
    q = g.reshape(-1).clone()
    count = min(k, m)
    alphas = []
    for i in range(count):
        slot = (k - 1 - i) % m
        alpha = rho[slot] * torch.dot(S[slot], q)
        q = q - alpha * Y[slot]
        alphas.append(alpha)
    if k > 0:
        last = (k - 1) % m
        gamma = torch.dot(S[last], Y[last]) / torch.clamp_min(
            torch.dot(Y[last], Y[last]), 1e-30)
        r = gamma * q
    else:
        r = q
    for j in range(count - 1, -1, -1):
        slot = (k - 1 - j) % m
        beta = rho[slot] * torch.dot(Y[slot], r)
        r = r + (alphas[j] - beta) * S[slot]
    return -r.reshape(g.shape)


def lbfgs(
    value_and_grad: Callable[[torch.Tensor],
                             Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    max_iters: int,
    num_corrections: int = 10,
    tol: float = 1e-4,
    ls_max_steps: int = 20,
    c1: float = 1e-4,
) -> LBFGSResult:
    """Minimize ``value_and_grad`` (returning a 0-d loss tensor and a
    gradient shaped like x) from ``x0``."""
    m = num_corrections
    dim = x0.numel()
    S = torch.zeros((m, dim), dtype=x0.dtype, device=x0.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros(m, dtype=x0.dtype, device=x0.device)
    x = x0
    f_dev, g = value_and_grad(x)
    f = f_dev.cpu().numpy()
    c1_32 = np.float32(c1)
    evaluations, ls_steps = 1, 0
    k = it = 0
    while it < max_iters:
        d = _direction(g, S, Y, rho, k, m)
        # restart with -g where d is not a descent direction
        d = torch.where(_dot(g, d) < 0, d, -g)
        if k == 0:
            d = d * (1.0 / torch.clamp_min(torch.linalg.vector_norm(g), 1.0))
        gtd = _dot(g, d)
        t, steps = 1.0, 0
        while True:
            xn = x + t * d
            fn_dev, gn = value_and_grad(xn)
            s = (xn - x).reshape(-1)
            y = (gn - g).reshape(-1)
            sy_dev = torch.dot(s, y)
            fn, sy, gtd_h = torch.stack([fn_dev, sy_dev, gtd]).cpu().numpy()
            evaluations += 1
            if not (fn > f + c1_32 * np.float32(t) * gtd_h) \
                    or steps >= ls_max_steps:
                break
            t *= 0.5
            steps += 1
        ls_steps += steps
        if sy > np.float32(1e-10):
            slot = k % m
            S[slot] = s
            Y[slot] = y
            rho[slot] = 1.0 / sy_dev
            k += 1
        rel_imp = np.abs(f - fn) / max(np.abs(f), np.abs(fn),
                                       np.float32(1e-12))
        x, f, g = xn, fn, gn
        it += 1
        if rel_imp < tol:
            break
    return LBFGSResult(x=x, f=float(f), num_iters=it,
                       line_search_steps=ls_steps, evaluations=evaluations)
