"""Times the block least-squares solve's constituent operations at CIFAR
scale: n = 50000 rows, a 4096-wide block, k = 10 labels.

    python -m keystone_tpu_torch.tools.profile_solver [--small] \
        [--device cuda|cpu]

Counterpart of the repository's ``tools/profile_solver.py``. Each line
gives one operation's milliseconds and its nominal rate from the
reference tool's flop counts: the full Gram (2 n bs^2), the Gram as
symmetric tiles of 512 and 1024 columns (only the upper tiles computed,
then assembled; their computed fraction and the time that fraction of
the full Gram would take), the Cholesky factor of ``G + 0.1 I`` (bs^3 /
3), ``cholesky_solve`` with k right-hand sides, and the cross product
with the residual (4 n bs k). These are plain float32 products, which
the reference computes outside any Pallas kernel too: ``torch.matmul``
and ``torch.linalg`` (TF32 stays off, ``ops/device.py``). Data is made
on the device from a seeded ``torch.Generator``; each time is the mean
of 5 calls after two warm calls, the card synchronized at the end
(``tools.timeit``). ``--small`` is (5000, 1024, 10).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from . import timeit

SHAPE = (50_000, 4_096, 10)
SMALL_SHAPE = (5_000, 1_024, 10)
TILES = (512, 1024)
RIDGE = 0.1


def gram_full(A: torch.Tensor) -> torch.Tensor:
    return A.T @ A


def syrk(A: torch.Tensor, tile: int) -> torch.Tensor:
    """A^T A from its upper tiles of ``tile`` columns (the last tile may be
    narrower), the lower ones their transposes."""
    bs = A.shape[1]
    edges = list(range(0, bs, tile)) + [bs]
    cols = [A[:, lo:hi] for lo, hi in zip(edges[:-1], edges[1:])]
    T = len(cols)
    blk = {}
    for i in range(T):
        for j in range(i, T):
            blk[(i, j)] = cols[i].T @ cols[j]
    return torch.cat([
        torch.cat([blk[(i, j)] if i <= j else blk[(j, i)].T
                   for j in range(T)], dim=1)
        for i in range(T)], dim=0)


def syrk_fraction(bs: int, tile: int) -> float:
    """The share of the full Gram's tiles the symmetric form computes."""
    T = -(-bs // tile)
    return T * (T + 1) / 2 / T ** 2


def chol(G: torch.Tensor, ridge: float = RIDGE) -> torch.Tensor:
    """The lower Cholesky factor of ``G + ridge I``."""
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return torch.linalg.cholesky(G + ridge * eye)


def cho_solve(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(R, L)


def cross_resid(A: torch.Tensor, W: torch.Tensor,
                Y: torch.Tensor) -> torch.Tensor:
    return A.T @ (Y - A @ W)


def _bench(name, fn, *args, flops=None, iters=5):
    fn(*args)          # the first call pays the library's set-up
    dt = timeit(fn, *args, iters=iters)
    rate = f"  {flops / dt / 1e12:7.2f} TFLOP/s (nominal)" if flops else ""
    print(f"{name:28s} {dt * 1e3:9.3f} ms{rate}", flush=True)
    return dt


def profile(n: int, bs: int, k: int, device) -> Dict[str, Dict[str, float]]:
    """Time each operation at (n, bs, k) on ``device``. Returns {operation:
    {"ms", "tflops" (None where no flop count applies)}} and, for each
    tiling, its computed fraction."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((n, bs), generator=gen, device=dev)
    Y = torch.randn((n, k), generator=gen, device=dev)
    R = torch.randn((bs, k), generator=gen, device=dev)
    W0 = torch.zeros((bs, k), device=dev)
    out: Dict[str, Dict[str, Optional[float]]] = {}

    def record(name, dt, flops):
        out[name] = {"ms": dt * 1e3,
                     "tflops": flops / dt / 1e12 if flops else None}

    gram_flops = 2.0 * n * bs * bs
    t_full = _bench("gram full (A^T A)", gram_full, A, flops=gram_flops)
    record("gram full", t_full, gram_flops)
    for tile in TILES:
        frac = syrk_fraction(bs, tile)
        t = _bench(f"gram syrk tile={tile}", syrk, A, tile, flops=gram_flops)
        record(f"gram syrk tile={tile}", t, gram_flops)
        out[f"gram syrk tile={tile}"]["fraction"] = frac
        print(f"  (computed fraction {frac:.3f}, ideal "
              f"{t_full * frac * 1e3:.1f} ms)", flush=True)
    G = gram_full(A)
    L = chol(G)
    chol_flops = bs ** 3 / 3
    record("cholesky factor", _bench("cholesky factor", chol, G,
                                     flops=chol_flops), chol_flops)
    record(f"cholesky_solve k={k}", _bench(f"cholesky_solve rhs k={k}",
                                           cho_solve, L, R), None)
    cross_flops = 4.0 * n * bs * k
    record("cross+residual", _bench("cross+residual", cross_resid, A, W0, Y,
                                    flops=cross_flops), cross_flops)
    print("done", flush=True)
    return out


def main(argv=None) -> int:
    from ..ops.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="(5000, 1024, 10) instead of (50000, 4096, 10)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, bs, k = SMALL_SHAPE if args.small else SHAPE
    print(f"profile_solver: n={n} bs={bs} k={k} on {dev}", flush=True)
    profile(n, bs, k, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
