"""The plain reference: what the program's fits and scores should be,
worked out again from the benchmark's own inputs in plain PyTorch.

It imports neither the program (``keystone_tpu_torch``) nor JAX, and
takes nothing the program made: features, scaler moments, weights and
scores are all computed here. Every function takes a ``dtype``; the
check runs it in float64, and the control in float32 with TF32 on (see
``precision``).
"""
from __future__ import annotations

import contextlib

import torch

#: how the reference is computed, by name: (dtype, TF32 on): the check's
#: float64, true float32, and the control, float32 with TF32 on
MODES = {"float64": (torch.float64, False), "float32": (torch.float32, False),
         "tf32": (torch.float32, True)}


@contextlib.contextmanager
def precision(tf32: bool):
    """Both TF32 switches set to ``tf32`` inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def indicators(labels: torch.Tensor, num_classes: int, dtype) -> torch.Tensor:
    """+1 at each row's class, -1 elsewhere."""
    hit = torch.arange(num_classes, device=labels.device) == labels.long()[:, None]
    return torch.where(hit, 1.0, -1.0).to(dtype)


def block_ridge(block, widths, Y: torch.Tensor, lam: float, passes: int):
    """Block coordinate descent for ridge regression, as the reference's
    ``BlockLeastSquaresEstimator`` solves it: ``block(b)`` returns the
    centered (n, w_b) feature block b (it may compute it anew each
    call), ``Y`` the centered labels. Each block's ``A^T A + lam I`` is
    factored once; each pass solves the blocks in order,

        W_b <- (A_b^T A_b + lam I)^-1 A_b^T (Y - P + A_b W_b),

    keeping the prediction P = sum_b A_b W_b. Returns the list of W_b."""
    factors = []
    for b in range(len(widths)):
        A = block(b)
        G = A.T @ A
        G.diagonal().add_(lam)
        factors.append(torch.linalg.cholesky(G))
        del A, G
    Ws = [torch.zeros((w, Y.shape[1]), dtype=Y.dtype, device=Y.device)
          for w in widths]
    P = torch.zeros_like(Y)
    for _ in range(passes):
        for b in range(len(widths)):
            A = block(b)
            rhs = A.T @ (Y - P + A @ Ws[b])
            W = torch.cholesky_solve(rhs, factors[b])
            P += A @ (W - Ws[b])
            Ws[b] = W
            del A
    return Ws
