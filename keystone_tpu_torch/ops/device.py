"""Device choice and float32 precision policy for the whole port.

The counterpart of two pieces of the JAX package: the backend test
behind its kernel dispatch (``ops/pallas_kernels.py::use_pallas``) and
the solver precision knob (``ops/linalg.py::SOLVER_PRECISION``).

Device rule: every entry point takes ``device=`` and defaults to
``"cuda"``. A caller who did not ask for the CPU gets an error when no
CUDA device is present; nothing continues silently on the CPU. Tests
pass ``device="cpu"``.

Precision rule: float32 means true float32, with the one exception
below. On Hopper a float32 matmul may run in TF32 (a 10-bit mantissa)
when ``torch.backends.cuda.matmul.allow_tf32`` is set, and cuDNN
convolutions do so by default (``torch.backends.cudnn.allow_tf32``). The
solver path (Gram, cross products, Cholesky and block solves) feeds
normal equations whose conditioning amplifies input error; the JAX
package measured 6.6e-2 relative solution error at a reduced matmul
precision against 4.1e-4 in full f32. Both switches are therefore turned
off when this module is imported, and every module of the port imports
it.

The solver path runs in true float32 with one exception: the fused Gram
kernel (``gram_cross``) runs its products in 3xTF32 on the tensor cores,
behind float64 bars: its G and C within (8 + sqrt(slabs)) x 2^-24 of the
largest entry at every shape, for its ceil(n / 32) slabs of rows, and no
worse than 2x the plain float32 version's error at the streamed fit's
chunk shape; the streamed fit's weights no worse than 2x their reading
with the float32 kernel. Every other solver GEMM stays true float32.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` for an entry point's ``device=`` argument.
    Raises when CUDA is asked for (the default) and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
