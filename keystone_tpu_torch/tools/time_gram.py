"""Times the Gram kernel of the checkout it runs from, so that two
designs of ``csrc/gram_cross.cu`` can be compared on one card: run it
from each checkout in turns (A, B, B, A), one card for all of them.

    python -m keystone_tpu_torch.tools.time_gram

Prints one JSON line at the streamed fit's chunk shape (1024, 8192, 10):
the card's name and power limit; the device milliseconds of one launch
(``tools.device_ms``); the max error of G and of C against the float64
sums on seeded randn rows into a nonzero carry, in units of 2^-24 of the
largest float64 entry, beside the plain float32 version's; and the mean
signed error of G's diagonal relative to its X^T X part, in the same
units, where a rounding bias toward zero shows.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.tools import device_ms


def main(n=1024, d=8192, k=10):
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    X = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=dev)
    Y = torch.as_tensor(rng.randn(n, k).astype(np.float32), device=dev)
    G0 = torch.as_tensor(rng.randn(d, d).astype(np.float32), device=dev)
    G0 = (G0 + G0.T) * n ** 0.5
    C0 = torch.as_tensor(rng.randn(d, k).astype(np.float32), device=dev)
    G, C = G0.clone(), C0.clone()
    out = {"n": n, "d": d, "k": k,
           "device_ms": device_ms(lambda: kernels.gram_cross(X, Y, G, C))}
    Xd = X.double()
    gram = Xd.T @ Xd
    for name, fn in (("kernel", kernels.gram_cross),
                     ("plain", kernels.gram_cross_plain)):
        G, C = fn(X, Y, G0.clone(), C0.clone())
        for part, got, want in (
                ("G", G, G0.double() + gram),
                ("C", C, C0.double() + Xd.T @ Y.double())):
            err = (got.double() - want).abs().max() / want.abs().max()
            out[f"{name}_{part}_units"] = float(err) * 2 ** 24
        diag = (G.double() - G0.double() - gram).diagonal() / gram.diagonal()
        out[f"{name}_diag_bias_units"] = float(diag.mean()) * 2 ** 24
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out["card"] = card.strip().splitlines()[0] if card.strip() else None
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
