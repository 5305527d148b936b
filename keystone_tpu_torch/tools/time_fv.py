"""Times the Fisher-vector moments kernel of the checkout it runs from, so
that two designs of ``csrc/fv_moments.cu`` can be compared on one card:
run it from each checkout in turns (A, B, B, A), one card for all of them.

    python -m keystone_tpu_torch.tools.time_fv

Prints one JSON line a GMM shape (D, K, n): ImageNetSiftLcsFV's two
branches (64, 16) at 44,023 and 17,024 descriptors, VOCSIFTFisher's
(80, 256, 47,213), a GMM past the llh tile (8, 4000, 47,213) and a few
small-K shapes. Each line holds the card's name and power limit, the
device milliseconds of one launch (``tools.device_ms``), the largest
error of the three sums against the plain version relative to its
largest value (on seeded randn descriptors whose float64 posteriors lie
clear of the 1e-4 threshold), and whether a second launch gives the same
bits.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from keystone_tpu_torch.nodes.learning.gmm import _posteriors
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.tools import device_ms

SHAPES = ((64, 16, 44023), (64, 16, 17024), (80, 256, 47213),
          (8, 4000, 47213), (64, 64, 5000), (128, 8, 1000), (300, 16, 100))


def main(shapes=SHAPES):
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    for D, K, n in shapes:
        rng = np.random.RandomState(D + K + n)
        X, means, variances, weights = (torch.as_tensor(a, device=dev) for a in (
            rng.randn(D, n).astype(np.float32),
            rng.randn(D, K).astype(np.float32),
            (0.5 + rng.rand(D, K)).astype(np.float32),
            rng.dirichlet(np.ones(K)).astype(np.float32)))
        terms = kernels.fv_terms(means, variances, weights)
        out = {"D": D, "K": K, "n": n, "device_ms": device_ms(
            lambda: kernels.fv_moments(X, means, variances, weights, 1e-4,
                                       terms=terms))}
        q64 = _posteriors(X.T.double(), means.T.double(),
                          variances.T.double(), weights.double(), 0.0)
        clear = ((q64.log() - np.log(1e-4)).abs() > 1e-3).all(dim=1)
        Xc = X[:, clear].contiguous()
        got = kernels.fv_moments(Xc, means, variances, weights, 1e-4,
                                 terms=terms)
        again = kernels.fv_moments(Xc, means, variances, weights, 1e-4,
                                   terms=terms)
        want = kernels.fv_moments_plain(Xc, means, variances, weights, 1e-4)
        out["clear"] = int(clear.sum())
        out["rel_err"] = max(float((g - w).abs().max() / w.abs().max())
                             for g, w in zip(got, want))
        out["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, again))
        out["card"] = card.strip().splitlines()[0] if card.strip() else None
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
