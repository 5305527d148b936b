"""Times the streamed RandomPatchCifar fit of phase 4b of
``chip_smoke.py`` in the checkout it runs from, so that two versions of
the streamed path can be compared on one card: run it from each checkout
in turns (A, B, B, A), one card for all of them.

    python -m keystone_tpu_torch.tools.time_streamed_fit [FITS]

The fit is phase 4b's: 20480 surrogate CIFAR images streamed as float32
in chunks of 1024 at prefetch depth 2 under the same device budget, 1024
learned filters, 8192 features, ``StandardScaler`` and
``BlockLeastSquaresEstimator(4096, 1, 10)``, through
``build_pipeline(...).fit()`` with the prefix memo reset before each
fit. The process's first fit (the kernels' first launches, which load
their code under CUDA's lazy module loading) is timed apart. Where the
checkout has the numerics plane, each later fit is paired with one
under ``numerics_suppressed()``, the two in alternating order. Prints
one JSON line: the first fit's seconds, each later fit's, their median,
the suppressed fits' and the median of the pairs' shares, beside the
card's name and power limit.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromIntLabels
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.parallel.streaming import StreamingDataset
from keystone_tpu_torch.pipelines.images.cifar import (
    random_patch_cifar as rpc,
)
from keystone_tpu_torch.workflow.common import Cacher
from keystone_tpu_torch.workflow.env import PipelineEnv

N_TRAIN, CHUNK, DEPTH, NUM_FILTERS = 20480, 1024, 2, 1024


def main(fits: int = 7):
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else None
    try:
        from keystone_tpu_torch.observability.numerics import (
            numerics_suppressed,
        )
    except ImportError:
        numerics_suppressed = None
    (tr_x, tr_y), _ = make_surrogate_cifar(N_TRAIN, 16, seed=0)
    config = rpc.RandomCifarConfig(num_filters=NUM_FILTERS, lam=10.0,
                                   seed=0)
    filters, whitener = rpc.learn_filters(
        ArrayDataset.from_numpy(tr_x, dev), config)
    labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
              >> Cacher("labels"))(
        ArrayDataset.from_numpy(tr_y.astype(np.int32), dev))
    budget = (DEPTH + 1) * CHUNK * 32 * 32 * 3 * 4 + (1 << 20)

    def fit(off=False):
        PipelineEnv.reset()
        stream = StreamingDataset.from_numpy(
            tr_x, CHUNK, device=dev, prefetch_depth=DEPTH,
            tag="cifar-train", hbm_budget=budget)
        torch.cuda.synchronize()
        with numerics_suppressed() if off else contextlib.nullcontext():
            t0 = time.time()
            rpc.build_pipeline(filters, whitener, config, stream,
                               labels).fit()
            torch.cuda.synchronize()
            return time.time() - t0

    first = fit()
    on, off = [], []
    for i in range(fits):
        if numerics_suppressed is None:
            on.append(fit())
            continue
        for leg in ((False, True) if i % 2 == 0 else (True, False)):
            (off if leg else on).append(fit(leg))
    line = {"first_s": first, "fits_s": on,
            "median_s": statistics.median(on)}
    if off:
        line.update(suppressed_s=off, median_suppressed_s=statistics.median(
            off), median_share=statistics.median(
                (a - b) / b for a, b in zip(on, off)))
    line["card"] = card
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
