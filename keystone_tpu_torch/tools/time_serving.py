"""Times the serving plane's captured-bucket path at phase 4c's widths of
``chip_smoke.py`` in the checkout it runs from, so that two versions of
the plane can be compared on one card: run it from each checkout in
turns (A, B, B, A), one card for all of them.

    PYTHONPATH=<checkout> python <checkout>/keystone_tpu_torch/tools/time_serving.py [PASSES]

A RandomPatchCifar model at the bench configuration's widths (1024
learned filters, 8192 features, ``BlockLeastSquaresEstimator(4096, 1,
10)``), fitted on 4096 surrogate CIFAR images, is admitted three times
into one ``ServingPlane`` on the card (f32, bf16 and int8 weights,
``max_batch = 64``: every bucket captured as a CUDA graph). Each pass
sends the 4096 test images, cut into seeded requests of 1-64 rows, from
8 closed-loop client threads through ``plane.submit`` to each model in
turn, after a first pass timed apart (phase 4c's, which pays the
first requests' set-up). Prints one JSON line: each weight type's
rows/s in the first pass, in each later pass and their median, and ``serving.request_ms`` p50 / p99
over the timed passes' last 256 requests (the histogram's tail), beside
the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromIntLabels
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.pipelines.images.cifar import (
    random_patch_cifar as rpc,
)
from keystone_tpu_torch.serving import ServingPlane
from keystone_tpu_torch.serving.models import ItemSpec
from keystone_tpu_torch.workflow.common import Cacher

N_TRAIN, N_TEST, NUM_FILTERS, CLIENTS, MAX_BATCH = 4096, 4096, 1024, 8, 64


def _requests(images, seed):
    rng = np.random.RandomState(seed)
    out, i = [], 0
    while i < len(images):
        n = int(rng.randint(1, MAX_BATCH + 1))
        out.append(images[i:i + n])
        i += n
    return out


def _drive(plane, name, requests):
    def client(j):
        for r in range(j, len(requests), CLIENTS):
            plane.submit(name, requests[r]).result(timeout=120)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(CLIENTS) as pool:
        for fut in [pool.submit(client, j) for j in range(CLIENTS)]:
            fut.result(timeout=600)
    return time.perf_counter() - t0


def main(passes: int = 5):
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else None
    (tr_x, tr_y), (te_x, _) = make_surrogate_cifar(N_TRAIN, N_TEST, seed=0)
    config = rpc.RandomCifarConfig(num_filters=NUM_FILTERS, lam=10.0,
                                   seed=0)
    train = ArrayDataset.from_numpy(tr_x, dev)
    filters, whitener = rpc.learn_filters(train, config)
    labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
              >> Cacher("labels"))(
        ArrayDataset.from_numpy(tr_y.astype(np.int32), dev))
    fitted = rpc.build_pipeline(filters, whitener, config, train,
                                labels).fit()
    requests = _requests(te_x.astype(np.float32), seed=1)
    sample = ItemSpec(tuple(te_x.shape[1:]), np.float32)
    rows = {}
    with ServingPlane(max_batch=MAX_BATCH, device=dev) as plane:
        for wd in ("f32", "bf16", "int8"):
            plane.admit(wd, fitted, sample,
                        weight_dtype=None if wd == "f32" else wd)
        # the first pass after admission (phase 4c's), then the timed ones
        first = {name: len(te_x) / _drive(plane, name, requests)
                 for name in ("f32", "bf16", "int8")}
        MetricsRegistry.reset()
        for _ in range(passes):
            for name in ("f32", "bf16", "int8"):
                wall = _drive(plane, name, requests)
                rows.setdefault(name, []).append(len(te_x) / wall)
        hist = MetricsRegistry.get_or_create().histogram(
            "serving.request_ms")
        line = {name: {"first_pass": first[name], "rows_per_s": r,
                       "median": statistics.median(r)}
                for name, r in rows.items()}
        line.update(request_ms_p50=hist.percentile(50),
                    request_ms_p99=hist.percentile(99), card=card)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
