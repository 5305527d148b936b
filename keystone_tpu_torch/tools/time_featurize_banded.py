"""Times the featurize and banded kernels of the checkout it runs from,
so that two versions of ``csrc/fused_featurize.cu`` and
``csrc/banded_matmul.cu`` (and of their wrappers) can be compared on one
card: run it from each checkout in turns (A, B, B, A), one card for all
of them.

    python -m keystone_tpu_torch.tools.time_featurize_banded

Prints one JSON line a call: ``fused_cifar_featurize`` at B = K = 1024
through the filter bank's launch plan (phase 5 of ``chip_smoke.py``),
the banded products of VOCSIFTFisher's 375 x 500 image, scale 0 and 4
(smoothing, then binning and sampling of the 8 orientation maps) and
the one-sided scale-0 smoothing band, and the 10 banded calls of one
such image recorded from ``sift.dense_sift`` (phase 5's banded row),
each beside the card's name and power limit, with the device
milliseconds of one launch (``tools.device_ms``, from a CUDA graph),
the milliseconds of one call at a time between CUDA events (median of
20, the wrapper's host time included), the wrapper's host microseconds
a call (the image row: its 10 calls), the plain version's device
milliseconds, whether a second launch gives the same bits, and the counts of
non-finite outputs of the kernel and of its plain version when one
input value is NaN (an image's first pixel; a pixel inside the bands),
with the banded kernels' live-range reach where the checkout has
``kernels.banded_live_reach``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from keystone_tpu_torch.ops import kernels, sift
from keystone_tpu_torch.tools import device_ms


def _image_calls(dev):
    """The 10 banded calls of one seeded 375 x 500 image's SIFT, as
    (band, X, right) triples."""
    calls = []
    real = sift.banded_matmul

    def record(band, X, right=None):
        calls.append((band, (X if X.dim() == 3 else X[None]).clone(),
                      right))
        return real(band, X, right=right)

    sift.banded_matmul = record
    try:
        img = torch.as_tensor(np.random.RandomState(0).rand(375, 500)
                              .astype(np.float32), device=dev)
        sift.dense_sift(img, 4, 6, 5, 0)
    finally:
        sift.banded_matmul = real
    torch.cuda.synchronize()
    return calls


def _calls(dev):
    """(name, kernel call, plain call, the input a NaN goes into, where,
    the live-range reach call or None)."""
    rng = np.random.RandomState(0)
    imgs = torch.as_tensor((rng.rand(1024, 32, 32, 3) * 255).astype(
        np.float32), device=dev)
    filters = torch.as_tensor((rng.randn(1024, 108) * 0.1).astype(
        np.float32), device=dev)
    means = torch.as_tensor((rng.randn(108) * 20).astype(np.float32),
                            device=dev)
    plan = kernels.featurize_plan(filters, means)
    yield ("fused_cifar_featurize B=1024 K=1024",
           lambda: kernels.fused_cifar_featurize(imgs, plan),
           lambda: kernels.fused_cifar_featurize_plain(
               imgs[:8], filters, whitener_means=means),
           imgs, (0, 0, 0, 0), None)
    reach = getattr(kernels, "banded_live_reach", None)
    H, W = 375, 500
    for scale in (0, 4):
        step, b, lo = sift._scale_params(scale, 4, 6, 5, 0)
        Ty, _ = sift._sampling_operator_interleaved(H, lo, step, b)
        Tx, _ = sift._sampling_operator_interleaved(W, lo, step, b)
        for name, left, right, C in (
                ("smooth", sift._smooth_band(H, b), sift._smooth_band(W, b),
                 1),
                ("bin + sample", Ty, Tx, 8)):
            X = torch.as_tensor(rng.rand(C, H, W).astype(np.float32),
                                device=dev)
            yield (f"banded_matmul {H}x{W} scale {scale} {name}",
                   lambda left=left, X=X, right=right: kernels.banded_matmul(
                       left, X, right=right),
                   lambda left=left, X=X, right=right:
                       kernels.banded_matmul_plain(left, X, right=right),
                   X, (0, 100, 200),
                   None if reach is None else
                   lambda left=left, X=X, right=right: reach(left, X,
                                                             right=right))
    band = sift._smooth_band(H, 6)
    X = torch.as_tensor(rng.rand(H, W).astype(np.float32), device=dev)
    yield ("banded_matmul one-sided 375x500 scale 0 smooth",
           lambda: kernels.banded_matmul(band, X),
           lambda: kernels.banded_matmul_plain(band, X), X, (100, 200),
           None if reach is None else lambda: reach(band, X))
    calls = _image_calls(dev)

    def each(fn):
        return lambda: [fn(band, X, right) for band, X, right in calls]

    yield ("banded_matmul one 375x500 image's 10 calls",
           each(lambda band, X, right: kernels.banded_matmul(
               band, X, right=right)),
           each(lambda band, X, right: kernels.banded_matmul_plain(
               band, X, right=right)),
           None, None, None)


def _card_ms(fn, reps=20):
    """Median milliseconds of one ``fn()`` between CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_us(fn, reps=50):
    """Host microseconds of one ``fn()``, ``reps`` enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def _nonfinite(out):
    out = out if isinstance(out, list) else [out]
    return sum(int((~torch.isfinite(o)).sum()) for o in out)


def main():
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else None
    for name, fn, plain, x, where, reach in _calls(dev):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        line = {"call": name, "device_ms": device_ms(fn),
                "card_ms": _card_ms(fn), "host_us": _host_us(fn),
                # the featurize plain version runs on 8 images only
                "plain_device_ms": (None if name.startswith("fused")
                                    else device_ms(plain)),
                "same_bits": all(torch.equal(p, q) for p, q in zip(
                    a if isinstance(a, list) else [a],
                    b if isinstance(b, list) else [b]))}
        if x is not None:
            keep = x[where].item()
            x[where] = float("nan")
            got = fn()
            got = got[:8] if name.startswith("fused") else got
            line.update(nan_kernel=_nonfinite(got),
                        nan_plain=_nonfinite(plain()))
            if reach is not None:
                line["nan_reach"] = int(reach().sum())
            x[where] = keep
        line["card"] = card
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
