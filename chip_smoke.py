#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``keystone_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile every kernel from the checkout's CUDA sources.
3. Kernel against plain: each kernel's wrapper on card tensors at the
   shapes the main path gives it (and a ragged K), held against its
   plain PyTorch version on the same inputs.
4. Main path: RandomPatchCifar fit + apply at the full width of the
   repository's bench configuration (1024 filters, 8192 features, two
   4096-wide BCD blocks) on surrogate CIFAR (20480 train / 4096 test
   images), through ``Pipeline.fit`` / ``apply`` / ``apply_datum``;
   then LinearPixels on the same data. Accuracy must land in the
   surrogate's bands and every kernel must have launched.
5. Timing: each kernel, its plain version and a library yardstick with
   CUDA events at B = 1024, K = 1024.

``--profile`` adds a second fit + apply under ``torch.profiler`` after
phase 4 and prints device time by kernel and the device's idle share.

The line before the last is a JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: Published H100 SXM peaks (NVIDIA data sheet): float32 outside the
#: tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: Kernel vs plain version: max |kernel - plain| <= FEATURIZE_TOL *
#: max |plain|. Both sides run in true float32 and differ only in the
#: order of their sums (the JAX package holds its TPU kernel to
#: rtol = atol = 2e-3 against the composed ops).
FEATURIZE_TOL = 1e-5

SEED = 0
N_TRAIN, N_TEST = 20480, 4096
NUM_FILTERS = 1024


def _sync():
    torch.cuda.synchronize()


def _time_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    _sync()
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


def _featurize_inputs(rng, B, K, device):
    imgs = torch.as_tensor((rng.rand(B, 32, 32, 3) * 255).astype(np.float32),
                           device=device)
    filters = torch.as_tensor((rng.randn(K, 108) * 0.1).astype(np.float32),
                              device=device)
    means = torch.as_tensor((rng.randn(108) * 20).astype(np.float32),
                            device=device)
    return imgs, filters, means


def _featurize_work(B, K, P=729, F=108, R=4, region_hits=4 * 196):
    """(operations, bytes) of fused_cifar_featurize on B images and K
    filters: the patch-by-filter products (2 P F K), the patch sums and
    sums of squares (3 P F), normalize + rectify (9 P K), and the pooled
    adds (2 K per patch-region membership; the four 14 x 14 regions hold
    784 memberships). Bytes: each input read once, the output written
    once."""
    ops = B * (2 * P * F * K + 3 * P * F + 9 * P * K + 2 * K * region_hits)
    nbytes = 4 * (B * 32 * 32 * 3 + K * F + F + B * R * 2 * K)
    return ops, nbytes


def _profile_main_path(rpc, config, train, test, train_labels):
    """Fit + apply once more under torch.profiler (``--profile`` only):
    device time by kernel, and the device's idle share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from keystone_tpu_torch.workflow.env import PipelineEnv

    PipelineEnv.reset()  # else the prefix memo serves the earlier fit
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync()
        t0 = time.time()
        filters, whitener = rpc.learn_filters(train.data, config)
        fitted = rpc.build_pipeline(filters, whitener, config, train.data,
                                    train_labels).fit()
        fitted.apply(test.data).get()
        _sync()
        wall = time.time() - t0
    busy = sum(e.device_time for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    print(f"[profile] fit + apply {wall:.3f} s wall, device busy "
          f"{busy:.3f} s, idle share {1 - busy / wall:.3f}", flush=True)


def main() -> int:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from keystone_tpu_torch.evaluation.multiclass import evaluate_multiclass
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels,
    )
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.pipelines.images.cifar import (
        linear_pixels,
        random_patch_cifar as rpc,
    )
    from keystone_tpu_torch.workflow.common import Cacher

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {smi}",
          flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    logs = kernels.build_kernels()
    print(f"[build] {len(kernels.SOURCES)} kernel libraries in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = [int(line.split()[4]) for line in log.splitlines()
                  if "spill stores" in line]
        print(f"[build] {name}: {len(regs)} kernel instantiations, at most "
              f"{max(regs, default=0)} registers, {sum(spills)} bytes of "
              "spill stores", flush=True)

    # -- 3. kernel against plain --------------------------------------------
    # the main path's shapes (fit featurize, test featurize, datum path)
    # plus a ragged K; the plain version runs in chunks of 512 images, its
    # (B, 27, 27, K) intermediates being too large for 20480 at once
    rng = np.random.RandomState(SEED)
    worst = 0.0
    for B, K in ((256, NUM_FILTERS), (256, 100), (1, NUM_FILTERS),
                 (N_TEST, NUM_FILTERS), (N_TRAIN, NUM_FILTERS)):
        imgs, filters, means = _featurize_inputs(rng, B, K, dev)
        got = kernels.fused_cifar_featurize(imgs, filters,
                                            whitener_means=means)
        want = torch.cat([kernels.fused_cifar_featurize_plain(
            imgs[i:i + 512], filters, whitener_means=means)
            for i in range(0, B, 512)])
        _sync()
        assert got.shape == want.shape == (B, 4 * 2 * K), got.shape
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rel = float(((got - want).abs()
                     / want.abs().clamp_min(1e-3 * scale)).max())
        print(f"[check] fused_cifar_featurize B={B} K={K}: max abs err "
              f"{err:.3e} (max |plain| {scale:.3e}), max rel err {rel:.3e}",
              flush=True)
        assert err <= FEATURIZE_TOL * scale, (err, scale)
        worst = max(worst, err)
        del imgs, filters, means, got, want
    torch.cuda.empty_cache()

    # -- 4. main path ---------------------------------------------------------
    (tr_x, tr_y), (te_x, te_y) = make_surrogate_cifar(N_TRAIN, N_TEST,
                                                      seed=SEED)
    train = LabeledData(ArrayDataset.from_numpy(tr_x, dev),
                        ArrayDataset.from_numpy(tr_y.astype(np.int32), dev))
    test = LabeledData(ArrayDataset.from_numpy(te_x, dev),
                       ArrayDataset.from_numpy(te_y.astype(np.int32), dev))
    config = rpc.RandomCifarConfig(num_filters=NUM_FILTERS, lam=10.0,
                                   seed=SEED)

    kernels.reset_launches()
    _sync()
    t0 = time.time()
    train_labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
                    >> Cacher("labels"))(train.labels)
    filters, whitener = rpc.learn_filters(train.data, config)
    fitted = rpc.build_pipeline(filters, whitener, config, train.data,
                                train_labels).fit()
    _sync()
    fit_s = time.time() - t0
    t0 = time.time()
    test_pred = fitted.apply(test.data).get()
    _sync()
    apply_s = time.time() - t0
    train_pred = fitted.apply(train.data).get()
    datum = [fitted.apply_datum(test.data.data[i]).get() for i in range(8)]
    _sync()
    launches = dict(kernels.LAUNCHES)

    preds = test_pred.numpy()
    assert preds.shape == (N_TEST,) and preds.min() >= 0 \
        and preds.max() < rpc.NUM_CLASSES
    datum = np.array([int(d) for d in datum])
    assert np.array_equal(datum, preds[:8]), (datum, preds[:8])
    rp_train = evaluate_multiclass(train_pred, train.labels,
                                   rpc.NUM_CLASSES).total_error
    rp_test = evaluate_multiclass(test_pred, test.labels,
                                  rpc.NUM_CLASSES).total_error
    print(f"[e2e] RandomPatchCifar {NUM_FILTERS} filters, "
          f"{filters.shape[0] * 8} features: fit {fit_s:.2f} s "
          f"({N_TRAIN / fit_s:.0f} img/s incl. filter learning), apply "
          f"{apply_s:.3f} s ({N_TEST / apply_s:.0f} img/s), train error "
          f"{rp_train:.4f}, test error {rp_test:.4f}, launches {launches}",
          flush=True)
    _, _, lin_eval = linear_pixels.run(
        linear_pixels.LinearPixelsConfig(lam=10.0), train, test, device=dev)
    lin_test = lin_eval.total_error
    print(f"[e2e] LinearPixels test error {lin_test:.4f}", flush=True)
    assert 0.02 < rp_test < 0.90, rp_test
    assert 0.30 < lin_test < 0.98, lin_test
    assert rp_test < lin_test - 0.15, (rp_test, lin_test)
    for name, count in launches.items():
        assert count > 0, f"{name} was not launched on the main path"
    if "--profile" in sys.argv[1:]:
        _profile_main_path(rpc, config, train, test, train_labels)
        kernels.LAUNCHES.update(launches)
    del fitted, train, test, train_labels, test_pred, train_pred
    torch.cuda.empty_cache()

    # -- 5. timing ------------------------------------------------------------
    B = K = 1024
    imgs, filters, means = _featurize_inputs(rng, B, K, dev)
    counted = dict(kernels.LAUNCHES)
    ms = _time_ms(lambda: kernels.fused_cifar_featurize(
        imgs, filters, whitener_means=means), reps=20)
    plain_ms = _time_ms(lambda: kernels.fused_cifar_featurize_plain(
        imgs, filters, whitener_means=means), reps=5, warmup=1)
    kernels.LAUNCHES.update(counted)  # timing launches are not the path's
    # library yardstick: the raw filter-bank product alone, as one
    # cuDNN float32 convolution (TF32 off); no single PyTorch call
    # computes the whole fused function
    x = imgs.permute(0, 3, 1, 2).contiguous()
    w = filters.reshape(K, 6, 6, 3).permute(0, 3, 1, 2).contiguous()
    library_ms = _time_ms(lambda: torch.nn.functional.conv2d(x, w), reps=20)
    ops, nbytes = _featurize_work(B, K)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[time] fused_cifar_featurize B={B} K={K}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, conv2d (GEMM only) {library_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms by {bound_by} ({ops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB), {ops / ms / 1e9:.1f} TFLOP/s achieved",
          flush=True)

    # -- 6. report ------------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_cifar_featurize",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/fused_featurize.cu",
        "replaces": "keystone_tpu/ops/pallas_kernels.py:290",
        "launches": launches["fused_cifar_featurize"],
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
