"""Per-stage profile of the ImageNet SIFT -> PCA -> FV featurization, with
the kernels held against their plain versions on every profile.

    python -m keystone_tpu_torch.tools.profile_imagenet [--small] \
        [--images N] [--device cuda|cpu]

Counterpart of the repository's ``tools/profile_imagenet.py``, at its
settings: 16 images of 480 x 640 (``--small``: 4 of 160 x 160), SIFT step
4, bin 6, 5 scales, ``scale_step`` 1, a 64 x 128 PCA, a 16-component GMM.
The stages (per scale s: bin = bin_size + 2 s, step = step + s), as
``ops/sift.py::_dsift_one_scale_banded`` runs them:

  smooth  Gaussian blur, both axes: one two-sided ``banded_matmul``
  orient  gradient -> 8 soft-assigned magnitude maps
  sample  triangle binning + fractional shift + strided sampling of the
          8 maps, both axes: one two-sided ``banded_matmul``
  norm    L2, clamp, renormalize, quantize, in the binned layout
  pca     signed square root + the 64 x 128 projection
  fv      GMM posteriors and moment sums (``fv_moments``) -> 2048-dim FV,
          L2, signed square root, L2

The reference times cumulative prefixes of one compiled program and
takes differences, to cancel a per-program dispatch floor. Eager PyTorch
has no such floor, so each stage is timed alone over the batch, its
inputs the previous stage's outputs: host wall milliseconds of an eager
run (the card synchronized on both sides, after a warm run), the launches
of each kernel in that run (``kernels.LAUNCHES``), device milliseconds of
the same work captured in a CUDA graph and replayed between CUDA events
(``tools.device_ms``), and the device's idle share, 1 - device / wall: the
share of the wall the card waits for the host. Then the whole chain a
batch, a batch of 64 (not with ``--small``), and LCS timed whole.

``kernel_gates`` runs on every profile: prefix 6 against the production
``SIFTExtractor`` -> PCA -> FV chain (<= 1e-4); the banded kernel's
descriptors against ``ops/sift.py::dense_sift_plain`` within the golden
envelope (max <= 2.0 quantization levels, mean <= 0.15), and on a card an
image with one NaN through a two-sided contraction, whose non-finite
outputs must be exactly ``kernels.banded_live_reach``; ``fv_moments``'
Fisher vector against its plain version's (<= 1e-3); the quantized
``LinearMapper`` through ``apply_dataset`` at (512, 1024, 100): argmax
agreement and max relative error against float32 (bf16 >= 0.999, <=
0.02; int8 >= 0.98, <= 0.03) and its one-item apply against the batch
(<= 1e-4). On the CPU each kernel's wrapper runs its plain version, so the
gates hold trivially there.

The reference's gate of the band products at reduced MXU precision
against full precision has no counterpart: the port's band products run
true float32 (on the card, FMAs in the banded kernel).
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Dict

import numpy as np
import torch

from . import device_ms, device_name, fence

N_IMGS, SMALL_N_IMGS = 16, 4
H, W = 480, 640
SMALL_HW = (160, 160)
STEP, BIN, NSCALES, SSTEP = 4, 6, 5, 1
DESC_DIM, VOCAB = 64, 16
THRESHOLD = 1e-2
STAGES = ("smooth", "orient", "sample", "norm", "pca", "fv")

#: the golden envelope of quantized descriptors
ENVELOPE_MAX, ENVELOPE_MEAN = 2.0, 0.15
PREFIX_TOL, FV_TOL, ITEM_TOL = 1e-4, 1e-3, 1e-4
#: weight type -> (least argmax agreement, largest relative error)
QUANT_BARS = {"bf16": (0.999, 0.02), "int8": (0.98, 0.03)}


def scale_plan():
    """(step, bin size, lower bound) of each scale."""
    from ..ops import sift as S

    return [S._scale_params(sc, STEP, BIN, NSCALES, SSTEP)
            for sc in range(NSCALES)]


def _hw(hw):
    return (H, W) if hw is None else hw


# -- the stages, one image and one scale at a time --------------------------

def _smooth(img, bs, hw=None):
    from ..ops import sift as S
    from ..ops.kernels import banded_matmul

    h, w = _hw(hw)
    return banded_matmul(S._smooth_band(h, bs), img,
                         right=S._smooth_band(w, bs))


def _sample(omaps, st, bs, lo, hw=None):
    """(8, NBP * ny, NBP * nx) keypoint-major bins, and (ny, nx)."""
    from ..ops import sift as S
    from ..ops.kernels import banded_matmul

    h, w = _hw(hw)
    Ty, ny = S._sampling_operator_interleaved(h, lo, st, bs)
    Tx, nx = S._sampling_operator_interleaved(w, lo, st, bs)
    if ny == 0 or nx == 0:
        return None, (ny, nx)
    return banded_matmul(Ty, omaps, right=Tx), (ny, nx)


def _norm(bins, ny, nx, device):
    from ..ops import sift as S

    if bins is None:
        return torch.zeros((S.DIMS, 0), device=device)
    b5 = bins.reshape(S.NBO, ny, S.NBP, nx, S.NBP).permute(0, 2, 1, 4, 3)
    return S._normalize_quantize_binned(b5)


def _pca(desc, pca):
    return pca @ (torch.sign(desc) * torch.sqrt(torch.abs(desc)))


def _fv(proj, gmm, terms=None):
    from ..nodes.images.fisher_vector import _fisher_vector
    from ..ops.kernels import fv_moments

    moments = fv_moments if terms is None else functools.partial(
        fv_moments, terms=terms)
    out = _fisher_vector(proj, *gmm, THRESHOLD, moments=moments).reshape(-1)
    out = out / torch.clamp_min(torch.linalg.norm(out), 2.2e-16)
    out = torch.sign(out) * torch.sqrt(torch.abs(out))
    return out / torch.clamp_min(torch.linalg.norm(out), 2.2e-16)


def prefix_fn(depth, pca=None, gmm=None, hw=None):
    """The featurizer cut after ``depth`` stages (1 smooth ... 6 fv), as a
    function of one (H, W) image: a scalar sum for depths 1-3 (as the
    reference's prefixes), the (128, N) descriptors at 4, the (64, N)
    projection at 5, the normalized Fisher vector at 6."""
    from ..ops import sift as S

    plan = scale_plan()

    def one(img):
        per_scale = []
        for st, bs, lo in plan:
            sm = _smooth(img, bs, hw)
            if depth == 1:
                per_scale.append(sm.sum())
                continue
            om = S._orientation_maps(sm)
            if depth == 2:
                per_scale.append(om.sum())
                continue
            bins, (ny, nx) = _sample(om, st, bs, lo, hw)
            if depth == 3:
                per_scale.append(torch.zeros((), device=img.device)
                                 if bins is None else bins.sum())
                continue
            per_scale.append(_norm(bins, ny, nx, img.device))
        if depth <= 3:
            return torch.stack(per_scale).sum()
        desc = torch.cat(per_scale, dim=1)
        if depth == 4:
            return desc
        proj = _pca(desc, pca)
        if depth == 5:
            return proj
        return _fv(proj, gmm)

    return one


# -- the stages over the batch ------------------------------------------------

def _stage_fns(imgs, pca, gmm, terms, hw):
    """fn(inputs) -> outputs for each of ``STAGES`` over the batch; the
    per-scale stages keep a list of images, each a list of scales."""
    from ..ops import sift as S

    plan = scale_plan()
    dev = imgs[0].device
    return [
        lambda _: [[_smooth(img, bs, hw) for _, bs, _ in plan]
                   for img in imgs],
        lambda sms: [[S._orientation_maps(sm) for sm in per] for per in sms],
        lambda oms: [[_sample(om, st, bs, lo, hw)
                      for om, (st, bs, lo) in zip(per, plan)]
                     for per in oms],
        lambda bins: [torch.cat([_norm(b, ny, nx, dev)
                                 for b, (ny, nx) in per], dim=1)
                      for per in bins],
        lambda descs: [_pca(d, pca) for d in descs],
        lambda projs: [_fv(p, gmm, terms) for p in projs],
    ]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(fn, dev):
    """(host wall ms of one ``fn()``, its result, the kernel launches it
    made), the card synchronized on both sides."""
    from ..ops import kernels

    kernels.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    return wall, out, {k: v for k, v in kernels.LAUNCHES.items() if v}


def _timed(label, fn, dev, n_imgs, graph=True):
    """Warm ``fn`` once, then its host wall, launches, device ms (a card
    only, and only where ``fn`` can be captured in a CUDA graph:
    ``graph``) and idle share; prints one line and returns the
    readings."""
    fn()
    wall, out, launches = _wall_ms(fn, dev)
    dev_ms = device_ms(fn, reps=1) if dev.type == "cuda" and graph \
        else None
    idle = None if dev_ms is None else 1.0 - dev_ms / wall
    shown = (f"device {dev_ms:9.3f} ms" if dev_ms is not None else
             "device not measured (" + ("CPU" if dev.type != "cuda" else
                                       "not capturable") + ")")
    print(f"  {label:8s}: {shown}, host wall {wall:9.3f} ms "
          f"({wall / n_imgs:.3f} ms an image), idle share "
          f"{'n/a' if idle is None else f'{idle:.3f}'}, launches "
          f"{launches}", flush=True)
    return {"stage": label, "device_ms": dev_ms, "wall_ms": wall,
            "launches": launches, "idle": idle}, out


def _inputs(n_imgs, hw, dev, seed=0):
    """Seeded images in [0, 1) and the PCA and GMM, made on the host with
    numpy as the reference's tool makes them, then moved."""
    h, w = hw
    rng = np.random.RandomState(seed)
    imgs = torch.as_tensor(rng.rand(n_imgs, h, w).astype(np.float32),
                           device=dev)
    pca = torch.as_tensor(rng.randn(DESC_DIM, 128).astype(np.float32)
                          / 11.3, device=dev)
    gmm = tuple(torch.as_tensor(a, device=dev) for a in (
        rng.randn(DESC_DIM, VOCAB).astype(np.float32),
        (0.5 + rng.rand(DESC_DIM, VOCAB)).astype(np.float32),
        (np.ones(VOCAB) / VOCAB).astype(np.float32)))
    return rng, imgs, pca, gmm


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def run(n_imgs: int, hw, device, batch64: bool = True) -> Dict:
    """The profile and the gates at ``n_imgs`` images of ``hw`` on
    ``device``. Returns each stage's readings, the whole chain's, the
    gates' and every kernel launch the run made (``launches``)."""
    from ..nodes.images.extractors import LCSExtractor
    from ..ops import kernels

    dev = torch.device(device)
    h, w = hw
    print(f"device: {device_name(dev)}; batch {n_imgs} {h}x{w}, step {STEP} "
          f"bin {BIN} scales {NSCALES}(+{SSTEP})", flush=True)
    rng, imgs, pca, gmm = _inputs(n_imgs, hw, dev)
    terms = kernels.fv_terms(*gmm)
    images = list(imgs)
    total: Dict[str, int] = {}
    stages = []
    value = None
    for name, fn in zip(STAGES, _stage_fns(images, pca, gmm, terms, hw)):
        reading, value = _timed(name, functools.partial(fn, value), dev,
                                n_imgs)
        _add(total, reading["launches"])
        stages.append(reading)
    wall = sum(s["wall_ms"] for s in stages)
    dev_sum = (None if dev.type != "cuda"
               else sum(s["device_ms"] for s in stages))
    print(f"stages summed: host wall {wall:.3f} ms, device "
          f"{'not measured' if dev_sum is None else f'{dev_sum:.3f} ms'}",
          flush=True)

    one = prefix_fn(6, pca, gmm, hw)
    chain, _ = _timed("chain", lambda: [one(img) for img in images], dev,
                      n_imgs)
    _add(total, chain["launches"])
    per_image = chain["wall_ms"] / n_imgs
    print(f"full featurize: {per_image:.3f} ms/img = "
          f"{1e3 / per_image:.1f} img/s", flush=True)

    if batch64 and n_imgs != 64:
        imgs64 = torch.as_tensor(rng.rand(64, h, w).astype(np.float32),
                                 device=dev)
        b64, _ = _timed("batch 64", lambda: [one(img) for img in imgs64],
                        dev, 64)
        _add(total, b64["launches"])
        ms64 = b64["wall_ms"] / 64
        print(f"batch 64: {ms64:.3f} ms/img = {1e3 / ms64:.1f} img/s "
              f"({100.0 * per_image / ms64 - 100.0:+.1f}% vs batch "
              f"{n_imgs})", flush=True)
        del imgs64

    lcs = LCSExtractor()
    imgs_rgb = torch.as_tensor(rng.rand(n_imgs, h, w, 3).astype(np.float32),
                               device=dev)
    fence(imgs_rgb)
    # LCS copies its keypoint offsets to the device in each apply, which a
    # CUDA graph cannot capture: its wall alone
    lcs_reading, _ = _timed("lcs", lambda: [lcs.apply(img)
                                            for img in imgs_rgb], dev, n_imgs,
                            graph=False)
    _add(total, lcs_reading["launches"])
    print(f"LCS whole: {lcs_reading['wall_ms'] / n_imgs:.3f} ms/img = "
          f"{1e3 * n_imgs / lcs_reading['wall_ms']:.1f} img/s", flush=True)

    kernels.reset_launches()
    gates = kernel_gates(imgs, pca, gmm, hw)
    _add(total, {k: v for k, v in kernels.LAUNCHES.items() if v})
    return {"stages": stages, "chain": chain, "gates": gates,
            "launches": total}


# -- the gates ----------------------------------------------------------------

def _production(img, pca, gmm):
    """The production chain: ``SIFTExtractor`` -> signed square root and
    PCA -> the Fisher vector with its GMM terms computed per call."""
    from ..nodes.images.extractors import SIFTExtractor

    d = SIFTExtractor(step=STEP, bin_size=BIN, num_scales=NSCALES,
                      scale_step=SSTEP).apply(img)
    return _fv(_pca(d, pca), gmm)


def kernel_gates(imgs, pca, gmm, hw=None) -> Dict:
    """Each kernel of the path against its plain version on this device,
    asserted (see the module docstring). Returns the readings."""
    from ..nodes.images.fisher_vector import _fisher_vector
    from ..nodes.learning.linear import LinearMapper
    from ..ops import kernels
    from ..ops import sift as S
    from ..parallel.dataset import ArrayDataset

    dev = imgs.device
    h, w = _hw(hw)
    out = {}
    two = imgs[:2]

    one = prefix_fn(6, pca, gmm, hw)
    a = torch.stack([one(g) for g in two])
    b = torch.stack([_production(g, pca, gmm) for g in two])
    out["prefix6"] = float((a - b).abs().max())
    print(f"parity prefix-6 vs production: max abs delta "
          f"{out['prefix6']:.2e} (<= {PREFIX_TOL})", flush=True)
    assert out["prefix6"] <= PREFIX_TOL, out["prefix6"]

    banded = torch.stack([S.dense_sift(g, STEP, BIN, NSCALES, SSTEP)
                          for g in two])
    plain = torch.stack([S.dense_sift_plain(g, STEP, BIN, NSCALES, SSTEP)
                         for g in two])
    diff = (banded - plain).abs()
    out["banded_max"], out["banded_mean"] = (float(diff.max()),
                                             float(diff.mean()))
    print(f"banded-kernel parity vs dense_sift_plain: max "
          f"{out['banded_max']:.3f} mean {out['banded_mean']:.4f} "
          f"(envelope: max <= {ENVELOPE_MAX}, mean <= {ENVELOPE_MEAN})",
          flush=True)
    assert bool(torch.isfinite(banded).all())
    assert out["banded_max"] <= ENVELOPE_MAX, out["banded_max"]
    assert out["banded_mean"] <= ENVELOPE_MEAN, out["banded_mean"]
    if dev.type == "cuda":
        # the kernels' reach of a NaN is their live ranges' (C16), inside
        # the plain version's whole columns
        _, bs, _ = scale_plan()[0]
        left, right = S._smooth_band(h, bs), S._smooth_band(w, bs)
        X = imgs[:1].clone()
        X[0, h // 3, w // 3] = float("nan")
        got = ~torch.isfinite(kernels.banded_matmul(left, X, right=right))
        reach = kernels.banded_live_reach(left, X, right=right)
        wide = ~torch.isfinite(kernels.banded_matmul_plain(left, X,
                                                           right=right))
        out["nan"] = {"kernel": int(got.sum()), "reach": int(reach.sum()),
                      "plain": int(wide.sum())}
        print(f"banded-kernel NaN reach: kernel {out['nan']['kernel']}, "
              f"live-range reach {out['nan']['reach']}, plain "
              f"{out['nan']['plain']} non-finite outputs", flush=True)
        assert torch.equal(got, reach) and out["nan"]["kernel"] > 0
        assert not bool((got & ~wide).any())

    rng = np.random.RandomState(7)
    proj = torch.as_tensor(rng.randn(DESC_DIM, 2048).astype(np.float32),
                           device=dev)
    fused = _fisher_vector(proj, *gmm, THRESHOLD)
    split = _fisher_vector(proj, *gmm, THRESHOLD,
                           moments=kernels.fv_moments_plain)
    err = (fused - split).abs()
    out["fv_max"] = float(err.max())
    print(f"fv_moments FV parity vs plain: max {out['fv_max']:.2e} mean "
          f"{float(err.mean()):.2e} (<= {FV_TOL})", flush=True)
    assert out["fv_max"] <= FV_TOL, out["fv_max"]

    # the quantized apply through apply_dataset, the batch dispatch that
    # reaches the kernel, at the rehearsal solve's shape
    n, d, k = 512, 1024, 100
    X = rng.randn(n, d).astype(np.float32)
    Wt = rng.randn(d, k).astype(np.float32) / np.sqrt(d)
    bias = rng.randn(k).astype(np.float32) * 0.01
    ds = ArrayDataset.from_numpy(X, dev)
    f32 = LinearMapper(Wt, intercept=bias).apply_dataset(ds).data[:n]
    for dtype, (min_agree, max_rel) in QUANT_BARS.items():
        q = LinearMapper(Wt, intercept=bias, weight_dtype=dtype)
        got = q.apply_dataset(ds).data[:n]
        agree = float((f32.argmax(1) == got.argmax(1)).float().mean())
        rel = float((got - f32).abs().max() / f32.abs().max())
        item = q.apply(ds.data[0])
        item_delta = float((item - got[0]).abs().max())
        out[f"quant_{dtype}"] = {"agree": agree, "rel": rel,
                                 "item": item_delta}
        print(f"quantized predict {dtype} (apply_dataset dispatch): argmax "
              f"agreement {agree:.4f} (>= {min_agree}), max rel err "
              f"{rel:.4f} (<= {max_rel}), item-vs-batch {item_delta:.2e} "
              f"(<= {ITEM_TOL})", flush=True)
        assert agree >= min_agree, (dtype, agree)
        assert rel <= max_rel, (dtype, rel)
        assert item_delta <= ITEM_TOL, (dtype, item_delta)
    return out


def main(argv=None) -> int:
    from ..ops.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help=f"{SMALL_N_IMGS} images of {SMALL_HW[0]} x "
                         f"{SMALL_HW[1]}")
    ap.add_argument("--images", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_imgs = args.images or (SMALL_N_IMGS if args.small else N_IMGS)
    run(n_imgs, SMALL_HW if args.small else (H, W), dev,
        batch64=not args.small)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
