"""Dense multi-scale SIFT.

Counterpart of ``keystone_tpu/ops/sift.py`` (the reference's VLFeat JNI
kernel, ``cpp/VLFeat.cxx``), vl_phow-style: for each scale s, bin size
``bin + 2 s``; Gaussian smoothing (sigma = bin size / 6); gradient
magnitude soft-assigned to 8 orientation bins; 4 x 4 spatial bins with
bilinear (triangle) weighting, sampled on the keypoint grid; L2
normalize, clamp at 0.2, renormalize, zero descriptors under the
contrast threshold, quantize to min(512 v, 255). Descriptors of all
scales are concatenated scale-major as a (128, numDesc) matrix.

The smoothing and the binning + sampling are band matrices built on the
host (numpy, ``lru_cache``d per shape). On a CUDA image both band
contractions of a scale go through ``ops.kernels.banded_matmul`` (the
two-sided CUDA kernel, two launches a scale); on a CPU image the einsum
form runs, the plain path, as the JAX package runs it off the TPU. The
band operators and their keypoint-major interleaving are copied from
the JAX package.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .kernels import banded_matmul

NBP = 4          # spatial bins per side
NBO = 8          # orientation bins
DIMS = NBP * NBP * NBO  # 128
MAGNIF = 6.0
CONTRAST_THRESHOLD = 0.005


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Separable Gaussian taps (vl_imsmooth uses radius ceil(4 sigma))."""
    if sigma < 1e-8:
        return np.ones(1, np.float32)
    radius = int(math.ceil(4.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _triangle_kernel(bin_size: int) -> np.ndarray:
    """Bilinear spatial weighting window: w(t) = max(0, 1 - |t|/binSize)
    over the 2*binSize-1 support (the SIFT spatial interpolation)."""
    t = np.arange(-(bin_size - 1), bin_size, dtype=np.float64)
    k = np.maximum(0.0, 1.0 - np.abs(t) / bin_size)
    return k.astype(np.float32)


def _orientation_maps(smoothed: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (NBO, H, W) gradient magnitude soft-assigned to
    orientation bins (linear interpolation in angle, as vl_dsift).
    ``torch.gradient`` takes one-sided differences at the edges, as
    ``jnp.gradient`` does; ``torch.remainder`` is the floor modulo of
    ``%``."""
    gy, gx = torch.gradient(smoothed)
    mag = torch.sqrt(gx * gx + gy * gy)
    angle = torch.remainder(torch.atan2(gy, gx), 2.0 * math.pi)
    a = angle * (NBO / (2.0 * math.pi))  # in [0, NBO)
    lo = torch.floor(a)
    frac = a - lo
    lo_bin = torch.remainder(lo.to(torch.int32), NBO)
    hi_bin = torch.remainder(lo_bin + 1, NBO)
    o = torch.arange(NBO, dtype=torch.int32, device=smoothed.device)[
        :, None, None]
    w = torch.where(lo_bin == o, 1.0 - frac, 0.0) + torch.where(
        hi_bin == o, frac, 0.0)
    return mag * w


def _keypoint_grid(dim: int, lo: int, hi: int, step: int,
                   extent: float) -> np.ndarray:
    """Descriptor-center coordinates along one axis: vl_dsift places
    descriptor bounding boxes starting at ``lo`` with the given step; the
    center is offset by half the descriptor extent."""
    half = extent / 2.0
    first = lo + half
    last = hi - half
    if last < first:
        return np.zeros(0, np.float64)
    count = int((last - first) // step) + 1
    return first + step * np.arange(count, dtype=np.float64)


@functools.lru_cache(maxsize=128)
def _smooth_band(length: int, bin_size: int) -> np.ndarray:
    """(L, L) band matrix applying the edge-padded Gaussian along one
    axis."""
    k = gaussian_kernel(bin_size / MAGNIF).astype(np.float64)
    r = (len(k) - 1) // 2
    G = np.zeros((length, length), np.float64)
    rows = np.arange(length)
    for t, w in enumerate(k):
        cols = np.clip(rows + t - r, 0, length - 1)
        np.add.at(G, (rows, cols), w)
    return G.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _sampling_operator(length: int, lo: int, step: int,
                       bin_size: int) -> Tuple[np.ndarray, int]:
    """(NBP*n, L) operator folding, along one axis, the triangle
    (bilinear spatial binning) convolution, the shared fractional offset
    of the regular keypoint grid, and the strided descriptor sampling
    into one band matrix: row (b, i) holds the weights producing spatial
    bin b of the descriptor centered at keypoint i (bin-major rows)."""
    extent = float(bin_size * NBP)
    centers = _keypoint_grid(length, lo, length - 1, step, extent)
    offs = (np.arange(NBP) - (NBP - 1) / 2.0) * bin_size
    n = len(centers)
    if n == 0:
        return np.zeros((0, length), np.float32), 0
    tri = _triangle_kernel(bin_size).astype(np.float64)
    r = bin_size - 1
    frac = float((centers[0] + offs[0]) % 1.0)
    shifts = [(0, 1.0)] if frac == 0.0 else [(0, 1.0 - frac), (1, frac)]
    T = np.zeros((NBP * n, length), np.float64)
    idx = np.arange(n)
    for b, off in enumerate(offs):
        p0 = int(math.floor(centers[0] + off))
        pos = p0 + idx * step                      # integer sample rows
        for ds, w in shifts:
            q = np.minimum(pos + ds, length - 1)
            for t, tw in enumerate(tri):
                cols = np.clip(q + t - r, 0, length - 1)
                np.add.at(T, (b * n + idx, cols), w * tw)
    return T.astype(np.float32), n


@functools.lru_cache(maxsize=128)
def _sampling_operator_interleaved(length: int, lo: int, step: int,
                                   bin_size: int) -> Tuple[np.ndarray, int]:
    """Row-permuted :func:`_sampling_operator` for the banded kernel: rows
    ordered keypoint-major (``i * NBP + b``) instead of bin-major (``b * n
    + i``), so a tile of consecutive rows covers a narrow contiguous
    column range (keypoints advance ``step`` columns, the NBP bins of one
    keypoint differ by ``bin_size``)."""
    T, n = _sampling_operator(length, lo, step, bin_size)
    if n == 0:
        return T, 0
    Ti = np.ascontiguousarray(
        T.reshape(NBP, n, length).transpose(1, 0, 2).reshape(
            NBP * n, length))
    return Ti, n


def _on(band: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(band, device=device)


def _dsift_one_scale_einsum(img, height, width, step, bin_size, lo):
    """Dense SIFT at one scale in the einsum form, the plain path (the JAX
    package's ``_dsift_one_scale`` off the TPU): the dense band operators
    as two contractions. Returns (128, numDesc)."""
    dev = img.device
    Gy = _on(_smooth_band(height, bin_size), dev)
    Gx = _on(_smooth_band(width, bin_size), dev)
    smoothed = torch.einsum("ih,hw,jw->ij", Gy, img, Gx)
    omaps = _orientation_maps(smoothed)            # (8, H, W)
    Ty, ny = _sampling_operator(height, lo, step, bin_size)
    Tx, nx = _sampling_operator(width, lo, step, bin_size)
    if ny == 0 or nx == 0:
        return torch.zeros((DIMS, 0), dtype=smoothed.dtype, device=dev)
    # (8, NBP*ny, NBP*nx): spatial bin (by, bx) of descriptor (iy, ix)
    bins = torch.einsum("ph,ohw,qw->opq", _on(Ty, dev), omaps, _on(Tx, dev))
    return _normalize_quantize_binned(bins.reshape(NBO, NBP, ny, NBP, nx))


def _dsift_one_scale_banded(img, height, width, step, bin_size, lo):
    """Dense SIFT at one scale through the banded kernel: the same two
    two-sided band contractions as the einsum form (smooth both axes, then
    bin + sample both axes of the 8 orientation maps), each one
    ``banded_matmul(left, X, right=...)`` launch whose intermediate stays
    in shared memory. The sampling operators use the
    keypoint-major row order; the final reshape and permute (a view)
    restore the bin-major (o, by, iy, bx, ix) layout the normalizer reads,
    as the JAX package's ``_dsift_one_scale_banded`` does."""
    smoothed = banded_matmul(_smooth_band(height, bin_size), img,
                             right=_smooth_band(width, bin_size))
    omaps = _orientation_maps(smoothed)            # (8, H, W)

    Ty, ny = _sampling_operator_interleaved(height, lo, step, bin_size)
    Tx, nx = _sampling_operator_interleaved(width, lo, step, bin_size)
    if ny == 0 or nx == 0:
        return torch.zeros((DIMS, 0), dtype=smoothed.dtype,
                           device=img.device)
    bins = banded_matmul(Ty, omaps, right=Tx)      # (8, NBP*ny, NBP*nx)
    # keypoint-major rows (i*NBP + b) -> the (o, by, iy, bx, ix) layout
    b5 = bins.reshape(NBO, ny, NBP, nx, NBP).permute(0, 2, 1, 4, 3)
    return _normalize_quantize_binned(b5)


def _normalize_quantize_binned(b5: torch.Tensor) -> torch.Tensor:
    """SIFT normalization in the (o, by, ny, bx, nx) layout: L2
    normalize, clamp at 0.2, renormalize; zero descriptors whose
    pre-normalization norm per unit bin mass is under the contrast
    threshold; quantize to min(512 v, 255) without rounding. Emits the
    (128, ny*nx) column-per-descriptor matrix, (by, bx, o)-major."""
    _, _, ny, _, nx = b5.shape
    norm = torch.sqrt(torch.sum(b5 * b5, dim=(0, 1, 3)))      # (ny, nx)
    bcast = (None, None, slice(None), None, slice(None))
    d = torch.clamp_max(b5 / torch.clamp_min(norm, 1e-12)[bcast], 0.2)
    norm2 = torch.clamp_min(torch.sqrt(torch.sum(d * d, dim=(0, 1, 3))),
                            1e-12)
    d = d / norm2[bcast]
    area = NBP * NBP
    d = torch.where((norm / area < CONTRAST_THRESHOLD)[bcast], 0.0, d)
    d = torch.clamp_max(512.0 * d, 255.0)
    return d.permute(1, 3, 0, 2, 4).reshape(DIMS, ny * nx)


def _scale_params(scale: int, step: int, bin_size: int, num_scales: int,
                  scale_step: int) -> Tuple[int, int, int]:
    """(step, bin size, lower bound) at one scale: the per-scale setup of
    ``getMultiScaleDSIFTs_f`` (VLFeat.cxx)."""
    scale_value = bin_size + 2 * scale
    lo = max((1 + num_scales * 2) - scale * 3, 0)
    return step + scale * scale_step, scale_value, lo


def _dense_sift(img_gray, step, bin_size, num_scales, scale_step, one_scale):
    img = img_gray.to(torch.float32).contiguous()
    height, width = int(img.shape[0]), int(img.shape[1])
    outs: List[torch.Tensor] = []
    for scale in range(num_scales):
        s, scale_value, lo = _scale_params(
            scale, step, bin_size, num_scales, scale_step)
        outs.append(one_scale(img, height, width, s, scale_value, lo))
    return torch.cat(outs, dim=1)  # (128, N)


def dense_sift(img_gray: torch.Tensor, step: int = 4, bin_size: int = 6,
               num_scales: int = 5, scale_step: int = 0, *,
               kernel_mode: Optional[str] = None) -> torch.Tensor:
    """Multi-scale dense SIFT of a grayscale (H, W) image in [0, 1].
    Returns (128, numDesc) float32, scales concatenated in order.
    ``kernel_mode`` picks the band products: ``"banded"`` the banded
    CUDA kernel (2 launches a scale, at every image size; a CPU or meta
    image raises), ``"einsum"`` the plain form on any device, None by
    the image's device: the kernel for a CUDA image, the einsum form for
    a CPU one (a meta image too: the static analyzer's shapes)."""
    on_host = img_gray.device.type in ("cpu", "meta")
    if kernel_mode is None:
        kernel_mode = "einsum" if on_host else "banded"
    if kernel_mode == "einsum":
        return dense_sift_plain(img_gray, step, bin_size, num_scales,
                                scale_step)
    if kernel_mode != "banded":
        raise ValueError(f"kernel_mode must be 'banded', 'einsum' or None, "
                         f"got {kernel_mode!r}")
    if on_host:
        raise ValueError(
            "kernel_mode='banded' runs the banded CUDA kernel and needs a "
            f"CUDA image, got one on {img_gray.device.type!r}")
    return _dense_sift(img_gray, step, bin_size, num_scales, scale_step,
                       _dsift_one_scale_banded)


def dense_sift_plain(img_gray: torch.Tensor, step: int = 4,
                     bin_size: int = 6, num_scales: int = 5,
                     scale_step: int = 0) -> torch.Tensor:
    """:func:`dense_sift` in the einsum form on any device, without the
    banded kernel: the plain path the kernel path is held against."""
    return _dense_sift(img_gray, step, bin_size, num_scales, scale_step,
                       _dsift_one_scale_einsum)


def sift_descriptor_count(
    height: int, width: int,
    step: int = 4, bin_size: int = 6,
    num_scales: int = 5, scale_step: int = 0,
) -> int:
    """Static descriptor count for shape planning."""
    total = 0
    for scale in range(num_scales):
        s, scale_value, lo = _scale_params(
            scale, step, bin_size, num_scales, scale_step)
        extent = scale_value * NBP
        ys = _keypoint_grid(height, lo, height - 1, s, extent)
        xs = _keypoint_grid(width, lo, width - 1, s, extent)
        total += len(ys) * len(xs)
    return total
