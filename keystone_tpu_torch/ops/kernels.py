"""Hand-written Hopper kernels, their builds, wrappers and plain versions.

Each kernel is CUDA C++ under ``keystone_tpu_torch/csrc/``, compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry point
and loaded with ``ctypes``. Libraries are built on first use into
``build/keystone_tpu_torch/`` at the root of the checkout, named by a
hash of their source, so a changed source is rebuilt. Nothing is built
or imported at module import time: the CPU tests import this module on
machines without ``nvcc``.

Dispatch rule, per wrapper: a tensor on the CPU goes to the kernel's
plain PyTorch version, which computes the same function step by step; a
tensor on a CUDA device launches the kernel, or raises. There is no
fallback from a failed build or launch, and a shape the kernel does not
take raises.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run can
reset it and read it back to show the path went through the kernels. A
call made while the current stream captures a CUDA graph only records
the launch into the graph, where each replay runs it: it is counted in
``CAPTURED`` instead (``serving/graphs.py`` counts the replays).

Kernels (Pallas TPU kernel replaced -> file here):

* ``fused_cifar_featurize`` (``keystone_tpu/ops/pallas_kernels.py::
  fused_cifar_featurize``) -> ``csrc/fused_featurize.cu``.
* ``gram_cross`` (``keystone_tpu/ops/pallas_kernels.py::
  gram_cross_pallas``) -> ``csrc/gram_cross.cu``.
* ``quantized_affine`` (``keystone_tpu/ops/pallas_kernels.py::
  quantized_affine_pallas``) -> ``csrc/quantized_affine.cu``.
* ``banded_matmul`` (``keystone_tpu/ops/pallas_kernels.py::
  banded_matmul_pallas``) -> ``csrc/banded_matmul.cu``.
* ``fv_moments`` (``keystone_tpu/ops/pallas_kernels.py::
  fv_moments_pallas``) -> ``csrc/fv_moments.cu``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import work
from .image_ops import patch_matrix, patch_stats, pool_image, pool_regions

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "keystone_tpu_torch"

#: kernel library name -> CUDA source under csrc/
SOURCES = {"fused_featurize": "fused_featurize.cu",
           "gram_cross": "gram_cross.cu",
           "quantized_affine": "quantized_affine.cu",
           "banded_matmul": "banded_matmul.cu",
           "fv_moments": "fv_moments.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: wrapper name -> launches made by that wrapper
LAUNCHES: Dict[str, int] = {"fused_cifar_featurize": 0, "gram_cross": 0,
                            "quantized_affine": 0, "banded_matmul": 0,
                            "fv_moments": 0}

#: wrapper name -> launches recorded into CUDA graphs under capture
CAPTURED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

#: wrapper name -> the work of the launches in ``LAUNCHES``: FLOPs and
#: bytes summed from each launch's shapes (``ops/work.py``); the traced
#: run's per-node MFU reads them (``observability/utilization.py``)
WORK: Dict[str, Dict[str, float]] = {
    name: {"flops": 0.0, "bytes": 0.0} for name in LAUNCHES}

_LIBS: Dict[str, ctypes.CDLL] = {}


#: devices whose tensors take a wrapper's plain version: the CPU, and the
#: meta device, whose tensors carry only a shape and a dtype (the static
#: analyzer's shape inference); a CUDA tensor launches the kernel
PLAIN_DEVICES = ("cpu", "meta")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        WORK[name] = {"flops": 0.0, "bytes": 0.0}


def _count_launch(name: str, flops: float, nbytes: float) -> None:
    """One launch by ``name``'s wrapper, of ``flops`` and ``nbytes``
    (``ops/work.py``): in ``LAUNCHES`` and ``WORK`` when it runs now, in
    ``CAPTURED`` when the stream is capturing a graph."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1
        work = WORK[name]
        work["flops"] += float(flops)
        work["bytes"] += float(nbytes)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC_DIR / SOURCES[name]).read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel libraries that are not built yet, one
    ``nvcc`` per source, all started together. Returns each compiled
    library's compiler output (``-Xptxas -v``: registers, shared memory,
    spills); raises if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_kernels([name])
        lib = ctypes.CDLL(str(path))
        _declare(name, lib)
        _LIBS[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    if name == "fused_featurize":
        lib.fused_cifar_featurize_f32.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, p]
        lib.fused_cifar_featurize_f32.restype = i
        lib.fused_featurize_smem_bytes.argtypes = [i, i, i, i, i]
        lib.fused_featurize_smem_bytes.restype = ll
        lib.fused_featurize_image_pitch.argtypes = [i, i]
        lib.fused_featurize_image_pitch.restype = i
        lib.fused_featurize_geometry.argtypes = [ctypes.POINTER(i)] * 3
        lib.fused_featurize_geometry.restype = None
        geo = [i() for _ in range(3)]
        lib.fused_featurize_geometry(*geo)
        got = tuple(v.value for v in geo)
        want = (FEATURIZE_TILE, FEATURIZE_CHUNK, FEATURIZE_KREG)
        if got != want:
            raise RuntimeError(f"fused_featurize: the library's geometry "
                               f"{got} is not the wrapper's {want}")
    elif name == "gram_cross":
        lib.gram_cross_f32.argtypes = [p, p, p, p, i, i, i, ll, ll, p]
        lib.gram_cross_f32.restype = i
        lib.gram_cross_slab_rows.argtypes = []
        lib.gram_cross_slab_rows.restype = i
    elif name == "quantized_affine":
        for fn in (lib.quantized_affine_bf16, lib.quantized_affine_int8):
            fn.argtypes = [p, ll, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
            fn.restype = i
        lib.quantized_affine_geometry.argtypes = [ctypes.POINTER(i)] * 5
        lib.quantized_affine_geometry.restype = None
        geo = [i() for _ in range(5)]
        lib.quantized_affine_geometry(*geo)
        got = tuple(v.value for v in geo)
        want = (QUANT_ROWS, QUANT_SLAB, QUANT_MAX_SPLITS, QUANT_KMAX,
                QUANT_BLOCKS_PER_SM)
        if got != want:
            raise RuntimeError(f"quantized_affine: the library's geometry "
                               f"{got} is not the wrapper's {want}")
    elif name == "banded_matmul":
        lib.banded_matmul_f32.argtypes = [p, p, p, p, ll, p, i, i, i, p]
        lib.banded_matmul_f32.restype = i
        lib.banded_matmul_tile_rows.argtypes = []
        lib.banded_matmul_tile_rows.restype = i
        lib.banded_matmul_group_rows.argtypes = []
        lib.banded_matmul_group_rows.restype = i
        lib.banded2_matmul_f32.argtypes = [p, p, p, p, ll, ll, p, i, i, i,
                                           i, i, i, i, p]
        lib.banded2_matmul_f32.restype = i
    elif name == "fv_moments":
        lib.fv_moments_f32.argtypes = [p, ll, p, p, p, p, p, p, i, i, i, f,
                                       p]
        lib.fv_moments_f32.restype = i
        lib.fv_moments_scratch_floats.argtypes = [i, i, i]
        lib.fv_moments_scratch_floats.restype = ll


# -- fused CIFAR featurization ---------------------------------------------

def _featurize_terms(filters, whitener_means):
    """fsum[k] = sum_f filters[k, f] and bias[k] = filters[k] . means:
    small per-filter vectors, computed outside the kernel."""
    fsum = filters.sum(dim=1)
    if whitener_means is None:
        bias = torch.zeros_like(fsum)
    else:
        bias = filters @ whitener_means.to(filters)
    return fsum, bias


def fused_cifar_featurize_plain(imgs, filters, img_size=32, patch_size=6,
                                channels=3, pool_stride=13, pool_size=14,
                                var_constant=10.0, alpha=0.25,
                                whitener_means=None):
    """The plain PyTorch version of the fused kernel, step by step:
    im2col (unfold), the patch-by-filter matmul, per-patch statistics,
    symmetric rectification, then the region sums. Images (B, H, W, C),
    filters (K, S*S*C) in (dy, dx, c) order -> (B, R*2K) features,
    region-major, K pos then K neg values per region."""
    B = imgs.shape[0]
    S = patch_size
    patches = patch_matrix(imgs, S)                    # (B, OH, OW, F)
    raw = patches @ filters.T                          # (B, OH, OW, K)
    m, sd = patch_stats(patches, var_constant)
    fsum, bias = _featurize_terms(filters, whitener_means)
    conv = (raw - m[..., None] * fsum) / sd[..., None] - bias
    rect = torch.cat([torch.clamp_min(conv - alpha, 0.0),
                      torch.clamp_min(-conv - alpha, 0.0)], dim=-1)
    pooled = pool_image(rect, pool_stride, pool_size, "identity", "sum")
    return pooled.reshape(B, -1)


#: the featurize kernel's filters a tile, patches a chunk and k-steps of 8
#: depths held in registers (``csrc/fused_featurize.cu``; the library's
#: ``fused_featurize_geometry`` is checked against them when it loads)
FEATURIZE_TILE, FEATURIZE_CHUNK, FEATURIZE_KREG = 128, 64, 14

#: launches of the featurize kernel's two instantiations: ``registers``
#: (a patch depth up to 8 * FEATURIZE_KREG, every filter fragment held in
#: registers: the main path's 6 x 6 x 3) and ``streamed`` (deeper
#: patches, the further k-steps' fragments read from the plan each chunk);
#: counted, like ``LAUNCHES``, outside graph capture
FEATURIZE_VARIANTS: Dict[str, int] = {"registers": 0, "streamed": 0}

#: (img_size, channels, patch_size, pool_stride, pool_size, device index)
#: -> _FeaturizeGeometry, the least recently used entry dropped beyond
#: _GEOMETRIES_KEPT
_GEOMETRIES: "OrderedDict[Tuple[int, ...], _FeaturizeGeometry]" = \
    OrderedDict()
_GEOMETRIES_KEPT = 64


class _FeaturizeGeometry(NamedTuple):
    cols: torch.Tensor  # int32 (staged columns, 4): featurize_columns
    nry: int            # regions along a row
    R: int              # regions
    hits: int           # patch memberships of the regions


def region_map(dim: int, pool_stride: int, pool_size: int):
    """Per index of one axis of the patch grid, the pooling regions along
    that axis holding it, as ``(first, count)`` int arrays: the regions
    (``image_ops.pool_regions``) are sorted by both ends, so the ones
    holding an index are consecutive."""
    ranges = pool_regions(dim, pool_stride, pool_size)
    first = np.zeros(dim, np.int32)
    count = np.zeros(dim, np.int32)
    for i in range(dim):
        hits = [r for r, (lo, hi) in enumerate(ranges) if lo <= i < hi]
        if hits:
            first[i], count[i] = hits[0], len(hits)
    return first, count


def featurize_columns(OH: int, OW: int, pool_stride: int, pool_size: int,
                      row: int, channels: int,
                      chunk: int = FEATURIZE_CHUNK) -> np.ndarray:
    """The featurize kernel's column table: the order in which it stages
    the patches (row-major over the OH x OW grid) and pools them. Patches
    are sorted, stably, by their pooling class (the row and column region
    sets from the per-row and per-column region maps, each packed as
    ``first | count << 16``; a count of 0: in no region), so each class is
    one run of columns, and padded with empty columns to a multiple of
    ``chunk`` (a multiple of 32). Four int32 a column: the patch's offset
    in an image whose rows are ``row`` values and pixels ``channels``
    values (-1 for a padding column); at the class's last column its row
    and column sets (elsewhere -1, 0); and at every 32nd column the bits
    of the class ends among its 32 columns (bit i: column + i), else 0."""
    rows = region_map(OH, pool_stride, pool_size)
    cols = region_map(OW, pool_stride, pool_size)
    P = OH * OW
    ry = rows[0] | rows[1] << 16
    rx = cols[0] | cols[1] << 16
    py, px = np.divmod(np.arange(P), OW)
    # the class key of each patch, then the patch: a stable sort
    order = np.lexsort((np.arange(P), rx[px], ry[py]))
    Pp = -(-P // chunk) * chunk
    table = np.zeros((Pp, 4), np.int32)
    table[:, 0] = -1
    table[:, 1] = -1
    table[:P, 0] = py[order] * row + px[order] * channels
    key_y, key_x = ry[py[order]], rx[px[order]]
    last = np.ones(P, bool)
    last[:-1] = (key_y[1:] != key_y[:-1]) | (key_x[1:] != key_x[:-1])
    table[:P, 1] = np.where(last, key_y, -1)
    table[:P, 2] = np.where(last, key_x, 0)
    ends = np.zeros(Pp, np.int64)
    ends[:P] = last
    words = (ends.reshape(-1, 32) << np.arange(32)).sum(axis=1)
    table[::32, 3] = words.astype(np.uint32).view(np.int32)
    return table


def _featurize_geometry_on(img_size, channels, patch_size, pool_stride,
                           pool_size, imgs):
    """The column table of a geometry on ``imgs``' device, cached per
    geometry and device; raises where an image's staged form does not fit
    one block's shared memory."""
    key = (img_size, channels, patch_size, pool_stride, pool_size,
           imgs.get_device())
    hit = _GEOMETRIES.get(key)
    if hit is not None:
        _GEOMETRIES.move_to_end(key)
        return hit
    lib = _library("fused_featurize")
    out_dim = img_size - patch_size + 1
    ranges = pool_regions(out_dim, pool_stride, pool_size)
    nry = len(ranges)
    R = nry * nry
    smem = lib.fused_featurize_smem_bytes(img_size, img_size, channels,
                                          patch_size, R)
    if smem > 232448:
        raise ValueError(f"fused_cifar_featurize: the staged image needs "
                         f"{smem} bytes of shared memory, above the 227 KB "
                         "a block may use")
    # the patches' offsets in the image as the kernel stages it, rows
    # fused_featurize_image_pitch floats apart
    pitch = lib.fused_featurize_image_pitch(img_size, channels)
    hit = _FeaturizeGeometry(torch.as_tensor(
        featurize_columns(out_dim, out_dim, pool_stride, pool_size, pitch,
                          channels),
        device=imgs.device), nry, R, sum(hi - lo for lo, hi in ranges) ** 2)
    _GEOMETRIES[key] = hit
    if len(_GEOMETRIES) > _GEOMETRIES_KEPT:
        _GEOMETRIES.popitem(last=False)
    return hit


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` ~ big + small, both TF32 (the low 13 mantissa bits
    clear): big by truncation, small = x - big (exact) rounded to nearest,
    ties away from zero, so |x - big - small| <= 2^-21 |x|."""
    bits = x.contiguous().view(torch.int32)
    big = (bits & -8192).view(torch.float32)
    rest = (x - big).view(torch.int32)
    small = ((rest + 0x1000) & -8192).view(torch.float32)
    return big, small


def featurize_ksteps(F: int) -> int:
    """k-steps of 8 depths the featurize kernel's product takes for a
    patch of F values: at least the FEATURIZE_KREG held in registers."""
    return max(FEATURIZE_KREG, -(-F // 8))


def featurize_fragments(filters: torch.Tensor) -> torch.Tensor:
    """A filter bank (K, F) split into TF32 parts (:func:`split_tf32`) and
    laid out as the featurize kernel's consumer threads hold their wgmma
    A fragments: float32 (T, 2, ks, 4, 32, 8), T = ceil(K / 128) tiles of
    two warpgroups, ks = :func:`featurize_ksteps` (F) k-steps, 4 warps, 32
    lanes and, per lane (g = lane // 4, t = lane % 4), big then small of
    a0 = (filter 64 wg + 16 warp + g, depth 8 k + t), a1 = (filter + 8,
    the same depth), a2 = (filter, depth + 4), a3 = (filter + 8, depth +
    4) within the tile; zero past K and past F."""
    K, F = filters.shape
    T = max(-(-K // FEATURIZE_TILE), 1)
    ks = featurize_ksteps(F)
    padded = torch.zeros((T * FEATURIZE_TILE, 8 * ks), dtype=torch.float32,
                         device=filters.device)
    padded[:K, :F] = filters
    parts = []
    for part in split_tf32(padded):
        # filter = (((T, wg, warp, h, g)), depth = (k, d, t); a_i, i = 2 d + h
        v = part.view(T, 2, 4, 2, 8, ks, 2, 4)
        parts.append(v.permute(0, 1, 5, 2, 4, 7, 6, 3).reshape(
            T, 2, ks, 4, 32, 4))
    return torch.cat(parts, dim=-1).contiguous()


class FeaturizePlan(NamedTuple):
    """A filter bank's terms as the featurize kernel reads them, made once
    per fitted model and device (on a CUDA device,
    ``FusedConvRectifyPool.apply_params`` holds this plan in the filters'
    place, so the bank lives on the card once): the filters split into
    TF32 parts in the kernel's fragment order (:func:`featurize_fragments`),
    the bias of the whitener means padded with zeros to the fragments' Kp
    filters, the filters' count K and their depth F."""
    frags: torch.Tensor
    bias: torch.Tensor
    K: int
    F: int = -1


def featurize_plan(filters, whitener_means=None) -> Optional[FeaturizePlan]:
    """The featurize kernel's plan of a filter bank (K, F) on its device:
    a :class:`FeaturizePlan` on a CUDA device, None on the CPU."""
    if filters.device.type != "cuda":
        return None
    K, F = filters.shape
    frags = featurize_fragments(filters.float())
    _, bias = _featurize_terms(filters, whitener_means)
    padded = torch.zeros(frags.shape[0] * FEATURIZE_TILE,
                         dtype=torch.float32, device=filters.device)
    padded[:K] = bias
    return FeaturizePlan(frags, padded, K, F)


def fused_cifar_featurize(imgs, filters, img_size=32, patch_size=6,
                          channels=3, pool_stride=13, pool_size=14,
                          var_constant=10.0, alpha=0.25,
                          whitener_means=None):
    """Fused Convolver(normalize) >> SymmetricRectifier >> Pooler(sum) >>
    vectorize over a batch of images (B, H, W, C) with filters
    (K, S*S*C): CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Every patch size, channel count and pooling geometry is
    taken, up to an image whose staged form (a chunk buffer of split
    patches, two copies of the image, its box sums and per-patch
    statistics, the region sums)
    exceeds one block's shared memory. For CUDA images ``filters`` may
    be the bank's :class:`FeaturizePlan` instead (:func:`featurize_plan`,
    made once per model and device: the node's apply params there),
    which holds the whitener means' bias, so ``whitener_means`` is then
    None; from a filter tensor a CUDA call makes the plan itself."""
    F = patch_size * patch_size * channels
    if isinstance(filters, FeaturizePlan):
        plan = filters
        if whitener_means is not None:
            raise ValueError("fused_cifar_featurize: a FeaturizePlan holds "
                             "the whitener means' bias; pass no means")
        if imgs.device.type != "cuda" or plan.F != F \
                or plan.frags.device != imgs.device:
            raise ValueError("fused_cifar_featurize: the plan is not of (K, "
                             f"{F}) filters on the CUDA images' device")
    elif imgs.device.type in PLAIN_DEVICES:
        return fused_cifar_featurize_plain(
            imgs, filters, img_size, patch_size, channels, pool_stride,
            pool_size, var_constant, alpha, whitener_means)
    elif imgs.device.type != "cuda":
        raise ValueError(f"fused_cifar_featurize: unsupported device "
                         f"{imgs.device}")
    else:
        if filters.dim() != 2 or filters.shape[1] != F:
            raise ValueError(f"fused_cifar_featurize: filters "
                             f"{tuple(filters.shape)} are not (K, {F})")
        if filters.dtype != torch.float32 or not filters.is_contiguous() \
                or filters.device != imgs.device:
            raise ValueError("fused_cifar_featurize: filters must be "
                             "contiguous float32 on the images' device")
        plan = featurize_plan(filters, whitener_means)
    if imgs.dim() != 4 or tuple(imgs.shape[1:]) != (
            img_size, img_size, channels):
        raise ValueError(f"fused_cifar_featurize: images {tuple(imgs.shape)} "
                         f"are not (B, {img_size}, {img_size}, {channels})")
    if imgs.dtype != torch.float32 or not imgs.is_contiguous():
        raise ValueError("fused_cifar_featurize: images must be contiguous "
                         "float32")
    geo = _featurize_geometry_on(img_size, channels, patch_size,
                                 pool_stride, pool_size, imgs)
    B, K = imgs.shape[0], plan.K
    out = torch.empty((B, geo.R * 2 * K), dtype=torch.float32,
                      device=imgs.device)
    if B == 0 or K == 0 or geo.R == 0:
        return out.zero_()
    lib = _library("fused_featurize")
    with _on_device(imgs.device):
        rc = lib.fused_cifar_featurize_f32(
            imgs.data_ptr(), plan.frags.data_ptr(), plan.bias.data_ptr(),
            geo.cols.data_ptr(), out.data_ptr(), B, img_size, img_size,
            channels, patch_size, K, plan.frags.shape[0] * FEATURIZE_TILE,
            geo.nry, geo.R, float(var_constant), float(alpha),
            _current_stream(imgs))
    if rc != 0:
        raise RuntimeError(f"fused_cifar_featurize: CUDA error {rc} at launch")
    product, rest, nbytes = work.featurize_work(
        B, K, P=(img_size - patch_size + 1) ** 2, F=F, R=geo.R,
        region_hits=geo.hits, pixels=img_size * img_size * channels)
    _count_launch("fused_cifar_featurize", product + rest, nbytes)
    if not torch.cuda.is_current_stream_capturing():
        FEATURIZE_VARIANTS["streamed" if featurize_ksteps(F) > FEATURIZE_KREG
                           else "registers"] += 1
    return out


# -- fused Gram / cross products -------------------------------------------

def _gram_operands(X, Y, G, C):
    """Integer X and Y promoted to float32 (a uint8 chunk must not wrap
    its products mod 256, as ``pallas_kernels.py::gram_cross`` promotes),
    and zeroed G (d, d) and C (d, k) where none are given."""
    if not torch.is_floating_point(X):
        X = X.to(torch.float32)
    if not torch.is_floating_point(Y):
        Y = Y.to(torch.float32)
    if X.dim() != 2 or Y.dim() != 2 or X.shape[0] != Y.shape[0]:
        raise ValueError(f"gram_cross: X {tuple(X.shape)} and Y "
                         f"{tuple(Y.shape)} are not (n, d) and (n, k)")
    d, k = X.shape[1], Y.shape[1]
    if G is None:
        G = torch.zeros((d, d), dtype=torch.float32, device=X.device)
    if C is None:
        C = torch.zeros((d, k), dtype=torch.float32, device=X.device)
    if tuple(G.shape) != (d, d) or tuple(C.shape) != (d, k):
        raise ValueError(f"gram_cross: carry G {tuple(G.shape)}, C "
                         f"{tuple(C.shape)} is not ({d}, {d}), ({d}, {k})")
    return X, Y, G, C


def gram_cross_plain(X, Y, G=None, C=None):
    """The plain PyTorch version of the Gram kernel: G += X^T X and
    C += X^T Y as two matrix products, in place (zeroed G and C when none
    are given). Returns ``(G, C)``."""
    X, Y, G, C = _gram_operands(X, Y, G, C)
    G.addmm_(X.T, X)
    C.addmm_(X.T, Y)
    return G, C


def gram_cross(X, Y, G=None, C=None):
    """Fused ``G += X^T X``, ``C += X^T Y`` in one pass over the rows of
    X (n, d) and Y (n, k), in place on the float32 carry (zeroed G and C
    when none are given); returns ``(G, C)``. CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Integer inputs are
    promoted to float32 first. The kernel computes the upper triangle of
    X^T X and mirrors it, so G stays exactly symmetric when it starts
    so; its products run in 3xTF32 on the tensor cores (the precision
    rule of ``ops/device.py``)."""
    X, Y, G, C = _gram_operands(X, Y, G, C)
    if X.device.type in PLAIN_DEVICES:
        return gram_cross_plain(X, Y, G, C)
    if X.device.type != "cuda":
        raise ValueError(f"gram_cross: unsupported device {X.device}")
    for name, t in (("X", X), ("Y", Y)):
        if t.dtype != torch.float32 or t.device != X.device or (
                t.numel() and (t.stride(1) != 1
                               or t.stride(0) < t.shape[1])):
            raise ValueError(f"gram_cross: {name} must be float32 rows "
                             "with unit column stride on X's device")
    for name, t in (("G", G), ("C", C)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != X.device:
            raise ValueError(f"gram_cross: {name} must be contiguous "
                             "float32 on X's device")
    n, d = X.shape
    k = Y.shape[1]
    if n == 0 or d == 0:
        return G, C
    lib = _library("gram_cross")
    with torch.cuda.device(X.device):
        rc = lib.gram_cross_f32(
            X.data_ptr(), Y.data_ptr(), G.data_ptr(), C.data_ptr(), n, d, k,
            X.stride(0), Y.stride(0) if k else 0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gram_cross: CUDA error {rc} at launch")
    _count_launch("gram_cross", *work.gram_work(n, d, k))
    return G, C


def gram_slab_rows() -> int:
    """Rows of X the Gram kernel sums on the tensor cores before adding
    them, rounded, into its float32 total, as the built library reports
    it."""
    return _library("gram_cross").gram_cross_slab_rows()


# -- quantized affine apply --------------------------------------------------

#: the kernel's fixed geometry (``csrc/quantized_affine.cu``): rows a
#: block, slab depth along d, blocks of a cluster along d, widest column
#: tile, and blocks an SM holds; the library's own report is checked
#: against them when it loads
QUANT_ROWS, QUANT_SLAB, QUANT_MAX_SPLITS, QUANT_KMAX = 16, 256, 8, 16
QUANT_BLOCKS_PER_SM = 2

_QUANT_ENTRY = {torch.bfloat16: "quantized_affine_bf16",
                torch.int8: "quantized_affine_int8"}

_SM_COUNT: Dict[int, int] = {}


def _quant_operands(X, Wq, scale, mean, inv_std, b):
    """Shapes and types of the quantized apply, checked the same way for
    the kernel and its plain version."""
    if X.dim() != 2 or Wq.dim() != 2 or X.shape[1] != Wq.shape[0]:
        raise ValueError(f"quantized_affine: X {tuple(X.shape)} and Wq "
                         f"{tuple(Wq.shape)} are not (n, d) and (d, k)")
    if Wq.dtype not in _QUANT_ENTRY:
        raise ValueError(f"quantized_affine: Wq is {Wq.dtype}; bfloat16 or "
                         "int8 weights are taken")
    d, k = Wq.shape
    for name, v, size in (("scale", scale, k), ("mean", mean, d),
                          ("inv_std", inv_std, d), ("b", b, k)):
        if tuple(v.shape) != (size,):
            raise ValueError(f"quantized_affine: {name} {tuple(v.shape)} is "
                             f"not ({size},)")


def quantized_affine_plain(X, Wq, scale, mean, inv_std, b):
    """The plain PyTorch version of the quantized apply: dequantize the
    weights (``float(Wq) * scale`` per column), then the float32 affine
    ``((X - mean) * inv_std) @ W + b``."""
    _quant_operands(X, Wq, scale, mean, inv_std, b)
    W = Wq.to(torch.float32) * scale[None, :]
    return ((X - mean) * inv_std) @ W + b


def quant_columns(k: int) -> Tuple[int, int]:
    """``(kc, ctiles)``: the kernel's column variant for k output columns
    (k rounded up to even, at most 16) and the column tiles of that
    width that cover k."""
    kc = min(k + (k & 1), QUANT_KMAX)
    return kc, -(-k // kc)


def quant_split(n: int, d: int, k: int, sms: int) -> Tuple[int, int]:
    """``(splits, dsplit)``: how the kernel cuts d across the blocks of a
    cluster for a batch of n rows. The grid has ceil(n / 16) x ctiles row
    and column tiles; with S splits each block takes ceil(slabs / S)
    256-deep slabs, and the card holds QUANT_BLOCKS_PER_SM blocks an SM.
    S (at most 8, at most the slab count) minimizes the waves of blocks
    times the slabs a block takes, the smaller S on a tie; then every
    split holds at least one slab, dsplit = slabs a split x 256."""
    slabs = max(-(-d // QUANT_SLAB), 1)
    tiles = -(-n // QUANT_ROWS) * quant_columns(k)[1]
    res = QUANT_BLOCKS_PER_SM * sms
    best = min(range(1, min(QUANT_MAX_SPLITS, slabs) + 1),
               key=lambda s: (-(-tiles * s // res) * -(-slabs // s), s))
    sps = -(-slabs // best)
    return -(-slabs // sps), sps * QUANT_SLAB


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


class QuantPlan:
    """A quantized model's launch plan on one CUDA device, made once per
    fitted model and device (on a CUDA device, a quantized mapper's
    ``apply_params`` is this plan alone, so the model's weights live on
    the card once): the weights laid out as the kernel reads them,
    (ctiles, dpad, kc) at their narrow width, zero past d and k, mean and
    inv_std padded to dpad, scale and b, the column variant kc, the SM
    count, the library entry and the device pointers, and the d splits
    per batch size. A call through it pays the shape checks of X and one
    ctypes call."""

    def __init__(self, Wq, scale, mean, inv_std, b):
        d, k = Wq.shape
        dev = Wq.device
        self.d, self.k, self.device = d, k, dev
        self.kc, ctiles = quant_columns(k)
        self.dpad = max(-(-d // QUANT_SLAB), 1) * QUANT_SLAB
        Wt = torch.zeros((self.dpad, ctiles * self.kc), dtype=Wq.dtype,
                         device=dev)
        Wt[:d, :k] = Wq
        self.Wt = Wt.view(self.dpad, ctiles, self.kc).transpose(0, 1) \
            .contiguous()
        pad = torch.zeros((2, self.dpad), dtype=torch.float32, device=dev)
        pad[0, :d] = mean
        pad[1, :d] = inv_std
        self.mean, self.inv = pad[0], pad[1]
        self.scale = scale.to(torch.float32).contiguous()
        self.b = b.to(torch.float32).contiguous()
        self.sms = _sm_count(dev)
        self.entry = getattr(_library("quantized_affine"),
                             _QUANT_ENTRY[Wq.dtype])
        self.ptrs = (self.Wt.data_ptr(), self.scale.data_ptr(),
                     self.mean.data_ptr(), self.inv.data_ptr(),
                     self.b.data_ptr())
        self._splits: Dict[int, Tuple[int, int]] = {}

    def split(self, n: int) -> Tuple[int, int]:
        """``(splits, slabs a split)`` for a batch of n rows, memoized."""
        hit = self._splits.get(n)
        if hit is None:
            splits, dsplit = quant_split(n, self.d, self.k, self.sms)
            hit = self._splits[n] = (splits, dsplit // QUANT_SLAB)
        return hit


def quant_plan(Wq, scale, mean, inv_std, b) -> Optional[QuantPlan]:
    """The launch plan of a quantized model on its weights' device: a
    :class:`QuantPlan` on a CUDA device, None on the CPU (where the plain
    version runs). The operands are checked once here."""
    if Wq.device.type != "cuda":
        return None
    X = torch.empty((0, Wq.shape[0]), device="meta")
    _quant_operands(X, Wq, scale, mean, inv_std, b)
    for name, t in (("Wq", Wq), ("scale", scale), ("mean", mean),
                    ("inv_std", inv_std), ("b", b)):
        if not t.is_contiguous() or t.device != Wq.device or (
                name != "Wq" and t.dtype != torch.float32):
            raise ValueError(f"quantized_affine: {name} must be contiguous "
                             "(float32 for the vectors) on X's device")
    return QuantPlan(Wq, scale, mean, inv_std, b)


def quantized_affine(X, *params):
    """``((X - mean) * inv_std) @ (float(Wq) * scale) + b`` for X (n, d)
    float32 and Wq (d, k) bfloat16 or int8 with per-column float32
    scales, accumulated in float32: the CUDA kernel (one launch) for CUDA
    tensors, the plain version for CPU tensors. Every shape is taken. X
    may be a row slice (unit column stride). ``params`` is either the
    five operands ``(Wq, scale, mean, inv_std, b)``, from which a CUDA
    call lays out the weights itself on every call, or, for a CUDA X,
    the model's :class:`QuantPlan` alone (:func:`quant_plan`, made once
    per model and device: a quantized mapper's apply params there)."""
    if len(params) == 1 and isinstance(params[0], QuantPlan):
        plan = params[0]
        if X.dim() != 2 or X.shape[1] != plan.d:
            raise ValueError(f"quantized_affine: X {tuple(X.shape)} is not "
                             f"(n, {plan.d})")
    elif len(params) == 5:
        if X.device.type in PLAIN_DEVICES:
            return quantized_affine_plain(X, *params)
        if X.device.type != "cuda":
            raise ValueError(f"quantized_affine: unsupported device "
                             f"{X.device}")
        _quant_operands(X, *params)
        if params[0].device != X.device:
            raise ValueError("quantized_affine: Wq must be on X's device")
        plan = quant_plan(*params)
    else:
        raise TypeError("quantized_affine: params are (Wq, scale, mean, "
                        "inv_std, b) or a QuantPlan")
    if X.dtype != torch.float32 or X.device != plan.device or (
            X.numel() and (X.stride(1) != 1 or X.stride(0) < X.shape[1])):
        raise ValueError("quantized_affine: X must be float32 rows with "
                         "unit column stride on the weights' device")
    n, d = X.shape
    k = plan.k
    if n == 0 or k == 0:
        return torch.empty((n, k), dtype=torch.float32, device=X.device)
    if d == 0:
        return plan.b.expand(n, k).clone()
    splits, sps = plan.split(n)
    out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    with _on_device(X.device):
        rc = plan.entry(X.data_ptr(), X.stride(0), *plan.ptrs,
                        out.data_ptr(), n, d, k, plan.kc, plan.dpad, splits,
                        sps, _current_stream(X))
    if rc != 0:
        raise RuntimeError(f"quantized_affine: CUDA error {rc} at launch")
    _count_launch("quantized_affine", *work.quant_work(
        n, d, k, plan.Wt.element_size()))
    return out


# -- banded matrix products (dense SIFT) -------------------------------------

#: (id(band), id(right), device) -> _BandPair, the least recently used
#: entry dropped beyond _BANDS_KEPT (SIFT makes 10 band pairs an image
#: size). The entry holds the host arrays themselves, so their ids cannot
#: be reused by other arrays while the entry lives.
_BANDS: "OrderedDict[Tuple[int, int, str], _BandPair]" = OrderedDict()
_BANDS_KEPT = 256


class _BandPair(NamedTuple):
    band: np.ndarray
    right: Optional[np.ndarray]
    dense: torch.Tensor                 # band, float32 on the device
    rdense: Optional[torch.Tensor]      # right, float32 on the device
    maps: Optional[torch.Tensor]        # int32 live maps, see banded_matmul
    KL: int                             # widest live range of band
    KR: int                             # widest live range of right
    ptrs: Tuple[int, int, int]          # launch arguments: dense, rdense,
                                        # maps device pointers (0: none)
    nnz: Tuple[int, int]                # nonzeros of band and right


def band_tile_rows() -> int:
    """Rows per tile of the banded kernels' live maps, as the built
    library reports it."""
    return _library("banded_matmul").banded_matmul_tile_rows()


def band_group_rows() -> int:
    """Rows of a band a warp of the two-sided kernel sums over one live
    range (the rows per entry of its group maps), as the built library
    reports it."""
    return _library("banded_matmul").banded_matmul_group_rows()


def band_live_map(band: np.ndarray, tile_rows: int):
    """The banded kernels' live map of a host band matrix (m, l): for each
    ``tile_rows``-row tile, the first and one past the last column holding
    a nonzero in any of the tile's rows, as two int32 arrays ``(klo,
    khi)``. A tile with no nonzero gets the empty range (0, 0). Each tile
    visits one contiguous column range, so no column is visited twice. The
    two-sided product takes the same map of both of its bands."""
    band = np.asarray(band)
    m = band.shape[0]
    tiles = -(-m // tile_rows)
    klo = np.zeros(tiles, np.int32)
    khi = np.zeros(tiles, np.int32)
    for i in range(tiles):
        nz = np.nonzero(np.any(band[i * tile_rows:(i + 1) * tile_rows] != 0,
                               axis=0))[0]
        if len(nz):
            klo[i], khi[i] = nz[0], nz[-1] + 1
    return klo, khi


def _band_pair_on(band: np.ndarray, right: Optional[np.ndarray],
                  device: torch.device, live_map: bool) -> _BandPair:
    """The pair's float32 copies on ``device`` (and, for the kernels, the
    live maps of both bands there and their widest ranges), cached per
    (band id, right id, device)."""
    key = (id(band), id(right), str(device))
    hit = _BANDS.get(key)
    if hit is not None:
        _BANDS.move_to_end(key)
    if hit is None or (live_map and hit.maps is None):
        def on(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)

        maps, widths = None, [0, 0]
        if live_map:
            parts = []
            sides = [a for a in (band, right) if a is not None]
            for side, a in enumerate(sides):
                lo, hi = band_live_map(a, band_tile_rows())
                parts += [lo, hi]
                widths[side] = int((hi - lo).max(initial=0))
            if right is not None:
                parts += [v for a in sides
                          for v in band_live_map(a, band_group_rows())]
            maps = torch.as_tensor(np.concatenate(parts), device=device)
        dense = on(band)
        rdense = None if right is None else on(right)
        ptrs = tuple(0 if t is None else t.data_ptr()
                     for t in (dense, rdense, maps))
        nnz = (int(np.count_nonzero(band)),
               0 if right is None else int(np.count_nonzero(right)))
        hit = _BandPair(band, right, dense, rdense, maps, *widths, ptrs, nnz)
        _BANDS[key] = hit
        if len(_BANDS) > _BANDS_KEPT:
            _BANDS.popitem(last=False)
    return hit


def _band_operands(band, X, right):
    for name, a in (("band", band), ("right", right)):
        if (a is not None or name == "band") and not (
                isinstance(a, np.ndarray) and a.ndim == 2):
            raise ValueError(f"banded_matmul: the {name} must be a 2-D host "
                             "numpy array")
    if right is None:
        if X.dim() != 2 or X.shape[0] != band.shape[1]:
            raise ValueError(f"banded_matmul: band {band.shape} and X "
                             f"{tuple(X.shape)} are not (m, l) and (l, n)")
    elif X.dim() not in (2, 3) or X.shape[-2] != band.shape[1] \
            or X.shape[-1] != right.shape[1]:
        raise ValueError(f"banded_matmul: band {band.shape}, X "
                         f"{tuple(X.shape)} and right {right.shape} are not "
                         "(m, l), ([C,] l, w) and (r, w)")


def banded_matmul_plain(band: np.ndarray, X: torch.Tensor,
                        right: Optional[np.ndarray] = None) -> torch.Tensor:
    """The plain PyTorch version of the banded kernels: the dense products
    ``band @ X`` and, with ``right``, ``band @ X @ right.T``, in float32."""
    _band_operands(band, X, right)
    pair = _band_pair_on(band, right, X.device, live_map=False)
    out = pair.dense @ X.to(torch.float32)
    return out if right is None else out @ pair.rdense.T


def _live_cover(band: np.ndarray, rows: int) -> np.ndarray:
    """(m, l) float32, 1 where column k lies in the live range of row i's
    ``rows``-row tile (:func:`band_live_map`)."""
    klo, khi = band_live_map(band, rows)
    tile = np.arange(band.shape[0]) // rows
    k = np.arange(band.shape[1])
    return ((k >= klo[tile, None]) & (k < khi[tile, None])).astype(
        np.float32)


def banded_live_reach(band: np.ndarray, X: torch.Tensor,
                      right: Optional[np.ndarray] = None,
                      tile_rows: Optional[int] = None,
                      group_rows: Optional[int] = None) -> torch.Tensor:
    """Where a non-finite value of X lands in the banded kernels' output,
    as a bool tensor of its shape: every output whose sum runs over it.
    The kernels, like the TPU kernel's product over each tile's live
    blocks, sum over a whole live range, zero band entries included, and
    0 x NaN is NaN: the one-sided kernel over the range of the output
    row's ``tile_rows``-row tile, the two-sided one over the ranges of
    the ``group_rows``-row groups of both bands' rows (the built
    library's sizes by default). The plain version's dense product sums
    over every column, so its reach is wider: this is what a check of
    the kernels' non-finite outputs holds them to."""
    _band_operands(band, X, right)
    bad = (~torch.isfinite(X)).to(torch.float32)
    if right is None:
        cover = _live_cover(band, tile_rows or band_tile_rows())
        return torch.as_tensor(cover, device=X.device) @ bad > 0
    rows = group_rows or band_group_rows()
    left, cross = (torch.as_tensor(_live_cover(a, rows), device=X.device)
                   for a in (band, right))
    return left @ bad @ cross.T > 0


def banded_matmul(band: np.ndarray, X: torch.Tensor,
                  right: Optional[np.ndarray] = None) -> torch.Tensor:
    """``band @ X`` for a host numpy band matrix (m, l) and X (l, n); with
    a host band ``right`` (r, w) and X (l, w) or (C, l, w), ``band @ X[c]
    @ right.T`` for every channel, shape (m, r) or (C, m, r), in one
    launch. The CUDA kernels for a CUDA X, visiting only the live column
    ranges of each 32-row tile of both bands; the plain version for a CPU
    X. The bands' device copies and live maps are cached per (band id,
    right id, device). X must be float32 with unit column stride (row and
    channel strides are taken; a transposed view is not). The output is a
    contiguous float32 tensor. Every shape is taken."""
    _band_operands(band, X, right)
    if X.device.type in PLAIN_DEVICES:
        return banded_matmul_plain(band, X, right)
    if X.device.type != "cuda":
        raise ValueError(f"banded_matmul: unsupported device {X.device}")
    if X.dtype != torch.float32 or (X.numel() and X.stride(-1) != 1
                                    and X.shape[-1] > 1):
        raise ValueError("banded_matmul: X must be float32 rows with unit "
                         "column stride")
    m, l = band.shape
    w = X.shape[-1]
    r = w if right is None else right.shape[0]
    out = torch.empty((*X.shape[:-2], m, r), dtype=torch.float32,
                      device=X.device)
    if out.numel() == 0:
        return out
    lib = _library("banded_matmul")
    pair = _band_pair_on(band, right, X.device, live_map=True)
    sl = X.stride(-2) if l > 1 else w
    dense, rdense, maps = pair.ptrs
    with _on_device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        if right is None:
            tiles = pair.maps.shape[0] // 2
            rc = lib.banded_matmul_f32(
                dense, maps, maps + 4 * tiles, X.data_ptr(), sl,
                out.data_ptr(), m, l, w, stream)
        else:
            C = X.shape[0] if X.dim() == 3 else 1
            sc = X.stride(0) if C > 1 else l * w
            rc = lib.banded2_matmul_f32(
                dense, rdense, maps, X.data_ptr(), sc, sl, out.data_ptr(), C,
                m, l, r, w, pair.KL, pair.KR, stream)
    if rc != 0:
        raise RuntimeError(f"banded_matmul: CUDA error {rc} at launch")
    if right is None:
        flops, nbytes = 2 * pair.nnz[0] * w, 4 * (l * w + m * w)
    else:
        flops, nbytes = work.banded_call_work(pair.nnz[0], m, pair.nnz[1], r,
                                              C, l, w)
    _count_launch("banded_matmul", flops, nbytes)
    return out


def _current_stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, as
    ``torch.cuda.current_stream(dev).cuda_stream`` gives it, without
    making a Stream object (a few microseconds of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _on_device(device: torch.device):
    """``torch.cuda.device(device)`` where it is not the current device
    already, else a no-op context (the common case costs no switch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


# -- fused GMM posteriors + Fisher-vector moments ---------------------------

class FVTerms(NamedTuple):
    """The fitted-GMM terms the FV kernel reads: a per-row center g (D,),
    A = 0.5 / var and B = (means - g) / var (D, K), and the per-component
    constants c (K,) of the centered means, so that the log-likelihood of
    a descriptor x is ``c + (x - g) . B - (x - g)^2 . A``."""
    center: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor


def fv_terms(means, variances, weights) -> FVTerms:
    """The kernel's terms of a diagonal GMM (means and variances (D, K),
    weights (K,)), on their device: computed once per fitted model and
    device (``FisherVector.apply_params``). The center g is the mean of
    the component means, which shrinks the terms the llh product adds and
    cancels (a column of PCA'd SIFT runs to the hundreds); the llh is the
    same function of x as ``nodes.learning.gmm._llh``."""
    D = means.shape[0]
    center = means.mean(dim=1)
    mc = means - center[:, None]
    c = (-0.5 * D * math.log(2.0 * math.pi)
         - 0.5 * torch.log(variances).sum(dim=0) + torch.log(weights)
         - 0.5 * (mc * mc / variances).sum(dim=0))
    return FVTerms(*(t.contiguous() for t in (
        center, 0.5 / variances, mc / variances, c)))


def _fv_operands(X, means, variances, weights):
    if X.dim() != 2 or means.dim() != 2 or means.shape != variances.shape \
            or means.shape[0] != X.shape[0] or weights.dim() != 1 \
            or weights.shape[0] != means.shape[1]:
        raise ValueError(
            f"fv_moments: X {tuple(X.shape)}, means {tuple(means.shape)}, "
            f"variances {tuple(variances.shape)}, weights "
            f"{tuple(weights.shape)} are not (D, n), (D, K), (D, K), (K,)")


def fv_moments_plain(X, means, variances, weights, threshold):
    """The plain PyTorch version of the FV moments kernel: the thresholded
    posterior matrix q (n, K) of ``nodes.learning.gmm._posteriors``
    written out, then ``(q.sum(0), X @ q, (X * X) @ q)``."""
    from ..nodes.learning.gmm import _posteriors

    _fv_operands(X, means, variances, weights)
    q = _posteriors(X.T, means.T, variances.T, weights, threshold)
    return q.sum(dim=0), X @ q, (X * X) @ q


def fv_moments(X, means, variances, weights, threshold, terms=None):
    """Moment SUMS ``(s0, s1, s2)`` = ``(sum q, X q, (X * X) q)`` of the
    thresholded GMM posteriors q of the descriptor columns of X (D, n),
    for means and variances (D, K) and weights (K,): the CUDA kernel for
    a CUDA X (the (n, K) posteriors never reach device memory; one launch
    and its block-order reduce, and a first launch of the per-column
    softmax statistics where K is past the llh tile), the plain version
    for a CPU X. The
    caller divides by n. ``terms`` is :func:`fv_terms` of the GMM,
    computed here when not given. X must be float32 with unit column
    stride; the GMM tensors float32 on X's device."""
    _fv_operands(X, means, variances, weights)
    if X.device.type in PLAIN_DEVICES:
        return fv_moments_plain(X, means, variances, weights, threshold)
    if X.device.type != "cuda":
        raise ValueError(f"fv_moments: unsupported device {X.device}")
    D, n = X.shape
    K = means.shape[1]
    if X.dtype != torch.float32 or (X.numel() and X.stride(1) != 1
                                    and n > 1):
        raise ValueError("fv_moments: X must be float32 rows with unit "
                         "column stride")
    for name, t in (("means", means), ("variances", variances),
                    ("weights", weights)):
        if t.dtype != torch.float32 or t.device != X.device:
            raise ValueError(f"fv_moments: {name} must be float32 on X's "
                             "device")
    empty = n == 0 or K == 0 or D == 0
    out = (torch.zeros if empty else torch.empty)(
        K + 2 * D * K, dtype=torch.float32, device=X.device)
    s0, s1, s2 = (out[:K], out[K:K + D * K].view(D, K),
                  out[K + D * K:].view(D, K))
    if empty:
        return s0, s1, s2
    lib = _library("fv_moments")
    if terms is None:
        terms = fv_terms(means, variances, weights)
    elif terms.A.shape != means.shape or any(
            t.device != X.device or t.dtype != torch.float32
            or not t.is_contiguous() for t in terms):
        raise ValueError("fv_moments: terms must be fv_terms of the GMM, "
                         "contiguous float32 on X's device")
    ldx = X.stride(0) if D > 1 else n
    with _on_device(X.device):
        # the library plans the launch; the wrapper allocates its scratch
        scratch = lib.fv_moments_scratch_floats(D, n, K)
        if scratch < 0:
            raise ValueError(f"fv_moments: no launch plan for D={D}, K={K}")
        partial = torch.empty(scratch, dtype=torch.float32, device=X.device)
        rc = lib.fv_moments_f32(
            X.data_ptr(), ldx, terms.center.data_ptr(), terms.A.data_ptr(),
            terms.B.data_ptr(), terms.c.data_ptr(), out.data_ptr(),
            partial.data_ptr(), D, n, K, float(threshold),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fv_moments: CUDA error {rc} at launch")
    _count_launch("fv_moments", *work.fv_work(D, K, n))
    return s0, s1, s2
