// Fused CIFAR featurization for Hopper (sm_90a): per image, patch
// normalization -> filter-bank product -> symmetric rectification ->
// overlapping sum-pooling, writing only the pooled (R, 2K) features.
//
// Replaces keystone_tpu/ops/pallas_kernels.py::fused_cifar_featurize
// (the Pallas TPU kernel _fused_featurize_kernel and its wrapper). The
// plain PyTorch version of the same function is
// keystone_tpu_torch/ops/kernels.py::fused_cifar_featurize_plain.
//
// What bounds it. Per 32x32x3 image and K filters the work is about
// 2 * 729 * 108 * K FLOP (the patch-by-filter product; statistics,
// rectification and pooling are O(729 * K)), against 12 KB of image
// read and 2 * R * K * 4 bytes of output written. At K = 1024 that is
// 161 MFLOP per 44 KB: about 3,700 FLOP per byte, far above the card's
// ridge point, so the kernel is bound by arithmetic, and by the
// instructions that feed it.
//
// What the design does about it.
//  * The product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8:
//    each operand v split into big = tf32(v) and small = tf32(v - big)
//    by a bit mask, a product taken as small*big + big*small + big*big
//    with float32 accumulation), on patches centered on their own mean as
//    they are staged. Centering makes the product (x - m) . f =
//    raw - m fsum directly, without the plain version's cancellation, and
//    keeps the TF32 parts small; against float64 the kernel's pooled
//    features are no worse than the float32 plain version's (held by
//    chip_smoke.py). A float32 CUDA-core product of the same structure
//    ran at 5.6-5.9 ms at B = K = 1024 (PERF.md).
//  * Persistent blocks, two an SM: the (filter tile, image) items are cut
//    into one contiguous run a block, filter tile major, so a block
//    stages its tile of KT = 128 filters (F x KT, from the filters laid
//    out (F, K) once per model by the wrapper) once or twice in all, and
//    walks its images, read through L1 (each value serves up to S * S
//    patches). Two blocks an SM let one block's statistics, im2col,
//    epilogue and pooling run beside the other's product.
//  * Per image, every patch's mean and 1 / sd first; then chunks of PC =
//    64 patches: the chunk's centered patches written transposed (F x PC)
//    into shared memory (im2col in shared memory, never in device
//    memory), then the product, a warp taking 32 patches x 32 filters.
//    Filter and patch tiles have their columns swizzled by row so that
//    the fragment reads hit 32 banks.
//  * The epilogue, once a chunk: conv = product / sd - bias, staged in
//    shared memory over the patch chunk; then each thread owns one
//    filter's column over one half of the chunk and walks its patches in
//    order, summing both signs' rectified values; where a run of patches
//    that share their pooling regions ends (runs are cut at the half), it
//    adds the sums to its half's copy of the region sums in shared
//    memory; the copies are added in order per image. The runs' ends
//    come from a table the wrapper builds
//    once per geometry from the per-row and per-column region maps (one
//    entry a patch, staged in shared memory once a launch), so the walk
//    has no loop bounds that depend on the data, and its loads go 8
//    patches ahead of the sums. Any region count is taken; the region
//    sums are part of the staged form of an image.
//  * The patch size S and the channel count C are runtime values: the
//    kernel reads an image row of S * C values per patch row, so one
//    instantiation takes every geometry whose staged form fits one
//    block's shared memory.
//  * Every sum is taken in a fixed order (the products over features in
//    the mma's order, the statistics per patch, the pooling over runs in
//    patch order), with no atomics, so results are bit-reproducible.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int KT = 128;  // filters a block: 4 warp columns of 32
constexpr int PC = 64;   // patches a chunk: 2 warp rows of 32
constexpr int CS = KT + 8;  // padded row of the conv tile
constexpr int FQ = NTHREADS / PC;  // im2col: threads a patch
constexpr int PH = NTHREADS / KT;  // pool: halves of a chunk's patches
constexpr int RUN_CUT = PC / PH;   // runs end at multiples of it
constexpr int SMEM_LIMIT = 232448;  // bytes a block may use (227 KB)
static_assert(RUN_CUT % 8 == 0, "the pooling walk loads 8 patches at a time");

// v ~ big + small, both TF32: the low 13 mantissa bits cleared (a bit
// mask, where cvt.rna.tf32 runs at the conversion unit's quarter rate);
// v - big is exact, so only small's truncation is lost (2^-20 of v)
// max(v, 0) that keeps a NaN, as jnp.maximum and torch.clamp_min do:
// fmaxf returns its non-NaN operand, which would turn a NaN convolution
// value into a finite 0 and hide a poisoned image from every check
// downstream.
__device__ inline float relu_nan(float v) {
  return (v > 0.0f || v != v) ? v : 0.0f;
}

__device__ inline void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

__device__ inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the two cross terms first, then big * big
__device__ inline void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                  const uint32_t (&as)[4], uint32_t bb0,
                                  uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// patches of the (H - S + 1) x (W - S + 1) grid, rounded up to chunks
__host__ __device__ inline int padded_patches(int H, int W, int S) {
  return ((H - S + 1) * (W - S + 1) + PC - 1) / PC * PC;
}

// Shared layout (floats): [filters F8 x KT][im2col F8 x PC, or conv PC x
// CS][bias KT][mean, 1/sd: 2 a patch][region sums PH x R x 2 x KT][run
// ends: 2 ints a patch]; F8 is F rounded up to the mma depth of 8
__host__ __device__ inline long long smem_floats(int H, int W, int C, int S,
                                                 int R) {
  const long long F8 = ((long long)S * S * C + 7) / 8 * 8;
  const long long ac = F8 * PC > PC * CS ? F8 * PC : PC * CS;
  return F8 * KT + ac + KT + 4LL * padded_patches(H, W, S) +
         2LL * PH * R * KT;
}

__global__ void __launch_bounds__(NTHREADS, 2)
fused_featurize_kernel(const float* __restrict__ imgs,
                       const float* __restrict__ filt,  // (F, Kp)
                       const float* __restrict__ bias,  // (Kp)
                       const int2* __restrict__ ends,
                       float* __restrict__ out, int B, int H, int W, int C,
                       int S, int K, int Kp, int nry, int R,
                       float var_constant, float alpha) {
  const int F = S * S * C, F8 = (F + 7) / 8 * 8, SC = S * C, row = W * C;
  const int OH = H - S + 1, OW = W - S + 1, P = OH * OW;
  const int nchunks = (P + PC - 1) / PC;
  extern __shared__ float4 smem4[];
  // filters [F8][KT] and patches [F8][PC], each row's columns swizzled by
  // (row & 3) << 3 so that the mma fragment reads hit 32 banks
  float* bs_ = reinterpret_cast<float*>(smem4);
  float* ac = bs_ + F8 * KT;  // [F8][PC] centered patches, then [PC][CS]
  float* bsb = ac + (F8 * PC > PC * CS ? F8 * PC : PC * CS);  // bias [KT]
  float* mr = bsb + KT;             // [patches][2]: mean, 1/sd
  float* racc = mr + 2 * nchunks * PC;  // [PH][R][2][KT]
  int2* ends_s = reinterpret_cast<int2*>(racc + 2 * PH * R * KT);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // mma fragment coordinates
  const int wm = warp % 2, wn = warp / 2;   // the warp's 32 patches, filters
  const int pl = tid % PC, fq = tid / PC;   // im2col: a patch, a quarter of F
  // pool: a filter and a half of the chunk's patches; output: a filter
  // and a sign
  const int kk = tid % KT, h = tid / KT;

  const long long items = (long long)(Kp / KT) * B;
  const long long per = (items + gridDim.x - 1) / gridDim.x;
  const long long beg = blockIdx.x * per;
  const long long end = beg + per < items ? beg + per : items;

  for (int e = tid; e < PH * R * 2 * KT; e += NTHREADS) racc[e] = 0.0f;
  for (int e = tid; e < nchunks * PC; e += NTHREADS)
    ends_s[e] = e < P ? ends[e] : make_int2(-1, 0);
  int cur_kt = -1;
  float bb[8];
  // the quarter of the features [f0, f1) this thread copies for its
  // patch; the last quarter also zeroes the rows [F, F8)
  const int f0 = fq * F / FQ, f1 = fq == FQ - 1 ? F8 : (fq + 1) * F / FQ;
  for (long long it = beg; it < end; ++it) {
    const int kt = (int)(it / B), b = (int)(it % B);
    const float* im = imgs + (long long)b * H * W * C;
    if (kt != cur_kt) {
      // every product of the last tile is done (the barrier ending its
      // last chunk)
      const float* src = filt + kt * KT;
      for (int e = tid; e < F8 * (KT / 4); e += NTHREADS) {
        const int f = e / (KT / 4), q = e % (KT / 4);
        float* dst = bs_ + f * KT + ((4 * q) ^ ((f & 3) << 3));
        if (f < F)
          cp_async16(dst, src + (long long)f * Kp + 4 * q);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int k = tid; k < KT; k += NTHREADS) bsb[k] = bias[kt * KT + k];
      cp_async_commit();
    }
    // every patch's mean and 1 / sd, sd = sqrt(var + var_constant) with
    // the unbiased variance (sum p^2 - F m^2) / (F - 1) and a NaN guard, as
    // in the plain version
    for (int p = tid; p < P; p += NTHREADS) {
      const float* src = im + (p / OW) * row + (p % OW) * C;
      float s = 0.0f, sq = 0.0f;
      for (int dy = 0; dy < S; ++dy) {
#pragma unroll 6
        for (int j = 0; j < SC; ++j) {
          const float v = __ldg(src + dy * row + j);
          s += v;
          sq = fmaf(v, v, sq);
        }
      }
      const float m = s / (float)F;
      const float var = (sq - (float)F * m * m) / ((float)F - 1.0f);
      float sd = sqrtf(var + var_constant);
      if (isnan(sd)) sd = sqrtf(var_constant);
      mr[p * 2] = m;
      mr[p * 2 + 1] = 1.0f / sd;
    }
    if (kt != cur_kt) {
      cp_async_wait_all();
      cur_kt = kt;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bb[j] = bsb[wn * 32 + (j / 2) * 8 + 2 * tq + (j & 1)];
    }
    __syncthreads();  // the means are in

    for (int ch = 0; ch < nchunks; ++ch) {
      // im2col: features [f0, f1) of patch pl, in (dy, dx, c) order,
      // centered on the patch's mean, into ac[f][pl] (swizzled)
      {
        const int p = ch * PC + pl;
        const bool valid = p < P;
        const int py = valid ? p / OW : 0, px = valid ? p % OW : 0;
        const float* src = im + py * row + px * C;
        const float m = valid ? mr[p * 2] : 0.0f;
        int dy = f0 / SC, j = f0 % SC;
#pragma unroll 4
        for (int f = f0; f < f1; ++f) {
          const float v =
              valid && f < F ? __ldg(src + dy * row + j) - m : 0.0f;
          ac[f * PC + (pl ^ ((f & 3) << 3))] = v;
          if (++j == SC) {
            j = 0;
            ++dy;
          }
        }
      }
      __syncthreads();

      // the chunk's product in 3xTF32 on the tensor cores: a warp takes 32
      // patches x 32 filters, 2 x 4 mma tiles of 16 x 8
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.0f;
      const int sw = tq << 3;
      for (int k0 = 0; k0 < F8; k0 += 8) {
        const float* a0 = ac + (k0 + tq) * PC;
        const float* a1 = a0 + 4 * PC;
        const float* b0 = bs_ + (k0 + tq) * KT;
        const float* b1 = b0 + 4 * KT;
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = wm * 32 + i * 16 + gq;
          split_tf32(a0[m ^ sw], ab[i][0], as[i][0]);
          split_tf32(a0[(m + 8) ^ sw], ab[i][1], as[i][1]);
          split_tf32(a1[m ^ sw], ab[i][2], as[i][2]);
          split_tf32(a1[(m + 8) ^ sw], ab[i][3], as[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nc = (wn * 32 + j * 8 + gq) ^ sw;
          uint32_t wb0, ws0, wb1, ws1;
          split_tf32(b0[nc], wb0, ws0);
          split_tf32(b1[nc], wb1, ws1);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_3xtf32(acc[i][j], ab[i], as[i], wb0, wb1, ws0, ws1);
        }
      }
      __syncthreads();  // the patches are read

      // conv = (patch - m) . filter / sd - bias, into ac[p][k]
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int q = wm * 32 + i * 16 + gq + 8 * hi;
          const float rsd = mr[(ch * PC + q) * 2 + 1];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = wn * 32 + j * 8 + 2 * tq;
            *reinterpret_cast<float2*>(ac + q * CS + n) = make_float2(
                acc[i][j][2 * hi] * rsd - bb[2 * j],
                acc[i][j][2 * hi + 1] * rsd - bb[2 * j + 1]);
          }
        }
      __syncthreads();

      // pool: each thread one filter's column over its half of the chunk,
      // both signs, in patch order; where a run of patches in the same
      // pooling regions ends (ends[p].x >= 0: rows first | count << 16,
      // then columns; every half ends one), its rectified sums go to
      // each of those regions, in the half's own copy of the region
      // sums. 8 patches' values and run ends are loaded ahead of their
      // sums: the region-sum stores may alias them for the compiler.
      {
        const float* col = ac + (h * RUN_CUT) * CS + kk;
        const int2* en = ends_s + ch * PC + h * RUN_CUT;
        float* rh = racc + h * R * 2 * KT + kk;
        float sp_ = 0.0f, sn = 0.0f;
        for (int q0 = 0; q0 < RUN_CUT; q0 += 8) {
          float c[8];
          int2 e[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            c[i] = col[(q0 + i) * CS];
            e[i] = en[q0 + i];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            sp_ += relu_nan(c[i] - alpha);
            sn += relu_nan(-c[i] - alpha);
            if (e[i].x >= 0) {
              const int rx0 = e[i].x & 0xffff, rxn = e[i].x >> 16;
              const int ry0 = e[i].y & 0xffff, ryn = e[i].y >> 16;
              for (int rx = rx0; rx < rx0 + rxn; ++rx)
                for (int ry = ry0; ry < ry0 + ryn; ++ry) {
                  float* dst = rh + (rx * nry + ry) * 2 * KT;
                  dst[0] += sp_;
                  dst[KT] += sn;
                }
              sp_ = 0.0f;
              sn = 0.0f;
            }
          }
        }
      }
      __syncthreads();  // the conv tile is read before the next chunk
    }

    // this item's pooled features, region-major, K pos then K neg values
    // per region, the halves' copies added in order; the sums restart at
    // zero for the next item
    const int k = kt * KT + kk;
    float* dst = out + (long long)b * R * 2 * K + (long long)h * K + k;
    for (int r = 0; r < R; ++r) {
      float* acc_r = racc + (r * 2 + h) * KT + kk;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < PH; ++q) {
        v += acc_r[q * R * 2 * KT];
        acc_r[q * R * 2 * KT] = 0.0f;
      }
      if (k < K) dst[(long long)r * 2 * K] = v;
    }
  }
  cp_async_wait_all();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for an image of H x W x C, patch S and
// R pooling regions, in bytes (above SMEM_LIMIT the launch is refused).
long long fused_featurize_smem_bytes(int H, int W, int C, int S, int R) {
  return 4 * smem_floats(H, W, C, S, R);
}

// Runs of patches end at multiples of this (the run ends table is cut
// there), and filters a block (the laid-out filters are padded to its
// multiple).
int fused_featurize_run_cut() { return RUN_CUT; }
int fused_featurize_filter_tile() { return KT; }

// out (B, R * 2K) for images (B, H, W, C) float32 contiguous, filt the
// filters laid out (F, Kp) with F = S * S * C in (dy, dx, c) order and Kp
// a multiple of the filter tile, bias (Kp) (zero past K), and
// the run ends of the geometry: two ints a patch, (-1, 0) inside a run
// and (rows, columns) at its last patch, each region set as
// first | count << 16.
// Launches on `stream`; returns the launch's error (0 on success), or
// cudaErrorInvalidValue for arguments it cannot take.
int fused_cifar_featurize_f32(const float* imgs, const float* filt,
                              const float* bias, const int* ends, float* out, int B, int H, int W, int C, int S,
                              int K, int Kp, int nry, int R,
                              float var_constant, float alpha,
                              void* stream) {
  if (B <= 0 || K <= 0 || S < 1 || S > H || S > W || C < 1 || R < 0 ||
      Kp % KT != 0 || Kp < K ||
      reinterpret_cast<uintptr_t>(filt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = fused_featurize_smem_bytes(H, W, C, S, R);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the opt-in to 227 KB of dynamic shared memory, once per device
  static int opted_in_device = -1;
  if (err == cudaSuccess && opted_in_device != dev) {
    err = cudaFuncSetAttribute(fused_featurize_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err == cudaSuccess) opted_in_device = dev;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_featurize_kernel, NTHREADS, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)(Kp / KT) * B;
  const long long blocks =
      items < (long long)sms * per_sm ? items : (long long)sms * per_sm;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_featurize_kernel<<<(unsigned)blocks, NTHREADS, (size_t)smem, st>>>(
      imgs, filt, bias, reinterpret_cast<const int2*>(ends), out, B, H, W, C, S, K, Kp, nry, R, var_constant, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
