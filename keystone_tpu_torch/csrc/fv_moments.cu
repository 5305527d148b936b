// GMM-posterior Fisher-vector moments for Hopper (sm_90a). For each
// descriptor column x of X (D, n), under a diagonal GMM with K components:
//   llh[k] = c[k] + x' . B[:, k] - x'^2 . A[:, k],   x' = x - g
//            A = 0.5 / var, B = (means - g) / var, c the per-component
//            constant of the centered means, g a per-row center
//   q = softmax(llh) (max-shifted); q = q > threshold ? q : 0; q /= sum(q)
// and the moment SUMS over the n columns
//   s0 = sum q (K),  s1 = X q (D, K),  s2 = (X * X) q (D, K),
// taken as sums of x' and x'^2 and moved back to x by the reduce:
//   s1 = s1' + g s0,  s2 = s2' + 2 g s1' + g^2 s0.
// The caller divides by n. The (n, K) posterior matrix never reaches
// device memory. g, A, B and c depend only on the fitted GMM: the caller
// computes them once (keystone_tpu_torch/ops/kernels.py::fv_terms).
//
// Replaces keystone_tpu/ops/pallas_kernels.py::fv_moments_pallas (the
// Pallas TPU kernel _fv_moments_kernel and its wrapper). The plain PyTorch
// version of the same function is
// keystone_tpu_torch/ops/kernels.py::fv_moments_plain.
//
// What bounds it. Two products of 2 n D K multiply-adds each: the llh
// tile [x' | -x'^2] (T x 2D) @ [B; A] (2D x K) and the moment update
// [x'; -x'^2] (2D x T) @ q (T x K), against 4 D n bytes of descriptors.
// At the full-width FV (D = 80, K = 256, n = 47,213 an image) that is 7.7
// GFLOP against 15 MB, so operations bound it: 0.116 ms at the float32
// peak, and 0.047 ms for the three TF32 passes below at the TF32
// tensor-core peak (the bytes take 4.5 us).
//
// What the design does about it.
//  * Both products run on the tensor cores (mma.sync m16n8k8, TF32) as
//    3xTF32: each operand v is split into big = tf32(v) and small =
//    tf32(v - big) (the low 13 mantissa bits cleared by a mask, at the
//    full integer rate, where cvt.rna.tf32 runs at a quarter of it), and
//    a product is small*big + big*small + big*big with float32
//    accumulation, about float32's accuracy. Plain TF32 (10 mantissa
//    bits) cannot hold llh terms of 1e4-1e5 on uncentered PCA'd
//    descriptors; centering X and the means on g (the mean of the
//    component means) shrinks those terms, and 3xTF32 on the centered
//    terms lands below plain float32's error against float64.
//  * [B; A] stays resident in shared memory (2D x K, 165 KB at D = 80,
//    K = 256), copied once per block with cp.async and split into
//    big/small as its fragments are read; the x'^2 rows are negated
//    instead of A. The s1'/s2' accumulators live in registers as mma
//    accumulator fragments: each of 8 warps owns 32 components (4 tiles
//    of 8) over all 2D = 160 rows of [x'; -x'^2] (10 tiles of 16), 160
//    floats a thread. Where 2D or K is larger than 160 rows or 256
//    components, grid.y splits the accumulated rows and components; each
//    split recomputes the posteriors, which need every row and component.
//  * Where [B; A] does not fit beside the tiles (D = 81 and up at K =
//    256, K = 512 at D = 64), the same buffer takes it in chunks of rows,
//    as many as fit: each tile copies the chunks in turn and sums the
//    llh over them in the llh tile, in chunk order, so such a GMM rereads
//    [B; A] from L2 on every tile. Refused only where the tiles and 8 rows
//    of [B; A] exceed one block's 227 KB: K past 1960 at D = 80, D past
//    455 at K = 256 (the llh tile is T x K floats, the x' tiles 2D x T).
//  * Blocks run in no order on Hopper, so each block (one an SM) takes a
//    strided set of T = 16-column tiles and keeps its own partial sums; a
//    second launch adds the blocks' partials in a fixed order (4 threads
//    an entry, each a quarter of the blocks in block order) and
//    un-centers. No atomics: the same inputs give the same bits on every
//    run.
//  * The next X tile is copied into shared memory with cp.async while the
//    current tile's two products and softmax run.
//  * Per tile: x' = x - g and -x'^2, each split into big and small once
//    and kept in shared memory for both products (the 8 warps read the
//    same fragments); the llh tile (T x K) in shared memory, a warp
//    taking 4 component tiles against one set of x' fragments; a
//    half-warp per row for the max, the exponentials, both
//    normalizations and the threshold, the row in registers (fixed
//    shuffle butterflies, expf, one reciprocal per normalization); then
//    the moment product from the q tile. Columns at or past n load as
//    zeros and their posteriors are dropped by index; the loops run over
//    exactly K components.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int T = 16;             // descriptor columns a tile
constexpr int TS = T + 8;         // padded row of the x' tiles
constexpr int NTW = 4;            // 8-component tiles a warp accumulates
constexpr int MTW = 10;           // 16-row tiles of [x'; x'^2] a split holds
constexpr int SPLIT_N = NWARPS * NTW;  // 8-component tiles a split holds
constexpr int SV = 16;            // llh values a lane keeps in registers
static_assert(T == 2 * NWARPS, "the softmax takes two rows a warp");

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// max and sum over each 16-lane half of the warp
__device__ inline float half_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ inline float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// v ~ big + small, both TF32: the low 13 mantissa bits cleared (a bit
// mask, where cvt.rna.tf32 runs at the conversion unit's quarter rate);
// v - big is exact, so only small's truncation is lost (2^-20 of v)
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

__device__ inline void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// padded component stride: at least 8 * ntiles, and 8 mod 32 so that the
// fragment reads (rows tq, columns gq) hit 32 distinct banks
__host__ __device__ inline int comp_stride(int ntiles) {
  const int ks = 8 * ntiles;
  return ks + ((8 - ks % 32) + 32) % 32;
}

// shared memory of one block, in floats: R rows of [B; -A] (R x KS, R =
// 2Dp where it is resident), the tile's [x'; x'^2] split into TF32 big and
// small parts (2 x 2Dp x TS), the raw X tile (D x T, the cp.async
// target), the llh / q tile (T x KS), c (KS) and g (Dp)
__host__ __device__ inline long long smem_floats(int D, int Dp, int KS,
                                                 int R) {
  return (long long)R * KS + 4LL * Dp * TS + (long long)D * T +
         (long long)T * KS + KS + Dp;
}

__global__ void __launch_bounds__(NTHREADS, 1)
fv_moments_kernel(const float* __restrict__ X, long long ldx,
                  const float* __restrict__ g, const float* __restrict__ A,
                  const float* __restrict__ B, const float* __restrict__ c,
                  float* __restrict__ partial, int D, int n, int K,
                  int rsplits, int R, float threshold) {
  const int Dp = (D + 7) / 8 * 8;
  const int ntiles = (K + 7) / 8;
  const int KS = comp_stride(ntiles);
  const int MT = Dp / 8;  // 16-row tiles of [x'; x'^2] (2 Dp rows)
  const bool resident = R >= 2 * Dp;  // else [B; -A] in chunks of R rows
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [R][KS]: B, then A
  uint32_t* xb = reinterpret_cast<uint32_t*>(ws + (long long)R * KS);
  uint32_t* xm = xb + 2 * Dp * TS;  // [2Dp][TS] big, small of [x'; x'^2]
  float* raw = reinterpret_cast<float*>(xm + 2 * Dp * TS);  // [D][T]
  float* qs = raw + D * T;                                   // [T][KS]
  float* cs = qs + T * KS;                                   // [KS]
  float* gs = cs + KS;                                       // [Dp]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma fragment coordinates
  const int rsplit = blockIdx.y % rsplits, csplit = blockIdx.y / rsplits;
  const int mt0 = rsplit * MTW;
  const int mtn = min(MTW, MT - mt0);
  const int nbase = csplit * SPLIT_N + warp * NTW;

  // rows [r0, r0 + R) of [B; A] into ws, asynchronously (padding rows
  // and components zero-filled)
  auto load_ws = [&](int r0) {
    for (int r = r0 + warp; r < min(r0 + R, 2 * Dp); r += NWARPS) {
      const float* src = r < D ? B + (long long)r * K
                         : r >= Dp && r - Dp < D ? A + (long long)(r - Dp) * K
                                                 : nullptr;
      for (int k = lane; k < KS; k += 32)
        cp_async4(ws + (r - r0) * KS + k,
                  src != nullptr && k < K ? src + k : c,
                  src != nullptr && k < K);
    }
  };
  // resident: [B; A] copied once per block, in the first tile's copy group
  if (resident) load_ws(0);
  for (int k = tid; k < KS; k += NTHREADS) cs[k] = k < K ? c[k] : 0.0f;
  for (int d = tid; d < Dp; d += NTHREADS) gs[d] = d < D ? g[d] : 0.0f;

  const long long tiles = ((long long)n + T - 1) / T;
  auto load_tile = [&](long long tile) {
    const long long col0 = tile * T;
    for (int e = tid; e < D * T; e += NTHREADS) {
      const int d = e / T, t = e % T;
      const bool valid = col0 + t < n;
      cp_async4(raw + e, valid ? X + (long long)d * ldx + col0 + t : X,
                valid);
    }
  };

  float acc[MTW][NTW][4];
  float s0acc[NTW];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.0f;
#pragma unroll
  for (int j = 0; j < NTW; ++j) s0acc[j] = 0.0f;

  long long tile = blockIdx.x;
  if (tile < tiles) load_tile(tile);
  cp_async_commit();
  for (; tile < tiles; tile += gridDim.x) {
    const int valid = (int)min((long long)T, (long long)n - tile * T);
    cp_async_wait_all();
    __syncthreads();  // raw holds this tile; the last tile is consumed
    // x' = x - g and -x'^2 (the llh subtracts x'^2 A), each split once
    // into TF32 big and small parts
    for (int e = tid; e < Dp * T; e += NTHREADS) {
      const int d = e / T, t = e % T;
      const float v = d < D ? raw[e] - gs[d] : 0.0f;
      split_tf32(v, xb[d * TS + t], xm[d * TS + t]);
      split_tf32(-(v * v), xb[(Dp + d) * TS + t], xm[(Dp + d) * TS + t]);
    }
    __syncthreads();  // raw is free: fetch the next tile behind the math
    if (tile + gridDim.x < tiles) load_tile(tile + gridDim.x);
    cp_async_commit();

    // llh[t][k] = c[k] + sum_r [x' | -x'^2][t][r] ws[r][k], over the
    // chunks of [B; -A] in order: a warp takes NTW 8-component tiles at a
    // time, its x' fragments serving all of them
    for (int r0 = 0; r0 < 2 * Dp; r0 += R) {
      if (!resident) {
        __syncthreads();  // every warp is done with the last chunk
        load_ws(r0);
        cp_async_commit();
        cp_async_wait_all();  // (the next X tile's copy with it)
        __syncthreads();
      }
      const int r1 = min(r0 + R, 2 * Dp);
      for (int nt0 = warp * NTW; nt0 < ntiles; nt0 += NWARPS * NTW) {
        float l[NTW][4] = {};
        for (int k0 = r0; k0 < r1; k0 += 8) {
          const int x0 = (k0 + tq) * TS + gq, x1 = x0 + 4 * TS;
          const uint32_t ab[4] = {xb[x0], xb[x0 + 8], xb[x1], xb[x1 + 8]};
          const uint32_t as[4] = {xm[x0], xm[x0 + 8], xm[x1], xm[x1 + 8]};
          const float* w0 = ws + (k0 - r0 + tq) * KS;
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            if (nt0 + j >= ntiles) break;
            const int kc = (nt0 + j) * 8 + gq;
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(w0[kc], bb0, bs0);
            split_tf32(w0[4 * KS + kc], bb1, bs1);
            mma_3xtf32(l[j], ab, as, bb0, bb1, bs0, bs1);
          }
        }
        // the first chunk starts from c, a later one adds to the tile
        // this thread wrote for the chunk before
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          if (nt0 + j >= ntiles) break;
          const int k = (nt0 + j) * 8 + 2 * tq;
          float* q0 = qs + gq * KS + k;
          float* q1 = q0 + 8 * KS;
          const bool first = r0 == 0;
          q0[0] = (first ? cs[k] : q0[0]) + l[j][0];
          q0[1] = (first ? cs[k + 1] : q0[1]) + l[j][1];
          q1[0] = (first ? cs[k] : q1[0]) + l[j][2];
          q1[1] = (first ? cs[k + 1] : q1[1]) + l[j][3];
        }
      }
    }
    __syncthreads();

    // softmax, threshold, renormalize; rows past n -> 0. Where K <= 16 SV
    // a half-warp takes a row (a warp two at once), each lane holding SV
    // of its values in registers; else a warp walks a row in shared
    // memory. Fixed shuffle butterflies: the same bits on every run.
    if (K <= 16 * SV) {
      const int t = 2 * warp + lane / 16, hl = lane % 16;
      float* row = qs + t * KS;
      float v[SV];
      float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int i = 0; i < SV; ++i) {
        const int k = hl + 16 * i;
        v[i] = k < K ? row[k] : __int_as_float(0xff800000);
        mx = fmaxf(mx, v[i]);
      }
      mx = half_max(mx);
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < SV; ++i) {
        v[i] = hl + 16 * i < K ? expf(v[i] - mx) : 0.0f;
        s += v[i];
      }
      const float inv = 1.0f / half_sum(s);
      float s2 = 0.0f;
#pragma unroll
      for (int i = 0; i < SV; ++i) {
        const float q = v[i] * inv;
        v[i] = q > threshold ? q : 0.0f;
        s2 += v[i];
      }
      const float s2sum = half_sum(s2);  // every lane takes part
      const float inv2 = t < valid ? 1.0f / s2sum : 0.0f;
#pragma unroll
      for (int i = 0; i < SV; ++i)
        if (hl + 16 * i < K) row[hl + 16 * i] = v[i] * inv2;
    } else {
      for (int t = warp; t < T; t += NWARPS) {
        float* row = qs + t * KS;
        if (t >= valid) {
          for (int k = lane; k < K; k += 32) row[k] = 0.0f;
          continue;
        }
        float mx = __int_as_float(0xff800000);  // -inf
        for (int k = lane; k < K; k += 32) mx = fmaxf(mx, row[k]);
        mx = warp_max(mx);
        float s = 0.0f;
        for (int k = lane; k < K; k += 32) {
          const float e = expf(row[k] - mx);
          row[k] = e;
          s += e;
        }
        const float inv = 1.0f / warp_sum(s);
        float s2 = 0.0f;
        for (int k = lane; k < K; k += 32) {
          const float q = row[k] * inv;
          row[k] = q > threshold ? q : 0.0f;
          s2 += row[k];
        }
        const float inv2 = 1.0f / warp_sum(s2);
        for (int k = lane; k < K; k += 32) row[k] = row[k] * inv2;
      }
    }
    __syncthreads();

    // [s1'; -s2'] += [x'; -x'^2] (2Dp x T) @ q (T x K); s0 += sum_t q
#pragma unroll
    for (int t0 = 0; t0 < T; t0 += 8) {
      uint32_t qb[NTW][2], qm[NTW][2];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nt = nbase + j;
        float v0 = 0.0f, v1 = 0.0f;
        if (nt < ntiles) {
          v0 = qs[(t0 + tq) * KS + nt * 8 + gq];
          v1 = qs[(t0 + tq + 4) * KS + nt * 8 + gq];
        }
        s0acc[j] += v0 + v1;
        split_tf32(v0, qb[j][0], qm[j][0]);
        split_tf32(v1, qb[j][1], qm[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        if (i >= mtn) break;
        const int r0 = ((mt0 + i) * 16 + gq) * TS + t0 + tq;
        const int r1 = r0 + 8 * TS;
        const uint32_t ab[4] = {xb[r0], xb[r1], xb[r0 + 4], xb[r1 + 4]};
        const uint32_t as[4] = {xm[r0], xm[r1], xm[r0 + 4], xm[r1 + 4]};
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (nbase + j < ntiles)
            mma_3xtf32(acc[i][j], ab, as, qb[j][0], qb[j][1], qm[j][0],
                       qm[j][1]);
      }
    }
  }

  cp_async_wait_all();  // a block past the last tile has copies in flight

  // this block's partial: [s0 (K) | s1' (D x K) | s2' (D x K)]
  float* dst = partial + (long long)blockIdx.x * (K + 2LL * D * K);
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    float v = s0acc[j];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int k = (nbase + j) * 8 + gq;
    if (rsplit == 0 && tq == 0 && k < K) dst[k] = v;
  }
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    if (i >= mtn) break;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = (mt0 + i) * 16 + gq + (u >= 2 ? 8 : 0);
        const int k = (nbase + j) * 8 + 2 * tq + (u & 1);
        const bool sq = m >= Dp;
        const int d = sq ? m - Dp : m;
        if (d < D && k < K)
          dst[K + (sq ? (long long)D * K : 0LL) + (long long)d * K + k] =
              sq ? -acc[i][j][u] : acc[i][j][u];
      }
    }
  }
}

constexpr int RTHREADS = 256;
constexpr int RPARTS = 4;  // threads an entry, each summing a quarter
constexpr int RENTRIES = RTHREADS / RPARTS;

// Sum the blocks' partials in a fixed order (each of RPARTS threads a
// contiguous quarter of the blocks in block order, the quarters then
// added in order) and move the centered sums back to X:
// out = [s0 | s1' + g s0 | s2' + 2 g s1' + g^2 s0].
__global__ void __launch_bounds__(RTHREADS)
reduce_uncenter_kernel(const float* __restrict__ partial,
                       const float* __restrict__ g, float* __restrict__ out,
                       int D, int K, int blocks) {
  __shared__ float part[3][RPARTS][RENTRIES];
  const long long DK = (long long)D * K;
  const int e = threadIdx.x % RENTRIES, p = threadIdx.x / RENTRIES;
  const long long i = (long long)blockIdx.x * RENTRIES + e;
  const long long total = K + 2 * DK;
  const int per = (blocks + RPARTS - 1) / RPARTS;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  if (i < DK) {
    const int k = (int)(i % K);
    const int b1 = min(blocks, (p + 1) * per);
#pragma unroll 8
    for (int b = p * per; b < b1; ++b) {
      const float* src = partial + (long long)b * total;
      s0 += src[k];
      s1 += src[K + i];
      s2 += src[K + DK + i];
    }
  }
  part[0][p][e] = s0;
  part[1][p][e] = s1;
  part[2][p][e] = s2;
  __syncthreads();
  if (p != 0 || i >= DK) return;
  for (int q = 1; q < RPARTS; ++q) {
    s0 += part[0][q][e];
    s1 += part[1][q][e];
    s2 += part[2][q][e];
  }
  const int d = (int)(i / K), k = (int)(i % K);
  const float gd = g[d];
  out[K + i] = fmaf(gd, s0, s1);
  out[K + DK + i] = fmaf(gd * gd, s0, fmaf(2.0f * gd, s1, s2));
  if (d == 0) out[k] = s0;
}

constexpr long long SMEM_LIMIT = 232448;  // bytes a block may use (227 KB)

struct Plan {
  int R;        // rows of [B; -A] shared memory holds (2Dp: resident)
  int rsplits;  // splits of the accumulated rows of [x'; x'^2] (grid y)
  int csplits;  // splits of the accumulated components (grid y)
  int blocks;   // blocks along n (grid x)
  long long smem;
};

// The launch plan for (D, n, K) on the current device: as many rows of
// [B; -A] as fit beside the tiles (a multiple of 8, at most all 2Dp), the
// row and component splits the register accumulators need, and as many
// blocks as the SMs hold at once, at most one a tile. False where the
// tiles and 8 rows of [B; -A] do not fit one block's shared memory.
bool make_plan(int D, int n, int K, Plan* p) {
  int dev = 0, sms = 0;
  if (D <= 0 || n <= 0 || K <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  const int Dp = (D + 7) / 8 * 8;
  const int ntiles = (K + 7) / 8;
  const int KS = comp_stride(ntiles);
  const long long room = SMEM_LIMIT / 4 - smem_floats(D, Dp, KS, 0);
  const int R = (int)std::min<long long>(2 * Dp, room / KS / 8 * 8);
  if (R < 8) return false;
  const long long smem = 4 * smem_floats(D, Dp, KS, R);
  const long long per_sm = std::max<long long>(
      1, std::min<long long>(2048 / NTHREADS, SMEM_LIMIT / smem));
  const long long tiles = ((long long)n + T - 1) / T;
  *p = {R, (Dp / 8 + MTW - 1) / MTW, (ntiles + SPLIT_N - 1) / SPLIT_N,
        (int)std::min<long long>(tiles, sms * per_sm), smem};
  return true;
}

}  // namespace

extern "C" {

// Floats of the (blocks, K + 2 D K) scratch that fv_moments_f32 needs on
// the current device for (D, n, K), or -1 where no plan fits a block's
// shared memory (or a size is not positive).
long long fv_moments_scratch_floats(int D, int n, int K) {
  Plan p;
  if (!make_plan(D, n, K, &p)) return -1;
  return (long long)p.blocks * (K + 2LL * D * K);
}

// out = [s0 (K) | s1 (D, K) | s2 (D, K)], contiguous float32, for X (D, n)
// float32 with row stride ldx (unit column stride), the center g (D), A =
// 0.5 / var and B = (means - g) / var contiguous (D, K), c (K) the llh
// constants of the centered means. `partial` is a float32 scratch of
// fv_moments_scratch_floats(D, n, K) floats. Launches the moments kernel
// and the block-order reduce on `stream` on the current device and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the launch cannot take.
int fv_moments_f32(const float* X, long long ldx, const float* g,
                   const float* A, const float* B, const float* c,
                   float* out, float* partial, int D, int n, int K,
                   float threshold, void* stream) {
  Plan p;
  if (ldx < n || partial == nullptr || !make_plan(D, n, K, &p) ||
      (long long)p.rsplits * p.csplits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the opt-in to 227 KB of dynamic shared memory, once per device (it
  // does not lower occupancy: a launch is placed by the bytes it asks for)
  static int opted_in_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && opted_in_device != dev) {
    err = cudaFuncSetAttribute(fv_moments_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_LIMIT);
    if (err == cudaSuccess) opted_in_device = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.blocks, (unsigned)(p.rsplits * p.csplits));
  fv_moments_kernel<<<grid, NTHREADS, (size_t)p.smem, st>>>(
      X, ldx, g, A, B, c, partial, D, n, K, p.rsplits, p.R, threshold);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long DK = (long long)D * K;
  reduce_uncenter_kernel<<<(unsigned)((DK + RENTRIES - 1) / RENTRIES),
                           RTHREADS, 0, st>>>(partial, g, out, D, K,
                                              p.blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
