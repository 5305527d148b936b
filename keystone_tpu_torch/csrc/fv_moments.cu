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
//    components, grid y and z split the accumulated rows and components;
//    each split recomputes the posteriors, which need every row and
//    component.
//  * Where [B; A] does not fit beside the tiles (D = 81 and up at K =
//    256, K = 512 at D = 64), the same buffer takes it in chunks of rows,
//    as many as fit: each tile copies the chunks in turn and sums the
//    llh over them in the llh tile, in chunk order, so such a GMM rereads
//    [B; A] from L2 on every tile.
//  * Where the llh tile (T x K) does not fit (K past about 1960 at D =
//    80), the components go in chunks (multiples of 256, as wide as fit),
//    in a fixed order, and the same kernel runs twice. The first launch
//    (no row or component splits) walks each tile's chunks twice,
//    recomputing their llh: a running max and sum of exponentials (the
//    sum rescaled to each new max), then the kept sum of the thresholded
//    posteriors; it writes the three per descriptor column. The second,
//    split over components as usual, recomputes only its split's own 256
//    components' llh, takes their posteriors from the three, and runs
//    the moment update. So such a GMM pays 3x the llh product, and only
//    there; one chunk runs the three steps at once on values held in
//    registers. A compile-time flag keeps that code out of the resident
//    instantiation, whose registers stay those of the one-chunk form.
//  * Where the x' tiles (2D x T) do not fit (D past about 455 at K =
//    256), the rows of [x'; -x'^2] are staged straight from X in the
//    chunks of rows of [B; A] for the llh, then each row split's own 160
//    rows are staged again for the moment product. With both, every
//    (D, K) has a launch plan; only device memory bounds it.
//  * Where the component tiles need fewer than the 8 warps (K <= 224,
//    one chunk, x' resident: ImageNet's K = 16 needs one), a third
//    instantiation (SMALLK) gives the idle warps work: G groups of warps
//    share the component tiles; group p takes the llh product's 8-row
//    steps of [B; -A] and the moment product's 16-row tiles of [x';
//    -x'^2] whose index is p mod G, and the groups' partial llh tiles
//    are added in group order in shared memory (at (64, 16) the device
//    time halves, keystone_tpu_torch/tools/time_fv.py); the other
//    instantiations compile none of it.
//  * Blocks run in no order on Hopper, so each block takes a strided set
//    of T = 16-column tiles and keeps its own partial sums; a last launch
//    adds the blocks' partials in a fixed order (4 threads an entry, each
//    a quarter of the blocks in block order) and un-centers. No atomics:
//    the same inputs give the same bits on every run. There are as many
//    blocks as the SMs hold at once, as the runtime's occupancy reports
//    it (one an SM at 160 accumulators a thread): more would only add
//    partials to reduce. The 227 KB shared-memory opt-in comes before
//    any plan, so a plan reads the occupancy its launch gets.
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

// Groups of warps for a GMM whose kct 8-component tiles need fewer than
// NWARPS warps (NTW tiles a warp, one chunk of every component): G groups
// of ceil(kct / NTW) warps share the component tiles, and split the llh
// product's rows of [B; -A] and the moment product's 16-row tiles. 1 where
// the tiles take every warp.
__host__ __device__ inline int warp_groups(int kct) {
  const int wk = (kct + NTW - 1) / NTW;
  return wk >= NWARPS ? 1 : NWARPS / (wk > 0 ? wk : 1);
}

// shared memory of one block, in floats: R rows of [B; -A] over a chunk of
// components (R x KS), XR rows of [x'; -x'^2] split into TF32 big and small
// (2 x XR x TS), the raw X tile and g where x' is resident (D x T, Dp),
// the llh / q tile (T x KS), c of the chunk (KS), the per-row softmax
// state of the component passes (3 x T), and where lg > 1 groups split
// the llh product, their partial llh tiles (lg x T x KS)
__host__ __device__ inline long long smem_floats(int D, int Dp, int KS, int R,
                                                 int XR, bool xres, int lg) {
  return (long long)R * KS + 2LL * XR * TS +
         (xres ? (long long)D * T + Dp : 0LL) + (long long)T * KS + KS +
         3 * T + (lg > 1 ? (long long)lg * T * KS : 0LL);
}

// WIDE: the instantiation for GMMs past the resident tiles (components in
// chunks, or x' rows staged from X); the other compiles only the one-chunk,
// resident-x' form, so its registers are those of that form alone.
// SMALLK (not WIDE): the instantiation for a GMM whose component tiles
// need fewer than NWARPS warps (K <= 224): warp_groups(K) groups of warps
// share them, splitting both products' rows; the other instantiations
// compile none of that code.
// mode (WIDE only; 0 otherwise): 0 one pass where the llh tile holds
// every component; with chunks of components, 1 the column statistics
// (running max, sum of exponentials, kept sum) into stats [3][ns], 2 the
// moments of the split's own components from those statistics.
template <bool WIDE, bool SMALLK>
__global__ void __launch_bounds__(NTHREADS, 1)
fv_moments_kernel(const float* __restrict__ X, long long ldx,
                  const float* __restrict__ g, const float* __restrict__ A,
                  const float* __restrict__ B, const float* __restrict__ c,
                  float* __restrict__ partial, float* __restrict__ stats,
                  long long ns, int D, int n, int K, int R, int XR, int KC,
                  float threshold, int mode) {
  const int md = WIDE ? mode : 0;
  const int Dp = (D + 7) / 8 * 8;
  const int ntiles = (K + 7) / 8;
  const int kct = (KC + 7) / 8;      // 8-component tiles of a chunk
  const int KS = comp_stride(kct);
  const int nchunks = (K + KC - 1) / KC;
  // the llh tile holds every component; every row of [x'; -x'^2] staged
  const bool single = !WIDE || nchunks == 1;
  const bool xres = !WIDE || XR >= 2 * Dp;
  const bool wres = single && R >= 2 * Dp;  // [B; -A] resident
  const int MT = Dp / 8;  // 16-row tiles of [x'; x'^2] (2 Dp rows)
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [R][KS]: B, then A
  uint32_t* xb = reinterpret_cast<uint32_t*>(ws + (long long)R * KS);
  uint32_t* xm = xb + XR * TS;  // [XR][TS] big, small of [x'; x'^2]
  float* raw = reinterpret_cast<float*>(xm + XR * TS);  // [D][T] (xres)
  float* qs = raw + (xres ? D * T : 0);                  // [T][KS]
  float* cs = qs + T * KS;                               // [KS]
  float* gs = cs + KS;                                   // [Dp] (xres)
  float* rowm = gs + (xres ? Dp : 0);  // running max, sum, kept sum [T]
  float* rowz = rowm + T;
  float* rowk = rowz + T;
  float* lred = rowk + T;  // [G][T][KS] partial llh tiles (SMALLK)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma fragment coordinates
  const int rsplit = blockIdx.y, csplit = blockIdx.z;
  const int mt0 = rsplit * MTW;
  const int mtn = min(MTW, MT - mt0);
  // SMALLK: G groups of wk warps share the component tiles (one split);
  // group gp takes the 8-row steps of [B; -A] and the 16-row tiles of
  // [x'; -x'^2] with index = gp mod G, the partial llh tiles added in
  // group order. Otherwise G = 1 and each warp owns NTW component tiles.
  const int G = SMALLK ? warp_groups(kct) : 1;
  const int wk = SMALLK ? (kct + NTW - 1) / NTW : NWARPS;
  const bool gwork = !SMALLK || warp < wk * G;
  const int gp = SMALLK && gwork ? warp / wk : 0;
  const int nbase =
      csplit * SPLIT_N + (gwork ? (SMALLK ? warp % wk : warp) * NTW : SPLIT_N);
  unsigned rows_mine = ~0u;  // the moment product's 16-row tiles it takes
  if (SMALLK) {
    rows_mine = 0u;
    for (int i = gp; i < MTW; i += G) rows_mine |= 1u << i;
  }
  // the first component tile the q tile holds for the moment product:
  // with several chunks, the last pass computes this split's own
  const int qbase = single ? 0 : csplit * SPLIT_N;

  // rows [r0, r0 + R) of [B; A] over components [kc0, kc0 + kn) into ws,
  // asynchronously (padding rows and components zero-filled)
  auto load_ws = [&](int r0, int kc0, int kn) {
    for (int r = r0 + warp; r < min(r0 + R, 2 * Dp); r += NWARPS) {
      const float* src = r < D ? B + (long long)r * K + kc0
                         : r >= Dp && r - Dp < D
                             ? A + (long long)(r - Dp) * K + kc0
                             : nullptr;
      for (int k = lane; k < KS; k += 32)
        cp_async4(ws + (r - r0) * KS + k,
                  src != nullptr && k < kn ? src + k : c,
                  src != nullptr && k < kn);
    }
  };
  auto load_c = [&](int kc0, int kn) {
    for (int k = tid; k < KS; k += NTHREADS) cs[k] = k < kn ? c[kc0 + k] : 0.0f;
  };
  // resident: [B; A] copied once per block, in the first tile's copy group
  if (wres) load_ws(0, 0, K);
  if (single) load_c(0, K);
  if (xres)
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
  // rows [ra, rb) of [x'; -x'^2] of the tile at col0, straight from X, into
  // rows [0, rb - ra) of xb / xm (where x' is not resident)
  auto stage_rows = [&](int ra, int rb, long long col0) {
    for (int e = tid; e < (rb - ra) * T; e += NTHREADS) {
      const int r = ra + e / T, t = e % T;
      const int d = r < Dp ? r : r - Dp;
      float v = 0.0f;
      if (d < D) {
        const float x =
            col0 + t < n ? X[(long long)d * ldx + col0 + t] : 0.0f;
        v = x - g[d];
      }
      split_tf32(r < Dp ? v : -(v * v), xb[(r - ra) * TS + t],
                 xm[(r - ra) * TS + t]);
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
  if (xres && tile < tiles) load_tile(tile);
  cp_async_commit();
  for (; tile < tiles; tile += gridDim.x) {
    const int valid = (int)min((long long)T, (long long)n - tile * T);
    const long long col0 = tile * T;
    if (xres) {
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
    }
    if (!single && tid < T) {
      const long long col = col0 + tid;
      rowm[tid] = md == 2 ? stats[col] : __int_as_float(0xff800000);  // -inf
      rowz[tid] = md == 2 ? stats[ns + col] : 0.0f;
      rowk[tid] = md == 2 ? stats[2 * ns + col] : 0.0f;
    }

    // One pass where the llh tile holds every component. Else, in chunk
    // order, each recomputing a chunk's llh: 0 the running max and sum of
    // exponentials and 1 the kept sum (mode 1), or 2 q of this split's
    // own components only (mode 2).
    const int pass_a = single || md == 1 ? 0 : 2;
    const int pass_b = single ? 1 : md == 1 ? 2 : 3;
    for (int pass = pass_a; pass < pass_b; ++pass) {
      const int cc1 = pass == 2 ? 1 : nchunks;
      for (int cc = 0; cc < cc1; ++cc) {
        const int kc0 = pass == 2 ? qbase * 8 : cc * KC;
        const int kn = min(pass == 2 ? SPLIT_N * 8 : KC, K - kc0);
        const int ntc = (kn + 7) / 8;
        // llh[t][k] = c[k] + sum_r [x' | -x'^2][t][r] ws[r][k], over the
        // chunks of rows of [B; -A] in order: a warp takes NTW 8-component
        // tiles at a time, its x' fragments serving all of them
        for (int r0 = 0; r0 < 2 * Dp; r0 += R) {
          const int r1 = min(r0 + R, 2 * Dp);
          if (!wres) {
            __syncthreads();  // every warp is done with the last chunk
            load_ws(r0, kc0, kn);
            cp_async_commit();
            if (!single && r0 == 0) load_c(kc0, kn);
            if (!xres) stage_rows(r0, r1, col0);
            cp_async_wait_all();  // (the next X tile's copy with it)
            __syncthreads();
          }
          const int xoff = xres ? 0 : r0;
          for (int nt0 = gwork ? nbase - csplit * SPLIT_N : ntc; nt0 < ntc;
               nt0 += wk * NTW) {
            float l[NTW][4] = {};
            for (int k0 = r0 + 8 * gp; k0 < r1; k0 += 8 * G) {
              const int x0 = (k0 - xoff + tq) * TS + gq, x1 = x0 + 4 * TS;
              const uint32_t ab[4] = {xb[x0], xb[x0 + 8], xb[x1], xb[x1 + 8]};
              const uint32_t as[4] = {xm[x0], xm[x0 + 8], xm[x1], xm[x1 + 8]};
              const float* w0 = ws + (k0 - r0 + tq) * KS;
#pragma unroll
              for (int j = 0; j < NTW; ++j) {
                if (nt0 + j >= ntc) break;
                const int kc = (nt0 + j) * 8 + gq;
                uint32_t bb0, bs0, bb1, bs1;
                split_tf32(w0[kc], bb0, bs0);
                split_tf32(w0[4 * KS + kc], bb1, bs1);
                mma_3xtf32(l[j], ab, as, bb0, bb1, bs0, bs1);
              }
            }
            // the first chunk of rows starts from c, a later one adds to
            // the tile this thread wrote for the chunk before; a SMALLK
            // group leaves its partial tile in its own slot
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
              if (nt0 + j >= ntc) break;
              const int k = (nt0 + j) * 8 + 2 * tq;
              float* q0 = (SMALLK ? lred + gp * T * KS : qs) + gq * KS + k;
              float* q1 = q0 + 8 * KS;
              if (SMALLK) {
                q0[0] = l[j][0];
                q0[1] = l[j][1];
                q1[0] = l[j][2];
                q1[1] = l[j][3];
                continue;
              }
              const bool first = r0 == 0;
              q0[0] = (first ? cs[k] : q0[0]) + l[j][0];
              q0[1] = (first ? cs[k + 1] : q0[1]) + l[j][1];
              q1[0] = (first ? cs[k] : q1[0]) + l[j][2];
              q1[1] = (first ? cs[k + 1] : q1[1]) + l[j][3];
            }
          }
          if (SMALLK) {
            __syncthreads();  // every group's partial tile is written
            // group 0 adds the groups' tiles in group order
            for (int nt0 = gwork && gp == 0 ? nbase : ntc; nt0 < ntc;
                 nt0 += wk * NTW) {
#pragma unroll
              for (int j = 0; j < NTW; ++j) {
                if (nt0 + j >= ntc) break;
                const int k = (nt0 + j) * 8 + 2 * tq;
                float* q0 = qs + gq * KS + k;
                float* q1 = q0 + 8 * KS;
                float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
                for (int p = 0; p < G; ++p) {
                  const float* l0 = lred + p * T * KS + gq * KS + k;
                  a0 += l0[0];
                  a1 += l0[1];
                  b0 += l0[8 * KS];
                  b1 += l0[8 * KS + 1];
                }
                const bool first = r0 == 0;
                q0[0] = (first ? cs[k] : q0[0]) + a0;
                q0[1] = (first ? cs[k + 1] : q0[1]) + a1;
                q1[0] = (first ? cs[k] : q1[0]) + b0;
                q1[1] = (first ? cs[k + 1] : q1[1]) + b1;
              }
            }
          }
        }
        __syncthreads();

        // softmax, threshold, renormalize; rows past n -> 0. Where the
        // chunk is at most 16 SV components a half-warp takes a row (a warp
        // two at once), each lane holding SV of its values in registers;
        // else a warp walks a row in shared memory. Fixed shuffle
        // butterflies: the same bits on every run.
        if (kn <= 16 * SV) {
          const int t = 2 * warp + lane / 16, hl = lane % 16;
          float* row = qs + t * KS;
          float v[SV];
          float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
          for (int i = 0; i < SV; ++i) {
            const int k = hl + 16 * i;
            v[i] = k < kn ? row[k] : __int_as_float(0xff800000);
            mx = fmaxf(mx, v[i]);
          }
          mx = half_max(mx);
          if (single) {
            float s = 0.0f;
#pragma unroll
            for (int i = 0; i < SV; ++i) {
              v[i] = hl + 16 * i < kn ? expf(v[i] - mx) : 0.0f;
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
              if (hl + 16 * i < kn) row[hl + 16 * i] = v[i] * inv2;
          } else if (pass == 0) {
            // the running max and sum, rescaled to the new max
            const float m0 = rowm[t], m1 = fmaxf(m0, mx);
            float s = 0.0f;
#pragma unroll
            for (int i = 0; i < SV; ++i)
              s += hl + 16 * i < kn ? expf(v[i] - m1) : 0.0f;
            s = half_sum(s);
            __syncwarp();
            if (hl == 0) {
              rowz[t] = rowz[t] * expf(m0 - m1) + s;
              rowm[t] = m1;
            }
          } else {
            const float m = rowm[t], inv = 1.0f / rowz[t];
            float s2 = 0.0f;
#pragma unroll
            for (int i = 0; i < SV; ++i) {
              const float q = hl + 16 * i < kn ? expf(v[i] - m) * inv : 0.0f;
              v[i] = q > threshold ? q : 0.0f;
              s2 += v[i];
            }
            s2 = half_sum(s2);
            if (pass == 1) {
              __syncwarp();
              if (hl == 0) rowk[t] += s2;
            } else {
              const float inv2 = t < valid ? 1.0f / rowk[t] : 0.0f;
#pragma unroll
              for (int i = 0; i < SV; ++i)
                if (hl + 16 * i < kn) row[hl + 16 * i] = v[i] * inv2;
            }
          }
        } else if (!single) {
          // passes 0 and 1 over a chunk wider than 16 SV components: a
          // warp walks a row in shared memory (pass 2 is never this wide)
          for (int t = warp; t < T; t += NWARPS) {
            const float* row = qs + t * KS;
            float mx = __int_as_float(0xff800000);  // -inf
            const float m0 = rowm[t];
            if (pass == 0) {
              for (int k = lane; k < kn; k += 32) mx = fmaxf(mx, row[k]);
              mx = fmaxf(m0, warp_max(mx));
            }
            const float inv = pass == 0 ? 0.0f : 1.0f / rowz[t];
            float s = 0.0f;
            for (int k = lane; k < kn; k += 32) {
              if (pass == 0) {
                s += expf(row[k] - mx);
              } else {
                const float q = expf(row[k] - m0) * inv;
                s += q > threshold ? q : 0.0f;
              }
            }
            s = warp_sum(s);
            __syncwarp();
            if (lane == 0) {
              if (pass == 0) {
                rowz[t] = rowz[t] * expf(m0 - mx) + s;
                rowm[t] = mx;
              } else {
                rowk[t] += s;
              }
            }
          }
        } else {
          // one chunk of more than 16 SV components
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
      }
    }
    if (md == 1) {  // the column statistics, and no moments
      if (tid < T) {
        stats[col0 + tid] = rowm[tid];
        stats[ns + col0 + tid] = rowz[tid];
        stats[2 * ns + col0 + tid] = rowk[tid];
      }
      continue;
    }

    // where x' is not resident, this split's own rows, restaged
    const int xoff = xres ? 0 : mt0 * 16;
    if (!xres) {
      stage_rows(mt0 * 16, (mt0 + mtn) * 16, col0);
      __syncthreads();
    }
    // [s1'; -s2'] += [x'; -x'^2] (2Dp x T) @ q (T x K); s0 += sum_t q
#pragma unroll
    for (int t0 = 0; t0 < T; t0 += 8) {
      uint32_t qb[NTW][2], qm[NTW][2];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nt = nbase + j;
        float v0 = 0.0f, v1 = 0.0f;
        if (nt < ntiles) {
          const int kq = (nt - qbase) * 8 + gq;
          v0 = qs[(t0 + tq) * KS + kq];
          v1 = qs[(t0 + tq + 4) * KS + kq];
        }
        s0acc[j] += v0 + v1;
        split_tf32(v0, qb[j][0], qm[j][0]);
        split_tf32(v1, qb[j][1], qm[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        if (i >= mtn) break;
        if (!((rows_mine >> i) & 1u)) continue;
        const int r0 = ((mt0 + i) * 16 + gq - xoff) * TS + t0 + tq;
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
    if (!xres) __syncthreads();  // the next tile restages xb
  }

  cp_async_wait_all();  // a block past the last tile has copies in flight
  if (md == 1) return;

  // this block's partial: [s0 (K) | s1' (D x K) | s2' (D x K)]
  float* dst = partial + (long long)blockIdx.x * (K + 2LL * D * K);
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    float v = s0acc[j];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int k = (nbase + j) * 8 + gq;
    if (rsplit == 0 && gp == 0 && tq == 0 && k < K) dst[k] = v;
  }
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    if (i >= mtn) break;
    if (!((rows_mine >> i) & 1u)) continue;
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
  int XR;       // rows of [x'; -x'^2] shared memory holds (2Dp: resident)
  int KC;       // components of a chunk (K: the llh tile holds them all)
  int rsplits;  // splits of the accumulated rows of [x'; x'^2] (grid y)
  int csplits;  // splits of the accumulated components (grid z)
  int blocks;   // blocks along n (grid x)
  long long smem;
};

// The kernel instantiation a launch takes: WIDE past the resident tiles,
// else SMALLK where the component tiles need fewer than NWARPS warps.
using FvKernel = void (*)(const float*, long long, const float*, const float*,
                          const float*, const float*, float*, float*,
                          long long, int, int, int, int, int, int, float, int);
FvKernel fv_kernel(bool wide, int K) {
  if (wide) return fv_moments_kernel<true, false>;
  return warp_groups((K + 7) / 8) > 1 ? fv_moments_kernel<false, true>
                                      : fv_moments_kernel<false, false>;
}

// The opt-in to 227 KB of dynamic shared memory, once per device, before
// any plan, so the occupancy a plan reads is the one its launch gets (the
// opt-in does not lower occupancy: a launch is placed by the bytes it
// asks for).
cudaError_t opt_in(int dev) {
  static int opted_in_device = -1;
  if (opted_in_device == dev) return cudaSuccess;
  for (FvKernel k : {fv_moments_kernel<false, false>,
                     fv_moments_kernel<false, true>,
                     fv_moments_kernel<true, false>}) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
    if (err != cudaSuccess) return err;
  }
  opted_in_device = dev;
  return cudaSuccess;
}

// The launch plan for (D, n, K) on the current device, the first that fits
// one block's shared memory of: every component in the llh tile, then
// chunks of SPLIT_N * 8 components; for each, every row of [x'; -x'^2]
// staged from a raw X tile, then rows staged straight from X in chunks of
// at least one row split's 160 (or all 2Dp). With them as many rows of
// [B; -A] as fit (a multiple of 8, at most all 2Dp, at least 8), the row
// and component splits the register accumulators need, and as many blocks
// as the SMs hold at once, at most one a tile. Every positive (D, K) has a
// plan: the last form needs about 1.3 KB a row of [B; -A] and 17 KB more.
bool make_plan(int D, int n, int K, Plan* p) {
  int dev = 0, sms = 0;
  if (D <= 0 || n <= 0 || K <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || opt_in(dev) != cudaSuccess)
    return false;
  const int Dp = (D + 7) / 8 * 8;
  const int ntiles = (K + 7) / 8;
  const long long tiles = ((long long)n + T - 1) / T;
  // every component, else the widest chunk (a multiple of SPLIT_N * 8)
  // beside which at least min(2Dp, 64) rows of [B; -A] fit
  for (int KC = K; KC == K || KC >= SPLIT_N * 8;
       KC = KC == K ? (K - 1) / (SPLIT_N * 8) * (SPLIT_N * 8)
               : KC - SPLIT_N * 8) {
    if (KC <= 0) break;
    const int KS = comp_stride((KC + 7) / 8);
    for (bool xres : {true, false}) {
      // one chunk of every component with x' resident takes the
      // non-WIDE instantiations: SMALLK where the groups are several
      const int lg = KC == K && xres ? warp_groups((KC + 7) / 8) : 1;
      const int xmin = xres ? 2 * Dp : std::min(2 * Dp, MTW * 16);
      const long long room =
          SMEM_LIMIT / 4 - smem_floats(D, Dp, KS, 0, xmin, xres, lg);
      if (room <= 0) continue;
      // rows past xmin also widen the x' buffer where it is not resident
      long long R = std::min<long long>(2 * Dp, room / KS);
      if (!xres && R > xmin)
        R = std::max<long long>(
            xmin, std::min<long long>(2 * Dp, (room + 2LL * xmin * TS) /
                                                  (KS + 2 * TS)));
      R = R / 8 * 8;
      if (R < (KC == K ? 8 : std::min(2 * Dp, 64))) continue;
      const int XR = xres ? 2 * Dp : (int)std::max<long long>(xmin, R);
      const long long smem =
          4 * smem_floats(D, Dp, KS, (int)R, XR, xres, lg);
      // blocks an SM holds at once: the shared-memory bound, lowered to
      // what the instantiation's registers allow (one, at 160
      // accumulators a thread), as the runtime reports it
      long long per_sm = std::max<long long>(
          1, std::min<long long>(2048 / NTHREADS, SMEM_LIMIT / smem));
      int resident = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &resident, fv_kernel(KC < K || XR < 2 * Dp, K), NTHREADS,
              (size_t)smem) == cudaSuccess &&
          resident > 0)
        per_sm = std::min<long long>(per_sm, resident);
      else
        (void)cudaGetLastError();
      *p = {(int)R,
            XR,
            KC,
            (Dp / 8 + MTW - 1) / MTW,
            (ntiles + SPLIT_N - 1) / SPLIT_N,
            (int)std::min<long long>(tiles, sms * per_sm),
            smem};
      return p->rsplits <= 65535 && p->csplits <= 65535;
    }
  }
  return false;
}

}  // namespace

extern "C" {

// Floats of the scratch that fv_moments_f32 needs on the current device
// for (D, n, K): the blocks' partials (blocks, K + 2 D K), then, where the
// components go in chunks, three statistics a descriptor column (3,
// tiles x T); or -1 where a size is not positive (or D or K passes 65535
// splits of the accumulators).
long long fv_moments_scratch_floats(int D, int n, int K) {
  Plan p;
  if (!make_plan(D, n, K, &p)) return -1;
  const long long ns = ((long long)n + T - 1) / T * T;
  return (long long)p.blocks * (K + 2LL * D * K) + (p.KC < K ? 3 * ns : 0);
}

// out = [s0 (K) | s1 (D, K) | s2 (D, K)], contiguous float32, for X (D, n)
// float32 with row stride ldx (unit column stride), the center g (D), A =
// 0.5 / var and B = (means - g) / var contiguous (D, K), c (K) the llh
// constants of the centered means. `partial` is a float32 scratch of
// fv_moments_scratch_floats(D, n, K) floats. Launches the moments kernel
// (twice where the components go in chunks: the column statistics, then
// the moments) and the block-order reduce on `stream` on the current
// device and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the launch cannot take.
int fv_moments_f32(const float* X, long long ldx, const float* g,
                   const float* A, const float* B, const float* c,
                   float* out, float* partial, int D, int n, int K,
                   float threshold, void* stream) {
  Plan p;
  if (ldx < n || partial == nullptr || !make_plan(D, n, K, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)p.blocks, (unsigned)p.rsplits,
                  (unsigned)p.csplits);
  const bool chunks = p.KC < K;
  const bool wide = chunks || p.XR < 2 * ((D + 7) / 8 * 8);
  const long long ns = ((long long)n + T - 1) / T * T;
  float* stats = partial + (long long)p.blocks * (K + 2LL * D * K);
  if (chunks) {  // the column statistics first, once for every split
    fv_moments_kernel<true, false><<<(unsigned)p.blocks, NTHREADS,
                                     (size_t)p.smem, st>>>(
        X, ldx, g, A, B, c, partial, stats, ns, D, n, K, p.R, p.XR, p.KC,
        threshold, 1);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  fv_kernel(wide, K)<<<grid, NTHREADS, (size_t)p.smem, st>>>(
      X, ldx, g, A, B, c, partial, stats, ns, D, n, K, p.R, p.XR, p.KC,
      threshold, chunks ? 2 : 0);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long DK = (long long)D * K;
  reduce_uncenter_kernel<<<(unsigned)((DK + RENTRIES - 1) / RENTRIES),
                           RTHREADS, 0, st>>>(partial, g, out, D, K,
                                              p.blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
