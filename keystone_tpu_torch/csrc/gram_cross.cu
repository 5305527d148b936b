// Fused Gram and cross products for Hopper (sm_90a), accumulated in
// place: G += X^T X and C += X^T Y in one launch over the rows of X.
//
// Replaces keystone_tpu/ops/pallas_kernels.py::gram_cross_pallas (the
// Pallas TPU kernel _gram_cross_kernel and its wrapper). The plain
// PyTorch version of the same function is
// keystone_tpu_torch/ops/kernels.py::gram_cross_plain.
//
// What bounds it. For X (n, d) and Y (n, k) the work is 2 n (d (d + 1)
// / 2 + d k) FLOP when only the upper triangle of the symmetric G is
// computed, against 4 (n d + n k + 2 d^2 + 2 d k) bytes (X and Y read
// once, G and C read and written once). At the streamed fit's chunk
// shape (n = 1024, d = 8192, k = 10) that is 68.9 GFLOP against 570 MB:
// about 120 FLOP per byte, far above the card's float32 ridge point (67
// TFLOP/s over 3.35 TB/s = 20 FLOP per byte), so the kernel is bound by
// arithmetic.
//
// What the design does about it.
//  * Only the upper-triangle tiles of G are computed (nt (nt + 1) / 2 of
//    the nt^2 tiles, nt = ceil(d / 128)), halving the work of the square
//    product; each off-diagonal tile is added both at (i, j) and, through
//    a transpose in shared memory, at (j, i), so the carry holds the full
//    symmetric G. A diagonal tile is computed whole; its (a, b) and
//    (b, a) entries come from the same products in the same order, so it
//    is exactly symmetric.
//  * One block owns one 128 x 128 output tile of [G | C] and loops over
//    every row of X in slabs of 8 rows. A tile of 128 reads 32 FLOP per
//    byte of its two column slabs from L2; the first version's 64 x 64
//    tile read 16, and at the f32 peak that needs about 4.2 TB/s of L2
//    bandwidth, which held it at 21 TFLOP/s, below cuBLAS.
//  * Each of the 256 threads keeps an 8 x 8 register tile (two 4-row by
//    two 4-column groups, 64 apart, so a warp's 16-byte shared loads are
//    contiguous or broadcast): four 16-byte shared loads per 64 FMAs.
//  * The next slab is loaded into registers while the current one is
//    multiplied, and stored into the other of two shared buffers: one
//    barrier per slab, and the global loads overlap the FMAs.
//  * In place: the block adds its tile into the carry once, after its
//    last slab. The TPU form, (g, c) = gram_cross(X, Y) followed by
//    G + g, would allocate a (d, d) temporary (268 MB at d = 8192) and
//    pass over it twice more per chunk.
//  * Every output tile has exactly one owner and a fixed row order, so
//    there are no atomics and results are bit-reproducible.
//  * True float32 FMAs on the CUDA cores, the precision of the plain
//    version (cuBLAS with TF32 off); no TF32 in any form.
//  * Ragged n, d and k are masked in the kernel: rows and columns past
//    the edge load as zeros and their outputs are not written.
//  * The TPU kernel's d ~ 896 ceiling (its (d, d) accumulator had to fit
//    VMEM) does not exist here: the accumulator is the carry in device
//    memory, and at d = 8192 the grid holds 2080 + 64 blocks, about 8
//    waves of 2 blocks on each of the 132 SMs, so the rows are not split
//    across blocks.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;       // output tile edge
constexpr int HALF = TILE / 2;  // the register tile's two groups, 64 apart
constexpr int BK = 8;           // rows of X per shared-memory slab
constexpr int NTHREADS = 256;   // 16 x 16 threads
constexpr int TPAD = TILE + 1;  // row stride of the epilogue's staged rows
constexpr int SLAB = BK * TILE;                // floats in one slab
constexpr int LOADS = SLAB / NTHREADS;         // slab values per thread
constexpr int SMEM_FLOATS =
    (4 * SLAB > HALF * TPAD) ? 4 * SLAB : HALF * TPAD;

// Block t of the grid -> output tile (bi, bj). The first n_tri blocks
// walk the upper triangle of G column by column (t = bj (bj + 1) / 2 +
// bi, bi <= bj); the rest walk the tiles of C, (bi, bj) = (t % nt,
// t / nt).
__device__ inline void tile_of(long long t, long long n_tri, int nt,
                               int* bi, int* bj, bool* is_c) {
  if (t < n_tri) {
    long long j = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while (j * (j + 1) / 2 > t) --j;
    while ((j + 1) * (j + 2) / 2 <= t) ++j;
    *bj = (int)j;
    *bi = (int)(t - j * (j + 1) / 2);
    *is_c = false;
  } else {
    t -= n_tri;
    *bi = (int)(t % nt);
    *bj = (int)(t / nt);
    *is_c = true;
  }
}

// Row (or column) of the tile held by register index m of a thread at
// position p (ty for rows, tx for columns): two groups of 4, 64 apart.
__device__ inline int tile_index(int p, int m) {
  return (m < 4) ? p * 4 + m : HALF + p * 4 + (m - 4);
}

__global__ void __launch_bounds__(NTHREADS, 2)
gram_cross_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                  float* __restrict__ G, float* __restrict__ C, int n, int d,
                  int k, long long ldx, long long ldy, int nt,
                  long long n_tri) {
  // two buffers of the (A, B) slab pair during the row loop; half of the
  // staged output tile after it
  __shared__ __align__(16) float smem[SMEM_FLOATS];

  int bi, bj;
  bool is_c;
  tile_of(blockIdx.x, n_tri, nt, &bi, &bj, &is_c);
  const int i0 = bi * TILE, j0 = bj * TILE;
  const float* B = is_c ? Y : X;
  const long long ldb = is_c ? ldy : ldx;
  const int bcols = is_c ? k : d;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.0f;

  // slab loads: consecutive threads take consecutive columns of one row,
  // so each warp reads 128 contiguous bytes of X (or Y). Slab element
  // e = tid + q * NTHREADS is row lr + q * RSTEP, column lc, of the slab:
  // each thread loads one fixed column, through two pointers formed once
  // and advanced by BK rows per slab.
  constexpr int RSTEP = NTHREADS / TILE;
  const int lr = tid / TILE, lc = tid % TILE;
  const bool a_col = i0 + lc < d, b_col = j0 + lc < bcols;
  const float* pa_src = X + (long long)lr * ldx + i0 + lc;
  const float* pb_src = B + (long long)lr * ldb + j0 + lc;
  const long long a_step = RSTEP * ldx, b_step = RSTEP * ldb;
  float pa[LOADS], pb[LOADS];
  auto load = [&](int r0) {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const bool row = r0 + lr + q * RSTEP < n;
      pa[q] = (row && a_col) ? pa_src[q * a_step] : 0.0f;
      pb[q] = (row && b_col) ? pb_src[q * b_step] : 0.0f;
    }
    pa_src += BK * ldx;
    pb_src += BK * ldb;
  };
  auto store = [&](int buf) {
    float* As = smem + buf * 2 * SLAB;
    float* Bs = As + SLAB;
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      As[tid + q * NTHREADS] = pa[q];
      Bs[tid + q * NTHREADS] = pb[q];
    }
  };

  const int nslabs = (n + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < nslabs; ++s) {
    const int cur = s & 1;
    if (s + 1 < nslabs) load((s + 1) * BK);
    const float* As = smem + cur * 2 * SLAB;
    const float* Bs = As + SLAB;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * TILE + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + kk * TILE + HALF + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * TILE + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + kk * TILE + HALF + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(a[m], b[j], acc[m][j]);
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < nslabs) store(cur ^ 1);
    __syncthreads();
  }

  // direct add: G[i0 + r, j0 + c] (or C) += tile[r, c], from registers;
  // 16-byte read-modify-writes where the row stride and the base address
  // allow (a contiguous view at an odd storage offset is not 16-byte
  // aligned), so a warp covers 256 contiguous bytes of two rows
  float* out = is_c ? C : G;
  const int ldo = is_c ? k : d;
  const bool vec = ldo % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int r = i0 + tile_index(ty, m);
    if (r >= d) continue;
    float* row = out + (long long)r * ldo;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = j0 + g * HALF + tx * 4;
      if (vec && c + 3 < bcols) {
        float4* p4 = reinterpret_cast<float4*>(row + c);
        float4 v = *p4;
        v.x += acc[m][g * 4 + 0];
        v.y += acc[m][g * 4 + 1];
        v.z += acc[m][g * 4 + 2];
        v.w += acc[m][g * 4 + 3];
        *p4 = v;
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (c + jj < bcols) row[c + jj] += acc[m][g * 4 + jj];
      }
    }
  }
  if (is_c || bi == bj) return;

  // the mirror tile, G[j0 + c, i0 + r] += tile[r, c], staged 64 rows of
  // the tile at a time through shared memory (the slabs are no longer
  // read), so consecutive threads add to consecutive columns of G
  float* T = smem;  // [HALF][TPAD]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        T[(ty * 4 + mm) * TPAD + tile_index(tx, j)] = acc[h * 4 + mm][j];
    __syncthreads();
    for (int e = tid; e < HALF * TILE; e += NTHREADS) {
      const int c = e / HALF, a = e % HALF;  // tile column, row in half
      const int gr = j0 + c, gc = i0 + h * HALF + a;
      if (gr < d && gc < d) G[(long long)gr * d + gc] += T[a * TPAD + c];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// G (d, d) += X^T X and C (d, k) += X^T Y for X (n, d) with row stride
// ldx and Y (n, k) with row stride ldy; G and C are contiguous. Launches
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when the grid would exceed 2^31 - 1 blocks.
int gram_cross_f32(const float* X, const float* Y, float* G, float* C, int n,
                   int d, int k, long long ldx, long long ldy, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const int nt = (d + TILE - 1) / TILE;
  const int nkt = (k + TILE - 1) / TILE;
  const long long n_tri = (long long)nt * (nt + 1) / 2;
  const long long blocks = n_tri + (long long)nt * nkt;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  gram_cross_kernel<<<(unsigned)blocks, NTHREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      X, Y, G, C, n, d, k, ldx, ldy, nt, n_tri);
  return (int)cudaGetLastError();
}

}  // extern "C"
