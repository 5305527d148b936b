// Quantized affine apply for Hopper (sm_90a):
//   out = ((X - mean) * inv_std) @ (float(Wq) * scale) + b
// with X (n, d) float32, Wq (d, k) bfloat16 or int8, and scale (k),
// mean (d), inv_std (d), b (k) float32; out (n, k) float32.
//
// Replaces keystone_tpu/ops/pallas_kernels.py::quantized_affine_pallas
// (the Pallas TPU kernel _quantized_affine_kernel and its wrapper). The
// plain PyTorch version of the same function is
// keystone_tpu_torch/ops/kernels.py::quantized_affine_plain.
//
// Semantics. Dequantize, then a float32 matrix product with float32
// accumulation: the weights are widened exactly (bfloat16 and int8 are
// exact in float32) and multiplied by their column scale in float32, as
// the plain version does; X is normalized with the same two float32
// operations. Only the order of the sums differs. No tensor core is used:
// an int8 or bfloat16 product would change the numerics and would need a
// parity bar of its own.
//
// What bounds it. The work is 2 n d k + 3 n d operations against
// 4 n d + d k w + 4 (2 d + 2 k) + 4 n k bytes (w the weight's byte
// width). With k = 10 that is about 5 operations per byte, far below the
// card's float32 ridge point (67 TFLOP/s over 3.35 TB/s = 20 per byte):
// the kernel is bound by reading X. At the serving shapes (n <= 64,
// d = 8192) the bytes take under a microsecond, so the launch itself
// dominates.
//
// What the design does about it.
//  * The TPU kernel keeps the whole (d, k) weight block and its f32
//    dequantized copy resident in VMEM. On Hopper that does not fit: at
//    d = 8192 and k = 10 the f32 copy alone is 320 KB, above the 227 KB
//    a block may use. So d is streamed in slabs of 256: the block stages
//    the slab's weight rows, dequantized with their column scale, in
//    shared memory (column-major, so the 32 lanes of a warp read 32
//    consecutive depths of one column, on 32 banks).
//  * X is read once, straight from device memory into registers, never
//    staged: each warp owns 4 rows and streams them along d, lane l
//    taking depths l, l + 32, ..., so every load is 128 contiguous bytes
//    of one row and a row's slab is 1 KB read in order. A lane issues
//    all 32 of a slab's X loads (predicated, without a branch) before
//    the weights are staged and before any FMA, so they are in flight
//    together. Earlier versions staged X slabs through shared memory
//    (0.269 and 0.195 ms at n = 4096, PERF.md); a version with a branch
//    around each depth's loads kept only 4 KB of X in flight per SM.
//  * Each lane accumulates its depths' products for the warp's 4 rows x
//    16 columns in registers; the warp then adds its 32 lanes with a
//    fixed butterfly of shuffles. About 200 registers a thread: one
//    block per SM.
//  * Every shape is taken: n, k and d are tiled and their ragged edges
//    masked (rows and columns past the edge load as zeros and are not
//    written), so there is no fit predicate.
//  * Occupancy at small n: a grid over row tiles alone would be a
//    handful of blocks on 132 SMs, so d is also split across blocks
//    (grid z). Each split writes its partial sums into a (splits, n, k)
//    scratch the wrapper allocates; a second small launch adds them in
//    split order and adds b. With one split the first launch adds b and
//    writes the output itself.
//  * No atomics and a fixed summation order: a batch gives the same bits
//    on every run, which the serving plane's eviction / readmission
//    contract relies on.
//
// Built by nvcc into a shared library with a plain C entry point per
// weight type and loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 16;               // output columns per block
constexpr int WR = 4;                // rows per warp
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RT = WR * NWARPS;      // rows per block
constexpr int DS = 256;              // slab depth along d
constexpr int PER_LANE = DS / 32;    // depths per lane per slab
constexpr int WLOADS = DS * KT / NTHREADS;

__device__ inline float widen(uint16_t bits) {  // bfloat16 -> float32
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ inline float widen(int8_t q) { return static_cast<float>(q); }

template <typename WT>
__global__ void __launch_bounds__(NTHREADS)
quantized_affine_kernel(const float* __restrict__ X, long long ldx,
                        const WT* __restrict__ Wq,
                        const float* __restrict__ scale,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        const float* __restrict__ b, float* __restrict__ out,
                        int n, int d, int k, int dsplit, int add_bias) {
  __shared__ float ws[KT * DS];  // [column][depth]

  const int c0 = blockIdx.y * KT;
  const int split = blockIdx.z;
  const int dbeg = split * dsplit;
  const int dend = min(dbeg + dsplit, d);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * RT + warp * WR;  // the warp's first row

  const float* xr[WR];
  bool ok[WR];
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    ok[r] = row0 + r < n;
    xr[r] = X + (long long)(ok[r] ? row0 + r : 0) * ldx;
  }
  float acc[WR][KT];
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[r][c] = 0.0f;

  for (int s0 = dbeg; s0 < dend; s0 += DS) {
    // the slab's X loads first (predicated, no branch), so a lane has
    // its 4 rows x 8 depths in flight while the weights are staged
    float x[PER_LANE][WR], m[PER_LANE], iv[PER_LANE];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int col = s0 + lane + 32 * t;
      const bool in = col < dend;
      m[t] = in ? mean[col] : 0.0f;
      iv[t] = in ? inv[col] : 0.0f;
#pragma unroll
      for (int r = 0; r < WR; ++r) x[t][r] = (in && ok[r]) ? xr[r][col] : 0.0f;
    }
    // the dequantized weight slab, column-major
#pragma unroll
    for (int q = 0; q < WLOADS; ++q) {
      const int e = tid + q * NTHREADS;
      const int c = e / DS, jj = e % DS;
      const int col = s0 + jj, kc = c0 + c;
      ws[e] = (col < dend && kc < k)
                  ? widen(Wq[(long long)col * k + kc]) * scale[kc]
                  : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int jj = lane + 32 * t;
      float xn[WR];
#pragma unroll
      for (int r = 0; r < WR; ++r)
        xn[r] = ok[r] ? (x[t][r] - m[t]) * iv[t] : 0.0f;
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const float w = ws[c * DS + jj];
#pragma unroll
        for (int r = 0; r < WR; ++r) acc[r][c] = fmaf(xn[r], w, acc[r][c]);
      }
    }
    __syncthreads();  // the slab is read before the next one is staged
  }

  // every lane ends with the sums over all 32 lanes, in a fixed order
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);

  float* dst = out + (long long)split * n * k;
#pragma unroll
  for (int c = 0; c < KT; ++c) {
    const int kc = c0 + c;
    if (lane != c || kc >= k) continue;
    const float bias = add_bias ? b[kc] : 0.0f;
#pragma unroll
    for (int r = 0; r < WR; ++r)
      if (ok[r]) dst[(long long)(row0 + r) * k + kc] = acc[r][c] + bias;
  }
}

// out[i] = (sum over splits s, in order, of partial[s][i]) + b[i % k]
__global__ void __launch_bounds__(NTHREADS)
reduce_splits_kernel(const float* __restrict__ partial,
                     const float* __restrict__ b, float* __restrict__ out,
                     long long nk, int k, int splits) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= nk) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[(long long)s * nk + i];
  out[i] = acc + b[i % k];
}

template <typename WT>
int launch(const float* X, long long ldx, const WT* Wq, const float* scale,
           const float* mean, const float* inv, const float* b, float* out,
           float* partial, int n, int d, int k, int dsplit, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0 || dsplit <= 0 || dsplit % DS != 0)
    return (int)cudaErrorInvalidValue;
  const int splits = (d + dsplit - 1) / dsplit;
  const long long row_tiles = (n + RT - 1) / RT;
  const long long col_tiles = (k + KT - 1) / KT;
  if (row_tiles > 2147483647LL || col_tiles > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles, (unsigned)splits);
  quantized_affine_kernel<WT><<<grid, NTHREADS, 0, st>>>(
      X, ldx, Wq, scale, mean, inv, b, splits > 1 ? partial : out, n, d, k,
      dsplit, splits > 1 ? 0 : 1);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long long nk = (long long)n * k;
  const long long blocks = (nk + NTHREADS - 1) / NTHREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  reduce_splits_kernel<<<(unsigned)blocks, NTHREADS, 0, st>>>(
      partial, b, out, nk, k, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n, k) = ((X - mean) * inv) @ (float(Wq) * scale) + b, for X
// (n, d) float32 with row stride ldx (unit column stride), Wq (d, k)
// contiguous, the vectors contiguous float32. d is split into
// ceil(d / dsplit) parts (dsplit a multiple of 256); with more than one,
// `partial` is a contiguous (splits, n, k) float32 scratch. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the launch cannot take.
int quantized_affine_bf16(const float* X, long long ldx, const uint16_t* Wq,
                          const float* scale, const float* mean,
                          const float* inv, const float* b, float* out,
                          float* partial, int n, int d, int k, int dsplit,
                          void* stream) {
  return launch<uint16_t>(X, ldx, Wq, scale, mean, inv, b, out, partial, n,
                          d, k, dsplit, stream);
}

int quantized_affine_int8(const float* X, long long ldx, const int8_t* Wq,
                          const float* scale, const float* mean,
                          const float* inv, const float* b, float* out,
                          float* partial, int n, int d, int k, int dsplit,
                          void* stream) {
  return launch<int8_t>(X, ldx, Wq, scale, mean, inv, b, out, partial, n, d,
                        k, dsplit, stream);
}

}  // extern "C"
