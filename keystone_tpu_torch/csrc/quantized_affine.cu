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
// d = 8192) the bytes take under a microsecond, so latency and the
// launch dominate.
//
// What the design does about it.
//  * One launch a call, and no scratch. A block takes RT = 16 rows and a
//    run of 256-deep slabs of d (1 KB of each row, read in one run); where the row tiles alone cannot fill
//    the card, d is split across the blocks of a thread-block cluster
//    (grid y, up to 8 blocks), and the cluster's rank 0 adds the other
//    blocks' partial sums through distributed shared memory in rank
//    order. The sums, and so the bits, do not depend on the schedule.
//  * The column count is a compile-time parameter KC, even and matched to
//    k (k = 10 runs 10 columns; k past 16 runs tiles of 16, grid z).
//  * X streams through a ring of STAGES shared-memory slabs filled by
//    cp.async (16-byte copies where X's rows allow, else 4-byte), so the
//    bytes in flight do not depend on registers. The weight slab, the
//    mean and inv_std go through the same ring: the weights at their
//    narrow width, widened and scaled as they are read.
//  * The weights, mean and inv_std are laid out once per model and
//    device by the wrapper (ops/kernels.py::quant_plan): (ctiles, dpad,
//    KC) narrow weights and dpad-long vectors, zero past d and k, so
//    every slab copy is whole and aligned.
//  * A thread takes 4 depths of each slab for 4 rows x KC columns (a
//    warp 4 rows, 2 warps 64 depths at a time); its warp's lanes are
//    added by a fixed butterfly of shuffles, then the 2 depth-group warps
//    in order, then the cluster's blocks in rank order. No atomics: a batch gives the same bits on every run, which
//    the serving plane's eviction / readmission contract relies on.
//  * Every shape is taken: rows past n load as zeros and are not written,
//    depths past d are zero, columns past k are not written.
//
// Built by nvcc into a shared library with a plain C entry point per
// weight type and loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TR = 4;               // rows a thread accumulates
constexpr int RG = 4;               // row groups of a block
constexpr int RT = TR * RG;         // rows a block
constexpr int DG = NWARPS / RG;     // depth groups: a warp takes 32 depths
constexpr int DSUB = 4;             // depths a thread takes in a slab
constexpr int DS = 32 * DG * DSUB;  // slab depth along d
constexpr int STAGES = 3;           // slabs in the ring
constexpr int MAX_SPLITS = 8;       // blocks of a cluster along d
constexpr int KMAX = 16;            // widest column tile
constexpr int MIN_BLOCKS = 2;       // blocks an SM holds (launch bounds)

__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ inline void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two narrow weights -> two float32 (bfloat16 pairs as one 32-bit word,
// int8 pairs as one 16-bit word)
__device__ inline void widen2(const uint16_t* w, float& a, float& b) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(w);
  a = __uint_as_float(v << 16);
  b = __uint_as_float(v & 0xffff0000u);
}
__device__ inline void widen2(const int8_t* w, float& a, float& b) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(w);
  a = (float)(int8_t)(v & 0xff);
  b = (float)(int8_t)(v >> 8);
}

template <typename WT, int KC>
struct Stage {
  float x[RT][DS];
  float mean[DS];
  float inv[DS];
  WT w[DS * KC];
};

template <typename WT, int KC>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
quantized_affine_kernel(const float* __restrict__ X, long long ldx, int xvec,
                        const WT* __restrict__ Wt,
                        const float* __restrict__ scale,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        const float* __restrict__ b, float* __restrict__ out,
                        int n, int d, int k, int dpad, int sps) {
  using St = Stage<WT, KC>;
  extern __shared__ __align__(16) unsigned char smem[];
  St* ring = reinterpret_cast<St*>(smem);
  __shared__ float wpart[NWARPS][TR][KC];
  __shared__ float bpart[RT * KC];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // the block's split of d
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = warp / DG, dg = warp % DG;
  const int row0 = blockIdx.x * RT;
  const int ct = blockIdx.z, c0 = ct * KC;
  const int slabs = dpad / DS;
  const int s0 = min(rank * sps, slabs), ns = min(slabs, s0 + sps) - s0;
  const WT* wsrc = Wt + (long long)ct * dpad * KC;

  // slab s into ring stage st: X rows (zero past n and d), the weights,
  // mean and inv_std (laid out whole by the wrapper)
  auto copy_stage = [&](int st, int s) {
    St& S = ring[st];
    const int col0 = s * DS;
    if (xvec) {
      for (int e = tid; e < RT * DS / 4; e += NTHREADS) {
        const int r = e / (DS / 4), c4 = (e % (DS / 4)) * 4;
        const int col = col0 + c4;
        const bool in = row0 + r < n && col < d;
        const int bytes = in ? 4 * min(4, d - col) : 0;
        cp_async16(&S.x[r][c4],
                   in ? X + (long long)(row0 + r) * ldx + col : X, bytes);
      }
    } else {
      for (int e = tid; e < RT * DS; e += NTHREADS) {
        const int r = e / DS, c = e % DS, col = col0 + c;
        const bool in = row0 + r < n && col < d;
        cp_async4(&S.x[r][c], in ? X + (long long)(row0 + r) * ldx + col : X,
                  in ? 4 : 0);
      }
    }
    constexpr int WCH = DS * KC * (int)sizeof(WT) / 16;
    for (int e = tid; e < WCH + DS / 2; e += NTHREADS) {
      if (e < WCH)
        cp_async16(reinterpret_cast<char*>(S.w) + 16 * e,
                   reinterpret_cast<const char*>(wsrc + (long long)col0 * KC) +
                       16 * e,
                   16);
      else if (e < WCH + DS / 4)
        cp_async16(&S.mean[(e - WCH) * 4], mean + col0 + (e - WCH) * 4, 16);
      else
        cp_async16(&S.inv[(e - WCH - DS / 4) * 4],
                   inv + col0 + (e - WCH - DS / 4) * 4, 16);
    }
  };

  float sc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) sc[c] = c0 + c < k ? scale[c0 + c] : 0.0f;
  float acc[TR][KC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[i][c] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ns) copy_stage(i, s0 + i);
    cp_async_commit();
  }
  const int j = dg * 32 + lane;  // this thread's first depth in a slab
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab i is in; every thread is done with slab i - 1
    if (i + STAGES - 1 < ns)
      copy_stage((i + STAGES - 1) % STAGES, s0 + i + STAGES - 1);
    cp_async_commit();
    const St& S = ring[i % STAGES];
#pragma unroll
    for (int t = 0; t < DSUB; ++t) {
      const int jt = j + t * 32 * DG;
      float w[KC];
#pragma unroll
      for (int c = 0; c < KC; c += 2) {
        widen2(S.w + jt * KC + c, w[c], w[c + 1]);
        w[c] *= sc[c];
        w[c + 1] *= sc[c + 1];
      }
      const float m = S.mean[jt], iv = S.inv[jt];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float xn = (S.x[rg * TR + r][jt] - m) * iv;
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[r][c] = fmaf(xn, w[c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();

  // the warp's 32 depths, by a fixed butterfly; then the depth groups in
  // order; then the cluster's blocks in rank order
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) wpart[warp][r][c] = acc[r][c];
  __syncthreads();
  if (tid < RT * KC) {
    const int r = tid / KC, c = tid % KC;
    const int g = r / TR;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < DG; ++q) s += wpart[g * DG + q][r % TR][c];
    bpart[tid] = s;
  }
  cluster.sync();  // every block's partial is in its shared memory
  if (rank == 0 && tid < RT * KC) {
    const int r = tid / KC, c = tid % KC;
    float s = 0.0f;
    for (int q = 0; q < (int)cluster.num_blocks(); ++q)
      s += cluster.map_shared_rank(bpart, q)[tid];
    if (row0 + r < n && c0 + c < k)
      out[(long long)(row0 + r) * k + c0 + c] = s + b[c0 + c];
  }
  cluster.sync();  // rank 0 has read every block's partial
}

template <typename WT, int KC>
int launch(const float* X, long long ldx, const WT* Wt, const float* scale,
           const float* mean, const float* inv, const float* b, float* out,
           int n, int d, int k, int dpad, int splits, int sps,
           cudaStream_t st) {
  const int ctiles = (k + KC - 1) / KC;
  const long long row_tiles = (n + RT - 1) / RT;
  const int slabs = dpad / DS;
  if (dpad % DS != 0 || dpad < d || splits < 1 || splits > MAX_SPLITS ||
      sps < 1 || (long long)splits * sps < slabs ||
      (long long)(splits - 1) * sps >= slabs || ctiles > 65535 ||
      row_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = STAGES * sizeof(Stage<WT, KC>);
  // the opt-in to dynamic shared memory above 48 KB, once per device
  static int opted_in_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && opted_in_device != dev) {
    err = cudaFuncSetAttribute(quantized_affine_kernel<WT, KC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) opted_in_device = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const int xvec = (reinterpret_cast<uintptr_t>(X) % 16 == 0 && ldx % 4 == 0)
                       ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)row_tiles, (unsigned)splits, (unsigned)ctiles);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, quantized_affine_kernel<WT, KC>, X, ldx, xvec,
                         Wt, scale, mean, inv, b, out, n, d, k, dpad, sps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename WT>
int dispatch(const float* X, long long ldx, const WT* Wt, const float* scale,
             const float* mean, const float* inv, const float* b, float* out,
             int n, int d, int k, int kc, int dpad, int splits, int sps,
             void* stream) {
  if (n <= 0 || d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KEYSTONE_CASE(w)                                                  \
  if (kc == w)                                                            \
    return launch<WT, w>(X, ldx, Wt, scale, mean, inv, b, out, n, d, k,   \
                         dpad, splits, sps, st);
  KEYSTONE_CASE(2) KEYSTONE_CASE(4) KEYSTONE_CASE(6) KEYSTONE_CASE(8)
  KEYSTONE_CASE(10) KEYSTONE_CASE(12) KEYSTONE_CASE(14) KEYSTONE_CASE(16)
#undef KEYSTONE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The kernel's fixed geometry, for the wrapper's launch plan: rows a
// block, slab depth, blocks of a cluster along d, widest column tile,
// blocks an SM holds.
void quantized_affine_geometry(int* rows, int* slab, int* max_splits,
                               int* kmax, int* blocks_per_sm) {
  *rows = RT;
  *slab = DS;
  *max_splits = MAX_SPLITS;
  *kmax = KMAX;
  *blocks_per_sm = MIN_BLOCKS;
}

// out (n, k) = ((X - mean) * inv) @ (float(Wq) * scale) + b, for X
// (n, d) float32 with row stride ldx (unit column stride), and the
// wrapper's layout of the model: Wt (ceil(k / kc), dpad, kc) narrow
// weights, mean and inv (dpad), all zero past d and k; scale and b (k).
// kc is the column tile (even, at most 16), dpad a multiple of the slab;
// d is cut into `splits` runs of `sps` slabs, one block of a cluster
// each. Launches on `stream` and returns the launch's error (0 on
// success), or cudaErrorInvalidValue for arguments it cannot take.
int quantized_affine_bf16(const float* X, long long ldx, const uint16_t* Wt,
                          const float* scale, const float* mean,
                          const float* inv, const float* b, float* out, int n,
                          int d, int k, int kc, int dpad, int splits, int sps,
                          void* stream) {
  return dispatch<uint16_t>(X, ldx, Wt, scale, mean, inv, b, out, n, d, k,
                            kc, dpad, splits, sps, stream);
}

int quantized_affine_int8(const float* X, long long ldx, const int8_t* Wt,
                          const float* scale, const float* mean,
                          const float* inv, const float* b, float* out, int n,
                          int d, int k, int kc, int dpad, int splits, int sps,
                          void* stream) {
  return dispatch<int8_t>(X, ldx, Wt, scale, mean, inv, b, out, n, d, k, kc,
                          dpad, splits, sps, stream);
}

}  // extern "C"
