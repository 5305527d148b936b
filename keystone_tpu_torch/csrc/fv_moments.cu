// GMM-posterior Fisher-vector moments for Hopper (sm_90a). For each
// descriptor column x of X (D, n), under a diagonal GMM with K components:
//   llh[k] = c[k] - (x^2 . A[:, k] - x . B[:, k])
//            A = 0.5 / var, B = means / var, c = the per-component constant
//   q = softmax(llh) (max-shifted); q = q > threshold ? q : 0; q /= sum(q)
// and the moment SUMS over the n columns
//   s0 = sum q (K),  s1 = X q (D, K),  s2 = (X * X) q (D, K).
// The caller divides by n. The (n, K) posterior matrix never reaches
// device memory.
//
// Replaces keystone_tpu/ops/pallas_kernels.py::fv_moments_pallas (the
// Pallas TPU kernel _fv_moments_kernel and its wrapper). The plain PyTorch
// version of the same function is
// keystone_tpu_torch/ops/kernels.py::fv_moments_plain.
//
// What bounds it. 8 n D K operations (the two llh sums and the two moment
// sums, a multiply and an add each) against 4 D n bytes of descriptors:
// at the full-width FV (D = 80, K = 256, n = 47,213 an image) that is 7.7
// GFLOP against 15 MB, so the float32 operations bound it (about 0.12 ms
// at 67 TFLOP/s; the bytes take 4.5 us).
//
// What the design does about it.
//  * Blocks run in no order on Hopper, so the TPU kernel's sequential
//    grid, which carries the sums in VMEM from one tile to the next, is
//    replaced by blocks that each own a strided set of T-column tiles
//    (T = 32, or 1 for a K too wide for 32 rows of llh in shared memory)
//    and carry their own partial sums in shared memory. A second small
//    launch adds the blocks' partials in block order: no atomics, the same
//    bits on every run.
//  * Per tile: the block stages x and x^2 (D x T) in shared memory. The
//    llh tile (T x K) is computed by (component, half-tile) work items:
//    a thread reads A and B for 8 depths at once from L2 (8 loads in
//    flight) and applies each to its T/2 columns, read as 16-byte
//    broadcasts, with T/2 pairs of sums in registers. One warp per row
//    then does the max, the exponentials, both normalizations and the
//    threshold in shared memory with fixed shuffle butterflies. Last, each
//    thread owns a (component, group of depths), reads its column of q
//    once into registers and adds its T-column sums of x q and x^2 q into
//    the shared-memory accumulators.
//  * At D = 80 and K = 256 the two accumulators take 160 KB: with the
//    tiles that is 213 KB of the 227 KB a block may use, one 512-thread
//    block an SM (16 warps to hide the L2 reads). Where D x K is larger
//    the launch plan (make_plan, below) splits the accumulated rows of D
//    across the grid's y dimension (each split recomputes the posteriors,
//    which need every row of D).
//  * Columns at or past n load as zeros, and their posteriors (nonzero for
//    a zero descriptor) are dropped by index. The loops run over exactly K
//    components, so no padded component enters the max or the sums. The
//    threshold and the renormalization come after the first
//    normalization.
//  * True float32 throughout (expf, not the fast intrinsic).
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DU = 8;  // depths of A and B a thread loads at once

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

// dot-style updates over N consecutive floats of two staged rows (x and
// x^2), the operands read as 16-byte broadcasts where N allows (the rows
// are 16-byte aligned when T is 32): f(t, x[t], x2[t]) for t < N.
template <int N, typename F>
__device__ inline void for_row(const float* xr, const float* x2r, F f) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int t = 0; t < N; t += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + t);
      const float4 b = *reinterpret_cast<const float4*>(x2r + t);
      f(t, a.x, b.x);
      f(t + 1, a.y, b.y);
      f(t + 2, a.z, b.z);
      f(t + 3, a.w, b.w);
    }
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) f(t, xr[t], x2r[t]);
  }
}

// Shared memory of one block, in floats: x and x^2 tiles (D x T each), the
// llh / posterior tile (T x K), the two accumulators (dr x K each) and s0.
__host__ __device__ inline long long smem_floats(int T, int D, int K,
                                                 int dr) {
  return 2LL * D * T + (long long)T * K + 2LL * dr * K + K;
}

template <int T>
__global__ void __launch_bounds__(NTHREADS)
fv_moments_kernel(const float* __restrict__ X, long long ldx,
                  const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ c, float* __restrict__ partial,
                  int D, int n, int K, int dr, float threshold) {
  constexpr int TH = T > 1 ? T / 2 : 1;  // llh columns per work item
  constexpr int HALVES = T / TH;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned tiles
  float* xs = reinterpret_cast<float*>(smem4);  // [D][T]
  float* x2s = xs + D * T;          // [D][T]
  float* qs = x2s + D * T;          // [T][K]
  float* acc1 = qs + T * K;         // [dr][K]
  float* acc2 = acc1 + dr * K;      // [dr][K]
  float* acc0 = acc2 + dr * K;      // [K]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int d0 = blockIdx.y * dr;
  const int d1 = min(d0 + dr, D);
  const int rows = max(d1 - d0, 0);
  const bool first_split = blockIdx.y == 0;
  // accumulation work items: (d-group, k), d-groups strided over rows
  const int groups = K >= NTHREADS ? 1 : max(1, min(rows, NTHREADS / K));

  for (int i = tid; i < 2 * dr * K + K; i += NTHREADS) acc1[i] = 0.0f;

  const long long tiles = ((long long)n + T - 1) / T;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long col0 = tile * T;
    const int valid = (int)min((long long)T, (long long)n - col0);
    __syncthreads();  // the previous tile is consumed before restaging
    for (int e = tid; e < D * T; e += NTHREADS) {
      const int d = e / T, t = e % T;
      const float v = t < valid ? X[(long long)d * ldx + col0 + t] : 0.0f;
      xs[e] = v;
      x2s[e] = v * v;
    }
    __syncthreads();

    // llh[t][k] = c[k] - (sum_d x2 A - sum_d x B), item (k, half)
    for (int w = tid; w < HALVES * K; w += NTHREADS) {
      const int k = w % K, tb = (w / K) * TH;
      float m1[TH], m2[TH];
#pragma unroll
      for (int t = 0; t < TH; ++t) m1[t] = m2[t] = 0.0f;
      for (int d = 0; d < D; d += DU) {
        float a[DU], b[DU];
#pragma unroll
        for (int u = 0; u < DU; ++u) {
          const bool in = d + u < D;
          a[u] = in ? __ldg(A + (long long)(d + u) * K + k) : 0.0f;
          b[u] = in ? __ldg(B + (long long)(d + u) * K + k) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < DU; ++u) {
          if (d + u >= D) break;
          const float au = a[u], bu = b[u];
          for_row<TH>(xs + (d + u) * T + tb, x2s + (d + u) * T + tb,
                      [&](int t, float x, float x2) {
                        m1[t] = fmaf(x2, au, m1[t]);
                        m2[t] = fmaf(x, bu, m2[t]);
                      });
        }
      }
      const float ck = c[k];
#pragma unroll
      for (int t = 0; t < TH; ++t)
        qs[(tb + t) * K + k] = ck - (m1[t] - m2[t]);
    }
    __syncthreads();

    // one warp per row: softmax, threshold, renormalize; rows past n -> 0
    for (int t = warp; t < T; t += NWARPS) {
      float* row = qs + t * K;
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
      s = warp_sum(s);
      float s2 = 0.0f;
      for (int k = lane; k < K; k += 32) {
        float q = row[k] / s;
        q = q > threshold ? q : 0.0f;
        row[k] = q;
        s2 += q;
      }
      s2 = warp_sum(s2);
      for (int k = lane; k < K; k += 32) row[k] = row[k] / s2;
    }
    __syncthreads();

    // s1[d][k] += sum_t x[d][t] q[t][k]; s2 with x^2; s0[k] += sum_t q[t][k]
    for (int w = tid; w < groups * K; w += NTHREADS) {
      const int k = w % K, g = w / K;
      float q[T];
#pragma unroll
      for (int t = 0; t < T; ++t) q[t] = qs[t * K + k];
      if (g == 0 && first_split) {
        float s0 = 0.0f;
#pragma unroll
        for (int t = 0; t < T; ++t) s0 += q[t];
        acc0[k] += s0;
      }
      for (int d = d0 + g; d < d1; d += groups) {
        float s1 = 0.0f, s2 = 0.0f;
        for_row<T>(xs + d * T, x2s + d * T, [&](int t, float x, float x2) {
          s1 = fmaf(x, q[t], s1);
          s2 = fmaf(x2, q[t], s2);
        });
        acc1[(d - d0) * K + k] += s1;
        acc2[(d - d0) * K + k] += s2;
      }
    }
  }
  __syncthreads();

  // this block's partial: [s0 (K) | s1 (D x K) | s2 (D x K)], own rows only
  float* dst = partial + (long long)blockIdx.x * (K + 2LL * D * K);
  if (first_split)
    for (int k = tid; k < K; k += NTHREADS) dst[k] = acc0[k];
  for (int e = tid; e < rows * K; e += NTHREADS) {
    const long long at = (long long)d0 * K + e;
    dst[K + at] = acc1[e];
    dst[K + (long long)D * K + at] = acc2[e];
  }
}

constexpr int RTHREADS = 256;

// out[i] = sum over blocks b, in order, of partial[b][i]
__global__ void __launch_bounds__(RTHREADS)
reduce_blocks_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     long long total, int blocks) {
  const long long i = (long long)blockIdx.x * RTHREADS + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc += partial[(long long)b * total + i];
  out[i] = acc;
}

constexpr long long SMEM_LIMIT = 232448;  // bytes a block may use (227 KB)

struct Plan {
  int T;       // tile width: 32, or 1 for a K too wide for 32 rows of llh
  int splits;  // row splits of D (grid y)
  int dr;      // accumulated rows of D a split
  int blocks;  // blocks along n (grid x)
  long long smem;
};

// The launch plan for (D, n, K) on the current device: the widest tile and
// the fewest row splits of D whose shared memory fits a block, and as many
// blocks as the SMs hold at once (by shared memory and by the SM's 2048
// threads), at most one a tile. False where even one accumulated row of D
// does not fit.
bool make_plan(int D, int n, int K, Plan* p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  for (int T : {32, 1}) {
    const long long budget =
        SMEM_LIMIT / 4 - (2LL * D * T + (long long)T * K + K);
    if (budget < 0) continue;
    int splits = 1, dr = 0;
    if (D > 0) {
      const long long rows = std::min<long long>(D, budget / (2LL * K));
      if (rows < 1) continue;
      splits = (int)((D + rows - 1) / rows);
      dr = (D + splits - 1) / splits;
    }
    const long long smem = 4 * smem_floats(T, D, K, dr);
    const long long per_sm = std::max<long long>(
        1, std::min<long long>(2048 / NTHREADS, SMEM_LIMIT / smem));
    const long long tiles = ((long long)n + T - 1) / T;
    *p = {T, splits, dr, (int)std::min<long long>(tiles, sms * per_sm),
          smem};
    return true;
  }
  return false;
}

template <int T>
int launch(const float* X, long long ldx, const float* A, const float* B,
           const float* c, float* out, float* partial, int D, int n, int K,
           const Plan& p, float threshold, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fv_moments_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.blocks, (unsigned)p.splits);
  fv_moments_kernel<T><<<grid, NTHREADS, (size_t)p.smem, st>>>(
      X, ldx, A, B, c, p.blocks > 1 ? partial : out, D, n, K, p.dr,
      threshold);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || p.blocks == 1) return rc;
  const long long total = K + 2LL * D * K;
  const long long rblocks = (total + RTHREADS - 1) / RTHREADS;
  reduce_blocks_kernel<<<(unsigned)rblocks, RTHREADS, 0, st>>>(
      partial, out, total, p.blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the (blocks, K + 2 D K) scratch that fv_moments_f32 needs on
// the current device for (D, n, K): 0 where the plan has one block, -1
// where no plan fits a block's shared memory.
long long fv_moments_scratch_floats(int D, int n, int K) {
  Plan p;
  if (n <= 0 || K <= 0 || D < 0 || !make_plan(D, n, K, &p)) return -1;
  return p.blocks > 1 ? (long long)p.blocks * (K + 2LL * D * K) : 0;
}

// out = [s0 (K) | s1 (D, K) | s2 (D, K)], contiguous float32, for X (D, n)
// float32 with row stride ldx (unit column stride), A = 0.5 / var and
// B = means / var contiguous (D, K), c (K) the llh constants. `partial` is
// a float32 scratch of fv_moments_scratch_floats(D, n, K) floats (null
// where that is 0). Launches on `stream` on the current device and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the launch cannot take.
int fv_moments_f32(const float* X, long long ldx, const float* A,
                   const float* B, const float* c, float* out, float* partial,
                   int D, int n, int K, float threshold, void* stream) {
  Plan p;
  if (n <= 0 || K <= 0 || D < 0 || ldx < n || !make_plan(D, n, K, &p) ||
      p.splits > 65535 || (p.blocks > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.T == 32)
    return launch<32>(X, ldx, A, B, c, out, partial, D, n, K, p, threshold,
                      st);
  return launch<1>(X, ldx, A, B, c, out, partial, D, n, K, p, threshold, st);
}

}  // extern "C"
