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
// read and 2 * R * K * 4 = 32 * K bytes of output written (R = 4
// regions). At K = 1024 that is 161 MFLOP per 44 KB: about 3,700 FLOP
// per byte, far above the card's float32 ridge point, so the kernel is
// bound by arithmetic, not by memory.
//
// What the design does about it.
//  * Nothing intermediate touches device memory: the (729, 108) patch
//    matrix is never built (patches are read on the fly from the image
//    staged in shared memory), and the (729, K) convolution and
//    rectifier outputs live only in registers. The TPU version builds
//    the im2col tensor in HBM first.
//  * One block owns (one image, one tile of KT = 64 filters); the filter
//    tile sits in shared memory transposed to (F, KT), so a thread's four
//    filter values for one feature come in one 16-byte load.
//  * Each thread computes a register tile of TP = 4 neighbouring patches
//    of one row times TK = 4 filters. Neighbouring patches share pixels:
//    for one (dy, c) the tile needs TP + S - 1 image values, loaded once
//    and reused across the S values of dx. Per 96 FMAs a thread issues 9
//    scalar and 6 vector shared loads (the first version, without the
//    reuse, issued 5 loads and an offset-table load per 16 FMAs and was
//    bound by shared-memory issue). The patch size S and channel count C
//    are template parameters, so every offset is a compile-time constant.
//  * The arithmetic runs on the float32 CUDA cores in true f32, the
//    precision of the plain version; tensor cores (TF32, wgmma) would
//    change the numerics and are left for a later change.
//  * Ragged K (e.g. K = 100) is masked inside the kernel: filters past K
//    load as zeros and their outputs are not written.
//  * Pooled sums are reduced across threads through shared memory in a
//    fixed order, with no atomics, so results are bit-reproducible.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KT = 64;          // filters per block
constexpr int NTHREADS = 256;   // 16 filter quads x 16 patch tiles
constexpr int TK = 4;           // filters per thread
constexpr int TP = 4;           // neighbouring patches per thread per pass
constexpr int KQ = KT / TK;     // filter quads per block: 16
constexpr int PGROUPS = NTHREADS / KQ;  // patch groups per pass: 16
constexpr int MAX_R = 4;        // pooling regions the kernel supports

// Shared layout (floats): [filt F*KT][img H*W*C][TP*C][mean P][sd P]
//                         [fsum KT][bias KT]
// The image is followed by TP*C zeros: a patch tile at the end of a row
// reads up to TP - 1 pixels past it (into the next row, or these zeros),
// and those values reach masked patches only.
__host__ __device__ inline int img_floats(int H, int W, int C) {
  return H * W * C + TP * C;
}

template <int S, int C>
__global__ void __launch_bounds__(NTHREADS, 2)
fused_featurize_kernel(const float* __restrict__ imgs,
                       const float* __restrict__ filters,
                       const float* __restrict__ fsum,
                       const float* __restrict__ bias,
                       float* __restrict__ out,
                       int H, int W, int K, int pool_stride, int pool_size,
                       float var_constant, float alpha) {
  constexpr int F = S * S * C;
  extern __shared__ __align__(16) float smem[];
  const int OH = H - S + 1;
  const int OW = W - S + 1;
  const int P = OH * OW;
  const int row = W * C;                 // floats per image row
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * KT;

  float* filt_s = smem;
  float* img_s = filt_s + F * KT;
  float* mean_s = img_s + img_floats(H, W, C);
  float* sd_s = mean_s + P;
  float* fsum_s = sd_s + P;
  float* bias_s = fsum_s + KT;

  const float* img_g = imgs + (size_t)b * H * W * C;
  for (int i = tid; i < H * W * C; i += NTHREADS) img_s[i] = img_g[i];
  for (int i = H * W * C + tid; i < img_floats(H, W, C); i += NTHREADS)
    img_s[i] = 0.0f;
  for (int i = tid; i < F * KT; i += NTHREADS) {
    // consecutive threads take consecutive filters: conflict-free shared
    // stores; the strided global reads hit the L2-resident filter bank
    const int f = i / KT, k = i - f * KT;
    filt_s[i] = (k0 + k < K) ? filters[(size_t)(k0 + k) * F + f] : 0.0f;
  }
  for (int k = tid; k < KT; k += NTHREADS) {
    fsum_s[k] = (k0 + k < K) ? fsum[k0 + k] : 0.0f;
    bias_s[k] = (k0 + k < K) ? bias[k0 + k] : 0.0f;
  }
  __syncthreads();

  // per-patch mean and sd = sqrt(var + var_constant), unbiased variance
  // (sum p^2 - F m^2) / (F - 1) with a NaN guard, as in the plain version
  for (int p = tid; p < P; p += NTHREADS) {
    const float* px = img_s + (p / OW) * row + (p % OW) * C;
    float s = 0.0f, sq = 0.0f;
#pragma unroll
    for (int dy = 0; dy < S; ++dy)
#pragma unroll
      for (int j = 0; j < S * C; ++j) {
        const float v = px[dy * row + j];
        s += v;
        sq += v * v;
      }
    const float m = s / (float)F;
    const float var = (sq - (float)F * m * m) / ((float)F - 1.0f);
    float sd = sqrtf(var + var_constant);
    if (isnan(sd)) sd = sqrtf(var_constant);
    mean_s[p] = m;
    sd_s[p] = sd;
  }
  __syncthreads();

  // pooling regions along each axis: [c - half, min(c + half, dim))
  const int half = pool_size / 2;
  const int nrx = (OH - half + pool_stride - 1) / pool_stride;
  const int nry = (OW - half + pool_stride - 1) / pool_stride;
  const int R = nrx * nry;

  const int kq = tid % KQ;             // which 4 filters
  const int pg = tid / KQ;             // which patch tile of the pass
  const int kl = kq * TK;              // local filter index
  const int tiles_per_row = (OW + TP - 1) / TP;
  const int ntiles = OH * tiles_per_row;

  float pool_pos[MAX_R][TK], pool_neg[MAX_R][TK];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r)
#pragma unroll
    for (int j = 0; j < TK; ++j) pool_pos[r][j] = pool_neg[r][j] = 0.0f;

  float fs[TK], bs[TK];
#pragma unroll
  for (int j = 0; j < TK; ++j) {
    fs[j] = fsum_s[kl + j];
    bs[j] = bias_s[kl + j];
  }
  const float4* filt4 = reinterpret_cast<const float4*>(filt_s) + kq;

  for (int t0 = 0; t0 < ntiles; t0 += PGROUPS) {
    const int tile = t0 + pg;
    // clamp the loads of tiles past the end; their results are masked
    const int tl = tile < ntiles ? tile : ntiles - 1;
    const int py = tl / tiles_per_row;
    const int px0 = (tl % tiles_per_row) * TP;
    const float* base = img_s + py * row + px0 * C;

    float acc[TP][TK];
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) acc[i][j] = 0.0f;

    // dy stays a loop: unrolling it too makes the compiler hoist every
    // load of the pass and spill
#pragma unroll 1
    for (int dy = 0; dy < S; ++dy) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v[TP + S - 1];
#pragma unroll
        for (int t = 0; t < TP + S - 1; ++t) v[t] = base[dy * row + t * C + c];
#pragma unroll
        for (int dx = 0; dx < S; ++dx) {
          const float4 w = filt4[((dy * S + dx) * C + c) * KQ];
#pragma unroll
          for (int i = 0; i < TP; ++i) {
            acc[i][0] = fmaf(v[i + dx], w.x, acc[i][0]);
            acc[i][1] = fmaf(v[i + dx], w.y, acc[i][1]);
            acc[i][2] = fmaf(v[i + dx], w.z, acc[i][2]);
            acc[i][3] = fmaf(v[i + dx], w.w, acc[i][3]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < TP; ++i) {
      const int pxi = px0 + i;
      if (tile >= ntiles || pxi >= OW) continue;
      const int p = py * OW + pxi;
      bool in_r[MAX_R];
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        const int rx = r / nry, ry = r - rx * nry;
        const int x0 = rx * pool_stride, y0 = ry * pool_stride;
        const int x1 = min(x0 + 2 * half, OH), y1 = min(y0 + 2 * half, OW);
        in_r[r] = r < R && py >= x0 && py < x1 && pxi >= y0 && pxi < y1;
      }
      const float m = mean_s[p], sd = sd_s[p];
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float conv = (acc[i][j] - m * fs[j]) / sd - bs[j];
        const float pos = fmaxf(conv - alpha, 0.0f);
        const float neg = fmaxf(-conv - alpha, 0.0f);
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) {
          if (in_r[r]) {
            pool_pos[r][j] += pos;
            pool_neg[r][j] += neg;
          }
        }
      }
    }
  }

  // fixed-order reduction over the patch groups through shared memory
  // (reuses the filter/image region, no longer read)
  __syncthreads();
  float* red = smem;   // [PGROUPS][R][2][KT]
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r >= R) break;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      red[((pg * R + r) * 2 + 0) * KT + kl + j] = pool_pos[r][j];
      red[((pg * R + r) * 2 + 1) * KT + kl + j] = pool_neg[r][j];
    }
  }
  __syncthreads();
  float* out_b = out + (size_t)b * R * 2 * K;
  for (int e = tid; e < R * 2 * KT; e += NTHREADS) {
    const int k = e % KT, rh = e / KT;          // rh = r * 2 + half
    if (k0 + k >= K) continue;
    float s = 0.0f;
    for (int g = 0; g < PGROUPS; ++g) s += red[(g * R * 2 + rh) * KT + k];
    const int r = rh / 2, h = rh % 2;
    out_b[r * 2 * K + h * K + k0 + k] = s;
  }
}

template <int S, int C>
int launch(const float* imgs, const float* filters, const float* fsum,
           const float* bias, float* out, int B, int H, int W, int K,
           int pool_stride, int pool_size, float var_constant, float alpha,
           int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_featurize_kernel<S, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (K + KT - 1) / KT);
  fused_featurize_kernel<S, C><<<grid, NTHREADS, smem, stream>>>(
      imgs, filters, fsum, bias, out, H, W, K, pool_stride, pool_size,
      var_constant, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for an image of H x W x C and patch S.
int fused_featurize_smem_bytes(int H, int W, int C, int S) {
  const int F = S * S * C;
  const int P = (H - S + 1) * (W - S + 1);
  const int main = (F * KT + img_floats(H, W, C) + 2 * P + 2 * KT) * 4;
  const int red = PGROUPS * MAX_R * 2 * KT * 4;
  return main > red ? main : red;
}

int fused_featurize_max_regions() { return MAX_R; }

// 1 when the kernel is compiled for patch size S and C channels.
int fused_featurize_supported(int S, int C) {
  return (C == 1 || C == 3) && S >= 3 && S <= 8;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a patch size / channel count not compiled.
int fused_cifar_featurize_f32(const float* imgs, const float* filters,
                              const float* fsum, const float* bias,
                              float* out, int B, int H, int W, int C, int S,
                              int K, int pool_stride, int pool_size,
                              float var_constant, float alpha,
                              void* stream) {
  const int smem = fused_featurize_smem_bytes(H, W, C, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KEYSTONE_CASE(s, c)                                                  \
  if (S == s && C == c)                                                      \
    return launch<s, c>(imgs, filters, fsum, bias, out, B, H, W, K,          \
                        pool_stride, pool_size, var_constant, alpha, smem,   \
                        st);
  KEYSTONE_CASE(3, 1) KEYSTONE_CASE(4, 1) KEYSTONE_CASE(5, 1)
  KEYSTONE_CASE(6, 1) KEYSTONE_CASE(7, 1) KEYSTONE_CASE(8, 1)
  KEYSTONE_CASE(3, 3) KEYSTONE_CASE(4, 3) KEYSTONE_CASE(5, 3)
  KEYSTONE_CASE(6, 3) KEYSTONE_CASE(7, 3) KEYSTONE_CASE(8, 3)
#undef KEYSTONE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
