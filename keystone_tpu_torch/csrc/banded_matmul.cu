// Banded matrix products for Hopper (sm_90a), two entry points:
//   one-sided  out (m, n)    = band (m, l) @ X (l, n)
//   two-sided  out (C, m, r) = band (m, l) @ X[c] (l, w) @ right (r, w)^T
// with band and right dense float32 copies of band matrices, X float32
// with unit column stride and the row (and channel) strides given, out
// float32 contiguous.
//
// Replaces keystone_tpu/ops/pallas_kernels.py::banded_matmul_pallas (the
// Pallas TPU kernel _banded_kernel, its wrapper banded_matmul and the
// 128 x 128 live-tile map band_tile_map). The one-sided entry point is
// that kernel's own function; the two-sided one is the JAX package's
// band contraction of dense SIFT (the einsum forms ih,hw,jw->ij and
// ph,ohw,qw->opq of keystone_tpu/ops/sift.py), which the TPU path runs as
// two one-sided calls. The plain PyTorch version of both is
// keystone_tpu_torch/ops/kernels.py::banded_matmul_plain.
//
// Where it runs. Dense SIFT (keystone_tpu_torch/ops/sift.py) expresses its
// Gaussian smoothing and its spatial binning + keypoint sampling as band
// matrices on both image axes: two two-sided products a scale (the
// smoothing of the image, then the binning of its 8 orientation maps, C =
// 8), ten an image at five scales.
//
// What bounds it. The bands are narrow: at VOC's 375 x 500 images the
// smoothing operators have 5-21 nonzeros a row and the interleaved
// sampling operators 9-27, so the true band work is small (about 0.5
// GFLOP an image). Reading each input once and writing each output once
// is about 65 MB an image: bytes bound it, about 20 us at 3.35 TB/s.
//
// What the design does about it.
//  * Live maps on both sides: for each 32-row tile of band rows and of
//    right rows, the first and one past the last nonzero column, and the
//    same for each 4-row group (computed on the host and cached with the
//    pair's device copies). A block owns one 32 x 32 output tile and
//    reads only the X patch of its two tile ranges: 24-57 columns a side
//    at scale 0, 30-97 at scale 4 of 375-500. A warp owns 4 rows and sums
//    only over its group's range (12-69 columns).
//  * The intermediate band @ X[c] of the patch stays in shared memory:
//    the two-sided product is one launch, with no transposed copy and no
//    intermediate in device memory.
//  * The block stages its band and right tiles (transposed, so a warp
//    reads one broadcast float4 of 4 band rows or 4 right rows) and its
//    patch with cp.async, coalesced, then loops over its channels; where
//    it takes several, the next channel's patch is copied while the
//    current one is computed. In the first product a lane owns up to 4
//    columns of its warp's 4 rows (16 sums in registers); in the second a
//    lane owns a row and its warp 4 right rows; the output tile goes out
//    through shared memory, coalesced.
//  * The grid is one block per output tile and channel group, the groups
//    chosen so that the card gets about sixteen blocks an SM: 192 blocks
//    for the smoothing of a 375 x 500 image, 165 x 8 for its scale-0
//    binning (one channel a block).
//  * True float32 FMAs, one sequential sum over k per value: no tensor
//    core (TF32 would change the numerics), no split of k, no atomics,
//    so the same inputs give the same bits. Rows past m or r are neither
//    read nor written; a tile with no nonzero writes zeros.
//  * The one-sided product keeps one block per 32-row tile and 128
//    columns, one column a thread, X streamed 8 rows ahead from device
//    memory.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int TM = 32;         // output rows per block (the live map's tile)
constexpr int NTHREADS = 128;  // one-sided: output columns per block
constexpr int KC = 128;        // one-sided: live band columns staged a pass
constexpr int BTS = TM + 4;    // one-sided: padded k-row of the band tile
constexpr int UNROLL = 8;      // one-sided: X rows a thread has in flight

constexpr int T2THREADS = 256;  // two-sided: 8 warps, GR tile rows each
constexpr int NWARPS2 = T2THREADS / 32;
constexpr int GR = TM / NWARPS2;  // two-sided: rows of a group map entry
static_assert(GR == 4, "a warp's rows are read as one float4");
constexpr int ZS = TM + 4;      // two-sided: padded row of the intermediate

constexpr long long SMEM_LIMIT = 232448;  // bytes a block may use (227 KB)

__global__ void __launch_bounds__(NTHREADS)
banded_matmul_kernel(const float* __restrict__ band,
                     const int* __restrict__ klo, const int* __restrict__ khi,
                     const float* __restrict__ X, long long ldx,
                     float* __restrict__ out, int m, int l, int n) {
  __shared__ __align__(16) float bt[KC * BTS];  // [k][row]

  const int rt = blockIdx.y;
  const int r0 = rt * TM;
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  const bool in = c < n;
  const int lo = klo[rt], hi = khi[rt];

  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.0f;

  for (int k0 = lo; k0 < hi; k0 += KC) {
    const int kc = min(KC, hi - k0);
    __syncthreads();  // the previous pass's tile is read before restaging
    for (int e = threadIdx.x; e < TM * kc; e += NTHREADS) {
      const int r = e / kc, kk = e % kc;
      bt[kk * BTS + r] =
          r0 + r < m ? band[(long long)(r0 + r) * l + k0 + kk] : 0.0f;
    }
    __syncthreads();
    const float* xp = X + (long long)k0 * ldx + (in ? c : 0);
    int kk = 0;
    for (; kk < kc; kk += UNROLL) {
      float x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        x[u] = (in && kk + u < kc) ? __ldg(xp + (long long)(kk + u) * ldx)
                                   : 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (kk + u >= kc) break;
        const float4* b4 =
            reinterpret_cast<const float4*>(bt + (kk + u) * BTS);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 b = b4[q];
          acc[4 * q] = fmaf(b.x, x[u], acc[4 * q]);
          acc[4 * q + 1] = fmaf(b.y, x[u], acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(b.z, x[u], acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(b.w, x[u], acc[4 * q + 3]);
        }
      }
    }
  }

  if (!in) return;
#pragma unroll
  for (int r = 0; r < TM; ++r)
    if (r0 + r < m) out[(long long)(r0 + r) * n + c] = acc[r];
}

// 4 bytes global -> shared, asynchronously; zeros where !valid
__device__ inline void cp_async4(float* dst, const float* src,
                                 bool valid = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Shared memory of a two-sided block, in floats: the band tile (KL x 32),
// the right tile (KR x 32), the intermediate (KR x ZS), the output tile
// (32 x 33) and `patches` patches (KL x KR each: two where a block takes
// several channels, the next one loaded behind the current one).
__host__ __device__ inline long long smem2_floats(int KL, int KR,
                                                  int patches) {
  return (long long)KL * TM + (long long)KR * TM + (long long)KR * ZS +
         TM * (TM + 1) + (long long)patches * KL * KR;
}

// [lo, hi) of a GR-row group's live range, relative to its tile's range
// starting at base; empty where the group is past the rows or all zero
__device__ inline int2 group_range(const int* glo, const int* ghi, int gi,
                                   int groups, int base) {
  if (gi >= groups || ghi[gi] <= glo[gi]) return make_int2(0, 0);
  return make_int2(glo[gi] - base, ghi[gi] - base);
}

// One 32 x 32 output tile (band rows i0.., right rows j0..) of the
// channels [c0, c1). maps = [klo | khi] of band's 32-row tiles, [jlo |
// jhi] of right's, then the same of band's and right's GR-row groups;
// KL, KR bound the tiles' live ranges (the smem layout's extents). NQ
// 32-column groups of the intermediate a thread holds.
template <int NQ>
__global__ void __launch_bounds__(T2THREADS)
banded2_kernel(const float* __restrict__ band, const float* __restrict__ right,
               const int* __restrict__ maps, const float* __restrict__ X,
               long long sc, long long sl, float* __restrict__ out, int C,
               int cpb, int m, int l, int r, int w, int KL, int KR) {
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);  // [KL][TM] band, transposed
  float* rs = bs + KL * TM;                     // [KR][TM] right, transposed
  float* zs = rs + KR * TM;                     // [KR][ZS] band @ patch
  float* os = zs + KR * ZS;                     // [TM][TM + 1] output tile
  float* ps = os + TM * (TM + 1);               // [1 or 2][KL][KR] patches

  const int mtiles = (m + TM - 1) / TM, rtiles = (r + TM - 1) / TM;
  const int mgroups = (m + GR - 1) / GR, rgroups = (r + GR - 1) / GR;
  const int* gmap = maps + 2 * mtiles + 2 * rtiles;
  const int it = blockIdx.y, jt = blockIdx.x;
  const int i0 = it * TM, j0 = jt * TM;
  const int c0 = blockIdx.z * cpb, c1 = min(C, c0 + cpb);
  const int klo = maps[it], lk = maps[mtiles + it] - klo;
  const int jlo = maps[2 * mtiles + jt];
  const int wj = maps[2 * mtiles + rtiles + jt] - jlo;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool live = lk > 0 && wj > 0;
  // phase 1: this warp's GR band rows; phase 2: this warp's GR right rows
  const int2 kr = group_range(gmap, gmap + mgroups, i0 / GR + warp, mgroups,
                              klo);
  const int2 cr = group_range(gmap + 2 * mgroups,
                              gmap + 2 * mgroups + rgroups, j0 / GR + warp,
                              rgroups, jlo);

  // a warp a row of the patch, coalesced along it
  auto load_patch = [&](int ch, float* dst) {
    const float* src = X + (long long)ch * sc + (long long)klo * sl + jlo;
    for (int kk = warp; kk < lk; kk += NWARPS2)
      for (int col = lane; col < wj; col += 32)
        cp_async4(dst + kk * KR + col, src + (long long)kk * sl + col);
  };

  // the band and right tiles, transposed (a lane a row: conflict-free
  // shared stores), in the same copy group as the first patch
  const bool row_in = i0 + lane < m, j_in = j0 + lane < r;
  for (int kk = warp; kk < lk; kk += NWARPS2)
    cp_async4(bs + kk * TM + lane,
              band + (row_in ? (long long)(i0 + lane) * l + klo + kk : 0),
              row_in);
  for (int col = warp; col < wj; col += NWARPS2)
    cp_async4(rs + col * TM + lane,
              right + (j_in ? (long long)(j0 + lane) * w + jlo + col : 0),
              j_in);
  if (live) load_patch(c0, ps);
  cp_async_commit();

  const long long mr = (long long)m * r;
  for (int ch = c0; ch < c1; ++ch) {
    const float* cur = ps + ((ch - c0) & 1) * KL * KR;
    if (live && ch + 1 < c1)
      load_patch(ch + 1, ps + ((ch + 1 - c0) & 1) * KL * KR);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // this channel's patch landed; zs and os are free

    // zs[col][row] = sum over the warp's 4 rows' live k of
    // band[i0 + row][klo + kk] patch[kk][col]
    for (int cb = 0; cb < wj; cb += 32 * NQ) {
      float z[NQ][4] = {};
#pragma unroll 4
      for (int kk = kr.x; kk < kr.y; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(bs + kk * TM +
                                                          GR * warp);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int col = cb + lane + 32 * q;
          const float x = col < wj ? cur[kk * KR + col] : 0.0f;
          z[q][0] = fmaf(b.x, x, z[q][0]);
          z[q][1] = fmaf(b.y, x, z[q][1]);
          z[q][2] = fmaf(b.z, x, z[q][2]);
          z[q][3] = fmaf(b.w, x, z[q][3]);
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = cb + lane + 32 * q;
        if (col < wj)
          *reinterpret_cast<float4*>(zs + col * ZS + GR * warp) =
              make_float4(z[q][0], z[q][1], z[q][2], z[q][3]);
      }
    }
    __syncthreads();

    // os[row][4 warp + u] = sum over the warp's 4 right rows' live
    // columns of zs[col][row] right[j0 + 4 warp + u][jlo + col]; a lane
    // owns a row
    float o[4] = {};
#pragma unroll 4
    for (int col = cr.x; col < cr.y; ++col) {
      const float zv = zs[col * ZS + lane];
      const float4 rv =
          *reinterpret_cast<const float4*>(rs + col * TM + GR * warp);
      o[0] = fmaf(zv, rv.x, o[0]);
      o[1] = fmaf(zv, rv.y, o[1]);
      o[2] = fmaf(zv, rv.z, o[2]);
      o[3] = fmaf(zv, rv.w, o[3]);
    }
#pragma unroll
    for (int u = 0; u < GR; ++u) os[lane * (TM + 1) + GR * warp + u] = o[u];
    __syncthreads();
    for (int row = warp; row < TM; row += NWARPS2)
      if (i0 + row < m && j_in)
        out[ch * mr + (long long)(i0 + row) * r + j0 + lane] =
            os[row * (TM + 1) + lane];
  }
}

template <int NQ>
int launch2(const float* band, const float* right, const int* maps,
            const float* X, long long sc, long long sl, float* out, int C,
            int m, int l, int r, int w, int KL, int KR, int dev, int sms,
            cudaStream_t st) {
  const long long mtiles = (m + TM - 1) / TM, rtiles = (r + TM - 1) / TM;
  // channel groups: enough blocks for about sixteen an SM
  const long long tiles = mtiles * rtiles;
  const int groups = (int)std::min<long long>(
      C, std::max<long long>(1, (16LL * sms + tiles - 1) / tiles));
  const int cpb = (C + groups - 1) / groups;
  const long long smem = 4 * smem2_floats(KL, KR, cpb > 1 ? 2 : 1);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // the opt-in to 227 KB of dynamic shared memory, once per device (it
  // does not lower occupancy: a launch is placed by the bytes it asks for)
  static int opted_in_device = -1;
  if (smem > 48 * 1024 && opted_in_device != dev) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded2_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    opted_in_device = dev;
  }
  const dim3 grid((unsigned)rtiles, (unsigned)mtiles,
                  (unsigned)((C + cpb - 1) / cpb));
  banded2_kernel<NQ><<<grid, T2THREADS, (size_t)smem, st>>>(
      band, right, maps, X, sc, sl, out, C, cpb, m, l, r, w, KL, KR);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile of the live maps the wrapper must pass.
int banded_matmul_tile_rows() { return TM; }

// Rows per group of the two-sided kernel's group maps.
int banded_matmul_group_rows() { return GR; }

// out (m, n) = band (m, l) @ X (l, n). band is contiguous float32; klo and
// khi are int32 arrays of ceil(m / 32) entries, the k-range [klo, khi) of
// each 32-row tile (0 <= klo <= khi <= l, and every nonzero of the tile's
// rows inside it); X has row stride ldx and unit column stride; out is
// contiguous. Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the launch cannot take.
int banded_matmul_f32(const float* band, const int* klo, const int* khi,
                      const float* X, long long ldx, float* out, int m, int l,
                      int n, void* stream) {
  if (m <= 0 || n <= 0 || l < 0 || ldx < n) return (int)cudaErrorInvalidValue;
  const long long row_tiles = (m + TM - 1) / TM;
  const long long col_tiles = (n + NTHREADS - 1) / NTHREADS;
  if (row_tiles > 65535 || col_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)col_tiles, (unsigned)row_tiles);
  banded_matmul_kernel<<<grid, NTHREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      band, klo, khi, X, ldx, out, m, l, n);
  return (int)cudaGetLastError();
}

// out (C, m, r) = band (m, l) @ X[c] (l, w) @ right (r, w)^T for c < C, in
// one launch. band and right are contiguous float32; maps is the int32
// array [klo | khi] of band's ceil(m / 32) row tiles, [jlo | jhi] of
// right's ceil(r / 32) row tiles, then the same of band's ceil(m / 4) and
// right's ceil(r / 4) row groups (banded_matmul_group_rows() rows a
// group), each range holding every nonzero of its rows (a group's range
// inside its tile's); KL and KR are the widest tile ranges. X has channel
// stride sc, row stride sl and unit column stride; out is contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the launch cannot take (among them
// live ranges whose patches do not fit a block's 227 KB).
int banded2_matmul_f32(const float* band, const float* right, const int* maps,
                       const float* X, long long sc, long long sl, float* out,
                       int C, int m, int l, int r, int w, int KL, int KR,
                       void* stream) {
  if (C <= 0 || m <= 0 || r <= 0 || l < 0 || w < 0 || KL < 0 || KR < 0 ||
      KL > l || KR > w || (m + TM - 1) / TM > 65535 || C > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (std::min(4, std::max(1, (KR + 31) / 32))) {
    case 1:
      return launch2<1>(band, right, maps, X, sc, sl, out, C, m, l, r, w, KL,
                        KR, dev, sms, st);
    case 2:
      return launch2<2>(band, right, maps, X, sc, sl, out, C, m, l, r, w, KL,
                        KR, dev, sms, st);
    case 3:
      return launch2<3>(band, right, maps, X, sc, sl, out, C, m, l, r, w, KL,
                        KR, dev, sms, st);
    default:
      return launch2<4>(band, right, maps, X, sc, sl, out, C, m, l, r, w, KL,
                        KR, dev, sms, st);
  }
}

}  // extern "C"
