// Banded matrix product for Hopper (sm_90a):
//   out (m, n) = band (m, l) @ X (l, n)
// with band a dense float32 copy of a band matrix, X float32 with unit
// column stride and row stride ldx, out float32 contiguous.
//
// Replaces keystone_tpu/ops/pallas_kernels.py::banded_matmul_pallas (the
// Pallas TPU kernel _banded_kernel, its wrapper banded_matmul and the
// 128 x 128 live-tile map band_tile_map). The plain PyTorch version of the
// same function is keystone_tpu_torch/ops/kernels.py::banded_matmul_plain.
//
// Where it runs. Dense SIFT (keystone_tpu_torch/ops/sift.py) expresses its
// Gaussian smoothing and its spatial binning + keypoint sampling as band
// matrices, four products a scale, twenty an image at five scales.
//
// What bounds it. The bands are narrow: at VOC's 375 x 500 images the
// smoothing operators have 5-21 nonzeros a row and the interleaved
// sampling operators 9-27, so an image's twenty products do about 0.53
// GFLOP of true band work against about 122 MB of X read and output
// written. Bytes bound it (about 36 us an image at 3.35 TB/s); the
// arithmetic is tiny, provided only the band is visited.
//
// What the design does about it.
//  * The live map is the kernel's own, at its 32-row tile height: for
//    each row tile the wrapper gives the first and one past the last
//    nonzero column over the tile's rows (klo, khi), computed on the host
//    and cached beside the band's device copy. A block loops over that
//    k-range only: 24-57 columns a tile at scale 0, 30-97 at scale 4. The
//    TPU's 128 x 128 tile map visits every column tile at these sizes.
//  * Each block owns a 32-row tile and 128 consecutive output columns,
//    one column a thread. It stages the tile's live band columns in
//    shared memory, transposed (k-major, 32 rows a k, so one 16-byte
//    load gives a thread 4 rows and the whole warp reads the same
//    address); X is not staged: each thread streams its column straight
//    from device memory, 8 rows ahead, the 32 lanes of a warp reading 128
//    contiguous bytes of an X row. Each X element is read once per row
//    tile whose live range covers it and feeds 32 FMAs from registers.
//    The 32 sums of a column stay in registers and are written once,
//    coalesced across the warp.
//  * True float32 FMAs, one sequential sum over k per output: no tensor
//    core (TF32 would change the numerics), no split of k, no atomics,
//    so the same inputs give the same bits.
//  * Every shape is taken: rows past m and columns past n are neither
//    read nor written; the k-range is the tile's own. A row tile with no
//    nonzero writes zeros.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;         // output rows per block (the live map's tile)
constexpr int NTHREADS = 128;  // output columns per block, one a thread
constexpr int KC = 128;        // live band columns staged per pass
constexpr int BTS = TM + 4;    // padded k-row of the staged band tile
constexpr int UNROLL = 8;      // X rows a thread has in flight

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

}  // namespace

extern "C" {

// Rows per tile of the live map the wrapper must pass.
int banded_matmul_tile_rows() { return TM; }

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

}  // extern "C"
