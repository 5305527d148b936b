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
// shape (n = 1024, d = 8192, k = 10) that is 68.9 GFLOP against 571 MB.
// The products run in 3xTF32 on the tensor cores, three TF32 products
// for each float32 one, so the bound is 3 x 68.9 GFLOP at the 495 TFLOP/s
// TF32 peak, 0.418 ms, against 0.170 ms for the bytes: operations. What
// holds the kernel back from it is feeding the tensor cores: every
// 128 x 128 tile reads two 128-column slabs of X through L2, 2.1 GB in
// all at this shape, and a copy of the kernel without its products takes
// about three quarters of the whole kernel's time (PERF.md).
//
// What the design does about it.
//  * Tensor cores through wgmma (m64nNk8, TF32, A from registers, B from
//    shared memory), in 3xTF32: each operand v is split into big =
//    tf32(v) and small = tf32(v - big), both rounded to nearest (ties
//    away, the rounding of cvt.rna.tf32.f32, done as an integer add and
//    mask), and each k-step takes small*big + big*small + big*big. A
//    truncating split would bias every operand toward zero, and on the
//    diagonal of G (sums of squares) that bias adds up over the rows.
//  * TF32 wgmma reads B K-major only, and X is row-major, so both
//    operands of X^T X arrive MN-major. Raw slabs of 32 rows are copied
//    into a ring of four shared buffers with cp.async, three slabs ahead;
//    a split pass reads each B slab once and writes its big and small
//    parts K-major, with the 128-byte swizzle wgmma's descriptor names;
//    each thread reads its A fragment straight from the raw slab (rows
//    padded by 8 floats, so the fragment reads hit 32 banks) and splits
//    it in registers. The copies and the split of the next slab run
//    while the current slab's wgmmas do, the split into the other of two
//    split buffers.
//  * The tensor cores' accumulator rounds toward zero, which on a sum of
//    squares is a bias, not noise. So each slab's 12 products accumulate
//    into a fresh wgmma accumulator that is then added, rounded to
//    nearest, into a float32 total in registers: 32 rounded adds for
//    1024 rows. The two accumulators (64 floats a thread each) are why a
//    tile is 128 x 128 and one block of two warpgroups runs on an SM.
//  * Only the upper-triangle tiles of G are computed (nt (nt + 1) / 2 of
//    the nt^2 tiles of 128 x 128, nt = ceil(d / 128)). Each tile is
//    staged in shared memory, once as it is and once transposed, and
//    added into G at (i, j) and (j, i) by bulk reduce-adds, one 512-byte
//    row each, which the memory system completes while the next block
//    runs. A diagonal tile stages only its upper triangle, mirrored: its
//    (a, b) and (b, a) entries take the cross terms in the opposite order
//    and differ in the last bit, so G stays exactly symmetric only this
//    way. Where G or its rows are not 16-byte aligned, the block adds the
//    staged tile element by element; that path, forced at the chunk
//    shape, takes 1.66x the bulk adds' time (PERF.md), which is why the
//    aligned case keeps its own epilogue.
//  * C is computed in tiles of 128 x 16 (wgmma m64n16k8), Y zero-padded
//    in shared memory, one 16-column group a block, so 10 live columns
//    no longer cost a 128-wide tile.
//  * Every output element has one owner and one summation order, and
//    each bulk add is the only add into its elements in a launch, so
//    results are bit-reproducible.
//  * In place: the block adds its tile into the carry once, after its
//    last slab; no (d, d) temporary per chunk.
//  * Ragged n, d and k: rows and columns past the edge are copied as
//    zeros (cp.async's source size) and their outputs are not written.
//    A row stride that is not a multiple of 4 floats, or X not 16-byte
//    aligned (a column slice), takes 4-byte copies.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;         // rows of every tile; columns of a G tile
constexpr int CN = 16;            // columns of a C tile
constexpr int BK = 32;            // rows of X a slab: one 128-byte K-major row
constexpr int KSTEP = 8;          // depth of one wgmma
constexpr int NTHREADS = 256;     // two warpgroups, 64 tile rows each
constexpr int RAW_LD = TILE + 8;  // padded row of a raw slab, in floats
constexpr int RAW_FLOATS = BK * RAW_LD;  // one raw slab
constexpr int RAW_SLOTS = 4;      // raw (A, B) slab pairs in flight
constexpr int SPLIT_FLOATS = TILE * BK;  // one K-major part (big or small)
constexpr int SLD = TILE + 8;     // row of a staged output tile, in floats
// [split buffer 0: big, small][split buffer 1: big, small][raw ring],
// after up to 1024 bytes of alignment for the 128-byte swizzle
constexpr int SMEM_BYTES =
    1024 + 4 * (4 * SPLIT_FLOATS + RAW_SLOTS * 2 * RAW_FLOATS);
static_assert(2 * TILE * SLD <= 4 * SPLIT_FLOATS + RAW_SLOTS * 2 * RAW_FLOATS,
              "the staged tile and its transpose fit the slab buffers");

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ inline void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// the split parts, written by ordinary stores, made visible to wgmma
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dst (global) += src (shared), `bytes` of float32, a multiple of 16,
// both 16-byte aligned; performed by the memory system, tracked as a bulk
// group
__device__ inline void bulk_add(float* dst, const float* src, int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ inline void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the staged rows have been read out (the shared memory may go)
__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads across the wait
template <int M>
__device__ inline void fence_regs(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a K-major operand in shared memory with the 128-byte
// swizzle: rows of 128 bytes (32 TF32 values of depth), 8-row groups
// 1024 bytes apart. The start address steps 32 bytes per k-step inside
// the swizzled row; the buffer itself is 1024-byte aligned.
__device__ inline uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// v ~ big + small, both TF32, each rounded to nearest with ties away from
// zero (the rounding of cvt.rna.tf32.f32: add half of the dropped 13
// bits' range, then clear them); v - big is exact in float32
__device__ inline void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  const float s = v - __uint_as_float(big);
  small = (__float_as_uint(s) + 0x1000u) & 0xffffe000u;
}

// d (64 x N, this warpgroup's wgmma accumulator) = a (64 x 8, registers)
// . b (8 x N, K-major in shared memory) + (accumulate ? d : 0)
template <int N>
__device__ inline void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                  uint64_t b, int accumulate);

template <>
__device__ inline void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <>
__device__ inline void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                      uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// Block t of the grid -> output tile (bi, bj). The first n_tri blocks
// walk the upper triangle of G column by column (t = bj (bj + 1) / 2 +
// bi, bi <= bj); the rest walk the tiles of C, (bi, bj) = (t % nt,
// t / nt), bj a group of CN columns.
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

// Copies rows [r0, r0 + BK) and columns [c0, c0 + W) of src (row stride
// ld) into a raw slab, zeros past row n and column cols. VEC: 16-byte
// copies (src 16-byte aligned, ld a multiple of 4).
template <int W, bool VEC>
__device__ inline void load_slab(float* dst, const float* src, long long ld,
                                 int r0, int n, int c0, int cols, int tid) {
  if constexpr (VEC) {
    constexpr int QW = W / 4;
    for (int e = tid; e < BK * QW; e += NTHREADS) {
      const int r = e / QW, c = c0 + 4 * (e % QW);
      int bytes = 0;
      const float* p = src;
      if (r0 + r < n && c < cols) {
        bytes = cols - c >= 4 ? 16 : 4 * (cols - c);
        p = src + (long long)(r0 + r) * ld + c;
      }
      cp_async16(dst + r * RAW_LD + 4 * (e % QW), p, bytes);
    }
  } else {
    for (int e = tid; e < BK * W; e += NTHREADS) {
      const int r = e / W, c = c0 + e % W;
      const bool in = r0 + r < n && c < cols;
      cp_async4(dst + r * RAW_LD + e % W,
                in ? src + (long long)(r0 + r) * ld + c : src, in ? 4 : 0);
    }
  }
}

// The raw slab's first N columns, split into big and small parts laid
// out K-major (row c holds column c's 32 values of depth), 16-byte groups
// of depth swizzled by (c & 7): consecutive threads take consecutive
// columns, so the raw reads and the 16-byte stores hit 32 banks.
template <int N>
__device__ inline void split_slab(float* big, float* small, const float* raw,
                                  int tid) {
  for (int e = tid; e < N * (BK / 4); e += NTHREADS) {
    const int c = e % N, q = e / N;
    uint32_t hb[4], hs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(raw[(4 * q + i) * RAW_LD + c], hb[i], hs[i]);
    const int off = c * BK + 4 * (q ^ (c & 7));
    *reinterpret_cast<uint4*>(big + off) = make_uint4(hb[0], hb[1], hb[2], hb[3]);
    *reinterpret_cast<uint4*>(small + off) =
        make_uint4(hs[0], hs[1], hs[2], hs[3]);
  }
}

// The sums of one tile over every row of X: columns [i0, i0 + 128) of X
// against columns [j0, j0 + N) of B (X itself, or Y), B's columns past
// bcols being zero. `same`: B's columns are A's (a diagonal tile of G), so
// one slab serves both. Returns this thread's part of the tile in total,
// in wgmma's accumulator layout: total[4 q + v] is row 16 (warp % 4) + g
// + 8 (v >> 1) of the warpgroup's 64, column 8 q + 2 t + (v & 1), with
// g = lane / 4 and t = lane % 4.
template <int N, bool AVEC, bool BVEC>
__device__ inline void tile_sums(float (&total)[N / 2], float* sm,
                                 const float* X, long long ldx, int i0, int d,
                                 const float* B, long long ldb, int j0,
                                 int bcols, bool same, int n) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's A rows: the tile's columns of X, the warpgroup's 64
  const int arow = 64 * (warp / 4) + 16 * (warp % 4) + g;
  float* split = sm;                      // [2][big, small]
  float* raw = sm + 4 * SPLIT_FLOATS;     // [RAW_SLOTS][A, B]
  auto raw_a = [&](int s) { return raw + (s % RAW_SLOTS) * 2 * RAW_FLOATS; };
  auto raw_b = [&](int s) { return same ? raw_a(s) : raw_a(s) + RAW_FLOATS; };
  auto load = [&](int s) {
    load_slab<TILE, AVEC>(raw_a(s), X, ldx, s * BK, n, i0, d, tid);
    if (!same)
      load_slab<N, BVEC>(raw_a(s) + RAW_FLOATS, B, ldb, s * BK, n, j0, bcols,
                         tid);
  };
  auto split_into = [&](int s) {
    float* big = split + (s & 1) * 2 * SPLIT_FLOATS;
    split_slab<N>(big, big + SPLIT_FLOATS, raw_b(s), tid);
    fence_proxy_async();
  };

  float part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) total[i] = part[i] = 0.0f;

  const int slabs = (n + BK - 1) / BK;
#pragma unroll
  for (int p = 0; p < RAW_SLOTS - 1; ++p) {
    if (p < slabs) load(p);
    cp_async_commit();
  }
  cp_async_wait<RAW_SLOTS - 2>();
  __syncthreads();
  split_into(0);
  __syncthreads();
  for (int s = 0; s < slabs; ++s) {
    const float* ra = raw_a(s);
    const uint32_t big = smem_addr(split + (s & 1) * 2 * SPLIT_FLOATS);
    const uint32_t small = big + 4 * SPLIT_FLOATS;
#pragma unroll
    for (int u = 0; u < BK / KSTEP; ++u) {
      const float* pa = ra + (KSTEP * u + t) * RAW_LD + arow;
      uint32_t ab[4], as[4];
      split_tf32(pa[0], ab[0], as[0]);
      split_tf32(pa[8], ab[1], as[1]);
      split_tf32(pa[4 * RAW_LD], ab[2], as[2]);
      split_tf32(pa[4 * RAW_LD + 8], ab[3], as[3]);
      const uint64_t db = kmajor_desc(big + 32 * u);
      const uint64_t ds = kmajor_desc(small + 32 * u);
      wgmma_fence();
      wgmma_tf32<N>(part, as, db, u > 0);
      wgmma_tf32<N>(part, ab, ds, 1);
      wgmma_tf32<N>(part, ab, db, 1);
      wgmma_commit();
    }
    // the copies RAW_SLOTS - 1 slabs ahead and the split of the next slab
    // run beside this slab's products. The slot of slab s + RAW_SLOTS - 1
    // was last read in slab s - 1, and the split buffer of slab s + 1 by
    // slab s - 1's products, all complete before the barrier ending it.
    if (s + RAW_SLOTS - 1 < slabs) load(s + RAW_SLOTS - 1);
    cp_async_commit();
    if (s + 1 < slabs) {
      cp_async_wait<RAW_SLOTS - 2>();
      __syncthreads();
      split_into(s + 1);
    }
    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) total[i] += part[i];
    __syncthreads();
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1)
gram_cross_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                  float* __restrict__ G, float* __restrict__ C, int n, int d,
                  int k, long long ldx, long long ldy, int nt,
                  long long n_tri, bool bulk) {
  extern __shared__ uint8_t smem_raw[];
  float* sm = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  int bi, bj;
  bool is_c;
  tile_of(blockIdx.x, n_tri, nt, &bi, &bj, &is_c);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // total[4 q + 2 h + v] is row r0 + 8 h, column j0 + 8 q + cl + v
  const int r0 = bi * TILE + 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
  const int cl = 2 * (lane % 4);

  if (is_c) {
    float total[CN / 2];
    const int j0 = bj * CN;
    tile_sums<CN, VEC, false>(total, sm, X, ldx, bi * TILE, d, Y, ldy, j0, k,
                              false, n);
    // every load before the stores
    float old[CN / 2];
#pragma unroll
    for (int i = 0; i < CN / 2; ++i) {
      const int r = r0 + 8 * ((i / 2) % 2), c = j0 + 8 * (i / 4) + cl + i % 2;
      old[i] = r < d && c < k ? __ldcs(C + (long long)r * k + c) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < CN / 2; ++i) {
      const int r = r0 + 8 * ((i / 2) % 2), c = j0 + 8 * (i / 4) + cl + i % 2;
      if (r < d && c < k) __stcs(C + (long long)r * k + c, old[i] + total[i]);
    }
    return;
  }

  float total[TILE / 2];
  const int j0 = bj * TILE;
  const bool diag = bi == bj;
  tile_sums<TILE, VEC, VEC>(total, sm, X, ldx, bi * TILE, d, X, ldx, j0, d,
                            diag, n);
  // The tile is staged in shared memory (free once the last slab is
  // done): D[r][c] = tile[r][c] and T[c][r] = tile[r][c], or, for a
  // diagonal tile, D alone as the symmetric completion of its upper
  // triangle (entries below the diagonal dropped). Then G[i0 + r][j0 +
  // c] += D[r][c] and G[j0 + c][i0 + r] += T[c][r], one row at a time.
  float* D = sm;
  float* T = sm + TILE * SLD;
  const int rl = r0 - bi * TILE;
#pragma unroll
  for (int q = 0; q < TILE / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, c = 8 * q + cl;
      const float v0 = total[4 * q + 2 * h], v1 = total[4 * q + 2 * h + 1];
      if (!diag) {
        *reinterpret_cast<float2*>(D + r * SLD + c) = make_float2(v0, v1);
        T[c * SLD + r] = v0;
        T[(c + 1) * SLD + r] = v1;
        continue;
      }
#pragma unroll
      for (int v = 0; v < 2; ++v)
        if (c + v >= r) {
          D[r * SLD + c + v] = v ? v1 : v0;
          D[(c + v) * SLD + r] = v ? v1 : v0;
        }
    }
  const int i0 = bi * TILE;
  if (bulk) {
    // one bulk reduce-add a row (512 bytes at most), 16-byte aligned
    // rows; the block waits only for its staged rows to be read out, and
    // the adds complete in L2 while the next block runs
    fence_proxy_async();
    __syncthreads();
    const int row = threadIdx.x % TILE;
    const bool mirror = threadIdx.x >= TILE;
    const int gr = (mirror ? j0 : i0) + row, gc = mirror ? i0 : j0;
    const int cols = d - gc < TILE ? d - gc : TILE;
    if ((!mirror || !diag) && gr < d)
      bulk_add(G + (long long)gr * d + gc, (mirror ? T : D) + row * SLD,
               4 * cols);
    bulk_commit();
    bulk_wait_read();
    return;
  }
  // G not 16-byte aligned or d not a multiple of 4: element by element,
  // a warp on 32 consecutive columns of a row
  __syncthreads();
  for (int e = threadIdx.x; e < TILE * TILE; e += NTHREADS) {
    const int r = e / TILE, c = e % TILE;
    if (i0 + r < d && j0 + c < d) {
      float* p = G + (long long)(i0 + r) * d + j0 + c;
      __stcs(p, __ldcs(p) + D[r * SLD + c]);
    }
    if (!diag && j0 + r < d && i0 + c < d) {
      float* p = G + (long long)(j0 + r) * d + i0 + c;
      __stcs(p, __ldcs(p) + T[r * SLD + c]);
    }
  }
}

}  // namespace

extern "C" {

// G (d, d) += X^T X and C (d, k) += X^T Y for X (n, d) with row stride
// ldx and Y (n, k) with row stride ldy; G and C are contiguous. Launches
// on `stream` and returns the launch's error (0 on success), or
// cudaErrorInvalidValue when the grid would exceed 2^31 - 1 blocks.
int gram_cross_f32(const float* X, const float* Y, float* G, float* C, int n,
                   int d, int k, long long ldx, long long ldy, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const int nt = (d + TILE - 1) / TILE;
  const int nkt = (k + CN - 1) / CN;
  const long long n_tri = (long long)nt * (nt + 1) / 2;
  const long long blocks = n_tri + (long long)nt * nkt;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // the opt-in past 48 KB of dynamic shared memory, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static int opted_in_device = -1;
  if (err == cudaSuccess && opted_in_device != dev) {
    err = cudaFuncSetAttribute(gram_cross_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gram_cross_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err == cudaSuccess) opted_in_device = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const bool vec = reinterpret_cast<uintptr_t>(X) % 16 == 0 && ldx % 4 == 0;
  const bool bulk = reinterpret_cast<uintptr_t>(G) % 16 == 0 && d % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    gram_cross_kernel<true><<<(unsigned)blocks, NTHREADS, SMEM_BYTES, st>>>(
        X, Y, G, C, n, d, k, ldx, ldy, nt, n_tri, bulk);
  else
    gram_cross_kernel<false><<<(unsigned)blocks, NTHREADS, SMEM_BYTES, st>>>(
        X, Y, G, C, n, d, k, ldx, ldy, nt, n_tri, bulk);
  return (int)cudaGetLastError();
}

// Rows of X a slab: each slab's products accumulate afresh on the tensor
// cores and are then added, rounded, into the float32 total.
int gram_cross_slab_rows() { return BK; }

}  // extern "C"
