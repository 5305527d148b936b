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
// read and 2 * R * K * 4 bytes of output written: about 3,700 FLOP per
// byte at K = 1024, so the kernel is bound by arithmetic. The product
// runs in 3xTF32 (three TF32 products for each float32 one), so its bound
// is 3 x 2 P F K at the TF32 peak. Beside the product every patch value
// has to be read, centered, split into TF32 parts and stored for the
// tensor cores, and every product rectified and pooled: in the design
// before this one those phases ran between its products, and with the
// product removed it took 47% of its whole time (PERF.md). A wgmma of 64
// rows reads its shared operand at 64 bytes a clock, half of what shared
// memory gives, so the phases beside it have to move little through
// shared memory, and they run on few warps, so their latency, not their
// instruction count, is what they cost.
//
// What the design does about it.
//  * The product is wgmma m64n64k8 in 3xTF32 with the FILTERS as the
//    register operand A and the PATCHES as the shared operand B: each
//    operand v is split into big = tf32(v) and small = tf32(v - big), and
//    each k-step takes (patch small) * (filter big), (patch big) *
//    (filter small), then big * big, into float32 accumulators. Patches
//    are centered on their own mean as they are staged, which makes the
//    product (x - m) . f = raw - m fsum directly, without the plain
//    version's cancellation.
//  * The filters are split once per model (kernels.py::featurize_plan,
//    in torch): big by truncation, small rounded to nearest, laid out in
//    the order each consumer thread holds its wgmma A fragments: float32
//    [tile Kp/128][warpgroup 2][k-step ks][warp 4][lane 32][8], the 8 being
//    big then small of a0..a3, a0 = (filter 64 wg + 16 warp + g, depth
//    8 k + t), a1 = filter + 8, a2 = depth + 4, a3 = both (g = lane / 4, t
//    = lane % 4), zero past K and past F; ks = max(14, ceil(F / 8)). A
//    consumer thread loads its tile's first 14 k-steps into 112 registers
//    once per tile and never splits a filter value; a patch whose depth
//    passes 112 streams its further k-steps from the plan each chunk (the
//    second instantiation, which waits for each of those k-steps).
//  * Warp-specialized persistent blocks, one an SM, over (filter tile of
//    128, image) items cut into one contiguous run a block, tile major.
//    A producer warpgroup (56 registers a thread) copies each image into
//    shared memory with cp.async one image ahead, its rows padded so that
//    the patches of neighbouring rows fall in other banks; computes every
//    patch's mean and 1 / sd once an item from box sums (per image row,
//    each patch column's S * C values; then per patch its S rows'); then
//    for each chunk of 64 patches writes the centered patches, split,
//    K-major under the 128-byte swizzle that wgmma's descriptor reads
//    (big at depths [0, 8 ks), small at [8 ks, 16 ks) of one row, so no
//    depth block is half empty), into a ring of up to three chunk
//    buffers. mbarriers hand them over, one arrival a warp (full: 4
//    producer warps; empty: 8 consumer warps). Each value is split once.
//    Two consumer warpgroups (224 registers a thread) take 64 filters
//    each of the same chunk; each keeps two accumulators, so the epilogue
//    and pooling of one chunk run on the CUDA cores while the next
//    chunk's wgmmas run, and the two issue their wgmmas in turns (named
//    barriers 2 and 3), so one's epilogue also runs beside the other's
//    products. Chunk, image and buffer counters advance by one; no 64-bit
//    division is left in the loop.
//  * Pooling straight from the accumulator registers. A thread holds 2
//    filters x 16 patches of a chunk, and the same 2 filters over the
//    whole image. The patches are staged in an order the wrapper sorts by
//    pooling class (the set of regions a patch lies in: a run of the
//    table kernels.py::featurize_columns), so each class is a run of
//    columns; the thread sums its rectified values of both signs along
//    the run in registers, and at the class's end the four threads of a
//    quad add their sums (two shuffles) and add them to the class's
//    regions in shared memory. Classes end 9 times an image at the main
//    geometry, in 4 of its 12 chunks, so a chunk without an end takes a
//    path with no branch, and pooling costs registers, not shared memory
//    traffic. Any region count is taken; the region sums are R x 2 x 128
//    floats of shared memory.
//  * The patch size S and the channel count C are runtime values (the
//    im2col reads through a per-launch table of offsets), so one kernel
//    takes every geometry whose staged form fits one block's shared
//    memory; the ring shrinks to two or one chunk buffers where the
//    region sums or a deep patch need the room.
//  * Every sum is taken in a fixed order (the products over depth in the
//    wgmma's order, the statistics per patch over its rows in order, the
//    pooling along classes in column order, the quads by xor shuffles,
//    whose sums are the same on every lane), with no atomics, so results
//    are bit-reproducible.
//  * NaN: a NaN pixel makes its patches' means NaN, so their centered
//    values, products and rectified sums NaN, as in the plain version;
//    the rectifier (max.NaN) keeps a NaN.
//
// Measured (PERF.md, H100 80GB HBM3 at 700 W, B = K = 1024): 2.10 ms of
// device time against the former design's 4.51 ms; the producer alone
// takes 1.32 ms of it, the producer with the products 1.33 ms (the
// products hide behind it), the consumers' epilogues alone 1.06 ms. The
// next gain is the im2col's latency on its one warp a scheduler.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (keystone_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KT = 128;          // filters a block: two consumer warpgroups
constexpr int PC = 64;           // patches a chunk: the wgmma's N
constexpr int KREG = 14;         // k-steps whose filter fragments stay in registers
constexpr int NTHREADS = 384;    // a producer and two consumer warpgroups
constexpr int MAX_STAGES = 3;    // chunk buffers in the ring
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int SMEM_LIMIT = 232448;  // bytes a block may use (227 KB)
constexpr int ROW_BYTES = 128;   // a K-major row of 32 TF32 values
constexpr int KBLOCK_BYTES = PC * ROW_BYTES;  // 32 depths of a chunk

// k-steps of 8 depths the product takes: at least the 14 held in registers
__host__ __device__ inline int ksteps_of(int F) {
  const int k = (F + 7) / 8;
  return k > KREG ? k : KREG;
}

// bytes of a chunk buffer: 64 patch rows, each the column's big parts
// (depths [0, 8 ks)) then its small parts (depths [8 ks, 16 ks)) on one
// depth axis, cut into 32-depth blocks of 128-byte rows
__host__ __device__ inline long long stage_bytes(int F) {
  return (long long)(ksteps_of(F) + 1) / 2 * KBLOCK_BYTES;
}

// byte offset of depth D (a multiple of 4) of row n in a chunk buffer:
// row n of D's 32-depth block, its 16-byte group swizzled by n % 8
__host__ __device__ inline int depth_offset(int D, int n) {
  return (D >> 5) * KBLOCK_BYTES + n * ROW_BYTES +
         ((((D >> 2) & 7) ^ (n & 7)) << 4);
}

__host__ __device__ inline long long align16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets in shared memory after the 1024-byte aligned base:
// [chunk buffers: nst][1 / sd: nst x PC][images: 2][row sums: sum, sq x
// H x OW][mean, 1 / sd: a staged column][region sums: R x 2 x KT][im2col
// offsets: 8 ks][mbarriers: full, empty x nst]
struct Smem {
  long long rsd, img, rows, stats, rs, koff, bars, bytes;
};

// floats between the rows of an image staged in shared memory: whole
// 16-byte groups, and not a multiple of 8 of them, so that the patches of
// a run of columns, which lie in neighbouring rows, fall in other banks
__host__ __device__ inline int image_pitch(int W, int C) {
  const int p = (W * C + 3) / 4 * 4;
  return p % 32 == 0 ? p + 4 : p;
}

__host__ __device__ inline long long image_floats(int H, int W, int C) {
  return (long long)H * image_pitch(W, C);
}

__host__ __device__ inline Smem smem_layout(int H, int W, int C, int S, int R,
                                            int nst) {
  const int F = S * S * C, OW = W - S + 1;
  const long long Pp = ((long long)(H - S + 1) * OW + PC - 1) / PC * PC;
  Smem m;
  m.rsd = (long long)nst * stage_bytes(F);
  m.img = m.rsd + 4LL * nst * PC;
  m.rows = m.img + 8 * image_floats(H, W, C);
  m.stats = m.rows + align16(8LL * H * OW);
  m.rs = m.stats + 8LL * Pp;
  m.koff = m.rs + 8LL * R * KT;
  m.bars = m.koff + 32LL * ksteps_of(F);
  m.bytes = 1024 + m.bars + 16LL * nst;
  return m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// max(v, 0) that keeps a NaN, as jnp.maximum and torch.clamp_min do:
// fmaxf returns its non-NaN operand, which would turn a NaN convolution
// value into a finite 0 and hide a poisoned image from every check
// downstream; max.NaN returns a NaN operand, in one instruction.
__device__ __forceinline__ float relu_nan(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}

// v ~ big + small, both TF32: the low 13 mantissa bits cleared (v - big
// is exact, so only small's truncation is lost, 2^-20 of v); a NaN stays
// a NaN in big
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the producer warpgroup's own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// the staged patches, written by ordinary stores, made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// keeps the compiler from moving accumulator reads across the wait
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a K-major operand in shared memory with the 128-byte
// swizzle: rows of 128 bytes (32 TF32 values of depth), 8-row groups
// 1024 bytes apart; the start address steps 32 bytes per k-step inside
// the swizzled row, and each 32-depth block is 1024-byte aligned.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 filters x 64 patches) = a (64 x 8, registers) . b (8 x 64,
// K-major in shared memory) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma64(float (&d)[32], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// k-step k of a chunk in 3xTF32: (patch small) * (filter big), (patch
// big) * (filter small), big * big; fr holds big a0..a3 then small, the
// chunk buffer at `stage` its big parts at depth 8 k, small at 8 (ks + k)
__device__ __forceinline__ void mma_kstep(float (&d)[32], const uint32_t* fr,
                                          uint32_t stage, int k, int ks,
                                          int accumulate) {
  const int db_ = 8 * k, ds_ = 8 * (ks + k);
  const uint64_t db = kmajor_desc(stage + (db_ >> 5) * KBLOCK_BYTES +
                                  (db_ & 31) * 4);
  const uint64_t ds = kmajor_desc(stage + (ds_ >> 5) * KBLOCK_BYTES +
                                  (ds_ & 31) * 4);
  wgmma64(d, fr[0], fr[1], fr[2], fr[3], ds, accumulate);
  wgmma64(d, fr[4], fr[5], fr[6], fr[7], db, 1);
  wgmma64(d, fr[0], fr[1], fr[2], fr[3], db, 1);
}

struct Args {
  const float* imgs;
  const float* frags;  // the plan's split filters (see the note)
  const float* bias;   // (Kp)
  const int4* cols;    // per staged column: patch offset, class end, end bits
  float* out;
  int B, H, W, C, S, K, Kp, nry, R, nst;
  bool vec;  // images 16-byte aligned, rows of whole float4s
  float var_constant, alpha;
};

// What a consumer thread keeps between chunks.
struct Consumer {
  uint32_t fr[KREG][8];  // its A fragments of the tile, big then small
  float bias[2];         // of its filters fl and fl + 8
  float run[4];          // class run sums: [2 h + sign]
  int cg, w, lane, t;    // warpgroup, warp in it, lane, lane % 4
  int fl, f;             // its filter of h = 0, the filter it writes
  int ks, nch;
  long long left;        // chunks left to issue
  int ch, kt, b, s, ph;  // the next chunk: its chunk of the image, tile,
                         // image, buffer and the buffer's phase parity
  int cur_kt;            // the tile in fr
  bool pend;             // a chunk's products are issued, its epilogue not run
  int p_s, p_ch, p_b, p_kt;  // that chunk's buffer, chunk, image, tile
  uint8_t* sm;
  long long sb;          // bytes of a chunk buffer
  float* rsd;
  float* rs;
  uint64_t* full;
  uint64_t* empty;
};

// the quad's class sums go to the class's regions: rows (first | count
// << 16) x columns; lane t adds (filter h = t / 2, sign t % 2)
__device__ __forceinline__ void flush(Consumer& c, float* __restrict__ rs, int rows,
                                      int cols, int nry, int f, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c.run[i] += __shfl_xor_sync(0xffffffffu, c.run[i], 1);
    c.run[i] += __shfl_xor_sync(0xffffffffu, c.run[i], 2);
  }
  const float v = t == 0 ? c.run[0] : t == 1 ? c.run[1]
                : t == 2 ? c.run[2] : c.run[3];
  const int r0 = rows & 0xffff, rn = rows >> 16;
  const int c0 = cols & 0xffff, cn = cols >> 16;
  for (int rx = r0; rx < r0 + rn; ++rx)
    for (int ry = c0; ry < c0 + cn; ++ry)
      rs[((rx * nry + ry) * 2 + (t & 1)) * KT + f] += v;
#pragma unroll
  for (int i = 0; i < 4; ++i) c.run[i] = 0.0f;
}

// One chunk's epilogue: conv = product / sd - bias, both rectified signs
// summed along the classes; then the chunk buffer is released, and after
// an image's last chunk its region sums are written out.
__device__ __forceinline__ void epilogue(Consumer& c, float (&d)[32],
                                         const Args& a,
                                         const float* __restrict__ rsd,
                                         float* __restrict__ rs,
                                         uint64_t* empty, int ch, int nch,
                                         int b, int kt, int f, int t) {
  const int4* cc = a.cols + ch * PC;
  // the bits of the class ends among the chunk's 64 columns
  const unsigned ends[2] = {(unsigned)__ldg(&cc[0].w),
                            (unsigned)__ldg(&cc[32].w)};
  if ((ends[0] | ends[1]) == 0) {
    // no class ends in the chunk: every column adds to the runs
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 r2 = *reinterpret_cast<const float2*>(rsd + 8 * q + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x0 = d[4 * q + 2 * h] * r2.x - c.bias[h];
        const float x1 = d[4 * q + 2 * h + 1] * r2.y - c.bias[h];
        c.run[2 * h] += relu_nan(x0 - a.alpha) + relu_nan(x1 - a.alpha);
        c.run[2 * h + 1] += relu_nan(-x0 - a.alpha) + relu_nan(-x1 - a.alpha);
      }
    }
  } else {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float2 r2 = *reinterpret_cast<const float2*>(rsd + 8 * q + 2 * t);
    float pv[2][2], nv[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float x = d[4 * q + 2 * h + v] * (v ? r2.y : r2.x) - c.bias[h];
        pv[h][v] = relu_nan(x - a.alpha);
        nv[h][v] = relu_nan(-x - a.alpha);
      }
    const unsigned mask = (ends[q / 4] >> (8 * (q % 4))) & 0xffu;
    if (mask == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        c.run[2 * h] += pv[h][0] + pv[h][1];
        c.run[2 * h + 1] += nv[h][0] + nv[h][1];
      }
      continue;
    }
    // class ends inside the group: the columns up to each end go to the
    // ending class (this lane's columns are 2t and 2t + 1)
    int lo = 0;
    for (unsigned m = mask; m; m &= m - 1) {
      const int e = __ffs(m) - 1;
      const bool i0 = 2 * t >= lo && 2 * t <= e;
      const bool i1 = 2 * t + 1 >= lo && 2 * t + 1 <= e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        c.run[2 * h] += (i0 ? pv[h][0] : 0.0f) + (i1 ? pv[h][1] : 0.0f);
        c.run[2 * h + 1] += (i0 ? nv[h][0] : 0.0f) + (i1 ? nv[h][1] : 0.0f);
      }
      const int4 en = __ldg(&cc[8 * q + e]);
      flush(c, rs, en.y, en.z, a.nry, f, t);
      lo = e + 1;
    }
    const bool i0 = 2 * t >= lo, i1 = 2 * t + 1 >= lo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c.run[2 * h] += (i0 ? pv[h][0] : 0.0f) + (i1 ? pv[h][1] : 0.0f);
      c.run[2 * h + 1] += (i0 ? nv[h][0] : 0.0f) + (i1 ? nv[h][1] : 0.0f);
    }
  }
  }
  // the warp's reads of the chunk buffer are done: one arrival a warp
  __syncwarp();
  if (c.lane == 0) mbar_arrive(empty);
  if (ch != nch - 1) return;
  // the image's pooled features, region-major, K pos then K neg values
  // per region; the padding columns' sums are dropped
  const int k = kt * KT + f;
  float* dst = a.out + (long long)b * a.R * 2 * a.K + (long long)(t & 1) * a.K + k;
  for (int r = 0; r < a.R; ++r) {
    float* p = rs + (r * 2 + (t & 1)) * KT + f;
    const float v = *p;
    *p = 0.0f;
    if (k < a.K) dst[(long long)r * 2 * a.K] = v;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c.run[i] = 0.0f;
}

// the plan's fragments of (tile kt, this thread), k-step k at + 256 k
__device__ __forceinline__ const uint4* frag_row(const Consumer& c,
                                                 const Args& a, int kt) {
  return reinterpret_cast<const uint4*>(a.frags) +
         (((long long)(kt * 2 + c.cg) * c.ks * 4 + c.w) * 32 + c.lane) * 2;
}

__device__ __forceinline__ void load_filters(Consumer& c, const Args& a,
                                             int kt) {
  const uint4* src = frag_row(c, a, kt);
#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    const uint4 u = __ldg(src + k * 256), v = __ldg(src + k * 256 + 1);
    c.fr[k][0] = u.x; c.fr[k][1] = u.y; c.fr[k][2] = u.z; c.fr[k][3] = u.w;
    c.fr[k][4] = v.x; c.fr[k][5] = v.y; c.fr[k][6] = v.z; c.fr[k][7] = v.w;
  }
  c.bias[0] = __ldg(a.bias + kt * KT + c.fl);
  c.bias[1] = __ldg(a.bias + kt * KT + c.fl + 8);
}

// the pending chunk's epilogue, its products complete
__device__ __forceinline__ void finish_pending(Consumer& c, float (&d)[32],
                                               const Args& a) {
  epilogue(c, d, a, c.rsd + c.p_s * PC, c.rs, c.empty + c.p_s, c.p_ch,
           c.nch, c.p_b, c.p_kt, c.f, c.t);
  c.pend = false;
}

// Issues chunk g's products into cur, then runs the pending chunk's
// epilogue on prev while they run.
template <bool TAIL>
__device__ __forceinline__ void consumer_step(Consumer& c, float (&cur)[32],
                                              float (&prev)[32],
                                              const Args& a) {
  const int ch = c.ch, kt = c.kt, b = c.b, s = c.s;
  if ((ch == 0 && kt != c.cur_kt) || a.nst == 1) {
    // the filter registers are rewritten, or the pending chunk's buffer
    // is the one this chunk waits for: finish the pending chunk first
    wgmma_wait<0>();
    fence_regs(prev);
    if (c.pend) finish_pending(c, prev, a);
    if (kt != c.cur_kt) {
      load_filters(c, a, kt);
      c.cur_kt = kt;
    }
  }
  mbar_wait(c.full + s, c.ph);
  const uint32_t stage = smem_addr(c.sm + (long long)s * c.sb);
  // the epilogue's reads of cur (two chunks ago) stay before the products
  fence_regs(cur);
  // the two warpgroups issue their products in turns, so that one's
  // epilogue runs while the other's products do (barriers 2 and 3: a
  // warpgroup waits for its own and then opens the other's)
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + c.cg) : "memory");
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < KREG; ++k)
    mma_kstep(cur, c.fr[k], stage, k, TAIL ? c.ks : KREG, k > 0);
  wgmma_commit();
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 + (c.cg ^ 1)) : "memory");
  fence_regs(cur);
  if constexpr (TAIL) {
    // depths past the registers' 112: fragments from the plan, one k-step
    // at a time
    const uint4* src = frag_row(c, a, kt);
    for (int k = KREG; k < c.ks; ++k) {
      wgmma_wait<0>();
      const uint4 u = __ldg(src + k * 256), v = __ldg(src + k * 256 + 1);
      const uint32_t fr[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      wgmma_fence();
      mma_kstep(cur, fr, stage, k, c.ks, 1);
      wgmma_commit();
    }
  }
  // the waits are unconditional, so that on every path the compiler sees
  // only cur's products in flight past this point
  wgmma_wait<1>();
  fence_regs(prev);
  if (c.pend) finish_pending(c, prev, a);
  c.pend = true;
  c.p_s = s;
  c.p_ch = ch;
  c.p_b = b;
  c.p_kt = kt;
  if (++c.ch == c.nch) {
    c.ch = 0;
    if (++c.b == a.B) {
      c.b = 0;
      ++c.kt;
    }
  }
  if (++c.s == a.nst) {
    c.s = 0;
    c.ph ^= 1;
  }
  --c.left;
}

// copies image b into a shared buffer, rows image_pitch apart (cp.async,
// one group)
__device__ __forceinline__ void prefetch_image(const Args& a, float* dst,
                                               int b, int tid) {
  const int wc = a.W * a.C, pitch = image_pitch(a.W, a.C);
  const float* src = a.imgs + (long long)b * a.H * wc;
  if (a.vec) {
    const int q = wc / 4;
    for (int e = tid; e < a.H * q; e += 128) {
      const int y = e / q, x = 4 * (e - y * q);
      cp_async16(dst + y * pitch + x, src + y * wc + x);
    }
  } else {
    for (int e = tid; e < a.H * wc; e += 128) {
      const int y = e / wc, x = e - y * wc;
      cp_async4(dst + y * pitch + x, src + e);
    }
  }
  cp_async_commit();
}

template <bool TAIL>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_featurize_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int B = a.B, H = a.H, W = a.W, C = a.C, S = a.S, nst = a.nst;
  const int F = S * S * C, SC = S * C, row = image_pitch(W, C);
  const int OH = H - S + 1, OW = W - S + 1, P = OH * OW;
  // k-steps of the product: the registers' 14 unless the patch is deeper
  // (a constant here, so the chunk buffer offsets are too)
  const int nch = (P + PC - 1) / PC, ks = TAIL ? ksteps_of(F) : KREG;
  const Smem L = smem_layout(H, W, C, S, a.R, nst);
  const long long sb = stage_bytes(F), imgf = image_floats(H, W, C);
  float* rsd_s = reinterpret_cast<float*>(sm + L.rsd);
  float* img_s = reinterpret_cast<float*>(sm + L.img);
  float* rows_s = reinterpret_cast<float*>(sm + L.rows);
  float2* stats_s = reinterpret_cast<float2*>(sm + L.stats);
  float* rs = reinterpret_cast<float*>(sm + L.rs);
  int* koff = reinterpret_cast<int*>(sm + L.koff);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + nst;

  const int tid = threadIdx.x;
  for (int e = tid; e < a.R * 2 * KT; e += NTHREADS) rs[e] = 0.0f;
  // the image offset of each depth k = (dy, dx, c) of a patch; -1 past F
  for (int k = tid; k < 8 * ks; k += NTHREADS)
    koff[k] = k < F ? (k / SC) * row + k % SC : -1;
  if (tid == 0)
    for (int s = 0; s < nst; ++s) {
      mbar_init(full + s, 4);   // one arrival a producer warp
      mbar_init(empty + s, 8);  // one arrival a consumer warp
    }
  __syncthreads();

  // the block's items, (filter tile, image), tile major
  const long long items = (long long)(a.Kp / KT) * B;
  const long long beg = items * blockIdx.x / gridDim.x;
  const long long end = items * (blockIdx.x + 1) / gridDim.x;
  if (beg >= end) return;
  const long long total = (end - beg) * nch;  // chunks of the block
  const int warp = tid / 32, lane = tid % 32;

  if (warp < 4) {
    // ---- producer: statistics and the split, swizzled im2col ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // a column n of the chunk a thread; the two halves of the threads take
    // every other 4 depths of the im2col
    const int n = tid & (PC - 1), half = tid >> 6;
    const int4* koff4 = reinterpret_cast<const int4*>(koff);
    const int HOW = H * OW;
    int b = (int)(beg % B), s = 0, ph = 0;  // the image, the next buffer
    prefetch_image(a, img_s, b, tid);
    int ib = 0;
    for (long long it = beg; it < end; ++it, ib ^= 1) {
      cp_async_wait_all();
      producer_sync();  // the image is in; the other buffer and the
                        // statistics of the last image are free
      const int bn = b + 1 == B ? 0 : b + 1;
      if (it + 1 < end) prefetch_image(a, img_s + (ib ^ 1) * imgf, bn, tid);
      b = bn;
      const float* im = img_s + ib * imgf;
      // every patch's mean and 1 / sd from box sums: per image row, the sums
      // of each patch column's S * C values and of their squares, then per
      // patch the sums of its S rows'
      for (int e = tid; e < HOW; e += 128) {
        const int y = e / OW, px = e - y * OW;
        const float* r = im + y * row + px * C;
        float sum = 0.0f, sq = 0.0f;
#pragma unroll 6
        for (int j = 0; j < SC; ++j) {
          sum += r[j];
          sq = fmaf(r[j], r[j], sq);
        }
        rows_s[e] = sum;
        rows_s[HOW + e] = sq;
      }
      producer_sync();
      // sd = sqrt(var + var_constant) with the unbiased variance (sum p^2 -
      // F m^2) / (F - 1) and a NaN guard, as in the plain version; stored
      // by staged column, (0, 0) for a padding column
      for (int j = tid; j < nch * PC; j += 128) {
        const int off = __ldg(&a.cols[j].x);
        float2 st = make_float2(0.0f, 0.0f);
        if (off >= 0) {
          const int py = off / row, px = (off - py * row) / C;
          float sum = 0.0f, sq = 0.0f;
#pragma unroll 6
          for (int dy = 0; dy < S; ++dy) {
            sum += rows_s[(py + dy) * OW + px];
            sq += rows_s[HOW + (py + dy) * OW + px];
          }
          const float m = sum / (float)F;
          const float var = (sq - (float)F * m * m) / ((float)F - 1.0f);
          float sd = sqrtf(var + a.var_constant);
          if (isnan(sd)) sd = sqrtf(a.var_constant);
          st = make_float2(m, 1.0f / sd);
        }
        stats_s[j] = st;
      }
      producer_sync();
      for (int ch = 0; ch < nch; ++ch) {
        mbar_wait(empty + s, ph ^ 1);
        const int off = __ldg(&a.cols[ch * PC + n].x);
        const float2 st = stats_s[ch * PC + n];
        if (half == 0) rsd_s[s * PC + n] = st.y;
        // the centered column, split, 4 depths a 16-byte store each of big
        // (depth k) and small (depth 8 ks + k); zero past F
        uint8_t* stage = sm + (long long)s * sb;
#pragma unroll 2
        for (int i = 0; i < ks; ++i) {
          const int c4 = 2 * i + half, k0 = 4 * c4;
          const int4 ko = koff4[c4];
          const int kk[4] = {ko.x, ko.y, ko.z, ko.w};
          uint32_t hb[4], hs[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v =
                off >= 0 && kk[i] >= 0 ? im[off + kk[i]] - st.x : 0.0f;
            split_tf32(v, hb[i], hs[i]);
          }
          *reinterpret_cast<uint4*>(stage + depth_offset(k0, n)) =
              make_uint4(hb[0], hb[1], hb[2], hb[3]);
          *reinterpret_cast<uint4*>(stage + depth_offset(8 * ks + k0, n)) =
              make_uint4(hs[0], hs[1], hs[2], hs[3]);
        }
        // the warp's stores, made visible to wgmma, then one arrival a warp
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + s);
        if (++s == nst) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumers: the product, the epilogue and the pooling -------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  Consumer c;
  const int cw = warp - 4;
  c.cg = cw / 4;
  c.w = cw % 4;
  c.lane = lane;
  c.t = lane % 4;
  c.fl = 64 * c.cg + 16 * c.w + lane / 4;
  c.f = c.fl + 8 * (c.t >> 1);
  c.ks = ks;
  c.nch = nch;
  c.left = total;
  c.kt = (int)(beg / B);
  c.b = (int)(beg % B);
  c.ch = 0;
  c.s = 0;
  c.ph = 0;
  c.sm = sm;
  c.sb = sb;
  c.rsd = rsd_s;
  c.rs = rs;
  c.full = full;
  c.empty = empty;
  c.cur_kt = -1;
  c.pend = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) c.run[i] = 0.0f;
  float acc0[32], acc1[32];
  if (c.cg == 1) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
  // chunk g accumulates in acc[g % 2]; each step leaves only its own
  // chunk's products in flight
  for (;;) {
    consumer_step<TAIL>(c, acc0, acc1, a);
    if (c.left == 0) {
      wgmma_wait<0>();
      fence_regs(acc0);
      finish_pending(c, acc0, a);
      return;
    }
    consumer_step<TAIL>(c, acc1, acc0, a);
    if (c.left == 0) {
      wgmma_wait<0>();
      fence_regs(acc1);
      finish_pending(c, acc1, a);
      return;
    }
  }
}

// the most chunk buffers that fit, or 0
int stages_for(int H, int W, int C, int S, int R) {
  for (int nst = MAX_STAGES; nst >= 1; --nst)
    if (smem_layout(H, W, C, S, R, nst).bytes <= SMEM_LIMIT) return nst;
  return 0;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs at least (one chunk buffer) for an
// image of H x W x C, patch S and R pooling regions, in bytes (above
// SMEM_LIMIT the launch is refused).
long long fused_featurize_smem_bytes(int H, int W, int C, int S, int R) {
  return smem_layout(H, W, C, S, R, 1).bytes;
}

// Floats between the rows of a staged image: the column table's patch
// offsets are in these rows.
int fused_featurize_image_pitch(int W, int C) { return image_pitch(W, C); }

// The wrapper's constants, checked against its own: filters a tile (the
// plan pads K to its multiple), patches a chunk (the column table pads
// the patches to its multiple) and the k-steps held in registers (the
// plan holds at least as many).
void fused_featurize_geometry(int* tile, int* chunk, int* kreg) {
  *tile = KT;
  *chunk = PC;
  *kreg = KREG;
}

// out (B, R * 2K) for images (B, H, W, C) float32 contiguous; frags the
// plan's split filters (see the note; Kp a multiple of the tile), bias
// (Kp) (zero past K), and cols the geometry's column table: 4 ints a
// staged column (a multiple of the chunk of them): the patch's offset in
// the staged image, rows fused_featurize_image_pitch apart (-1 for
// padding); at the last column of a pooling class its
// row and column region sets, each first | count << 16 (else -1, 0); and
// at every 8th column the bits of the class ends among its 8 columns.
// Launches on `stream`; returns the launch's error (0 on success), or
// cudaErrorInvalidValue for arguments it cannot take.
int fused_cifar_featurize_f32(const float* imgs, const float* frags,
                              const float* bias, const int* cols, float* out,
                              int B, int H, int W, int C, int S, int K, int Kp,
                              int nry, int R, float var_constant, float alpha,
                              void* stream) {
  if (B <= 0 || K <= 0 || S < 1 || S > H || S > W || C < 1 || R < 0 ||
      Kp % KT != 0 || Kp < K ||
      reinterpret_cast<uintptr_t>(frags) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cols) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nst = stages_for(H, W, C, S, R);
  if (nst == 0) return (int)cudaErrorInvalidValue;
  const long long smem = smem_layout(H, W, C, S, R, nst).bytes;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the opt-in to 227 KB of dynamic shared memory, once per device
  static int opted_in_device = -1;
  if (err == cudaSuccess && opted_in_device != dev) {
    err = cudaFuncSetAttribute(fused_featurize_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_featurize_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_LIMIT);
    if (err == cudaSuccess) opted_in_device = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)(Kp / KT) * B;
  const long long blocks = items < sms ? items : sms;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.imgs = imgs;
  a.frags = frags;
  a.bias = bias;
  a.cols = reinterpret_cast<const int4*>(cols);
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.C = C; a.S = S; a.K = K; a.Kp = Kp;
  a.nry = nry; a.R = R; a.nst = nst;
  a.vec = (W * C) % 4 == 0 && reinterpret_cast<uintptr_t>(imgs) % 16 == 0;
  a.var_constant = var_constant;
  a.alpha = alpha;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ksteps_of(S * S * C) > KREG)
    fused_featurize_kernel<true><<<(unsigned)blocks, NTHREADS, (size_t)smem,
                                   st>>>(a);
  else
    fused_featurize_kernel<false><<<(unsigned)blocks, NTHREADS, (size_t)smem,
                                    st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
