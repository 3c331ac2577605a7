// OpEuclidean / OpAngular in batched form (a GEMM with the distance
// epilogue) and the row-norm kernel, OpAngular's second output.
//
// Replaces: repro/kernels/distance.py, _distance_kernel and _norm_kernel
// (the Pallas TPU kernels, which run the product on the MXU at
// Precision.HIGHEST and carry the accumulator across K blocks in VMEM).
//
// What the distance kernel computes, per (query m, candidate n), over the
// feature axis cut into blocks of kKBlock = 128 (the reference's bk):
//   euclidean: sum over blocks of (|q_b|^2 - 2 q_b.c_b) + |c_b|^2, then
//              max(., 0) (NaN passes, as jnp.maximum lets it);
//   angular:   q.c.
//
// Arithmetic: 3xTF32 on the tensor cores, Hopper's counterpart of the
// TPU's emulated f32 (Precision.HIGHEST is several bf16 passes through
// the MXU).  Each f32 operand is split once as x = hi + lo, hi = x rounded
// to TF32 (cvt.rna), lo = x - hi, exact in f32; the tensor cores read lo
// truncated to TF32.  q.c is hi_q.hi_c + (hi_q.lo_c + lo_q.hi_c) in two
// f32 accumulators: every product is exact, the dropped lo_q.lo_c and the
// truncation of lo cost about 2.5 * 2^-21 of each |q_i c_i|, so a score
// is within ~1.2e-6 |q||c| of the f32 sum of its products, inside the
// 1e-5 scales it is held to; the large sum takes d / 8 tensor-core
// roundings and not 3 d / 8.  |q_b|^2 and |c_b|^2 are plain f32 sums of
// the raw values (__fmaf_rn).  A row holding a non-finite value or
// |x| > 2^126 (where hi overflows, or inf - inf and inf * 0 turn the
// split into NaN) is flagged during the split; its pairs are recomputed
// in plain f32 from global memory, so they equal the plain version's,
// non-finite values included.
//
// What bounds it on the H100, at the path's shapes (M = 1024 queries a
// chunk, N ~ 1e6, D = 128 or 100): the 3 * 2 M N D tensor operations over
// 495 TFLOP/s (TF32) and the (M D + N D + M N) * 4 bytes over 3.35 TB/s
// are about equal, ~1.6 ms (the M N output is almost all the bytes).  The
// old f32 bound, 2 M N D over 67 TFLOP/s, was 3.6-4.0 ms.
//
// What the design does about it: one launch per 128-wide K block (the
// second and later add into the output, as the plain form adds block by
// block).  In a launch, block b keeps query tile b % m_tiles (128 rows,
// split once, 128 KB of hi and lo in wgmma's 128-byte-swizzled K-major
// layout) in shared memory as the wgmma's B operand, and walks every
// (gridDim / m_tiles)-th candidate tile of 128 rows, so the database
// comes from HBM once per group of m_tiles blocks and from L2 for the
// rest.  A block is three warpgroups.  The producer streams raw
// candidate parts of 32 features through a ring of kStages slots with
// cp.async (16-byte copies where D % 4 == 0 and the rows are 16-byte
// aligned, else 4-byte ones; zero fill past M, N and D); an mbarrier per
// slot says when they have landed.  Each consumer warpgroup takes 64
// candidate rows as the A operand from registers: it loads its fragments
// of a part, splits them in registers (no shared-memory writes, no proxy
// fence, no barrier between the consumers), frees the slot at once and
// issues wgmma.m64n128k8.tf32, three per 8 features, the K pad cut to a
// multiple of 8 (13 k-steps at D = 100).  The two warpgroups take turns on
// the tensor cores; at a tile's end each closes the K block and writes
// its 64 x 128 scores, one float a store, 8 consecutive candidates of 4
// query rows a warp.
#include <algorithm>
#include <cstdint>

#include "datapath.cuh"

namespace {

constexpr int kKBlock = 128;  // the reference's K block (ops' bk)

// ---- the distance kernel: one launch per K block --------------------------
constexpr int kBM = 128;                         // query tile (the wgmma's B, N = 128)
constexpr int kBN = 128;                         // candidate tile (A: 64 rows a warpgroup)
constexpr int kBK = 32;                          // features a part
constexpr int kParts = kKBlock / kBK;            // parts of the resident query tile
constexpr int kStages = 5;                       // the candidate ring
constexpr int kConsumers = 2;                    // warpgroups of 64 candidate rows
constexpr int kThreads = 128 * (1 + kConsumers); // the producer warpgroup first
constexpr int kPartBytes = kBM * kBK * 4;        // a query part: 16 KB, 128-byte swizzled
constexpr int kQueryBytes = 2 * kParts * kPartBytes;  // the query tile's hi and lo
// a candidate part, raw: rows of 32 features padded to 36 floats, so the
// A fragments' loads (8 rows x 4 features a warp) hit 32 distinct banks
constexpr int kRowFloats = kBK + 4;
constexpr int kStageBytes = kBN * kRowFloats * 4;
static_assert(kBM == kBN, "the loaders map query and candidate rows alike");

struct Side {
  uint64_t loaded[kStages], empty[kStages], q_loaded;  // mbarriers
  float q2[kBM];    // the query tile's |q_b|^2
  uint8_t fq[kBM];  // flagged query rows
};
// the side data, then the 1024-byte-aligned query tile (its swizzle
// repeats every 1024 bytes), then the ring
constexpr int kSmemBytes =
    static_cast<int>(sizeof(Side)) + 1023 + kQueryBytes + kStages * kStageBytes;
static_assert(kSmemBytes <= 232448, "227 KB of shared memory a block");

__device__ __forceinline__ float max0_keep_nan(float x) { return (x > 0.0f || x != x) ? x : 0.0f; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

// wait until the barrier's phase of parity `parity` has completed (the
// spin stays inside one asm block, so the compiler sees no divergent loop)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// cp.async with zero fill: `bytes` of the copy's size come from src, the
// rest are zeros (bytes == 0 reads nothing)
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO), LBO unused (1) for swizzled K-major layouts
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RF_ACC8(b)                                                                   \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),   \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 128 f32) = A (64 x 8 TF32, from registers) * B (128 x 8 TF32,
// shared memory, K-major)^T + (accumulate ? d : 0).  Thread t of the
// warpgroup holds A[16 (t / 32) + (t % 32) / 4 + {0, 8}][t % 4 + {0, 4}]
// as a = {(r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4)}.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : RF_ACC8(0), RF_ACC8(8), RF_ACC8(16), RF_ACC8(24), RF_ACC8(32), RF_ACC8(40),
        RF_ACC8(48), RF_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
#undef RF_ACC8

// one candidate part's products, kSteps k-steps of 8 features: hi.hi into
// hi, hi.lo + lo.hi into lo.  Straight-line code for each kSteps: ptxas
// fences a wgmma that sits under a branch.
template <int kSteps>
__device__ __forceinline__ void mma_part(float (&hi)[64], float (&lo)[64],
                                         const uint32_t (&a_hi)[4][4],
                                         const uint32_t (&a_lo)[4][4], uint32_t b_hi,
                                         uint32_t b_lo, bool first) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint64_t dbh = smem_desc(b_hi + 32 * kk), dbl = smem_desc(b_lo + 32 * kk);
    const int acc = (first && kk == 0) ? 0 : 1;
    wgmma_tf32_rs(hi, a_hi[kk], dbh, acc);
    wgmma_tf32_rs(lo, a_hi[kk], dbl, acc);
    wgmma_tf32_rs(lo, a_lo[kk], dbh, 1);
  }
}

// one K block's score of one pair in plain f32 (one fused multiply-add a
// feature): the rare path for pairs with a flagged row
template <bool kEuclid>
__device__ float plain_block(const float* __restrict__ qr, const float* __restrict__ cr, int kw) {
  float part = 0.0f, q2 = 0.0f, c2 = 0.0f;
  for (int k = 0; k < kw; ++k) {
    const float a = qr[k], b = cr[k];
    part = __fmaf_rn(a, b, part);
    if (kEuclid) {
      q2 = __fmaf_rn(a, a, q2);
      c2 = __fmaf_rn(b, b, c2);
    }
  }
  return kEuclid ? __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, part)), c2) : part;
}

// the copy of 4 features (one 16-byte chunk) of one row: 16-byte cp.async
// where the rows are 16-byte aligned, else 4-byte ones; zero fill past
// `rows` and `kw`
__device__ __forceinline__ void load_chunk(uint32_t dst, const float* __restrict__ src, int row,
                                           int rows, int col, int kw, int ld, bool vec) {
  const bool live = row < rows;
  const float* p = src + static_cast<size_t>(live ? row : 0) * ld + col;
  if (vec) {
    const bool any = live && col < kw;  // kw % 4 == 0: the chunk is all in or all out
    cp_async16(dst, any ? p : src, any ? 16u : 0u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = live && col + e < kw;
      cp_async4(dst + 4 * e, in ? p + e : src, in ? 4u : 0u);
    }
  }
}

// the split of one 16-byte chunk: hi over x, lo at the same offset of the
// lo part; adds the squares to *sq and returns whether the chunk needs
// the plain path
__device__ __forceinline__ bool split_chunk(uint8_t* hi_part, uint8_t* lo_part, uint32_t off,
                                            float* sq) {
  const float4 x = *reinterpret_cast<float4*>(hi_part + off);
  float4 hi, lo;
  hi.x = round_tf32(x.x);
  hi.y = round_tf32(x.y);
  hi.z = round_tf32(x.z);
  hi.w = round_tf32(x.w);
  lo.x = __fsub_rn(x.x, hi.x);
  lo.y = __fsub_rn(x.y, hi.y);
  lo.z = __fsub_rn(x.z, hi.z);
  lo.w = __fsub_rn(x.w, hi.w);
  *reinterpret_cast<float4*>(hi_part + off) = hi;
  *reinterpret_cast<float4*>(lo_part + off) = lo;
  float s = *sq;
  s = __fmaf_rn(x.x, x.x, s);
  s = __fmaf_rn(x.y, x.y, s);
  s = __fmaf_rn(x.z, x.z, s);
  s = __fmaf_rn(x.w, x.w, s);
  *sq = s;
  constexpr float kBig = 0x1p126f;
  return !(fabsf(x.x) <= kBig) || !(fabsf(x.y) <= kBig) || !(fabsf(x.z) <= kBig) ||
         !(fabsf(x.w) <= kBig);
}

// sum over the 8 lanes that hold one row's chunks
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ uint32_t row_any(uint32_t x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x |= __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the consumer warpgroups' barrier (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers) : "memory");
}

// the 4 lanes that hold one candidate row's features (lane % 4)
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ uint32_t quad_any(uint32_t x) {
  x |= __shfl_xor_sync(0xffffffffu, x, 1);
  return x | __shfl_xor_sync(0xffffffffu, x, 2);
}

// One K block (kw <= 128 features at stride ld) of the scores of q
// (m rows) against c (n rows), added to out unless first_block, clamped
// at 0 (euclidean) when last_block.  Block b holds query tile b % m_tiles
// and walks candidate tiles b / m_tiles, + gridDim.x / m_tiles, ...
template <bool kEuclid>
__global__ void __launch_bounds__(kThreads, 1)
    distance_kernel(const float* __restrict__ q, const float* __restrict__ c,
                    float* __restrict__ out, int m, int n, int kw, int ld, int first_block,
                    int last_block, int vec_loads) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Side& sd = *reinterpret_cast<Side*>(smem_raw);
  uint8_t* base = smem_raw + sizeof(Side);
  base += (1024u - (smem_addr(base) & 1023u)) & 1023u;
  uint8_t* ring = base + kQueryBytes;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sd.loaded[s], 128);
      mbar_init(&sd.empty[s], 128 * kConsumers);
    }
    mbar_init(&sd.q_loaded, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (m + kBM - 1) / kBM, n_tiles = (n + kBN - 1) / kBN;
  const int n_groups = gridDim.x / m_tiles;
  const int m0 = (blockIdx.x % m_tiles) * kBM, group = blockIdx.x / m_tiles;
  const int k_stages = (kw + kBK - 1) / kBK;
  // this block's candidate parts: k_stages of each of its tiles
  const int n_stages = (n_tiles - group + n_groups - 1) / n_groups * k_stages;

  // the role, as a value the compiler knows to be warp-uniform: ptxas
  // serializes wgmma in a path it thinks divergent
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    // ======== producer: cp.async of raw tiles ========
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int chunk = tid & 7, rb = tid >> 3;  // rows rb + 16 i, features 4 chunk ..
    const bool vec = vec_loads != 0;
    // the query tile, once, in wgmma's layout: row r at r * 128 bytes,
    // chunk j at 16 (j ^ (r % 8))
    const uint32_t sw = static_cast<uint32_t>((chunk ^ (rb & 7)) << 4);
    for (int ks = 0; ks < k_stages; ++ks) {
      const uint32_t part = smem_addr(base + ks * kPartBytes);
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {
        const int r = rb + 16 * i;
        load_chunk(part + r * 128 + sw, q, m0 + r, m, ks * kBK + 4 * chunk, kw, ld, vec);
      }
    }
    // arrives once this thread's copies have landed
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     smem_addr(&sd.q_loaded))
                 : "memory");
    // the candidate parts, as far ahead as the ring allows
    for (int g = 0; g < n_stages; ++g) {
      const int s = g % kStages, ks = g % k_stages;
      const int n0 = (group + g / k_stages * n_groups) * kBN;
      mbar_wait(&sd.empty[s], ((g / kStages) & 1) ^ 1);
      const uint32_t part = smem_addr(ring + s * kStageBytes);
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {
        const int r = rb + 16 * i;
        load_chunk(part + r * (kRowFloats * 4) + 16 * chunk, c, n0 + r, n,
                   ks * kBK + 4 * chunk, kw, ld, vec);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                       smem_addr(&sd.loaded[s]))
                   : "memory");
    }
  } else {
    // ======== consumers: split, 3xTF32 wgmma, epilogue ========
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int w = role - 1, t = tid % 128;
    // the wgmma's share: candidate rows r0, r0 + 8 of the tile (A rows
    // and accumulator rows), query columns 2 tq + 8 j + {0, 1}
    const int r0 = 64 * w + 16 * (t / 32) + (t % 32) / 4, tq = t % 4;

    // the query tile: split once in place, |q|^2 and flags of its rows
    mbar_wait(&sd.q_loaded, 0);
    {
      const int u = tid - 128, chunk = u & 7, rb = u >> 3;  // chunk of rows rb + 32 i
      const uint32_t sw = static_cast<uint32_t>((chunk ^ (rb & 7)) << 4);
      float q2p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      uint32_t bad = 0;
      for (int ks = 0; ks < k_stages; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (split_chunk(base + ks * kPartBytes, base + (kParts + ks) * kPartBytes,
                          (rb + 32 * i) * 128 + sw, &q2p[i]))
            bad |= 1u << i;
        }
      }
      bad = row_any(bad);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float q2 = row_sum(q2p[i]);
        if (chunk == 0) {
          sd.q2[rb + 32 * i] = q2;
          sd.fq[rb + 32 * i] = (bad >> i) & 1u;
        }
      }
      // wgmma reads the query tile through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      consumers_sync();
    }
    uint32_t flag_q = 0;  // bit 2 j + e: query column 2 tq + 8 j + e
#pragma unroll
    for (int j = 0; j < 32; ++j) flag_q |= static_cast<uint32_t>(sd.fq[2 * tq + 8 * (j / 2) + j % 2]) << j;

    float hi[64], lo[64];  // hi.hi, and hi.lo + lo.hi
    float c2p[2] = {0.0f, 0.0f};  // partial |c|^2 of rows r0, r0 + 8 over this thread's features
    uint32_t bad = 0;             // bit h: row r0 + 8 h holds a flagged value
    for (int g = 0; g < n_stages; ++g) {
      const int s = g % kStages, ks = g % k_stages;
      if (ks == 0) {
        c2p[0] = c2p[1] = 0.0f;
        bad = 0;
      }
      // the A fragments of this part, split in registers
      mbar_wait(&sd.loaded[s], (g / kStages) & 1);
      const float* part = reinterpret_cast<const float*>(ring + s * kStageBytes);
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = part[(r0 + 8 * (i & 1)) * kRowFloats + 8 * kk + tq + 4 * (i >> 1)];
          const float h = round_tf32(x);
          a_hi[kk][i] = __float_as_uint(h);
          a_lo[kk][i] = __float_as_uint(__fsub_rn(x, h));
          c2p[i & 1] = __fmaf_rn(x, x, c2p[i & 1]);
          if (!(fabsf(x) <= 0x1p126f)) bad |= 1u << (i & 1);
        }
      mbar_arrive(&sd.empty[s]);  // the part is in registers: its slot is free

      const uint32_t b_hi = smem_addr(base + ks * kPartBytes);
      const uint32_t b_lo = b_hi + kParts * kPartBytes;
      const int steps = min(kBK / 8, (kw - ks * kBK + 7) / 8);  // the K pad: multiples of 8
      fence_acc(hi);
      fence_acc(lo);
      wgmma_fence();
      static_assert(kBK / 8 == 4, "a part is 4 k-steps");
      switch (steps) {
        case 4: mma_part<4>(hi, lo, a_hi, a_lo, b_hi, b_lo, ks == 0); break;
        case 3: mma_part<3>(hi, lo, a_hi, a_lo, b_hi, b_lo, ks == 0); break;
        case 2: mma_part<2>(hi, lo, a_hi, a_lo, b_hi, b_lo, ks == 0); break;
        default: mma_part<1>(hi, lo, a_hi, a_lo, b_hi, b_lo, ks == 0); break;
      }
      wgmma_commit();
      wgmma_wait_all();  // the fragments' registers are reused by the next part
      fence_acc(hi);
      fence_acc(lo);
      if (ks != k_stages - 1) continue;

      // ---- the tile's last part: close the K block and write the tile ----
      const int n0 = (group + g / k_stages * n_groups) * kBN;
      const float c2[2] = {kEuclid ? quad_sum(c2p[0]) : 0.0f, kEuclid ? quad_sum(c2p[1]) : 0.0f};
      const uint32_t flag_c = quad_any(bad);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * tq + 8 * j + e;
          const float q2 = kEuclid ? sd.q2[col] : 0.0f;
          const bool q_live = m0 + col < m && !((flag_q >> (2 * j + e)) & 1u);
          float* dst = out + static_cast<size_t>(m0 + col) * n + n0 + r0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // pairs with a flagged row are left to the rare path below
            if (!q_live || n0 + r0 + 8 * h >= n || ((flag_c >> h) & 1u)) continue;
            const int i = 4 * j + 2 * h + e;
            const float qc = __fadd_rn(hi[i], lo[i]);
            // (|q_b|^2 - 2 q_b.c_b) + |c_b|^2
            float v = kEuclid ? __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, qc)), c2[h]) : qc;
            if (!first_block) v = __fadd_rn(dst[8 * h], v);
            if (kEuclid && last_block) v = max0_keep_nan(v);
            dst[8 * h] = v;
          }
        }
      // the rare path: pairs with a flagged row, in plain f32 from global memory
      if (flag_q | flag_c) {
        for (int j = 0; j < 32; ++j) {
          const int qrow = m0 + 2 * tq + 8 * (j / 2) + j % 2;
          for (int h = 0; h < 2; ++h) {
            const int cand = n0 + r0 + 8 * h;
            if (qrow >= m || cand >= n || !(((flag_q >> j) | (flag_c >> h)) & 1u)) continue;
            float* dst = out + static_cast<size_t>(qrow) * n + cand;
            float v = plain_block<kEuclid>(q + static_cast<size_t>(qrow) * ld,
                                           c + static_cast<size_t>(cand) * ld, kw);
            if (!first_block) v = __fadd_rn(*dst, v);
            if (kEuclid && last_block) v = max0_keep_nan(v);
            *dst = v;
          }
        }
      }
    }
  }
}

// one launch per K block; the launches of one call form one kernel call
template <bool kEuclid>
int launch_distance(const float* q, const float* c, float* out, int m, int n, int d,
                    cudaStream_t stream) {
  auto kernel = distance_kernel<kEuclid>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the ring needs more than the default 48 KB: allowed once per device
  static uint64_t allowed = 0;
  if (dev < 64 && !((allowed >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed |= 1ull << dev;
  }
  // each query tile in n_groups blocks, which split the candidate tiles
  const int m_tiles = (m + kBM - 1) / kBM, n_tiles = (n + kBN - 1) / kBN;
  const int n_groups = std::max(1, std::min(sms / m_tiles, n_tiles));
  if (static_cast<long long>(m_tiles) * n_groups > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int kb = 0; kb < d; kb += kKBlock) {
    const float* qb = q + kb;
    const float* cb = c + kb;
    const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(qb) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cb) % 16 == 0;
    kernel<<<m_tiles * n_groups, kThreads, kSmemBytes, stream>>>(
        qb, cb, out, m, n, std::min(kKBlock, d - kb), d, kb == 0, kb + kKBlock >= d, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ---- the norm kernel: two variants, the same bits -------------------------
//
// |c_n|^2 per row, summed as the reference's _norm_kernel sums it: each
// 128-feature block's sum (a lane squares 4 consecutive features and adds
// the products in order, then an xor tree at 16, 8, 4, 2, 1 closes the
// block) adds into the row's total, block by block.  Bound by bytes: N D 4 B
// read once.
//
// Warp a row (variant 0), for long, narrow tables: a warp walks its row's
// blocks one after another, 8 rows a 256-thread block.  A row's blocks are
// dependent round trips to memory, so a table of few rows runs on few warps
// of few SMs (16 x 4096: 2 blocks, 32 trips in a row).
//
// Short-wide (variant 1), for tables of few, wide rows: a block of threads a
// row, its warps taking the row's blocks in turn (warp w: blocks w, w + W,
// ...), so the row's loads are in flight together.  Each warp forms its
// block's sum exactly as variant 0 does and leaves it in shared memory; one
// warp then adds the sums into the total in block order, the sums handed out
// by shuffles, so both variants give the same bits for every input.  A lane
// reads its 4 features as one float4 where every row is 16-byte aligned
// (d % 4 == 0 and an aligned table), else as 4 scalars, with the same
// arithmetic.  kernels/distance.py norm_variant picks the variant.

__global__ void norm_kernel(const float* __restrict__ c, float* __restrict__ out, int n,
                            int d) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const float* src = c + static_cast<size_t>(row) * d;
  float total = 0.0f;
  for (int kb = 0; kb < d; kb += kKBlock) {
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kb + lane * 4 + e;
      if (col < d) {
        const float x = src[col];
        s = __fadd_rn(s, __fmul_rn(x, x));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    total = __fadd_rn(total, s);
  }
  if (lane == 0) out[row] = total;
}

// a row's block sums live in the block's shared memory: 48 KB, d up to 1.5M
constexpr int kWideMaxBlocks = 48 * 1024 / 4;

__global__ void norm_wide_kernel(const float* __restrict__ c, float* __restrict__ out, int d,
                                 int vec) {
  extern __shared__ float sums[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int blocks = (d - 1) / kKBlock + 1;
  const float* src = c + static_cast<size_t>(blockIdx.x) * d;
  for (int b = warp; b < blocks; b += warps) {
    const int col = b * kKBlock + lane * 4;
    float s = 0.0f;
    if (vec) {
      if (col < d) {  // d % 4 == 0: the lane's 4 features are all in the row
        const float4 x = __ldg(reinterpret_cast<const float4*>(src + col));
        s = __fadd_rn(s, __fmul_rn(x.x, x.x));
        s = __fadd_rn(s, __fmul_rn(x.y, x.y));
        s = __fadd_rn(s, __fmul_rn(x.z, x.z));
        s = __fadd_rn(s, __fmul_rn(x.w, x.w));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < d) {
          const float x = src[col + e];
          s = __fadd_rn(s, __fmul_rn(x, x));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) sums[b] = s;
  }
  __syncthreads();
  if (warp != 0) return;
  float total = 0.0f;
  for (int b0 = 0; b0 < blocks; b0 += 32) {
    const int here = min(32, blocks - b0);
    const float mine = lane < here ? sums[b0 + lane] : 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float s = __shfl_sync(0xffffffffu, mine, j);
      if (j < here) total = __fadd_rn(total, s);
    }
  }
  if (lane == 0) out[blockIdx.x] = total;
}

}  // namespace

// q: (m, d) f32, c: (n, d) f32, both row-major; out: (m, n) f32.
// mode 0 = euclidean, 1 = angular.
extern "C" int rayflex_distance(const void* q, const void* c, void* out, int m, int n,
                                int d, int mode, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (d <= 0 || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto cp = static_cast<const float*>(c);
  auto op = static_cast<float*>(out);
  return mode == 0 ? launch_distance<true>(qp, cp, op, m, n, d, s)
                   : launch_distance<false>(qp, cp, op, m, n, d, s);
}

// c: (n, d) f32 row-major; out: (n,) f32.  variant 0 = warp a row,
// 1 = short-wide (a block a row); both give the same bits.
extern "C" int rayflex_norm(const void* c, void* out, int n, int d, int variant,
                            void* stream) {
  if (n <= 0) return 0;
  if (d <= 0 || (variant != 0 && variant != 1)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto cp = static_cast<const float*>(c);
  auto op = static_cast<float*>(out);
  if (variant == 0) {
    const int threads = 256, rows_per_block = threads / 32;
    norm_kernel<<<(n + rows_per_block - 1) / rows_per_block, threads, 0, s>>>(cp, op, n, d);
  } else {
    const int blocks = (d - 1) / kKBlock + 1;
    if (blocks > kWideMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
    const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
    const int warps = std::min(32, blocks);
    norm_wide_kernel<<<n, warps * 32, blocks * sizeof(float), s>>>(cp, op, d, vec);
  }
  RAYFLEX_LAUNCH_RESULT();
}
