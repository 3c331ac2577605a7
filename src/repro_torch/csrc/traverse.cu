// The fused closest / any / shadow traversal kernel: one thread per ray,
// running the ray's whole pop -> box test -> OpTriangle -> commit -> push
// loop to its end, under any DatapathConfig: arity 4 or 8, node boxes in
// f32 or bf16, any stack size (8 variants: arity x box type x stack home).
//
// Replaces: repro/kernels/traverse.py, _traverse_kernel (the Pallas TPU
// kernel, where one 128-lane tile steps its rays in lockstep).
// What bounds it on the H100: the operations its jobs count set the bound
// (about 20 f32 operations a child box and 50 a triangle job, against a few
// hundred MB of distinct bytes), but what holds it is latency: every pop
// gathers a data-dependent record and waits on the pop before it, a warp
// runs as long as its slowest ray, and a warp whose rays disagree on the
// kind of node they pop runs both kinds.
// What the design does about it:
//   * the tree's layout (kernels/traverse.py, pack_bvh): each node above
//     the leaf parents holds its ARITY children's boxes as one record, rows
//     lo.x | lo.y | lo.z | hi.x | hi.y | hi.z of ARITY bounds (96 B in f32
//     at BVH4, 48 B in bf16, 192 B in f32 at BVH8), read with 16 B vector
//     loads; no leaf box is stored, and a leaf-parent pop counts its box job
//     and loads nothing for it (the plain version reads the box test only
//     at inner nodes, core/wavefront.py); each leaf slot holds its
//     triangle's 9 floats and its index (-1: empty) in three 16 B words, in
//     leaf-slot order, so a triangle job is 3 vector loads with no
//     dependent index load.  bf16 bounds upcast exactly (a shift of the
//     16 bits, as __bfloat162float does), since the codecs place every
//     bound the kernel reads on the bf16 grid;
//   * a short dependent chain per pop: the stack top stays in a register
//     (a pop after a push waits on no load; the stack is read only when a
//     pop pushes nothing), so a node's record loads issue as soon as the
//     step starts.  A stack of up to 64 entries is a thread-local array
//     (local memory, cached in L1) with the config's stack size as the
//     runtime limit; a deeper one is a column of per-thread device scratch
//     laid out slot-major (slot i of launch position r at i * n + r), so a
//     warp's accesses to one depth coalesce.  The ray's registers, best hit
//     and counters stay in registers; nothing is written before the ray
//     retires.  __launch_bounds__ caps the registers so that
//     min_blocks(ARITY) blocks of 128 threads stay resident: spill-free but
//     for one 4 B register of the BVH4 scratch-stack variants;
//   * one branch per warp step: the loop is warp-uniform, and each step
//     runs the branch (inner node or leaf parent) that more of the warp's
//     active lanes have on top (a vote); the other lanes wait one step.  A
//     lane always pops its own top, so each ray's sequence of pops, and
//     every counter, is the plain version's.  Thread r serves ray r: a
//     Z-order ray schedule made the kernel ~13% faster on clustered-1M's
//     camera rays, but its sort cost more than that on the H100.
//
// Semantics are the plain version's (core/wavefront.py) exactly: a round
// adds `arity` to triangle_jobs at every leaf parent even where slots hold
// -1; a hit commits when hit & idx >= 0 & t < t_best & t <= extent &
// t >= t_min, taking the first minimum; any/shadow rays retire on their
// first commit; children are pushed farthest first (the 5- or
// 19-comparator sort of datapath.cuh) when they hit and tmin < t_best, and
// a push past stack_size is dropped and flags stack_overflow.
#include <cuda_bf16.h>

#include "datapath.cuh"

namespace {

constexpr int kMaxLocalStack = 64;  // deepest stack kept in a local array
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlotWords = 3;  // 16 B words of a leaf slot: a.xyz b.x | b.yz c.xy | c.z idx

// Blocks of 128 threads each SM keeps resident: the register cap, the
// fastest of 4-8 on the H100.
constexpr int min_blocks(int arity) { return arity == 4 ? 7 : 6; }

// Ray operand rows (the reference's union layout, (16, n_pad) f32).
constexpr int kRowOrg = 0, kRowDir = 3, kRowInv = 6, kRowShear = 9, kRowK = 12, kRowExt = 15;

struct Params {
  const float* rays;  // (16, n_pad)
  int n_pad, n;
  const uint4* kids;   // (leaf_parent_offset, record words) child records
  const uint4* slots;  // (arity^depth, 3) leaf slots
  int leaf_parent_offset, max_rounds, any_hit;
  float t_min;
  int stack_size;
  int* stack_scratch;  // (stack_size, n) when the stack lives in scratch
  float* t_out;
  int *tri_out, *qb_out, *ntri_out, *ovf_out;
};

__device__ __forceinline__ unsigned word(const uint4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// A node's child record: rows lo.x | lo.y | lo.z | hi.x | hi.y | hi.z of
// ARITY bounds each, as f32 or bf16 bits, loaded as 16 B words.
template <int ARITY, typename BoxT>
struct ChildRecord {
  static constexpr int kPerWord = 16 / sizeof(BoxT);  // bounds a 16 B word holds
  static constexpr int kWords = 6 * ARITY / kPerWord;
  uint4 w[kWords];

  __device__ __forceinline__ void load(const uint4* __restrict__ kids, int node) {
    const uint4* p = kids + static_cast<size_t>(node) * kWords;
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldg(p + i);
  }
  // bound e of the record as f32 (bf16: its 16 bits are the f32's high half)
  __device__ __forceinline__ float at(int e) const {
    const uint4& v = w[e / kPerWord];
    if constexpr (kPerWord == 4) {
      return __uint_as_float(word(v, e % 4));
    } else {
      const unsigned u = word(v, (e % 8) / 2);
      return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
    }
  }
};

// Slot i of thread r's stack: a local array, or a column of device scratch
// addressed from the kernel's parameters (no register holds its base).
template <bool kLocal>
struct RayStack;

template <>
struct RayStack<true> {
  int slot[kMaxLocalStack];
  __device__ __forceinline__ int& at(const Params&, int, int i) { return slot[i]; }
};

template <>
struct RayStack<false> {
  __device__ __forceinline__ int& at(const Params& P, int r, int i) {
    return P.stack_scratch[static_cast<size_t>(i) * P.n + r];
  }
};

template <int ARITY, typename BoxT, bool kLocalStack>
__global__ void __launch_bounds__(kThreads, min_blocks(ARITY)) traverse_kernel(const Params P) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < P.n;  // columns n .. n_pad - 1 repeat ray 0

  float org[3], inv[3], shear[3];
  // kx, ky, kz (0..2) in bits 0-5 and the direction's sign bits in 6-8: one
  // register for the loop's life, unpacked where a branch needs them
  unsigned code = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    org[d] = __ldg(P.rays + (kRowOrg + d) * P.n_pad + r);
    inv[d] = __ldg(P.rays + (kRowInv + d) * P.n_pad + r);
    shear[d] = __ldg(P.rays + (kRowShear + d) * P.n_pad + r);
    const int kd = static_cast<int>(__ldg(P.rays + (kRowK + d) * P.n_pad + r));
    const bool neg = signbit(__ldg(P.rays + (kRowDir + d) * P.n_pad + r));
    code |= (static_cast<unsigned>(kd) << (2 * d)) | (static_cast<unsigned>(neg) << (6 + d));
  }
  const float extent = __ldg(P.rays + kRowExt * P.n_pad + r);

  RayStack<kLocalStack> stack;
  // slot sp - 1 whenever sp > 0, kept in a register: after a push it is
  // the last child pushed, so the next pop needs no load.  The root is
  // pre-pushed and never stored: it is popped first, before any push.
  int top = 0, sp = valid ? 1 : 0;
  float t_best = CUDART_INF_F;
  int best_tri = -1, n_qb = 0, n_tri = 0;
  bool overflow = false, done = false;

  for (;;) {  // one warp step; every lane of the warp runs it
    const bool active = sp > 0 && !done && n_qb < P.max_rounds;
    const bool leafy = top >= P.leaf_parent_offset;
    const unsigned act = __ballot_sync(kFull, active);
    if (act == 0) break;
    const int n_leafy = __popc(__ballot_sync(kFull, active && leafy));
    const bool leaf_step = 2 * n_leafy >= __popc(act);  // the vote
    if (!active || leafy != leaf_step) continue;

    const int node = top;
    --sp;
    ++n_qb;  // one box-test job, whichever branch
    bool pushed = false;
    if (!leafy) {
      // ---- the box test on the node's ARITY children ---------------------
      ChildRecord<ARITY, BoxT> rec;
      rec.load(P.kids, node);
      float lo[ARITY][3], hi[ARITY][3];
#pragma unroll
      for (int b = 0; b < ARITY; ++b) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          lo[b][d] = rec.at(d * ARITY + b);
          hi[b][d] = rec.at((3 + d) * ARITY + b);
        }
      }
      const bool neg[3] = {((code >> 6) & 1u) != 0, ((code >> 7) & 1u) != 0,
                           ((code >> 8) & 1u) != 0};
      float tmin[ARITY];
      int idx[ARITY], hit[ARITY];
      rayflex::op_box_test<ARITY>(org, inv, neg, lo, hi, tmin, idx, hit);
      // ---- push hit children farthest first (sorted order) ---------------
      const int base = ARITY * node + 1;
#pragma unroll
      for (int i = 0; i < ARITY; ++i) {
        const int slot = ARITY - 1 - i;
        if (hit[slot] && tmin[slot] < t_best) {
          if (sp < P.stack_size) {
            top = base + idx[slot];
            stack.at(P, r, sp++) = top;
            pushed = true;
          } else {
            overflow = true;  // drop and flag
          }
        }
      }
    } else {
      // ---- ARITY OpTriangle jobs, the external divide, first minimum -----
      // A leaf parent's slots start at ARITY (node - leaf_parent_offset):
      // its children ARITY node + 1 .. less the leaf level's offset
      // ARITY leaf_parent_offset + 1.
      n_tri += ARITY;
      const int k[3] = {static_cast<int>(code & 3u), static_cast<int>((code >> 2) & 3u),
                        static_cast<int>((code >> 4) & 3u)};
      const uint4* s =
          P.slots + static_cast<size_t>(node - P.leaf_parent_offset) * ARITY * kSlotWords;
      float best_leaf_t = CUDART_INF_F;
      int best_leaf_tri = -1;
#pragma unroll
      for (int g = 0; g < ARITY; g += 4) {  // 4 slots' records in flight at once
        uint4 w[4][kSlotWords];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < kSlotWords; ++i) w[j][i] = __ldg(s + (g + j) * kSlotWords + i);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float va[3] = {__uint_as_float(w[j][0].x), __uint_as_float(w[j][0].y),
                               __uint_as_float(w[j][0].z)};
          const float vb[3] = {__uint_as_float(w[j][0].w), __uint_as_float(w[j][1].x),
                               __uint_as_float(w[j][1].y)};
          const float vc[3] = {__uint_as_float(w[j][1].z), __uint_as_float(w[j][1].w),
                               __uint_as_float(w[j][2].x)};
          const int ti = static_cast<int>(w[j][2].y);
          float t_num, t_denom;
          bool h;
          rayflex::op_triangle(org, shear, k, va, vb, vc, &t_num, &t_denom, &h);
          if (h && ti >= 0) {
            const float t = __fdiv_rn(t_num, t_denom);
            // strict <: the first minimum
            if (t < t_best && t <= extent && t >= P.t_min && t < best_leaf_t) {
              best_leaf_t = t;
              best_leaf_tri = ti;
            }
          }
        }
      }
      if (best_leaf_t < t_best) {
        t_best = best_leaf_t;
        best_tri = best_leaf_tri;
        if (P.any_hit) done = true;
      }
    }
    if (!pushed && sp > 0) top = stack.at(P, r, sp - 1);
  }

  if (!valid) return;
  P.t_out[r] = t_best;
  P.tri_out[r] = best_tri;
  P.qb_out[r] = n_qb;
  P.ntri_out[r] = n_tri;
  P.ovf_out[r] = overflow;
}

template <int ARITY, typename BoxT, bool kLocalStack>
void launch(const Params& P, cudaStream_t stream) {
  const int blocks = (P.n + kThreads - 1) / kThreads;
  traverse_kernel<ARITY, BoxT, kLocalStack><<<blocks, kThreads, 0, stream>>>(P);
}

template <int ARITY, typename BoxT>
void launch_stack(const Params& P, cudaStream_t stream) {
  if (P.stack_size <= kMaxLocalStack) {
    launch<ARITY, BoxT, true>(P, stream);
  } else {
    launch<ARITY, BoxT, false>(P, stream);
  }
}

template <int ARITY>
void launch_box(const Params& P, bool box_bf16, cudaStream_t stream) {
  if (box_bf16) {
    launch_stack<ARITY, __nv_bfloat16>(P, stream);
  } else {
    launch_stack<ARITY, float>(P, stream);
  }
}

}  // namespace

// rays: (16, n_pad) f32 union rows, n_pad a multiple of 128 and at least
// n (thread r reads column r); kids: (leaf_parent_offset, 6 * arity) f32,
// or bf16 when box_bf16, each node's child boxes as rows
// lo.x | lo.y | lo.z | hi.x | hi.y | hi.z of `arity` bounds; slots:
// (arity^depth, 12) words, each leaf slot's a.xyz b.xyz c.xyz as f32 and
// its triangle index as i32 (-1 = empty) and 2 words of padding; both
// 16-byte aligned; arity 4 or 8; stack_scratch: (stack_size, n) i32 device
// scratch when stack_size > 64, else unused (may be null).  Outputs (n,)
// each: t f32, tri i32, quadbox_jobs i32, triangle_jobs i32,
// stack_overflow i32.  Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for another n_pad, an arity other than 4 or 8, a
// stack size below 1, or a stack deeper than 64 without scratch.
extern "C" int rayflex_traverse(const void* rays, int n_pad, int n, const void* kids,
                                const void* slots, int leaf_parent_offset, int max_rounds,
                                int any_hit, float t_min, int stack_size, int arity, int box_bf16,
                                void* stack_scratch, void* t, void* tri, void* qb, void* ntri,
                                void* ovf, void* stream) {
  if (n_pad % kThreads != 0 || n_pad < n || stack_size < 1 || (arity != 4 && arity != 8) ||
      (stack_size > kMaxLocalStack && stack_scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const Params P{static_cast<const float*>(rays), n_pad, n, static_cast<const uint4*>(kids),
                 static_cast<const uint4*>(slots), leaf_parent_offset, max_rounds, any_hit, t_min,
                 stack_size,
                 static_cast<int*>(stack_scratch), static_cast<float*>(t), static_cast<int*>(tri),
                 static_cast<int*>(qb), static_cast<int*>(ntri), static_cast<int*>(ovf)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (arity == 4) {
    launch_box<4>(P, box_bf16 != 0, s);
  } else {
    launch_box<8>(P, box_bf16 != 0, s);
  }
  RAYFLEX_LAUNCH_RESULT();
}
