// The fused kNN / radius neighbour kernel: one thread per query, running
// the query's whole pop -> point-box test -> leaf distances -> top-k
// insertion -> pruned push loop over a point BVH4 to its end.
//
// Replaces: repro/kernels/traverse.py, _neighbor_kernel (the Pallas TPU
// kernel, where one 128-lane tile steps its queries in lockstep).
// What bounds it on the H100: latency and divergence before bytes or
// operations.  A pop of an inner node reads 4 child boxes (96 B) for
// about 80 f32 operations, a pop of a leaf parent 4 leaf slots and 4
// points (80 B) for about 50; the reads are data-dependent gathers, each
// pop waits on the one before, and a warp runs as long as its slowest
// query (a nearest query pops from a few dozen to over a thousand nodes).
// What the design does about it:
//   * the schedule: the launcher sorts the queries along the Z-order
//     curve of the tree's root box (kernels/traverse.py, query_order) and
//     passes the permutation; thread r serves query order[r] and writes
//     column order[r].  A warp's 32 queries are then neighbours in the
//     tree, whatever order the caller gave, and walk similar paths;
//   * where the state lives: the k best (distance, index) pairs stay in
//     registers for k up to 32 (a variant per capacity KCAP; the list is
//     right-aligned in its KCAP slots over -inf, so the k-th best is always
//     slot KCAP-1 and every index is static; the register cap keeps 6
//     blocks of 128 threads resident); a larger k keeps its list in
//     two (k, n) scratch rows at the thread's launch position (a warp's
//     accesses to one rank coalesce), copied to the query's output column
//     at the end, which needs no size limit.  The 64-entry stack lives in
//     thread-local memory (cached in L1), blocks are 128 threads;
//   * the tree's layout: each node above the leaf parents holds its 4
//     children's boxes in 96 contiguous bytes (6 float4 loads), and each
//     leaf slot its point as x | y | z | |c|^2 (one float4 load), so a pop
//     issues 6 or 5 vector loads instead of 24 or 20 scalar ones;
//   * one branch per warp step: the loop is warp-uniform and, each step,
//     picks the lanes that pop by the list's home.  With a register list
//     the branch (inner node or leaf parent) that more of the warp's
//     active lanes need runs, and the rest wait a step (a vote); with the
//     general list, whose leaf step inserts through memory, lanes pop
//     inner nodes until no lane has one on top and then score the leaves
//     together (while-while: Aila & Laine, HPG 2009).  A lane always pops
//     its own stack top, so each query's sequence of pops is the plain
//     version's under either policy, and the job counters and the list
//     are unchanged.  The stack top stays in a register, so a pop after a
//     push waits on no load.
//
// Semantics are the plain version's (core/neighbor.py, neighbor_wavefront)
// exactly, and so are the bits: every add and multiply is a round-to-
// nearest intrinsic, never contracted (the build also passes -fmad=false):
//   q_sq = (x*x + y*y) + z*z, r_sq = extent * extent;
//   leaf distance max((q_sq - 2 q.c) + |c|^2, 0), q.c = (x cx + y cy) + z cz,
//   NaN passing the max as jnp.maximum lets it;
//   a candidate counts and inserts when its slot holds a point and its
//   distance is <= r_sq; insertion is strict <, so on equal distances the
//   earlier candidate keeps its slot;
//   a child is pushed, farthest first, when its box distance is <= the
//   bound b * mul + add * q_sq (b = r_sq, or min(r_sq, k-th best) for
//   nearest; the two constants are passed in, rounded to f32 once by the
//   caller, as the plain version rounds them);
//   the stack index of a pop and a push clamps to 63 while sp keeps
//   counting, and there is no overflow flag; a query stops after
//   max_rounds pops.
#include "datapath.cuh"

namespace {

constexpr int kMaxStack = 64;  // STACK_SIZE of the default config
constexpr int kThreads = 128;

// Query operand rows: the ray union layout of traverse.cu.
constexpr int kRowOrg = 0, kRowExt = 15;

struct Params {
  const float* rays;  // (16, n_pad)
  int n_pad, n;
  const int* order;     // (n,) the query each thread serves, or null
  const float4* kids;   // (lpo, 6) child boxes of each node above the leaf parents
  const int4* leaf;     // (4^depth / 4,) leaf slots of each leaf parent
  const float4* pts;    // (4^depth,) each slot's point: x, y, z, |c|^2
  int leaf_parent_offset, max_rounds, k, nearest;
  float slack_mul, slack_add;
  float* d_out;  // (k, n)
  int* i_out;    // (k, n)
  float* list_d;  // (k, n) the general list's rows, by launch position
  int* list_i;    // (k, n)
  int *cnt_out, *box_out, *pt_out;  // (n,)
};

__device__ __forceinline__ float max0_keep_nan(float x) { return (x > 0.0f || x != x) ? x : 0.0f; }

// The sorted top-k list in registers: slots KCAP-k .. KCAP-1 hold the k
// best, ascending; the slots before them hold -inf, which no distance is
// below, so they never change.  One insertion is insert_sorted's
// compare-shift network (core/neighbor.py), unrolled over the slots.
template <int KCAP>
struct TopK {
  float d[KCAP];
  int i[KCAP];

  __device__ __forceinline__ void init(const Params& P, int) {
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      d[j] = j < KCAP - P.k ? -CUDART_INF_F : CUDART_INF_F;
      i[j] = -1;
    }
  }
  __device__ __forceinline__ float kth() const { return d[KCAP - 1]; }
  __device__ __forceinline__ void insert(float d2, int cand) {
    if (!(d2 < d[KCAP - 1])) return;
#pragma unroll
    for (int j = KCAP - 1; j > 0; --j) {  // descending: d[j - 1] is still the old value
      const bool ins = d2 < d[j], up = d2 < d[j - 1];
      d[j] = ins ? (up ? d[j - 1] : d2) : d[j];
      i[j] = ins ? (up ? i[j - 1] : cand) : i[j];
    }
    if (d2 < d[0]) {
      d[0] = d2;
      i[0] = cand;
    }
  }
  __device__ __forceinline__ void store(const Params& P, int q) const {
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      const int rank = j - (KCAP - P.k);
      if (rank >= 0) {
        P.d_out[static_cast<long long>(rank) * P.n + q] = d[j];
        P.i_out[static_cast<long long>(rank) * P.n + q] = i[j];
      }
    }
  }
};

// The general list (any k): it lives in column r (the thread's launch
// position) of two (k, n) scratch rows, so a warp's accesses to one rank
// are 32 neighbouring words, with the k-th best cached in a register; it
// is copied to the query's output column at the end.
template <>
struct TopK<0> {
  float* d;
  int* i;
  long long stride;
  int k;
  float kth_;

  __device__ __forceinline__ void init(const Params& P, int r) {
    d = P.list_d + r;
    i = P.list_i + r;
    stride = P.n;
    k = P.k;
    for (int j = 0; j < k; ++j) {
      d[j * stride] = CUDART_INF_F;
      i[j * stride] = -1;
    }
    kth_ = CUDART_INF_F;
  }
  __device__ __forceinline__ float kth() const { return kth_; }
  __device__ __forceinline__ void insert(float d2, int cand) {
    if (!(d2 < kth_)) return;
    int j = k - 1;  // shift the worse tail down one and land in the rank slot
    while (j > 0 && d2 < d[(j - 1) * stride]) {
      d[j * stride] = d[(j - 1) * stride];
      i[j * stride] = i[(j - 1) * stride];
      --j;
    }
    d[j * stride] = d2;
    i[j * stride] = cand;
    kth_ = d[(k - 1) * stride];
  }
  __device__ __forceinline__ void store(const Params& P, int q) const {
    for (int j = 0; j < k; ++j) {
      P.d_out[j * stride + q] = d[j * stride];
      P.i_out[j * stride + q] = i[j * stride];
    }
  }
};

template <int KCAP>
__device__ __forceinline__ void run_query(const Params& P, int r, bool valid) {
  const int q = valid ? (P.order ? __ldg(P.order + r) : r) : 0;
  float p[3];
  // row `row` of the operand at column q, the offset in 64 bits: row 15
  // starts past a 32-bit int above 2^31 / 15 queries
  const auto ray_row = [&](int row) {
    return valid ? __ldg(P.rays + static_cast<size_t>(row) * P.n_pad + q) : 0.0f;
  };
#pragma unroll
  for (int d = 0; d < 3; ++d) p[d] = ray_row(kRowOrg + d);
  const float extent = ray_row(kRowExt);
  const float r_sq = __fmul_rn(extent, extent);
  const float q_sq = __fadd_rn(__fadd_rn(__fmul_rn(p[0], p[0]), __fmul_rn(p[1], p[1])),
                               __fmul_rn(p[2], p[2]));

  TopK<KCAP> best;
  if (valid) best.init(P, r);
  int stack[kMaxStack];
  stack[0] = 0;  // root pre-pushed
  int sp = valid ? 1 : 0, count = 0, n_box = 0, n_pt = 0;
  // stack[min(sp - 1, 63)] whenever sp > 0, kept in a register: after a
  // push it is the last child pushed, so the next pop needs no load
  int top = 0;

  for (;;) {  // one warp step; every lane of the warp runs it
    const bool active = sp > 0 && n_box < P.max_rounds;
    const unsigned act = __ballot_sync(0xffffffffu, active);
    if (act == 0) break;
    const bool leafy = active && top >= P.leaf_parent_offset;
    // the step's branch: while-while for the general list, else the vote
    const int n_leafy = __popc(__ballot_sync(0xffffffffu, leafy));
    const int n_inner = __popc(act) - n_leafy;
    const bool leaf_step = KCAP == 0 ? n_inner == 0 : n_leafy >= n_inner;
    if (!(active && leafy == leaf_step)) continue;

    const int node = top;
    --sp;
    ++n_box;
    bool pushed = false;
    if (!leafy) {
      // ---- one point-box job, pruned pushes farthest first -------------
      const float4* kb = P.kids + 6 * node;
      const float4 lx = __ldg(kb), ly = __ldg(kb + 1), lz = __ldg(kb + 2);
      const float4 hx = __ldg(kb + 3), hy = __ldg(kb + 4), hz = __ldg(kb + 5);
      const float lo[4][3] = {{lx.x, ly.x, lz.x}, {lx.y, ly.y, lz.y},
                              {lx.z, ly.z, lz.z}, {lx.w, ly.w, lz.w}};
      const float hi[4][3] = {{hx.x, hy.x, hz.x}, {hx.y, hy.y, hz.y},
                              {hx.z, hy.z, hz.z}, {hx.w, hy.w, hz.w}};
      float dist[4];
      int idx[4];
      rayflex::point_box_test(p, lo, hi, dist, idx);
      const float b = P.nearest ? rayflex::cmp_min(r_sq, best.kth()) : r_sq;
      const float bound = __fadd_rn(__fmul_rn(b, P.slack_mul), __fmul_rn(P.slack_add, q_sq));
      const int base = 4 * node + 1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int slot = 3 - c;
        if (dist[slot] <= bound) {
          top = base + idx[slot];
          stack[min(sp, kMaxStack - 1)] = top;
          ++sp;
          pushed = true;
        }
      }
    } else {
      // ---- 4 point-distance jobs and 4 insertion beats ------------------
      // A leaf parent's 4 slots start at 4 (node - leaf_parent_offset):
      // its children 4 node + 1 .. 4 node + 4 less the leaf level's offset
      // 4 leaf_parent_offset + 1.  Only children of nodes above the leaf
      // parents are ever pushed, so the slots are always in the table.
      n_pt += 4;
      const int group = node - P.leaf_parent_offset;
      const int4 slots = __ldg(P.leaf + group);
      const int cands[4] = {slots.x, slots.y, slots.z, slots.w};
      float4 pt4[4];  // every slot has a row: load all 4 at once
#pragma unroll
      for (int s = 0; s < 4; ++s) pt4[s] = __ldg(P.pts + 4 * group + s);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int cand = cands[s];
        if (cand < 0) continue;  // padded slot: never in radius
        const float4 c = pt4[s];
        const float qc = __fadd_rn(__fadd_rn(__fmul_rn(p[0], c.x), __fmul_rn(p[1], c.y)),
                                   __fmul_rn(p[2], c.z));
        const float d2 = max0_keep_nan(__fadd_rn(__fsub_rn(q_sq, __fmul_rn(2.0f, qc)), c.w));
        if (!(d2 <= r_sq)) continue;
        ++count;
        best.insert(d2, cand);
      }
    }
    if (!pushed && sp > 0) top = stack[min(sp - 1, kMaxStack - 1)];
  }

  if (!valid) return;
  best.store(P, q);
  P.cnt_out[q] = count;
  P.box_out[q] = n_box;
  P.pt_out[q] = n_pt;
}

// Registers a thread may use: a cap that keeps 6 blocks resident (85), or
// 4 for the 32-slot list, which needs more.
template <int KCAP>
__global__ void __launch_bounds__(kThreads, KCAP == 32 ? 4 : 6) neighbor_kernel(const Params P) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  run_query<KCAP>(P, r, r < P.n);
}

template <int KCAP>
int launch(const Params& P, cudaStream_t stream) {
  neighbor_kernel<KCAP><<<(P.n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(P);
  RAYFLEX_LAUNCH_RESULT();
}

}  // namespace

// rays: (16, n_pad) f32 union rows (origin = the query point, extent = the
// radius); order: (n,) i32, the query each thread serves (null: thread r
// serves query r); kids: (leaf_parent_offset, 24) f32, each node's 4 child
// boxes as rows lo.x | lo.y | lo.z | hi.x | hi.y | hi.z; leaf: (4^depth,)
// i32 (-1 = empty slot); pts: (4^depth, 4) f32, each slot's point as x, y,
// z, |c|^2; every tree operand 16-byte aligned.  capacity: the register
// list's KCAP (1, 2, 4, 8, 16 or 32, and k <= capacity) or 0 for the
// general list (any k >= 1).  Outputs dist (k, n) f32, index (k, n) i32,
// count, box_jobs, point_jobs (n,) i32; list_d / list_i: (k, n) f32 / i32
// scratch for the general list (capacity 0; null otherwise).
// Returns the launch's cudaError_t, or cudaErrorInvalidValue for arguments
// outside those.
extern "C" int rayflex_neighbor(const void* rays, int n_pad, int n, const void* order,
                                const void* kids, const void* leaf, const void* pts,
                                int leaf_parent_offset, int max_rounds, int k, int nearest,
                                float slack_mul, float slack_add, int capacity, void* d, void* i,
                                void* cnt, void* box, void* pt, void* list_d, void* list_i,
                                void* stream) {
  const bool capacity_ok = capacity == 0 || (k <= capacity && (capacity & (capacity - 1)) == 0 &&
                                             capacity <= 32);
  if (k < 1 || !capacity_ok || (capacity == 0 && (list_d == nullptr || list_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const Params P{static_cast<const float*>(rays), n_pad, n, static_cast<const int*>(order),
                 static_cast<const float4*>(kids), static_cast<const int4*>(leaf),
                 static_cast<const float4*>(pts), leaf_parent_offset, max_rounds, k, nearest,
                 slack_mul, slack_add, static_cast<float*>(d), static_cast<int*>(i),
                 static_cast<float*>(list_d), static_cast<int*>(list_i), static_cast<int*>(cnt),
                 static_cast<int*>(box), static_cast<int*>(pt)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (capacity) {
    case 0: return launch<0>(P, s);
    case 1: return launch<1>(P, s);
    case 2: return launch<2>(P, s);
    case 4: return launch<4>(P, s);
    case 8: return launch<8>(P, s);
    case 16: return launch<16>(P, s);
    default: return launch<32>(P, s);
  }
}
