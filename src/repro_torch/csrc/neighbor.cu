// The fused kNN / radius neighbour kernel: one thread per query, running
// the query's whole pop -> point-box test -> leaf distances -> top-k
// insertion -> pruned push loop over a point BVH4 to its end.
//
// Replaces: repro/kernels/traverse.py, _neighbor_kernel (the Pallas TPU
// kernel, where one 128-lane tile steps its queries in lockstep).
// What bounds it on the H100: bytes, and latency before bytes.  Each round
// a query reads 4 child boxes (96 B) or, at a leaf parent, 4 leaf slots
// and 4 packed points (80 B), for about 60 f32 operations: under one
// operation per byte.  The reads are data-dependent gathers and each
// round waits on the previous round's pop.
// What the design does about it: the query, its counters and the k best
// (distance, index) pairs stay in the thread for the whole loop (the k
// pairs and the 64-int stack are arrays indexed at run time, which the
// compiler places in thread-local memory, cached in L1); nothing is
// written until the query retires.  Queries of a block are neighbours in
// the caller's batch, so self-queries of a Morton-ordered cloud walk
// similar paths.
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
//   counting, and there is no overflow flag.
#include "datapath.cuh"

namespace {

constexpr int kMaxStack = 64;  // STACK_SIZE of the default config
constexpr int kMaxK = 64;

// Query operand rows: the ray union layout of traverse.cu.
constexpr int kRowOrg = 0, kRowExt = 15;

__device__ __forceinline__ float max0_keep_nan(float x) { return (x > 0.0f || x != x) ? x : 0.0f; }

__global__ void neighbor_kernel(const float* __restrict__ rays, int n_pad, int n,
                                const float* __restrict__ nlo, const float* __restrict__ nhi,
                                int nodes_pad, const int* __restrict__ leaf, int n_leaf,
                                const float* __restrict__ pts, int pts_pad,
                                int leaf_parent_offset, int leaf_offset, int max_rounds, int k,
                                int nearest, float slack_mul, float slack_add,
                                float* __restrict__ d_out, int* __restrict__ i_out,
                                int* __restrict__ cnt_out, int* __restrict__ box_out,
                                int* __restrict__ pt_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  float p[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) p[d] = rays[(kRowOrg + d) * n_pad + r];
  const float extent = rays[kRowExt * n_pad + r];
  const float r_sq = __fmul_rn(extent, extent);
  const float q_sq = __fadd_rn(__fadd_rn(__fmul_rn(p[0], p[0]), __fmul_rn(p[1], p[1])),
                               __fmul_rn(p[2], p[2]));

  float best_d[kMaxK];
  int best_i[kMaxK];
  for (int j = 0; j < k; ++j) {
    best_d[j] = CUDART_INF_F;
    best_i[j] = -1;
  }
  int stack[kMaxStack];
  stack[0] = 0;  // root pre-pushed
  int sp = 1, count = 0, n_box = 0, n_pt = 0;

  while (sp > 0 && n_box < max_rounds) {
    const int node = stack[min(sp - 1, kMaxStack - 1)];
    --sp;
    const int base = 4 * node + 1;
    ++n_box;

    if (node >= leaf_parent_offset) {
      // ---- 4 point-distance jobs and 4 insertion beats ------------------
      n_pt += 4;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        int pos = base - leaf_offset + s;
        pos = pos < 0 ? 0 : (pos > n_leaf - 1 ? n_leaf - 1 : pos);
        const int cand = leaf[pos];
        if (cand < 0) continue;  // padded slot: never in radius
        const float cx = pts[cand], cy = pts[pts_pad + cand], cz = pts[2 * pts_pad + cand];
        const float c2 = pts[3 * pts_pad + cand];
        const float qc = __fadd_rn(__fadd_rn(__fmul_rn(p[0], cx), __fmul_rn(p[1], cy)),
                                   __fmul_rn(p[2], cz));
        const float d2 = max0_keep_nan(__fadd_rn(__fsub_rn(q_sq, __fmul_rn(2.0f, qc)), c2));
        if (!(d2 <= r_sq)) continue;
        ++count;
        if (!(d2 < best_d[k - 1])) continue;
        int j = k - 1;  // shift the worse tail down one and land in the rank slot
        while (j > 0 && d2 < best_d[j - 1]) {
          best_d[j] = best_d[j - 1];
          best_i[j] = best_i[j - 1];
          --j;
        }
        best_d[j] = d2;
        best_i[j] = cand;
      }
    } else {
      // ---- one point-box job, pruned pushes farthest first -------------
      float lo[4][3], hi[4][3];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          lo[b][d] = nlo[d * nodes_pad + base + b];
          hi[b][d] = nhi[d * nodes_pad + base + b];
        }
      }
      float dist[4];
      int idx[4];
      rayflex::point_box_test(p, lo, hi, dist, idx);
      const float b = nearest ? rayflex::cmp_min(r_sq, best_d[k - 1]) : r_sq;
      const float bound = __fadd_rn(__fmul_rn(b, slack_mul), __fmul_rn(slack_add, q_sq));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int slot = 3 - c;
        if (dist[slot] <= bound) {
          stack[min(sp, kMaxStack - 1)] = base + idx[slot];
          ++sp;
        }
      }
    }
  }

  for (int j = 0; j < k; ++j) {
    d_out[j * n + r] = best_d[j];
    i_out[j * n + r] = best_i[j];
  }
  cnt_out[r] = count;
  box_out[r] = n_box;
  pt_out[r] = n_pt;
}

}  // namespace

// rays: (16, n_pad) f32 union rows (origin = the query point, extent = the
// radius); nlo/nhi: (3, nodes_pad) f32; leaf: (n_leaf,) i32 (-1 = empty
// slot); pts: (4, pts_pad) f32 rows x | y | z | |c|^2.  Outputs dist (k, n)
// f32, index (k, n) i32, count, box_jobs, point_jobs (n,) i32.  Returns the
// launch's cudaError_t, or cudaErrorInvalidValue for k outside 1..64.
extern "C" int rayflex_neighbor(const void* rays, int n_pad, int n, const void* nlo,
                                const void* nhi, int nodes_pad, const void* leaf, int n_leaf,
                                const void* pts, int pts_pad, int leaf_parent_offset,
                                int leaf_offset, int max_rounds, int k, int nearest,
                                float slack_mul, float slack_add, void* d, void* i, void* cnt,
                                void* box, void* pt, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  neighbor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), n_pad, n, static_cast<const float*>(nlo),
      static_cast<const float*>(nhi), nodes_pad, static_cast<const int*>(leaf), n_leaf,
      static_cast<const float*>(pts), pts_pad, leaf_parent_offset, leaf_offset, max_rounds, k,
      nearest, slack_mul, slack_add, static_cast<float*>(d), static_cast<int*>(i),
      static_cast<int*>(cnt), static_cast<int*>(box), static_cast<int*>(pt));
  RAYFLEX_LAUNCH_RESULT();
}
