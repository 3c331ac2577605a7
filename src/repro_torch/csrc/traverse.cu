// The fused closest / any / shadow traversal kernel: one thread per ray,
// running the ray's whole pop -> OpQuadbox -> OpTriangle -> commit -> push
// loop to its end.
//
// Replaces: repro/kernels/traverse.py, _traverse_kernel (the Pallas TPU
// kernel, where one 128-lane tile steps its rays in lockstep).
// What bounds it on the H100: bytes, and latency before bytes.  Each round
// a ray reads 4 child boxes (96 B) and, at a leaf parent, 4 leaf slots and
// 4 triangles (160 B), with about 80 and 180 f32 operations: well under
// one operation per byte.  The reads are data-dependent gathers, so a
// warp whose rays diverge issues up to 32 separate segments per load, and
// each round waits on the previous round's pop.
// What the design does about it: the ray's registers, its best hit and
// its counters live in registers for the whole loop; its stack of
// `stack_size` ints lives in thread-local memory (the simplest layout
// that is right: an array indexed by the stack pointer, which the
// compiler places in local memory, cached in L1).  Nothing is written back
// until the ray retires: one read of the ray and one write of its record,
// so HBM traffic is the gathers alone, and the 50 MB L2 holds the upper
// levels of the tree that every ray visits.  The BVH is read through the
// read-only path (__restrict__ const).  Rays of a block are neighbours in
// the caller's batch, which for camera rays are neighbouring pixels that
// walk similar paths.
//
// Semantics are the plain version's (core/wavefront.py) exactly: a round
// adds 4 to triangle_jobs at every leaf parent even where slots hold -1;
// a hit commits when hit & idx >= 0 & t < t_best & t <= extent & t >= t_min,
// taking the first minimum; any/shadow rays retire on their first commit;
// children are pushed farthest first when they hit and tmin < t_best, and a
// push past stack_size is dropped and flags stack_overflow.
#include "datapath.cuh"

namespace {

constexpr int kMaxStack = 64;  // DatapathConfig.stack_size of the default config

// Ray operand rows (the reference's union layout, (16, n_pad) f32).
constexpr int kRowOrg = 0, kRowDir = 3, kRowInv = 6, kRowShear = 9, kRowK = 12, kRowExt = 15;

__global__ void traverse_kernel(const float* __restrict__ rays, int n_pad, int n,
                                const float* __restrict__ nlo, const float* __restrict__ nhi,
                                int nodes_pad, const int* __restrict__ leaf, int n_leaf,
                                const float* __restrict__ tris, int tri_pad,
                                int leaf_parent_offset, int leaf_offset, int max_rounds,
                                int any_hit, float t_min, int stack_size,
                                float* __restrict__ t_out, int* __restrict__ tri_out,
                                int* __restrict__ qb_out, int* __restrict__ ntri_out,
                                int* __restrict__ ovf_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  float org[3], inv[3], shear[3];
  bool neg[3];
  int k[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    org[d] = rays[(kRowOrg + d) * n_pad + r];
    neg[d] = signbit(rays[(kRowDir + d) * n_pad + r]);
    inv[d] = rays[(kRowInv + d) * n_pad + r];
    shear[d] = rays[(kRowShear + d) * n_pad + r];
    k[d] = static_cast<int>(rays[(kRowK + d) * n_pad + r]);
  }
  const float extent = rays[kRowExt * n_pad + r];

  int stack[kMaxStack];
  stack[0] = 0;  // root pre-pushed
  int sp = 1;
  float t_best = CUDART_INF_F;
  int best_tri = -1, n_qb = 0, n_tri = 0;
  bool overflow = false, done = false;

  while (sp > 0 && !done && n_qb < max_rounds) {
    const int node = stack[--sp];
    const bool leaf_parent = node >= leaf_parent_offset;
    const int base = 4 * node + 1;

    // ---- one OpQuadbox job on the node's 4 children ----------------------
    float lo[4][3], hi[4][3];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[b][d] = nlo[d * nodes_pad + base + b];
        hi[b][d] = nhi[d * nodes_pad + base + b];
      }
    }
    float tmin[4];
    int idx[4], hit[4];
    rayflex::op_quadbox(org, inv, neg, lo, hi, tmin, idx, hit);
    ++n_qb;

    if (leaf_parent) {
      // ---- 4 OpTriangle jobs, the external divide, first-minimum commit --
      n_tri += 4;
      float best_leaf_t = CUDART_INF_F;
      int best_leaf_tri = -1;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        int pos = base - leaf_offset + s;
        pos = pos < 0 ? 0 : (pos > n_leaf - 1 ? n_leaf - 1 : pos);
        const int ti = leaf[pos];
        float t_masked = CUDART_INF_F;
        if (ti >= 0) {
          float va[3], vb[3], vc[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            va[d] = tris[d * tri_pad + ti];
            vb[d] = tris[(3 + d) * tri_pad + ti];
            vc[d] = tris[(6 + d) * tri_pad + ti];
          }
          float t_num, t_denom;
          bool h;
          rayflex::op_triangle(org, shear, k, va, vb, vc, &t_num, &t_denom, &h);
          const float t = __fdiv_rn(t_num, t_denom);
          if (h && t < t_best && t <= extent && t >= t_min) t_masked = t;
        }
        if (s == 0 || t_masked < best_leaf_t) {  // strict <: first minimum
          best_leaf_t = t_masked;
          best_leaf_tri = ti;
        }
      }
      if (best_leaf_t < t_best) {
        t_best = best_leaf_t;
        best_tri = best_leaf_tri;
        if (any_hit) done = true;
      }
    } else {
      // ---- push hit children farthest first (sorted order) ---------------
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = 3 - i;
        if (hit[slot] && tmin[slot] < t_best) {
          if (sp < stack_size) {
            stack[sp++] = base + idx[slot];
          } else {
            overflow = true;  // drop and flag
          }
        }
      }
    }
  }

  t_out[r] = t_best;
  tri_out[r] = best_tri;
  qb_out[r] = n_qb;
  ntri_out[r] = n_tri;
  ovf_out[r] = overflow;
}

}  // namespace

// rays: (16, n_pad) f32 union rows; nlo/nhi: (3, nodes_pad) f32; leaf:
// (n_leaf,) i32 (-1 = empty slot); tris: (9, tri_pad) f32 rows a.xyz b.xyz
// c.xyz.  Outputs (n,) each: t f32, tri i32, quadbox_jobs i32,
// triangle_jobs i32, stack_overflow i32.  Returns the launch's cudaError_t,
// or cudaErrorInvalidValue for a stack deeper than the kernel holds.
extern "C" int rayflex_traverse(const void* rays, int n_pad, int n, const void* nlo,
                                const void* nhi, int nodes_pad, const void* leaf, int n_leaf,
                                const void* tris, int tri_pad, int leaf_parent_offset,
                                int leaf_offset, int max_rounds, int any_hit, float t_min,
                                int stack_size, void* t, void* tri, void* qb, void* ntri,
                                void* ovf, void* stream) {
  if (stack_size < 1 || stack_size > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  traverse_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), n_pad, n, static_cast<const float*>(nlo),
      static_cast<const float*>(nhi), nodes_pad, static_cast<const int*>(leaf), n_leaf,
      static_cast<const float*>(tris), tri_pad, leaf_parent_offset, leaf_offset, max_rounds,
      any_hit, t_min, stack_size, static_cast<float*>(t), static_cast<int*>(tri),
      static_cast<int*>(qb), static_cast<int*>(ntri), static_cast<int*>(ovf));
  RAYFLEX_LAUNCH_RESULT();
}
