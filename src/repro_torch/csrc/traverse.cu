// The fused closest / any / shadow traversal kernel: one thread per ray,
// running the ray's whole pop -> box test -> OpTriangle -> commit -> push
// loop to its end, under any DatapathConfig: arity 4 or 8, node-box rows
// in f32 or bf16, any stack size.
//
// Replaces: repro/kernels/traverse.py, _traverse_kernel (the Pallas TPU
// kernel, where one 128-lane tile steps its rays in lockstep).
// What bounds it on the H100: bytes, and latency before bytes.  Each round
// a ray reads `arity` child boxes (24 B each in f32, 12 B in bf16) and, at
// a leaf parent, `arity` leaf slots and triangles (40 B each), with about
// 20 and 45 f32 operations per box and triangle: well under one operation
// per byte.  The reads are data-dependent gathers, so a warp whose rays
// diverge issues up to 32 separate segments per load, and each round
// waits on the previous round's pop.
// What the design does about it: the ray's registers, its best hit and
// its counters live in registers for the whole loop.  A stack of up to 64
// entries is a thread-local array (local memory, cached in L1) indexed by
// the stack pointer, with the config's stack size as the runtime limit; a
// deeper stack is a column of per-thread device scratch laid out slot-major
// (slot i of ray r at i * n + r), so a warp's pushes to one depth are
// contiguous.  Nothing is written back until the ray retires: one read of
// the ray and one write of its record, so HBM traffic is the gathers alone,
// and the 50 MB L2 holds the upper levels of the tree that every ray
// visits.  bf16 node rows halve the box bytes and upcast exactly
// (__bfloat162float), since the codecs place every bound on the bf16 grid.
// The BVH is read through the read-only path (__restrict__ const).  Rays of
// a block are neighbours in the caller's batch, which for camera rays are
// neighbouring pixels that walk similar paths.
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

// Ray operand rows (the reference's union layout, (16, n_pad) f32).
constexpr int kRowOrg = 0, kRowDir = 3, kRowInv = 6, kRowShear = 9, kRowK = 12, kRowExt = 15;

__device__ __forceinline__ float box_f32(float x) { return x; }
__device__ __forceinline__ float box_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The ray's stack: a local array, or a column of device scratch.
template <bool kLocal>
struct RayStack;

template <>
struct RayStack<true> {
  int slot[kMaxLocalStack];
  __device__ __forceinline__ RayStack(int*, int, int) {}
  __device__ __forceinline__ int& operator[](int i) { return slot[i]; }
};

template <>
struct RayStack<false> {
  int* column;
  int stride;
  __device__ __forceinline__ RayStack(int* scratch, int r, int n) : column(scratch + r), stride(n) {}
  __device__ __forceinline__ int& operator[](int i) {
    return column[static_cast<size_t>(i) * stride];
  }
};

template <int ARITY, typename BoxT, bool kLocalStack>
__global__ void traverse_kernel(const float* __restrict__ rays, int n_pad, int n,
                                const BoxT* __restrict__ nlo, const BoxT* __restrict__ nhi,
                                int nodes_pad, const int* __restrict__ leaf, int n_leaf,
                                const float* __restrict__ tris, int tri_pad,
                                int leaf_parent_offset, int leaf_offset, int max_rounds,
                                int any_hit, float t_min, int stack_size,
                                int* __restrict__ stack_scratch,
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

  RayStack<kLocalStack> stack(stack_scratch, r, n);
  stack[0] = 0;  // root pre-pushed
  int sp = 1;
  float t_best = CUDART_INF_F;
  int best_tri = -1, n_qb = 0, n_tri = 0;
  bool overflow = false, done = false;

  while (sp > 0 && !done && n_qb < max_rounds) {
    const int node = stack[--sp];
    const bool leaf_parent = node >= leaf_parent_offset;
    const int base = ARITY * node + 1;

    // ---- one box-test job on the node's ARITY children -------------------
    float lo[ARITY][3], hi[ARITY][3];
#pragma unroll
    for (int b = 0; b < ARITY; ++b) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[b][d] = box_f32(nlo[d * nodes_pad + base + b]);
        hi[b][d] = box_f32(nhi[d * nodes_pad + base + b]);
      }
    }
    float tmin[ARITY];
    int idx[ARITY], hit[ARITY];
    rayflex::op_box_test<ARITY>(org, inv, neg, lo, hi, tmin, idx, hit);
    ++n_qb;

    if (leaf_parent) {
      // ---- ARITY OpTriangle jobs, the external divide, first minimum -----
      n_tri += ARITY;
      float best_leaf_t = CUDART_INF_F;
      int best_leaf_tri = -1;
#pragma unroll
      for (int s = 0; s < ARITY; ++s) {
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
      for (int i = 0; i < ARITY; ++i) {
        const int slot = ARITY - 1 - i;
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

struct TraverseArgs {
  const float* rays;
  int n_pad, n;
  const void *nlo, *nhi;
  int nodes_pad;
  const int* leaf;
  int n_leaf;
  const float* tris;
  int tri_pad, leaf_parent_offset, leaf_offset, max_rounds, any_hit;
  float t_min;
  int stack_size;
  int* stack_scratch;
  float* t;
  int *tri, *qb, *ntri, *ovf;
};

template <int ARITY, typename BoxT, bool kLocalStack>
void launch(const TraverseArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.n + threads - 1) / threads;
  traverse_kernel<ARITY, BoxT, kLocalStack><<<blocks, threads, 0, stream>>>(
      a.rays, a.n_pad, a.n, static_cast<const BoxT*>(a.nlo), static_cast<const BoxT*>(a.nhi),
      a.nodes_pad, a.leaf, a.n_leaf, a.tris, a.tri_pad, a.leaf_parent_offset, a.leaf_offset,
      a.max_rounds, a.any_hit, a.t_min, a.stack_size, a.stack_scratch, a.t, a.tri, a.qb,
      a.ntri, a.ovf);
}

template <int ARITY, typename BoxT>
void launch_stack(const TraverseArgs& a, cudaStream_t stream) {
  if (a.stack_size <= kMaxLocalStack) {
    launch<ARITY, BoxT, true>(a, stream);
  } else {
    launch<ARITY, BoxT, false>(a, stream);
  }
}

template <int ARITY>
void launch_box(const TraverseArgs& a, bool box_bf16, cudaStream_t stream) {
  if (box_bf16) {
    launch_stack<ARITY, __nv_bfloat16>(a, stream);
  } else {
    launch_stack<ARITY, float>(a, stream);
  }
}

}  // namespace

// rays: (16, n_pad) f32 union rows; nlo/nhi: (3, nodes_pad) f32, or bf16
// when box_bf16; leaf: (n_leaf,) i32 (-1 = empty slot); tris: (9, tri_pad)
// f32 rows a.xyz b.xyz c.xyz; arity 4 or 8; stack_scratch: (stack_size, n)
// i32 device scratch when stack_size > 64, else unused (may be null).
// Outputs (n,) each: t f32, tri i32, quadbox_jobs i32, triangle_jobs i32,
// stack_overflow i32.  Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for an arity other than 4 or 8, a stack size below
// 1, or a stack deeper than 64 without scratch.
extern "C" int rayflex_traverse(const void* rays, int n_pad, int n, const void* nlo,
                                const void* nhi, int nodes_pad, const void* leaf, int n_leaf,
                                const void* tris, int tri_pad, int leaf_parent_offset,
                                int leaf_offset, int max_rounds, int any_hit, float t_min,
                                int stack_size, int arity, int box_bf16, void* stack_scratch,
                                void* t, void* tri, void* qb, void* ntri, void* ovf,
                                void* stream) {
  if (stack_size < 1 || (arity != 4 && arity != 8) ||
      (stack_size > kMaxLocalStack && stack_scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const TraverseArgs a{static_cast<const float*>(rays), n_pad, n, nlo, nhi, nodes_pad,
                       static_cast<const int*>(leaf), n_leaf, static_cast<const float*>(tris),
                       tri_pad, leaf_parent_offset, leaf_offset, max_rounds, any_hit, t_min,
                       stack_size, static_cast<int*>(stack_scratch), static_cast<float*>(t),
                       static_cast<int*>(tri), static_cast<int*>(qb), static_cast<int*>(ntri),
                       static_cast<int*>(ovf)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (arity == 4) {
    launch_box<4>(a, box_bf16 != 0, s);
  } else {
    launch_box<8>(a, box_bf16 != 0, s);
  }
  RAYFLEX_LAUNCH_RESULT();
}
