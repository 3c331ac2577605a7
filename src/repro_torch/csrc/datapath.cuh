// The stage units of the Ray Tracer Datapath, written once as __device__
// functions and shared by the standalone OpQuadbox / OpTriangle kernels
// (raybox.cu, raytri.cu), the fused traversal kernel (traverse.cu) and the
// fused neighbour kernel (neighbor.cu): one implementation per functional
// unit.
//
// Rounding: the paper rounds after every functional unit, and so does the
// plain PyTorch version (one eager op per stage).  Every add, multiply and
// divide here is therefore an explicit round-to-nearest intrinsic
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), which the compiler never
// contracts into an FMA; the build adds -fmad=false as a second guard and
// never uses --use_fast_math.  Comparator min/max are `a > b ? a : b`,
// never fmaxf/fminf: a compare with NaN is false and keeps the second
// operand, which drops the NaN slabs that 0 * inf produces.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rayflex {

__device__ __forceinline__ float cmp_max(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ float cmp_min(float a, float b) { return a < b ? a : b; }

// Compare-exchange of the sorting network: a false compare (ties and NaN
// included) exchanges the pair, exactly like the reference's selects.
__device__ __forceinline__ void cas(float* key, int* idx, int* hit, int i, int j) {
  if (!(key[i] < key[j])) {
    float k = key[i]; key[i] = key[j]; key[j] = k;
    int x = idx[i]; idx[i] = idx[j]; idx[j] = x;
    int h = hit[i]; hit[i] = hit[j]; hit[j] = h;
  }
}

// The child sorting networks, one per box-test width: the paper's
// 5-comparator QuadSortRecFN at 4, Batcher's 19-comparator odd-even merge
// sort at 8 (the BVH8 twin), pair for pair as core/datapath.SORT_NETWORKS.
template <int W>
__device__ __forceinline__ void sort_network(float* key, int* idx, int* hit) {
  static_assert(W == 4 || W == 8, "the box test is 4 or 8 wide");
  if constexpr (W == 4) {
    cas(key, idx, hit, 0, 1);
    cas(key, idx, hit, 2, 3);
    cas(key, idx, hit, 0, 2);
    cas(key, idx, hit, 1, 3);
    cas(key, idx, hit, 1, 2);
  } else {
    cas(key, idx, hit, 0, 1);
    cas(key, idx, hit, 2, 3);
    cas(key, idx, hit, 4, 5);
    cas(key, idx, hit, 6, 7);
    cas(key, idx, hit, 0, 2);
    cas(key, idx, hit, 1, 3);
    cas(key, idx, hit, 4, 6);
    cas(key, idx, hit, 5, 7);
    cas(key, idx, hit, 1, 2);
    cas(key, idx, hit, 5, 6);
    cas(key, idx, hit, 0, 4);
    cas(key, idx, hit, 1, 5);
    cas(key, idx, hit, 2, 6);
    cas(key, idx, hit, 3, 7);
    cas(key, idx, hit, 2, 4);
    cas(key, idx, hit, 3, 5);
    cas(key, idx, hit, 1, 2);
    cas(key, idx, hit, 3, 4);
    cas(key, idx, hit, 5, 6);
  }
}

// The box test: one ray against W AABBs (OpQuadbox at W = 4).  lo/hi are
// [box][dim]; neg[d] is the sign bit of the ray direction (so dir == -0.0
// swaps too).  Outputs tmin sorted ascending, with the box index and hit
// flag of each sorted slot.
template <int W>
__device__ __forceinline__ void op_box_test(const float org[3], const float inv[3],
                                            const bool neg[3], const float lo[W][3],
                                            const float hi[W][3], float tmin[W],
                                            int idx[W], int hit[W]) {
#pragma unroll
  for (int b = 0; b < W; ++b) {
    float t_near[3], t_far[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      // stage 2 (adders) and stage 3 (multipliers): slab distances
      float t_lo = __fmul_rn(__fsub_rn(lo[b][d], org[d]), inv[d]);
      float t_hi = __fmul_rn(__fsub_rn(hi[b][d], org[d]), inv[d]);
      // stage 4: swap keyed on the sign bit
      t_near[d] = neg[d] ? t_hi : t_lo;
      t_far[d] = neg[d] ? t_lo : t_hi;
    }
    float mn = cmp_max(t_near[2], cmp_max(t_near[1], cmp_max(t_near[0], 0.0f)));
    float mx = cmp_min(t_far[2], cmp_min(t_far[1], cmp_min(t_far[0], CUDART_INF_F)));
    tmin[b] = mn;
    idx[b] = b;
    hit[b] = mn <= mx;  // stage 5
  }
  sort_network<W>(tmin, idx, hit);  // stage 10
}

// OpQuadbox: the paper's 4-wide box test.
__device__ __forceinline__ void op_quadbox(const float org[3], const float inv[3],
                                           const bool neg[3], const float lo[4][3],
                                           const float hi[4][3], float tmin[4],
                                           int idx[4], int hit[4]) {
  op_box_test<4>(org, inv, neg, lo, hi, tmin, idx, hit);
}

// Point-vs-4-AABB squared distance, the neighbour-search twin of
// OpQuadbox: per axis the gap is max(lo - p, max(p - hi, 0)) through
// comparators, so an inverted pad box (lo = +inf, hi = -inf) gives +inf;
// the squared distance is (sq0 + sq1) + sq2.  The same quad-sort network
// orders the four children near to far.  `hit` is the sort's third
// payload, unused here.
__device__ __forceinline__ void point_box_test(const float p[3], const float lo[4][3],
                                               const float hi[4][3], float dist[4],
                                               int idx[4]) {
  int unused[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float sq[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float below = __fsub_rn(lo[b][d], p[d]);
      const float above = __fsub_rn(p[d], hi[b][d]);
      const float gap = cmp_max(below, cmp_max(above, 0.0f));
      sq[d] = __fmul_rn(gap, gap);
    }
    dist[b] = __fadd_rn(__fadd_rn(sq[0], sq[1]), sq[2]);
    idx[b] = b;
    unused[b] = 0;
  }
  sort_network<4>(dist, idx, unused);
}

__device__ __forceinline__ float select_dim(const float v[3], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

// OpTriangle: Woop/Benthin/Wald watertight test, backface-culling variant.
// k holds kx, ky, kz; shear holds Sx, Sy, Sz.  The divide t_num / t_denom
// is left to the caller, as in the paper.
__device__ __forceinline__ void op_triangle(const float org[3], const float shear[3],
                                            const int k[3], const float va[3],
                                            const float vb[3], const float vc[3],
                                            float* t_num_out, float* t_denom_out,
                                            bool* hit_out) {
  float a[3], b[3], c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {  // stage 2: translate (9 adders)
    a[d] = __fsub_rn(va[d], org[d]);
    b[d] = __fsub_rn(vb[d], org[d]);
    c[d] = __fsub_rn(vc[d], org[d]);
  }
  const float sx = shear[0], sy = shear[1], sz = shear[2];
  const float a_kx = select_dim(a, k[0]), a_ky = select_dim(a, k[1]), a_kz = select_dim(a, k[2]);
  const float b_kx = select_dim(b, k[0]), b_ky = select_dim(b, k[1]), b_kz = select_dim(b, k[2]);
  const float c_kx = select_dim(c, k[0]), c_ky = select_dim(c, k[1]), c_kz = select_dim(c, k[2]);

  // stage 3: shear products (9 multipliers)
  const float az = __fmul_rn(sz, a_kz);
  const float bz = __fmul_rn(sz, b_kz);
  const float cz = __fmul_rn(sz, c_kz);
  // stage 4: shear-subtract (6 adders)
  const float ax = __fsub_rn(a_kx, __fmul_rn(sx, a_kz));
  const float ay = __fsub_rn(a_ky, __fmul_rn(sy, a_kz));
  const float bx = __fsub_rn(b_kx, __fmul_rn(sx, b_kz));
  const float by = __fsub_rn(b_ky, __fmul_rn(sy, b_kz));
  const float cx = __fsub_rn(c_kx, __fmul_rn(sx, c_kz));
  const float cy = __fsub_rn(c_ky, __fmul_rn(sy, c_kz));
  // stages 5-6: edge functions (6 multipliers, 3 adders)
  const float u = __fsub_rn(__fmul_rn(cx, by), __fmul_rn(cy, bx));
  const float v = __fsub_rn(__fmul_rn(ax, cy), __fmul_rn(ay, cx));
  const float w = __fsub_rn(__fmul_rn(bx, ay), __fmul_rn(by, ax));
  // stages 7-9: scaled z products and the two sums
  const float t_denom = __fadd_rn(__fadd_rn(u, v), w);
  const float t_num = __fadd_rn(__fadd_rn(__fmul_rn(u, az), __fmul_rn(v, bz)),
                                __fmul_rn(w, cz));
  // stage 10: hit decision (5 comparators)
  *hit_out = (t_num > 0.0f) && (t_denom != 0.0f) && (u >= 0.0f) && (v >= 0.0f) &&
             (w >= 0.0f);
  *t_num_out = t_num;
  *t_denom_out = t_denom;
}

}  // namespace rayflex

// Every C entry point returns the cudaError_t of its launch (0 = success).
#define RAYFLEX_LAUNCH_RESULT() return static_cast<int>(cudaGetLastError())
