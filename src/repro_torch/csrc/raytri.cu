// OpTriangle as a standalone kernel: one thread per job (one ray vs one
// triangle, watertight, backface culling, the divide left undone).
//
// Replaces: repro/kernels/raytri.py, raytri_kernel (the Pallas TPU kernel).
// What bounds it on the H100: bytes.  A job reads 15 floats and 3 ints and
// writes 3 words (84 B) for about 45 f32 operations, 0.54 op per byte.
// What the design does about it: rows-by-jobs layout, so every row access
// of a warp is one contiguous segment; the per-job kx/ky/kz crossbar is a
// register select (datapath.cuh, select_dim); all arithmetic in registers.
#include "datapath.cuh"

namespace {

__global__ void raytri_kernel(const float* __restrict__ org, const float* __restrict__ shear,
                              const int* __restrict__ k, const float* __restrict__ va,
                              const float* __restrict__ vb, const float* __restrict__ vc,
                              float* __restrict__ t_num_out, float* __restrict__ t_denom_out,
                              int* __restrict__ hit_out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  // d n + j reaches 3 n - 1, past a 32-bit int above 2^31 / 3 jobs:
  // offsets are taken in 64 bits
  const size_t stride = static_cast<size_t>(n);
  float o[3], s[3], a[3], b[3], c[3];
  int kk[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    o[d] = org[d * stride + j];
    s[d] = shear[d * stride + j];
    kk[d] = k[d * stride + j];
    a[d] = va[d * stride + j];
    b[d] = vb[d * stride + j];
    c[d] = vc[d * stride + j];
  }
  float t_num, t_denom;
  bool hit;
  rayflex::op_triangle(o, s, kk, a, b, c, &t_num, &t_denom, &hit);
  t_num_out[j] = t_num;
  t_denom_out[j] = t_denom;
  hit_out[j] = hit;
}

}  // namespace

// org/shear: (3, n) f32; k: (3, n) i32 (kx, ky, kz); va/vb/vc: (3, n) f32.
// Outputs t_num, t_denom (n,) f32 and hit (n,) i32.
extern "C" int rayflex_raytri(const void* org, const void* shear, const void* k,
                              const void* va, const void* vb, const void* vc, void* t_num,
                              void* t_denom, void* hit, int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  raytri_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(org), static_cast<const float*>(shear),
      static_cast<const int*>(k), static_cast<const float*>(va),
      static_cast<const float*>(vb), static_cast<const float*>(vc),
      static_cast<float*>(t_num), static_cast<float*>(t_denom), static_cast<int*>(hit), n);
  RAYFLEX_LAUNCH_RESULT();
}
