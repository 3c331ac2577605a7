// OpQuadbox as a standalone kernel: one thread per job (one ray vs 4 AABBs).
//
// Replaces: repro/kernels/raybox.py, raybox_kernel (the Pallas TPU kernel).
// What bounds it on the H100: bytes.  A job reads 9 + 24 floats and writes
// 12 words (180 B) for about 80 f32 operations, 0.44 op per byte, far
// below the card's 20 op per byte of f32 work per byte of HBM.
// What the design does about it: the operands stay in the reference's
// rows-by-jobs layout, so thread i reads and writes column i of every row
// and a warp's accesses to a row are one contiguous 128-byte segment; the
// arithmetic lives in registers (datapath.cuh, op_quadbox).
#include "datapath.cuh"

namespace {

__global__ void raybox_kernel(const float* __restrict__ org, const float* __restrict__ inv,
                              const float* __restrict__ neg, const float* __restrict__ lo,
                              const float* __restrict__ hi, float* __restrict__ tmin_out,
                              int* __restrict__ idx_out, int* __restrict__ hit_out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  // (3 b + d) n + j reaches 12 n - 1, past a 32-bit int above 2^31 / 12
  // jobs: offsets are taken in 64 bits
  const size_t stride = static_cast<size_t>(n);
  float o[3], iv[3], l[4][3], h[4][3];
  bool ng[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    o[d] = org[d * stride + j];
    iv[d] = inv[d * stride + j];
    ng[d] = neg[d * stride + j] > 0.5f;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      l[b][d] = lo[(3 * b + d) * stride + j];
      h[b][d] = hi[(3 * b + d) * stride + j];
    }
  }
  float tmin[4];
  int idx[4], hit[4];
  rayflex::op_quadbox(o, iv, ng, l, h, tmin, idx, hit);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    tmin_out[s * stride + j] = tmin[s];
    idx_out[s * stride + j] = idx[s];
    hit_out[s * stride + j] = hit[s];
  }
}

}  // namespace

// org/inv/neg: (3, n) f32; lo/hi: (12, n) f32, row 3*box + dim.
// Outputs tmin (4, n) f32, idx (4, n) i32, hit (4, n) i32.
extern "C" int rayflex_raybox(const void* org, const void* inv, const void* neg,
                              const void* lo, const void* hi, void* tmin, void* idx,
                              void* hit, int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  raybox_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(org), static_cast<const float*>(inv),
      static_cast<const float*>(neg), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(tmin), static_cast<int*>(idx),
      static_cast<int*>(hit), n);
  RAYFLEX_LAUNCH_RESULT();
}

extern "C" const char* rayflex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
