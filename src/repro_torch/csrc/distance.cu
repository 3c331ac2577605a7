// OpEuclidean / OpAngular in batched form (a tiled f32 GEMM with the
// distance epilogue) and the row-norm kernel, OpAngular's second output.
//
// Replaces: repro/kernels/distance.py, _distance_kernel and _norm_kernel
// (the Pallas TPU kernels, which run the product on the MXU and carry the
// accumulator across K blocks in VMEM).
//
// What the distance kernel computes, per (query m, candidate n), over the
// feature axis cut into blocks of kKBlock = 128 (the reference's bk):
//   euclidean: sum over blocks of (|q_b|^2 - 2 q_b.c_b) + |c_b|^2, then
//              max(., 0) (NaN passes, as jnp.maximum lets it);
//   angular:   q.c.
// What bounds it on the H100: operations.  At D = 128 a pair costs 256 f32
// operations against 4 bytes of output, far above the card's ~20 f32
// operations per byte of HBM; the bound is 2 M N D over 67 TFLOP/s
// (non-tensor f32), since the reference's Precision.HIGHEST rules out TF32.
// What the design does about it: a 128 x 128 output tile per block of 256
// threads, each thread an 8 x 8 register tile (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise, so the shared-memory reads of a
// warp are conflict-free 16-byte vectors); the feature axis is swept in
// shared-memory stages of 16, so each operand element read from global
// memory feeds 128 multiply-adds.  Products accumulate with __fmaf_rn
// (explicit FMA, as cuBLAS does; -fmad=false only stops contraction of a
// separate mul and add).  The kernel is held to a tolerance, not to the
// bits of its plain version: the order of the sums differs.  It masks the
// ragged edges of M, N and D itself.  No wgmma, TMA or 3xTF32 yet.
#include "datapath.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256;
constexpr int kKBlock = 128;  // the reference's K block (ops' bk)
constexpr int kPad = 4;       // keeps rows 16-byte aligned

__device__ __forceinline__ float max0_keep_nan(float x) { return (x > 0.0f || x != x) ? x : 0.0f; }

template <bool kEuclid, bool kMultiBlock>
__global__ void __launch_bounds__(kThreads)
    distance_kernel(const float* __restrict__ q, const float* __restrict__ c,
                    float* __restrict__ out, int m, int n, int d) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];
  __shared__ __align__(16) float bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // acc carries the sum across K blocks; with a single block (d <= 128)
  // it is dead code and the block's value stays in part
  float acc[8][8], part[8][8], q2[8], c2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < d; kb += kKBlock) {
    const int kend = min(kb + kKBlock, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q2[i] = 0.0f;
      c2[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
    }
    for (int k0 = kb; k0 < kend; k0 += kBK) {
      // stage: thread t loads feature k0 + t % 16 of rows t / 16 + 16 i
      const int kk = tid % kBK, col = k0 + kk;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tid / kBK + 16 * i;
        const int qm = m0 + r, cn = n0 + r;
        as[kk][r] = (qm < m && col < kend) ? q[static_cast<size_t>(qm) * d + col] : 0.0f;
        bs[kk][r] = (cn < n && col < kend) ? c[static_cast<size_t>(cn) * d + col] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kBK; ++s) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&as[s][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[s][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[s][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[s][64 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) part[i][j] = __fmaf_rn(a[i], b[j], part[i][j]);
        if (kEuclid) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            q2[i] = __fmaf_rn(a[i], a[i], q2[i]);
            c2[i] = __fmaf_rn(b[i], b[i], c2[i]);
          }
        }
      }
      __syncthreads();
    }
    // close the K block: the euclidean expanded form, or the plain dot
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = kEuclid ? __fadd_rn(__fsub_rn(q2[i], __fmul_rn(2.0f, part[i][j])), c2[j])
                                : part[i][j];
        if (kMultiBlock) acc[i][j] = __fadd_rn(acc[i][j], v);
        else part[i][j] = v;
      }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
    float* dst = out + static_cast<size_t>(row) * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= n) continue;
      float v = kMultiBlock ? acc[i][j] : part[i][j];
      if (kEuclid) v = max0_keep_nan(v);
      dst[col] = v;
    }
  }
}

// |c_n|^2 per row: one warp per row, each lane squaring 4 consecutive
// features of a 128-feature block; the block's sum (a warp reduction) adds
// into the row's total, block by block, as the reference accumulates.
// Bound by bytes: N D 4 B read once.
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

}  // namespace

// q: (m, d) f32, c: (n, d) f32, both row-major; out: (m, n) f32.
// mode 0 = euclidean, 1 = angular.
extern "C" int rayflex_distance(const void* q, const void* c, void* out, int m, int n,
                                int d, int mode, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (d <= 0 || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto cp = static_cast<const float*>(c);
  auto op = static_cast<float*>(out);
  const bool multi = d > kKBlock;
  if (mode == 0) {
    if (multi) distance_kernel<true, true><<<grid, kThreads, 0, s>>>(qp, cp, op, m, n, d);
    else distance_kernel<true, false><<<grid, kThreads, 0, s>>>(qp, cp, op, m, n, d);
  } else {
    if (multi) distance_kernel<false, true><<<grid, kThreads, 0, s>>>(qp, cp, op, m, n, d);
    else distance_kernel<false, false><<<grid, kThreads, 0, s>>>(qp, cp, op, m, n, d);
  }
  RAYFLEX_LAUNCH_RESULT();
}

// c: (n, d) f32 row-major; out: (n,) f32.
extern "C" int rayflex_norm(const void* c, void* out, int n, int d, void* stream) {
  if (n <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256, rows_per_block = threads / 32;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  norm_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<float*>(out), n, d);
  RAYFLEX_LAUNCH_RESULT();
}
