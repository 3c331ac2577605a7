// The unified mixed-opcode datapath stream (Table V): one in-order stream
// of beats, each beat one opcode for 128 lane-streams, with per-lane,
// per-mode accumulators that persist across the beats of their own mode.
//
// Replaces: repro/kernels/unified.py, unified_kernel (the Pallas TPU kernel,
// with its branches _triangle_branch, _quadbox_branch, _euclidean_branch
// and _angular_branch).
// What bounds it on the H100: bytes.  A beat reads only the operand rows
// its opcode uses (quadbox 33, triangle 18, euclidean 34, angular 18 of the
// 48) and writes the 16 output rows, for at most ~80 f32 operations a job:
// under 0.6 op per byte against the card's ~20.
// What the design does about it, in two passes:
//   A. one block of 128 threads per beat (the opcode is uniform in a block,
//      so no warp diverges on it): each thread reads its column of the live
//      rows, runs the mode's unit (op_quadbox / op_triangle of datapath.cuh,
//      or the euclidean / angular adder trees) and writes all 16 output
//      rows, zeros where the opcode writes nothing; a vector beat writes its
//      per-beat partial(s) where the accumulator belongs.  Rows are read and
//      written column-contiguously, 512 B per warp-row.
//   B. the accumulator chains.  Bit-equality with the in-order stream
//      forbids re-association: acc_t = partial_t + acc_{t-1} per lane and
//      mode, in stream order.  A chain starts at a (beat, lane) of mode m
//      whose reset is set, or at the stream's first beat of m (where the
//      accumulators hold their power-up +0.0); nothing earlier reaches it.
//      One thread per chain start walks forward over the beats, adding the
//      partials of mode m in order, and stops at that lane's next reset of
//      m.  Its loads run 16 beats ahead of its adds, so a walk costs one
//      memory round trip per 16 beats.  A chain start adds +0.0, as the
//      reference does (acc_in = 0.0 on a reset), so a -0.0 partial comes
//      out +0.0.  A stream with no resets is 128 chains as long as the
//      stream: correct, and latency-bound.
// Rounding: every add and multiply is an __f*_rn intrinsic, the adder trees
// keep the reference's pairing, and the build uses -fmad=false
// (datapath.cuh).  Row offsets are 64-bit: 48 rows x T*128 columns passes
// 2^31 elements at a few hundred thousand beats.
#include "datapath.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kAhead = 16;  // beats a chain walk loads ahead of its adds

// the union layout of kernels/common.py
constexpr int ROW_ORG = 0, ROW_INV = 3, ROW_NEG = 6, ROW_SHEAR = 3, ROW_K = 6;
constexpr int ROW_BOX_LO = 9, ROW_BOX_HI = 25, ROW_TRI_A = 9, ROW_TRI_B = 12, ROW_TRI_C = 15;
constexpr int ROW_VEC_A = 9, ROW_VEC_B = 25, ROW_MASK = 41, ROW_RESET = 42;
constexpr int N_OUTPUT_ROWS = 16;
constexpr int OUT_TMIN = 0, OUT_IDX = 4, OUT_HIT = 8, OUT_TNUM = 0, OUT_TDENOM = 1,
              OUT_THIT = 2, OUT_EUCLID = 0, OUT_DOT = 0, OUT_NORM = 1, OUT_RESET = 12;
constexpr int OP_TRIANGLE = 0, OP_QUADBOX = 1, OP_EUCLIDEAN = 2, OP_ANGULAR = 3;

// Pass A: one block per beat, one thread per lane.  scratch[0..1] is the
// first euclidean / angular beat (set to t by the caller, lowered here);
// scratch[2 + beat] is the beat's mode, for pass B.
__global__ void unified_beats(const int* __restrict__ opcodes, const float* __restrict__ in,
                              float* __restrict__ out, int* __restrict__ scratch, long long n) {
  const int t = blockIdx.x;
  const long long j = static_cast<long long>(t) * kLanes + threadIdx.x;
  // the reference picks the branch with lax.switch, which clamps its index
  const int raw = opcodes[t];
  const int op = raw < 0 ? 0 : (raw > 3 ? 3 : raw);
  auto row = [&](int r) { return in[static_cast<long long>(r) * n + j]; };

  float o[N_OUTPUT_ROWS];
#pragma unroll
  for (int r = 0; r < N_OUTPUT_ROWS; ++r) o[r] = 0.0f;

  if (op == OP_TRIANGLE) {
    float org[3], shear[3], va[3], vb[3], vc[3];
    int k[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      org[d] = row(ROW_ORG + d);
      shear[d] = row(ROW_SHEAR + d);
      // k arrives as f32; the reference's mux takes 0.0 -> x, 1.0 -> y,
      // anything else -> z
      const float kf = row(ROW_K + d);
      k[d] = kf == 0.0f ? 0 : (kf == 1.0f ? 1 : 2);
      va[d] = row(ROW_TRI_A + d);
      vb[d] = row(ROW_TRI_B + d);
      vc[d] = row(ROW_TRI_C + d);
    }
    bool hit;
    rayflex::op_triangle(org, shear, k, va, vb, vc, &o[OUT_TNUM], &o[OUT_TDENOM], &hit);
    o[OUT_THIT] = hit ? 1.0f : 0.0f;
  } else if (op == OP_QUADBOX) {
    float org[3], inv[3], lo[4][3], hi[4][3];
    bool neg[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      org[d] = row(ROW_ORG + d);
      inv[d] = row(ROW_INV + d);
      neg[d] = row(ROW_NEG + d) > 0.5f;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[b][d] = row(ROW_BOX_LO + 3 * b + d);
        hi[b][d] = row(ROW_BOX_HI + 3 * b + d);
      }
    }
    float tmin[4];
    int idx[4], hit[4];
    rayflex::op_quadbox(org, inv, neg, lo, hi, tmin, idx, hit);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      o[OUT_TMIN + s] = tmin[s];
      o[OUT_IDX + s] = static_cast<float>(idx[s]);
      o[OUT_HIT + s] = hit[s] ? 1.0f : 0.0f;
    }
  } else if (op == OP_EUCLIDEAN) {
    // the live-lane mask arrives as a count: lane i is live iff count > i
    const float count = row(ROW_MASK);
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // stages 2-3: 16 adders, 16 multipliers
      const float d = __fsub_rn(row(ROW_VEC_A + i), row(ROW_VEC_B + i));
      s[i] = count > static_cast<float>(i) ? __fmul_rn(d, d) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = __fadd_rn(s[i], s[i + 8]);  // stage 4
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = __fadd_rn(s[i], s[i + 4]);  // stage 6
#pragma unroll
    for (int i = 0; i < 2; ++i) s[i] = __fadd_rn(s[i], s[i + 2]);  // stage 8
    o[OUT_EUCLID] = __fadd_rn(s[0], s[1]);  // stage 9: the partial (pass B adds)
    o[OUT_RESET] = row(ROW_RESET);
  } else {  // OP_ANGULAR: 8 lanes, two multipliers each
    const float count = row(ROW_MASK);
    float dot[8], nrm[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // stage 3
      const float q = row(ROW_VEC_A + i), c = row(ROW_VEC_B + i);
      const bool live = count > static_cast<float>(i);
      dot[i] = live ? __fmul_rn(q, c) : 0.0f;
      nrm[i] = live ? __fmul_rn(c, c) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // stage 4
      dot[i] = __fadd_rn(dot[i], dot[i + 4]);
      nrm[i] = __fadd_rn(nrm[i], nrm[i + 4]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // stage 6
      dot[i] = __fadd_rn(dot[i], dot[i + 2]);
      nrm[i] = __fadd_rn(nrm[i], nrm[i + 2]);
    }
    o[OUT_DOT] = __fadd_rn(dot[0], dot[1]);  // stage 8: the partials
    o[OUT_NORM] = __fadd_rn(nrm[0], nrm[1]);
    o[OUT_RESET] = row(ROW_RESET);
  }

#pragma unroll
  for (int r = 0; r < N_OUTPUT_ROWS; ++r) out[static_cast<long long>(r) * n + j] = o[r];
  if (threadIdx.x == 0) {
    scratch[2 + t] = op;
    if (op >= OP_EUCLIDEAN) atomicMin(&scratch[op - OP_EUCLIDEAN], t);
  }
}

// Pass B: one thread per (beat, lane); only chain starts do work.  It reads
// the modes pass A wrote, not the opcodes: with the opcode clamp (min/max)
// here too, ptxas -O3 (CUDA 12.9, sm_90a) chose between the euclidean and
// angular walks on the clamp's predicate output, and no euclidean walk ran.
__global__ void unified_chains(const int* __restrict__ scratch, const float* __restrict__ in,
                               float* __restrict__ out, int t_beats, long long n) {
  const int* modes = scratch + 2;
  const int t = blockIdx.x;
  const int op = modes[t];
  if (op < OP_EUCLIDEAN) return;
  const float* reset = in + static_cast<long long>(ROW_RESET) * n + threadIdx.x;
  const long long j = static_cast<long long>(t) * kLanes;
  if (!(reset[j] > 0.5f) && t != scratch[op - OP_EUCLIDEAN]) return;  // not a chain start

  const bool ang = op == OP_ANGULAR;
  float* acc0 = out + static_cast<long long>(OUT_EUCLID) * n + threadIdx.x;  // == OUT_DOT
  float* acc1 = out + static_cast<long long>(OUT_NORM) * n + threadIdx.x;
  // chain start: partial + 0.0, the reference's acc_in on a reset
  float a0 = __fadd_rn(acc0[j], 0.0f);
  acc0[j] = a0;
  float a1 = 0.0f;
  if (ang) {
    a1 = __fadd_rn(acc1[j], 0.0f);
    acc1[j] = a1;
  }
  for (int base = t + 1; base < t_beats; base += kAhead) {
    // loads first (none depends on an add), then the in-order adds; a
    // column past this chain's end is loaded and never used
    int ops[kAhead];
    bool rst[kAhead];
    float p0[kAhead], p1[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int s = base + k < t_beats ? base + k : t_beats - 1;
      const long long c = static_cast<long long>(s) * kLanes;
      ops[k] = base + k < t_beats ? modes[s] : -1;
      rst[k] = reset[c] > 0.5f;
      p0[k] = acc0[c];
      p1[k] = ang ? acc1[c] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (ops[k] != op) continue;
      if (rst[k]) return;  // the next chain of this lane and mode
      const long long c = static_cast<long long>(base + k) * kLanes;
      a0 = __fadd_rn(p0[k], a0);
      acc0[c] = a0;
      if (ang) {
        a1 = __fadd_rn(p1[k], a1);
        acc1[c] = a1;
      }
    }
  }
}

}  // namespace

// opcodes: (t,) i32, one per beat; operands: (48, t*128) f32 in the union
// layout, column beat*128 + lane; out: (16, t*128) f32.  scratch: (t + 2,)
// i32, its first two set to t by the caller.
extern "C" int rayflex_unified(const void* opcodes, const void* operands, void* out,
                               void* scratch, int t, void* stream) {
  if (t <= 0) return 0;
  const long long n = static_cast<long long>(t) * kLanes;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ops = static_cast<const int*>(opcodes);
  const auto* in = static_cast<const float*>(operands);
  auto* o = static_cast<float*>(out);
  auto* f = static_cast<int*>(scratch);
  unified_beats<<<t, kLanes, 0, s>>>(ops, in, o, f, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unified_chains<<<t, kLanes, 0, s>>>(f, in, o, t, n);
  RAYFLEX_LAUNCH_RESULT();
}
