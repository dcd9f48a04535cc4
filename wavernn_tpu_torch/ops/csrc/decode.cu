// WaveRNN sample loop, one persistent kernel for Hopper (sm_90a): the row
// design, one CTA per fold row.
//
// Replaces wavernn_tpu/ops/pallas_decode.py::_decode_kernel (launched by
// pallas_decode.decode).  It computes what that kernel computes, step for
// step (the math is written out in ops/cuda_decode.py, whose
// decode_reference is this kernel's plain PyTorch version), not how the TPU
// lays it out: no 128-lane padding, no chunked DMA double-buffering, no
// on-core transpose.
//
// Route.  The cluster design (decode_cluster.cu: a fold row's columns
// split over a thread-block cluster) serves the int8 / bf16 recurrent and
// feed-forward variants by default.  This kernel serves int8_gates (G8,
// whose per-row operand maxima would need one more cluster-wide reduction
// per operand) and the ablations, and is the A/B arm of the cluster design
// (cuda_decode.decode(design="row")).
//
// Design.  One CTA owns R fold rows for all T steps, with no communication
// between CTAs.  Its recurrent state (x, h1, h2), the residual and the
// operands of each dot live in shared memory, k-major ([K][R]) so that one
// weight, loaded once, meets all R rows: the bf16-rounded operands as
// double, converted once per step, the int8 ones packed four to a word.
// The step has five dependent phases (GRU1, GRU2, FC1, FC2, FC3 +
// sampling).  In each, every dot is split over the CTA's threads (1,024 at
// R = 1, 512 at R = 2) by csrc/dot.cuh: a thread takes 8 bf16 or 16 int8
// columns of one K-slice and reads them with 16-byte loads, coalesced
// across its warp; the partial sums go to shared memory and the phase's
// epilogue (gate math, residual, relu, bf16 rounding: one thread per
// column) adds each column's slices in a fixed order.  FC3's n_out columns
// (ldw not 16-byte aligned) take one column per task, K split over all
// warps in slices of 16 rows.  The weights stay in global memory, resident
// in the 50 MB L2: each is used once per CTA and step, so staging it
// through shared memory adds instructions and saves nothing (a cp.async
// ring of four rows per thread measured slower, PERF.md).
//
// Arithmetic.  A dot of bf16 operands sums its exact products in float64
// and rounds the sum once to float32, each dot on its own, as the plain
// version does; the int8 recurrent dots sum integers with __dp4a, exact.
// With int8 feed-forward matrices (FF, the TPU kernel's ``int8_ff``), GRU2's
// input dot, FC1 and FC2 are int8 dots too: each phase's epilogue quantizes
// the next one's operand at its calibrated fixed scale (round(clip(v * 127
// / S, +-127)), half to even) straight into its byte of the packed int8
// operand, and the dot's int32 sum times the column's fused scale (weight
// scale x S / 127) replaces the float64 sum.  The clip keeps every value in
// the int8 range, so no second byte plane is needed.
// With G8 (the TPU kernel's ``int8_gates``) the same five dots are int8 at
// per-column weight scales, and each operand (h1, xr, h2, xr after GRU2,
// relu(f1)) is quantized at its own row's scale: the phase that makes it
// keeps each row's largest |value| (a warp maximum, then an atomicMax in
// shared memory), and after one more barrier every thread packs its words
// at sa = max(m, 1e-8) * (1/127), round(v / sa) by a true division, half to
// even.  The epilogue multiplies the dot's exact int32 sum by (sa * s_w).
// A maximum does not depend on the order of its terms, so this variant too
// equals its plain version bit for bit.  It costs three barriers a step
// more than FF (the operands of GRU2's input dot, FC1 and FC2; h1's and
// h2's maxima are known a phase ahead).
// The order of the float64 terms then hardly matters, so this kernel and
// its plain version (float64 GEMMs) agree to the bit nearly always, and a
// deterministic decode can be held to a tight tolerance over thousands of
// steps.  The gate arithmetic is float32 with one rounding per operation
// (the __f*_rn intrinsics keep nvcc from contracting it into FMAs), in the
// plain version's order.
//
// What bounds it.  Per CTA and step the dots stream ~4.85 MB of weights
// from L2 at the full-size model (1.64 M bf16 + 1.57 M int8).  Each bf16
// weight costs ~4.8 issued instructions at R = 1 (the float64 FMA, and four
// integer ops that build its double), so one CTA can take ~27 bf16 weights
// a clock against the SM's 128 issue slots.  A thread issues its loads one
// at a time, so each phase also lasts as long as its longest chain of L2
// round trips; the splits (make_plan) keep those chains short.  On an H100
// (700 W) the step takes 72.94 us at 64 rows x 2,048 steps (PR 3's design,
// a thread per column walking K one 1- or 2-byte load at a time: 268.20),
// and the matmul floor, the same dots alone, 102.33 us for 3.67 M weights
// (PERF.md).

// Ablations (dev only, for the cost breakdown in
// wavernn_tpu_torch/tools/kernel_breakdown.py): the template parameter MASK
// drops named pieces of the step, with the meanings of the TPU kernel's
// ``ablate`` knob.  AB_SAMPLE: the sample is tanh(logits[0]); AB_GATES: each
// GRU update is 0.5*h + 0.01*(gi[r] + gh[r]) (all gate dots still run);
// AB_COND_READ: the conditioning row is zeros; AB_OUT_WRITE: no output
// store.  Production is MASK = 0, which compiles to the plain kernel.
//
// Random bits: a counter-based 32-bit hash of (seed, fold row, step, lane)
// replaces the TPU's on-core PRNG; the plain version reproduces it.  The
// fold row is row0 + the row within the launch, so a launch over rows
// [row0, row0 + B) of a larger batch (one shard of a mesh) draws the bits
// that the whole batch's launch draws for those rows.
//
// Entry point (plain C, bound with ctypes):
//   int wavernn_decode(const void* const* ptrs, const long long* dims,
//                      void* stream)
// ptrs = cond, out, then the packed weights in cuda_decode.WEIGHT_ORDER;
// dims = B, Tc, C, T, H, F, feat, aux_d, n_out, mode (0 RAW, 1 MOL),
//        deterministic, int8_hh, rows_per_cta, seed, ablation mask, int8_ff,
//        row0, int8_gates (then int8_hh and int8_ff are 0, one row per CTA,
//        no ablation).
// Returns a cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "decode_step.cuh"
#include "dot.cuh"

namespace {

using namespace step;

// Threads per CTA: a CTA of one row fits its registers in 64 a thread and
// takes 1,024 threads, twice the warps to issue from (PERF.md: the matmul
// floor 2.2x faster than at R = 2 and 512 threads).
__host__ __device__ constexpr int threads(int R) { return R == 1 ? 1024 : 512; }
constexpr int AB_SAMPLE = 1, AB_GATES = 2, AB_COND_READ = 4, AB_OUT_WRITE = 8;

struct Params {
  const __nv_bfloat16* cond;  // (B, Tc, C) fold-major conditioning
  float* out;                 // (B, T)
  const __nv_bfloat16* w_Im1; const float* u1;
  const __nv_bfloat16* w_Im; const float* w_x; const float* b_I;
  const void* w_hh1; const float* s_hh1; const float* b1; const float* b_hh1_n;
  const void* w_ih2x;                 // bf16, or int8 with FF
  const void* w_hh2; const float* s_hh2; const float* b2; const float* b_hh2_n;
  const void* w_fc1x; const float* b_fc1;
  const void* w_fc2x; const float* b_fc2;
  const __nv_bfloat16* w_aux; const __nv_bfloat16* w_fc3; const float* b_fc3;
  // FF: each int8 feed-forward matrix's fused column scales, and the (3,)
  // quantization multipliers 127 / S of their operands
  const float* fs_ih2; const float* fs_fc1; const float* fs_fc2;
  const float* ffq;
  // G8: the int8 feed-forward matrices' column scales (s_hh1 / s_hh2 hold
  // the recurrent ones')
  const float* s_ih2; const float* s_fc1; const float* s_fc2;
  int B, Tc, C, T, H, F, feat, d, n_out, mode, det;
  uint32_t seed;
  uint32_t row0;      // the random bits' row of this launch's row 0
  dot::Split sp[11];  // each dot's split (D_* order)
  int off[11];        // each dot's partial sums in shared memory, in doubles
  int scratch;        // doubles of partial sums, the largest phase's
};

// The step's dots, each summed on its own, in phase order: GRU1 (seg0 @
// w_Im1, seg0 @ w_Im, h1 @ w_hh1), GRU2 (bf(xr) @ w_ih2x, a2 @ w_aux[:3H],
// h2 @ w_hh2), FC1 (x, a3), FC2 (x, a4), FC3.
enum { D_IM1, D_IM, D_HH1, D_IH2, D_AUX2, D_HH2, D_FC1, D_AUX3, D_FC2,
       D_AUX4, D_FC3, ND };
// G8's operands quantized per row: h1, xr (GRU2's input), h2, xr after
// GRU2 (FC1's), relu(f1) (FC2's)
enum { Q_H1, Q_X1, Q_H2, Q_X2, Q_F1, NQ };

// The ablated GRU update; ``keep`` takes the unused gate values, so that
// their dots stay live.
__device__ __forceinline__ float gru_ablated(const float (&gi)[3],
                                             const float (&gh)[3], float h,
                                             float& keep) {
  keep = add(keep, add(add(gi[1], gi[2]), add(gh[1], gh[2])));
  return add(mul(0.5f, h), mul(0.01f, add(gi[0], gh[0])));
}

// __syncthreads(), and with ``want`` whether ``v`` held in any thread.
__device__ __forceinline__ bool sync_or(bool v, bool want) {
  if (want) return __syncthreads_or(v);
  __syncthreads();
  return false;
}

// G8 runs with I8 and FF set: its five dots are the int8 ones of those.
template <int R, bool I8, bool FF, bool G8, int MASK>
__global__ void __launch_bounds__(threads(R)) decode_kernel(Params p) {
  using dot::psum;
  constexpr int NT = threads(R), NWARP = NT / 32;
  // an ablated GRU update can leave (-1, 1), and its int8 operand the int8
  // range: those dots then take a second byte plane
  constexpr bool GATES = (MASK & AB_GATES) != 0;
  extern __shared__ __align__(16) double sm[];
  const int H = p.H, F = p.F, C = p.C, d = p.d, NO = p.n_out;
  const int W = H > F ? H : F;
  const int K0 = p.feat + d;           // seg0 width: [mel | a1]
  const int H3 = 3 * H, NA = 3 * H + 2 * F;
  // sm: the phase's partial sums, then
  double* cond = sm + p.scratch;       // [C][R] conditioning row
  double* opX = cond + C * R;          // [W][R] input-side dot operand
  double* opH = opX + W * R;           // [W][R] bf16 hidden / fc2 operand
  float* h1 = reinterpret_cast<float*>(opH + W * R);  // [H][R]
  float* h2 = h1 + H * R;              // [H][R]
  float* xr = h2 + H * R;              // [H][R]
  float* logits = xr + H * R;          // [R][NO]
  float* xs = logits + R * NO;         // [R] previous sample
  uint32_t* opQ = reinterpret_cast<uint32_t*>(xs + R);  // [H/4][R] int8
  uint32_t* opQh = opQ + (H / 4) * R;  // [H/4][R] its high bytes (GATES)
  uint32_t* opF = opQh + (H / 4) * R;  // [W/4][R] int8 feed-forward operand
  uint32_t* amax = opF + (W / 4) * R;  // [NQ][R] G8: bits of a row's max|v|
  float* qscale = reinterpret_cast<float*>(amax + NQ * R);  // [NQ][R] its sa
  float* f1s = reinterpret_cast<float*>(opH);  // [F][R] G8: relu(f1)
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * R;
  float keep = 0.f;  // AB_GATES only

  auto part = [&](int i) { return sm + p.off[i]; };
  auto ipart = [&](int i) { return reinterpret_cast<int*>(sm + p.off[i]); };
  // the recurrent dot's operand from h (int8 or bf16); with GATES, whether
  // it left the int8 range
  auto hidden_operand = [&](const float* h) {
    if constexpr (I8) {
      return dot::pack_i8<NT, R>(opQ, GATES ? opQh : nullptr, h, H);
    } else {
      for (int i = tid; i < H * R; i += NT) opH[i] = bfr64(h[i]);
      return false;
    }
  };
  auto hidden_dot = [&](int i, const void* w, bool wide, int& first) {
    if constexpr (I8) {
      const int8_t* w8 = static_cast<const int8_t*>(w);
      if (GATES && wide)
        dot::dot_i8<NT, R, GATES ? 2 : 1>(ipart(i), opQ, opQh, H, H3, w8,
                                          H3, p.sp[i], first);
      else
        dot::dot_i8<NT, R, 1>(ipart(i), opQ, nullptr, H, H3, w8, H3,
                              p.sp[i], first);
    } else {
      dot::dot_bf16<NT, R, 8>(part(i), opH, H, H3,
                              static_cast<const __nv_bfloat16*>(w), H3,
                              p.sp[i], first);
    }
  };
  // FF: the operand of feed-forward dot q, v at its calibrated scale,
  // stored as byte k of row r of opF
  float ffq[3] = {0.f, 0.f, 0.f};
  if constexpr (FF && !G8) {
    ffq[0] = p.ffq[0]; ffq[1] = p.ffq[1]; ffq[2] = p.ffq[2];
  }
  auto ff_operand = [&](int q, float v, int k, int r) {
    dot::store_i8<R>(opF, k, r, __float2int_rn(
        fminf(fmaxf(mul(v, ffq[q]), -127.f), 127.f)));
  };
  // a feed-forward dot: int8 on opF (FF), else bf16 on ``a``
  auto ff_dot = [&](int i, const double* a, int K, int N, const void* w,
                    int& first) {
    if constexpr (FF)
      dot::dot_i8<NT, R, 1>(ipart(i), opF, nullptr, K, N,
                            static_cast<const int8_t*>(w), N, p.sp[i], first);
    else
      dot::dot_bf16<NT, R, 8>(part(i), a, K, N,
                              static_cast<const __nv_bfloat16*>(w), N,
                              p.sp[i], first);
  };
  // G8: operand q of row r packed at its row's scale (into ``plane``),
  // the scale kept for the epilogue
  auto quantize = [&](int q, uint32_t* plane, const float* v, int K) {
    if (tid < R) qscale[q * R + tid] = dot::row_scale(amax[q * R + tid]);
    dot::pack_scaled<NT, R>(plane, v, K, amax + q * R);
  };
  // G8: column n of a dot on operand q, scaled back from int8 (s: the
  // weight's column scales)
  auto g8_col = [&](int i, int q, const float* s, int N, int n, int r) {
    return mul(psum<R>(ipart(i), p.sp[i].S, N, n, r),
               mul(qscale[q * R + r], s[n]));
  };
  // column n of a feed-forward dot (on G8's operand q), scaled back from
  // int8 (FF, G8)
  auto ff_col = [&](int i, int q, const float* fs, const float* s, int N,
                    int n, int r) {
    if constexpr (G8)
      return g8_col(i, q, s, N, n, r);
    else if constexpr (FF)
      return mul(psum<R>(ipart(i), p.sp[i].S, N, n, r), fs[n]);
    else
      return psum<R>(part(i), p.sp[i].S, N, n, r);
  };
  // gate g of column j of a recurrent dot (on G8's operand q), scaled back
  // from int8
  auto hidden_gate = [&](int i, int q, const float* s_hh, int g, int j,
                         int r) {
    if constexpr (G8)
      return g8_col(i, q, s_hh, H3, g * H + j, r);
    else if constexpr (I8)
      return mul(psum<R>(ipart(i), p.sp[i].S, H3, g * H + j, r),
                 mul(s_hh[g * H + j], 1.0f / 127.0f));
    else
      return psum<R>(part(i), p.sp[i].S, H3, g * H + j, r);
  };
  // G8: the bits of |v| (a float >= 0 orders as its bits do)
  auto abits = [](float v) { return __float_as_uint(fabsf(v)); };

  for (int i = tid; i < H * R; i += NT) { h1[i] = 0.f; h2[i] = 0.f; }
  for (int i = tid; i < R; i += NT) xs[i] = 0.f;
  for (int i = tid; i < NQ * R; i += NT) amax[i] = 0u;
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    // conditioning row of each fold, and gru1's hidden operand
    for (int i = tid; i < C * R; i += NT) {
      const int r = i % R, c = i / R, b = b0 + r;
      if constexpr ((MASK & AB_COND_READ) != 0) {
        cond[i] = 0.0;
      } else {
        cond[i] = b < p.B ? dot::act(static_cast<double>(__bfloat162float(
                                p.cond[((size_t)b * p.Tc + t) * C + c])))
                          : 0.0;
      }
    }
    bool wide1 = false;
    if constexpr (G8) {
      quantize(Q_H1, opQ, h1, H);
      __syncthreads();
      // no thread reads these maxima again before this step's GRU1
      // epilogue makes them anew
      if (tid < R) { amax[Q_H1 * R + tid] = 0u; amax[Q_X1 * R + tid] = 0u; }
    } else {
      wide1 = sync_or(hidden_operand(h1), GATES);
    }

    // GRU1 (inputs precomposed through I) and the I projection
    int first = 0;
    dot::dot_bf16<NT, R, 8>(part(D_IM1), cond, K0, H3, p.w_Im1, H3,
                            p.sp[D_IM1], first);
    dot::dot_bf16<NT, R, 8>(part(D_IM), cond, K0, H, p.w_Im, H, p.sp[D_IM],
                            first);
    hidden_dot(D_HH1, p.w_hh1, wide1, first);
    __syncthreads();
    uint32_t mh[R], mx[R];   // G8: this thread's largest |h|, |xr| a row
#pragma unroll
    for (int r = 0; r < R; ++r) { mh[r] = 0u; mx[r] = 0u; }
    for (int j = tid; j < H; j += NT) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = xs[r];
        float a[3], h[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          a[g] = add(mul(x, p.u1[g * H + j]),
                     psum<R>(part(D_IM1), p.sp[D_IM1].S, H3, g * H + j, r));
          h[g] = hidden_gate(D_HH1, Q_H1, p.s_hh1, g, j, r);
        }
        const float hn = GATES
            ? gru_ablated(a, h, h1[j * R + r], keep)
            : gru(a, h, p.b1, p.b_hh1_n, j, H, h1[j * R + r]);
        h1[j * R + r] = hn;
        const float v = add(add(add(mul(x, p.w_x[j]),
                                    psum<R>(part(D_IM), p.sp[D_IM].S, H, j, r)),
                                p.b_I[j]), hn);
        xr[j * R + r] = v;
        if constexpr (G8) {
          mh[r] = max(mh[r], abits(hn));
          mx[r] = max(mx[r], abits(v));
        } else if constexpr (FF) {
          ff_operand(0, v, j, r);
        } else {
          opX[j * R + r] = bfr64(v);
        }
      }
    }
    bool wide2 = false;
    if constexpr (G8) {
      dot::commit_max<R>(amax + Q_H1 * R, mh);
      dot::commit_max<R>(amax + Q_X1 * R, mx);
      __syncthreads();
      quantize(Q_X1, opF, xr, H);
      quantize(Q_H2, opQ, h2, H);
      __syncthreads();
      if (tid < R) { amax[Q_H2 * R + tid] = 0u; amax[Q_X2 * R + tid] = 0u; }
    } else {
      wide2 = sync_or(hidden_operand(h2), GATES);
    }

    // GRU2 on [xr | a2]
    first = 0;
    ff_dot(D_IH2, opX, H, H3, p.w_ih2x, first);
    dot::dot_bf16<NT, R, 8>(part(D_AUX2), cond + K0 * R, d, H3, p.w_aux, NA,
                            p.sp[D_AUX2], first);
    hidden_dot(D_HH2, p.w_hh2, wide2, first);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) { mh[r] = 0u; mx[r] = 0u; }
    for (int j = tid; j < H; j += NT) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a[3], h[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          a[g] = add(ff_col(D_IH2, Q_X1, p.fs_ih2, p.s_ih2, H3, g * H + j, r),
                     psum<R>(part(D_AUX2), p.sp[D_AUX2].S, H3, g * H + j, r));
          h[g] = hidden_gate(D_HH2, Q_H2, p.s_hh2, g, j, r);
        }
        const float hn = GATES
            ? gru_ablated(a, h, h2[j * R + r], keep)
            : gru(a, h, p.b2, p.b_hh2_n, j, H, h2[j * R + r]);
        h2[j * R + r] = hn;
        const float v = add(xr[j * R + r], hn);
        xr[j * R + r] = v;
        if constexpr (G8) {
          mh[r] = max(mh[r], abits(hn));
          mx[r] = max(mx[r], abits(v));
        } else if constexpr (FF) {
          ff_operand(1, v, j, r);
        } else {
          opX[j * R + r] = bfr64(v);
        }
      }
    }
    if constexpr (G8) {
      dot::commit_max<R>(amax + Q_H2 * R, mh);
      dot::commit_max<R>(amax + Q_X2 * R, mx);
      __syncthreads();
      quantize(Q_X2, opF, xr, H);
      if (tid < R) amax[Q_F1 * R + tid] = 0u;
    }
    __syncthreads();

    // FC1 on [xr | a3] -> opH (FF: opF; G8: f1s)
    first = 0;
    ff_dot(D_FC1, opX, H, F, p.w_fc1x, first);
    dot::dot_bf16<NT, R, 8>(part(D_AUX3), cond + (K0 + d) * R, d, F,
                            p.w_aux + (size_t)d * NA + H3, NA, p.sp[D_AUX3],
                            first);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = 0u;
    for (int j = tid; j < F; j += NT) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float f1 = fmaxf(
            add(add(ff_col(D_FC1, Q_X2, p.fs_fc1, p.s_fc1, F, j, r),
                    psum<R>(part(D_AUX3), p.sp[D_AUX3].S, F, j, r)),
                p.b_fc1[j]), 0.f);
        if constexpr (G8) {
          f1s[j * R + r] = f1;
          mx[r] = max(mx[r], abits(f1));
        } else if constexpr (FF) {
          ff_operand(2, f1, j, r);
        } else {
          opH[j * R + r] = bfr64(f1);
        }
      }
    }
    if constexpr (G8) {
      dot::commit_max<R>(amax + Q_F1 * R, mx);
      __syncthreads();
      quantize(Q_F1, opF, f1s, F);
    }
    __syncthreads();

    // FC2 on [f1 | a4] -> opX
    first = 0;
    ff_dot(D_FC2, opH, F, F, p.w_fc2x, first);
    dot::dot_bf16<NT, R, 8>(part(D_AUX4), cond + (K0 + 2 * d) * R, d, F,
                            p.w_aux + (size_t)2 * d * NA + H3 + F, NA,
                            p.sp[D_AUX4], first);
    __syncthreads();
    for (int j = tid; j < F; j += NT) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        opX[j * R + r] = bfr64(fmaxf(
            add(add(ff_col(D_FC2, Q_F1, p.fs_fc2, p.s_fc2, F, j, r),
                    psum<R>(part(D_AUX4), p.sp[D_AUX4].S, F, j, r)),
                p.b_fc2[j]), 0.f));
    }
    __syncthreads();

    // FC3 (ldw = n_out, not 16-byte aligned: one column per task)
    first = 0;
    dot::dot_bf16<NT, R, 1>(part(D_FC3), opX, F, NO, p.w_fc3, NO,
                            p.sp[D_FC3], first);
    __syncthreads();

    // sampling: one warp per fold row, which first adds up its logits
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += NWARP) {
      const int b = b0 + r;
      const uint32_t rb = p.row0 + b;   // the random bits' row
      float* lg = logits + r * NO;
      for (int i = lane; i < NO; i += 32)
        lg[i] = add(psum<R>(part(D_FC3), p.sp[D_FC3].S, NO, i, r),
                    p.b_fc3[i]);
      __syncwarp();
      float sample;
      if constexpr ((MASK & AB_SAMPLE) != 0)
        sample = tanhf(lg[0]);
      else
        sample = sample_row(lg, NO, p.mode, p.det, p.seed, rb, t, lane);
      if (lane == 0) {
        xs[r] = sample;
        if (!(MASK & AB_OUT_WRITE) && b < p.B)
          p.out[(size_t)b * p.T + t] = sample;
      }
    }
    __syncthreads();
  }
  // never true (the grid has ceil(B / R) CTAs), but the compiler cannot
  // know it: the ablated gates' dots are not dead code
  if (GATES && b0 > p.B) p.out[0] = keep;
}

// Each dot's split over the CTA's threads and the place of its partial
// sums; returns the kernel's shared memory bytes.  int8 dots (the recurrent
// ones with i8, the feed-forward ones with ff) take 16 columns and 4 k rows
// per load step, bf16 dots 8 columns and any k.
size_t make_plan(Params& p, int R, bool i8, bool ff) {
  const int H = p.H, F = p.F, d = p.d, H3 = 3 * H, K0 = p.feat + p.d;
  const int hv = i8 ? 16 : 8, ha = i8 ? 4 : 1;
  const int fv = ff ? 16 : 8, fa = ff ? 4 : 1;
  const int K[ND] = {K0, K0, H, H, d, H, H, d, F, d, F};
  const int N[ND] = {H3, H, H3, H3, H3, H3, F, F, F, F, p.n_out};
  const int V[ND] = {8, 8, hv, fv, 8, hv, fv, 8, fv, 8, 1};
  const int A[ND] = {1, 1, ha, fa, 1, ha, fa, 1, fa, 1, 1};
  const int phase[ND] = {0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4};
  // FC3's one-column tasks take slices down to 8 rows: its 2-byte loads
  // are each an L2 round trip, and a short slice is a short chain.
  int min_rows[ND];
  for (int i = 0; i < ND; ++i) min_rows[i] = V[i] == 1 ? 8 : 32;
  // A dot too short for two slices (the aux blocks) takes one task per
  // column group; where those tasks need at most a quarter of the threads,
  // the phase's other dots split over the threads they leave, so that no
  // thread carries such a task on top of a long slice.
  const int nt = threads(R);
  int small[5] = {0, 0, 0, 0, 0}, spare[5];
  for (int i = 0; i < ND; ++i)
    if (K[i] < 2 * min_rows[i]) small[phase[i]] += N[i] / V[i];
  for (int ph = 0; ph < 5; ++ph)
    spare[ph] = small[ph] <= nt / 4 ? nt - small[ph] : nt;
  long long used = 0, top = 0;
  for (int i = 0; i < ND; ++i) {
    if (i > 0 && phase[i] != phase[i - 1]) used = 0;
    p.sp[i] = dot::split(K[i], N[i] / V[i], spare[phase[i]], A[i], nt,
                         min_rows[i]);
    p.off[i] = (int)used;
    long long n = (long long)p.sp[i].S * N[i] * R;  // partial sums
    if (V[i] == 16) n = (n + 1) / 2;                // int32, two a double
    used += (n + 1) / 2 * 2;                        // 16-byte aligned
    top = used > top ? used : top;
  }
  p.scratch = (int)top;
  const int W = H > F ? H : F;
  return (size_t)(top + (size_t)(p.C + 2 * W) * R) * sizeof(double)
         + (size_t)(3 * H + p.n_out + 1) * R * sizeof(float)
         + (size_t)(2 * (H / 4) + W / 4 + 2 * NQ) * R * sizeof(uint32_t);
}

template <int R, bool I8, bool FF, bool G8, int MASK>
cudaError_t launch(Params p, cudaStream_t stream) {
  const size_t bytes = make_plan(p, R, I8, FF);
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<R, I8, FF, G8, MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int grid = (p.B + R - 1) / R;
  decode_kernel<R, I8, FF, G8, MASK><<<grid, threads(R), bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool I8, bool FF>
cudaError_t launch_rows(const Params& p, int R, cudaStream_t s) {
  switch (R) {
    case 1: return launch<1, I8, FF, false, 0>(p, s);
    case 2: return launch<2, I8, FF, false, 0>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// The ablations the breakdown runs, built for its configuration only:
// int8 recurrent matrices, bf16 feed-forward matrices, the production rows
// per CTA (cuda_decode.ROWS_PER_CTA).
constexpr int ABLATION_R = 1;

cudaError_t launch_ablated(const Params& p, int mask, cudaStream_t s) {
  constexpr int R = ABLATION_R;
  switch (mask) {
    case AB_SAMPLE: return launch<R, true, false, false, AB_SAMPLE>(p, s);
    case AB_GATES: return launch<R, true, false, false, AB_GATES>(p, s);
    case AB_SAMPLE | AB_GATES:
      return launch<R, true, false, false, AB_SAMPLE | AB_GATES>(p, s);
    case AB_COND_READ: return launch<R, true, false, false, AB_COND_READ>(p, s);
    case AB_OUT_WRITE: return launch<R, true, false, false, AB_OUT_WRITE>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int wavernn_decode(const void* const* ptrs, const long long* dims,
                              void* stream) {
  Params p;
  int i = 0;
  p.cond = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  p.w_Im1 = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.u1 = static_cast<const float*>(ptrs[i++]);
  p.w_Im = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.w_x = static_cast<const float*>(ptrs[i++]);
  p.b_I = static_cast<const float*>(ptrs[i++]);
  p.w_hh1 = ptrs[i++];
  p.s_hh1 = static_cast<const float*>(ptrs[i++]);
  p.b1 = static_cast<const float*>(ptrs[i++]);
  p.b_hh1_n = static_cast<const float*>(ptrs[i++]);
  p.w_ih2x = ptrs[i++];
  p.w_hh2 = ptrs[i++];
  p.s_hh2 = static_cast<const float*>(ptrs[i++]);
  p.b2 = static_cast<const float*>(ptrs[i++]);
  p.b_hh2_n = static_cast<const float*>(ptrs[i++]);
  p.w_fc1x = ptrs[i++];
  p.b_fc1 = static_cast<const float*>(ptrs[i++]);
  p.w_fc2x = ptrs[i++];
  p.b_fc2 = static_cast<const float*>(ptrs[i++]);
  p.w_aux = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.w_fc3 = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.b_fc3 = static_cast<const float*>(ptrs[i++]);
  p.fs_ih2 = static_cast<const float*>(ptrs[i++]);
  p.fs_fc1 = static_cast<const float*>(ptrs[i++]);
  p.fs_fc2 = static_cast<const float*>(ptrs[i++]);
  p.ffq = static_cast<const float*>(ptrs[i++]);
  p.s_ih2 = static_cast<const float*>(ptrs[i++]);
  p.s_fc1 = static_cast<const float*>(ptrs[i++]);
  p.s_fc2 = static_cast<const float*>(ptrs[i++]);
  p.B = (int)dims[0]; p.Tc = (int)dims[1]; p.C = (int)dims[2];
  p.T = (int)dims[3]; p.H = (int)dims[4]; p.F = (int)dims[5];
  p.feat = (int)dims[6]; p.d = (int)dims[7]; p.n_out = (int)dims[8];
  p.mode = (int)dims[9]; p.det = (int)dims[10];
  const bool int8_hh = dims[11] != 0;
  const int R = (int)dims[12];
  p.seed = (uint32_t)dims[13];
  const int mask = (int)dims[14];
  const bool int8_ff = dims[15] != 0;
  p.row0 = (uint32_t)dims[16];
  const bool int8_gates = dims[17] != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8_gates) {
    if (int8_hh || int8_ff || R != 1 || mask != 0) return cudaErrorInvalidValue;
    return launch<1, true, true, true, 0>(p, s);
  }
  if (mask != 0) {
    if (!int8_hh || int8_ff || R != ABLATION_R) return cudaErrorInvalidValue;
    return launch_ablated(p, mask, s);
  }
  if (int8_hh)
    return int8_ff ? launch_rows<true, true>(p, R, s)
                   : launch_rows<true, false>(p, R, s);
  return int8_ff ? launch_rows<false, true>(p, R, s)
                 : launch_rows<false, false>(p, R, s);
}

extern "C" const char* wavernn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
