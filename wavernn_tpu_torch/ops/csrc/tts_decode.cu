// Tacotron decoder steps at batch 1, one persistent cooperative kernel for
// Hopper (sm_90a).
//
// Replaces wavernn_tpu/ops/pallas_tts.py::_tts_decode_kernel (launched by
// pallas_tts.tts_decode_chunk).  It computes what that kernel computes, step
// for step (the math is written out in ops/tts_decode.py, whose
// tts_decode_reference is this kernel's plain PyTorch version), not how the
// TPU lays it out: no 128-lane padding, no rolled window matrix, no mel lane
// blocks, any number of steps.
//
// Design.  A step is a chain of ten dependent phases (prenet1, prenet2,
// attention GRU, query projection, location energies, scores + context,
// rnn_input, LSTM1, LSTM2, mel projection).  At batch 1 no phase has a batch
// to spread, so every phase spreads its OUTPUTS over all warps of a grid of a
// few tens of CTAs, one CTA per SM, with a grid barrier between phases.  A
// warp owns one output (one GRU or LSTM unit: its 3 or 4 gate columns) and
// splits the dot's K over its lanes, each lane loading 8 bf16 weights (16
// bytes) at a time from the matrix stored (out, in); the lanes' partial sums
// meet in a shuffle reduction.  Activations pass between phases through a
// small global scratch (read with ld.global.cg, so never from a stale L1);
// each CTA copies a phase's input vector into shared memory first.  The
// sigmoid-normalised scores need a sum over the whole text: every CTA
// computes them all (L sigmoids), so the sum costs no extra barrier, and
// every CTA keeps its own identical copy of the cumulative and previous
// attention.  The location conv, folded with L into one (D, 62) matrix,
// lives in shared memory as float64 for the whole launch.
//
// Arithmetic.  Every dot sums its exact products (bf16 x bf16 fits a double)
// in float64 and rounds the sum once to float32; the order of the terms then
// hardly matters, so this kernel and its plain version agree to the bit
// nearly always and an autoregressive decode can be held to a tight
// tolerance over hundreds of steps.  Gate arithmetic is float32 with one
// rounding per operation (the __f*_rn intrinsics keep nvcc from contracting
// it), in the plain version's order; sigmoid(v) = 0.5 * tanhf(0.5 * v) + 0.5.
//
// What bounds it.  About 5.2 M bf16 weights (10.3 MB at the full-size model)
// are read once per step, spread over the grid, from the 50 MB L2 where they
// stay: 0.2 TB/s at the 48 us per step measured on an H100, far from L2's
// rate, and the float64 arithmetic is as far from its peak.  Latency sets
// the pace: ten grid barriers per step, each a round trip through L2
// atomics, and each phase's short dependent chain (64 CTAs measured best;
// fewer are slower, more no faster).  Fewer phases (redundant small phases
// per CTA), weights resident in shared memory and wgmma are later work.
//
// Entry point (plain C, bound with ctypes):
//   int tts_decode(const void* const* ptrs, const long long* dims,
//                  void* stream)
// ptrs = the packed weights in cuda_tts.WEIGHT_ORDER, then enc_t (D, L),
//        encp (L, D), state_in, state_out, mels, scores, stop, work, bar;
// dims = n_steps, L, D, Dh, H, n_mels, r, ctas.
// Returns a cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int KTAPS = 31;
constexpr int PADT = (KTAPS - 1) / 2;
constexpr int NTAP2 = 2 * KTAPS;

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16 *p1_w, *p2_w, *wih_c, *wih_p, *whh, *M_loc, *W_q, *v;
  const bf16 *ri_c, *ri_h, *l1_ih, *l1_hh, *l2_ih, *l2_hh, *mel_w;
  const float *p1_b, *p2_b, *b_attn, *b_attn_hn, *b_q, *ri_b, *l1_b, *l2_b;
  const float* enc_t;   // (D, L)
  const float* encp;    // (L, D)
  const float* s_in;    // state: prev_mel, h_attn, h1, c1, h2, c2, context, cum, prv
  float* s_out;
  float* mels;          // (n_steps, r * n_mels)
  float* scores;        // (n_steps, L)
  float* stop;          // (n_steps,)
  float* work;          // activations passed between phases
  unsigned* bar;        // grid barrier: arrival count, generation
  int n_steps, L, D, Dh, H, n_mels, r;
};

// float32 arithmetic with one rounding per operation
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sg(float v) {
  return add(mul(0.5f, tanhf(mul(0.5f, v))), 0.5f);
}
__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float f32(double v) { return __double2float_rn(v); }

// Data written by other CTAs during the launch: read it from L2.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

// All CTAs meet; writes before it are visible to reads after it.  The grid
// is co-resident (cooperative launch), so spinning cannot deadlock.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffU, v, o);
  return v;
}

// dst[i] = bf16-rounded src[i] as double, i < n (the whole CTA)
__device__ __forceinline__ void load_op(double* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = (double)bfr(ldcg(src + i));
}

// acc[g] += sum_k w[(row0 + g*gs)*K + k] * op[k] over k < K (K % 8 == 0):
// lanes take 8 consecutive k (one 16-byte load per row) at a time.
template <int G>
__device__ __forceinline__ void wdot(double (&acc)[G], const bf16* __restrict__ w,
                                     int K, int row0, int gs, const double* op,
                                     int lane) {
  for (int k = lane * 8; k < K; k += 256) {
    uint4 raw[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      raw[g] = __ldg(reinterpret_cast<const uint4*>(
          w + (size_t)(row0 + g * gs) * K + k));
    double x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = op[k + e];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[g]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        acc[g] = fma((double)f.x, x[2 * e], acc[g]);
        acc[g] = fma((double)f.y, x[2 * e + 1], acc[g]);
      }
    }
  }
}

template <int G>
__device__ __forceinline__ void wsum(double (&acc)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = warp_sum(acc[g]);
}

__global__ void __launch_bounds__(NT, 1) tts_decode_kernel(Params p) {
  const int L = p.L, D = p.D, Dh = p.Dh, H = p.H, NM = p.n_mels;
  const int RM = p.r * NM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gw = blockIdx.x * NW + warp;          // this warp's grid index
  const int TW = gridDim.x * NW;                  // warps in the grid

  // shared memory: doubles first, then floats
  extern __shared__ __align__(16) double smd[];
  int opn = 2 * D + Dh;
  if (2 * H > opn) opn = 2 * H;
  if (NM > opn) opn = NM;
  double* op = smd;                     // [opn] a phase's input operand
  double* Ms = op + opn;                // [62][D] folded location conv
  double* win = Ms + NTAP2 * D;         // [NW][62] per-warp conv window
  double* red = win + NW * NTAP2;       // [NW] block reduction
  float* cum = reinterpret_cast<float*>(red + NW);  // [L]
  float* prv = cum + L;                 // [L]
  float* sc = prv + L;                  // [L] this step's scores
  float* pq = sc + L;                   // [D] query projection

  // global scratch
  float* w_prev = p.work;               // [NM]
  float* w_p1 = w_prev + NM;            // [D]
  float* w_p2 = w_p1 + D;               // [Dh]
  float* w_ha = w_p2 + Dh;              // [2][D]
  float* w_pq = w_ha + 2 * D;           // [D]
  float* w_u = w_pq + D;                // [L]
  float* w_ctx = w_u + L;               // [D]
  float* w_x = w_ctx + D;               // [H]
  float* w_h1 = w_x + H;                // [2][H]
  float* w_c1 = w_h1 + 2 * H;           // [2][H]
  float* w_x1 = w_c1 + 2 * H;           // [H]
  float* w_h2 = w_x1 + H;               // [2][H]
  float* w_c2 = w_h2 + 2 * H;           // [2][H]
  float* w_x2 = w_c2 + 2 * H;           // [H]

  // the state coming in
  const float* s_prev = p.s_in;
  const float* s_ha = s_prev + NM;
  const float* s_h1 = s_ha + D;
  const float* s_c1 = s_h1 + H;
  const float* s_h2 = s_c1 + H;
  const float* s_c2 = s_h2 + H;
  const float* s_ctx = s_c2 + H;
  const float* s_cum = s_ctx + D;
  const float* s_prv = s_cum + L;

  for (int i = tid; i < NTAP2 * D; i += NT) {     // Ms[t][d] = M_loc[d][t]
    const int t = i / D, d = i % D;
    Ms[i] = (double)__bfloat162float(p.M_loc[(size_t)d * NTAP2 + t]);
  }
  for (int i = tid; i < L; i += NT) { cum[i] = s_cum[i]; prv[i] = s_prv[i]; }
  __syncthreads();

  for (int step = 0; step < p.n_steps; ++step) {
    const int a = step & 1, b = a ^ 1;
    const bool first = step == 0;
    const float* prev_cur = first ? s_prev : w_prev;
    const float* ctx_cur = first ? s_ctx : w_ctx;
    const float* ha_cur = first ? s_ha : w_ha + b * D;
    const float* h1_cur = first ? s_h1 : w_h1 + b * H;
    const float* c1_cur = first ? s_c1 : w_c1 + b * H;
    const float* h2_cur = first ? s_h2 : w_h2 + b * H;
    const float* c2_cur = first ? s_c2 : w_c2 + b * H;
    float* ha_nxt = w_ha + a * D;
    float* h1_nxt = w_h1 + a * H;
    float* c1_nxt = w_c1 + a * H;
    float* h2_nxt = w_h2 + a * H;
    float* c2_nxt = w_c2 + a * H;

    // the previous step's stop value: max over its r mel frames
    if (!first && blockIdx.x == 0 && warp == NW - 1) {
      float m = -CUDART_INF_F;
      for (int k = lane; k < RM; k += 32)
        m = fmaxf(m, ldcg(p.mels + (size_t)(step - 1) * RM + k));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffU, m, o));
      if (lane == 0) p.stop[step - 1] = m;
    }

    // 1. prenet fc1 on the previous mel frame
    load_op(op, prev_cur, NM);
    __syncthreads();
    for (int j = gw; j < D; j += TW) {
      double acc[1] = {0.0};
      wdot<1>(acc, p.p1_w, NM, j, 0, op, lane);
      wsum(acc);
      if (lane == 0) __stcg(w_p1 + j, fmaxf(add(f32(acc[0]), p.p1_b[j]), 0.f));
    }
    grid_sync(p.bar);

    // 2. prenet fc2
    load_op(op, w_p1, D);
    __syncthreads();
    for (int j = gw; j < Dh; j += TW) {
      double acc[1] = {0.0};
      wdot<1>(acc, p.p2_w, D, j, 0, op, lane);
      wsum(acc);
      if (lane == 0) __stcg(w_p2 + j, fmaxf(add(f32(acc[0]), p.p2_b[j]), 0.f));
    }
    grid_sync(p.bar);

    // 3. attention GRU: gi = [context | p2] @ wih, gh = h_attn @ whh
    load_op(op, ctx_cur, D);
    load_op(op + D, w_p2, Dh);
    load_op(op + D + Dh, ha_cur, D);
    __syncthreads();
    for (int j = gw; j < D; j += TW) {
      double gi[3] = {0.0, 0.0, 0.0}, gh[3] = {0.0, 0.0, 0.0};
      wdot<3>(gi, p.wih_c, D, j, D, op, lane);
      wdot<3>(gi, p.wih_p, Dh, j, D, op + D, lane);
      wdot<3>(gh, p.whh, D, j, D, op + D + Dh, lane);
      wsum(gi);
      wsum(gh);
      if (lane == 0) {
        float fi[3], fh[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          fi[g] = add(f32(gi[g]), p.b_attn[g * D + j]);
          fh[g] = f32(gh[g]);
        }
        const float rg = sg(add(fi[0], fh[0]));
        const float zg = sg(add(fi[1], fh[1]));
        const float ng = tanhf(add(fi[2], mul(rg, add(fh[2], p.b_attn_hn[j]))));
        __stcg(ha_nxt + j, add(mul(sub(1.0f, zg), ng), mul(zg, ldcg(ha_cur + j))));
      }
    }
    grid_sync(p.bar);

    // 4. query projection pq = h_attn @ W
    load_op(op, ha_nxt, D);
    __syncthreads();
    for (int j = gw; j < D; j += TW) {
      double acc[1] = {0.0};
      wdot<1>(acc, p.W_q, D, j, 0, op, lane);
      wsum(acc);
      if (lane == 0) __stcg(w_pq + j, f32(acc[0]));
    }
    grid_sync(p.bar);

    // 5. location energies u[l] = v . tanh(((ploc + encp) + pq) + b_q)
    for (int i = tid; i < D; i += NT) pq[i] = ldcg(w_pq + i);
    __syncthreads();
    double* wv = win + warp * NTAP2;
    for (int l = gw; l < L; l += TW) {
      for (int t = lane; t < NTAP2; t += 32) {
        const int src = l + (t < KTAPS ? t : t - KTAPS) - PADT;
        const float* row = t < KTAPS ? cum : prv;
        wv[t] = (src >= 0 && src < L) ? (double)bfr(row[src]) : 0.0;
      }
      __syncwarp();
      double uacc = 0.0;
      for (int d = lane; d < D; d += 32) {
        double s = 0.0;
#pragma unroll 2
        for (int t = 0; t < NTAP2; ++t) s = fma(Ms[t * D + d], wv[t], s);
        const float targ = tanhf(add(add(add(f32(s), __ldg(p.encp + (size_t)l * D + d)),
                                         pq[d]), p.b_q[d]));
        uacc = fma((double)__bfloat162float(p.v[d]), (double)bfr(targ), uacc);
      }
      uacc = warp_sum(uacc);
      if (lane == 0) __stcg(w_u + l, f32(uacc));
      __syncwarp();
    }
    grid_sync(p.bar);

    // 6. scores in every CTA (the sum is over all of L), then the context
    double part = 0.0;
    for (int l = tid; l < L; l += NT) {
      const float s = sg(ldcg(w_u + l));
      sc[l] = s;
      part += (double)s;
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    double tot = 0.0;
    for (int w = 0; w < NW; ++w) tot += red[w];
    const float total = f32(tot);
    for (int l = tid; l < L; l += NT) {
      const float s = __fdiv_rn(sc[l], total);
      sc[l] = s;
      cum[l] = add(cum[l], s);
      prv[l] = s;
      if (blockIdx.x == 0) p.scores[(size_t)step * L + l] = s;
    }
    __syncthreads();
    for (int d = gw; d < D; d += TW) {
      double acc = 0.0;
      const float* e = p.enc_t + (size_t)d * L;
      for (int l = lane; l < L; l += 32)
        acc = fma((double)bfr(sc[l]), (double)bfr(__ldg(e + l)), acc);
      acc = warp_sum(acc);
      if (lane == 0) __stcg(w_ctx + d, f32(acc));
    }
    grid_sync(p.bar);

    // 7. rnn_input: x = [context | h_attn] @ ri + ri_b
    load_op(op, w_ctx, D);
    load_op(op + D, ha_nxt, D);
    __syncthreads();
    for (int j = gw; j < H; j += TW) {
      double acc[1] = {0.0};
      wdot<1>(acc, p.ri_c, D, j, 0, op, lane);
      wdot<1>(acc, p.ri_h, D, j, 0, op + D, lane);
      wsum(acc);
      if (lane == 0) __stcg(w_x + j, add(f32(acc[0]), p.ri_b[j]));
    }
    grid_sync(p.bar);

    // 8./9. the residual LSTMs
    for (int layer = 0; layer < 2; ++layer) {
      const float* xin = layer ? w_x1 : w_x;
      const float* hc = layer ? h2_cur : h1_cur;
      const float* cc = layer ? c2_cur : c1_cur;
      float* hn = layer ? h2_nxt : h1_nxt;
      float* cn = layer ? c2_nxt : c1_nxt;
      float* xo = layer ? w_x2 : w_x1;
      const bf16* w_ih = layer ? p.l2_ih : p.l1_ih;
      const bf16* w_hh = layer ? p.l2_hh : p.l1_hh;
      const float* bias = layer ? p.l2_b : p.l1_b;
      load_op(op, xin, H);
      load_op(op + H, hc, H);
      __syncthreads();
      for (int j = gw; j < H; j += TW) {
        double g4[4] = {0.0, 0.0, 0.0, 0.0};
        wdot<4>(g4, w_ih, H, j, H, op, lane);
        wdot<4>(g4, w_hh, H, j, H, op + H, lane);
        wsum(g4);
        if (lane == 0) {
          float gv[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) gv[g] = add(f32(g4[g]), bias[g * H + j]);
          const float ig = sg(gv[0]), fg = sg(gv[1]);
          const float gg = tanhf(gv[2]), og = sg(gv[3]);
          const float c = add(mul(fg, ldcg(cc + j)), mul(ig, gg));
          const float h = mul(og, tanhf(c));
          __stcg(cn + j, c);
          __stcg(hn + j, h);
          __stcg(xo + j, add(ldcg(xin + j), h));
        }
      }
      grid_sync(p.bar);
    }

    // 10. mel projection: r frames; the last one feeds the next step
    load_op(op, w_x2, H);
    __syncthreads();
    for (int m = gw; m < RM; m += TW) {
      double acc[1] = {0.0};
      wdot<1>(acc, p.mel_w, H, m, 0, op, lane);
      wsum(acc);
      if (lane == 0) {
        const float v = f32(acc[0]);
        __stcg(p.mels + (size_t)step * RM + m, v);
        if (m >= RM - NM) __stcg(w_prev + (m - (RM - NM)), v);
      }
    }
    grid_sync(p.bar);
  }

  // the last step's stop value and the state going out
  if (blockIdx.x == 0) {
    const int n = p.n_steps, last = (n - 1) & 1;
    if (warp == 0) {
      float m = -CUDART_INF_F;
      for (int k = lane; k < RM; k += 32)
        m = fmaxf(m, ldcg(p.mels + (size_t)(n - 1) * RM + k));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffU, m, o));
      if (lane == 0) p.stop[n - 1] = m;
    }
    float* o = p.s_out;
    for (int i = tid; i < NM; i += NT) o[i] = ldcg(w_prev + i);
    o += NM;
    for (int i = tid; i < D; i += NT) o[i] = ldcg(w_ha + last * D + i);
    o += D;
    for (int i = tid; i < H; i += NT) {
      o[i] = ldcg(w_h1 + last * H + i);
      o[H + i] = ldcg(w_c1 + last * H + i);
      o[2 * H + i] = ldcg(w_h2 + last * H + i);
      o[3 * H + i] = ldcg(w_c2 + last * H + i);
    }
    o += 4 * H;
    for (int i = tid; i < D; i += NT) o[i] = ldcg(w_ctx + i);
    o += D;
    for (int i = tid; i < L; i += NT) { o[i] = cum[i]; o[L + i] = prv[i]; }
  }
}

// Dynamic shared memory of one CTA (the layout at the kernel's top).
size_t smem_bytes(long long L, long long D, long long Dh, long long H,
                  long long n_mels) {
  long long opn = 2 * D + Dh;
  if (2 * H > opn) opn = 2 * H;
  if (n_mels > opn) opn = n_mels;
  return sizeof(double) * (opn + NTAP2 * D + NW * NTAP2 + NW) +
         sizeof(float) * (3 * L + D);
}

}  // namespace

extern "C" int tts_decode(const void* const* ptrs, const long long* dims,
                          void* stream) {
  Params p;
  int i = 0;
  auto bw = [&]() { return static_cast<const bf16*>(ptrs[i++]); };
  auto fw = [&]() { return static_cast<const float*>(ptrs[i++]); };
  p.p1_w = bw(); p.p1_b = fw(); p.p2_w = bw(); p.p2_b = fw();
  p.wih_c = bw(); p.wih_p = bw(); p.whh = bw();
  p.b_attn = fw(); p.b_attn_hn = fw();
  p.M_loc = bw(); p.W_q = bw(); p.b_q = fw(); p.v = bw();
  p.ri_c = bw(); p.ri_h = bw(); p.ri_b = fw();
  p.l1_ih = bw(); p.l1_hh = bw(); p.l1_b = fw();
  p.l2_ih = bw(); p.l2_hh = bw(); p.l2_b = fw();
  p.mel_w = bw();
  p.enc_t = fw(); p.encp = fw(); p.s_in = fw();
  p.s_out = const_cast<float*>(fw());
  p.mels = const_cast<float*>(fw());
  p.scores = const_cast<float*>(fw());
  p.stop = const_cast<float*>(fw());
  p.work = const_cast<float*>(fw());
  p.bar = static_cast<unsigned*>(const_cast<void*>(ptrs[i++]));
  p.n_steps = (int)dims[0]; p.L = (int)dims[1]; p.D = (int)dims[2];
  p.Dh = (int)dims[3]; p.H = (int)dims[4]; p.n_mels = (int)dims[5];
  p.r = (int)dims[6];
  const int ctas = (int)dims[7];

  const size_t bytes = smem_bytes(p.L, p.D, p.Dh, p.H, p.n_mels);
  cudaError_t e = cudaFuncSetAttribute(
      tts_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)tts_decode_kernel, dim3(ctas),
                                  dim3(NT), args, bytes,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" int tts_decode_max_ctas(int* out, long long L, long long D,
                                   long long Dh, long long H,
                                   long long n_mels) {
  const size_t bytes = smem_bytes(L, D, Dh, H, n_mels);
  cudaError_t e = cudaFuncSetAttribute(
      tts_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tts_decode_kernel,
                                                    NT, bytes);
  if (e != cudaSuccess) return e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}
