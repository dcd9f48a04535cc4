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
// to spread, so each phase spreads its OUTPUTS over a grid of one CTA per SM
// (every SM that fits).  Each CTA owns a fixed contiguous range of every
// phase's output units (a prenet, query, rnn_input or mel row; a GRU unit's
// 3 + 3 rows; an LSTM unit's 4 rows), of the text positions (energies) and
// of the context columns: the plan is ops/cuda_tts.py::tts_smem_plan, and
// layout() below computes the same bytes.  At launch the CTA copies the bf16
// weight rows of its units into shared memory, where they stay for all
// steps (~80 KB at full width on 132 CTAs), with the folded location conv
// (bf16 tap pairs), its text positions' encp rows and its context columns
// of the encoder output: no per-step dot reads a weight from global memory.
// Inside a CTA a unit's rows go to a group of 8 / units warps, each thread
// taking 16-byte chunks of 8 columns; the phase's operand is held
// chunk-major in shared memory, so a warp's loads of weights and operand are
// free of bank conflicts.
//
// The cumulative and previous attention: a CTA keeps them only for its
// conv window, its text positions and PADT either side (zero outside the
// text), in shared memory, beside the same window staged as the conv's
// operand; phase 6 updates the window, and each position's owner writes
// it out at the end.  Two placements of what grows with the text (GLOB,
// the plan's "placement").  Shared: the context columns, the CTA's copy of
// the scores, and its text positions' pe (= ploc + encp) and encp rows sit
// in shared memory beside the weights (~35.5 bytes a symbol at full width
// on 132 CTAs; up to 2,918 symbols, 3,828 with I8L: cuda_tts.
// shared_text_limit).  Global, for a text past that: the weights,
// operands, partials, conv taps and windows stay in shared memory and
// those L-sized regions move out.  The context columns and the encp rows
// are read from enc_t and encp themselves (the column rounded to bf16 at
// use, the value the shared copy holds); the scores go to this CTA's
// slice of a global workspace, and pe to the CTA's own rows of an (L, D)
// array there.  Ownership, phase order and every sum's order are the same
// in both, so both give the same bits.
//
// Between phases, no barrier: a value that crosses CTAs is written together
// with its step (tag) in one 64-bit word, and a reader polls the words it
// needs until each carries the step it waits for (fetch()); the words of a
// phase's operand are loaded together, so a phase waits for its slowest
// producer's store plus about one round trip through L2.  Activations sit
// in two slots that alternate by step; one grid barrier per step (a counter
// that only grows: red.release.gpu by each CTA, a spin of ld.acquire.gpu)
// keeps a CTA from writing a slot another may still read.  State that only
// its owner needs (the attention GRU's h, the LSTM cells) stays in shared
// memory.  Every spin is bounded: a launch whose inputs never come traps.
//
// The work that grows with the text runs over all of a CTA's positions at
// once, with no block barrier per position.  The location conv is off the
// critical path: ploc[l, :] depends only on the cumulative and previous
// attention, final after phase 6, so a CTA computes it for its own text
// positions, a thread a column d, 8 positions at a time as independent
// float64 sums (a position's 31 cum taps in order plus its 31 prv taps in
// order; each tap loaded once for the 8), in one function that is not
// inlined (conv_rows), spread over NWIN phase ends (those of phases 6-9,
// whose hand-overs hide it best, take up to SLOT_MIN positions each
// first; the rest also goes to the ends of the next step's phases 1-4),
// while the next input is on its way, and writes pe = f32(ploc) + encp.
// Phase 5 adds the query and the bias, takes tanh and reduces the v-dot:
// from NW positions a CTA on a warp takes a position (energy_rows), below
// that the CTA takes one position at a time.  Phase 6 normalises all L
// scores in every CTA, updates the CTA's window and writes out its own
// positions' scores; its context splits a column's L over up to NW / nd
// warps (ctx_split) and adds their sums in order.  Code that only long
// texts run stays out of the step's loop (the instruction cache holds
// little more than the loop), and a text of a position or none a CTA (the
// main path's) runs one inline conv block.  The float32 -> float64
// conversions of the energies and the context are bf_scaled against an
// act-scaled operand (v, the context columns), as in the dots.
//
// Arithmetic.  Every dot sums its exact products (bf16 x bf16 fits a double)
// in float64 and rounds the sum once to float32, in one fixed order per
// output (a thread's chunks in order, the warp's shuffle tree, the group's
// warps in order), so this kernel and its plain version agree to the bit
// nearly always and an autoregressive decode can be held to a tight
// tolerance over hundreds of steps.  A weight (or a conv tap) becomes a
// double by two integer ops against an operand held as a * 2^896
// (dot.cuh's bf_scaled), not by a conversion on the float64 pipe.  Gate
// arithmetic is float32 with one rounding per operation (the __f*_rn
// intrinsics keep nvcc from contracting it), in the plain version's order;
// sigmoid(v) = 0.5 * tanhf(0.5 * v) + 0.5.
//
// I8L (the TPU kernel's ``int8_lstm``): the LSTM units' rows are int8 in
// shared memory, with their per-row scales (4 + 4 floats a unit), half the
// bytes of bf16.  Each CTA quantizes the LSTM operands x and h itself at sa
// = max(max|v|, 1e-8) * (1/127) (a maximum does not depend on order, so
// every CTA takes the same one), round(v / sa) by a true division, half to
// even (or by the reciprocal where that gives the same integer,
// dot::quant_byte_rcp), and sums each half of a row with __dp4a: exact
// integers, so the order of the terms does not matter.  The gate is
// (f32(sum_x) * (sa_x * s_ih) + f32(sum_h) * (sa_h * s_hh)) + b, the plain
// version's order, and the variant equals its plain version bit for bit.
// The two halves run at different times.  The h half needs h1 and h2 of
// the step before, final once that step's grid barrier has passed: the
// cells store them as plain float32 in the tagged h slots (Acts::h1f and
// h2f), phase 2 loads both whole in
// the round trip of its own operand, and hh_dot() computes both layers' h
// products once phase 2's outputs are out, off the LSTM phases.  An LSTM
// phase fetches x alone: each thread keeps a running max|x| as its words
// come, each warp's maximum rides on the fetch's closing block barrier,
// and a warp takes a unit whole, each lane quantizing in registers the
// 16-value chunk it dots and lanes 0-3 taking a gate each.  Two block
// barriers from the fetch to the cell, no pass of its own for the maximum
// or the quantization.
//
// What bounds it.  About 5.2 M bf16 weights (10.35 MB at the full-size
// model) per step, spread over the grid's shared memory: a few hundred
// cycles of float64 FMAs and integer ops per CTA and phase.  The bound of a
// 48-step launch is its 10.35 MB read once (3.1 us at 3.35 TB/s).  Latency
// sets the pace: per phase, the hand-over of its inputs through L2 (~1.7-2.7
// us a phase on an H100, PERF.md, from the spans of tts_decode_spans), and
// the step's barrier (~1 us bare, tts_barrier_loop).  A long text adds, a
// step and CTA, its positions' conv (256 x 62 float64 FMAs a position,
// ~0.14 us of an SM's float64 pipe) and tanh, and passes over all L
// scores; past ~10,000 symbols the enc_t, encp and pe bytes of a step
// outgrow the L2 cache.
//
// Entry points (plain C, bound with ctypes):
//   int tts_decode(const void* const* ptrs, const long long* dims,
//                  void* stream)
// ptrs = the packed weights in cuda_tts.WEIGHT_ORDER, then enc_t (D, L),
//        encp (L, D), state_in, state_out, mels, scores, stop, work, bar;
//        ws (the global placement's workspace, else null);
// dims = n_steps, L, D, Dh, H, n_mels, r, ctas, int8_lstm (the LSTM
//        matrices int8, then their four scale vectors after the pointers),
//        global (1: the global placement).
// work is the tagged activations (zeroed), bar the step barrier's counter
// (zeroed); ws needs no zeroing.  Returns a cudaError_t (0 = launched).
// Beside it: tts_decode_smem_bytes and tts_decode_workspace_bytes (the
// layout's shared and global bytes for dims), tts_decode_max_ctas
// (co-resident CTAs for a layout, variant and placement), and, dev only,
// tts_decode_spans (every variant and placement; one more pointer after
// ws: n_steps x 10 uint64 stamps) and tts_barrier_loop (bare barriers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dot.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int KTAPS = 31;
constexpr int PADT = (KTAPS - 1) / 2;
constexpr int NTAP2 = 2 * KTAPS;
constexpr int MAXG = 6;      // the most sums of one unit (the GRU's 3 + 3)
constexpr int NPHASE = 10;   // phases of a step
constexpr int NWIN = 8;      // phase ends that hold the location conv
constexpr int SLOT_MIN = 12;  // positions the conv slots of phases 6-9 take first
constexpr int CTX_MIN = 256; // the fewest positions a warp takes of a context column
constexpr int KE = 8;        // energy columns a thread keeps in registers
constexpr long long SPIN_LIMIT = 1LL << 24;  // polls before a launch traps

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
  unsigned long long* work;  // tagged activations passed between CTAs
  unsigned* bar;        // the grid barrier's arrival counter
  float* ws;            // GLOB: the workspace (ws_floats)
  unsigned long long* spans;  // SPANS: %globaltimer at each phase's end
  // I8L: the four LSTM matrices' per-row scales, (4H,) each
  const float *l1_ih_s, *l1_hh_s, *l2_ih_s, *l2_hh_s;
  int n_steps, L, D, Dh, H, n_mels, r;
};

// ---- the shared-memory plan (cuda_tts.tts_smem_plan computes the same) ----

__host__ __device__ inline int most(int n, int g) { return (n + g - 1) / g; }
__host__ __device__ inline int own0(int n, int i, int g) {
  return (int)((long long)i * n / g);
}
__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t o = at;
  at += (bytes + 15) / 16 * 16;
  return o;
}

// Weight regions, in order: prenet1, prenet2, attention GRU, query,
// rnn_input, LSTM1, LSTM2, mel.
enum { WP1, WP2, WG, WQ, WRI, WL1, WL2, WMEL, NWREG };

struct Layout {
  size_t op, encd, part, win, opf, cum, prv, sc, pe, encp, own, hh, ms;
  size_t w[NWREG];
  size_t total;
};

// With i8l the LSTM regions hold each unit's 4 rows of 2H int8 weights and
// then its 8 float scales (ih gates, hh gates), and hh the warps' maxima of
// the LSTM operands (2 a warp) and the h half of both LSTMs' gates for the
// step (2 layers x 4 gates a unit, float32); the operand region also
// holds h1 and h2 as float32 at its end in phase 2.
// cum and prv are the CTA's conv window's alone (its positions and PADT
// either side; win holds them staged as the conv's operand), in both
// placements.  With glob the L-sized regions take no shared memory (they
// are in the workspace, ws_floats).
__host__ __device__ inline Layout layout(int L, int D, int Dh, int H, int NM,
                                         int r, int G, bool i8l, bool glob) {
  Layout y;
  size_t at = 0;
  int op_n = 2 * D + Dh;
  if (2 * H > op_n) op_n = 2 * H;
  if (NM > op_n) op_n = NM;
  if (i8l && D + H > op_n) op_n = D + H;   // I8L: phase 2's [p1 | h1 | h2]
  const size_t nd = most(D, G), nh = most(H, G);
  const size_t nw = most(L, G) + 2 * PADT;   // a conv window
  const size_t Ls = glob ? 0 : (size_t)L, nl = glob ? 0 : most(L, G);
  y.op = take(at, 8 * (size_t)op_n);
  y.encd = take(at, 8 * nd * Ls);
  y.part = take(at, 8 * NW * MAXG);
  y.win = take(at, 8 * 2 * nw);
  y.opf = take(at, 4 * (size_t)op_n);
  y.cum = take(at, 4 * nw);
  y.prv = take(at, 4 * nw);
  y.sc = take(at, 4 * Ls);
  y.pe = take(at, 4 * nl * D);
  y.encp = take(at, 4 * nl * D);
  y.own = take(at, 4 * (nd + 2 * nh));
  y.hh = take(at, i8l ? 4 * (2 * NW + 8 * nh) : 0);
  y.ms = take(at, 4 * (size_t)KTAPS * D);
  const size_t units[NWREG] = {nd, (size_t)most(Dh, G), nd, nd, nh, nh, nh,
                               (size_t)most(r * NM, G)};
  const size_t row[NWREG] = {(size_t)NM, (size_t)D,
                             (size_t)(3 * (D + Dh) + 3 * D), (size_t)D,
                             (size_t)(2 * D), (size_t)(8 * H), (size_t)(8 * H),
                             (size_t)H};
  for (int k = 0; k < NWREG; ++k) {
    const bool lstm = k == WL1 || k == WL2;
    y.w[k] = take(at, lstm && i8l ? units[k] * (row[k] + 8 * sizeof(float))
                                  : 2 * units[k] * row[k]);
  }
  y.total = at;
  return y;
}

// The global placement's workspace, in floats: each CTA's slice of the
// scores (ws_stride(L) floats), then pe (L, D), whose rows each CTA writes
// for its own text positions.
__host__ __device__ inline size_t ws_stride(int L) { return ((size_t)L + 3) / 4 * 4; }
__host__ __device__ inline size_t ws_floats(int L, int D, int G) {
  return ws_stride(L) * G + (size_t)L * D;
}

// Warps that share a context column of nd: the most (a power of two, so
// that NW / S groups of S warps tile the CTA) that leaves each warp at
// least CTX_MIN of the L positions; 1 keeps a warp a column.
__device__ __forceinline__ int ctx_split(int L, int nd) {
  int S = 1;
  while (nd > 0 && 2 * S * nd <= NW && 2 * S * CTX_MIN <= L) S *= 2;
  return S;
}

// ---- arithmetic ----

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

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffU, v, o);
  return v;
}

// ---- grid barriers ----

// The counter barrier: one release-add per CTA on a counter that only
// grows, then a spin of acquire loads until it reaches ``target``.
__device__ __forceinline__ void arrive(unsigned* bar) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
}
__device__ __forceinline__ void wait_for(const unsigned* bar, unsigned target) {
  unsigned v;
  for (long long spin = 0;; ++spin) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(bar) : "memory");
    if ((int)(v - target) >= 0) return;
    if (spin > SPIN_LIMIT) __trap();
  }
}

// The earlier barrier (an arrival count reset by the last CTA, a generation
// word every CTA spins on), kept as the bare-barrier loop's yardstick.
__device__ __forceinline__ void generation_sync(unsigned* bar) {
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

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---- tagged activations ----

// A value that crosses CTAs travels with the step that wrote it: one 64-bit
// word, the float's bits low and the tag (step + 2; 1 for the state coming
// in, 0 never written) high, stored and loaded whole at gpu scope, so a
// reader that sees the tag it waits for holds that step's value and needs no
// barrier or fence.
__device__ __forceinline__ void put(unsigned long long* p, float v,
                                    unsigned tag) {
  const unsigned long long w =
      ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// Values k = tid, tid + NT, ... < n of a phase's input, four a pass: a
// thread loads its four words, then loads again the ones whose tag is not
// yet the one src(k, word, tag) names until it is, and hands each value to
// use(k, v).  A launch whose inputs never come traps.
template <class Src, class Use>
__device__ __forceinline__ void fetch(int n, Src src, Use use) {
  for (int base = 0; base < n; base += 4 * NT) {
    const unsigned long long* a[4];
    unsigned want[4];
    unsigned long long w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = base + j * NT + (int)threadIdx.x;
      a[j] = nullptr;
      want[j] = 0;
      w[j] = 0;
      if (k < n) {
        src(k, a[j], want[j]);
        w[j] = peek(a[j]);
      }
    }
    for (long long spin = 0;; ++spin) {
      bool ready = true;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (a[j] && (unsigned)(w[j] >> 32) != want[j]) {
          ready = false;
          w[j] = peek(a[j]);
        }
      if (ready) break;
      if (spin > SPIN_LIMIT) __trap();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (a[j]) use(base + j * NT + (int)threadIdx.x, __uint_as_float((unsigned)w[j]));
  }
}

// ---- the dots ----

// acc[OFF + g] += row g of w (K columns, rows K apart) . the operand's
// chunks [c0, c0 + K / 8), over this thread's chunks t, t + TT, ...; opT
// holds the operand chunk-major: element 8c + e at opT[e * NC + c].
template <int G, int OFF, int N>
__device__ __forceinline__ void seg_dot(double (&acc)[N], const bf16* w, int K,
                                        int c0, const double* opT, int NC,
                                        int t, int TT) {
  const int nc = K / 8;
  for (int c = t; c < nc; c += TT) {
    double x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = opT[e * NC + c0 + c];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint4 q = *reinterpret_cast<const uint4*>(w + (size_t)g * K + c * 8);
      double a = acc[OFF + g];
      a = fma(x[0], dot::lo_bf(q.x), a);
      a = fma(x[1], dot::hi_bf(q.x), a);
      a = fma(x[2], dot::lo_bf(q.y), a);
      a = fma(x[3], dot::hi_bf(q.y), a);
      a = fma(x[4], dot::lo_bf(q.z), a);
      a = fma(x[5], dot::hi_bf(q.z), a);
      a = fma(x[6], dot::lo_bf(q.w), a);
      a = fma(x[7], dot::hi_bf(q.w), a);
      acc[OFF + g] = a;
    }
  }
}

// The nu units a CTA owns in a phase: unit u has GA rows over the operand's
// KA columns from chunk cA (at wA + u * GA * KA) and GB rows over KB columns
// from chunk cB (at wB + u * GB * KB).  A group of S = 8 / nu warps (one if
// nu >= 8) takes a unit; epi(u, sums) gets its GA + GB float64 sums, each
// added in a fixed order: a thread's chunks, the warp's shuffle tree, the
// group's warps in order.
template <int GA, int GB, class Epi>
__device__ __forceinline__ void units(int nu, const bf16* wA, int KA, int cA,
                                      const bf16* wB, int KB, int cB,
                                      const double* opT, int NC, double* part,
                                      Epi epi) {
  constexpr int G = GA + GB;
  if (nu <= 0) return;
  const int S = nu >= NW ? 1 : NW / nu;
  const int groups = NW / S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, s = warp % S;
  for (int u = warp / S; u < nu; u += groups) {
    double acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0;
    seg_dot<GA, 0>(acc, wA + (size_t)u * GA * KA, KA, cA, opT, NC,
                   s * 32 + lane, S * 32);
    if constexpr (GB > 0)
      seg_dot<GB, GA>(acc, wB + (size_t)u * GB * KB, KB, cB, opT, NC,
                      s * 32 + lane, S * 32);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = warp_sum(acc[g]);
    if (S == 1) {
      if (lane == 0) epi(u, acc);
    } else if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) part[(u * S + s) * G + g] = acc[g];
    }
  }
  if (S > 1) {
    __syncthreads();
    const int u = threadIdx.x;
    if (u < nu) {
      double sum[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sum[g] = 0.0;
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) sum[g] += part[(u * S + i) * G + g];
      epi(u, sum);
    }
  }
}

// Copy the rows of nu units from global into shared memory: unit u's row g
// is [a row | b row] (KA + KB bf16), source row g * N + u0 + u (the packed
// matrices stack their gates).
__device__ __forceinline__ void copy_units(bf16* dst, const bf16* a, int KA,
                                           const bf16* b, int KB, int u0,
                                           int nu, int G, int N) {
  const int cpr = (KA + KB) / 8;
  const int total = nu * G * cpr;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int row = i / cpr, k = (i % cpr) * 8;
    const size_t src = (size_t)(row % G) * N + u0 + row / G;
    const bf16* p = k < KA ? a + src * KA + k : b + src * KB + (k - KA);
    reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// I8L: the 16 values at v (16-byte aligned) quantized at sa (rs its
// reciprocal), packed as an int8 row's 16-byte chunk holds its columns:
// by the reciprocal, and by quant_byte's division where one of them lies
// near a tie (quant_byte_rcp), so the common path has no branch.
__device__ __forceinline__ uint4 quant16(const float* v, float sa, float rs) {
  float4 f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = reinterpret_cast<const float4*>(v)[j];
  uint32_t q[4];
  bool tie = false;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = dot::quant_byte_rcp(f[j].x, rs, tie) |
           dot::quant_byte_rcp(f[j].y, rs, tie) << 8 |
           dot::quant_byte_rcp(f[j].z, rs, tie) << 16 |
           dot::quant_byte_rcp(f[j].w, rs, tie) << 24;
  if (tie) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = dot::quant_byte(f[j].x, sa) | dot::quant_byte(f[j].y, sa) << 8 |
             dot::quant_byte(f[j].z, sa) << 16 |
             dot::quant_byte(f[j].w, sa) << 24;
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// I8L: acc[g] += the int8 dot of row g of w (rows ldw bytes apart) with
// the operand chunk a, over 16-byte chunk c of the rows.
template <int G>
__device__ __forceinline__ void dot16(int (&acc)[G], const int8_t* w, int ldw,
                                      int c, uint4 a) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 q = reinterpret_cast<const uint4*>(w + (size_t)g * ldw)[c];
    int v = acc[g];
    v = __dp4a((int)q.x, (int)a.x, v);
    v = __dp4a((int)q.y, (int)a.y, v);
    v = __dp4a((int)q.z, (int)a.z, v);
    v = __dp4a((int)q.w, (int)a.w, v);
    acc[g] = v;
  }
}

// I8L: one warp's dot of a unit's 4 rows (ldw bytes apart from w) with the
// H values at v quantized at sa (rs its reciprocal), lane l taking chunks
// l, l + 32, ...: the exact int32 sums, in every lane.
__device__ __forceinline__ void unit_i8(int (&acc)[4], const int8_t* w,
                                        int ldw, const float* v, int H,
                                        float sa, float rs, int lane) {
#pragma unroll
  for (int g = 0; g < 4; ++g) acc[g] = 0;
  for (int c = lane; c < H / 16; c += 32)
    dot16<4>(acc, w, ldw, c, quant16(v + 16 * c, sa, rs));
#pragma unroll
  for (int g = 0; g < 4; ++g) acc[g] = __reduce_add_sync(0xffffffffU, acc[g]);
}

// acc[j] += tap k of the staged window x (one of cum's or prv's, index
// 0 at the position PADT before the CTA's first) times position j0 + j's
// value, k = 0 .. 30 in order, for one column of ms (its 31 taps, D
// apart): every tap loaded once for the B positions.
template <int B>
__device__ __forceinline__ void conv_taps(double (&acc)[B], const double* x,
                                          const uint16_t* w, int D) {
#pragma unroll
  for (int t = 0; t < KTAPS; ++t) {
    const double wt = dot::bf_scaled((uint32_t)w[(size_t)t * D] << 16);
#pragma unroll
    for (int j = 0; j < B; ++j) acc[j] = fma(wt, x[j + t], acc[j]);
  }
}

// Column d of pe rows j0 .. j0 + B - 1 of a CTA's text positions: the
// folded location conv over the staged window (wc, wp: act(bf16) of cum
// and prv; ms: the 62 bf16 taps of each column, [62][D]), each position's
// float64 sum taken as cum's 31 taps in order plus prv's 31 in order (two
// chains, interleaved for one position), B positions at once; then pe =
// f32(ploc) + encp, the plain version's first rounding of the energies.
template <int B>
__device__ __forceinline__ void conv_block(float* pe, const float* encp,
                                           const double* wc, const double* wp,
                                           const uint16_t* ms, int D, int j0,
                                           int d) {
  float ep[B];
  double sum[B];
#pragma unroll
  for (int j = 0; j < B; ++j) ep[j] = encp[(size_t)(j0 + j) * D + d];
  const uint16_t* w = ms + d;
  if constexpr (B == 1) {
    double c[1] = {0.0}, v[1] = {0.0};
    conv_taps<1>(c, wc + j0, w, D);
    conv_taps<1>(v, wp + j0, w + (size_t)KTAPS * D, D);
    sum[0] = __dadd_rn(c[0], v[0]);
  } else {
#pragma unroll 1
    for (int part = 0; part < 2; ++part) {
      double acc[B];
#pragma unroll
      for (int j = 0; j < B; ++j) acc[j] = 0.0;
      conv_taps<B>(acc, (part ? wp : wc) + j0, w + (size_t)part * KTAPS * D, D);
#pragma unroll
      for (int j = 0; j < B; ++j) sum[j] = part ? __dadd_rn(sum[j], acc[j]) : acc[j];
    }
  }
#pragma unroll
  for (int j = 0; j < B; ++j)
    pe[(size_t)(j0 + j) * D + d] = add(f32(sum[j]), ep[j]);
}

// pe rows [ja, jb) of a CTA's text positions (conv_block): a thread a
// column, the positions in blocks of 8 (then 4, 2, 1).  One copy of the
// code for every phase end that calls it, so that the step's loop stays
// small enough for the instruction cache.
__device__ __noinline__ void conv_rows(float* pe, const float* encp,
                                       const double* wc, const double* wp,
                                       const uint16_t* ms, int D, int ja,
                                       int jb) {
  for (int d = threadIdx.x; d < D; d += NT) {
    int j = ja;
    for (; j + 8 <= jb; j += 8) conv_block<8>(pe, encp, wc, wp, ms, D, j, d);
    if (j + 4 <= jb) { conv_block<4>(pe, encp, wc, wp, ms, D, j, d); j += 4; }
    if (j + 2 <= jb) { conv_block<2>(pe, encp, wc, wp, ms, D, j, d); j += 2; }
    if (j < jb) conv_block<1>(pe, encp, wc, wp, ms, D, j, d);
  }
}

// Energies u[l0 + jl] = v . bf16(tanh((pe[jl] + pq) + b_q)) of a CTA's nl
// >= NW positions (pe holding f32(ploc + encp), pq in opf): a warp a
// position, each lane the columns lane, lane + 32, ..., of which it keeps
// KE's v (act-scaled), b_q and pq in registers for all its positions, the
// next position's pe loaded while it works on this one; the bf16 of tanh
// enters as bf_scaled against the act-scaled v (exact products, no
// conversion on the float64 pipe), the warp's shuffle tree sums, lane 0
// puts.  Not inlined: the main path's texts give a CTA fewer positions.
__device__ __noinline__ void energy_rows(const float* pe, const float* opf,
                                         const float* b_q, const bf16* v,
                                         int D, int nl, unsigned long long* u,
                                         unsigned tag) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = lane < D ? (D - lane + 31) / 32 : 0;   // this lane's columns
  double va[KE];
  float bq[KE], pq[KE];
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int d = lane + 32 * k;
    va[k] = k < nk ? dot::act((double)__bfloat162float(v[d])) : 0.0;
    bq[k] = k < nk ? __ldg(b_q + d) : 0.f;
    pq[k] = k < nk ? opf[d] : 0.f;
  }
  auto row = [&](int jl, float (&x)[KE]) {
#pragma unroll
    for (int k = 0; k < KE; ++k)
      x[k] = k < nk && jl < nl ? pe[(size_t)jl * D + lane + 32 * k] : 0.f;
  };
  float x[KE];
  row(warp, x);
  for (int jl = warp; jl < nl; jl += NW) {
    float xn[KE];
    row(jl + NW, xn);
    double e = 0.0;
#pragma unroll
    for (int k = 0; k < KE; ++k)
      if (k < nk) {
        const float t = bfr(tanhf(add(add(x[k], pq[k]), bq[k])));
        e = fma(va[k], dot::bf_scaled(__float_as_uint(t)), e);
      }
    for (int k = KE; k < nk; ++k) {   // D past 32 KE columns
      const int d = lane + 32 * k;
      const float t = bfr(tanhf(add(add(pe[(size_t)jl * D + d], opf[d]),
                                    __ldg(b_q + d))));
      e = fma(dot::act((double)__bfloat162float(v[d])),
              dot::bf_scaled(__float_as_uint(t)), e);
    }
    e = warp_sum(e);
    if (lane == 0) put(u + jl, f32(e), tag);
#pragma unroll
    for (int k = 0; k < KE; ++k) x[k] = xn[k];
  }
}

// The first of a CTA's nl positions that conv slot w takes (slot w takes
// [slot_start(nl, w), slot_start(nl, w + 1))): the slots at the ends of
// phases 6-9 (w < NWIN / 2), whose hand-overs hide the conv best, first
// take up to SLOT_MIN each, and the rest is spread over all NWIN slots.
__device__ __forceinline__ int slot_start(int nl, int w) {
  const int first = min(nl, NWIN / 2 * SLOT_MIN), rest = nl - first;
  const int per = most(rest, NWIN);
  int a = 0;
  for (int v = 0; v < w; ++v)
    a += (v < NWIN / 2 ? max(0, min(SLOT_MIN, first - v * SLOT_MIN)) : 0) +
         max(0, min(per, rest - v * per));
  return a;
}

// A segment of a phase's input: n tagged words at p, of step tag - 2.
struct Seg {
  const unsigned long long* p;
  int n;
  unsigned tag;
};

template <bool SPANS, bool I8L, bool GLOB>
__global__ void __launch_bounds__(NT, 1) tts_decode_kernel(Params p) {
  const int L = p.L, D = p.D, Dh = p.Dh, H = p.H, NM = p.n_mels;
  const int RM = p.r * NM;
  const int G = gridDim.x, cta = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Layout y = layout(L, D, Dh, H, NM, p.r, G, I8L, GLOB);

  // what this CTA owns: [x0, x0 + nx)
  const int p1_0 = own0(D, cta, G), n_p1 = own0(D, cta + 1, G) - p1_0;
  const int p2_0 = own0(Dh, cta, G), n_p2 = own0(Dh, cta + 1, G) - p2_0;
  const int d0 = own0(D, cta, G), nd = own0(D, cta + 1, G) - d0;  // GRU, W_q, context
  const int l0 = own0(L, cta, G), nl = own0(L, cta + 1, G) - l0;
  const int h0 = own0(H, cta, G), nh = own0(H, cta + 1, G) - h0;  // rnn_input, LSTMs
  const int m0 = own0(RM, cta, G), nm = own0(RM, cta + 1, G) - m0;

  extern __shared__ __align__(16) unsigned char sm[];
  // the conv window: positions [wl0, wl0 + nw), zero outside [0, L)
  const int wl0 = l0 - PADT, nw = nl + 2 * PADT;
  // GLOB: this CTA's slice of the workspace (the scores)
  const size_t wst = ws_stride(L);
  double* opT = reinterpret_cast<double*>(sm + y.op);     // the operand
  double* encd = reinterpret_cast<double*>(sm + y.encd);  // [nd][L] act(bf16), shared placement
  double* part = reinterpret_cast<double*>(sm + y.part);  // partial sums
  double* win = reinterpret_cast<double*>(sm + y.win);    // [cum | prv] staged, [2][nw]
  float* opf = reinterpret_cast<float*>(sm + y.opf);      // operand, f32
  float* cum = reinterpret_cast<float*>(sm + y.cum);      // [nw], the window's
  float* prv = reinterpret_cast<float*>(sm + y.prv);      // [nw]
  float* sc = GLOB ? p.ws + (size_t)cta * wst : reinterpret_cast<float*>(sm + y.sc);
  float* pe = GLOB ? p.ws + wst * G + (size_t)l0 * D      // [nl][D], ploc + encp
                   : reinterpret_cast<float*>(sm + y.pe);
  float* encp_s = reinterpret_cast<float*>(sm + y.encp);  // [nl][D], shared placement
  const float* encp = GLOB ? p.encp + (size_t)l0 * D : encp_s;
  float* ha_own = reinterpret_cast<float*>(sm + y.own);
  float* c1_own = ha_own + most(D, G);
  float* c2_own = c1_own + most(H, G);
  // I8L: the warps' maxima (2 a warp), then [layer][u][gate] f32(sum_h) *
  // (sa_h * s_hh) for the step
  uint32_t* wmax = reinterpret_cast<uint32_t*>(sm + y.hh);
  float* hh_v = reinterpret_cast<float*>(wmax + 2 * NW);
  // I8L: [h1 | h2] of the step before, f32, at the end of the operand
  float* hf = reinterpret_cast<float*>(sm + y.encd) - 2 * H;
  uint16_t* ms = reinterpret_cast<uint16_t*>(sm + y.ms);  // [62][D] conv taps
  bf16* w_p1 = reinterpret_cast<bf16*>(sm + y.w[WP1]);
  bf16* w_p2 = reinterpret_cast<bf16*>(sm + y.w[WP2]);
  bf16* w_gi = reinterpret_cast<bf16*>(sm + y.w[WG]);
  bf16* w_gh = w_gi + (size_t)most(D, G) * 3 * (D + Dh);
  bf16* w_q = reinterpret_cast<bf16*>(sm + y.w[WQ]);
  bf16* w_ri = reinterpret_cast<bf16*>(sm + y.w[WRI]);
  bf16* w_l1 = reinterpret_cast<bf16*>(sm + y.w[WL1]);
  bf16* w_l2 = reinterpret_cast<bf16*>(sm + y.w[WL2]);
  bf16* w_mel = reinterpret_cast<bf16*>(sm + y.w[WMEL]);

  // tagged scratch, two slots (by step parity) of each activation
  const size_t slot = (size_t)NM + 4 * D + Dh + L + 5 * H;
  struct Acts {
    unsigned long long *prev, *p1, *p2, *ha, *pq, *u, *ctx, *x, *h1, *x1, *h2,
        *x2;
    float *h1f, *h2f;
  };
  auto acts = [&](int parity) {
    Acts t;
    t.prev = p.work + parity * slot;      // [NM]
    t.p1 = t.prev + NM;                   // [D]
    t.p2 = t.p1 + D;                      // [Dh]
    t.ha = t.p2 + Dh;                     // [D]
    t.pq = t.ha + D;                      // [D]
    t.u = t.pq + D;                       // [L]
    t.ctx = t.u + L;                      // [D]
    t.x = t.ctx + D;                      // [H]
    t.h1 = t.x + H;                       // [H]
    t.x1 = t.h1 + H;                      // [H]
    t.h2 = t.x1 + H;                      // [H]
    t.x2 = t.h2 + H;                      // [H]
    // I8L leaves the tagged h slots unused and keeps h1 and h2 there as
    // plain float32, 16-byte aligned: the cells store them with __stcg,
    // and the step's grid barrier makes them visible to every CTA, as it
    // does the mels
    auto f16b = [](unsigned long long* q) {
      return reinterpret_cast<float*>(
          (reinterpret_cast<uintptr_t>(q) + 15) & ~(uintptr_t)15);
    };
    t.h1f = f16b(t.h1);                   // [H] f32
    t.h2f = f16b(t.h2);                   // [H] f32
    return t;
  };

  // the state coming in and going out
  const float* s_prev = p.s_in;
  const float* s_ha = s_prev + NM;
  const float* s_h1 = s_ha + D;
  const float* s_c1 = s_h1 + H;
  const float* s_h2 = s_c1 + H;
  const float* s_c2 = s_h2 + H;
  const float* s_ctx = s_c2 + H;
  const float* s_cum = s_ctx + D;
  const float* s_prv = s_cum + L;
  float* o_prev = p.s_out;
  float* o_ha = o_prev + NM;
  float* o_h1 = o_ha + D;
  float* o_c1 = o_h1 + H;
  float* o_h2 = o_c1 + H;
  float* o_c2 = o_h2 + H;
  float* o_ctx = o_c2 + H;
  float* o_cum = o_ctx + D;
  float* o_prv = o_cum + L;

  // ---- prologue: this CTA's weights, conv, encoder slices and state ----
  copy_units(w_p1, p.p1_w, NM, nullptr, 0, p1_0, n_p1, 1, D);
  copy_units(w_p2, p.p2_w, D, nullptr, 0, p2_0, n_p2, 1, Dh);
  copy_units(w_gi, p.wih_c, D, p.wih_p, Dh, d0, nd, 3, D);
  copy_units(w_gh, p.whh, D, nullptr, 0, d0, nd, 3, D);
  copy_units(w_q, p.W_q, D, nullptr, 0, d0, nd, 1, D);
  copy_units(w_ri, p.ri_c, D, p.ri_h, D, h0, nh, 1, H);
  // I8L: an int8 row of H bytes is H / 2 bf16-sized elements
  const int lk = I8L ? H / 2 : H;
  copy_units(w_l1, p.l1_ih, lk, p.l1_hh, lk, h0, nh, 4, H);
  copy_units(w_l2, p.l2_ih, lk, p.l2_hh, lk, h0, nh, 4, H);
  // I8L: each unit's scales after the rows: [ih gates 0-3 | hh gates 0-3]
  float* l1_s = reinterpret_cast<float*>(
      reinterpret_cast<int8_t*>(w_l1) + (size_t)most(H, G) * 8 * H);
  float* l2_s = reinterpret_cast<float*>(
      reinterpret_cast<int8_t*>(w_l2) + (size_t)most(H, G) * 8 * H);
  if constexpr (I8L) {
    for (int i = tid; i < nh * 8; i += NT) {
      const int u = i / 8, g = i % 4, n = g * H + h0 + u;
      l1_s[i] = i % 8 < 4 ? p.l1_ih_s[n] : p.l1_hh_s[n];
      l2_s[i] = i % 8 < 4 ? p.l2_ih_s[n] : p.l2_hh_s[n];
    }
  }
  copy_units(w_mel, p.mel_w, H, nullptr, 0, m0, nm, 1, RM);
  if (nl > 0) {
    const uint16_t* m = reinterpret_cast<const uint16_t*>(p.M_loc);
    for (int i = tid; i < NTAP2 * D; i += NT)     // ms[k][d] = tap k of d
      ms[i] = m[(size_t)(i % D) * NTAP2 + i / D];
    if constexpr (!GLOB)
      for (int i = tid; i < nl * D; i += NT) encp_s[i] = __ldg(p.encp + (size_t)l0 * D + i);
  }
  if constexpr (!GLOB)
    for (int i = tid; i < nd * L; i += NT)
      encd[i] = dot::act((double)bfr(__ldg(p.enc_t + (size_t)d0 * L + i)));
  // the window's cum and prv, and the same staged as the conv's operand
  for (int i = tid; i < nw; i += NT) {
    const int l = wl0 + i;
    const bool in = l >= 0 && l < L;
    const float c = in ? s_cum[l] : 0.f, v = in ? s_prv[l] : 0.f;
    cum[i] = c;
    prv[i] = v;
    win[i] = dot::act((double)bfr(c));
    win[nw + i] = dot::act((double)bfr(v));
  }
  for (int i = tid; i < nd; i += NT) ha_own[i] = s_ha[d0 + i];
  for (int i = tid; i < nh; i += NT) { c1_own[i] = s_c1[h0 + i]; c2_own[i] = s_c2[h0 + i]; }
  {  // the state coming in, each value by its owner, as step -1's (slot 1)
    const Acts in = acts(1);
    for (int i = tid; i < nd; i += NT) {
      put(in.ha + d0 + i, s_ha[d0 + i], 1);
      put(in.ctx + d0 + i, s_ctx[d0 + i], 1);
    }
    for (int i = tid; i < nh; i += NT) {
      put(in.h1 + h0 + i, s_h1[h0 + i], 1);
      put(in.h2 + h0 + i, s_h2[h0 + i], 1);
    }
    for (int i = tid; i < nm; i += NT)
      if (m0 + i >= RM - NM)
        put(in.prev + (m0 + i - (RM - NM)), s_prev[m0 + i - (RM - NM)], 1);
  }
  __syncthreads();

  // pe rows [ja, jb) of this CTA's positions from the staged window.  No
  // barrier: the window was staged before a barrier, and pe is read after
  // the next phase's fetch has met.
  auto conv = [&](int ja, int jb) {
    if (ja < jb) conv_rows(pe, encp, win, win + nw, ms, D, ja, jb);
  };
  conv(0, nl);

  // CTA 0 stamps the clock when phase k + 1's input has come (k = 9: the
  // step's barrier)
  auto stamp = [&](int step, int k) {
    if (SPANS && cta == 0 && tid == 0)
      p.spans[(size_t)step * NPHASE + k] = globaltimer();
  };

  // the phase's operand, up to three tagged segments concatenated: f32 in
  // opf and, with act, act(bf16(v)) chunk-major in opT.  The block first
  // meets, so that no thread still reads the last phase's operand.  I8L's
  // work rides on the two barriers: before() runs after the first, seen(v)
  // on each value as it comes, after() before the second.
  auto load_op_with = [&](Seg s0, Seg s1, Seg s2, bool act, auto&& before,
                          auto&& seen, auto&& after) {
    const int n = s0.n + s1.n + s2.n, NC = n / 8;
    __syncthreads();
    before();
    fetch(n,
          [&](int k, const unsigned long long*& w, unsigned& tag) {
            const Seg& g = k < s0.n ? s0 : k < s0.n + s1.n ? s1 : s2;
            w = g.p + (k < s0.n ? k : k < s0.n + s1.n ? k - s0.n : k - s0.n - s1.n);
            tag = g.tag;
          },
          [&](int k, float v) {
            opf[k] = v;
            if (act) opT[(k % 8) * NC + k / 8] = dot::act((double)bfr(v));
            seen(v);
          });
    after();
    __syncthreads();
  };
  const auto nop = [] {};
  auto load_op = [&](Seg s0, Seg s1, Seg s2) {
    load_op_with(s0, s1, s2, true, nop, [](float) {}, nop);
  };
  const Seg none{nullptr, 0, 0};

  // I8L, phase 2: its operand and, in the same round trip, [h1 | h2] of
  // the step before (from h1s and h2s) into hf: a thread's first two
  // float4 are loaded while the operand is awaited, any more after it.
  // Each warp's max|h| of each layer rides on the closing barrier.
  auto load_h = [&](Seg s, const float* h1s, const float* h2s) {
    const int n4 = H / 2;   // float4 of [h1 | h2]
    auto get = [&](int i) {
      return __ldcg(reinterpret_cast<const float4*>(
          i < H / 4 ? h1s + 4 * i : h2s + 4 * (i - H / 4)));
    };
    float4 hv[2];
    uint32_t m1 = 0u, m2 = 0u;
    auto keep = [&](int i, float4 v) {
      reinterpret_cast<float4*>(hf)[i] = v;
      const uint32_t b =
          max(max(__float_as_uint(fabsf(v.x)), __float_as_uint(fabsf(v.y))),
              max(__float_as_uint(fabsf(v.z)), __float_as_uint(fabsf(v.w))));
      if (i < H / 4) m1 = max(m1, b); else m2 = max(m2, b);
    };
    auto before = [&] {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (tid + j * NT < n4) hv[j] = get(tid + j * NT);
    };
    auto after = [&] {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (tid + j * NT < n4) keep(tid + j * NT, hv[j]);
      for (int i = tid + 2 * NT; i < n4; i += NT) keep(i, get(i));
      m1 = __reduce_max_sync(0xffffffffU, m1);
      m2 = __reduce_max_sync(0xffffffffU, m2);
      if (lane == 0) { wmax[2 * warp] = m1; wmax[2 * warp + 1] = m2; }
    };
    load_op_with(s, none, none, true, before, [](float) {}, after);
  };

  // I8L: the h half of both LSTMs' gates for the step into hh_v, from hf
  // and the maxima load_h left: a warp takes a (layer, unit) whole
  // (unit_i8).  It runs once phase 2's outputs are out, while phase 3's
  // input is on its way; nothing writes hf or wmax before phase 3's
  // load_op meets.
  auto hh_dot = [&]() {
    const uint32_t m1 = __reduce_max_sync(0xffffffffU, lane < NW ? wmax[2 * lane] : 0u);
    const uint32_t m2 =
        __reduce_max_sync(0xffffffffU, lane < NW ? wmax[2 * lane + 1] : 0u);
    const float sh1 = dot::row_scale(m1), sh2 = dot::row_scale(m2);
    const float rs1 = __frcp_rn(sh1), rs2 = __frcp_rn(sh2);
    for (int i = warp; i < 2 * nh; i += NW) {
      const int layer = i / nh, u = i % nh;
      const float sh = layer ? sh2 : sh1;
      const int8_t* w = reinterpret_cast<const int8_t*>(layer ? w_l2 : w_l1) +
                        (size_t)u * 8 * H + H;    // row 0's hh half
      int acc[4];
      unit_i8(acc, w, 2 * H, hf + layer * H, H, sh, layer ? rs2 : rs1, lane);
      if (lane == 0) {
        const float* su = (layer ? l2_s : l1_s) + 8 * u + 4;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          hh_v[i * 4 + g] = mul(__int2float_rn(acc[g]), mul(sh, su[g]));
      }
    }
  };

  // I8L: an LSTM phase's operand, x alone, f32 in opf (no bf16 copy).
  // Each warp's running max|x| is stored before the closing barrier, which
  // makes it visible to the block.
  auto load_x = [&](const unsigned long long* xs, unsigned xtag) {
    uint32_t m = 0u;
    load_op_with({xs, H, xtag}, none, none, false, nop,
                 [&](float v) { m = max(m, __float_as_uint(fabsf(v))); },
                 [&] {
                   m = __reduce_max_sync(0xffffffffU, m);
                   if (lane == 0) wmax[warp] = m;
                 });
  };

  unsigned nbar = 0;
  for (int step = 0; step < p.n_steps; ++step) {
    const bool first = step == 0, last = step == p.n_steps - 1;
    const unsigned tag = step + 2, tag_cur = step + 1;   // this step, the last
    const Acts nx = acts(step & 1), cur = acts((step & 1) ^ 1);
    // the next step's conv is spread over NWIN phase ends, slot w's share
    // of the positions (slot_start): slots 0-3 at the ends of this step's
    // phases 6-9, 4-7 at the ends of the next step's phases 1-4
    auto conv_here = [&](int w) {
      if (w < NWIN / 2 ? last : first) return;
      const int ja = slot_start(nl, w), jb = slot_start(nl, w + 1);
      if (w == 0 && jb == ja + 1) {   // the main path's one position, inline
        for (int d = tid; d < D; d += NT)
          conv_block<1>(pe, encp, win, win + nw, ms, D, ja, d);
      } else {
        conv(ja, jb);
      }
    };

    // 1. prenet fc1 on the previous mel frame
    load_op({cur.prev, NM, tag_cur}, none, none);
    units<1, 0>(n_p1, w_p1, NM, 0, nullptr, 0, 0, opT, NM / 8, part,
                [&](int u, const double* s) {
                  const int j = p1_0 + u;
                  put(nx.p1 + j, fmaxf(add(f32(s[0]), p.p1_b[j]), 0.f), tag);
                });
    if (!first && cta == 0 && warp == NW - 1) {   // the last step's stop
      float m = -CUDART_INF_F;
      for (int k = lane; k < RM; k += 32)
        m = fmaxf(m, ldcg(p.mels + (size_t)(step - 1) * RM + k));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffU, m, o));
      if (lane == 0) p.stop[step - 1] = m;
    }
    conv_here(4);

    // 2. prenet fc2 (I8L: with h1 and h2 of the step before)
    if constexpr (I8L)
      load_h({nx.p1, D, tag}, first ? s_h1 : cur.h1f,
             first ? s_h2 : cur.h2f);
    else
      load_op({nx.p1, D, tag}, none, none);
    stamp(step, 0);
    units<1, 0>(n_p2, w_p2, D, 0, nullptr, 0, 0, opT, D / 8, part,
                [&](int u, const double* s) {
                  const int j = p2_0 + u;
                  put(nx.p2 + j, fmaxf(add(f32(s[0]), p.p2_b[j]), 0.f), tag);
                });
    if constexpr (I8L) hh_dot();
    conv_here(5);

    // 3. attention GRU: gi = [context | p2] @ wih, gh = h_attn @ whh
    load_op({cur.ctx, D, tag_cur}, {nx.p2, Dh, tag}, {cur.ha, D, tag_cur});
    stamp(step, 1);
    units<3, 3>(nd, w_gi, D + Dh, 0, w_gh, D, (D + Dh) / 8, opT,
                (2 * D + Dh) / 8, part, [&](int u, const double* s) {
                  const int j = d0 + u;
                  float fi[3], fh[3];
#pragma unroll
                  for (int g = 0; g < 3; ++g) {
                    fi[g] = add(f32(s[g]), p.b_attn[g * D + j]);
                    fh[g] = f32(s[3 + g]);
                  }
                  const float rg = sg(add(fi[0], fh[0]));
                  const float zg = sg(add(fi[1], fh[1]));
                  const float ng =
                      tanhf(add(fi[2], mul(rg, add(fh[2], p.b_attn_hn[j]))));
                  const float h = add(mul(sub(1.0f, zg), ng), mul(zg, ha_own[u]));
                  ha_own[u] = h;
                  put(nx.ha + j, h, tag);
                  if (last) o_ha[j] = h;
                });
    conv_here(6);

    // 4. query projection pq = h_attn @ W
    load_op({nx.ha, D, tag}, none, none);
    stamp(step, 2);
    units<1, 0>(nd, w_q, D, 0, nullptr, 0, 0, opT, D / 8, part,
                [&](int u, const double* s) { put(nx.pq + d0 + u, f32(s[0]), tag); });
    conv_here(7);

    // 5. location energies u[l] = v . tanh(((ploc + encp) + pq) + b_q), pe
    // holding f32(ploc + encp): from NW positions a CTA on, a warp a
    // position (energy_rows); below, a position at a time over the CTA (a
    // thread a column, the warps' sums added in order by thread 0)
    load_op({nx.pq, D, tag}, none, none);    // pq in opf
    stamp(step, 3);
    if (nl >= NW) {
      energy_rows(pe, opf, p.b_q, p.v, D, nl, nx.u + l0, tag);
    } else {
      for (int jl = 0; jl < nl; ++jl) {
        double e = 0.0;
        for (int d = tid; d < D; d += NT) {
          const float targ = tanhf(add(add(pe[jl * D + d], opf[d]), __ldg(p.b_q + d)));
          e = fma((double)__bfloat162float(p.v[d]), (double)bfr(targ), e);
        }
        e = warp_sum(e);
        if (lane == 0) part[warp] = e;
        __syncthreads();
        if (tid == 0) {
          double t = 0.0;
          for (int w = 0; w < NW; ++w) t += part[w];
          put(nx.u + l0 + jl, f32(t), tag);
        }
        __syncthreads();
      }
    }

    // 6. scores in every CTA (the sum is over all of L), then the context
    {
      __syncthreads();
      double ps = 0.0;
      fetch(L,
            [&](int l, const unsigned long long*& w, unsigned& t) {
              w = nx.u + l;
              t = tag;
            },
            [&](int l, float v) {
              const float s = sg(v);
              sc[l] = s;
              ps += (double)s;
            });
      stamp(step, 4);
      ps = warp_sum(ps);
      if (lane == 0) part[warp] = ps;
      __syncthreads();
      double tot = 0.0;
      for (int w = 0; w < NW; ++w) tot += part[w];
      const float total = f32(tot);
      // the scores normalised (each by the thread that fetched it), its own
      // positions' written out; the window's cum and prv updated and staged
      for (int l = tid; l < L; l += NT) {
        const float s = __fdiv_rn(sc[l], total);
        sc[l] = s;
        const int i = l - wl0;
        if (i >= 0 && i < nw) {
          const float c = add(cum[i], s);
          cum[i] = c;
          prv[i] = s;
          win[i] = dot::act((double)bfr(c));
          win[nw + i] = dot::act((double)bfr(s));
          if (i >= PADT && i < PADT + nl) p.scores[(size_t)step * L + l] = s;
        }
      }
      __syncthreads();
      // the context: column jd by a group of S warps, each a contiguous
      // range of L with its lanes interleaved, each score entering as
      // bf_scaled against the act-scaled column; the S sums added in order
      const int S = ctx_split(L, nd), sw = warp % S;
      const int la = S == 1 ? 0 : L * sw / S, lb = S == 1 ? L : L * (sw + 1) / S;
      for (int jd = warp / S; jd < nd; jd += NW / S) {
        double acc = 0.0;
        if constexpr (GLOB) {   // the column as the shared copy holds it
          const float* col = p.enc_t + (size_t)(d0 + jd) * L;
#pragma unroll 8
          for (int l = la + lane; l < lb; l += 32)
            acc = fma(dot::bf_scaled(__float_as_uint(bfr(sc[l]))),
                      dot::act((double)bfr(__ldg(col + l))), acc);
        } else {
          for (int l = la + lane; l < lb; l += 32)
            acc = fma(dot::bf_scaled(__float_as_uint(bfr(sc[l]))),
                      encd[jd * L + l], acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) {
          if (S == 1) {
            const float c = f32(acc);
            put(nx.ctx + d0 + jd, c, tag);
            if (last) o_ctx[d0 + jd] = c;
          } else {
            part[jd * S + sw] = acc;
          }
        }
      }
      if (S > 1) {
        __syncthreads();
        if (tid < nd) {
          double t = 0.0;
          for (int i = 0; i < S; ++i) t += part[tid * S + i];
          const float c = f32(t);
          put(nx.ctx + d0 + tid, c, tag);
          if (last) o_ctx[d0 + tid] = c;
        }
      }
    }
    conv_here(0);

    // 7. rnn_input: x = [context | h_attn] @ ri + ri_b
    load_op({nx.ctx, D, tag}, {nx.ha, D, tag}, none);
    stamp(step, 5);
    units<1, 0>(nh, w_ri, 2 * D, 0, nullptr, 0, 0, opT, 2 * D / 8, part,
                [&](int u, const double* s) {
                  const int j = h0 + u;
                  put(nx.x + j, add(f32(s[0]), p.ri_b[j]), tag);
                });
    conv_here(1);

    // 8./9. the residual LSTMs
#pragma unroll 1
    for (int layer = 0; layer < 2; ++layer) {
      unsigned long long* xin = layer ? nx.x1 : nx.x;
      unsigned long long* hc = layer ? cur.h2 : cur.h1;
      unsigned long long* hn = layer ? nx.h2 : nx.h1;
      unsigned long long* xo = layer ? nx.x2 : nx.x1;
      float* c_own = layer ? c2_own : c1_own;
      float* o_h = layer ? o_h2 : o_h1;
      float* o_c = layer ? o_c2 : o_c1;
      const bf16* w = layer ? w_l2 : w_l1;
      const float* bias = layer ? p.l2_b : p.l1_b;
      // the cell of unit u from its gates' pre-activations (bias added);
      // opf[j] is x's value j
      auto cell_of = [&](int u, float ig, float fg, float gg, float og) {
        const int j = h0 + u;
        const float c = add(mul(fg, c_own[u]), mul(ig, gg));
        const float h = mul(og, tanhf(c));
        c_own[u] = c;
        if constexpr (I8L)
          __stcg((layer ? nx.h2f : nx.h1f) + j, h);
        else
          put(hn + j, h, tag);
        put(xo + j, add(opf[j], h), tag);
        if (last) { o_h[j] = h; o_c[j] = c; }
      };
      auto cell = [&](int u, const float (&gv)[4]) {
        cell_of(u, sg(gv[0]), sg(gv[1]), tanhf(gv[2]), sg(gv[3]));
      };
      if constexpr (I8L) {
        // the x half; the h half is hh_v's, from phase 2
        load_x(xin, tag);
        stamp(step, 6 + layer);
        const uint32_t mx =
            __reduce_max_sync(0xffffffffU, lane < NW ? wmax[lane] : 0u);
        const float sx = dot::row_scale(mx), rsx = __frcp_rn(sx);
        const float* sc_l = layer ? l2_s : l1_s;
        for (int u = warp; u < nh; u += NW) {
          int acc[4];
          unit_i8(acc, reinterpret_cast<const int8_t*>(w) + (size_t)u * 8 * H,
                  2 * H, opf, H, sx, rsx, lane);
          // lane g < 4 takes gate g's pre-activation and activation
          const int g = lane & 3, j = h0 + u;
          const int a = g == 0 ? acc[0] : g == 1 ? acc[1] : g == 2 ? acc[2] : acc[3];
          const float gv =
              add(add(mul(__int2float_rn(a), mul(sx, sc_l[8 * u + g])),
                      hh_v[(layer * nh + u) * 4 + g]),
                  bias[g * H + j]);
          // tanh for g, sigmoid (sg's operations) for i, f and o
          const float t = tanhf(g == 2 ? gv : mul(0.5f, gv));
          const float act = g == 2 ? t : add(mul(0.5f, t), 0.5f);
          const float ig = __shfl_sync(0xffffffffU, act, 0);
          const float fg = __shfl_sync(0xffffffffU, act, 1);
          const float gg = __shfl_sync(0xffffffffU, act, 2);
          const float og = __shfl_sync(0xffffffffU, act, 3);
          if (lane == 0) cell_of(u, ig, fg, gg, og);
        }
      } else {
        load_op({xin, H, tag}, {hc, H, tag_cur}, none);
        stamp(step, 6 + layer);
        units<4, 0>(nh, w, 2 * H, 0, nullptr, 0, 0, opT, 2 * H / 8, part,
                    [&](int u, const double* s) {
                      const int j = h0 + u;
                      float gv[4];
#pragma unroll
                      for (int g = 0; g < 4; ++g) gv[g] = add(f32(s[g]), bias[g * H + j]);
                      cell(u, gv);
                    });
      }
      conv_here(2 + layer);
    }

    // 10. mel projection: r frames; the last one feeds the next step
    load_op({nx.x2, H, tag}, none, none);
    stamp(step, 8);
    units<1, 0>(nm, w_mel, H, 0, nullptr, 0, 0, opT, H / 8, part,
                [&](int u, const double* s) {
                  const int m = m0 + u;
                  const float v = f32(s[0]);
                  __stcg(p.mels + (size_t)step * RM + m, v);
                  if (m >= RM - NM) {
                    put(nx.prev + (m - (RM - NM)), v, tag);
                    if (last) o_prev[m - (RM - NM)] = v;
                  }
                });

    // the step's one grid barrier: no CTA starts a step before every CTA
    // has read what the step before last wrote into the slots it reuses
    __syncthreads();
    ++nbar;
    if (tid == 0) {
      arrive(p.bar);
      wait_for(p.bar, nbar * (unsigned)G);
    }
    __syncthreads();
    stamp(step, 9);
  }

  // the last step's stop value and the attention going out
  if (cta == 0) {
    const int n = p.n_steps;
    if (warp == 0) {
      float m = -CUDART_INF_F;
      for (int k = lane; k < RM; k += 32)
        m = fmaxf(m, ldcg(p.mels + (size_t)(n - 1) * RM + k));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffU, m, o));
      if (lane == 0) p.stop[n - 1] = m;
    }
  }
  // the attention going out, each position by its owner
  for (int i = tid; i < nl; i += NT) {
    o_cum[l0 + i] = cum[PADT + i];
    o_prv[l0 + i] = prv[PADT + i];
  }
}

// The bare-barrier loop: n barriers with no work between them, of the
// earlier generation barrier (KIND 0) or the counter barrier (KIND 1).
template <int KIND>
__global__ void __launch_bounds__(NT, 1) barrier_loop(unsigned* bar, int n) {
  for (int i = 0; i < n; ++i) {
    if (KIND == 0) {
      generation_sync(bar);
    } else {
      __syncthreads();
      if (threadIdx.x == 0) {
        arrive(bar);
        wait_for(bar, (unsigned)(i + 1) * gridDim.x);
      }
      __syncthreads();
    }
  }
}

Layout layout_of(const long long* dims) {
  return layout((int)dims[1], (int)dims[2], (int)dims[3], (int)dims[4],
                (int)dims[5], (int)dims[6], (int)dims[7], dims[8] != 0,
                dims[9] != 0);
}

template <bool SPANS, bool I8L, bool GLOB>
int launch(const void* const* ptrs, const long long* dims, void* stream) {
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
  p.work = static_cast<unsigned long long*>(const_cast<void*>(ptrs[i++]));
  p.bar = static_cast<unsigned*>(const_cast<void*>(ptrs[i++]));
  p.ws = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (GLOB && p.ws == nullptr) return cudaErrorInvalidValue;
  p.spans = SPANS ? static_cast<unsigned long long*>(const_cast<void*>(ptrs[i++]))
                  : nullptr;
  if (I8L) {
    p.l1_ih_s = fw(); p.l1_hh_s = fw(); p.l2_ih_s = fw(); p.l2_hh_s = fw();
  }
  p.n_steps = (int)dims[0]; p.L = (int)dims[1]; p.D = (int)dims[2];
  p.Dh = (int)dims[3]; p.H = (int)dims[4]; p.n_mels = (int)dims[5];
  p.r = (int)dims[6];
  const int ctas = (int)dims[7];

  const size_t bytes = layout_of(dims).total;
  cudaError_t e = cudaFuncSetAttribute(
      tts_decode_kernel<SPANS, I8L, GLOB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)tts_decode_kernel<SPANS, I8L, GLOB>,
                                  dim3(ctas), dim3(NT), args, bytes,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" int tts_decode(const void* const* ptrs, const long long* dims,
                          void* stream) {
  if (dims[9])
    return dims[8] ? launch<false, true, true>(ptrs, dims, stream)
                   : launch<false, false, true>(ptrs, dims, stream);
  return dims[8] ? launch<false, true, false>(ptrs, dims, stream)
                 : launch<false, false, false>(ptrs, dims, stream);
}

// The same launch with one more pointer after ``ws``: spans, n_steps x 10
// uint64, where CTA 0 writes %globaltimer at the end of each phase: when the
// next phase's input has come, and after the step's barrier (dev only; every
// variant and placement).
extern "C" int tts_decode_spans(const void* const* ptrs, const long long* dims,
                                void* stream) {
  if (dims[9])
    return dims[8] ? launch<true, true, true>(ptrs, dims, stream)
                   : launch<true, false, true>(ptrs, dims, stream);
  return dims[8] ? launch<true, true, false>(ptrs, dims, stream)
                 : launch<true, false, false>(ptrs, dims, stream);
}

// The dynamic shared memory of one CTA for dims (tts_decode's).
extern "C" long long tts_decode_smem_bytes(const long long* dims) {
  return (long long)layout_of(dims).total;
}

// The global placement's workspace bytes for dims (0 for the shared one).
extern "C" long long tts_decode_workspace_bytes(const long long* dims) {
  if (!dims[9]) return 0;
  return (long long)(4 * ws_floats((int)dims[1], (int)dims[2], (int)dims[7]));
}

// How many CTAs with ``bytes`` of shared memory each can be co-resident, of
// the bf16 kernel or (int8_lstm) the I8L one, in the shared or (glob) the
// global placement.
extern "C" int tts_decode_max_ctas(int* out, long long bytes, int int8_lstm,
                                   int glob) {
  const void* fn =
      glob ? (int8_lstm ? (const void*)tts_decode_kernel<false, true, true>
                        : (const void*)tts_decode_kernel<false, false, true>)
           : (int8_lstm ? (const void*)tts_decode_kernel<false, true, false>
                        : (const void*)tts_decode_kernel<false, false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT,
                                                    (size_t)bytes);
  if (e != cudaSuccess) return e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// n bare barriers of ``kind`` (0 generation, 1 counter) on a cooperative
// grid of ``ctas`` CTAs of NT threads; bar: two zeroed uint32 (dev only).
extern "C" int tts_barrier_loop(int kind, int ctas, long long n, void* bar,
                                void* stream) {
  void* b = bar;
  int nn = (int)n;
  void* args[] = {&b, &nn};
  const void* fn = kind == 0 ? (const void*)barrier_loop<0>
                             : (const void*)barrier_loop<1>;
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(ctas), dim3(NT), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
