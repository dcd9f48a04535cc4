// WaveRNN sample loop for Hopper (sm_90a): a fold row's columns split over
// a thread-block cluster, operands exchanged through distributed shared
// memory.
//
// Replaces wavernn_tpu/ops/pallas_decode.py::_decode_kernel (launched by
// pallas_decode.decode, pallas_call at :103) for the variants with int8 or
// bf16 recurrent matrices and int8 (``int8_ff``) or bf16 feed-forward
// matrices, and for ``int8_gates`` (the five big matrices int8, each
// operand quantized per row on the fly; pallas_decode.py:225-239).  It
// computes what decode.cu computes, step for step (the math is written out
// in ops/cuda_decode.py, whose decode_reference is the plain version of
// both).  decode.cu (one CTA per fold row) keeps the ablations.
//
// What bounded the row-per-CTA design.  One CTA owned a fold row and
// streamed every weight of the model from L2 through its one SM each step:
// with int8_ff 0.33 M bf16 + 2.88 M int8 weights, ~3.54 MB.  The step cost
// the same from 1 to 64 rows (54.20 us at 1, 55.49 at 48: ~65 GB/s into one
// SM), left 84 of 132 SMs idle at 48 rows, and doubled past one wave (121.25
// us at 240 rows, two CTAs an SM; NVIDIA H100 80GB HBM3, 700 W, PERF.md).
//
// Design.  A cluster of K CTAs (K <= 16, on neighbouring SMs of one GPC)
// owns Rt fold rows for all T steps; clusters do not communicate.  Each
// CTA owns a fixed range of each phase's output units, the same for all Rt
// rows: GRU units [u0, u1) with their three gate columns (j, H + j, 2H + j)
// in both GRUs, and FC columns [f0, f1) of FC1 and FC2, ranges aligned to 16
// (8 for bf16 FC columns) so that no packed int8 word and no 16-byte weight
// load has two owners.  It computes those columns' dots for its rows
// (csrc/dot.cuh, dot_bf16_rows / dot_i8_rows: each task a column group, a
// slice of k and RC rows) and runs their epilogues as decode.cu does: gate
// math, residual, relu, quantization at the calibrated ffq scale.  It then
// writes its slice of the next operand (int8-packed xr, h or relu(f1), or
// bf16-rounded doubles) into the operand buffer of every CTA of the
// cluster through distributed shared memory; one cluster barrier
// (barrier.cluster.arrive.release / wait.acquire) orders those stores
// before any CTA reads them.  The operand buffers alternate (xr -> A, xr
// after GRU2 -> B, relu(f1) -> A, f2 -> B; h1 by step parity), so a phase
// needs one barrier: a CTA writes a buffer only after every peer has
// passed the barrier behind the phase that last read it.  Four barriers a
// step: after GRU1, GRU2, FC1 and FC2.  FC3 (F x n_out) is split over the
// cluster by rows: each CTA sums its own f2 columns' products in float64
// and pushes that partial into its slot of every CTA, in the hand-over
// after FC2 (in place of f2 itself, the same bytes).  Every CTA then adds
// the K partials in rank order and draws the sample with the same
// counter-based bits, so every CTA holds the same x for the next step
// without a fifth exchange; rank 0 stores it.  (Whole in every CTA, FC3's
// 2-byte loads ran in chains that grew with the rows a cluster.)
//
// Off the chain.  Only GRU1's epilogue, GRU2's input dot, FC1, FC2 and FC3
// wait on the previous phase.  The other dots of step t + 1 run in the
// windows of step t, each between the arrival at a cluster barrier and the
// wait there, and add up their slices there: window 1 the conditioning row
// (fetched with cp.async a step ahead), w_Im1 and w_Im; window 2 h1
// (exchanged at barrier 1) @ w_hh1 and a2's block of w_aux; window 3 h2
// (barrier 2) @ w_hh2 and a3's; window 4 a4's.
//
// Arithmetic.  Each column's dot runs whole inside one CTA.  int8 sums are
// exact: the k slices add their int32 sums with shared-memory atomics.  A
// bf16 dot sums its exact products in float64 and adds its k slices in
// slice order, so a result does not depend on scheduling; the plain
// version's float64 GEMM sums in another order, and the float32 rounding
// of the two agrees nearly always (max |d| 0 in every comparison so far).
//
// What bounds it.  Per CTA and step it streams 3.54 MB / K of weights from
// L2 (221 KB at K = 16); the step is a chain of ~eleven dependent parts
// (five dot phases with their epilogues, four barriers with their pushes
// and windows, the sample drawn by one warp), each as long as a few L2 or
// DSMEM round trips or a single warp's serial math, so at one row a
// cluster it is latency that bounds it, not intake.  With many rows a
// cluster the float64 FMAs (0.33 M bf16 weights x Rt a step) and the int8
// dp4a grow with Rt, and the bf16 dots' partial sums in shared memory cap
// how finely k is split.  The plan (cuda_decode.cluster_plan) puts every
// cluster in one wave where the layout allows: Rt = the rows over the
// co-resident clusters, one CTA an SM.  PERF.md has the spans a step
// (cuda_decode.decode_cluster_spans).
//
// int8_gates (G8).  A row's operand scale needs the row's largest |value|
// over all H (or F) units, which K CTAs own in slices.  Each CTA hands over
// its slice as float32 values, not int8, and in the same push one word a
// row: the bits of its slice's largest |value| (a float >= 0 orders as its
// bits do), into its own rank's slot of an Rt x K table in every peer.
// Behind the same cluster barrier every CTA takes the largest of the K
// slots (order-free: the same bits in every CTA), forms the row's scale
// and packs the whole operand into one local int8 plane, which the int8
// dot reads as int8_ff's operand.  No barrier is added: four a step, as
// the other variants.  h1's and h2's quantizations run in windows 2 and 3;
// GRU2's xr, FC1's xr and FC2's relu(f1) are packed on the chain, one
// block-wide pass and one __syncthreads each.  The float32 operands are
// held row-major ([Rt][H], [Rt][F]) and a row's K slots side by side, so
// that a packing thread reads its four values and its row's K maxima in
// 16-byte loads without bank conflicts.  The plane serves every operand
// in turn: the windows' dots and the chain's never overlap.
//
// Random bits: rand_bits(seed, row0 + row, step, lane) as decode.cu.
//
// Entry points (plain C, bound with ctypes):
//   int wavernn_decode_cluster(const void* const* ptrs, const long long* dims,
//                              void* stream)
// ptrs as wavernn_decode's (cond, out, then cuda_decode.WEIGHT_ORDER);
// dims = B, Tc, C, T, H, F, feat, aux_d, n_out, mode, deterministic,
//        int8_hh, int8_ff, seed, row0, K, Rt, RC, clusters, budget (the
//        bytes of one bf16 dot's partial sums), bytes (the plan's; a
//        launch whose plan disagrees is refused), int8_gates (with
//        int8_hh and int8_ff set: its five matrices are int8).
//   long long wavernn_decode_cluster_bytes(const long long* dims)
// dims = H, F, feat, aux_d, n_out, int8_hh, int8_ff, K, Rt, RC, budget,
// int8_gates: the layout's shared-memory bytes, or -1 for a plan the
// kernel does not take.
//   int wavernn_decode_cluster_max(int* out, const long long* dims)
// dims = K, int8_hh, int8_ff, int8_gates: the clusters of K CTAs
// co-resident on the current device, one CTA an SM
// (cudaOccupancyMaxActiveClusters).
//   int wavernn_decode_cluster_spans(ptrs, dims, stream, void* spans)
// dev only: the int8_hh + int8_ff (or int8_gates) kernel that stamps
// %globaltimer at NSPAN
// points of every step into spans ((T, NSPAN) int64, the first cluster's
// rank 0).
// Each returns a cudaError_t (0 = success) but the bytes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_step.cuh"
#include "dot.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace step;

constexpr int NT = 512;                 // threads per CTA
constexpr int SMEM_LIMIT = 232448;      // shared memory a CTA may use
// dynamic shared memory every launch asks for at least: two CTAs cannot
// share an SM, so each CTA has its SM's L2 intake to itself
constexpr int ONE_PER_SM = 118784;
constexpr int KMAX = 16;

enum { D_IM1, D_IM, D_HH1, D_IH2, D_AUX2, D_HH2, D_FC1, D_AUX3, D_FC2,
       D_AUX4, D_FC3, ND };
// G8's quantized operands: h1 and xr (GRU1's hand-over), h2 and xr after
// GRU2 (GRU2's), relu(f1) (FC1's)
enum { Q_H1, Q_X1, Q_H2, Q_X2, Q_F1 };

struct CParams {
  const __nv_bfloat16* cond;  // (B, Tc, C) fold-major conditioning
  float* out;                 // (B, T)
  const __nv_bfloat16* w_Im1; const float* u1;
  const __nv_bfloat16* w_Im; const float* w_x; const float* b_I;
  const void* w_hh1; const float* s_hh1; const float* b1; const float* b_hh1_n;
  const void* w_ih2x;
  const void* w_hh2; const float* s_hh2; const float* b2; const float* b_hh2_n;
  const void* w_fc1x; const float* b_fc1;
  const void* w_fc2x; const float* b_fc2;
  const __nv_bfloat16* w_aux; const __nv_bfloat16* w_fc3; const float* b_fc3;
  const float* fs_ih2; const float* fs_fc1; const float* fs_fc2;
  const float* ffq;
  const float* s_ih2; const float* s_fc1; const float* s_fc2;  // G8
  int B, Tc, C, T, H, F, feat, d, n_out, mode, det;
  uint32_t seed, row0;
  // the plan
  int K, Rt, U, Fo;           // cluster size, rows, most units / FC columns
  dot::Split sp[ND];
  int off[ND];   // bytes: a bf16 dot's partials or an int8 dot's sums
  int poff[ND];  // bytes: a window dot's added-up sums (float), or -1
  int o_cond, o_craw, o_h1, o_h2, o_a, o_b, o_f2, o_l3, o_own, o_logits,
      o_xs, o_consts;
  int o_plane, o_max, o_qs;   // G8: the int8 plane, the maxima, the scales
  bool cond_async;   // the conditioning rows copied 16 bytes at a time
  int hbytes;    // one h operand buffer
  int l3bytes;   // one CTA's FC3 partial logits
  int bytes;
  unsigned long long* spans;  // SPANS: (T, NSPAN) %globaltimer stamps
};

// The stamps of the SPANS instantiation (CTA 0, thread 0), in step order:
// step start, GRU1 epilogue, barrier 1 passed, GRU2's input dot, GRU2
// epilogue, barrier 2, FC1, barrier 3, FC2, FC3's partial, the window,
// barrier 4.
constexpr int NSPAN = 12;

__host__ __device__ inline int align16(long long n) {
  return (int)((n + 15) / 16 * 16);
}

// The window (1-4) each dot is computed in, for the next step, between
// the arrival at that barrier and the wait there; 0: in its phase.
constexpr int WINDOW[ND] = {1, 1, 2, 0, 2, 3, 0, 3, 0, 4, 0};

// The layout (cuda_decode.cluster_plan computes the same): each dot's
// split over the CTA's threads and the place of its sums, the operand
// buffers, the CTA's own state.  A bf16 dot's float64 partial sums live
// only until its window or epilogue adds them up, so every window's dots
// and every phase's dot share one region; an int8 dot adds its slices with
// shared-memory atomics into int32 sums of its own (set back to 0 by the
// epilogue that reads them), and the window's bf16 dots' added-up sums (as
// float32) have their own.  G8 (with i8 and ff) holds its operands as
// float32 and adds the int8 plane, the five operands' maxima ([Rt][K]
// words each) and their row scales.  Returns false for a plan it does not
// take.
bool make_plan(CParams& p, int K, int Rt, int RC, int budget, bool i8,
               bool ff, bool g8) {
  const int H = p.H, F = p.F, d = p.d, K0 = p.feat + p.d, NO = p.n_out;
  if (g8 && !(i8 && ff)) return false;
  const int gF = ff ? 16 : 8;
  const int nGH = H / 16, nGF = F / gF;
  if (K < 1 || K > KMAX || (K & (K - 1)) || K > nGH || K > nGF) return false;
  if (RC < 1 || RC > 2 || Rt < RC || Rt % RC || budget < 1) return false;
  const int U = 16 * ((nGH + K - 1) / K), Fo = gF * ((nGF + K - 1) / K);
  p.K = K; p.Rt = Rt; p.U = U; p.Fo = Fo;
  const int NRC = Rt / RC;
  const int Kd[ND] = {K0, K0, H, H, d, H, H, d, F, d, Fo};
  const int ng[ND] = {3, 1, 3, 3, 3, 3, 1, 1, 1, 1, 1};
  const int np[ND] = {U, U, U, U, U, U, Fo, Fo, Fo, Fo, NO};
  const bool in8[ND] = {false, false, i8, ff, false, i8, ff, false, ff,
                        false, false};
  int group[5] = {0, 0, 0, 0, 0}, shared = 0, ints = 0, pre = 0;
  for (int i = 0; i < ND; ++i) {
    const int V = i == D_FC3 ? 1 : in8[i] ? 16 : 8;
    const int min_rows = in8[i] ? 16 : 8;
    const long long cols = (long long)ng[i] * np[i];
    const int smax = in8[i] ? Kd[i]
        : (int)(budget / (cols * Rt * 8) > 1 ? budget / (cols * Rt * 8) : 1);
    p.sp[i] = dot::split(Kd[i], NRC * (int)(cols / V), NT, in8[i] ? 4 : 1,
                         smax, min_rows);
    p.poff[i] = -1;
    if (in8[i]) {
      p.off[i] = -1 - ints;   // placed after the shared region
      ints += align16((cols + cols / 16) * Rt * 4);
      continue;
    }
    const int n = align16((long long)p.sp[i].S * cols * Rt * 8);
    const int w = WINDOW[i];
    p.off[i] = w ? group[w] : 0;
    group[w] = w ? group[w] + n : (n > group[0] ? n : group[0]);
    if (w) {
      p.poff[i] = pre;
      pre += align16(cols * Rt * 4);
    }
  }
  for (int w = 0; w < 5; ++w) shared = group[w] > shared ? group[w] : shared;
  int used = shared;
  for (int i = 0; i < ND; ++i)
    if (p.off[i] < 0) p.off[i] = used + (-1 - p.off[i]);
  used += ints;
  for (int i = 0; i < ND; ++i)
    if (p.poff[i] >= 0) p.poff[i] += used;
  used += pre;
  const int W = H > F ? H : F;
  p.o_cond = used; used += align16((long long)p.C * Rt * 8);
  p.o_craw = used; used += 2 * align16((long long)p.C * Rt * 2);
  p.hbytes = align16((long long)H * Rt * (g8 ? 4 : i8 ? 1 : 8));
  p.o_h1 = used; used += 2 * p.hbytes;
  p.o_h2 = used; used += p.hbytes;
  const int ab = align16((long long)W * Rt * (g8 ? 4 : ff ? 1 : 8));
  p.o_a = used; used += ab;
  p.o_b = used; used += ab;
  p.o_f2 = used; used += align16((long long)Fo * Rt * 8);
  p.l3bytes = align16((long long)NO * Rt * 8);
  p.o_l3 = used; used += K * p.l3bytes;
  p.o_own = used; used += 3 * align16((long long)U * Rt * 4);
  p.o_logits = used; used += align16((long long)Rt * NO * 4);
  p.o_xs = used; used += align16((long long)Rt * 4);
  p.o_consts = used;
  used += align16((long long)((13 + (i8 ? 6 : 0) + (ff ? 3 : 0)) * U
                              + (ff ? 4 : 2) * Fo + NO) * 4);
  p.o_plane = used; used += g8 ? align16((long long)W * Rt) : 0;
  p.o_max = used; used += g8 ? align16((long long)5 * Rt * K * 4) : 0;
  p.o_qs = used; used += g8 ? align16((long long)5 * Rt * 4) : 0;
  p.bytes = used;
  return used <= SMEM_LIMIT;
}

// Column n, row r of a bf16 dot's split sums ([S][NN][Rt]), its slices
// added in slice order, rounded once to float32.
__device__ __forceinline__ float psum_rows(const double* part, int S, int NN,
                                           int n, int r, int Rt) {
  double s = 0.0;
  for (int i = 0; i < S; ++i) s += part[((size_t)i * NN + n) * Rt + r];
  return __double2float_rn(s);
}

// Column n, row r of an int8 dot's sum, as float32 (exact: |sum| <= 127 *
// 127 * K < 2^24), set back to 0 for the next step.  (Per-slice partial
// sums added in the epilogue, as the bf16 dots do, measured slower on the
// card than these atomics.)
__device__ __forceinline__ float take(int* acc, int n, int r, int Rt) {
  int* a = acc + dot::acc_at(n, r, Rt);
  const int v = *a;
  *a = 0;
  return __int2float_rn(v);
}

// Byte k of row r of an int8 operand packed four k rows to a word,
// [K / 4][Rt].
__device__ __forceinline__ void put_i8(void* aq, int k, int r, int Rt,
                                       int q) {
  static_cast<int8_t*>(aq)[((k / 4) * Rt + r) * 4 + k % 4] =
      static_cast<int8_t>(q);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Copy this CTA's slices [p1, p1 + n1) and [p2, p2 + n2) (bytes, 16-byte
// aligned, multiples of 16) of its shared memory into the same places of
// every other CTA of the cluster.
__device__ __forceinline__ void push(cg::cluster_group& cl, int K, int me,
                                     unsigned char* p1, int n1,
                                     unsigned char* p2, int n2) {
  const int c1 = n1 / 16, c = c1 + n2 / 16;
  for (int i = threadIdx.x; i < c * (K - 1); i += NT) {
    int peer = i / c;
    peer += peer >= me;
    const int k = i % c;
    uint4* src = k < c1 ? reinterpret_cast<uint4*>(p1) + k
                        : reinterpret_cast<uint4*>(p2) + (k - c1);
    *cl.map_shared_rank(src, peer) = *src;
  }
}

// G8: copy this CTA's columns [c0, c0 + n) (n a multiple of 4) of the Rt
// rows of the float32 operands a and b ([Rt][ld] each; b may be null) and
// its words of the maxima of nq operands (the word of operand row j at m +
// j * K + me) into the same places of every other CTA of the cluster (K a
// power of two: the peers are me ^ 1 .. me ^ (K - 1)).  A thread takes one
// 16-byte piece or word and stores it to every peer, so that no division
// runs per store; one copy of the code serves the three hand-overs.
__device__ __noinline__ void push_g8(int K, int me, int Rt, int c0, int n,
                                     float* a, float* b, int ld, uint32_t* m,
                                     int nq) {
  cg::cluster_group cl = cg::this_cluster();
  const int cr = n / 4, ca = Rt * cr, cd = (b ? 2 : 1) * ca;
  const int c = cd + nq * Rt;
  for (int k = threadIdx.x; k < c; k += NT) {
    if (k < cd) {
      const int kk = k < ca ? k : k - ca;
      uint4* src = reinterpret_cast<uint4*>((k < ca ? a : b) + (kk / cr) * ld
                                            + c0 + (kk % cr) * 4);
      const uint4 v = *src;
      for (int q = 1; q < K; ++q) *cl.map_shared_rank(src, me ^ q) = v;
    } else {
      uint32_t* src = m + (k - cd) * K + me;
      const uint32_t v = *src;
      for (int q = 1; q < K; ++q) *cl.map_shared_rank(src, me ^ q) = v;
    }
  }
}

// G8: operand v ([Rt][Kd] float32, the whole operand) packed into plane
// ([Kd / 4][Rt] words, four k rows a word, as dot_i8_rows reads it) at
// each row's scale, from the largest of the K CTAs' maxima of the row
// (mx: [Rt][K]); the scales into qs[Rt].  A thread takes four consecutive
// k of one row.  One copy of the code serves the five operands.
__device__ __noinline__ void pack_rows(uint32_t* plane, float* qs,
                                       const float* v, const uint32_t* mx,
                                       int Kd, int Rt, int K) {
  const int n4 = Kd / 4;
  for (int i = threadIdx.x; i < n4 * Rt; i += NT) {
    const int r = i / n4, k4 = i - r * n4;
    const uint32_t* mr = mx + r * K;
    uint32_t m = 0u;
    if (K % 4 == 0) {
      for (int c = 0; c < K; c += 4) {
        const uint4 w = *reinterpret_cast<const uint4*>(mr + c);
        m = max(max(m, max(w.x, w.y)), max(w.z, w.w));
      }
    } else {
      for (int c = 0; c < K; ++c) m = max(m, mr[c]);
    }
    const float sa = dot::row_scale(m);
    const float4 x = *reinterpret_cast<const float4*>(v + r * Kd + 4 * k4);
    plane[k4 * Rt + r] = dot::quant_byte(x.x, sa)
                         | dot::quant_byte(x.y, sa) << 8
                         | dot::quant_byte(x.z, sa) << 16
                         | dot::quant_byte(x.w, sa) << 24;
    if (k4 == 0) qs[r] = sa;
  }
}

// G8: fold the bits of |v| of this lane's epilogue item i (row i % Rt;
// the warp's 32 lanes hold 32 consecutive items, bits 0 where a lane has
// none) into each row's maximum m[row * K]: the lanes of one row reduced
// by shuffles, then one shared-memory atomicMax a row and warp.  Every
// lane of the warp calls it.
__device__ __forceinline__ void commit_rows(uint32_t* m, int K, uint32_t bits,
                                            int i, int Rt) {
  for (int off = Rt; off < 32; off *= 2)
    bits = max(bits, __shfl_down_sync(0xffffffffU, bits, off));
  if ((int)(threadIdx.x & 31) < Rt && bits != 0)
    atomicMax(m + (i % Rt) * K, bits);
}

// G8 runs with I8 and FF set: its five dots are the int8 ones of those.
template <int RC, bool I8, bool FF, bool G8, bool SPANS>
__global__ void __launch_bounds__(NT, 1) decode_cluster_kernel(CParams p) {
  static_assert(!G8 || (I8 && FF), "int8_gates has five int8 matrices");
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char sm[];
  const int K = p.K, Rt = p.Rt, U = p.U, Fo = p.Fo;
  const int me = (int)cl.block_rank();
  const int b0 = (int)(blockIdx.x / K) * Rt;
  const int H = p.H, F = p.F, d = p.d, NO = p.n_out, H3 = 3 * H;
  const int K0 = p.feat + d, NA = 3 * H + 2 * F;
  const int gF = FF ? 16 : 8;
  const int u0 = 16 * (me * (H / 16) / K), u1 = 16 * ((me + 1) * (H / 16) / K);
  const int f0 = gF * (me * (F / gF) / K), f1 = gF * ((me + 1) * (F / gF) / K);
  const int nu = u1 - u0, nf = f1 - f0;
  const int tid = threadIdx.x, lane = tid % 32;

  auto part = [&](int i) { return reinterpret_cast<double*>(sm + p.off[i]); };
  auto iacc = [&](int i) { return reinterpret_cast<int*>(sm + p.off[i]); };
  auto pre = [&](int i) { return reinterpret_cast<float*>(sm + p.poff[i]); };
  double* cond = reinterpret_cast<double*>(sm + p.o_cond);   // [C][Rt]
  unsigned char* h1buf = sm + p.o_h1;   // two h1 operands (step parity)
  unsigned char* h2buf = sm + p.o_h2;   // the h2 operand
  unsigned char* abuf = sm + p.o_a;     // xr, relu(f1)
  unsigned char* bbuf = sm + p.o_b;     // xr after GRU2
  double* f2 = reinterpret_cast<double*>(sm + p.o_f2);  // [Fo][Rt] own f2
  float* h1o = reinterpret_cast<float*>(sm + p.o_own);       // [U][Rt] own
  float* h2o = h1o + align16((long long)U * Rt * 4) / 4;
  float* xro = h2o + align16((long long)U * Rt * 4) / 4;
  float* logits = reinterpret_cast<float*>(sm + p.o_logits);  // [Rt][NO]
  float* xs = reinterpret_cast<float*>(sm + p.o_xs);          // [Rt]
  // two steps' conditioning rows as loaded, [2][Rt][C] bf16
  __nv_bfloat16* craw = reinterpret_cast<__nv_bfloat16*>(sm + p.o_craw);
  // the CTA's per-column constants, gate-major [3][U] where a GRU has three
  float* c_u1 = reinterpret_cast<float*>(sm + p.o_consts);
  float* c_b1 = c_u1 + 3 * U;      // b1, b_hh1_n, w_x, b_I
  float* c_bn1 = c_b1 + 3 * U;
  float* c_wx = c_bn1 + U;
  float* c_bI = c_wx + U;
  float* c_b2 = c_bI + U;          // b2, b_hh2_n
  float* c_bn2 = c_b2 + 3 * U;
  float* c_bf1 = c_bn2 + U;        // b_fc1, b_fc2, b_fc3 (all n_out)
  float* c_bf2 = c_bf1 + Fo;
  float* c_bf3 = c_bf2 + Fo;
  // I8: s_hh1 / 127, s_hh2 / 127 (G8: s_hh1, s_hh2)
  float* c_s1 = c_bf3 + NO;
  float* c_s2 = c_s1 + (I8 ? 3 * U : 0);
  // FF: the fused scales (G8: the weights' scales)
  float* c_fs2 = c_s2 + (I8 ? 3 * U : 0);
  float* c_fsf1 = c_fs2 + 3 * U;
  float* c_fsf2 = c_fsf1 + Fo;
  // G8: the int8 plane of the operand a dot reads ([W / 4][Rt] words), the
  // five operands' maxima ([5][Rt][K]: row r's slot of CTA c) and row
  // scales [5][Rt]
  uint32_t* plane = reinterpret_cast<uint32_t*>(sm + p.o_plane);
  uint32_t* maxima = reinterpret_cast<uint32_t*>(sm + p.o_max);
  float* qs = reinterpret_cast<float*>(sm + p.o_qs);
  // G8: operand q's maxima, and this CTA's slot of its row 0
  auto qmax = [&](int q) { return maxima + q * Rt * K; };
  auto own_max = [&](int q) { return qmax(q) + me; };
  // bytes of one unit's [Rt] values of an h operand and of an ff operand
  constexpr int isz = G8 ? 4 : I8 ? 1 : 8, fsz = G8 ? 4 : FF ? 1 : 8;

  float ffq[3] = {0.f, 0.f, 0.f};
  if constexpr (FF && !G8) {
    ffq[0] = p.ffq[0]; ffq[1] = p.ffq[1]; ffq[2] = p.ffq[2];
  }
  auto stamp = [&](int t, int k) {
    if constexpr (SPANS) {
      if (blockIdx.x == 0 && tid == 0) {
        unsigned long long g;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
        p.spans[(size_t)t * NSPAN + k] = g;
      }
    }
  };

  // v as the operand of a recurrent dot (I8: round(v * 127), |v| <= 1;
  // G8: v itself, row-major)
  auto put_h = [&](unsigned char* buf, int j, int r, float v) {
    if constexpr (G8)
      reinterpret_cast<float*>(buf)[r * H + j] = v;
    else if constexpr (I8)
      put_i8(buf, j, r, Rt, __float2int_rn(mul(v, 127.f)));
    else
      reinterpret_cast<double*>(buf)[j * Rt + r] = bfr64(v);
  };
  // v as the operand of feed-forward dot q (FF: at its calibrated scale;
  // G8: v itself, row-major: rows of H, F for relu(f1))
  auto put_ff = [&](unsigned char* buf, int q, int k, int r, float v) {
    if constexpr (G8)
      reinterpret_cast<float*>(buf)[r * (q == 2 ? F : H) + k] = v;
    else if constexpr (FF)
      put_i8(buf, k, r, Rt, __float2int_rn(
          fminf(fmaxf(mul(v, ffq[q]), -127.f), 127.f)));
    else
      reinterpret_cast<double*>(buf)[k * Rt + r] = bfr64(v);
  };
  // a recurrent dot on h operand ``op`` (the CTA's three gate slices)
  auto hidden_dot = [&](int i, const unsigned char* op, const void* w,
                        int& first) {
    if constexpr (I8)
      dot::dot_i8_rows<NT, RC>(iacc(i), reinterpret_cast<const uint32_t*>(op),
                               Rt, H, nu, 3, U, H,
                               static_cast<const int8_t*>(w) + u0, H3, p.sp[i],
                               first);
    else
      dot::dot_bf16_rows<NT, RC, 8>(part(i),
                                    reinterpret_cast<const double*>(op), Rt,
                                    H, nu, 3, U, H,
                                    static_cast<const __nv_bfloat16*>(w) + u0,
                                    H3, p.sp[i], first);
  };
  // a feed-forward dot on operand ``op``: Kd rows, ng gates of n columns
  // (np in the sums' layout), w at the CTA's first column
  auto ff_dot = [&](int i, const unsigned char* op, int Kd, int ng, int n,
                    int np, int gs, const void* w, int c0, int ldw) {
    int first = 0;
    if constexpr (FF)
      dot::dot_i8_rows<NT, RC>(iacc(i), reinterpret_cast<const uint32_t*>(op),
                               Rt, Kd, n, ng, np, gs,
                               static_cast<const int8_t*>(w) + c0, ldw,
                               p.sp[i], first);
    else
      dot::dot_bf16_rows<NT, RC, 8>(part(i),
                                    reinterpret_cast<const double*>(op), Rt,
                                    Kd, n, ng, np, gs,
                                    static_cast<const __nv_bfloat16*>(w) + c0,
                                    ldw, p.sp[i], first);
  };
  // column n (of ng * np), row r of dot i on operand q: FF's int8 sum
  // times fs[n] (G8: times its row's scale times the weight's, s[n])
  auto ff_col = [&](int i, int q, int ng, int np, int n, int r,
                    const float* fs) {
    if constexpr (G8)
      return mul(take(iacc(i), n, r, Rt), mul(qs[q * Rt + r], fs[n]));
    else if constexpr (FF)
      return mul(take(iacc(i), n, r, Rt), fs[n]);
    else
      return psum_rows(part(i), p.sp[i].S, ng * np, n, r, Rt);
  };
  // column n, row r of a window's bf16 dot (added up in its window)
  auto bf_col = [&](int i, int n, int r) { return pre(i)[n * Rt + r]; };
  // gate g of unit jl of a recurrent dot on operand q (s: its scales / 127;
  // G8: its scales, times the row's)
  auto hidden_gate = [&](int i, int q, const float* s, int g, int jl,
                         int r) {
    if constexpr (G8)
      return mul(take(iacc(i), g * U + jl, r, Rt),
                 mul(qs[q * Rt + r], s[g * U + jl]));
    else if constexpr (I8)
      return mul(take(iacc(i), g * U + jl, r, Rt), s[g * U + jl]);
    else
      return bf_col(i, g * U + jl, r);
  };
  // G8: operand q (v: [Rt][Kd] float32, the whole operand) packed into
  // the plane at each row's scale, the scales kept in qs[q] for the
  // epilogue.  The caller syncs before a dot reads the plane.
  auto quantize = [&](int q, const unsigned char* v, int Kd) {
    pack_rows(plane, qs + q * Rt, reinterpret_cast<const float*>(v), qmax(q),
              Kd, Rt, K);
  };
  // G8: this CTA's maxima of operand q set back to 0 (after every read of
  // them, before the epilogue that makes them anew)
  auto clear_max = [&](int q) {
    for (int i = tid; i < Rt; i += NT) own_max(q)[i * K] = 0u;
  };
  // G8: the bits of |v| (a float >= 0 orders as its bits do)
  auto abits = [](float v) { return __float_as_uint(fabsf(v)); };
  // the conditioning row of step t, and the dots that need only it and the
  // recurrent state: the window's
  // step t's conditioning rows into craw[t & 1], asynchronously where the
  // rows are 16-byte aligned (rows past B are zeros)
  auto fetch_cond = [&](int t) {
    const int C = p.C;
    __nv_bfloat16* dst = craw + (t & 1) * Rt * C;
    if (p.cond_async) {
      const int n16 = C / 8;
      for (int i = tid; i < Rt * n16; i += NT) {
        const int r = i / n16, c = (i % n16) * 8, b = b0 + r;
        if (b < p.B)
          cp_async16(dst + r * C + c, p.cond + ((size_t)b * p.Tc + t) * C + c);
        else
          *reinterpret_cast<uint4*>(dst + r * C + c) = make_uint4(0, 0, 0, 0);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    } else {
      for (int i = tid; i < Rt * C; i += NT) {
        const int r = i / C, c = i % C, b = b0 + r;
        dst[i] = b < p.B ? p.cond[((size_t)b * p.Tc + t) * C + c]
                         : __float2bfloat16_rn(0.f);
      }
    }
  };
  // pre(i) = dot i's partial sums added in slice order, rounded: NN
  // columns x Rt rows
  auto reduce = [&](int i, int NN, int& first) {
    const int n = NN * Rt;
    for (int k = dot::first_task<NT>(first); k < n; k += NT)
      pre(i)[k] = psum_rows(part(i), p.sp[i].S, NN, k / Rt, k % Rt, Rt);
    first = (first + n) % NT;
  };
  // The windows: the dots of step t that do not wait on a phase of their
  // step, each window's after the arrival at its barrier of step t - 1.
  // 1: step t's conditioning row (fetched a step ahead), w_Im1 and w_Im;
  // 2: h1 of step t - 1 (exchanged at barrier 1) and a2's block of w_aux;
  // 3: h2 (barrier 2) and a3's block; 4: a4's block.  Each adds up its
  // partial sums and ends at __syncthreads: the shared partial region is
  // the next phase's.
  auto window = [&](int w, int t) {
    int first = 0;
    if (w == 1) {
      if (p.cond_async) asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
      const __nv_bfloat16* src = craw + (t & 1) * Rt * p.C;
      for (int i = tid; i < p.C * Rt; i += NT) {
        const int r = i % Rt, c = i / Rt;
        cond[i] = dot::act(static_cast<double>(__bfloat162float(
            src[r * p.C + c])));
      }
      __syncthreads();
      dot::dot_bf16_rows<NT, RC, 8>(part(D_IM1), cond, Rt, K0, nu, 3, U, H,
                                    p.w_Im1 + u0, H3, p.sp[D_IM1], first);
      dot::dot_bf16_rows<NT, RC, 8>(part(D_IM), cond, Rt, K0, nu, 1, U, 0,
                                    p.w_Im + u0, H, p.sp[D_IM], first);
      __syncthreads();
      first = 0;
      reduce(D_IM1, 3 * U, first);
      reduce(D_IM, U, first);
    } else if (w == 2) {
      const unsigned char* h1 = h1buf + ((t + 1) & 1) * p.hbytes;
      if constexpr (G8) {
        quantize(Q_H1, h1, H);
        __syncthreads();
        clear_max(Q_H1);
        clear_max(Q_X1);
        h1 = reinterpret_cast<const unsigned char*>(plane);
      }
      hidden_dot(D_HH1, h1, p.w_hh1, first);
      dot::dot_bf16_rows<NT, RC, 8>(part(D_AUX2), cond + K0 * Rt, Rt, d, nu,
                                    3, U, H, p.w_aux + u0, NA, p.sp[D_AUX2],
                                    first);
      __syncthreads();
      first = 0;
      reduce(D_AUX2, 3 * U, first);
      if constexpr (!I8) reduce(D_HH1, 3 * U, first);
    } else if (w == 3) {
      const unsigned char* h2 = h2buf;
      if constexpr (G8) {
        quantize(Q_H2, h2, H);
        __syncthreads();
        clear_max(Q_H2);
        clear_max(Q_X2);
        h2 = reinterpret_cast<const unsigned char*>(plane);
      }
      hidden_dot(D_HH2, h2, p.w_hh2, first);
      dot::dot_bf16_rows<NT, RC, 8>(part(D_AUX3), cond + (K0 + d) * Rt, Rt, d,
                                    nf, 1, Fo, 0,
                                    p.w_aux + (size_t)d * NA + H3 + f0, NA,
                                    p.sp[D_AUX3], first);
      __syncthreads();
      first = 0;
      reduce(D_AUX3, Fo, first);
      if constexpr (!I8) reduce(D_HH2, 3 * U, first);
    } else {
      dot::dot_bf16_rows<NT, RC, 8>(part(D_AUX4), cond + (K0 + 2 * d) * Rt, Rt,
                                    d, nf, 1, Fo, 0,
                                    p.w_aux + (size_t)2 * d * NA + H3 + F + f0,
                                    NA, p.sp[D_AUX4], first);
      __syncthreads();
      first = 0;
      reduce(D_AUX4, Fo, first);
    }
    __syncthreads();
  };

  // the state and the operands of h(-1) = 0, the int8 sums at 0
  for (int i = tid; i < 3 * align16((long long)U * Rt * 4) / 4; i += NT)
    h1o[i] = 0.f;
  for (int i = tid; i < Rt; i += NT) xs[i] = 0.f;
  for (int i = tid; i < 3 * p.hbytes / 4; i += NT)
    reinterpret_cast<uint32_t*>(h1buf)[i] = 0u;
  if constexpr (G8)
    for (int i = tid; i < 5 * Rt * K; i += NT) maxima[i] = 0u;
  for (int i = tid; i < nu; i += NT) {
    const int j = u0 + i;
    for (int g = 0; g < 3; ++g) {
      c_u1[g * U + i] = p.u1[g * H + j];
      c_b1[g * U + i] = p.b1[g * H + j];
      c_b2[g * U + i] = p.b2[g * H + j];
      if constexpr (G8) {
        c_s1[g * U + i] = p.s_hh1[g * H + j];
        c_s2[g * U + i] = p.s_hh2[g * H + j];
        c_fs2[g * U + i] = p.s_ih2[g * H + j];
      } else {
        if constexpr (I8) {
          c_s1[g * U + i] = mul(p.s_hh1[g * H + j], 1.0f / 127.0f);
          c_s2[g * U + i] = mul(p.s_hh2[g * H + j], 1.0f / 127.0f);
        }
        if constexpr (FF) c_fs2[g * U + i] = p.fs_ih2[g * H + j];
      }
    }
    c_bn1[i] = p.b_hh1_n[j];
    c_bn2[i] = p.b_hh2_n[j];
    c_wx[i] = p.w_x[j];
    c_bI[i] = p.b_I[j];
  }
  for (int i = tid; i < nf; i += NT) {
    c_bf1[i] = p.b_fc1[f0 + i];
    c_bf2[i] = p.b_fc2[f0 + i];
    if constexpr (G8) {
      c_fsf1[i] = p.s_fc1[f0 + i];
      c_fsf2[i] = p.s_fc2[f0 + i];
    } else if constexpr (FF) {
      c_fsf1[i] = p.fs_fc1[f0 + i];
      c_fsf2[i] = p.fs_fc2[f0 + i];
    }
  }
  for (int i = tid; i < NO; i += NT) c_bf3[i] = p.b_fc3[i];
  for (int i = 0; i < ND; ++i) {
    const bool is8 = (I8 && (i == D_HH1 || i == D_HH2))
                     || (FF && (i == D_IH2 || i == D_FC1 || i == D_FC2));
    if (!is8) continue;
    const int cols = (i == D_FC1 || i == D_FC2) ? Fo : 3 * U;
    for (int k = tid; k < (cols + cols / 16) * Rt; k += NT) iacc(i)[k] = 0;
  }
  fetch_cond(0);
  __syncthreads();
  cl.sync();   // every CTA of the cluster runs before any writes to a peer
  for (int w = 1; w <= 4; ++w) window(w, 0);

  for (int t = 0; t < p.T; ++t) {
    __syncthreads();
    stamp(t, 0);
    if (t + 1 < p.T) fetch_cond(t + 1);
    unsigned char* h1now = h1buf + (t & 1) * p.hbytes;
    // GRU1 (inputs precomposed through I) and the I projection; the loops
    // over a phase's items run whole warps (G8's maxima are reduced a warp
    // at a time)
    for (int i0 = tid - lane; i0 < nu * Rt; i0 += NT) {
      const int i = i0 + lane;
      uint32_t mh = 0u, mx = 0u;
      if (i < nu * Rt) {
        const int jl = i / Rt, r = i % Rt, j = u0 + jl;
        const float x = xs[r];
        float a[3], h[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          a[g] = add(mul(x, c_u1[g * U + jl]),
                     bf_col(D_IM1, g * U + jl, r));
          h[g] = hidden_gate(D_HH1, Q_H1, c_s1, g, jl, r);
        }
        const float hn = gru(a, h, c_b1, c_bn1, jl, U, h1o[jl * Rt + r]);
        h1o[jl * Rt + r] = hn;
        const float v = add(add(add(mul(x, c_wx[jl]), bf_col(D_IM, jl, r)),
                                c_bI[jl]), hn);
        xro[jl * Rt + r] = v;
        put_h(h1now, j, r, hn);
        put_ff(abuf, 0, j, r, v);
        mh = abits(hn);
        mx = abits(v);
      }
      if constexpr (G8) {
        commit_rows(own_max(Q_H1), K, mh, i, Rt);
        commit_rows(own_max(Q_X1), K, mx, i, Rt);
      }
    }
    __syncthreads();
    stamp(t, 1);
    if constexpr (G8)
      push_g8(K, me, Rt, u0, nu, reinterpret_cast<float*>(h1now),
              reinterpret_cast<float*>(abuf), H, qmax(Q_H1), 2);
    else
      push(cl, K, me, h1now + u0 * Rt * isz, nu * Rt * isz,
           abuf + u0 * Rt * fsz, nu * Rt * fsz);
    cluster_arrive();
    if (t + 1 < p.T) window(1, t + 1);
    cluster_wait();
    stamp(t, 2);

    // GRU2 on [xr | a2]
    if constexpr (G8) {
      quantize(Q_X1, abuf, H);
      __syncthreads();
    }
    ff_dot(D_IH2, G8 ? reinterpret_cast<unsigned char*>(plane) : abuf, H, 3,
           nu, U, H, p.w_ih2x, u0, H3);
    __syncthreads();
    stamp(t, 3);
    for (int i0 = tid - lane; i0 < nu * Rt; i0 += NT) {
      const int i = i0 + lane;
      uint32_t mh = 0u, mx = 0u;
      if (i < nu * Rt) {
        const int jl = i / Rt, r = i % Rt, j = u0 + jl;
        float a[3], h[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          a[g] = add(ff_col(D_IH2, Q_X1, 3, U, g * U + jl, r, c_fs2),
                     bf_col(D_AUX2, g * U + jl, r));
          h[g] = hidden_gate(D_HH2, Q_H2, c_s2, g, jl, r);
        }
        const float hn = gru(a, h, c_b2, c_bn2, jl, U, h2o[jl * Rt + r]);
        h2o[jl * Rt + r] = hn;
        const float v = add(xro[jl * Rt + r], hn);
        xro[jl * Rt + r] = v;
        put_h(h2buf, j, r, hn);
        put_ff(bbuf, 1, j, r, v);
        mh = abits(hn);
        mx = abits(v);
      }
      if constexpr (G8) {
        commit_rows(own_max(Q_H2), K, mh, i, Rt);
        commit_rows(own_max(Q_X2), K, mx, i, Rt);
      }
    }
    __syncthreads();
    stamp(t, 4);
    if constexpr (G8)
      push_g8(K, me, Rt, u0, nu, reinterpret_cast<float*>(h2buf),
              reinterpret_cast<float*>(bbuf), H, qmax(Q_H2), 2);
    else
      push(cl, K, me, h2buf + u0 * Rt * isz, nu * Rt * isz,
           bbuf + u0 * Rt * fsz, nu * Rt * fsz);
    cluster_arrive();
    if (t + 1 < p.T) window(2, t + 1);
    cluster_wait();
    stamp(t, 5);

    // FC1 on [xr | a3] -> A
    if constexpr (G8) {
      quantize(Q_X2, bbuf, H);
      __syncthreads();
    }
    ff_dot(D_FC1, G8 ? reinterpret_cast<unsigned char*>(plane) : bbuf, H, 1,
           nf, Fo, 0, p.w_fc1x, f0, F);
    __syncthreads();
    for (int i0 = tid - lane; i0 < nf * Rt; i0 += NT) {
      const int i = i0 + lane;
      uint32_t mf = 0u;
      if (i < nf * Rt) {
        const int jl = i / Rt, r = i % Rt, j = f0 + jl;
        const float f1v = fmaxf(
            add(add(ff_col(D_FC1, Q_X2, 1, Fo, jl, r, c_fsf1),
                    bf_col(D_AUX3, jl, r)),
                c_bf1[jl]), 0.f);
        put_ff(abuf, 2, j, r, f1v);
        mf = abits(f1v);
      }
      if constexpr (G8) commit_rows(own_max(Q_F1), K, mf, i, Rt);
    }
    __syncthreads();
    stamp(t, 6);
    if constexpr (G8)
      push_g8(K, me, Rt, f0, nf, reinterpret_cast<float*>(abuf), nullptr, F,
              qmax(Q_F1), 1);
    else
      push(cl, K, me, abuf + f0 * Rt * fsz, nf * Rt * fsz, nullptr, 0);
    cluster_arrive();
    if (t + 1 < p.T) window(3, t + 1);
    cluster_wait();
    stamp(t, 7);

    // FC2 on [f1 | a4] -> the CTA's f2 columns (bf16-rounded doubles, its
    // rows of FC3's operand)
    if constexpr (G8) {
      quantize(Q_F1, abuf, F);
      __syncthreads();
      clear_max(Q_F1);
    }
    ff_dot(D_FC2, G8 ? reinterpret_cast<unsigned char*>(plane) : abuf, F, 1,
           nf, Fo, 0, p.w_fc2x, f0, F);
    __syncthreads();
    for (int i = tid; i < nf * Rt; i += NT) {
      const int jl = i / Rt, r = i % Rt;
      f2[i] = bfr64(fmaxf(
          add(add(ff_col(D_FC2, Q_F1, 1, Fo, jl, r, c_fsf2),
                  bf_col(D_AUX4, jl, r)),
              c_bf2[jl]), 0.f));
    }
    __syncthreads();
    stamp(t, 8);
    // FC3 over the CTA's rows of f2: its float64 partial logits, pushed to
    // slot ``me`` of every CTA
    {
      int first = 0;
      dot::dot_bf16_rows<NT, RC, 1>(part(D_FC3), f2, Rt, nf, NO, 1,
                                    NO, 0, p.w_fc3 + (size_t)f0 * NO, NO,
                                    p.sp[D_FC3], first);
    }
    __syncthreads();
    double* l3 = reinterpret_cast<double*>(sm + p.o_l3);
    double* l3me = reinterpret_cast<double*>(sm + p.o_l3 + me * p.l3bytes);
    for (int i = tid; i < NO * Rt; i += NT) {
      double s = 0.0;
      for (int k = 0; k < p.sp[D_FC3].S; ++k)
        s += part(D_FC3)[(size_t)k * NO * Rt + i];
      l3me[i] = s;
    }
    __syncthreads();
    stamp(t, 9);
    push(cl, K, me, reinterpret_cast<unsigned char*>(l3me), p.l3bytes,
         nullptr, 0);
    cluster_arrive();
    if (t + 1 < p.T) window(4, t + 1);
    stamp(t, 10);
    cluster_wait();
    stamp(t, 11);

    // the logits (the CTAs' partials added in rank order, the same in
    // every CTA) and the sample of each row
    const int warp = tid / 32;
    for (int r = warp; r < Rt; r += NT / 32) {
      const int b = b0 + r;
      float* lg = logits + r * NO;
      for (int i = lane; i < NO; i += 32) {
        double s = 0.0;
        for (int q = 0; q < K; ++q) s += l3[q * (p.l3bytes / 8) + i * Rt + r];
        lg[i] = add(__double2float_rn(s), c_bf3[i]);
      }
      __syncwarp();
      const float sample = sample_row(lg, NO, p.mode, p.det, p.seed,
                                      p.row0 + b, t, lane);
      if (lane == 0) {
        xs[r] = sample;
        if (me == 0 && b < p.B) p.out[(size_t)b * p.T + t] = sample;
      }
    }
  }
  cl.sync();   // no CTA leaves while a peer may still read or write it
}

template <int RC, bool I8, bool FF, bool G8, bool SPANS = false>
cudaError_t set_attributes(int K, int bytes) {
  auto fn = decode_cluster_kernel<RC, I8, FF, G8, SPANS>;
  cudaError_t e = cudaSuccess;
  if (K > 8)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  return e;
}

cudaLaunchConfig_t config(int K, int clusters, int bytes, cudaStream_t s,
                          cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * K, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = K;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

template <int RC, bool I8, bool FF, bool G8, bool SPANS = false>
cudaError_t launch(const CParams& p, int clusters, cudaStream_t s) {
  const int bytes = p.bytes > ONE_PER_SM ? p.bytes : ONE_PER_SM;
  cudaError_t e = set_attributes<RC, I8, FF, G8, SPANS>(p.K, bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = config(p.K, clusters, bytes, s, at);
  e = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<RC, I8, FF, G8, SPANS>,
                         p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int RC>
cudaError_t launch_variant(const CParams& p, bool i8, bool ff, bool g8,
                           int clusters, cudaStream_t s) {
  if (g8) return launch<RC, true, true, true>(p, clusters, s);
  if (i8) return ff ? launch<RC, true, true, false>(p, clusters, s)
                    : launch<RC, true, false, false>(p, clusters, s);
  return ff ? launch<RC, false, true, false>(p, clusters, s)
            : launch<RC, false, false, false>(p, clusters, s);
}

template <bool I8, bool FF, bool G8>
cudaError_t max_clusters(int* out, int K) {
  cudaError_t e = set_attributes<1, I8, FF, G8>(K, ONE_PER_SM);
  if (e != cudaSuccess) return e;
  int sms = 0, dev = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = config(K, sms / K > 0 ? sms / K : 1, ONE_PER_SM,
                                  nullptr, at);
  return cudaOccupancyMaxActiveClusters(
      out, decode_cluster_kernel<1, I8, FF, G8, false>, &cfg);
}

void plan_dims(CParams& p, const long long* dims) {
  p.H = (int)dims[0]; p.F = (int)dims[1]; p.feat = (int)dims[2];
  p.d = (int)dims[3]; p.n_out = (int)dims[4];
  p.C = p.feat + 4 * p.d;
}

// The launch's parameters from the entry point's arrays; false for a plan
// the kernel does not take or that disagrees with the caller's.
bool parse(CParams& p, const void* const* ptrs, const long long* dims,
           bool& i8, bool& ff, bool& g8, int& RC, int& clusters) {
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
  i8 = dims[11] != 0;
  ff = dims[12] != 0;
  p.seed = (uint32_t)dims[13];
  p.row0 = (uint32_t)dims[14];
  const int K = (int)dims[15], Rt = (int)dims[16];
  RC = (int)dims[17];
  clusters = (int)dims[18];
  const int budget = (int)dims[19];
  const long long want = dims[20];
  g8 = dims[21] != 0;
  if (p.H % 16 || p.F % (ff ? 16 : 8) || p.C != p.feat + 4 * p.d)
    return false;
  if (!make_plan(p, K, Rt, RC, budget, i8, ff, g8) || p.bytes != want)
    return false;
  p.cond_async = p.C % 8 == 0
                 && (reinterpret_cast<uintptr_t>(p.cond) & 15) == 0;
  return clusters >= 1 && (long long)clusters * Rt >= p.B
         && (long long)(clusters - 1) * Rt < p.B;
}

}  // namespace

extern "C" long long wavernn_decode_cluster_bytes(const long long* dims) {
  CParams p = {};
  plan_dims(p, dims);
  if (!make_plan(p, (int)dims[7], (int)dims[8], (int)dims[9], (int)dims[10],
                 dims[5] != 0, dims[6] != 0, dims[11] != 0))
    return -1;
  return p.bytes;
}

extern "C" int wavernn_decode_cluster_max(int* out, const long long* dims) {
  const int K = (int)dims[0];
  const bool i8 = dims[1] != 0, ff = dims[2] != 0, g8 = dims[3] != 0;
  *out = 0;
  if (K < 1 || K > KMAX || (g8 && !(i8 && ff))) return cudaErrorInvalidValue;
  if (g8) return max_clusters<true, true, true>(out, K);
  if (i8) return ff ? max_clusters<true, true, false>(out, K)
                    : max_clusters<true, false, false>(out, K);
  return ff ? max_clusters<false, true, false>(out, K)
            : max_clusters<false, false, false>(out, K);
}

extern "C" int wavernn_decode_cluster(const void* const* ptrs,
                                      const long long* dims, void* stream) {
  CParams p = {};
  bool i8, ff, g8;
  int RC, clusters;
  if (!parse(p, ptrs, dims, i8, ff, g8, RC, clusters))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return RC == 1 ? launch_variant<1>(p, i8, ff, g8, clusters, s)
                 : launch_variant<2>(p, i8, ff, g8, clusters, s);
}

// Dev only: the int8_hh + int8_ff or the int8_gates kernel with the SPANS
// stamps into ``spans`` ((T, NSPAN) of the first cluster's rank 0).
extern "C" int wavernn_decode_cluster_spans(const void* const* ptrs,
                                            const long long* dims,
                                            void* stream, void* spans) {
  CParams p = {};
  bool i8, ff, g8;
  int RC, clusters;
  if (!parse(p, ptrs, dims, i8, ff, g8, RC, clusters) || !i8 || !ff)
    return cudaErrorInvalidValue;
  p.spans = static_cast<unsigned long long*>(spans);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g8)
    return RC == 1 ? launch<1, true, true, true, true>(p, clusters, s)
                   : launch<2, true, true, true, true>(p, clusters, s);
  return RC == 1 ? launch<1, true, true, false, true>(p, clusters, s)
                 : launch<2, true, true, false, true>(p, clusters, s);
}
