// The weight-streaming dot of the sample-loop kernels (decode.cu and its
// yardstick twin matmul_floor.cu), for Hopper (sm_90a).
//
// One CTA computes, for its R rows, the dot of an activation held in shared
// memory (k-major, [K][R]) with a weight matrix in global memory (row-major
// (K, N), leading dimension ldw).  The weights are read once per CTA and
// call, and every weight meets all R rows.
//
// Split.  A task is a group of V consecutive output columns and a slice of
// at most L consecutive k rows; the S slices of a column are S tasks.  Task
// i takes column group i % G and slice i / G, so the 32 threads of a warp
// read 32 neighbouring groups of one k row: with V = 8 bf16 or 16 int8
// columns, one 16-byte load per thread and 512 contiguous bytes per warp.
// The dots of one phase hand out their tasks in turn over the CTA's
// threads, each dot starting at the thread after the last one's last task
// (``first``), so that a small dot fills the threads a large one leaves
// idle.  Each task writes its partial sums to shared memory ([S][N][R]); the
// phase's epilogue adds a column's S partials in slice order (psum), so the
// result does not depend on scheduling and is the same from run to run.
//
// Arithmetic.  bf16 dots: the activation is held as double (bf16-rounded,
// converted once per step, scaled by ACT_SCALE), each weight is turned into
// a double by integer ops and used for all R rows, and the exact products
// are summed in float64; the epilogue rounds the column's sum once to
// float32.  int8 dots: the activation is quantised to int8 and packed four
// k rows to a 32-bit word, four k rows of 16 weight columns are transposed
// into the same packing with byte permutes, and __dp4a sums the products
// into int32: exact, so the result is the integer sum itself.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dot {

// S slices of L rows (the last one may be shorter).
struct Split {
  int S, L;
};

// The split of a K-row dot with G column groups over nt threads: as many
// slices as leave each group's slices one thread each (nt / G), no slice
// under ``min_rows`` rows, at most smax slices; L a multiple of ``align``.
__host__ __device__ inline Split split(int K, int G, int nt, int align,
                                       int smax, int min_rows) {
  if (K <= 0) return {1, align};
  int S = G > 0 ? nt / G : 1;
  const int cap = K / min_rows;
  if (S > cap) S = cap;
  if (S > smax) S = smax;
  if (S < 1) S = 1;
  int L = (K + S - 1) / S;
  L = (L + align - 1) / align * align;
  return {(K + L - 1) / L, L};
}

// The first task of this thread when the dot's tasks start at thread
// ``first``.
template <int NT>
__device__ __forceinline__ int first_task(int first) {
  return ((int)threadIdx.x - first + NT) % NT;
}

// The activation's scale: a dot's operand is held as a * 2^896, so that a
// weight w enters as the double w * 2^-896, whose bits are the bf16's own
// bits shifted into place.  Exact for every finite bf16, subnormals and
// zeros included (w * 2^-896 is then a subnormal double, which the float64
// FMA takes at full rate), and a * 2^896 stays finite for every finite
// bf16 a; each product (a * 2^896) * (w * 2^-896) is a * w exactly.
constexpr double ACT_SCALE = 0x1p896;

__device__ __forceinline__ double act(double a) { return a * ACT_SCALE; }

// w * 2^-896 for the bf16 w in the high half of x, from two integer ops
// (an arithmetic shift keeps the sign in bit 31 and clears the exponent's
// top three bits; the mask drops the low half) instead of a conversion,
// which would take four float64 FMAs' issue slots.
__device__ __forceinline__ double bf_scaled(uint32_t x) {
  const uint32_t hi = static_cast<uint32_t>(static_cast<int>(x) >> 3)
                      & 0x8fffe000U;
  return __hiloint2double(static_cast<int>(hi), 0);
}
__device__ __forceinline__ double lo_bf(uint32_t w) { return bf_scaled(w << 16); }
__device__ __forceinline__ double hi_bf(uint32_t w) { return bf_scaled(w); }

// One k row of a V-column group, as loaded: 8 bf16 in a uint4 or one in
// the low half of a word.
template <int V>
using Raw = typename std::conditional<V == 8, uint4, uint32_t>::type;

template <int V>
__device__ __forceinline__ Raw<V> load_raw(const __nv_bfloat16* p) {
  static_assert(V == 8 || V == 1, "8 columns (16 bytes) or one");
  if constexpr (V == 8) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return __bfloat16_as_ushort(__ldg(p));
  }
}

// acc[c][r] += a[r] * w[c] for the V weights of one loaded k row.
template <int R, int V>
__device__ __forceinline__ void fma_row(double (&acc)[V][R], Raw<V> q,
                                        const double* a) {
  double w[V], av[R];
  if constexpr (V == 8) {
    w[0] = lo_bf(q.x); w[1] = hi_bf(q.x);
    w[2] = lo_bf(q.y); w[3] = hi_bf(q.y);
    w[4] = lo_bf(q.z); w[5] = hi_bf(q.z);
    w[6] = lo_bf(q.w); w[7] = hi_bf(q.w);
  } else {
    w[0] = lo_bf(q);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) av[r] = a[r];
#pragma unroll
  for (int c = 0; c < V; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[c][r] = fma(av[r], w[c], acc[c][r]);
}

// part[s][n][r] = sum over k in slice s of a[k][r] * w[k][n], for the N
// columns of a bf16 matrix, in V-column groups (V divides N; with V = 8,
// w and ldw are 16-byte aligned); a holds act() of the operand.
template <int NT, int R, int V>
__device__ __forceinline__ void dot_bf16(double* part, const double* a,
                                         int K, int N,
                                         const __nv_bfloat16* w, int ldw,
                                         Split sp, int& first) {
  const int G = N / V, tasks = G * sp.S;
  for (int i = first_task<NT>(first); i < tasks; i += NT) {
    const int g = i % G, s = i / G;
    const int k0 = s * sp.L, k1 = min(K, k0 + sp.L);
    double acc[V][R];
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = 0.0;
    const __nv_bfloat16* wp = w + (size_t)k0 * ldw + g * V;
#pragma unroll 4
    for (int k = k0; k < k1; ++k, wp += ldw)
      fma_row<R, V>(acc, load_raw<V>(wp), a + k * R);
    double* o = part + ((size_t)s * N + g * V) * R;
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) o[c * R + r] = acc[c][r];
  }
  first = (first + tasks) % NT;
}

// Four words of four int8 weights each (k rows k..k+3, columns c..c+3) ->
// four words of one column each (k rows in bytes 0..3), as the activation
// is packed.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&t)[4]) {
  const uint32_t a = __byte_perm(r0, r1, 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const uint32_t b = __byte_perm(r0, r1, 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const uint32_t c = __byte_perm(r2, r3, 0x5140);
  const uint32_t d = __byte_perm(r2, r3, 0x7362);
  t[0] = __byte_perm(a, c, 0x5410);
  t[1] = __byte_perm(a, c, 0x7632);
  t[2] = __byte_perm(b, d, 0x5410);
  t[3] = __byte_perm(b, d, 0x7632);
}

// acc[p][c][r] += the dot of four k rows of column c (q: four loaded k rows
// of 16 columns) with the packed activation plane p of row r.
template <int R, int NW>
__device__ __forceinline__ void dp4a_rows(int (&acc)[NW][16][R],
                                          const uint4 (&q)[4],
                                          const uint32_t* aq,
                                          const uint32_t* ah, int at) {
  int av[NW][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    av[0][r] = static_cast<int>(aq[at + r]);
    if constexpr (NW == 2) av[1][r] = static_cast<int>(ah[at + r]);
  }
  uint32_t t[4][4];
  transpose4(q[0].x, q[1].x, q[2].x, q[3].x, t[0]);
  transpose4(q[0].y, q[1].y, q[2].y, q[3].y, t[1]);
  transpose4(q[0].z, q[1].z, q[2].z, q[3].z, t[2]);
  transpose4(q[0].w, q[1].w, q[2].w, q[3].w, t[3]);
#pragma unroll
  for (int p = 0; p < NW; ++p)
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[p][c][r] = __dp4a(static_cast<int>(t[c / 4][c % 4]), av[p][r],
                              acc[p][c][r]);
}

// part[s][n][r] = sum over k in slice s of q[k][r] * w[k][n], for the N
// columns of an int8 matrix in 16-column groups (16 divides N and ldw, w
// is 16-byte aligned, K and L are multiples of 4).  The activation q is
// packed four k rows to a word: aq[k / 4][r].  With NW = 2 an activation
// outside the int8 range is split as q = 256 * hi + lo over two planes (ah
// holds the hi bytes) and the sum is 256 * sum(hi) + sum(lo), exact while
// |q| < 2^15 and the sum fits int32.
template <int NT, int R, int NW>
__device__ __forceinline__ void dot_i8(int* part, const uint32_t* aq,
                                       const uint32_t* ah, int K, int N,
                                       const int8_t* w, int ldw, Split sp,
                                       int& first) {
  const int G = N / 16, tasks = G * sp.S;
  for (int i = first_task<NT>(first); i < tasks; i += NT) {
    const int g = i % G, s = i / G;
    const int k0 = s * sp.L, k1 = min(K, k0 + sp.L);
    int acc[NW][16][R];
#pragma unroll
    for (int p = 0; p < NW; ++p)
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[p][c][r] = 0;
    const int8_t* wp = w + (size_t)k0 * ldw + g * 16;
#pragma unroll 2
    for (int k = k0; k < k1; k += 4, wp += (size_t)4 * ldw) {
      uint4 q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)j * ldw));
      dp4a_rows<R, NW>(acc, q, aq, ah, (k / 4) * R);
    }
    int* o = part + ((size_t)s * N + g * 16) * R;
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r)
        o[c * R + r] = NW == 2 ? acc[NW - 1][c][r] * 256 + acc[0][c][r]
                               : acc[0][c][r];
  }
  first = (first + tasks) % NT;
}

// The cluster kernel's dots (decode_cluster.cu): a CTA computes its slice
// of a matrix's columns for Rt rows, RC of them a task (held in registers).
// The slice is ng gates of N columns each (gate g's first column at w + g *
// gs); its partial column of gate g, column n, is g * np + n (np >= N: the
// most columns any CTA of the cluster owns, so that every CTA has one
// layout).  Task i takes row chunk i % NRC, column group (i / NRC) % G and
// slice i / (NRC * G): the lanes of a warp that share a column group share
// its weight addresses, so a weight is fetched once per warp load for all
// Rt rows.

// part[s][g * np + n][r], as dot_bf16's partial sums; a holds [K][Rt].
template <int NT, int RC, int V>
__device__ __forceinline__ void dot_bf16_rows(double* part, const double* a,
                                              int Rt, int K, int N, int ng,
                                              int np, int gs,
                                              const __nv_bfloat16* w, int ldw,
                                              Split sp, int& first) {
  const int NRC = Rt / RC, GN = N / V, G = ng * GN, tasks = NRC * G * sp.S;
  for (int i = first_task<NT>(first); i < tasks; i += NT) {
    const int rc = i % NRC, gg = (i / NRC) % G, s = i / (NRC * G);
    const int g = gg / GN, c0 = (gg % GN) * V, r0 = rc * RC;
    const int k0 = s * sp.L, k1 = min(K, k0 + sp.L);
    double acc[V][RC];
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < RC; ++r) acc[c][r] = 0.0;
    const __nv_bfloat16* wp = w + (size_t)k0 * ldw + (size_t)g * gs + c0;
#pragma unroll 8
    for (int k = k0; k < k1; ++k, wp += ldw)
      fma_row<RC, V>(acc, load_raw<V>(wp), a + k * Rt + r0);
    double* o = part + ((size_t)s * ng * np + g * np + c0) * Rt + r0;
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < RC; ++r) o[c * Rt + r] = acc[c][r];
  }
  first = (first + tasks) % NT;
}

// The place of column n (of ng * np), row r in an int8 dot's sums: one pad
// word every 16 columns, so that the 16-column groups of a warp's lanes
// fall in different banks.
__device__ __forceinline__ int acc_at(int n, int r, int Rt) {
  return (n + (n >> 4)) * Rt + r;
}

// acc[acc_at(g * np + n, r)] += the int8 dot (int32, exact, so the slices
// add in any order: with atomics, into sums the consumer set to 0); aq
// packs [K / 4][Rt] four k rows to a word.
template <int NT, int RC>
__device__ __forceinline__ void dot_i8_rows(int* acc_out, const uint32_t* aq,
                                            int Rt, int K, int N, int ng,
                                            int np, int gs, const int8_t* w,
                                            int ldw, Split sp, int& first) {
  const int NRC = Rt / RC, GN = N / 16, G = ng * GN, tasks = NRC * G * sp.S;
  for (int i = first_task<NT>(first); i < tasks; i += NT) {
    const int rc = i % NRC, gg = (i / NRC) % G, s = i / (NRC * G);
    const int g = gg / GN, c0 = (gg % GN) * 16, r0 = rc * RC;
    const int k0 = s * sp.L, k1 = min(K, k0 + sp.L);
    int acc[1][16][RC];
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int r = 0; r < RC; ++r) acc[0][c][r] = 0;
    const int8_t* wp = w + (size_t)k0 * ldw + (size_t)g * gs + c0;
#pragma unroll 4
    for (int k = k0; k < k1; k += 4, wp += (size_t)4 * ldw) {
      uint4 q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)j * ldw));
      dp4a_rows<RC, 1>(acc, q, aq, nullptr, (k / 4) * Rt + r0);
    }
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int r = 0; r < RC; ++r)
        atomicAdd(acc_out + acc_at(g * np + c0 + c, r0 + r, Rt), acc[0][c][r]);
  }
  first = (first + tasks) % NT;
}

// Column n, row r of a split dot: its S partial sums added in slice order,
// rounded once to float32.
template <int R>
__device__ __forceinline__ float psum(const double* part, int S, int N,
                                      int n, int r) {
  double s = 0.0;
  for (int i = 0; i < S; ++i) s += part[((size_t)i * N + n) * R + r];
  return __double2float_rn(s);
}
template <int R>
__device__ __forceinline__ float psum(const int* part, int S, int N, int n,
                                      int r) {
  int s = 0;
  for (int i = 0; i < S; ++i) s += part[((size_t)i * N + n) * R + r];
  return __int2float_rn(s);
}

// Byte k of row r of an int8 activation packed four k rows to a word,
// [K / 4][R], as dot_i8 reads it (byte b of a word is k row 4 * (k / 4) +
// b), set to q in [-128, 127]: a thread that owns column k of an epilogue
// writes its own byte, and no packing pass is needed.
template <int R>
__device__ __forceinline__ void store_i8(uint32_t* aq, int k, int r, int q) {
  reinterpret_cast<int8_t*>(aq)[((k / 4) * R + r) * 4 + k % 4] =
      static_cast<int8_t>(q);
}

// An int8 activation [K][R] (float, integer-valued after rintf(v * 127))
// packed four k rows to a word, [K / 4][R]; ``hi`` gets the planes' high
// bytes (q = 256 * hi + lo).  Returns whether any value left the int8 range.
template <int NT, int R>
__device__ __forceinline__ bool pack_i8(uint32_t* lo, uint32_t* hi,
                                        const float* v, int K) {
  bool wide = false;
  for (int i = threadIdx.x; i < (K / 4) * R; i += NT) {
    const int r = i % R, k = (i / R) * 4;
    uint32_t l = 0, h = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int q = __float2int_rn(__fmul_rn(v[(k + b) * R + r], 127.f));
      const int ql = static_cast<int8_t>(q & 0xff);
      const int qh = (q - ql) >> 8;
      wide |= qh != 0;
      l |= static_cast<uint32_t>(ql & 0xff) << (8 * b);
      h |= static_cast<uint32_t>(qh & 0xff) << (8 * b);
    }
    lo[i] = l;
    if (hi != nullptr) hi[i] = h;
  }
  return wide;
}

// Operands quantized on the fly (decode.cu's G8, tts_decode.cu's I8L, the
// TPU kernels' ``int8_gates`` / ``int8_lstm``): a row's scale from the bits
// of its largest |value| (a float >= 0, so its bits order as unsigned
// integers do): sa = max(m, 1e-8) * float32(1/127), in float32.
__device__ __forceinline__ float row_scale(uint32_t mbits) {
  return __fmul_rn(fmaxf(__uint_as_float(mbits), 1e-8f), 1.0f / 127.0f);
}

// round(v / sa) (a true division, half to even) as an int8 byte; |v| <= m
// keeps it within [-127, 127].  A zero v (relu's, h(-1)'s) gives 0 without
// dividing it: the division's range check sends a zero dividend down its
// slow path.
__device__ __forceinline__ uint32_t quant_byte(float v, float sa) {
  const bool zero = v == 0.f;
  const int q = __float2int_rn(__fdiv_rn(zero ? sa : v, sa));
  return zero ? 0u : static_cast<uint32_t>(q & 0xff);
}

// quant_byte's byte without its division, from rs = __frcp_rn(sa).  For
// |v / sa| < 128, v * rs (two roundings) and the rounded quotient both lie
// within 2^-16 of v / sa, so they round to the same integer unless v * rs
// is within 2^-12 of a half-integer: there ``tie`` is set, and the caller
// takes quant_byte instead (about one value in 2,000).  A zero v gives 0,
// as there.
__device__ __forceinline__ uint32_t quant_byte_rcp(float v, float rs,
                                                   bool& tie) {
  const float q = __fmul_rn(v, rs);
  const float r = rintf(q);
  tie |= fabsf(__fsub_rn(q, r)) > 0.5f - 0x1p-12f;
  return static_cast<uint32_t>(__float2int_rn(r) & 0xff);
}

// Add this thread's largest |values| m[r] to each row's maximum amax[r]
// (shared memory): a warp's maximum, then one atomicMax a warp.  Every
// thread of the CTA calls it.
template <int R>
__device__ __forceinline__ void commit_max(uint32_t* amax,
                                           const uint32_t (&m)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t w = __reduce_max_sync(0xffffffffU, m[r]);
    if ((threadIdx.x & 31) == 0 && w != 0) atomicMax(amax + r, w);
  }
}

// The activation v [K][R] quantized at each row's scale (from amax[r],
// the bits of the row's largest |value|), packed four k rows to a word,
// [K / 4][R], as dot_i8 reads it.
template <int NT, int R>
__device__ __forceinline__ void pack_scaled(uint32_t* aq, const float* v,
                                            int K, const uint32_t* amax) {
  for (int i = threadIdx.x; i < (K / 4) * R; i += NT) {
    const int r = i % R, k = (i / R) * 4;
    const float sa = row_scale(amax[r]);
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) w |= quant_byte(v[(k + b) * R + r], sa) << (8 * b);
    aq[i] = w;
  }
}

}  // namespace dot
