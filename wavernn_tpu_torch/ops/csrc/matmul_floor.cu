// The decode step's matmul floor: T serial steps of six bf16 dots, for
// Hopper (sm_90a).
//
// Replaces tools/kernel_breakdown.py::matmul_only_kernel (launched by
// run_matmul_only).  Per step and row, with hb = bf16(h):
//
//   g1..g4 = hb @ w1..w4      (H, 3H) each
//   f1, f2 = hb @ wf1, wf2    (H, H) each
//   h      = tanh(g1[:H] + g2[H:2H] + g3[2H:] + g4[:H] + f1 + f2)
//
// Every step computes all 4 * 3H + 2 * H columns, as the TPU kernel's
// whole-matrix dots do.  The formula keeps 6 * H of them; the other 8 * H
// go into a float64 running sum per row (``sink``, with ``sink_abs`` the
// sum of their absolute values), so that no product can be dropped as
// dead code and the floor times the same work as the TPU kernel.
//
// Design: the decode kernel's dots, on purpose.  The floor's job is to say
// what share of the decode step its weight-streaming dots cost, so it
// streams its weights with the same routine (csrc/dot.cuh) in the decode
// kernel's production shape: one persistent CTA of 1,024 threads per row
// (R = 1) for all T steps, the bf16-rounded state held as double in shared
// memory, each thread loading 16 bytes (8 columns of one k row) at a time,
// float64 sums of the exact products rounded once to float32.  Its six
// dots are one phase, each column cut into at most two K-slices (the
// 7,168 columns' partial sums take 115 KB of shared memory): 1,792 tasks
// over 1,024 threads.  The plain version
// (ops/matmul_floor.py::matmul_floor_reference) sums the same products in
// float64 too, so the two agree to the bit nearly always.
//
// What bounds it: not the card's rates.  The work is bf16 tensor-core
// bound at ~0.97 ms for B = 64, T = 2,048 (7.3 MB of weights); each CTA
// turns every weight (3.67 M per step) into a double with integer ops and
// runs a float64 FMA on it, ~4.8 issued instructions per weight, on B of
// the 132 SMs, so the SM's instruction issue and each thread's chain of
// L2 round trips (its loads go out one at a time) set the pace.  On an
// H100 (700 W) it takes 102.33 us per step at B = 64, T = 2,048 (PR 3's
// design, a thread per column walking K one 2-byte load at a time: 298.43
// in the same PR's measurement).
//
// Entry point (plain C, bound with ctypes):
//   int matmul_floor(const void* const* ptrs, const long long* dims,
//                    void* stream)
// ptrs = h0 (B, H) f32, h (B, H) f32, sink (B,) f64, sink_abs (B,) f64,
//        w1, w2, w3, w4 (H, 3H) bf16, wf1, wf2 (H, H) bf16;
// dims = B, T, H.  Returns a cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dot.cuh"

namespace {

constexpr int NT = 1024;  // the decode kernel's threads at one row per CTA
constexpr int NWARP = NT / 32;
constexpr int R = 1;

struct Params {
  const float* h0;
  float* h;
  double* sink;
  double* sink_abs;
  const __nv_bfloat16* w[6];  // w1..w4, wf1, wf2
  int B, T, H;
  dot::Split sp[6];
  int off[6];                 // each dot's partial sums, in doubles
  int scratch;                // doubles of partial sums
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
// the state as a dot operand: bf16-rounded, as double at the dots' scale
__device__ __forceinline__ double bfr(float v) {
  return dot::act(static_cast<double>(__bfloat162float(__float2bfloat16_rn(v))));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffU, v, o);
  return v;
}

__global__ void __launch_bounds__(NT) floor_kernel(Params p) {
  extern __shared__ __align__(16) double sm[];
  const int H = p.H;
  // sm: the partial sums, the state [H][R] twice (read one buffer, write
  // the other), then the block sums [NWARP][2R]
  double* state = sm + p.scratch;
  double* red = state + 2 * H * R;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * R;

  for (int i = tid; i < H * R; i += NT) {
    const int r = i % R, k = i / R, b = b0 + r;
    state[i] = b < p.B ? bfr(p.h0[(size_t)b * H + k]) : 0.0;
  }
  double sink[R], sabs[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { sink[r] = 0.0; sabs[r] = 0.0; }
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const double* cur = state + (t & 1) * H * R;
    double* nxt = state + ((t + 1) & 1) * H * R;
    int first = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m)
      dot::dot_bf16<NT, R, 8>(sm + p.off[m], cur, H, m < 4 ? 3 * H : H,
                              p.w[m], m < 4 ? 3 * H : H, p.sp[m], first);
    __syncthreads();
    for (int j = tid; j < H; j += NT) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v[4][3];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            v[m][c] = dot::psum<R>(sm + p.off[m], p.sp[m].S, 3 * H,
                                   c * H + j, r);
        // the kept columns, added in the JAX order
        float a = add(v[0][0], v[1][1]);
        a = add(a, v[2][2]);
        a = add(a, v[3][0]);
        a = add(a, dot::psum<R>(sm + p.off[4], p.sp[4].S, H, j, r));
        a = add(a, dot::psum<R>(sm + p.off[5], p.sp[5].S, H, j, r));
        const float hn = tanhf(a);
        nxt[j * R + r] = bfr(hn);
        if (t == p.T - 1 && b0 + r < p.B) p.h[(size_t)(b0 + r) * H + j] = hn;
        // the discarded columns
        const float d[8] = {v[0][1], v[0][2], v[1][0], v[1][2],
                            v[2][0], v[2][1], v[3][1], v[3][2]};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          sink[r] += static_cast<double>(d[c]);
          sabs[r] += fabs(static_cast<double>(d[c]));
        }
      }
    }
    __syncthreads();
  }

  // block sums of the discarded columns: warps, then warp 0
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const double s = warp_sum(sink[r]), a = warp_sum(sabs[r]);
    if (lane == 0) { red[warp * 2 * R + r] = s; red[warp * 2 * R + R + r] = a; }
  }
  __syncthreads();
  if (tid < 2 * R) {
    double s = 0.0;
    for (int w = 0; w < NWARP; ++w) s += red[w * 2 * R + tid];
    const int r = tid % R, b = b0 + r;
    if (b < p.B) (tid < R ? p.sink : p.sink_abs)[b] = s;
  }
}

}  // namespace

extern "C" int matmul_floor(const void* const* ptrs, const long long* dims,
                            void* stream) {
  Params p;
  p.h0 = static_cast<const float*>(ptrs[0]);
  p.h = static_cast<float*>(const_cast<void*>(ptrs[1]));
  p.sink = static_cast<double*>(const_cast<void*>(ptrs[2]));
  p.sink_abs = static_cast<double*>(const_cast<void*>(ptrs[3]));
  for (int m = 0; m < 6; ++m)
    p.w[m] = static_cast<const __nv_bfloat16*>(ptrs[4 + m]);
  p.B = (int)dims[0]; p.T = (int)dims[1]; p.H = (int)dims[2];
  int off = 0;
  for (int m = 0; m < 6; ++m) {
    const int N = m < 4 ? 3 * p.H : p.H;
    p.sp[m] = dot::split(p.H, N / 8, NT, 1, 2, 32);
    p.off[m] = off;
    off += p.sp[m].S * N * R;
  }
  p.scratch = off;
  const size_t bytes = ((size_t)off + 2 * p.H * R + NWARP * 2 * R)
                       * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int grid = (p.B + R - 1) / R;
  floor_kernel<<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
