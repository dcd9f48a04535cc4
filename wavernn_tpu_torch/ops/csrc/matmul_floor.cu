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
// Design: the same structure as csrc/decode.cu, on purpose.  The floor's
// job is to say what share of the decode step its weight-streaming dots
// cost, so it streams its weights the way the decode kernel does: one
// persistent CTA per R = 2 rows for all T steps, the bf16-rounded state
// k-major ([H][R]) in shared memory so that one weight element, loaded
// once, meets both rows, each thread owning output columns and walking K
// one 2-byte weight at a time through L2, with float64 sums of the exact
// bf16 products rounded once to float32.  The plain version
// (ops/matmul_floor.py::matmul_floor_reference) sums the same products in
// float64 too, so the two agree to the bit nearly always.
//
// What bounds it: not the card's rates.  The work is bf16 tensor-core
// bound at ~5.8 ms for B = 64, T = 12,160 (0.47 us per step; 7.3 MB of
// weights); this kernel takes ~400 us per step on an H100 (PERF.md).  Each
// CTA re-reads all the weights from L2 at every step, a thread walking its
// columns' K one 2-byte load at a time, converting each weight and state
// value to float64 and chaining float64 FMAs, on B / 2 of the 132 SMs: the
// per-thread serial chain sets the pace, as in decode.cu.  A design that
// approaches the bound (wgmma, weights resident across SMs) belongs to the
// decode kernel's redesign.
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

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int R = 2;

struct Params {
  const float* h0;
  float* h;
  double* sink;
  double* sink_abs;
  const __nv_bfloat16* w[4];
  const __nv_bfloat16* wf[2];
  int B, T, H;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[g][r] += sum_k a[k][r] * w[k][j + g*gs], g < G, over the k-major
// [K][R] state; float64 sums of the exact bf16 products.
template <int G>
__device__ __forceinline__ void dot(double (&acc)[G][R], const float* a,
                                    int K, const __nv_bfloat16* w, int ldw,
                                    int j, int gs) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    double wv[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      wv[g] = static_cast<double>(
          __bfloat162float(__ldg(w + (size_t)k * ldw + j + g * gs)));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const double v = static_cast<double>(a[k * R + r]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g][r] = fma(v, wv[g], acc[g][r]);
    }
  }
}

template <int G>
__device__ __forceinline__ void zero(double (&acc)[G][R]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[g][r] = 0.0;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffU, v, o);
  return v;
}

__global__ void __launch_bounds__(NT) floor_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int H = p.H;
  // sm: the state, [H][R] twice (read one buffer, write the other), then
  // the block sums [NWARP][2R] as double
  double* red = reinterpret_cast<double*>(sm + 2 * H * R);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * R;

  for (int i = tid; i < H * R; i += NT) {
    const int r = i % R, k = i / R, b = b0 + r;
    sm[i] = b < p.B ? bfr(p.h0[(size_t)b * H + k]) : 0.f;
  }
  double sink[R], sabs[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { sink[r] = 0.0; sabs[r] = 0.0; }
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const float* cur = sm + (t & 1) * H * R;
    float* nxt = sm + ((t + 1) & 1) * H * R;
    for (int j = tid; j < H; j += NT) {
      double g[4][3][R], f[2][1][R];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        zero(g[m]);
        dot<3>(g[m], cur, H, p.w[m], 3 * H, j, H);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        zero(f[m]);
        dot<1>(f[m], cur, H, p.wf[m], H, j, 0);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v[4][3];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int c = 0; c < 3; ++c) v[m][c] = __double2float_rn(g[m][c][r]);
        // the kept columns, added in the JAX order
        float a = add(v[0][0], v[1][1]);
        a = add(a, v[2][2]);
        a = add(a, v[3][0]);
        a = add(a, __double2float_rn(f[0][0][r]));
        a = add(a, __double2float_rn(f[1][0][r]));
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
  for (int m = 0; m < 4; ++m)
    p.w[m] = static_cast<const __nv_bfloat16*>(ptrs[4 + m]);
  for (int m = 0; m < 2; ++m)
    p.wf[m] = static_cast<const __nv_bfloat16*>(ptrs[8 + m]);
  p.B = (int)dims[0]; p.T = (int)dims[1]; p.H = (int)dims[2];
  const size_t bytes = (size_t)2 * p.H * R * sizeof(float)
                       + (size_t)NWARP * 2 * R * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int grid = (p.B + R - 1) / R;
  floor_kernel<<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
