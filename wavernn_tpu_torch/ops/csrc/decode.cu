// WaveRNN sample loop, one persistent kernel for Hopper (sm_90a).
//
// Replaces wavernn_tpu/ops/pallas_decode.py::_decode_kernel (launched by
// pallas_decode.decode).  It computes what that kernel computes, step for
// step (the math is written out in ops/cuda_decode.py, whose
// decode_reference is this kernel's plain PyTorch version), not how the TPU
// lays it out: no 128-lane padding, no chunked DMA double-buffering, no
// on-core transpose.
//
// Design.  One CTA owns R fold rows for all T steps.  Its recurrent state
// (x, h1, h2), the residual and the bf16-rounded operands of each dot live
// in shared memory, stored k-major ([K][R]) so that one weight element,
// loaded once, meets all R rows.  Each of the step's five dependent phases
// (GRU1, GRU2, FC1, FC2, FC3 + sampling) spreads its output columns over
// the threads, with a __syncthreads() between phases.
//
// Arithmetic.  A dot of bf16 operands sums its exact products in float64
// and rounds the sum once to float32; the int8 recurrent dots sum integers,
// exact in float32 (H * 127^2 < 2^24).  The order of the terms then hardly
// matters, so this kernel and its plain version (float64 GEMMs) agree to
// the bit nearly always, and a deterministic decode can be held to a tight
// tolerance over thousands of steps.  The gate arithmetic is float32 with
// one rounding per operation (the __f*_rn intrinsics keep nvcc from
// contracting it into FMAs), in the plain version's order.
//
// What bounds it.  The weights (about 5.2 MB at the full-size model with
// int8 recurrent matrices and bf16 feed-forward matrices) are read from
// global memory once per step per CTA; they stay resident in the 50 MB L2,
// so each CTA streams ~5.2 MB per step from L2.  A thread loads one 1- or
// 2-byte weight at a time, so the bytes in flight per SM, not the L2's
// bandwidth, set the pace: the kernel is bound by L2 latency.  Few rows
// per CTA put more SMs to work; two rows per CTA measured fastest.  The
// faster design (a step's columns spread over all SMs with weights held in
// shared memory, a cluster or grid barrier per phase, wide loads, wgmma)
// is later work.
//
// Ablations (dev only, for the cost breakdown in
// wavernn_tpu_torch/tools/kernel_breakdown.py): the template parameter MASK
// drops named pieces of the step, with the meanings of the TPU kernel's
// ``ablate`` knob.  AB_SAMPLE: the sample is tanh(logits[0]); AB_GATES: each
// GRU update is 0.5*h + 0.01*(gi[r] + gh[r]) (all gate dots still run);
// AB_COND_READ: the conditioning row is zeros; AB_OUT_WRITE: no output
// store.  Production is MASK = 0, which compiles to the plain kernel.
//
// Random bits: a counter-based 32-bit hash of (seed, fold row, step, lane)
// replaces the TPU's on-core PRNG; the plain version reproduces it.
//
// Entry point (plain C, bound with ctypes):
//   int wavernn_decode(const void* const* ptrs, const long long* dims,
//                      void* stream)
// ptrs = cond, out, then the packed weights in cuda_decode.WEIGHT_ORDER;
// dims = B, Tc, C, T, H, F, feat, aux_d, n_out, mode (0 RAW, 1 MOL),
//        deterministic, int8_hh, rows_per_cta, seed, ablation mask.
// Returns a cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr float LOG_SCALE_MIN = -32.23619130191664f;  // log(1e-14)
constexpr int AB_SAMPLE = 1, AB_GATES = 2, AB_COND_READ = 4, AB_OUT_WRITE = 8;

struct Params {
  const __nv_bfloat16* cond;  // (B, Tc, C) fold-major conditioning
  float* out;                 // (B, T)
  const __nv_bfloat16* w_Im1; const float* u1;
  const __nv_bfloat16* w_Im; const float* w_x; const float* b_I;
  const void* w_hh1; const float* s_hh1; const float* b1; const float* b_hh1_n;
  const __nv_bfloat16* w_ih2x;
  const void* w_hh2; const float* s_hh2; const float* b2; const float* b_hh2_n;
  const __nv_bfloat16* w_fc1x; const float* b_fc1;
  const __nv_bfloat16* w_fc2x; const float* b_fc2;
  const __nv_bfloat16* w_aux; const __nv_bfloat16* w_fc3; const float* b_fc3;
  int B, Tc, C, T, H, F, feat, d, n_out, mode, det;
  uint32_t seed;
};

// float32 arithmetic with one rounding per operation
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// acc + a*b for the dots: exact products, so fused or not is the same
__device__ __forceinline__ double madd(double a, double b, double acc) {
  return fma(a, b, acc);
}
__device__ __forceinline__ float madd(float a, float b, float acc) {
  return fmaf(a, b, acc);
}

__device__ __forceinline__ float wload(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(__ldg(p + i));
}
__device__ __forceinline__ float wload(const int8_t* p, size_t i) {
  return static_cast<float>(__ldg(p + i));
}
__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float sigm(float v) {
  return add(mul(0.5f, tanhf(mul(0.5f, v))), 0.5f);
}
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352dU;
  x ^= x >> 15; x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t rand_bits(uint32_t seed, uint32_t row,
                                              uint32_t step, uint32_t lane) {
  uint32_t h = mix32(seed ^ 0x9e3779b9U);
  h = mix32(h ^ row);
  h = mix32(h ^ step);
  return mix32(h ^ lane);
}
__device__ __forceinline__ float uniform(uint32_t bits) {
  return add(sub(__uint_as_float((bits >> 9) | 0x3f800000U), 1.0f), 1e-7f);
}
__device__ __forceinline__ float gumbel(uint32_t bits) {
  return -logf(-logf(uniform(bits)));
}

// acc[g][r] += sum_k a[k][r] * w[k][j + g*gs], g < G, over a k-major
// [K][R] activation buffer.  TA is the accumulator type: double for bf16
// weights, float for the integer-valued int8 dots.
template <int R, int G, typename TA, typename TW>
__device__ __forceinline__ void dot(TA (&acc)[G][R], const float* a, int K,
                                    const TW* w, int ldw, int j, int gs) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    TA wv[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      wv[g] = static_cast<TA>(wload(w, (size_t)k * ldw + j + g * gs));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const TA v = static_cast<TA>(a[k * R + r]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g][r] = madd(v, wv[g], acc[g][r]);
    }
  }
}

template <int R, int G, typename TA>
__device__ __forceinline__ void zero(TA (&acc)[G][R]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[g][r] = TA(0);
}

// Warp argmax, first index on ties.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffU, v, o);
    int oi = __shfl_xor_sync(0xffffffffU, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = add(v, __shfl_xor_sync(0xffffffffU, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffU, v, o));
  return v;
}

// Torch-convention GRU update of column j: gi/gh are the input- and
// hidden-side (r, z, n) pre-activations, b packs b_ih+b_hh for r/z and
// b_ih for n; the hidden-side n bias is scaled by r.
__device__ __forceinline__ float gru(const float (&gi)[3], const float (&gh)[3],
                                     const float* b, const float* b_hh_n,
                                     int j, int H, float h) {
  const float rr = sigm(add(add(gi[0], b[j]), gh[0]));
  const float zz = sigm(add(add(gi[1], b[H + j]), gh[1]));
  const float nn = tanhf(add(add(gi[2], b[2 * H + j]),
                             mul(rr, add(gh[2], b_hh_n[j]))));
  return add(mul(sub(1.0f, zz), nn), mul(zz, h));
}

// The ablated GRU update; ``keep`` takes the unused gate values, so that
// their dots stay live.
__device__ __forceinline__ float gru_ablated(const float (&gi)[3],
                                             const float (&gh)[3], float h,
                                             float& keep) {
  keep = add(keep, add(add(gi[1], gi[2]), add(gh[1], gh[2])));
  return add(mul(0.5f, h), mul(0.01f, add(gi[0], gh[0])));
}

template <int R, bool I8, int MASK>
__global__ void __launch_bounds__(NT) decode_kernel(Params p) {
  using TW = typename std::conditional<I8, int8_t, __nv_bfloat16>::type;
  using TH = typename std::conditional<I8, float, double>::type;
  extern __shared__ __align__(16) float sm[];
  const int H = p.H, F = p.F, C = p.C, d = p.d, NO = p.n_out;
  const int W = H > F ? H : F;
  const int K0 = p.feat + d;           // seg0 width: [mel | a1]
  const int H3 = 3 * H, NA = 3 * H + 2 * F;
  float* cond = sm;                    // [C][R]
  float* h1 = cond + C * R;            // [H][R]
  float* h2 = h1 + H * R;              // [H][R]
  float* xr = h2 + H * R;              // [H][R]
  float* opX = xr + H * R;             // [W][R] input-side dot operand
  float* opH = opX + W * R;            // [W][R] hidden-side / fc2 operand
  float* logits = opH + W * R;         // [R][NO]
  float* xs = logits + R * NO;         // [R] previous sample
  const TW* w_hh1 = static_cast<const TW*>(p.w_hh1);
  const TW* w_hh2 = static_cast<const TW*>(p.w_hh2);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * R;
  float keep = 0.f;  // AB_GATES only

  for (int i = tid; i < H * R; i += NT) { h1[i] = 0.f; h2[i] = 0.f; }
  for (int i = tid; i < R; i += NT) xs[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    // conditioning row of each fold, and gru1's hidden operand
    for (int i = tid; i < C * R; i += NT) {
      const int r = i % R, c = i / R, b = b0 + r;
      if constexpr ((MASK & AB_COND_READ) != 0) {
        cond[i] = 0.f;
      } else {
        cond[i] = b < p.B
            ? __bfloat162float(p.cond[((size_t)b * p.Tc + t) * C + c]) : 0.f;
      }
    }
    for (int i = tid; i < H * R; i += NT)
      opH[i] = I8 ? rintf(mul(h1[i], 127.f)) : bfr(h1[i]);
    __syncthreads();

    // GRU1 (inputs precomposed through I) and the I projection
    for (int j = tid; j < H; j += NT) {
      double gi[3][R], xi[1][R];
      TH gh[3][R];
      zero(gi); zero(xi); zero(gh);
      dot<R, 3>(gi, cond, K0, p.w_Im1, H3, j, H);
      dot<R, 1>(xi, cond, K0, p.w_Im, H, j, 0);
      dot<R, 3>(gh, opH, H, w_hh1, H3, j, H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = xs[r];
        float a[3], h[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          a[g] = add(mul(x, p.u1[g * H + j]), to_f32(gi[g][r]));
          h[g] = I8 ? mul(to_f32(gh[g][r]),
                          mul(p.s_hh1[g * H + j], 1.0f / 127.0f))
                    : to_f32(gh[g][r]);
        }
        const float hn = (MASK & AB_GATES)
            ? gru_ablated(a, h, h1[j * R + r], keep)
            : gru(a, h, p.b1, p.b_hh1_n, j, H, h1[j * R + r]);
        h1[j * R + r] = hn;
        const float v = add(add(add(mul(x, p.w_x[j]), to_f32(xi[0][r])),
                                p.b_I[j]), hn);
        xr[j * R + r] = v;
        opX[j * R + r] = bfr(v);
      }
    }
    __syncthreads();
    for (int i = tid; i < H * R; i += NT)
      opH[i] = I8 ? rintf(mul(h2[i], 127.f)) : bfr(h2[i]);
    __syncthreads();

    // GRU2 on [xr | a2]
    for (int j = tid; j < H; j += NT) {
      double gx[3][R], ga[3][R];
      TH gh[3][R];
      zero(gx); zero(ga); zero(gh);
      dot<R, 3>(gx, opX, H, p.w_ih2x, H3, j, H);
      dot<R, 3>(ga, cond + K0 * R, d, p.w_aux, NA, j, H);
      dot<R, 3>(gh, opH, H, w_hh2, H3, j, H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a[3], h[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          a[g] = add(to_f32(gx[g][r]), to_f32(ga[g][r]));
          h[g] = I8 ? mul(to_f32(gh[g][r]),
                          mul(p.s_hh2[g * H + j], 1.0f / 127.0f))
                    : to_f32(gh[g][r]);
        }
        const float hn = (MASK & AB_GATES)
            ? gru_ablated(a, h, h2[j * R + r], keep)
            : gru(a, h, p.b2, p.b_hh2_n, j, H, h2[j * R + r]);
        h2[j * R + r] = hn;
        xr[j * R + r] = add(xr[j * R + r], hn);
      }
    }
    __syncthreads();
    for (int i = tid; i < H * R; i += NT) opX[i] = bfr(xr[i]);
    __syncthreads();

    // FC1 on [xr | a3] -> opH
    for (int j = tid; j < F; j += NT) {
      double ax[1][R], aa[1][R];
      zero(ax); zero(aa);
      dot<R, 1>(ax, opX, H, p.w_fc1x, F, j, 0);
      dot<R, 1>(aa, cond + (K0 + d) * R, d, p.w_aux + (size_t)d * NA + H3,
                NA, j, 0);
#pragma unroll
      for (int r = 0; r < R; ++r)
        opH[j * R + r] = bfr(fmaxf(
            add(add(to_f32(ax[0][r]), to_f32(aa[0][r])), p.b_fc1[j]), 0.f));
    }
    __syncthreads();

    // FC2 on [f1 | a4] -> opX
    for (int j = tid; j < F; j += NT) {
      double ax[1][R], aa[1][R];
      zero(ax); zero(aa);
      dot<R, 1>(ax, opH, F, p.w_fc2x, F, j, 0);
      dot<R, 1>(aa, cond + (K0 + 2 * d) * R, d,
                p.w_aux + (size_t)2 * d * NA + H3 + F, NA, j, 0);
#pragma unroll
      for (int r = 0; r < R; ++r)
        opX[j * R + r] = bfr(fmaxf(
            add(add(to_f32(ax[0][r]), to_f32(aa[0][r])), p.b_fc2[j]), 0.f));
    }
    __syncthreads();

    // FC3 -> logits [R][NO]
    for (int j = tid; j < NO; j += NT) {
      double acc[1][R];
      zero(acc);
      dot<R, 1>(acc, opX, F, p.w_fc3, NO, j, 0);
#pragma unroll
      for (int r = 0; r < R; ++r)
        logits[r * NO + j] = add(to_f32(acc[0][r]), p.b_fc3[j]);
    }
    __syncthreads();

    // sampling: one warp per fold row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += NWARP) {
      const int b = b0 + r;
      const float* lg = logits + r * NO;
      float sample;
      if constexpr ((MASK & AB_SAMPLE) != 0) {
        sample = tanhf(lg[0]);
      } else if (p.mode == 0) {  // RAW: (Gumbel-)argmax over the classes
        float best = -CUDART_INF_F;
        int bi = NO;
        for (int i = lane; i < NO; i += 32) {
          float s = lg[i];
          if (!p.det) s = add(s, gumbel(rand_bits(p.seed, b, t, i)));
          if (s > best) { best = s; bi = i; }
        }
        warp_argmax(best, bi);
        // class -> [-1, 1], dividing as a multiply by the f32 reciprocal
        const float inv = static_cast<float>(1.0 / (NO - 1.0));
        sample = sub(mul(mul(2.0f, static_cast<float>(bi)), inv), 1.0f);
      } else {            // MOL
        const int nm = NO / 3;
        const bool on = lane < nm;
        if (p.det) {
          float best = on ? lg[lane] : -CUDART_INF_F;
          int bi = on ? lane : NO;
          warp_argmax(best, bi);
          sample = lg[nm + bi];
        } else {
          const float s = on ? add(lg[lane],
                                   gumbel(rand_bits(p.seed, b, t, lane)))
                             : -CUDART_INF_F;
          const float mx = warp_max(s);
          const float hit = (on && s >= mx) ? 1.f : 0.f;
          const float oh = __fdiv_rn(hit, warp_sum(hit));
          const float mean = warp_sum(on ? mul(lg[nm + lane], oh) : 0.f);
          const float ls = warp_sum(
              on ? mul(fmaxf(lg[2 * nm + lane], LOG_SCALE_MIN), oh) : 0.f);
          const float u = fminf(fmaxf(uniform(rand_bits(p.seed, b, t, nm)),
                                      1e-5f), 0.99999f);
          sample = add(mean, mul(expf(ls), sub(logf(u), logf(sub(1.0f, u)))));
        }
        sample = fminf(fmaxf(sample, -1.f), 1.f);
      }
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
  if ((MASK & AB_GATES) && b0 > p.B) p.out[0] = keep;
}

template <int R, bool I8, int MASK>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int W = p.H > p.F ? p.H : p.F;
  const size_t floats = (size_t)R * (p.C + 3 * p.H + 2 * W + p.n_out + 1);
  const size_t bytes = floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<R, I8, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const int grid = (p.B + R - 1) / R;
  decode_kernel<R, I8, MASK><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool I8>
cudaError_t launch_rows(const Params& p, int R, cudaStream_t s) {
  switch (R) {
    case 1: return launch<1, I8, 0>(p, s);
    case 2: return launch<2, I8, 0>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// The ablations the breakdown runs, built for its configuration only:
// int8 recurrent matrices, two rows per CTA.
cudaError_t launch_ablated(const Params& p, int mask, cudaStream_t s) {
  switch (mask) {
    case AB_SAMPLE: return launch<2, true, AB_SAMPLE>(p, s);
    case AB_GATES: return launch<2, true, AB_GATES>(p, s);
    case AB_SAMPLE | AB_GATES:
      return launch<2, true, AB_SAMPLE | AB_GATES>(p, s);
    case AB_COND_READ: return launch<2, true, AB_COND_READ>(p, s);
    case AB_OUT_WRITE: return launch<2, true, AB_OUT_WRITE>(p, s);
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
  p.w_ih2x = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.w_hh2 = ptrs[i++];
  p.s_hh2 = static_cast<const float*>(ptrs[i++]);
  p.b2 = static_cast<const float*>(ptrs[i++]);
  p.b_hh2_n = static_cast<const float*>(ptrs[i++]);
  p.w_fc1x = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.b_fc1 = static_cast<const float*>(ptrs[i++]);
  p.w_fc2x = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.b_fc2 = static_cast<const float*>(ptrs[i++]);
  p.w_aux = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.w_fc3 = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.b_fc3 = static_cast<const float*>(ptrs[i++]);
  p.B = (int)dims[0]; p.Tc = (int)dims[1]; p.C = (int)dims[2];
  p.T = (int)dims[3]; p.H = (int)dims[4]; p.F = (int)dims[5];
  p.feat = (int)dims[6]; p.d = (int)dims[7]; p.n_out = (int)dims[8];
  p.mode = (int)dims[9]; p.det = (int)dims[10];
  const bool int8_hh = dims[11] != 0;
  const int R = (int)dims[12];
  p.seed = (uint32_t)dims[13];
  const int mask = (int)dims[14];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != 0) {
    if (!int8_hh || R != 2) return cudaErrorInvalidValue;
    return launch_ablated(p, mask, s);
  }
  return int8_hh ? launch_rows<true>(p, R, s) : launch_rows<false>(p, R, s);
}

extern "C" const char* wavernn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
