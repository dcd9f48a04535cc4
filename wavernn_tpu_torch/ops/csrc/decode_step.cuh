// The WaveRNN step's scalar pieces, shared by both designs of the decode
// kernel (decode.cu: one CTA per fold row; decode_cluster.cu: a fold row's
// columns split over a thread-block cluster): float32 arithmetic with one
// rounding per operation, the bf16 rounding of a dot operand, the GRU
// update, the counter-based random bits and the sampling of one fold row
// by one warp.  Each is written out in ops/cuda_decode.py, whose
// decode_reference repeats it operation for operation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dot.cuh"

namespace step {

constexpr float LOG_SCALE_MIN = -32.23619130191664f;  // log(1e-14)

// float32 arithmetic with one rounding per operation (the __f*_rn
// intrinsics keep nvcc from contracting it into FMAs)
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// a dot operand: bf16-rounded, held as double at the dots' scale
__device__ __forceinline__ double bfr64(float v) {
  return dot::act(static_cast<double>(bfr(v)));
}
__device__ __forceinline__ float sigm(float v) {
  return add(mul(0.5f, tanhf(mul(0.5f, v))), 0.5f);
}
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

// The sample of one fold row from its NO logits ``lg`` (in shared memory),
// by one warp (every lane returns it): RAW (Gumbel-)argmax over the
// classes, MOL a logistic draw from the (Gumbel-)chosen component, or its
// mean when deterministic.  ``rb`` is the random bits' row, ``t`` the step.
__device__ __forceinline__ float sample_row(const float* lg, int NO, int mode,
                                            int det, uint32_t seed,
                                            uint32_t rb, int t, int lane) {
  if (mode == 0) {  // RAW: (Gumbel-)argmax over the classes
    float best = -CUDART_INF_F;
    int bi = NO;
    for (int i = lane; i < NO; i += 32) {
      float s = lg[i];
      if (!det) s = add(s, gumbel(rand_bits(seed, rb, t, i)));
      if (s > best) { best = s; bi = i; }
    }
    warp_argmax(best, bi);
    // class -> [-1, 1], dividing as a multiply by the f32 reciprocal
    const float inv = static_cast<float>(1.0 / (NO - 1.0));
    return sub(mul(mul(2.0f, static_cast<float>(bi)), inv), 1.0f);
  }
  // MOL
  const int nm = NO / 3;
  const bool on = lane < nm;
  float sample;
  if (det) {
    float best = on ? lg[lane] : -CUDART_INF_F;
    int bi = on ? lane : NO;
    warp_argmax(best, bi);
    sample = lg[nm + bi];
  } else {
    const float s = on ? add(lg[lane], gumbel(rand_bits(seed, rb, t, lane)))
                       : -CUDART_INF_F;
    const float mx = warp_max(s);
    const float hit = (on && s >= mx) ? 1.f : 0.f;
    const float oh = __fdiv_rn(hit, warp_sum(hit));
    const float mean = warp_sum(on ? mul(lg[nm + lane], oh) : 0.f);
    const float ls = warp_sum(
        on ? mul(fmaxf(lg[2 * nm + lane], LOG_SCALE_MIN), oh) : 0.f);
    const float u = fminf(fmaxf(uniform(rand_bits(seed, rb, t, nm)), 1e-5f),
                          0.99999f);
    sample = add(mean, mul(expf(ls), sub(logf(u), logf(sub(1.0f, u)))));
  }
  return fminf(fmaxf(sample, -1.f), 1.f);
}

}  // namespace step
