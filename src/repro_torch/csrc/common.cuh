// Shared helpers for the port's CUDA kernels: dtype conversion to and from
// the f32 accumulator, and the codes the Python wrappers pass for dtypes and
// activations. Every kernel accumulates in f32, whatever its input type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

// dtype codes passed by the wrappers (kernels/_build.py DTYPE_CODES)
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2 };
// activation codes (kernels/bdmm.py and kernels/masked_matmul.py ACT_CODES:
// every entry of the reference's ref.ACTIVATIONS; fused_ffn.py takes the
// first four)
enum Act {
  ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3,
  ACT_SIGMOID = 4, ACT_SOFTPLUS = 5, ACT_SQRELU = 6, ACT_LAST = ACT_SQRELU
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as jnp/torch casts do
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// jax.nn.silu == x * sigmoid(x)
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// jax.nn.gelu(approximate=True), torch's gelu(approximate="tanh")
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// p[c0 .. c0+3] as f32, zero past `bo`: one vector load when `vec` (the
// caller guarantees 4-element alignment) and the four are in range
template <typename W>
__device__ __forceinline__ void load4(const W* __restrict__ p, int c0, int bo, bool vec,
                                      float out[4]);

template <>
__device__ __forceinline__ void load4<int8_t>(const int8_t* __restrict__ p, int c0, int bo,
                                              bool vec, float out[4]) {
  if (vec && c0 + 3 < bo) {
    const char4 v = *reinterpret_cast<const char4*>(p + c0);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (c0 + j < bo) ? static_cast<float>(p[c0 + j]) : 0.f;
  }
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* __restrict__ p, int c0,
                                                     int bo, bool vec, float out[4]) {
  if (vec && c0 + 3 < bo) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p + c0);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (c0 + j < bo) ? __bfloat162float(p[c0 + j]) : 0.f;
  }
}

template <>
__device__ __forceinline__ void load4<float>(const float* __restrict__ p, int c0, int bo,
                                             bool vec, float out[4]) {
  if (vec && c0 + 3 < bo) {
    const float4 v = *reinterpret_cast<const float4*>(p + c0);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (c0 + j < bo) ? p[c0 + j] : 0.f;
  }
}

// jax.nn.sigmoid == 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// jax.nn.softplus == logaddexp(x, 0) == max(x, 0) + log1p(exp(-|x|)) (not
// torch's threshold form)
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_SILU: return silu(v);
    case ACT_GELU: return gelu_tanh(v);
    case ACT_RELU: return fmaxf(v, 0.0f);
    case ACT_SIGMOID: return sigmoid(v);
    case ACT_SOFTPLUS: return softplus(v);
    case ACT_SQRELU: {  // RWKV's channel mix: squared ReLU
      const float r = fmaxf(v, 0.0f);
      return r * r;
    }
    default: return v;
  }
}

// f(std::integral_constant<int, A>()) for the runtime activation code act:
// an epilogue that unrolls over a whole tile calls its activation with the
// constant A.value, so it inlines one activation, not a switch of all of
// them at every element (which costs registers, and spills, on every path).
template <typename F>
__device__ __forceinline__ void dispatch_act(int act, F&& f) {
  switch (act) {
    case ACT_SILU: f(std::integral_constant<int, ACT_SILU>()); break;
    case ACT_GELU: f(std::integral_constant<int, ACT_GELU>()); break;
    case ACT_RELU: f(std::integral_constant<int, ACT_RELU>()); break;
    case ACT_SIGMOID: f(std::integral_constant<int, ACT_SIGMOID>()); break;
    case ACT_SOFTPLUS: f(std::integral_constant<int, ACT_SOFTPLUS>()); break;
    case ACT_SQRELU: f(std::integral_constant<int, ACT_SQRELU>()); break;
    default: f(std::integral_constant<int, ACT_NONE>());
  }
}

}  // namespace repro_torch
