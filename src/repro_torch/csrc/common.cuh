// Shared helpers for the port's CUDA kernels: dtype conversion to and from
// the f32 accumulator, and the codes the Python wrappers pass for dtypes and
// activations. Every kernel accumulates in f32, whatever its input type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// dtype codes passed by the wrappers (kernels/_build.py DTYPE_CODES)
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2 };
// activation codes (kernels/bdmm.py and kernels/masked_matmul.py ACT_CODES)
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3 };

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

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_SILU: return silu(v);
    case ACT_GELU: return gelu_tanh(v);
    case ACT_RELU: return fmaxf(v, 0.0f);
    default: return v;
  }
}

}  // namespace repro_torch
