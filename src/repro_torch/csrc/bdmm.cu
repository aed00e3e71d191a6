// Block-diagonal matmul for Hopper (sm_90a): the MPDCompress inference op.
//
// Replaces the Pallas TPU bodies in src/repro/kernels/bdmm.py:
//   _bdmm_kernel         (general grid, K accumulated over grid steps)
//   _bdmm_decode_kernel  (decode-shaped grid, m <= 32, full K per step)
//
// For packed inputs x (m, nb*bi) and packed diagonal blocks w (nb, bi, bo):
//   y[:, n*bo:(n+1)*bo] = act(x[:, n*bi:(n+1)*bi] @ w[n] (* scale[n]) + b[n])
// with w either the activation type (f32 / bf16) or int8 with a per-output
// channel f32 scale (nb, bo). Products accumulate in f32; the epilogue runs
// scale -> bias -> activation -> cast, the reference's order.
//
// What bounds it on the H100:
// * decode (m <= 32): the weight stream. The int8 blocks of one olmo-1b
//   decode step are ~147 MB, ~44 us at 3.35 TB/s; the activations are a few
//   KB. The decode kernel therefore reads every weight byte exactly once for
//   all m rows: a block owns (block n, 32 output columns), stages the m input
//   rows of one K chunk in shared memory, and each thread streams 4 adjacent
//   columns of a K slice with one vector load per row (4 B of int8), keeping
//   m x 4 f32 sums in registers. K slices are reduced by warp shuffles and one
//   shared-memory pass in a fixed order, so results are deterministic.
// * general (prefill chunks, m = 64 tokens): 2*m*bi*bo/nb operations against
//   the same weight bytes; at m = 64 still far below the ~295 op/B ridge of
//   the bf16 tensor cores, so this first version is a plain shared-memory
//   tiled f32 SIMT GEMM (64x64 output tile per block, 4x4 per thread,
//   K in steps of 16). wgmma/TMA belong to a later change.
// Ragged m/bo/K edges are masked in-kernel; nothing is padded or copied.

#include "common.cuh"

namespace repro_torch {
namespace {

// ------------------------------------------------------------------ general
constexpr int GM = 64, GN = 64, GK = 16, G_THREADS = 256;

__device__ __forceinline__ float epilogue(float v, const float* __restrict__ scale,
                                          const float* __restrict__ bias, long idx,
                                          int act) {
  if (scale) v *= scale[idx];
  if (bias) v += bias[idx];
  if (act == ACT_SILU) v = silu(v);
  return v;
}

template <typename T, typename W>
__global__ void __launch_bounds__(G_THREADS)
bdmm_general_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    T* __restrict__ y, int m, int nb, int bi, int bo, int act) {
  __shared__ float As[GK][GM + 4];  // x tile, k-major
  __shared__ float Bs[GK][GN + 4];  // w tile
  const int n = blockIdx.y;
  const int col0 = blockIdx.x * GN;
  const int row0 = blockIdx.z * GM;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const long ldx = static_cast<long>(nb) * bi;
  const T* xb = x + static_cast<long>(n) * bi;
  const W* wb = w + static_cast<long>(n) * bi * bo;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < bi; k0 += GK) {
#pragma unroll
    for (int i = 0; i < (GM * GK) / G_THREADS; ++i) {
      const int idx = tid + i * G_THREADS;
      const int r = idx / GK, kk = idx % GK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < m && gk < bi) ? to_f32(xb[gr * ldx + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (GK * GN) / G_THREADS; ++i) {
      const int idx = tid + i * G_THREADS;
      const int kk = idx / GN, c = idx % GN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < bi && gc < bo) ? to_f32(wb[static_cast<long>(gk) * bo + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long ldy = static_cast<long>(nb) * bo;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + tr * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tc * 4 + j;
      if (gc >= bo) continue;
      const long pidx = static_cast<long>(n) * bo + gc;
      y[gr * ldy + pidx] = from_f32<T>(epilogue(acc[i][j], scale, bias, pidx, act));
    }
  }
}

// ------------------------------------------------------------------- decode
constexpr int D_N = 32;                    // output columns per block
constexpr int D_THREADS = 256;
constexpr int D_VEC = 4;                   // adjacent columns per thread
constexpr int D_CT = D_N / D_VEC;          // threads across one K row: 8
constexpr int D_KS = D_THREADS / D_CT;     // K slices per block: 32
constexpr int D_KC = 128;                  // K rows staged per chunk
constexpr int D_WARPS = D_THREADS / 32;

template <typename T, typename W, int MT>
__global__ void __launch_bounds__(D_THREADS)
bdmm_decode_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   T* __restrict__ y, int m, int nb, int bi, int bo, int act, int vec) {
  // x chunk [MT][D_KC] during the K loop, then the per-warp partial sums
  // [D_WARPS][MT][D_N]; the second is the larger
  __shared__ float smem[D_WARPS * MT * D_N];
  const int n = blockIdx.y;
  const int col0 = blockIdx.x * D_N;
  const int tid = threadIdx.x;
  const int ct = tid % D_CT;
  const int ks = tid / D_CT;
  const int c0 = col0 + ct * D_VEC;
  const long ldx = static_cast<long>(nb) * bi;
  const T* xb = x + static_cast<long>(n) * bi;
  const W* wb = w + static_cast<long>(n) * bi * bo;

  float acc[MT][D_VEC];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < D_VEC; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < bi; k0 += D_KC) {
    const int kc = min(D_KC, bi - k0);
    for (int idx = tid; idx < MT * D_KC; idx += D_THREADS) {
      const int r = idx / D_KC, kk = idx % D_KC;
      smem[idx] = (r < m && kk < kc) ? to_f32(xb[r * ldx + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kk = ks; kk < kc; kk += D_KS) {
      float wv[D_VEC];
      load4<W>(wb + static_cast<long>(k0 + kk) * bo, c0, bo, vec != 0, wv);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float xv = smem[r * D_KC + kk];
#pragma unroll
        for (int j = 0; j < D_VEC; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
      }
    }
    __syncthreads();
  }

  // lane = (ks % 4) * 8 + ct: lanes 8 and 16 apart hold the same columns
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < D_VEC; ++j) {
      float v = acc[r][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][j] = v;
    }
  if (lane < D_CT) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < D_VEC; ++j) smem[(warp * MT + r) * D_N + lane * D_VEC + j] = acc[r][j];
  }
  __syncthreads();

  const long ldy = static_cast<long>(nb) * bo;
  for (int idx = tid; idx < MT * D_N; idx += D_THREADS) {
    const int r = idx / D_N, c = idx % D_N;
    const int gc = col0 + c;
    if (r >= m || gc >= bo) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < D_WARPS; ++wi) s += smem[(wi * MT + r) * D_N + c];
    const long pidx = static_cast<long>(n) * bo + gc;
    y[r * ldy + pidx] = from_f32<T>(epilogue(s, scale, bias, pidx, act));
  }
}

template <typename T, typename W>
void launch_decode(const void* x, const void* w, const float* scale, const float* bias,
                   void* y, int m, int nb, int bi, int bo, int act, int vec,
                   cudaStream_t stream) {
  const dim3 grid((bo + D_N - 1) / D_N, nb);
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const W*>(w);
  auto* yt = static_cast<T*>(y);
#define REPRO_DECODE(MT_)                                                          \
  bdmm_decode_kernel<T, W, MT_><<<grid, D_THREADS, 0, stream>>>(xt, wt, scale, bias, \
                                                                yt, m, nb, bi, bo, act, vec)
  if (m <= 1) REPRO_DECODE(1);
  else if (m <= 2) REPRO_DECODE(2);
  else if (m <= 4) REPRO_DECODE(4);
  else if (m <= 8) REPRO_DECODE(8);
  else if (m <= 16) REPRO_DECODE(16);
  else REPRO_DECODE(32);
#undef REPRO_DECODE
}

template <typename T, typename W>
void launch(const void* x, const void* w, const float* scale, const float* bias, void* y,
            int m, int nb, int bi, int bo, int act, int decode, int vec, cudaStream_t stream) {
  if (decode) {
    launch_decode<T, W>(x, w, scale, bias, y, m, nb, bi, bo, act, vec, stream);
  } else {
    const dim3 grid((bo + GN - 1) / GN, nb, (m + GM - 1) / GM);
    bdmm_general_kernel<T, W><<<grid, G_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scale, bias,
        static_cast<T*>(y), m, nb, bi, bo, act);
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// x_dtype: DT_F32 or DT_BF16; w_int8: 0 -> w has x's dtype, 1 -> int8 (+ scale)
// decode: 1 -> decode-shaped kernel (m <= 32), 0 -> general kernel
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bdmm_launch(const void* x, const void* w, const float* scale,
                           const float* bias, void* y, int m, int nb, int bi, int bo,
                           int x_dtype, int w_int8, int act, int decode, int vec,
                           void* stream) {
  cudaGetLastError();  // clear a stale error so the one returned is this launch's
  if (m <= 0 || nb <= 0 || bi <= 0 || bo <= 0 || (decode && m > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_BF16) {
    if (w_int8) launch<__nv_bfloat16, int8_t>(x, w, scale, bias, y, m, nb, bi, bo, act, decode, vec, s);
    else launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, bias, y, m, nb, bi, bo, act, decode, vec, s);
  } else if (x_dtype == DT_F32) {
    if (w_int8) launch<float, int8_t>(x, w, scale, bias, y, m, nb, bi, bo, act, decode, vec, s);
    else launch<float, float>(x, w, scale, bias, y, m, nb, bi, bo, act, decode, vec, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bdmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
