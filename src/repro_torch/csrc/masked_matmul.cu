// Masked matmul and its weight gradient for Hopper (sm_90a): the
// paper-faithful masked-dense training ops of MPDCompress (Algorithm 1).
//
// Replaces the Pallas TPU bodies in src/repro/kernels/masked_matmul.py:
//   _mm_kernel     y = act(x @ (M o W) + b), or with transpose_rhs
//                  y = x @ (M o W)^T (the input gradient dx = g @ (M o W)^T)
//   _sddmm_kernel  dW = (x^T @ g) o M (the weight gradient, sampled by M)
//
// What the TPU bodies keep out of device memory, these keep out too: the
// mask is multiplied into each W tile as the tile is staged in shared memory,
// so M o W is never written back, and the sddmm applies M in its epilogue.
// The mask arrives as uint8 (one byte per weight); every product accumulates
// in f32 whatever the input type.
//
// What bounds them on the H100: at the shapes of olmo-1b training (m = 2048
// tokens, K and N in {2048, 8192, 50304}) the dense product these kernels
// compute is far above the ~295 op/B ridge of the bf16 tensor cores, so it
// is bound by operations; the on-mask work alone (1/nb of it) sits below the
// ridge, and its bound is the bytes of x, W, the mask and y. This first
// version is a plain shared-memory tiled f32 SIMT GEMM: a 128x128 output tile
// per block of 256 threads, 8x8 outputs per thread (two 4-row and two
// 4-column strips, so the float4 reads of a warp are conflict-free), K in
// steps of 16, no double buffering. It computes the full dense product; the
// mask's 1/nb density is not exploited (a permuted block-diagonal mask leaves
// no all-zero tile). wgmma/TMA belong to a later change.
//
// Unlike the TPU grid, whose K (or token) axis is a sequential grid dimension
// carrying an f32 accumulator in VMEM, each block here loops over the whole
// reduction axis itself and owns its sums in registers: Hopper blocks run in
// parallel and in no order.
//
// Both kinds of tile are staged by one loader. A "k-contiguous" operand is
// read along its rows (x in (m, K), W in (N, K) for transpose_rhs) and a
// "k-strided" operand along its columns (W in (K, N), and both x and g of the
// sddmm, whose reduction axis is the token axis). Consecutive threads always
// read consecutive addresses in device memory; the transpose into the
// k-major shared tile happens on the store.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int LD = BM + 4;  // padded row of a shared tile: 2-way store conflicts at most
static_assert(BM == BN, "one loader serves both operands");

// Stage the k-major tile s[kk][rc] (kk < BK, rc < BM) of an operand whose
// element (rc, k) lives at src[rc * ld + k] (KCONTIG) or src[k * ld + rc].
// With a mask (same layout as src) each value is multiplied by it, as the
// reference multiplies w by m.astype(w.dtype). Out-of-range entries are 0.
template <bool KCONTIG, typename T>
__device__ __forceinline__ void stage(float (*s)[LD], const T* __restrict__ src,
                                      const uint8_t* __restrict__ mask, long ld,
                                      int rc0, int rc_end, int k0, int k_end, int tid) {
#pragma unroll
  for (int i = 0; i < (BM * BK) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int rc = KCONTIG ? idx / BK : idx % BM;
    const int kk = KCONTIG ? idx % BK : idx / BM;
    const int grc = rc0 + rc, gk = k0 + kk;
    float v = 0.f;
    if (grc < rc_end && gk < k_end) {
      const long off = KCONTIG ? static_cast<long>(grc) * ld + gk
                               : static_cast<long>(gk) * ld + grc;
      v = to_f32(src[off]);
      if (mask) v *= static_cast<float>(mask[off]);
    }
    s[kk][rc] = v;
  }
}

// acc[i][j] += sum_kk a[kk][row(i)] * b[kk][col(j)] over one staged K step.
// Thread (tr, tc) owns rows {tr*4 + i, 64 + tr*4 + i} and columns
// {tc*4 + j, 64 + tc*4 + j}, i, j < 4.
__device__ __forceinline__ void tile_fma(float (*a)[LD], float (*b)[LD],
                                         float acc[8][8], int tr, int tc) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float av[8], bv[8];
    const float4 a0 = *reinterpret_cast<const float4*>(&a[kk][tr * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[kk][64 + tr * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[kk][tc * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[kk][64 + tc * 4]);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ int owned(int t, int i) { return (i / 4) * 64 + t * 4 + i % 4; }

// y (m, n) = act(x (m, k) @ B + bias), B = M o W with W (k, n), or
// B = (M o W)^T with W (n, k) when TRANS_W.
// Two blocks per SM: the epilogue's bias and activation would otherwise
// take the kernel past 128 registers a thread and leave one block per SM.
template <typename T, bool TRANS_W>
__global__ void __launch_bounds__(THREADS, 2)
masked_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const uint8_t* __restrict__ mask, const float* __restrict__ bias,
                 T* __restrict__ y, int m, int k, int n, int act) {
  __shared__ __align__(16) float As[BK][LD];
  __shared__ __align__(16) float Bs[BK][LD];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    stage<true>(As, x, nullptr, k, row0, m, k0, k, tid);
    stage<TRANS_W>(Bs, w, mask, TRANS_W ? k : n, col0, n, k0, k, tid);
    __syncthreads();
    tile_fma(As, Bs, acc, tr, tc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + owned(tr, i);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + owned(tc, j);
      if (c >= n) continue;
      float v = acc[i][j];
      if (bias) v += bias[c];
      y[static_cast<long>(r) * n + c] = from_f32<T>(activate(v, act));
    }
  }
}

// dw (d_in, d_out) = (x^T @ g) o M over all m tokens; x (m, d_in), g (m, d_out).
// Off-mask entries are written as exact zeros by a select, so a non-finite
// sum cannot leak into them (the reference's multiply would give NaN there).
template <typename T>
__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const T* __restrict__ x, const T* __restrict__ g,
             const uint8_t* __restrict__ mask, T* __restrict__ dw,
             int m, int d_in, int d_out) {
  __shared__ __align__(16) float As[BK][LD];
  __shared__ __align__(16) float Bs[BK][LD];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < m; t0 += BK) {
    stage<false>(As, x, nullptr, d_in, row0, d_in, t0, m, tid);
    stage<false>(Bs, g, nullptr, d_out, col0, d_out, t0, m, tid);
    __syncthreads();
    tile_fma(As, Bs, acc, tr, tc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + owned(tr, i);
    if (r >= d_in) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + owned(tc, j);
      if (c >= d_out) continue;
      const long off = static_cast<long>(r) * d_out + c;
      dw[off] = from_f32<T>(mask[off] ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
void launch_mm(const void* x, const void* w, const uint8_t* mask, const float* bias, void* y,
               int m, int k, int n, int trans, int act, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  auto* yt = static_cast<T*>(y);
  if (trans)
    masked_mm_kernel<T, true><<<grid, THREADS, 0, s>>>(xt, wt, mask, bias, yt, m, k, n, act);
  else
    masked_mm_kernel<T, false><<<grid, THREADS, 0, s>>>(xt, wt, mask, bias, yt, m, k, n, act);
}

template <typename T>
void launch_sddmm(const void* x, const void* g, const uint8_t* mask, void* dw,
                  int m, int d_in, int d_out, cudaStream_t s) {
  const dim3 grid((d_out + BN - 1) / BN, (d_in + BM - 1) / BM);
  sddmm_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                                           mask, static_cast<T*>(dw), m, d_in, d_out);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// y (m, n) = act(x (m, k) @ (M o W) + bias): W and mask (k, n), or (n, k)
// with transpose_w (then y = x @ (M o W)^T). dtype: DT_F32 or DT_BF16 for x,
// W and y; bias f32 (n,) or null. Returns cudaGetLastError() after the launch.
extern "C" int masked_matmul_launch(const void* x, const void* w, const uint8_t* mask,
                                    const float* bias, void* y, int m, int k, int n,
                                    int dtype, int transpose_w, int act, void* stream) {
  cudaGetLastError();  // clear a stale error so the one returned is this launch's
  if (m <= 0 || k <= 0 || n <= 0 || act < ACT_NONE || act > ACT_RELU)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    launch_mm<__nv_bfloat16>(x, w, mask, bias, y, m, k, n, transpose_w, act, s);
  else if (dtype == DT_F32)
    launch_mm<float>(x, w, mask, bias, y, m, k, n, transpose_w, act, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dw (d_in, d_out) = (x^T @ g) o M for x (m, d_in), g (m, d_out), mask
// (d_in, d_out); x, g and dw share one dtype (DT_F32 or DT_BF16).
extern "C" int sddmm_masked_launch(const void* x, const void* g, const uint8_t* mask,
                                   void* dw, int m, int d_in, int d_out, int dtype,
                                   void* stream) {
  cudaGetLastError();
  if (m <= 0 || d_in <= 0 || d_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    launch_sddmm<__nv_bfloat16>(x, g, mask, dw, m, d_in, d_out, s);
  else if (dtype == DT_F32)
    launch_sddmm<float>(x, g, mask, dw, m, d_in, d_out, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* masked_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
