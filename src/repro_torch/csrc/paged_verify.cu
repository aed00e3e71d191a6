// Speculative-verify attention over paged KV for Hopper (sm_90a).
//
// Replaces the Pallas TPU body src/repro/kernels/paged_attention.py::
// _paged_verify_kernel: a window of Tq queries per row b (the pending token
// and the draft's k proposals) against the row's KV pages, online softmax in
// f32, the window folded into the GQA group rows. Query t of row b sits at
// position lengths[b] - Tq + t and sees kv_pos < lengths[b] - (Tq - 1) + t:
// the accepted context plus the window up to and including itself (the
// window's K/V is already in the pool).
//
// Layout: q (B, Tq, H, Dh); k_pages / v_pages (n_pages, page_size, Kh, Dh);
// block_tables (B, P) int32; lengths (B,) int32 >= Tq; out (B, Tq, H, Dh).
//
// Design: the page loop of paged_attend.cuh with pos0 = lengths[b] - Tq and
// depth = lengths[b]. One block per (window tile, KV head, row b); a tile
// holds q_tile window tokens times the g = H / Kh heads of its KV head, at
// most 128 * 16 rows x Dh (olmo-1b: g 1, Dh 128, Tq 5 is one tile; g 4 takes
// two). Each K/V page of the row is read from device memory once per block
// and serves every query of the tile, so the window costs about the K/V
// bytes of one decode step, which is what bounds it on the H100 (~4 flops
// per byte read; see paged_attend.cuh). With Tq == 1 the block computes
// exactly what paged_attention.cu computes, bit for bit.

#include "paged_attend.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int Tq, int q_tile,
                    int P, int n_pages, int ps, int H, int kh_n, int dh, float scale) {
  const int t0 = blockIdx.x * q_tile;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int depth = max(lengths[b], Tq);
  const long row = static_cast<long>(b) * Tq * H * dh;
  paged_attend_tile<T>(q + row, k_pages, v_pages, block_tables + static_cast<long>(b) * P,
                       out + row, t0, q_tile, Tq, /*pos0=*/depth - Tq, depth, P, n_pages, ps,
                       H, kh_n, kh, dh, scale);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt, const int* lengths,
           void* out, int B, int Tq, int q_tile, int P, int n_pages, int ps, int H, int kh_n,
           int dh, float scale, cudaStream_t stream) {
  const int rows = q_tile * (H / kh_n);
  const size_t smem = sizeof(float) * paged_smem_floats(rows, ps, dh);
  cudaError_t err = set_smem(paged_verify_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + q_tile - 1) / q_tile, kh_n, B);
  paged_verify_kernel<T><<<grid, PA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt,
      lengths, static_cast<T*>(out), Tq, q_tile, P, n_pages, ps, H, kh_n, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// dtype: DT_F32 or DT_BF16 (q, pools and out share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_verify_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const int* block_tables, const int* lengths, void* out,
                                   int B, int Tq, int q_tile, int P, int n_pages,
                                   int page_size, int H, int kh_n, int dh, float scale,
                                   int dtype, void* stream) {
  cudaGetLastError();
  if (B <= 0 || Tq <= 0 || q_tile <= 0 || q_tile > Tq || P <= 0 || kh_n <= 0 ||
      H % kh_n != 0 || B > 65535 || !paged_shape_ok(q_tile * (H / kh_n), dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths, out, B, Tq,
                                 q_tile, P, n_pages, page_size, H, kh_n, dh, scale, s);
  if (dtype == DT_F32)
    return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B, Tq, q_tile, P,
                         n_pages, page_size, H, kh_n, dh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_verify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
