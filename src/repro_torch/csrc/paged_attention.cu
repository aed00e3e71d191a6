// Paged-attention decode step for Hopper (sm_90a).
//
// Replaces the Pallas TPU body src/repro/kernels/paged_attention.py::
// _paged_attn_kernel: one decode query per row b over the row's KV pages,
// online softmax in f32, GQA groups folded into rows.
//
// Layout: q (B, H, Dh); k_pages / v_pages (n_pages, page_size, Kh, Dh);
// block_tables (B, P) int32; lengths (B,) int32 >= 1; out (B, H, Dh).
// One block per (KV head, row): it reads its page ids from the block table
// itself and stops at lengths[b] (see paged_attend.cuh for the body and for
// what bounds it: the K/V bytes of the real context).

#include "paged_attend.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out, int P,
                       int n_pages, int ps, int H, int kh_n, int dh, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int length = max(lengths[b], 1);
  const long row = static_cast<long>(b) * H * dh;
  paged_attend_tile<T>(q + row, k_pages, v_pages, block_tables + static_cast<long>(b) * P,
                       out + row, /*t0=*/0, /*nq=*/1, /*n_tok=*/1,
                       /*pos0=*/length - 1, /*depth=*/length, P, n_pages, ps, H, kh_n, kh,
                       dh, scale);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt, const int* lengths,
           void* out, int B, int P, int n_pages, int ps, int H, int kh_n, int dh,
           float scale, cudaStream_t stream) {
  const int rows = H / kh_n;
  const size_t smem = sizeof(float) * paged_smem_floats(rows, ps, dh);
  cudaError_t err = set_smem(paged_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_kernel<T><<<dim3(kh_n, B), PA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt,
      lengths, static_cast<T*>(out), P, n_pages, ps, H, kh_n, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// dtype: DT_F32 or DT_BF16 (q, pools and out share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const int* block_tables, const int* lengths, void* out,
                                      int B, int P, int n_pages, int page_size, int H,
                                      int kh_n, int dh, float scale, int dtype,
                                      void* stream) {
  cudaGetLastError();
  if (B <= 0 || P <= 0 || kh_n <= 0 || H % kh_n != 0 || !paged_shape_ok(H / kh_n, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths, out, B, P,
                                 n_pages, page_size, H, kh_n, dh, scale, s);
  if (dtype == DT_F32)
    return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B, P, n_pages,
                         page_size, H, kh_n, dh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
