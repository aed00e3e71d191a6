// Paged-attention decode step for Hopper (sm_90a).
//
// Replaces the Pallas TPU body src/repro/kernels/paged_attention.py::
// _paged_attn_kernel: one decode query per row b over the row's KV pages,
// softmax in f32, GQA groups folded into rows.
//
// Layout: q (B, H, Dh); k_pages / v_pages (n_pages, page_size, Kh, Dh);
// block_tables (B, P) int32; lengths (B,) int32 >= 1; out (B, H, Dh).
// Design (paged_attend.cuh): split-KV, grid (splits, Kh, B), each block one
// split of S pages of one row's context, then the combine. It is bound by
// the K/V bytes of the real context; the split grid puts 9 x 16 x 4 = 576
// blocks' loads in flight at olmo-1b's served decode step (one block per
// (KV head, row) before: 64). bf16 runs the tensor-core body, f32 the SIMT
// one. Each kernel function is the verify kernel's (paged_verify.cu) with
// one query, so a verify window's query equals this kernel at its own
// length bit for bit.

#include "paged_attend.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(SK_THREADS)
    paged_attention_kernel(const SplitParams p) {
  split_kv_block<T>(p);
}

__global__ void __launch_bounds__(32 * TC_MAX_WARPS)
    paged_attention_kernel_tc(const SplitParams p) {
  split_tc_block(p);
}

template <typename T>
__global__ void paged_attention_kernel_combine(const SplitParams p) {
  combine_row<T>(p);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// dtype: DT_F32 or DT_BF16 (q, pools and out share it); route:
// ROUTE_SPLIT_TC (bf16) or ROUTE_SPLIT_KV; stages: STAGE_SPLIT |
// STAGE_COMBINE. scratch: the f32 partials, B * H * n_splits * (2 + Dh)
// floats (m and l pairs first). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const int* block_tables, const int* lengths, void* out,
                                      float* scratch, int B, int P, int n_pages, int page_size,
                                      int H, int kh_n, int dh, int n_splits, int split_pages,
                                      int vec, float scale, int dtype, int route, int stages,
                                      void* stream) {
  cudaGetLastError();
  if (kh_n <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const SplitParams p{q, k_pages, v_pages, block_tables, lengths, /*info=*/nullptr,
                      reinterpret_cast<float2*>(scratch),
                      scratch + 2L * B * H * n_splits, out,
                      /*n_tok=*/1, /*q_tile=*/1, n_splits, split_pages, P, n_pages, page_size,
                      H, kh_n, dh, vec, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_split<__nv_bfloat16>(p, B, dtype, route, stages,
                                       paged_attention_kernel<__nv_bfloat16>,
                                       paged_attention_kernel_tc,
                                       paged_attention_kernel_combine<__nv_bfloat16>, s);
  if (dtype == DT_F32)
    return launch_split<float>(p, B, dtype, route, stages, paged_attention_kernel<float>,
                               paged_attention_kernel_tc, paged_attention_kernel_combine<float>,
                               s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
