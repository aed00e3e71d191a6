// Speculative-verify attention over paged KV for Hopper (sm_90a).
//
// Replaces the Pallas TPU body src/repro/kernels/paged_attention.py::
// _paged_verify_kernel: a window of Tq queries per row b (the pending token
// and the draft's k proposals) against the row's KV pages, softmax in f32,
// the window folded into the GQA group rows. Query t of row b sits at
// position lengths[b] - Tq + t and sees kv_pos < lengths[b] - (Tq - 1) + t:
// the accepted context plus the window up to and including itself (the
// window's K/V is already in the pool).
//
// Layout: q (B, Tq, H, Dh); k_pages / v_pages (n_pages, page_size, Kh, Dh);
// block_tables (B, P) int32; lengths (B,) int32 >= Tq; out (B, Tq, H, Dh).
//
// Design (paged_attend.cuh): split-KV, grid (splits x window tiles, Kh, B).
// A tile holds q_tile window tokens times the g = H / Kh heads of its KV
// head (olmo-1b: g 1, Tq 5 is one tile; g 4 takes two). Each block reads
// one split of its row's K/V once for every query of the tile, so the
// window costs about the K/V bytes of one decode step, which is what bounds
// it on the H100. bf16 runs the tensor-core body, f32 the SIMT one. Each
// kernel function is the decode kernel's (paged_attention.cu), so query t
// equals the decode kernel at length lengths[b] - (Tq - 1) + t bit for bit.

#include "paged_attend.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(SK_THREADS)
    paged_verify_kernel(const SplitParams p) {
  split_kv_block<T>(p);
}

__global__ void __launch_bounds__(32 * TC_MAX_WARPS) paged_verify_kernel_tc(const SplitParams p) {
  split_tc_block(p);
}

template <typename T>
__global__ void paged_verify_kernel_combine(const SplitParams p) {
  combine_row<T>(p);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// dtype: DT_F32 or DT_BF16 (q, pools and out share it); route:
// ROUTE_SPLIT_TC (bf16) or ROUTE_SPLIT_KV; stages: STAGE_SPLIT |
// STAGE_COMBINE. scratch: the f32 partials, B * Tq * H * n_splits * (2 +
// Dh) floats (m and l pairs first). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int paged_verify_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const int* block_tables, const int* lengths, void* out,
                                   float* scratch, int B, int Tq, int q_tile, int P,
                                   int n_pages, int page_size, int H, int kh_n, int dh,
                                   int n_splits, int split_pages, int vec, float scale,
                                   int dtype, int route, int stages, void* stream) {
  cudaGetLastError();
  if (kh_n <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const SplitParams p{q, k_pages, v_pages, block_tables, lengths, /*info=*/nullptr,
                      reinterpret_cast<float2*>(scratch),
                      scratch + 2L * B * Tq * H * n_splits, out,
                      Tq, q_tile, n_splits, split_pages, P, n_pages, page_size, H, kh_n, dh,
                      vec, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_split<__nv_bfloat16>(p, B, dtype, route, stages,
                                       paged_verify_kernel<__nv_bfloat16>,
                                       paged_verify_kernel_tc,
                                       paged_verify_kernel_combine<__nv_bfloat16>, s);
  if (dtype == DT_F32)
    return launch_split<float>(p, B, dtype, route, stages, paged_verify_kernel<float>,
                               paged_verify_kernel_tc, paged_verify_kernel_combine<float>, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_verify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
