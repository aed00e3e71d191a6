// Chunked-prefill attention over paged KV for Hopper (sm_90a).
//
// Replaces the Pallas TPU body src/repro/kernels/paged_prefill.py::
// _paged_prefill_kernel: one request's chunk of Tc queries at global
// positions start + t attends causally over the request's paged context
// (trie-reused prefix pages included) plus the chunk itself, never
// materialising the (Tc, P * page_size) score matrix.
//
// Layout: q (Tc, H, Dh); k_pages / v_pages (n_pages, page_size, Kh, Dh);
// bt_row (P,) int32; out (Tc, H, Dh). Query t sees kv_pos <= start + t and
// kv_pos < start + chunk_len; padded tail queries (t >= chunk_len) see the
// whole real context, so their normaliser stays positive.
//
// Design (paged_attend.cuh): grid (splits x query tiles, Kh), each block
// one split of S pages against one tile of queries; then the combine. A
// block skips a split that starts past its tile's last query position or
// past start + chunk_len, so K/V read grows with the real depth. bf16 runs
// the tensor-core body on tiles of 32 rows (at olmo-1b's chunk of 64 and
// start 448, 8 splits x 2 tiles x 16 KV heads = 256 blocks, where one block
// per 16-token tile and KV head made 64); f32, the parity route of the
// exact phases, the SIMT body with no TF32.

#include "paged_attend.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(SK_THREADS)
    paged_prefill_kernel(const SplitParams p) {
  split_kv_block<T>(p);
}

__global__ void __launch_bounds__(32 * TC_MAX_WARPS) paged_prefill_kernel_tc(const SplitParams p) {
  split_tc_block(p);
}

template <typename T>
__global__ void paged_prefill_kernel_combine(const SplitParams p) {
  combine_row<T>(p);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// info: (start, chunk_len), two int32 on the device, read by every block
// (so a captured launch replays at any start and length, and the host
// never reads them back). dtype: DT_F32 or DT_BF16 (q, pools and out share
// it); route: ROUTE_SPLIT_TC (bf16) or ROUTE_SPLIT_KV; stages: STAGE_SPLIT |
// STAGE_COMBINE. scratch: the f32 partials, Tc * H * n_splits * (2 + Dh)
// floats (m and l pairs first). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int paged_prefill_launch(const void* q, const void* k_pages, const void* v_pages,
                                    const int* bt_row, const int* info, void* out,
                                    float* scratch, int Tc, int q_tile, int P, int n_pages,
                                    int page_size, int H, int kh_n, int dh, int n_splits,
                                    int split_pages, int vec, float scale, int dtype,
                                    int route, int stages, void* stream) {
  cudaGetLastError();
  if (kh_n <= 0 || H <= 0 || info == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const SplitParams p{q, k_pages, v_pages, bt_row, nullptr, info,
                      reinterpret_cast<float2*>(scratch),
                      scratch + 2L * Tc * H * n_splits, out,
                      Tc, q_tile, n_splits, split_pages, P, n_pages, page_size, H, kh_n, dh,
                      vec, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_split<__nv_bfloat16>(p, 1, dtype, route, stages,
                                       paged_prefill_kernel<__nv_bfloat16>,
                                       paged_prefill_kernel_tc,
                                       paged_prefill_kernel_combine<__nv_bfloat16>, s);
  if (dtype == DT_F32)
    return launch_split<float>(p, 1, dtype, route, stages, paged_prefill_kernel<float>,
                               paged_prefill_kernel_tc, paged_prefill_kernel_combine<float>, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
