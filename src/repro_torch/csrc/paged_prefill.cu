// Chunked-prefill attention over paged KV for Hopper (sm_90a).
//
// Replaces the Pallas TPU body src/repro/kernels/paged_prefill.py::
// _paged_prefill_kernel: one request's chunk of Tc queries at global
// positions start + t attends causally over the request's paged context
// (trie-reused prefix pages included) plus the chunk itself, with an online
// softmax, never materialising the (Tc, P * page_size) score matrix.
//
// Layout: q (Tc, H, Dh); k_pages / v_pages (n_pages, page_size, Kh, Dh);
// bt_row (P,) int32; out (Tc, H, Dh). Query t sees kv_pos <= start + t and
// kv_pos < start + chunk_len; padded tail queries (t >= chunk_len) see the
// whole real context, so their normaliser stays positive.
// One block per (query tile of q_tile tokens, KV head). A block walks only
// the pages with base < start + chunk_len and base <= its last query
// position, so KV read grows with the real depth (see paged_attend.cuh).

#include "paged_attend.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages, const int* __restrict__ bt_row,
                     T* __restrict__ out, int Tc, int q_tile, int start, int chunk_len, int P,
                     int n_pages, int ps, int H, int kh_n, int dh, float scale) {
  const int t0 = blockIdx.x * q_tile;
  const int kh = blockIdx.y;
  paged_attend_tile<T>(q, k_pages, v_pages, bt_row, out, t0, q_tile, Tc, /*pos0=*/start,
                       /*depth=*/start + chunk_len, P, n_pages, ps, H, kh_n, kh, dh, scale);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt, void* out, int Tc,
           int q_tile, int start, int chunk_len, int P, int n_pages, int ps, int H, int kh_n,
           int dh, float scale, cudaStream_t stream) {
  const int rows = q_tile * (H / kh_n);
  const size_t smem = sizeof(float) * paged_smem_floats(rows, ps, dh);
  cudaError_t err = set_smem(paged_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tc + q_tile - 1) / q_tile, kh_n);
  paged_prefill_kernel<T><<<grid, PA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt,
      static_cast<T*>(out), Tc, q_tile, start, chunk_len, P, n_pages, ps, H, kh_n, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// dtype: DT_F32 or DT_BF16 (q, pools and out share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_prefill_launch(const void* q, const void* k_pages, const void* v_pages,
                                    const int* bt_row, void* out, int Tc, int q_tile,
                                    int start, int chunk_len, int P, int n_pages,
                                    int page_size, int H, int kh_n, int dh, float scale,
                                    int dtype, void* stream) {
  cudaGetLastError();
  if (Tc <= 0 || q_tile <= 0 || P <= 0 || kh_n <= 0 || H % kh_n != 0 ||
      start + chunk_len < 1 || !paged_shape_ok(q_tile * (H / kh_n), dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, bt_row, out, Tc, q_tile, start,
                                 chunk_len, P, n_pages, page_size, H, kh_n, dh, scale, s);
  if (dtype == DT_F32)
    return launch<float>(q, k_pages, v_pages, bt_row, out, Tc, q_tile, start, chunk_len, P,
                         n_pages, page_size, H, kh_n, dh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
