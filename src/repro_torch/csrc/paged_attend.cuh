// The shared body of the paged-attention kernels (paged_attention.cu for a
// decode step, paged_prefill.cu for a prefill chunk).
//
// One thread block owns a tile of query rows that share one KV head: `nq`
// consecutive query tokens times the `g = H / Kh` query heads of that KV
// head, row r = token * g + j (the reference's GQA folding). It walks the
// pages of its block-table row in order, and for each page:
//   1. copies the page's K and V for positions below `depth` into shared
//      memory (positions at or past `depth` are never read: stale or NaN
//      entries there cannot reach the sum, not even as 0 * NaN);
//   2. scores every (row, position) pair with an f32 dot product;
//   3. runs the online-softmax update per row (running max, normaliser),
//      masking kv_pos > q_pos(row) and kv_pos >= depth;
//   4. accumulates p (rounded to the value type, as the reference casts p
//      before PV) times V into per-thread f32 registers.
// It stops at the first page past `depth` or past the tile's last query
// position, and divides once at the end. A decode step is the special case
// of one query token at position length - 1 with depth = length.
//
// What bounds it on the H100: the K/V bytes (about 4 flops per byte read), so
// the work is proportional to the real context depth, never to the block
// table's width. Simple first version: one block per (tile, KV head), three
// barriers per page, no split of a long context across blocks.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int PA_THREADS = 128;
constexpr int PA_MAX_ROWS_PER_THREAD = 16;  // rows * Dh <= 128 * 16

// floats of dynamic shared memory the body needs
__host__ __device__ inline int paged_smem_floats(int rows, int ps, int dh) {
  return rows * (dh + 1) + ps * (dh + 1) + ps * dh + rows * ps + 3 * rows;
}

template <typename T>
__device__ void paged_attend_tile(
    const T* __restrict__ q,        // query token t, head h at q[(t * H + h) * dh]
    const T* __restrict__ k_pages,  // (n_pages, ps, kh_n, dh)
    const T* __restrict__ v_pages,
    const int* __restrict__ bt,     // this tile's block-table row, P entries
    T* __restrict__ out,            // same layout as q
    int t0, int nq, int n_tok,      // tile tokens t0 .. t0+nq-1 of n_tok
    int pos0,                       // global position of token 0
    int depth,                      // valid KV positions: [0, depth)
    int P, int n_pages, int ps, int H, int kh_n, int kh, int dh, float scale) {
  extern __shared__ float smem[];
  const int g = H / kh_n;
  const int rows = nq * g;
  float* q_s = smem;                          // [rows][dh + 1]
  float* k_s = q_s + rows * (dh + 1);         // [ps][dh + 1]
  float* v_s = k_s + ps * (dh + 1);           // [ps][dh]
  float* s_s = v_s + ps * dh;                 // [rows][ps] scores, then p
  float* m_s = s_s + rows * ps;               // [rows] running max
  float* l_s = m_s + rows;                    // [rows] running normaliser
  float* a_s = l_s + rows;                    // [rows] rescale of this page

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_warps = PA_THREADS / 32;

  for (int idx = tid; idx < rows * dh; idx += PA_THREADS) {
    const int r = idx / dh, d = idx % dh;
    const int t = t0 + r / g, h = kh * g + r % g;
    q_s[r * (dh + 1) + d] = (t < n_tok) ? to_f32(q[(static_cast<long>(t) * H + h) * dh + d]) : 0.f;
  }
  for (int r = tid; r < rows; r += PA_THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // thread -> (column d, row group); rows rg, rg + n_rg, ...
  const int d_own = tid % dh;
  const int rg = tid / dh;
  const int n_rg = PA_THREADS / dh;
  float acc[PA_MAX_ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < PA_MAX_ROWS_PER_THREAD; ++i) acc[i] = 0.f;

  const int t_last = min(t0 + nq, n_tok) - 1;
  const int q_hi = pos0 + t_last;             // last query position of the tile
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const int base = p * ps;
    if (base >= depth || base > q_hi) break;  // pages are in position order
    const int page = min(max(bt[p], 0), n_pages - 1);
    const long page_off = static_cast<long>(page) * ps * kh_n * dh;
    for (int idx = tid; idx < ps * dh; idx += PA_THREADS) {
      const int s = idx / dh, d = idx % dh;
      float kv = 0.f, vv = 0.f;
      if (base + s < depth) {
        const long off = page_off + (static_cast<long>(s) * kh_n + kh) * dh + d;
        kv = to_f32(k_pages[off]);
        vv = to_f32(v_pages[off]);
      }
      k_s[s * (dh + 1) + d] = kv;
      v_s[s * dh + d] = vv;
    }
    __syncthreads();

    for (int idx = tid; idx < rows * ps; idx += PA_THREADS) {
      const int r = idx / ps, s = idx % ps;
      const int kv_pos = base + s;
      const int q_pos = pos0 + t0 + r / g;
      float sc = -INFINITY;
      if (kv_pos < depth && kv_pos <= q_pos) {
        const float* qr = q_s + r * (dh + 1);
        const float* kr = k_s + s * (dh + 1);
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      s_s[r * ps + s] = sc;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += n_warps) {
      float mx = -INFINITY;
      for (int s = lane; s < ps; s += 32) mx = fmaxf(mx, s_s[r * ps + s]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < ps; s += 32) {
        const float sc = s_s[r * ps + s];
        float pr = 0.f;
        if (sc != -INFINITY) {
          pr = expf(sc - m_new);
          sum += pr;
          pr = to_f32(from_f32<T>(pr));       // p is cast to V's type before PV
        }
        s_s[r * ps + s] = pr;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        // m_new == -inf: no valid position yet; nothing to rescale
        const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < PA_MAX_ROWS_PER_THREAD; ++i) {
      const int r = rg + i * n_rg;
      if (r >= rows) break;
      float a = acc[i] * a_s[r];
      const float* pr = s_s + r * ps;
      for (int s = 0; s < ps; ++s) a = fmaf(pr[s], v_s[s * dh + d_own], a);
      acc[i] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PA_MAX_ROWS_PER_THREAD; ++i) {
    const int r = rg + i * n_rg;
    if (r >= rows) break;
    const int t = t0 + r / g, h = kh * g + r % g;
    if (t >= n_tok) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    out[(static_cast<long>(t) * H + h) * dh + d_own] = from_f32<T>(acc[i] / l);
  }
}

// Shapes the body accepts: dh divides the block's 128 threads, and every
// thread owns at most PA_MAX_ROWS_PER_THREAD rows.
inline bool paged_shape_ok(int rows, int dh) {
  return dh > 0 && dh <= PA_THREADS && PA_THREADS % dh == 0 &&
         rows * dh <= PA_THREADS * PA_MAX_ROWS_PER_THREAD;
}

// Opt in to more than 48 KB of dynamic shared memory once per kernel.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
