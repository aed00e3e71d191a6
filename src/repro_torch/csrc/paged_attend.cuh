// The shared bodies of the paged-attention kernels: paged_attention.cu (a
// decode step), paged_verify.cu (a speculative verify window) and
// paged_prefill.cu (a prefill chunk).
//
// What bounds them on the H100: the K/V bytes of the real context (about 4
// flops per byte read in a decode step, ~60 in a 64-token prefill chunk),
// so the time is a question of how many bytes are in flight at once.
//
// Split-KV. A row's KV range is cut into splits of `split_pages` (S) pages,
// boundaries at multiples of S pages from position 0, and each split is one
// block: grid (splits x query tiles, Kh, B), the split count taken from the
// block table's width (a host shape; `lengths` stays on the card). A block
// reads its S page ids first (with `lengths`, not after it), then copies
// q and the split's K and V with 16-byte cp.async copies, q and K in one
// group and V in another, all in flight before the first score; positions
// at or past the depth are zero-filled, never read (stale or NaN entries
// there cannot reach the sum, not even as 0 * NaN). The block writes a
// partial (m, l, acc in f32) per query row; a block whose split starts at
// or past its rows' depth writes the empty partial (m = -inf, l = 0,
// acc = 0) and returns. A second kernel combines the splits of each (row, token, head)
// in split-index order (no atomics), divides once and writes T.
//
// Two bodies fill a split, chosen by dtype (kernels/paged_attention.py
// plan):
//  * split_tc_block (bf16, all three kernels): one warp a tile of 16 query
//    rows (tokens x the g = H / Kh heads of a KV head; a decode step or a
//    verify window one warp, a prefill chunk two), QK^T and PV on
//    mma.sync.m16n8k16 (bf16 in, f32 accumulate) from ldmatrix, the
//    softmax over the split in registers, P rounded to bf16 in the
//    registers that feed PV (as the reference casts p to V's type). The
//    work is far below the tensor cores' rate (a 64-token chunk is ~0.25
//    GFLOP against ~4 MB of K/V), so mma.sync's simple fragments (no
//    descriptors, no async proxy) cost nothing that matters against wgmma;
//    rows padded by 16 bytes keep ldmatrix free of bank conflicts. At
//    bf16 the SIMT body below was bound by instruction issue (bf16
//    unpacking, address arithmetic, shuffle trees): at a verify window's
//    5 rows its scores took longer than its loads.
//  * split_kv_block (f32, the parity route; SIMT, no TF32): a tile of up
//    to SK_ROWS query rows, SK_GROUP rows at a time so that independent
//    sums hide each other's latency. Scores: 8 lanes a position (at Dh
//    128), each a dot over 16 columns in two chains, then a fixed 3-step
//    xor-shuffle tree. Softmax over the whole split at once (one max, one
//    sum a row). PV: a thread a (column pair, row group), even and odd
//    positions in two sums in order.
//
// Invariance (what the speculative streams need): query t of a verify
// window at depth L equals, bit for bit, the decode kernel at length
// L - (Tq - 1) + t, for any block-table width. It holds because
//  - at each dtype the decode and verify kernels are one function
//    (split_tc_block at bf16, split_kv_block at f32, one warp a block for
//    both at bf16) with every shape a runtime argument, so the same
//    instructions compute a row whatever Tq, B, P or the row's slot; an
//    mma's output row depends on its own row of A alone;
//  - a row's score, max, sum and PV at a position depend on that row and
//    position only; a position masked for the row gives p = 0 exactly and
//    adds 0 to the sum and to PV (fma(0, v, a) == a; a zero product in an
//    mma), so a row whose horizon ends inside the split or before it gets
//    the partial it would get from a block loaded to its own depth, and
//    the empty partial when it sees nothing of the split;
//  - split boundaries depend on S alone, and the combine skips empty
//    partials, so a wider table only adds splits that change nothing;
//  - products and sums whose rounding matters are written as __fmul_rn,
//    __fadd_rn and fmaf, so no contraction can differ between call sites.
#pragma once

#include "common.cuh"
#include "tc.cuh"

namespace repro_torch {

constexpr int SK_THREADS = 128;  // split_kv_block: 4 warps
constexpr int SK_ROWS = 16;      // query rows a split_kv_block owns at most
constexpr int SK_GROUP = 2;      // rows a score or PV pass computes together
constexpr int MAX_SPLIT_PAGES = 8;
constexpr int TC_MAX_WARPS = 2;  // split_tc_block: 16 query rows a warp
constexpr int TC_MAX_KEYS = 64;  // positions of a split the tc body holds
constexpr int TC_MAX_DH = 128;

// Everything a split block and the combine need; passed by value.
struct SplitParams {
  const void* q;        // (rows of B * n_tok tokens, H, Dh), token-major
  const void* k_pages;  // (n_pages, ps, kh_n, dh)
  const void* v_pages;
  const int* bt;        // (B, P) block tables, row-major
  const int* lengths;   // (B,) depth at the last token, or null: prefill
  const int* info;      // prefill: (start, chunk_len) on the device
  float2* ml;           // (q rows, splits): running max and normaliser
  float* acc;           // (q rows, splits, dh): unnormalised output
  void* out;            // like q
  int n_tok, q_tile, n_splits, split_pages;
  int P, n_pages, ps, H, kh_n, dh;
  int vec;               // widest copy every K/V/q row start is aligned to
  float scale;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile of a block: tokens t0 .. t0 + nq - 1 of batch row b, KV head kh,
// split `split`; query token t sees positions < min(pos0 + t + 1, depth).
struct Tile {
  int b, kh, split, t0, nq, g, rows, pos0, depth, base, sp, hi;
};

__device__ __forceinline__ Tile tile_of(const SplitParams& p) {
  Tile t;
  t.split = blockIdx.x % p.n_splits;
  t.t0 = (blockIdx.x / p.n_splits) * p.q_tile;
  t.kh = blockIdx.y;
  t.b = blockIdx.z;
  t.nq = min(p.q_tile, p.n_tok - t.t0);
  t.g = p.H / p.kh_n;
  t.rows = t.nq * t.g;
  if (p.lengths) {  // decode / verify: the window ends at the row's depth
    t.depth = max(p.lengths[t.b], p.n_tok);
    t.pos0 = t.depth - p.n_tok;
  } else {
    t.pos0 = p.info[0];  // positions start .. start + chunk_len - 1
    t.depth = t.pos0 + p.info[1];
  }
  t.sp = p.split_pages * p.ps;
  t.base = t.split * t.sp;
  t.hi = min(t.pos0 + t.t0 + t.nq, t.depth);  // the tile's last horizon
  return t;
}

// Row r of the tile as a row of q / out / the partials (token-major).
__device__ __forceinline__ long q_row(const SplitParams& p, const Tile& t, int r) {
  return (static_cast<long>(t.b) * p.n_tok + t.t0 + r / t.g) * p.H + t.kh * t.g + r % t.g;
}
__device__ __forceinline__ int horizon(const Tile& t, int r) {
  return min(t.pos0 + t.t0 + r / t.g + 1, t.depth);
}

// Every row of the tile sees nothing of this split.
__device__ inline void write_empty(const SplitParams& p, const Tile& t) {
  for (int i = threadIdx.x; i < t.rows * p.dh; i += blockDim.x) {
    const long slot = q_row(p, t, i / p.dh) * p.n_splits + t.split;
    p.acc[slot * p.dh + i % p.dh] = 0.f;
    if (i % p.dh == 0) p.ml[slot] = make_float2(-INFINITY, 0.f);
  }
}

// The split's page ids, read before the row's depth is known so that the
// table and `lengths` are fetched together (pages past the table: the null
// page, never read).
__device__ __forceinline__ void split_pages_of(const SplitParams& p,
                                               int (&page)[MAX_SPLIT_PAGES]) {
  const int split = blockIdx.x % p.n_splits;
  const int* bt = p.bt + static_cast<long>(blockIdx.z) * p.P + split * p.split_pages;
  const int left = p.P - split * p.split_pages;
#pragma unroll
  for (int k = 0; k < MAX_SPLIT_PAGES; ++k)
    page[k] = (k < p.split_pages && k < left) ? min(max(bt[k], 0), p.n_pages - 1) : 0;
}

// Copy positions [base, base + sp) of KV head kh into dst rows of
// `stride` bytes (K then V, one cp.async group each); positions at or past
// `hi` are zero-filled without a read.
template <typename T>
__device__ void load_split(const SplitParams& p, const Tile& t,
                           const int (&page)[MAX_SPLIT_PAGES], uint32_t k_dst, uint32_t v_dst,
                           int stride) {
  const int row_bytes = p.dh * static_cast<int>(sizeof(T));
  const int lc = __ffs(row_bytes >> 4) - 1;  // log2 of the 16-byte chunks a row
  const long step = static_cast<long>(p.kh_n) * row_bytes;  // between positions
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const auto* src = static_cast<const uint8_t*>(kv ? p.v_pages : p.k_pages);
    const uint32_t dst = kv ? v_dst : k_dst;
#pragma unroll
    for (int k = 0; k < MAX_SPLIT_PAGES; ++k) {
      if (k >= p.split_pages) break;
      const int pos0 = t.base + k * p.ps;
      const uint8_t* pg = src + (static_cast<long>(page[k]) * p.ps * p.kh_n + t.kh) * row_bytes;
      for (int i = threadIdx.x; i < (p.ps << lc); i += blockDim.x) {
        const int s = i >> lc, c = (i & ((1 << lc) - 1)) * 16;
        const bool live = pos0 + s < t.hi;
        tc::copy16(dst + (k * p.ps + s) * stride + c, pg + s * step + c, src, live ? 16 : 0,
                   p.vec);
      }
    }
    cp_async_commit();
  }
}

// Copy `n` query rows of the tile into dst rows of `stride` bytes, rows at
// or past its real rows zero-filled (part of the next cp.async group).
template <typename T>
__device__ void load_q(const SplitParams& p, const Tile& t, uint32_t dst, int stride, int n) {
  const int row_bytes = p.dh * static_cast<int>(sizeof(T));
  const int lc = __ffs(row_bytes >> 4) - 1;
  const auto* qb = static_cast<const uint8_t*>(p.q);
  for (int i = threadIdx.x; i < (n << lc); i += blockDim.x) {
    const int r = i >> lc, c = (i & ((1 << lc) - 1)) * 16;
    const bool live = r < t.rows;
    const long off = live ? q_row(p, t, r) * row_bytes + c : 0;
    tc::copy16(dst + r * stride + c, qb + off, qb, live ? 16 : 0, p.vec);
  }
}

// ------------------------------------------------------------ split_kv_block
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Query rows a block's shared memory holds: its tile's, in whole groups.
__host__ __device__ inline int split_kv_rows(const SplitParams& p) {
  const int rows = p.q_tile * (p.H / p.kh_n);
  return (rows + SK_GROUP - 1) / SK_GROUP * SK_GROUP;
}
__host__ __device__ inline int split_kv_smem_bytes(const SplitParams& p, int elem) {
  const int sp = p.split_pages * p.ps, rows = split_kv_rows(p);
  return (2 * sp + rows) * p.dh * elem + 2 * rows * sp * 4 + 2 * rows * 4;
}

template <typename T>
__device__ void split_kv_block(const SplitParams& p) {
  int page[MAX_SPLIT_PAGES];
  split_pages_of(p, page);
  const Tile t = tile_of(p);
  if (t.base >= t.hi) {
    write_empty(p, t);
    return;
  }
  extern __shared__ __align__(16) uint8_t smem[];
  const int dh = p.dh, sp = t.sp, nr = split_kv_rows(p);
  const int groups = (t.rows + SK_GROUP - 1) / SK_GROUP;
  T* k_s = reinterpret_cast<T*>(smem);                 // [sp][dh]
  T* v_s = k_s + sp * dh;                              // [sp][dh]
  T* q_s = v_s + sp * dh;                              // [nr][dh]
  float* s_s = reinterpret_cast<float*>(q_s + nr * dh);  // [nr][sp]
  float* p_t = s_s + nr * sp;                          // [sp][nr]: p
  float* m_s = p_t + nr * sp;                          // [nr]
  float* l_s = m_s + nr;                               // [nr]
  const int row_bytes = dh * static_cast<int>(sizeof(T));
  load_q<T>(p, t, tc::smem_u32(q_s), row_bytes, groups * SK_GROUP);
  load_split<T>(p, t, page, tc::smem_u32(k_s), tc::smem_u32(v_s), row_bytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // scores: lpp lanes a position, each a dot over dpl columns (16 of 128:
  // 4-column pieces lpp * 4 apart, so that the lanes of a position read
  // one contiguous run), then a fixed xor-shuffle tree; SK_GROUP rows at
  // once (a row past the tile's rows has q = 0 and is not stored)
  const int dpl = dh >= 32 ? dh / 8 : 4;
  const int lpp = dh / dpl, ppw = 32 / lpp, sub = lane % lpp;
  cp_async_wait<1>();
  __syncthreads();
  for (int g0 = 0; g0 < groups; ++g0) {
    float qv[SK_GROUP][16];  // this lane's columns of the group's q rows
    int hz[SK_GROUP];
#pragma unroll
    for (int i = 0; i < SK_GROUP; ++i) {
      hz[i] = horizon(t, g0 * SK_GROUP + i);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * c < dpl)
          load4<T>(q_s + (g0 * SK_GROUP + i) * dh, (c * lpp + sub) * 4, dh, true, &qv[i][4 * c]);
    }
#pragma unroll 4
    for (int j0 = warp * ppw; j0 < sp; j0 += (SK_THREADS / 32) * ppw) {
      const int j = j0 + lane / lpp;
      const T* krow = k_s + min(j, sp - 1) * dh;
      float kv[16];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * c < dpl) load4<T>(krow, (c * lpp + sub) * 4, dh, true, &kv[4 * c]);
      float d[SK_GROUP];
#pragma unroll
      for (int i = 0; i < SK_GROUP; ++i) {
        float a0 = 0.f, a1 = 0.f;  // even and odd 4-column pieces
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
          if (4 * c >= dpl) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) a0 = fmaf(qv[i][4 * c + e], kv[4 * c + e], a0);
          if (4 * c + 4 < dpl) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a1 = fmaf(qv[i][4 * c + 4 + e], kv[4 * c + 4 + e], a1);
          }
        }
        d[i] = __fadd_rn(a0, a1);
      }
      for (int o = lpp / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < SK_GROUP; ++i) d[i] = __fadd_rn(d[i], __shfl_xor_sync(0xffffffffu, d[i], o));
      }
      if (sub == 0 && j < sp) {
#pragma unroll
        for (int i = 0; i < SK_GROUP; ++i) {
          const int r = g0 * SK_GROUP + i;
          if (r < t.rows)
            s_s[r * sp + j] = (t.base + j < hz[i]) ? __fmul_rn(d[i], p.scale) : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // softmax over the split, one warp a row: p = exp(s - m), 0 where masked
  for (int r = warp; r < t.rows; r += SK_THREADS / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < sp; j += 32) mx = fmaxf(mx, s_s[r * sp + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < sp; j += 32) {
      const float sc = s_s[r * sp + j];
      float pr = 0.f;
      if (sc != -INFINITY) {
        pr = expf(__fsub_rn(sc, mx));
        sum = __fadd_rn(sum, pr);
        pr = to_f32(from_f32<T>(pr));  // p is cast to V's type before PV
      }
      p_t[j * nr + r] = pr;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // PV: a thread a (column pair, group of SK_GROUP rows); even and odd
  // positions in two sums, each in position order, then added
  const int pairs = dh / 2;
  for (int it = tid; it < groups * pairs; it += SK_THREADS) {
    const int g0 = it / pairs, d = (it % pairs) * 2;
    float a[SK_GROUP][2][2];  // [row][column][position parity]
#pragma unroll
    for (int i = 0; i < SK_GROUP; ++i) a[i][0][0] = a[i][0][1] = a[i][1][0] = a[i][1][1] = 0.f;
    const float* pg = p_t + g0 * SK_GROUP;
#pragma unroll 4
    for (int j = 0; j < sp; j += 2) {  // positions j (even) and j + 1 (odd)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (j + h >= sp) break;  // an odd split length's last position
        const float2 v = load2(v_s + (j + h) * dh + d);
        const float2 pr = *reinterpret_cast<const float2*>(pg + (j + h) * nr);
        a[0][0][h] = fmaf(pr.x, v.x, a[0][0][h]);
        a[0][1][h] = fmaf(pr.x, v.y, a[0][1][h]);
        a[1][0][h] = fmaf(pr.y, v.x, a[1][0][h]);
        a[1][1][h] = fmaf(pr.y, v.y, a[1][1][h]);
      }
    }
#pragma unroll
    for (int i = 0; i < SK_GROUP; ++i) {
      const int r = g0 * SK_GROUP + i;
      if (r >= t.rows) break;
      const long slot = q_row(p, t, r) * p.n_splits + t.split;
      *reinterpret_cast<float2*>(p.acc + slot * dh + d) =
          make_float2(__fadd_rn(a[i][0][0], a[i][0][1]), __fadd_rn(a[i][1][0], a[i][1][1]));
      if (d == 0) p.ml[slot] = make_float2(m_s[r], l_s[r]);
    }
  }
}

// ------------------------------------------------------------ split_tc_block
// rows of dh bf16 padded by 16 bytes: 8 rows at one column fall in 8
// distinct bank groups for ldmatrix
__host__ __device__ inline int tc_stride(int dh) { return dh * 2 + 16; }
__host__ __device__ inline int tc_warps(const SplitParams& p) {
  return (p.q_tile * (p.H / p.kh_n) + 15) / 16;
}
__host__ __device__ inline int tc_smem_bytes(const SplitParams& p) {
  return (16 * tc_warps(p) + 2 * p.split_pages * p.ps) * tc_stride(p.dh);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * gq + c; A holds rows
// gq and gq + 8, columns 2c, 2c + 1 (+ 8); B columns gq, rows 2c, 2c + 1
// (+ 8); C rows gq (regs 0, 1) and gq + 8 (regs 2, 3), columns 2c, 2c + 1.
__device__ inline void split_tc_block(const SplitParams& p) {
  using bf16 = __nv_bfloat16;
  int page[MAX_SPLIT_PAGES];
  split_pages_of(p, page);
  const Tile t = tile_of(p);
  if (t.base >= t.hi) {
    write_empty(p, t);
    return;
  }
  extern __shared__ __align__(16) uint8_t smem[];
  const int dh = p.dh, sp = t.sp, stride = tc_stride(dh), n_rows = 16 * tc_warps(p);
  const uint32_t q_s = tc::smem_u32(smem);
  const uint32_t k_s = q_s + n_rows * stride;
  const uint32_t v_s = k_s + sp * stride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, c = lane % 4;

  // Q rows of the tile (zero past its real rows), with K's group
  load_q<bf16>(p, t, q_s, stride, n_rows);
  load_split<bf16>(p, t, page, k_s, v_s, stride);
  cp_async_wait<1>();
  __syncthreads();

  const int r0 = warp * 16 + gq;  // this lane's rows r0 and r0 + 8
  uint32_t qf[TC_MAX_DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < TC_MAX_DH / 16; ++kk)
    if (kk * 16 < dh)
      tc::ldsm_x4(qf[kk], q_s + (warp * 16 + lane % 16) * stride + (kk * 16 + (lane / 16) * 8) * 2);

  // S = Q K^T: key tiles of 8, two a ldmatrix.x4
  float s[TC_MAX_KEYS / 8][4];
#pragma unroll
  for (int j = 0; j < TC_MAX_KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int jj = 0; jj < TC_MAX_KEYS / 16; ++jj) {
    if (jj * 16 >= sp) break;
    const int key = jj * 16 + lane % 8 + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < TC_MAX_DH / 16; ++kk) {
      if (kk * 16 >= dh) break;
      uint32_t b[4];
      tc::ldsm_x4(b, k_s + key * stride + (kk * 16 + ((lane / 8) % 2) * 8) * 2);
      tc::mma_16816(s[2 * jj], qf[kk], b[0], b[1]);
      tc::mma_16816(s[2 * jj + 1], qf[kk], b[2], b[3]);
    }
  }

  // softmax over the split in registers: a row's 4 lanes hold its keys
  const int hz[2] = {horizon(t, min(r0, t.rows - 1)), horizon(t, min(r0 + 8, t.rows - 1))};
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < TC_MAX_KEYS / 8; ++j) {
    if (j * 8 >= sp) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pos = t.base + j * 8 + 2 * c + (e & 1);
      s[j][e] = pos < hz[e >> 1] ? __fmul_rn(s[j][e], p.scale) : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
#pragma unroll
  for (int j = 0; j < TC_MAX_KEYS / 8; ++j) {
    if (j * 8 >= sp) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = s[j][e] == -INFINITY ? 0.f : expf(__fsub_rn(s[j][e], mx[e >> 1]));
      l[e >> 1] = __fadd_rn(l[e >> 1], pr);
      s[j][e] = pr;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], o));

  // O = P V: P from the score registers (rounded to bf16), V by ldmatrix.trans
  cp_async_wait<0>();
  __syncthreads();
  float o[TC_MAX_DH / 8][4];
#pragma unroll
  for (int n = 0; n < TC_MAX_DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < TC_MAX_KEYS / 16; ++kk) {
    if (kk * 16 >= sp) break;
    const uint32_t a[4] = {tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const int key = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int nn = 0; nn < TC_MAX_DH / 16; ++nn) {
      if (nn * 16 >= dh) break;
      uint32_t b[4];
      tc::ldsm_x4_t(b, v_s + key * stride + (nn * 16 + (lane / 16) * 8) * 2);
      tc::mma_16816(o[2 * nn], a, b[0], b[1]);
      tc::mma_16816(o[2 * nn + 1], a, b[2], b[3]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= t.rows) continue;
    const long slot = q_row(p, t, r) * p.n_splits + t.split;
    if (c == 0) p.ml[slot] = make_float2(mx[h], l[h]);
    float* dst = p.acc + slot * dh + 2 * c;
#pragma unroll
    for (int n = 0; n < TC_MAX_DH / 8; ++n) {
      if (n * 8 >= dh) break;
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------- combine
// One block a q row: M = max of the splits' m; the weights exp(m_s - M) of
// the non-empty splits (0 for the empty ones) in shared memory; L and O
// summed over the non-empty splits in split order; one division.
template <typename T>
__device__ void combine_row(const SplitParams& p) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // [n_splits]: m, then weights
  float* l_s = w_s + p.n_splits;                // [n_splits]
  const long row = blockIdx.x;
  const int ns = p.n_splits;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const float2 v = p.ml[row * ns + s];
    w_s[s] = v.x;
    l_s[s] = v.y;
  }
  __syncthreads();
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, w_s[s]);
  __syncthreads();
  for (int s = threadIdx.x; s < ns; s += blockDim.x)
    w_s[s] = w_s[s] == -INFINITY ? 0.f : expf(__fsub_rn(w_s[s], M));
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < ns; ++s)
    if (w_s[s] != 0.f) L = fmaf(w_s[s], l_s[s], L);
  const float* acc = p.acc + row * ns * p.dh;
  for (int d = threadIdx.x; d < p.dh; d += blockDim.x) {
    float O = 0.f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float w = w_s[s];
      if (w != 0.f) O = fmaf(w, acc[s * p.dh + d], O);
    }
    static_cast<T*>(p.out)[row * p.dh + d] = from_f32<T>(O / fmaxf(L, 1e-30f));
  }
}

// The combine's block: a thread a column, whole warps; its shared memory.
inline int combine_threads(const SplitParams& p) {
  return p.dh >= 128 ? 128 : (p.dh + 31) / 32 * 32;
}
inline int combine_smem(const SplitParams& p) { return 2 * p.n_splits * 4; }

// stages: 1 the split blocks, 2 the combine (3 both; the breakdown times
// each alone)
enum Stage { STAGE_SPLIT = 1, STAGE_COMBINE = 2 };

// Opt in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Shapes the split_kv body takes: Dh a power of two in [8, 128] (16-byte
// rows, at most 16 columns a lane), at most SK_ROWS rows a tile.
inline bool split_kv_ok(const SplitParams& p, int rows) {
  return p.dh >= 8 && p.dh <= 128 && (p.dh & (p.dh - 1)) == 0 && rows >= 1 &&
         rows <= SK_ROWS && p.split_pages >= 1 && p.split_pages <= MAX_SPLIT_PAGES &&
         p.ps >= 1 && p.n_splits >= 1 && p.P >= 1 && p.kh_n >= 1 && p.H % p.kh_n == 0 &&
         tc::vec_ok(p.vec);
}
// ... and the tc body: bf16, Dh a multiple of 16 up to 128, a split of a
// multiple of 16 positions up to 64, at most 16 * TC_MAX_WARPS rows a tile.
inline bool split_tc_ok(const SplitParams& p, int rows) {
  const int sp = p.split_pages * p.ps;
  return p.dh % 16 == 0 && p.dh >= 16 && p.dh <= TC_MAX_DH && sp % 16 == 0 &&
         sp <= TC_MAX_KEYS && p.split_pages >= 1 && p.split_pages <= MAX_SPLIT_PAGES &&
         rows >= 1 && rows <= 16 * TC_MAX_WARPS && p.n_splits >= 1 && p.P >= 1 && p.kh_n >= 1 &&
         p.H % p.kh_n == 0 && tc::vec_ok(p.vec);
}

// The split grid: (splits x query tiles, Kh, B).
inline dim3 split_grid(const SplitParams& p, int B) {
  const int n_qt = (p.n_tok + p.q_tile - 1) / p.q_tile;
  return dim3(p.n_splits * n_qt, p.kh_n, B);
}

// The bodies (kernels/paged_attention.py ROUTES).
enum Route { ROUTE_SPLIT_KV = 0, ROUTE_SPLIT_TC = 1 };

// Check the shape against the body, launch the split blocks of `route`
// over B rows of n_tok tokens, then the combine of every q row; returns
// cudaGetLastError() (0 on success). Each source passes its own kernels, so
// that a profile names them after their family.
template <typename T, typename SimtKernel, typename TcKernel, typename CombineKernel>
int launch_split(const SplitParams& p, int B, int dtype, int route, int stages,
                 SimtKernel simt, TcKernel tc, CombineKernel combine, cudaStream_t stream) {
  const int rows = p.q_tile * (p.H / p.kh_n);
  const bool ok = route == ROUTE_SPLIT_TC ? dtype == DT_BF16 && split_tc_ok(p, rows)
                                          : route == ROUTE_SPLIT_KV && split_kv_ok(p, rows);
  if (!ok || B <= 0 || B > 65535 || p.n_tok <= 0 || p.q_tile <= 0 || p.q_tile > p.n_tok ||
      p.n_splits * p.split_pages < p.P)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if ((stages & STAGE_SPLIT) && route == ROUTE_SPLIT_TC) {
    const size_t smem = tc_smem_bytes(p);
    if ((err = set_smem(tc, smem)) != cudaSuccess) return static_cast<int>(err);
    tc<<<split_grid(p, B), 32 * tc_warps(p), smem, stream>>>(p);
  } else if (stages & STAGE_SPLIT) {
    const size_t smem = split_kv_smem_bytes(p, sizeof(T));
    if ((err = set_smem(simt, smem)) != cudaSuccess) return static_cast<int>(err);
    simt<<<split_grid(p, B), SK_THREADS, smem, stream>>>(p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (stages & STAGE_COMBINE)
    combine<<<B * p.n_tok * p.H, combine_threads(p), combine_smem(p), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace repro_torch
