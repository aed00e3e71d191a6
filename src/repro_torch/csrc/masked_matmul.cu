// Masked matmul and its weight gradient for Hopper (sm_90a): the
// paper-faithful masked-dense training ops of MPDCompress (Algorithm 1).
//
// Replaces the Pallas TPU bodies in src/repro/kernels/masked_matmul.py:
//   _mm_kernel     y = act(x @ (M o W) + b), or with transpose_rhs
//                  y = x @ (M o W)^T (the input gradient dx = g @ (M o W)^T)
//   _sddmm_kernel  dW = (x^T @ g) o M (the weight gradient, sampled by M)
//
// What the TPU bodies keep out of device memory, these keep out too: the
// mask (uint8, one byte per weight, in W's layout) meets each W tile on
// chip, so M o W is never written back, and the sddmm applies M in its
// epilogue. Every product accumulates in f32 whatever the input type.
//
// The masked matmul has three routes; kernels/masked_matmul.py::plan picks
// one, its tiles and its K split from (m, K, N, dtype) and passes them here.
//
// * tc (bf16, m > 64: training, forward and dx). At olmo-1b's training
//   shapes (m = 2048, K and N in {2048, 8192, 50304}) the dense product is
//   far above the ~295 op/B ridge, so its floor is the tensor cores' rate:
//   68.7 GFLOP for up/gate, 0.069 ms at 989 TFLOP/s. What bounds this body
//   is moving tiles from L2 into shared memory (56 KB a K step for 2M
//   MACs) and the mask pass. A block owns a 256 x 128 output tile and has
//   four warpgroups. Warpgroups 2 and 3 produce: one thread loads each K
//   step of 64 with TMA (x K-major; W MN-major forward, K-major with
//   transpose_rhs; both 128-byte swizzled for wgmma; the mask beside W as
//   plain bytes) into a ring of 4 stages, and all 256 threads then
//   multiply their share of the landed W tile by the mask in place (w * m
//   in bf16, as the reference multiplies, so an off-mask NaN still gives
//   NaN), fence those generic-proxy writes for the async proxy and mark the
//   stage full.
//   Warpgroups 0 and 1 consume: each runs wgmma.mma_async m64n128k16 on its
//   128 token rows from shared memory into f32 registers and marks a stage
//   empty once its wgmmas have retired. So the loads, the mask pass and the
//   products of different K steps overlap, and the tensor cores wait on no
//   block-wide barrier. The output tile leaves through shared memory, 16
//   bytes a thread. Rows that TMA refuses (not 16-byte aligned: the mask
//   rows of N = 200) are copied by the producers with cp.async instead.
//   The mask's 1/nb density is not exploited: a permuted block mask leaves
//   no all-zero tile, so the dense product is the floor.
// * tc_small_m (bf16, m <= 64: a served model's decode, verify and prefill
//   rows). Bound by the W and mask stream (50.3 MB for up/gate, 0.015 ms).
//   A and B swap: the output channels take wgmma's 64-row side and the
//   tokens its N side (m64n64k16, rows past m zero), so no row is padded to
//   128. One warpgroup per block of 64 channels copies with cp.async into 4
//   stages of 20 KB (two blocks an SM); each thread masks the pieces it
//   copied, so one barrier a step publishes a stage. K is split over blocks
//   so that every olmo-1b projection fills the card; split partial sums go
//   to an f32 workspace and a second pass adds them in the fixed order s =
//   0, 1, ... (no float atomics). Tiles, split and instruction shape depend
//   on (K, N) alone, so a row's output is bit for bit the same at every m <=
//   64.
// * simt_f32 (f32, any m). f32 stays exact f32 (TF32 would not hold the
//   parity routes' tolerances): a shared-memory tiled f32 SIMT GEMM, a 128 x
//   128 output tile per block of 256 threads, 8 x 8 outputs a thread, K in
//   steps of 16. The f32 sddmm runs on the same SIMT body.
//
// The sddmm in bf16 (sddmm_tc_kernel) is the tc body's shape with the token
// axis as K: A = x^T and B = g both read MN-major straight from the rows of
// x and g, one TMA producer thread and no pass over a landed stage, the
// mask read once per output tile in the epilogue and applied as a select.
// At m = 2048 its loads from L2 are its floor (~6 TB/s).
//
// Ragged edges are zero-filled by the copies (TMA boxes out of range, or
// cp.async with a short source size): K need not be a multiple of 64 nor m
// of 8. A cp.async copy is the widest of 16, 8 or 4 bytes that the
// operand's rows allow; rows aligned to fewer than 4 bytes are staged by
// synchronous loads in the same body.
//
// Unlike the TPU grid, whose K (or token) axis is a sequential grid dimension
// carrying an f32 accumulator in VMEM, each block here loops over its
// reduction range itself and owns its sums in registers: Hopper blocks run
// in parallel and in no order.

#include "tc.cuh"

namespace repro_torch {
namespace {

// ====================================================== SIMT route (f32)
constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int LD = BM + 4;  // padded row of a shared tile: 2-way store conflicts at most
static_assert(BM == BN, "one loader serves both operands");

// Both kinds of tile are staged by one loader. A "k-contiguous" operand is
// read along its rows (x in (m, K), W in (N, K) for transpose_rhs) and a
// "k-strided" operand along its columns (W in (K, N), and both x and g of the
// sddmm, whose reduction axis is the token axis). Consecutive threads always
// read consecutive addresses in device memory; the transpose into the
// k-major shared tile happens on the store.
//
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
masked_mm_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
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

}  // namespace

// ============================================== tensor-core routes (bf16)
namespace tc {
namespace {

struct Args {
  const bf16* x;        // (m, k)
  const bf16* w;        // (k, n), or (n, k) with TRANS_W
  const uint8_t* mask;  // W's layout
  const float* bias;    // (n,) or null
  bf16* y;              // (m, n)
  float* ws;            // (split, m, n) partial sums when split > 1
  int m, k, n, act, k_chunk;
  int vec_x, vec_w, vec_m;  // copy width in bytes of each operand's rows
};

// TMA descriptors of x, W and the mask (tc with 16-byte aligned rows).
struct Maps {
  CUtensorMap x, w, mask;
};

// w * m for two bf16 weights and bytes sel_lo, sel_hi of the mask word m4:
// byte b placed under the exponent of 2^23 is the float 2^23 + b, so
// subtracting 2^23 gives b exactly for every byte; the product is rounded
// once, as the reference's bf16 multiply is.
__device__ __forceinline__ uint32_t mask2(uint32_t w2, uint32_t m4, uint32_t sel_lo,
                                          uint32_t sel_hi) {
  const float lo = __uint_as_float(__byte_perm(m4, 0x4B000000u, sel_lo)) - 8388608.0f;
  const float hi = __uint_as_float(__byte_perm(m4, 0x4B000000u, sel_hi)) - 8388608.0f;
  __nv_bfloat162 w;
  memcpy(&w, &w2, 4);
  const __nv_bfloat162 p = __hmul2(w, __floats2bfloat162_rn(lo, hi));
  uint32_t out;
  memcpy(&out, &p, 4);
  return out;
}

// One stage's pieces of W: pair c of row r is W chunks 2c and 2c + 1 (16
// weights) with the 16 mask bytes they meet, chunk c of the mask tile's row
// r. The thread that copies a piece also masks it, so a thread needs only
// its own copies to have landed. K-major W (TRANS_W): WC channel rows of 4
// pairs; MN-major: TK k rows of WC / 16 pairs. Chunk 2c + 1 of a pair sits
// at chunk 2c's offset ^ 16 in either swizzled layout.
template <int WC, bool TRANS_W>
struct Pieces {
  static constexpr int P = TRANS_W ? 4 : WC / 16;  // pairs per row
  static constexpr int R = TRANS_W ? WC : TK;      // rows
  static_assert(P == 4 || P == 8, "4 or 8 pairs a row");
  // Piece idx of the stage. Eight threads (one shared-memory phase of
  // 16-byte accesses) take 4 pairs of row r and 4 of row r + 1, whose
  // swizzled W chunks fall in complementary halves of the banks; with 8
  // pairs a row they take the row's other half-row on the next row, so
  // that their 64-byte mask reads do not share banks either.
  static __device__ __forceinline__ void at(int idx, int& r, int& c) {
    if (P == 4) {
      r = idx / 4;
      c = idx % 4;
    } else {
      const int j = idx % 16, half = j / 8, rr = (j % 8) / 4;
      r = 2 * (idx / 16) + rr;
      c = j % 4 + 4 * (rr ^ half);
    }
  }
  static __device__ __forceinline__ uint32_t w_off(int r, int c) {
    return TRANS_W ? KMajor{}(r, 2 * c) : MNMajor{}(r, 2 * c);
  }
  static __device__ __forceinline__ uint32_t m_off(int r, int c) { return r * (P * 16) + c * 16; }
};

// Issue this thread's copies of one stage: x rows [tok0, tok0 + XR) as K-major
// chunks, and its W pieces (channels from ch0) for the K step from k0.
template <int XR, int WC, bool TRANS_W, int NT>
__device__ __forceinline__ void issue_stage(const Rows& gx, const Rows& gw, const Rows& gm,
                                            uint32_t sx, uint32_t sw, uint32_t sm, int tok0,
                                            int ch0, int k0, int tid) {
  using PC = Pieces<WC, TRANS_W>;
  static_assert((XR * 8) % NT == 0 && (PC::R * PC::P) % NT == 0, "shares must be whole");
#pragma unroll
  for (int i = 0; i < XR * 8 / NT; ++i) {
    const int idx = tid + i * NT, r = idx / 8, c = idx % 8;
    const int gr = tok0 + r, gb = 2 * k0 + c * 16;
    const int valid = gr < gx.rows ? min(max(gx.row_bytes - gb, 0), 16) : 0;
    copy16(sx + KMajor{}(r, c), gx.base + gr * gx.ld + gb, gx.base, valid, gx.vec);
  }
#pragma unroll
  for (int i = 0; i < PC::R * PC::P / NT; ++i) {
    int r, c;
    PC::at(tid + i * NT, r, c);
    const int gr = TRANS_W ? ch0 + r : k0 + r;  // row of W and of the mask
    const int wb = TRANS_W ? 2 * k0 + 32 * c : 2 * ch0 + 32 * c;
    const int mb = TRANS_W ? k0 + 16 * c : ch0 + 16 * c;
    const bool in = gr < gw.rows;
    const int wv = in ? min(max(gw.row_bytes - wb, 0), 32) : 0;
    const int mv = in ? min(max(gm.row_bytes - mb, 0), 16) : 0;
    const uint32_t wd = sw + PC::w_off(r, c);
    const uint8_t* wp = gw.base + gr * gw.ld + wb;
    copy16(wd, wp, gw.base, min(wv, 16), gw.vec);
    copy16(wd ^ 16, wp + 16, gw.base, max(wv - 16, 0), gw.vec);
    copy16(sm + PC::m_off(r, c), gm.base + gr * gm.ld + mb, gm.base, mv, gm.vec);
  }
}

// w * m for mask bytes of 0 or 1, the bytes that Algorithm 1's masks hold:
// bytes sel of m4 spread to the two halves of a word, times 0x3F80, are
// the bf16 patterns of 0.0 and 1.0, and w * 1.0 and w * 0.0 are what the
// general form gives (an off-mask NaN or inf still gives NaN).
__device__ __forceinline__ uint32_t mask2_01(uint32_t w2, uint32_t m4, uint32_t sel) {
  const uint32_t m2 = __byte_perm(m4, 0u, sel) * 0x3F80u;
  __nv_bfloat162 w, m;
  memcpy(&w, &w2, 4);
  memcpy(&m, &m2, 4);
  const __nv_bfloat162 p = __hmul2(w, m);
  uint32_t out;
  memcpy(&out, &p, 4);
  return out;
}

// M o W in place over this thread's W pieces of one stage.
template <int WC, bool TRANS_W, int NT>
__device__ __forceinline__ void mask_stage(uint8_t* sw, const uint8_t* sm, int tid) {
  using PC = Pieces<WC, TRANS_W>;
#pragma unroll
  for (int i = 0; i < PC::R * PC::P / NT; ++i) {
    int r, c;
    PC::at(tid + i * NT, r, c);
    const uint32_t off = PC::w_off(r, c);
    uint4* w0 = reinterpret_cast<uint4*>(sw + off);
    uint4* w1 = reinterpret_cast<uint4*>(sw + (off ^ 16));
    const uint4 mk = *reinterpret_cast<const uint4*>(sm + PC::m_off(r, c));
    uint4 u = *w0, v = *w1;
    if (((mk.x | mk.y | mk.z | mk.w) & 0xFEFEFEFEu) == 0) {
      u.x = mask2_01(u.x, mk.x, 0x4140);
      u.y = mask2_01(u.y, mk.x, 0x4342);
      u.z = mask2_01(u.z, mk.y, 0x4140);
      u.w = mask2_01(u.w, mk.y, 0x4342);
      v.x = mask2_01(v.x, mk.z, 0x4140);
      v.y = mask2_01(v.y, mk.z, 0x4342);
      v.z = mask2_01(v.z, mk.w, 0x4140);
      v.w = mask2_01(v.w, mk.w, 0x4342);
    } else {
      u.x = mask2(u.x, mk.x, 0x7440, 0x7441);
      u.y = mask2(u.y, mk.x, 0x7442, 0x7443);
      u.z = mask2(u.z, mk.y, 0x7440, 0x7441);
      u.w = mask2(u.w, mk.y, 0x7442, 0x7443);
      v.x = mask2(v.x, mk.z, 0x7440, 0x7441);
      v.y = mask2(v.y, mk.z, 0x7442, 0x7443);
      v.z = mask2(v.z, mk.w, 0x7440, 0x7441);
      v.w = mask2(v.w, mk.w, 0x7442, 0x7443);
    }
    *w0 = u;
    *w1 = v;
  }
}

// tc_small_m epilogue: write accumulator `acc` (MMA rows = 64 channels from
// ch0, columns = tokens) to y, or to split `z` of the workspace.
// Accumulator 4g + 2h + e of a thread sits at MMA row 16 warp + lane / 4 +
// 8h, column 8g + 2 (lane % 4) + e. The bias goes through the read-only
// path: an ordinary load would wait for every store before it (y might
// alias it).
template <int BQ>
__device__ __forceinline__ void store_small(const Args& a, const float (&acc)[BQ / 2], int ch0,
                                            int z, bool split, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const long mn = static_cast<long>(a.m) * a.n;
  float b[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ch = ch0 + r0 + 8 * h;
    b[h] = a.bias && ch < a.n ? __ldg(a.bias + ch) : 0.f;
  }
#pragma unroll
  for (int g = 0; g < BQ / 8; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = 8 * g + c0 + e, ch = ch0 + r0 + 8 * h;
        if (tok >= a.m || ch >= a.n) continue;
        const long off = static_cast<long>(tok) * a.n + ch;
        const float v = acc[4 * g + 2 * h + e];
        if (split)
          a.ws[z * mn + off] = v;
        else
          a.y[off] = from_f32<bf16>(activate_tc(v + b[h], a.act));
      }
}

// Shared-memory bytes of one pipeline stage: the x tile (XR token rows),
// the W tile (WC channels) and its mask, each 1024-byte aligned.
template <int XR, int WC>
struct Stage {
  static constexpr int X = XR * TK * 2, W = WC * TK * 2, M = WC * TK, BYTES = X + W + M;
  static_assert(X % 1024 == 0 && W % 1024 == 0 && M % 1024 == 0, "swizzled tiles stay aligned");
};

// ------------------------------------------------------------ tc_small_m
// y^T tile = (M o W)^T x^T: one warpgroup, 64 channels on wgmma's M side
// (A = W, K-major with TRANS_W, else MN-major) times 64 token columns (B =
// x, K-major; rows past m are zero). blockIdx.z is the K split.
template <int STAGES, bool TRANS_W>
__global__ void __launch_bounds__(WG_THREADS) masked_mm_small_kernel(const Args a) {
  constexpr int BQ = 64, WC = 64, NT = WG_THREADS;
  using S = Stage<BQ, WC>;
  static_assert(STAGES >= 3, "loads run STAGES - 2 steps ahead");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, ch0 = blockIdx.x * WC;
  const int kb = blockIdx.z * a.k_chunk;
  const int steps = (min(a.k, kb + a.k_chunk) - kb + TK - 1) / TK;
  const auto* wb = reinterpret_cast<const uint8_t*>(a.w);
  const Rows gx{reinterpret_cast<const uint8_t*>(a.x), 2L * a.k, a.m, 2 * a.k, a.vec_x};
  const Rows gw = TRANS_W ? Rows{wb, 2L * a.k, a.n, 2 * a.k, a.vec_w}
                          : Rows{wb, 2L * a.n, a.k, 2 * a.n, a.vec_w};
  const Rows gm = TRANS_W ? Rows{a.mask, a.k, a.n, a.k, a.vec_m}
                          : Rows{a.mask, a.n, a.k, a.n, a.vec_m};
  auto issue = [&](int t) {
    const uint32_t sx = s0 + (t % STAGES) * S::BYTES;
    issue_stage<BQ, WC, TRANS_W, NT>(gx, gw, gm, sx, sx + S::X, sx + S::X + S::W, 0, ch0,
                                     kb + t * TK, tid);
  };
  float acc[BQ / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) acc[i] = 0.f;

  // Stage t % STAGES holds step t. A thread waits for its own copies, masks
  // its own pieces and fences them for the async proxy; the one barrier a
  // step then publishes the stage and retires step t - 2's wgmmas (waited
  // for at step t - 1), so its stage takes step t + STAGES - 2.
#pragma unroll
  for (int t = 0; t < STAGES - 2; ++t) {
    if (t < steps) issue(t);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int st = t % STAGES;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 3) : "memory");
    mask_stage<WC, TRANS_W, NT>(smem + st * S::BYTES + S::X, smem + st * S::BYTES + S::X + S::W,
                                tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + STAGES - 2 < steps) issue(t + STAGES - 2);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t sx = s0 + st * S::BYTES, sw = sx + S::X;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t da = TRANS_W ? desc(sw + kk * 32, 16, 1024)
                                  : desc(sw + kk * 16 * 128, 8192, 1024);
      wgmma<BQ, TRANS_W ? 0 : 1, 0>(acc, da, desc(sx + kk * 32, 16, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  store_small<BQ>(a, acc, ch0, blockIdx.z, gridDim.z > 1, tid);
}

// -------------------------------------------------------------------- tc
// y tile = x (M o W): 256 tokens x 128 channels per block, four
// warpgroups. Warpgroups 0 and 1 consume: each owns 128 token rows (two
// m64n128k16 row slices, 128 f32 accumulators a thread) and issues wgmma
// from shared memory (A = x, K-major; B = W, MN-major forward, K-major with
// TRANS_W). Warpgroups 2 and 3 produce: one thread loads each stage with
// TMA (or all copy with cp.async), all mask their share of each stage once
// it has landed and hand it over through a `full` mbarrier; the consumers
// return a stage through `empty` once their wgmmas on it have retired. So
// loads, the mask pass and the products of different K steps overlap, and
// no barrier stops the tensor cores between steps. Two producer
// warpgroups, not one, because the mask pass is the producer's critical
// work; registers move from them to the consumers.
constexpr int TC_CW = 2, TC_PW = 2;  // consumer and producer warpgroups
constexpr int TC_BQ = 128;           // output channels of a tile
constexpr int TC_LAG = 2;            // steps loaded ahead of the mask pass
// Registers a thread after the split: the block starts at 128 each (65,536
// / 512 threads; the consumers' 128 accumulators keep ptxas at that cap),
// and 2 x 128 x 88 + 2 x 128 x 168 is exactly that pool, so the consumers'
// increase is always granted.
constexpr int TC_PRODUCER_REGS = 88, TC_CONSUMER_REGS = 168;
constexpr int OUT_LD = TC_BQ * 2 + 16;  // bytes of a staged output row
// Blocks walk the tiles in groups of RASTER token tiles, token tile
// fastest: the blocks of a wave then share a few W strips (W and its mask
// are 2.5x x's bytes at olmo-1b's shapes) instead of each wave reading all
// of W.
constexpr int RASTER = 8;

// tc epilogue of one consumer warpgroup (128 token rows from tok0): bias and
// activation on the accumulators, the bf16 rows staged in shared memory at
// buf (rows padded to OUT_LD bytes, so the 8 rows of a store hit distinct
// banks), then written out 16 bytes a thread, 16 threads a row: every
// output sector is written whole. Stores straight from the accumulator
// layout would write each 32-byte sector in two scattered halves, which at
// a 32 MB output cost more than the product.
__device__ __forceinline__ void store_tc(const Args& a, const float (&acc)[2][TC_BQ / 2],
                                         uint8_t* buf, int tok0, int ch0, int wg, int tid) {
  const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32, c0 = 2 * (lane % 4);
#pragma unroll
  for (int g = 0; g < TC_BQ / 8; ++g) {
    const int ch = ch0 + 8 * g + c0;
    const float b0 = a.bias && ch < a.n ? __ldg(a.bias + ch) : 0.f;
    const float b1 = a.bias && ch + 1 < a.n ? __ldg(a.bias + ch + 1) : 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = j * 64 + warp * 16 + lane / 4 + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(buf + r * OUT_LD + (8 * g + c0) * 2) =
            __floats2bfloat162_rn(activate_tc(acc[j][4 * g + 2 * h] + b0, a.act),
                                  activate_tc(acc[j][4 * g + 2 * h + 1] + b1, a.act));
      }
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG_THREADS) : "memory");
  const bool vec = a.n % 8 == 0;
#pragma unroll 4
  for (int i = t; i < 128 * (TC_BQ / 8); i += WG_THREADS) {
    const int r = i / (TC_BQ / 8), c = i % (TC_BQ / 8);
    const int tok = tok0 + wg * 128 + r, ch = ch0 + 8 * c;
    if (tok >= a.m || ch >= a.n) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(buf + r * OUT_LD + c * 16);
    bf16* dst = a.y + static_cast<long>(tok) * a.n + ch;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int q = 0; q < 8 && ch + q < a.n; ++q) dst[q] = e[q];
    }
  }
}

template <int STAGES, bool TRANS_W>
__global__ void __launch_bounds__((TC_CW + TC_PW) * WG_THREADS, 1)
    masked_mm_tc_kernel(const Args a, const __grid_constant__ Maps maps) {
  constexpr int CW = TC_CW, BP = 128 * CW, BQ = TC_BQ, NT = TC_PW * WG_THREADS;
  using S = Stage<BP, BQ>;
  static_assert(STAGES >= TC_LAG + 2, "a stage per copy in flight, masked and consumed");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + STAGES * S::BYTES);  // TMA done
  uint64_t* full = landed + STAGES;   // masked: the consumers may read
  uint64_t* empty = full + STAGES;    // consumed: the producer may refill
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int mt = (a.m + BP - 1) / BP, nt = (a.n + BQ - 1) / BQ;
  const int per = RASTER * nt, first = blockIdx.x / per * RASTER;
  const int size = min(mt - first, RASTER), local = blockIdx.x % per;
  const int tok0 = (first + local % size) * BP, ch0 = local / size * BQ;
  const int steps = (a.k + TK - 1) / TK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(landed + s, 1);      // the issuing thread, plus the copies' bytes
      bar_init(full + s, NT);       // every producer thread
      bar_init(empty + s, 4 * CW);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= CW) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TC_PRODUCER_REGS));
    const int pt = tid - CW * WG_THREADS;
    const auto* wb = reinterpret_cast<const uint8_t*>(a.w);
    const Rows gx{reinterpret_cast<const uint8_t*>(a.x), 2L * a.k, a.m, 2 * a.k, a.vec_x};
    const Rows gw = TRANS_W ? Rows{wb, 2L * a.k, a.n, 2 * a.k, a.vec_w}
                            : Rows{wb, 2L * a.n, a.k, 2 * a.n, a.vec_w};
    const Rows gm = TRANS_W ? Rows{a.mask, a.k, a.n, a.k, a.vec_m}
                            : Rows{a.mask, a.n, a.k, a.n, a.vec_m};
    const bool tma = a.vec_x == 16 && a.vec_w == 16 && a.vec_m == 16;
    // Step t is copied at iteration t and masked at iteration t + TC_LAG,
    // before the copies of iteration t + TC_LAG are issued: the thread that
    // waits for a free stage then holds up no stage the consumers need.
#pragma unroll 1
    for (int t = 0; t < steps + TC_LAG; ++t) {
      if (t >= TC_LAG) {
        const int u = t - TC_LAG, st = u % STAGES;
        if (tma)
          bar_wait(landed + st, (u / STAGES) & 1);
        else
          asm volatile("cp.async.wait_group %0;\n" ::"n"(TC_LAG - 1) : "memory");
        mask_stage<BQ, TRANS_W, NT>(smem + st * S::BYTES + S::X,
                                    smem + st * S::BYTES + S::X + S::W, pt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(full + st);
      }
      if (t < steps) {
        const int st = t % STAGES, k0 = t * TK;
        const uint32_t sx = s0 + st * S::BYTES, sw = sx + S::X, sm = sw + S::W;
        if (tma) {
          if (pt == 0) {
            if (t >= STAGES) bar_wait(empty + st, ((t / STAGES) & 1) ^ 1);
            bar_expect(landed + st, S::BYTES);
            tma_load(sx, &maps.x, k0, tok0, landed + st);
            if (TRANS_W) {
              tma_load(sw, &maps.w, k0, ch0, landed + st);
            } else {
              tma_load(sw, &maps.w, ch0, k0, landed + st);
              tma_load(sw + 8192, &maps.w, ch0 + 64, k0, landed + st);
            }
            tma_load(sm, &maps.mask, TRANS_W ? k0 : ch0, TRANS_W ? ch0 : k0, landed + st);
          }
        } else {
          if (t >= STAGES) bar_wait(empty + st, ((t / STAGES) & 1) ^ 1);
          issue_stage<BP, BQ, TRANS_W, NT>(gx, gw, gm, sx, sw, sm, tok0, ch0, k0, pt);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TC_CONSUMER_REGS));
    const bool lane0 = tid % 32 == 0;
    float acc[2][BQ / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < BQ / 2; ++q) acc[j][q] = 0.f;
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      const int st = t % STAGES;
      bar_wait(full + st, (t / STAGES) & 1);
      const uint32_t sx = s0 + st * S::BYTES, sw = sx + S::X;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint64_t db = TRANS_W ? desc(sw + kk * 32, 16, 1024)
                                    : desc(sw + kk * 16 * 128, 8192, 1024);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wgmma<BQ, 0, TRANS_W ? 0 : 1>(
              acc[j], desc(sx + (wg * 2 + j) * 8192 + kk * 32, 16, 1024), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (t > 0 && lane0) bar_arrive(empty + (t - 1) % STAGES);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    // every wgmma of both consumers has retired: the stages are free
    asm volatile("bar.sync 1, %0;\n" ::"n"(CW * WG_THREADS) : "memory");
    store_tc(a, acc, smem + wg * 128 * OUT_LD, tok0, ch0, wg, tid);
  }
}

// ------------------------------------------------------------ sddmm tc
// dW tile = (x^T g) o M: 256 input channels (rows of dW) x 128 output
// channels per block, the m tokens reduced in K steps of 64. Warpgroups 0
// and 1 consume: each owns 128 rows (two m64n128k16 row slices, 128 f32
// accumulators a thread) and issues wgmma with A = x^T and B = g, both
// MN-major as x and g lie in memory (wgmma's transpose bits), so neither is
// transposed anywhere. Warpgroup 2 produces: one thread loads each stage
// with TMA (four 64 x 64 boxes of x, two of g; a ragged m is zero past the
// tensor's last row) or, for rows TMA refuses, all its threads copy with
// cp.async and arrive once their copies have landed. No pass touches a
// landed stage. The epilogue stages the bf16 tile in shared memory and
// writes it 16 bytes a thread, each value selected by its mask byte, read
// once here: off-mask entries are exact zeros whatever the sum.
struct SddmmArgs {
  const bf16* x;        // (m, d_in)
  const bf16* g;        // (m, d_out)
  const uint8_t* mask;  // (d_in, d_out)
  bf16* dw;             // (d_in, d_out)
  int m, d_in, d_out;
  int vec_x, vec_g, vec_m;  // copy width in bytes of each operand's rows
};

struct SddmmMaps {
  CUtensorMap x, g;
};

constexpr int SD_CW = 2, SD_BP = 128 * SD_CW, SD_BQ = 128;  // tile: dW rows x columns
constexpr int SD_STAGES = 4, SD_LAG = 2;  // cp.async steps in flight before a stage is marked
constexpr int SD_X = SD_BP * TK * 2, SD_G = SD_BQ * TK * 2, SD_BYTES = SD_X + SD_G;
static_assert(SD_BP * OUT_LD <= SD_STAGES * SD_BYTES, "the output stages in the ring");

// The epilogue: each consumer's 128 rows rounded to bf16 and staged in
// shared memory (padded rows, OUT_LD bytes: the 8 rows of a store hit
// distinct banks; thread element 4g + 2h + e of slice j at row 64 j + 16
// warp + lane / 4 + 8h, column 8g + 2 (lane % 4) + e), then written 16 bytes
// a thread, 16 threads a row, each value selected by its mask byte.
__device__ __forceinline__ void store_sddmm(const SddmmArgs& a, const float (&acc)[2][64],
                                            uint8_t* buf, int row0, int col0, int wg, int tid) {
  const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32, c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int g = 0; g < 16; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = j * 64 + warp * 16 + lane / 4 + 8 * h, c = 8 * g + c0;
        *reinterpret_cast<__nv_bfloat162*>(buf + r * OUT_LD + c * 2) =
            __floats2bfloat162_rn(acc[j][4 * g + 2 * h], acc[j][4 * g + 2 * h + 1]);
      }
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG_THREADS) : "memory");
  const bool vec = a.d_out % 8 == 0 && a.vec_m >= 8;
#pragma unroll 4
  for (int i = t; i < 128 * (SD_BQ / 8); i += WG_THREADS) {
    const int r = i / (SD_BQ / 8), c = i % (SD_BQ / 8);
    const int row = row0 + wg * 128 + r, col = col0 + 8 * c;
    if (row >= a.d_in || col >= a.d_out) continue;
    const long off = static_cast<long>(row) * a.d_out + col;
    uint4 v = *reinterpret_cast<const uint4*>(buf + r * OUT_LD + c * 16);
    if (vec) {
      const uint2 mk = __ldg(reinterpret_cast<const uint2*>(a.mask + off));
      uint32_t* e = &v.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t m2 = (q < 2 ? mk.x : mk.y) >> (16 * (q % 2));
        e[q] &= ((m2 & 0xFFu) ? 0xFFFFu : 0u) | ((m2 & 0xFF00u) ? 0xFFFF0000u : 0u);
      }
      *reinterpret_cast<uint4*>(a.dw + off) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int q = 0; q < 8 && col + q < a.d_out; ++q)
        a.dw[off + q] = a.mask[off + q] ? e[q] : from_f32<bf16>(0.f);
    }
  }
}

__global__ void __launch_bounds__((SD_CW + 1) * WG_THREADS, 1)
    sddmm_tc_kernel(const SddmmArgs a, const __grid_constant__ SddmmMaps maps) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SD_STAGES * SD_BYTES);  // landed
  uint64_t* empty = full + SD_STAGES;  // consumed: the producer may refill
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int mt = (a.d_in + SD_BP - 1) / SD_BP, nt = (a.d_out + SD_BQ - 1) / SD_BQ;
  const int per = RASTER * nt, first = blockIdx.x / per * RASTER;
  const int size = min(mt - first, RASTER), local = blockIdx.x % per;
  const int row0 = (first + local % size) * SD_BP, col0 = local / size * SD_BQ;
  const int steps = (a.m + TK - 1) / TK;
  const bool tma = a.vec_x == 16 && a.vec_g == 16;
  if (tid == 0) {
    for (int s = 0; s < SD_STAGES; ++s) {
      bar_init(full + s, tma ? 1 : WG_THREADS);  // the issuing thread, or every copier
      bar_init(empty + s, 4 * SD_CW);            // every consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == SD_CW) {
    const int pt = tid - SD_CW * WG_THREADS;
    if (tma) {
      if (pt != 0) return;
#pragma unroll 1
      for (int t = 0; t < steps; ++t) {
        const int st = t % SD_STAGES, t0 = t * TK;
        const uint32_t sx = s0 + st * SD_BYTES, sg = sx + SD_X;
        if (t >= SD_STAGES) bar_wait(empty + st, ((t / SD_STAGES) & 1) ^ 1);
        bar_expect(full + st, SD_BYTES);
#pragma unroll
        for (int p = 0; p < SD_BP / 64; ++p)
          tma_load(sx + p * 8192, &maps.x, row0 + 64 * p, t0, full + st);
#pragma unroll
        for (int p = 0; p < SD_BQ / 64; ++p)
          tma_load(sg + p * 8192, &maps.g, col0 + 64 * p, t0, full + st);
      }
      return;
    }
    const Rows gx{reinterpret_cast<const uint8_t*>(a.x), 2L * a.d_in, a.m, 2 * a.d_in, a.vec_x};
    const Rows gg{reinterpret_cast<const uint8_t*>(a.g), 2L * a.d_out, a.m, 2 * a.d_out,
                  a.vec_g};
    // Step t is copied at iteration t and marked landed at t + SD_LAG.
#pragma unroll 1
    for (int t = 0; t < steps + SD_LAG; ++t) {
      if (t >= SD_LAG) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(SD_LAG - 1) : "memory");
        fence_async_smem();
        bar_arrive(full + (t - SD_LAG) % SD_STAGES);
      }
      if (t < steps) {
        const int st = t % SD_STAGES, t0 = t * TK;
        const uint32_t sx = s0 + st * SD_BYTES, sg = sx + SD_X;
        if (t >= SD_STAGES) bar_wait(empty + st, ((t / SD_STAGES) & 1) ^ 1);
#pragma unroll 4
        for (int i = pt; i < TK * (SD_BP / 8); i += WG_THREADS) {
          const int r = i / (SD_BP / 8), c = i % (SD_BP / 8);
          copy_chunk(sx + MNMajor{}(r, c), gx, t0 + r, 2 * row0 + 16 * c);
        }
#pragma unroll 4
        for (int i = pt; i < TK * (SD_BQ / 8); i += WG_THREADS) {
          const int r = i / (SD_BQ / 8), c = i % (SD_BQ / 8);
          copy_chunk(sg + MNMajor{}(r, c), gg, t0 + r, 2 * col0 + 16 * c);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    return;
  }

  const bool lane0 = tid % 32 == 0;
  float acc[2][SD_BQ / 2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < SD_BQ / 2; ++q) acc[j][q] = 0.f;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int st = t % SD_STAGES;
    bar_wait(full + st, (t / SD_STAGES) & 1);
    const uint32_t sx = s0 + st * SD_BYTES, sg = sx + SD_X;
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t db = desc_mn(sg, kk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma<SD_BQ, 1, 1>(acc[j], desc_mn(sx + (wg * 2 + j) * 8192, kk), db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (t > 0 && lane0) bar_arrive(empty + (t - 1) % SD_STAGES);
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  // every wgmma of both consumers has retired: the ring is free
  asm volatile("bar.sync 1, %0;\n" ::"n"(SD_CW * WG_THREADS) : "memory");
  store_sddmm(a, acc, smem + wg * 128 * OUT_LD, row0, col0, wg, tid);
}

// y = act(sum_s ws[s] + bias), the split partial sums added in the fixed
// order s = 0, 1, ..., so the result does not depend on the blocks' order.
__global__ void masked_mm_reduce_kernel(const float* __restrict__ ws,
                                        const float* __restrict__ bias, bf16* __restrict__ y,
                                        int m, int n, int split, int act) {
  const long mn = static_cast<long>(m) * n;
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int s = 0; s < split; ++s) v += ws[s * mn + i];
  if (bias) v += bias[i % n];
  y[i] = from_f32<bf16>(activate_tc(v, act));
}

}  // namespace
}  // namespace tc

namespace {

void launch_sddmm_f32(const void* x, const void* g, const uint8_t* mask, void* dw, int m,
                      int d_in, int d_out, cudaStream_t s) {
  const dim3 grid((d_out + BN - 1) / BN, (d_in + BM - 1) / BM);
  sddmm_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(g), mask,
                                               static_cast<float*>(dw), m, d_in, d_out);
}

// routes (kernels/masked_matmul.py ROUTES) and the tiles each is built for
enum Route { ROUTE_SIMT_F32 = 0, ROUTE_TC = 1, ROUTE_TC_SMALL_M = 2 };
constexpr int TC_STAGES = 4, SMALL_STAGES = 4, SMALL_TILE = 64;

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// y (m, n) = act(x (m, k) @ (M o W) + bias): W and mask (k, n), or (n, k)
// with transpose_w (then y = x @ (M o W)^T). dtype: DT_F32 (route simt_f32)
// or DT_BF16 (routes tc and tc_small_m) for x, W and y; bias f32 (n,) or
// null. The launch plan (kernels/masked_matmul.py::plan): the route, its
// output tile (tile_p rows of the MMA's M side, tile_q of its N side; they
// must be the ones the route is built for), the K split and the K range of
// each split (k_chunk, a multiple of 64; split > 1 only on tc_small_m, with
// ws an f32 (split, m, n) workspace), and the copy width in bytes of the
// rows of x, W and the mask. Returns cudaGetLastError() after the launches.
extern "C" int masked_matmul_launch(const void* x, const void* w, const uint8_t* mask,
                                    const float* bias, void* y, float* ws, int m, int k, int n,
                                    int dtype, int transpose_w, int act, int route, int tile_p,
                                    int tile_q, int split, int k_chunk, int vec_x, int vec_w,
                                    int vec_m, void* stream) {
  cudaGetLastError();  // clear a stale error so the one returned is this launch's
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || k <= 0 || n <= 0 || act < ACT_NONE || act > ACT_RELU) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_SIMT_F32) {
    if (dtype != DT_F32 || split != 1 || tile_p != BM || tile_q != BN) return bad;
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    const auto* xt = static_cast<const float*>(x);
    const auto* wt = static_cast<const float*>(w);
    auto* yt = static_cast<float*>(y);
    if (transpose_w)
      masked_mm_simt_kernel<float, true><<<grid, THREADS, 0, s>>>(xt, wt, mask, bias, yt, m, k, n, act);
    else
      masked_mm_simt_kernel<float, false><<<grid, THREADS, 0, s>>>(xt, wt, mask, bias, yt, m, k, n, act);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != DT_BF16 || !tc::vec_ok(vec_x) || !tc::vec_ok(vec_w) || !tc::vec_ok(vec_m)) return bad;
  if (split < 1 || k_chunk <= 0 || k_chunk % tc::TK || static_cast<long>(split) * k_chunk < k ||
      static_cast<long>(split - 1) * k_chunk >= k || (split > 1 && ws == nullptr))
    return bad;
  const tc::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                   mask, bias, static_cast<__nv_bfloat16*>(y), ws, m, k, n, act, k_chunk,
                   vec_x, vec_w, vec_m};
  cudaError_t e;
  if (route == ROUTE_TC) {
    constexpr int BP = 128 * tc::TC_CW, BQ = tc::TC_BQ;
    if (tile_p != BP || tile_q != BQ || split != 1) return bad;
    const dim3 grid(((n + BQ - 1) / BQ) * ((m + BP - 1) / BP));
    const int bytes = TC_STAGES * tc::Stage<BP, BQ>::BYTES + 1024 +
                      3 * TC_STAGES * 8;  // + alignment slack and the mbarriers
    const int threads = (tc::TC_CW + tc::TC_PW) * 128;
    tc::Maps maps{};
    if (vec_x == 16 && vec_w == 16 && vec_m == 16) {  // else the producer copies by cp.async
      const long wr = transpose_w ? n : k, wc = transpose_w ? k : n;
      if (!tc::tensor_map(&maps.x, x, 2, m, k, BP, tc::TK, true) ||
          !tc::tensor_map(&maps.w, w, 2, wr, wc, transpose_w ? BQ : tc::TK, tc::TK, true) ||
          !tc::tensor_map(&maps.mask, mask, 1, wr, wc, transpose_w ? BQ : tc::TK,
                          transpose_w ? tc::TK : BQ, false))
        return static_cast<int>(cudaErrorNotSupported);
    }
    e = transpose_w ? tc::launch(tc::masked_mm_tc_kernel<TC_STAGES, true>, threads, bytes, grid,
                                 s, a, maps)
                    : tc::launch(tc::masked_mm_tc_kernel<TC_STAGES, false>, threads, bytes, grid,
                                 s, a, maps);
  } else if (route == ROUTE_TC_SMALL_M) {
    if (tile_p != SMALL_TILE || tile_q != SMALL_TILE || m > SMALL_TILE) return bad;
    const dim3 grid((n + SMALL_TILE - 1) / SMALL_TILE, 1, split);
    const int bytes = SMALL_STAGES * tc::Stage<SMALL_TILE, SMALL_TILE>::BYTES + 1024;
    e = transpose_w
            ? tc::launch(tc::masked_mm_small_kernel<SMALL_STAGES, true>, 128, bytes, grid, s, a)
            : tc::launch(tc::masked_mm_small_kernel<SMALL_STAGES, false>, 128, bytes, grid, s, a);
    if (e == cudaSuccess && split > 1) {
      const long mn = static_cast<long>(m) * n;
      tc::masked_mm_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
          ws, bias, static_cast<__nv_bfloat16*>(y), m, n, split, act);
      e = cudaGetLastError();
    }
  } else {
    return bad;
  }
  return static_cast<int>(e);
}

// dw (d_in, d_out) = (x^T @ g) o M for x (m, d_in), g (m, d_out), mask
// (d_in, d_out); x, g and dw share one dtype. route (kernels/masked_matmul.py
// SDDMM_ROUTES): ROUTE_SIMT_F32 for DT_F32, ROUTE_TC for DT_BF16, with the
// copy width in bytes of the rows of x, g and the mask (x and g by TMA when
// both are 16). Returns cudaGetLastError() after the launch.
extern "C" int sddmm_masked_launch(const void* x, const void* g, const uint8_t* mask,
                                   void* dw, int m, int d_in, int d_out, int dtype, int route,
                                   int vec_x, int vec_g, int vec_m, void* stream) {
  cudaGetLastError();
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || d_in <= 0 || d_out <= 0) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_SIMT_F32) {
    if (dtype != DT_F32) return bad;
    launch_sddmm_f32(x, g, mask, dw, m, d_in, d_out, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != ROUTE_TC || dtype != DT_BF16 || !tc::vec_ok(vec_x) || !tc::vec_ok(vec_g) ||
      !tc::vec_ok(vec_m))
    return bad;
  const tc::SddmmArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
                        mask, static_cast<__nv_bfloat16*>(dw), m, d_in, d_out, vec_x, vec_g, vec_m};
  tc::SddmmMaps maps{};
  if (vec_x == 16 && vec_g == 16) {  // else the producers copy by cp.async
    if (!tc::tensor_map(&maps.x, x, 2, m, d_in, tc::TK, tc::TK, true) ||
        !tc::tensor_map(&maps.g, g, 2, m, d_out, tc::TK, tc::TK, true))
      return static_cast<int>(cudaErrorNotSupported);
  }
  const dim3 grid(((d_in + tc::SD_BP - 1) / tc::SD_BP) * ((d_out + tc::SD_BQ - 1) / tc::SD_BQ));
  const int bytes = tc::SD_STAGES * tc::SD_BYTES + 1024 + 2 * tc::SD_STAGES * 8;
  return static_cast<int>(
      tc::launch(tc::sddmm_tc_kernel, (tc::SD_CW + 1) * 128, bytes, grid, s, a, maps));
}

extern "C" const char* masked_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
