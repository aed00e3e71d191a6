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
//   steps of 16. The sddmm runs on the same SIMT body.
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

#include <cuda.h>

#include "common.cuh"

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

// ============================================== tensor-core routes (bf16)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int TK = 64;           // K step: one 128-byte swizzle row of bf16
constexpr int WG_THREADS = 128;  // one warpgroup

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

// A row-major matrix in device memory seen as `rows` rows of `row_bytes`
// bytes, `ld` bytes apart, each row start aligned to `vec` bytes.
struct Rows {
  const uint8_t* base;
  long ld;
  int rows, row_bytes, vec;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled K-major
// tile: rows of 64 bf16 (128 bytes), chunk c stored at c ^ (r % 8). This is
// the layout TMA's SWIZZLE_128B writes and wgmma's 128B mode reads.
struct KMajor {
  __device__ __forceinline__ uint32_t operator()(int r, int c) const {
    return r * 128 + ((c ^ (r & 7)) << 4);
  }
};
// The same swizzle MN-major: k row r holds 64 MN values per 8 KB panel,
// chunk c (8 MN values) in panel c / 8.
struct MNMajor {
  __device__ __forceinline__ uint32_t operator()(int r, int c) const {
    return (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
};

// Copy 16 bytes into shared memory at `dst`, `valid` of them from `src`
// and the rest zero. With vec >= 4 the copy is asynchronous (cp.async of
// vec-byte pieces); narrower-aligned rows are loaded and stored here.
__device__ __forceinline__ void copy16(uint32_t dst, const uint8_t* src, const uint8_t* base,
                                       int valid, int vec) {
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(valid > 0 ? src : base), "r"(valid) : "memory");
  } else if (vec == 8) {
#pragma unroll
    for (int o = 0; o < 16; o += 8) {
      const int v = min(max(valid - o, 0), 8);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst + o),
                   "l"(v > 0 ? src + o : base), "r"(v) : "memory");
    }
  } else if (vec == 4) {
#pragma unroll
    for (int o = 0; o < 16; o += 4) {
      const int v = min(max(valid - o, 0), 4);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + o),
                   "l"(v > 0 ? src + o : base), "r"(v) : "memory");
    }
  } else {
    uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < valid) q[b >> 2] |= static_cast<uint32_t>(src[b]) << (8 * (b & 3));
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(q[0]), "r"(q[1]),
                 "r"(q[2]), "r"(q[3]) : "memory");
  }
}

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

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major tiles
// use only the stride between 8-row groups (sbo, 1024 bytes); MN-major
// tiles also the stride between 64-wide MN panels (lbo).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D (64 x N, f32, in registers) += A (64 x 16) B (16 x N), both from shared
// memory; TA / TB: 0 = K-major, 1 = MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BQ, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BQ / 2], uint64_t da, uint64_t db) {
  if constexpr (BQ == 128)
    wgmma_n128<TA, TB>(d, da, db);
  else
    wgmma_n64<TA, TB>(d, da, db);
}

// Keep the compiler from moving accumulator accesses across an asynchronous
// wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The activation of the tensor-core epilogues: silu through the fast
// exponential and division, a few f32 ulps from the reference and far below
// the bf16 rounding that follows (the IEEE forms call a slow path that cost
// the m = 2048 epilogue more than its whole product); the others as the
// reference computes them.
__device__ __forceinline__ float activate_tc(float v, int act) {
  return act == ACT_SILU ? __fdividef(v, 1.0f + __expf(-v)) : activate(v, act);
}

__device__ __forceinline__ uint32_t bar_u32(const uint64_t* b) { return smem_u32(b); }
__device__ __forceinline__ void bar_init(const uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(const uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar_u32(b)) : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(const uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_u32(b)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bar_expect(const uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_u32(b)),
               "r"(bytes) : "memory");
}
// 2-D TMA load of the box at (c0 innermost, c1) into shared memory at dst,
// completing on barrier b; the box's bytes outside the tensor are zero.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         const uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(bar_u32(b)), "r"(c0), "r"(c1) : "memory");
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

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

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

template <class Kernel, class... P>
cudaError_t launch(Kernel kern, int threads, int bytes, dim3 grid, cudaStream_t s,
                   const P&... params) {
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, bytes, s>>>(params...);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) matrix of 1- or 2-byte elements as boxes of
// (box_rows, box_cols), 128-byte swizzled (the wgmma tiles) or plain (the
// mask tiles). Rows and base must be 16-byte aligned.
bool tensor_map(CUtensorMap* map, const void* base, int elem_bytes, long rows, long cols,
                int box_rows, int box_cols, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

template <typename T>
void launch_sddmm(const void* x, const void* g, const uint8_t* mask, void* dw,
                  int m, int d_in, int d_out, cudaStream_t s) {
  const dim3 grid((d_out + BN - 1) / BN, (d_in + BM - 1) / BM);
  sddmm_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                                           mask, static_cast<T*>(dw), m, d_in, d_out);
}

// routes (kernels/masked_matmul.py ROUTES) and the tiles each is built for
enum Route { ROUTE_SIMT_F32 = 0, ROUTE_TC = 1, ROUTE_TC_SMALL_M = 2 };
constexpr int TC_STAGES = 4, SMALL_STAGES = 4, SMALL_TILE = 64;

bool vec_ok(int v) { return v == 1 || v == 2 || v == 4 || v == 8 || v == 16; }


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
  if (dtype != DT_BF16 || !vec_ok(vec_x) || !vec_ok(vec_w) || !vec_ok(vec_m)) return bad;
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
