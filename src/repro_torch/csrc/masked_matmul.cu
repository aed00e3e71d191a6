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
// The masked matmul has four routes; kernels/masked_matmul.py::plan picks
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
// * simt_small_m and simt_f32 (f32, m <= 64 and above; the f32 SDDMM on
//   the tiled SIMT body with a tile plan of its own). f32 stays exact f32
//   (TF32 would not hold the parity routes' tolerances): FFMA on the CUDA
//   cores. At LeNet-300-100's widths (the paper's path: K and N of 800,
//   300, 100, 10) a 128 x 128 tile leaves 1 to 3 blocks on 132 SMs, so
//   both bodies split K over a thread block cluster and add the partials
//   over DSMEM in rank order; see the simt namespace below.
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

#include "simt.cuh"

namespace repro_torch {

// ===================================================== SIMT routes (f32)
// f32 stays exact f32: FFMA on the CUDA cores, no TF32, no tensor cores,
// on the shared machinery of simt.cuh.
namespace simt {
namespace {

struct Args {
  const float* x;       // (m, k); the SDDMM: x (m, d_in)
  const float* w;       // (k, n), or (n, k) with TRANS_W; the SDDMM: g (m, d_out)
  const uint8_t* mask;  // W's layout; the SDDMM: (d_in, d_out)
  const float* bias;    // (n,) or null
  float* y;             // (m, n); the SDDMM: dW (d_in, d_out)
  int m, k, n, act;     // the SDDMM: m tokens, k = d_in, n = d_out
  int split, k_chunk;   // blocks along K (blockIdx.z) and the K range of each
  int vec_x, vec_w, vec_m;  // copy width in bytes of each operand's rows
};

// 4 mask bytes into shared memory at dst, `valid` of them from src and the
// rest zero: one asynchronous copy where the rows are 4-byte aligned, else
// loaded and stored here.
__device__ __forceinline__ void copy4(uint32_t dst, const uint8_t* src, const uint8_t* base,
                                      int valid, int vec) {
  if (vec >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(valid > 0 ? src : base), "r"(valid) : "memory");
  } else {
    uint32_t q = 0;
    for (int b = 0; b < valid; ++b) q |= static_cast<uint32_t>(src[b]) << (8 * b);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(q) : "memory");
  }
}

// y[r, c..c+3] = act(v + bias) for the 4 channels below n; one 16-byte
// store where the row allows it.
__device__ __forceinline__ void store4(const Args& a, int r, int c, float4 v) {
  float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = activate(o[q] + (a.bias && c + q < a.n ? __ldg(a.bias + c + q) : 0.f), a.act);
  float* dst = a.y + static_cast<long>(r) * a.n + c;
  if (a.n % 4 == 0 && c + 4 <= a.n) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c + q < a.n) dst[q] = o[q];
  }
}

// -------------------------------------------------------- simt_small_m
// m <= 64 rows (batch-1 inference, a training batch of 50, a served
// model's decode rows). Bound by the W and mask stream (1.2 MB at LeNet's
// 800 x 300), so the design is about spreading that stream over the card
// and keeping it in flight. A block owns SM_NC output channels (lane l:
// channel l) for all m rows, warp w rows 16 w .. 16 w + 15, held in
// registers; warps whose rows all lie past m skip the products. K is
// split over the z blocks of one cluster. W, its mask and x stream through
// a ring of SM_STAGES cp.async stages of SM_TK k; the thread that copied a
// W piece (4 weights) multiplies it by its 4 mask bytes, so one barrier a
// stage publishes it. Tiles and split follow from (K, N) alone
// (kernels/masked_matmul.py::plan) and no arithmetic depends on m, so a
// row's output is bit for bit the same at every m <= 64.
constexpr int SM_THREADS = 128, SM_ROWS = 64, SM_STAGES = 4;

struct SmallStage {
  static constexpr int X = SM_ROWS * SM_TK * 4;  // x rows of SM_TK floats
  static constexpr int W = SM_NC * SM_XLD * 4;   // the W tile, either layout
  static constexpr int M = SM_TK * SM_NC;        // one mask word per W piece
  static constexpr int BYTES = X + W + M;
  static_assert(BYTES % 16 == 0 && SM_ROWS * SM_NC * 4 <= SM_STAGES * BYTES,
                "aligned stages; the partials fit the ring");
};

template <bool TRANS_W>
__global__ void __launch_bounds__(SM_THREADS) masked_mm_simt_small_kernel(const Args a) {
  using S = SmallStage;
  constexpr int NC = SM_NC;
  constexpr int PER = SM_TK * NC / 4 / SM_THREADS;  // W pieces a thread copies and masks
  static_assert(PER * SM_THREADS * 4 == SM_TK * NC && NC == 32, "whole shares, a lane a channel");
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t s0 = tc::smem_u32(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch0 = blockIdx.x * NC;
  const int kb = blockIdx.z * a.k_chunk, ke = min(a.k, kb + a.k_chunk);
  const int steps = (ke - kb + SM_TK - 1) / SM_TK;
  const auto* xb = reinterpret_cast<const uint8_t*>(a.x);
  const auto* wb = reinterpret_cast<const uint8_t*>(a.w);

  auto issue = [&](int t) {
    const uint32_t st = s0 + (t % SM_STAGES) * S::BYTES;
    const int k0 = kb + t * SM_TK;
    for (int i = tid; i < a.m * (SM_TK / 4); i += SM_THREADS) {
      const int r = i / (SM_TK / 4), q = i % (SM_TK / 4), kk = k0 + 4 * q;
      tc::copy16(st + 16 * i, xb + (static_cast<long>(r) * a.k + kk) * 4, xb,
                 4 * min(max(ke - kk, 0), 4), a.vec_x);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = tid + i * SM_THREADS;
      int valid;
      long off;
      if (TRANS_W) {  // channel row cr, k from kk
        const int cr = p / (SM_TK / 4), kk = k0 + 4 * (p % (SM_TK / 4)), ch = ch0 + cr;
        valid = ch < a.n ? min(max(ke - kk, 0), 4) : 0;
        off = static_cast<long>(ch) * a.k + kk;
      } else {        // k row kk, channels from ch
        const int kk = k0 + p / (NC / 4), ch = ch0 + 4 * (p % (NC / 4));
        valid = kk < ke ? min(max(a.n - ch, 0), 4) : 0;
        off = static_cast<long>(kk) * a.n + ch;
      }
      tc::copy16(st + S::X + small_w_off<TRANS_W>(p), wb + off * 4, wb, 4 * valid, a.vec_w);
      copy4(st + S::X + S::W + 4 * p, a.mask + off, a.mask, valid, a.vec_m);
    }
  };

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const bool rows_here = warp * 16 < a.m;

  // Stage t % SM_STAGES holds step t; SM_STAGES - 1 steps are in flight. A
  // thread waits for its own copies and masks its own pieces; the barrier
  // then publishes step t and frees the stage of step t - 1 for step t +
  // SM_STAGES - 1.
#pragma unroll
  for (int t = 0; t < SM_STAGES - 1; ++t) {
    if (t < steps) issue(t);
    tc::cp_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    uint8_t* st = smem + (t % SM_STAGES) * S::BYTES;
    tc::cp_wait<SM_STAGES - 2>();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = tid + i * SM_THREADS;
      float4* wp = reinterpret_cast<float4*>(st + S::X + small_w_off<TRANS_W>(p));
      *wp = apply_mask(*wp, *reinterpret_cast<const uint32_t*>(st + S::X + S::W + 4 * p));
    }
    __syncthreads();
    if (t + SM_STAGES - 1 < steps) issue(t + SM_STAGES - 1);
    tc::cp_commit();
    if (!rows_here) continue;
    const float* xs = reinterpret_cast<const float*>(st) + warp * 16 * SM_TK;
    const float* ws = reinterpret_cast<const float*>(st + S::X);
#pragma unroll
    for (int q = 0; q < SM_TK / 4; ++q) {
      float wv[4];
      if (TRANS_W) {
        const float4 v = *reinterpret_cast<const float4*>(ws + lane * SM_XLD + 4 * q);
        wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[e] = ws[(4 * q + e) * NC + lane];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + i * SM_TK + 4 * q);
        acc[i] = fmaf(xv.x, wv[0], acc[i]);
        acc[i] = fmaf(xv.y, wv[1], acc[i]);
        acc[i] = fmaf(xv.z, wv[2], acc[i]);
        acc[i] = fmaf(xv.w, wv[3], acc[i]);
      }
    }
  }

  if (a.split == 1) {
    const int c = ch0 + lane;
    if (!rows_here || c >= a.n) return;
    const float b = a.bias ? __ldg(a.bias + c) : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      if (r < a.m) a.y[static_cast<long>(r) * a.n + c] = activate(acc[i] + b, a.act);
    }
    return;
  }
  // The split's partials (rows < m, NC channels) in shared memory; each
  // block then adds a share of the tile from all of them, in rank order.
  __syncthreads();  // every warp is done with the ring
  float* part = reinterpret_cast<float*>(smem);
  if (rows_here)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (warp * 16 + i < a.m) part[(warp * 16 + i) * NC + lane] = acc[i];
  tc::cluster_sync();
  tc::cluster_add<CLUSTER_MAX>(s0, a.split, a.m * NC / 4, [&](int g, float4 v) {
    store4(a, g / (NC / 4), ch0 + 4 * (g % (NC / 4)), v);
  });
  tc::cluster_sync();  // the other blocks have read this block's partial
}

// simt_f32 (m > 64): y tile = act(x (M o W) + bias), 128 x 128 tokens x
// channels, 8 x 8 a thread. At olmo-1b's widths the grid fills the card and
// the body is bound by its FFMA issue rate (68.7 GFLOP for up/gate, 1.03 ms
// at 67 TFLOP/s); where the grid is short of the SMs (LeNet at m = 2048: 48
// tiles at N = 300) K is split over the z blocks of a cluster and the
// partials added as in simt_small_m. One block an SM: at two, the 128
// registers a thread spilled and up/gate ran 16 % slower (2.13 ms against
// 1.84, H100 80GB HBM3, 700 W).
template <bool TRANS_W>
using MmTile = Tile<128, 128, 8, 8, TRANS_W ? 32 : 16>;

template <bool TRANS_W>
__global__ void __launch_bounds__(MmTile<TRANS_W>::THREADS, 1)
    masked_mm_simt_kernel(const Args a) {
  using T = MmTile<TRANS_W>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + 2 * T::BK * T::LA;
  const int col0 = blockIdx.x * 128, row0 = blockIdx.y * 128;
  const int kb = blockIdx.z * a.k_chunk, ke = min(a.k, kb + a.k_chunk);
  const int tid = threadIdx.x, tr = tid / 16, tcol = tid % 16;
  const bool vx = a.vec_x == 16, vw = a.vec_w == 16, vm = a.vec_m >= 4;
  Loader<128, T::BK, T::THREADS, true, false> la;
  Loader<128, T::BK, T::THREADS, TRANS_W, true> lb;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  tile_loop<T>(
      sa, sb, la, lb,
      [&](auto& l, int k0) { l.load(a.x, nullptr, a.k, row0, a.m, k0, ke, vx, false, tid); },
      [&](auto& l, int k0) {
        l.load(a.w, a.mask, TRANS_W ? a.k : a.n, col0, a.n, k0, ke, vw, vm, tid);
      },
      kb, ke, acc, tr, tcol, tid);

  if (a.split == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + T::row(tr, i);
      if (r >= a.m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + T::col(tcol, 4 * h);
        if (c < a.n)
          store4(a, r, c, make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                      acc[i][4 * h + 3]));
      }
    }
    return;
  }
  // the loop's last barrier freed the buffers: the 128 x 128 partial
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + T::row(tr, i) * 128 + T::col(tcol, 4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  tc::cluster_sync();
  const int rows = min(128, a.m - row0);
  tc::cluster_add<CLUSTER_MAX>(tc::smem_u32(part), a.split, rows * 32, [&](int g, float4 v) {
    const int c = col0 + 4 * (g % 32);
    if (c < a.n) store4(a, row0 + g / 32, c, v);
  });
  tc::cluster_sync();  // the other blocks have read this block's partial
}

// The SDDMM, f32: dW tile = (x^T g) o M, BM rows of dW (input channels) x
// BN columns (output channels), the m tokens reduced in steps of BK; x and
// g are both read along their rows (k-strided operands), so nothing is
// transposed. kernels/masked_matmul.py::sddmm_plan picks the tile from
// (d_in, d_out) so that the grid covers the SMs where the output allows:
// 128 x 128 at olmo-1b's widths, 64 x 32 at LeNet's. Off-mask
// entries are written as exact zeros by a select, so a non-finite sum
// cannot leak into them (the reference's multiply would give NaN there); 4
// consecutive dW floats leave as one 16-byte store with their 4 mask bytes
// read as one word where d_out % 4 == 0.
template <int BM, int BN, int TM, int TN, int BK>
__global__ void __launch_bounds__(Tile<BM, BN, TM, TN, BK>::THREADS)
    sddmm_simt_kernel(const Args a) {
  using T = Tile<BM, BN, TM, TN, BK>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + 2 * BK * T::LA;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tr = tid / (BN / TN), tcol = tid % (BN / TN);
  const bool vx = a.vec_x == 16, vg = a.vec_w == 16;
  Loader<BM, BK, T::THREADS, false, false> la;
  Loader<BN, BK, T::THREADS, false, false> lb;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  tile_loop<T>(
      sa, sb, la, lb,
      [&](auto& l, int t0) { l.load(a.x, nullptr, a.k, row0, a.k, t0, a.m, vx, false, tid); },
      [&](auto& l, int t0) { l.load(a.w, nullptr, a.n, col0, a.n, t0, a.m, vg, false, tid); },
      0, a.m, acc, tr, tcol, tid);

  const bool vec = a.n % 4 == 0 && a.vec_m >= 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + T::row(tr, i);
    if (r >= a.k) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = col0 + T::col(tcol, 4 * h);
      const long off = static_cast<long>(r) * a.n + c;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (vec && c + 4 <= a.n) {
        const uint32_t mk = __ldg(reinterpret_cast<const unsigned int*>(a.mask + off));
        *reinterpret_cast<float4*>(a.y + off) =
            make_float4(mk & 0xFFu ? v[0] : 0.f, mk & 0xFF00u ? v[1] : 0.f,
                        mk & 0xFF0000u ? v[2] : 0.f, mk & 0xFF000000u ? v[3] : 0.f);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < a.n) a.y[off + q] = a.mask[off + q] ? v[q] : 0.f;
      }
    }
  }
}

// ------------------------------------------------------------- launches
// The masked matmul's f32 bodies: the tile (rows, channels) must be one
// they are built for; split blocks along K (one cluster, <= CLUSTER_MAX)
// of k_chunk each (a multiple of 4 floats).
cudaError_t launch_mm(const Args& a, bool small, bool trans, int tile_p, int tile_q,
                      cudaStream_t s) {
  if (small) {
    if (a.m > SM_ROWS || tile_p != SM_ROWS || tile_q != SM_NC) return cudaErrorInvalidValue;
    const dim3 grid((a.n + SM_NC - 1) / SM_NC, 1, a.split);
    const int bytes = SM_STAGES * SmallStage::BYTES;
    return trans ? launch_split(masked_mm_simt_small_kernel<true>, SM_THREADS, bytes, grid,
                                a.split, s, a)
                 : launch_split(masked_mm_simt_small_kernel<false>, SM_THREADS, bytes, grid,
                                a.split, s, a);
  }
  if (tile_p != 128 || tile_q != 128) return cudaErrorInvalidValue;
  const dim3 grid((a.n + 127) / 128, (a.m + 127) / 128, a.split);
  // the ring, or the 128 x 128 partial of a split if that is larger
  const int part = a.split > 1 ? 128 * 128 * 4 : 0;
  return trans ? launch_split(masked_mm_simt_kernel<true>, MmTile<true>::THREADS,
                              max(part, MmTile<true>::RING), grid, a.split, s, a)
               : launch_split(masked_mm_simt_kernel<false>, MmTile<false>::THREADS,
                              max(part, MmTile<false>::RING), grid, a.split, s, a);
}

// The f32 SDDMM at one of the tiles (rows of dW x columns) it is built for.
cudaError_t launch_sddmm(const Args& a, int tile_p, int tile_q, cudaStream_t s) {
  const dim3 grid((a.n + tile_q - 1) / tile_q, (a.k + tile_p - 1) / tile_p);
#define REPRO_SDDMM(BM_, BN_, TM_, TN_, BK_)                                                 \
  tc::launch(sddmm_simt_kernel<BM_, BN_, TM_, TN_, BK_>,                                     \
             Tile<BM_, BN_, TM_, TN_, BK_>::THREADS, Tile<BM_, BN_, TM_, TN_, BK_>::RING, grid, \
             s, a)
  if (tile_p == 128 && tile_q == 128) return REPRO_SDDMM(128, 128, 8, 8, 32);
  if (tile_p == 64 && tile_q == 32) return REPRO_SDDMM(64, 32, 4, 4, 16);
#undef REPRO_SDDMM
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace simt

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
  dispatch_act(split ? ACT_NONE : a.act, [&](auto A) {
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
            a.y[off] = from_f32<bf16>(activate_tc(v + b[h], A.value));
        }
  });
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
  dispatch_act(a.act, [&](auto A) {
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
              __floats2bfloat162_rn(activate_tc(acc[j][4 * g + 2 * h] + b0, A.value),
                                    activate_tc(acc[j][4 * g + 2 * h + 1] + b1, A.value));
        }
    }
  });
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

// routes (kernels/masked_matmul.py ROUTES, SDDMM_ROUTES) and the tiles each
// is built for
enum Route { ROUTE_SIMT_F32 = 0, ROUTE_TC = 1, ROUTE_TC_SMALL_M = 2, ROUTE_SIMT_SMALL_M = 3 };
enum SddmmRoute { SDDMM_SIMT_F32 = 0, SDDMM_TC = 1, SDDMM_SIMT_SMALL_TILE = 2 };
constexpr int TC_STAGES = 4, SMALL_STAGES = 4, SMALL_TILE = 64;

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// y (m, n) = act(x (m, k) @ (M o W) + bias): W and mask (k, n), or (n, k)
// with transpose_w (then y = x @ (M o W)^T). dtype: DT_F32 (routes
// simt_small_m for m <= 64 and simt_f32) or DT_BF16 (routes tc and
// tc_small_m) for x, W and y; bias f32 (n,) or null. The launch plan
// (kernels/masked_matmul.py::plan): the route, its output tile (tile_p rows
// of the MMA's M side, tile_q of its N side; they must be one the route is
// built for: the f32 routes take tokens x channels), the K split and the K
// range of each split (k_chunk: a multiple of 64 on the bf16 routes, with
// ws an f32 (split, m, n) workspace when tc_small_m splits; a multiple of 4
// on the f32 routes, whose split is one cluster of at most 16 blocks and
// needs no workspace), and the copy width in bytes of the rows of x, W and
// the mask. Returns cudaGetLastError() after the launches.
extern "C" int masked_matmul_launch(const void* x, const void* w, const uint8_t* mask,
                                    const float* bias, void* y, float* ws, int m, int k, int n,
                                    int dtype, int transpose_w, int act, int route, int tile_p,
                                    int tile_q, int split, int k_chunk, int vec_x, int vec_w,
                                    int vec_m, void* stream) {
  cudaGetLastError();  // clear a stale error so the one returned is this launch's
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || k <= 0 || n <= 0 || act < ACT_NONE || act > ACT_LAST) return bad;
  if (!tc::vec_ok(vec_x) || !tc::vec_ok(vec_w) || !tc::vec_ok(vec_m)) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_SIMT_F32 || route == ROUTE_SIMT_SMALL_M) {
    if (dtype != DT_F32 || !simt::split_ok(k, split, k_chunk, 4, simt::CLUSTER_MAX)) return bad;
    const simt::Args a{static_cast<const float*>(x), static_cast<const float*>(w), mask, bias,
                       static_cast<float*>(y), m, k, n, act, split, k_chunk,
                       vec_x, vec_w, vec_m};
    return static_cast<int>(
        simt::launch_mm(a, route == ROUTE_SIMT_SMALL_M, transpose_w != 0, tile_p, tile_q, s));
  }
  if (dtype != DT_BF16 || !simt::split_ok(k, split, k_chunk, tc::TK, 1 << 30) ||
      (split > 1 && ws == nullptr))
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
// (d_in, d_out); x, g and dw share one dtype. The plan
// (kernels/masked_matmul.py::sddmm_plan): route (SDDMM_ROUTES) and the
// output tile, rows of dW x columns: SDDMM_TC for DT_BF16 at 256 x 128;
// for DT_F32 SDDMM_SIMT_F32 at 128 x 128 or SDDMM_SIMT_SMALL_TILE at 64 x
// 32. vec_*: the copy width in bytes of the rows of x, g and
// the mask (bf16 x and g by TMA when both are 16). Returns
// cudaGetLastError() after the launch.
extern "C" int sddmm_masked_launch(const void* x, const void* g, const uint8_t* mask,
                                   void* dw, int m, int d_in, int d_out, int dtype, int route,
                                   int tile_p, int tile_q, int vec_x, int vec_g, int vec_m,
                                   void* stream) {
  cudaGetLastError();
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || d_in <= 0 || d_out <= 0) return bad;
  if (!tc::vec_ok(vec_x) || !tc::vec_ok(vec_g) || !tc::vec_ok(vec_m)) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == SDDMM_SIMT_F32 || route == SDDMM_SIMT_SMALL_TILE) {
    const bool big = tile_p == 128 && tile_q == 128;
    if (dtype != DT_F32 || big != (route == SDDMM_SIMT_F32)) return bad;
    const simt::Args a{static_cast<const float*>(x), static_cast<const float*>(g), mask, nullptr,
                       static_cast<float*>(dw), m, d_in, d_out, ACT_NONE, 1, m,
                       vec_x, vec_g, vec_m};
    return static_cast<int>(simt::launch_sddmm(a, tile_p, tile_q, s));
  }
  if (route != SDDMM_TC || dtype != DT_BF16 || tile_p != tc::SD_BP || tile_q != tc::SD_BQ)
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
