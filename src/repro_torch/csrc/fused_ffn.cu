// Fused block-diagonal MLP for Hopper (sm_90a): the perm-fused packed FFN.
//
// Replaces the Pallas TPU body _ffn_kernel in src/repro/kernels/fused_ffn.py.
// For a perm-fused packed FFN (paper Fig. 3) block n of the MLP is
// independent of every other block:
//   u_n = x_n @ Wu[n] (* s_up[n]) + bu_n                  (bi -> f)
//   h_n = act(x_n @ Wg[n] (* s_gate[n]) + bg_n) * u_n     (gated; or act(u_n))
//   y_n = (h_n @ Wd[n]) (* s_down[n]) + bd_n              (f -> bo)
// with the weights in the activation type (f32 / bf16) or int8 with per
// output channel f32 scales. Products accumulate in f32; s_up / s_gate
// rescale each dot before its bias and the hidden epilogue (which needs true
// scale values), s_down commutes with the f-sum and is applied once, last.
// The hidden h never reaches device memory.
//
// What bounds it on the H100: the weight stream. At olmo-1b's full width
// (nb 8, bi 256, f 1024, bo 256) the three int8 projections are 6.3 MB, 1.9
// us at 3.35 TB/s, at decode (m = 4) as at one prefill chunk (m = 64). The
// TPU carries the down-projection sum across a sequential f grid axis in
// VMEM; a CUDA block has no such carry, and one block per (m tile, block n)
// would stream 6.3 MB through only 8 SMs. So the f axis is split across
// blocks: block (s, n, m tile) computes the hidden of its f tiles and their
// contribution to y_n, and the f32 partial sums are added in the fixed
// order s = 0, 1, ... before the epilogue: inside a cluster of the split's
// blocks over DSMEM (tc, tc_tall, simt_small, simt_tall), or from a
// workspace by the last block of each (m tile, n) to finish, behind an
// atomic ticket (simt_f32). The result is deterministic and the grid fills
// the card (128 blocks at the shapes above). With one split the block
// writes y directly.
//
// Five bodies; kernels/fused_ffn.py plan picks one by x's dtype and m:
//
// * tc (bf16 x, m <= 64, bf16 or int8 weights). A block owns one mma row tile of 16
//   tokens (every tile through the same instructions, so a token's output
//   does not depend on the chunk it rides in) x 256 output columns x 64 f
//   channels (split 16 at f = 1024 for every m <= 64: 128 blocks at m <=
//   16). Its Wu and Wg tiles (K stages of 64 rows, all in flight for bi <=
//   256, a ring beyond), its x rows and its Wd tile are requested at once
//   with 16-byte cp.async copies, the scales and biases read meanwhile.
//   Warp w owns f channels 16w .. 16w + 15: GEMM 1 on mma.sync.m16n8k16
//   with tokens on the 16-row side (A = x by ldmatrix, B = Wu / Wg by
//   ldmatrix.trans, int8 widened in registers exactly), then scale, bias
//   and gate in f32 on the accumulators. The hidden never leaves the
//   registers: the m16n8 accumulators of two n8 tiles are the A fragment of
//   a k16 step, so h feeds GEMM 2 directly, as a hi + lo pair of bf16 (two
//   mma's; h - hi - lo is within 2^-16 |h|: the reference keeps h in f32
//   for the down product, and one bf16 rounding of h inside a sum of 1024
//   terms would add an error it does not have). GEMM 2 keeps the warp's
//   partial over its 16 f for half the columns in registers; the four
//   warps' partials meet in shared memory, a half at a time, and are added
//   in warp order onto the block's f32 sums. The blocks of a tile's f split form one
//   thread block cluster: after a cluster barrier each adds a share of the
//   tile from all of their sums in rank order (no workspace, no float
//   atomics, one launch), then s_down, b_down and the cast.
// * tc_tall (bf16 x, m > 64: training batches, whole-prompt admissions,
//   the static prefill; bf16 or int8 weights). At m = 2048 the tc body's
//   1024 blocks each re-read their block's 1.5 MB of weights over 16 tokens
//   (~1.57 GB of L2 traffic for 25.8 GFLOP). Here a block owns 128 tokens,
//   two wgmma warpgroups of 64 rows beside a producer warpgroup, and walks
//   the f tiles with the down sum in registers: 128 blocks at m = 2048 (8x
//   less weight traffic), the f split only where the row tiles leave SMs
//   idle. Described at fused_ffn_wg_kernel.
// * simt_small (f32 x, m <= 64) and simt_tall (f32 x, m > 64): the exact
//   parity route (FFMA only, no TF32) through one pipelined cp.async ring,
//   with 16-byte shared loads into register tiles. Described at
//   fused_ffn_simt_kernel.
// * simt_f32 (f32 x, the first f32 body; plan never picks it, `force` runs
//   it beside the two above): the weight tiles are copied as stored with
//   cp.async, every thread issuing all its copies before waiting once; GEMM
//   1 takes the up/gate tiles in K chunks of 128 with x staged in f32 and
//   accumulates u and g in registers; the epilogue writes h (BM x 64) to
//   shared memory; GEMM 2 adds h @ Wd, whose whole 64 x 256 tile was copied
//   during GEMM 1, into a BM x 256 register tile of y that lives across the
//   block's f tiles; its split goes through the workspace.
// Ragged m, bi, f and bo are bounds-checked in the kernels: padded f
// channels give h = 0 and read zero rows of Wd, so they contribute exactly
// 0.

#include "tc.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int FS = 64;     // f channels per tile
constexpr int KC = 128;    // GEMM 1 K chunk (block-input rows)
constexpr int BO_T = 256;  // output columns per block

// per-thread register tiles: GEMM 1 covers BM x FS, GEMM 2 BM x BO_T
template <int BM>
struct Tiles {
  static constexpr int O1 = BM * FS / THREADS;
  static constexpr int TN1 = O1 < 4 ? O1 : 4;
  static constexpr int TM1 = O1 / TN1;
  static constexpr int CT1 = FS / TN1, RT1 = BM / TM1;
  static constexpr int O2 = BM * BO_T / THREADS;
  static constexpr int TN2 = O2 < 8 ? O2 : 8;
  static constexpr int TM2 = O2 / TN2;
  static constexpr int CT2 = BO_T / TN2, RT2 = BM / TM2;
  static constexpr int LDA = BM + 1;  // k-major row stride of the x and h tiles
  static_assert(BM >= 4 && RT1 * CT1 == THREADS && RT2 * CT2 == THREADS, "tile");
};

// dynamic shared memory: the x chunk and the hidden tile in f32, then the
// up, gate and down weight tiles as stored (offsets stay 16-byte aligned)
template <typename W, int BM>
constexpr int smem_bytes() {
  return (KC + FS) * (BM + 1) * 4 + (2 * KC * FS + FS * BO_T) * static_cast<int>(sizeof(W));
}

// asynchronous global -> shared copy of BYTES (4, 8 or 16); `in` false
// fills zeros and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(BYTES), "r"(in ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename W>
__device__ __forceinline__ W zero() { return W(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

// Stage rows [r0, r0+ROWS) x columns [c0, c0+COLS) of a row-major matrix
// (row stride ld, nr x nc) into dst (ROWS x COLS, as stored), zero outside.
// With `vec` (nc and ld multiples of 4, 16-byte aligned base) every thread
// issues all its copies at once, asynchronously; else a plain copy.
template <typename W, int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(W* dst, const W* __restrict__ src, long ld, int r0,
                                           int c0, int nr, int nc, bool vec) {
  constexpr int QPR = COLS / 4;  // quads per row
#pragma unroll 4
  for (int q = threadIdx.x; q < ROWS * QPR; q += THREADS) {
    const int r = q / QPR, c = (q % QPR) * 4;
    const int gr = r0 + r, gc = c0 + c;
    W* d = dst + r * COLS + c;
    if (vec) {
      const bool in = gr < nr && gc < nc;  // nc % 4 == 0: all four or none
      cp_async<4 * sizeof(W)>(d, in ? src + gr * ld + gc : src, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = (gr < nr && gc + e < nc) ? src[gr * ld + gc + e] : zero<W>();
    }
  }
}

template <typename T, typename W, int BM>
__global__ void __launch_bounds__(THREADS, 1)
fused_ffn_kernel(const T* __restrict__ x, const W* __restrict__ wu,
                 const W* __restrict__ wg, const W* __restrict__ wd,
                 const float* __restrict__ su, const float* __restrict__ sg,
                 const float* __restrict__ sd, const float* __restrict__ bu,
                 const float* __restrict__ bg, const float* __restrict__ bd,
                 T* __restrict__ y, float* __restrict__ part, int* __restrict__ counters,
                 int m, int nb, int bi, int f, int bo, int act, int split, int fpb,
                 int n_chunks, int vec) {
  using TL = Tiles<BM>;
  constexpr int LDA = TL::LDA;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // x chunk, k-major
  float* hs = xs + KC * LDA;                   // hidden tile, k-major (k = f)
  W* wus = reinterpret_cast<W*>(hs + FS * LDA);
  W* wgs = wus + KC * FS;
  W* wds = wgs + KC * FS;
  __shared__ int s_last;

  const int s = blockIdx.x;
  const int n = blockIdx.y;
  const int mt = blockIdx.z / n_chunks, ch = blockIdx.z % n_chunks;
  const int row0 = mt * BM, c0 = ch * BO_T;
  const int tid = threadIdx.x;
  const bool gated = wg != nullptr;
  const bool v = vec != 0;
  const long ldx = static_cast<long>(nb) * bi;
  const long ldy = static_cast<long>(nb) * bo;
  const T* xb = x + static_cast<long>(n) * bi;
  const W* wub = wu + static_cast<long>(n) * bi * f;
  const W* wgb = gated ? wg + static_cast<long>(n) * bi * f : nullptr;
  const W* wdb = wd + static_cast<long>(n) * f * bo;

  const int tr1 = tid / TL::CT1, tc1 = tid % TL::CT1;
  const int tr2 = tid / TL::CT2, tc2 = tid % TL::CT2;
  float acc2[TL::TM2][TL::TN2];
#pragma unroll
  for (int i = 0; i < TL::TM2; ++i)
#pragma unroll
    for (int j = 0; j < TL::TN2; ++j) acc2[i][j] = 0.f;

  const int n_ft = (f + FS - 1) / FS;
  for (int t = s * fpb; t < min((s + 1) * fpb, n_ft); ++t) {
    const int f0 = t * FS;
    // the down tile's copy is issued first and overlaps GEMM 1
    stage_tile<W, FS, BO_T>(wds, wdb, bo, f0, c0, f, bo, v);
    // ---------------------------------------------- GEMM 1: u, g = x @ Wu, Wg
    float au[TL::TM1][TL::TN1], ag[TL::TM1][TL::TN1];
#pragma unroll
    for (int i = 0; i < TL::TM1; ++i)
#pragma unroll
      for (int j = 0; j < TL::TN1; ++j) au[i][j] = ag[i][j] = 0.f;
    for (int k0 = 0; k0 < bi; k0 += KC) {
      stage_tile<W, KC, FS>(wus, wub, f, k0, f0, bi, f, v);
      if (gated) stage_tile<W, KC, FS>(wgs, wgb, f, k0, f0, bi, f, v);
#pragma unroll 4
      for (int idx = tid; idx < BM * KC; idx += THREADS) {
        const int r = idx / KC, k = idx % KC;
        const int gr = row0 + r, gk = k0 + k;
        xs[k * LDA + r] = (gr < m && gk < bi) ? to_f32(xb[gr * ldx + gk]) : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[TL::TM1], b[TL::TN1], c[TL::TN1];
#pragma unroll
        for (int i = 0; i < TL::TM1; ++i) a[i] = xs[k * LDA + tr1 + i * TL::RT1];
#pragma unroll
        for (int j = 0; j < TL::TN1; ++j) {
          b[j] = to_f32(wus[k * FS + tc1 + j * TL::CT1]);
          c[j] = gated ? to_f32(wgs[k * FS + tc1 + j * TL::CT1]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TL::TM1; ++i)
#pragma unroll
          for (int j = 0; j < TL::TN1; ++j) {
            au[i][j] = fmaf(a[i], b[j], au[i][j]);
            ag[i][j] = fmaf(a[i], c[j], ag[i][j]);
          }
      }
      __syncthreads();
    }
    // ------------------------- hidden epilogue: scale, bias, gate -> smem
#pragma unroll
    for (int i = 0; i < TL::TM1; ++i)
#pragma unroll
      for (int j = 0; j < TL::TN1; ++j) {
        const int r = tr1 + i * TL::RT1, jj = tc1 + j * TL::CT1;
        const int fj = f0 + jj;
        float h = 0.f;  // padded channels contribute exactly 0
        if (fj < f) {
          const long pf = static_cast<long>(n) * f + fj;
          float u = au[i][j];
          if (su) u *= su[pf];
          if (bu) u += bu[pf];
          if (gated) {
            float g = ag[i][j];
            if (sg) g *= sg[pf];
            if (bg) g += bg[pf];
            h = activate(g, act) * u;
          } else {
            h = activate(u, act);
          }
        }
        hs[jj * LDA + r] = h;
      }
    __syncthreads();
    // ----------------------------------------------- GEMM 2: y += h @ Wd
#pragma unroll 4
    for (int kk = 0; kk < FS; ++kk) {
      float a[TL::TM2], b[TL::TN2];
#pragma unroll
      for (int i = 0; i < TL::TM2; ++i) a[i] = hs[kk * LDA + tr2 + i * TL::RT2];
#pragma unroll
      for (int j = 0; j < TL::TN2; ++j) b[j] = to_f32(wds[kk * BO_T + tc2 + j * TL::CT2]);
#pragma unroll
      for (int i = 0; i < TL::TM2; ++i)
#pragma unroll
        for (int j = 0; j < TL::TN2; ++j) acc2[i][j] = fmaf(a[i], b[j], acc2[i][j]);
    }
    __syncthreads();  // hs and wds are restaged by the next f tile
  }

  // ------------------------------------------------------------ epilogue
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < TL::TM2; ++i) {
      const int gr = row0 + tr2 + i * TL::RT2;
      if (gr >= m) continue;
#pragma unroll
      for (int j = 0; j < TL::TN2; ++j) {
        const int c = c0 + tc2 + j * TL::CT2;
        if (c >= bo) continue;
        const long pc = static_cast<long>(n) * bo + c;
        float out = acc2[i][j];
        if (sd) out *= sd[pc];
        if (bd) out += bd[pc];
        y[gr * ldy + pc] = from_f32<T>(out);
      }
    }
    return;
  }
  // split f: publish this block's partial sums, then the last block of the
  // (m tile, n, column chunk) to arrive reduces them in order s = 0, 1, ...
#pragma unroll
  for (int i = 0; i < TL::TM2; ++i) {
    const int gr = row0 + tr2 + i * TL::RT2;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TL::TN2; ++j) {
      const int c = c0 + tc2 + j * TL::CT2;
      if (c < bo) part[(static_cast<long>(s) * m + gr) * ldy + static_cast<long>(n) * bo + c] = acc2[i][j];
    }
  }
  __threadfence();
  __syncthreads();
  const int cidx = blockIdx.z * nb + n;
  if (tid == 0) s_last = atomicAdd(&counters[cidx], 1) == split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = tid; idx < BM * BO_T; idx += THREADS) {
    const int gr = row0 + idx / BO_T, c = c0 + idx % BO_T;
    if (gr >= m || c >= bo) continue;
    const long pc = static_cast<long>(n) * bo + c;
    float out = 0.f;
#pragma unroll 8
    for (int si = 0; si < split; ++si) out += __ldcg(part + (static_cast<long>(si) * m + gr) * ldy + pc);
    if (sd) out *= sd[pc];
    if (bd) out += bd[pc];
    y[gr * ldy + pc] = from_f32<T>(out);
  }
  if (tid == 0) counters[cidx] = 0;  // ready for the next launch
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* wu, const void* wg, const void* wd, const float* su,
            const float* sg, const float* sd, const float* bu, const float* bg,
            const float* bd, void* y, float* part, int* counters, int m, int nb, int bi,
            int f, int bo, int bm, int act, int split, int fpb, int vec, cudaStream_t stream) {
  const int n_chunks = (bo + BO_T - 1) / BO_T;
  const dim3 grid(split, nb, ((m + bm - 1) / bm) * n_chunks);
  const auto* xt = static_cast<const T*>(x);
  const auto* wut = static_cast<const W*>(wu);
  const auto* wgt = static_cast<const W*>(wg);
  const auto* wdt = static_cast<const W*>(wd);
  auto* yt = static_cast<T*>(y);
#define REPRO_FFN(BM_)                                                                    \
  {                                                                                         \
    auto* kern = fused_ffn_kernel<T, W, BM_>;                                               \
    constexpr int bytes = smem_bytes<W, BM_>();                                             \
    static const cudaError_t attr =                                                         \
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);     \
    if (attr != cudaSuccess) return attr;                                                   \
    kern<<<grid, THREADS, bytes, stream>>>(xt, wut, wgt, wdt, su, sg, sd,                   \
                                                            bu, bg, bd, yt, part, counters, \
                                                            m, nb, bi, f, bo, act, split,   \
                                                            fpb, n_chunks, vec);            \
  }
  switch (bm) {
    case 4: REPRO_FFN(4); break;
    case 8: REPRO_FFN(8); break;
    case 16: REPRO_FFN(16); break;
    case 32: REPRO_FFN(32); break;
    default: REPRO_FFN(64); break;
  }
#undef REPRO_FFN
  return cudaSuccess;
}

}  // namespace

// =========================================================== tc (bf16 x)
namespace tc {
namespace {

struct FArgs {
  const bf16* x;                         // (m, nb * bi)
  const void *wu, *wg, *wd;              // (nb, bi, f) x 2, (nb, f, bo): bf16 or int8
  const float *su, *sg, *sd, *bu, *bg, *bd;
  bf16* y;                               // (m, nb * bo)
  int m, nb, bi, f, bo, act, split, fpb, n_chunks, vec_x, vec_w;
  int tma;                               // tc_tall: loads by TMA (else cp.async)
};

constexpr int FT_THREADS = 128;  // 4 warps, 16 f channels of the tile each
constexpr int FT_ROWS = 16;      // tokens of a block: one mma row tile
constexpr int FT_F = 64;         // f channels of a tile
constexpr int FT_COLS = 256;     // output columns of a block
constexpr int FT_STAGES = 4;     // GEMM-1 K stages in flight (bi <= 256: all)
constexpr int FT_HALF = FT_COLS / 2;  // output columns of a GEMM-2 half
constexpr int FT_LDS = FT_HALF + 8;  // row stride (floats) of a warp's partial

#ifndef REPRO_CUT
// breakdown variants (benchmarks/): 1 loads, 2 + the products; tc_tall
// also 3 (2 without the hidden's arithmetic), 4 (2 without GEMM 2) and 5
// (2 without GEMM 1)
#define REPRO_CUT 0
#endif
#ifndef REPRO_TALL_GENERIC
#define REPRO_TALL_GENERIC 0  // 1: gated silu through tc_tall's generic (branching) hidden
#endif

// Shared memory of a block: the K ring (Wu, Wg and x rows of 64 K rows a
// stage), whose bytes hold the four warps' partials once GEMM 1 is done;
// the Wd tile; the block's f32 sums (16 x 256), which its cluster reads at
// the end.
template <bool INT8>
struct FfnSmem {
  static constexpr int W_ROW = INT8 ? 64 : 128;  // a K row of the 64-channel Wu / Wg tile
  static constexpr int STAGE = 2 * TK * W_ROW + FT_ROWS * TK * 2;
  static constexpr int D_ROW = FT_COLS * (INT8 ? 1 : 2);  // an f row of the Wd tile
  static constexpr int D = FT_F * D_ROW;
  static constexpr int SCRATCH = 4 * FT_ROWS * FT_LDS * 4;
  static constexpr int SUMS = FT_ROWS * FT_COLS * 4;
  static __host__ __device__ constexpr int ring(int slots) {
    return slots * STAGE > SCRATCH ? slots * STAGE : SCRATCH;
  }
  static __host__ __device__ constexpr int bytes(int slots) { return ring(slots) + D + SUMS; }
  // Wd rows: int8 GEMM 2 reads rows 2i and 2i + 1 in one ldmatrix, so its
  // swizzle keys on r / 2
  static __device__ __forceinline__ uint32_t d_off(int r, int c) {
    if constexpr (INT8)
      return swz<D_ROW, 2>(r, c);
    else
      return swz<D_ROW, 1>(r, c);
  }
};

__host__ __device__ inline int ffn_slots(int bi) {
  const int steps = (bi + TK - 1) / TK;
  return steps < FT_STAGES ? steps : FT_STAGES;
}

template <bool INT8>
__global__ void __launch_bounds__(FT_THREADS) fused_ffn_tc_kernel(const FArgs a) {
  using L = FfnSmem<INT8>;
  constexpr int ES = INT8 ? 1 : 2;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float s_sd[FT_COLS], s_bd[FT_COLS];
  const uint32_t s0 = smem_u32(smem);
  const int slots = ffn_slots(a.bi), steps = (a.bi + TK - 1) / TK;
  const uint32_t sd = s0 + L::ring(slots);
  float* scratch = reinterpret_cast<float*>(smem);  // the ring's bytes, after GEMM 1
  float* sums = reinterpret_cast<float*>(smem + L::ring(slots) + L::D);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, c = lane % 4;
  const int s = blockIdx.x, n = blockIdx.y;
  const int r0 = blockIdx.z / a.n_chunks * FT_ROWS, c0 = blockIdx.z % a.n_chunks * FT_COLS;
  const bool gated = a.wg != nullptr;
  const int n_ft = (a.f + FT_F - 1) / FT_F;
  const long wblk = static_cast<long>(n) * a.bi * a.f * ES;
  const auto* wub = static_cast<const uint8_t*>(a.wu) + wblk;
  const auto* wgb = gated ? static_cast<const uint8_t*>(a.wg) + wblk : wub;
  const auto* wdb = static_cast<const uint8_t*>(a.wd) + static_cast<long>(n) * a.f * a.bo * ES;
  const Rows gx{reinterpret_cast<const uint8_t*>(a.x) + static_cast<long>(n) * a.bi * 2,
                2L * a.nb * a.bi, a.m, 2 * a.bi, a.vec_x};
  // the down projection's scale and bias for the block's columns; the sums
  for (int i = tid; i < FT_COLS; i += FT_THREADS) {
    const long pc = static_cast<long>(n) * a.bo + c0 + i;
    const bool in = c0 + i < a.bo;
    s_sd[i] = a.sd && in ? __ldg(a.sd + pc) : 1.f;
    s_bd[i] = a.bd && in ? __ldg(a.bd + pc) : 0.f;
  }
  for (int i = tid; i < FT_ROWS * FT_COLS; i += FT_THREADS) sums[i] = 0.f;

#pragma unroll 1
  for (int t = s * a.fpb; t < min((s + 1) * a.fpb, n_ft); ++t) {
    const int f0 = t * FT_F;
    const Rows gu{wub + f0 * ES, static_cast<long>(a.f) * ES, a.bi, (a.f - f0) * ES, a.vec_w};
    const Rows gg{wgb + f0 * ES, static_cast<long>(a.f) * ES, a.bi, (a.f - f0) * ES, a.vec_w};
    const Rows gd{wdb + (static_cast<long>(f0) * a.bo + c0) * ES, static_cast<long>(a.bo) * ES,
                  a.f - f0, (a.bo - c0) * ES, a.vec_w};
    auto issue = [&](int st) {
      const uint32_t su = s0 + (st % slots) * L::STAGE, sg = su + TK * L::W_ROW;
      const uint32_t sx = sg + TK * L::W_ROW;
      constexpr int WC = L::W_ROW / 16;
#pragma unroll
      for (int i = 0; i < TK * WC / FT_THREADS; ++i) {
        const int idx = tid + i * FT_THREADS, r = idx / WC, q = idx % WC;
        copy_chunk(su + swz<L::W_ROW>(r, q), gu, st * TK + r, 16 * q);
        if (gated) copy_chunk(sg + swz<L::W_ROW>(r, q), gg, st * TK + r, 16 * q);
      }
      copy_chunk(sx + swz<128>(tid / 8, tid % 8), gx, r0 + tid / 8, 2 * st * TK + 16 * (tid % 8));
    };
    // GEMM 1's stages, and with the last of them the Wd tile: every copy of
    // the tile is in flight before the first product
#pragma unroll 1
    for (int st = 0; st < FT_STAGES; ++st) {
      if (st < slots) issue(st);
      if (st == FT_STAGES - 1) {
        constexpr int DC = L::D_ROW / 16;
#pragma unroll 4
        for (int i = 0; i < FT_F * DC / FT_THREADS; ++i) {
          const int idx = tid + i * FT_THREADS, r = idx / DC, q = idx % DC;
          copy_chunk(sd + L::d_off(r, q), gd, r, 16 * q);
        }
      }
      cp_commit();
    }
    // the up and gate scales and biases of this thread's 4 f channels (the
    // hidden's order below), read while the tiles are in flight
    float hs[4][4];  // [channel q = 2j + (e & 1)][su, bu, sg, bg]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = q / 2, odd = q % 2;
      const int fg = f0 + 16 * warp + (INT8 ? 2 * (2 * c + odd) + j : 8 * j + 2 * c + odd);
      const long pf = static_cast<long>(n) * a.f + fg;
      const bool in = fg < a.f;
      hs[q][0] = a.su && in ? __ldg(a.su + pf) : 1.f;
      hs[q][1] = a.bu && in ? __ldg(a.bu + pf) : 0.f;
      hs[q][2] = a.sg && in ? __ldg(a.sg + pf) : 1.f;
      hs[q][3] = a.bg && in ? __ldg(a.bg + pf) : 0.f;
    }

    // ------------------------------ GEMM 1: u, g = x @ Wu, x @ Wg (16 f)
    // n8 tile j: int8 the even (j = 0) / odd (j = 1) columns of the warp's
    // 16-byte chunk, bf16 columns 8j .. 8j + 7 of its 16
    float au[2][4], ag[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) au[j][e] = ag[j][e] = 0.f;
#pragma unroll 1
    for (int st = 0; st < steps; ++st) {
      cp_wait<FT_STAGES - 1>();
      __syncthreads();
      if (REPRO_CUT != 1) {
        const uint32_t su = s0 + (st % slots) * L::STAGE, sg = su + TK * L::W_ROW;
        const uint32_t sx = sg + TK * L::W_ROW;
#pragma unroll
        for (int h2 = 0; h2 < TK / 32; ++h2) {
          uint32_t xa[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ldsm_x4(xa[h], sx + swz<128>(lane % 16, 4 * h2 + 2 * h + lane / 16));
          auto gemm1 = [&](uint32_t sw, float(&acc)[2][4]) {
            if constexpr (INT8) {
              // K rows 32 h2 + lane at the warp's chunk
              uint32_t q[4];
              ldsm_x4_t(q, sw + swz<64>(32 * h2 + lane, warp));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint32_t e0, o0, e1, o1;
                widen_pairs(q[2 * h], e0, o0);
                widen_pairs(q[2 * h + 1], e1, o1);
                mma_16816(acc[0], xa[h], e0, e1);
                mma_16816(acc[1], xa[h], o0, o1);
              }
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint32_t q[4];
                ldsm_x4_t(q, sw + swz<128>(32 * h2 + 16 * h + lane % 8 + 8 * ((lane / 8) % 2),
                                           2 * warp + lane / 16));
                mma_16816(acc[0], xa[h], q[0], q[1]);
                mma_16816(acc[1], xa[h], q[2], q[3]);
              }
            }
          };
          gemm1(su, au);
          if (gated) gemm1(sg, ag);
        }
      }
      __syncthreads();
      if (st + slots < steps) issue(st + slots);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();
    if (REPRO_CUT == 1) continue;

    // ----------------------- the hidden: scale, bias, gate; hi + lo bf16
    // accumulator e of tile j: token gq (+ 8 for e >= 2), f channel 16w +
    // 8j + 2c + (e & 1), or with int8 16w + 2 (2c + (e & 1)) + j; GEMM 2
    // reduces over f in that order
    uint32_t ah[4], al[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int fl = 16 * warp + (INT8 ? 2 * (2 * c + (e & 1)) + j : 8 * j + 2 * c + (e & 1));
        const float* q = hs[2 * j + (e & 1)];
        float h = 0.f;  // padded channels contribute exactly 0
        if (f0 + fl < a.f) {
          const float u = __fadd_rn(__fmul_rn(au[j][e], q[0]), q[1]);
          h = gated ? __fmul_rn(activate_tc(__fadd_rn(__fmul_rn(ag[j][e], q[2]), q[3]), a.act), u)
                    : activate_tc(u, a.act);
        }
        hv[e] = h;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // q = 0: token gq, q = 1: token gq + 8
        const __nv_bfloat162 hi = __floats2bfloat162_rn(hv[2 * q], hv[2 * q + 1]);
        const float2 back = __bfloat1622float2(hi);
        ah[2 * j + q] = *reinterpret_cast<const uint32_t*>(&hi);
        al[2 * j + q] = pack_bf16(__fsub_rn(hv[2 * q], back.x), __fsub_rn(hv[2 * q + 1], back.y));
      }
    }

    // --------------------- GEMM 2: y += h @ Wd (16 f, 128 columns a half)
    // The warp's partial over its 16 f for a half of the columns stays in
    // registers (16 independent n8 tiles, hi then lo), then the four warps'
    // partials meet once in shared memory and are added in warp order onto
    // the block's sums.
#pragma unroll 1
    for (int hh = 0; hh < 2; ++hh) {
      float acc[16][4];
#pragma unroll
      for (int cc = 0; cc < FT_HALF / 32; ++cc) {
        const int ch = 4 * hh + cc;  // 32-column chunk of the 256
        uint32_t b[4][2];            // the chunk's four n8 tiles
        if constexpr (INT8) {
          // f rows 16w + 2i (b0 b1) and 16w + 2i + 1 (b2 b3), i = lane % 8:
          // the int8 hidden's k order; chunks of 16 columns whose even and
          // odd columns are two n8 tiles
          uint32_t q[4];
          ldsm_x4_t(q, sd + L::d_off(16 * warp + 2 * (lane % 8) + (lane / 8) % 2, 2 * ch + lane / 16));
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            widen_pairs(q[2 * qq], b[2 * qq][0], b[2 * qq + 1][0]);
            widen_pairs(q[2 * qq + 1], b[2 * qq][1], b[2 * qq + 1][1]);
          }
        } else {
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            uint32_t q[4];
            ldsm_x4_t(q, sd + L::d_off(16 * warp + lane % 8 + 8 * ((lane / 8) % 2),
                                       4 * ch + 2 * qq + lane / 16));
            b[2 * qq][0] = q[0];
            b[2 * qq][1] = q[1];
            b[2 * qq + 1][0] = q[2];
            b[2 * qq + 1][1] = q[3];
          }
        }
#pragma unroll
        for (int T = 0; T < 4; ++T) {
          float(&d)[4] = acc[4 * cc + T];
          d[0] = d[1] = d[2] = d[3] = 0.f;
          mma_16816(d, ah, b[T][0], b[T][1]);
          mma_16816(d, al, b[T][0], b[T][1]);
        }
      }
      // tile 4cc + T's column e: int8 32cc + 16 (T / 2) + 2 (2c + (e & 1)) +
      // T % 2 (tiles T, T + 1 side by side), bf16 32cc + 8T + 2c + (e & 1)
      float* mine = scratch + warp * FT_ROWS * FT_LDS;
#pragma unroll
      for (int cc = 0; cc < FT_HALF / 32; ++cc)
#pragma unroll
        for (int T = 0; T < 4; T += 2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gq + 8 * (e >> 1);
            if constexpr (INT8) {
              const int col = 32 * cc + 8 * T + 2 * (2 * c + (e & 1));
              *reinterpret_cast<float2*>(mine + row * FT_LDS + col) =
                  make_float2(acc[4 * cc + T][e], acc[4 * cc + T + 1][e]);
            } else if ((e & 1) == 0) {
#pragma unroll
              for (int u = 0; u < 2; ++u)
                *reinterpret_cast<float2*>(mine + row * FT_LDS + 32 * cc + 8 * (T + u) + 2 * c) =
                    make_float2(acc[4 * cc + T + u][e], acc[4 * cc + T + u][e + 1]);
            }
          }
      __syncthreads();
      if (REPRO_CUT == 2) continue;
#pragma unroll 4
      for (int i = 0; i < FT_ROWS * FT_HALF / FT_THREADS; ++i) {
        const int idx = tid + i * FT_THREADS, row = idx / FT_HALF, col = idx % FT_HALF;
        float v = scratch[row * FT_LDS + col];
#pragma unroll
        for (int w = 1; w < 4; ++w) v = __fadd_rn(v, scratch[(w * FT_ROWS + row) * FT_LDS + col]);
        float& sum = sums[row * FT_COLS + FT_HALF * hh + col];
        sum = __fadd_rn(sum, v);
      }
      __syncthreads();  // the scratch (and, after the last, the ring) is reused
    }
  }
  if (REPRO_CUT != 0) return;

  // ------------------------------------------------------------ epilogue
  // s_down, b_down, bf16, in 4 columns at a time. With a split the tile's
  // blocks form one cluster and each adds a share of the tile from all of
  // their sums, in rank order.
  const long ldy = static_cast<long>(a.nb) * a.bo;
  const int rows = min(FT_ROWS, a.m - r0);
  bf16* y0 = a.y + static_cast<long>(r0) * ldy + static_cast<long>(n) * a.bo + c0;
  const bool vec_y = a.bo % 4 == 0 && (reinterpret_cast<uintptr_t>(a.y) & 7) == 0;
  auto out = [&](int g, float4 v) {
    const int row = g / (FT_COLS / 4), col = 4 * (g % (FT_COLS / 4));
    const float vs[4] = {v.x, v.y, v.z, v.w};
    bf16 o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = from_f32<bf16>(__fadd_rn(__fmul_rn(vs[q], s_sd[col + q]), s_bd[col + q]));
    bf16* dst = y0 + row * ldy + col;
    if (vec_y && c0 + col + 4 <= a.bo) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + col + q < a.bo) dst[q] = o[q];
    }
  };
  if (a.split == 1) {
    for (int g = tid; g < rows * FT_COLS / 4; g += FT_THREADS)
      out(g, *reinterpret_cast<const float4*>(sums + 4 * g));
    return;
  }
  cluster_sync();
  cluster_add<16>(smem_u32(sums), a.split, rows * FT_COLS / 4, out);
  cluster_sync();  // the other blocks have read this block's sums
}

// ================================================= tc_tall (bf16 x, m > 64)
// A block owns 128 tokens x one diagonal block n x up to 256 output columns
// and walks its f tiles (64 channels each), so each weight byte it loads
// serves 128 tokens, not 16. Two consumer warpgroups own 64 token rows each;
// one producer warpgroup fills a ring of 16 KB slots in the order the
// consumers take them, tile after tile:
//   [x K step (bi > 256 only)] [Wu | Wg K step] ... [Wd cols 0-127] [128-255]
// A GEMM-1 slot is the Wu and Wg panels of one K step (64 K rows x 64 f,
// MN-major, side by side), so one wgmma.m64n128k16 gives u and g of the
// tile's 64 channels together (A = x from shared memory, K-major). x's 128 x
// bi tile stays resident for bi <= 256 (TT_XRES K steps); deeper x takes a
// slot of its own before each weight slot. The hidden's scale, bias and
// gate run in f32 on the accumulators; h is repacked in registers as the A
// operand of the down product (the accumulator-to-A reuse of attention's
// P V), as a hi + lo pair of bf16, two wgmmas a k16 step, so h keeps f32's
// precision to 2^-16 |h|. y (64 x 256 f32 a warpgroup, 128 registers a
// thread) lives across the block's f tiles. Rows TMA can read arrive by TMA
// from one thread (zero past every edge): bf16 weights straight into their
// slot (128-byte swizzle), int8 into landing buffers whose rows every
// producer thread widens exactly to bf16 in the slot's layout TT_LAG items
// later. Other rows come by cp.async from all producer threads, which
// publish an item TT_LAG items after issuing it (int8 widened the same way). Where the row tiles leave SMs idle
// the f tiles are split over a cluster, whose blocks add their f32 partials
// in rank order over DSMEM (no workspace, no float atomics); with one split
// the block stages y in shared memory and writes it whole sectors at a time.
// What bounds it at m = 2048 (olmo-1b, bf16): the products, 34.4 GFLOP with
// the lo half (0.035 ms at 989 TFLOP/s), beside ~0.19 GB of weight tiles
// from L2 (a block an SM, each reading its diagonal block's 1.5 MB once);
// the bytes from device memory (29 MB) are far below both. The hidden
// between the two products is the part that does not overlap (PERF.md);
// for gated silu it runs branch-free (fused_ffn_wg_kernel<., true>): a
// branch while the previous k16 step's wgmmas read their registers cost
// more than the products.
constexpr int TT_ROWS = 128;                 // tokens of a block
constexpr int TT_THREADS = 3 * WG_THREADS;   // two consumer warpgroups, one producer
constexpr int TT_SLOT = 16384;               // ring slot: two 64 x 64 bf16 panels
constexpr int TT_XRES = 4;                   // x's K steps kept resident (bi <= 256)
constexpr int TT_LAG = 4;                    // cp.async: items in flight a producer thread
constexpr int TT_LAND = 8192;                // int8 landing bytes of an item
constexpr int TT_NL = TT_LAG + 1;            // int8 landing buffers
constexpr int TT_BUDGET = 232448;            // dynamic shared memory of a block
constexpr int CLUSTER_SPLIT_MAX = 16;       // the f split is one cluster
constexpr int TT_PLD = FT_COLS + 8;          // f32 row stride of a split partial
constexpr int TT_OUT_LD = 2 * FT_COLS + 16;  // bytes of a staged bf16 output row
// Registers a thread after the split: 3 x 168 (65,536 / 384, rounded down
// to 8) = 56 + 2 x 224, so the consumers' increase is always granted.
constexpr int TT_PRODUCER_REGS = 56, TT_CONSUMER_REGS = 224;

struct TallMaps {
  CUtensorMap x, wu, wg, wd;
};

// The block's shared memory from its 1024-aligned base: resident x, the
// int8 landing buffers, the ring, then the mbarriers. A split partial (128
// x TT_PLD f32) reuses the bytes from the base once every product is done.
struct TallLayout {
  int ksteps, x_bytes, land, slots, bytes;
};
__host__ __device__ inline TallLayout tall_layout(int bi, bool int8) {
  TallLayout l;
  l.ksteps = (bi + TK - 1) / TK;
  l.x_bytes = l.ksteps <= TT_XRES ? l.ksteps * TT_SLOT : 0;
  l.land = int8 ? TT_NL * TT_LAND : 0;
  l.slots = (TT_BUDGET - 1024 - 512 - l.x_bytes - l.land) / TT_SLOT;
  l.bytes = 1024 + l.x_bytes + l.land + l.slots * TT_SLOT + (2 * l.slots + 1 + 2 * TT_NL) * 8;
  return l;
}

// Two int8 weights of the word v (bytes sel0, sel1 of v ^ 0x80808080) as a
// bf16 pair, exactly: the byte under the exponent of 2^23 is 2^23 + (q +
// 128), one subtraction gives q, and the upper half of that f32 is q in
// bf16 (|q| <= 128 has 8 significant bits).
__device__ __forceinline__ uint32_t widen2(uint32_t v, uint32_t sel0, uint32_t sel1) {
  const float bias = 8388736.0f;  // 2^23 + 128
  const uint32_t f0 = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, sel0)), bias));
  const uint32_t f1 = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, sel1)), bias));
  return __byte_perm(f0, f1, 0x7632);
}
// 16 int8 weights at shared address src -> 16 bf16 at dst0 (the first 8)
// and dst1.
__device__ __forceinline__ void widen16(uint32_t src, uint32_t dst0, uint32_t dst1) {
  uint32_t w[4];
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "r"(src) : "memory");
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = w[i] ^ 0x80808080u;
    o[2 * i] = widen2(v, 0x7440, 0x7441);
    o[2 * i + 1] = widen2(v, 0x7442, 0x7443);
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst0), "r"(o[0]), "r"(o[1]),
               "r"(o[2]), "r"(o[3]) : "memory");
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst1), "r"(o[4]), "r"(o[5]),
               "r"(o[6]), "r"(o[7]) : "memory");
}

// What item j of a tile holds: K step k of x (kind 0) or of Wu | Wg (kind
// 1), or half k of the Wd tile (kind 2).
struct Item {
  int kind, k;
};
__device__ __forceinline__ Item tall_item(int j, int g1, bool resident) {
  if (j >= g1) return {2, j - g1};
  if (resident) return {1, j};
  return {j & 1, j >> 1};
}

// Keep registers that an asynchronous wgmma reads (its A operand) live and
// unchanged until it has been waited for.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <bool INT8, bool SILU_GATED>
__global__ void __launch_bounds__(TT_THREADS, 1)
    fused_ffn_wg_kernel(const FArgs a, const __grid_constant__ TallMaps maps) {
  constexpr int ES = INT8 ? 1 : 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const TallLayout L = tall_layout(a.bi, INT8);
  const bool resident = L.x_bytes > 0, tma = a.tma != 0;
  const uint32_t s0 = smem_u32(smem), sland = s0 + L.x_bytes, sring = sland + L.land;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.x_bytes + L.land + L.slots * TT_SLOT);
  uint64_t* empty = full + L.slots;
  uint64_t* xbar = empty + L.slots;
  uint64_t* landed = xbar + 1;      // int8 by TMA: an item's bytes have landed
  uint64_t* lfree = landed + TT_NL;  // and every producer thread has widened them
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int n = blockIdx.y;
  const int r0 = blockIdx.z / a.n_chunks * TT_ROWS, c0 = blockIdx.z % a.n_chunks * FT_COLS;
  const bool gated = a.wg != nullptr;
  const int n_ft = (a.f + FT_F - 1) / FT_F;
  const int t0 = blockIdx.x * a.fpb, t1 = min(t0 + a.fpb, n_ft);
  const int halves = min(a.bo - c0, FT_COLS) > FT_HALF ? 2 : 1;
  const int g1 = resident ? L.ksteps : 2 * L.ksteps;  // GEMM-1 items of a tile
  const int per_tile = g1 + halves;
  const int n_items = (t1 - t0) * per_tile;
  if (tid == 0) {
    for (int i = 0; i < L.slots; ++i) {
      bar_init(full + i, tma && !INT8 ? 1 : WG_THREADS);
      bar_init(empty + i, 8);  // every consumer warp
    }
    for (int i = 0; i < TT_NL; ++i) {
      bar_init(landed + i, 1);
      bar_init(lfree + i, WG_THREADS);
    }
    bar_init(xbar, tma ? 1 : WG_THREADS);
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TT_PRODUCER_REGS));
    const int pt = tid - 2 * WG_THREADS;
    if (tma && INT8) {
      // int8 by TMA: one thread loads item t into landing buffer t % TT_NL
      // (x K steps straight into their slot) TT_LAG items ahead; every
      // thread waits for item t - TT_LAG to land, widens its share into the
      // slot and publishes it. A landing buffer is reloaded once all
      // threads have widened what it held (lfree).
      if (pt == 0 && resident) {
        bar_expect(xbar, L.ksteps * TT_SLOT);
        for (int k = 0; k < L.ksteps; ++k)
          for (int h = 0; h < 2; ++h)
            tma_load(s0 + k * TT_SLOT + h * 8192, &maps.x, k * TK, n, r0 + 64 * h, xbar);
      }
#pragma unroll 1
      for (int t = 0; t < n_items + TT_LAG; ++t) {
        if (pt == 0 && t < n_items) {
          const int li = t % TT_NL, f0 = (t0 + t / per_tile) * FT_F;
          if (t >= TT_NL) bar_wait(lfree + li, ((t / TT_NL) & 1) ^ 1);
          const uint32_t land = sland + li * TT_LAND;
          const Item it = tall_item(t % per_tile, g1, resident);
          if (it.kind == 0) {
            const int st = t % L.slots;
            if (t >= L.slots) bar_wait(empty + st, ((t / L.slots) & 1) ^ 1);
            const uint32_t dst = sring + st * TT_SLOT;
            bar_expect(landed + li, TT_SLOT);
            tma_load(dst, &maps.x, it.k * TK, n, r0, landed + li);
            tma_load(dst + 8192, &maps.x, it.k * TK, n, r0 + 64, landed + li);
          } else if (it.kind == 1) {  // Wu, Wg: 64 K rows of 64 bytes each
            bar_expect(landed + li, gated ? TT_LAND : TT_LAND / 2);
            tma_load(land, &maps.wu, f0, it.k * TK, n, landed + li);
            if (gated) tma_load(land + TT_LAND / 2, &maps.wg, f0, it.k * TK, n, landed + li);
          } else {  // Wd: 64 f rows of 128 bytes
            bar_expect(landed + li, TT_LAND);
            tma_load(land, &maps.wd, c0 + FT_HALF * it.k, f0, n, landed + li);
          }
        }
        if (t >= TT_LAG) {
          const int u = t - TT_LAG, li = u % TT_NL, st = u % L.slots;
          bar_wait(landed + li, (u / TT_NL) & 1);
          const Item it = tall_item(u % per_tile, g1, resident);
          if (it.kind != 0) {
            if (u >= L.slots) bar_wait(empty + st, ((u / L.slots) & 1) ^ 1);
            const uint32_t dst = sring + st * TT_SLOT, land = sland + li * TT_LAND;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (it.kind == 1) {
                if (q >= 2 && !gated) break;
                const int idx = pt + (q & 1) * WG_THREADS, r = idx / 4, c = idx % 4;
                const uint32_t panel = dst + (q < 2 ? 0 : 8192);
                widen16(land + (q < 2 ? 0 : TT_LAND / 2) + r * 64 + c * 16,
                        panel + MNMajor{}(r, 2 * c), panel + MNMajor{}(r, 2 * c + 1));
              } else {
                const int idx = pt + q * WG_THREADS, r = idx / 8, c = idx % 8;
                widen16(land + r * 128 + c * 16, dst + MNMajor{}(r, 2 * c),
                        dst + MNMajor{}(r, 2 * c + 1));
              }
            }
          }
          bar_arrive(lfree + li);
          fence_async_smem();
          bar_arrive(full + st);
        }
      }
    } else if (tma) {
      if (pt == 0) {
        if (resident) {
          bar_expect(xbar, L.ksteps * TT_SLOT);
          for (int k = 0; k < L.ksteps; ++k)
            for (int h = 0; h < 2; ++h)
              tma_load(s0 + k * TT_SLOT + h * 8192, &maps.x, k * TK, n, r0 + 64 * h, xbar);
        }
#pragma unroll 1
        for (int i = 0; i < n_items; ++i) {
          const int st = i % L.slots;
          if (i >= L.slots) bar_wait(empty + st, ((i / L.slots) & 1) ^ 1);
          const uint32_t dst = sring + st * TT_SLOT;
          const int f0 = (t0 + i / per_tile) * FT_F;
          const Item it = tall_item(i % per_tile, g1, resident);
          if (it.kind == 0) {
            bar_expect(full + st, TT_SLOT);
            tma_load(dst, &maps.x, it.k * TK, n, r0, full + st);
            tma_load(dst + 8192, &maps.x, it.k * TK, n, r0 + 64, full + st);
          } else if (it.kind == 1) {
            bar_expect(full + st, gated ? TT_SLOT : TT_SLOT / 2);
            tma_load(dst, &maps.wu, f0, it.k * TK, n, full + st);
            if (gated) tma_load(dst + 8192, &maps.wg, f0, it.k * TK, n, full + st);
          } else {
            bar_expect(full + st, TT_SLOT);
            tma_load(dst, &maps.wd, c0 + FT_HALF * it.k, f0, n, full + st);
            tma_load(dst + 8192, &maps.wd, c0 + FT_HALF * it.k + 64, f0, n, full + st);
          }
        }
      }
    } else {
      const long wblk = static_cast<long>(n) * a.bi * a.f * ES;
      const auto* wub = static_cast<const uint8_t*>(a.wu) + wblk;
      const auto* wgb = gated ? static_cast<const uint8_t*>(a.wg) + wblk : wub;
      const auto* wdb = static_cast<const uint8_t*>(a.wd) + static_cast<long>(n) * a.f * a.bo * ES;
      const Rows gx{reinterpret_cast<const uint8_t*>(a.x) + static_cast<long>(n) * a.bi * 2,
                    2L * a.nb * a.bi, a.m, 2 * a.bi, a.vec_x};
      // x K step k (128 rows x 64, K-major) at dst: 8 chunks a thread
      auto copy_x = [&](uint32_t dst, int k) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int idx = pt + q * WG_THREADS, r = idx / 8, c = idx % 8;
          copy_chunk(dst + KMajor{}(r, c), gx, r0 + r, 2 * k * TK + 16 * c);
        }
      };
      if (resident) {
        for (int k = 0; k < L.ksteps; ++k) copy_x(s0 + k * TT_SLOT, k);
        cp_commit();
        cp_wait<0>();
        fence_async_smem();
        bar_arrive(xbar);
      }
      // Item i is issued at iteration i and published at i + TT_LAG. A
      // thread's int8 chunks of an item land at bytes [64 pt, 64 pt + 64)
      // of its landing buffer, whatever the item, so each thread reads back
      // only what it copied itself.
#pragma unroll 1
      for (int i = 0; i < n_items + TT_LAG; ++i) {
        if (i < n_items) {
          const int st = i % L.slots, f0 = (t0 + i / per_tile) * FT_F;
          const uint32_t dst = sring + st * TT_SLOT;
          const uint32_t land = sland + (i % TT_NL) * TT_LAND + 64 * pt;
          const Item it = tall_item(i % per_tile, g1, resident);
          if ((!INT8 || it.kind == 0) && i >= L.slots)
            bar_wait(empty + st, ((i / L.slots) & 1) ^ 1);
          if (it.kind == 0) {
            copy_x(dst, it.k);
          } else if (it.kind == 1) {
            const Rows gu{wub + f0 * ES, static_cast<long>(a.f) * ES, a.bi, (a.f - f0) * ES,
                          a.vec_w};
            const Rows gg{wgb + f0 * ES, static_cast<long>(a.f) * ES, a.bi, (a.f - f0) * ES,
                          a.vec_w};
            if constexpr (INT8) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (q >= 2 && !gated) break;
                const int idx = pt + (q & 1) * WG_THREADS, r = idx / 4, c = idx % 4;
                copy_chunk(land + 16 * q, q < 2 ? gu : gg, it.k * TK + r, 16 * c);
              }
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int idx = pt + q * WG_THREADS, r = idx / 8, c = idx % 8;
                copy_chunk(dst + MNMajor{}(r, c), gu, it.k * TK + r, 16 * c);
                if (gated) copy_chunk(dst + 8192 + MNMajor{}(r, c), gg, it.k * TK + r, 16 * c);
              }
            }
          } else {
            const int cb = c0 + FT_HALF * it.k;
            const Rows gd{wdb + (static_cast<long>(f0) * a.bo + cb) * ES,
                          static_cast<long>(a.bo) * ES, a.f - f0, (a.bo - cb) * ES, a.vec_w};
            if constexpr (INT8) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int idx = pt + q * WG_THREADS, r = idx / 8, c = idx % 8;
                copy_chunk(land + 16 * q, gd, r, 16 * c);
              }
            } else {
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const int idx = pt + q * WG_THREADS, r = idx / 16, c = idx % 16;
                copy_chunk(dst + MNMajor{}(r, c), gd, r, 16 * c);
              }
            }
          }
        }
        cp_commit();
        if (i >= TT_LAG) {
          const int u = i - TT_LAG, st = u % L.slots;
          cp_wait<TT_LAG>();
          if constexpr (INT8) {
            const Item it = tall_item(u % per_tile, g1, resident);
            if (it.kind != 0) {
              if (u >= L.slots) bar_wait(empty + st, ((u / L.slots) & 1) ^ 1);
              const uint32_t dst = sring + st * TT_SLOT;
              const uint32_t land = sland + (u % TT_NL) * TT_LAND + 64 * pt;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (it.kind == 1) {
                  if (q >= 2 && !gated) break;
                  const int idx = pt + (q & 1) * WG_THREADS, r = idx / 4, c = idx % 4;
                  const uint32_t panel = dst + (q < 2 ? 0 : 8192);
                  widen16(land + 16 * q, panel + MNMajor{}(r, 2 * c),
                          panel + MNMajor{}(r, 2 * c + 1));
                } else {
                  const int idx = pt + q * WG_THREADS, r = idx / 8, c = idx % 8;
                  widen16(land + 16 * q, dst + MNMajor{}(r, 2 * c), dst + MNMajor{}(r, 2 * c + 1));
                }
              }
            }
          }
          fence_async_smem();
          bar_arrive(full + st);
        }
      }
    }
    if (a.split > 1 && REPRO_CUT == 0) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TT_CONSUMER_REGS));
    const int warp = (tid / 32) % 4, lane = tid % 32, gq = lane / 4, c = lane % 4;
    const bool lane0 = lane == 0;
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 64; ++q) acc[h][q] = 0.f;
    if (resident) bar_wait(xbar, 0);
    auto take = [&](int i) {
      bar_wait(full + i % L.slots, (i / L.slots) & 1);
      return sring + (i % L.slots) * TT_SLOT;
    };
    auto give = [&](int i) {
      if (lane0) bar_arrive(empty + i % L.slots);
    };
    int i = 0;
#pragma unroll 1
    for (int t = t0; t < t1; ++t) {
      const int f0 = t * FT_F;
      // ------------------------- GEMM 1: [u | g] (64 x 128) = x @ [Wu | Wg]
      float ug[64];
#pragma unroll
      for (int q = 0; q < 64; ++q) ug[q] = 0.f;
      int prev = -1;
#pragma unroll 1
      for (int k = 0; k < L.ksteps; ++k) {
        uint32_t xs = s0 + k * TT_SLOT;
        if (!resident) xs = take(i++);
        const int wi = i++;
        const uint32_t ws = take(wi);
        if (REPRO_CUT != 1 && REPRO_CUT != 5) {
          fence_acc(ug);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TK / 16; ++kk)
            wgmma_n128<0, 1>(ug, desc(xs + wg * 8192 + kk * 32, 16, 1024), desc_mn(ws, kk));
          wgmma_commit();
          wgmma_wait<1>();
          fence_acc(ug);
        }
        if (prev >= 0) {
          if (!resident) give(prev - 1);
          give(prev);
        }
        prev = wi;
      }
      wgmma_wait<0>();
      fence_acc(ug);
      if (!resident) give(prev - 1);
      give(prev);

      // ------------- the hidden and GEMM 2: y (64 x 256) += h @ Wd (64 f)
      // Accumulator 4q + 2rh + e: token row 16 warp + gq + 8 rh, channel 8q
      // + 2c + e (u; g at + 32). Per k16 step j (channels 16j .. 16j + 15:
      // n8 groups 2j, 2j + 1) the hidden's scale, bias and gate in f32, h as
      // the A fragment of registers 8j .. 8j + 7 two by two, a hi + lo pair
      // of bf16, and its wgmmas on both column halves issued at once, so
      // step j's products overlap step j + 1's epilogue.
      int di[2] = {0, 0};
      uint32_t ds[2] = {0u, 0u};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (hf < halves) {
          di[hf] = i++;
          ds[hf] = take(di[hf]);
        }
      uint32_t hi[4][4], lo[4][4];
      fence_acc(acc[0]);
      fence_acc(acc[1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 2 * j; q < 2 * j + 2; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int fg = f0 + 8 * q + 2 * c + e;
            const long pf = static_cast<long>(n) * a.f + fg;
            const bool in = fg < a.f;
            const float su = a.su && in ? __ldg(a.su + pf) : 1.f;
            const float bu = a.bu && in ? __ldg(a.bu + pf) : 0.f;
            const float sg = a.sg && in ? __ldg(a.sg + pf) : 1.f;
            const float bg = a.bg && in ? __ldg(a.bg + pf) : 0.f;
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              const int r = 4 * q + 2 * rh + e;
              float h = 0.f;  // padded channels contribute exactly 0
              if (REPRO_CUT == 3) {
                h = ug[r];
              } else if (SILU_GATED) {
                // branch-free (a branch here, while the previous step's
                // wgmmas read their registers, cost more than the products)
                const float u = __fadd_rn(__fmul_rn(ug[r], su), bu);
                const float g = __fadd_rn(__fmul_rn(ug[32 + r], sg), bg);
                h = __fmul_rn(__fdividef(g, 1.0f + __expf(-g)), u);
                h = in ? h : 0.f;
              } else if (in) {
                const float u = __fadd_rn(__fmul_rn(ug[r], su), bu);
                h = gated ? __fmul_rn(activate_tc(__fadd_rn(__fmul_rn(ug[32 + r], sg), bg), a.act), u)
                          : activate_tc(u, a.act);
              }
              ug[r] = h;
            }
          }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float h0 = ug[8 * j + 2 * q], h1 = ug[8 * j + 2 * q + 1];
          const __nv_bfloat162 b = __floats2bfloat162_rn(h0, h1);
          const float2 back = __bfloat1622float2(b);
          hi[j][q] = *reinterpret_cast<const uint32_t*>(&b);
          lo[j][q] = pack_bf16(__fsub_rn(h0, back.x), __fsub_rn(h1, back.y));
        }
        if (REPRO_CUT != 1 && REPRO_CUT != 4) {
          wgmma_fence();
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            if (hf < halves) {
              wgmma_n128_rs<1>(acc[hf], hi[j], desc_mn(ds[hf], j));
              wgmma_n128_rs<1>(acc[hf], lo[j], desc_mn(ds[hf], j));
            }
          wgmma_commit();
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fence_regs(hi[j]);
        fence_regs(lo[j]);
      }
      give(di[0]);
      if (halves > 1) give(di[1]);
    }

    if (REPRO_CUT != 0) {
      // the cut variants keep their products alive and store nothing
      if (acc[0][0] == 1.2345e-38f && acc[1][63] == 1.2345e-38f) a.y[0] = from_f32<bf16>(0.f);
      return;
    }
    // ------------------------------------------------------------ epilogue
    const long ldy = static_cast<long>(a.nb) * a.bo;
    const int row0 = 64 * wg + 16 * warp + gq;
    if (a.split == 1) {
      // s_down, b_down and bf16 on the accumulators, each warpgroup's 64
      // rows staged in shared memory (rows padded to TT_OUT_LD bytes, so a
      // store's 8 rows hit distinct banks) once both consumers' products
      // have retired (the staging reuses x and the ring), then written 16
      // bytes a thread, 32 threads a row: every output sector whole.
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG_THREADS) : "memory");
      uint8_t* buf = smem + wg * 64 * TT_OUT_LD;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf >= halves) break;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int cl = FT_HALF * hf + 8 * q + 2 * c;
          float sd[2], bd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long pc = static_cast<long>(n) * a.bo + c0 + cl + e;
            const bool in = c0 + cl + e < a.bo;
            sd[e] = a.sd && in ? __ldg(a.sd + pc) : 1.f;
            bd[e] = a.bd && in ? __ldg(a.bd + pc) : 0.f;
          }
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
            *reinterpret_cast<__nv_bfloat162*>(buf + (16 * warp + gq + 8 * rh) * TT_OUT_LD + 2 * cl) =
                __floats2bfloat162_rn(__fadd_rn(__fmul_rn(acc[hf][4 * q + 2 * rh], sd[0]), bd[0]),
                                      __fadd_rn(__fmul_rn(acc[hf][4 * q + 2 * rh + 1], sd[1]), bd[1]));
        }
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG_THREADS) : "memory");
      const bool vec = a.bo % 8 == 0 && (reinterpret_cast<uintptr_t>(a.y) & 15) == 0;
#pragma unroll 4
      for (int i = tid % WG_THREADS; i < 64 * (FT_COLS / 8); i += WG_THREADS) {
        const int r = i / (FT_COLS / 8), col = c0 + 8 * (i % (FT_COLS / 8));
        const int row = r0 + 64 * wg + r;
        if (row >= a.m || col >= a.bo) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(buf + r * TT_OUT_LD + 2 * (col - c0));
        bf16* dst = a.y + row * ldy + static_cast<long>(n) * a.bo + col;
        if (vec && col + 8 <= a.bo) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const bf16* e = reinterpret_cast<const bf16*>(&v);
          for (int q = 0; q < 8 && col + q < a.bo; ++q) dst[q] = e[q];
        }
      }
      return;
    }
    // split f: this block's f32 partial into its own shared memory, once
    // every product of both consumers has retired (it reuses x and the
    // ring); then the blocks of the split add the tile's partials in rank
    // order (the consumer threads, a share of the 4-column groups each),
    // then s_down, b_down and bf16. The producers join both cluster
    // barriers.
    asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG_THREADS) : "memory");
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          *reinterpret_cast<float2*>(part + (row0 + 8 * rh) * TT_PLD + FT_HALF * hf + 8 * q + 2 * c) =
              make_float2(acc[hf][4 * q + 2 * rh], acc[hf][4 * q + 2 * rh + 1]);
    cluster_sync();
    // block `rank` adds a contiguous share of the tile's 4-column groups,
    // neighbouring threads on neighbouring groups (conflict-free remote reads)
    const int rows = min(TT_ROWS, a.m - r0), split = a.split, rank = cluster_rank();
    const int groups = rows * (FT_COLS / 4), share = (groups + split - 1) / split;
    const bool vec_y = a.bo % 4 == 0 && (reinterpret_cast<uintptr_t>(a.y) & 7) == 0;
    for (int g = rank * share + tid; g < min(groups, (rank + 1) * share); g += 2 * WG_THREADS) {
      const int row = g / (FT_COLS / 4), col = 4 * (g % (FT_COLS / 4));
      if (c0 + col >= a.bo) continue;
      const uint32_t addr = s0 + (row * TT_PLD + col) * 4;
      float4 t[CLUSTER_SPLIT_MAX];
#pragma unroll
      for (int r = 0; r < CLUSTER_SPLIT_MAX; ++r)
        if (r < split) t[r] = ld_cluster4(addr, r);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < CLUSTER_SPLIT_MAX; ++r)
        if (r < split) {
          v[0] = __fadd_rn(v[0], t[r].x);
          v[1] = __fadd_rn(v[1], t[r].y);
          v[2] = __fadd_rn(v[2], t[r].z);
          v[3] = __fadd_rn(v[3], t[r].w);
        }
      bf16 o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long pc = static_cast<long>(n) * a.bo + c0 + col + q;
        const bool in = c0 + col + q < a.bo;
        const float sd = a.sd && in ? __ldg(a.sd + pc) : 1.f;
        const float bd = a.bd && in ? __ldg(a.bd + pc) : 0.f;
        o[q] = from_f32<bf16>(__fadd_rn(__fmul_rn(v[q], sd), bd));
      }
      bf16* dst = a.y + static_cast<long>(r0 + row) * ldy + static_cast<long>(n) * a.bo + c0 + col;
      if (vec_y && c0 + col + 4 <= a.bo) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c0 + col + q < a.bo) dst[q] = o[q];
      }
    }
    cluster_sync();  // the other blocks have read this block's partial
  }
}

}  // namespace
}  // namespace tc

// ========================================== simt_small / simt_tall (f32 x)
// The exact parity route on the CUDA cores (FFMA only: no TF32, no tensor
// cores). Every output is one fma chain: u and g over k in increasing order
// within an f tile, y over a tile's f channels in order and over the
// block's f tiles in order; the blocks of an f split form one cluster whose
// partials are added in rank order over DSMEM (tc::cluster_add): no
// workspace, no ticket, no float atomics, so a graph replay equals the
// eager call bit for bit.
//
// A block owns BM tokens x one diagonal block n x up to 256 output columns
// and walks its f tiles: 128 channels (simt_small) or 64 (simt_tall).
// Everything it reads comes through one ring of SLOTS slots, SLOTS - 1
// items ahead of the products, one barrier an item: by TMA from one thread
// (boxes as stored, zeros past every edge, completing on the slot's
// mbarrier) where every row is 16-byte aligned, else by 16-byte cp.async
// copies from every thread. A tile's items: ceil(bi / KC) GEMM-1 items (KC
// K rows of Wu and of Wg as stored, int8 as int8, and the same KC columns
// of the block's x rows in f32), then F / DC Wd items (DC f rows of 256
// columns as stored: as many weights as a GEMM-1 item, so every item fills
// its slot alike). KC is 16, 64 at row tiles of 8 or fewer (fewer items,
// fewer barriers: decode). x thus arrives once per block wherever the
// block owns one f tile (every plan at m <= 64 up to f = 1024 on the
// H100).
//   GEMM 1: RT1 x CT1 threads, each TM1 rows (strided by RT1: a warp's two
// rows fall in other banks) x TN1 channels of u and of g in runs of 4
// (strided by CT1 runs: a warp's loads of a run are contiguous): a 16-byte
// load of x gives 4 k of a row, one of Wu and of Wg 4 channels of a k
// (int8 widened exactly in registers), 8 TM1 fmas for each. The hidden
// (scale, bias, activation, gate in f32) goes to shared memory f-major.
//   GEMM 2: RT2 x CQ2 threads, each TM2 consecutive rows x QN2 quads of
// columns: h by 16-byte loads along the rows, Wd a quad at a time.
// simt_small (BM <= 64: decode, verify, a prefill chunk) keeps y in
// registers across the tiles; the row tile only selects how many threads
// share the work, so a token's output does not depend on its chunk.
// simt_tall (BM = 128: whole-prompt admissions, f32 training batches) reads
// each weight byte once for 128 tokens; its y (128 registers a thread)
// waits in shared memory while GEMM 1 holds its 64 accumulators, and is
// loaded for each tile's down product.
// What bounds it on the H100 at olmo-1b's width (nb 8, bi 256, f 1024, bo
// 256, gated): at m = 4 the 25 MB of f32 weights (7.5 us at 3.35 TB/s),
// from m = 64 up the fmas (67 TFLOP/s: 12 us at m = 64, 0.385 ms at m =
// 2048). What holds it from there (PERF.md; H100 80GB HBM3, 700 W): a
// block an SM, and the card co-schedules 7 clusters of 16 such blocks, so
// m <= 64 splits 8 ways (64 SMs, each pulling 384 KB at ~30 GB/s); FFMA
// issue at ~60 % inside a tile.
namespace sf {
namespace {

struct SArgs {
  const float* x;                        // (m, nb * bi)
  const void *wu, *wg, *wd;              // (nb, bi, f) x 2, (nb, f, bo): f32 or int8
  const float *su, *sg, *sd, *bu, *bg, *bd;
  float* y;                              // (m, nb * bo)
  int m, nb, bi, f, bo, act, split, fpb, n_chunks, vec_x, vec_w;
  int tma;                               // items land by TMA (else cp.async)
};

// x (bi, nb, m), Wu and Wg (f, bi, nb), Wd (bo, f, nb), innermost first,
// each read in the boxes of one item
struct SfMaps {
  CUtensorMap x, wu, wg, wd;
};

#ifndef REPRO_SF_CUT
// breakdown variants (benchmarks/): 1 the loads alone, 2 + GEMM 1 and the
// hidden, 3 + GEMM 2 (the whole body without its epilogue)
#define REPRO_SF_CUT 0
#endif
constexpr int THREADS = 256;
constexpr int COLS = 256;       // output columns of a block
constexpr int BUDGET = 229376;  // dynamic shared memory of a block (the column scales beside)
constexpr int SLOTS_MAX = 16;
constexpr int SPLIT_MAX = 16;   // the f split is one cluster (non-portable above 8)
constexpr int TALL_ROWS = 128;
constexpr int SMALL_F = 128;    // f channels of a simt_small tile
constexpr int TALL_F = 64;      // of a simt_tall tile

template <typename W, int BM>
struct Geo {
  using Wt = W;
  static constexpr bool TALL = BM > 64;            // y in shared memory between tiles
  static constexpr int F = TALL ? TALL_F : SMALL_F;
  static constexpr int KC = BM <= 8 ? 64 : 16;     // K rows of a GEMM-1 item
  static constexpr int DC = 2 * KC * F / COLS;     // f rows of a Wd item (as many weights)
  static constexpr int N2 = F / DC;                // Wd items of a tile
  static constexpr int ES = static_cast<int>(sizeof(W));
  static constexpr int W_BYTES = 2 * KC * F * ES;  // Wu | Wg of an item, or its Wd rows
  static constexpr int LDX = KC;                   // x row (floats) of an item (where a
                                                   // warp reads two, 64 bytes apart)
  static constexpr int SLOT = W_BYTES + BM * LDX * 4;
  static constexpr int LDH = BM + 4;               // padded f row (floats) of the hidden
  static constexpr int H_BYTES = F * LDH * 4;
  static constexpr int Y_BYTES = TALL ? BM * COLS * 4 : 0;
  static constexpr int FIT = (BUDGET - H_BYTES - Y_BYTES - 8 * SLOTS_MAX) / SLOT;
  static constexpr int SLOTS = FIT < SLOTS_MAX ? FIT : SLOTS_MAX;
  static constexpr int BAR_OFF = H_BYTES + Y_BYTES + SLOTS * SLOT;  // a TMA barrier a slot
  static constexpr int BYTES = BAR_OFF + 8 * SLOTS;
  // GEMM 1: RT1 x CT1 threads, each TM1 rows (tr1 + i RT1) x TN1 channels in
  // NQ runs of QW (channel QW (tc1 + q CT1) + e), so that a warp's loads of
  // a run are contiguous
  static constexpr int PAIRS = BM * F / THREADS;
  static constexpr int TN1 = PAIRS < F / 16 ? PAIRS : F / 16;
  static constexpr int CT1 = F / TN1, RT1 = THREADS / CT1, TM1 = BM / RT1;
  static constexpr int QW = TN1 < 4 ? TN1 : 4, NQ = TN1 / QW;
  // GEMM 2: RT2 x CQ2 threads, each TM2 consecutive rows x QN2 column quads
  static constexpr int TM2 = BM >= 32 ? 8 : BM / 4, RT2 = BM / TM2;
  static constexpr int CQ2 = THREADS / RT2, QN2 = COLS / 4 / CQ2;
  static_assert(SLOTS >= 3, "a ring of at least three slots");
  static_assert(TALL || BM * COLS * 4 <= SLOTS * SLOT, "the partial reuses the ring");
  static_assert(RT1 * TM1 == BM && CT1 * TN1 == F, "GEMM 1 covers the tile");
  static_assert(RT2 * CQ2 == THREADS && CQ2 * QN2 == COLS / 4, "GEMM 2 covers the tile");
  // channel j of GEMM-1 thread column tc1
  static __device__ __forceinline__ int channel(int tc1, int j) {
    return QW * (tc1 + (j / QW) * CT1) + j % QW;
  }
};

// N consecutive weights as f32: floats as they are; int8 widened exactly
// (byte q ^ 0x80 under the exponent of 2^23 is the float 2^23 + q + 128,
// one subtraction leaves q)
template <int N>
__device__ __forceinline__ void ldw(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void ldw(const int8_t* p, float* v) {
  uint32_t q;
  if constexpr (N == 4)
    q = *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (N == 2)
    q = *reinterpret_cast<const uint16_t*>(p);
  else
    q = static_cast<uint8_t>(*p);
  q ^= 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
#pragma unroll
  for (int e = 0; e < N; ++e)
    v[e] = __fsub_rn(__uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 + e)), bias);
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const int8_t* p) {
  float v[4];
  ldw<4>(p, v);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// u, g += x @ Wu, x @ Wg over one GEMM-1 item
template <class G, bool GATED>
__device__ __forceinline__ void gemm1(const uint8_t* slot, int tr1, int tc1,
                                      float (&au)[G::TM1][G::TN1], float (&ag)[G::TM1][G::TN1]) {
  using W = typename G::Wt;
  const W* wu = reinterpret_cast<const W*>(slot);
  const W* wg = wu + G::KC * G::F;
  const float* xs = reinterpret_cast<const float*>(slot + G::W_BYTES);
#pragma unroll
  for (int k4 = 0; k4 < G::KC; k4 += 4) {
    float4 xv[G::TM1];
#pragma unroll
    for (int i = 0; i < G::TM1; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xs + (tr1 + i * G::RT1) * G::LDX + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float u[G::TN1], g[G::TN1];
#pragma unroll
      for (int q = 0; q < G::NQ; ++q) {
        const int off = (k4 + kk) * G::F + G::QW * (tc1 + q * G::CT1);
        ldw<G::QW>(wu + off, u + q * G::QW);
        if (GATED) ldw<G::QW>(wg + off, g + q * G::QW);
      }
#pragma unroll
      for (int i = 0; i < G::TM1; ++i) {
        const float a = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int j = 0; j < G::TN1; ++j) {
          au[i][j] = fmaf(a, u[j], au[i][j]);
          if (GATED) ag[i][j] = fmaf(a, g[j], ag[i][j]);
        }
      }
    }
  }
}

// the hidden of this thread's rows and channels (scale, bias, activation
// and gate in f32; channels at or past f give 0) into the f-major tile hs
template <class G>
__device__ __forceinline__ void hidden(float* hs, const float (&au)[G::TM1][G::TN1],
                                       const float (&ag)[G::TM1][G::TN1],
                                       const float (&p)[G::TN1][4], int live, int tr1, int tc1,
                                       bool gated, int act) {
  dispatch_act(act, [&](auto A) {
#pragma unroll
    for (int j = 0; j < G::TN1; ++j) {
      const int c = G::channel(tc1, j);
#pragma unroll
      for (int i = 0; i < G::TM1; ++i) {
        float h = 0.f;  // padded channels contribute exactly 0
        if (c < live) {
          const float u = __fadd_rn(__fmul_rn(au[i][j], p[j][0]), p[j][1]);
          h = gated ? __fmul_rn(activate(__fadd_rn(__fmul_rn(ag[i][j], p[j][2]), p[j][3]),
                                         A.value), u)
                    : activate(u, A.value);
        }
        hs[c * G::LDH + tr1 + i * G::RT1] = h;
      }
    }
  });
}

// y += h @ Wd over one Wd item (f rows dl0 .. dl0 + DC of the tile)
template <class G>
__device__ __forceinline__ void gemm2(const uint8_t* slot, const float* hs, int dl0, int tr2,
                                      int tc2, float (&acc)[G::TM2][4 * G::QN2]) {
  using W = typename G::Wt;
  const W* wd = reinterpret_cast<const W*>(slot);
#pragma unroll
  for (int dd = 0; dd < G::DC; ++dd) {
    const float* hrow = hs + (dl0 + dd) * G::LDH + tr2 * G::TM2;
    float hv[G::TM2];
    if constexpr (G::TM2 % 4 == 0) {
#pragma unroll
      for (int i = 0; i < G::TM2; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(hrow + i);
        hv[i] = v.x;
        hv[i + 1] = v.y;
        hv[i + 2] = v.z;
        hv[i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < G::TM2; ++i) hv[i] = hrow[i];
    }
    float4 w[G::QN2];
#pragma unroll
    for (int q = 0; q < G::QN2; ++q) w[q] = lds4(wd + dd * COLS + 4 * (tc2 + q * G::CQ2));
#pragma unroll
    for (int i = 0; i < G::TM2; ++i)
#pragma unroll
      for (int q = 0; q < G::QN2; ++q) {
        acc[i][4 * q] = fmaf(hv[i], w[q].x, acc[i][4 * q]);
        acc[i][4 * q + 1] = fmaf(hv[i], w[q].y, acc[i][4 * q + 1]);
        acc[i][4 * q + 2] = fmaf(hv[i], w[q].z, acc[i][4 * q + 2]);
        acc[i][4 * q + 3] = fmaf(hv[i], w[q].w, acc[i][4 * q + 3]);
      }
  }
}

// this thread's share of y (rows tr2 TM2 + i, column quads tc2 + q CQ2) at
// ys, a BM x 256 f32 tile: loaded (zero when `zero`) or stored
template <class G, bool STORE>
__device__ __forceinline__ void y_tile(float* ys, float (&acc)[G::TM2][4 * G::QN2], int tr2,
                                       int tc2, bool zero = false) {
#pragma unroll
  for (int i = 0; i < G::TM2; ++i)
#pragma unroll
    for (int q = 0; q < G::QN2; ++q) {
      float4* p = reinterpret_cast<float4*>(ys + (tr2 * G::TM2 + i) * COLS + 4 * (tc2 + q * G::CQ2));
      if (STORE) {
        *p = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
      } else {
        const float4 v = zero ? make_float4(0.f, 0.f, 0.f, 0.f) : *p;
        acc[i][4 * q] = v.x;
        acc[i][4 * q + 1] = v.y;
        acc[i][4 * q + 2] = v.z;
        acc[i][4 * q + 3] = v.w;
      }
    }
}

template <typename W, int BM>
__global__ void __launch_bounds__(THREADS, 1)
    fused_ffn_simt_kernel(const SArgs a, const __grid_constant__ SfMaps maps) {
  using G = Geo<W, BM>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float s_sd[COLS], s_bd[COLS];
  float* hs = reinterpret_cast<float*>(smem);
  float* ys = reinterpret_cast<float*>(smem + G::H_BYTES);
  uint8_t* ring = smem + G::H_BYTES + G::Y_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  const uint32_t ring_s = tc::smem_u32(ring);
  const int tid = threadIdx.x, n = blockIdx.y;
  const bool tma = a.tma != 0;
  const int r0 = blockIdx.z / a.n_chunks * BM, c0 = blockIdx.z % a.n_chunks * COLS;
  const bool gated = a.wg != nullptr;
  const int n_ft = (a.f + G::F - 1) / G::F;
  const int t0 = blockIdx.x * a.fpb, t1 = min(t0 + a.fpb, n_ft);
  const int n1 = (a.bi + G::KC - 1) / G::KC, per = n1 + G::N2;
  const int n_items = (t1 - t0) * per;
  const long wblk = static_cast<long>(n) * a.bi * a.f * G::ES;
  const auto* wub = static_cast<const uint8_t*>(a.wu) + wblk;
  const auto* wgb = gated ? static_cast<const uint8_t*>(a.wg) + wblk : wub;
  const auto* wdb = static_cast<const uint8_t*>(a.wd) + static_cast<long>(n) * a.f * a.bo * G::ES;
  const tc::Rows gx{reinterpret_cast<const uint8_t*>(a.x + static_cast<long>(n) * a.bi),
                    4L * a.nb * a.bi, a.m, 4 * a.bi, a.vec_x};
  for (int i = tid; i < COLS; i += THREADS) {
    const long pc = static_cast<long>(n) * a.bo + c0 + i;
    const bool in = c0 + i < a.bo;
    s_sd[i] = a.sd && in ? __ldg(a.sd + pc) : 1.f;
    s_bd[i] = a.bd && in ? __ldg(a.bd + pc) : 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < G::SLOTS; ++i) tc::bar_init(full + i, 1);
    tc::bar_init_fence();
  }
  __syncthreads();

  // item i of the block into slot i % SLOTS, zeros past every edge: by TMA
  // from one thread, completing on the slot's barrier, where every row is
  // 16-byte aligned; else by cp.async from every thread, one commit group
  // an item (empty past the last)
  auto issue = [&](int i) {
    if (tma) {
      if (tid != 0 || i >= n_items) return;
      const int j = i % per, f0 = (t0 + i / per) * G::F;
      const uint32_t s = ring_s + (i % G::SLOTS) * G::SLOT;
      const uint64_t* b = full + i % G::SLOTS;
      tc::fence_async_smem();  // the slot's last reads before the copy's writes
      if (j < n1) {
        tc::bar_expect(b, (gated ? 2 : 1) * G::KC * G::F * G::ES + BM * G::KC * 4);
        tc::tma_load(s, &maps.wu, f0, j * G::KC, n, b);
        if (gated) tc::tma_load(s + G::KC * G::F * G::ES, &maps.wg, f0, j * G::KC, n, b);
        tc::tma_load(s + G::W_BYTES, &maps.x, j * G::KC, n, r0, b);
      } else {
        tc::bar_expect(b, G::DC * COLS * G::ES);
        tc::tma_load(s, &maps.wd, c0, f0 + (j - n1) * G::DC, n, b);
      }
      return;
    }
    if (i < n_items) {
      const int j = i % per, f0 = (t0 + i / per) * G::F;
      const uint32_t s = ring_s + (i % G::SLOTS) * G::SLOT;
      if (j < n1) {
        const int k0 = j * G::KC;
        const long ld = static_cast<long>(a.f) * G::ES;
        const tc::Rows gu{wub + f0 * G::ES, ld, a.bi, (a.f - f0) * G::ES, a.vec_w};
        const tc::Rows gg{wgb + f0 * G::ES, ld, a.bi, (a.f - f0) * G::ES, a.vec_w};
        constexpr int WC = G::F * G::ES / 16, WN = G::KC * WC;  // chunks a row, an item
#pragma unroll
        for (int e = 0; e < (WN + THREADS - 1) / THREADS; ++e) {
          const int q = tid + e * THREADS, r = q / WC, c = q % WC;
          if (WN % THREADS == 0 || q < WN) {
            tc::copy_chunk(s + r * G::F * G::ES + 16 * c, gu, k0 + r, 16 * c);
            if (gated)
              tc::copy_chunk(s + (G::KC + r) * G::F * G::ES + 16 * c, gg, k0 + r, 16 * c);
          }
        }
        constexpr int XC = G::KC * 4 / 16, XN = BM * XC;
#pragma unroll
        for (int e = 0; e < (XN + THREADS - 1) / THREADS; ++e) {
          const int q = tid + e * THREADS, r = q / XC, c = q % XC;
          if (XN % THREADS == 0 || q < XN)
            tc::copy_chunk(s + G::W_BYTES + r * G::LDX * 4 + 16 * c, gx, r0 + r, 4 * k0 + 16 * c);
        }
      } else {
        const tc::Rows gd{wdb + (static_cast<long>(f0) * a.bo + c0) * G::ES,
                          static_cast<long>(a.bo) * G::ES, a.f - f0, (a.bo - c0) * G::ES,
                          a.vec_w};
        const int d0 = (j - n1) * G::DC;
        constexpr int DCH = COLS * G::ES / 16, DN = G::DC * DCH;
#pragma unroll
        for (int e = 0; e < (DN + THREADS - 1) / THREADS; ++e) {
          const int q = tid + e * THREADS, r = q / DCH, c = q % DCH;
          if (DN % THREADS == 0 || q < DN)
            tc::copy_chunk(s + r * COLS * G::ES + 16 * c, gd, d0 + r, 16 * c);
        }
      }
    }
    tc::cp_commit();
  };
#pragma unroll 1
  for (int i = 0; i < G::SLOTS - 1; ++i) issue(i);
  int it = 0;  // the next item to take
  // wait for item `it`, refill the slot the previous item left, hand it out
  auto take = [&]() {
    if (tma)
      tc::bar_wait(full + it % G::SLOTS, (it / G::SLOTS) & 1);
    else
      tc::cp_wait<G::SLOTS - 2>();
    __syncthreads();
    issue(it + G::SLOTS - 1);
    return static_cast<const uint8_t*>(ring + (it++ % G::SLOTS) * G::SLOT);
  };

  const int tr1 = tid / G::CT1, tc1 = tid % G::CT1, tr2 = tid / G::CQ2, tc2 = tid % G::CQ2;
  float acc[G::TM2][4 * G::QN2];
#pragma unroll
  for (int i = 0; i < G::TM2; ++i)
#pragma unroll
    for (int q = 0; q < 4 * G::QN2; ++q) acc[i][q] = 0.f;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const int f0 = t * G::F;
    // the up and gate scales and biases of this thread's channels
    float p[G::TN1][4];
#pragma unroll
    for (int j = 0; j < G::TN1; ++j) {
      const int fg = f0 + G::channel(tc1, j);
      const bool in = fg < a.f;
      const long pf = static_cast<long>(n) * a.f + fg;
      p[j][0] = a.su && in ? __ldg(a.su + pf) : 1.f;
      p[j][1] = a.bu && in ? __ldg(a.bu + pf) : 0.f;
      p[j][2] = a.sg && in ? __ldg(a.sg + pf) : 1.f;
      p[j][3] = a.bg && in ? __ldg(a.bg + pf) : 0.f;
    }
    float au[G::TM1][G::TN1], ag[G::TM1][G::TN1];
#pragma unroll
    for (int i = 0; i < G::TM1; ++i)
#pragma unroll
      for (int j = 0; j < G::TN1; ++j) au[i][j] = ag[i][j] = 0.f;
#pragma unroll 1
    for (int j = 0; j < n1; ++j) {
      const uint8_t* s = take();
      if (REPRO_SF_CUT != 1) {
        if (gated)
          gemm1<G, true>(s, tr1, tc1, au, ag);
        else
          gemm1<G, false>(s, tr1, tc1, au, ag);
      }
    }
    if (REPRO_SF_CUT != 1) hidden<G>(hs, au, ag, p, a.f - f0, tr1, tc1, gated, a.act);
    if constexpr (G::TALL) y_tile<G, false>(ys, acc, tr2, tc2, t == t0);
#pragma unroll 1
    for (int d = 0; d < G::N2; ++d) {
      const uint8_t* s = take();
      if (REPRO_SF_CUT == 0 || REPRO_SF_CUT == 3) gemm2<G>(s, hs, d * G::DC, tr2, tc2, acc);
    }
    if constexpr (G::TALL) y_tile<G, true>(ys, acc, tr2, tc2);
  }

  // ------------------------------------------------------------ epilogue
  // the block's f32 partial (simt_small: into the ring's bytes), then
  // s_down, b_down; with a split each block of the cluster adds a share of
  // the tile from all of the partials, in rank order
  tc::cp_wait<0>();
  __syncthreads();
  float* part = G::TALL ? ys : reinterpret_cast<float*>(ring);
  if constexpr (!G::TALL) y_tile<G, true>(part, acc, tr2, tc2);
  if (REPRO_SF_CUT != 0) {  // the cut variants keep their work alive and store nothing
    if (part[tid] == 1.2345e-38f && hs[tid] == 1.2345e-38f) a.y[0] = 0.f;
    return;
  }
  const long ldy = static_cast<long>(a.nb) * a.bo;
  const int rows = min(BM, a.m - r0);
  float* y0 = a.y + static_cast<long>(r0) * ldy + static_cast<long>(n) * a.bo + c0;
  const bool vec_y = a.bo % 4 == 0 && (reinterpret_cast<uintptr_t>(a.y) & 15) == 0;
  auto out = [&](int g, float4 v) {
    const int row = g / (COLS / 4), col = 4 * (g % (COLS / 4));
    if (c0 + col >= a.bo) return;
    const float o[4] = {__fadd_rn(__fmul_rn(v.x, s_sd[col]), s_bd[col]),
                        __fadd_rn(__fmul_rn(v.y, s_sd[col + 1]), s_bd[col + 1]),
                        __fadd_rn(__fmul_rn(v.z, s_sd[col + 2]), s_bd[col + 2]),
                        __fadd_rn(__fmul_rn(v.w, s_sd[col + 3]), s_bd[col + 3])};
    float* dst = y0 + row * ldy + col;
    if (vec_y && c0 + col + 4 <= a.bo) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + col + q < a.bo) dst[q] = o[q];
    }
  };
  if (a.split == 1) {
    __syncthreads();
    for (int g = tid; g < rows * (COLS / 4); g += THREADS)
      out(g, *reinterpret_cast<const float4*>(part + 4 * g));
    return;
  }
  tc::cluster_sync();
  tc::cluster_add<SPLIT_MAX>(tc::smem_u32(part), a.split, rows * (COLS / 4), out);
  tc::cluster_sync();  // the other blocks have read this block's partial
}

}  // namespace
}  // namespace sf

namespace {

template <bool INT8, bool SILU_GATED>
cudaError_t launch_tall(const tc::FArgs& a, cudaStream_t s) {
  tc::TallMaps maps{};
  if (a.tma) {  // every row 16-byte aligned
    // bf16 weights land swizzled in their slot; int8 as plain rows in a
    // landing buffer (Wd 128 columns a box), widened from there
    constexpr int es = INT8 ? 1 : 2;
    const long nb = a.nb, bi = a.bi, f = a.f, bo = a.bo;
    const long xd[3] = {bi, nb, a.m}, xs[2] = {2 * bi, 2 * nb * bi};
    const long ud[3] = {f, bi, nb}, us[2] = {es * f, es * bi * f};
    const long dd[3] = {bo, f, nb}, ds[2] = {es * bo, es * f * bo};
    const int xb[3] = {tc::TK, 1, 64}, wb[3] = {64, tc::TK, 1};
    const int db[3] = {INT8 ? tc::FT_HALF : 64, tc::TK, 1};
    if (!tc::tensor_map_nd(&maps.x, a.x, 2, 3, xd, xs, xb, true) ||
        !tc::tensor_map_nd(&maps.wu, a.wu, es, 3, ud, us, wb, !INT8) ||
        !tc::tensor_map_nd(&maps.wg, a.wg ? a.wg : a.wu, es, 3, ud, us, wb, !INT8) ||
        !tc::tensor_map_nd(&maps.wd, a.wd, es, 3, dd, ds, db, !INT8))
      return cudaErrorNotSupported;
  }
  const dim3 grid(a.split, a.nb, (a.m + tc::TT_ROWS - 1) / tc::TT_ROWS * a.n_chunks);
  return tc::launch_cluster(tc::fused_ffn_wg_kernel<INT8, SILU_GATED>, tc::TT_THREADS,
                            tc::tall_layout(a.bi, INT8).bytes, grid, dim3(a.split, 1, 1), s, a,
                            maps);
}

template <typename W, int BM>
cudaError_t launch_simt(const sf::SArgs& a, cudaStream_t s) {
  using G = sf::Geo<W, BM>;
  sf::SfMaps maps{};
  if (a.tma) {  // every row 16-byte aligned: the items' boxes by TMA, as stored
    const long es = G::ES, nb = a.nb, bi = a.bi, f = a.f, bo = a.bo;
    const long xd[3] = {bi, nb, a.m}, xs[2] = {4 * bi, 4 * nb * bi};
    const long ud[3] = {f, bi, nb}, us[2] = {es * f, es * bi * f};
    const long dd[3] = {bo, f, nb}, ds[2] = {es * bo, es * f * bo};
    const int xb[3] = {G::KC, 1, BM}, wb[3] = {G::F, G::KC, 1}, db[3] = {sf::COLS, G::DC, 1};
    if (!tc::tensor_map_nd(&maps.x, a.x, 4, 3, xd, xs, xb, false) ||
        !tc::tensor_map_nd(&maps.wu, a.wu, G::ES, 3, ud, us, wb, false) ||
        !tc::tensor_map_nd(&maps.wg, a.wg ? a.wg : a.wu, G::ES, 3, ud, us, wb, false) ||
        !tc::tensor_map_nd(&maps.wd, a.wd, G::ES, 3, dd, ds, db, false))
      return cudaErrorNotSupported;
  }
  const dim3 grid(a.split, a.nb, (a.m + BM - 1) / BM * a.n_chunks);
  return tc::launch_cluster(sf::fused_ffn_simt_kernel<W, BM>, sf::THREADS, G::BYTES, grid,
                            dim3(a.split, 1, 1), s, a, maps);
}

template <bool INT8>
cudaError_t launch_tc(const tc::FArgs& a, cudaStream_t s) {
  using L = tc::FfnSmem<INT8>;
  const dim3 grid(a.split, a.nb, (a.m + tc::FT_ROWS - 1) / tc::FT_ROWS * a.n_chunks);
  // the f split of a tile is one cluster
  return tc::launch_cluster(tc::fused_ffn_tc_kernel<INT8>, tc::FT_THREADS,
                            L::bytes(tc::ffn_slots(a.bi)), grid, dim3(a.split, 1, 1), s, a);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// route 0 (simt_f32, the first f32 body, run only when forced):
// x_dtype DT_F32; bm rows per block (4, 8, 16, 32 or 64). route 1 (tc):
// x_dtype DT_BF16; bm 16 rows per block (one mma row tile). route 2
// (tc_tall): x_dtype DT_BF16; bm 128 rows per block (two wgmma row tiles);
// loads by TMA when vec_x = vec_w = 16. route 3 (simt_small): x_dtype
// DT_F32; bm 4, 8, 16, 32 or 64. route 4 (simt_tall): x_dtype DT_F32; bm
// 128. vec_x / vec_w the copy width in bytes of the rows of x and of the
// weights. w_int8: 0 -> weights in x's dtype, 1 -> int8 (+ scales). wg, the
// scales and the biases may be null. split: blocks along f, each owning fpb
// f tiles of 64 (routes 1-4: the split is a cluster, at most 16 blocks,
// each owning at least one tile). simt_f32 only: part, split * m * nb * bo
// f32 (unused when split == 1), and counters, one int per (m tile, column
// chunk, block), zero on entry and left zero; vec: its weight rows take
// 4-element copies. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fused_ffn_launch(const void* x, const void* wu, const void* wg, const void* wd,
                                const float* su, const float* sg, const float* sd,
                                const float* bu, const float* bg, const float* bd, void* y,
                                float* part, int* counters, int m, int nb, int bi, int f, int bo,
                                int x_dtype, int w_int8, int act, int route, int bm, int split,
                                int fpb, int vec, int vec_x, int vec_w, void* stream) {
  cudaGetLastError();  // clear a stale error so the one returned is this launch's
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || nb <= 0 || bi <= 0 || f <= 0 || bo <= 0 || split <= 0 || fpb <= 0) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1) {
    if (x_dtype != DT_BF16 || !tc::vec_ok(vec_x) || !tc::vec_ok(vec_w)) return bad;
    const int n_chunks = (bo + tc::FT_COLS - 1) / tc::FT_COLS;
    if (split > 16) return bad;
    if (bm != tc::FT_ROWS) return bad;
    const tc::FArgs a{static_cast<const __nv_bfloat16*>(x), wu, wg, wd, su, sg, sd, bu, bg, bd,
                      static_cast<__nv_bfloat16*>(y), m, nb, bi, f, bo, act, split, fpb, n_chunks,
                      vec_x, vec_w};
    err = w_int8 ? launch_tc<true>(a, s) : launch_tc<false>(a, s);
  } else if (route == 2) {
    if (x_dtype != DT_BF16 || !tc::vec_ok(vec_x) || !tc::vec_ok(vec_w)) return bad;
    const int n_chunks = (bo + tc::FT_COLS - 1) / tc::FT_COLS;
    const int n_ft = (f + tc::FT_F - 1) / tc::FT_F;
    if (bm != tc::TT_ROWS || split > tc::CLUSTER_SPLIT_MAX || (split - 1) * fpb >= n_ft ||
        split * fpb < n_ft)
      return bad;
    const int tma = vec_x == 16 && vec_w == 16;
    const tc::FArgs a{static_cast<const __nv_bfloat16*>(x), wu, wg, wd, su, sg, sd, bu, bg, bd,
                      static_cast<__nv_bfloat16*>(y), m, nb, bi, f, bo, act, split, fpb, n_chunks,
                      vec_x, vec_w, tma};
    // gated silu (SwiGLU, every olmo-1b FFN) on a branch-free hidden
    if (wg != nullptr && act == ACT_SILU && !REPRO_TALL_GENERIC)
      err = w_int8 ? launch_tall<true, true>(a, s) : launch_tall<false, true>(a, s);
    else
      err = w_int8 ? launch_tall<true, false>(a, s) : launch_tall<false, false>(a, s);
  } else if ((route == 3 || route == 4) && x_dtype == DT_F32) {
    const int n_ft = (f + (route == 4 ? sf::TALL_F : sf::SMALL_F) - 1) /
                     (route == 4 ? sf::TALL_F : sf::SMALL_F);
    if (!tc::vec_ok(vec_x) || !tc::vec_ok(vec_w) || split > sf::SPLIT_MAX ||
        (split - 1) * fpb >= n_ft || split * fpb < n_ft || (route == 4) != (bm == sf::TALL_ROWS))
      return bad;
    const sf::SArgs a{static_cast<const float*>(x), wu, wg, wd, su, sg, sd, bu, bg, bd,
                      static_cast<float*>(y), m, nb, bi, f, bo, act, split, fpb,
                      (bo + sf::COLS - 1) / sf::COLS, vec_x, vec_w,
                      vec_x == 16 && vec_w == 16};
#define REPRO_SF(BM_) \
  err = w_int8 ? launch_simt<int8_t, BM_>(a, s) : launch_simt<float, BM_>(a, s)
    switch (bm) {
      case 4: REPRO_SF(4); break;
      case 8: REPRO_SF(8); break;
      case 16: REPRO_SF(16); break;
      case 32: REPRO_SF(32); break;
      case 64: REPRO_SF(64); break;
      case sf::TALL_ROWS: REPRO_SF(sf::TALL_ROWS); break;
      default: return bad;
    }
#undef REPRO_SF
  } else if (route == 0 && x_dtype == DT_F32) {
    if ((bm != 4 && bm != 8 && bm != 16 && bm != 32 && bm != 64) ||
        (split > 1 && (part == nullptr || counters == nullptr)))
      return bad;
    if (w_int8)
      err = launch<float, int8_t>(x, wu, wg, wd, su, sg, sd, bu, bg, bd, y, part, counters, m,
                                  nb, bi, f, bo, bm, act, split, fpb, vec, s);
    else
      err = launch<float, float>(x, wu, wg, wd, su, sg, sd, bu, bg, bd, y, part, counters, m,
                                 nb, bi, f, bo, bm, act, split, fpb, vec, s);
  } else {
    return bad;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `split` blocks of the SIMT body (route 3 or 4, bm
// rows, int8 or fp weights) the card can run at once (0 on error).
extern "C" int fused_ffn_max_clusters(int route, int bm, int w_int8, int split) {
  int n = 0;
#define REPRO_SF_Q(W_, BM_)                                                                 \
  {                                                                                          \
    auto* kern = sf::fused_ffn_simt_kernel<W_, BM_>;                                         \
    constexpr int bytes = sf::Geo<W_, BM_>::BYTES;                                           \
    if (tc::prepare(kern, bytes, split) != cudaSuccess) return 0;                            \
    cudaLaunchConfig_t cfg = {};                                                             \
    cfg.gridDim = dim3(split, 1, 1);                                                         \
    cfg.blockDim = dim3(sf::THREADS);                                                        \
    cfg.dynamicSmemBytes = bytes;                                                            \
    cudaLaunchAttribute attr[1];                                                             \
    attr[0].id = cudaLaunchAttributeClusterDimension;                                        \
    attr[0].val.clusterDim.x = split;                                                        \
    attr[0].val.clusterDim.y = 1;                                                            \
    attr[0].val.clusterDim.z = 1;                                                            \
    cfg.attrs = attr;                                                                        \
    cfg.numAttrs = 1;                                                                        \
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) n = 0;                \
  }
#define REPRO_SF_QB(BM_)          \
  if (w_int8) {                   \
    REPRO_SF_Q(int8_t, BM_)       \
  } else {                        \
    REPRO_SF_Q(float, BM_)        \
  }
  cudaGetLastError();
  if ((route != 3 && route != 4) || split < 1 || split > sf::SPLIT_MAX) return 0;
  switch (bm) {
    case 4: REPRO_SF_QB(4); break;
    case 8: REPRO_SF_QB(8); break;
    case 16: REPRO_SF_QB(16); break;
    case 32: REPRO_SF_QB(32); break;
    case 64: REPRO_SF_QB(64); break;
    case sf::TALL_ROWS: REPRO_SF_QB(sf::TALL_ROWS); break;
    default: return 0;
  }
#undef REPRO_SF_QB
#undef REPRO_SF_Q
  cudaGetLastError();
  return n;
}

extern "C" const char* fused_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
