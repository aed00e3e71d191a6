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
// The hidden h stays in shared memory, in f32: it never reaches device
// memory.
//
// What bounds it on the H100: the weight stream. At olmo-1b's full width
// (nb 8, bi 256, f 1024, bo 256) the three int8 projections are 6.3 MB, 1.9
// us at 3.35 TB/s, at decode (m = 4) as at one prefill chunk (m = 64). The
// TPU carries the down-projection sum across a sequential f grid axis in
// VMEM; a CUDA block has no such carry, and one block per (m tile, block n)
// would stream 6.3 MB through only 8 SMs. So the f axis is split across
// blocks: block (s, n, m tile) computes the hidden of its f tiles and their
// contribution to y_n, f32 partial sums go to a workspace, and the last
// block of each (m tile, n) to finish (an atomic ticket) sums the partials
// in the fixed order s = 0, 1, ... and runs the epilogue. The result is
// deterministic and the grid fills the card (128 blocks at the shapes
// above). With one split the block writes y directly.
//
// Inside a block: the weight tiles are copied into shared memory as stored
// (int8, bf16 or f32) with cp.async, every thread issuing all its copies
// before waiting once, so a block's weights arrive in one round trip per K
// chunk rather than one per load (at decode the loads, not the FMAs, set
// the time). GEMM 1 takes the up/gate tiles (f tile of 64 channels) in K
// chunks of 128 with x staged in f32 and accumulates u and g in registers;
// the epilogue writes h (BM x 64) to shared memory; GEMM 2 adds h @ Wd,
// whose whole 64 x 256 tile was copied during GEMM 1, into a BM x 256
// register tile of y that lives across the block's f tiles. This first
// version is f32 SIMT; tensor cores, TMA and wgmma are later work. Ragged
// m, bi, f and bo are bounds-checked in the kernel: padded f channels give
// h = 0 and read zero rows of Wd, so they contribute exactly 0.

#include "common.cuh"

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
}  // namespace repro_torch

using namespace repro_torch;

// x_dtype: DT_F32 or DT_BF16; w_int8: 0 -> weights in x's dtype, 1 -> int8
// (+ scales). wg, the scales and the biases may be null. bm: rows per block
// (4, 8, 16, 32 or 64); split: blocks along f, each owning fpb f tiles of 64;
// part: split * m * nb * bo f32 (unused when split == 1); counters: one int
// per (m tile, column chunk, block), zero on entry and left zero.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_ffn_launch(const void* x, const void* wu, const void* wg, const void* wd,
                                const float* su, const float* sg, const float* sd,
                                const float* bu, const float* bg, const float* bd, void* y,
                                float* part, int* counters, int m, int nb, int bi, int f, int bo,
                                int x_dtype, int w_int8, int act, int bm, int split, int fpb,
                                int vec, void* stream) {
  cudaGetLastError();  // clear a stale error so the one returned is this launch's
  if (m <= 0 || nb <= 0 || bi <= 0 || f <= 0 || bo <= 0 || split <= 0 || fpb <= 0 ||
      (bm != 4 && bm != 8 && bm != 16 && bm != 32 && bm != 64) ||
      (split > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == DT_BF16) {
    if (w_int8)
      err = launch<__nv_bfloat16, int8_t>(x, wu, wg, wd, su, sg, sd, bu, bg, bd, y, part,
                                          counters, m, nb, bi, f, bo, bm, act, split, fpb, vec,
                                          s);
    else
      err = launch<__nv_bfloat16, __nv_bfloat16>(x, wu, wg, wd, su, sg, sd, bu, bg, bd, y, part,
                                                 counters, m, nb, bi, f, bo, bm, act, split,
                                                 fpb, vec, s);
  } else if (x_dtype == DT_F32) {
    if (w_int8)
      err = launch<float, int8_t>(x, wu, wg, wd, su, sg, sd, bu, bg, bd, y, part, counters, m,
                                  nb, bi, f, bo, bm, act, split, fpb, vec, s);
    else
      err = launch<float, float>(x, wu, wg, wd, su, sg, sd, bu, bg, bd, y, part, counters, m,
                                 nb, bi, f, bo, bm, act, split, fpb, vec, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
