// Block-diagonal matmul for Hopper (sm_90a): the MPDCompress inference op
// and the packed training path's forward and input gradient.
//
// Replaces the Pallas TPU bodies in src/repro/kernels/bdmm.py:
//   _bdmm_kernel         (general grid, K accumulated over grid steps)
//   _bdmm_decode_kernel  (decode-shaped grid, m <= 32, full K per step)
//
// For packed inputs x (m, nb*k) and packed diagonal blocks w:
//   y[:, n*N:(n+1)*N] = act(x[:, n*k:(n+1)*k] @ B_n (* scale[n]) + b[n])
// with B_n = w[n] for w (nb, k, N), or B_n = w[n]^T for w (nb, N, k) (the
// transposed-blocks orientation: the input gradient dx = g @ blockdiag(w)^T
// reads w as stored, no transposed copy). w is the activation type (f32 /
// bf16) or int8 with a per-output-channel f32 scale (nb, N). Products
// accumulate in f32; the epilogue runs scale -> bias -> activation -> cast,
// the reference's order. kernels/bdmm.py::plan picks the body:
//
// * decode_tc (bf16 x, m <= 32, forward): the weight stream. The int8
//   blocks of one olmo-1b decode step are ~147 MB, ~44 us at 3.35 TB/s; the
//   activations are a few KB, and the products (a few GFLOP) are far below
//   the tensor cores' rate. So the time is round trips: how many weight
//   bytes are in flight at once, and how few dependent memory trips follow
//   them. A block owns 64 output channels of one diagonal block over a K
//   range of up to 256 rows: its whole slice (4 stages of 64 rows; deeper K
//   is split over blocks, by a plan that depends on (nb, K, N) alone) and
//   its token rows are requested with 16-byte cp.async copies before the
//   first product, its scales and biases read meanwhile. The products run
//   on mma.sync.m16n8k16 with channels on the 16-row side and tokens on the
//   n8 side, so m pads only to 8 (mma.sync rather than wgmma: at m <= 32
//   the work is far below the rate, and its fragments need no descriptors);
//   int8 is widened to bf16 in registers by byte permutes, exactly. The
//   output tile is staged in shared memory and leaves in 16-byte stores.
//   A K split is one cluster: each block leaves its f32 partial in shared
//   memory and, after a cluster barrier, adds a share of the tile from all
//   of them in the fixed order rank 0, 1, ... (no workspace round trip, no
//   float atomics, one launch).
// * decode_simt, simt_small and simt_f32 (f32 x: the parity routes of the
//   exact phases and the paper's LeNet path): exact f32, FFMA on the CUDA
//   cores (no TF32: the parity routes' tolerances would not hold), on the
//   machinery simt.cuh shares with the masked matmul's f32 bodies.
//   - small (decode_simt: the forward at m <= 32; simt_small: the transposed
//     form at m <= 64, and the forward above 32 rows where a 128-channel
//     tile would be mostly idle or the rows fit one 64-row tile: LeNet's
//     blocks have N of 1 to 75 and K <= 200). Bound by latency, not by bytes
//     or products: LeNet's blocks are a few KB and a few MFLOP, and the
//     olmo-1b parity shapes at m <= 64 a few MB at most. A block owns 32
//     output channels of one diagonal block over one K range of a split.
//     Its whole range (up to 256 rows of K, 8 stages) and its x rows are
//     requested with cp.async before the first product, 16 bytes a copy
//     where the rows allow and the widest piece they do where not (LeNet
//     rows of 30, 75 or 5 floats), int8 as stored and widened on chip; so
//     the block pays about one memory round trip. decode_simt keeps all
//     m rows of a channel in one thread's registers and splits the stages'
//     groups of 4 k over its four warps, whose partials it adds in a fixed
//     order; simt_small takes a 64-row tile, 4 x 4 outputs a thread over
//     the whole range (8 shared-memory reads for 64 FFMA, no warp sum: on
//     decode_simt's layout at 64 rows the warp sum and stores took 1.5-3.3
//     us at m = 50, and the products 4.7 of 17 us at LeNet's m = 2048; H100
//     80GB HBM3, 700 W, benchmarks/torch_bdmm.py --mode f32_breakdown). K
//     is split over the z blocks of a cluster of up to 16, added over DSMEM
//     in rank order:
//     by simt_small where one row tile's blocks leave SMs idle (LeNet's
//     batch of 50: 10 diagonal blocks), by decode_simt only past 256 rows
//     of K (at batch 1 a split ran slower than none). decode_simt's plan
//     depends on (nb, K, N) alone and no arithmetic on m, so row r of an
//     m-row call is bit for bit row r of the same input cut to fewer rows
//     (the speculative verify windows rely on it).
//   - tiled (simt_f32: wide blocks whose tiles fill the card, the speedup
//     layer's (8, 256, 256) at 512 and 2048 tokens, forward and dx). Bound
//     by FFMA issue (2.15 GFLOP at m = 2048: 0.032 ms at 67 TFLOP/s). The
//     pipelined 128 x 128 tile, 8 x 4 a thread (512 threads), one block an
//     SM, with the diagonal block a grid axis; K is split over a cluster of
//     up to 4 where the tiles leave SMs idle (m = 512: 64 tiles).
// * tc (bf16 x and w above 32 rows, and the transposed form at any m, where
//   TMA can read the rows: packed training at 4 x 512 tokens, forward and
//   dx, and bf16 prefill chunks). At olmo-1b's packed shapes (K 256 or 1024,
//   N 256-6288 a block) the output or the gradient input dominates the bytes
//   (up/gate at m = 2048: 46 MB, 0.0138 ms at 3.35 TB/s) and K is only 4-16
//   steps of 64, so a tile's epilogue weighs as much as its loads. One
//   persistent block an SM walks the 128 token x 128 channel tiles of every
//   diagonal block: a producer thread loads each K step with TMA through
//   3-D tensor maps, x as (m, nb, k) and w as (nb, k, N) or (nb, N, k), so a
//   block's K edge is a tensor edge and TMA zero-fills past it (a 2-D box at
//   column n*k + k0 would read the next block's columns when k is no
//   multiple of 64), into a 6-stage ring that it keeps full across tile
//   boundaries; two consumer warpgroups run wgmma m64n128k16 (x K-major; w
//   MN-major forward, K-major transposed) and hand stages back by mbarrier.
//   A consumer stages its bf16 rows in a 128-byte-swizzled buffer and one
//   thread writes them with TMA stores through y seen as (m, nb, N), which
//   clip at the block's N columns and at m; the warpgroup goes on to the
//   next tile while the store drains. Staging and storing inline cost two
//   thirds of the time at K = 256 (the loads stalled behind them).
// * tc_small_m (bf16 x with int8 w above 32 rows - the served prefill
//   chunk is 64 tokens - and rows TMA refuses): A and B swap, the 64 output
//   channels take wgmma's 64-row side and 64 tokens its N side (m64n64k16,
//   rows past m zero), so no token row is padded. One warpgroup copies each
//   K step with cp.async (the widest piece the rows allow) into 4 stages;
//   each thread widens the int8 pieces it copied to bf16 in the swizzled
//   layout (exact: |q| <= 127) and fences them for the async proxy before
//   the one barrier of the step publishes the stage. The scale is applied in
//   the epilogue, per output channel. Where the tiles fill under half the
//   SMs, K is split over blocks and a second pass adds the f32 partial sums
//   in the fixed order s = 0, 1, ... (no float atomics).
// Ragged m / N / K edges are zero-filled by the copies or masked in-kernel;
// nothing is padded or copied outside the kernels. Every sum is added in a
// fixed order, so results do not depend on the blocks' order.

#include <type_traits>

#include "simt.cuh"

// Breakdown variants (benchmarks/torch_bdmm.py) of decode_tc and the small
// f32 bodies: 1 the loads alone (every copy issued and waited for), 2 + the
// products (kept in shared memory only), 3 (the small f32 bodies) nothing:
// the launch alone.
#ifndef REPRO_CUT
#define REPRO_CUT 0
#endif

namespace repro_torch {
namespace {

// routes (kernels/bdmm.py ROUTES)
enum Route {
  ROUTE_DECODE_SIMT = 0,
  ROUTE_SIMT_F32 = 1,
  ROUTE_TC = 2,
  ROUTE_TC_SMALL_M = 3,
  ROUTE_DECODE_TC = 4,
  ROUTE_SIMT_SMALL = 5
};

}  // namespace

// ==================================================== SIMT bodies (f32)
namespace simt {
namespace {

struct BArgs {
  const float* x;      // (m, nb * k)
  const void* w;       // (nb, k, n), or (nb, n, k) transposed; f32 or int8
  const float* scale;  // (nb, n) for int8 w, else null
  const float* bias;   // (nb * n,) or null
  float* y;            // (m, nb * n)
  int m, nb, k, n, act;
  int split, k_chunk;  // K split over the z blocks of one cluster, the K range of each
  int vec_x, vec_w;    // copy width in bytes of the rows of x and w
};

// scale -> bias -> activation of packed output channel p, each step rounded
// on its own so that no call site contracts it differently
__device__ __forceinline__ float out1(const BArgs& a, long p, float v) {
  if (a.scale) v = __fmul_rn(v, __ldg(a.scale + p));
  if (a.bias) v = __fadd_rn(v, __ldg(a.bias + p));
  return activate(v, a.act);
}

// y[r, blk * n + c .. + 3], the channels below n: one 16-byte store where
// the row allows it
__device__ __forceinline__ void store4(const BArgs& a, int blk, int r, int c, float4 v) {
  const long p = static_cast<long>(blk) * a.n + c;
  float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (c + q < a.n) o[q] = out1(a, p + q, o[q]);
  float* dst = a.y + static_cast<long>(r) * a.nb * a.n + p;
  if (a.n % 4 == 0 && c + 4 <= a.n) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c + q < a.n) dst[q] = o[q];
  }
}

// ------------------------------------------------------ the ring (small)
// The two small bodies stage K in steps of SM_TK rows through a ring of
// SS_STAGES cp.async stages, the whole range of a split (up to 256 rows)
// requested before the first product; deeper ranges cycle through it. A
// stage holds the W tile first - f32 as simt.cuh lays it out (k-major rows
// of SM_NC channels, channel-major rows of SM_XLD floats transposed), int8
// as stored (SM_TK rows of SM_NC bytes) - then the x rows. simt_small,
// whose 16 row groups all read each weight, widens an int8 tile once a
// stage into an f32 tile after the ring (SS_WIDE bytes), in the f32
// forward layout (int-to-float conversions run at an eighth of the FFMA
// rate); decode_simt's weights are each read by one lane, which widens it.
constexpr int SS_THREADS = 128, SS_WARPS = SS_THREADS / 32;
constexpr int SS_STAGES = 8;   // a whole range of 256 rows of K in flight

constexpr int SS_WIDE = SM_TK * SM_NC * 4;

template <bool INT8>
__host__ __device__ constexpr int ring_w() { return INT8 ? SM_TK * SM_NC : SM_NC * SM_XLD * 4; }

// The W tile of the stage at st as f32: an int8 tile widened by the whole
// block into `wide` (exact: every int8 value is an f32 value), then a
// barrier; an f32 tile as it landed.
template <bool INT8>
__device__ __forceinline__ const float* stage_w(const uint8_t* st, float* wide, int tid) {
  if constexpr (!INT8) {
    return reinterpret_cast<const float*>(st);
  } else {
    for (int i = tid; i < SM_TK * SM_NC / 4; i += SS_THREADS) {
      const uint32_t w4 = reinterpret_cast<const uint32_t*>(st)[i];
      reinterpret_cast<float4*>(wide)[i] =
          make_float4(static_cast<float>(static_cast<int8_t>(w4 & 0xFFu)),
                      static_cast<float>(static_cast<int8_t>((w4 >> 8) & 0xFFu)),
                      static_cast<float>(static_cast<int8_t>((w4 >> 16) & 0xFFu)),
                      static_cast<float>(static_cast<int8_t>(w4 >> 24)));
    }
    __syncthreads();
    return wide;
  }
}

// Issue this thread's copies of the W tile of the stage at st: SM_NC
// channels from ch0 over K rows [k0, k0 + SM_TK), zero past ke and n.
template <bool TRANS, bool INT8>
__device__ __forceinline__ void issue_w(const BArgs& a, uint32_t st, const uint8_t* wb, int ch0,
                                        int k0, int ke, int tid) {
  if constexpr (INT8) {  // k row kk as stored: two pieces of 16 channels
    for (int i = tid; i < SM_TK * 2; i += SS_THREADS) {
      const int kk = k0 + i / 2, ch = ch0 + 16 * (i % 2);
      const int valid = kk < ke ? min(max(a.n - ch, 0), 16) : 0;
      copy16(st + 16 * i, wb + static_cast<long>(kk) * a.n + ch, wb, valid, a.vec_w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < SM_TK * SM_NC / 4 / SS_THREADS; ++i) {
      const int p = tid + i * SS_THREADS;
      int valid;
      long off;
      if (TRANS) {  // channel row cr, k from kk
        const int cr = p / (SM_TK / 4), kk = k0 + 4 * (p % (SM_TK / 4)), ch = ch0 + cr;
        valid = ch < a.n ? min(max(ke - kk, 0), 4) : 0;
        off = static_cast<long>(ch) * a.k + kk;
      } else {      // k row kk, channels from ch
        const int kk = k0 + p / (SM_NC / 4), ch = ch0 + 4 * (p % (SM_NC / 4));
        valid = kk < ke ? min(max(a.n - ch, 0), 4) : 0;
        off = static_cast<long>(kk) * a.n + ch;
      }
      copy16(st + small_w_off<TRANS>(p), wb + 4 * off, wb, 4 * valid, a.vec_w);
    }
  }
}

// ---------------------------------------------------------------- decode
// route decode_simt (forward, m <= 32). A block owns SM_NC output channels
// (lane l: channel l) of diagonal block blockIdx.y for all m rows (MT: the
// power of two that holds them, every row in registers) over split
// blockIdx.z's K range. Warp w takes k = 4q .. 4q + 3 of every stage for q
// = w, w + 4: one fma chain per output in increasing k; the four warps'
// partials are then added in the order 0, 1, 2, 3. A row's arithmetic does
// not depend on MT, so row r is bit for bit the same at every m.
template <bool INT8>
__host__ __device__ constexpr int decode_stage(int mt) { return ring_w<INT8>() + mt * SM_TK * 4; }

template <bool INT8, int MT>
__global__ void __launch_bounds__(SS_THREADS) bdmm_simt_decode_kernel(const BArgs a) {
  constexpr int ES = INT8 ? 1 : 4, W = ring_w<INT8>(), STAGE = decode_stage<INT8>(MT);
  constexpr int QUADS = SM_TK / 4 / SS_WARPS;  // groups of 4 k a warp takes from a stage
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t s0 = tc::smem_u32(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch0 = blockIdx.x * SM_NC, blk = blockIdx.y, z = blockIdx.z;
  const int kb = z * a.k_chunk, ke = min(a.k, kb + a.k_chunk);
  const int steps = (ke - kb + SM_TK - 1) / SM_TK;
  const int slots = min(SS_STAGES, (a.k_chunk + SM_TK - 1) / SM_TK);
  const long ldx = 4L * a.nb * a.k;  // bytes between rows of x
  const auto* xb = reinterpret_cast<const uint8_t*>(a.x) + 4L * blk * a.k;
  const auto* wb = static_cast<const uint8_t*>(a.w) + static_cast<long>(blk) * a.k * a.n * ES;
  auto issue = [&](int t) {
    const uint32_t st = s0 + (t % slots) * STAGE;
    const int k0 = kb + t * SM_TK;
    for (int i = tid; i < a.m * (SM_TK / 4); i += SS_THREADS) {  // x: row r, k from kk
      const int r = i / (SM_TK / 4), kk = k0 + 4 * (i % (SM_TK / 4));
      copy16(st + W + 16 * i, xb + r * ldx + 4L * kk, xb, 4 * min(max(ke - kk, 0), 4),
                 a.vec_x);
    }
    issue_w<false, INT8>(a, st, wb, ch0, k0, ke, tid);
  };

  if (REPRO_CUT == 3) return;
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;
#pragma unroll 1
  for (int t = 0; t < SS_STAGES; ++t) {
    if (t < min(steps, slots)) issue(t);
    tc::cp_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    tc::cp_wait<SS_STAGES - 1>();
    __syncthreads();
    const uint8_t* st = smem + (t % slots) * STAGE;
    const float* xs = reinterpret_cast<const float*>(st + W);
#pragma unroll
    for (int h = 0; h < (REPRO_CUT == 1 ? 0 : QUADS); ++h) {
      const int q = warp + SS_WARPS * h;
      float wv[4];  // int8: each weight is read, and widened, by one lane alone
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (4 * q + e) * SM_NC + lane;
        wv[e] = INT8 ? static_cast<float>(reinterpret_cast<const int8_t*>(st)[i])
                     : reinterpret_cast<const float*>(st)[i];
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * SM_TK + 4 * q);
        acc[r] = fmaf(xv.x, wv[0], acc[r]);
        acc[r] = fmaf(xv.y, wv[1], acc[r]);
        acc[r] = fmaf(xv.z, wv[2], acc[r]);
        acc[r] = fmaf(xv.w, wv[3], acc[r]);
      }
    }
    if (t + slots < steps) {  // the ring turns: every warp is done with this stage
      __syncthreads();
      issue(t + slots);
    }
    tc::cp_commit();
  }

  // The warps' partials added in the order 0, 1, 2, 3; with a split, the
  // block's sum then goes to the cluster, whose blocks each add a share of
  // the tile from all of them in rank order.
  __syncthreads();  // every warp is done with the ring
  float* part = reinterpret_cast<float*>(smem);  // [SS_WARPS][MT][SM_NC]
  if (REPRO_CUT != 0) {  // a breakdown variant: the products kept in shared memory only
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < MT; ++r) v += acc[r];
    part[tid] = v;
    return;
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) part[(warp * MT + r) * SM_NC + lane] = acc[r];
  __syncthreads();
  float* sum = part + SS_WARPS * MT * SM_NC;     // [m][SM_NC]
  for (int i = tid; i < a.m * SM_NC; i += SS_THREADS) {
    const int r = i / SM_NC, c = i % SM_NC;
    float v = part[r * SM_NC + c];
#pragma unroll
    for (int w = 1; w < SS_WARPS; ++w) v = __fadd_rn(v, part[(w * MT + r) * SM_NC + c]);
    if (a.split > 1) {
      sum[i] = v;
    } else if (ch0 + c < a.n) {
      const long p = static_cast<long>(blk) * a.n + ch0 + c;
      a.y[static_cast<long>(r) * a.nb * a.n + p] = out1(a, p, v);
    }
  }
  if (a.split == 1) return;
  tc::cluster_sync();
  tc::cluster_add<CLUSTER_MAX>(tc::smem_u32(sum), a.split, a.m * SM_NC / 4, [&](int g, float4 v) {
    const int c = ch0 + 4 * (g % (SM_NC / 4));
    if (c < a.n) store4(a, blk, g / (SM_NC / 4), c, v);
  });
  tc::cluster_sync();  // the other blocks have read this block's partial
}

// ----------------------------------------------------------------- small
// route simt_small: a 64-row x 32-channel tile of diagonal block
// blockIdx.y (blockIdx.z = token tile * split + z) over split z's K range,
// 4 x 4 outputs a thread: rows g + 16 i (g = tid / 8), channels 4h .. 4h +
// 3 forward and h + 8j transposed (h = tid % 8), so that a quarter-warp's
// 16-byte reads of x rows (padded to ST_XLD floats) and of W's channel
// rows fall in distinct banks. A group of 4 k costs 8 reads of shared
// memory for 64 FFMA, and each output is one fma chain in increasing k:
// no warp sum.
constexpr int ST_ROWS = 64;
constexpr int ST_XLD = SM_TK + 4;  // padded x row

template <bool INT8>
__host__ __device__ constexpr int small_stage() { return ring_w<INT8>() + ST_ROWS * ST_XLD * 4; }

template <bool TRANS, bool INT8>
__global__ void __launch_bounds__(SS_THREADS) bdmm_simt_small_kernel(const BArgs a) {
  static_assert(!(TRANS && INT8), "int8 blocks run forward only");
  constexpr int ES = INT8 ? 1 : 4, W = ring_w<INT8>(), STAGE = small_stage<INT8>();
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t s0 = tc::smem_u32(smem);
  const int tid = threadIdx.x, g = tid / 8, h = tid % 8;
  const int ch0 = blockIdx.x * SM_NC, blk = blockIdx.y;
  const int tok0 = (blockIdx.z / a.split) * ST_ROWS, z = blockIdx.z % a.split;
  const int rows = min(ST_ROWS, a.m - tok0);
  const int kb = z * a.k_chunk, ke = min(a.k, kb + a.k_chunk);
  const int steps = (ke - kb + SM_TK - 1) / SM_TK;
  const int slots = min(SS_STAGES, (a.k_chunk + SM_TK - 1) / SM_TK);
  const long ldx = 4L * a.nb * a.k;  // bytes between rows of x
  const auto* xb = reinterpret_cast<const uint8_t*>(a.x) + tok0 * ldx + 4L * blk * a.k;
  const auto* wb = static_cast<const uint8_t*>(a.w) + static_cast<long>(blk) * a.k * a.n * ES;
  float* wide = reinterpret_cast<float*>(smem + slots * STAGE);
  auto issue = [&](int t) {
    const uint32_t st = s0 + (t % slots) * STAGE;
    const int k0 = kb + t * SM_TK;
    for (int i = tid; i < rows * (SM_TK / 4); i += SS_THREADS) {  // x: row r, k from kk
      const int r = i / (SM_TK / 4), q = i % (SM_TK / 4), kk = k0 + 4 * q;
      copy16(st + W + 4 * (r * ST_XLD + 4 * q), xb + r * ldx + 4L * kk, xb,
                 4 * min(max(ke - kk, 0), 4), a.vec_x);
    }
    issue_w<TRANS, INT8>(a, st, wb, ch0, k0, ke, tid);
  };

  if (REPRO_CUT == 3) return;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int t = 0; t < SS_STAGES; ++t) {
    if (t < min(steps, slots)) issue(t);
    tc::cp_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    tc::cp_wait<SS_STAGES - 1>();
    __syncthreads();
    const uint8_t* st = smem + (t % slots) * STAGE;
    const float* xs = reinterpret_cast<const float*>(st + W);
    const float* ws = stage_w<INT8>(st, wide, tid);
#pragma unroll 2
    for (int q = 0; q < (REPRO_CUT == 1 ? 0 : SM_TK / 4); ++q) {
      float xv[4][4], wv[4][4];  // [row][k], [k][channel]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(xs + (g + 16 * i) * ST_XLD + 4 * q);
        xv[i][0] = v.x; xv[i][1] = v.y; xv[i][2] = v.z; xv[i][3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (TRANS) {  // channel h + 8e, k = 4q .. 4q + 3
          const float4 v = *reinterpret_cast<const float4*>(
              st + small_w_off<true>((h + 8 * e) * (SM_TK / 4) + q));
          wv[0][e] = v.x; wv[1][e] = v.y; wv[2][e] = v.z; wv[3][e] = v.w;
        } else {                // channels 4h .. 4h + 3 of k row 4q + e
          const float4 v = *reinterpret_cast<const float4*>(ws + (4 * q + e) * SM_NC + 4 * h);
          wv[e][0] = v.x; wv[e][1] = v.y; wv[e][2] = v.z; wv[e][3] = v.w;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i][e], wv[e][j], acc[i][j]);
    }
    if (t + slots < steps) {  // the ring turns: every thread is done with this stage
      __syncthreads();
      issue(t + slots);
    }
    tc::cp_commit();
  }

  // output channel of this thread's column j
  auto chan = [&](int j) { return TRANS ? h + 8 * j : 4 * h + j; };
  if (REPRO_CUT != 0) {  // a breakdown variant: the products kept in shared memory only
    __syncthreads();
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v += acc[i][j];
    reinterpret_cast<float*>(smem)[tid] = v;
    return;
  }
  if (a.split == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 16 * i;
      if (r >= rows) continue;
      if (!TRANS) {
        store4(a, blk, tok0 + r, ch0 + 4 * h,
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = ch0 + chan(j);
        if (c >= a.n) continue;
        const long p = static_cast<long>(blk) * a.n + c;
        a.y[static_cast<long>(tok0 + r) * a.nb * a.n + p] = out1(a, p, acc[i][j]);
      }
    }
    return;
  }
  // the split's partials (64 rows x SM_NC channels) in shared memory; each
  // block then adds a share of the tile from all of them, in rank order
  __syncthreads();  // every thread is done with the ring
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[(g + 16 * i) * SM_NC + chan(j)] = acc[i][j];
  tc::cluster_sync();
  tc::cluster_add<CLUSTER_MAX>(tc::smem_u32(part), a.split, rows * SM_NC / 4, [&](int q, float4 v) {
    const int c = ch0 + 4 * (q % (SM_NC / 4));
    if (c < a.n) store4(a, blk, tok0 + q / (SM_NC / 4), c, v);
  });
  tc::cluster_sync();  // the other blocks have read this block's partial
}

// ---------------------------------------------------------------- tiled
// route simt_f32: simt.cuh's pipelined 128 x 128 tile (tokens x channels,
// one block an SM) of diagonal block blockIdx.y, over split z's K range
// (blockIdx.z = token tile * split + z); a K step of 16 forward, 32
// transposed, where both operands are read along K. 8 x 4 outputs a
// thread, 512 threads: with the masked matmul's 8 x 8 and 256 threads two
// warps a scheduler left FFMA issue idle (the speedup's m = 2048 ran 0.0715
// ms against 0.0680 at 512 threads, and a forward K step of 32 0.0749; H100
// 80GB HBM3, 700 W, benchmarks/torch_bdmm.py --mode f32_breakdown).
#ifndef REPRO_SIMT_FWD_BK
#define REPRO_SIMT_FWD_BK 16  // the forward K step (a breakdown variant: 32)
#endif
#ifndef REPRO_SIMT_TN
#define REPRO_SIMT_TN 4  // channels a thread (a breakdown variant: 8, 256 threads)
#endif
constexpr int BT_TN = REPRO_SIMT_TN, BT_TC = 128 / BT_TN;  // threads across the channels
template <bool TRANS>
using BTile = Tile<128, 128, 8, BT_TN, TRANS ? 32 : REPRO_SIMT_FWD_BK>;

template <bool TRANS, bool INT8>
__global__ void __launch_bounds__(BTile<TRANS>::THREADS, 1) bdmm_simt_tiled_kernel(const BArgs a) {
  using T = BTile<TRANS>;
  using W = std::conditional_t<INT8, int8_t, float>;
  static_assert(!(TRANS && INT8), "int8 blocks run forward only");
  extern __shared__ __align__(16) uint8_t smem[];
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + 2 * T::BK * T::LA;
  const int col0 = blockIdx.x * 128, blk = blockIdx.y;
  const int row0 = (blockIdx.z / a.split) * 128, z = blockIdx.z % a.split;
  const int kb = z * a.k_chunk, ke = min(a.k, kb + a.k_chunk);
  const int tid = threadIdx.x, tr = tid / BT_TC, tcol = tid % BT_TC;
  const bool vx = a.vec_x == 16, vw = a.vec_w >= (INT8 ? 4 : 16);
  const float* xb = a.x + static_cast<long>(blk) * a.k;
  const W* wb = static_cast<const W*>(a.w) + static_cast<long>(blk) * a.k * a.n;
  Loader<128, T::BK, T::THREADS, true, false> la;
  Loader<128, T::BK, T::THREADS, TRANS, false, W> lb;
  float acc[8][BT_TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < BT_TN; ++j) acc[i][j] = 0.f;
  tile_loop<T>(
      sa, sb, la, lb,
      [&](auto& l, int k0) {
        l.load(xb, nullptr, static_cast<long>(a.nb) * a.k, row0, a.m, k0, ke, vx, false, tid);
      },
      [&](auto& l, int k0) {
        l.load(wb, nullptr, TRANS ? a.k : a.n, col0, a.n, k0, ke, vw, false, tid);
      },
      kb, ke, acc, tr, tcol, tid);

  if (a.split == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + T::row(tr, i);
      if (r >= a.m) continue;
#pragma unroll
      for (int h = 0; h < BT_TN / 4; ++h) {
        const int c = col0 + T::col(tcol, 4 * h);
        if (c < a.n)
          store4(a, blk, r, c, make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
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
    for (int h = 0; h < BT_TN / 4; ++h)
      *reinterpret_cast<float4*>(part + T::row(tr, i) * 128 + T::col(tcol, 4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  tc::cluster_sync();
  const int rows = min(128, a.m - row0);
  tc::cluster_add<CLUSTER_MAX>(tc::smem_u32(part), a.split, rows * 32, [&](int g, float4 v) {
    const int c = col0 + 4 * (g % 32);
    if (c < a.n) store4(a, blk, row0 + g / 32, c, v);
  });
  tc::cluster_sync();  // the other blocks have read this block's partial
}

// ------------------------------------------------------------- launches
template <bool TRANS, bool INT8>
cudaError_t launch_tiled(const BArgs& a, cudaStream_t s) {
  using T = BTile<TRANS>;
  const dim3 grid((a.n + 127) / 128, a.nb, (a.m + 127) / 128 * a.split);
  // the ring, or the 128 x 128 partial of a split if that is larger
  const int part = a.split > 1 ? 128 * 128 * 4 : 0;
  return launch_split(bdmm_simt_tiled_kernel<TRANS, INT8>, T::THREADS, max(part, T::RING), grid,
                      a.split, s, a);
}

template <bool INT8, int MT>
cudaError_t launch_decode_mt(const BArgs& a, cudaStream_t s) {
  const dim3 grid((a.n + SM_NC - 1) / SM_NC, a.nb, a.split);
  const int slots = min(SS_STAGES, (a.k_chunk + SM_TK - 1) / SM_TK);
  // the ring, or the warps' partials and the block's sum if that is larger
  const int part = (SS_WARPS + (a.split > 1)) * MT * SM_NC * 4;
  return launch_split(bdmm_simt_decode_kernel<INT8, MT>, SS_THREADS,
                      max(slots * decode_stage<INT8>(MT), part), grid, a.split, s, a);
}

// MT: the power of two that holds the m <= 32 rows
template <bool INT8>
cudaError_t launch_decode(const BArgs& a, cudaStream_t s) {
  if (a.m <= 1) return launch_decode_mt<INT8, 1>(a, s);
  if (a.m <= 2) return launch_decode_mt<INT8, 2>(a, s);
  if (a.m <= 4) return launch_decode_mt<INT8, 4>(a, s);
  if (a.m <= 8) return launch_decode_mt<INT8, 8>(a, s);
  if (a.m <= 16) return launch_decode_mt<INT8, 16>(a, s);
  return launch_decode_mt<INT8, 32>(a, s);
}

template <bool TRANS, bool INT8>
cudaError_t launch_small(const BArgs& a, cudaStream_t s) {
  const dim3 grid((a.n + SM_NC - 1) / SM_NC, a.nb, (a.m + ST_ROWS - 1) / ST_ROWS * a.split);
  const int slots = min(SS_STAGES, (a.k_chunk + SM_TK - 1) / SM_TK);
  // the ring, or the 64 x SM_NC partial of a split if that is larger
  const int part = a.split > 1 ? ST_ROWS * SM_NC * 4 : 0;
  return launch_split(bdmm_simt_small_kernel<TRANS, INT8>, SS_THREADS,
                      max(slots * small_stage<INT8>() + (INT8 ? SS_WIDE : 0), part), grid,
                      a.split, s, a);
}

cudaError_t launch_f32(const BArgs& a, Route route, bool trans, bool int8, cudaStream_t s) {
  if (route == ROUTE_DECODE_SIMT)
    return int8 ? launch_decode<true>(a, s) : launch_decode<false>(a, s);
  if (route == ROUTE_SIMT_F32)
    return int8 ? launch_tiled<false, true>(a, s)
                : trans ? launch_tiled<true, false>(a, s) : launch_tiled<false, false>(a, s);
  return int8 ? launch_small<false, true>(a, s)
              : trans ? launch_small<true, false>(a, s) : launch_small<false, false>(a, s);
}

}  // namespace
}  // namespace simt

// ============================================== tensor-core bodies (bf16)
namespace tc {
namespace {

struct BArgs {
  const bf16* x;       // (m, nb * k)
  const void* w;       // (nb, k, n), or (nb, n, k) transposed; bf16 or int8
  const float* scale;  // (nb, n) for int8 w, else null
  const float* bias;   // (nb * n,) or null
  bf16* y;             // (m, nb * n)
  float* ws;           // tc_small_m: (split, m, nb * n) partial sums when split > 1
  int m, nb, k, n, act;
  int vec_x, vec_w;    // copy width in bytes of the rows of x and w
  int split, k_chunk;  // tc_small_m, decode_tc: K split over blocks, K range of a split
};

// scale -> bias -> activation act of output channel ch of block blk
__device__ __forceinline__ float bdmm_out(const BArgs& a, int blk, int ch, float v, int act) {
  if (ch >= a.n) return 0.f;
  const long p = static_cast<long>(blk) * a.n + ch;
  if (a.scale) v *= __ldg(a.scale + p);
  if (a.bias) v += __ldg(a.bias + p);
  return activate_tc(v, act);
}

// ------------------------------------------------------------------- tc
constexpr int BT_CW = 2;            // consumer warpgroups, 64 token rows each
constexpr int BT_BP = 64 * BT_CW;   // tokens of a tile
constexpr int BT_BQ = 128;          // channels of a tile
constexpr int BT_STAGES = 6;  // 192 KB ring + 32 KB staging: one block an SM
constexpr int BT_X = BT_BP * TK * 2, BT_W = BT_BQ * TK * 2, BT_BYTES = BT_X + BT_W;
// a consumer's staged output: 64 token rows x 128 channels as two 128-byte
// swizzled panels of 64 channels, the boxes of the output's TMA stores
constexpr int BT_OUT = 64 * BT_BQ * 2;
constexpr int BT_THREADS = BT_CW * WG_THREADS + 32;  // + one producer warp

// TMA descriptors of x as (m, nb, k), w as (nb, k, n) or (nb, n, k), and y
// as (m, nb, n).
struct BMaps {
  CUtensorMap x, w, y;
};

// Tile i of the grid walk: channel tile fastest, then token tile, then
// block, so consecutive tiles share their x tile.
__device__ __forceinline__ void bt_tile(const BArgs& a, int i, int& blk, int& tok0, int& ch0) {
  const int nt = (a.n + BT_BQ - 1) / BT_BQ, mt = (a.m + BT_BP - 1) / BT_BP;
  ch0 = (i % nt) * BT_BQ;
  tok0 = (i / nt % mt) * BT_BP;
  blk = i / nt / mt;
}

// bias -> activation of one consumer's accumulators (64 x 128; thread
// element 4g + 2h + e at row 16 warp + lane / 4 + 8h, column 8g + 2 (lane %
// 4) + e), rounded to bf16 into the two swizzled panels at out.
template <int ACT>
__device__ __forceinline__ void bt_stage(uint8_t* out, const float (&acc)[BT_BQ / 2],
                                         const float* bias, int nv, int t) {
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int g = 0; g < BT_BQ / 8; ++g) {
    const int c = 8 * g + 2 * (lane % 4);  // nv: the tile's channels in range
    const float b0 = bias && c < nv ? __ldg(bias + c) : 0.f;
    const float b1 = bias && c + 1 < nv ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + lane / 4 + 8 * h;
      float v0 = acc[4 * g + 2 * h] + b0, v1 = acc[4 * g + 2 * h + 1] + b1;
      if (ACT != ACT_NONE) {
        v0 = activate_tc(v0, ACT);
        v1 = activate_tc(v1, ACT);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (g / 8) * 8192 + r * 128 +
                                         (((g % 8) ^ (r % 8)) << 4) + 4 * (lane % 4)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Persistent: block b takes tiles b, b + gridDim.x, ... The producer thread
// runs ahead through the ring across tile boundaries, so the next tile's
// loads are in flight while the consumers finish a tile. A consumer stages
// its rows in shared memory and one of its threads stores them with TMA,
// asynchronously: the warpgroup goes on to the next tile at once, and waits
// for that store to have read the staging only a tile later. (A K split for
// grids of few tiles measured no faster: its second pass costs what it
// saves.)
template <bool TRANS>
__global__ void __launch_bounds__(BT_THREADS, 1)
    bdmm_general_tc_kernel(const BArgs a, const __grid_constant__ BMaps maps) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  uint8_t* staging = smem + BT_STAGES * BT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + BT_CW * BT_OUT);  // landed
  uint64_t* empty = full + BT_STAGES;  // consumed: the producer may refill
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int tiles = ((a.n + BT_BQ - 1) / BT_BQ) * ((a.m + BT_BP - 1) / BT_BP) * a.nb;
  const int steps = (a.k + TK - 1) / TK;
  if (tid == 0) {
    for (int s = 0; s < BT_STAGES; ++s) {
      bar_init(full + s, 1);           // the issuing thread, plus the copies' bytes
      bar_init(empty + s, 4 * BT_CW);  // every consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == BT_CW) {
    if (tid != BT_CW * WG_THREADS) return;
    int q = 0;  // loads issued: step q uses stage q % STAGES
#pragma unroll 1
    for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
      int blk, tok0, ch0;
      bt_tile(a, i, blk, tok0, ch0);
#pragma unroll 1
      for (int t = 0; t < steps; ++t, ++q) {
        const int st = q % BT_STAGES, k0 = t * TK;
        const uint32_t sx = s0 + st * BT_BYTES, sw = sx + BT_X;
        if (q >= BT_STAGES) bar_wait(empty + st, ((q / BT_STAGES) & 1) ^ 1);
        bar_expect(full + st, BT_BYTES);
        tma_load(sx, &maps.x, k0, blk, tok0, full + st);
        if (TRANS) {
          tma_load(sw, &maps.w, k0, ch0, blk, full + st);
        } else {
          tma_load(sw, &maps.w, ch0, k0, blk, full + st);
          tma_load(sw + 8192, &maps.w, ch0 + 64, k0, blk, full + st);
        }
      }
    }
    return;
  }

  const bool lane0 = tid % 32 == 0, leader = tid % WG_THREADS == 0;
  const int t = tid % WG_THREADS;
  uint8_t* out = staging + wg * BT_OUT;
  float acc[BT_BQ / 2];
  int q = 0;  // steps consumed
#pragma unroll 1
  for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
    int blk, tok0, ch0;
    bt_tile(a, i, blk, tok0, ch0);
#pragma unroll
    for (int j = 0; j < BT_BQ / 2; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int s = 0; s < steps; ++s, ++q) {
      const int st = q % BT_STAGES;
      bar_wait(full + st, (q / BT_STAGES) & 1);
      const uint32_t sx = s0 + st * BT_BYTES, sw = sx + BT_X;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma<BT_BQ, 0, TRANS ? 0 : 1>(acc, desc_k(sx + wg * 8192, kk),
                                       TRANS ? desc_k(sw, kk) : desc_mn(sw, kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (s > 0 && lane0) bar_arrive(empty + (q - 1) % BT_STAGES);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane0) bar_arrive(empty + (q - 1) % BT_STAGES);
    // the previous tile's store has read the staging
    if (leader) bulk_wait<0, true>();
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG_THREADS) : "memory");
    const float* bias = a.bias ? a.bias + static_cast<long>(blk) * a.n + ch0 : nullptr;
    switch (a.act) {
      case ACT_SILU: bt_stage<ACT_SILU>(out, acc, bias, a.n - ch0, t); break;
      case ACT_GELU: bt_stage<ACT_GELU>(out, acc, bias, a.n - ch0, t); break;
      case ACT_RELU: bt_stage<ACT_RELU>(out, acc, bias, a.n - ch0, t); break;
      case ACT_SIGMOID: bt_stage<ACT_SIGMOID>(out, acc, bias, a.n - ch0, t); break;
      case ACT_SOFTPLUS: bt_stage<ACT_SOFTPLUS>(out, acc, bias, a.n - ch0, t); break;
      case ACT_SQRELU: bt_stage<ACT_SQRELU>(out, acc, bias, a.n - ch0, t); break;
      default: bt_stage<ACT_NONE>(out, acc, bias, a.n - ch0, t);
    }
    fence_async_smem();
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG_THREADS) : "memory");
    if (leader) {
      tma_store(&maps.y, smem_u32(out), ch0, blk, tok0 + wg * 64);
      tma_store(&maps.y, smem_u32(out) + 8192, ch0 + 64, blk, tok0 + wg * 64);
      bulk_commit();
    }
  }
  if (leader) bulk_wait<0, false>();
}

// ----------------------------------------------------------- tc_small_m
constexpr int BS_TILE = 64;  // channels (wgmma's M side) and tokens (its N side)
constexpr int BS_STAGES = 4;

template <bool INT8>
struct SmallStage {
  // x tile, the bf16 w tile wgmma reads, and the int8 w tile as copied
  static constexpr int X = BS_TILE * TK * 2, W = BS_TILE * TK * 2, Q = INT8 ? BS_TILE * TK : 0;
  static constexpr int BYTES = X + W + Q;
  static_assert(X % 1024 == 0 && W % 1024 == 0 && Q % 1024 == 0, "swizzled tiles stay aligned");
};

// 16 int8 weights as 16 bf16 (exact: every int8 value is a bf16 value)
__device__ __forceinline__ uint4 widen8(uint2 q) {
  uint4 out;
  uint32_t* o = &out.x;
  const uint32_t w[2] = {q.x, q.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = w[i / 2];
    const int sh = 16 * (i % 2);
    const __nv_bfloat162 p = __floats2bfloat162_rn(
        static_cast<float>(static_cast<int8_t>((v >> sh) & 0xFF)),
        static_cast<float>(static_cast<int8_t>((v >> (sh + 8)) & 0xFF)));
    memcpy(o + i, &p, 4);
  }
  return out;
}

// y^T tile = B_n^T x^T: 64 channels from ch0 of block blockIdx.y (A = w,
// MN-major forward, K-major transposed) times 64 tokens from tok0 (B = x,
// K-major; rows past m are zero), over split z's K range, blockIdx.z =
// token tile + token tiles * z. With a split the f32 partial sums go to the
// workspace and bdmm_reduce_kernel finishes them.
template <bool TRANS, bool INT8>
__global__ void __launch_bounds__(WG_THREADS) bdmm_general_small_kernel(const BArgs a) {
  using S = SmallStage<INT8>;
  static_assert(!(TRANS && INT8), "int8 blocks run forward only");
  constexpr int NT = WG_THREADS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, ch0 = blockIdx.x * BS_TILE, blk = blockIdx.y;
  const int tok_tiles = (a.m + BS_TILE - 1) / BS_TILE, z = blockIdx.z / tok_tiles;
  const int tok0 = (blockIdx.z % tok_tiles) * BS_TILE, kb = z * a.k_chunk;
  const int steps = (min(a.k, kb + a.k_chunk) - kb + TK - 1) / TK;
  constexpr int ES = INT8 ? 1 : 2;  // bytes of a weight
  const auto* wb = static_cast<const uint8_t*>(a.w) + static_cast<long>(blk) * a.k * a.n * ES;
  const Rows gx{reinterpret_cast<const uint8_t*>(a.x) + static_cast<long>(blk) * a.k * 2,
                2L * a.nb * a.k, a.m, 2 * a.k, a.vec_x};
  const Rows gw = TRANS ? Rows{wb, static_cast<long>(a.k) * ES, a.n, a.k * ES, a.vec_w}
                        : Rows{wb, static_cast<long>(a.n) * ES, a.k, a.n * ES, a.vec_w};
  auto issue = [&](int t) {
    const uint32_t sx = s0 + (t % BS_STAGES) * S::BYTES, sw = sx + S::X, sq = sw + S::W;
    const int k0 = kb + t * TK;
#pragma unroll
    for (int i = 0; i < BS_TILE * 8 / NT; ++i) {
      const int idx = tid + i * NT, r = idx / 8, c = idx % 8;
      copy_chunk(sx + KMajor{}(r, c), gx, tok0 + r, 2 * k0 + 16 * c);
    }
    if constexpr (INT8) {  // k rows of 64 int8 channels, 4 chunks a row
#pragma unroll
      for (int i = 0; i < TK * 4 / NT; ++i) {
        const int idx = tid + i * NT, r = idx / 4, c = idx % 4;
        copy_chunk(sq + r * 64 + 16 * c, gw, k0 + r, ch0 + 16 * c);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BS_TILE * 8 / NT; ++i) {
        const int idx = tid + i * NT, r = idx / 8, c = idx % 8;
        if (TRANS)
          copy_chunk(sw + KMajor{}(r, c), gw, ch0 + r, 2 * k0 + 16 * c);
        else
          copy_chunk(sw + MNMajor{}(r, c), gw, k0 + r, 2 * ch0 + 16 * c);
      }
    }
  };
  float acc[BS_TILE / 2];
#pragma unroll
  for (int i = 0; i < BS_TILE / 2; ++i) acc[i] = 0.f;

  // Stage t % STAGES holds step t. A thread waits for its own copies,
  // widens its own int8 pieces and fences them for the async proxy; the one
  // barrier a step then publishes the stage and retires step t - 2's wgmmas
  // (waited for at step t - 1), so its stage takes step t + STAGES - 2.
#pragma unroll
  for (int t = 0; t < BS_STAGES - 2; ++t) {
    if (t < steps) issue(t);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int st = t % BS_STAGES;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(BS_STAGES - 3) : "memory");
    uint8_t* stage = smem + st * S::BYTES;
    if constexpr (INT8) {
#pragma unroll
      for (int i = 0; i < TK * 4 / NT; ++i) {
        const int idx = tid + i * NT, r = idx / 4, c = idx % 4;
        const uint4 q = *reinterpret_cast<const uint4*>(stage + S::X + S::W + r * 64 + 16 * c);
        *reinterpret_cast<uint4*>(stage + S::X + MNMajor{}(r, 2 * c)) = widen8(make_uint2(q.x, q.y));
        *reinterpret_cast<uint4*>(stage + S::X + MNMajor{}(r, 2 * c + 1)) =
            widen8(make_uint2(q.z, q.w));
      }
    }
    fence_async_smem();
    __syncthreads();
    if (t + BS_STAGES - 2 < steps) issue(t + BS_STAGES - 2);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t sx = s0 + st * S::BYTES, sw = sx + S::X;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma<BS_TILE, TRANS ? 0 : 1, 0>(acc, TRANS ? desc_k(sw, kk) : desc_mn(sw, kk),
                                       desc_k(sx, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator 4g + 2h + e sits at channel row 16 warp + lane / 4 + 8h,
  // token column 8g + 2 (lane % 4) + e
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const long ldy = static_cast<long>(a.nb) * a.n;
  float* part = a.split > 1 ? a.ws + static_cast<long>(z) * a.m * ldy : nullptr;
  dispatch_act(part ? ACT_NONE : a.act, [&](auto A) {
#pragma unroll
    for (int g = 0; g < BS_TILE / 8; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tok = tok0 + 8 * g + c0 + e, ch = ch0 + r0 + 8 * h;
          if (tok >= a.m || ch >= a.n) continue;
          const long off = tok * ldy + static_cast<long>(blk) * a.n + ch;
          const float v = acc[4 * g + 2 * h + e];
          if (part)
            part[off] = v;
          else
            a.y[off] = from_f32<bf16>(bdmm_out(a, blk, ch, v, A.value));
        }
  });
}

// ------------------------------------------------------------ decode_tc
// The bf16 decode grid (m <= 32). Block (channel tile, diagonal block,
// split) owns 64 output channels of every token over one K range of
// k_chunk rows (plan: the split depends on (nb, k, n) only). Its weight
// slice and the token rows of that range are requested at once, K stage by
// K stage (64 rows each, DC_STAGES of them in flight, a ring beyond), with
// 16-byte cp.async copies. Warp w computes channels 16w .. 16w + 15 of every
// token on mma.sync.m16n8k16: channels on the 16-row side (A = the weights,
// read by ldmatrix.trans), tokens on the n8 side (B = x rows, ldmatrix), so
// m pads only to 8. int8 weights are widened in registers after their
// ldmatrix (widen_pairs): a lane's bytes hold channels 2gq and 2gq + 1,
// which become A rows gq and gq + 8. A token's outputs depend on its own
// x row only, with one instruction sequence whatever m is, so row r of an
// m-row call is bit for bit row r of the same input cut to fewer rows.
constexpr int DC_CH = 64;       // output channels of a block
constexpr int DC_THREADS = 128;
constexpr int DC_STAGES = 4;    // K stages in flight: a whole 256-row slice

template <bool INT8>
struct DecodeStage {
  static constexpr int W_ROW = INT8 ? 64 : 128;  // 64 channels as stored
  static constexpr int W = TK * W_ROW;
  static __host__ __device__ constexpr int bytes(int nt) { return W + nt * 8 * TK * 2; }
  // the K ring, which the epilogue then reuses for the block's f32 partial
  // (m x 64) or its bf16 output tile
  static __host__ __device__ constexpr int ring(int slots, int nt) {
    return slots * bytes(nt) > nt * 8 * DC_CH * 4 ? slots * bytes(nt) : nt * 8 * DC_CH * 4;
  }
};

// scale -> bias -> activation -> bf16, each step rounded on its own so that
// no call site contracts it differently
__device__ __forceinline__ bf16 decode_out(float v, float scale, float bias, int act) {
  return from_f32<bf16>(activate_tc(__fadd_rn(__fmul_rn(v, scale), bias), act));
}

template <bool INT8, int NT>
__global__ void __launch_bounds__(DC_THREADS) bdmm_decode_tc_kernel(const BArgs a) {
  using S = DecodeStage<INT8>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float s_scale[DC_CH], s_bias[DC_CH];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, c = lane % 4;
  const int ch0 = blockIdx.x * DC_CH, blk = blockIdx.y, z = blockIdx.z;
  const int kb = z * a.k_chunk, steps = (min(a.k, kb + a.k_chunk) - kb + TK - 1) / TK;
  const int slots = min(DC_STAGES, a.k_chunk / TK);
  constexpr int ES = INT8 ? 1 : 2;
  const Rows gw{static_cast<const uint8_t*>(a.w) + (static_cast<long>(blk) * a.k * a.n + ch0) * ES,
                static_cast<long>(a.n) * ES, a.k, (a.n - ch0) * ES, a.vec_w};
  const Rows gx{reinterpret_cast<const uint8_t*>(a.x) + static_cast<long>(blk) * a.k * 2,
                2L * a.nb * a.k, a.m, 2 * a.k, a.vec_x};
  auto issue = [&](int t) {
    const uint32_t sw = s0 + (t % slots) * S::bytes(NT), sx = sw + S::W;
    const int k0 = kb + t * TK;
    constexpr int WC = S::W_ROW / 16;  // 16-byte chunks of a weight row
#pragma unroll
    for (int i = 0; i < TK * WC / DC_THREADS; ++i) {
      const int idx = tid + i * DC_THREADS, r = idx / WC, q = idx % WC;
      copy_chunk(sw + swz<S::W_ROW>(r, q), gw, k0 + r, 16 * q);
    }
#pragma unroll
    for (int i = 0; i < (NT * 64 + DC_THREADS - 1) / DC_THREADS; ++i) {
      const int idx = tid + i * DC_THREADS, r = idx / 8, q = idx % 8;
      if (idx < NT * 64) copy_chunk(sx + swz<128>(r, q), gx, r, 2 * k0 + 16 * q);
    }
  };
#pragma unroll 1
  for (int t = 0; t < DC_STAGES; ++t) {
    if (t < min(steps, slots)) issue(t);
    cp_commit();
  }
  // the tile's scales and biases, read while the weights are in flight
  if (tid < DC_CH) {
    const long p = static_cast<long>(blk) * a.n + ch0 + tid;
    const bool in = ch0 + tid < a.n;
    s_scale[tid] = a.scale && in ? __ldg(a.scale + p) : 1.f;
    s_bias[tid] = a.bias && in ? __ldg(a.bias + p) : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    cp_wait<DC_STAGES - 1>();
    __syncthreads();
    if (REPRO_CUT != 1) {
      const uint32_t sw = s0 + (t % slots) * S::bytes(NT), sx = sw + S::W;
#pragma unroll
      for (int h2 = 0; h2 < TK / 32; ++h2) {  // two k16 steps at a time
        uint32_t af[2][4];
        if constexpr (INT8) {
          // rows 32 h2 + 8j + lane % 8 (j = lane / 8) at the warp's chunk:
          // r[0], r[1] rows 0-7, 8-15 of the first k16, r[2], r[3] the second
          uint32_t r[4];
          ldsm_x4_t(r, sw + swz<64>(32 * h2 + lane, warp));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            widen_pairs(r[2 * h], af[h][0], af[h][1]);
            widen_pairs(r[2 * h + 1], af[h][2], af[h][3]);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ldsm_x4_t(af[h], sw + swz<128>(32 * h2 + 16 * h + lane % 8 + 8 * (lane / 16),
                                             2 * warp + (lane / 8) % 2));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[4];
          ldsm_x4(b, sx + swz<128>(8 * j + lane % 8, 4 * h2 + lane / 8));
          mma_16816(acc[j], af[0], b[0], b[1]);
          mma_16816(acc[j], af[1], b[2], b[3]);
        }
      }
    }
    __syncthreads();
    if (t + slots < steps) issue(t + slots);
    cp_commit();
  }
  if (REPRO_CUT != 0) {  // a breakdown variant: the products kept in shared memory only
    if (REPRO_CUT == 2) {
      float* keep = reinterpret_cast<float*>(smem) + tid;
#pragma unroll
      for (int j = 0; j < NT; ++j) keep[j * DC_THREADS] = acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
    }
    return;
  }

  // accumulator e of tile j: token 8j + 2c + (e & 1), channel row gq (+ 8
  // for e >= 2) as the weights' ldmatrix laid it out. The ring's bytes now
  // hold the block's m x 64 tile: the f32 partial (split > 1), else the
  // bf16 output, staged so that it leaves in 16-byte stores.
  const long ldy = static_cast<long>(a.nb) * a.n;
  bf16* out = a.y + static_cast<long>(blk) * a.n + ch0;
  const bool vec_y = a.n % 8 == 0 && (reinterpret_cast<uintptr_t>(a.y) & 15) == 0;
  if (a.split > 1) {
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * c + (e & 1);
        const int cl = 16 * warp + (INT8 ? 2 * gq + (e >> 1) : gq + 8 * (e >> 1));
        if (tok < a.m) part[tok * DC_CH + cl] = acc[j][e];
      }
    cluster_sync();
    // groups of 4 channels of one token, shared out over the split's blocks
    cluster_add<8>(s0, a.split, a.m * DC_CH / 4, [&](int g, float4 v) {
      const int tok = g / (DC_CH / 4), cl = 4 * (g % (DC_CH / 4));
      const float vs[4] = {v.x, v.y, v.z, v.w};
      bf16 o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = decode_out(vs[q], s_scale[cl + q], s_bias[cl + q], a.act);
      bf16* dst = out + tok * ldy + cl;
      if (vec_y && ch0 + cl + 4 <= a.n) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ch0 + cl + q < a.n) dst[q] = o[q];
      }
    });
    cluster_sync();  // the other blocks have read this block's partial
    return;
  }
  bf16* tile = reinterpret_cast<bf16*>(smem);  // m x 64, 128-byte rows
  dispatch_act(a.act, [&](auto A) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * c + (e & 1);
        const int cl = 16 * warp + (INT8 ? 2 * gq + (e >> 1) : gq + 8 * (e >> 1));
        tile[tok * DC_CH + cl] = decode_out(acc[j][e], s_scale[cl], s_bias[cl], A.value);
      }
  });
  __syncthreads();
  for (int idx = tid; idx < a.m * (DC_CH / 8); idx += DC_THREADS) {
    const int tok = idx / (DC_CH / 8), cl = 8 * (idx % (DC_CH / 8));
    bf16* dst = out + tok * ldy + cl;
    if (vec_y && ch0 + cl + 8 <= a.n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tile + tok * DC_CH + cl);
    } else {
      for (int q = 0; q < 8 && ch0 + cl + q < a.n; ++q) dst[q] = tile[tok * DC_CH + cl + q];
    }
  }
}

// y = act(sum_z ws[z] (* scale) + bias): the split partial sums added in the
// fixed order z = 0, 1, ..., so the result does not depend on the blocks'
// order.
__global__ void bdmm_reduce_kernel(const BArgs a) {
  const long ldy = static_cast<long>(a.nb) * a.n, total = a.m * ldy;
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int z = 0; z < a.split; ++z) v += a.ws[z * total + i];
  const int p = static_cast<int>(i % ldy);
  a.y[i] = from_f32<bf16>(bdmm_out(a, p / a.n, p % a.n, v, a.act));
}

}  // namespace
}  // namespace tc

namespace {

template <bool INT8>
cudaError_t launch_decode_tc(const tc::BArgs& a, cudaStream_t s) {
  const dim3 grid((a.n + tc::DC_CH - 1) / tc::DC_CH, a.nb, a.split);
  const int nt = (a.m + 7) / 8;
  const int slots = a.k_chunk / tc::TK < tc::DC_STAGES ? a.k_chunk / tc::TK : tc::DC_STAGES;
  const int bytes = tc::DecodeStage<INT8>::ring(slots, nt);
  // the split's blocks form one cluster
#define REPRO_DECODE_TC(NT_)                                                                  \
  tc::launch_cluster(tc::bdmm_decode_tc_kernel<INT8, NT_>, tc::DC_THREADS, bytes, grid,       \
                     dim3(1, 1, a.split), s, a)
  switch (nt) {
    case 1: return REPRO_DECODE_TC(1);
    case 2: return REPRO_DECODE_TC(2);
    case 3: return REPRO_DECODE_TC(3);
    default: return REPRO_DECODE_TC(4);
  }
#undef REPRO_DECODE_TC
}

template <bool TRANS, bool INT8>
cudaError_t launch_small(const tc::BArgs& a, cudaStream_t s) {
  const dim3 grid((a.n + tc::BS_TILE - 1) / tc::BS_TILE, a.nb,
                  (a.m + tc::BS_TILE - 1) / tc::BS_TILE * a.split);
  const int bytes = tc::BS_STAGES * tc::SmallStage<INT8>::BYTES + 1024;  // + alignment slack
  cudaError_t e =
      tc::launch(tc::bdmm_general_small_kernel<TRANS, INT8>, tc::WG_THREADS, bytes, grid, s, a);
  if (e == cudaSuccess && a.split > 1) {
    const long total = static_cast<long>(a.m) * a.nb * a.n;
    tc::bdmm_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(a);
    e = cudaGetLastError();
  }
  return e;
}

template <bool TRANS>
cudaError_t launch_tc(const tc::BArgs& a, int blocks, cudaStream_t s) {
  tc::BMaps maps{};
  const long k = a.k, n = a.n, nb = a.nb, m = a.m;
  // x as (m, nb, k); w as (nb, k, n) or, transposed, (nb, n, k); y as (m,
  // nb, n): a block's K and N edges are tensor edges
  const long xd[3] = {k, nb, m}, xs[2] = {2 * k, 2 * nb * k};
  const long wd[3] = {TRANS ? k : n, TRANS ? n : k, nb}, ws[2] = {2 * wd[0], 2 * k * n};
  const long yd[3] = {n, nb, m}, ys[2] = {2 * n, 2 * nb * n};
  const int xb[3] = {tc::TK, 1, tc::BT_BP}, wbx[3] = {tc::TK, TRANS ? tc::BT_BQ : tc::TK, 1};
  const int yb[3] = {64, 1, 64};
  if (!tc::tensor_map_nd(&maps.x, a.x, 2, 3, xd, xs, xb, true) ||
      !tc::tensor_map_nd(&maps.w, a.w, 2, 3, wd, ws, wbx, true) ||
      !tc::tensor_map_nd(&maps.y, a.y, 2, 3, yd, ys, yb, true))
    return cudaErrorNotSupported;
  const int bytes = tc::BT_STAGES * tc::BT_BYTES + tc::BT_CW * tc::BT_OUT + 1024 +
                    2 * tc::BT_STAGES * 8;  // + alignment slack, the mbarriers
  return tc::launch(tc::bdmm_general_tc_kernel<TRANS>, tc::BT_THREADS, bytes, dim3(blocks), s,
                    a, maps);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// y (m, nb*n) = act(x (m, nb*k) @ blockdiag(B) (* scale) + bias): B_n = w[n]
// for w (nb, k, n), or w[n]^T for w (nb, n, k) with transpose. x_dtype:
// DT_F32 or DT_BF16 (y the same); w_int8: 0 -> w has x's dtype, 1 -> int8
// with scale (nb, n) f32. The launch plan (kernels/bdmm.py::plan): route 0
// decode_simt (f32 x, m <= 32, forward) and 5 simt_small (f32 x; the same
// small body), 1 simt_f32 (f32 x, the tiled body), 2 tc (bf16 x and w; x, w
// and the rows of both 16-byte aligned; `blocks` persistent blocks), 3
// tc_small_m (bf16 x, bf16 or, forward only, int8 w), 4 decode_tc (bf16 x,
// m <= 32, forward). K is split over `split` blocks of k_chunk rows: on the
// f32 routes a multiple of 4, inside one cluster of the split's blocks (at
// most 16, simt_f32 8); on the bf16 routes a multiple of 64, tc_small_m
// adding the splits from ws, an f32 (split, m, nb*n) workspace, decode_tc
// inside a cluster (at most 8). vec_x / vec_w: the copy width in bytes of
// the rows of x and w. Returns cudaGetLastError() after the launches.
extern "C" int bdmm_launch(const void* x, const void* w, const float* scale,
                           const float* bias, void* y, float* ws, int m, int nb,
                           int k, int n, int x_dtype, int w_int8, int act, int route,
                           int transpose, int vec_x, int vec_w, int blocks, int split,
                           int k_chunk, void* stream) {
  cudaGetLastError();  // clear a stale error so the one returned is this launch's
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || nb <= 0 || k <= 0 || n <= 0 || act < ACT_NONE || act > ACT_LAST) return bad;
  if (w_int8 && (transpose || !scale)) return bad;
  if (!tc::vec_ok(vec_x) || !tc::vec_ok(vec_w)) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_DECODE_SIMT || route == ROUTE_SIMT_SMALL || route == ROUTE_SIMT_F32) {
    const int max_split = route == ROUTE_SIMT_F32 ? 8 : simt::CLUSTER_MAX;
    if (x_dtype != DT_F32 || !simt::split_ok(k, split, k_chunk, 4, max_split)) return bad;
    if (route == ROUTE_DECODE_SIMT && (m > 32 || transpose)) return bad;
    const simt::BArgs a{static_cast<const float*>(x), w, scale, bias, static_cast<float*>(y),
                        m, nb, k, n, act, split, k_chunk, vec_x, vec_w};
    return static_cast<int>(
        simt::launch_f32(a, static_cast<Route>(route), transpose != 0, w_int8 != 0, s));
  }
  if (x_dtype != DT_BF16 || !simt::split_ok(k, split, k_chunk, tc::TK, 1 << 30)) return bad;
  const tc::BArgs a{static_cast<const __nv_bfloat16*>(x), w, scale, bias,
                    static_cast<__nv_bfloat16*>(y), ws, m, nb, k, n, act, vec_x, vec_w,
                    split, k_chunk};
  cudaError_t e;
  if (route == ROUTE_TC) {
    if (w_int8 || vec_x != 16 || vec_w != 16 || k % 8 || n % 8 || split != 1 || blocks < 1)
      return bad;
    e = transpose ? launch_tc<true>(a, blocks, s) : launch_tc<false>(a, blocks, s);
  } else if (route == ROUTE_TC_SMALL_M) {
    if (split > 1 && ws == nullptr) return bad;
    e = w_int8 ? launch_small<false, true>(a, s)
               : transpose ? launch_small<true, false>(a, s) : launch_small<false, false>(a, s);
  } else if (route == ROUTE_DECODE_TC) {
    if (m > 32 || transpose || split > 8) return bad;
    e = w_int8 ? launch_decode_tc<true>(a, s) : launch_decode_tc<false>(a, s);
  } else {
    return bad;
  }
  return static_cast<int>(e);
}

extern "C" const char* bdmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
