// The exact f32 SIMT machinery (FFMA on the CUDA cores, no TF32, no tensor
// cores) shared by the masked matmul and SDDMM (masked_matmul.cu) and bdmm's
// f32 bodies (bdmm.cu): the pipelined tile of the tiled bodies (Tile,
// Loader, tile_fma, tile_loop), the small-m bodies' copies and W-tile
// layout, and the cluster launch of a K split. Every output is one fma chain
// over its K range in increasing k; a K split is one thread block cluster
// whose partials are added over DSMEM in rank order (tc::cluster_add), so a
// result never depends on the blocks' order and a CUDA-graph replay equals
// the eager call bit for bit.
#pragma once

#include "tc.cuh"

namespace repro_torch {
namespace simt {

constexpr int CLUSTER_MAX = 16;  // a K split is one cluster (non-portable above 8)

// w * m for 4 weights and their 4 mask bytes, as the reference multiplies w
// by m.astype(w.dtype): an off-mask NaN or inf still gives NaN.
__device__ __forceinline__ float4 apply_mask(float4 v, uint32_t mk) {
  v.x = __fmul_rn(v.x, static_cast<float>(mk & 0xFFu));
  v.y = __fmul_rn(v.y, static_cast<float>((mk >> 8) & 0xFFu));
  v.z = __fmul_rn(v.z, static_cast<float>((mk >> 16) & 0xFFu));
  v.w = __fmul_rn(v.w, static_cast<float>(mk >> 24));
  return v;
}

// -------------------------------------------------- the small-m bodies
// A block owns SM_NC output channels (lane l: channel l) and stages K in
// steps of SM_TK through a cp.async ring: x rows of SM_TK floats, and a W
// tile of SM_TK k rows of SM_NC channels, or (TRANS_W: W read as (n, k))
// SM_NC channel rows of SM_XLD floats, padded so that a quarter-warp's
// 16-byte reads of 8 channel rows fall in distinct banks.
constexpr int SM_NC = 32, SM_TK = 32;
constexpr int SM_XLD = SM_TK + 4;  // padded k row of a channel-major W tile (TRANS_W)

// Byte offset in the W tile of piece p (4 floats): k row p / (SM_NC / 4) of
// SM_NC channels, or channel row p / (SM_TK / 4) of SM_XLD floats (TRANS_W).
template <bool TRANS_W>
__device__ __forceinline__ uint32_t small_w_off(int p) {
  return TRANS_W ? ((p / (SM_TK / 4)) * SM_XLD + 4 * (p % (SM_TK / 4))) * 4 : 16 * p;
}

// tc::copy16 with the 8- and 4-byte copies of rows that are no multiple of
// 16 bytes inline (LeNet's rows of 30, 75 or 5 floats): tc.cuh keeps them
// out of line to keep the tensor-core bodies small, but in bdmm's small f32
// bodies, where they are most of the copies of a µs-scale call, the calls
// cost more than the code they save.
__device__ __forceinline__ void copy16(uint32_t dst, const uint8_t* src, const uint8_t* base,
                                       int valid, int vec) {
  if (vec != 8 && vec != 4) {
    tc::copy16(dst, src, base, valid, vec);
    return;
  }
#pragma unroll
  for (int o = 0; o < 16; o += 8) {
    if (vec == 8) {
      const int v = min(max(valid - o, 0), 8);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst + o),
                   "l"(v > 0 ? src + o : base), "r"(v) : "memory");
    } else {
#pragma unroll
      for (int f = o; f < o + 8; f += 4) {
        const int v = min(max(valid - f, 0), 4);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + f),
                     "l"(v > 0 ? src + f : base), "r"(v) : "memory");
      }
    }
  }
}

// 4 consecutive elements as f32 in one aligned load: floats as they are,
// int8 weights widened exactly (every int8 value is an f32 value).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const int8_t* p) {
  const uint32_t q = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float4(static_cast<float>(static_cast<int8_t>(q & 0xFFu)),
                     static_cast<float>(static_cast<int8_t>((q >> 8) & 0xFFu)),
                     static_cast<float>(static_cast<int8_t>((q >> 16) & 0xFFu)),
                     static_cast<float>(static_cast<int8_t>(q >> 24)));
}

// ----------------------------------------------------- the tiled bodies
// A BM x BN output tile a block, TM x TN outputs a thread, K in steps of
// BK through two shared buffers: step t + 1 is loaded from device memory
// into registers (16-byte loads where the rows allow) while step t is
// multiplied, then stored k-major (transposed where the operand is
// k-contiguous, masked where it is W) into the other buffer, so one barrier
// a step orders both. Thread (tr, tc) owns rows tr * 4 + i (+ BM / 2 for i
// >= 4 when TM = 8) and the same pattern of columns. BK is 32 where the
// 128 x 128 tile's operands are read along K (transpose_rhs, the SDDMM):
// a step then reads whole 128-byte lines of each row and whole 32-byte
// sectors of the mask (olmo-1b's transposed up/gate 2.06 -> 1.96 ms, its
// SDDMM 1.82 -> 1.64); 16 elsewhere (the forward ran 1.82 at 16, 1.95 at
// 32; H100 80GB HBM3, 700 W).
template <int BM, int BN, int TM, int TN, int BK_>
struct Tile {
  static constexpr int BK = BK_;
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int LA = BM + 4, LB = BN + 4;  // padded rows of the k-major buffers
  static constexpr int RING = 2 * BK * (LA + LB) * 4;
  static __device__ __forceinline__ int row(int t, int i) {
    return (i / 4) * (BM * 4 / TM) + t * 4 + i % 4;
  }
  static __device__ __forceinline__ int col(int t, int j) {
    return (j / 4) * (BN * 4 / TN) + t * 4 + j % 4;
  }
};

// One operand's share of a ROWS x BK step in registers, pieces of 4 floats
// along its contiguous axis. Element (r, k) lives at src[r * ld + k]
// (KCONTIG: x, W with TRANS_W) or src[k * ld + r] (W forward; x and g of
// the SDDMM, whose K is the token axis). E is the stored type: f32, or int8
// (bdmm's quantized blocks, widened to f32 exactly on the load; `vec` then
// means 4-byte aligned rows). With MASK each piece keeps its 4 mask bytes
// (same layout as src) and is multiplied by them on the store: nothing
// reads a load before the step's products, so the loads overlap them. Out
// of range is 0.
template <int ROWS, int BK, int THREADS, bool KCONTIG, bool MASK, typename E = float>
struct Loader {
  static constexpr int PER = ROWS * BK / 4 / THREADS;
  static_assert(PER * THREADS * 4 == ROWS * BK, "whole shares");
  float4 v[PER];
  uint32_t mk[MASK ? PER : 1];

  static __device__ __forceinline__ void piece(int p, int& r, int& k) {
    if (KCONTIG) {
      r = p / (BK / 4);
      k = 4 * (p % (BK / 4));
    } else {
      k = p / (ROWS / 4);
      r = 4 * (p % (ROWS / 4));
    }
  }

  __device__ __forceinline__ void load(const E* __restrict__ src,
                                       const uint8_t* __restrict__ mask, long ld, int r0,
                                       int r_end, int k0, int k_end, bool vec, bool vec_m,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int r, k;
      piece(tid + i * THREADS, r, k);
      const int gr = r0 + r, gk = k0 + k;
      const bool in = KCONTIG ? gr < r_end : gk < k_end;
      const int left = KCONTIG ? k_end - gk : r_end - gr;  // elements left on the row
      const long off = KCONTIG ? gr * ld + gk : gk * ld + gr;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in && vec && left >= 4) {
        f = ldg4(src + off);
      } else if (in) {
        if (left > 0) f.x = to_f32(__ldg(src + off));
        if (left > 1) f.y = to_f32(__ldg(src + off + 1));
        if (left > 2) f.z = to_f32(__ldg(src + off + 2));
        if (left > 3) f.w = to_f32(__ldg(src + off + 3));
      }
      if (MASK) {
        uint32_t q = 0;
        if (in && vec_m && left >= 4) {
          q = __ldg(reinterpret_cast<const unsigned int*>(mask + off));
        } else if (in) {
          for (int e = 0; e < min(left, 4); ++e)
            q |= static_cast<uint32_t>(__ldg(mask + off + e)) << (8 * e);
        }
        mk[i] = q;
      }
      v[i] = f;
    }
  }

  // into the k-major buffer s[k][r] (rows of ROWS + 4 floats)
  __device__ __forceinline__ void store(float* s, int tid) const {
    constexpr int LD = ROWS + 4;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int r, k;
      piece(tid + i * THREADS, r, k);
      const float4 f = MASK ? apply_mask(v[i], mk[i]) : v[i];
      if (KCONTIG) {
        s[(k + 0) * LD + r] = f.x;
        s[(k + 1) * LD + r] = f.y;
        s[(k + 2) * LD + r] = f.z;
        s[(k + 3) * LD + r] = f.w;
      } else {
        *reinterpret_cast<float4*>(s + k * LD + r) = f;
      }
    }
  }
};

// acc[i][j] += sum_kk a[kk][row(i)] * b[kk][col(j)] over one buffered step
template <class T, int TM, int TN>
__device__ __forceinline__ void tile_fma(const float* a, const float* b, float (&acc)[TM][TN],
                                         int tr, int tc) {
#pragma unroll
  for (int kk = 0; kk < T::BK; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const float4 f = *reinterpret_cast<const float4*>(a + kk * T::LA + T::row(tr, 4 * h));
      av[4 * h] = f.x; av[4 * h + 1] = f.y; av[4 * h + 2] = f.z; av[4 * h + 3] = f.w;
    }
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const float4 f = *reinterpret_cast<const float4*>(b + kk * T::LB + T::col(tc, 4 * h));
      bv[4 * h] = f.x; bv[4 * h + 1] = f.y; bv[4 * h + 2] = f.z; bv[4 * h + 3] = f.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The pipelined K loop of one block over [kb, ke): step t + 1 is loaded
// into registers before step t's products and stored after them.
template <class T, int TM, int TN, class LA_, class LB_, class LoadA, class LoadB>
__device__ __forceinline__ void tile_loop(float* sa, float* sb, LA_& la, LB_& lb, LoadA load_a,
                                          LoadB load_b, int kb, int ke, float (&acc)[TM][TN],
                                          int tr, int tc, int tid) {
  constexpr int BK = T::BK;
  const int steps = (ke - kb + BK - 1) / BK;
  load_a(la, kb);
  load_b(lb, kb);
  la.store(sa, tid);
  lb.store(sb, tid);
  __syncthreads();
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    const bool next = t + 1 < steps;
    if (next) {
      load_a(la, kb + (t + 1) * BK);
      load_b(lb, kb + (t + 1) * BK);
    }
    tile_fma<T>(sa + cur * BK * T::LA, sb + cur * BK * T::LB, acc, tr, tc);
    if (next) {
      la.store(sa + (cur ^ 1) * BK * T::LA, tid);
      lb.store(sb + (cur ^ 1) * BK * T::LB, tid);
    }
    __syncthreads();
  }
}

// A K split of split blocks of k_chunk each (a multiple of `unit`) covers
// [0, k), every block's range non-empty.
inline bool split_ok(int k, int split, int k_chunk, int unit, int max_split) {
  return split >= 1 && split <= max_split && k_chunk > 0 && k_chunk % unit == 0 &&
         static_cast<long>(split) * k_chunk >= k && static_cast<long>(split - 1) * k_chunk < k;
}

// A launch whose K split (split > 1) is one cluster of the split's blocks
// along z.
template <class A>
cudaError_t launch_split(void (*kern)(A), int threads, int bytes, dim3 grid, int split,
                         cudaStream_t s, const A& a) {
  return split > 1 ? tc::launch_cluster(kern, threads, bytes, grid, dim3(1, 1, split), s, a)
                   : tc::launch(kern, threads, bytes, grid, s, a);
}

}  // namespace simt
}  // namespace repro_torch
