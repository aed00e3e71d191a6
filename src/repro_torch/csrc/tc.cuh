// Tensor-core building blocks for Hopper (sm_90a) shared by the port's bf16
// GEMM bodies (masked_matmul.cu, bdmm.cu, fused_ffn.cu): 128-byte-swizzled shared-memory
// layouts, wgmma descriptors and instructions, mbarriers, TMA loads and
// tensor maps, and cp.async copies for rows that TMA refuses.
#pragma once

#include <cuda.h>
#include <string.h>

#include "common.cuh"

namespace repro_torch {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int TK = 64;           // K step: one 128-byte swizzle row of bf16
constexpr int WG_THREADS = 128;  // one warpgroup

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

// The narrower copies of copy16, out of line: every call site keeps only
// the 16-byte fast path (the kernels' code is fetched from device memory
// when the L2 holds none of it, so its size costs time).
__device__ __noinline__ void copy16_narrow(uint32_t dst, const uint8_t* src, const uint8_t* base,
                                           int valid, int vec) {
  if (vec == 8) {
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
    for (int b = 0; b < valid; ++b) q[b >> 2] |= static_cast<uint32_t>(src[b]) << (8 * (b & 3));
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(q[0]), "r"(q[1]),
                 "r"(q[2]), "r"(q[3]) : "memory");
  }
}

// Copy 16 bytes into shared memory at `dst`, `valid` of them from `src`
// and the rest zero. With vec >= 4 the copy is asynchronous (cp.async of
// vec-byte pieces); narrower-aligned rows are loaded and stored here.
__device__ __forceinline__ void copy16(uint32_t dst, const uint8_t* src, const uint8_t* base,
                                       int valid, int vec) {
  if (vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(valid > 0 ? src : base), "r"(valid) : "memory");
  else
    copy16_narrow(dst, src, base, valid, vec);
}

// Chunk c of the 16-byte chunks of row r of g, from column byte col_byte
// on: `valid` bytes in range (0 past the last row or the row's end).
__device__ __forceinline__ void copy_chunk(uint32_t dst, const Rows& g, int r, int col_byte) {
  const int valid = r < g.rows ? min(max(g.row_bytes - col_byte, 0), 16) : 0;
  copy16(dst, g.base + static_cast<long>(r) * g.ld + col_byte, g.base, valid, g.vec);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major tiles
// use only the stride between 8-row groups (sbo, 1024 bytes); MN-major
// tiles also the stride between 64-wide MN panels (lbo).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// Descriptors of k16 slice kk of a 64-deep stage: K-major rows of 128
// bytes, or MN-major panels of 8 KB whose k rows are 128 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, 8192, 1024);
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

// D (64 x 128) += A (64 x 16, bf16, in registers: the mma.m16n8k16 A
// fragment of each warp's 16 rows) B (16 x 128, shared memory; TB as above).
// A's registers must not change until the wgmma has been waited for.
template <int TB>
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The activation of the tensor-core epilogues: silu, sigmoid and softplus
// through the fast exponential (and division), a few f32 ulps from the
// reference and far below the bf16 rounding that follows (the IEEE forms
// call a slow path that cost the m = 2048 epilogue more than its whole
// product; sigmoid's exponent is clamped where 1 + e^-v would pass 2^126,
// past which the fast division gives 0); the others as the reference
// computes them.
__device__ __forceinline__ float activate_tc(float v, int act) {
  switch (act) {
    case ACT_SILU: return __fdividef(v, 1.0f + __expf(-v));
    case ACT_SIGMOID: return __fdividef(1.0f, 1.0f + __expf(fminf(-v, 80.0f)));
    case ACT_SOFTPLUS: return fmaxf(v, 0.0f) + log1pf(__expf(-fabsf(v)));
    default: return activate(v, act);
  }
}

__device__ __forceinline__ uint32_t bar_u32(const uint64_t* b) { return smem_u32(b); }
__device__ __forceinline__ void bar_init(const uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
// The same for a 3-D tensor map, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, const uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(bar_u32(b)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// 3-D TMA store of the box at (c0 innermost, c1, c2) from shared memory at
// src: elements outside the tensor are not written. Completion is tracked
// by bulk groups of the issuing thread.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until the issuing thread's bulk groups but the newest N have read
// their shared memory (READ) or completed.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- mma.sync
// The warp-level tensor-core path of the small-batch bodies (bdmm's decode
// grid, the fused MLP, the paged-attention split body). Fragment layouts
// (PTX ISA, mma.m16n8k16), lane = 4 gq + c: A holds rows gq and gq + 8,
// columns 2c, 2c + 1 (+ 8); B columns gq, rows 2c, 2c + 1 (+ 8); C rows gq
// (regs 0, 1) and gq + 8 (regs 2, 3), columns 2c, 2c + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
// D (16 x 8, f32) += A (16 x 16, bf16, row) B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix.trans of int8 rows (8 rows of 16 bytes seen as 8 b16 columns)
// gives lane 4 gq + c the 2 x 2 bytes of rows 2c, 2c + 1 at columns 2gq,
// 2gq + 1: bytes 0..3 = [2c][2gq], [2c][2gq+1], [2c+1][2gq], [2c+1][2gq+1].
// widen_pairs turns them into two bf16 pairs along the rows, exactly (|q| <=
// 128 has at most 8 significant bits): `even` = column 2gq (rows 2c, 2c + 1),
// `odd` = column 2gq + 1. Each byte goes to f32 as 2^23 + (q + 128) by a byte
// permute, one subtraction gives q, and the upper halves of two f32 are two
// bf16: 11 integer and f32 instructions for 4 weights, no conversions.
__device__ __forceinline__ void widen_pairs(uint32_t v, uint32_t& even, uint32_t& odd) {
  const uint32_t u = v ^ 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
  const uint32_t f0 = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)), bias));
  const uint32_t f1 = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)), bias));
  const uint32_t f2 = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)), bias));
  const uint32_t f3 = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)), bias));
  even = __byte_perm(f0, f2, 0x7632);
  odd = __byte_perm(f1, f3, 0x7632);
}

// Swizzled shared-memory rows for ldmatrix: chunk c (16 bytes) of row r. A
// 128-byte row keeps chunk c at c ^ (r % 8) (KMajor above); a 64-byte row
// (64 int8 channels) at c ^ ((r / 2) % 4), so 8 consecutive rows at one
// chunk fill the 8 bank groups; wider rows XOR the chunk's low 3 bits with
// (r / ROW_DIV) % 8.
template <int ROW_BYTES, int ROW_DIV = 1>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (ROW_BYTES == 64)
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else
    return r * ROW_BYTES + ((c ^ ((r / ROW_DIV) & 7)) << 4);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- clusters
// A split reduction inside one launch: the blocks of a split form a thread
// block cluster (co-scheduled on one GPC), each leaves its f32 partial in
// its own shared memory, and after a cluster barrier every block adds a
// share of the outputs, reading the partials of the others over the
// SM-to-SM network in the fixed order rank 0, 1, ... No workspace, no
// ticket, no float atomics: the sums do not depend on the blocks' order.
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster arrives; the release / acquire
// pair makes the shared-memory writes before it visible to the reads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
                   "memory");
}
// 4 floats at shared address `addr` (this block's layout) of block `rank`
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote) : "memory");
  return v;
}
// Groups g of 4 outputs (0 <= g < groups), this block's share of them (g =
// rank, rank + split, ...): the sum of the split partials at part + 4g of
// every block, added from zero in rank order with every load in flight at
// once (MAXS >= split); out(g, v) stores them.
template <int MAXS, class Out>
__device__ __forceinline__ void cluster_add(uint32_t part, int split, int groups, Out out) {
  for (int g = cluster_rank() + split * static_cast<int>(threadIdx.x); g < groups;
       g += split * static_cast<int>(blockDim.x)) {
    float4 t[MAXS];
#pragma unroll
    for (int r = 0; r < MAXS; ++r)
      if (r < split) t[r] = ld_cluster4(part + 16 * g, r);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAXS; ++r)
      if (r < split) {
        v.x = __fadd_rn(v.x, t[r].x);
        v.y = __fadd_rn(v.y, t[r].y);
        v.z = __fadd_rn(v.z, t[r].z);
        v.w = __fadd_rn(v.w, t[r].w);
      }
    out(g, v);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A kernel's `bytes` of dynamic shared memory allowed, with the largest
// carveout (as many blocks as the bytes allow share an SM) and, for
// clusters above 8 blocks, Hopper's non-portable sizes (at most 16).
template <class Kernel>
cudaError_t prepare(Kernel kern, int bytes, int cluster_blocks = 1) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && cluster_blocks > 8)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <class Kernel, class... P>
cudaError_t launch(Kernel kern, int threads, int bytes, dim3 grid, cudaStream_t s,
                   const P&... params) {
  const cudaError_t e = prepare(kern, bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, bytes, s>>>(params...);
  return cudaGetLastError();
}

// The same with the grid cut into clusters of `cluster` blocks (x, y, z).
template <class... P>
cudaError_t launch_cluster(void (*kern)(P...), int threads, int bytes, dim3 grid, dim3 cluster,
                           cudaStream_t s, const P&... params) {
  cudaError_t e = prepare(kern, bytes, cluster.x * cluster.y * cluster.z);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, params...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// A tensor of `rank` dims of 1-, 2- or 4-byte elements (uint8, bf16, f32), dims[0] innermost and
// contiguous, strides[i] the bytes between steps of dims[i + 1], read in
// boxes of box[0..rank), 128-byte swizzled (the wgmma tiles) or plain.
// The base and every stride must be 16-byte aligned.
inline bool tensor_map_nd(CUtensorMap* map, const void* base, int elem_bytes, int rank,
                          const long* dims, const long* strides, const int* box, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || rank < 2 || rank > 3) return false;
  cuuint64_t d[3], st[2];
  cuuint32_t bx[3], unit[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    if (i + 1 < rank) st[i] = static_cast<cuuint64_t>(strides[i]);
  }
  return fn(map,
            elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
            : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            rank, const_cast<void*>(base), d, st, bx, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) matrix as boxes of (box_rows, box_cols).
inline bool tensor_map(CUtensorMap* map, const void* base, int elem_bytes, long rows, long cols,
                       int box_rows, int box_cols, bool swizzle) {
  const long dims[2] = {cols, rows}, strides[1] = {cols * elem_bytes};
  const int box[2] = {box_cols, box_rows};
  return tensor_map_nd(map, base, elem_bytes, 2, dims, strides, box, swizzle);
}

inline bool vec_ok(int v) { return v == 1 || v == 2 || v == 4 || v == 8 || v == 16; }

}  // namespace tc
}  // namespace repro_torch
