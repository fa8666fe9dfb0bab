// Shared pieces of the flash-attention kernels: the f32 bodies' tile sizes,
// the argument check and register packing (all three sources), and the bf16
// mma.sync m16n8k16 wrapper and tile loaders of flash_bwd_dq.cu.  The wgmma
// bodies of flash_fwd.cu and flash_bwd_dkv.cu take their Hopper pieces from
// sm90.cuh.
//
// mma.sync m16n8k16 fragment layout, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major)  a0: row g,     cols 2t, 2t+1    a1: row g+8, cols 2t, 2t+1
//                           a2: row g,     cols 2t+8, 2t+9  a3: row g+8, cols 2t+8, 2t+9
//   B (16 x 8, col major)   b0: rows 2t, 2t+1 of col g      b1: rows 2t+8, 2t+9 of col g
//   C (16 x 8, f32)         c0, c1: row g, cols 2t, 2t+1    c2, c3: row g+8, cols 2t, 2t+1
// So an f32 accumulator over two neighbouring 8-column tiles is, packed to
// bf16 pairwise, the A operand of the next product over those 16 columns.
//
// Every source is rebuilt when a header changes: the library's name hashes
// the .cu and every .cuh of csrc/ (_kernels.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // q rows per tile
constexpr int BKV = 64;  // kv rows per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values into one 32-bit register, the first in the low half (the
// lower row or column index of an mma fragment).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand over columns [16 kc, 16 kc + 16) of the 16 rows starting at
// r0 - g of a row-major [rows][LD] shared tile (r0 = this thread's row g).
template <int LD>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                            int r0, int kc, int t) {
  const __nv_bfloat16* p = tile + r0 * LD + kc * 16 + t * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// The B operand of X Y^T, where Y is a row-major shared tile: columns
// [8 nt, 8 nt + 8) of the product are rows of Y, the depth runs along
// Y's row, so each register is one aligned pair of a row.
template <int LD>
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int nt, int kc, int g,
                                         int t) {
  const __nv_bfloat16* p = tile + (nt * 8 + g) * LD + kc * 16 + t * 2;
  mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(p),
           *reinterpret_cast<const uint32_t*>(p + 8));
}

// The B operand of X Y, where Y is a row-major shared tile: the depth runs
// down Y's rows [16 kk, 16 kk + 16), so each register gathers two rows of
// one column.  Accumulates into acc[hn] for every 8-column tile hn of Y.
template <int LD, int HN>
__device__ __forceinline__ void mma_cols(float (&acc)[HN][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int kk, int g, int t) {
  const __nv_bfloat16* p = tile + (kk * 16 + t * 2) * LD + g;
#pragma unroll
  for (int hn = 0; hn < HN; ++hn) {
    const uint32_t b0 = pack_bf16(p[hn * 8], p[LD + hn * 8]);
    const uint32_t b1 = pack_bf16(p[8 * LD + hn * 8], p[9 * LD + hn * 8]);
    mma_bf16(acc[hn], a, b0, b1);
  }
}

// Rows [row0, row0 + 64) of one head of a [B, S, N, H] bf16 tensor into a
// [64][LD] shared tile, 16 bytes per thread per step; zeros past S and H.
template <int HP, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src, int row0,
                                               int S, int H, size_t row_stride) {
  constexpr int CH = HP / 8;
  for (int i = threadIdx.x; i < BQ * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && c < H)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The common argument check of the three entry points.
inline bool bad_shape(int B, int S, int N, int H, int dtype) {
  return B < 1 || S < 1 || N < 1 || H < 8 || H > 128 || H % 8 != 0 ||
         (dtype != 0 && dtype != 1) || (S + BQ - 1) / BQ > 65535;
}

}  // namespace
