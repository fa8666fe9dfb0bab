// Shared pieces of the flash-attention kernels: the f32 bodies' tile sizes,
// the argument check, the shared-memory allowance and register packing.  The
// bf16 bodies (wgmma, TMA) take their Hopper pieces from sm90.cuh.
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

// Two values into one 32-bit register, the first in the low half (the
// lower row or column index of an mma fragment).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
