// Flash-attention backward, dQ, for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces tputopo/workloads/attention.py:_flash_dq_kernel, the Pallas TPU
// kernel that _flash_backward launches, with P recomputed as in
// _recompute_p.  Per (batch, head) and q row i it computes
//   P_ij  = exp(scale * q_i . k_j - LSE_i), 0 where the causal mask
//           k_pos <= q_pos fails or j lies past S;
//   dP_ij = dO_i . v_j;
//   dS_ij = P_ij (dP_ij - D_i) scale, in f32, then cast to K's dtype;
//   dQ_i  = sum_j dS_ij k_j with f32 accumulation, written in q's dtype.
// D = rowsum(dO o O) is computed in f32 by the caller, as the reference
// does outside its kernel.
//
// Layout: q, k, v, dO and dQ are [B, S, N, H], contiguous, read in place;
// LSE and D are [B*N, S] f32.  H is a multiple of 8 up to 128 and is
// zero-padded to a multiple of 16 in shared memory; rows past S load as
// zeros, are masked as keys by position and are never stored, and the LSE
// and D are never read past S.
//
// What bounds it on this card: three products per (q, kv) pair (Q K^T,
// dO V^T, dS K), 6 S^2/2 H flops per head when causal against ~5 S H
// bytes moved, so at S = 2048, H = 128 it is bound by tensor-core
// operations.  The design:
//  - one thread block per (b*n, 64-row q tile); a loop inside the block
//    walks the 64-row kv tiles (when causal, only those at or left of the
//    diagonal).  It takes the place of the TPU grid's sequential kv axis,
//    and each block owns its dQ rows: no atomics, one summation order;
//  - bf16: four warps, each owning 16 q rows.  S = Q K^T and dP = dO V^T
//    run as mma.sync m16n8k16 with the same operand pattern; dS is formed
//    in the accumulator registers, packed to bf16 in registers as the A
//    operand of dS K, with K as the B operand exactly as V is in the
//    forward's P V.  Q and dO stay in shared memory and their fragments are
//    re-read per kv tile, which keeps the thread under ~170 registers;
//  - f32: one thread per q row, FMA loops;
//  - q tiles are issued heaviest first (causal work grows with the tile).
// Pipelined loads and wgmma are later work: this version is right first.

#include "flash_common.cuh"

namespace {

template <int HCH>
__global__ void __launch_bounds__(128)
flash_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dd,
              __nv_bfloat16* __restrict__ dq, int S, int N, int H, int causal,
              float scale) {
  constexpr int HP = HCH * 16;
  constexpr int LD = HP + 8;
  constexpr int HN = HP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + BQ * LD;  // dO
  __nv_bfloat16* sK = sO + BQ * LD;
  __nv_bfloat16* sV = sK + BKV * LD;

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int q0 = qt * BQ;
  const size_t rs = (size_t)N * H;
  const size_t base = (size_t)b * S * rs + (size_t)n * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int row[2] = {q0 + r0, q0 + r0 + 8};
  float lse_r[2], d_r[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const bool in = row[ri] < S;
    lse_r[ri] = in ? lse[(size_t)bn * S + row[ri]] : 0.f;
    d_r[ri] = in ? dd[(size_t)bn * S + row[ri]] : 0.f;
  }

  load_tile_bf16<HP, LD>(sQ, q + base, q0, S, H, rs);
  load_tile_bf16<HP, LD>(sO, dout + base, q0, S, H, rs);

  float acc[HN][4];
#pragma unroll
  for (int hn = 0; hn < HN; ++hn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[hn][e] = 0.f;

  const int n_kt = (S + BKV - 1) / BKV;
  const int kt_end = causal ? min(n_kt, qt + 1) : n_kt;  // BQ == BKV
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<HP, LD>(sK, k + base, kt * BKV, S, H, rs);
    load_tile_bf16<HP, LD>(sV, v + base, kt * BKV, S, H, rs);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 kv columns.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HCH; ++kc) {
      uint32_t qa[4], oa[4];
      load_a_frag<LD>(qa, sQ, r0, kc, t);
      load_a_frag<LD>(oa, sO, r0, kc, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mma_rows<LD>(s[nt], qa, sK, nt, kc, g, t);
        mma_rows<LD>(dp[nt], oa, sV, nt, kc, g, t);
      }
    }

    // dS = P (dP - D) scale in place of S.  Element e sits at row
    // r0 + 8 * (e >> 1), column t * 2 + (e & 1) of its 8-column tile.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const int col = kt * BKV + nt * 8 + t * 2 + (e & 1);
        const bool live = col < S && row[ri] < S && !(causal && col > row[ri]);
        const float p = live ? expf(s[nt][e] * scale - lse_r[ri]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - d_r[ri]) * scale;
      }

    // dQ += dS K, dS rounded to bf16 (K's dtype) straight from the registers.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t sa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_cols<LD, HN>(acc, sa, sK, kk, g, t);
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= S) continue;
    __nv_bfloat16* out = dq + base + (size_t)row[ri] * rs;
#pragma unroll
    for (int hn = 0; hn < HN; ++hn) {
      const int col = hn * 8 + t * 2;
      if (col < H)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[hn][2 * ri], acc[hn][2 * ri + 1]);
    }
  }
}

template <int HCH>
__global__ void __launch_bounds__(BQ)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dd,
             float* __restrict__ dq, int S, int N, int H, int causal, float scale) {
  constexpr int HP = HCH * 16;
  constexpr int LQ = HP + 1;  // odd stride: each thread reads its own row
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [BQ][LQ]
  float* sO = sQ + BQ * LQ;                     // dO, [BQ][LQ]
  float* sK = sO + BQ * LQ;                     // [BKV][HP]
  float* sV = sK + BKV * HP;                    // [BKV][HP]

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const size_t rs = (size_t)N * H;
  const size_t base = (size_t)b * S * rs + (size_t)n * H;
  const int i = threadIdx.x, row = q0 + i;
  const bool row_in = row < S;
  const float lse_i = row_in ? lse[(size_t)bn * S + row] : 0.f;
  const float d_i = row_in ? dd[(size_t)bn * S + row] : 0.f;

  for (int idx = threadIdx.x; idx < BQ * HP; idx += blockDim.x) {
    const int r = idx / HP, c = idx % HP;
    const bool in = q0 + r < S && c < H;
    const size_t off = base + (size_t)(q0 + r) * rs + c;
    sQ[r * LQ + c] = in ? q[off] : 0.f;
    sO[r * LQ + c] = in ? dout[off] : 0.f;
  }
  float acc[HP];
#pragma unroll
  for (int c = 0; c < HP; ++c) acc[c] = 0.f;

  const int n_kt = (S + BKV - 1) / BKV;
  const int kt_end = causal ? min(n_kt, qt + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BKV * HP; idx += blockDim.x) {
      const int r = idx / HP, c = idx % HP;
      const bool in = kt * BKV + r < S && c < H;
      const size_t off = base + (size_t)(kt * BKV + r) * rs + c;
      sK[idx] = in ? k[off] : 0.f;
      sV[idx] = in ? v[off] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < BKV; ++j) {
      const int col = kt * BKV + j;
      if (!row_in || col >= S || (causal && col > row)) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < HP; ++c) {
        s = fmaf(sQ[i * LQ + c], sK[j * HP + c], s);
        dp = fmaf(sO[i * LQ + c], sV[j * HP + c], dp);
      }
      const float ds = expf(s * scale - lse_i) * (dp - d_i) * scale;
#pragma unroll
      for (int c = 0; c < HP; ++c) acc[c] = fmaf(ds, sK[j * HP + c], acc[c]);
    }
  }

  if (row_in) {
    float* out = dq + base + (size_t)row * rs;
#pragma unroll
    for (int c = 0; c < HP; ++c)
      if (c < H) out[c] = acc[c];
  }
}

template <int HCH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dd, void* dq, int B, int S, int N, int H,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int HP = HCH * 16;
  const dim3 grid(B * N, (S + BQ - 1) / BQ);
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = 4 * BQ * (HP + 8) * sizeof(__nv_bfloat16);
    if ((err = allow_smem(flash_dq_bf16<HCH>, smem)) != cudaSuccess) return err;
    flash_dq_bf16<HCH><<<grid, 128, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
        dd, static_cast<__nv_bfloat16*>(dq), S, N, H, causal, scale);
  } else {
    const size_t smem = (2 * BQ * (HP + 1) + 2 * BKV * HP) * sizeof(float);
    if ((err = allow_smem(flash_dq_f32<HCH>, smem)) != cudaSuccess) return err;
    flash_dq_f32<HCH><<<grid, BQ, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, dd,
        static_cast<float*>(dq), S, N, H, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq: [B, S, N, H] contiguous, all bf16 (dtype 1) or all f32
// (dtype 0); lse, d: [B*N, S] f32.  Returns the launch's cudaError_t (0 on
// success); the launch is asynchronous on ``stream``.
extern "C" int tputopo_flash_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* d,
                                    void* dq, int B, int S, int N, int H, int causal,
                                    int dtype, float scale, void* stream) {
  if (bad_shape(B, S, N, H, dtype)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((H + 15) / 16) {
    case 1: return (int)launch<1>(dtype, q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 2: return (int)launch<2>(dtype, q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 3: return (int)launch<3>(dtype, q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 4: return (int)launch<4>(dtype, q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 5: return (int)launch<5>(dtype, q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 6: return (int)launch<6>(dtype, q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 7: return (int)launch<7>(dtype, q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    default: return (int)launch<8>(dtype, q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
  }
}
