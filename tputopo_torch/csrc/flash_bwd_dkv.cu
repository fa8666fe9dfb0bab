// Flash-attention backward, dK and dV, for Hopper (sm_90a), written by hand
// in CUDA C++.
//
// Replaces tputopo/workloads/attention.py:_flash_dkv_kernel, the Pallas TPU
// kernel that _flash_backward launches, with P recomputed as in
// _recompute_p.  Per (batch, head) and kv row j it computes
//   P_ij  = exp(scale * q_i . k_j - LSE_i), 0 where the causal mask
//           k_pos <= q_pos fails or i lies past S;
//   dV_j  = sum_i P_ij dO_i, with P cast to dO's dtype;
//   dP_ij = dO_i . v_j,  dS_ij = P_ij (dP_ij - D_i) scale in f32;
//   dK_j  = sum_i dS_ij q_i, with dS cast to q's dtype;
// both with f32 accumulation, written in k's and v's dtypes.
//
// Layout as flash_bwd_dq.cu: [B, S, N, H] tensors read in place, LSE and D
// [B*N, S] f32, H a multiple of 8 up to 128.  q rows past S load as zeros
// and would give scale * S^T = 0, so P = exp(-LSE) != 0: they are masked
// by position (q_pos < S), and the LSE and D are never read past S.
//
// What bounds it on this card: four products per (q, kv) pair, 8 S^2/2 H
// flops per head when causal against ~6 S H bytes: bound by tensor-core
// operations at the model's shape.  The design:
//  - one thread block per (b*n, 64-row kv tile); a loop inside the block
//    walks the q tiles (when causal, only those at or below the diagonal),
//    and each block owns its dK and dV rows: no atomics, and the result is
//    deterministic, as in the reference's two-kernel scheme;
//  - bf16: four warps, each owning 16 kv rows.  The transposed tiles are
//    computed directly, so nothing is transposed through shared memory:
//    S^T = K Q^T (the forward's Q K^T with the roles swapped), P^T from it
//    with the LSE indexed by column, held in the accumulator layout with kv
//    rows, which packed to bf16 is the A operand of dV += P^T dO (dO the B
//    operand, as V is in the forward); dP^T = V dO^T; dS^T = P^T (dP^T - D)
//    scale; dK += dS^T Q.  The q tile's LSE and D rows sit in shared memory;
//  - register pressure: the dK and dV accumulators alone are 2 x 64 f32
//    registers a thread at H = 128, so each q tile is taken in two halves
//    of 32 columns, which halves the S^T and dP^T fragments (ptxas for
//    sm_90a still reports 255 registers and an 8-byte spill at H = 128);
//  - f32: two threads per kv row, each owning half of the head dim of the
//    accumulators; their partial dot products meet by one shuffle;
//  - kv tiles are issued heaviest first (when causal, tile 0 sees every
//    q tile).
// Pipelined loads and wgmma are later work: this version is right first.

#include "flash_common.cuh"

namespace {

template <int HCH>
__global__ void __launch_bounds__(128)
flash_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dd,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int N,
               int H, int causal, float scale) {
  constexpr int HP = HCH * 16;
  constexpr int LD = HP + 8;
  constexpr int HN = HP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BKV * LD;
  __nv_bfloat16* sQ = sV + BKV * LD;
  __nv_bfloat16* sO = sQ + BQ * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + BQ * LD);  // the q tile's LSE
  float* sD = sL + BQ;                                  // and D

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int kvt = blockIdx.y;  // causal work shrinks with the tile index
  const int kv0 = kvt * BKV;
  const size_t rs = (size_t)N * H;
  const size_t base = (size_t)b * S * rs + (size_t)n * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's kv rows: r0 and r0 + 8
  const int kvrow[2] = {kv0 + r0, kv0 + r0 + 8};

  load_tile_bf16<HP, LD>(sK, k + base, kv0, S, H, rs);
  load_tile_bf16<HP, LD>(sV, v + base, kv0, S, H, rs);

  float dk_acc[HN][4], dv_acc[HN][4];
#pragma unroll
  for (int hn = 0; hn < HN; ++hn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[hn][e] = dv_acc[hn][e] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  for (int qt = causal ? kvt : 0; qt < n_qt; ++qt) {  // BQ == BKV
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile_bf16<HP, LD>(sQ, q + base, q0, S, H, rs);
    load_tile_bf16<HP, LD>(sO, dout + base, q0, S, H, rs);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const bool in = q0 + i < S;
      sL[i] = in ? lse[(size_t)bn * S + q0 + i] : 0.f;
      sD[i] = in ? dd[(size_t)bn * S + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns.
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HCH; ++kc) {
        uint32_t ka[4], va[4];
        load_a_frag<LD>(ka, sK, r0, kc, t);
        load_a_frag<LD>(va, sV, r0, kc, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_rows<LD>(st[j], ka, sQ, half * 4 + j, kc, g, t);
          mma_rows<LD>(dpt[j], va, sO, half * 4 + j, kc, g, t);
        }
      }

      // P^T into st, dS^T into dpt.  Element e sits at kv row
      // r0 + 8 * (e >> 1), q column t * 2 + (e & 1) of its 8-column tile.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (half * 4 + j) * 8 + t * 2 + (e & 1);  // q within the tile
          const int q_pos = q0 + c, kv_pos = kvrow[e >> 1];
          const bool live = q_pos < S && kv_pos < S && !(causal && kv_pos > q_pos);
          const float p = live ? expf(st[j][e] * scale - sL[c]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - sD[c]) * scale;
        }

      // dV += P^T dO and dK += dS^T Q over this half's two 16-row q chunks,
      // P^T and dS^T rounded to bf16 (dO's and q's dtype) from the registers.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {pack_f32(st[2 * kk][0], st[2 * kk][1]),
                                pack_f32(st[2 * kk][2], st[2 * kk][3]),
                                pack_f32(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_f32(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t sa[4] = {pack_f32(dpt[2 * kk][0], dpt[2 * kk][1]),
                                pack_f32(dpt[2 * kk][2], dpt[2 * kk][3]),
                                pack_f32(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                pack_f32(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
        mma_cols<LD, HN>(dv_acc, pa, sO, half * 2 + kk, g, t);
        mma_cols<LD, HN>(dk_acc, sa, sQ, half * 2 + kk, g, t);
      }
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (kvrow[ri] >= S) continue;
    const size_t off = base + (size_t)kvrow[ri] * rs;
#pragma unroll
    for (int hn = 0; hn < HN; ++hn) {
      const int col = hn * 8 + t * 2;
      if (col < H) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            __floats2bfloat162_rn(dk_acc[hn][2 * ri], dk_acc[hn][2 * ri + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(dv_acc[hn][2 * ri], dv_acc[hn][2 * ri + 1]);
      }
    }
  }
}

// Two threads per kv row: thread 2 r + h owns columns [h HH, h HH + HH) of
// row r's accumulators.  K and V sit in shared memory as half-rows of odd
// stride HH + 1, so the 32 threads of a warp read 32 different banks.
template <int HCH>
__global__ void __launch_bounds__(2 * BKV)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dd,
              float* __restrict__ dk, float* __restrict__ dv, int S, int N, int H,
              int causal, float scale) {
  constexpr int HP = HCH * 16;
  constexpr int HH = HP / 2;
  constexpr int LH = HH + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // [2 BKV][LH] half-rows
  float* sV = sK + 2 * BKV * LH;                // [2 BKV][LH]
  float* sQ = sV + 2 * BKV * LH;                // [BQ][HP]
  float* sO = sQ + BQ * HP;                     // dO, [BQ][HP]
  float* sL = sO + BQ * HP;                     // [BQ]
  float* sD = sL + BQ;                          // [BQ]

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int kvt = blockIdx.y;
  const int kv0 = kvt * BKV;
  const size_t rs = (size_t)N * H;
  const size_t base = (size_t)b * S * rs + (size_t)n * H;
  const int tid = threadIdx.x, h0 = (tid & 1) * HH;
  const int kv_pos = kv0 + (tid >> 1);

  for (int idx = tid; idx < BKV * HP; idx += blockDim.x) {
    const int r = idx / HP, c = idx % HP;
    const bool in = kv0 + r < S && c < H;
    const size_t off = base + (size_t)(kv0 + r) * rs + c;
    const int at = (2 * r + c / HH) * LH + c % HH;
    sK[at] = in ? k[off] : 0.f;
    sV[at] = in ? v[off] : 0.f;
  }
  float dk_acc[HH], dv_acc[HH];
#pragma unroll
  for (int c = 0; c < HH; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  for (int qt = causal ? kvt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    for (int idx = tid; idx < BQ * HP; idx += blockDim.x) {
      const int r = idx / HP, c = idx % HP;
      const bool in = q0 + r < S && c < H;
      const size_t off = base + (size_t)(q0 + r) * rs + c;
      sQ[idx] = in ? q[off] : 0.f;
      sO[idx] = in ? dout[off] : 0.f;
    }
    for (int i = tid; i < BQ; i += blockDim.x) {
      const bool in = q0 + i < S;
      sL[i] = in ? lse[(size_t)bn * S + q0 + i] : 0.f;
      sD[i] = in ? dd[(size_t)bn * S + q0 + i] : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < BQ; ++i) {
      const int q_pos = q0 + i;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < HH; ++c) {
        s = fmaf(sK[tid * LH + c], sQ[i * HP + h0 + c], s);
        dp = fmaf(sV[tid * LH + c], sO[i * HP + h0 + c], dp);
      }
      // every lane shuffles, live or not: the pair's halves meet here
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const bool live = q_pos < S && kv_pos < S && !(causal && kv_pos > q_pos);
      if (!live) continue;
      const float p = expf(s * scale - sL[i]);
      const float ds = p * (dp - sD[i]) * scale;
#pragma unroll
      for (int c = 0; c < HH; ++c) {
        dv_acc[c] = fmaf(p, sO[i * HP + h0 + c], dv_acc[c]);
        dk_acc[c] = fmaf(ds, sQ[i * HP + h0 + c], dk_acc[c]);
      }
    }
  }

  if (kv_pos < S) {
    const size_t off = base + (size_t)kv_pos * rs + h0;
#pragma unroll
    for (int c = 0; c < HH; ++c)
      if (h0 + c < H) {
        dk[off + c] = dk_acc[c];
        dv[off + c] = dv_acc[c];
      }
  }
}

template <int HCH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dd, void* dk, void* dv, int B, int S,
                   int N, int H, int causal, float scale, cudaStream_t stream) {
  constexpr int HP = HCH * 16;
  const dim3 grid(B * N, (S + BKV - 1) / BKV);
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem =
        4 * BQ * (HP + 8) * sizeof(__nv_bfloat16) + 2 * BQ * sizeof(float);
    if ((err = allow_smem(flash_dkv_bf16<HCH>, smem)) != cudaSuccess) return err;
    flash_dkv_bf16<HCH><<<grid, 128, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
        dd, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, N, H,
        causal, scale);
  } else {
    const size_t smem =
        (2 * 2 * BKV * (HP / 2 + 1) + 2 * BQ * HP + 2 * BQ) * sizeof(float);
    if ((err = allow_smem(flash_dkv_f32<HCH>, smem)) != cudaSuccess) return err;
    flash_dkv_f32<HCH><<<grid, 2 * BKV, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, dd,
        static_cast<float*>(dk), static_cast<float*>(dv), S, N, H, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk, dv: [B, S, N, H] contiguous, all bf16 (dtype 1) or all
// f32 (dtype 0); lse, d: [B*N, S] f32.  Returns the launch's cudaError_t
// (0 on success); the launch is asynchronous on ``stream``.
extern "C" int tputopo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* d,
                                     void* dk, void* dv, int B, int S, int N, int H,
                                     int causal, int dtype, float scale, void* stream) {
  if (bad_shape(B, S, N, H, dtype)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((H + 15) / 16) {
    case 1: return (int)launch<1>(dtype, q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 2: return (int)launch<2>(dtype, q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 3: return (int)launch<3>(dtype, q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 4: return (int)launch<4>(dtype, q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 5: return (int)launch<5>(dtype, q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 6: return (int)launch<6>(dtype, q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 7: return (int)launch<7>(dtype, q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    default: return (int)launch<8>(dtype, q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
  }
}
