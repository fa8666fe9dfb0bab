// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces tputopo/workloads/attention.py:_flash_fwd_kernel, the Pallas TPU
// kernel that _flash_forward_lse launches, with its tile math from
// _masked_scores.  Per (batch, head) it computes
//   S = (1/sqrt(H)) Q K^T with f32 accumulation; under the causal mask
//   k_pos <= q_pos, masked scores are -1e30 and kv tiles wholly above the
//   diagonal are skipped;
//   an online softmax: a running max m and denominator l per row, the f32
//   accumulator rescaled by exp(m_prev - m_new) at each kv tile;
//   P cast to V's dtype before P V;
//   O = acc / l in q's dtype, LSE = m + log l in f32.
//
// Layout: q, k, v and o are [B, S, N, H], contiguous, the layout of the
// public API, read in place with no head transpose; lse is [B*N, S] f32.
// H is a multiple of 8 up to 128 and is zero-padded to a multiple of 16
// in shared memory; rows past S are zero-filled on load, masked as keys
// and never stored.
//
// What bounds it on this card: at the model's shape (S = 2048, H = 128,
// bf16, causal) the work is ~S/2 multiply-adds for every byte the kernel
// must move, far above the H100's ~295 operations per byte, so it is bound
// by tensor-core operations, not by memory.  The design:
//  - one thread block per (b*n, 64-row q tile); a loop inside the block
//    walks the 64-row kv tiles.  It takes the place of the TPU grid's
//    sequential kv axis: here blocks run in parallel, in no order, and
//    nothing carries over between them;
//  - bf16: four warps, each owning 16 q rows.  Q K^T and P V run on the
//    tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulate).  Q's
//    fragments, S and the O accumulator stay in registers, and S's
//    accumulator fragment is re-packed in registers as the A operand of
//    P V, so P never reaches shared or device memory;
//  - f32, the dtype of the tests: one thread per q row, FMA loops;
//  - q tiles are issued heaviest first (causal work grows with the tile
//    index), so the last wave of blocks is short.
// Pipelined loads (cp.async/TMA) and wgmma are later work: this version is
// right and simple first.

#include "flash_common.cuh"

namespace {

template <int HCH>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int S, int N, int H, int causal, float scale) {
  constexpr int HP = HCH * 16;  // padded head dim
  constexpr int LD = HP + 8;    // row stride: 8 extra elements spread the banks
  constexpr int HN = HP / 8;    // 8-column tiles of the O accumulator
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BKV * LD;

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int q0 = qt * BQ;
  const size_t rs = (size_t)N * H;
  const size_t base = (size_t)b * S * rs + (size_t)n * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int r0 = warp * 16 + g;           // this thread's rows: r0 and r0 + 8
  const int row[2] = {q0 + r0, q0 + r0 + 8};

  load_tile_bf16<HP, LD>(sQ, q + base, q0, S, H, rs);
  __syncthreads();
  uint32_t qa[HCH][4];
#pragma unroll
  for (int kc = 0; kc < HCH; ++kc) load_a_frag<LD>(qa[kc], sQ, r0, kc, t);

  float acc[HN][4];
#pragma unroll
  for (int hn = 0; hn < HN; ++hn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[hn][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int n_kt = (S + BKV - 1) / BKV;
  const int kt_end = causal ? min(n_kt, qt + 1) : n_kt;  // BQ == BKV
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<HP, LD>(sK, k + base, kt * BKV, S, H, rs);
    load_tile_bf16<HP, LD>(sV, v + base, kt * BKV, S, H, rs);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns (8 tiles of 8).
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HCH; ++kc) mma_rows<LD>(s[nt], qa[kc], sK, nt, kc, g, t);
    }

    // Scale, mask, and the row max.  Fragment element e sits at row
    // r0 + 8 * (e >> 1), column t * 2 + (e & 1) of its tile.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * BKV + nt * 8 + t * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= S || (causal && col > row[e >> 1])) x = NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      // the four threads of a group hold the 64 columns of a row
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m[ri], mx[ri]);
      alpha[ri] = expf(m[ri] - m_new);
      m[ri] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      sum[ri] += __shfl_xor_sync(0xffffffffu, sum[ri], 1);
      sum[ri] += __shfl_xor_sync(0xffffffffu, sum[ri], 2);
      l[ri] = l[ri] * alpha[ri] + sum[ri];
    }
#pragma unroll
    for (int hn = 0; hn < HN; ++hn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hn][e] *= alpha[e >> 1];

    // O += P V, P rounded to bf16 (V's dtype) straight from the registers.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_cols<LD, HN>(acc, pa, sV, kk, g, t);
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= S) continue;
    __nv_bfloat16* orow = o + base + (size_t)row[ri] * rs;
#pragma unroll
    for (int hn = 0; hn < HN; ++hn) {
      const int col = hn * 8 + t * 2;
      if (col < H)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[hn][2 * ri] / l[ri], acc[hn][2 * ri + 1] / l[ri]);
    }
    if (t == 0) lse[(size_t)bn * S + row[ri]] = m[ri] + logf(l[ri]);
  }
}

template <int HCH>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int N, int H, int causal, float scale) {
  constexpr int HP = HCH * 16;
  constexpr int LQ = HP + 1;  // odd stride: each thread reads its own Q row
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [BQ][LQ]
  float* sK = sQ + BQ * LQ;                     // [BKV][HP]
  float* sV = sK + BKV * HP;                    // [BKV][HP]
  float* sS = sV + BKV * HP;                    // [BKV][BQ] scores, a column per thread

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const size_t rs = (size_t)N * H;
  const size_t base = (size_t)b * S * rs + (size_t)n * H;
  const int i = threadIdx.x, row = q0 + i;

  for (int idx = threadIdx.x; idx < BQ * HP; idx += blockDim.x) {
    const int r = idx / HP, c = idx % HP;
    sQ[r * LQ + c] = (q0 + r < S && c < H) ? q[base + (size_t)(q0 + r) * rs + c] : 0.f;
  }
  float acc[HP];
#pragma unroll
  for (int c = 0; c < HP; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

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

    float mx = NEG_INF;
    for (int j = 0; j < BKV; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < HP; ++c) d = fmaf(sQ[i * LQ + c], sK[j * HP + c], d);
      const int col = kt * BKV + j;
      float x = d * scale;
      if (col >= S || (causal && col > row)) x = NEG_INF;
      sS[j * BQ + i] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < HP; ++c) acc[c] *= alpha;
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(sS[j * BQ + i] - m_new);
      sum += p;
#pragma unroll
      for (int c = 0; c < HP; ++c) acc[c] = fmaf(p, sV[j * HP + c], acc[c]);
    }
    l = l * alpha + sum;
    m = m_new;
  }

  if (row < S) {
    float* orow = o + base + (size_t)row * rs;
#pragma unroll
    for (int c = 0; c < HP; ++c)
      if (c < H) orow[c] = acc[c] / l;
    lse[(size_t)bn * S + row] = m + logf(l);
  }
}

template <int HCH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int N, int H, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int HP = HCH * 16;
  const dim3 grid(B * N, (S + BQ - 1) / BQ);
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = 3 * BQ * (HP + 8) * sizeof(__nv_bfloat16);
    if ((err = allow_smem(flash_fwd_bf16<HCH>, smem)) != cudaSuccess) return err;
    flash_fwd_bf16<HCH><<<grid, 128, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, N,
        H, causal, scale);
  } else {
    const size_t smem = (BQ * (HP + 1) + 2 * BKV * HP + BKV * BQ) * sizeof(float);
    if ((err = allow_smem(flash_fwd_f32<HCH>, smem)) != cudaSuccess) return err;
    flash_fwd_f32<HCH><<<grid, BQ, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, S, N, H, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, S, N, H] contiguous, all bf16 (dtype 1) or all f32
// (dtype 0); lse: [B*N, S] f32.  Returns the launch's cudaError_t (0 on
// success); the launch is asynchronous on ``stream``.
extern "C" int tputopo_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int S, int N, int H, int causal,
                                 int dtype, float scale, void* stream) {
  if (bad_shape(B, S, N, H, dtype)) return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((H + 15) / 16) {
    case 1: return (int)launch<1>(dtype, q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 2: return (int)launch<2>(dtype, q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 3: return (int)launch<3>(dtype, q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 4: return (int)launch<4>(dtype, q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 5: return (int)launch<5>(dtype, q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 6: return (int)launch<6>(dtype, q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 7: return (int)launch<7>(dtype, q, k, v, o, l, B, S, N, H, causal, scale, st);
    default: return (int)launch<8>(dtype, q, k, v, o, l, B, S, N, H, causal, scale, st);
  }
}
