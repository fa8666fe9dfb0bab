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
// LSE and D are [B*N, S] f32.  H is a multiple of 8 up to 128.  Rows past S
// are never stored, and the LSE and D are never read past S.
//
// What bounds it on this card: three products per (q, kv) pair (Q K^T,
// dO V^T, dS K), 6 S^2/2 H flops per head when causal against ~5 S H
// bytes moved, so at S = 2048, H = 128 it is bound by tensor-core
// operations.  What kept the first version (warp-level MMA) at ~9x
// its bound and 1.7x SDPA's whole backward: no copy overlapped the math
// (plain loads between two block barriers per kv tile), the B operand of
// dS K was gathered from shared memory one bf16 at a time, the warp-level
// MMA, and 64-row q tiles that read K and V once per 64 q rows.  The bf16
// design is the dK/dV kernel's with the roles of q and kv swapped:
//  - one block per (b*n, 128-row q tile), q tiles issued heaviest first
//    (causal work grows with the tile index); a loop inside the block walks
//    the 64-row kv tiles (when causal, only those at or left of the
//    diagonal of the block's last row).  Each block owns its dQ rows: no
//    atomics, one summation order, as in the reference's two-kernel scheme;
//  - three warpgroups: two consumers of 64 q rows each, whose dQ
//    accumulator (m64nH f32) stays in registers for the whole kv loop, and
//    one producer, which gives up its registers (setmaxnreg) to them;
//  - Q and dO come in once by TMA (csrc/sm90.cuh), and each consumer thread
//    reads its two rows' LSE (prescaled by log2 e) and D once into
//    registers.  K and V go through a ring of two stages: one producer
//    thread issues the TMA copies, the stage's "full" mbarrier completes
//    when they have landed, its "empty" mbarrier when both consumers are
//    done with it, so the next tile's copies run during the current tile's
//    math.  A third stage, and issuing the next tile's S and dP before
//    waiting on this tile's dQ product, measured no faster;
//  - three wgmmas per kv tile: S = Q K^T and dP = dO V^T (m64n64k16, both
//    operands from shared memory, K-major); P = exp2(S scale log2 e - LSE
//    log2 e) and dS = P (dP - D) scale in registers; then dQ += dS K
//    (m64nHk16, dS packed to bf16 in registers as the A operand, K from the
//    same shared tile, MN-major);
//  - the position masks are applied only on tiles that cross the diagonal
//    or S; a kv tile wholly above a consumer's q rows (the block's last
//    tile, for the first consumer) is waited on and released, not computed;
//  - f32, the dtype of the tests: one thread per q row, FMA loops, 64-row
//    tiles (flash_common.cuh), unchanged.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int DQ_BQ = 128;      // q rows per block: two consumer warpgroups of 64
constexpr int DQ_BKV = 64;      // kv rows per pipeline stage
constexpr int DQ_STAGES = 2;    // K/V ring depth
constexpr int DQ_THREADS = 384; // warpgroups 0 and 1 consume, 2 produces
constexpr int DQ_Q_CHUNK = DQ_BQ * ROW_BYTES;    // one 64-column box of Q or dO
constexpr int DQ_KV_CHUNK = DQ_BKV * ROW_BYTES;  // one 64-column box of K or V

template <int HC>  // 64-column chunks of the head dim: 1 (H <= 64) or 2
struct DqSmem {
  static constexpr int DO = HC * DQ_Q_CHUNK;             // Q sits at 0
  static constexpr int STAGES = 2 * HC * DQ_Q_CHUNK;
  static constexpr int STAGE = 2 * HC * DQ_KV_CHUNK;     // K's chunks, then V's
  static constexpr int BARS = STAGES + DQ_STAGES * STAGE;
  static constexpr int BYTES = BARS + (1 + 2 * DQ_STAGES) * 8 + 1024;  // + alignment slack
};

template <int HC>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ dd,
              __nv_bfloat16* __restrict__ dq, int S, int N, int H, int causal, float scale,
              float scale_log2) {
  using L = DqSmem<HC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzled boxes: 1 KB aligned
  const uint32_t bar_q = base + L::BARS;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + DQ_STAGES + s); };

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;  // heaviest tiles first
  const int n_kt = (S + DQ_BKV - 1) / DQ_BKV;
  // causal: the last kv tile holding a key at or left of the block's last row
  const int kt_end = causal ? min(n_kt, (q0 + DQ_BQ + DQ_BKV - 1) / DQ_BKV) : n_kt;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread releases the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    regs_give_up<24>();
    if (threadIdx.x == 2 * 128) {
      mbar_arrive_expect_tx(bar_q, 2 * HC * DQ_Q_CHUNK);
      for (int c = 0; c < HC; ++c) {
        tma_load_4d(base + c * DQ_Q_CHUNK, &tq, bar_q, c * BOX_COLS, n, q0, b);
        tma_load_4d(base + L::DO + c * DQ_Q_CHUNK, &tdo, bar_q, c * BOX_COLS, n, q0, b);
      }
      for (int kt = 0; kt < kt_end; ++kt) {
        const int s = kt % DQ_STAGES;
        mbar_wait(empty(s), ((kt / DQ_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::STAGE);
        const uint32_t sk = base + L::STAGES + s * L::STAGE, sv = sk + HC * DQ_KV_CHUNK;
        for (int c = 0; c < HC; ++c) {
          tma_load_4d(sk + c * DQ_KV_CHUNK, &tk, full(s), c * BOX_COLS, n, kt * DQ_BKV, b);
          tma_load_4d(sv + c * DQ_KV_CHUNK, &tv, full(s), c * BOX_COLS, n, kt * DQ_BKV, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
    regs_take<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int r_lo = q0 + 64 * wg;
    const int row[2] = {r_lo + 16 * warp + g, r_lo + 16 * warp + g + 8};
    const uint32_t sq = base + wg * 64 * ROW_BYTES, sdo = sq + L::DO;
    float lse2[2], d_r[2];  // this thread's rows: LSE log2 e and D
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const bool in = row[ri] < S;
      lse2[ri] = in ? lse[(size_t)bn * S + row[ri]] * LOG2E : 0.f;
      d_r[ri] = in ? dd[(size_t)bn * S + row[ri]] : 0.f;
    }
    // rows wholly past S (the second consumer of a ragged last tile) store
    // nothing, so they need no math
    const bool idle = r_lo >= S;

    float acc[HC * 32];
#pragma unroll
    for (int i = 0; i < HC * 32; ++i) acc[i] = 0.f;
    mbar_wait(bar_q, 0);

    for (int kt = 0; kt < kt_end; ++kt) {
      const int s = kt % DQ_STAGES, kv0 = kt * DQ_BKV;
      mbar_wait(full(s), (kt / DQ_STAGES) & 1);
      if (idle || (causal && kv0 > r_lo + 63)) {  // every pair masked for these q rows
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t sk = base + L::STAGES + s * L::STAGE, sv = sk + HC * DQ_KV_CHUNK;

      // S = Q K^T and dP = dO V^T: 64 q rows x 64 kv columns.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HC * 4; ++kk) {
        const uint32_t q_off = (kk / 4) * DQ_Q_CHUNK + (kk % 4) * 32;
        const uint32_t kv_off = (kk / 4) * DQ_KV_CHUNK + (kk % 4) * 32;
        wgmma_ss(sc, wgmma_desc(sq + q_off, 16, 1024), wgmma_desc(sk + kv_off, 16, 1024), kk);
        wgmma_ss(dp, wgmma_desc(sdo + q_off, 16, 1024), wgmma_desc(sv + kv_off, 16, 1024),
                 kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS into dp.  sc[i] sits at q row row[(i >> 1) & 1], kv column
      // kv0 + c with c = 8 (i / 4) + 2 t + (i & 1).
      const bool edge = kv0 + DQ_BKV > S || (causal && kv0 + DQ_BKV - 1 > r_lo);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int ri = (i >> 1) & 1, col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
        float p = exp2f(sc[i] * scale_log2 - lse2[ri]);
        if (edge && (col >= S || (causal && col > row[ri]))) p = 0.f;
        dp[i] = p * (dp[i] - d_r[ri]) * scale;
      }

      // dQ += dS K, dS rounded to bf16 (K's dtype) from the registers, 16 kv
      // rows a step.
      uint32_t sa[DQ_BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sa[kk][r] = pack_f32(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BKV / 16; ++kk)
        wgmma_rs_mn(acc, sa[kk], wgmma_desc(sk + kk * 16 * ROW_BYTES, DQ_KV_CHUNK, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (row[ri] >= S) continue;
      __nv_bfloat16* out = dq + (((size_t)b * S + row[ri]) * N + n) * H;
#pragma unroll
      for (int j = 0; j < HC * 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < H)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * ri], acc[4 * j + 2 * ri + 1]);
      }
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

template <int HC>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* dd, void* dq, int B, int S, int N,
                        int H, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map_bshd(&tq, q, B, S, N, H, DQ_BQ)) != cudaSuccess) return err;
  if ((err = make_map_bshd(&tk, k, B, S, N, H, DQ_BKV)) != cudaSuccess) return err;
  if ((err = make_map_bshd(&tv, v, B, S, N, H, DQ_BKV)) != cudaSuccess) return err;
  if ((err = make_map_bshd(&tdo, dout, B, S, N, H, DQ_BQ)) != cudaSuccess) return err;
  const size_t smem = DqSmem<HC>::BYTES;
  if ((err = allow_smem(flash_dq_sm90<HC>, smem)) != cudaSuccess) return err;
  const dim3 grid(B * N, (S + DQ_BQ - 1) / DQ_BQ);
  flash_dq_sm90<HC><<<grid, DQ_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<__nv_bfloat16*>(dq), S, N, H, causal, scale,
      scale * LOG2E);
  return cudaGetLastError();
}

template <int HCH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dd, void* dq, int B, int S, int N, int H,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int HP = HCH * 16;
  const dim3 grid(B * N, (S + BQ - 1) / BQ);
  const size_t smem = (2 * BQ * (HP + 1) + 2 * BKV * HP) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(flash_dq_f32<HCH>, smem)) != cudaSuccess) return err;
  flash_dq_f32<HCH><<<grid, BQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dd,
      static_cast<float*>(dq), S, N, H, causal, scale);
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
  if (dtype == 1)
    return (int)(H <= BOX_COLS
                     ? launch_sm90<1>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st)
                     : launch_sm90<2>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st));
  switch ((H + 15) / 16) {
    case 1: return (int)launch_f32<1>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 2: return (int)launch_f32<2>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 3: return (int)launch_f32<3>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 4: return (int)launch_f32<4>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 5: return (int)launch_f32<5>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 6: return (int)launch_f32<6>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    case 7: return (int)launch_f32<7>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
    default: return (int)launch_f32<8>(q, k, v, dout, l, dd, dq, B, S, N, H, causal, scale, st);
  }
}
