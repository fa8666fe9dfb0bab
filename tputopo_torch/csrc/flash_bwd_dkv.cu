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
// operations at the model's shape.  What kept the first version
// (warp-level MMA) at ~12x its bound: no load overlapped the math (two
// block barriers per q tile), the B operands of P^T dO and dS^T Q were
// gathered from shared memory one bf16 at a time, the warp-level MMA, and
// 255 registers with a spill.  The bf16 design:
//  - one block per (b*n, 128-row kv tile), kv tiles issued heaviest first
//    (when causal, tile 0 sees every q tile); a loop inside the block walks
//    the 64-row q tiles (when causal, only those at or below the diagonal).
//    Each block owns its dK and dV rows: no atomics, and the result is
//    deterministic, as in the reference's two-kernel scheme;
//  - three warpgroups: two consumers of 64 kv rows each, whose dK and dV
//    accumulators (m64nH f32) stay in registers for the whole q loop, and
//    one producer, which gives up its registers (setmaxnreg) to them;
//  - K and V come in once by TMA (csrc/sm90.cuh).  Q, dO and the q tile's
//    LSE and D rows go through a ring of two stages: one producer thread
//    issues the TMA copies of Q and dO, the producer warp loads the LSE
//    (prescaled by log2 e) and D rows with plain loads, and the stage's
//    "full" mbarrier completes when all of it has landed; its "empty"
//    mbarrier completes when both consumers are done with it.  The next
//    tile's copies run during the current tile's math;
//  - four wgmmas per q tile, the transposed tiles computed directly so
//    nothing is transposed through shared memory: S^T = K Q^T and
//    dP^T = V dO^T (m64n64k16, both operands from shared memory, K-major);
//    P^T = exp2(S^T scale log2 e - LSE log2 e) and dS^T = P^T (dP^T - D)
//    scale in registers, the LSE and D indexed by column; then
//    dV += P^T dO and dK += dS^T Q (m64nHk16, P^T and dS^T packed to bf16
//    in registers as the A operand, dO and Q from shared memory MN-major);
//  - the position masks are applied only on tiles that cross the diagonal
//    or S, and a q tile wholly above a consumer's kv rows is skipped;
//  - f32, the dtype of the tests: two threads per kv row, FMA loops, 64-row
//    tiles (flash_common.cuh), unchanged.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int DKV_BKV = 128;      // kv rows per block: two consumer warpgroups of 64
constexpr int DKV_BQ = 64;        // q rows per pipeline stage
constexpr int DKV_STAGES = 2;     // Q/dO ring depth
constexpr int DKV_THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int DKV_KV_CHUNK = DKV_BKV * ROW_BYTES;  // one 64-column box of K or V
constexpr int DKV_Q_CHUNK = DKV_BQ * ROW_BYTES;    // one 64-column box of Q or dO

template <int HC>  // 64-column chunks of the head dim: 1 (H <= 64) or 2
struct DkvSmem {
  static constexpr int V = HC * DKV_KV_CHUNK;             // K sits at 0
  static constexpr int STAGES = 2 * HC * DKV_KV_CHUNK;
  static constexpr int STAGE = 2 * HC * DKV_Q_CHUNK;      // Q's chunks, then dO's
  static constexpr int ROWS = STAGES + DKV_STAGES * STAGE;  // [stage][LSE, D][64] f32
  static constexpr int BARS = ROWS + DKV_STAGES * 2 * DKV_BQ * 4;
  static constexpr int BYTES = BARS + (1 + 2 * DKV_STAGES) * 8 + 1024;  // + alignment slack
};

template <int HC>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ dd,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int N,
               int H, int causal, float scale, float scale_log2) {
  using L = DkvSmem<HC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzled boxes: 1 KB aligned
  float* rows_all = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)) + L::ROWS);
  const uint32_t bar_kv = base + L::BARS;
  auto full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8u * (1 + DKV_STAGES + s); };

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int kv0 = blockIdx.y * DKV_BKV;  // causal work shrinks with the tile index
  const int n_qt = (S + DKV_BQ - 1) / DKV_BQ;
  const int qt0 = causal ? kv0 / DKV_BQ : 0;  // earlier q tiles see none of these keys

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full(s), 32);        // the producer warp's lanes
      mbar_init(empty(s), 2 * 128);  // every consumer thread releases the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    regs_give_up<24>();
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * HC * DKV_KV_CHUNK);
        for (int c = 0; c < HC; ++c) {
          tma_load_4d(base + c * DKV_KV_CHUNK, &tk, bar_kv, c * BOX_COLS, n, kv0, b);
          tma_load_4d(base + L::V + c * DKV_KV_CHUNK, &tv, bar_kv, c * BOX_COLS, n, kv0, b);
        }
      }
      for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
        const int s = i % DKV_STAGES, q0 = qt * DKV_BQ;
        mbar_wait(empty(s), ((i / DKV_STAGES) & 1) ^ 1);
        float* rows = rows_all + s * 2 * DKV_BQ;
        for (int r = lane; r < DKV_BQ; r += 32) {
          const bool in = q0 + r < S;
          rows[r] = in ? lse[(size_t)bn * S + q0 + r] * LOG2E : 0.f;
          rows[DKV_BQ + r] = in ? dd[(size_t)bn * S + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(s), L::STAGE);
          const uint32_t sq = base + L::STAGES + s * L::STAGE, sdo = sq + HC * DKV_Q_CHUNK;
          for (int c = 0; c < HC; ++c) {
            tma_load_4d(sq + c * DKV_Q_CHUNK, &tq, full(s), c * BOX_COLS, n, q0, b);
            tma_load_4d(sdo + c * DKV_Q_CHUNK, &tdo, full(s), c * BOX_COLS, n, q0, b);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {  // consumers: warpgroup wg owns kv rows [kv0 + 64 wg, kv0 + 64 wg + 64)
    regs_take<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int kv_lo = kv0 + 64 * wg;
    const int kvrow[2] = {kv_lo + 16 * warp + g, kv_lo + 16 * warp + g + 8};
    const uint32_t sk = base + wg * 64 * ROW_BYTES, sv = sk + L::V;

    float dk_acc[HC * 32], dv_acc[HC * 32];
#pragma unroll
    for (int i = 0; i < HC * 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(bar_kv, 0);

    for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
      const int s = i % DKV_STAGES, q0 = qt * DKV_BQ;
      mbar_wait(full(s), (i / DKV_STAGES) & 1);
      if (causal && q0 + DKV_BQ - 1 < kv_lo) {  // every pair masked for these kv rows
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t sq = base + L::STAGES + s * L::STAGE, sdo = sq + HC * DKV_Q_CHUNK;
      const float* sl = rows_all + s * 2 * DKV_BQ;  // LSE log2 e, by q column
      const float* sd = sl + DKV_BQ;                // D

      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 q columns.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HC * 4; ++kk) {
        const uint32_t kv_off = (kk / 4) * DKV_KV_CHUNK + (kk % 4) * 32;
        const uint32_t q_off = (kk / 4) * DKV_Q_CHUNK + (kk % 4) * 32;
        wgmma_ss(st, wgmma_desc(sk + kv_off, 16, 1024), wgmma_desc(sq + q_off, 16, 1024), kk);
        wgmma_ss(dpt, wgmma_desc(sv + kv_off, 16, 1024), wgmma_desc(sdo + q_off, 16, 1024),
                 kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T into st, dS^T into dpt.  st[i] sits at kv row kvrow[(i >> 1) & 1],
      // q column q0 + c with c = 8 (i / 4) + 2 t + (i & 1).
      const bool edge = q0 + DKV_BQ > S || (causal && kv_lo + 63 > q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i / 4) * 8 + 2 * t + (i & 1);
        float p = exp2f(st[i] * scale_log2 - sl[c]);
        if (edge && (q0 + c >= S || (causal && kvrow[(i >> 1) & 1] > q0 + c))) p = 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - sd[c]) * scale;
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 (dO's
      // and q's dtype) from the registers, 16 q rows a step.
      uint32_t pa[DKV_BQ / 16][4], sa[DKV_BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_f32(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          sa[kk][r] = pack_f32(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
        const uint32_t off = kk * 16 * ROW_BYTES;
        wgmma_rs_mn(dv_acc, pa[kk], wgmma_desc(sdo + off, DKV_Q_CHUNK, 1024), 1);
        wgmma_rs_mn(dk_acc, sa[kk], wgmma_desc(sq + off, DKV_Q_CHUNK, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (kvrow[ri] >= S) continue;
      const size_t off = (((size_t)b * S + kvrow[ri]) * N + n) * H;
#pragma unroll
      for (int j = 0; j < HC * 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < H) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
              __floats2bfloat162_rn(dk_acc[4 * j + 2 * ri], dk_acc[4 * j + 2 * ri + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
              __floats2bfloat162_rn(dv_acc[4 * j + 2 * ri], dv_acc[4 * j + 2 * ri + 1]);
        }
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

template <int HC>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* dd, void* dk, void* dv, int B, int S,
                        int N, int H, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map_bshd(&tq, q, B, S, N, H, DKV_BQ)) != cudaSuccess) return err;
  if ((err = make_map_bshd(&tk, k, B, S, N, H, DKV_BKV)) != cudaSuccess) return err;
  if ((err = make_map_bshd(&tv, v, B, S, N, H, DKV_BKV)) != cudaSuccess) return err;
  if ((err = make_map_bshd(&tdo, dout, B, S, N, H, DKV_BQ)) != cudaSuccess) return err;
  const size_t smem = DkvSmem<HC>::BYTES;
  if ((err = allow_smem(flash_dkv_sm90<HC>, smem)) != cudaSuccess) return err;
  const dim3 grid(B * N, (S + DKV_BKV - 1) / DKV_BKV);
  flash_dkv_sm90<HC><<<grid, DKV_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, N, H, causal, scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int HCH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dd, void* dk, void* dv, int B, int S,
                       int N, int H, int causal, float scale, cudaStream_t stream) {
  constexpr int HP = HCH * 16;
  const dim3 grid(B * N, (S + BKV - 1) / BKV);
  const size_t smem = (2 * 2 * BKV * (HP / 2 + 1) + 2 * BQ * HP + 2 * BQ) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(flash_dkv_f32<HCH>, smem)) != cudaSuccess) return err;
  flash_dkv_f32<HCH><<<grid, 2 * BKV, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dd,
      static_cast<float*>(dk), static_cast<float*>(dv), S, N, H, causal, scale);
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
  if (dtype == 1)
    return (int)(H <= BOX_COLS
                     ? launch_sm90<1>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st)
                     : launch_sm90<2>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st));
  switch ((H + 15) / 16) {
    case 1: return (int)launch_f32<1>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 2: return (int)launch_f32<2>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 3: return (int)launch_f32<3>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 4: return (int)launch_f32<4>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 5: return (int)launch_f32<5>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 6: return (int)launch_f32<6>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    case 7: return (int)launch_f32<7>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
    default: return (int)launch_f32<8>(q, k, v, dout, l, dd, dk, dv, B, S, N, H, causal, scale, st);
  }
}
