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
// H is a multiple of 8 up to 128.
//
// What bounds it on this card: at the model's shape (S = 2048, H = 128,
// bf16, causal) the work is ~S/2 multiply-adds for every byte the kernel
// must move, far above the H100's ~295 operations per byte, so it is bound
// by tensor-core operations, not by memory.  What kept the first version
// (warp-level MMA m16n8k16) at ~14x its bound: no copy overlapped the
// math (plain loads between two block barriers per kv tile), the B operand
// of P V was gathered from shared memory one bf16 at a time, and the
// warp-level MMA does not reach Hopper's tensor-core rate.  The bf16 design:
//  - one block per (b*n, 128-row q tile), q tiles issued heaviest first
//    (causal work grows with the tile index).  Three warpgroups: two
//    consumers of 64 q rows each, one producer.  The producer gives up its
//    registers (setmaxnreg) to the consumers;
//  - one producer thread brings the tiles in by TMA (csrc/sm90.cuh): Q once,
//    K and V through a ring of two 128-row stages, each with a "full"
//    mbarrier (the copy's bytes have landed) and an "empty" one (both
//    consumers are done with it), so the next tile's copy runs during the
//    current tile's math.  TMA zero-fills columns past H and rows past S:
//    no padding code;
//  - both products on wgmma: S = Q K^T (m64n128k16, Q and K from shared
//    memory, K-major), then O += P V (m64nHk16, P from registers, V from
//    shared memory MN-major).  P is S's accumulator packed pairwise to bf16
//    in registers: per warp the wgmma accumulator has the m16n8k16 A layout,
//    so P never reaches shared memory;
//  - the softmax runs on scores prescaled by scale * log2(e), with exp2f;
//    the LSE is converted back to natural-log units on the way out;
//  - the causal mask is applied element by element only on tiles that cross
//    the diagonal (or S); kv tiles wholly above the diagonal of the block's
//    last row are never loaded;
//  - f32, the dtype of the tests: one thread per q row, FMA loops, 64-row
//    tiles (flash_common.cuh), unchanged.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int FWD_BQ = 128;      // q rows per block: two consumer warpgroups of 64
constexpr int FWD_BKV = 128;     // kv rows per pipeline stage
constexpr int FWD_STAGES = 2;    // K/V ring depth
constexpr int FWD_THREADS = 384; // warpgroups 0 and 1 consume, 2 produces
constexpr int FWD_CHUNK = 128 * ROW_BYTES;  // one 64-column box of a 128-row tile
constexpr float LN2 = 0.6931471805599453f;

template <int HC>  // 64-column chunks of the head dim: 1 (H <= 64) or 2
struct FwdSmem {
  static constexpr int K = HC * FWD_CHUNK;       // Q sits at 0
  static constexpr int STAGE = 2 * HC * FWD_CHUNK;  // K's chunks, then V's
  static constexpr int BARS = K + FWD_STAGES * STAGE;
  static constexpr int BYTES = BARS + (1 + 2 * FWD_STAGES) * 8 + 1024;  // + alignment slack
};

template <int HC>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int S, int N, int H, int causal, float scale_log2) {
  using L = FwdSmem<HC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzled boxes: 1 KB aligned
  const uint32_t bar_q = base + L::BARS;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + FWD_STAGES + s); };

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_BQ;  // heaviest tiles first
  const int n_kt = (S + FWD_BKV - 1) / FWD_BKV;
  // causal: the last kv tile holding a key at or left of the block's last row
  const int kt_end = causal ? min(n_kt, (q0 + FWD_BQ + FWD_BKV - 1) / FWD_BKV) : n_kt;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
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
      mbar_arrive_expect_tx(bar_q, HC * FWD_CHUNK);
      for (int c = 0; c < HC; ++c)
        tma_load_4d(base + c * FWD_CHUNK, &tq, bar_q, c * BOX_COLS, n, q0, b);
      for (int kt = 0; kt < kt_end; ++kt) {
        const int s = kt % FWD_STAGES;
        mbar_wait(empty(s), ((kt / FWD_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::STAGE);
        const uint32_t sk = base + L::K + s * L::STAGE, sv = sk + HC * FWD_CHUNK;
        for (int c = 0; c < HC; ++c) {
          tma_load_4d(sk + c * FWD_CHUNK, &tk, full(s), c * BOX_COLS, n, kt * FWD_BKV, b);
          tma_load_4d(sv + c * FWD_CHUNK, &tv, full(s), c * BOX_COLS, n, kt * FWD_BKV, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
    regs_take<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int r_lo = q0 + 64 * wg;
    const int row[2] = {r_lo + 16 * warp + g, r_lo + 16 * warp + g + 8};
    const uint32_t sq = base + wg * 64 * ROW_BYTES;

    float acc[HC * 32];
#pragma unroll
    for (int i = 0; i < HC * 32; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    mbar_wait(bar_q, 0);

    for (int kt = 0; kt < kt_end; ++kt) {
      const int s = kt % FWD_STAGES;
      const uint32_t sk = base + L::K + s * L::STAGE, sv = sk + HC * FWD_CHUNK;
      mbar_wait(full(s), (kt / FWD_STAGES) & 1);

      // S = Q K^T: 64 q rows x 128 kv columns, 16 head-dim columns a step.
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HC * 4; ++kk) {
        const uint32_t off = (kk / 4) * FWD_CHUNK + (kk % 4) * 32;
        wgmma_ss(sc, wgmma_desc(sq + off, 16, 1024), wgmma_desc(sk + off, 16, 1024), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Scale, mask, row max.  sc[i] sits at row row[(i >> 1) & 1], kv
      // column kv0 + 8 (i / 4) + 2 t + (i & 1).
      const int kv0 = kt * FWD_BKV;
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      if (kv0 + FWD_BKV > S || (causal && kv0 + FWD_BKV - 1 > r_lo)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
          if (col >= S || (causal && col > row[(i >> 1) & 1])) sc[i] = NEG_INF;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        // the four threads of a group hold a row's 128 columns
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
        const float m_new = fmaxf(m[ri], mx[ri]);
        alpha[ri] = exp2f(m[ri] - m_new);
        m[ri] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = exp2f(sc[i] - m[(i >> 1) & 1]);
        sc[i] = p;
        sum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        sum[ri] += __shfl_xor_sync(0xffffffffu, sum[ri], 1);
        sum[ri] += __shfl_xor_sync(0xffffffffu, sum[ri], 2);
        l[ri] = l[ri] * alpha[ri] + sum[ri];
      }
#pragma unroll
      for (int i = 0; i < HC * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V, P rounded to bf16 (V's dtype) straight from the registers,
      // 16 kv rows a step.
      uint32_t pa[FWD_BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < FWD_BKV / 16; ++kk) {
        pa[kk][0] = pack_f32(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_BKV / 16; ++kk)
        wgmma_rs_mn(acc, pa[kk], wgmma_desc(sv + kk * 16 * ROW_BYTES, FWD_CHUNK, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (row[ri] >= S) continue;
      const float inv = 1.f / l[ri];
      __nv_bfloat16* orow = o + (((size_t)b * S + row[ri]) * N + n) * H;
#pragma unroll
      for (int j = 0; j < HC * 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < H)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[4 * j + 2 * ri] * inv, acc[4 * j + 2 * ri + 1] * inv);
      }
      if (t == 0) lse[(size_t)bn * S + row[ri]] = (m[ri] + log2f(l[ri])) * LN2;
    }
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

template <int HC>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int S, int N, int H, int causal, float scale,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map_bshd(&tq, q, B, S, N, H, FWD_BQ)) != cudaSuccess) return err;
  if ((err = make_map_bshd(&tk, k, B, S, N, H, FWD_BKV)) != cudaSuccess) return err;
  if ((err = make_map_bshd(&tv, v, B, S, N, H, FWD_BKV)) != cudaSuccess) return err;
  const size_t smem = FwdSmem<HC>::BYTES;
  if ((err = allow_smem(flash_fwd_sm90<HC>, smem)) != cudaSuccess) return err;
  const dim3 grid(B * N, (S + FWD_BQ - 1) / FWD_BQ);
  flash_fwd_sm90<HC><<<grid, FWD_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, N, H, causal, scale * LOG2E);
  return cudaGetLastError();
}

template <int HCH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int S, int N, int H, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int HP = HCH * 16;
  const dim3 grid(B * N, (S + BQ - 1) / BQ);
  const size_t smem = (BQ * (HP + 1) + 2 * BKV * HP + BKV * BQ) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(flash_fwd_f32<HCH>, smem)) != cudaSuccess) return err;
  flash_fwd_f32<HCH><<<grid, BQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, N, H, causal, scale);
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
  if (dtype == 1)
    return (int)(H <= BOX_COLS ? launch_sm90<1>(q, k, v, o, l, B, S, N, H, causal, scale, st)
                               : launch_sm90<2>(q, k, v, o, l, B, S, N, H, causal, scale, st));
  switch ((H + 15) / 16) {
    case 1: return (int)launch_f32<1>(q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 2: return (int)launch_f32<2>(q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 3: return (int)launch_f32<3>(q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 4: return (int)launch_f32<4>(q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 5: return (int)launch_f32<5>(q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 6: return (int)launch_f32<6>(q, k, v, o, l, B, S, N, H, causal, scale, st);
    case 7: return (int)launch_f32<7>(q, k, v, o, l, B, S, N, H, causal, scale, st);
    default: return (int)launch_f32<8>(q, k, v, o, l, B, S, N, H, causal, scale, st);
  }
}
