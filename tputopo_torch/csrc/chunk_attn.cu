// Attention of a block of queries over a bf16 KV cache for Hopper (sm_90a),
// written by hand in CUDA C++: the prefill chunks, whole-bucket admissions
// and one-shot prefills of the serving paths.
//
// Replaces no Pallas kernel: the reference attends by einsums, which XLA
// fuses.  Computes tputopo/workloads/serving.py:_attend_ragged for a bf16
// cache, the port's attention.py:cached_attention_plain being its plain
// version, for the calls that csrc/decode_attn.cu does not take (more than
// 16 queries a row).  For row b, KV head kv and query t (heads n = kv *
// group + g):
//   query t sits at pos[b] + t (the raw start, never clamped) and attends
//   cache positions 0 .. min(pos[b] + t, S - 1); a query below position 0
//   has every position masked and, as in the reference, takes the uniform
//   average over all S (one score, 0, for every position);
//   S = (1/sqrt(H)) Q K^T with f32 accumulation, an online softmax in f32,
//   P rounded to bf16 for O += P V (f32 accumulation), as flash_fwd.cu does;
//   the output is cast to bf16.
// Masked positions are never read past the block's last query: the
// reference gives them exp(-1e30 - m), which is 0 exactly.
//
// Layout: q and out are [B, T, N, H] bf16, ck and cv one layer's cache
// [B, S, KV, H] bf16, read in place by TMA at the cache's own strides; pos
// is [B] int64, read on the device (no readback: the admission programs
// are CUDA graphs, and the grid depends on the shapes alone).  All
// contiguous, on 16-byte boundaries.  H is 128; N is a multiple of KV with
// at most 128 query heads a KV head.
//
// What bounds it on this card: tensor-core operations.  A chunk of T
// queries a head against a prefix of P cached positions does 4 H T P N
// flops over (T + 2 P) KV H + 2 T N H bf16 elements: at longdoc's T = 512,
// N 32, KV 8 and P ~3000 that is ~25 GFLOP against ~13 MB, ~1900 flops a
// byte, far above the H100's ~295.  The einsums it replaces widened the
// whole cache to f32, built an f32 [T, S] score tile for every head over
// all S positions whatever the prefix, and multiplied on CUDA cores.  The
// design, on the structure of flash_fwd.cu (csrc/sm90.cuh):
//  - GQA packing: a block owns one (row b, KV head) and 128 query rows,
//    the `group` heads that share the KV head across 128 / group query
//    positions (32 at Mistral's group 4), so each K/V tile is loaded once
//    for all of them.  Q comes in as one TMA box of [positions, group
//    heads, 64 columns] a head-dim half, rows ordered position-major;
//  - three warpgroups: two consumers of 64 query rows each, one producer,
//    which gives its registers up (setmaxnreg).  One producer thread keeps
//    K and V tiles of 128 cache positions coming through a two-stage ring
//    with "full" and "empty" mbarriers, TMA zero-filling rows past S;
//  - both products on wgmma: S = Q K^T (m64n128k16, both from shared
//    memory, K-major), O += P V (P from registers, the S accumulator packed
//    to bf16; V from shared memory, MN-major); the softmax in exp2 on
//    scores prescaled by scale * log2(e);
//  - the causal bound: the loop ends at the tile holding the block's last
//    query position (all S only when a query of the block lies below 0),
//    and the element-wise mask runs only on tiles that cross the block's
//    first query position or S, or when a uniform query is present;
//  - blocks are issued heaviest first (the last query positions attend
//    the most tiles); the grid is (ceil(T / positions), KV, B).

#include "sm90.cuh"

namespace {

constexpr int ROWS = 128;      // query rows a block: two consumer warpgroups of 64
constexpr int BKV = 128;       // cache positions a pipeline stage
constexpr int STAGES = 2;      // K/V ring depth
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int HEAD_DIM = 128;  // the model's (Mistral's, Llama's) head dim
constexpr int HC = HEAD_DIM / BOX_COLS;  // 64-column TMA boxes a row
constexpr int TILE = 128 * ROW_BYTES;    // one 64-column box of a 128-row tile
constexpr float NEG = -1e30f;

struct Smem {
  static constexpr int K = HC * TILE;          // Q sits at 0
  static constexpr int STAGE = 2 * HC * TILE;  // K's boxes, then V's
  static constexpr int BARS = K + STAGES * STAGE;
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
};

__global__ void __launch_bounds__(THREADS, 1)
chunk_attn_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const long long* __restrict__ pos,
                __nv_bfloat16* __restrict__ o, int T, int S, int N, int KV, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzled boxes: 1 KB aligned
  const uint32_t bar_q = base + Smem::BARS;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int group = N / KV, positions = ROWS / group, rows = group * positions;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * positions;  // heaviest blocks first
  const int kv = blockIdx.y, b = blockIdx.z;
  const long long p0 = pos[b];
  const long long lo = p0 + t0;                               // the block's first query
  const long long hi = p0 + min(t0 + positions, T) - 1;       // and its last
  // Positions the block reads: up to its last query's, or all S when a
  // query lies below 0 (it takes the uniform average).
  const int end = lo < 0 ? S : static_cast<int>(hi + 1 < S ? hi + 1 : S);
  const int n_kt = (end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
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
      mbar_arrive_expect_tx(bar_q, HC * rows * ROW_BYTES);
      for (int c = 0; c < HC; ++c)
        tma_load_4d(base + c * TILE, &tq, bar_q, c * BOX_COLS, kv * group, t0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), Smem::STAGE);
        const uint32_t sk = base + Smem::K + s * Smem::STAGE, sv = sk + HC * TILE;
        for (int c = 0; c < HC; ++c) {
          tma_load_4d(sk + c * TILE, &tk, full(s), c * BOX_COLS, kv, kt * BKV, b);
          tma_load_4d(sv + c * TILE, &tv, full(s), c * BOX_COLS, kv, kt * BKV, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64)
    regs_take<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int row[2] = {64 * wg + 16 * warp + g, 64 * wg + 16 * warp + g + 8};
    // Each row's last attended position, and whether it takes the uniform
    // average (then every position below S scores 0).  Rows past T or past
    // `rows` are computed on the zeros TMA filled in, and never stored.
    int last[2];
    bool uniform[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const long long qp = p0 + t0 + row[ri] / group;
      uniform[ri] = qp < 0;
      last[ri] = qp < 0 ? S - 1 : static_cast<int>(qp < S - 1 ? qp : S - 1);
    }
    const uint32_t sq = base + wg * 64 * ROW_BYTES;

    float acc[HC * 32];
#pragma unroll
    for (int i = 0; i < HC * 32; ++i) acc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    mbar_wait(bar_q, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t sk = base + Smem::K + s * Smem::STAGE, sv = sk + HC * TILE;
      mbar_wait(full(s), (kt / STAGES) & 1);

      // S = Q K^T: 64 query rows x 128 cache positions, 16 head-dim columns a step.
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HC * 4; ++kk) {
        const uint32_t off = (kk / 4) * TILE + (kk % 4) * 32;
        wgmma_ss(sc, wgmma_desc(sq + off, 16, 1024), wgmma_desc(sk + off, 16, 1024), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Scale, mask, row max.  sc[i] sits at row row[(i >> 1) & 1], cache
      // position kv0 + 8 (i / 4) + 2 t + (i & 1).
      const int kv0 = kt * BKV;
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      if (lo < 0 || kv0 + BKV - 1 > lo || kv0 + BKV > S) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int ri = (i >> 1) & 1;
          const int col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
          sc[i] = col > last[ri] ? NEG : (uniform[ri] ? 0.f : sc[i]);
        }
      }
      float mx[2] = {NEG, NEG};
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

      // O += P V, P rounded to bf16 straight from the registers, 16 cache
      // positions a step.
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs_mn(acc, pa[kk], wgmma_desc(sv + kk * 16 * ROW_BYTES, TILE, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int tq = t0 + row[ri] / group;
      if (row[ri] >= rows || tq >= T) continue;
      const int n = kv * group + row[ri] % group;
      const float inv = 1.f / l[ri];
      __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * T + tq) * N + n) * HEAD_DIM;
#pragma unroll
      for (int j = 0; j < HC * 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) = __floats2bfloat162_rn(
            acc[4 * j + 2 * ri] * inv, acc[4 * j + 2 * ri + 1] * inv);
    }
  }
}

}  // namespace

// q and out: [B, T, N, H] bf16; ck and cv: [B, S, KV, H] bf16; pos: [B]
// int64; all contiguous.  Returns the launch's cudaError_t (0 on success);
// the launch is asynchronous on `stream`.
extern "C" int tputopo_chunk_attn(const void* q, const void* ck, const void* cv,
                                  const void* pos, void* out, int B, int T, int S, int N,
                                  int KV, int H, float scale, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || S < 1 || KV < 1 || KV > 65535 || N % KV ||
      N / KV > ROWS || H != HEAD_DIM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = N / KV, positions = ROWS / group;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map_bshd_heads(&tq, q, B, T, N, H, group, positions)) != cudaSuccess ||
      (err = make_map_bshd(&tk, ck, B, S, KV, H, BKV)) != cudaSuccess ||
      (err = make_map_bshd(&tv, cv, B, S, KV, H, BKV)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaFuncSetAttribute(chunk_attn_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + positions - 1) / positions, KV, B);
  chunk_attn_sm90<<<grid, THREADS, Smem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const long long*>(pos), static_cast<__nv_bfloat16*>(out), T, S,
      N, KV, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
