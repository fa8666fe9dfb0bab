// Latent attention (MLA, DeepSeek-V2/V3) of a prefill chunk over its
// up-projected rows, for Hopper (sm_90a), written by hand in CUDA C++: the
// expanded form that the serving paths' prefill chunks take.
//
// Replaces no Pallas kernel: the reference has no latent attention.
// Computes tputopo_torch/attention.py:latent_expanded, the port's plain
// version, for a bf16 cache at DeepSeek-V3's head widths (nope 128, rope
// 64, v 128).  The wrapper (attention._latent_chunk_attention_cuda) first
// up-projects the latent rows below the chunk's end, kv = c_kv W_ukv, with
// the same bf16 product as the plain version, into a scratch [B, span, N,
// nope + v]; this kernel attends it.  For row b, head n and query t:
//   query t sits at pos[b] + t (the raw start) and attends the positions
//   0 .. min(pos[b] + t, span - 1); a query below position 0 has every
//   position masked and, as in the plain version, takes the uniform
//   average over all span rows;
//   the key of position s is [k_nope(s, n), k_pe(s)]: k_nope the first
//   nope columns of head n's up-projected row, k_pe the latent row's
//   last rope columns, read in place from the latent cache and shared by
//   every head; the value is head n's last v columns of kv;
//   S = q K^T with f32 accumulation, q = [q_nope, q_pe] (softmax scale)
//   rounded once to bf16 by the wrapper, as the plain version folds the
//   scale in; an online softmax in f32; P rounded to bf16 for O += P V
//   (f32 accumulation); the output cast to bf16.
// Masked positions are never read past the block's last query.
//
// Layout: q [B, T, N, nope + rope] and out [B, T, N, v] bf16; kv [B, span,
// N, nope + v] bf16; latent one layer's cache [B, S, R + rope] bf16, its
// k_pe columns (from R) read by TMA at the cache's own row stride, its
// rows below span only; pos [B] int64, read on the device (no readback:
// the admission programs are CUDA graphs, and the grid depends on the
// shapes alone).  All contiguous, on 16-byte boundaries, R a multiple of 8.
//
// What bounds it on this card: tensor-core operations.  A 2048-query chunk
// attending P earlier positions does 2 N (nope + rope + v) = 81,920 flops a
// (query, position) pair at N 128, over (P + T) (N (nope + v) + rope) +
// T N (nope + rope + v) bf16 elements: at P 10,000 that is ~1.6 TFLOP
// against ~0.9 GB, ~1,800 flops a byte (each head's K/V read once),
// against the H100's ~295; the up-projection before it is a large GEMM
// (2 R N (nope + v) flops a row, ~16 MFLOP a row against 64 KB written).
// The plain version it replaces (bf16 products into f32 score tiles
// [N, T, 1024] and an online softmax of elementwise passes over them)
// moved ~26 bytes a (query, head, position) element through HBM.  The
// design, on chunk_attn.cu's structure (csrc/sm90.cuh), keeps the scores
// on chip:
//  - a block owns one (row b, head n) and 128 query positions; three
//    warpgroups: two consumers of 64 query rows each, one producer, which
//    gives its registers up (setmaxnreg).  One producer thread keeps the
//    K and V tiles of 128 positions coming through two-stage rings of
//    their own, each with "full" and "empty" mbarriers, TMA zero-filling
//    rows past span: K's two k_nope boxes from kv at its row stride
//    N (nope + v) 2 bytes, its k_pe box in place from the latent cache at
//    (R + rope) 2 bytes; V's two boxes from kv.  A K tile is released
//    when its scores are done, a V tile when its product is;
//  - both products on wgmma: S = Q K^T (m64n128k16, depth 192 into one
//    accumulator, both from shared memory, K-major), O += P V (P from
//    registers, the S accumulator packed to bf16; V from shared memory,
//    MN-major).  A consumer issues tile j's scores and tile j - 1's
//    product together and runs tile j's softmax while the product runs
//    (FlashAttention-3's intra-warpgroup overlap: ~10% faster at long
//    spans than waiting for each product in turn); the softmax in exp2,
//    the scale folded into the exponent;
//  - the causal bound: the loop ends at the tile holding the block's last
//    query position (all span rows only when a query of the block lies
//    below 0), and the element-wise mask runs only on tiles that cross
//    the block's first query position or span, or when a uniform query is
//    present;
//  - the grid is (ceil(T / 128), N, B): a head's query tiles are adjacent,
//    so they stream its K/V tiles together and all but the first read
//    them from L2; within a head, blocks are issued heaviest first (the
//    last query positions attend the most tiles).
// Shared memory: Q 48 KB, two stages of K (48 KB each) and of V (32 KB
// each), 208 KB.

#include "sm90.cuh"

namespace {

constexpr int ROWS = 128;      // query positions a block: two consumer warpgroups of 64
constexpr int BKV = 128;       // cache positions a pipeline stage
constexpr int STAGES = 2;      // the K and V rings' depth
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int NOPE = 128;      // DeepSeek-V3's qk_nope_head_dim
constexpr int ROPE = 64;       // qk_rope_head_dim
constexpr int VDIM = 128;      // v_head_dim
constexpr int KC = (NOPE + ROPE) / BOX_COLS;  // 64-column boxes of a query or key row
constexpr int NC = NOPE / BOX_COLS;           // of them the up-projected k_nope's
constexpr int VC = VDIM / BOX_COLS;           // 64-column boxes of a value row
constexpr int TILE = 128 * ROW_BYTES;         // one 64-column box of a 128-row tile
constexpr float NEG = -1e30f;

struct Smem {
  static constexpr int K = KC * TILE;                 // Q sits at 0, then K's ring
  static constexpr int V = K + STAGES * KC * TILE;    // then V's ring
  static constexpr int BARS = V + STAGES * VC * TILE;
  static constexpr int BYTES = BARS + (1 + 4 * STAGES) * 8 + 1024;  // + alignment slack
};

// S = Q K^T for the warpgroup's 64 query rows (Q's boxes at sq) against the
// 128 positions of the K tile at sk: 16 of the 192 key columns a step,
// k_nope's two boxes, then k_pe's.  Issued, not waited for.
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < KC * 4; ++kk) {
    const uint32_t off = (kk / 4) * TILE + (kk % 4) * 32;
    wgmma_ss(sc, wgmma_desc(sq + off, 16, 1024), wgmma_desc(sk + off, 16, 1024), kk);
  }
  wgmma_commit();
}

// O += P V for the V tile at sv, P in registers (bf16 pairs), 16 positions
// a step.  Issued, not waited for.
__device__ __forceinline__ void issue_values(float (&acc)[VC * 32],
                                             const uint32_t (&pa)[BKV / 16][4], uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs_mn(acc, pa[kk], wgmma_desc(sv + kk * 16 * ROW_BYTES, TILE, 1024), 1);
  wgmma_commit();
}

// The online softmax over one tile's scores, in place, in exp2 with the
// scale folded into the exponent: masked (where `masked`: positions past a
// row's last, and every position of a uniform row scored 0), then each
// row's max m (of the scores times scale_log2), p = 2^(s scale_log2 - m)
// and its sum l, the previous m's factor into alpha.  sc[i] sits at row
// (i >> 1) & 1 of the thread's two, position kv0 + 8 (i / 4) + 2 t + (i & 1).
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked, int kv0, int t,
                                             const int (&last)[2], const bool (&uniform)[2],
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int ri = (i >> 1) & 1;
      const int col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
      sc[i] = col > last[ri] ? NEG : (uniform[ri] ? 0.f : sc[i]);
    }
  }
  float mx[2] = {NEG, NEG}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    // the four threads of a group hold a row's 128 columns
    mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
    mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
    const float m_new = fmaxf(m[ri], mx[ri] * scale_log2);
    alpha[ri] = exp2f(m[ri] - m_new);
    m[ri] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = exp2f(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
    sc[i] = p;
    sum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    sum[ri] += __shfl_xor_sync(0xffffffffu, sum[ri], 1);
    sum[ri] += __shfl_xor_sync(0xffffffffu, sum[ri], 2);
    l[ri] = l[ri] * alpha[ri] + sum[ri];
  }
}

// P rounded to bf16 pairs straight from the registers: the A operand of
// O += P V.
__device__ __forceinline__ void pack_probs(uint32_t (&pa)[BKV / 16][4], const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
latent_chunk_attn_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tkv,
                       const __grid_constant__ CUtensorMap tpe,
                       const long long* __restrict__ pos, __nv_bfloat16* __restrict__ o,
                       int T, int span, int N, int R, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzled boxes: 1 KB aligned
  const uint32_t bar_q = base + Smem::BARS;
  // K and V have rings of their own: a K tile is released when its scores
  // are done, a V tile when its product is.
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bar_q + 8u * (1 + 3 * STAGES + s); };
  auto k_tile = [&](int s) { return base + Smem::K + s * KC * TILE; };
  auto v_tile = [&](int s) { return base + Smem::V + s * VC * TILE; };

  const int t0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest blocks first
  const int n = blockIdx.y, b = blockIdx.z;
  const long long p0 = pos[b];
  const long long lo = p0 + t0;                         // the block's first query
  const long long hi = p0 + min(t0 + ROWS, T) - 1;      // and its last
  // Positions the block reads: up to its last query's, or all span rows
  // when a query lies below 0 (it takes the uniform average).
  const int end = lo < 0 ? span : static_cast<int>(hi + 1 < span ? hi + 1 : span);
  const int n_kt = (end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * 128);  // every consumer thread releases the tile
      mbar_init(v_empty(s), 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    regs_give_up<24>();
    if (threadIdx.x == 2 * 128) {
      mbar_arrive_expect_tx(bar_q, KC * TILE);
      for (int c = 0; c < KC; ++c)
        tma_load_4d(base + c * TILE, &tq, bar_q, c * BOX_COLS, n, t0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const uint32_t parity = ((kt / STAGES) & 1) ^ 1;
        mbar_wait(k_empty(s), parity);
        mbar_arrive_expect_tx(k_full(s), KC * TILE);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(k_tile(s) + c * TILE, &tkv, k_full(s), c * BOX_COLS, n, kt * BKV, b);
        tma_load_3d(k_tile(s) + NC * TILE, &tpe, k_full(s), R, kt * BKV, b);
        mbar_wait(v_empty(s), parity);
        mbar_arrive_expect_tx(v_full(s), VC * TILE);
        for (int c = 0; c < VC; ++c)
          tma_load_4d(v_tile(s) + c * TILE, &tkv, v_full(s), NOPE + c * BOX_COLS, n, kt * BKV,
                      b);
      }
    }
  } else {  // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64)
    regs_take<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int row[2] = {64 * wg + 16 * warp + g, 64 * wg + 16 * warp + g + 8};
    // Each row's last attended position, and whether it takes the uniform
    // average (then every position below span scores 0).  Rows past T are
    // computed on the zeros TMA filled in, and never stored.
    int last[2];
    bool uniform[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const long long qp = p0 + t0 + row[ri];
      uniform[ri] = qp < 0;
      last[ri] = qp < 0 ? span - 1 : static_cast<int>(qp < span - 1 ? qp : span - 1);
    }
    const uint32_t sq = base + wg * 64 * ROW_BYTES;

    float acc[VC * 32];
#pragma unroll
    for (int i = 0; i < VC * 32; ++i) acc[i] = 0.f;
    // m: the running row max of the scores times scale * log2(e)
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float sc[64];
    uint32_t pa[BKV / 16][4];
    mbar_wait(bar_q, 0);

    // A tile is masked where it crosses the block's first query position
    // or span, or where a uniform row is present.
    auto masked = [&](int kv0) { return lo < 0 || kv0 + BKV - 1 > lo || kv0 + BKV > span; };
    float alpha[2];

    // Tile 0: its scores and softmax alone.
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_scores(sc, sq, k_tile(0));
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(k_empty(0));
    softmax_tile(sc, m, l, alpha, masked(0), 0, t, last, uniform, scale_log2);
    pack_probs(pa, sc);

    // Tile kt's scores and tile kt - 1's product are issued together, and
    // the softmax of tile kt runs while the product does.
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % STAGES, sp = (kt - 1) % STAGES;
      mbar_wait(k_full(s), (kt / STAGES) & 1);
      mbar_wait(v_full(sp), ((kt - 1) / STAGES) & 1);
      wgmma_fence();
      issue_scores(sc, sq, k_tile(s));
      wgmma_fence();
      issue_values(acc, pa, v_tile(sp));
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(k_empty(s));
      softmax_tile(sc, m, l, alpha, masked(kt * BKV), kt * BKV, t, last, uniform, scale_log2);
      // The product is done: release its V tile, rescale, and round this
      // tile's P for the next one.
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(v_empty(sp));
#pragma unroll
      for (int i = 0; i < VC * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_probs(pa, sc);
    }
    // The last tile's product.
    const int sl = (n_kt - 1) % STAGES;
    mbar_wait(v_full(sl), ((n_kt - 1) / STAGES) & 1);
    wgmma_fence();
    issue_values(acc, pa, v_tile(sl));
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(v_empty(sl));

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int tq = t0 + row[ri];
      if (tq >= T) continue;
      const float inv = 1.f / l[ri];
      __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * T + tq) * N + n) * VDIM;
#pragma unroll
      for (int j = 0; j < VC * 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) = __floats2bfloat162_rn(
            acc[4 * j + 2 * ri] * inv, acc[4 * j + 2 * ri + 1] * inv);
    }
  }
}

}  // namespace

// q: [B, T, N, nope + rope] bf16 (the softmax scale folded in); kv: [B,
// span, N, nope + v] bf16; latent: [B, S, R + rope] bf16; pos: [B] int64;
// out: [B, T, N, v] bf16; all contiguous.  `scale` multiplies the scores
// before the softmax (1 where q carries the softmax scale).  Returns the
// launch's cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int tputopo_latent_chunk_attn(const void* q, const void* kv, const void* latent,
                                         const void* pos, void* out, int B, int T, int S,
                                         int span, int N, int R, float scale, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || N < 1 || N > 65535 || span < 1 || span > S || R < 0 ||
      R % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tkv, tpe;
  const long long row = static_cast<long long>(R + ROPE) * 2;
  cudaError_t err;
  if ((err = make_map_bshd(&tq, q, B, T, N, NOPE + ROPE, ROWS)) != cudaSuccess ||
      (err = make_map_bshd(&tkv, kv, B, span, N, NOPE + VDIM, BKV)) != cudaSuccess ||
      (err = make_map_rows(&tpe, latent, B, span, R + ROPE, row, row * S, BKV)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaFuncSetAttribute(latent_chunk_attn_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + ROWS - 1) / ROWS, N, B);
  latent_chunk_attn_sm90<<<grid, THREADS, Smem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tkv, tpe, static_cast<const long long*>(pos), static_cast<__nv_bfloat16*>(out), T,
      span, N, R, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
