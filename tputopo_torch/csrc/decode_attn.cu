// Decode attention over a bf16 KV cache for Hopper (sm_90a), written by hand
// in CUDA C++.
//
// Replaces no Pallas kernel: the reference attends by einsums, which XLA
// fuses.  Computes tputopo/workloads/serving.py:_attend_ragged for a bf16
// cache, the port's attention.py:cached_attention_plain being its plain
// version.  For slot b, KV head kv and query t (heads n = kv * group + g):
//   q is widened to f32 and scaled by 1/sqrt(H) in f32; K and V are read as
//   the bf16 they are stored in and widened to f32 in registers;
//   query t sits at pos[b] + t and attends cache positions
//   0 .. min(pos[b] + t, S - 1); a query below position 0 has every
//   position masked and, as in the reference, takes the uniform average
//   over all S (one score for every position);
//   scores, the softmax and the P V sum are f32; the output is cast to bf16.
// Masked positions are never read: the reference gives them exp(-1e30 - m),
// which is 0 exactly.
//
// Layout: q and out are [B, T, N, H] bf16, ck and cv one layer's cache
// [B, S, KV, H] bf16, read in place; pos is [B] int64 on the device.  All
// contiguous.  H is 128; T * N / KV <= 64.
//
// What bounds it on this card: bytes.  A step reads each live cache row
// once (256 bytes of K and of V per KV head at H = 128) and does 2 * group
// * T multiply-adds per element read: at T = 1, group 4, 4 operations a
// byte against the H100's ~295 (bf16 tensor cores) or ~20 (f32 CUDA
// cores).  So the design moves only the bytes it must, as fast as the
// memory gives them:
//  - the grid is (splits, KV, B), fixed by the shapes so a CUDA graph
//    captures it; a split is SPLIT positions.  Each block reads its slot's
//    position on the device and returns at once when its split begins past
//    the slot's last attended position: the bytes read follow each slot's
//    length;
//  - each block holds the group * T queries of one KV head (f32, shared
//    memory) and streams its K/V rows once for all of them, 16 bytes a
//    thread, through two TILE-row stages by cp.async, the next tile's copy
//    in flight during the current tile's math.  Rows are XOR-swizzled in
//    shared memory, so a warp's reads hit every bank once.  A block takes
//    ~40 KB, so five or six share an SM: more blocks in flight beat deeper
//    stages (three stages, or 64-row tiles, ran 10-20% slower);
//  - scores: a thread per (position, every fourth query), the dot product
//    over H in f32 FMAs, split over up to four partial sums so the chains
//    overlap; the online softmax: a warp per query, its running max and sum
//    in shared memory; P V: a thread per 8 columns and query (and, for few
//    queries, per phase of the positions), f32 accumulators in registers,
//    rescaled at each tile;
//  - each split writes its (m, l, acc) to f32 scratch; a second kernel, a
//    block per query, merges the splits in a fixed order and writes bf16.
//    No atomics: replays are bit for bit the eager call.
// Tensor cores are not needed: at T <= 16 the f32 FMA work is a few
// percent of the card's CUDA-core rate for the bytes moved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SPLIT = 256;    // positions per block
constexpr int TILE = 32;      // positions per pipeline stage
constexpr int STAGES = 2;     // tiles in shared memory, STAGES - 1 copies ahead
constexpr int THREADS = 128;  // THREADS / TILE threads per position in the scores
constexpr int MAX_Q = 64;     // queries per KV head: T * group
constexpr int HEAD_DIM = 128;  // the model's (Mistral's, Llama's) head dim

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where 16-byte chunk c of tile row r sits in shared memory: the chunk index
// XOR the row's low three bits, so the eight threads of a quarter warp that
// read one chunk of eight consecutive rows (the scores), or eight chunks of
// one row (P V), hit all 32 banks.
__device__ __forceinline__ int swizzle(int r, int c) { return (c ^ (r & 7)) * 16; }

// Eight bf16 (16 bytes) widened to f32: a bf16 is the high half of an f32.
__device__ __forceinline__ void widen8(const uint4 raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The last position query qi attends (t = qi / group), and whether every
// position is masked for it (then all S positions take one score).
__device__ __forceinline__ int last_attended(long long p0, int qi, int group, int S,
                                             bool* uniform) {
  const long long qp = p0 + qi / group;
  *uniform = qp < 0;
  return qp < 0 ? S - 1 : static_cast<int>(qp < S - 1 ? qp : S - 1);
}

template <int H>
struct Layout {
  static constexpr int HC = H / 8;          // 16-byte chunks in a row
  static constexpr int R = THREADS / HC;    // P V thread rows
  static constexpr int PITCH = H * 2;       // a row in shared memory, bytes
  static constexpr int RING = STAGES * TILE * PITCH;  // K's stages, or V's
  // Bytes for Q queries: the stages, the q rows (reused to sum the P V
  // phases at the end), the tile's scores and the running max, sum and
  // rescale factor of each query.
  static int bytes(int Q) {
    const int rows = Q > R ? Q : R;
    return 2 * RING + 4 * (rows * H + Q * TILE + 3 * Q);
  }
};

// QA: the most queries a block holds (4, 16 or 64), which sizes the
// registers of the scores and of the P V sums.
template <int H, int QA>
__global__ void __launch_bounds__(THREADS)
decode_attn_split(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
                  const __nv_bfloat16* __restrict__ cv, const long long* __restrict__ pos,
                  float* __restrict__ part_acc, float* __restrict__ part_ml, int T, int S,
                  int N, int KV, float scale) {
  using L = Layout<H>;
  constexpr int HC = L::HC, R = L::R, PITCH = L::PITCH;
  constexpr int QG = THREADS / TILE;      // threads per position in the scores
  constexpr int QS = (QA + QG - 1) / QG;  // scores a thread holds
  constexpr int NA = QS >= 4 ? 1 : 4 / QS;  // partial sums per score: chains to overlap
  constexpr int CI = QA > R ? QA / R : 1;  // P V items a thread holds
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, n_splits = (S + SPLIT - 1) / SPLIT;
  const int group = N / KV, Q = T * group;
  const long long p0 = pos[b];
  const int last = p0 < 0 ? S - 1
                          : static_cast<int>(p0 + T - 1 < S - 1 ? p0 + T - 1 : S - 1);
  const int s0 = split * SPLIT;
  if (s0 > last) return;  // no query of this slot reaches the split
  const int s_end = min(s0 + SPLIT, last + 1);
  const int ntiles = (s_end - s0 + TILE - 1) / TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kbuf = smem;
  unsigned char* vbuf = smem + L::RING;
  float* qs = reinterpret_cast<float*>(smem + 2 * L::RING);
  float* sc = qs + (Q > R ? Q : R) * H;
  float* m_s = sc + Q * TILE;
  float* l_s = m_s + Q;
  float* a_s = l_s + Q;

  const size_t row = static_cast<size_t>(KV) * H;  // elements between positions
  const size_t head = (static_cast<size_t>(b) * S * KV + kv) * H;
  auto load_tile = [&](int tile, int stage) {
    const int p_start = s0 + tile * TILE;
    for (int i = tid; i < TILE * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      const int p = p_start + r;
      const bool ok = p < s_end;
      const size_t off = head + (ok ? p : 0) * row + c * 8;
      const int at = (stage * TILE + r) * PITCH + swizzle(r, c);
      cp_async_16(kbuf + at, ck + off, ok);
      cp_async_16(vbuf + at, cv + off, ok);
    }
  };

  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t, t);
    cp_async_commit();
  }
  for (int i = tid; i < Q * H; i += THREADS) {
    const int qi = i / H, d = i % H;
    const size_t at = ((static_cast<size_t>(b) * T + qi / group) * N + kv * group + qi % group) * H + d;
    qs[i] = __bfloat162float(q[at]) * scale;
  }
  for (int qi = tid; qi < Q; qi += THREADS) {
    m_s[qi] = -INFINITY;
    l_s[qi] = 0.f;
  }

  const int c = tid % HC, r = tid / HC;
  const int PH = Q < R ? R / Q : 1;  // phases of the positions per query in P V
  const int items = Q * PH;
  float acc[CI][8];
#pragma unroll
  for (int j = 0; j < CI; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it % STAGES, ahead = it + STAGES - 1;
    if (ahead < ntiles) load_tile(ahead, ahead % STAGES);
    cp_async_commit();  // an empty group past the last tile keeps the count
    cp_async_wait<STAGES - 1>();  // tile it has landed
    __syncthreads();
    const int p_start = s0 + it * TILE;

    // Scores: thread (position p, queries qh, qh + QG, ...).
    {
      const int p = tid % TILE, qh = tid / TILE;
      const unsigned char* krow = kbuf + (stage * TILE + p) * PITCH;
      float s[QS][NA];
#pragma unroll
      for (int j = 0; j < QS; ++j)
#pragma unroll
        for (int a = 0; a < NA; ++a) s[j][a] = 0.f;
#pragma unroll
      for (int cc = 0; cc < HC; ++cc) {
        float kf[8];
        widen8(*reinterpret_cast<const uint4*>(krow + swizzle(p, cc)), kf);
#pragma unroll
        for (int j = 0; j < QS; ++j) {
          const int qi = qh + QG * j;
          if (qi < Q) {
            const float4* qv = reinterpret_cast<const float4*>(qs + qi * H + cc * 8);
            const float4 x = qv[0], y = qv[1];
            float& a = s[j][cc % NA];
            a = fmaf(x.x, kf[0], a);
            a = fmaf(x.y, kf[1], a);
            a = fmaf(x.z, kf[2], a);
            a = fmaf(x.w, kf[3], a);
            a = fmaf(y.x, kf[4], a);
            a = fmaf(y.y, kf[5], a);
            a = fmaf(y.z, kf[6], a);
            a = fmaf(y.w, kf[7], a);
          }
        }
      }
      const int pg = p_start + p;
#pragma unroll
      for (int j = 0; j < QS; ++j) {
        const int qi = qh + QG * j;
        if (qi < Q) {
          bool uniform;
          const int lim = last_attended(p0, qi, group, S, &uniform);
          float dot = s[j][0];
#pragma unroll
          for (int a = 1; a < NA; ++a) dot += s[j][a];
          sc[qi * TILE + p] = pg <= lim ? (uniform ? 0.f : dot) : -INFINITY;
        }
      }
    }
    __syncthreads();

    // The online softmax: a warp per query.
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int qi = warp; qi < Q; qi += THREADS / 32) {
        float* srow = sc + qi * TILE;
        float x[TILE / 32];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) {
          x[i] = srow[lane + 32 * i];
          mx = fmaxf(mx, x[i]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[qi];
        if (mx == -INFINITY) {  // no position of this tile for this query
#pragma unroll
          for (int i = 0; i < TILE / 32; ++i) srow[lane + 32 * i] = 0.f;
          if (lane == 0) a_s[qi] = 1.f;
          continue;
        }
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) {
          x[i] = expf(x[i] - m_new);
          sum += x[i];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) srow[lane + 32 * i] = x[i];
        if (lane == 0) {
          const float a = expf(m_old - m_new);
          a_s[qi] = a;
          l_s[qi] = l_s[qi] * a + sum;
          m_s[qi] = m_new;
        }
      }
    }
    __syncthreads();

    // P V: thread (8 columns c, row r), items r, r + R, ...: item =
    // phase * Q + query, the phase taking every PH-th position.
#pragma unroll
    for (int j = 0; j < CI; ++j) {
      const int item = r + j * R;
      if (item < items) {
        const int qi = item % Q, ph = item / Q;
        const float a = a_s[qi];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] *= a;
        const float* prow = sc + qi * TILE;
        const unsigned char* vtile = vbuf + stage * TILE * PITCH;
#pragma unroll 4
        for (int pp = ph; pp < TILE; pp += PH) {
          const float w = prow[pp];
          float vf[8];
          widen8(*reinterpret_cast<const uint4*>(vtile + pp * PITCH + swizzle(pp, c)), vf);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(w, vf[k], acc[j][k]);
        }
      }
    }
    __syncthreads();  // the stage is free for the copy after next
  }

  // Sum each query's phases in order and write the split's partials.
  float* red = qs;  // the q rows are no longer read
#pragma unroll
  for (int j = 0; j < CI; ++j) {
    const int item = r + j * R;
    if (item < items)
#pragma unroll
      for (int k = 0; k < 8; ++k) red[item * H + c * 8 + k] = acc[j][k];
  }
  __syncthreads();
  const size_t cta = (static_cast<size_t>(b) * KV + kv) * n_splits + split;
  for (int i = tid; i < Q * H; i += THREADS) {
    const int qi = i / H, d = i % H;
    float sum = 0.f;
    for (int ph = 0; ph < PH; ++ph) sum += red[(ph * Q + qi) * H + d];
    part_acc[(cta * Q + qi) * H + d] = sum;
  }
  for (int qi = tid; qi < Q; qi += THREADS) {
    part_ml[(cta * Q + qi) * 2] = m_s[qi];
    part_ml[(cta * Q + qi) * 2 + 1] = l_s[qi];
  }
}

// Merges the splits of one query of one (slot, KV head): a block per query,
// a thread per column.  The query takes the splits up to its last attended
// position, each of which holds at least one of its positions.  The splits'
// max and weighted sum are reduced across the block in a fixed order, then
// each thread sums its column over the splits in order.
__global__ void decode_attn_combine(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    const long long* __restrict__ pos,
                                    __nv_bfloat16* __restrict__ out, int T, int S, int N,
                                    int KV, int H, int NS) {
  extern __shared__ float w[];  // NS split weights, then a value per warp
  float* red = w + NS;
  const int qi = blockIdx.x, kv = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int lane = d % 32, warp = d / 32, warps = blockDim.x / 32;
  const int group = N / KV, Q = T * group;
  bool uniform;
  const int n = last_attended(pos[b], qi, group, S, &uniform) / SPLIT + 1;
  const size_t first = (static_cast<size_t>(b) * KV + kv) * NS * Q + qi;  // split 0's row
  auto block_reduce = [&](float v, bool is_max) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = red[0];
    for (int i = 1; i < warps; ++i) v = is_max ? fmaxf(v, red[i]) : v + red[i];
    __syncthreads();
    return v;
  };
  float m = -INFINITY;
  for (int s = d; s < n; s += blockDim.x) m = fmaxf(m, part_ml[(first + s * Q) * 2]);
  m = block_reduce(m, true);
  float l = 0.f;
  for (int s = d; s < n; s += blockDim.x) {
    const size_t at = (first + s * Q) * 2;
    w[s] = expf(part_ml[at] - m);
    l = fmaf(part_ml[at + 1], w[s], l);
  }
  l = block_reduce(l, false);  // also orders the writes of w before the reads
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) acc = fmaf(part_acc[(first + s * Q) * H + d], w[s], acc);
  const int t = qi / group, g = qi % group;
  out[((static_cast<size_t>(b) * T + t) * N + kv * group + g) * H + d] =
      __float2bfloat16(acc / l);
}

template <int H, int QA>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* pos, void* out,
                   void* part_acc, void* part_ml, int B, int T, int S, int N, int KV,
                   float scale, cudaStream_t st) {
  const int Q = T * (N / KV), NS = (S + SPLIT - 1) / SPLIT;
  const int bytes = Layout<H>::bytes(Q);
  auto kernel = decode_attn_split<H, QA>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<H>::bytes(QA));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(NS, KV, B), THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(cv), static_cast<const long long*>(pos),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), T, S, N, KV, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<<<dim3(Q, KV, B), H, (NS + H / 32) * sizeof(float), st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const long long*>(pos), static_cast<__nv_bfloat16*>(out), T, S, N, KV, H, NS);
  return cudaGetLastError();
}


}  // namespace

// part_acc: [B, KV, ceil(S / 256), T * N / KV, H] f32 and part_ml: the same
// with 2 in place of H, scratch the caller allocates.  Returns a cudaError_t.
extern "C" int tputopo_decode_attn(const void* q, const void* ck, const void* cv,
                                   const void* pos, void* out, void* part_acc, void* part_ml,
                                   int B, int T, int S, int N, int KV, int H, float scale,
                                   void* stream) {
  if (B < 1 || B > 65535 || T < 1 || S < 1 || KV < 1 || KV > 65535 || N % KV ||
      T * (N / KV) > MAX_Q || H != HEAD_DIM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Q = T * (N / KV);
  cudaError_t err;
  if (Q <= 4)
    err = launch<HEAD_DIM, 4>(q, ck, cv, pos, out, part_acc, part_ml, B, T, S, N, KV, scale, st);
  else if (Q <= 16)
    err = launch<HEAD_DIM, 16>(q, ck, cv, pos, out, part_acc, part_ml, B, T, S, N, KV, scale, st);
  else
    err = launch<HEAD_DIM, MAX_Q>(q, ck, cv, pos, out, part_acc, part_ml, B, T, S, N, KV, scale,
                                  st);
  return static_cast<int>(err);
}
