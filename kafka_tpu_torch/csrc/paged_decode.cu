// Paged decode attention for Hopper (sm_90a), bf16 pool, f32 softmax.
//
// Replaces the Pallas kernel `paged_decode_attention` / `_decode_kernel`
// (kafka_tpu/ops/pallas/paged_attention.py:180 / :50).  Same function: one
// query token per sequence attends its own `seq_len + 1` valid slots,
// found through the page table; online softmax in f32 (m, l, acc).  Lanes
// whose table row points at the trash page produce garbage rows that the
// caller discards.
//
// Bound on an H100: bytes.  The valid window's K and V,
// 2 * sum_b(seq_len_b + 1) * Hkv * D * 2 bytes per layer, read once at
// 3.35 TB/s; the arithmetic is ~2 flops per byte.
//
// Design, and what differs from the TPU kernel:
// * GQA is indexed directly (kv head = q head / G).  The TPU kernel's
//   block-diagonal q expansion existed only for Mosaic's lane tiling.
// * Work is cut into fixed chunks of `chunk` tokens (the wrapper passes
//   128 at page 16: 8 whole pages) across all lanes, not into equal
//   splits per lane: a lane of 2,047 tokens gets 16 blocks per kv head and
//   a lane of 6 tokens one, so the longest lane no longer sets the time.
//   128 tokens is 32 KB of K and V per kv head at D 64: long enough that
//   the merge is cheap, short enough that 8 lanes of a few hundred tokens
//   fill the 132 SMs.  The grid enumerates (chunk, kv head) over the
//   prefix sum of the lanes' chunk counts, kv head fastest; its length is
//   a host-side bound (the lengths live on the device), and blocks past
//   the last chunk exit at once.
// * A block reads its chunk's page ids once, then stages the chunk's K and
//   V rows for its kv head through shared memory in tiles of 32 tokens
//   with 16-byte cp.async copies, double-buffered: tile i + 1 is in flight
//   while tile i is computed.  Rows are padded by 16 bytes, so the
//   per-lane 16-byte row reads of the score step hit every bank once.
// * All G heads x 32 tokens are scored at once on the CUDA cores: a lane
//   owns a token, a warp two heads (warp, warp + 4), and reads the token's
//   K row once for both.  A G <= 8-row product is far too small for
//   mma.sync or wgmma to pay off, and the work is bound by bytes, not
//   operations.  One online-softmax rescale per tile, not per token; P.V
//   is taken from shared memory, 16 threads per head each owning D / 16
//   output elements.
// * A lane with one chunk writes its rows itself; the other lanes' chunks
//   write unnormalised f32 (m, l, acc) partials, which a second small
//   kernel merges, a variable number per row: a row's (m, l) pairs are
//   read once into shared memory and its acc loads are unrolled, so the
//   merge of a 16-chunk lane waits out a few memory latencies, not 32.
//   The chunk enumeration and the merge are shared with K3 and K4
//   (paged_chunks.cuh).
//
// Plain C interface, loaded with ctypes; the launch error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_chunks.cuh"

namespace {

constexpr int kMaxG = 8;             // q heads per kv head supported
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;            // tokens per staged tile, one per lane
constexpr int kPad = 8;              // bf16 padding per staged row (16 B)

template <int D>
struct Smem {
  __nv_bfloat16 k[2][kTile][D + kPad];
  __nv_bfloat16 v[2][kTile][D + kPad];
  float q[kMaxG][D];       // pre-scaled by scale * log2(e)
  float p[kMaxG][kTile];   // the tile's probabilities
  float alpha[kMaxG];      // the tile's rescale of the running sums
  float m[kMaxG];
  float l[kMaxG];
  int page[kMaxChunkPages];
};

// one head's online-softmax step over a tile; the warp's lane = token
__device__ __forceinline__ void tile_softmax(float s, bool valid, float& m,
                                             float& l, float* p_row,
                                             float* alpha, int lane) {
  s = valid ? s : kNegInf;
  const float m_new = fmaxf(m, warp_max(s));
  const float a = exp2f(m - m_new);
  const float p = valid ? exp2f(s - m_new) : 0.f;
  l = l * a + warp_sum(p);
  m = m_new;
  p_row[lane] = p;
  if (lane == 0) *alpha = a;
}

// stage tokens t0 + tile * kTile .. of the chunk [t0, t1) into buffer buf;
// rows past t1 are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(
    Smem<D>& sm, const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, int t0, int t1, int tile,
    int buf, int page_size, int HD, int kvh) {
  constexpr int CPR = D / 8;  // 16-byte pieces of a row
  const int base = t0 + tile * kTile;
  for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
    const int tt = i / CPR;
    const int c = (i % CPR) * 8;
    const int t = base + tt;
    const bool ok = t < t1;
    size_t off = 0;
    if (ok)
      off = ((size_t)sm.page[(t - t0) / page_size] * page_size +
             t % page_size) * HD + (size_t)kvh * D + c;
    cp_async16(smem_addr(&sm.k[buf][tt][c]), k_pool + off, ok);
    cp_async16(smem_addr(&sm.v[buf][tt][c]), v_pool + off, ok);
  }
}

// grid (Hkv * B * max_chunks), block kThreads.
template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_chunk_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, Hq, D]
    const __nv_bfloat16* __restrict__ k_pool,  // [SLOTS, Hkv*D]
    const __nv_bfloat16* __restrict__ v_pool,  // [SLOTS, Hkv*D]
    const int* __restrict__ page_table,        // [B, P]
    const int* __restrict__ seq_lens,          // [B]
    __nv_bfloat16* __restrict__ out,           // [B, Hq, D]
    float* __restrict__ part_acc,              // [B, max_chunks, Hq, D]
    float* __restrict__ part_ml,               // [B, max_chunks, Hq, 2]
    int B, int G, int Hkv, int P, int page_size, int chunk, int max_chunks,
    float scale) {
  __shared__ __align__(16) Smem<D> sm;
  constexpr int E = D / 16;  // output elements a P.V thread owns
  const int kvh = blockIdx.x % Hkv;
  const int cap = P * page_size;

  // this block's lane b and chunk j: the J-th chunk of the prefix sum
  const ChunkWork w =
      find_chunk(blockIdx.x / Hkv, seq_lens, nullptr, B, 1, cap, chunk);
  if (w.b == B) return;
  const int b = w.b, j = w.j, n_ch = w.n_ch;
  // read again rather than carried: carried, it costs a spill at D 64
  const int n_valid = lane_window(seq_lens[b], 1, cap);
  const int t0 = j * chunk;                 // page-aligned
  const int t1 = min(t0 + chunk, n_valid);  // t0 < t1 unless n_valid is 0
  const int n_tiles = max(0, (t1 - t0 + kTile - 1) / kTile);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Hq = Hkv * G;
  const int HD = Hkv * D;

  const int n_pages = max(0, (t1 - t0 + page_size - 1) / page_size);
  for (int i = tid; i < n_pages; i += kThreads)
    sm.page[i] = page_table[(size_t)b * P + t0 / page_size + i];
  const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    sm.q[i / D][i % D] = __bfloat162float(qb[i]) * scale * kLog2e;
  __syncthreads();

  // score step: heads g0 = warp and g1 = warp + 4; P.V step: head pr,
  // elements pd..pd+E-1
  const int g0 = warp;
  const int g1 = warp + kWarps;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int pr = tid / 16;
  const int pd = (tid % 16) * E;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  if (n_tiles > 0)
    load_tile<D>(sm, k_pool, v_pool, t0, t1, 0, 0, page_size, HD, kvh);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles)
      load_tile<D>(sm, k_pool, v_pool, t0, t1, i + 1, buf ^ 1, page_size, HD,
                   kvh);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile i has landed for every thread
    const int nv = min(kTile, t1 - t0 - i * kTile);
    if (g0 < G) {  // warp-uniform
      float s0 = 0.f, s1 = 0.f;
      const __nv_bfloat16* kr = &sm.k[buf][lane][0];
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float kf[8];
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(kr + c), kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) s0 += sm.q[g0][c + e] * kf[e];
        if (g1 < G) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s1 += sm.q[g1][c + e] * kf[e];
        }
      }
      tile_softmax(s0, lane < nv, m0, l0, sm.p[g0], &sm.alpha[g0], lane);
      if (g1 < G)
        tile_softmax(s1, lane < nv, m1, l1, sm.p[g1], &sm.alpha[g1], lane);
    }
    __syncthreads();  // probabilities and rescales are ready
    if (pr < G) {
      const float a = sm.alpha[pr];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= a;
      for (int tt = 0; tt < nv; ++tt) {
        const float p = sm.p[pr][tt];
        float vf[E];
        if constexpr (E == 8) {
          bf16x8_to_f32(*reinterpret_cast<const uint4*>(&sm.v[buf][tt][pd]),
                        vf);
        } else {
          const uint2 raw = *reinterpret_cast<const uint2*>(&sm.v[buf][tt][pd]);
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float2 a01 = __bfloat1622float2(h[0]);
          const float2 a23 = __bfloat1622float2(h[1]);
          vf[0] = a01.x;
          vf[1] = a01.y;
          vf[2] = a23.x;
          vf[3] = a23.y;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += p * vf[e];
      }
    }
    __syncthreads();  // buffer `buf` and the probabilities are free again
  }

  if (lane == 0 && g0 < G) {
    sm.m[g0] = m0;
    sm.l[g0] = l0;
  }
  if (lane == 0 && g1 < G) {
    sm.m[g1] = m1;
    sm.l[g1] = l1;
  }
  __syncthreads();
  if (pr >= G) return;
  const int h = kvh * G + pr;
  if (n_ch == 1) {
    const float inv = 1.f / fmaxf(sm.l[pr], 1e-30f);
    __nv_bfloat16* o = out + ((size_t)b * Hq + h) * D + pd;
#pragma unroll
    for (int e = 0; e < E; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(o + e) =
          __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
    return;
  }
  const size_t row = ((size_t)b * max_chunks + j) * Hq + h;
  float* pa = part_acc + row * D + pd;
#pragma unroll
  for (int e = 0; e < E; ++e) pa[e] = acc[e];
  if (pd == 0) {
    part_ml[row * 2] = sm.m[pr];
    part_ml[row * 2 + 1] = sm.l[pr];
  }
}

}  // namespace

extern "C" int kafka_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* seq_lens, void* out, void* part_acc,
    void* part_ml, int B, int Hq, int Hkv, int D, int P, int page_size,
    int chunk, float scale, void* stream) {
  const int G = Hkv > 0 ? Hq / Hkv : 0;
  const int max_chunks = max_lane_chunks(P, page_size, chunk);
  if (G < 1 || G > kMaxG || Hq % Hkv != 0 || B < 1 || max_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int cap = P * page_size;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)Hkv * B * max_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k_pool);
  auto* vp = static_cast<const __nv_bfloat16*>(v_pool);
  auto* pt = static_cast<const int*>(page_table);
  auto* sl = static_cast<const int*>(seq_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  if (D == 64) {
    paged_decode_chunk_kernel<64><<<(unsigned)blocks, kThreads, 0, st>>>(
        qp, kp, vp, pt, sl, op, pa, pm, B, G, Hkv, P, page_size, chunk,
        max_chunks, scale);
  } else if (D == 128) {
    paged_decode_chunk_kernel<128><<<(unsigned)blocks, kThreads, 0, st>>>(
        qp, kp, vp, pt, sl, op, pa, pm, B, G, Hkv, P, page_size, chunk,
        max_chunks, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(pa, pm, sl, nullptr, op, B, Hq, D, 1, cap, chunk,
                      max_chunks, st);
}
