// Paged decode attention over an int8 KV pool for Hopper (sm_90a): bf16
// query and output, int8 K/V rows with one f32 scale per slot, f32 math.
//
// Replaces the Pallas kernel `paged_decode_attention_int8` /
// `_decode_kernel_int8` (kafka_tpu/ops/pallas/paged_attention.py:690 /
// :558).  Same function: sequence b's query (position seq_len_b) attends
// slots 0..seq_len_b of its window, found through the page table, with
// the per-slot dequant folded into the math instead of a dense window:
//   score_j = (q . k_q[j]) * scale * s_k[j],   out = sum_j p_j s_v[j] v_q[j]
// with p the softmax of the scores.  The TPU kernel takes the scales
// pre-gathered chunk-major only because Mosaic needs static sublane rows;
// this kernel reads each scale straight from k_s/v_s by slot.
//
// Bound on an H100: bytes.  The valid window's int8 K and V rows and
// their scales, sum_b(seq_len_b + 1) * (2 * Hkv * D + 8) bytes per layer —
// half of K1's — read once at 3.35 TB/s; the arithmetic is ~4 * Hq * D
// flops per slot, about 2 flops per byte, far below the ~295 at which the
// tensor cores would be the limit.
//
// Design: K1's chunked split (csrc/paged_decode.cu) over int8 tiles.
// * Work is cut into fixed chunks of whole pages across all lanes
//   (paged_chunks.cuh): the wrapper passes 128 tokens at page 16, K1's
//   chunk.  A lane of 2,047 tokens gets 16 chunks per kv head and a lane
//   of 6 tokens one, so the longest lane no longer sets the time.  An int8
//   row is half a bf16 one, so 256-token chunks would move K1's 32 KB per
//   kv head; measured on the H100 (PERF.md) they lost to 128 at six of
//   K1's eight shapes, tied at one and won only with every lane long:
//   with half the blocks, each block's serial walk of its tiles is what
//   the card waits for.
// * A block reads its chunk's page ids once, then stages the chunk's int8
//   K and V rows for its kv head, and their f32 slot scales, through
//   shared memory in tiles of 64 tokens with cp.async (16 bytes a row
//   piece, 4 bytes a scale), double-buffered: tile i + 1 is in flight while
//   tile i is computed.  Rows past the window are zero-filled (src-size 0).
//   Rows are padded by 16 bytes against bank conflicts.
// * Codes convert to f32 on the read from shared memory (a byte permute
//   into 2^23 + u and one subtraction: exact, and cheaper than I2F), and
//   each code once per block: the conversion is the kernel's largest
//   instruction cost (a first design that converted every K code twice
//   and every V code once per head took 7-11% longer).
// * Scores: two lanes per token, each converting half of the token's K
//   row, form the dot products of every head and meet by a shuffle; the
//   scales are applied as the plain version applies them,
//   (q . k_q) * scale * s_k, then folded into log2 units.  A warp runs the
//   online softmax of two heads (one rescale per tile) and stores p * s_v
//   token-major.  A product of G <= 8 rows is far too small for the
//   tensor cores to pay off, and the work is bound by bytes.
// * P.V: each warp takes every fourth token of the tile, each lane D / 32
//   elements of it, and adds p * s_v * v into the accumulators of every
//   head (one float4 read of four heads' weights); the four warps' sums
//   meet in shared memory at the end of the chunk.
// * A lane with one chunk writes its rows itself; the other lanes' chunks
//   write (m, l, acc) partials that K1's merge kernel combines
//   (paged_chunks.cuh).
// * Masking is by seq_len, with no NaN path: a slot never written holds
//   q = 0, s = 0 and a reused page stale codes, and neither is read as
//   valid (its probability is 0, and rows past the window are zeros).
//   The trash lane (table row all page 0) reads page 0 and is discarded.
//
// Plain C interface, loaded with ctypes; the launch error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_chunks.cuh"

namespace {

constexpr int kMaxG = 8;    // q heads per kv head supported
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;   // tokens per staged tile
constexpr int kPad = 16;    // int8 padding per staged row (16 B)
constexpr int kPVRow = 12;  // floats of a token's p * s_v row (16-B rows)

template <int D>
struct SmemI8 {
  int8_t k[2][kTile][D + kPad];  // after the loop: the P.V groups' sums
  int8_t v[2][kTile][D + kPad];
  float ks[2][kTile];           // the tile's s_k
  float vs[2][kTile];           // the tile's s_v
  alignas(16) float q[kMaxG][D];  // the query rows in f32, unscaled
  float s[kMaxG][kTile + 1];    // the tile's scores (log2 units)
  alignas(16) float pv[kTile][kPVRow];  // p * s_v, token-major
  float alpha[kMaxG];           // the tile's rescale of the running sums
  float m[kMaxG];
  float l[kMaxG];
  int page[kMaxChunkPages];
};

// four int8 codes (one 32-bit word) to f32, exactly: the byte u = b + 128
// becomes the float 2^23 + u, less 2^23 + 128
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// E consecutive codes (E = 2 or 4, suitably aligned) to f32
template <int E>
__device__ __forceinline__ void codes_to_f32(const int8_t* p, float* out) {
  if constexpr (E == 2) {
    float f[4];
    i8x4_to_f32(*reinterpret_cast<const uint16_t*>(p), f);
    out[0] = f[0];
    out[1] = f[1];
  } else {
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), out);
  }
}

// stage tokens t0 + tile * kTile .. of the chunk [t0, t1) and their scales
// into buffer buf; rows past t1 are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(
    SmemI8<D>& sm, const int8_t* __restrict__ k_q,
    const float* __restrict__ k_s, const int8_t* __restrict__ v_q,
    const float* __restrict__ v_s, int t0, int t1, int tile, int buf,
    int page_size, int HD, int kvh) {
  constexpr int CPR = D / 16;  // 16-byte pieces of a row
  const int base = t0 + tile * kTile;
  for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
    const int tt = i / CPR;
    const int c = (i % CPR) * 16;
    const int t = base + tt;
    const bool ok = t < t1;
    size_t off = 0;
    if (ok)
      off = ((size_t)sm.page[(t - t0) / page_size] * page_size +
             t % page_size) * HD + (size_t)kvh * D + c;
    cp_async16(smem_addr(&sm.k[buf][tt][c]), k_q + off, ok);
    cp_async16(smem_addr(&sm.v[buf][tt][c]), v_q + off, ok);
  }
  for (int tt = threadIdx.x; tt < kTile; tt += kThreads) {
    const int t = base + tt;
    const bool ok = t < t1;
    size_t slot = 0;
    if (ok)
      slot = (size_t)sm.page[(t - t0) / page_size] * page_size +
             t % page_size;
    cp_async4(smem_addr(&sm.ks[buf][tt]), k_s + slot, ok);
    cp_async4(smem_addr(&sm.vs[buf][tt]), v_s + slot, ok);
  }
}

// grid (Hkv * B * max_chunks), block kThreads.
template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_int8_chunk_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
    const int8_t* __restrict__ k_q,       // [SLOTS, Hkv*D]
    const float* __restrict__ k_s,        // [SLOTS]
    const int8_t* __restrict__ v_q,       // [SLOTS, Hkv*D]
    const float* __restrict__ v_s,        // [SLOTS]
    const int* __restrict__ page_table,   // [B, P]
    const int* __restrict__ seq_lens,     // [B]
    __nv_bfloat16* __restrict__ out,      // [B, Hq, D]
    float* __restrict__ part_acc,         // [B, max_chunks, Hq, D]
    float* __restrict__ part_ml,          // [B, max_chunks, Hq, 2]
    int B, int G, int Hkv, int P, int page_size, int chunk, int max_chunks,
    float scale) {
  __shared__ __align__(16) SmemI8<D> sm;
  constexpr int E = D / 32;        // output elements a P.V lane owns
  constexpr int PIECES = D / 16;   // 16-code pieces of a K row
  const int kvh = blockIdx.x % Hkv;
  const int cap = P * page_size;

  // this block's lane b and chunk j: the J-th chunk of the prefix sum
  const ChunkWork w =
      find_chunk(blockIdx.x / Hkv, seq_lens, nullptr, B, 1, cap, chunk);
  if (w.b == B) return;
  const int b = w.b, j = w.j, n_ch = w.n_ch;
  const int t0 = j * chunk;                   // page-aligned
  const int t1 = min(t0 + chunk, w.n_valid);  // t0 < t1: n_valid >= 1
  const int n_tiles = (t1 - t0 + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Hq = Hkv * G;
  const int HD = Hkv * D;

  const int n_pages = (t1 - t0 + page_size - 1) / page_size;
  for (int i = tid; i < n_pages; i += kThreads)
    sm.page[i] = page_table[(size_t)b * P + t0 / page_size + i];
  const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    sm.q[i / D][i % D] = __bfloat162float(qb[i]);
  __syncthreads();

  // score step: token st, the pieces of its K row of parity sh, every
  // head; softmax step: heads g0 = warp and g1 = warp + 4; P.V step:
  // tokens warp, warp + 4, ..., elements pe..pe+E-1 of every head
  const int st = warp * 16 + lane / 2;
  const int sh = lane & 1;
  const int g0 = warp;
  const int g1 = warp + kWarps;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int pe = lane * E;
  float acc[kMaxG][E];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  load_tile<D>(sm, k_q, k_s, v_q, v_s, t0, t1, 0, 0, page_size, HD, kvh);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles)
      load_tile<D>(sm, k_q, k_s, v_q, v_s, t0, t1, i + 1, buf ^ 1,
                   page_size, HD, kvh);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile i has landed for every thread
    const int nv = min(kTile, t1 - t0 - i * kTile);

    // scores of token st: each code converted once, for every head; the
    // lane pair's halves meet by a shuffle
    {
      float d[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) d[g] = 0.f;
      const int8_t* kr = &sm.k[buf][st][0];
#pragma unroll
      for (int i = 0; i < PIECES / 2; ++i) {
        const int pc = 2 * i + sh;
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + 16 * pc);
        float kf[16];
        i8x4_to_f32(raw.x, kf);
        i8x4_to_f32(raw.y, kf + 4);
        i8x4_to_f32(raw.z, kf + 8);
        i8x4_to_f32(raw.w, kf + 12);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {  // warp-uniform
            const float4* qr =
                reinterpret_cast<const float4*>(&sm.q[g][16 * pc]);
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const float4 qv = qr[e4];
              d[g] += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1] +
                      qv.z * kf[4 * e4 + 2] + qv.w * kf[4 * e4 + 3];
            }
          }
        }
      }
      const float sk = sm.ks[buf][st];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          d[g] += __shfl_xor_sync(0xffffffffu, d[g], 1);
          if ((g & 1) == sh)
            sm.s[g][st] = st < nv ? d[g] * scale * sk * kLog2e : kNegInf;
        }
      }
    }
    __syncthreads();  // the tile's scores are in place

    // online softmax, one rescale per tile; p * s_v, token-major
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = h ? g1 : g0;
      if (g >= G) continue;  // warp-uniform
      float& m = h ? m1 : m0;
      float& l = h ? l1 : l0;
      const float s0 = sm.s[g][lane];
      const float s1 = sm.s[g][lane + 32];
      const bool v0 = lane < nv, v1 = lane + 32 < nv;
      const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
      const float a = exp2f(m - m_new);
      const float p0 = v0 ? exp2f(s0 - m_new) : 0.f;
      const float p1 = v1 ? exp2f(s1 - m_new) : 0.f;
      l = l * a + warp_sum(p0 + p1);
      m = m_new;
      sm.pv[lane][g] = p0 * sm.vs[buf][lane];
      sm.pv[lane + 32][g] = p1 * sm.vs[buf][lane + 32];
      if (lane == 0) sm.alpha[g] = a;
    }
    __syncthreads();  // weights and rescales are ready

    // P.V: each V code converted once and applied to every head
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float a = sm.alpha[g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= a;
      }
    }
    for (int tt = warp; tt < nv; tt += kWarps) {
      float vf[E];
      codes_to_f32<E>(&sm.v[buf][tt][pe], vf);
      const float4 pa = *reinterpret_cast<const float4*>(&sm.pv[tt][0]);
      const float pw[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += pw[g] * vf[e];
        }
      }
      if (G > 4) {
        const float4 pb = *reinterpret_cast<const float4*>(&sm.pv[tt][4]);
        const float px[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (g + 4 < G) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g + 4][e] += px[g] * vf[e];
          }
        }
      }
    }
    __syncthreads();  // buffer `buf` and the weights are free again
  }

  // the four token groups' sums meet in the (idle) staging buffers
  float* red = reinterpret_cast<float*>(&sm.k[0][0][0]);  // [4][G][D]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        red[((size_t)warp * G + g) * D + pe + e] = acc[g][e];
    }
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
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float A = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) A += red[(size_t)v * G * D + idx];
    const int h = kvh * G + g;
    const int d = idx % D;
    if (n_ch == 1) {
      out[((size_t)b * Hq + h) * D + d] =
          __float2bfloat16(A / fmaxf(sm.l[g], 1e-30f));
    } else {
      const size_t row = ((size_t)b * max_chunks + j) * Hq + h;
      part_acc[row * D + d] = A;
      if (d == 0) {
        part_ml[row * 2] = sm.m[g];
        part_ml[row * 2 + 1] = sm.l[g];
      }
    }
  }
}

template <int D>
void launch_chunks(unsigned blocks, cudaStream_t st, const __nv_bfloat16* q,
                   const int8_t* kq, const float* ks, const int8_t* vq,
                   const float* vs, const int* pt, const int* sl,
                   __nv_bfloat16* out, float* pa, float* pm, int B, int G,
                   int Hkv, int P, int page_size, int chunk, int max_chunks,
                   float scale) {
  paged_decode_int8_chunk_kernel<D><<<blocks, kThreads, 0, st>>>(
      q, kq, ks, vq, vs, pt, sl, out, pa, pm, B, G, Hkv, P, page_size, chunk,
      max_chunks, scale);
}

}  // namespace

extern "C" int kafka_paged_decode_int8(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* page_table, const void* seq_lens, void* out,
    void* part_acc, void* part_ml, int B, int Hq, int Hkv, int D, int P,
    int page_size, int chunk, float scale, void* stream) {
  const int G = Hkv > 0 ? Hq / Hkv : 0;
  const int max_chunks = max_lane_chunks(P, page_size, chunk);
  if (G < 1 || G > kMaxG || Hq % Hkv != 0 || B < 1 || max_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)Hkv * B * max_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kq = static_cast<const int8_t*>(k_q);
  auto* ks = static_cast<const float*>(k_s);
  auto* vq = static_cast<const int8_t*>(v_q);
  auto* vs = static_cast<const float*>(v_s);
  auto* pt = static_cast<const int*>(page_table);
  auto* sl = static_cast<const int*>(seq_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  const unsigned nb = (unsigned)blocks;
  if (D == 64) {
    launch_chunks<64>(nb, st, qp, kq, ks, vq, vs, pt, sl, op, pa, pm, B, G,
                      Hkv, P, page_size, chunk, max_chunks, scale);
  } else if (D == 128) {
    launch_chunks<128>(nb, st, qp, kq, ks, vq, vs, pt, sl, op, pa, pm, B, G,
                       Hkv, P, page_size, chunk, max_chunks, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(pa, pm, sl, nullptr, op, B, Hq, D, 1, P * page_size,
                      chunk, max_chunks, st);
}
