// Paged verify attention (speculative decoding) for Hopper (sm_90a), bf16
// pool, f32 softmax, on the tensor cores.
//
// Replaces the Pallas kernel `paged_verify_attention` / `_verify_kernel`
// (kafka_tpu/ops/pallas/paged_attention.py:384 / :251).  Same function:
// each sequence b brings S = K+1 query tokens at positions
// seq_len_b + j (j < S); its KV for the first q_len_b of them is already
// written, so the window holds n_valid = seq_len_b + q_len_b slots, found
// through the page table.  Query row j attends slots <= seq_len_b + j.
// Rows j >= q_len_b carry no contract (the engine discards them); this
// kernel writes zeros there.  Like the TPU kernel, which holds all S * Hq
// rows of a sequence in one block, it takes any S: there is no cap on
// speculative_k beyond the attention window.
//
// Bound on an H100: bytes.  The valid windows' K and V,
// 2 * sum_b(seq_len_b + q_len_b) * Hkv * D * 2 bytes per layer, read once
// at 3.35 TB/s; the arithmetic is 4 * Hq * D flops per (live row, slot)
// pair — about S / 2 times K1's ~2 flops per byte, still far below the
// ~295 flops per byte at which the tensor cores become the limit.
//
// Design: K1's chunked split (csrc/paged_decode.cu), with the row side on
// the tensor cores.
// * Work is cut into fixed chunks of whole pages across all lanes
//   (paged_chunks.cuh; the wrapper passes 128 tokens at page 16, K1's
//   chunk), over each lane's n_valid = seq_len + q_len slots.  The grid
//   enumerates (chunk, kv head) over the prefix sum of the lanes' chunk
//   counts; surplus blocks exit at once.  A lane with one chunk writes its
//   rows itself; the others' chunks write (m, l, acc) partials that K1's
//   merge kernel combines, over all S * Hq rows of the lane.
// * A block holds the G * S query rows of its kv head (row r = query j =
//   r / G, head g = r % G), one 16-row group per warp: 20 rows (2 warps)
//   for Llama-3.2-1B at K = 4, 36 (3 warps) at K = 8, 68 (5 warps) at
//   K = 16.  Up to 8 warps (128 rows) a block; past that the rows are
//   spread evenly over as many row blocks as needed (grid y), each
//   staging the chunk's tiles again (from L2).  So the rows set no shared
//   memory bound and no cap: the staged tiles do not depend on S.
// * The chunk's K and V rows for the kv head are staged through shared
//   memory in tiles of 32 tokens with 16-byte cp.async copies,
//   double-buffered (tile i + 1 in flight while tile i is computed), rows
//   past the chunk zero-filled (src-size 0), each row XOR-swizzled in
//   16-byte pieces so ldmatrix reads are free of bank conflicts.  The page
//   ids of the chunk are read once.  Nothing is converted to f32 in
//   shared memory.
// * Why mma.sync m16n8k16 (bf16 in, f32 accumulate), as K2
//   (csrc/flash_prefill.cu) does, and not CUDA-core dots: every K/V
//   element meets G * S rows (20 to 68 and more), so on the CUDA cores the
//   products outgrow the loads as K grows, while a 16-row MMA group scores
//   a whole 32-token tile in 4 * D / 16 instructions a warp.  The Q
//   fragments stay in registers for the whole chunk; S = Q K^T and
//   O += P V read K and V by ldmatrix (.trans for V).  P is rounded to
//   bf16 for the PV product, as the plain version rounds its
//   probabilities.  wgmma would want 64-row tiles, three times the rows
//   K = 4 has.
// * Softmax: online, per row in f32 registers, one rescale per tile, in
//   log2 units (the scale folded into the exponent).  Row j of lane b
//   masks slots >= min(seq_len + j + 1, n_valid); a masked score is -1e30
//   and its probability is set to 0, never computed, so an unwritten or
//   stale slot never meets an arithmetic op as a valid value and no row
//   can produce a NaN.  A row no slot reached (j >= q_len) has l = 0 and
//   comes out as zeros, here or in the merge.
//
// Scratch (the wrapper allocates it): partials of B * window / 128 chunks
// x S * Hq rows x (D + 2) floats, 5.4 MB at B 8, S 5, a 2,048-token
// window and Llama-3.2-1B's heads.
//
// Plain C interface, loaded with ctypes; the launch error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_chunks.cuh"

namespace {

constexpr int kMaxG = 8;      // q heads per kv head supported
constexpr int kMaxWarps = 8;  // 16-row groups a block holds
constexpr int kTile = 32;     // kv tokens per staged tile

template <int D>
struct SmemV {
  __nv_bfloat16 k[2][kTile * D];  // swizzled [kTile][D]
  __nv_bfloat16 v[2][kTile * D];
  int page[kMaxChunkPages];
};

// stage tokens t0 + tile * kTile .. of the chunk [t0, t1) into buffer buf;
// rows past t1 are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(
    SmemV<D>& sm, const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, int t0, int t1, int tile,
    int buf, int page_size, int HD, int kvh) {
  constexpr int CPR = D / 8;  // 16-byte pieces of a row
  const int base = t0 + tile * kTile;
  for (int i = threadIdx.x; i < kTile * CPR; i += blockDim.x) {
    const int tt = i / CPR;
    const int c = i % CPR;
    const int t = base + tt;
    const bool ok = t < t1;
    size_t off = 0;
    if (ok)
      off = ((size_t)sm.page[(t - t0) / page_size] * page_size +
             t % page_size) * HD + (size_t)kvh * D + c * 8;
    cp_async16(smem_addr(&sm.k[buf][swz<D>(tt, c)]), k_pool + off, ok);
    cp_async16(smem_addr(&sm.v[buf][swz<D>(tt, c)]), v_pool + off, ok);
  }
}

// grid (Hkv * B * max_chunks, row blocks), block 32 * warps; a block's
// rows are [blockIdx.y * 16 * warps, + 16 * warps) of the kv head's G * S.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32) paged_verify_chunk_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, S, Hq, D]
    const __nv_bfloat16* __restrict__ k_pool,  // [SLOTS, Hkv*D]
    const __nv_bfloat16* __restrict__ v_pool,  // [SLOTS, Hkv*D]
    const int* __restrict__ page_table,        // [B, P]
    const int* __restrict__ seq_lens,          // [B]
    const int* __restrict__ q_lens,            // [B]
    __nv_bfloat16* __restrict__ out,           // [B, S, Hq, D]
    float* __restrict__ part_acc,              // [B, max_chunks, S*Hq, D]
    float* __restrict__ part_ml,               // [B, max_chunks, S*Hq, 2]
    int B, int S, int G, int Hkv, int P, int page_size, int chunk,
    int max_chunks, float scale_log2) {
  __shared__ __align__(128) SmemV<D> sm;
  constexpr int KS = D / 16;      // k-steps of Q K^T
  constexpr int NB = kTile / 8;   // 8-token column blocks of a score tile
  constexpr int ND = D / 8;       // 8-wide column blocks of the output
  const int kvh = blockIdx.x % Hkv;
  const int cap = P * page_size;

  // this block's lane b and chunk j: the J-th chunk of the prefix sum
  const ChunkWork w =
      find_chunk(blockIdx.x / Hkv, seq_lens, q_lens, B, S, cap, chunk);
  if (w.b == B) return;
  const int b = w.b, jc = w.j, n_ch = w.n_ch, n_valid = w.n_valid;
  const int t0 = jc * chunk;                // page-aligned
  const int t1 = min(t0 + chunk, n_valid);  // t0 < t1 unless n_valid is 0
  const int n_tiles = max(0, (t1 - t0 + kTile - 1) / kTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int Hq = Hkv * G;
  const int HD = Hkv * D;
  const int R = S * Hq;  // output rows of a lane
  const int seq_len = seq_lens[b];
  const int q_len = lane_new_tokens(q_lens, b, S);

  const int n_pages = max(0, (t1 - t0 + page_size - 1) / page_size);
  for (int i = tid; i < n_pages; i += blockDim.x)
    sm.page[i] = page_table[(size_t)b * P + t0 / page_size + i];
  __syncthreads();
  if (n_tiles > 0)
    load_tile<D>(sm, k_pool, v_pool, t0, t1, 0, 0, page_size, HD, kvh);
  cp_async_commit();

  // this thread's rows gq and gq + 8 of the warp's 16: the kv head's row
  // r (query j = r / G, head g = r % G), live when r < G * S and j <
  // q_len; hi = the first slot the row does not see
  const int r0 = (blockIdx.y * (blockDim.x >> 5) + warp) * 16;
  int hi[2];
  size_t orow[2];  // the row in [B, S, Hq] (valid where r < G * S)
  bool real[2];    // r < G * S: the row exists
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gq + 8 * h;
    const int j = r / G;
    real[h] = r < G * S;
    const bool live = real[h] && j < q_len;
    hi[h] = live ? min(seq_len + j + 1, n_valid) : 0;
    orow[h] = ((size_t)b * S + j) * Hq + (size_t)kvh * G + r % G;
  }

  // Q fragments of the warp's 16 rows, straight from device memory (rows
  // that are not live are zeros)
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int h = x & 1;  // a0, a2: row gq; a1, a3: row gq + 8
      const int col = kk * 16 + 2 * tq + ((x >> 1) << 3);
      qf[kk][x] = hi[h] > 0
          ? *reinterpret_cast<const uint32_t*>(q + orow[h] * D + col)
          : 0u;
    }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles)
      load_tile<D>(sm, k_pool, v_pool, t0, t1, i + 1, buf ^ 1, page_size,
                   HD, kvh);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile i has landed for every thread
    const __nv_bfloat16* kt = sm.k[buf];
    const __nv_bfloat16* vt = sm.v[buf];
    const int base = t0 + i * kTile;

    // S = Q K^T over the tile's 32 tokens
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        const int tok = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(kt + swz<D>(tok, 2 * kk + ((lane >> 3) & 1))), b0,
                b1, b2, b3);
        mma_bf16(s[2 * np], qf[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // mask, then the online softmax in log2 units, one rescale per tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = base + n * 8 + 2 * tq + e;
          float& x = s[n][2 * h + e];
          x = t < hi[h] ? x * scale_log2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = base + n * 8 + 2 * tq + e;
          float& x = s[n][2 * h + e];
          x = t < hi[h] ? exp2_approx(x - m_new) : 0.f;
          l[h] += x;
        }
      }
    }

    // O += P V, P rounded to bf16 from the score accumulators in place
#pragma unroll
    for (int k16 = 0; k16 < kTile / 16; ++k16) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * k16][0], s[2 * k16][1]);
      a[1] = pack_bf16(s[2 * k16][2], s[2 * k16][3]);
      a[2] = pack_bf16(s[2 * k16 + 1][0], s[2 * k16 + 1][1]);
      a[3] = pack_bf16(s[2 * k16 + 1][2], s[2 * k16 + 1][3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        const int tok = k16 * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_addr(vt + swz<D>(tok, 2 * dp + (lane >> 4))), b0,
                      b1, b2, b3);
        mma_bf16(o[2 * dp], a, b0, b1);
        mma_bf16(o[2 * dp + 1], a, b2, b3);
      }
    }
    __syncthreads();  // buffer `buf` is free again
  }

  // the row's sums over its quad; then the output or the partials
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!real[h]) continue;
    if (n_ch == 1) {
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
      __nv_bfloat16* op = out + orow[h] * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    } else {
      // orow[h] = b * R + (j * Hq + head): the lane's row r' = orow - b * R
      const size_t prow =
          ((size_t)b * max_chunks + jc) * R + (orow[h] - (size_t)b * R);
      float* pa = part_acc + prow * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(pa + n * 8) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (tq == 0) {
        part_ml[prow * 2] = m[h];
        part_ml[prow * 2 + 1] = l[h];
      }
    }
  }
}

}  // namespace

extern "C" int kafka_paged_verify_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* seq_lens, const void* q_lens,
    void* out, void* part_acc, void* part_ml, int B, int S, int Hq, int Hkv,
    int D, int P, int page_size, int chunk, float scale, void* stream) {
  const int G = Hkv > 0 ? Hq / Hkv : 0;
  const int max_chunks = max_lane_chunks(P, page_size, chunk);
  if (G < 1 || G > kMaxG || Hq % Hkv != 0 || B < 1 || S < 1 ||
      max_chunks < 1)
    return (int)cudaErrorInvalidValue;
  // 16-row groups: up to kMaxWarps a block, spread evenly over row blocks
  const int groups = (G * S + 15) / 16;
  const int row_blocks = (groups + kMaxWarps - 1) / kMaxWarps;
  const int warps = (groups + row_blocks - 1) / row_blocks;
  const long long blocks = (long long)Hkv * B * max_chunks;
  if (blocks > 0x7fffffffLL || row_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k_pool);
  auto* vp = static_cast<const __nv_bfloat16*>(v_pool);
  auto* pt = static_cast<const int*>(page_table);
  auto* sl = static_cast<const int*>(seq_lens);
  auto* ql = static_cast<const int*>(q_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  const dim3 grid((unsigned)blocks, (unsigned)row_blocks);
  const float sl2 = scale * kLog2e;
  if (D == 64) {
    paged_verify_chunk_kernel<64><<<grid, warps * 32, 0, st>>>(
        qp, kp, vp, pt, sl, ql, op, pa, pm, B, S, G, Hkv, P, page_size, chunk,
        max_chunks, sl2);
  } else if (D == 128) {
    paged_verify_chunk_kernel<128><<<grid, warps * 32, 0, st>>>(
        qp, kp, vp, pt, sl, ql, op, pa, pm, B, S, G, Hkv, P, page_size, chunk,
        max_chunks, sl2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(pa, pm, sl, ql, op, B, S * Hq, D, S, P * page_size,
                      chunk, max_chunks, st);
}
