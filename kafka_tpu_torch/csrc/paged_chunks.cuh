// The chunked work split shared by the paged attention kernels (K1
// paged_decode.cu, K3 paged_verify.cu, K4 paged_decode_int8.cu), for Hopper
// (sm_90a).
//
// Each lane's valid window (its cached tokens plus the new ones: 1 for a
// decode step, q_len for a verify step, capped at the table's reach) is cut
// into fixed chunks of whole pages, and the grid enumerates (chunk, kv
// head) over the prefix sum of the lanes' chunk counts, kv head fastest.
// The lengths live on the device, so the grid's length is a host-side
// bound (B x the window's chunks x kv heads) and blocks past the last chunk
// exit at once.  A lane with one chunk writes its rows in the chunk kernel;
// the other lanes' chunks write unnormalised f32 partials (m, l, acc), with
// m and the scores in log2 units, which `paged_merge_kernel` merges, a
// variable number per row.  Partials are laid out [B, max_chunks, R, D] and
// [B, max_chunks, R, 2], R the rows of a lane (Hq for decode, S * Hq for
// verify), so the merge's output row (b, r) is the kernels' output row.
//
// Also here: the conversion and warp helpers the three kernels share (their
// staging helpers are in tile_ops.cuh).  Each including .cu file is its own
// shared library, so everything stays in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ops.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxChunkPages = 128;  // page ids a chunk may span

__device__ __forceinline__ void bf16x8_to_f32(uint4 raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the new tokens of lane b: its q_len (clamped to S) for a verify step,
// one for a decode step (q_lens null)
__device__ __forceinline__ int lane_new_tokens(const int* q_lens, int b,
                                               int S) {
  return q_lens ? max(0, min(q_lens[b], S)) : 1;
}

// valid slots of a lane: cached plus new tokens, capped at the table
__device__ __forceinline__ int lane_window(int seq_len, int new_tokens,
                                           int cap) {
  return max(0, min(seq_len + new_tokens, cap));
}

// chunks of one lane's window (at least one, so every row is written)
__device__ __forceinline__ int lane_chunks(int n_valid, int chunk) {
  return max(1, (n_valid + chunk - 1) / chunk);
}

struct ChunkWork {
  int b;        // lane; B when the block is past the last chunk
  int j;        // chunk of the lane
  int n_ch;     // the lane's chunk count
  int n_valid;  // the lane's valid slots
};

// the J-th chunk of the prefix sum of the lanes' chunk counts
__device__ __forceinline__ ChunkWork find_chunk(int J,
                                                const int* __restrict__ seq_lens,
                                                const int* __restrict__ q_lens,
                                                int B, int S, int cap,
                                                int chunk) {
  ChunkWork w{0, 0, 1, 0};
  for (; w.b < B; ++w.b) {
    w.n_valid =
        lane_window(seq_lens[w.b], lane_new_tokens(q_lens, w.b, S), cap);
    w.n_ch = lane_chunks(w.n_valid, chunk);
    if (J < w.n_ch) break;
    J -= w.n_ch;
  }
  w.j = J;
  return w;
}

// grid (B * R), block D, max_chunks * 2 floats of dynamic shared memory:
// merge the chunk partials of output row (b, r); lanes with one chunk
// were written by the chunk kernel.  The row's (m, l) pairs are read once,
// by as many threads, into shared memory; each thread then reads its
// element of every partial's acc, unrolled so the loads overlap.  A row
// that saw no slot (l = 0 everywhere) comes out as zeros.
__global__ void paged_merge_kernel(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   const int* __restrict__ seq_lens,
                                   const int* __restrict__ q_lens,
                                   __nv_bfloat16* __restrict__ out, int R,
                                   int D, int S, int cap, int chunk,
                                   int max_chunks) {
  extern __shared__ float ml[];  // [n][2]
  const int row = blockIdx.x;
  const int b = row / R;
  const int r = row % R;
  const int n = lane_chunks(
      lane_window(seq_lens[b], lane_new_tokens(q_lens, b, S), cap), chunk);
  if (n <= 1) return;
  const int d = threadIdx.x;
  const size_t first = (size_t)b * max_chunks * R + r;
  for (int j = d; j < n; j += blockDim.x) {
    const size_t p = first + (size_t)j * R;
    ml[2 * j] = part_ml[p * 2];
    ml[2 * j + 1] = part_ml[p * 2 + 1];
  }
  __syncthreads();
  float M = kNegInf;
  for (int j = 0; j < n; ++j) M = fmaxf(M, ml[2 * j]);
  float L = 0.f, A = 0.f;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float c = exp2f(ml[2 * j] - M);
    L += ml[2 * j + 1] * c;
    A += part_acc[(first + (size_t)j * R) * D + d] * c;
  }
  out[(size_t)row * D + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
}

// the largest chunk count a lane can have, or 0 if the arguments do not
// make whole-page chunks the merge can hold
inline int max_lane_chunks(int P, int page_size, int chunk) {
  if (P < 1 || page_size < 1 || chunk < page_size || chunk % page_size ||
      chunk / page_size > kMaxChunkPages)
    return 0;
  const int n = (P * page_size + chunk - 1) / chunk;
  // the merge keeps a row's (m, l) pairs in 48 KB of shared memory
  return n * 2 * (int)sizeof(float) > 48 * 1024 ? 0 : n;
}

// launch the merge after a chunk kernel (nothing to merge when no lane can
// have two chunks); returns the launch's error code
inline int launch_merge(const float* part_acc, const float* part_ml,
                        const int* seq_lens, const int* q_lens,
                        __nv_bfloat16* out, int B, int R, int D, int S,
                        int cap, int chunk, int max_chunks,
                        cudaStream_t st) {
  if (max_chunks <= 1) return (int)cudaSuccess;
  paged_merge_kernel<<<B * R, D, max_chunks * 2 * sizeof(float), st>>>(
      part_acc, part_ml, seq_lens, q_lens, out, R, D, S, cap, chunk,
      max_chunks);
  return (int)cudaGetLastError();
}

}  // namespace
