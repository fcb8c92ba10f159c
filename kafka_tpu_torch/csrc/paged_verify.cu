// Paged verify attention (speculative decoding) for Hopper (sm_90a), bf16
// pool, f32 softmax.
//
// Replaces the Pallas kernel `paged_verify_attention` / `_verify_kernel`
// (kafka_tpu/ops/pallas/paged_attention.py:384 / :251).  Same function:
// each sequence b brings S = K+1 query tokens at positions
// seq_len_b + j (j < S); its KV for the first q_len_b of them is already
// written, so the window holds n_valid = seq_len_b + q_len_b slots, found
// through the page table.  Query row j attends slots <= seq_len_b + j.
// Rows j >= q_len_b carry no contract (the engine discards them); this
// kernel skips them and writes zeros there.
//
// Bound on an H100: bytes.  The valid windows' K and V,
// 2 * sum_b(seq_len_b + q_len_b) * Hkv * D * 2 bytes per layer, read once
// at 3.35 TB/s; the arithmetic is 4 * Hq * D flops per (valid row, slot)
// pair — about S / 2 times K1's ~2 flops per byte, still far below the
// ~295 flops per byte at which the tensor cores become the limit.
//
// Design, and what differs from the TPU kernel:
// * GQA is indexed directly (kv head = q head / G); the TPU kernel's
//   block-diagonal q expansion existed only for Mosaic's lane tiling.
// * K1's split design: grid (sequence, kv head, split of the valid
//   window), each block writing an unnormalised partial (m, l, acc) that
//   a second, small kernel combines; with one split the block writes the
//   output itself.
// * A block holds all G * S query rows of its kv head (4 * 5 = 20 for
//   Llama-3.2-1B with K = 4).  Each row is owned by kTD = 8 consecutive
//   threads, each holding D / 8 elements of the pre-scaled query and of
//   the f32 accumulator in registers; a row's dot product is summed over
//   its 8 threads with three shuffles.
// * K and V are staged through shared memory in tiles of kTile tokens
//   (converted to f32 once): each K/V row is loaded from device memory
//   once per block and applied to every row whose causal limit
//   seq_len + j reaches it — the amortisation speculative decoding
//   exists for.
// * Each tile's scores are formed first, then one rescale per tile (not
//   per token) updates the running max.
// This first version multiplies on the CUDA cores in f32; TMA staging and
// tensor-core products are later work.
//
// Plain C interface, loaded with ctypes; the launch error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTD = 8;        // threads per query row
constexpr int kMaxRows = 32;  // G * S rows a block holds
constexpr int kThreads = kTD * kMaxRows;
constexpr int kTile = 32;     // kv tokens staged per shared-memory tile

__device__ __forceinline__ void bf16x8_to_f32(uint4 raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// grid (B, Hkv, n_splits), block kThreads.
template <int D>
__global__ void __launch_bounds__(kThreads) paged_verify_split_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, S, Hq, D]
    const __nv_bfloat16* __restrict__ k_pool,  // [SLOTS, Hkv*D]
    const __nv_bfloat16* __restrict__ v_pool,  // [SLOTS, Hkv*D]
    const int* __restrict__ page_table,        // [B, P]
    const int* __restrict__ seq_lens,          // [B]
    const int* __restrict__ q_lens,            // [B]
    __nv_bfloat16* __restrict__ out,           // [B, S, Hq, D] (1 split)
    float* __restrict__ part_acc,              // [B, S, Hq, n_splits, D]
    float* __restrict__ part_ml,               // [B, S, Hq, n_splits, 2]
    int S, int G, int Hkv, int P, int page_size, int n_splits,
    float scale) {
  constexpr int E = D / kTD;  // elements of a row per thread
  static_assert(E % 4 == 0, "D must be a multiple of 32");
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / kTD;    // query row of this thread: j * G + g
  const int sub = tid % kTD;  // which D / kTD slice of the row
  const int j = r / G;
  const int g = r % G;
  const int Hq = Hkv * G;
  const int HD = Hkv * D;

  const int seq_len = seq_lens[b];
  const int q_len = min(q_lens[b], S);
  const int n_valid = max(0, min(seq_len + q_len, P * page_size));
  const bool live = r < G * S && j < q_len;
  // this row's reach (exclusive): its own position, inside the window
  const int my_hi = live ? min(seq_len + j + 1, n_valid) : 0;
  const int per = (n_valid + n_splits - 1) / n_splits;
  const int t0 = split * per;
  const int t1 = min(t0 + per, n_valid);

  float qr[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = 0.f;
    acc[e] = 0.f;
  }
  if (live) {
    const __nv_bfloat16* qp =
        q + (((size_t)b * S + j) * Hq + (size_t)kvh * G + g) * D + sub * E;
#pragma unroll
    for (int e = 0; e < E; e += 8) {
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(qp + e), qr + e);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) qr[e] *= scale;
  }
  float m = kNegInf, l = 0.f;

  for (int base = t0; base < t1; base += kTile) {
    __syncthreads();  // the previous tile is no longer read
    const int n = min(kTile, t1 - base);
    for (int i = tid; i < kTile * (D / 8); i += kThreads) {
      const int tt = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      if (tt < n) {
        const int t = base + tt;
        const int page = page_table[(size_t)b * P + t / page_size];
        const size_t off = ((size_t)page * page_size + t % page_size) * HD +
                           (size_t)kvh * D + c;
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(k_pool + off),
                      &ks[tt][c]);
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(v_pool + off),
                      &vs[tt][c]);
      }
    }
    __syncthreads();
    // tokens of this tile the row sees: [base, base + hi)
    const int hi = min(n, my_hi - base);
    // every thread forms all kTile scores (the shuffles need the whole
    // warp); masked ones are dropped below
    float s[kTile];
    float tile_max = kNegInf;
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[tt][sub * E]);
      float d = 0.f;
#pragma unroll
      for (int e4 = 0; e4 < E / 4; ++e4) {
        const float4 k4 = kr[e4];
        d += qr[4 * e4] * k4.x + qr[4 * e4 + 1] * k4.y +
             qr[4 * e4 + 2] * k4.z + qr[4 * e4 + 3] * k4.w;
      }
#pragma unroll
      for (int o = kTD / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      s[tt] = d;
      if (tt < hi) tile_max = fmaxf(tile_max, d);
    }
    if (hi <= 0) continue;  // nothing of this tile for this row
    const float m_new = fmaxf(m, tile_max);
    const float alpha = __expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < hi) {
        const float p = __expf(s[tt] - m_new);
        l += p;
        const float4* vr =
            reinterpret_cast<const float4*>(&vs[tt][sub * E]);
#pragma unroll
        for (int e4 = 0; e4 < E / 4; ++e4) {
          const float4 v4 = vr[e4];
          acc[4 * e4] += p * v4.x;
          acc[4 * e4 + 1] += p * v4.y;
          acc[4 * e4 + 2] += p * v4.z;
          acc[4 * e4 + 3] += p * v4.w;
        }
      }
    }
    m = m_new;
  }

  if (r >= G * S) return;
  const size_t row = ((size_t)b * S + j) * Hq + (size_t)kvh * G + g;
  if (n_splits == 1) {
    const float inv = live ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    __nv_bfloat162* op =
        reinterpret_cast<__nv_bfloat162*>(out + row * D + sub * E);
#pragma unroll
    for (int e = 0; e < E / 2; ++e)
      op[e] = __floats2bfloat162_rn(acc[2 * e] * inv, acc[2 * e + 1] * inv);
  } else {
    float* pa = part_acc + (row * n_splits + split) * D + sub * E;
#pragma unroll
    for (int e = 0; e < E; ++e) pa[e] = acc[e];
    if (sub == 0) {
      part_ml[(row * n_splits + split) * 2] = m;
      part_ml[(row * n_splits + split) * 2 + 1] = l;
    }
  }
}

// grid (B * S * Hq), block D: merge the n_splits partial states of one
// row.  A row no split saw (skipped rows, empty windows) has L = 0 and
// comes out as zeros.
__global__ void paged_verify_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int n_splits, int D) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  float M = kNegInf;
  for (int s = 0; s < n_splits; ++s)
    M = fmaxf(M, part_ml[(row * n_splits + s) * 2]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float c = __expf(part_ml[(row * n_splits + s) * 2] - M);
    L += part_ml[(row * n_splits + s) * 2 + 1] * c;
    A += part_acc[(row * n_splits + s) * D + d] * c;
  }
  out[row * D + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
}

}  // namespace

extern "C" int kafka_paged_verify_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* seq_lens, const void* q_lens,
    void* out, void* part_acc, void* part_ml, int B, int S, int Hq, int Hkv,
    int D, int P, int page_size, int n_splits, float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || n_splits < 1)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (G * S > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(B, Hkv, n_splits);
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k_pool);
  auto* vp = static_cast<const __nv_bfloat16*>(v_pool);
  auto* pt = static_cast<const int*>(page_table);
  auto* sl = static_cast<const int*>(seq_lens);
  auto* ql = static_cast<const int*>(q_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  if (D == 64) {
    paged_verify_split_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, pt, sl, ql, op, pa, pm, S, G, Hkv, P, page_size,
        n_splits, scale);
  } else if (D == 128) {
    paged_verify_split_kernel<128><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, pt, sl, ql, op, pa, pm, S, G, Hkv, P, page_size,
        n_splits, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  paged_verify_combine_kernel<<<B * S * Hq, D, 0, st>>>(pa, pm, op, n_splits,
                                                        D);
  return (int)cudaGetLastError();
}
