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
// Design:
// * K1's split grid — (sequence, kv head, split of the valid window) plus
//   a small combine kernel — but K3's staging: K/V rows go through shared
//   memory in 32-token tiles with 16-byte loads, so a warp keeps several
//   loads in flight instead of walking its tokens one dependent load at a
//   time (on the H100, PERF.md records K3 reading K1's window in less
//   device time than K1).
// * The 4 warps of a block take the split's tiles in turn, each staging
//   its own tile (64 B of int8 K and V per token at D = 64, with the
//   tile's 32 s_k / s_v as f32 beside them), so a warp waits only on its
//   own loads (__syncwarp, no block barrier in the loop).  At the end the
//   warps' (m, l, acc) states merge through shared memory.
// * Codes are converted to f32 on the read from shared memory.  Each
//   query row of the kv head is held by 8 lanes (D / 8 elements each, the
//   G <= 8 rows in RPT = ceil(G / 4) passes of 4 row groups); a dot
//   product is summed with three shuffles.  Lane `sub` keeps the scores of
//   tokens sub, sub + 8, ... of the tile, so a tile costs 4 score
//   registers per row; the PV loop fetches each probability with one
//   shuffle.
// * Every shuffle runs with the whole warp: the score loop runs all 32
//   tokens of a tile whatever is valid, and the PV loop's bound is the
//   same for all lanes.  Tokens past the window are masked after.
// * Masking is by seq_len, as in K1: a slot never written holds q = 0,
//   s = 0 and a reused page stale codes, and neither is read as valid.
//   The trash lane (table row all page 0) reads page 0 and is discarded.
// This first version multiplies on the CUDA cores in f32; TMA staging and
// loads issued a tile ahead of the math are later work.
//
// Plain C interface, loaded with ctypes; the launch error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;  // tokens a warp stages at a time
constexpr int kTD = 8;     // lanes per query row

__device__ __forceinline__ void bf16x8_to_f32(uint4 raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int E>
__device__ __forceinline__ void i8_to_f32(const int8_t* p, float* out) {
#pragma unroll
  for (int c = 0; c < E; c += 4) {
    const char4 v = *reinterpret_cast<const char4*>(p + c);
    out[c] = static_cast<float>(v.x);
    out[c + 1] = static_cast<float>(v.y);
    out[c + 2] = static_cast<float>(v.z);
    out[c + 3] = static_cast<float>(v.w);
  }
}

// grid (B, Hkv, n_splits), block kThreads.  RPT = query rows per lane.
template <int D, int RPT>
__global__ void __launch_bounds__(kThreads) paged_decode_int8_split_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
    const int8_t* __restrict__ k_q,       // [SLOTS, Hkv*D]
    const float* __restrict__ k_s,        // [SLOTS]
    const int8_t* __restrict__ v_q,       // [SLOTS, Hkv*D]
    const float* __restrict__ v_s,        // [SLOTS]
    const int* __restrict__ page_table,   // [B, P]
    const int* __restrict__ seq_lens,     // [B]
    __nv_bfloat16* __restrict__ out,      // [B, Hq, D] (1 split)
    float* __restrict__ part_acc,         // [B, Hq, n_splits, D]
    float* __restrict__ part_ml,          // [B, Hq, n_splits, 2]
    int G, int Hkv, int P, int page_size, int n_splits, float scale) {
  constexpr int E = D / kTD;      // codes of a row per lane: 8 or 16
  constexpr int CH = D / 16;      // 16-byte chunks of a token's row
  constexpr int kRows = 4 * RPT;  // row slots of a warp
  static_assert(E % 8 == 0, "D must be a multiple of 64");
  // per warp: a tile of int8 K rows then V rows; after the loop the same
  // bytes hold the warps' (acc, m, l) for the merge
  constexpr int kStage = kWarps * kTile * D * 2;
  constexpr int kMerge = kWarps * kRows * (D + 2) * 4;
  __shared__ __align__(16) unsigned char smem[kStage > kMerge ? kStage
                                                              : kMerge];
  __shared__ float kss[kWarps][kTile];
  __shared__ float vss[kWarps][kTile];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = lane / kTD;   // row group: rows rg, rg + 4
  const int sub = lane % kTD;  // which D / 8 slice of the row
  const int Hq = Hkv * G;
  const int HD = Hkv * D;
  int8_t* ks = reinterpret_cast<int8_t*>(smem) + w * kTile * D * 2;
  int8_t* vs = ks + kTile * D;

  const int seq_len = seq_lens[b];
  const int n_valid = max(0, min(seq_len + 1, P * page_size));
  const int per = (n_valid + n_splits - 1) / n_splits;
  const int t0 = min(split * per, n_valid);
  const int t1 = min(t0 + per, n_valid);

  float qr[RPT][E], acc[RPT][E], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + 4 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[i][e] = 0.f;
      acc[i][e] = 0.f;
    }
    if (r < G) {
      const __nv_bfloat16* qp =
          q + ((size_t)b * Hq + (size_t)kvh * G + r) * D + sub * E;
#pragma unroll
      for (int e = 0; e < E; e += 8)
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(qp + e), qr[i] + e);
    }
  }

  for (int base = t0 + w * kTile; base < t1; base += kWarps * kTile) {
    const int n = min(kTile, t1 - base);  // >= 1, the same for the warp
    for (int i = lane; i < kTile * CH; i += 32) {
      const int tt = i / CH;
      const int c = (i % CH) * 16;
      if (tt < n) {
        const int t = base + tt;
        const int page = page_table[(size_t)b * P + t / page_size];
        const size_t off = ((size_t)page * page_size + t % page_size) * HD +
                           (size_t)kvh * D + c;
        *reinterpret_cast<uint4*>(ks + tt * D + c) =
            *reinterpret_cast<const uint4*>(k_q + off);
        *reinterpret_cast<uint4*>(vs + tt * D + c) =
            *reinterpret_cast<const uint4*>(v_q + off);
      }
    }
    if (lane < n) {
      const int t = base + lane;
      const int page = page_table[(size_t)b * P + t / page_size];
      const size_t slot = (size_t)page * page_size + t % page_size;
      kss[w][lane] = k_s[slot];
      vss[w][lane] = v_s[slot];
    }
    __syncwarp();

    // raw dot products; this lane keeps those of tokens 8 * j + sub
    float sc[RPT][4];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      float kf[E];
      i8_to_f32<E>(ks + tt * D + sub * E, kf);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qr[i][e] * kf[e];
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if (sub == (tt & 7)) sc[i][tt >> 3] = d;
      }
    }
    // scores with the per-slot k scale, one rescale per tile; sc then
    // holds this lane's probabilities (0 past the window)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tt = 8 * j + sub;
        sc[i][j] = tt < n ? sc[i][j] * scale * kss[w][tt] : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = 8 * j + sub < n ? __expf(sc[i][j] - m_new) : 0.f;
        sc[i][j] = p;
        l[i] += p;  // this lane's share; summed over the row's 8 lanes
      }
      m[i] = m_new;
    }
    // PV with the per-slot v scale; the bound n is the same for the warp
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < n) {
        float vf[E];
        i8_to_f32<E>(vs + tt * D + sub * E, vf);
        const float sv = vss[w][tt];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float p = __shfl_sync(0xffffffffu, sc[i][tt >> 3],
                                      (lane & ~7) | (tt & 7)) * sv;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i][e] += p * vf[e];
        }
      }
    }
    __syncwarp();  // the tile is read before the next one is staged
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
  }

  // merge the warps' states; a warp that saw no tile has l = 0, acc = 0
  __syncthreads();  // every warp is done with its staging bytes
  float* mrg = reinterpret_cast<float*>(smem);  // [kWarps][kRows][D + 2]
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float* row = mrg + ((size_t)w * kRows + rg + 4 * i) * (D + 2);
#pragma unroll
    for (int e = 0; e < E; ++e) row[sub * E + e] = acc[i][e];
    if (sub == 0) {
      row[D] = m[i];
      row[D + 1] = l[i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      M = fmaxf(M, mrg[((size_t)v * kRows + r) * (D + 2) + D]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float* row = mrg + ((size_t)v * kRows + r) * (D + 2);
      const float c = __expf(row[D] - M);
      L += row[D + 1] * c;
      A += row[d] * c;
    }
    const size_t orow = (size_t)b * Hq + (size_t)kvh * G + r;
    if (n_splits == 1) {
      out[orow * D + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
    } else {
      part_acc[(orow * n_splits + split) * D + d] = A;
      if (d == 0) {
        part_ml[(orow * n_splits + split) * 2] = M;
        part_ml[(orow * n_splits + split) * 2 + 1] = L;
      }
    }
  }
}

// grid (B * Hq), block D: merge the n_splits partial states of one row.
// An empty split has L = 0 and adds nothing.
__global__ void paged_decode_int8_combine_kernel(
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

template <int D, int RPT>
void launch_split(dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
                  const int8_t* kq, const float* ks, const int8_t* vq,
                  const float* vs, const int* pt, const int* sl,
                  __nv_bfloat16* out, float* pa, float* pm, int G, int Hkv,
                  int P, int page_size, int n_splits, float scale) {
  paged_decode_int8_split_kernel<D, RPT><<<grid, kThreads, 0, st>>>(
      q, kq, ks, vq, vs, pt, sl, out, pa, pm, G, Hkv, P, page_size, n_splits,
      scale);
}

}  // namespace

extern "C" int kafka_paged_decode_int8(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* page_table, const void* seq_lens, void* out,
    void* part_acc, void* part_ml, int B, int Hq, int Hkv, int D, int P,
    int page_size, int n_splits, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || n_splits < 1 || page_size < 1)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (G > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(B, Hkv, n_splits);
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
  const bool two = G > 4;
  if (D == 64 && !two) {
    launch_split<64, 1>(grid, st, qp, kq, ks, vq, vs, pt, sl, op, pa, pm, G,
                        Hkv, P, page_size, n_splits, scale);
  } else if (D == 64) {
    launch_split<64, 2>(grid, st, qp, kq, ks, vq, vs, pt, sl, op, pa, pm, G,
                        Hkv, P, page_size, n_splits, scale);
  } else if (D == 128 && !two) {
    launch_split<128, 1>(grid, st, qp, kq, ks, vq, vs, pt, sl, op, pa, pm, G,
                         Hkv, P, page_size, n_splits, scale);
  } else if (D == 128) {
    launch_split<128, 2>(grid, st, qp, kq, ks, vq, vs, pt, sl, op, pa, pm, G,
                         Hkv, P, page_size, n_splits, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  paged_decode_int8_combine_kernel<<<B * Hq, D, 0, st>>>(pa, pm, op, n_splits,
                                                         D);
  return (int)cudaGetLastError();
}
