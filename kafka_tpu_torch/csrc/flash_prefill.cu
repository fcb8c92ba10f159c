// Flash prefill attention over the paged KV pool, for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the Pallas kernel `paged_prefill_attention` / `_prefill_kernel`
// (kafka_tpu/ops/pallas/flash_prefill.py:164 / :37).  Same function: the S
// roped queries of one prefill chunk, at absolute positions
// start .. start+S-1, attend the sequence's paged window (whose KV for this
// chunk is already written).  A query at position p sees kv positions
// <= p that are below the written total start + chunk_len.  Rows past
// chunk_len are garbage (their KV went to the trash page); this kernel
// writes zeros there.
//
// Bound on an H100: operations for long chunks.  A 2048-row chunk of
// Llama-3.2-1B geometry (Hq 32, D 64) does 4 * Hq * D * sum_i(start + i + 1)
// flops, 17.2 GFLOP at start 0, against ~17 MB of q, K, V and output.
//
// Design:
// * GQA packing.  A block owns one kv head and a tile of query positions;
//   its MMA rows are (position, q head of the group) pairs, row r holding
//   position i0 + r / G and head r % G, so every K/V tile staged in shared
//   memory serves all G heads.  A warp owns MT 16-row tiles: 4 warps of 32
//   rows (128 rows, 32 positions at G 4) when that grid still fills every
//   SM once, else 4 warps of 16 rows (64-row blocks, also for the short
//   chunks: 2 warps of 16 lost to them at every measured shape).  Two
//   row tiles per warp let each K or V fragment feed four MMAs.
// * Tensor cores.  S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16
//   in, f32 accumulate), fed from shared memory by ldmatrix (.trans for
//   V).  The Q fragments stay in registers for the whole pass, except at
//   D 128 with 32 rows a warp, where the accumulators leave no room and
//   each k-step re-reads them from the Q tile.
// * Staging.  K and V tiles of 64 tokens (32 at D 128 with 32-row warps)
//   are gathered from the paged pool with 16-byte cp.async copies (one
//   token's head slice is D * 2 contiguous bytes at stride Hkv * D * 2),
//   double-buffered so tile j+1 loads under tile j's MMAs.  Rows are XOR-swizzled in 16-byte chunks
//   (chunk ^ (row & 7)) so every ldmatrix is free of bank conflicts.
//   Tokens past the block's reach are zero-filled, never read.
// * Softmax.  Online, per row in f32 registers, the (m, l) state shared by
//   the row's quad through shuffles.  The scale is applied to the f32
//   scores (q is not pre-scaled in bf16), folded into the exponent of the
//   SFU's ex2.  P is rounded to bf16 for the PV product, as the plain
//   version rounds its probabilities; O accumulates in f32 and is
//   normalised once at the end.
// * Causal work.  Tiles wholly below the block's first row's diagonal run
//   unmasked; only the last one or two tiles, which straddle the diagonal
//   or the start + chunk_len edge, are masked; tiles past the block's last
//   live row are never loaded.  Row tiles launch heaviest first.
// * The output is staged through the (by then idle) Q tile and written
//   with 16-byte stores.
// Shared memory: Q tile + two K and two V stages, (16 W MT + 4 tile) D 2
// bytes: 48 KB at D 64 and 64 KB at D 128 with 128-row blocks; dynamic,
// opted in once per block shape.
//
// Plain C interface, loaded with ctypes; the error code of the attribute
// call or the launch is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_ops.cuh"

namespace {

// kv tokens per staged tile: 64, or 32 where the warp's rows need the
// registers (D 128 with 32 rows a warp)
template <int D, int MT>
__host__ __device__ constexpr int tile_n() {
  return D * MT > 128 ? 32 : 64;
}

template <int D, int W, int MT>
constexpr int smem_bytes() {
  return (16 * W * MT * D + 4 * tile_n<D, MT>() * D) * 2;
}

// grid (Hkv, row tiles), W warps of MT 16-row MMA tiles each; row tile
// gridDim.y-1-blockIdx.y runs first
template <int D, int W, int MT>
__global__ void __launch_bounds__(W * 32) flash_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,       // [S, Hq, D]
    const __nv_bfloat16* __restrict__ k_pool,  // [SLOTS, Hkv*D]
    const __nv_bfloat16* __restrict__ v_pool,  // [SLOTS, Hkv*D]
    const int* __restrict__ page_row,          // [P]
    __nv_bfloat16* __restrict__ out,           // [S, Hq, D]
    int S, int G, int Hkv, int page_size, int start, int chunk_len,
    float scale_log2) {
  constexpr int BM = 16 * W * MT;  // MMA rows of the block
  constexpr int kTileN = tile_n<D, MT>();
  constexpr int NT = 32 * W;       // threads
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NB = kTileN / 8;   // 8-wide column blocks of a score tile
  constexpr int ND = D / 8;        // 8-wide column blocks of the output
  // Q fragments stay in registers for the whole pass unless the rows'
  // accumulators leave no room (D 128 with 32 rows a warp): then each
  // k-step re-reads them from the Q tile
  constexpr bool kQInRegs = D * MT <= 128;
  extern __shared__ __align__(128) __nv_bfloat16 smem[];
  __nv_bfloat16* qs = smem;                 // [BM][D]
  __nv_bfloat16* ks = qs + BM * D;          // [2][kTileN][D]
  __nv_bfloat16* vs = ks + 2 * kTileN * D;  // [2][kTileN][D]

  const int kvh = blockIdx.x;
  const int QP = BM / G;  // query positions of the block
  const int i0 = (gridDim.y - 1 - blockIdx.y) * QP;
  const int Hq = Hkv * G;
  const int HD = Hkv * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = warp * 16 * MT;  // the warp's first row

  // live positions [i0, i_end); the block's kv reach [0, kv_hi)
  const int i_end = min(i0 + QP, chunk_len);
  const int kv_hi = start + i_end;
  const int n_kv = i_end > i0 ? (kv_hi + kTileN - 1) / kTileN : 0;
  // tiles every row sees whole: they end at or before the first row's
  // position start + i0
  const int n_full = (start + i0 + 1) / kTileN;

  // this thread's rows (gq and gq + 8 of each of its warp's MT tiles):
  // the last kv position each may see; rows that are not live see
  // everything (their q is zero and their output is written as zeros)
  int lim[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + gq + 8 * h;
      const int i = i0 + r / G;
      lim[mt][h] = (r < QP * G && i < i_end) ? start + i : 0x7fffffff;
    }
  }

  auto load_kv = [&](int j, int stage) {
    const int t0 = j * kTileN;
    __nv_bfloat16* kd = ks + stage * kTileN * D;
    __nv_bfloat16* vd = vs + stage * kTileN * D;
#pragma unroll
    for (int c = tid; c < kTileN * CH; c += NT) {
      const int tt = c / CH, ch = c % CH;
      const int t = t0 + tt;
      const bool ok = t < kv_hi;
      size_t off = 0;
      if (ok) {
        off = ((size_t)page_row[t / page_size] * page_size + t % page_size) *
                  HD + (size_t)kvh * D + ch * 8;
      }
      cp_async16(smem_addr(kd + swz<D>(tt, ch)), k_pool + off, ok);
      cp_async16(smem_addr(vd + swz<D>(tt, ch)), v_pool + off, ok);
    }
  };

  float o[MT][ND][4];
  float m[MT][2], l[MT][2];  // running max (raw score units) and sum
  uint32_t qf[kQInRegs ? MT : 1][kQInRegs ? KS : 1][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  if (n_kv > 0) {
    // the Q tile rides in the first tile's copy group
#pragma unroll
    for (int c = tid; c < BM * CH; c += NT) {
      const int r = c / CH, ch = c % CH;
      const int i = i0 + r / G;
      const bool ok = r < QP * G && i < i_end;
      const __nv_bfloat16* src =
          ok ? q + ((size_t)i * Hq + kvh * G + r % G) * D + ch * 8 : q;
      cp_async16(smem_addr(qs + swz<D>(r, ch)), src, ok);
    }
    load_kv(0, 0);
    cp_async_commit();
  }

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      load_kv(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kQInRegs && j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int r = row0 + mt * 16 + (lane & 15);
          ldsm_x4(smem_addr(qs + swz<D>(r, 2 * kk + (lane >> 4))),
                  qf[mt][kk][0], qf[mt][kk][1], qf[mt][kk][2],
                  qf[mt][kk][3]);
        }
      }
    }
    const __nv_bfloat16* kt = ks + (j & 1) * kTileN * D;
    const __nv_bfloat16* vt = vs + (j & 1) * kTileN * D;

    // S = Q K^T over the tile's tokens; each K fragment serves the
    // warp's MT row tiles
    float s[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qk[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (kQInRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            qk[mt][x] = qf[kQInRegs ? mt : 0][kQInRegs ? kk : 0][x];
        } else {
          const int r = row0 + mt * 16 + (lane & 15);
          ldsm_x4(smem_addr(qs + swz<D>(r, 2 * kk + (lane >> 4))),
                  qk[mt][0], qk[mt][1], qk[mt][2], qk[mt][3]);
        }
      }
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        const int tok = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(kt + swz<D>(tok, 2 * kk + ((lane >> 3) & 1))), b0,
                b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qk[mt], b0, b1);
          mma_bf16(s[mt][2 * np + 1], qk[mt], b2, b3);
        }
      }
    }

    // mask the straddling tiles; online softmax with the scale folded
    // into the exponent (exp2 of s * scale * log2e - m * scale * log2e)
    const int t0 = j * kTileN;
    if (j >= n_full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (t0 + n * 8 + 2 * tq + (e & 1) > lim[mt][e >> 1])
              s[mt][n][e] = -INFINITY;
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mb[2];  // the exponent's offset per row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * h], s[mt][n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][h], mx);
        // a row with nothing visible yet keeps a finite reference point
        mb[h] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
        const float alpha = exp2_approx(m[mt][h] * scale_log2 - mb[h]);
        m[mt][h] = m_new;
        l[mt][h] *= alpha;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[mt][n][2 * h] *= alpha;
          o[mt][n][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2_approx(fmaf(s[mt][n][e], scale_log2, -mb[e >> 1]));
          l[mt][e >> 1] += p;
          s[mt][n][e] = p;
        }
      }
    }

    // O += P V, P rounded to bf16 from the score accumulators in place;
    // each V fragment serves the warp's MT row tiles
#pragma unroll
    for (int ks16 = 0; ks16 < kTileN / 16; ++ks16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * ks16][0], s[mt][2 * ks16][1]);
        a[mt][1] = pack_bf16(s[mt][2 * ks16][2], s[mt][2 * ks16][3]);
        a[mt][2] = pack_bf16(s[mt][2 * ks16 + 1][0], s[mt][2 * ks16 + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * ks16 + 1][2], s[mt][2 * ks16 + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        const int tok = ks16 * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_addr(vt + swz<D>(tok, 2 * dp + (lane >> 4))), b0,
                      b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], a[mt], b0, b1);
          mma_bf16(o[mt][2 * dp + 1], a[mt], b2, b3);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // normalise once; rows that are not live come out as zeros
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[mt][h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = lim[mt][h] != 0x7fffffff ? 1.f / sum : 0.f;
      const int r = row0 + mt * 16 + gq + 8 * h;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(qs + swz<D>(r, n) + 2 * tq) =
            __floats2bfloat162_rn(o[mt][n][2 * h] * inv,
                                  o[mt][n][2 * h + 1] * inv);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = tid; c < BM * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const int i = i0 + r / G;
    if (r < QP * G && i < S) {
      *reinterpret_cast<uint4*>(out + ((size_t)i * Hq + kvh * G + r % G) * D +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<D>(r, ch));
    }
  }
}

// blocks of the grid for W warps of MT row tiles
inline long grid_blocks(int S, int G, int Hkv, int W, int MT) {
  const int QP = 16 * W * MT / G;
  return (long)((S + QP - 1) / QP) * Hkv;
}

template <int D, int W, int MT>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k_pool,
           const __nv_bfloat16* v_pool, const int* page_row,
           __nv_bfloat16* out, int S, int G, int Hkv, int page_size, int start,
           int chunk_len, float scale_log2, cudaStream_t st) {
  // opt in to the dynamic shared memory once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_mma_kernel<D, W, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D, W, MT>());
  if (attr != cudaSuccess) return (int)attr;
  const int QP = 16 * W * MT / G;
  dim3 grid(Hkv, (S + QP - 1) / QP);
  flash_prefill_mma_kernel<D, W, MT>
      <<<grid, 32 * W, smem_bytes<D, W, MT>(), st>>>(
          q, k_pool, v_pool, page_row, out, S, G, Hkv, page_size, start,
          chunk_len, scale_log2);
  return (int)cudaGetLastError();
}

// 4 warps of MT 16-row tiles at head dim D
template <int D>
int launch_shape(int MT, const __nv_bfloat16* q,
                 const __nv_bfloat16* k_pool, const __nv_bfloat16* v_pool,
                 const int* page_row, __nv_bfloat16* out, int S, int G,
                 int Hkv, int page_size, int start, int chunk_len,
                 float scale_log2, cudaStream_t st) {
  if (MT == 2)
    return launch<D, 4, 2>(q, k_pool, v_pool, page_row, out, S, G, Hkv,
                           page_size, start, chunk_len, scale_log2, st);
  if (MT == 1)
    return launch<D, 4, 1>(q, k_pool, v_pool, page_row, out, S, G, Hkv,
                           page_size, start, chunk_len, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// row_tiles = 0 lets the launcher pick the block shape; else each of its 4
// warps owns row_tiles (1 or 2) 16-row tiles.  Both shapes compute the
// same function; the choice is only a matter of time.
extern "C" int kafka_flash_prefill_bf16_tiles(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_row, void* out, int S, int Hq, int Hkv, int D, int P,
    int page_size, int start, int chunk_len, float scale, void* stream,
    int row_tiles) {
  if (Hkv < 1 || Hq % Hkv != 0 || S < 1 || page_size < 1 || start < 0 ||
      chunk_len < 1 || chunk_len > S || start + chunk_len > P * page_size)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (G > 8) return (int)cudaErrorInvalidValue;
  if (row_tiles == 0) {
    // 4 warps of 32 rows where that grid still fills every SM once, else
    // 4 warps of 16
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    row_tiles = grid_blocks(S, G, Hkv, 4, 2) >= sms ? 2 : 1;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k_pool);
  auto* vp = static_cast<const __nv_bfloat16*>(v_pool);
  auto* pr = static_cast<const int*>(page_row);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const float sl2 = scale * kLog2e;
  if (D == 64)
    return launch_shape<64>(row_tiles, qp, kp, vp, pr, op, S, G, Hkv,
                            page_size, start, chunk_len, sl2, st);
  if (D == 128)
    return launch_shape<128>(row_tiles, qp, kp, vp, pr, op, S, G, Hkv,
                             page_size, start, chunk_len, sl2, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int kafka_flash_prefill_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_row, void* out, int S, int Hq, int Hkv, int D, int P,
    int page_size, int start, int chunk_len, float scale, void* stream) {
  return kafka_flash_prefill_bf16_tiles(q, k_pool, v_pool, page_row, out, S,
                                        Hq, Hkv, D, P, page_size, start,
                                        chunk_len, scale, stream, 0);
}
