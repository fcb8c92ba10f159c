// Fused decode MLP block for Hopper (sm_90a): rmsnorm + SwiGLU + residual,
// bf16 activations, bf16 or int8 weights with per-output-channel f32
// scales, products on the tensor cores.
//
// Replaces the Pallas kernel `fused_mlp_block` / `_kernel`
// (kafka_tpu/ops/pallas/fused_mlp.py:153 / :84).  Same function:
//   out = h + W_d(silu(nx W_g) * (nx W_u)),   nx = bf16(rmsnorm(h) * ln)
// with the JAX kernel's rounding points: the norm in f32 and nx rounded
// to bf16; each projection accumulated in f32, its int8 scales applied to
// the f32 output, then rounded once to bf16; silu with the sigmoid in f32,
// rounded to bf16, times u in bf16; the residual added in bf16.
//
// Bound on an H100: bytes.  At decode (B <= 64 rows) every weight byte is
// used at most 64 times, below the ~295 flops per byte at which the
// tensor cores become the limit, so the three weight matrices, read once,
// bound it: 3 * H * F * 2 bytes in bf16 (1 byte in int8, plus the scales)
// at 3.35 TB/s; 0.030 ms (bf16) and 0.015 ms (int8) at H 2048, F 8192.
//
// Design.  Three launches a call, no scratch but nx and p, no float
// atomics, deterministic:
//   (0) one block per row: nx = bf16(rmsnorm(h) * ln), [B, H];
//   (a) gate/up, one block per 32 columns of F (F / 32 blocks, 256 at
//       F 8192: two per SM): g and u over all of H, then
//       p = bf16(silu(g)) * u, [B, F];
//   (b) down, one block per 64 columns of H and split of F (F split
//       into the most parts, up to 8, of whole 128-row stages; H / 64 x
//       8 = 256 blocks at H 2048, F 8192); the splits of a
//       column tile form one thread block cluster, which adds their sums
//       through distributed shared memory in split order, then applies
//       the scale, rounds and adds the residual.
// (a) and (b) are launched programmatically dependent on the launch
// before them: each starts its weight copies while the previous launch
// finishes, and waits for it only before it reads that launch's output.
// Both passes are one product, y^T[64, B] = W^T[64, K] x^T[K, B]: the
// weight tile is the M side of mma.sync m16n8k16 (bf16 in, f32
// accumulators) and up to 8 activation rows its N side ("swap AB"), so
// B 8 wastes no lane of the tensor core; B up to 64 takes 8 such N tiles
// from the same weight fragments, so each weight byte is read once for
// every B <= 64.  A block's 4 warps split each stage's rows (the
// contraction); their sums meet in shared memory at the end, in order.
// * Bytes in flight: the weight and activation tiles arrive by TMA (one
//   2D tensor-map copy a box, completion on an mbarrier) in a 4-stage
//   shared-memory ring of 8 KB weight stages (64 rows of bf16, 128 of
//   int8): three stages, 24 KB, in flight a block, 48 KB an SM, against
//   the ~18 KB that 3.35 TB/s at ~0.7 us of latency needs (cp.async, 16
//   bytes a thread, fed the same ring at about the same rate).  The old
//   design kept ~8 KB a block in flight through registers and started
//   128 blocks for the down pass.
// * Instruction stream: bf16 weight fragments come from ldmatrix.trans
//   (one instruction per 16 x 16 tile), so the products cost a few
//   instructions per 256 weights instead of one FFMA per weight and row.
//   int8 codes are widened in registers, exactly (|q| <= 127 is exact in
//   bf16): a byte permute into the float 2^23 + (q + 128), one
//   subtraction, and a permute that packs the high halves of two such
//   floats into a bf16 pair, about 3 instructions a code and once per
//   code, against ~10 a byte in the old design.  The M index is permuted
//   for int8 so that each lane widens 8 contiguous codes of a row (one
//   8-byte shared load): lane group g covers columns 8g .. 8g + 7, m-tile
//   i row r <-> column 8 (r % 8) + 2 i + r / 8; the epilogue undoes it.
// * What bounds it now is not isolated (PERF.md).  The likely cost: each
//   of the three launches pays a ramp (its first copies' round trip) and
//   an epilogue (the warps' and the splits' reductions), which the bf16
//   layer's 100 MB hides better than the int8 layer's 50 MB.
//
// Plain C interface, loaded with ctypes; the launch error code is returned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "tile_ops.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNormThreads = 256;
constexpr int kCols = 64;      // weight columns of a block (M side)
constexpr int kStages = 4;     // shared-memory ring depth
constexpr int kRedRow = kCols + 4;  // f32 row of the warps' partial sums
constexpr int kMaxSplits = 8;  // down pass: a cluster of split blocks

// A stage: KC weight rows of the block's kCols columns as TMA wrote them
// (8 KB), then the activation rows' KC columns (NT * 8 rows, 128-byte
// boxes).  TMA swizzles each box: the 16-byte piece index of a byte at
// offset o of a box is XORed with bits 7.. of o, over the box's row width
// (swizzled() below: 128 B rows take 3 bits, 64 B 2, 32 B 1), which keeps
// ldmatrix and the int8 loads free of (bf16) or low in (int8) bank
// conflicts.  The gate/up pass holds two boxes, w0's and w1's columns.
template <typename W>
struct Stage;

template <>
struct Stage<__nv_bfloat16> {
  static constexpr int KC = 64;          // weight rows (contraction) a stage
  static constexpr int kRowBytes = 128;  // 64 columns of bf16
};

template <>
struct Stage<int8_t> {
  static constexpr int KC = 128;
  static constexpr int kRowBytes = 64;
};

constexpr int kWBytes = 8192;  // a stage's weights, either type
constexpr int kXBox = 64;      // activation columns of an x box (128 B)

template <typename W, int NT>
struct Layout {
  static constexpr int KC = Stage<W>::KC;
  static_assert(KC * Stage<W>::kRowBytes == kWBytes, "8 KB of weights");
  static constexpr int kXBoxBytes = NT * 8 * kXBox * 2;
  static constexpr int kXBytes = (KC / kXBox) * kXBoxBytes;
  static constexpr int kStageBytes = kWBytes + kXBytes;  // 1 KB multiple
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kRedBytes = kWarps * NT * 8 * kRedRow * 4;
  // the block's sums, [NT * 8][kCols] f32, after the warps' partials
  static constexpr int kSumBytes = NT * 8 * kCols * 4;
  static constexpr int kEpiBytes = kRedBytes + kSumBytes;
  // + 1 KB: the ring starts on a 1 KB boundary (128-byte swizzle span)
  static constexpr int kSmem =
      (kRingBytes > kEpiBytes ? kRingBytes : kEpiBytes) + 1024;
};

// offset of byte o of a TMA box whose rows are `row_bytes` wide
template <int row_bytes>
__device__ __forceinline__ uint32_t swizzled(uint32_t o) {
  constexpr uint32_t mask = row_bytes == 128 ? 7 : row_bytes == 64 ? 3 : 1;
  return o ^ (((o >> 7) & mask) << 4);
}

// Offset in a stage of byte b (0 .. kRowBytes - 1) of weight row k: one
// box of the block's columns, or (DUAL) w0's box then w1's.
template <typename W, bool DUAL>
__device__ __forceinline__ uint32_t w_offset(int k, int b) {
  constexpr int RB = Stage<W>::kRowBytes;
  if constexpr (DUAL) {
    constexpr int half = RB / 2;
    return (b / half) * (kWBytes / 2) + swizzled<half>(k * half + b % half);
  } else {
    return swizzled<RB>(k * RB + b);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

// the one arrival of the barrier's phase, and the bytes it waits for
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait for the phase of parity `parity` to complete; a copy that never
// lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

// TMA: the box of `map` at (column c0, row c1) into shared memory at dst;
// its bytes count down the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Programmatic dependent launch: a launch made with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the previous launch has called griddep_launch_dependents (or
// exited); griddep_wait blocks until that launch has completed and its
// writes are visible.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The exact f32 of the int8 code in byte SEL & 3 of v, where v holds codes
// + 128 (codes ^ 0x80): the float 2^23 + (q + 128), less 2^23 + 128.
template <int SEL>
__device__ __forceinline__ uint32_t code_f32(uint32_t v) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 | SEL)) -
      8388736.f);
}

// two exact f32 of codes as a bf16 pair (lo in the low half): their high
// halves, since |q| <= 128 has no set bit in the low 16
__device__ __forceinline__ uint32_t hi_halves(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// Byte B (0..7) of an 8-byte row piece r (codes + 128), as f32 bits.
template <int B>
__device__ __forceinline__ uint32_t piece_code(const uint2& r) {
  return code_f32<B & 3>(B < 4 ? r.x : r.y);
}

// The A fragments of m-tiles 0..3 from int8 rows 2t, 2t + 1, 2t + 8,
// 2t + 9 of a k16 step (r[0..3], this lane's 8 codes of each, + 128).
// m-tile i row g takes byte 2i, row g + 8 byte 2i + 1.
template <int I>
__device__ __forceinline__ void widen_tile(const uint2 (&r)[4],
                                           uint32_t (&a)[4]) {
  a[0] = hi_halves(piece_code<2 * I>(r[0]), piece_code<2 * I>(r[1]));
  a[1] = hi_halves(piece_code<2 * I + 1>(r[0]), piece_code<2 * I + 1>(r[1]));
  a[2] = hi_halves(piece_code<2 * I>(r[2]), piece_code<2 * I>(r[3]));
  a[3] = hi_halves(piece_code<2 * I + 1>(r[2]), piece_code<2 * I + 1>(r[3]));
}

// The tile column of accumulator row (m-tile i, group g, upper half hi).
template <typename W>
__device__ __forceinline__ int acc_col(int i, int g, int hi) {
  if constexpr (sizeof(W) == 1) return 8 * g + 2 * i + hi;
  return 16 * i + g + 8 * hi;
}

// grid (B), block kNormThreads: nx[b] = bf16(h[b] * rsqrt(mean(h[b]^2) +
// eps) * ln), all in f32.
__global__ void __launch_bounds__(kNormThreads) mlp_rmsnorm_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ ln,
    __nv_bfloat16* __restrict__ nx, int H, float eps) {
  __shared__ float part[kNormThreads / 32];
  griddep_launch_dependents();  // the gate/up pass may start its copies
  const size_t row = (size_t)blockIdx.x * H;
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += kNormThreads) {
    const float x = __bfloat162float(h[row + k]);
    ss += x * x;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int v = 0; v < kNormThreads / 32; ++v) total += part[v];
  const float inv = rsqrtf(total / H + eps);
  for (int k = threadIdx.x; k < H; k += kNormThreads) {
    const float x = __bfloat162float(h[row + k]);
    nx[row + k] = __float2bfloat16(x * inv * __bfloat162float(ln[k]));
  }
}

// One pass: y^T[64, B] = W^T[64, K] x^T[K, B] over this block's rows of
// K, then the pass's epilogue.
// DUAL (gate/up): grid (N / 32); the block's 64 columns are w0's 32 and
//   w1's 32 at n0 = 32 * blockIdx.x; y[b, n] = bf16(silu(bf16(g * s0)))
//   * bf16(u * s1) (scales null for bf16 weights).
// else (down): grid (N / 64, splits), clusters of (1, splits): rows
//   [k0, k0 + k_len) of K with k0 = blockIdx.y * k_len; each block leaves
//   its sums in its shared memory, and block r of the cluster adds the
//   splits' sums of rows r * B / splits .. in split order (distributed
//   shared memory) and writes y = res + bf16(sum * s0).
// tw0, tw1: tensor maps of the weights [K, N] (boxes of KC rows and the
// block's columns); tx: of the activation rows [B, K] (boxes of NT * 8
// rows, rows past B filled with zeros, and kXBox columns).
template <typename W, bool DUAL, int NT>
__global__ void __launch_bounds__(kThreads) mlp_pass_kernel(
    const __grid_constant__ CUtensorMap tw0,
    const __grid_constant__ CUtensorMap tw1,
    const __grid_constant__ CUtensorMap tx, int N,
    const float* __restrict__ s0, const float* __restrict__ s1,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ y,
    int B, int k_len) {
  using L = Layout<W, NT>;
  constexpr int KC = L::KC;
  constexpr bool kInt8 = sizeof(W) == 1;
  __shared__ __align__(8) uint64_t full[kStages];  // a slot's bytes landed
  extern __shared__ unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n0 = blockIdx.x * (DUAL ? kCols / 2 : kCols);
  const int k0 = DUAL ? 0 : blockIdx.y * k_len;
  const int n_stages = k_len / KC;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (ring - raw);
  const uint32_t bar0 = smem_addr(&full[0]);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  griddep_launch_dependents();  // the next pass may start its copies

  // thread 0 stages the weight rows, and the activation rows (the previous
  // launch's output), of stage s into ring slot `slot`
  auto load_weights = [&](int s, int slot) {
    const uint32_t dst = ring + slot * L::kStageBytes;
    const uint32_t bar = bar0 + 8 * slot;
    mbar_expect(bar, L::kStageBytes);
    tma_load(dst, &tw0, n0, k0 + s * KC, bar);
    if constexpr (DUAL) tma_load(dst + kWBytes / 2, &tw1, n0, s * KC, bar);
  };
  auto load_x = [&](int s, int slot) {
    const uint32_t dst = ring + slot * L::kStageBytes + kWBytes;
#pragma unroll
    for (int j = 0; j < KC / kXBox; ++j)
      tma_load(dst + j * L::kXBoxBytes, &tx, k0 + s * KC + j * kXBox, 0,
               bar0 + 8 * slot);
  };

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  // The weights do not depend on the previous launch: the first stages'
  // copies start while it finishes (programmatic dependent launch), and
  // only the activation rows wait for it.
  if (tid == 0)
    for (int s = 0; s < kStages - 1 && s < n_stages; ++s)
      load_weights(s, s);
  griddep_wait();
  if (tid == 0)
    for (int s = 0; s < kStages - 1 && s < n_stages; ++s) load_x(s, s);
  for (int s = 0; s < n_stages; ++s) {
    if (s > 0) __syncthreads();  // slot (s - 1) % kStages is no longer read
    const int f = s + kStages - 1;
    if (tid == 0 && f < n_stages) {
      load_weights(f, f % kStages);
      load_x(f, f % kStages);
    }
    mbar_wait(bar0 + 8 * (s % kStages), (s / kStages) & 1);
    const uint32_t wbase = ring + (s % kStages) * L::kStageBytes;
    const uint32_t xbase = wbase + kWBytes;
    const unsigned char* wtile = smem + (s % kStages) * L::kStageBytes;
#pragma unroll
    for (int ks = 0; ks < KC / (16 * kWarps); ++ks) {
      const int kk = warp * (KC / kWarps) + ks * 16;  // first row of the step
      uint32_t a[4][4];
      if constexpr (kInt8) {
        uint2 r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kk + 2 * t + (j & 1) + 8 * (j >> 1);
          r[j] = *reinterpret_cast<const uint2*>(
              wtile + w_offset<W, DUAL>(k, 8 * g));
          r[j].x ^= 0x80808080u;
          r[j].y ^= 0x80808080u;
        }
        widen_tile<0>(r, a[0]);
        widen_tile<1>(r, a[1]);
        widen_tile<2>(r, a[2]);
        widen_tile<3>(r, a[3]);
      } else {
        const int q = lane / 8;
        const int k = kk + (lane % 8) + 8 * (q >> 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ldsm_x4_trans(wbase + w_offset<W, DUAL>(k, 32 * i + 16 * (q & 1)),
                        a[i][0], a[i][1], a[i][2], a[i][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = 8 * n + (lane % 8);
        const int col = kk + 8 * ((lane / 8) & 1);  // of the stage's KC
        uint32_t b0, b1;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
            : "=r"(b0), "=r"(b1)
            : "r"(xbase + (col / kXBox) * L::kXBoxBytes +
                  swizzled<128>(r * 128 + (col % kXBox) * 2)));
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[i][n], a[i], b0, b1);
      }
    }
  }
  __syncthreads();  // the ring is free: the warps' sums go there

  float* red = reinterpret_cast<float*>(smem);  // [warp][row][kRedRow]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * n + 2 * t + (e & 1);
        red[(warp * NT * 8 + row) * kRedRow + acc_col<W>(i, g, e >> 1)] =
            acc[i][n][e];
      }
  __syncthreads();
  auto block_sum = [&](int row, int col) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      v += red[(w * NT * 8 + row) * kRedRow + col];
    return v;
  };

  if constexpr (DUAL) {
    for (int idx = tid; idx < B * (kCols / 2); idx += kThreads) {
      const int b = idx / (kCols / 2);
      const int c = idx % (kCols / 2);
      const int n = n0 + c;
      float gv = block_sum(b, c);
      float uv = block_sum(b, c + kCols / 2);
      if (s0 != nullptr) {
        gv *= s0[n];
        uv *= s1[n];
      }
      const float gb = round_bf16(gv);
      // the sigmoid in f32; the division's approximate form (2 ulp) keeps
      // the IEEE division's out-of-line slow path, and its spills, away
      const float pb = round_bf16(gb * __fdividef(1.f, 1.f + expf(-gb)));
      y[(size_t)b * N + n] = __float2bfloat16(pb * round_bf16(uv));
    }
    return;
  }

  const int splits = gridDim.y;  // the cluster's size
  auto finish = [&](int b, int n, float v) {
    if (s0 != nullptr) v *= s0[n];
    const size_t o = (size_t)b * N + n;
    y[o] = __float2bfloat16(__bfloat162float(res[o]) + round_bf16(v));
  };
  if (splits == 1) {
    for (int idx = tid; idx < B * kCols; idx += kThreads)
      finish(idx / kCols, n0 + idx % kCols, block_sum(idx / kCols,
                                                      idx % kCols));
    return;
  }
  float* sums = reinterpret_cast<float*>(smem + L::kRedBytes);
  for (int idx = tid; idx < B * kCols; idx += kThreads)
    sums[idx] = block_sum(idx / kCols, idx % kCols);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's sums are written
  const int per = B * kCols / splits;
  const int first = blockIdx.y * per;
  for (int idx = first + tid; idx < first + per; idx += kThreads) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp)  // in order: deterministic
      v += cluster.map_shared_rank(sums, sp)[idx];
    finish(idx / kCols, n0 + idx % kCols, v);
  }
  cluster.sync();  // no block leaves while its sums are read
}

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a row-major [rows, cols] matrix of 1- or 2-byte elements
// whose boxes are box_rows x box_cols, swizzled over the box's row width
// (32, 64 or 128 bytes); rows past `rows` read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int elem_bytes,
                uint64_t rows, uint64_t cols, uint32_t box_rows,
                uint32_t box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const uint32_t row_bytes = box_cols * elem_bytes;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One pass over x [B, K] and w0 (w1) [K, N]: the tensor maps, then the
// launch, programmatic-dependent on the launch before it.
template <typename W, bool DUAL, int NT>
cudaError_t launch_pass(dim3 grid, cudaStream_t st,
                        const __nv_bfloat16* x, int K, const W* w0,
                        const W* w1, int N, const float* s0, const float* s1,
                        const __nv_bfloat16* res, __nv_bfloat16* y, int B,
                        int k_len) {
  using L = Layout<W, NT>;
  const uint32_t box_cols = DUAL ? kCols / 2 : kCols;
  CUtensorMap tw0, tw1, tx;
  if (!tensor_map(&tw0, w0, sizeof(W), K, N, L::KC, box_cols) ||
      !tensor_map(&tw1, DUAL ? w1 : w0, sizeof(W), K, N, L::KC, box_cols) ||
      !tensor_map(&tx, x, 2, B, K, NT * 8, kXBox))
    return cudaErrorInvalidValue;
  constexpr int smem = L::kSmem;
  auto kernel = mlp_pass_kernel<W, DUAL, NT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = grid.y;  // the down pass's splits
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tw0, tw1, tx, N,
                                             s0, s1, res, y, B, k_len);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename W, int NT>
int launch(const __nv_bfloat16* h, const __nv_bfloat16* ln, const W* wg,
           const W* wu, const W* wd, const float* sg, const float* su,
           const float* sd, __nv_bfloat16* nx, __nv_bfloat16* p,
           __nv_bfloat16* out, int B, int H,
           int F, int splits, float eps, cudaStream_t st) {
  mlp_rmsnorm_kernel<<<B, kNormThreads, 0, st>>>(h, ln, nx, H, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_pass<W, true, NT>(dim3(F / (kCols / 2)), st, nx, H, wg, wu, F,
                                 sg, su, nullptr, p, B, H);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass<W, false, NT>(dim3(H / kCols, splits), st, p, F,
                                        wd, nullptr, H, sd, nullptr, h, out,
                                        B, F / splits);
}

template <typename W>
int launch_rows(const __nv_bfloat16* h, const __nv_bfloat16* ln,
                const W* wg, const W* wu, const W* wd, const float* sg,
                const float* su, const float* sd, __nv_bfloat16* nx,
                __nv_bfloat16* p, __nv_bfloat16* out, int B, int H, int F, int splits,
                float eps, cudaStream_t st) {
  // the N side of the product: 8, 16, 32 or 64 activation rows
  if (B <= 8)
    return launch<W, 1>(h, ln, wg, wu, wd, sg, su, sd, nx, p, out, B, H, F,
                        splits, eps, st);
  if (B <= 16)
    return launch<W, 2>(h, ln, wg, wu, wd, sg, su, sd, nx, p, out, B, H, F,
                        splits, eps, st);
  if (B <= 32)
    return launch<W, 4>(h, ln, wg, wu, wd, sg, su, sd, nx, p, out, B, H, F,
                        splits, eps, st);
  return launch<W, 8>(h, ln, wg, wu, wd, sg, su, sd, nx, p, out, B, H, F,
                      splits, eps, st);
}

}  // namespace

// Rows B in 1..64; H and F multiples of 128; 16-byte aligned operands.
extern "C" int kafka_fused_mlp(const void* h, const void* ln, const void* wg,
                               const void* wu, const void* wd, const void* sg,
                               const void* su, const void* sd, void* nx,
                               void* p, void* out, int B, int H, int F,
                               int int8, float eps, void* stream) {
  if (B < 1 || B > 64 || H % 128 != 0 || F % 128 != 0)
    return (int)cudaErrorInvalidValue;
  // the down pass's splits of F: the most, up to the cluster's kMaxSplits,
  // that leave each a whole number of 128-row stages
  int splits = kMaxSplits;
  while (F % (128 * splits) != 0) splits /= 2;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* hp = static_cast<const __nv_bfloat16*>(h);
  auto* lp = static_cast<const __nv_bfloat16*>(ln);
  auto* nxp = static_cast<__nv_bfloat16*>(nx);
  auto* pp = static_cast<__nv_bfloat16*>(p);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (int8) {
    if (sg == nullptr || su == nullptr || sd == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch_rows<int8_t>(
        hp, lp, static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu),
        static_cast<const int8_t*>(wd), static_cast<const float*>(sg),
        static_cast<const float*>(su), static_cast<const float*>(sd), nxp, pp,
        op, B, H, F, splits, eps, st);
  }
  return launch_rows<__nv_bfloat16>(
      hp, lp, static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu),
      static_cast<const __nv_bfloat16*>(wd), nullptr, nullptr, nullptr, nxp,
      pp, op, B, H, F, splits, eps, st);
}
