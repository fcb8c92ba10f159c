// Fused decode MLP block for Hopper (sm_90a): rmsnorm + SwiGLU + residual,
// bf16 activations, bf16 or int8 weights with per-output-channel f32
// scales.
//
// Replaces the Pallas kernel `fused_mlp_block` / `_kernel`
// (kafka_tpu/ops/pallas/fused_mlp.py:153 / :84).  Same function:
//   out = h + W_d(silu(nx W_g) * (nx W_u)),   nx = rmsnorm(h) * ln
// with the JAX kernel's rounding points: the norm in f32 and nx rounded
// to bf16; each projection accumulated in f32, its int8 scales applied to
// the f32 output, then rounded once to bf16; silu with the sigmoid in f32,
// rounded to bf16, times u in bf16; the residual added in bf16.
//
// Bound on an H100: bytes.  At decode (B <= 64 rows) every weight byte is
// used B times, far below the ~295 flops per byte at which the tensor
// cores become the limit, so the three weight matrices, read once, bound
// it: 3 * H * F * 2 bytes in bf16 (1 byte in int8) at 3.35 TB/s.
//
// Design.  The TPU kernel walks F-tiles in order on one core and carries
// the down-projection sum in VMEM scratch; Hopper's blocks run in no
// order, so this is three launches and no atomics (the result is
// deterministic):
//   (0) one block per row: nx = bf16(rmsnorm(h) * ln), [B, H] scratch;
//   (a) blocks over F-column tiles: g and u for all rows of the tile,
//       then p = bf16(silu(g)) * u into a [B, F] bf16 scratch (128 KB at
//       B 8, F 8192);
//   (b) blocks over H-column tiles: the down projection of p over all of
//       F, its scale, and the residual.
// (a) and (b) are the same skinny product: 8 warps split the contraction
// axis K, each lane holds 4 adjacent output columns of up to 8 rows in
// f32 registers and reads its 4 weights with one 8-byte (bf16) or 4-byte
// (int8) load, the lanes of a warp covering CT * 4 adjacent columns; the
// input rows are staged in shared memory 256 columns at a time.  Partial
// sums meet through shuffles and shared memory at the end.  Rows come in
// chunks of 8 (grid y): past 8 rows the weights are read once per chunk.
// This first version multiplies on the CUDA cores in f32; tensor cores
// and TMA are later work.
//
// Plain C interface, loaded with ctypes; the launch error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsB = 8;  // rows of a block
constexpr int kKC = 256;   // contraction columns staged at a time

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float* out) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  out[0] = static_cast<float>(v.x);
  out[1] = static_cast<float>(v.y);
  out[2] = static_cast<float>(v.z);
  out[3] = static_cast<float>(v.w);
}

// grid (B), block kThreads: nx[b] = bf16(h[b] * rsqrt(mean(h[b]^2) + eps)
// * ln), all in f32.
__global__ void __launch_bounds__(kThreads) mlp_rmsnorm_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ ln,
    __nv_bfloat16* __restrict__ nx, int H, float eps) {
  __shared__ float part[kWarps];
  const size_t row = (size_t)blockIdx.x * H;
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += kThreads) {
    const float x = __bfloat162float(h[row + k]);
    ss += x * x;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) total += part[v];
  const float inv = rsqrtf(total / H + eps);
  for (int k = threadIdx.x; k < H; k += kThreads) {
    const float x = __bfloat162float(h[row + k]);
    nx[row + k] = __float2bfloat16(x * inv * __bfloat162float(ln[k]));
  }
}

// grid (N / (CT * 4), ceil(B / kRowsB)), block kThreads.
// DUAL (pass a): y = bf16(silu(bf16(x W0 * s0))) * bf16(x W1 * s1).
// else (pass b): y = res + bf16(x W0 * s0).
// s0/s1 are null for bf16 weights.
template <typename W, bool DUAL, int CT>
__global__ void __launch_bounds__(kThreads) mlp_gemv_kernel(
    const __nv_bfloat16* __restrict__ x,    // [B, K]
    const W* __restrict__ w0,               // [K, N]
    const W* __restrict__ w1,               // [K, N] (DUAL)
    const float* __restrict__ s0,           // [N] or null
    const float* __restrict__ s1,           // [N] or null (DUAL)
    const __nv_bfloat16* __restrict__ res,  // [B, N] (not DUAL)
    __nv_bfloat16* __restrict__ y,          // [B, N]
    int B, int K, int N) {
  constexpr int KQ = 32 / CT;      // contraction lanes of a warp
  constexpr int KS = kWarps * KQ;  // contraction slices of a block
  constexpr int NT = CT * 4;       // output columns of a block
  constexpr int NM = DUAL ? 2 : 1;
  static_assert(kKC % KS == 0, "K chunk must split evenly");
  __shared__ __align__(16) __nv_bfloat16 xs[kRowsB][kKC];
  __shared__ float red[kWarps][NM][kRowsB][NT];

  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ct = lane % CT;
  const int kq = lane / CT;
  const int k_first = w * KQ + kq;
  const int n0 = blockIdx.x * NT + ct * 4;
  const int b0 = blockIdx.y * kRowsB;
  const int nb = min(kRowsB, B - b0);

  float a0[kRowsB][4], a1[kRowsB][4];
#pragma unroll
  for (int r = 0; r < kRowsB; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a0[r][j] = 0.f;
      a1[r][j] = 0.f;
    }
  }
  for (int kc = 0; kc < K; kc += kKC) {
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < kRowsB * kKC / 8; i += kThreads) {
      const int r = i / (kKC / 8);
      const int c = (i % (kKC / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nb)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(b0 + r) * K + kc +
                                            c);
      *reinterpret_cast<uint4*>(&xs[r][c]) = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = k_first; k < kKC; k += KS) {
      float f0[4], f1[4];
      load4(w0 + (size_t)(kc + k) * N + n0, f0);
      if constexpr (DUAL) load4(w1 + (size_t)(kc + k) * N + n0, f1);
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        const float xv = __bfloat162float(xs[r][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a0[r][j] += xv * f0[j];
          if constexpr (DUAL) a1[r][j] += xv * f1[j];
        }
      }
    }
  }
  // the KQ contraction lanes of a warp share ct: lanes ct, ct + CT, ...
#pragma unroll
  for (int o = CT; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a0[r][j] += __shfl_xor_sync(0xffffffffu, a0[r][j], o);
        if constexpr (DUAL)
          a1[r][j] += __shfl_xor_sync(0xffffffffu, a1[r][j], o);
      }
    }
  }
  if (kq == 0) {
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[w][0][r][ct * 4 + j] = a0[r][j];
        if constexpr (DUAL) red[w][NM - 1][r][ct * 4 + j] = a1[r][j];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRowsB * NT; idx += kThreads) {
    const int r = idx / NT;
    const int c = idx % NT;
    if (r >= nb) continue;
    const int n = blockIdx.x * NT + c;
    const size_t o = (size_t)(b0 + r) * N + n;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      g += red[v][0][r][c];
      if constexpr (DUAL) u += red[v][NM - 1][r][c];
    }
    if (s0 != nullptr) g *= s0[n];
    if constexpr (DUAL) {
      if (s1 != nullptr) u *= s1[n];
      const float gb = round_bf16(g);
      const float ub = round_bf16(u);
      const float pb = round_bf16(gb * (1.f / (1.f + expf(-gb))));
      y[o] = __float2bfloat16(pb * ub);
    } else {
      y[o] = __float2bfloat16(__bfloat162float(res[o]) + round_bf16(g));
    }
  }
}

template <typename W>
int launch(const __nv_bfloat16* h, const __nv_bfloat16* ln, const W* wg,
           const W* wu, const W* wd, const float* sg, const float* su,
           const float* sd, __nv_bfloat16* nx, __nv_bfloat16* p,
           __nv_bfloat16* out, int B, int H, int F, float eps,
           cudaStream_t st) {
  constexpr int kCtUp = 8;    // 32 columns of F per block
  constexpr int kCtDown = 4;  // 16 columns of H per block
  mlp_rmsnorm_kernel<<<B, kThreads, 0, st>>>(h, ln, nx, H, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = (B + kRowsB - 1) / kRowsB;
  mlp_gemv_kernel<W, true, kCtUp>
      <<<dim3(F / (kCtUp * 4), chunks), kThreads, 0, st>>>(
          nx, wg, wu, sg, su, nullptr, p, B, H, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_gemv_kernel<W, false, kCtDown>
      <<<dim3(H / (kCtDown * 4), chunks), kThreads, 0, st>>>(
          p, wd, nullptr, sd, nullptr, h, out, B, F, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kafka_fused_mlp(const void* h, const void* ln, const void* wg,
                               const void* wu, const void* wd, const void* sg,
                               const void* su, const void* sd, void* nx,
                               void* p, void* out, int B, int H, int F,
                               int int8, float eps, void* stream) {
  if (B < 1 || H % kKC != 0 || F % kKC != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* hp = static_cast<const __nv_bfloat16*>(h);
  auto* lp = static_cast<const __nv_bfloat16*>(ln);
  auto* nxp = static_cast<__nv_bfloat16*>(nx);
  auto* pp = static_cast<__nv_bfloat16*>(p);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (int8) {
    if (sg == nullptr || su == nullptr || sd == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch<int8_t>(
        hp, lp, static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu),
        static_cast<const int8_t*>(wd), static_cast<const float*>(sg),
        static_cast<const float*>(su), static_cast<const float*>(sd), nxp, pp,
        op, B, H, F, eps, st);
  }
  return launch<__nv_bfloat16>(
      hp, lp, static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu),
      static_cast<const __nv_bfloat16*>(wd), nullptr, nullptr, nullptr, nxp,
      pp, op, B, H, F, eps, st);
}
