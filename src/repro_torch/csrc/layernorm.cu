// One-pass row RMSNorm / LayerNorm, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/layernorm.py, norm_onepass (Pallas body
// _ln_kernel).  Same function: x (R,D) in f32 or bf16, every row
// normalized in f32 and cast back to x's dtype.  layernorm: mu = mean(x),
// var = mean((x - mu)^2), y = (x - mu) * rsqrt(var + eps) * scale + bias;
// rmsnorm (any other kind): y = x * rsqrt(mean(x^2) + eps) * scale.  scale
// and bias (D,) are f32 or x's dtype each (the port's models keep norm
// scales in f32).  That is SSR's line-buffer LayerNorm: the row is read
// from memory once while the mean, the variance and the output are
// computed.
//
// What bounds it on the H100: bytes.  It reads x once and writes y once,
// R*D*(in + out bytes), plus the scale (and bias) once, for ~5 flops per
// element.  At R = 512, D = 4096 in bf16 that is 8.4 MB: 2.5 us at
// 3.35 TB/s.
//
// What this design does about it (norm_vec_kernel): the row stays in
// registers.  Each thread loads NV 16-byte vectors of its row (8 bf16 or
// 4 f32 values each; neighbouring threads take neighbouring vectors, so
// every load and store is coalesced and 16 bytes wide), 16 values a
// thread (32 where D > 16,384); a row takes as many threads as that needs
// (a multiple of 32, at most 1024: norm_plan in kernels/layernorm.py
// picks NV, the threads per row, the rows per block and the grid from the
// shapes), and a block of up to 256 threads takes several rows of a small
// D at once.  With blocks of at most 256 threads (D <= 4096) each thread
// loads its scale and bias vectors once, into registers, and they serve
// every row the block takes: the blocks walk the rows in a grid-stride
// loop.  Wider rows read them per row, from L1, and keep the registers
// for occupancy: bytes in flight are what a bandwidth-bound pass needs,
// and more threads of 16 values keep more of them in flight than fewer
// of 32.  A row's sums are warp shuffles and, when the row
// spans several warps, one exchange through shared memory (one barrier;
// the two slots alternate, so the next sum needs no second barrier).
// Layernorm's variance is mean((x - mu)^2) over the register row, as JAX
// computes it, and the output is (x - mu) * r, then * scale, then + bias,
// each rounded apart (no fused multiply-add), in that order.
//
// A D that is not a multiple of the vector width, or an operand that does
// not start on a 16-byte boundary, takes norm_kernel: one block of 256
// threads per row, the row staged in shared memory as f32 (D*4 bytes:
// D <= 32,768 takes at most 128 KB), scalar loads.  The TPU kernel's row
// blocks (block_rows) and its r % block_rows assertion are its tiling;
// here any R >= 1 and 1 <= D <= 32,768 work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNormThreads = 256;
constexpr int kNormMaxD = 32768;
constexpr int kVecThreads = 256;     // a norm_vec_kernel block, unless WIDE
constexpr int kVecRowsMax = 8;       // rows a block of norm_vec_kernel takes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T cast_to(float v);
template <>
__device__ __forceinline__ float cast_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 cast_to<bf16>(float v) {
  return __float2bfloat16_rn(v);   // round to nearest even, as torch casts
}

// ---------------------------------------------------------------------------
// the vector path

// N values of U from p (16-byte aligned) with 16-byte loads, in f32.
template <typename U, int N>
__device__ __forceinline__ void load_f32(const U* __restrict__ p,
                                         float* v) {
  constexpr int kPer = 16 / (int)sizeof(U);
  static_assert(N % kPer == 0, "whole 16-byte vectors");
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    union {
      uint4 raw;
      U e[kPer];
    } u;
    u.raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[c * kPer + i] = to_f32(u.e[i]);
  }
}

// one 16-byte vector of T to p (16-byte aligned)
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float* y) {
  constexpr int kPer = 16 / (int)sizeof(T);
  union {
    uint4 raw;
    T e[kPer];
  } u;
#pragma unroll
  for (int i = 0; i < kPer; ++i) u.e[i] = cast_to<T>(y[i]);
  *reinterpret_cast<uint4*>(p) = u.raw;
}

// T: x and out; TS, TB: scale and bias (TB unread unless HB); NV: 16-byte
// vectors of x a thread holds; LN: layernorm (else rmsnorm); WIDE: rows
// of more than 256 threads (one a block), which leave scale and bias in
// memory (read per row, from L1) to stay within 64 registers a thread;
// narrower rows take blocks of at most 256 threads, which keep them in
// registers.
// Block (tpr, rpb) = (blockDim.x, blockDim.y): tpr threads (a multiple of
// 32) per row, rpb rows at a time; thread x of a row holds its vectors
// x, x + tpr, ..., x + (NV - 1) * tpr.
template <typename T, typename TS, typename TB, int NV, bool LN, bool HB,
          bool WIDE>
__global__ void __launch_bounds__(WIDE ? 1024 : kVecThreads)
norm_vec_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                const TB* __restrict__ bias, T* __restrict__ out, int R,
                int D, float eps) {
  constexpr int V = 16 / (int)sizeof(T);   // values a vector
  constexpr int E = NV * V;                // values a thread
  constexpr int EK = WIDE ? 1 : E;         // scale and bias values kept
  __shared__ float red[2][kVecRowsMax][32];
  const int tpr = blockDim.x, rpb = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lane = tx & 31, warp = tx >> 5, nw = tpr >> 5;
  const int nvec = D / V;
  const float fd = (float)D;

  // the thread's scale and bias values, once for every row
  float sc[EK], bi[EK];
  if constexpr (!WIDE) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = tx + k * tpr;
      if (j < nvec) {
        load_f32<TS, V>(scale + (size_t)j * V, sc + k * V);
        if constexpr (HB) load_f32<TB, V>(bias + (size_t)j * V, bi + k * V);
      }
    }
  }

  int par = 0;   // the shared slot of the next sum
  auto row_sum = [&](float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (nw == 1) return v;                 // block-uniform
    float* slot = red[par][ty];
    par ^= 1;
    if (lane == 0) slot[warp] = v;
    __syncthreads();
    float t = lane < nw ? slot[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
    return t;
  };

  // every thread of the block takes the same number of steps (barriers)
  for (int r0 = blockIdx.x * rpb; r0 < R; r0 += gridDim.x * rpb) {
    const int row = r0 + ty;
    const bool ok = row < R;
    const T* xr = x + (size_t)(ok ? row : 0) * D;
    float v[E];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = tx + k * tpr;
      if (ok && j < nvec) {
        load_f32<T, V>(xr + (size_t)j * V, v + k * V);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[k * V + i] = 0.f;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += LN ? v[e] : v[e] * v[e];
    s = row_sum(s);
    float mu = 0.f, var;
    if constexpr (LN) {
      mu = s / fd;
      float s2 = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (tx + k * tpr < nvec) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float d = v[k * V + i] - mu;
            s2 += d * d;
          }
        }
      }
      var = row_sum(s2) / fd;
    } else {
      var = s / fd;
    }
    const float rs = rsqrtf(var + eps);
    if (!ok) continue;
    T* orow = out + (size_t)row * D;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = tx + k * tpr;
      if (j >= nvec) continue;
      float ks[V], kb[V];
      if constexpr (WIDE) {
        load_f32<TS, V>(scale + (size_t)j * V, ks);
        if constexpr (HB) load_f32<TB, V>(bias + (size_t)j * V, kb);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ks[i] = sc[k * V + i];
          if constexpr (HB) kb[i] = bi[k * V + i];
        }
      }
      float y[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float* vv = v + k * V;
        if constexpr (LN) {
          y[i] = __fmul_rn(__fmul_rn(__fsub_rn(vv[i], mu), rs), ks[i]);
          if constexpr (HB) y[i] = __fadd_rn(y[i], kb[i]);
        } else {
          y[i] = __fmul_rn(__fmul_rn(vv[i], rs), ks[i]);
        }
      }
      store_vec<T>(orow + (size_t)j * V, y);
    }
  }
}

template <typename T, typename TS, typename TB, int NV, bool LN, bool HB>
cudaError_t launch_vec(const void* x, const void* scale, const void* bias,
                       void* out, int R, int D, float eps, int tpr, int rpb,
                       int blocks, cudaStream_t stream) {
  auto kernel = tpr * rpb > kVecThreads
                    ? norm_vec_kernel<T, TS, TB, NV, LN, HB, true>
                    : norm_vec_kernel<T, TS, TB, NV, LN, HB, false>;
  kernel<<<blocks, dim3(tpr, rpb), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<const TB*>(bias), static_cast<T*>(out), R, D, eps);
  return cudaGetLastError();
}

// scale and bias are f32 or x's dtype
template <typename T, int NV, bool LN, bool HB, typename TB>
cudaError_t launch_vec_scale(int scale_bf16, const void* x,
                             const void* scale, const void* bias, void* out,
                             int R, int D, float eps, int tpr, int rpb,
                             int blocks, cudaStream_t stream) {
  if (!scale_bf16)
    return launch_vec<T, float, TB, NV, LN, HB>(x, scale, bias, out, R, D,
                                                eps, tpr, rpb, blocks,
                                                stream);
  if constexpr (std::is_same<T, bf16>::value)
    return launch_vec<T, bf16, TB, NV, LN, HB>(x, scale, bias, out, R, D,
                                               eps, tpr, rpb, blocks, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int NV>
cudaError_t launch_vec_kind(int scale_bf16, const void* bias, int bias_bf16,
                            int layernorm, const void* x, const void* scale,
                            void* out, int R, int D, float eps, int tpr,
                            int rpb, int blocks, cudaStream_t stream) {
#define REPRO_NORM_VEC(LN, HB, TB)                                          \
  return launch_vec_scale<T, NV, LN, HB, TB>(scale_bf16, x, scale, bias,    \
                                             out, R, D, eps, tpr, rpb,      \
                                             blocks, stream)
  if (!layernorm) REPRO_NORM_VEC(false, false, float);
  if (bias == nullptr) REPRO_NORM_VEC(true, false, float);
  if (!bias_bf16) REPRO_NORM_VEC(true, true, float);
  if constexpr (std::is_same<T, bf16>::value) REPRO_NORM_VEC(true, true, bf16);
#undef REPRO_NORM_VEC
  return cudaErrorInvalidValue;
}

// nv: 16 or 32 values a thread (2 or 4 vectors of bf16, 4 or 8 of f32)
template <typename T>
cudaError_t launch_vec_plan(int nv, int scale_bf16, const void* bias,
                            int bias_bf16, int layernorm, const void* x,
                            const void* scale, void* out, int R, int D,
                            float eps, int tpr, int rpb, int blocks,
                            cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const bool aligned = ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)out |
                        (uintptr_t)bias) % 16 == 0;
  if (D % V != 0 || !aligned || tpr < 32 || tpr > 1024 || tpr % 32 != 0 ||
      rpb < 1 || rpb > kVecRowsMax || tpr * rpb > 1024 ||
      (tpr * rpb > kVecThreads && rpb != 1) || blocks < 1 ||
      (long long)nv * V * tpr < D || nv * V > 32)
    return cudaErrorInvalidValue;
#define REPRO_NORM_NV(NV)                                                    \
  if (nv == NV)                                                              \
  return launch_vec_kind<T, NV>(scale_bf16, bias, bias_bf16, layernorm, x,   \
                                scale, out, R, D, eps, tpr, rpb, blocks,     \
                                stream)
  REPRO_NORM_NV(16 / V);
  REPRO_NORM_NV(32 / V);
#undef REPRO_NORM_NV
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the scalar path: odd widths and misaligned operands

__device__ __forceinline__ float param(const void* p, int is_bf16, int i) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Sum of v over the block, returned to every thread.  `red` holds one
// slot per warp; the leading barrier lets a second call reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kNormThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
norm_kernel(const T* __restrict__ x, const void* __restrict__ scale,
            int scale_bf16, const void* __restrict__ bias, int bias_bf16,
            T* __restrict__ out, int D, int layernorm, float eps) {
  extern __shared__ float row[];                    // D floats
  __shared__ float red[kNormThreads / 32];
  const size_t base = (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kNormThreads) {
    const float v = to_f32(x[base + i]);
    row[i] = v;
    s += layernorm ? v : v * v;
  }
  s = block_sum(s, red);
  float mu = 0.f, var;
  if (layernorm) {
    mu = s / D;
    float s2 = 0.f;
    for (int i = threadIdx.x; i < D; i += kNormThreads) {
      const float d = row[i] - mu;
      s2 += d * d;
    }
    var = block_sum(s2, red) / D;
  } else {
    var = s / D;
  }
  const float r = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < D; i += kNormThreads) {
    float y;
    if (layernorm) {
      y = __fmul_rn(__fmul_rn(row[i] - mu, r), param(scale, scale_bf16, i));
      if (bias != nullptr) y = __fadd_rn(y, param(bias, bias_bf16, i));
    } else {
      y = __fmul_rn(__fmul_rn(row[i], r), param(scale, scale_bf16, i));
    }
    out[base + i] = cast_to<T>(y);
  }
}

template <typename T>
cudaError_t launch_norm(const void* x, const void* scale, int scale_bf16,
                        const void* bias, int bias_bf16, void* out, int R,
                        int D, int layernorm, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  norm_kernel<T><<<R, kNormThreads, smem, stream>>>(
      static_cast<const T*>(x), scale, scale_bf16, bias, bias_bf16,
      static_cast<T*>(out), D, layernorm, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (x and out); scale (D,) and bias (D,) or
// null, each 0 float32 / 1 bfloat16 (bfloat16 only with bfloat16 x on the
// vector path); layernorm: 1 layernorm, 0 rmsnorm (bias unused).  nv: 0
// for the scalar path (one block a row; tpr, rpb, blocks unused), else
// the vector path with nv 16-byte vectors a thread (16 or 32 values), tpr
// threads a row, rpb rows a block and `blocks` blocks (kernels/
// layernorm.py, norm_plan); it needs D a multiple of the vector width and
// every operand on a 16-byte boundary.  Shape contract (checked by the
// Python wrapper): x and out (R, D) contiguous on one device, R >= 1,
// 1 <= D <= 32,768.
extern "C" int repro_norm_onepass(int dtype, const void* x, const void* scale,
                                  int scale_dtype, const void* bias,
                                  int bias_dtype, void* out, int R, int D,
                                  int layernorm, float eps, int nv, int tpr,
                                  int rpb, int blocks, void* stream) {
  using namespace repro_torch;
  if (R <= 0 || D <= 0 || D > kNormMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv != 0) {
    if (dtype == 0)
      return (int)launch_vec_plan<float>(nv, scale_dtype,
                                         layernorm ? bias : nullptr,
                                         bias_dtype, layernorm, x, scale,
                                         out, R, D, eps, tpr, rpb, blocks, s);
    return (int)launch_vec_plan<bf16>(nv, scale_dtype,
                                      layernorm ? bias : nullptr, bias_dtype,
                                      layernorm, x, scale, out, R, D, eps,
                                      tpr, rpb, blocks, s);
  }
  if (dtype == 0)
    return (int)launch_norm<float>(x, scale, scale_dtype, bias, bias_dtype,
                                   out, R, D, layernorm, eps, s);
  return (int)launch_norm<bf16>(x, scale, scale_dtype, bias, bias_dtype, out,
                                R, D, layernorm, eps, s);
}
