// One-pass row RMSNorm / LayerNorm, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/layernorm.py, norm_onepass (Pallas body
// _ln_kernel).  Same function: x (R,D) in f32 or bf16, every row
// normalized in f32 and cast back to x's dtype.  layernorm: mu = mean(x),
// var = mean((x - mu)^2), y = (x - mu) * rsqrt(var + eps) * scale + bias;
// rmsnorm (any other kind): y = x * rsqrt(mean(x^2) + eps) * scale.  scale
// and bias (D,) are f32 or bf16 each (the port's models keep norm scales
// in f32).  That is SSR's line-buffer LayerNorm: the row is read from
// memory once while the mean, the variance and the output are computed.
//
// What bounds it on the H100: bytes.  It reads x once and writes y once,
// R*D*(in + out bytes), plus the scale (and bias) once, for ~5 flops per
// element.  At R = 512, D = 4096 in bf16 that is 8.4 MB: 2.5 us at
// 3.35 TB/s.
//
// What this design does about it: one block per row.  The row is read
// from HBM once into shared memory as f32 (dynamic shared memory, D*4
// bytes: D <= 32,768 takes at most 128 KB of the SM's 227 KB), each
// thread reducing the elements it loaded; warp shuffles and then one
// shared-memory slot per warp finish the sum.  Layernorm's second pass,
// mean((x - mu)^2), and the output pass read the row back from shared
// memory, each thread only the elements it wrote itself, so no barrier is
// needed between them; the output is cast and written once.  The TPU
// kernel's row blocks (block_rows) and its r % block_rows assertion are
// its tiling; here any R >= 1 and 1 <= D <= 32,768 work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kNormThreads = 256;
constexpr int kNormMaxD = 32768;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& dst, float v) { dst = v; }
__device__ __forceinline__ void from_f32(bf16& dst, float v) {
  dst = __float2bfloat16(v);
}

__device__ __forceinline__ float param(const void* p, int is_bf16, int i) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Sum of v over the block, returned to every thread.  `red` holds one
// slot per warp; the leading barrier lets a second call reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kNormThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
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
      y = (row[i] - mu) * r * param(scale, scale_bf16, i);
      if (bias != nullptr) y += param(bias, bias_bf16, i);
    } else {
      y = row[i] * r * param(scale, scale_bf16, i);
    }
    from_f32(out[base + i], y);
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
// null, each 0 float32 / 1 bfloat16; layernorm: 1 layernorm, 0 rmsnorm
// (bias unused).  Shape contract (checked by the Python wrapper): x and
// out (R, D) contiguous on one device, R >= 1, 1 <= D <= 32,768.
extern "C" int repro_norm_onepass(int dtype, const void* x, const void* scale,
                                  int scale_dtype, const void* bias,
                                  int bias_dtype, void* out, int R, int D,
                                  int layernorm, float eps, void* stream) {
  using namespace repro_torch;
  if (R <= 0 || D <= 0 || D > kNormMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_norm<float>(x, scale, scale_dtype, bias, bias_dtype,
                                   out, R, D, layernorm, eps, s);
  return (int)launch_norm<bf16>(x, scale, scale_dtype, bias, bias_dtype, out,
                                R, D, layernorm, eps, s);
}
