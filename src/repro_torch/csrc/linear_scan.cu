// Gated linear recurrence h_t = a_t * h_{t-1} + b_t, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/linear_scan.py, linear_scan (Pallas body
// _scan_kernel).  Same function: a, b (N,S,F) f32, an optional carry-in
// h0 (N,F) (zeros when null); out (N,S,F) f32 holds every h_t.  Each step
// is a product rounded to f32 and then a sum rounded to f32 (__fmul_rn,
// __fadd_rn: no contraction into an fma), the two separately rounded ops
// of the plain version (kernels/ref.py, linear_scan_ref), so the kernel
// equals it bit for bit.  In the model (mamba) F = d_inner * d_state =
// 262,144 at jamba's width: every decode step runs it at S = 1 with the
// slot's state as h0 (prefill takes the fused selective scan,
// selective_scan.cu).
//
// What bounds it on the H100: bytes.  It reads a and b once and writes
// every state once, 12 bytes per (n, t, f), plus 4 bytes per (n, f) of
// h0, for 2 flops per 12 bytes.  At the decode shape (N = 4, S = 1) the
// whole launch is one load of a, b and h0 and one store per feature, so
// what matters is how many bytes each thread has in flight.
//
// What this design does about it: the vector path gives each thread 4
// neighbouring features, read and written as 16-byte float4 (a warp moves
// 512 contiguous bytes per access), and walks t with the carry in
// registers, loading the a and b of kUnroll steps before it runs their
// carry chain, so 8 float4 loads are in flight while the chain of the
// previous steps runs.  Blocks of 128 threads, (F/4/128, N) of them:
// 512 blocks a row at F = 262,144, nearly 4 per SM at N = 1 and one full
// wave of 2,048 at N = 4.  The plan comes from the host
// (kernels/linear_scan.py, scan_plan), from shapes and alignment alone;
// an F that is not a multiple of 4, or an operand off a 16-byte
// boundary, takes the scalar path: one thread per feature, 4-byte
// accesses.  The TPU kernel's sequence blocks and VMEM carry are not
// needed: the carry never leaves the thread.
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kUnroll = 4;

__device__ __forceinline__ float scan_step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__global__ void __launch_bounds__(128)
linear_scan_vec_kernel(const float4* __restrict__ a,
                       const float4* __restrict__ b,
                       const float4* __restrict__ h0,
                       float4* __restrict__ out, int S, int F4) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (f >= F4) return;
  float4 h = h0 != nullptr ? __ldg(h0 + (size_t)n * F4 + f)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  size_t idx = (size_t)n * S * F4 + f;
  for (int t0 = 0; t0 < S; t0 += kUnroll, idx += (size_t)kUnroll * F4) {
    float4 av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        av[u] = __ldg(a + idx + (size_t)u * F4);
        bv[u] = __ldg(b + idx + (size_t)u * F4);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        h.x = scan_step(av[u].x, h.x, bv[u].x);
        h.y = scan_step(av[u].y, h.y, bv[u].y);
        h.z = scan_step(av[u].z, h.z, bv[u].z);
        h.w = scan_step(av[u].w, h.w, bv[u].w);
        out[idx + (size_t)u * F4] = h;
      }
    }
  }
}

__global__ void __launch_bounds__(256)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ out,
                   int S, int F) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (f >= F) return;
  float h = h0 != nullptr ? h0[(size_t)n * F + f] : 0.f;
  size_t idx = (size_t)n * S * F + f;
#pragma unroll 8
  for (int t = 0; t < S; ++t, idx += F) {
    h = scan_step(a[idx], h, b[idx]);
    out[idx] = h;
  }
}

}  // namespace
}  // namespace repro_torch

// a, b, out: (N, S, F) float32; h0: (N, F) float32 or null (zeros).
// vec: 1 for the vector path (F % 4 == 0, every operand 16-byte aligned),
// 0 for the scalar one; threads a block and blocks along F from the
// host's plan.  Shape contract (checked by the Python wrapper): all
// tensors contiguous float32 on one device, N <= 65,535.
extern "C" int repro_linear_scan(const float* a, const float* b,
                                 const float* h0, float* out, int N, int S,
                                 int F, int vec, int threads, int blocks,
                                 void* stream) {
  using namespace repro_torch;
  if (N == 0 || S == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(blocks, N);
  if (vec) {
    linear_scan_vec_kernel<<<grid, threads, 0, st>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b),
        reinterpret_cast<const float4*>(h0), reinterpret_cast<float4*>(out),
        S, F / 4);
  } else {
    linear_scan_kernel<<<grid, threads, 0, st>>>(a, b, h0, out, S, F);
  }
  return (int)cudaGetLastError();
}
