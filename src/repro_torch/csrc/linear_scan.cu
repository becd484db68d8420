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
// slot's state as h0, and every prefill at the prompt's length.
//
// What bounds it on the H100: bytes.  It reads a and b once and writes
// every state once, 12 bytes per (n, t, f), plus 4 bytes per (n, f) of
// h0, for 2 flops per 12 bytes.
//
// What this design does about it: one thread per (n, f) walks t in order
// with the carry in a register, so nothing but a, b, h0 and the output
// ever touches device memory.  Threads of a warp own neighbouring
// features, so each step's loads and stores are coalesced 128-byte lines
// across the F axis; the loop is unrolled so the loads of later steps are
// in flight while the carry chain runs.  The grid is (ceil(F/256), N):
// 1,024 blocks of 256 threads at F = 262,144, enough to fill the 132 SMs
// at N = 1.  The TPU kernel's sequence blocks and VMEM carry are not
// needed: the carry never leaves the thread.
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kScanThreads = 256;

__global__ void __launch_bounds__(kScanThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ out,
                   int S, int F) {
  const int f = blockIdx.x * kScanThreads + threadIdx.x;
  const int n = blockIdx.y;
  if (f >= F) return;
  float h = h0 != nullptr ? h0[(size_t)n * F + f] : 0.f;
  size_t idx = (size_t)n * S * F + f;
#pragma unroll 8
  for (int t = 0; t < S; ++t, idx += F) {
    h = __fadd_rn(__fmul_rn(a[idx], h), b[idx]);
    out[idx] = h;
  }
}

}  // namespace
}  // namespace repro_torch

// a, b, out: (N, S, F) float32; h0: (N, F) float32 or null (zeros).
// Shape contract (checked by the Python wrapper): all tensors contiguous
// float32 on one device, N <= 65,535.
extern "C" int repro_linear_scan(const float* a, const float* b,
                                 const float* h0, float* out, int N, int S,
                                 int F, void* stream) {
  using namespace repro_torch;
  if (N == 0 || S == 0 || F == 0) return (int)cudaSuccess;
  dim3 grid((F + kScanThreads - 1) / kScanThreads, N);
  linear_scan_kernel<<<grid, kScanThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, h0, out, S,
                                                             F);
  return (int)cudaGetLastError();
}
