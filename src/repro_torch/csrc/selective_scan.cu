// Mamba's selective scan, fused, Hopper (sm_90a).
//
// Replaces: src/repro/models/ssm.py, mamba_scan_fused (jnp, no Pallas
// kernel): the JAX package's default mamba prefill.  Same function:
// delta, x (N,S,D) f32; B, C (N,S,n) f32; A (D,n) f32; an optional
// carry-in h0 (N,D,n) (zeros when null).  For every step t and channel d
//   a = exp(delta*A[d,k]),  h[k] = a*h[k] + (delta*x)*B[k],  y = sum_k C[k]*h[k]
// writing y (N,S,D) f32 and the last state h_last (N,D,n) f32.  The
// products are rounded in JAX's order (delta*A, then delta*x, then *B)
// and the state update is a product then a sum, each rounded
// (__fmul_rn/__fadd_rn, no fma), as the plain version
// (kernels/ref.py, mamba_scan_fused_ref) steps through them; only expf
// and the order of the C sum can differ from it.
//
// What bounds it on the H100: the reads of delta and x and the write of
// y are 12 bytes per (n, t, d), ~0.12 GB at N = 1, S = 600, D = 16,384
// (~0.036 ms at 3.35 TB/s); the work is n = 16 exps and ~6 more f32 ops
// per (n, t, d) for each state, ~157 M exps there, which is about as long
// again on the CUDA cores and the special-function units.  The
// materialized route it replaces (exp, the products, linear_scan and the
// C contraction over (N,S,D,n) tensors) moves ~8 such tensors, ~5 GB.
//
// What this design does about it: a, b and h never leave registers.  A
// block of 128 threads walks t over 128 / lanes channels; each channel's
// n states are split over `lanes` neighbouring threads, `states` (1, 2
// or 4) a thread, with their A values in registers.  The block stages
// kSteps steps of delta and x (its channels) and of B and C (shared by
// every channel) in shared memory with cp.async, double buffered, so the
// next chunk's loads are in flight while this chunk's recurrence runs
// (16-byte copies when D and n are multiples of 4 and every operand is
// 16-byte aligned, else 4-byte ones).  Each thread leaves its partial
// C.h of a step in shared memory; after the chunk, each (step, channel)
// sums its lanes' partials and a warp stores 32 neighbouring channels of
// y, so the recurrence has no shuffle and no scattered store in its
// loop.  The host's plan (kernels/selective_scan.py, selective_scan_plan)
// picks lanes and states from d_state.  Threads of channels past D
// compute zeros and store nothing.
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kSteps = 32;      // steps a staged chunk

// One chunk of `rows` steps (rows <= kSteps; the rest zero-filled) from
// global row `row0` (= batch * S + first step) into a stage: delta and x
// of the block's `ch` channels from c0, B and C padded to rows of nP.
__device__ __forceinline__ void stage_chunk(
    float* s, const float* __restrict__ delta, const float* __restrict__ x,
    const float* __restrict__ B, const float* __restrict__ C, size_t row0,
    int rows, int c0, int ch, int D, int n, int nP, bool vec) {
  float* sd = s;
  float* sx = sd + kSteps * ch;
  float* sb = sx + kSteps * ch;
  float* sc = sb + kSteps * nP;
  const int w = vec ? 4 : 1;                 // floats a copy
  const int cv = ch / w, pv = nP / w;
  for (int i = threadIdx.x; i < kSteps * cv; i += kThreads) {
    const int r = i / cv, j = (i % cv) * w;
    const bool ok = r < rows && c0 + j < D;
    const size_t g = ok ? (row0 + r) * D + c0 + j : 0;
    const uint32_t od = mma::smem_u32(sd + r * ch + j);
    const uint32_t ox = mma::smem_u32(sx + r * ch + j);
    if (vec) {
      mma::cp_async16(od, delta + g, ok);
      mma::cp_async16(ox, x + g, ok);
    } else {
      mma::cp_async4(od, delta + g, ok);
      mma::cp_async4(ox, x + g, ok);
    }
  }
  for (int i = threadIdx.x; i < kSteps * pv; i += kThreads) {
    const int r = i / pv, k = (i % pv) * w;
    const bool ok = r < rows && k < n;
    const size_t g = ok ? (row0 + r) * n + k : 0;
    const uint32_t ob = mma::smem_u32(sb + r * nP + k);
    const uint32_t oc = mma::smem_u32(sc + r * nP + k);
    if (vec) {
      mma::cp_async16(ob, B + g, ok);
      mma::cp_async16(oc, C + g, ok);
    } else {
      mma::cp_async4(ob, B + g, ok);
      mma::cp_async4(oc, C + g, ok);
    }
  }
}

// Shared memory of a launch: two stages and the partial sums of y.
inline int smem_floats(int lanes, int states) {
  return 2 * kSteps * (2 * (kThreads / lanes) + 2 * lanes * states)
         + kSteps * kThreads;
}

template <int kStates>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ delta,
                      const float* __restrict__ x,
                      const float* __restrict__ B,
                      const float* __restrict__ C,
                      const float* __restrict__ A,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D, int n,
                      int lanes, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ch = kThreads / lanes;           // channels a block
  const int nP = lanes * kStates;
  const int stage = kSteps * (2 * ch + 2 * nP);
  float* sy = smem + 2 * stage;              // (kSteps, kThreads) partials
  const int chl = threadIdx.x / lanes, sub = threadIdx.x % lanes;
  const int c0 = blockIdx.x * ch, c = c0 + chl;
  const int k0 = sub * kStates;
  const bool live = c < D;
  const size_t row_base = (size_t)blockIdx.y * S;

  float h[kStates], a_row[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const bool ok = live && k0 + k < n;
    const size_t i = ((size_t)blockIdx.y * D + c) * n + k0 + k;
    a_row[k] = ok ? A[(size_t)c * n + k0 + k] : 0.f;
    h[k] = ok && h0 != nullptr ? h0[i] : 0.f;
  }

  const int chunks = (S + kSteps - 1) / kSteps;
  stage_chunk(smem, delta, x, B, C, row_base, min(kSteps, S), c0, ch, D, n,
              nP, vec);
  mma::cp_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kSteps;
    if (ci + 1 < chunks)
      stage_chunk(smem + ((ci + 1) & 1) * stage, delta, x, B, C,
                  row_base + t0 + kSteps, min(kSteps, S - t0 - kSteps), c0,
                  ch, D, n, nP, vec);
    mma::cp_commit();
    mma::cp_wait<1>();
    __syncthreads();
    const float* sd = smem + (ci & 1) * stage;
    const float* sx = sd + kSteps * ch;
    const float* sb = sx + kSteps * ch + k0;
    const float* sc = sb + kSteps * nP;
    const int rows = min(kSteps, S - t0);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float d = sd[r * ch + chl];
      const float dx = __fmul_rn(d, sx[r * ch + chl]);
      float bk[kStates], ck[kStates];
      if constexpr (kStates % 4 == 0) {
#pragma unroll
        for (int k = 0; k < kStates; k += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(sb + r * nP + k);
          const float4 c4 = *reinterpret_cast<const float4*>(sc + r * nP + k);
          bk[k] = b4.x, bk[k + 1] = b4.y, bk[k + 2] = b4.z, bk[k + 3] = b4.w;
          ck[k] = c4.x, ck[k + 1] = c4.y, ck[k + 2] = c4.z, ck[k + 3] = c4.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          bk[k] = sb[r * nP + k];
          ck[k] = sc[r * nP + k];
        }
      }
      float yv = 0.f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float a = expf(__fmul_rn(d, a_row[k]));
        h[k] = __fadd_rn(__fmul_rn(a, h[k]), __fmul_rn(dx, bk[k]));
        yv = k0 + k < n ? fmaf(ck[k], h[k], yv) : yv;
      }
      sy[r * kThreads + threadIdx.x] = yv;
    }
    __syncthreads();
    // y of the chunk: each (step, channel) sums its lanes' partials, and
    // a warp stores 32 neighbouring channels of one step
    for (int i = threadIdx.x; i < rows * ch; i += kThreads) {
      const int r = i / ch, cc = i % ch;
      const float* p = sy + r * kThreads + cc * lanes;
      float v = p[0];
      for (int l = 1; l < lanes; ++l) v += p[l];
      if (c0 + cc < D) y[(row_base + t0 + r) * D + c0 + cc] = v;
    }
  }
#pragma unroll
  for (int k = 0; k < kStates; ++k)
    if (live && k0 + k < n)
      h_last[((size_t)blockIdx.y * D + c) * n + k0 + k] = h[k];
}

template <int kStates>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t st,
                   const float* delta, const float* x, const float* B,
                   const float* C, const float* A, const float* h0, float* y,
                   float* h_last, int S, int D, int n, int lanes, int vec) {
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_kernel<kStates>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  selective_scan_kernel<kStates><<<grid, kThreads, smem, st>>>(
      delta, x, B, C, A, h0, y, h_last, S, D, n, lanes, vec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// delta, x, y: (N, S, D) float32; B, C: (N, S, n); A: (D, n); h0, h_last:
// (N, D, n), h0 null for zeros.  The plan from the host: vec (16-byte
// copies: D % 4 == 0, n % 4 == 0, every operand 16-byte aligned), lanes
// a channel (1 to 32, a power of two) and states a lane (1, 2 or 4), with
// lanes * states >= n; blocks of 128 / lanes channels along D.
// Shape contract (checked by the Python wrapper): contiguous float32 on
// one device, S >= 1, 1 <= n <= 32, N <= 65,535.
extern "C" int repro_selective_scan(const float* delta, const float* x,
                                    const float* B, const float* C,
                                    const float* A, const float* h0,
                                    float* y, float* h_last, int N, int S,
                                    int D, int n, int vec, int lanes,
                                    int states, int blocks, void* stream) {
  using namespace repro_torch;
  if (N == 0 || S == 0 || D == 0) return (int)cudaSuccess;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1))
      || lanes * states < n || (vec && (lanes * states) % 4))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(lanes, states);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(blocks, N);
  switch (states) {
    case 1:
      return (int)launch<1>(grid, smem, st, delta, x, B, C, A, h0, y, h_last,
                            S, D, n, lanes, vec);
    case 2:
      return (int)launch<2>(grid, smem, st, delta, x, B, C, A, h0, y, h_last,
                            S, D, n, lanes, vec);
    case 4:
      return (int)launch<4>(grid, smem, st, delta, x, B, C, A, h0, y, h_last,
                            S, D, n, lanes, vec);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
