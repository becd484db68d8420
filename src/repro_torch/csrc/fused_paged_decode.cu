// Fused RoPE + page write + paged decode attention, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py, fused_paged_decode_grouped
// (Pallas body _fused_decode_kernel), fp pools.  Same function, per slot b
// and kv head h: rotate the G query rows and the fresh key at position
// pos = positions[b] (rotate-half pairs (c, c + D/2), angle pos * inv[i]
// with inv[i] = 1/theta^(2i/D) in f32); write the roped key and the raw
// value, cast to the pool dtype, into page bt[b, min(pos/P, NB-1)] row
// pos % P; then online-softmax attention of the G rows over the slot's
// logical positions kpos <= pos, optional softcap.  The fresh row is
// attended AS STORED (after the cast), as the TPU kernel does.
//
// The inverse frequencies come in as a (D/2,) f32 table built by the plain
// version's own helper (kernels/ref.py, rope_inv_freq), and the rotation
// uses the precise sinf/cosf and non-contracted multiplies, so the rotated
// rows match the plain PyTorch version bit for bit in f32 (at theta = 5e6
// the first frequency is 1 rad/token: angles reach 10^3 rad, where a fast
// sine would be visibly wrong).
//
// Sink page: idle slots carry all-sentinel tables, so several blocks write
// row pos % P of the sink page at once.  That race is benign -- the sink
// is never mapped for reading by an active slot and idle outputs are
// discarded.  An active slot's write page is exclusively its own (the
// engine copies-on-write before the step), so no other block reads it.
//
// What bounds it on the H100: bytes.  Per step and layer it must read the
// slot's cached K/V once (pos+1 tokens x D x 2 tensors per kv head) for
// only 4*G*D flops per key -- 32 flops per byte of bf16 at G=8, far below
// the ~295 the card needs to be bound by operations.
//
// What this design does about it: one block of 256 threads per (slot, kv
// head).  The G query rows are loaded and roped once into shared memory
// and then held in registers, so every cached key and value is read from
// device memory exactly once and serves all G query heads of its group.
// Each of the 8 warps walks every 8th key: a lane holds D/32 consecutive
// dims, the G partial scores are reduced with warp shuffles, and the warps'
// (m, l, acc) states merge in shared memory at the end.  Keys past pos are
// never visited.  With few slots the grid is small (B*Hkv blocks); a
// split-KV variant with a reduce pass is the next step.
#include "attn_common.cuh"

namespace repro_torch {
namespace {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * 32;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecodeThreads)
fused_decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                    const T* __restrict__ vn, T* __restrict__ kp,
                    T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ positions,
                    const float* __restrict__ inv_freq, T* __restrict__ out,
                    int Hkv, int P, int NB, float softcap, float scale) {
  constexpr int kHalf = D / 2;
  constexpr int DL = D / 32;  // dims per lane
  __shared__ float cs[kHalf], sn[kHalf];
  __shared__ float qs[G][D];
  __shared__ float kfresh[D], vfresh[D];
  __shared__ float red_m[kDecodeWarps][G], red_l[kDecodeWarps][G];
  __shared__ float red_acc[kDecodeWarps][G][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = positions[b];
  const int* btb = bt + (size_t)b * NB;
  const int jt = min(pos / P, NB - 1);
  const int row_t = pos % P;
  const int wpage = btb[jt];

  for (int i = tid; i < kHalf; i += kDecodeThreads) {
    const float a = __fmul_rn((float)pos, inv_freq[i]);
    cs[i] = cosf(a);
    sn[i] = sinf(a);
  }
  __syncthreads();

  // rotate the G query rows; keep them as the model dtype holds them
  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  for (int idx = tid; idx < G * D; idx += kDecodeThreads) {
    const int g = idx / D, c = idx % D;
    const int i = c % kHalf;
    const float x1 = to_f32(qb[g * D + i]);
    const float x2 = to_f32(qb[g * D + i + kHalf]);
    const float y = c < kHalf
                        ? __fsub_rn(__fmul_rn(x1, cs[i]), __fmul_rn(x2, sn[i]))
                        : __fadd_rn(__fmul_rn(x1, sn[i]), __fmul_rn(x2, cs[i]));
    qs[g][c] = to_f32(from_f32<T>(y));
  }
  // rotate the fresh key, cast both rows to the pool dtype, write them
  const T* knb = kn + ((size_t)b * Hkv + h) * D;
  const T* vnb = vn + ((size_t)b * Hkv + h) * D;
  const size_t wrow = (((size_t)wpage * P + row_t) * Hkv + h) * D;
  for (int c = tid; c < D; c += kDecodeThreads) {
    const int i = c % kHalf;
    const float x1 = to_f32(knb[i]);
    const float x2 = to_f32(knb[i + kHalf]);
    const float y = c < kHalf
                        ? __fsub_rn(__fmul_rn(x1, cs[i]), __fmul_rn(x2, sn[i]))
                        : __fadd_rn(__fmul_rn(x1, sn[i]), __fmul_rn(x2, cs[i]));
    const T kc = from_f32<T>(y);
    const T vc = vnb[c];
    kp[wrow + c] = kc;
    vp[wrow + c] = vc;
    kfresh[c] = to_f32(kc);
    vfresh[c] = to_f32(vc);
  }
  __syncthreads();

  float qreg[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < DL; ++e) qreg[g][e] = qs[g][lane * DL + e];
  float acc[G][DL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;
  }

  // every visited key is admissible: kpos <= pos, inside the table
  const int t_end = min(pos + 1, NB * P);
  const int t_fresh = jt * P + row_t;
  for (int t = warp; t < t_end; t += kDecodeWarps) {
    float kx[DL], vx[DL];
    if (t == t_fresh) {
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        kx[e] = kfresh[lane * DL + e];
        vx[e] = vfresh[lane * DL + e];
      }
    } else {
      const int page = btb[t / P];
      const size_t off =
          (((size_t)page * P + (t % P)) * Hkv + h) * D + lane * DL;
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        kx[e] = to_f32(kp[off + e]);
        vx[e] = to_f32(vp[off + e]);
      }
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) part = fmaf(qreg[g][e], kx[e], part);
      s[g] = part;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(kFull, s[g], off);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sc = apply_softcap(s[g] * scale, softcap);
      const float m_new = fmaxf(m[g], sc);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e] * alpha);
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) red_acc[warp][g][lane * DL + e] = acc[g][e];
  }
  __syncthreads();
  T* ob = out + ((size_t)b * Hkv + h) * G * D;
  for (int idx = tid; idx < G * D; idx += kDecodeThreads) {
    const int g = idx / D, c = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float f = red_m[w][g] == kNegInf ? 0.f : expf(red_m[w][g] - mx);
      lsum += red_l[w][g] * f;
      asum += red_acc[w][g][c] * f;
    }
    ob[g * D + c] = from_f32<T>(lsum > 0.f ? asum / lsum : 0.f);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kp,
                   void* vp, const int* bt, const int* positions,
                   const float* inv_freq, void* out, int B, int Hkv, int P,
                   int NB, float softcap, float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  fused_decode_kernel<T, D, G><<<grid, kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(kp), static_cast<T*>(vp), bt,
      positions, inv_freq, static_cast<T*>(out), Hkv, P, NB, softcap, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* kn, const void* vn,
                     void* kp, void* vp, const int* bt, const int* positions,
                     const float* inv_freq, void* out, int B, int Hkv, int P,
                     int NB, float softcap, float scale,
                     cudaStream_t stream) {
#define REPRO_DECODE_G(GG)                                                 \
  if (G == GG)                                                             \
  return launch<T, D, GG>(q, kn, vn, kp, vp, bt, positions, inv_freq, out, \
                          B, Hkv, P, NB, softcap, scale, stream)
  REPRO_DECODE_G(1);
  REPRO_DECODE_G(2);
  REPRO_DECODE_G(4);
  REPRO_DECODE_G(8);
#undef REPRO_DECODE_G
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new and the pools share
// it).  Shape contract (checked by the Python wrapper): D in {64, 128},
// G in {1, 2, 4, 8}, positions >= 0, block table entries in [0, N), all
// tensors contiguous.  Writes the pools in place.
extern "C" int repro_fused_paged_decode(int dtype, const void* q,
                                        const void* kn, const void* vn,
                                        void* kp, void* vp, const int* bt,
                                        const int* positions,
                                        const float* inv_freq, void* out,
                                        int B, int Hkv, int G, int D, int P,
                                        int NB, float softcap, float scale,
                                        void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return (int)cudaSuccess;
#define REPRO_DECODE(T, DD)                                                  \
  return (int)launch_g<T, DD>(G, q, kn, vn, kp, vp, bt, positions, inv_freq, \
                              out, B, Hkv, P, NB, softcap, scale, s)
  if (dtype == 0 && D == 64) REPRO_DECODE(float, 64);
  if (dtype == 0 && D == 128) REPRO_DECODE(float, 128);
  if (dtype == 1 && D == 64) REPRO_DECODE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_DECODE(__nv_bfloat16, 128);
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}
