// Fused RoPE + page write + paged decode attention, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py, fused_paged_decode_grouped
// (Pallas body _fused_decode_kernel), both modes: fp pools and int8 pools
// with per-row scales (the ``quantized`` branch).  Same function, per slot
// b and kv head h: rotate the G query rows and the fresh key at position
// pos = positions[b] (rotate-half pairs (c, c + D/2), angle pos * inv[i]
// with inv[i] = 1/theta^(2i/D) in f32); write the roped key and the raw
// value into page bt[b, min(pos/P, NB-1)] row pos % P; then online-softmax
// attention of the G rows over the slot's logical positions kpos <= pos,
// optional softcap.  The fresh row is attended AS STORED, from shared
// memory, as the TPU kernel does: on fp pools after the cast to the pool
// dtype; on int8 pools as q * scale.
//
// int8 pools: the roped key is first rounded to the activation dtype (the
// plain version ropes into the activation dtype, and JAX's prefill-side
// _paged_write quantizes those same rows); then, in f32, amax over the
// row by a warp-shuffle max, scale = amax > 0 ? amax / 127 : 1 and
// q = rint(x / scale) -- __fdiv_rn and rintf (half to even, as jnp.round
// and torch.round), so the int8 rows and scales equal the plain
// version's bit for bit.  Cached rows dequantize as (float)q * scale.
//
// The inverse frequencies come in as a (D/2,) f32 table built by the plain
// version's own helper (kernels/ref.py, rope_inv_freq), and the rotation
// uses the precise sinf/cosf and non-contracted multiplies, so the rotated
// rows match the plain PyTorch version bit for bit in f32 (at theta = 5e6
// the first frequency is 1 rad/token: angles reach 10^3 rad, where a fast
// sine would be visibly wrong).
//
// Sink page: idle slots carry all-sentinel tables, so several blocks write
// row pos % P of the sink page -- and on int8 pools its scale entries --
// at once.  That race is benign: the sink is never mapped for reading by
// an active slot and idle outputs are discarded.  An active slot's write
// page is exclusively its own (the engine copies-on-write before the
// step), so no other block reads it.
//
// What bounds it on the H100: bytes.  Per step and layer it must read the
// slot's cached K/V once -- pos+1 tokens x 2 tensors per kv head, D
// elements each (fp) or D int8 bytes plus a 4-byte scale (int8) -- for
// only 4*G*D flops per key: 32 flops per byte of bf16 at G=8 (~62 per
// byte on int8 pools), far below the ~295 the card needs to be bound by
// operations.
//
// What this design does about it: one block of 256 threads per (slot, kv
// head).  The G query rows are loaded and roped once into shared memory
// and then held in registers, so every cached key and value is read from
// device memory exactly once and serves all G query heads of its group.
// Each of the 8 warps walks every 8th key: a lane holds D/32 consecutive
// dims (and on int8 pools one broadcast scale load per key), the G partial
// scores are reduced with warp shuffles, and the warps' (m, l, acc) states
// merge in shared memory at the end.  Keys past pos are never visited.
// With few slots the grid is small (B*Hkv blocks); a split-KV variant with
// a reduce pass is the next step.
#include <type_traits>

#include "attn_common.cuh"

namespace repro_torch {
namespace {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * 32;

// Max of |x| over the D values of a shared row, by one warp.
template <int D>
__device__ __forceinline__ float warp_row_amax(const float* row, int lane) {
  constexpr int DL = D / 32;
  float a = 0.f;
#pragma unroll
  for (int e = 0; e < DL; ++e) a = fmaxf(a, fabsf(row[lane * DL + e]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
  return a;
}

// T: activation dtype (q, k_new, v_new, out); TP: pool dtype (T, or
// int8_t with row scales ks/vs).
template <typename T, typename TP, int D, int G>
__global__ void __launch_bounds__(kDecodeThreads)
fused_decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                    const T* __restrict__ vn, TP* __restrict__ kp,
                    TP* __restrict__ vp, float* __restrict__ ks,
                    float* __restrict__ vs, const int* __restrict__ bt,
                    const int* __restrict__ positions,
                    const float* __restrict__ inv_freq, T* __restrict__ out,
                    int Hkv, int P, int NB, float softcap, float scale) {
  constexpr int kHalf = D / 2;
  constexpr int DL = D / 32;  // dims per lane
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  __shared__ float cs[kHalf], sn[kHalf];
  __shared__ float fresh_sc[2];
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
  // rotate the fresh key and round both rows to the activation dtype
  const T* knb = kn + ((size_t)b * Hkv + h) * D;
  const T* vnb = vn + ((size_t)b * Hkv + h) * D;
  const size_t wrow_idx = ((size_t)wpage * P + row_t) * Hkv + h;
  const size_t wrow = wrow_idx * D;
  for (int c = tid; c < D; c += kDecodeThreads) {
    const int i = c % kHalf;
    const float x1 = to_f32(knb[i]);
    const float x2 = to_f32(knb[i + kHalf]);
    const float y = c < kHalf
                        ? __fsub_rn(__fmul_rn(x1, cs[i]), __fmul_rn(x2, sn[i]))
                        : __fadd_rn(__fmul_rn(x1, sn[i]), __fmul_rn(x2, cs[i]));
    kfresh[c] = to_f32(from_f32<T>(y));
    vfresh[c] = to_f32(vnb[c]);
  }
  __syncthreads();
  if constexpr (kQuant) {
    // per-row scales: warp 0 takes the key row, warp 1 the value row
    if (warp < 2) {
      const float amax = warp_row_amax<D>(warp == 0 ? kfresh : vfresh, lane);
      if (lane == 0) fresh_sc[warp] = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    }
    __syncthreads();
    const float ksc = fresh_sc[0], vsc = fresh_sc[1];
    if (tid == 0) {
      ks[wrow_idx] = ksc;
      vs[wrow_idx] = vsc;
    }
    for (int c = tid; c < D; c += kDecodeThreads) {
      const float kq = rintf(__fdiv_rn(kfresh[c], ksc));
      const float vq = rintf(__fdiv_rn(vfresh[c], vsc));
      kp[wrow + c] = (int8_t)kq;
      vp[wrow + c] = (int8_t)vq;
      kfresh[c] = __fmul_rn(kq, ksc);  // attended as stored
      vfresh[c] = __fmul_rn(vq, vsc);
    }
  } else {
    for (int c = tid; c < D; c += kDecodeThreads) {
      const TP kc = from_f32<TP>(kfresh[c]);
      const TP vc = from_f32<TP>(vfresh[c]);
      kp[wrow + c] = kc;
      vp[wrow + c] = vc;
      kfresh[c] = to_f32(kc);
      vfresh[c] = to_f32(vc);
    }
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
      const size_t ridx = ((size_t)page * P + (t % P)) * Hkv + h;
      const size_t off = ridx * D + lane * DL;
      float ksc = 1.f, vsc = 1.f;
      if constexpr (kQuant) {
        ksc = ks[ridx];
        vsc = vs[ridx];
      }
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        kx[e] = pool_f32<TP>(kp[off + e], ksc);
        vx[e] = pool_f32<TP>(vp[off + e], vsc);
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

template <typename T, typename TP, int D, int G>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kp,
                   void* vp, float* ks, float* vs, const int* bt,
                   const int* positions, const float* inv_freq, void* out,
                   int B, int Hkv, int P, int NB, float softcap, float scale,
                   cudaStream_t stream) {
  dim3 grid(Hkv, B);
  fused_decode_kernel<T, TP, D, G><<<grid, kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<TP*>(kp), static_cast<TP*>(vp),
      ks, vs, bt, positions, inv_freq, static_cast<T*>(out), Hkv, P, NB,
      softcap, scale);
  return cudaGetLastError();
}

template <typename T, typename TP, int D>
cudaError_t launch_g(int G, const void* q, const void* kn, const void* vn,
                     void* kp, void* vp, float* ks, float* vs, const int* bt,
                     const int* positions, const float* inv_freq, void* out,
                     int B, int Hkv, int P, int NB, float softcap,
                     float scale, cudaStream_t stream) {
#define REPRO_DECODE_G(GG)                                                    \
  if (G == GG)                                                                \
  return launch<T, TP, D, GG>(q, kn, vn, kp, vp, ks, vs, bt, positions,       \
                              inv_freq, out, B, Hkv, P, NB, softcap, scale,   \
                              stream)
  REPRO_DECODE_G(1);
  REPRO_DECODE_G(2);
  REPRO_DECODE_G(4);
  REPRO_DECODE_G(8);
#undef REPRO_DECODE_G
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_pool(int G, const void* q, const void* kn, const void* vn,
                        void* kp, void* vp, float* ks, float* vs,
                        const int* bt, const int* positions,
                        const float* inv_freq, void* out, int B, int Hkv,
                        int P, int NB, float softcap, float scale,
                        cudaStream_t stream) {
  if (ks != nullptr)
    return launch_g<T, int8_t, D>(G, q, kn, vn, kp, vp, ks, vs, bt,
                                  positions, inv_freq, out, B, Hkv, P, NB,
                                  softcap, scale, stream);
  return launch_g<T, T, D>(G, q, kn, vn, kp, vp, nullptr, nullptr, bt,
                           positions, inv_freq, out, B, Hkv, P, NB, softcap,
                           scale, stream);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, out; fp pools share
// it).  With ks/vs non-null the pools are int8 with (N, P, Hkv) f32 row
// scales, written in place with the rows.  Shape contract (checked by the
// Python wrapper): D in {64, 128}, G in {1, 2, 4, 8}, positions >= 0,
// block table entries in [0, N), all tensors contiguous.
extern "C" int repro_fused_paged_decode(int dtype, const void* q,
                                        const void* kn, const void* vn,
                                        void* kp, void* vp, float* ks,
                                        float* vs, const int* bt,
                                        const int* positions,
                                        const float* inv_freq, void* out,
                                        int B, int Hkv, int G, int D, int P,
                                        int NB, float softcap, float scale,
                                        void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return (int)cudaSuccess;
  if ((ks == nullptr) != (vs == nullptr)) return (int)cudaErrorInvalidValue;
#define REPRO_DECODE(T, DD)                                                 \
  return (int)launch_pool<T, DD>(G, q, kn, vn, kp, vp, ks, vs, bt,          \
                                 positions, inv_freq, out, B, Hkv, P, NB,   \
                                 softcap, scale, s)
  if (dtype == 0 && D == 64) REPRO_DECODE(float, 64);
  if (dtype == 0 && D == 128) REPRO_DECODE(float, 128);
  if (dtype == 1 && D == 64) REPRO_DECODE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_DECODE(__nv_bfloat16, 128);
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}
