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
// What this design does about it: the keys are split across blocks and
// walked in tiles (split_decode_walk, decode_split.cuh).  The grid is
// (Hkv, B, splits): the host picks the splits from shapes alone
// (_build.split_plan over B*Hkv blocks and the NB*P-key table), so that
// few slots still fill the card's 132 SMs -- 8 splits of 128 keys at the
// serve's 4 slots x 4 kv heads, 4 of 256 at B=8 -- and a combine pass
// merges the splits' f32 (m, l, O) (none with one split).  Every split
// with keys ropes its G query rows; only the split whose key range holds
// the fresh position ropes the fresh key, writes its row (and scales) to
// the pool and attends it as stored from shared memory, so no block
// reads a row another block writes.  Inside a split, each warp streams
// its own 8 keys of every 64-key tile (four pages) through a cp.async
// ring, with no block barrier: each cached key and value is read from
// device memory once and serves all G query rows of its group, the
// scores run on the tensor cores in bf16, and there is one
// online-softmax update per tile and warp with P kept in f32, as the
// Pallas kernel keeps p and v.  Every global load the prologue needs is
// issued before its first barrier.  A split that starts past pos walks
// nothing and writes m = -inf, l = 0.
#include "attn_common.cuh"
#include "decode_split.cuh"

namespace repro_torch {
namespace {

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
// int8_t with row scales ks/vs).  Block (h, b, split) walks keys
// [split * split_keys, +split_keys) of the slot's min(pos + 1, NB * P).
template <typename T, typename TP, int D, int G>
__global__ void __launch_bounds__(split::kThreads)
fused_decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                    const T* __restrict__ vn, TP* __restrict__ kp,
                    TP* __restrict__ vp, float* __restrict__ ks,
                    float* __restrict__ vs, const int* __restrict__ bt,
                    const int* __restrict__ positions,
                    const float* __restrict__ inv_freq, T* __restrict__ out,
                    float* __restrict__ ws_o, float* __restrict__ ws_ml,
                    int Hkv, int P, int NB, int split_keys, float softcap,
                    float scale) {
  constexpr int kHalf = D / 2;
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  __shared__ float cs[kHalf], sn[kHalf];
  __shared__ float kfresh[D], vfresh[D];

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = positions[b];
  const int* btb = bt + (size_t)b * NB;
  const int jt = min(pos / P, NB - 1);
  const int row_t = pos % P;
  const int t_end = min(pos + 1, NB * P);
  const int t_fresh = jt * P + row_t;
  const int t_begin = split * split_keys;
  const int t_hi = min(t_begin + split_keys, t_end);
  const bool owner = t_begin <= t_fresh && t_fresh < t_hi;

  // what the prologue reads, loaded before any barrier so that its global
  // loads overlap: per thread its q elements (both halves of each rotate
  // pair), and for thread c < D the fresh key's pair and value c
  constexpr int QPT = (G * D + split::kThreads - 1) / split::kThreads;
  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  float qx1[QPT], qx2[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int idx = tid + u * split::kThreads;
    const int g = idx / D, i = (idx % D) % kHalf;
    qx1[u] = idx < G * D ? to_f32(qb[g * D + i]) : 0.f;
    qx2[u] = idx < G * D ? to_f32(qb[g * D + i + kHalf]) : 0.f;
  }
  const T* knb = kn + ((size_t)b * Hkv + h) * D;
  const int ci = tid % kHalf;
  const float kx1 = tid < D ? to_f32(knb[ci]) : 0.f;
  const float kx2 = tid < D ? to_f32(knb[ci + kHalf]) : 0.f;
  const float vx = tid < D ? to_f32(vn[((size_t)b * Hkv + h) * D + tid])
                           : 0.f;
  const float inv = tid < kHalf ? inv_freq[tid] : 0.f;

  // RoPE of the G query rows (every split with keys) and, in the owning
  // split, of the fresh key; the fresh row is written to its page and
  // kept, as stored, for the walk
  auto pre = [&](float* qs, TP* kfr, TP* vfr, float* fsc) {
    if (t_hi <= t_begin) return;           // an empty split: nothing to do
    if (tid < kHalf) {
      const float a = __fmul_rn((float)pos, inv);
      cs[tid] = cosf(a);
      sn[tid] = sinf(a);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int idx = tid + u * split::kThreads;
      if (idx >= G * D) break;
      const int c = idx % D, i = c % kHalf;
      const float x1 = qx1[u], x2 = qx2[u];
      const float y =
          c < kHalf ? __fsub_rn(__fmul_rn(x1, cs[i]), __fmul_rn(x2, sn[i]))
                    : __fadd_rn(__fmul_rn(x1, sn[i]), __fmul_rn(x2, cs[i]));
      qs[idx] = to_f32(from_f32<T>(y));   // as the model dtype holds it
    }
    if (!owner) return;                    // block-uniform
    const size_t wrow_idx = ((size_t)btb[jt] * P + row_t) * Hkv + h;
    const size_t wrow = wrow_idx * D;
    if (tid < D) {
      const int c = tid, i = ci;
      const float y =
          c < kHalf
              ? __fsub_rn(__fmul_rn(kx1, cs[i]), __fmul_rn(kx2, sn[i]))
              : __fadd_rn(__fmul_rn(kx1, sn[i]), __fmul_rn(kx2, cs[i]));
      kfresh[c] = to_f32(from_f32<T>(y));  // roped in the activation dtype
      vfresh[c] = vx;
    }
    __syncthreads();
    if constexpr (kQuant) {
      // per-row scales: warp 0 takes the key row, warp 1 the value row
      if (warp < 2) {
        const float amax = warp_row_amax<D>(warp == 0 ? kfresh : vfresh,
                                            lane);
        if (lane == 0) fsc[warp] = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
      }
      __syncthreads();
      const float ksc = fsc[0], vsc = fsc[1];
      if (tid == 0) {
        ks[wrow_idx] = ksc;
        vs[wrow_idx] = vsc;
      }
      for (int c = tid; c < D; c += split::kThreads) {
        const int8_t kq = (int8_t)rintf(__fdiv_rn(kfresh[c], ksc));
        const int8_t vq = (int8_t)rintf(__fdiv_rn(vfresh[c], vsc));
        kp[wrow + c] = kq;
        vp[wrow + c] = vq;
        kfr[c] = kq;
        vfr[c] = vq;
      }
    } else {
      for (int c = tid; c < D; c += split::kThreads) {
        const TP kc = from_f32<TP>(kfresh[c]);
        const TP vc = from_f32<TP>(vfresh[c]);
        kp[wrow + c] = kc;
        vp[wrow + c] = vc;
        kfr[c] = kc;
        vfr[c] = vc;
      }
    }
  };

  const size_t row0 = ((size_t)b * Hkv + h) * G;
  split::split_decode_walk<T, TP, D, G>(
      kp, vp, ks, vs, btb, h, Hkv, P, t_begin,
      min(t_begin + split_keys, NB * P), t_hi, owner ? t_fresh : -1,
      softcap, scale, pre, out, ws_o, ws_ml, row0,
      (size_t)gridDim.y * Hkv * G, split);
}

// The fused decode's combine pass (mma::combine_rows, as the bf16
// attention engine's split_combine_kernel), named apart so that a
// profile credits it to the decode.
template <typename T, int D>
__global__ void __launch_bounds__(256)
fused_decode_combine_kernel(const float* __restrict__ ws_o,
                            const float* __restrict__ ws_ml,
                            T* __restrict__ out, size_t rows, int nsplit) {
  mma::combine_rows<T, D>(ws_o, ws_ml, out, rows, nsplit);
}

template <typename T, typename TP, int D, int G>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kp,
                   void* vp, float* ks, float* vs, const int* bt,
                   const int* positions, const float* inv_freq, void* out,
                   float* ws_o, float* ws_ml, int nsplit, int split_keys,
                   int B, int Hkv, int P, int NB, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = split::walk_smem<T, TP, D, G>();
  auto kernel = fused_decode_kernel<T, TP, D, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, nsplit);
  kernel<<<grid, split::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<TP*>(kp), static_cast<TP*>(vp),
      ks, vs, bt, positions, inv_freq, static_cast<T*>(out),
      nsplit > 1 ? ws_o : nullptr, nsplit > 1 ? ws_ml : nullptr, Hkv, P, NB,
      split_keys, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const size_t rows = (size_t)B * Hkv * G;
  const unsigned blocks = (unsigned)((rows * (D / 4) + 255) / 256);
  fused_decode_combine_kernel<T, D><<<blocks, 256, 0, stream>>>(
      ws_o, ws_ml, static_cast<T*>(out), rows, nsplit);
  return cudaGetLastError();
}

template <typename T, typename TP, int D>
cudaError_t launch_g(int G, const void* q, const void* kn, const void* vn,
                     void* kp, void* vp, float* ks, float* vs, const int* bt,
                     const int* positions, const float* inv_freq, void* out,
                     float* ws_o, float* ws_ml, int nsplit, int split_keys,
                     int B, int Hkv, int P, int NB, float softcap,
                     float scale, cudaStream_t stream) {
#define REPRO_DECODE_G(GG)                                                    \
  if (G == GG)                                                                \
  return launch<T, TP, D, GG>(q, kn, vn, kp, vp, ks, vs, bt, positions,       \
                              inv_freq, out, ws_o, ws_ml, nsplit,             \
                              split_keys, B, Hkv, P, NB, softcap, scale,      \
                              stream)
  REPRO_DECODE_G(1);
  REPRO_DECODE_G(2);
  REPRO_DECODE_G(3);
  REPRO_DECODE_G(4);
  REPRO_DECODE_G(5);
  REPRO_DECODE_G(6);
  REPRO_DECODE_G(7);
  REPRO_DECODE_G(8);
#undef REPRO_DECODE_G
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_pool(int G, const void* q, const void* kn, const void* vn,
                        void* kp, void* vp, float* ks, float* vs,
                        const int* bt, const int* positions,
                        const float* inv_freq, void* out, float* ws_o,
                        float* ws_ml, int nsplit, int split_keys, int B,
                        int Hkv, int P, int NB, float softcap, float scale,
                        cudaStream_t stream) {
  if (ks != nullptr)
    return launch_g<T, int8_t, D>(G, q, kn, vn, kp, vp, ks, vs, bt,
                                  positions, inv_freq, out, ws_o, ws_ml,
                                  nsplit, split_keys, B, Hkv, P, NB, softcap,
                                  scale, stream);
  return launch_g<T, T, D>(G, q, kn, vn, kp, vp, nullptr, nullptr, bt,
                           positions, inv_freq, out, ws_o, ws_ml, nsplit,
                           split_keys, B, Hkv, P, NB, softcap, scale, stream);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, out; fp pools share
// it).  With ks/vs non-null the pools are int8 with (N, P, Hkv) f32 row
// scales, written in place with the rows.  nsplit key splits of
// split_keys keys each (a multiple of 64; nsplit * split_keys covers the
// NB * P table), merged through the f32 workspaces ws_o (nsplit, B*Hkv*G,
// D) and ws_ml (nsplit, B*Hkv*G, 2) when nsplit > 1.  Shape contract
// (checked by the Python wrapper): D in {64, 128, 256}, G from 1 to 8,
// positions >= 0, block table entries in [0, N), all tensors contiguous,
// the pools 16-byte aligned.
extern "C" int repro_fused_paged_decode(int dtype, const void* q,
                                        const void* kn, const void* vn,
                                        void* kp, void* vp, float* ks,
                                        float* vs, const int* bt,
                                        const int* positions,
                                        const float* inv_freq, void* out,
                                        float* ws_o, float* ws_ml,
                                        int nsplit, int split_keys, int B,
                                        int Hkv, int G, int D, int P, int NB,
                                        float softcap, float scale,
                                        void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return (int)cudaSuccess;
  if ((ks == nullptr) != (vs == nullptr) || nsplit < 1 || nsplit > 65535 ||
      split_keys < 1 || split_keys % split::kKeys != 0 ||
      (long long)nsplit * split_keys < (long long)NB * P ||
      (nsplit > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
#define REPRO_DECODE(T, DD)                                                 \
  return (int)launch_pool<T, DD>(G, q, kn, vn, kp, vp, ks, vs, bt,          \
                                 positions, inv_freq, out, ws_o, ws_ml,     \
                                 nsplit, split_keys, B, Hkv, P, NB,         \
                                 softcap, scale, s)
  if (dtype == 0 && D == 64) REPRO_DECODE(float, 64);
  if (dtype == 0 && D == 128) REPRO_DECODE(float, 128);
  if (dtype == 0 && D == 256) REPRO_DECODE(float, 256);
  if (dtype == 1 && D == 64) REPRO_DECODE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_DECODE(__nv_bfloat16, 128);
  if (dtype == 1 && D == 256) REPRO_DECODE(__nv_bfloat16, 256);
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}
