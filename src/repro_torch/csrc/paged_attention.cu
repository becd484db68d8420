// Unfused one-token paged decode attention, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py, paged_attention_grouped
// (Pallas body _paged_kernel).  Same function: per slot b and kv head h,
// the G query rows q[b, h] (B,Hkv,G,D) attend every logical position
// kpos < lengths[b] of the slot, each key's page resolved through the
// block table bt (B,NB) into pools (N,P,Hkv,D); f32 online softmax,
// optional tanh softcap.  It serves the decode steps that cannot fuse
// their RoPE and page write (rope-free attention, jamba's): the model has
// already written the fresh row into its page, and lengths = position + 1.
// On int8 pools (scale pointers non-null) every key and value element is
// dequantized in the loader, (float)q * scale[(page, row, h)], as the
// paged prefill kernel does -- the JAX package sends every int8 pool of
// this step to its jnp reference instead.  Masked keys contribute an exact
// 0 (they are never visited), so a slot with length 0 writes 0.
//
// What bounds it on the H100: bytes.  Per step and layer it must read the
// slot's cached K/V once -- lengths[b] tokens x 2 tensors per kv head, D
// elements each (fp) or D int8 bytes plus a 4-byte scale (int8) -- for
// only 4*G*D flops per key: 32 flops per byte of bf16 at G=8, far below
// the ~295 the card needs to be bound by operations.
//
// What this design does about it: it is the fused decode without RoPE and
// without the write: one block of 256 threads per (slot, kv head) stages
// its G query rows in shared memory once, then decode_walk()
// (attn_common.cuh) reads every admissible key and value of the slot from
// device memory exactly once for all G rows of the group.  Keys at or past
// lengths[b] are never visited.  With few slots the grid is small
// (B*Hkv blocks); split-KV with a reduce pass is the speed step for both
// decode kernels.
#include "attn_common.cuh"

namespace repro_torch {
namespace {

// T: activation dtype (q, out); TP: pool dtype (T, or int8_t with row
// scales ks/vs).
template <typename T, typename TP, int D, int G>
__global__ void __launch_bounds__(kDecodeThreads)
paged_attention_kernel(const T* __restrict__ q, const TP* __restrict__ kp,
                       const TP* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int Hkv, int P, int NB, float softcap, float scale) {
  __shared__ float qs[G][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kDecodeThreads)
    qs[idx / D][idx % D] = to_f32(qb[idx]);
  __syncthreads();
  const int t_end = max(0, min(lengths[b], NB * P));
  decode_walk<T, TP, D, G>(&qs[0][0], kp, vp, ks, vs, bt + (size_t)b * NB,
                           h, Hkv, P, t_end, -1, nullptr, nullptr, softcap,
                           scale, out + ((size_t)b * Hkv + h) * G * D);
}

template <typename T, typename TP, int D, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* bt,
                   const int* lengths, void* out, int B, int Hkv, int P,
                   int NB, float softcap, float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  paged_attention_kernel<T, TP, D, G><<<grid, kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, bt, lengths, static_cast<T*>(out),
      Hkv, P, NB, softcap, scale);
  return cudaGetLastError();
}

template <typename T, typename TP, int D>
cudaError_t launch_g(int G, const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* bt,
                     const int* lengths, void* out, int B, int Hkv, int P,
                     int NB, float softcap, float scale,
                     cudaStream_t stream) {
#define REPRO_PAGED_G(GG)                                                    \
  if (G == GG)                                                               \
  return launch<T, TP, D, GG>(q, kp, vp, ks, vs, bt, lengths, out, B, Hkv,   \
                              P, NB, softcap, scale, stream)
  REPRO_PAGED_G(1);
  REPRO_PAGED_G(2);
  REPRO_PAGED_G(4);
  REPRO_PAGED_G(8);
#undef REPRO_PAGED_G
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_pool(int G, const void* q, const void* kp, const void* vp,
                        const float* ks, const float* vs, const int* bt,
                        const int* lengths, void* out, int B, int Hkv, int P,
                        int NB, float softcap, float scale,
                        cudaStream_t stream) {
  if (ks != nullptr)
    return launch_g<T, int8_t, D>(G, q, kp, vp, ks, vs, bt, lengths, out, B,
                                  Hkv, P, NB, softcap, scale, stream);
  return launch_g<T, T, D>(G, q, kp, vp, nullptr, nullptr, bt, lengths, out,
                           B, Hkv, P, NB, softcap, scale, stream);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q and out; fp pools share it).  With
// ks/vs non-null the pools are int8 with (N, P, Hkv) f32 row scales.
// lengths: (B,) int32 valid keys per slot.  Shape contract (checked by
// the Python wrapper): D in {64, 128}, G in {1, 2, 4, 8}, block table
// entries in [0, N), all tensors contiguous.
extern "C" int repro_paged_attention(int dtype, const void* q,
                                     const void* kp, const void* vp,
                                     const float* ks, const float* vs,
                                     const int* bt, const int* lengths,
                                     void* out, int B, int Hkv, int G, int D,
                                     int P, int NB, float softcap,
                                     float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return (int)cudaSuccess;
  if ((ks == nullptr) != (vs == nullptr)) return (int)cudaErrorInvalidValue;
#define REPRO_PAGED(T, DD)                                                  \
  return (int)launch_pool<T, DD>(G, q, kp, vp, ks, vs, bt, lengths, out, B, \
                                 Hkv, P, NB, softcap, scale, s)
  if (dtype == 0 && D == 64) REPRO_PAGED(float, 64);
  if (dtype == 0 && D == 128) REPRO_PAGED(float, 128);
  if (dtype == 1 && D == 64) REPRO_PAGED(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_PAGED(__nv_bfloat16, 128);
#undef REPRO_PAGED
  return (int)cudaErrorInvalidValue;
}
