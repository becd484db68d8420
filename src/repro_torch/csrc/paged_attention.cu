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
// It also serves the per-slot decode of sliding-window layers (gemma2's
// local layers), which JAX computes with jnp over its dense ring
// (src/repro/models/layers.py, the per-slot branch of
// multi_head_attention): the ring is viewed as one W-row page a slot,
// lengths = min(position + 1, W) (backend/dispatch.py,
// dispatch_ring_decode).
// On int8 pools (scale pointers non-null) every key and value element is
// dequantized as (float)q * scale[(page, row, h)], as the paged prefill
// kernel does -- the JAX package sends every int8 pool of this step to
// its jnp reference instead.  Lengths above the table's NB * P keys
// attend the whole table.
//
// A slot with lengths[b] <= 0 gives what the Pallas kernel and both
// references give: every score is masked to the same -1e30, so every
// weight is equal and the row is the uniform mean of V over the slot's
// NB * P table rows.  Here such a slot stages zero query rows and walks
// the whole table as admissible: every score is then 0 (and softcap's
// cap * tanh(0 / cap) = 0), so the walk needs no branch of its own.
//
// What bounds it on the H100: bytes.  Per step and layer it must read the
// slot's cached K/V once -- lengths[b] tokens x 2 tensors per kv head, D
// elements each (fp) or D int8 bytes plus a 4-byte scale (int8) -- for
// only 4*G*D flops per key: 32 flops per byte of bf16 at G=8, far below
// the ~295 the card needs to be bound by operations.
//
// What this design does about it: it is the fused decode's split walk
// (split_decode_walk, decode_split.cuh) without RoPE and without the
// write.  The grid is (Hkv, B, splits): the host picks the splits from
// shapes alone (_build.split_plan over B*Hkv blocks and the NB*P-key
// table), so that few slots still fill the card's 132 SMs -- 4 splits of
// 256 keys at 4 slots x 8 kv heads -- and a combine pass merges the
// splits' f32 (m, l, O) (none with one split).  Inside a split each warp
// streams its own 8 keys of every 64-key tile through a cp.async ring
// with no block barrier, so each admissible key and value is read from
// device memory once and serves all G query rows of its group; bf16
// scores run on the tensor cores, f32 on the CUDA cores.  The prologue
// only stages the G query rows in f32, from registers loaded before its
// first barrier.  A split that starts at or past lengths[b] walks nothing
// and writes m = -inf, l = 0.
#include "attn_common.cuh"
#include "decode_split.cuh"

namespace repro_torch {
namespace {

// T: activation dtype (q, out); TP: pool dtype (T, or int8_t with row
// scales ks/vs).  Block (h, b, split) walks keys [split * split_keys,
// +split_keys) of the slot's min(lengths[b], NB * P), or of the whole
// table with zero query rows when lengths[b] <= 0.
template <typename T, typename TP, int D, int G>
__global__ void __launch_bounds__(split::kThreads)
paged_attention_kernel(const T* __restrict__ q, const TP* __restrict__ kp,
                       const TP* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ ws_o, float* __restrict__ ws_ml,
                       int Hkv, int P, int NB, int split_keys, float softcap,
                       float scale) {
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const bool empty = len <= 0;
  const int t_end = empty ? NB * P : min(len, NB * P);
  const int t_begin = split * split_keys;
  const int t_hi = min(t_begin + split_keys, t_end);

  // the G query rows, loaded before any barrier (zeros for an empty slot)
  constexpr int QPT = (G * D + split::kThreads - 1) / split::kThreads;
  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  float qx[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int idx = tid + u * split::kThreads;
    qx[u] = idx < G * D && !empty ? to_f32(qb[idx]) : 0.f;
  }
  auto pre = [&](float* qs, TP*, TP*, float*) {
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int idx = tid + u * split::kThreads;
      if (idx < G * D) qs[idx] = qx[u];
    }
  };

  split::split_decode_walk<T, TP, D, G>(
      kp, vp, ks, vs, bt + (size_t)b * NB, h, Hkv, P, t_begin,
      min(t_begin + split_keys, NB * P), t_hi, -1, softcap, scale, pre, out,
      ws_o, ws_ml, ((size_t)b * Hkv + h) * G, (size_t)gridDim.y * Hkv * G,
      split);
}

// The unfused decode's combine pass (mma::combine_rows), named apart so
// that a profile credits it to this decode.
template <typename T, int D>
__global__ void __launch_bounds__(256)
paged_attention_combine_kernel(const float* __restrict__ ws_o,
                               const float* __restrict__ ws_ml,
                               T* __restrict__ out, size_t rows,
                               int nsplit) {
  mma::combine_rows<T, D>(ws_o, ws_ml, out, rows, nsplit);
}

template <typename T, typename TP, int D, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* bt,
                   const int* lengths, void* out, float* ws_o, float* ws_ml,
                   int nsplit, int split_keys, int B, int Hkv, int P, int NB,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = split::walk_smem<T, TP, D, G>();
  auto kernel = paged_attention_kernel<T, TP, D, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, nsplit);
  kernel<<<grid, split::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, bt, lengths, static_cast<T*>(out),
      nsplit > 1 ? ws_o : nullptr, nsplit > 1 ? ws_ml : nullptr, Hkv, P, NB,
      split_keys, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const size_t rows = (size_t)B * Hkv * G;
  const unsigned blocks = (unsigned)((rows * (D / 4) + 255) / 256);
  paged_attention_combine_kernel<T, D><<<blocks, 256, 0, stream>>>(
      ws_o, ws_ml, static_cast<T*>(out), rows, nsplit);
  return cudaGetLastError();
}

template <typename T, typename TP, int D>
cudaError_t launch_g(int G, const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* bt,
                     const int* lengths, void* out, float* ws_o,
                     float* ws_ml, int nsplit, int split_keys, int B,
                     int Hkv, int P, int NB, float softcap, float scale,
                     cudaStream_t stream) {
#define REPRO_PAGED_G(GG)                                                    \
  if (G == GG)                                                               \
  return launch<T, TP, D, GG>(q, kp, vp, ks, vs, bt, lengths, out, ws_o,     \
                              ws_ml, nsplit, split_keys, B, Hkv, P, NB,      \
                              softcap, scale, stream)
  REPRO_PAGED_G(1);
  REPRO_PAGED_G(2);
  REPRO_PAGED_G(3);
  REPRO_PAGED_G(4);
  REPRO_PAGED_G(5);
  REPRO_PAGED_G(6);
  REPRO_PAGED_G(7);
  REPRO_PAGED_G(8);
#undef REPRO_PAGED_G
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_pool(int G, const void* q, const void* kp, const void* vp,
                        const float* ks, const float* vs, const int* bt,
                        const int* lengths, void* out, float* ws_o,
                        float* ws_ml, int nsplit, int split_keys, int B,
                        int Hkv, int P, int NB, float softcap, float scale,
                        cudaStream_t stream) {
  if (ks != nullptr)
    return launch_g<T, int8_t, D>(G, q, kp, vp, ks, vs, bt, lengths, out,
                                  ws_o, ws_ml, nsplit, split_keys, B, Hkv, P,
                                  NB, softcap, scale, stream);
  return launch_g<T, T, D>(G, q, kp, vp, nullptr, nullptr, bt, lengths, out,
                           ws_o, ws_ml, nsplit, split_keys, B, Hkv, P, NB,
                           softcap, scale, stream);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q and out; fp pools share it).  With
// ks/vs non-null the pools are int8 with (N, P, Hkv) f32 row scales.
// lengths: (B,) int32 valid keys per slot.  nsplit key splits of
// split_keys keys each (a multiple of 64; nsplit * split_keys covers the
// NB * P table), merged through the f32 workspaces ws_o (nsplit, B*Hkv*G,
// D) and ws_ml (nsplit, B*Hkv*G, 2) when nsplit > 1.  Shape contract
// (checked by the Python wrapper): D in {64, 128, 256}, G from 1 to 8,
// block table entries in [0, N), all tensors contiguous, the pools
// 16-byte aligned.
extern "C" int repro_paged_attention(int dtype, const void* q,
                                     const void* kp, const void* vp,
                                     const float* ks, const float* vs,
                                     const int* bt, const int* lengths,
                                     void* out, float* ws_o, float* ws_ml,
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
#define REPRO_PAGED(T, DD)                                                  \
  return (int)launch_pool<T, DD>(G, q, kp, vp, ks, vs, bt, lengths, out,    \
                                 ws_o, ws_ml, nsplit, split_keys, B, Hkv, P, \
                                 NB, softcap, scale, s)
  if (dtype == 0 && D == 64) REPRO_PAGED(float, 64);
  if (dtype == 0 && D == 128) REPRO_PAGED(float, 128);
  if (dtype == 0 && D == 256) REPRO_PAGED(float, 256);
  if (dtype == 1 && D == 64) REPRO_PAGED(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_PAGED(__nv_bfloat16, 128);
  if (dtype == 1 && D == 256) REPRO_PAGED(__nv_bfloat16, 256);
#undef REPRO_PAGED
  return (int)cudaErrorInvalidValue;
}
