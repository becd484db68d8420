// Suffix / chunk prefill and speculative-verify attention over the paged
// KV pool, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py,
// paged_prefill_attention_grouped (Pallas body _paged_prefill_kernel), and
// serves the paged verify window, which the JAX package computes with its
// jnp reference on every backend (backend/dispatch.py,
// dispatch_paged_verify_attention -> ref.paged_verify_attention_ref).
// Same function: q (B,Hkv,G,S,D) holds S fresh queries per slot at
// positions offsets[b]..offsets[b]+S-1 (their K/V already written into
// the pool); each attends every mapped logical position kpos <= qpos of
// its slot through the block table bt (B,NB) into pools (N,P,Hkv,D); f32
// online softmax, optional softcap.  A prefill passes B = 1; a verify
// window passes each slot's position with S = K+1.  On int8 pools
// (scale pointers non-null) every key element is dequantized as it is
// staged, q * scale[(page, row, h)], so no dequantized copy of the pool
// is ever made -- the JAX package sends every int8 prefill to its jnp
// reference instead.  The G query heads of one kv head are flattened into
// G*S rows, row r at position offsets[b] + r % S, so one pass over a page
// serves all of them (the GQA reuse the TPU kernel gets from its MXU).
//
// What bounds it on the H100: per admission and layer it must read the
// slot's mapped K/V once (offset+S tokens x Hkv x D x 2 tensors; int8
// pools D bytes plus a 4-byte scale per row) and the queries, and write
// the output; at the prefill's shapes (S=100-600, G=8, D=128) that is
// ~1-3 MB against ~4*G*D flops per admissible (query, key) pair, ~0.5-3
// GFLOP -- bound by operations.  A verify window (S = K+1 = 5) does
// S*G = 40 rows per kv head over the whole slot: bound by bytes.
//
// What this design does about it: one block of 128 threads per (slot,
// kv head, 64 flattened rows) walks the logical key positions in tiles of
// 32 (attn_common.cuh), resolving each key's physical page through the
// block table as it stages the tile, so no contiguous K/V copy is ever
// made.  Keys past offsets[b]+S-1 are never visited (fully masked), and a
// tile no row of the block may attend is skipped before it is loaded;
// both bounds come from the block's own slot, so windows at different
// depths skip independently.  The products run on the CUDA cores in f32;
// wgmma comes later.
#include "attn_common.cuh"

namespace repro_torch {
namespace {

template <typename T, typename TP>
struct PagedPrefillProb {
  const T* q;        // (G*S, D) rows of this (b, h)
  T* o;
  const TP* kp;      // pools (N, P, Hkv, D)
  const TP* vp;
  const float* ks;   // (N, P, Hkv) row scales on int8 pools, else null
  const float* vs;
  const int* bt;     // (NB,) row of this slot
  int r0, n_rows, n_keys, S, P, Hkv, h, offset, D;

  __device__ const T* q_row(int r) const { return q + (size_t)(r0 + r) * D; }
  __device__ T* o_row(int r) const { return o + (size_t)(r0 + r) * D; }
  __device__ int qpos(int r) const { return offset + (r0 + r) % S; }
  __device__ void key_meta(int t, int& kpos, int& kvalid) const {
    kpos = t;
    kvalid = 1;
  }
  __device__ bool admit(int qp, int kpos) const { return kpos <= qp; }
  __device__ void load_kv(int t, int d, float& kx, float& vx) const {
    const int page = bt[t / P];
    const size_t row = ((size_t)page * P + (t % P)) * Hkv + h;
    float ksc = 1.f, vsc = 1.f;
    if (ks != nullptr) {
      ksc = ks[row];
      vsc = vs[row];
    }
    kx = pool_f32<TP>(kp[row * D + d], ksc);
    vx = pool_f32<TP>(vp[row * D + d], vsc);
  }
};

template <typename T, typename TP, int D>
__global__ void __launch_bounds__(kTileThreads)
paged_prefill_kernel(const T* __restrict__ q, const TP* __restrict__ kp,
                     const TP* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ bt,
                     const int* __restrict__ offsets, T* __restrict__ out,
                     int Hkv, int G, int S, int P, int NB, float softcap,
                     float scale) {
  const int rt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int R = G * S;
  const int offset = offsets[b];
  PagedPrefillProb<T, TP> pb;
  pb.q = q + ((size_t)b * Hkv + h) * R * D;
  pb.o = out + ((size_t)b * Hkv + h) * R * D;
  pb.kp = kp;
  pb.vp = vp;
  pb.ks = ks;
  pb.vs = vs;
  pb.bt = bt + (size_t)b * NB;
  pb.r0 = rt * kBQ;
  pb.n_rows = min(kBQ, R - pb.r0);
  // keys beyond the slot's last query position are fully masked
  pb.n_keys = min(NB * P, offset + S);
  pb.S = S;
  pb.P = P;
  pb.Hkv = Hkv;
  pb.h = h;
  pb.offset = offset;
  pb.D = D;
  tile_attention<T, D>(pb, scale, softcap);
}

template <typename T, typename TP, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* bt,
                   const int* offsets, void* out, int B, int Hkv, int G,
                   int S, int P, int NB, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem = TileSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, TP, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((G * S + kBQ - 1) / kBQ, Hkv, B);
  paged_prefill_kernel<T, TP, D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, bt, offsets, static_cast<T*>(out),
      Hkv, G, S, P, NB, softcap, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_pool(const void* q, const void* kp, const void* vp,
                        const float* ks, const float* vs, const int* bt,
                        const int* offsets, void* out, int B, int Hkv, int G,
                        int S, int P, int NB, float softcap, float scale,
                        cudaStream_t stream) {
  if (ks != nullptr)
    return launch<T, int8_t, D>(q, kp, vp, ks, vs, bt, offsets, out, B, Hkv,
                                G, S, P, NB, softcap, scale, stream);
  return launch<T, T, D>(q, kp, vp, nullptr, nullptr, bt, offsets, out, B,
                         Hkv, G, S, P, NB, softcap, scale, stream);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q and out; fp pools share it).  With
// k_scales/v_scales non-null the pools are int8 with (N, P, Hkv) f32 row
// scales.  offsets: (B,) int32 position of each slot's first query.
// Shape contract (checked by the Python wrapper): D in {64, 128},
// offsets >= 0, block table entries in [0, N), all tensors contiguous.
extern "C" int repro_paged_prefill(int dtype, const void* q, const void* kp,
                                   const void* vp, const float* ks,
                                   const float* vs, const int* bt,
                                   const int* offsets, void* out, int B,
                                   int Hkv, int G, int S, int D, int P,
                                   int NB, float softcap, float scale,
                                   void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0 || B == 0) return (int)cudaSuccess;
  if ((ks == nullptr) != (vs == nullptr)) return (int)cudaErrorInvalidValue;
#define REPRO_PREFILL(T, DD)                                                  \
  return (int)launch_pool<T, DD>(q, kp, vp, ks, vs, bt, offsets, out, B, Hkv, \
                                 G, S, P, NB, softcap, scale, s)
  if (dtype == 0 && D == 64) REPRO_PREFILL(float, 64);
  if (dtype == 0 && D == 128) REPRO_PREFILL(float, 128);
  if (dtype == 1 && D == 64) REPRO_PREFILL(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_PREFILL(__nv_bfloat16, 128);
#undef REPRO_PREFILL
  return (int)cudaErrorInvalidValue;
}
