// Suffix / chunk prefill attention over the paged KV pool, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py,
// paged_prefill_attention_grouped (Pallas body _paged_prefill_kernel).
// Same function: q (B,Hkv,G,S,D) holds S fresh queries at positions
// offset..offset+S-1 (their K/V already written into the pool); each
// attends every mapped logical position kpos <= qpos of its slot through
// the block table bt (B,NB) into pools (N,P,Hkv,D); f32 online softmax,
// optional softcap.  The G query heads of one kv head are flattened into
// G*S rows, row r at position offset + r % S, so one pass over a page
// serves all of them (the GQA reuse the TPU kernel gets from its MXU).
//
// What bounds it on the H100: per admission and layer it must read the
// slot's mapped K/V once (offset+S tokens x Hkv x D x 2 tensors) and the
// queries, and write the output; at the main path's shapes (S=100-600,
// G=8, D=128) that is ~1-3 MB of bf16 against ~4*G*D flops per
// admissible (query, key) pair, ~0.5-3 GFLOP -- bound by operations.
//
// What this design does about it: one block of 128 threads per (slot,
// kv head, 64 flattened rows) walks the logical key positions in tiles of
// 32 (attn_common.cuh), resolving each key's physical page through the
// block table as it stages the tile, so no contiguous K/V copy is ever
// made.  Keys past offset+S-1 are never visited (fully masked), and a
// tile no row of the block may attend is skipped before it is loaded.
// The products run on the CUDA cores in f32; wgmma comes later.
#include "attn_common.cuh"

namespace repro_torch {
namespace {

template <typename T>
struct PagedPrefillProb {
  const T* q;        // (G*S, D) rows of this (b, h)
  T* o;
  const T* kp;       // pools (N, P, Hkv, D)
  const T* vp;
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
  __device__ size_t key_off(int t) const {
    const int page = bt[t / P];
    return (((size_t)page * P + (t % P)) * Hkv + h) * D;
  }
  __device__ const T* k_row(int t) const { return kp + key_off(t); }
  __device__ const T* v_row(int t) const { return vp + key_off(t); }
};

template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ bt,
                     T* __restrict__ out, int Hkv, int G, int S, int P,
                     int NB, int offset, float softcap, float scale) {
  const int rt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int R = G * S;
  PagedPrefillProb<T> pb;
  pb.q = q + ((size_t)b * Hkv + h) * R * D;
  pb.o = out + ((size_t)b * Hkv + h) * R * D;
  pb.kp = kp;
  pb.vp = vp;
  pb.bt = bt + (size_t)b * NB;
  pb.r0 = rt * kBQ;
  pb.n_rows = min(kBQ, R - pb.r0);
  // keys beyond the last query position are fully masked: never visit
  pb.n_keys = min(NB * P, offset + S);
  pb.S = S;
  pb.P = P;
  pb.Hkv = Hkv;
  pb.h = h;
  pb.offset = offset;
  pb.D = D;
  tile_attention<T, D>(pb, scale, softcap);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, void* out, int B, int Hkv, int G, int S,
                   int P, int NB, int offset, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem = TileSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((G * S + kBQ - 1) / kBQ, Hkv, B);
  paged_prefill_kernel<T, D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, static_cast<T*>(out), Hkv, G, S, P, NB,
      offset, softcap, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  Shape contract (checked by the
// Python wrapper): D in {64, 128}, offset >= 0, block table entries in
// [0, N), all tensors contiguous.
extern "C" int repro_paged_prefill(int dtype, const void* q, const void* kp,
                                   const void* vp, const int* bt, void* out,
                                   int B, int Hkv, int G, int S, int D, int P,
                                   int NB, int offset, float softcap,
                                   float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0 || B == 0) return (int)cudaSuccess;
#define REPRO_PREFILL(T, DD)                                                 \
  return (int)launch<T, DD>(q, kp, vp, bt, out, B, Hkv, G, S, P, NB, offset, \
                            softcap, scale, s)
  if (dtype == 0 && D == 64) REPRO_PREFILL(float, 64);
  if (dtype == 0 && D == 128) REPRO_PREFILL(float, 128);
  if (dtype == 1 && D == 64) REPRO_PREFILL(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_PREFILL(__nv_bfloat16, 128);
#undef REPRO_PREFILL
  return (int)cudaErrorInvalidValue;
}
