// Suffix / chunk prefill and speculative-verify attention over the paged
// KV pool, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py,
// paged_prefill_attention_grouped (Pallas body _paged_prefill_kernel), and
// serves the paged verify window, which the JAX package computes with its
// jnp reference on every backend (backend/dispatch.py,
// dispatch_paged_verify_attention -> ref.paged_verify_attention_ref).
// Same function: q (B,Hkv,G,S,D) holds S fresh queries per slot at
// positions offset_b..offset_b+S-1 (their K/V already written into the
// pool); each attends every mapped logical position kpos <= qpos of its
// slot through the block table bt (B,NB) into pools (N,P,Hkv,D); f32
// online softmax, optional softcap.  A prefill passes one offset for
// every slot (offsets null); a verify window passes each slot's position
// with S = K+1.  On int8 pools (scale pointers non-null) every key is
// dequantized inside the kernel, so no dequantized copy of the pool is
// ever made -- the JAX package sends every int8 prefill to its jnp
// reference instead.  The G query heads of one kv head are flattened
// into G*S rows, row r at position offset_b + r % S, so one pass over a
// page serves all of them (the GQA reuse the TPU kernel gets from its
// MXU).
//
// What bounds it on the H100 at the main path's shapes (G=8, D=128,
// Hkv=4, page 16): a prefill of S=256 at offset 256 does 4*D flops for
// each admissible (query, key) pair, 98,432 pairs per query head, ~1.6
// GFLOP against ~2 MB of K/V and queries: 0.0016 ms at the bf16
// tensor-core peak, bound by operations.  A verify window (B=4, S=5,
// offsets 100-1000) has only G*S = 40 rows per (slot, kv head) over up
// to 1,005 keys: ~2.3 MB of int8 K/V and scales against 0.17 GFLOP,
// 0.0008 ms, bound by bytes -- and only 16 (slot, kv head) pairs for
// 132 SMs.
//
// What this design does about it: the bf16 path runs on the tensor
// cores (attn_mma.cuh: mma.sync m16n8k16, ldmatrix, a cp.async ring of
// whole K/V rows, each key's page resolved once per row), one block of
// 128 threads per (slot, kv head, 64 flattened rows, key split).  Keys
// past the block's last query position are never copied and causal
// tiles are masked per element only where they straddle the diagonal.
// For the verify window the host splits the keys (split-KV): at 4 slots
// it launches 8 splits of 128 keys, 128 blocks, and a combine pass
// merges the splits' (m, l, O) rows from a workspace; a split wholly
// past a slot's last key writes m = -inf, l = 0.  The f32 path keeps the
// CUDA-core engine (tile_attention, attn_common.cuh): its callers hold it
// to 2e-5, which neither TF32 nor bf16 tensor cores meet.
#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace repro_torch {
namespace {

// -- f32: the CUDA-core engine ----------------------------------------------

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
                     const int* __restrict__ offsets, int offset0,
                     T* __restrict__ out, int Hkv, int G, int S, int P,
                     int NB, float softcap, float scale) {
  const int rt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int R = G * S;
  const int offset = offsets != nullptr ? offsets[b] : offset0;
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

template <typename TP, int D>
cudaError_t launch_f32(const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* bt,
                       const int* offsets, int offset, void* out, int B,
                       int Hkv, int G, int S, int P, int NB, float softcap,
                       float scale, cudaStream_t stream) {
  const size_t smem = TileSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<float, TP, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((G * S + kBQ - 1) / kBQ, Hkv, B);
  paged_prefill_kernel<float, TP, D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, bt, offsets, offset,
      static_cast<float*>(out), Hkv, G, S, P, NB, softcap, scale);
  return cudaGetLastError();
}

// -- bf16: the tensor-core engine ---------------------------------------------

struct PagedMmaProb {
  const int* bt;     // (NB,) row of this slot
  int P, Hkv, h, S, offset, r0;
  int n_rows, qmin, qmax, t_begin, t_end;
  size_t row0;

  __device__ int qpos(int r) const { return offset + (r0 + r) % S; }
  __device__ size_t kv_row(int t) const {
    return ((size_t)bt[t / P] * P + (t % P)) * Hkv + h;
  }
  __device__ void key_meta(int t, int& kpos, int& kvalid) const {
    kpos = t;
    kvalid = 1;
  }
  __device__ bool admit(int qp, int kpos) const { return kpos <= qp; }
  // keys [t0, t1) lie below t_end <= qmax + 1, so some pair is admissible;
  // every pair is when the tile is whole and ends at or below qmin
  __device__ int tile_class(int t0, int t1) const {
    return (t1 - t0 == mma::kKeys && t1 - 1 <= qmin) ? 2 : 1;
  }
};

template <typename TP, int D>
__global__ void __launch_bounds__(mma::kThreads)
paged_prefill_mma_kernel(const mma::bf16* __restrict__ q,
                         const TP* __restrict__ kp, const TP* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ bt,
                         const int* __restrict__ offsets, int offset0,
                         mma::bf16* __restrict__ out, float* __restrict__ ws_o,
                         float* __restrict__ ws_ml, int Hkv, int G, int S,
                         int P, int NB, int nsplit, int split_keys,
                         float softcap, float scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z / nsplit, z = blockIdx.z % nsplit;
  const int R = G * S;
  PagedMmaProb pb;
  pb.bt = bt + (size_t)b * NB;
  pb.P = P;
  pb.Hkv = Hkv;
  pb.h = h;
  pb.S = S;
  pb.offset = offsets != nullptr ? offsets[b] : offset0;
  pb.r0 = blockIdx.x * mma::kRows;
  pb.n_rows = min(mma::kRows, R - pb.r0);
  pb.row0 = ((size_t)b * Hkv + h) * R + pb.r0;
  // rows r0 .. r0+n_rows-1 sit at offset + r % S
  const int a = pb.r0 % S;
  if (pb.n_rows >= S || a + pb.n_rows > S) {
    pb.qmin = pb.offset;
    pb.qmax = pb.offset + S - 1;
  } else {
    pb.qmin = pb.offset + a;
    pb.qmax = pb.offset + a + pb.n_rows - 1;
  }
  pb.t_begin = z * split_keys;
  pb.t_end = min(min(pb.t_begin + split_keys, NB * P), pb.qmax + 1);
  const size_t rows = (size_t)(gridDim.z / nsplit) * Hkv * R;
  mma::tile_attention_mma<TP, D, false>(pb, q, kp, vp, ks, vs, out, ws_o, ws_ml,
                                 rows, z, scale, softcap);
}

template <typename TP, int D>
cudaError_t launch_mma(const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* bt,
                       const int* offsets, int offset, void* out,
                       float* ws_o, float* ws_ml, int nsplit, int split_keys,
                       int B, int Hkv, int G, int S, int P, int NB,
                       float softcap, float scale, cudaStream_t stream) {
  const int R = G * S;
  dim3 grid((R + mma::kRows - 1) / mma::kRows, Hkv, B * nsplit);
  cudaError_t err = mma::launch_tiles(
      paged_prefill_mma_kernel<TP, D>, mma::MmaSmem<TP, D>::kBytes, grid,
      stream, static_cast<const mma::bf16*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, bt, offsets, offset,
      static_cast<mma::bf16*>(out), nsplit > 1 ? ws_o : nullptr,
      nsplit > 1 ? ws_ml : nullptr, Hkv, G, S, P, NB, nsplit, split_keys,
      softcap, scale);
  if (err != cudaSuccess) return err;
  return mma::launch_combine<D>(ws_o, ws_ml, out, (size_t)B * Hkv * R,
                                nsplit, stream);
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* kp,
                         const void* vp, const float* ks, const float* vs,
                         const int* bt, const int* offsets, int offset,
                         void* out, float* ws_o, float* ws_ml, int nsplit,
                         int split_keys, int B, int Hkv, int G, int S, int P,
                         int NB, float softcap, float scale,
                         cudaStream_t stream) {
  const bool quant = ks != nullptr;
  if (dtype == 0) {
    if (nsplit != 1) return cudaErrorInvalidValue;
    return quant ? launch_f32<int8_t, D>(q, kp, vp, ks, vs, bt, offsets,
                                         offset, out, B, Hkv, G, S, P, NB,
                                         softcap, scale, stream)
                 : launch_f32<float, D>(q, kp, vp, nullptr, nullptr, bt,
                                        offsets, offset, out, B, Hkv, G, S,
                                        P, NB, softcap, scale, stream);
  }
  return quant ? launch_mma<int8_t, D>(q, kp, vp, ks, vs, bt, offsets,
                                       offset, out, ws_o, ws_ml, nsplit,
                                       split_keys, B, Hkv, G, S, P, NB,
                                       softcap, scale, stream)
               : launch_mma<mma::bf16, D>(q, kp, vp, nullptr, nullptr, bt,
                                          offsets, offset, out, ws_o, ws_ml,
                                          nsplit, split_keys, B, Hkv, G, S,
                                          P, NB, softcap, scale, stream);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q and out; fp pools share it).  With
// k_scales/v_scales non-null the pools are int8 with (N, P, Hkv) f32 row
// scales.  offsets: (B,) int32 position of each slot's first query, or
// null for `offset` in every slot.  bf16 only: nsplit key splits of
// split_keys keys each, merged through the f32 workspaces ws_o
// (nsplit, B*Hkv*G*S, D) and ws_ml (nsplit, B*Hkv*G*S, 2) when nsplit > 1
// (f32 takes nsplit = 1).  Shape contract (checked by the Python
// wrapper): D in {64, 128, 256}, offsets >= 0, block table entries in [0, N),
// all tensors contiguous, q and the pools 16-byte aligned.
extern "C" int repro_paged_prefill(int dtype, const void* q, const void* kp,
                                   const void* vp, const float* ks,
                                   const float* vs, const int* bt,
                                   const int* offsets, int offset, void* out,
                                   float* ws_o, float* ws_ml, int nsplit,
                                   int split_keys, int B, int Hkv, int G,
                                   int S, int D, int P, int NB, float softcap,
                                   float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0 || B == 0) return (int)cudaSuccess;
  if ((ks == nullptr) != (vs == nullptr) || (dtype != 0 && dtype != 1) ||
      nsplit < 1 || split_keys < 1 ||
      (nsplit > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
#define REPRO_PREFILL(DD)                                                   \
  return (int)launch_dtype<DD>(dtype, q, kp, vp, ks, vs, bt, offsets,       \
                               offset, out, ws_o, ws_ml, nsplit, split_keys, \
                               B, Hkv, G, S, P, NB, softcap, scale, s)
  if (D == 64) REPRO_PREFILL(64);
  if (D == 128) REPRO_PREFILL(128);
  if (D == 256) REPRO_PREFILL(256);
#undef REPRO_PREFILL
  return (int)cudaErrorInvalidValue;
}
