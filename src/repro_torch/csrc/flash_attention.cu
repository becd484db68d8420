// Dense online-softmax attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bhsd
// (Pallas body _flash_kernel).  Same function: q (B,H,Sq,D) against
// k/v (B,Hkv,Skv,D), GQA through h // (H/Hkv), masks from absolute
// positions -- k_valid, causal rel >= 0, sliding window rel < window --
// optional tanh softcap, f32 softmax, a row with no admissible key -> 0.
//
// What bounds it on the H100: at the main path's shapes (a 100-600 token
// prompt, H=32, D=128) it reads q, k, v and writes o once, a few MB, but
// does 4*D flops for every admissible (query, key) pair; a prompt of 512
// tokens is ~2.1 GFLOP against ~1 MB of bf16 K/V, so it is bound by
// operations (tensor-core bf16 peak), not bytes.
//
// What this design does about it: this first version runs the products
// on the CUDA cores in f32 (see attn_common.cuh): q tiles of 64 rows stay
// in shared memory for the whole key walk, each K/V tile is loaded once per
// block, and fully masked tiles (the upper triangle under causal masking)
// are skipped before they are loaded.  It stays far from the tensor-core
// bound; wgmma tiles fed by TMA are the next step.
#include "attn_common.cuh"

namespace repro_torch {
namespace {

template <typename T>
struct FlashProb {
  const T* q;   // (Sq, D) rows of this (b, h)
  const T* k;   // (Skv, D) rows of this (b, h // groups)
  const T* v;
  T* o;
  const int* q_pos;
  const int* k_pos;
  const int* k_valid;
  int q0, n_rows, n_keys, D, causal, window;

  __device__ const T* q_row(int r) const { return q + (size_t)(q0 + r) * D; }
  __device__ T* o_row(int r) const { return o + (size_t)(q0 + r) * D; }
  __device__ int qpos(int r) const { return q_pos[q0 + r]; }
  __device__ void key_meta(int t, int& kp, int& kv) const {
    kp = k_pos[t];
    kv = k_valid[t];
  }
  __device__ bool admit(int qp, int kp) const {
    const int rel = qp - kp;
    if (causal && rel < 0) return false;
    if (window > 0 && rel >= window) return false;
    return true;
  }
  __device__ void load_kv(int t, int d, float& kx, float& vx) const {
    kx = to_f32(k[(size_t)t * D + d]);
    vx = to_f32(v[(size_t)t * D + d]);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos, const int* __restrict__ k_valid,
             T* __restrict__ out, int H, int Hkv, int Sq, int Skv, int causal,
             int window, float softcap, float scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  FlashProb<T> pb;
  pb.q = q + ((size_t)b * H + h) * Sq * D;
  pb.o = out + ((size_t)b * H + h) * Sq * D;
  pb.k = k + ((size_t)b * Hkv + hk) * Skv * D;
  pb.v = v + ((size_t)b * Hkv + hk) * Skv * D;
  pb.q_pos = q_pos;
  pb.k_pos = k_pos;
  pb.k_valid = k_valid;
  pb.q0 = qt * kBQ;
  pb.n_rows = min(kBQ, Sq - pb.q0);
  pb.n_keys = Skv;
  pb.D = D;
  pb.causal = causal;
  pb.window = window;
  tile_attention<T, D>(pb, scale, softcap);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* k_pos, const int* k_valid,
                   void* out, int B, int H, int Hkv, int Sq, int Skv,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem = TileSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, k_valid, static_cast<T*>(out),
      H, Hkv, Sq, Skv, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  Shape contract (checked by the
// Python wrapper): D in {64, 128}, H % Hkv == 0, all tensors contiguous.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, const int* q_pos,
                                     const int* k_pos, const int* k_valid,
                                     void* out, int B, int H, int Hkv, int Sq,
                                     int Skv, int D, int causal, int window,
                                     float softcap, float scale,
                                     void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || B == 0) return (int)cudaSuccess;
#define REPRO_FLASH(T, DD)                                                  \
  return (int)launch<T, DD>(q, k, v, q_pos, k_pos, k_valid, out, B, H, Hkv, \
                            Sq, Skv, causal, window, softcap, scale, s)
  if (dtype == 0 && D == 64) REPRO_FLASH(float, 64);
  if (dtype == 0 && D == 128) REPRO_FLASH(float, 128);
  if (dtype == 1 && D == 64) REPRO_FLASH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_FLASH(__nv_bfloat16, 128);
#undef REPRO_FLASH
  return (int)cudaErrorInvalidValue;
}
