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
// does 4*D flops for every admissible (query, key) pair; a causal prompt
// of 512 tokens is ~2.2 GFLOP against ~9 MB of bf16 q, k, v and o:
// 0.0028 ms at 3.35 TB/s against 0.0022 ms at the bf16 tensor-core peak,
// so both limits sit within 1.3x of each other and the kernel must keep
// the tensor cores fed from a single read of K/V per (query tile, head).
//
// What this design does about it: the bf16 path runs on the tensor
// cores (attn_mma.cuh): one block of 128 threads per (64 query rows,
// head, key split) keeps its Q tile in registers as mma.sync A fragments
// and streams 64-key K/V tiles through a two-stage cp.async ring; each
// tile's k_pos/k_valid are staged beside it.  The softmax probabilities
// enter P V as two bf16 parts (hi + lo, two products into one f32
// accumulator), because the Pallas kernel and its ref keep P in f32: a
// single bf16 rounding of P would add its own error to the output's.
// A tile that no row of the
// block may attend (past the causal diagonal, outside the window, all
// keys invalid) is skipped before it is copied, and a tile whose every
// pair is admissible takes no per-element mask.  When the (query tile,
// head) blocks are too few for the card the host splits the keys and a
// combine pass merges the splits (none at the main path's shapes: 256
// blocks at 512 tokens).  At head_dim 256 (gemma2) the Q fragments are
// read from shared memory a k-step at a time (attn_mma.cuh), so that
// the 16 x 256 f32 O accumulator fits the registers beside S and P;
// the window then bounds each query tile's key range, and tiles outside
// it are skipped.  The paper's ViTs bring head dims 40 (DeiT-160) and
// 60 (LV-ViT-T), which no mma k-step divides: the bf16 tile is built at
// 48 and 64 columns with the true width as the global row stride
// (attn_mma.cuh, "Head dims 40 and 60"), and the f32 tile at the true
// width.  Those encoders run non-causal at Sq = Skv = 197: 4 query tiles
// of 64 rows, the last holding 5, every key tile admissible (no
// per-element mask).  The f32 path keeps the CUDA-core engine
// (tile_attention, attn_common.cuh): its callers hold it to 2e-5, which
// neither TF32 nor bf16 tensor cores meet.
#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace repro_torch {
namespace {

// -- f32: the CUDA-core engine ----------------------------------------------

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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* q_pos, const int* k_pos, const int* k_valid,
                       void* out, int B, int H, int Hkv, int Sq, int Skv,
                       int causal, int window, float softcap, float scale,
                       cudaStream_t stream) {
  const size_t smem = TileSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<float, D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_pos, k_pos, k_valid,
      static_cast<float*>(out), H, Hkv, Sq, Skv, causal, window, softcap,
      scale);
  return cudaGetLastError();
}

// -- bf16: the tensor-core engine ---------------------------------------------

struct FlashMmaProb {
  const int* q_pos;    // (Sq,)
  const int* k_pos;    // (Skv,)
  const int* k_valid;
  int q0, causal, window;
  int n_rows, qmin, qmax, t_begin, t_end;
  size_t row0;

  __device__ int qpos(int r) const { return q_pos[q0 + r]; }
  __device__ size_t kv_row(int t) const { return (size_t)t; }
  __device__ void key_meta(int t, int& kp, int& kv) const {
    kp = k_pos[t];
    kv = k_valid[t] != 0;
  }
  __device__ bool admit(int qp, int kp) const {
    const long long rel = (long long)qp - kp;
    if (causal && rel < 0) return false;
    if (window > 0 && rel >= window) return false;
    return true;
  }
  // bounds over the tile's valid keys against the block's query positions;
  // every warp computes the same answer from the same loads
  __device__ int tile_class(int t0, int t1) const {
    const int lane = threadIdx.x & 31;
    int kmin = INT_MAX, kmax = INT_MIN;
    bool all = true, any = false;
#pragma unroll
    for (int i = 0; i < mma::kKeys / 32; ++i) {
      const int t = t0 + lane + 32 * i;
      const bool ok = t < t1 && k_valid[t] != 0;
      all = all && ok;
      if (ok) {
        const int kp = k_pos[t];
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
        any = true;
      }
    }
    if (!__any_sync(kFull, any)) return 0;
    all = __all_sync(kFull, all);
    kmin = __reduce_min_sync(kFull, kmin);
    kmax = __reduce_max_sync(kFull, kmax);
    if (causal && kmin > qmax) return 0;
    if (window > 0 && (long long)qmin - kmax >= window) return 0;
    const bool every = all && (!causal || kmax <= qmin) &&
                       (window <= 0 || (long long)qmax - kmin < window);
    return every ? 2 : 1;
  }
};

// D: the tile's width; DG: the true head dim (D = 48 for 40, 64 for 60)
template <int D, int DG>
__global__ void __launch_bounds__(mma::kThreads)
flash_mma_kernel(const mma::bf16* __restrict__ q,
                 const mma::bf16* __restrict__ k,
                 const mma::bf16* __restrict__ v,
                 const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                 const int* __restrict__ k_valid, mma::bf16* __restrict__ out,
                 float* __restrict__ ws_o, float* __restrict__ ws_ml, int H,
                 int Hkv, int Sq, int Skv, int causal, int window, int nsplit,
                 int split_keys, float softcap, float scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z / nsplit, z = blockIdx.z % nsplit;
  const int hk = h / (H / Hkv);
  FlashMmaProb pb;
  pb.q_pos = q_pos;
  pb.k_pos = k_pos;
  pb.k_valid = k_valid;
  pb.causal = causal;
  pb.window = window;
  pb.q0 = blockIdx.x * mma::kRows;
  pb.n_rows = min(mma::kRows, Sq - pb.q0);
  pb.row0 = ((size_t)b * H + h) * Sq + pb.q0;
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = threadIdx.x & 31; r < pb.n_rows; r += 32) {
    const int p = q_pos[pb.q0 + r];
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
  pb.qmin = __reduce_min_sync(kFull, qmin);
  pb.qmax = __reduce_max_sync(kFull, qmax);
  pb.t_begin = z * split_keys;
  pb.t_end = min(pb.t_begin + split_keys, Skv);
  const size_t kv = ((size_t)b * Hkv + hk) * Skv * DG;
  const size_t rows = (size_t)(gridDim.z / nsplit) * H * Sq;
  mma::tile_attention_mma<mma::bf16, D, true, FlashMmaProb, DG>(
      pb, q, k + kv, v + kv, nullptr, nullptr, out, ws_o, ws_ml, rows, z,
      scale, softcap);
}

template <int D, int DG = D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* q_pos, const int* k_pos, const int* k_valid,
                       void* out, float* ws_o, float* ws_ml, int nsplit,
                       int split_keys, int B, int H, int Hkv, int Sq, int Skv,
                       int causal, int window, float softcap, float scale,
                       cudaStream_t stream) {
  dim3 grid((Sq + mma::kRows - 1) / mma::kRows, H, B * nsplit);
  cudaError_t err = mma::launch_tiles(
      flash_mma_kernel<D, DG>, mma::MmaSmem<mma::bf16, D>::kBytes, grid,
      stream,
      static_cast<const mma::bf16*>(q), static_cast<const mma::bf16*>(k),
      static_cast<const mma::bf16*>(v), q_pos, k_pos, k_valid,
      static_cast<mma::bf16*>(out), nsplit > 1 ? ws_o : nullptr,
      nsplit > 1 ? ws_ml : nullptr, H, Hkv, Sq, Skv, causal, window, nsplit,
      split_keys, softcap, scale);
  if (err != cudaSuccess) return err;
  return mma::launch_combine<DG>(ws_o, ws_ml, out, (size_t)B * H * Sq,
                                 nsplit, stream);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  bf16 only: nsplit key splits of
// split_keys keys each, merged through the f32 workspaces ws_o
// (nsplit, B*H*Sq, D) and ws_ml (nsplit, B*H*Sq, 2) when nsplit > 1 (f32
// takes nsplit = 1).  Shape contract (checked by the Python wrapper): D in
// {40, 60, 64, 128, 256}, H % Hkv == 0, all tensors contiguous, q, k and v
// 16-byte aligned.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, const int* q_pos,
                                     const int* k_pos, const int* k_valid,
                                     void* out, float* ws_o, float* ws_ml,
                                     int nsplit, int split_keys, int B, int H,
                                     int Hkv, int Sq, int Skv, int D,
                                     int causal, int window, float softcap,
                                     float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || B == 0) return (int)cudaSuccess;
  if ((dtype != 0 && dtype != 1) || nsplit < 1 || split_keys < 1 ||
      (dtype == 0 && nsplit != 1) ||
      (nsplit > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
// DD: the head dim; DP: the bf16 tile's width
#define REPRO_FLASH(DD, DP)                                                  \
  return (int)(dtype == 0                                                    \
                   ? launch_f32<DD>(q, k, v, q_pos, k_pos, k_valid, out, B,  \
                                    H, Hkv, Sq, Skv, causal, window,         \
                                    softcap, scale, s)                       \
                   : launch_mma<DP, DD>(q, k, v, q_pos, k_pos, k_valid, out, \
                                        ws_o, ws_ml, nsplit, split_keys, B,  \
                                        H, Hkv, Sq, Skv, causal, window,     \
                                        softcap, scale, s))
  if (D == 40) REPRO_FLASH(40, 48);
  if (D == 60) REPRO_FLASH(60, 64);
  if (D == 64) REPRO_FLASH(64, 64);
  if (D == 128) REPRO_FLASH(128, 128);
  if (D == 256) REPRO_FLASH(256, 256);
#undef REPRO_FLASH
  return (int)cudaErrorInvalidValue;
}
