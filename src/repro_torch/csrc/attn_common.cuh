// Shared pieces of the port's attention kernels (sm_90a, plain CUDA cores).
//
// Activation types are float and __nv_bfloat16; paged KV pools hold the
// activation type or int8 with one f32 scale per (row, kv head).  Every
// kernel computes in f32.  The C entry points take a dtype code (0 =
// float32, 1 = bfloat16) for the activations, a null or non-null scale
// pointer for the pools, launch on the caller's stream, allocate nothing,
// and return cudaGetLastError().
//
// tile_attention() is the online-softmax engine behind flash_attention.cu
// and paged_prefill.cu: one block of 128 threads owns BQ = 64 query rows,
// two threads per row.  The block walks the keys in tiles of BK = 32: it
// stages the tile's K and V in shared memory as f32 (int8 pools are
// dequantized here, one row scale per key), each thread scores its
// row against its half of the tile's keys, the pair exchanges its row max
// and row sum with one shuffle, and each thread accumulates half of the
// row's output columns (interleaved, so the two threads of a pair read
// neighbouring banks).  Masked keys contribute an exact 0, so a row with
// no admissible key ends with l == 0 and writes 0, as the plain versions
// do.  A key tile in which no row of the block has an admissible key is
// skipped before its K/V are loaded (causal and paged prefill skip about
// half of all tiles this way).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// One pool element in f32: fp pools as stored, int8 pools times the row
// scale (one rounding, as the plain version's ``q.float() * scale``).
template <typename TP>
__device__ __forceinline__ float pool_f32(TP x, float scale) {
  return to_f32(x);
}
template <>
__device__ __forceinline__ float pool_f32<int8_t>(int8_t x, float scale) {
  return __fmul_rn((float)x, scale);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float apply_softcap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kTileThreads = 128;

template <int D>
struct TileSmem {
  static constexpr int kQStride = D + 1;   // padded: conflict-free row reads
  static constexpr int kKStride = D + 1;
  static constexpr int kPStride = kBK + 1;
  static constexpr size_t kFloats = (size_t)kBQ * kQStride +
                                    (size_t)kBK * kKStride + (size_t)kBK * D +
                                    (size_t)kBQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float) + 2 * kBK * sizeof(int);
};

// Prob supplies, for the block it was built for:
//   int n_rows, n_keys;                       valid rows in the tile, keys to walk
//   const T* q_row(int r); T* o_row(int r);  row pointers (r < n_rows)
//   int qpos(int r);                          absolute position of row r
//   void key_meta(int t, int& kpos, int& kvalid);
//   bool admit(int qpos, int kpos);           mask beyond k_valid
//   void load_kv(int t, int d, float& k, float& v);  element d of key t, f32
template <typename T, int D, typename Prob>
__device__ __forceinline__ void tile_attention(const Prob& pb, float scale,
                                               float softcap) {
  extern __shared__ float smem[];
  using S = TileSmem<D>;
  float* Qs = smem;
  float* Ks = Qs + kBQ * S::kQStride;
  float* Vs = Ks + kBK * S::kKStride;
  float* Ps = Vs + kBK * D;
  int* kpos_s = reinterpret_cast<int*>(Ps + kBQ * S::kPStride);
  int* kval_s = kpos_s + kBK;

  constexpr int kHalfK = kBK / 2;
  constexpr int kCols = D / 2;
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const bool row_ok = r < pb.n_rows;
  const int qp = row_ok ? pb.qpos(r) : 0;

  for (int idx = tid; idx < kBQ * D; idx += kTileThreads) {
    const int rr = idx / D, d = idx - (idx / D) * D;
    Qs[rr * S::kQStride + d] = rr < pb.n_rows ? to_f32(pb.q_row(rr)[d]) : 0.f;
  }
  float o[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) o[i] = 0.f;
  float m = kNegInf, l = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < pb.n_keys; t0 += kBK) {
    if (tid < kBK) {
      const int t = t0 + tid;
      int kp = 0, kv = 0;
      if (t < pb.n_keys) pb.key_meta(t, kp, kv);
      kpos_s[tid] = kp;
      kval_s[tid] = kv;
    }
    __syncthreads();
    unsigned okm = 0u;
    if (row_ok) {
#pragma unroll
      for (int jj = 0; jj < kHalfK; ++jj) {
        const int j = half * kHalfK + jj;
        if (kval_s[j] != 0 && pb.admit(qp, kpos_s[j])) okm |= 1u << jj;
      }
    }
    if (!__syncthreads_or(okm != 0u)) continue;  // whole tile masked

    for (int idx = tid; idx < kBK * D; idx += kTileThreads) {
      const int j = idx / D, d = idx - (idx / D) * D;
      const int t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < pb.n_keys) pb.load_kv(t, d, kx, vx);
      Ks[j * S::kKStride + d] = kx;
      Vs[j * D + d] = vx;
    }
    __syncthreads();

    float s[kHalfK];
#pragma unroll
    for (int jj = 0; jj < kHalfK; ++jj) s[jj] = 0.f;
    const float* qrow = Qs + r * S::kQStride;
    const float* kbase = Ks + half * kHalfK * S::kKStride;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int jj = 0; jj < kHalfK; ++jj)
        s[jj] = fmaf(qd, kbase[jj * S::kKStride + d], s[jj]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kHalfK; ++jj) {
      if ((okm >> jj) & 1u) {
        s[jj] = apply_softcap(s[jj] * scale, softcap);
        mx = fmaxf(mx, s[jj]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = (m_new == kNegInf) ? 1.f : expf(m - m_new);
    float psum = 0.f;
    float* prow_w = Ps + r * S::kPStride + half * kHalfK;
#pragma unroll
    for (int jj = 0; jj < kHalfK; ++jj) {
      const float p = ((okm >> jj) & 1u) ? expf(s[jj] - m_new) : 0.f;
      prow_w[jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(kFull, psum, 1);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[i] *= alpha;
    __syncthreads();  // the pair's probabilities are in Ps

    const float* prow = Ps + r * S::kPStride;
    for (int j = 0; j < kBK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * D + half;
#pragma unroll
      for (int i = 0; i < kCols; ++i) o[i] = fmaf(p, vrow[2 * i], o[i]);
    }
    __syncthreads();  // the next tile overwrites Ks, Vs, Ps
  }

  if (row_ok) {
    T* orow = pb.o_row(r);
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      orow[2 * i + half] = from_f32<T>(l > 0.f ? o[i] / l : 0.f);
  }
}

}  // namespace repro_torch
