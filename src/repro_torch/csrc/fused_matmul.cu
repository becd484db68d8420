// Fused matmul + epilogue, Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_matmul.py, matmul_fused (Pallas body
// _mm_kernel, epilogue _epilogue).  Same function: x (M,K) @ w (K,N) with
// an f32 accumulator, then + bias (N,), then gelu (tanh form) / silu /
// relu^2 / none, then one cast to the output dtype (f32 or bf16) and one
// store.  That is SSR's HMM matmul with its reuse-distance-1 ops (bias,
// activation, down-cast) fused into the epilogue, so the f32 product
// never makes a round trip through HBM.
//
// What bounds it on the H100: at a prefill M (512 and up) operations,
// 2*M*N*K at 989 TFLOP/s in bf16 or 67 TFLOP/s in f32 (M=512, K=4096,
// N=11008 in bf16: 0.047 ms); at a decode M (4 slots) bytes, the K*N
// weight read once (90 MB for yi-6b's gate projection: 0.027 ms at
// 3.35 TB/s).
//
// What this design does about it: one block per output tile walks K in a
// loop (the TPU's sequential kb grid axis and its VMEM accumulator become
// a loop and registers), staging x and w tiles through double-buffered
// shared memory with the next tile's loads in flight in registers while
// the current one is multiplied.  bf16 operands go to the tensor cores
// through wmma (16x16x16 bf16 tiles, f32 accumulators; bf16 products are
// exact in f32): 128x128 block tiles of 8 warps at a prefill M, 16x64
// tiles with a deep K step (128) at M <= 16, where the weight read is the
// cost and more blocks keep more of it in flight.  f32 operands use f32
// FMA on the CUDA cores (64x64 tiles, 4x4 outputs a thread), never TF32,
// because the JAX kernel's product is f32.  The epilogue runs on the
// accumulator on chip: bf16 fragments pass through a per-warp 16x16 f32
// staging tile in shared memory (wmma's register layout is opaque), the
// f32 tile applies it in registers.  Ragged M, N and K are masked in the
// loaders and the store, so any M, N, K >= 1 work; 16-byte vector loads
// are used when K and N are multiples of 8 and the operands 16-byte
// aligned.  wgmma/TMA pipelines are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

enum Activation { kNone = 0, kGelu = 1, kSilu = 2, kRelu2 = 3 };

__device__ __forceinline__ float epilogue(float acc, const void* bias,
                                          int bias_bf16, int col, int act) {
  if (bias != nullptr)
    acc += bias_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[col])
                     : static_cast<const float*>(bias)[col];
  if (act == kGelu) {
    const float inner = 0.7978845608028654f * (acc + 0.044715f * acc * acc *
                                               acc);
    acc = 0.5f * acc * (1.f + tanhf(inner));
  } else if (act == kSilu) {
    acc = acc / (1.f + expf(-acc));
  } else if (act == kRelu2) {
    const float r = fmaxf(acc, 0.f);
    acc = r * r;
  }
  return acc;
}

__device__ __forceinline__ void store_out(void* out, int out_bf16,
                                          size_t idx, float v) {
  if (out_bf16)
    static_cast<bf16*>(out)[idx] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[idx] = v;
}

// ---------------------------------------------------------------------------
// bf16: wmma tensor-core tiles
// ---------------------------------------------------------------------------

union Chunk {          // 8 bf16 values (as raw bits), one 16-byte load
  uint4 v;
  unsigned short h[8];
};

// Loads 8 consecutive bf16 of row `row` (of `rows`), columns col..col+7
// (of `cols`), from a row-major (rows, cols) matrix; out of range -> 0.
template <bool VEC>
__device__ __forceinline__ uint4 load_chunk(const bf16* __restrict__ p,
                                            int rows, int cols, int row,
                                            int col) {
  Chunk c;
  c.v = make_uint4(0, 0, 0, 0);
  if (row >= rows) return c.v;
  const bf16* src = p + (size_t)row * cols + col;
  if (VEC) {           // cols % 8 == 0: a chunk is wholly in or out
    if (col < cols) c.v = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < cols)
        c.h[e] = reinterpret_cast<const unsigned short*>(src)[e];
  }
  return c.v;
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
struct TileShape {
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr int LDA = BK + 8, LDB = BN + 8;   // padded, elements
  static constexpr int A_CHUNKS = BM * BK / 8, B_CHUNKS = BK * BN / 8;
  static constexpr int A_PER = (A_CHUNKS + kThreads - 1) / kThreads;
  static constexpr int B_PER = (B_CHUNKS + kThreads - 1) / kThreads;
  static constexpr int A_BYTES = 2 * BM * LDA * 2, B_BYTES = 2 * BK * LDB * 2;
  static constexpr int SMEM = A_BYTES + B_BYTES;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tiles");
  static_assert(WARPS_M * WARPS_N * 1024 <= A_BYTES,
                "the epilogue's staging tiles reuse the A buffers");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
};

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
mm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const void* __restrict__ bias, int bias_bf16,
               void* __restrict__ out, int out_bf16, int M, int N, int K,
               int act) {
  using namespace nvcuda;
  using S = TileShape<BM, BN, BK, WARPS_M, WARPS_N>;
  __shared__ __align__(128) unsigned char smem[S::SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);                 // [2][BM*LDA]
  bf16* Bs = reinterpret_cast<bf16*>(smem + S::A_BYTES);    // [2][BK*LDB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  uint4 ra[S::A_PER], rb[S::B_PER];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int t = 0; t < S::A_PER; ++t) {
      const int c = tid + t * S::kThreads;
      if (c < S::A_CHUNKS)
        ra[t] = load_chunk<VEC>(x, M, K, m0 + c / (BK / 8),
                                k0 + (c % (BK / 8)) * 8);
    }
#pragma unroll
    for (int t = 0; t < S::B_PER; ++t) {
      const int c = tid + t * S::kThreads;
      if (c < S::B_CHUNKS)
        rb[t] = load_chunk<VEC>(w, K, N, k0 + c / (BN / 8),
                                n0 + (c % (BN / 8)) * 8);
    }
  };
  auto store_tiles = [&](int buf) {
    bf16* a = As + buf * BM * S::LDA;
    bf16* b = Bs + buf * BK * S::LDB;
#pragma unroll
    for (int t = 0; t < S::A_PER; ++t) {
      const int c = tid + t * S::kThreads;
      if (c < S::A_CHUNKS)
        *reinterpret_cast<uint4*>(a + (c / (BK / 8)) * S::LDA +
                                  (c % (BK / 8)) * 8) = ra[t];
    }
#pragma unroll
    for (int t = 0; t < S::B_PER; ++t) {
      const int c = tid + t * S::kThreads;
      if (c < S::B_CHUNKS)
        *reinterpret_cast<uint4*>(b + (c / (BN / 8)) * S::LDB +
                                  (c % (BN / 8)) * 8) = rb[t];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[S::FM][S::FN];
#pragma unroll
  for (int i = 0; i < S::FM; ++i)
#pragma unroll
    for (int j = 0; j < S::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int ktiles = (K + BK - 1) / BK;
  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) load_tiles((kt + 1) * BK);   // in flight meanwhile
    const bf16* a = As + buf * BM * S::LDA;
    const bf16* b = Bs + buf * BK * S::LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          af[S::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bfr[S::FN];
#pragma unroll
      for (int i = 0; i < S::FM; ++i)
        wmma::load_matrix_sync(af[i], a + (wm * S::WM + i * 16) * S::LDA + kk,
                               S::LDA);
#pragma unroll
      for (int j = 0; j < S::FN; ++j)
        wmma::load_matrix_sync(bfr[j], b + kk * S::LDB + wn * S::WN + j * 16,
                               S::LDB);
#pragma unroll
      for (int i = 0; i < S::FM; ++i)
#pragma unroll
        for (int j = 0; j < S::FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) store_tiles(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 f32 fragment at a time in its own
  // 1 KB of the (now idle) A buffers, then applies bias, activation and
  // the cast per element and stores it once.
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < S::FM; ++i) {
    const int r0 = m0 + wm * S::WM + i * 16;
#pragma unroll
    for (int j = 0; j < S::FN; ++j) {
      const int c0 = n0 + wn * S::WN + j * 16;
      if (r0 >= M || c0 >= N) continue;          // warp-uniform
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16, c = c0 + e % 16;
        if (r < M && c < N)
          store_out(out, out_bf16, (size_t)r * N + c,
                    epilogue(stage[e], bias, bias_bf16, c, act));
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA tiles (no TF32)
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 64, kF32K = 16, kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const void* __restrict__ bias, int bias_bf16,
              void* __restrict__ out, int out_bf16, int M, int N, int K,
              int act) {
  constexpr int T = kF32Tile, BK = kF32K, PER = T * BK / kF32Threads;
  __shared__ float As[2][BK][T + 4];     // transposed: As[k][m]
  __shared__ float Bs[2][BK][T + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * T, n0 = blockIdx.x * T;
  float ra[PER], rb[PER];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int e = tid + t * kF32Threads;
      const int ar = m0 + e / BK, ac = k0 + e % BK;
      ra[t] = (ar < M && ac < K) ? x[(size_t)ar * K + ac] : 0.f;
      const int br = k0 + e / T, bc = n0 + e % T;
      rb[t] = (br < K && bc < N) ? w[(size_t)br * N + bc] : 0.f;
    }
  };
  auto store_tiles = [&](int buf) {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int e = tid + t * kF32Threads;
      As[buf][e % BK][e / BK] = ra[t];
      Bs[buf][e / T][e % T] = rb[t];
    }
  };
  float acc[4][4] = {};
  const int ktiles = (K + BK - 1) / BK;
  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) load_tiles((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[buf][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[buf][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) store_tiles(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N)
        store_out(out, out_bf16, (size_t)r * N + c,
                  epilogue(acc[i][j], bias, bias_bf16, c, act));
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
cudaError_t launch_bf16(const bf16* x, const bf16* w, const void* bias,
                        int bias_bf16, void* out, int out_bf16, int M, int N,
                        int K, int act, bool vec, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  constexpr int threads = WARPS_M * WARPS_N * 32;
  if (vec)
    mm_bf16_kernel<BM, BN, BK, WARPS_M, WARPS_N, true>
        <<<grid, threads, 0, stream>>>(x, w, bias, bias_bf16, out, out_bf16,
                                       M, N, K, act);
  else
    mm_bf16_kernel<BM, BN, BK, WARPS_M, WARPS_N, false>
        <<<grid, threads, 0, stream>>>(x, w, bias, bias_bf16, out, out_bf16,
                                       M, N, K, act);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (x and w); bias: (N,) or null, bias_dtype
// 0 float32 / 1 bfloat16; out (M, N), out_dtype 0 float32 / 1 bfloat16;
// act: 0 none, 1 gelu (tanh), 2 silu, 3 relu2.  Shape contract (checked
// by the Python wrapper): x (M,K) and w (K,N) contiguous row-major on one
// device, M, N, K >= 1, ceil(M / 64) <= 65,535.
extern "C" int repro_matmul_fused(int dtype, const void* x, const void* w,
                                  const void* bias, int bias_dtype, void* out,
                                  int out_dtype, int M, int N, int K, int act,
                                  void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
    mm_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        bias_dtype, out, out_dtype, M, N, K, act);
    return (int)cudaGetLastError();
  }
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  if (M <= 16)         // decode: weight-read bound, many narrow blocks
    return (int)launch_bf16<16, 64, 128, 1, 4>(xb, wb, bias, bias_dtype, out,
                                               out_dtype, M, N, K, act, vec,
                                               s);
  return (int)launch_bf16<128, 128, 32, 2, 4>(xb, wb, bias, bias_dtype, out,
                                              out_dtype, M, N, K, act, vec, s);
}
