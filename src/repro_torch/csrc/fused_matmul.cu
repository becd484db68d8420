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
// What this design does about it: the wrapper picks one of five paths
// from shapes and alignment alone (kernels/fused_matmul.py, matmul_plan),
// each of which applies the epilogue on the accumulator, on chip:
//
//   * wgmma (bf16, M > 16, K and N multiples of 8, 16-byte aligned
//     operands): 128 x 128 output tiles, one block each, rastered so that
//     the blocks sharing a weight column run together (the weight is read
//     from HBM about once).  A producer warp keeps a six-stage ring of
//     128 x 64 x tiles and 64 x 128 w tiles full with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion); two
//     consumer warpgroups each run wgmma m64n128k16 on their 64 rows
//     straight from shared memory (x K-major; w N-major through the
//     descriptor's transpose bit), f32 accumulators in registers, one
//     wgmma group kept in flight while the previous stage is released.
//     The epilogue reads the documented accumulator layout in registers.
//   * split_k (bf16, M <= 16, same alignment): the cost is the K x N
//     weight read.  Blocks of 256 columns x a K range stream their
//     weight rows (and the matching x columns) through a four-stage
//     cp.async ring in 16-byte loads, several blocks an SM; with more
//     than one split, f32 partials go to a workspace and one reduce pass
//     sums them in split order (deterministic, no atomics), then applies
//     the epilogue and the cast.
//   * fma_tile (f32, same alignment): CUDA-core FMA, never TF32, because
//     the JAX kernel's product is f32: 128 x 128 tiles, 8 x 8 outputs a
//     thread, 32-deep K steps through a three-stage cp.async ring,
//     16-byte shared-memory reads.
//   * wmma (bf16) and fma (f32): any other shape -- K or N not a
//     multiple of 8, or misaligned operands -- with masked loads: wmma
//     16x16x16 tensor-core tiles (16x64 at M <= 16, 128x128 above) with
//     register-staged double buffering, and 64 x 64 FMA tiles.
#include <cuda.h>            // CUtensorMap and its enums (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "attn_mma.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

enum Activation { kNone = 0, kGelu = 1, kSilu = 2, kRelu2 = 3 };

// bias[col] in f32 (0 without a bias)
__device__ __forceinline__ float bias_at(const void* bias, int bias_bf16,
                                         int col) {
  if (bias == nullptr) return 0.f;
  return bias_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[col])
                   : static_cast<const float*>(bias)[col];
}

__device__ __forceinline__ float activate(float acc, int act) {
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

__device__ __forceinline__ float epilogue(float acc, const void* bias,
                                          int bias_bf16, int col, int act) {
  if (bias != nullptr) acc += bias_at(bias, bias_bf16, col);
  return activate(acc, act);
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

// ---------------------------------------------------------------------------
// shared pieces of the fast paths
// ---------------------------------------------------------------------------

using mma::cp_async16;   // the attention engine's cp.async helpers
using mma::cp_commit;
using mma::cp_wait;
using mma::smem_u32;

// two neighbouring outputs (c, c + 1) of row r: + their bias (ba, bb,
// loaded ahead), the activation, one cast, one store
__device__ __forceinline__ void store_pair(void* out, int out_bf16, int N,
                                           int r, int c, float a, float b,
                                           float ba, float bb, int act) {
  a = activate(a + ba, act);
  b = activate(b + bb, act);
  const size_t idx = (size_t)r * N + c;
  if (out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + idx) =
        __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
        make_float2(a, b);
}

// ---------------------------------------------------------------------------
// bf16, M > 16: TMA ring + wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64, kStages = 6;
constexpr int kConsumers = 2;                     // warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kATile = BM * BK * 2;               // 16 KB, 128 B rows
constexpr int kBSub = BK * 64 * 2;                // one 64-column slab
constexpr int kBTile = (BN / 64) * kBSub;
constexpr int kStage = kATile + kBTile;
constexpr size_t kSmem = 1024 + (size_t)kStages * kStage + 2 * kStages * 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box of the 2-D tensor map at (c0 innermost, c1) -> dst, completion on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, the warpgroup's accumulator fragment) += A (64 x 16,
// K-major, 128-byte swizzle) * B (16 x 128, N-major: transposed,
// 128-byte swizzle), both read from shared memory through descriptors.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Block (m tile, n tile): rows m0 .. m0+127 of x, columns n0 .. n0+127 of
// w.  Stage s holds the x tile (128 rows of 64 K, 128 bytes each) and the
// w tile as two 64-column slabs (64 K rows of 128 bytes), all swizzled by
// TMA in 1024-byte atoms; out-of-range rows and columns arrive as zeros.
__global__ void __launch_bounds__(kThreads, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_w,
                const void* __restrict__ bias, int bias_bf16,
                void* __restrict__ out, int out_bf16, int M, int N, int K,
                int act) {
  extern __shared__ unsigned char smem_wg[];
  const uint32_t raw = smem_u32(smem_wg);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's atoms
  const uint32_t full = base + kStages * kStage;  // kStages mbarriers
  const uint32_t empty = full + kStages * 8;
  const int tid = threadIdx.x, wgi = tid / 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ktiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == kConsumers) {                        // the producer
    if (tid == kConsumers * 128) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, ((kt / kStages) - 1) & 1);
        const uint32_t st = base + s * kStage;
        mbar_expect_tx(full + 8 * s, kStage);
        tma_load(st, &tm_x, kt * BK, m0, full + 8 * s);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(st + kATile + j * kBSub, &tm_w, n0 + 64 * j, kt * BK,
                   full + 8 * s);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int c0 = n0 + 2 * (lane % 4);
  float bv[BN / 8][2];                 // the thread's columns' bias, early
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j;
    bv[j][0] = c < N ? bias_at(bias, bias_bf16, c) : 0.f;
    bv[j][1] = c < N ? bias_at(bias, bias_bf16, c + 1) : 0.f;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t st = base + s * kStage;
    fence_operands(acc);
    fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: this warpgroup's 64 rows, K step kk (32 bytes into each row);
      // B: K rows 16kk .. 16kk+15 (two 8-row atoms), both slabs
      const uint64_t da = desc(st + wgi * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = desc(st + kATile + kk * 16 * 128, kBSub, 1024);
      wgmma_m64n128k16(acc, da, db);
    }
    commit();
    wait<1>();                         // the previous stage's group is done
    fence_operands(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  wait<0>();
  fence_operands(acc);

  // accumulator layout: register 4j + e of a thread holds row
  // 16 * (warp % 4) + lane / 4 (+ 8 for e >= 2), column 8j + 2 (lane % 4)
  // (+ 1 for odd e) of the warpgroup's 64 x 128 tile
  const int r0 = m0 + wgi * 64 + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j;
    if (c >= N) continue;              // N is even: c + 1 < N too
    if (r0 < M)
      store_pair(out, out_bf16, N, r0, c, acc[4 * j], acc[4 * j + 1],
                 bv[j][0], bv[j][1], act);
    if (r0 + 8 < M)
      store_pair(out, out_bf16, N, r0 + 8, c, acc[4 * j + 2],
                 acc[4 * j + 3], bv[j][0], bv[j][1], act);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point so that the library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) bf16 matrix in boxes of 64 columns x box_rows
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const bf16* x, const bf16* w, const void* bias,
                   int bias_bf16, void* out, int out_bf16, int M, int N,
                   int K, int act, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w;
  if (!make_map(&tm_x, x, M, K, BM) || !make_map(&tm_w, w, K, N, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  mm_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(
      tm_x, tm_w, bias, bias_bf16, out, out_bf16, M, N, K, act);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16, M <= 16: split-K weight streaming
// ---------------------------------------------------------------------------

namespace sk {

constexpr int kCols = 256;          // columns a block: 32 lanes x 8
constexpr int kRows = 32;           // weight rows a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int MR>
struct Smem {
  static constexpr int kW = kRows * kCols * 2;    // 16 KB of weight rows
  static constexpr int kX = MR * kRows * 2;       // x[m][32 rows] in bf16
  static constexpr int kStage = kW + kX;
  static constexpr size_t kBytes = (size_t)kStages * kStage;
  static_assert(kWarps * kCols * 4 <= kBytes, "the reduction reuses the ring");
};

// Block (column block, split z): columns n0 .. n0+255, weight rows
// [z * split_rows, +split_rows) of K.  Warp w takes the stage's rows
// w, w + 8, ..; a lane holds 8 columns (one 16-byte chunk) for all MR
// rows of x.  splits == 1: the epilogue here; else f32 partials to
// ws[z][m][n].
template <int MR>
__global__ void __launch_bounds__(kThreads)
mm_split_k_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const void* __restrict__ bias, int bias_bf16,
                  void* __restrict__ out, int out_bf16,
                  float* __restrict__ ws, int M, int N, int K,
                  int split_rows, int act) {
  using S = Smem<MR>;
  extern __shared__ __align__(16) unsigned char smem_sk[];
  const uint32_t sbase = smem_u32(smem_sk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kCols, z = blockIdx.y;
  const int k_lo = z * split_rows, k_hi = min(k_lo + split_rows, K);
  const int nst = (k_hi - k_lo + kRows - 1) / kRows;

  auto issue = [&](int i) {
    if (i < nst) {
      const int k0 = k_lo + i * kRows;
      const uint32_t st = sbase + (i % kStages) * S::kStage;
      // weight rows: 32 rows x 32 chunks
#pragma unroll
      for (int u = 0; u < kRows * kCols / 8 / kThreads; ++u) {
        const int c = tid + u * kThreads;
        const int r = c / (kCols / 8), cc = c % (kCols / 8);
        const int k = k0 + r, n = n0 + cc * 8;
        const bool ok = k < k_hi && n < N;
        cp_async16(st + r * kCols * 2 + cc * 16,
                   w + (ok ? (size_t)k * N + n : 0), ok);
      }
      // x[m][k0 .. k0+31]: 4 chunks a row
      if (tid < MR * (kRows / 8)) {
        const int m = tid / (kRows / 8), cc = tid % (kRows / 8);
        const int k = k0 + cc * 8;
        const bool ok = m < M && k < k_hi;
        cp_async16(st + S::kW + m * kRows * 2 + cc * 16,
                   x + (ok ? (size_t)m * K + k : 0), ok);
      }
    }
    cp_commit();
  };

  float acc[MR][8];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < nst; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();                 // stage i landed; stage i-1 is free
    issue(i + kStages - 1);
    const unsigned char* st = smem_sk + (i % kStages) * S::kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(st + S::kW);
#pragma unroll
    for (int rr = 0; rr < kRows / kWarps; ++rr) {
      const int r = warp + rr * kWarps;
      union {
        uint4 v;
        __nv_bfloat162 h[4];
      } wv;
      wv.v = *reinterpret_cast<const uint4*>(st + r * kCols * 2 + lane * 16);
      float wf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(wv.h[e]);
        wf[2 * e] = f.x;
        wf[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xm = __bfloat162float(xs[m * kRows + r]);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[m][e] = fmaf(xm, wf[e], acc[m][e]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the 8 warps' partial sums, one row of x at a time
  float* red = reinterpret_cast<float*>(smem_sk);     // [warp][256]
  const int n = n0 + tid;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m >= M) break;                                // block-uniform
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp * kCols + lane * 8 + e] = acc[m][e];
    __syncthreads();
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) v += red[u * kCols + tid];
    if (n < N) {
      if (gridDim.y == 1)
        store_out(out, out_bf16, (size_t)m * N + n,
                  epilogue(v, bias, bias_bf16, n, act));
      else
        ws[((size_t)z * M + m) * N + n] = v;
    }
    __syncthreads();
  }
}

// out[m][n] = epilogue(sum over z of ws[z][m][n], in split order)
__global__ void __launch_bounds__(256)
mm_split_k_reduce(const float* __restrict__ ws, const void* __restrict__ bias,
                  int bias_bf16, void* __restrict__ out, int out_bf16, int M,
                  int N, int splits, int act) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (idx >= total) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[(size_t)z * total + idx];
  store_out(out, out_bf16, idx,
            epilogue(v, bias, bias_bf16, (int)(idx % N), act));
}

template <int MR>
cudaError_t launch_mr(const bf16* x, const bf16* w, const void* bias,
                      int bias_bf16, void* out, int out_bf16, float* ws,
                      int M, int N, int K, int splits, int split_rows,
                      int act, cudaStream_t stream) {
  constexpr size_t smem = Smem<MR>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mm_split_k_kernel<MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kCols - 1) / kCols, splits);
  mm_split_k_kernel<MR><<<grid, kThreads, smem, stream>>>(
      x, w, bias, bias_bf16, out, out_bf16, ws, M, N, K, split_rows, act);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)M * N;
  mm_split_k_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      ws, bias, bias_bf16, out, out_bf16, M, N, splits, act);
  return cudaGetLastError();
}

cudaError_t launch(const bf16* x, const bf16* w, const void* bias,
                   int bias_bf16, void* out, int out_bf16, float* ws, int M,
                   int N, int K, int splits, int split_rows, int act,
                   cudaStream_t stream) {
#define REPRO_SPLIT_K(MR)                                                   \
  if (M <= MR)                                                              \
  return launch_mr<MR>(x, w, bias, bias_bf16, out, out_bf16, ws, M, N, K,   \
                       splits, split_rows, act, stream)
  REPRO_SPLIT_K(1);
  REPRO_SPLIT_K(2);
  REPRO_SPLIT_K(4);
  REPRO_SPLIT_K(8);
  REPRO_SPLIT_K(16);
#undef REPRO_SPLIT_K
  return cudaErrorInvalidValue;
}

}  // namespace sk

// ---------------------------------------------------------------------------
// f32, aligned: 128 x 128 CUDA-core tiles, cp.async ring
// ---------------------------------------------------------------------------

namespace ft {

constexpr int BM = 128, BN = 128, BK = 32, kStages = 3, kThreads = 256;
constexpr int kLdA = BK + 4;         // x rows padded: rows ty, ty + 1 of a
                                     // warp's reads sit 4 banks apart
constexpr int kA = BM * kLdA * 4;    // x tile, [m][32 (+4)]
constexpr int kB = BK * BN * 4;      // w tile, [k][128]
constexpr int kStage = kA + kB;
constexpr size_t kSmem = (size_t)kStages * kStage;

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i < 8) and
// columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3: per 4-deep K
// step it reads 8 float4 of x and 8 float4 of w for 256 FMAs.
__global__ void __launch_bounds__(kThreads)
mm_fma_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const void* __restrict__ bias, int bias_bf16,
                   void* __restrict__ out, int out_bf16, int M, int N, int K,
                   int act) {
  extern __shared__ __align__(16) unsigned char smem_ft[];
  const uint32_t sbase = smem_u32(smem_ft);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  auto issue = [&](int kt) {
    if (kt < ktiles) {
      const int k0 = kt * BK;
      const uint32_t st = sbase + (kt % kStages) * kStage;
#pragma unroll
      for (int u = 0; u < BM * BK / 4 / kThreads; ++u) {   // x: 128 x 8
        const int c = tid + u * kThreads;
        const int r = c / (BK / 4), cc = c % (BK / 4);
        const int m = m0 + r, k = k0 + cc * 4;
        const bool ok = m < M && k < K;
        cp_async16(st + r * kLdA * 4 + cc * 16,
                   x + (ok ? (size_t)m * K + k : 0), ok);
      }
#pragma unroll
      for (int u = 0; u < BK * BN / 4 / kThreads; ++u) {   // w: 32 x 32
        const int c = tid + u * kThreads;
        const int r = c / (BN / 4), cc = c % (BN / 4);
        const int k = k0 + r, n = n0 + cc * 4;
        const bool ok = k < K && n < N;
        cp_async16(st + kA + r * BN * 4 + cc * 16,
                   w + (ok ? (size_t)k * N + n : 0), ok);
      }
    }
    cp_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) issue(kt);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    issue(kt + kStages - 1);
    const unsigned char* st = smem_ft + (kt % kStages) * kStage;
    const float* as = reinterpret_cast<const float*>(st);
    const float* bs = reinterpret_cast<const float*>(st + kA);
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kLdA +
                                                k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bs + (k4 + kk) * BN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(
            bs + (k4 + kk) * BN + 64 + 4 * tx);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                                            : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();

  float bv[8];                         // the thread's columns' bias
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + 64 * (j / 4) + 4 * tx + j % 4;
    bv[j] = c < N ? bias_at(bias, bias_bf16, c) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 64 * h + 4 * tx;
      if (c >= N) continue;            // N % 8 == 0: all four in range
      store_pair(out, out_bf16, N, r, c, acc[i][4 * h], acc[i][4 * h + 1],
                 bv[4 * h], bv[4 * h + 1], act);
      store_pair(out, out_bf16, N, r, c + 2, acc[i][4 * h + 2],
                 acc[i][4 * h + 3], bv[4 * h + 2], bv[4 * h + 3], act);
    }
  }
}

cudaError_t launch(const float* x, const float* w, const void* bias,
                   int bias_bf16, void* out, int out_bf16, int M, int N,
                   int K, int act, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mm_fma_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_fma_tile_kernel<<<grid, kThreads, kSmem, stream>>>(
      x, w, bias, bias_bf16, out, out_bf16, M, N, K, act);
  return cudaGetLastError();
}

}  // namespace ft

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
// act: 0 none, 1 gelu (tanh), 2 silu, 3 relu2.  path (the wrapper's
// matmul_plan): 0 wmma and 1 fma (any shape; bf16 and f32), 2 wgmma
// (bf16), 3 split_k (bf16, M <= 16: `splits` blocks of split_rows rows
// of K, a multiple of 32, with an f32 workspace ws of splits * M * N
// when splits > 1), 4 fma_tile (f32); paths 2-4 need K and N multiples
// of 8 and 16-byte aligned x and w.  Shape contract (checked by the
// Python wrapper): x (M,K) and w (K,N) contiguous row-major on one
// device, M, N, K >= 1, ceil(M / 64) <= 65,535.
extern "C" int repro_matmul_fused(int dtype, const void* x, const void* w,
                                  const void* bias, int bias_dtype, void* out,
                                  int out_dtype, int M, int N, int K, int act,
                                  int path, int splits, int split_rows,
                                  float* ws, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = K % 8 == 0 && N % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if ((path >= 2 && !aligned) || (dtype == 0) != (path == 1 || path == 4))
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  switch (path) {
    case 1: {
      dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
      mm_f32_kernel<<<grid, kF32Threads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), bias,
          bias_dtype, out, out_dtype, M, N, K, act);
      return (int)cudaGetLastError();
    }
    case 2:
      return (int)wg::launch(xb, wb, bias, bias_dtype, out, out_dtype, M, N,
                             K, act, s);
    case 3:
      if (M > 16 || splits < 1 || splits > 65535 || split_rows < 1 ||
          split_rows % sk::kRows != 0 ||
          (long long)(splits - 1) * split_rows >= K ||
          (long long)splits * split_rows < K ||
          (splits > 1 && ws == nullptr))
        return (int)cudaErrorInvalidValue;
      return (int)sk::launch(xb, wb, bias, bias_dtype, out, out_dtype, ws, M,
                             N, K, splits, split_rows, act, s);
    case 4:
      return (int)ft::launch(static_cast<const float*>(x),
                             static_cast<const float*>(w), bias, bias_dtype,
                             out, out_dtype, M, N, K, act, s);
    case 0: {
      const bool vec = aligned;
      if (M <= 16)     // decode: weight-read bound, many narrow blocks
        return (int)launch_bf16<16, 64, 128, 1, 4>(
            xb, wb, bias, bias_dtype, out, out_dtype, M, N, K, act, vec, s);
      return (int)launch_bf16<128, 128, 32, 2, 4>(
          xb, wb, bias, bias_dtype, out, out_dtype, M, N, K, act, vec, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
