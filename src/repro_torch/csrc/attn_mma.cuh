// Tensor-core attention tile engine for bf16 activations (sm_90a).
//
// tile_attention_mma<TP, D>() is the bf16 engine behind flash_attention.cu
// and paged_prefill.cu (their f32 paths keep tile_attention() of
// attn_common.cuh).  One block of 128 threads (4 warps) owns 64 query
// rows, 16 per warp, and walks its key range [t_begin, t_end) in tiles of
// 64 keys:
//
//   * Q: the block's 64 x D bf16 tile is copied once with 16-byte
//     cp.async chunks into shared memory (8-byte ones, two a chunk, for
//     rows whose length is not a multiple of 16 bytes, see "Head dims
//     40 and 60" below).  At D <= 128 it is kept, for
//     the whole walk, as ldmatrix-loaded A fragments in registers; at
//     D = 256 those would take 64 registers a lane beside the 128 of the
//     O accumulator, so each k-step of Q K^T reads its fragment from the
//     tile with ldmatrix instead.
//   * K/V: a two-stage ring in dynamic shared memory.  While a warp
//     computes on one stage, the next live tile's rows stream into the
//     other (cp.async.cg, 16 bytes, commit_group/wait_group).  Each key's
//     row is resolved once through Prob::kv_row (the paged kernel's block
//     table lookup) and copied whole; rows past the range are zero-filled.
//     16-byte chunks are XOR-swizzled by row (chunk ^ (row & 7)), so
//     ldmatrix (.trans for V) reads are free of bank conflicts.  int8
//     pools stream their D-byte rows and their f32 row scales into the
//     ring; one pass converts the stage to bf16 (exact: |x| <= 127) in a
//     single K/V tile, and the scales stay in shared memory.
//   * S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 accumulate).  On
//     int8 pools each score column is multiplied by its key's k scale.
//     Scale, tanh softcap and (only on tiles that straddle a mask
//     boundary) the per-element mask are applied in registers; online
//     softmax in the exp2 domain, row max and sum over the quad that
//     shares a row.  P is rounded to bf16 (on int8 pools after
//     multiplying each column by its key's v scale) as the A operand of
//     O += P V, which stays in f32 registers: at D <= 128 the whole
//     tile's P is packed first, at D = 256 P overwrites S and each k-step
//     is packed just before its products.  With kSplitP
//     (the flash instantiation: JAX's flash kernel and its ref keep P in
//     f32) P goes in as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi),
//     two products into the same f32 accumulator: P keeps 16 significant
//     bits, and the output's error is that of its own final rounding.  The
//     paged instantiations keep the single rounding, as the paged refs
//     round their probabilities to the activation dtype.
//
// A tile in which no row may attend any key is skipped before its K/V
// are copied (Prob::tile_class, uniform across the block), so causal
// walks stop at the diagonal.  Masked keys contribute an exact 0; a row
// with no admissible key ends with l == 0 and writes 0, as the plain
// versions do.
//
// Split-KV: with ws_o non-null the block writes its rows' f32 (m, l,
// unnormalised O) for split `split` into the workspace, and
// split_combine_kernel merges the splits and casts the result; with
// ws_o null the engine writes the normalised bf16 rows itself.
//
// Head dims 40 and 60 (DeiT-160, LV-ViT-T; flash only): the tile is
// instantiated at a padded width D (48 and 64: mma.sync k-steps over D
// are 16 wide, the P V n-tiles 8) and the true width DG is the global
// row stride.  Columns past DG are zero-filled in shared memory (the
// copies' zero fill), so they add 0 to every score and give 0 output
// columns, which are never written: only DG columns are read from and
// written to global memory.  A bf16 row of 60 is 120 bytes, so every
// other row starts 8 bytes off a 16-byte boundary: those rows stream in
// 8-byte cp.async copies (cp_row_chunk).  At D = 48 a row holds 6
// 16-byte chunks, too few for the XOR swizzle, so rows are laid out at a
// stride of 7 chunks instead (RowLayout): 8 consecutive rows at one chunk
// still fall in 8 distinct bank groups for ldmatrix.  The softmax scale
// is the caller's, 1/sqrt(DG).
#pragma once

#include <climits>

#include "attn_common.cuh"

namespace repro_torch {
namespace mma {

constexpr int kRows = 64;      // query rows per block, 16 per warp
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRows == kKeys, "Q and K/V tiles share one 64-row layout");

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !pred.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool pred) {
  const int n = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16x2 register, lo in the low half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// What pack_bf16 drops: bf16(a - bf16(a)), bf16(b - bf16(b)), packed the
// same way (the differences are exact in f32).
__device__ __forceinline__ uint32_t pack_lo_bf16(float a, float b) {
  return pack_bf16(a - __bfloat162float(__float2bfloat16_rn(a)),
                   b - __bfloat162float(__float2bfloat16_rn(b)));
}

// A 64 x D bf16 tile's rows in shared memory: D/8 16-byte chunks a row,
// XOR-swizzled by row when that is a multiple of 8; else (D = 48) a row
// stride of D/8 rounded up to odd chunks, unswizzled.
template <int D>
struct RowLayout {
  static_assert(D % 16 == 0, "tile widths are whole mma k-steps");
  static constexpr int kChunks = D / 8;
  static constexpr bool kSwizzle = kChunks % 8 == 0;
  static constexpr int kStride = kSwizzle ? kChunks : (kChunks | 1);
};

// Byte offset of 16-byte chunk c of row r in a 64 x D bf16 tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (RowLayout<D>::kSwizzle)
    return r * (D * 2) + ((c ^ (r & 7)) << 4);
  else
    return r * (RowLayout<D>::kStride * 16) + (c << 4);
}

// Chunk c (bf16 columns 8c .. 8c+7) of a global row of DG columns into
// 16 bytes of shared memory at dst; columns past DG, and every column
// when !ok, are zero-filled.  A row of DG % 8 != 0 columns (DG = 60) may
// start 8 bytes off a 16-byte boundary: its chunks go as two 8-byte
// copies (DG % 4 == 0, so each half is whole or empty).
template <int DG>
__device__ __forceinline__ void cp_row_chunk(uint32_t dst, const bf16* row,
                                             int c, bool ok) {
  static_assert(DG % 4 == 0, "rows are whole 8-byte halves");
  if constexpr (DG % 8 == 0) {
    const bool in = ok && c * 8 < DG;
    cp_async16(dst, row + (in ? c * 8 : 0), in);
  } else {
    const bool lo = ok && c * 8 < DG, hi = ok && c * 8 + 4 < DG;
    cp_async8(dst, row + (lo ? c * 8 : 0), lo);
    cp_async8(dst + 8, row + (hi ? c * 8 + 4 : 0), hi);
  }
}

template <typename TP, int D>
struct MmaSmem {
  static constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  // one 64 x D bf16 tile
  static constexpr int kTile = kRows * RowLayout<D>::kStride * 16;
  static constexpr int kRaw = kKeys * D;       // one 64 x D int8 tile
  static constexpr int kQ = 0;
  // the ring: stage s holds K then V (bf16 tiles, or int8 tiles)
  static constexpr int kRing = kTile;
  static constexpr int kStage = 2 * (kQuant ? kRaw : kTile);
  // int8 pools: the stage converted to bf16, K then V
  static constexpr int kConv = kRing + kStages * kStage;
  // per stage: int kpos[64], int ok[64], float kscale[64], float vscale[64]
  static constexpr int kMeta = kConv + (kQuant ? 2 * kTile : 0);
  static constexpr int kMetaStage = 4 * kKeys * 4;
  static constexpr size_t kBytes = (size_t)kMeta + kStages * kMetaStage;
};

// Prob supplies, for the block it was built for:
//   int n_rows;            valid query rows (<= 64): global rows row0 + r
//   size_t row0;           row index into q, out and the workspace
//   int qmin, qmax;        positions over the block's valid rows
//   int t_begin, t_end;    the block's key range
//   int qpos(int r);       absolute position of row r
//   size_t kv_row(int t);  row of key t in kbase/vbase (x D) and the scales
//   void key_meta(int t, int& kpos, int& kvalid);
//   bool admit(int qpos, int kpos);           the mask beyond k_valid
//   int tile_class(int t0, int t1);  keys [t0, t1): 0 no pair admissible,
//       1 mask per element, 2 every pair admissible; the same value in
//       every thread of the block
// DG: the true head dim, the row stride of q, k, v, out and the
// workspace (D, the tile's width, by default; DG < D pads, bf16 pools
// only).
template <typename TP, int D, bool kSplitP, typename Prob, int DG = D>
__device__ __forceinline__ void tile_attention_mma(
    const Prob& pb, const bf16* __restrict__ q, const TP* __restrict__ kbase,
    const TP* __restrict__ vbase, const float* __restrict__ ks,
    const float* __restrict__ vs, bf16* __restrict__ out,
    float* __restrict__ ws_o, float* __restrict__ ws_ml, size_t ws_rows,
    int split, float scale, float softcap) {
  using SM = MmaSmem<TP, D>;
  constexpr bool kQuant = SM::kQuant;
  static_assert(DG <= D && D - DG < 16 && (!kQuant || DG == D),
                "a padded tile is at most one k-step wider, bf16 only");
  constexpr int KD = D / 16;         // k-steps of Q K^T
  constexpr int ND = D / 8;          // n-tiles of P V
  // D <= 128: Q's A fragments held in registers for the walk, and each
  // tile's P packed whole before O += P V.  D = 256: both read a k-step at
  // a time (Q from shared memory, P from S) to save registers.  On the
  // card the D <= 128 layout is the faster one there: Q from shared memory
  // took flash 7% longer at D=128 and the int8 prefill 5-12% at D=64, and
  // P a k-step at a time with Q in registers the fp prefill 14-20% at
  // D=128 (bench_attention.py, H100 80GB HBM3, 700 W)
  constexpr bool kQRegs = D <= 128;
  constexpr int CPR = D / 8;         // 16-byte chunks in a bf16 row
  constexpr int RPP = kThreads / CPR;
  // a padded tile (DG < D) copies chunk by chunk through cp_row_chunk
  constexpr int kChunkIters = (kRows * CPR + kThreads - 1) / kThreads;
  constexpr int CPR8 = D / 16;       // 16-byte chunks in an int8 row
  constexpr int RPP8 = kThreads / CPR8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* sm = smem_mma;
  const uint32_t sbase = smem_u32(sm);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;

  auto meta = [&](int stage) {
    return reinterpret_cast<int*>(sm + SM::kMeta + stage * SM::kMetaStage);
  };

  // -- Q tile, zero rows past n_rows ------------------------------------
  if constexpr (DG == D) {
    const int c = tid % CPR;
#pragma unroll
    for (int i = 0; i < kRows / RPP; ++i) {
      const int r = tid / CPR + i * RPP;
      const bool ok = r < pb.n_rows;
      cp_async16(sbase + SM::kQ + swz<D>(r, c),
                 q + (pb.row0 + (ok ? r : 0)) * D + c * 8, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunkIters; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / CPR, c = idx % CPR;
      const bool ok = r < pb.n_rows;
      if (r < kRows)
        cp_row_chunk<DG>(sbase + SM::kQ + swz<D>(r, c),
                         q + (pb.row0 + (ok ? r : 0)) * DG, c, ok);
    }
  }
  cp_commit();

  // copies keys [t0, min(t0 + 64, t_end)) of K, V (and scales) into stage
  auto issue = [&](int t0, int stage) {
    const int t1 = min(t0 + kKeys, pb.t_end);
    if constexpr (!kQuant) {
      const uint32_t kd = sbase + SM::kRing + stage * SM::kStage;
      const uint32_t vd = kd + SM::kTile;
      if constexpr (DG == D) {
        const int c = tid % CPR;
#pragma unroll
        for (int i = 0; i < kKeys / RPP; ++i) {
          const int r = tid / CPR + i * RPP;
          const bool ok = t0 + r < t1;
          const size_t row = ok ? pb.kv_row(t0 + r) : 0;
          cp_async16(kd + swz<D>(r, c), kbase + row * D + c * 8, ok);
          cp_async16(vd + swz<D>(r, c), vbase + row * D + c * 8, ok);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kChunkIters; ++i) {
          const int idx = tid + i * kThreads;
          const int r = idx / CPR, c = idx % CPR;
          if (r >= kKeys) continue;
          const bool ok = t0 + r < t1;
          const size_t row = ok ? pb.kv_row(t0 + r) : 0;
          cp_row_chunk<DG>(kd + swz<D>(r, c), kbase + row * DG, c, ok);
          cp_row_chunk<DG>(vd + swz<D>(r, c), vbase + row * DG, c, ok);
        }
      }
    } else {
      const uint32_t kd = sbase + SM::kRing + stage * SM::kStage;
      const uint32_t vd = kd + SM::kRaw;
      const int c = tid % CPR8;
#pragma unroll
      for (int i = 0; i < kKeys / RPP8; ++i) {
        const int r = tid / CPR8 + i * RPP8;
        const bool ok = t0 + r < t1;
        const size_t row = ok ? pb.kv_row(t0 + r) : 0;
        cp_async16(kd + r * D + c * 16, kbase + row * D + c * 16, ok);
        cp_async16(vd + r * D + c * 16, vbase + row * D + c * 16, ok);
      }
      // threads 0-63 copy key tid's k scale, 64-127 key (tid-64)'s v scale
      const int r = tid & (kKeys - 1);
      const bool ok = t0 + r < t1;
      const size_t row = ok ? pb.kv_row(t0 + r) : 0;
      const int which = tid < kKeys ? 2 : 3;
      cp_async4(smem_u32(meta(stage) + which * kKeys + r),
                (tid < kKeys ? ks : vs) + row, ok);
    }
    if (tid < kKeys) {
      int kp = 0, kv = 0;
      if (t0 + tid < t1) pb.key_meta(t0 + tid, kp, kv);
      meta(stage)[tid] = kp;
      meta(stage)[kKeys + tid] = kv;
    }
  };

  // int8 pools: the stage's K and V rows to bf16, swizzled
  auto convert = [&](int stage) {
    const unsigned char* raw = sm + SM::kRing + stage * SM::kStage;
#pragma unroll
    for (int i = 0; i < 2 * kKeys * CPR8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int which = idx / (kKeys * CPR8);
      const int rem = idx - which * (kKeys * CPR8);
      const int r = rem / CPR8, c = rem % CPR8;
      const int4 v = *reinterpret_cast<const int4*>(raw + which * SM::kRaw +
                                                    r * D + c * 16);
      const int8_t* x = reinterpret_cast<const int8_t*>(&v);
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e] = pack_bf16((float)x[2 * e], (float)x[2 * e + 1]);
      unsigned char* dst = sm + SM::kConv + which * SM::kTile;
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c + 1)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  };

  // the first live tile at or after t0 (its class in cls)
  auto next_live = [&](int t0, int& cls) {
    for (; t0 < pb.t_end; t0 += kKeys) {
      cls = pb.tile_class(t0, min(t0 + kKeys, pb.t_end));
      if (cls != 0) break;
    }
    return t0;
  };

  int cls = 0, cls_n = 0;
  int t = next_live(pb.t_begin, cls);
  if (t < pb.t_end) issue(t, 0);
  cp_commit();
  cp_wait<1>();                      // the Q group has landed
  __syncthreads();

  // the warp's Q A fragment of k-step kk
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    ldsm_x4(sbase + SM::kQ + swz<D>(warp * 16 + (lane & 15),
                                    kk * 2 + (lane >> 4)), a);
  };
  uint32_t qa[kQRegs ? KD : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) q_frag(kk, qa[kk]);
  }

  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  const int qp_lo = r_lo < pb.n_rows ? pb.qpos(r_lo) : 0;
  const int qp_hi = r_hi < pb.n_rows ? pb.qpos(r_hi) : 0;
  const float sl = scale * kLog2e;                  // no softcap
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  int tn = t < pb.t_end ? next_live(t + kKeys, cls_n) : pb.t_end;
  int stage = 0;
  while (t < pb.t_end) {
    if (tn < pb.t_end) issue(tn, stage ^ 1);
    cp_commit();
    cp_wait<1>();                    // tile t has landed (this thread's part)
    __syncthreads();                 // ... and every thread's
    uint32_t kt, vt;
    if constexpr (kQuant) {
      convert(stage);
      __syncthreads();
      kt = sbase + SM::kConv;
    } else {
      kt = sbase + SM::kRing + stage * SM::kStage;
    }
    vt = kt + SM::kTile;
    const int* mpos = meta(stage);
    const int* mok = mpos + kKeys;
    const float* mks = reinterpret_cast<const float*>(mpos + 2 * kKeys);
    const float* mvs = mks + kKeys;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
      } else {
        q_frag(kk, a);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(kt + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                            kk * 2 + ((lane >> 3) & 1)), b);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale, softcap, mask (log2 domain); row max over the quad
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1);
        float x = s[j][e];
        if constexpr (kQuant) x *= mks[col];
        x = softcap > 0.f ? cap_out * tanhf(x * cap_in) : x * sl;
        if (cls == 1 &&
            !(mok[col] != 0 && pb.admit(e < 2 ? qp_lo : qp_hi, mpos[col])))
          x = kNegInf;
        s[j][e] = x;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, x);
        else
          mx_hi = fmaxf(mx_hi, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // a row with no admissible key yet subtracts 0: its p and alpha are 0
    const float mu_lo = mn_lo == kNegInf ? 0.f : mn_lo;
    const float mu_hi = mn_hi == kNegInf ? 0.f : mn_hi;
    const float a_lo = exp2f(m_lo - mu_lo), a_hi = exp2f(m_hi - mu_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= a_lo;
      o[n][1] *= a_lo;
      o[n][2] *= a_hi;
      o[n][3] *= a_hi;
    }

    // P (on int8 pools times each key's v scale, after l takes the
    // unscaled sum): bf16 A fragments, k-step kk covering keys 16kk ..
    // 16kk+15 (kSplitP: pl holds the parts the bf16 rounding dropped);
    // at D = 256 P overwrites S and is packed a k-step at a time below
    uint32_t pa[kQRegs ? 4 : 1][4], pl[kQRegs && kSplitP ? 4 : 1][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p0 = exp2f(s[j][0] - mu_lo), p1 = exp2f(s[j][1] - mu_lo);
      float p2 = exp2f(s[j][2] - mu_hi), p3 = exp2f(s[j][3] - mu_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      if constexpr (kQuant) {
        const int col = 8 * j + 2 * tig;
        p0 *= mvs[col];
        p1 *= mvs[col + 1];
        p2 *= mvs[col];
        p3 *= mvs[col + 1];
      }
      if constexpr (kQRegs) {
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        if constexpr (kSplitP) {
          pl[j >> 1][(j & 1) * 2] = pack_lo_bf16(p0, p1);
          pl[j >> 1][(j & 1) * 2 + 1] = pack_lo_bf16(p2, p3);
        }
      } else {
        s[j][0] = p0;
        s[j][1] = p1;
        s[j][2] = p2;
        s[j][3] = p3;
      }
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4], lo[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = pa[kk][e];
          if constexpr (kSplitP) lo[e] = pl[kk][e];
        }
      } else {
        const float(&s0)[4] = s[2 * kk];
        const float(&s1)[4] = s[2 * kk + 1];
        a[0] = pack_bf16(s0[0], s0[1]);
        a[1] = pack_bf16(s0[2], s0[3]);
        a[2] = pack_bf16(s1[0], s1[1]);
        a[3] = pack_bf16(s1[2], s1[3]);
        if constexpr (kSplitP) {
          lo[0] = pack_lo_bf16(s0[0], s0[1]);
          lo[1] = pack_lo_bf16(s0[2], s0[3]);
          lo[2] = pack_lo_bf16(s1[0], s1[1]);
          lo[3] = pack_lo_bf16(s1[2], s1[3]);
        }
      }
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(vt + swz<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                              dp * 2 + (lane >> 4)), b);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        if constexpr (kSplitP) {
          mma_bf16(o[2 * dp], lo, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();                 // the next issue overwrites this stage

    t = tn;
    cls = cls_n;
    stage ^= 1;
    if (t < pb.t_end) tn = next_live(t + kKeys, cls_n);
  }
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, off);
    l_hi += __shfl_xor_sync(kFull, l_hi, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_hi : r_lo;
    if (r >= pb.n_rows) continue;
    const float m = half ? m_hi : m_lo, l = half ? l_hi : l_lo;
    // a column pair past the true width (a padded tile) is not written
    auto col_ok = [&](int col) { return DG == D || col < DG; };
    if (ws_o != nullptr) {
      const size_t w = (size_t)split * ws_rows + pb.row0 + r;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        if (col_ok(8 * n + 2 * tig))
          *reinterpret_cast<float2*>(ws_o + w * DG + 8 * n + 2 * tig) =
              make_float2(o[n][2 * half], o[n][2 * half + 1]);
      if (tig == 0)
        *reinterpret_cast<float2*>(ws_ml + 2 * w) = make_float2(m, l);
    } else {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* orow = out + (pb.row0 + r) * DG;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        if (col_ok(8 * n + 2 * tig))
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * tig) =
              __floats2bfloat162_rn(o[n][2 * half] * inv,
                                    o[n][2 * half + 1] * inv);
    }
  }
}

// Merges nsplit workspace slices (m in the exp2 domain, l, unnormalised
// O, all f32) of `rows` rows into out (T: bf16 or f32), 4 columns per
// thread; a row that no split admitted any key for writes 0.  Shared by
// split_combine_kernel and the fused decode's own combine kernel.
template <typename T, int D>
__device__ __forceinline__ void combine_rows(const float* __restrict__ ws_o,
                                             const float* __restrict__ ws_ml,
                                             T* __restrict__ out, size_t rows,
                                             int nsplit) {
  constexpr int C4 = D / 4;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * C4) return;
  const size_t row = idx / C4;
  const int c = (int)(idx % C4) * 4;
  float mx = kNegInf;
  for (int z = 0; z < nsplit; ++z)
    mx = fmaxf(mx, ws_ml[2 * (z * rows + row)]);
  float l = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (mx != kNegInf) {
    for (int z = 0; z < nsplit; ++z) {
      const size_t w = z * rows + row;
      const float m = ws_ml[2 * w];
      if (m == kNegInf) continue;
      const float f = exp2f(m - mx);
      l += f * ws_ml[2 * w + 1];
      const float4 v = *reinterpret_cast<const float4*>(ws_o + w * D + c);
      a0 += f * v.x;
      a1 += f * v.y;
      a2 += f * v.z;
      a3 += f * v.w;
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* o = out + row * D + c;
  o[0] = from_f32<T>(a0 * inv);
  o[1] = from_f32<T>(a1 * inv);
  o[2] = from_f32<T>(a2 * inv);
  o[3] = from_f32<T>(a3 * inv);
}

template <int D>
__global__ void __launch_bounds__(256)
split_combine_kernel(const float* __restrict__ ws_o,
                     const float* __restrict__ ws_ml, bf16* __restrict__ out,
                     size_t rows, int nsplit) {
  combine_rows<bf16, D>(ws_o, ws_ml, out, rows, nsplit);
}

// Launches the combine pass on `stream` when nsplit > 1; returns
// cudaGetLastError().
template <int D>
cudaError_t launch_combine(const float* ws_o, const float* ws_ml, void* out,
                           size_t rows, int nsplit, cudaStream_t stream) {
  if (nsplit <= 1) return cudaSuccess;
  const size_t n = rows * (D / 4);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  split_combine_kernel<D><<<blocks, 256, 0, stream>>>(
      ws_o, ws_ml, static_cast<bf16*>(out), rows, nsplit);
  return cudaGetLastError();
}

// Sets the kernel's dynamic shared memory and launches it; returns the
// first error.
template <typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, size_t smem, dim3 grid,
                         cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace mma
}  // namespace repro_torch
