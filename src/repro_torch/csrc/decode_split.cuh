// Split-KV, tiled-key walk for one-token paged decode (sm_90a).
//
// split_decode_walk<T, TP, D, G>() is the engine behind both one-token
// decodes, fused_paged_decode.cu and paged_attention.cu: one block of 256
// threads (8 warps) attends the G query rows of one (slot, kv head) over
// the logical key range [t_begin, t_hi) of one key split.  The keys go by
// in tiles of 64 (four 16-row pages), or of 32 where three stages of 64
// keys do not fit the ring (f32 rows at D = 256: 128 KB a stage):
//
//   * warp w owns keys 8w .. 8w+7 of every tile (4w .. 4w+3 in a 32-key
//     tile): it resolves their pool
//     rows through the slot's block table once, a tile ahead of their
//     copy (without waiting for the slot's position), and streams their K
//     and V rows (and on int8 pools their f32 row scales) into a ring of
//     3 to 5 stages in dynamic shared memory with 16-byte cp.async
//     copies, keys past t_hi zero-filled.  A warp waits only for its own
//     copies, so the walk has no block barrier until the final merge;
//   * scores of the warp's 8 keys: with bf16 activations on the tensor
//     cores, mma.sync m16n8k16 (the G query rows, exact in bf16, as A;
//     the keys' rows as B, int8 rows converted exactly and their scales
//     applied to the scores; f32 accumulation); with f32 activations on
//     the CUDA cores, each lane D/32 dims of every key and query row and
//     a reduce-scatter of the G x 8 partial sums over the 32 lanes (62
//     shuffles at G = 8, not 5 per score);
//   * any G from 1 to 8 query rows: the tensor-core path already pads
//     its A operand to 8 rows, and the CUDA-core path lays its partial
//     sums out for GP, G rounded up to a power of two (3 -> 4; 5, 6, 7
//     -> 8), whose rows past G are zero scores that are never kept,
//     stored or written back;
//   * one online-softmax update per tile, query row and warp, over the
//     warp's 8 keys (exp2 domain; each warp keeps its own m and l), P
//     kept in f32;
//   * O += P V in f32: warp w again takes its 8 keys, a lane its D/32
//     dims, for all G rows; the 8 warps' (m, l, O) merge in shared
//     memory at the end.
//
// The caller's prologue runs after the first tiles are issued, so the
// fused decode's RoPE and fresh-row write overlap their loads.  Key t_fresh (-1:
// none) is never copied from the pool: the walk writes the caller's row
// (pool format, from shared memory) into its tile, so it is attended as
// stored.  Every key in [t_begin, t_hi) is admissible.  With ws_o null
// the walk writes the normalised rows; otherwise it writes its f32
// (m, l, unnormalised O) into split `split` of the workspace (an empty
// range writes m = -inf, l = 0) and a combine pass merges the splits.
#pragma once

#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace repro_torch {
namespace split {

constexpr int kKeys = 64;        // keys per split unit (and most tiles)
constexpr int kRingBytes = 192 * 1024;   // the cp.async ring, at most
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// kMma: the scores run on the tensor cores (bf16 activations), whose
// B-fragment reads want K rows 16 bytes apart in banks
template <typename TP, int D, int G, bool kMma>
struct Smem {
  static constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  static constexpr int kRow = D * (int)sizeof(TP);        // bytes per row
  static constexpr int kKRow = kRow + (kMma ? 16 : 0);    // K's row stride
  // keys per tile: 64, or 32 where three 64-key stages of K and V would
  // pass the ring's bytes (f32 rows at D = 256; the tensor-core walk
  // takes 8 keys a warp and bf16 rows, which always fit)
  static constexpr int kKeys =
      kMma || 3 * 2 * 64 * kRow <= kRingBytes ? 64 : 32;
  static constexpr int kKeysPerWarp = kKeys / kWarps;
  static constexpr int kTileK = kKeys * kKRow;
  static constexpr int kTile = kKeys * kRow;
  // stage: K tile, V tile, then (int8) k and v scales
  static constexpr int kStage = kTileK + kTile + (kQuant ? 2 * kKeys * 4 : 0);
  // 3 to 5 stages, as many as 192 KB hold (5 in bf16 at D = 128, 3 in
  // f32, 3 in bf16 at D = 256)
  static constexpr int kFit = kRingBytes / kStage;
  static constexpr int kStages = kFit < 3 ? 3 : kFit > 5 ? 5 : kFit;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kRed = kWarps * G * D * 4;         // after the walk
  static constexpr int kS = kRing > kRed ? kRing : kRed;
  // per warp: P of its 8 keys (G x 8) and G rescale factors; after the
  // walk the warps' m and l
  static constexpr int kRowsP = kMma ? 8 : G;   // rows of a warp's P
  // P, then G row factors rounded up to 4 floats: the next warp's P
  // stays 16-byte aligned for its float4 reads
  static constexpr int kWarpP = kRowsP * kKeysPerWarp + (G + 3) / 4 * 4;
  static constexpr int kRows = kS + kWarps * kWarpP * 4;
  static constexpr int kQ = kRows;
  static constexpr int kFresh = kQ + G * D * 4;           // K, V rows
  static constexpr int kFreshSc = kFresh + 2 * kRow;      // their scales
  static constexpr size_t kBytes = (size_t)kFreshSc + 16;
  static_assert(kRow % 16 == 0, "rows are copied in 16-byte chunks");
  static_assert(kKeysPerWarp % 4 == 0, "P is read as float4");
  static_assert(!kMma || kKeysPerWarp == 8, "an mma B fragment is 8 keys");
  // the launch adds the fused decode's few KB of static shared memory
  static_assert(kBytes <= 220 * 1024, "the walk fits one SM's 227 KB");
};

template <int B>
struct Vec;
template <>
struct Vec<16> {
  using type = uint4;
};
template <>
struct Vec<8> {
  using type = uint2;
};
template <>
struct Vec<4> {
  using type = uint32_t;
};
template <>
struct Vec<2> {
  using type = uint16_t;
};

// A lane's D/32 consecutive values of a shared row, in f32 (int8 rows
// times their scale, one rounding, as the plain version dequantizes);
// read in pieces of at most 16 bytes (f32 rows at D = 256 give a lane
// 32 bytes).
template <typename TP, int DL>
__device__ __forceinline__ void lane_row(const unsigned char* row, int lane,
                                         float sc, float (&x)[DL]) {
  constexpr int B = DL * (int)sizeof(TP);
  constexpr int PB = B < 16 ? B : 16;             // bytes a piece
  constexpr int PN = PB / (int)sizeof(TP);        // values a piece
  using V = typename Vec<PB>::type;
#pragma unroll
  for (int c = 0; c < B / PB; ++c) {
    union {
      V raw;
      TP v[PN];
    } u;
    u.raw = *reinterpret_cast<const V*>(row + lane * B + c * PB);
#pragma unroll
    for (int e = 0; e < PN; ++e) x[c * PN + e] = pool_f32<TP>(u.v[e], sc);
  }
}

// Sums N per-lane values over the warp's 32 lanes, leaving each lane
// max(N/32, 1) of the totals: with N >= 32 lane l holds totals
// l*(N/32) .. l*(N/32) + N/32 - 1 in v[0 ..]; with N < 32 it holds total
// l / (32/N) in v[0].  Each level halves the values a lane carries.
template <int N, int O>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (O > 0) {
      if constexpr (N > 1) {
        constexpr int H = N / 2;
        const bool up = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float send = up ? v[i] : v[i + H];
          const float keep = up ? v[i + H] : v[i];
          v[i] = keep + __shfl_xor_sync(kFull, send, O);
        }
        ReduceScatter<H, O / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(kFull, v[0], O);
        ReduceScatter<1, O / 2>::run(v, lane);
      }
    }
  }
};

// dynamic shared memory of split_decode_walk<T, TP, D, G>
template <typename T, typename TP, int D, int G>
constexpr size_t walk_smem() {
  return Smem<TP, D, G, std::is_same<T, __nv_bfloat16>::value>::kBytes;
}

// Pre(float* qs, TP* k_row, TP* v_row, float* row_scales) fills, after
// the first tiles are issued: qs, the G query rows (f32, (G, D)
// row-major), and when t_fresh >= 0 the fresh key and value rows in the
// pool's format and (int8) their two scales.  It may use __syncthreads.
// Keys [t_begin, t_hi) are attended; t_range >= t_hi ends the split's
// range inside the table.
template <typename T, typename TP, int D, int G, typename Pre>
__device__ __forceinline__ void split_decode_walk(
    const TP* __restrict__ kp, const TP* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ btb, int h, int Hkv, int P, int t_begin,
    int t_range, int t_hi, int t_fresh, float softcap, float scale, Pre pre,
    T* __restrict__ out, float* __restrict__ ws_o, float* __restrict__ ws_ml,
    size_t row0, size_t ws_rows, int split) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using S = Smem<TP, D, G, kMma>;
  constexpr bool kQuant = S::kQuant;
  constexpr int kKeys = S::kKeys;            // keys per tile
  constexpr int kKeysPerWarp = S::kKeysPerWarp;
  static_assert(G >= 1 && G <= 8, "1 to 8 query rows per kv head");
  constexpr int DL = D / 32;                 // dims per lane
  // G rounded up to a power of two: the reduce-scatter halves its values
  constexpr int GP = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  constexpr int NV = GP * kKeysPerWarp;      // partial scores per warp
  // totals a lane holds, lanes sharing one, lanes sharing a row: the
  // reduce-scatter's layout (rows >= G of the GP are padding), or the mma
  // accumulator's (row lane / 4, keys 2 (lane % 4) and + 1; rows >= G are
  // padding)
  constexpr int NL = kMma ? 2 : NV >= 32 ? NV / 32 : 1;
  constexpr int kDup = kMma || NV >= 32 ? 1 : 32 / NV;
  constexpr int kRowLanes = kMma ? 4 : 32 / GP;
  constexpr int CPR = S::kRow / 16;          // 16-byte chunks per row
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(16) unsigned char smem_split[];
  unsigned char* sm = smem_split;
  const uint32_t sbase = mma::smem_u32(sm);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* sp = reinterpret_cast<float*>(sm + S::kS);
  float* pw = sp + warp * S::kWarpP;                // the warp's P ...
  float* aw = pw + S::kRowsP * kKeysPerWarp;        // ... and row factors
  float* qs = reinterpret_cast<float*>(sm + S::kQ);
  TP* kfr = reinterpret_cast<TP*>(sm + S::kFresh);
  TP* vfr = reinterpret_cast<TP*>(sm + S::kFresh + S::kRow);
  float* fsc = reinterpret_cast<float*>(sm + S::kFreshSc);

  const int ntiles = t_hi > t_begin ? (t_hi - t_begin + kKeys - 1) / kKeys
                                    : 0;
  // Each warp streams its own rows of every tile (keys 8w .. 8w+7 of 64,
  // 4w .. 4w+3 of 32), so that a warp waits only for its own copies: the
  // loop has no block barrier.  row_of(i): lane l holds the pool row
  // (page * P + slot row) of the warp's key l % kKeysPerWarp of tile i,
  // for every key of the split's range
  // inside the table (t_range), so that the table's loads need not wait
  // for the slot's position (-1 past it); it is loaded a tile ahead.
  auto row_of = [&](int i) {
    const int t =
        t_begin + i * kKeys + warp * kKeysPerWarp + lane % kKeysPerWarp;
    return t < t_range ? btb[t / P] * P + t % P : -1;
  };
  auto stage_at = [&](int i) { return (i % kStages) * S::kStage; };
  auto issue = [&](int i, int row) {
    if (i < ntiles) {
      const uint32_t kd = sbase + stage_at(i), vd = kd + S::kTileK;
      const int t0 = t_begin + i * kKeys + warp * kKeysPerWarp;
      // the fresh key is never copied; keys past t_hi are zero-filled
#pragma unroll
      for (int u = 0; u < kKeysPerWarp * CPR / 32; ++u) {
        const int c = lane + 32 * u;
        const int r = c / CPR, cc = c % CPR;
        const int pr = __shfl_sync(kFull, row, r);
        const int j = warp * kKeysPerWarp + r;
        if (t0 + r == t_fresh) continue;
        const bool ok = t0 + r < t_hi;
        const size_t g = ((size_t)(ok ? pr : 0) * Hkv + h) * D;
        mma::cp_async16(
            kd + j * S::kKRow + cc * 16,
            reinterpret_cast<const unsigned char*>(kp + g) + cc * 16, ok);
        mma::cp_async16(
            vd + j * S::kRow + cc * 16,
            reinterpret_cast<const unsigned char*>(vp + g) + cc * 16, ok);
      }
      if constexpr (kQuant) {
        // the warp's first lanes copy their keys' k scales, the next as
        // many their v scales
        const int r = lane % kKeysPerWarp;
        const int j = warp * kKeysPerWarp + r;
        const bool kside = lane < kKeysPerWarp;
        if (lane < 2 * kKeysPerWarp && t0 + r != t_fresh) {
          const bool ok = t0 + r < t_hi;
          const size_t g = (size_t)(ok ? row : 0) * Hkv + h;
          mma::cp_async4(vd + S::kTile + (kside ? 0 : kKeys * 4) + j * 4,
                         (kside ? ks : vs) + g, ok);
        }
      }
    }
    mma::cp_commit();   // one group per tile, empty past the range
  };

  // tiles 0 .. kStages-2 in flight before the prologue's own work; then
  // at tile i, tile i + kStages - 1 is issued and the rows of i + kStages
  // loaded
  int ahead[kStages - 1];
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) ahead[i] = row_of(i);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i, ahead[i]);
  int next_row = row_of(kStages - 1);
  pre(qs, kfr, vfr, fsc);
  __syncthreads();

  // the G rows: per lane D/32 dims of each (CUDA cores), or as bf16 A
  // fragments of the m16n8k16 product, rows g = lane / 4 < G (tensor
  // cores; q is exact in bf16, as the model dtype holds it)
  float qreg[kMma ? 1 : G][DL];
  uint32_t qa[kMma ? D / 16 : 1][2];
  if constexpr (kMma) {
    const int g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const float* qr = qs + g * D + 16 * kk + c;
      qa[kk][0] = g < G ? mma::pack_bf16(qr[0], qr[1]) : 0u;
      qa[kk][1] = g < G ? mma::pack_bf16(qr[8], qr[9]) : 0u;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < DL; ++e) qreg[g][e] = qs[g * D + lane * DL + e];
  }
  float acc[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;
  float m_w = kNegInf, l_w = 0.f;       // the warp's state of row g
  const float sl = scale * kLog2e;                  // no softcap
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;

  for (int i = 0; i < ntiles; ++i) {
    const int t0 = t_begin + i * kKeys;
    unsigned char* st = sm + stage_at(i);
    mma::cp_wait<kStages - 2>();       // tile i has landed (own copies)
    const int jf = t_fresh - t0 - warp * kKeysPerWarp;
    if (jf >= 0 && jf < kKeysPerWarp) {
      const int j = t_fresh - t0;       // the fresh row, as stored
      for (int c = lane; c < S::kRow / 4; c += 32) {
        reinterpret_cast<uint32_t*>(st + j * S::kKRow)[c] =
            reinterpret_cast<const uint32_t*>(kfr)[c];
        reinterpret_cast<uint32_t*>(st + S::kTileK + j * S::kRow)[c] =
            reinterpret_cast<const uint32_t*>(vfr)[c];
      }
      if constexpr (kQuant) {
        if (lane < 2)
          reinterpret_cast<float*>(st + S::kTileK + S::kTile)[lane * kKeys +
                                                              j] = fsc[lane];
      }
    }
    __syncwarp();                      // the warp's rows, every lane's
    issue(i + kStages - 1, next_row);
    next_row = row_of(i + kStages);
    const float* ksc =
        reinterpret_cast<const float*>(st + S::kTileK + S::kTile);
    const float* vsc = ksc + kKeys;

    // scores of the warp's 8 keys against the G rows
    float part[kMma ? 4 : NV];
    if constexpr (kMma) {
      // S (16 x 8, rows >= G zero) = Q (16 x D) K^T (D x 8 keys): the B
      // fragment of lane (g, t) is key 8w + g, dims 16kk + 2t (+1) and
      // 16kk + 2t + 8 (+1); int8 keys convert exactly to bf16, and their
      // scale multiplies the score
      const unsigned char* kr =
          st + (warp * kKeysPerWarp + lane / 4) * S::kKRow;
      const int c = 2 * (lane % 4);
      float odd[4] = {0.f, 0.f, 0.f, 0.f};   // two chains of products
#pragma unroll
      for (int e = 0; e < 4; ++e) part[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        if constexpr (kQuant) {
          const int8_t* k8 = reinterpret_cast<const int8_t*>(kr) + 16 * kk;
          b0 = mma::pack_bf16((float)k8[c], (float)k8[c + 1]);
          b1 = mma::pack_bf16((float)k8[c + 8], (float)k8[c + 9]);
        } else {
          const uint32_t* k16 =
              reinterpret_cast<const uint32_t*>(kr + 32 * kk);
          b0 = k16[c / 2];
          b1 = k16[c / 2 + 4];
        }
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        if (kk % 2)
          mma::mma_bf16(odd, a, b0, b1);
        else
          mma::mma_bf16(part, a, b0, b1);
      }
      part[0] += odd[0];
      part[1] += odd[1];
      if constexpr (kQuant) {
        part[0] *= ksc[warp * kKeysPerWarp + c];
        part[1] *= ksc[warp * kKeysPerWarp + c + 1];
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kKeysPerWarp; ++jj) {
        const int j = warp * kKeysPerWarp + jj;
        float kx[DL];
        lane_row<TP, DL>(st + j * S::kKRow, lane, kQuant ? ksc[j] : 1.f,
                         kx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < DL; ++e) s = fmaf(qreg[g][e], kx[e], s);
          part[g * kKeysPerWarp + jj] = s;
        }
#pragma unroll
        for (int g = G; g < GP; ++g) part[g * kKeysPerWarp + jj] = 0.f;
      }
      ReduceScatter<NV, 16>::run(part, lane);
    }

    // the warp's online-softmax update: lane holds totals idx0 .. idx0 +
    // NL - 1 of its row g (the 32/GP lanes of a row share its m and l)
    const int idx0 = lane / kDup * NL;
    const int jj0 = idx0 % kKeysPerWarp;
    const bool row_ok = idx0 / kKeysPerWarp < G;    // not mma padding
    float x[NL];
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const float raw = part[u];
      float v = softcap > 0.f ? cap_out * tanhf(raw * cap_in) : raw * sl;
      v = t0 + warp * kKeysPerWarp + jj0 + u < t_hi ? v : kNegInf;
      x[u] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int off = 1; off < kRowLanes; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float m_new = fmaxf(m_w, mx);
    const float alpha = exp2f(m_w - m_new);   // 1 while the row saw no key
    float ps = 0.f;
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const float p = x[u] == kNegInf ? 0.f : exp2f(x[u] - m_new);
      if (lane % kDup == 0 && row_ok) {
        pw[idx0 + u] = p;
        ps += p;
      }
    }
#pragma unroll
    for (int off = 1; off < kRowLanes; off <<= 1)
      ps += __shfl_xor_sync(kFull, ps, off);
    l_w = l_w * alpha + ps;
    m_w = m_new;
    if (lane % kRowLanes == 0 && row_ok) aw[lane / kRowLanes] = alpha;
    __syncwarp();

    // O += P V over the warp's 8 keys, P in f32
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = aw[g];
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[g][e] *= a;
    }
    float pr[G][kKeysPerWarp];           // the warp's P, 16-byte reads
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int q4 = 0; q4 < kKeysPerWarp / 4; ++q4) {
        const float4 p4 =
            reinterpret_cast<const float4*>(pw + g * kKeysPerWarp)[q4];
        pr[g][4 * q4] = p4.x;
        pr[g][4 * q4 + 1] = p4.y;
        pr[g][4 * q4 + 2] = p4.z;
        pr[g][4 * q4 + 3] = p4.w;
      }
#pragma unroll
    for (int jj = 0; jj < kKeysPerWarp; ++jj) {
      const int j = warp * kKeysPerWarp + jj;
      float vx[DL];
      lane_row<TP, DL>(st + S::kTileK + j * S::kRow, lane,
                       kQuant ? vsc[j] : 1.f, vx);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < DL; ++e)
          acc[g][e] = fmaf(pr[g][jj], vx[e], acc[g][e]);
    }
  }
  mma::cp_wait<0>();
  __syncthreads();                     // the ring is free: partial sums

  // merge the warps' (m, l, acc): row g's state sits in lane g * 32/GP
  // (CUDA cores) or 4g (tensor cores)
  float* red = reinterpret_cast<float*>(sm);       // [warp][G][D]
  float* red_m = sp;                               // [warp][G]
  float* red_l = sp + kWarps * G;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < DL; ++e)
      red[(warp * G + g) * D + lane * DL + e] = acc[g][e];
  if (lane % kRowLanes == 0 && lane / kRowLanes < G) {
    red_m[warp * G + lane / kRowLanes] = m_w;
    red_l[warp * G + lane / kRowLanes] = l_w;
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w * G + g]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no key has l = 0 and acc = 0
      const float f = exp2f(red_m[w * G + g] - m);
      o += f * red[w * G * D + idx];
      l += f * red_l[w * G + g];
    }
    if (ws_o == nullptr) {
      out[row0 * D + idx] = from_f32<T>(l > 0.f ? o / l : 0.f);
    } else {
      const size_t w = (size_t)split * ws_rows + row0 + g;
      ws_o[w * D + (idx % D)] = o;
      if (idx % D == 0) {
        ws_ml[2 * w] = l > 0.f ? m : kNegInf;
        ws_ml[2 * w + 1] = l;
      }
    }
  }
}

}  // namespace split
}  // namespace repro_torch
