// Decode attention for Hopper (sm_90a): a chunk of C query rows against a
// KV cache, read either contiguously (K5) or through a block table (K6).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K5  distributed_tensorflow_guide_tpu/ops/decode_attention.py
//       _decode_kernel (launcher decode_attention)
//   K6  distributed_tensorflow_guide_tpu/ops/decode_attention.py
//       _paged_decode_kernel (launcher paged_decode_attention)
// One source serves both: the PAGED parameter decides whether KV row p of
// request b lives at cache row (b, h, p) or at pool row
// (table[b, p / bs], h, p % bs).
//
// What bounds it: HBM bytes at decode widths. Each call must read the live
// slice of the cache once (K and V rows up to the chunk's last position,
// plus the f32 scale per row when the cache is int8) and read and write
// the q chunk once (decode_kernel_hbm_bytes() in decode_attention.py). A
// decode step does 4 * L * hd flops per (b, h) against 4 * L * hd bytes;
// a prefill chunk of C rows does C times the flops on the same bytes, so
// from ten rows on the products matter too. The wrapper picks one of
// two regimes from C, which the host knows:
//
// Regime 1, split-KV (decode steps and short chunks; the f32 route at any
// C): decode_split_kernel. The key axis is cut into splits of a fixed
// number of absolute positions, which the wrapper passes in (its
// split_keys(): 256, half that for f32 rows wider than 64), so a
// request's partials never depend on its batch-mates, and the grid's
// split count comes from the cache's capacity (K5's S, K6's table width
// x block size), never from a live length: the lengths (K6) and the
// write index (K5) stay in device memory, the host reads none of them,
// and one captured CUDA graph replays at any position. dispatch() refuses
// a plan whose splits do not cover the capacity or whose keys do not fit
// a CTA. A split that starts at or past what its rows can see writes an
// empty partial and exits. A CTA owns one split of one (b, h) and 1 (a
// decode step) or kRows query rows:
//   * each of its 8 warps owns 32 keys of the split (16 for the wide f32
//     rows) from load to partial: it issues their K/V rows with cp.async
//     (16 bytes a lane where the row allows) before anything waits, so
//     the whole split is in flight at once (64 KB a CTA at bf16, hd 64);
//     rows past what the CTA's rows can see are never loaded;
//   * a lane scores its key against every row (q in shared memory), the
//     warp takes its softmax with shuffles, P goes through the warp's
//     slice of shared memory, and P V gives each lane 8 head-dim columns
//     of every fourth (hd <= 64) or second key, the key groups summed by
//     shuffles; no block-wide barrier until the warps' partials merge, in
//     warp order;
//   * with one split the CTA writes O; else its (m, l, acc) go to an f32
//     workspace and decode_combine_kernel merges each row's splits in
//     split order (bitwise repeatable). A split that starts past what its
//     rows can see leaves an empty partial (m = NEG_INF, l = 0).
// K and V rows sit in shared memory as 16-byte chunks, swizzled (chunk c
// of row j at c ^ (j % 8)) where a row is a power of two of chunks and
// padded by a chunk otherwise, so the 8 rows 8 lanes read at once fall in
// different banks.
//
// Regime 2, tensor cores (chunks of C >= CHUNK_MIN_ROWS = 10 rows, fixed
// in decode_attention.py by measurement; bf16 queries, a bf16 or int8
// cache, hd a multiple of 8): decode_chunk_sm90. A CTA owns 64
// query rows of one (b, h): one consumer warpgroup keeps S, P and O in
// registers, S = Q K^T and O += P V run as wgmma (P rounded to bf16 as
// the A operand), as in flash_fwd_sm90; a producer warpgroup loads Q once
// and streams 64-key K/V tiles through a 3-stage mbarrier ring: by TMA
// for K5's bf16 cache where the whole tile lies below the last position
// the CTA's rows can see (the tensor map covers all S rows: the live
// length is a device value), by cp.async gathers, which write zeros for
// the rows past that position, for the tile that position crosses, for
// K6 (through the block table) and for int8 (one 16-byte copy per row
// piece). An int8 tile lands raw and the producer converts it to bf16 in
// shared memory (exact: |v| <= 127). Only tiles that the diagonal or the
// live length crosses are masked (every score column past either is
// -inf), and the KV loop ends at the last position the CTA's rows can
// see.
//
// Every product that could meet an add is written as an explicit fmaf or
// a rounded __fmul_rn / __fsub_rn, so no template instance (K5 or K6, 1 or
// kRows rows) contracts it otherwise: a query row's output has the same
// bits whether it comes alone (a decode step) or as a row of a chunk (a
// speculative verify chunk, an engine step), through K5 or through K6.
//
// In both regimes an int8 cache moves over the wire as int8: the per-row
// k scale folds into the score columns and the v scale into P's columns
// after l has summed the raw p, never into a dequantised copy. Rows at or
// past a request's live length are never read (zero-filled in shared
// memory instead), so whatever the cache holds there (in speculative
// decoding, the k/v of rejected drafts) cannot reach the output, not even
// as 0 * NaN. Any head dim up to 128: columns past hd
// are zero in shared memory.
//
// Layouts (row-major, contiguous):
//   q, out   (B, C, H, hd)                      query dtype (f32 or bf16)
//   K5 k, v  (B, H, S, hd)   scales (B, H, 1, S) f32 when int8
//   K6 k, v  (N, H, bs, hd)  scales (N, H, 1, bs) f32 when int8
//   tables   (B, n_blk) int32, lengths (B,) int32 (K6)
//   index    (1,) int32 (K5): the chunk's first position; every request's
//            live length is index + C (clamped to [1, S])
//   ws       f32 workspace: acc (B, H, C, n_splits, hd), then (m, l)
//            (B, H, C, n_splits, 2); used when n_splits > 1
// Query row c of request b sits at position length - C + c; key p is
// visible to it when p <= that position (causal within the chunk, and
// every unwritten slot hidden).

#include <type_traits>

#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSplitWarps = 8;   // warps of a split CTA, up to 32 keys each
constexpr int kMaxSplitKeys = kSplitWarps * 32;  // a lane holds one key
constexpr int kSmemCap = 227 * 1024;  // dynamic shared memory of a CTA
constexpr int kRows = 8;         // query rows per split CTA (1 at C = 1)
constexpr int kChunkThreads = 256;  // consumer warpgroup, producer warpgroup
constexpr int kChunkStages = 3;
constexpr int kMaxHd = 128;

template <typename T>
constexpr bool kQuant = std::is_same<T, int8_t>::value;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte vector of cache elements -> floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& raw, float* out) {
    const float* p = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = p[e];
  }
};
template <> struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int kN = 16;
  __device__ static void unpack(const uint4& raw, float* out) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = static_cast<float>(p[e]);
  }
};

// Eight cache elements (columns 8 cb .. 8 cb + 7) of a row in shared
// memory -> floats: ``at0`` is the byte offset of their first 16-byte
// chunk, ``at1`` that of the next chunk (f32 spans two).
template <typename TC>
__device__ __forceinline__ void load8(const uint8_t* base, int at0, int at1,
                                      float (&out)[8]);
template <>
__device__ __forceinline__ void load8<bf16>(const uint8_t* base, int at0,
                                            int, float (&out)[8]) {
  Vec<bf16>::unpack(*reinterpret_cast<const uint4*>(base + at0), out);
}
template <>
__device__ __forceinline__ void load8<float>(const uint8_t* base, int at0,
                                             int at1, float (&out)[8]) {
  Vec<float>::unpack(*reinterpret_cast<const uint4*>(base + at0), out);
  Vec<float>::unpack(*reinterpret_cast<const uint4*>(base + at1), out + 4);
}
template <>
__device__ __forceinline__ void load8<int8_t>(const uint8_t* base, int at0,
                                              int, float (&out)[8]) {
  const int8_t* p = reinterpret_cast<const int8_t*>(base + at0);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = static_cast<float>(p[e]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- cp.async ----

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of the thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The widest piece (16, 8, 4, 2 or 1 bytes) that every row of
// ``row_bytes`` bytes starts on, given a 16-byte aligned base.
__device__ __forceinline__ int piece_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16
         : row_bytes % 8 == 0 ? 8
         : row_bytes % 4 == 0 ? 4
         : row_bytes % 2 == 0 ? 2
                              : 1;
}

// One piece of ``n`` bytes from device to shared memory: asynchronously
// for 4 bytes and up, else through a register.
__device__ __forceinline__ void copy_piece(uint8_t* dst, const uint8_t* src,
                                           int n) {
  switch (n) {
    case 16: cp_async<16>(dst, src); break;
    case 8: cp_async<8>(dst, src); break;
    case 4: cp_async<4>(dst, src); break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
      break;
    default: *dst = *src;
  }
}

// Cache row of key position p for (b, h): the scale of that row sits at
// the same index, the K/V vector at index * hd.
template <bool PAGED>
__device__ __forceinline__ long long kv_row(int b, int h, int p, int H,
                                            int seq, const int* tables,
                                            int n_blk) {
  if (PAGED) {
    const int blk = tables[(long long)b * n_blk + p / seq];
    return ((long long)blk * H + h) * seq + p % seq;
  }
  return ((long long)b * H + h) * seq + p;
}

// A request's live length, read on the device: K6's per-request length
// (at least 1), K5's write index + C (within [1, S]).
template <bool PAGED>
__device__ __forceinline__ int live_length(const int* lengths, int b, int C,
                                           int seq) {
  if (PAGED) return max(lengths[b], 1);
  return min(max(lengths[0] + C, 1), seq);
}

// ==== regime 1: split-KV ==================================================

// Bytes of a K or V row in shared memory: the row rounded up to 16-byte
// chunks; a power-of-two count of chunks is swizzled (chunk c of row j at
// c ^ (j % 8)), any other count padded by one chunk, so that the 8 rows
// that 8 lanes read at once fall in different banks.
__host__ __device__ constexpr int split_chunks(int hd, int elem) {
  return (hd * elem + 15) / 16;
}
__host__ __device__ constexpr bool split_swizzled(int hd, int elem) {
  return (split_chunks(hd, elem) & (split_chunks(hd, elem) - 1)) == 0;
}
__host__ __device__ constexpr int split_pitch(int hd, int elem) {
  return split_chunks(hd, elem) * 16 + (split_swizzled(hd, elem) ? 0 : 16);
}
// K and V rows of the whole split, reused at the end for the warps'
// partial accumulators ([8 warps][R][HDP] f32), then q, then each warp's
// P (R x 32) and (m, l) per row.
template <int HDP, int R>
__host__ __device__ constexpr int split_smem(int keys, int hd, int elem) {
  return (2 * keys * split_pitch(hd, elem) > kSplitWarps * R * HDP * 4
              ? 2 * keys * split_pitch(hd, elem)
              : kSplitWarps * R * HDP * 4) +
         R * HDP * 4 + kSplitWarps * R * (32 + 2) * 4;
}

// grid (n_splits, ceil(C / R), B * H), kSplitWarps warps; R query rows
// a CTA (1 for a decode step, kRows for a short chunk). ``seq`` is S for
// the contiguous cache and the block size for the pool; ``keys`` the keys
// of a split. Warp w owns keys [kv_lo + w * kw, kv_lo + (w + 1) * kw) of
// the CTA's split (kw = keys / 8, at most 32) and takes them from its own
// loads to its own (m, l, acc): lane j holds key j for the scores, P goes
// through the warp's slice of shared memory, and a lane owns two head-dim
// columns (per 64) for P V. The warps' partials merge once, in warp
// order, at the end.
template <typename TQ, typename TC, bool PAGED, int HDP, int R>
__global__ void __launch_bounds__(kSplitWarps * 32)
decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                    const TC* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    TQ* __restrict__ out, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int C, int H, int hd,
                    int seq, int n_blk, int keys, float scale) {
  constexpr bool QUANT = kQuant<TC>;
  constexpr int kThreads = kSplitWarps * 32;
  extern __shared__ __align__(16) uint8_t smem[];

  const int elem = sizeof(TC);
  const int kw = keys / kSplitWarps;  // keys a warp owns
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int r0 = blockIdx.y * R;
  const int rows = min(R, C - r0);
  const int length = live_length<PAGED>(lengths, b, C, seq);
  const int q_base = length - C;  // position of chunk row 0
  // the split's keys, up to the last position the CTA's rows can see
  const int kv_lo = split * keys;
  const int kv_end = min(kv_lo + keys, max(0, min(length, q_base + r0 + rows)));
  const long long row0 = ((long long)b * H + h) * C + r0;  // (B, H, C) row
  if (n_splits > 1 && kv_end <= kv_lo) {  // past the live keys: empty
    for (int i = threadIdx.x; i < rows * hd; i += kSplitWarps * 32) {
      const int r = i / hd, d = i % hd;
      ws_acc[((row0 + r) * n_splits + split) * hd + d] = 0.f;
      if (d == 0) {
        ws_ml[((row0 + r) * n_splits + split) * 2] = kNegInf;
        ws_ml[((row0 + r) * n_splits + split) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_bytes = hd * elem;
  const int chunks = split_chunks(hd, elem);
  const int pitch = split_pitch(hd, elem);
  const int swz = split_swizzled(hd, elem) ? min(chunks, 8) - 1 : 0;
  const int kv_bytes = 2 * keys * pitch;
  uint8_t* k_s = smem;                 // [keys][pitch]
  uint8_t* v_s = smem + keys * pitch;  // [keys][pitch]
  float* q_s = reinterpret_cast<float*>(
      smem + max(kv_bytes, kSplitWarps * R * HDP * 4));
  float* p_w = q_s + R * HDP + warp * R * 32;  // this warp's P, [R][32]
  float* m_w = q_s + R * HDP + kSplitWarps * R * 32;  // [warps][R]
  float* l_w = m_w + kSplitWarps * R;
  // byte offset of byte o of row j (its 16-byte chunk swizzled by j)
  auto at = [&](int j, int o) {
    return j * pitch + ((((o >> 4) ^ (j & swz))) << 4) + (o & 15);
  };

  // rows whose bytes end inside a chunk: that chunk's tail stays zero
  if (chunks * 16 != row_bytes) {
    for (int j = tid; j < 2 * keys; j += kThreads)
      *reinterpret_cast<uint4*>(smem + at(j % keys, row_bytes & ~15) +
                                (j / keys) * keys * pitch) =
          make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // the warp's own keys: every copy issued before anything waits
  const int p0 = kv_lo + warp * kw;
  const int valid = max(0, min(kw, kv_end - p0));
  const int piece = piece_bytes(row_bytes);
  const int pieces = row_bytes / piece;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(k);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(v);
  if (piece == 16 && 32 % pieces == 0) {  // rows of 1-32 whole chunks
    const int step = 32 / pieces, o = (lane % pieces) * 16;
    for (int j = lane / pieces; j < valid; j += step) {
      const int jj = warp * kw + j;  // row in the split
      const long long src =
          kv_row<PAGED>(b, h, p0 + j, H, seq, tables, n_blk) * row_bytes + o;
      cp_async<16>(k_s + at(jj, o), kb + src);
      cp_async<16>(v_s + at(jj, o), vb + src);
    }
  } else {
    for (int i = lane; i < valid * pieces; i += 32) {
      const int j = i / pieces, o = (i % pieces) * piece;
      const int jj = warp * kw + j;
      const long long src =
          kv_row<PAGED>(b, h, p0 + j, H, seq, tables, n_blk) * row_bytes + o;
      copy_piece(k_s + at(jj, o), kb + src, piece);
      copy_piece(v_s + at(jj, o), vb + src, piece);
    }
  }
  cp_async_commit();
  const bool mine = lane < valid;  // lane holds key p0 + lane
  float ksc = 1.f, vsc = 1.f;
  if (QUANT && mine) {
    const long long r = kv_row<PAGED>(b, h, p0 + lane, H, seq, tables, n_blk);
    ksc = k_scale[r];
    vsc = v_scale[r];
  }
  for (int i = tid; i < R * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    q_s[i] = (r < rows && d < hd)
                 ? to_float(q[(((long long)b * C + r0 + r) * H + h) * hd + d])
                 : 0.f;
  }
  __syncthreads();  // q is in
  cp_async_wait<0>();
  __syncwarp();     // the warp's rows are in

  // scores of the lane's key against every row, then the warp's softmax
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  if (mine) {
    const int jj = warp * kw + lane;
#pragma unroll 4
    for (int c = 0; c < chunks; ++c) {
      constexpr int kN = Vec<TC>::kN;
      float f[kN];
      Vec<TC>::unpack(*reinterpret_cast<const uint4*>(k_s + at(jj, c * 16)),
                      f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float* qr = q_s + r * HDP + c * kN;
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < kN; ++e) a = fmaf(f[e], qr[e], a);
          s[r] += a;
        }
      }
    }
  }
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    p_w[r * 32 + lane] = 0.f;
    if (r < rows) {  // uniform across the warp
      float x = kNegInf;
      if (mine && p0 + lane <= q_base + r0 + r) {
        x = __fmul_rn(s[r], scale);
        if (QUANT) x = __fmul_rn(x, ksc);  // k dequant: the score column
      }
      m[r] = warp_max(x);
      const float p =
          x <= kNegInf * 0.5f ? 0.f : expf(__fsub_rn(x, m[r]));
      l[r] = warp_sum(p);
      p_w[r * 32 + lane] = QUANT ? __fmul_rn(p, vsc) : p;  // v, after l
    }
  }
  __syncwarp();

  // P V over the warp's keys: lane owns 8 columns, 8 cb .. 8 cb + 7, of
  // every kGroups-th key; the key groups are summed by shuffles after
  constexpr int kBlocks = HDP / 8;        // column blocks of 8
  constexpr int kGroups = 32 / kBlocks;   // 4 (HDP 64) or 2 (HDP 128)
  const int cb = lane % kBlocks, kg = lane / kBlocks;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  if (8 * cb < hd) {
#pragma unroll 2
    for (int j = kg; j < valid; j += kGroups) {
      float vv[8];
      load8<TC>(v_s, at(warp * kw + j, 8 * cb * elem),
                at(warp * kw + j, 8 * cb * elem + 16), vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = p_w[r * 32 + j];  // 0 for a row past C
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int o = kBlocks; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);

  // the warps' partials, merged in warp order: the split's (m, l, acc)
  __syncthreads();  // every warp is done with K and V
  float* red = reinterpret_cast<float*>(smem);  // [warps][R][HDP]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      m_w[warp * R + r] = m[r];
      l_w[warp * R + r] = l[r];
    }
    if (kg == 0) {
      float* dst = red + (warp * R + r) * HDP + 8 * cb;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) M = fmaxf(M, m_w[w * R + r]);
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float e = expf(m_w[w * R + r] - M);
      L = fmaf(e, l_w[w * R + r], L);
      a = fmaf(e, red[(w * R + r) * HDP + d], a);
    }
    if (n_splits == 1) {
      out[(((long long)b * C + r0 + r) * H + h) * hd + d] =
          from_float<TQ>(a / (L == 0.f ? 1.f : L));
    } else {
      ws_acc[((row0 + r) * n_splits + split) * hd + d] = a;
      if (d == 0) {
        ws_ml[((row0 + r) * n_splits + split) * 2] = M;
        ws_ml[((row0 + r) * n_splits + split) * 2 + 1] = L;
      }
    }
  }
}

// grid ceil(B * H * C / 4), 128 threads: one warp merges the splits of one
// (b, h, c) row, in split order: O = sum_s e^(m_s - M) acc_s /
// sum_s e^(m_s - M) l_s with M the largest m_s. An empty split (m =
// NEG_INF, l = 0) adds nothing; a row with l = 0 gives 0.
template <typename TQ>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ ws_acc,
                      const float* __restrict__ ws_ml, TQ* __restrict__ out,
                      int B, int C, int H, int hd, int n_splits) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= (long long)B * H * C) return;
  const int lane = threadIdx.x & 31;
  const int c = row % C, h = (row / C) % H, b = row / ((long long)C * H);
  const float* ml = ws_ml + row * n_splits * 2;
  float M = kNegInf;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f;
  for (int s = 0; s < n_splits; ++s)
    L = fmaf(expf(ml[2 * s] - M), ml[2 * s + 1], L);
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  TQ* orow = out + (((long long)b * C + c) * H + h) * hd;
  for (int d = lane; d < hd; d += 32) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      a = fmaf(expf(ml[2 * s] - M), ws_acc[(row * n_splits + s) * hd + d],
               a);
    orow[d] = from_float<TQ>(a * inv);
  }
}

// ==== regime 2: prefill chunks on the tensor cores ==========================
//
// Shared memory, from a 1024-byte aligned base: the Q tile, then
// kChunkStages ring stages of [K tile | V tile | raw int8 K | raw int8 V |
// k scales | v scales] (the raw parts and scales for int8 only), then the
// full and empty mbarriers. Tiles are bf16 in the 128-byte swizzled layout
// (HDP / 64 boxes of 64 rows x 128 bytes); a raw int8 tile is 64 rows of
// HDP bytes.
template <int HDP, bool QUANT>
struct ChunkLayout {
  static constexpr int kTileBytes = (HDP / kAtomCols) * kBoxBytes;
  static constexpr int kRawBytes = QUANT ? kTile * HDP : 0;
  static constexpr int kScaleBytes = QUANT ? 2 * kTile * 4 : 0;
  // a whole number of the 1024-byte atoms that the swizzle repeats over,
  // so that every stage's tiles start on one (wgmma and TMA read the
  // swizzle from the address bits)
  static constexpr int kStageBytes =
      (2 * kTileBytes + 2 * kRawBytes + kScaleBytes + 1023) / 1024 * 1024;
  static constexpr int kDataBytes = kTileBytes + kChunkStages * kStageBytes;
  static constexpr int kSmem =
      1024 + kDataBytes + 2 * kChunkStages * (int)sizeof(uint64_t);
};

// Byte offset of bf16 column d (a multiple of 8) of row r in a swizzled
// tile: its box, its row, and its 16-byte chunk swizzled by the row.
__device__ __forceinline__ int sw128_offset(int r, int d) {
  const int c = d / 8;
  return (c / 8) * kBoxBytes + r * 128 + (((c % 8) ^ (r % 8)) * 16);
}

// Eight int8 values (one 8-byte load) as eight bf16 (exact: |x| <= 127),
// packed in column order.
__device__ __forceinline__ uint4 int8x8_to_bf16(uint2 x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? x.x : x.y;
    const int sh = 16 * (i & 1);
    w[i] = pack_bf16(static_cast<float>(static_cast<int8_t>(word >> sh)),
                     static_cast<float>(static_cast<int8_t>(word >> (sh + 8))));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The generic-proxy writes (cp.async, st.shared) this thread made to the
// tiles, made visible to the tensor cores' reads (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One KV tile of 64 keys merged into the warpgroup's 64 rows; q_s, k_s,
// v_s: shared addresses of the swizzled Q, K and V tiles; ks, vs: the
// tile's int8 scales. The thread holds rows qpos[0] and qpos[1] =
// qpos[0] + 8; accumulator entry i sits in row (i >> 1) & 1 at column
// 8 (i >> 2) + 2 (lane & 3) + (i & 1). Scores are scaled (and, for int8,
// multiplied by their k scale) before the max; a masked score (key past
// kv_end or past the row's position) is -inf, so its p is exactly 0; the
// row's m starts at the finite NEG_INF, so its first live tile gets
// alpha = 0, never NaN. l sums the f32 p; P (times its v scale for int8)
// enters P V as bf16.
template <int HDP, bool QUANT>
__device__ __forceinline__ void chunk_tile(float (&o)[HDP / 2],
                                           float (&m)[2], float (&l)[2],
                                           const int (&qpos)[2],
                                           uint32_t q_s, uint32_t k_s,
                                           uint32_t v_s,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs,
                                           int kv0, int kv_end, bool mask,
                                           float scale) {
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
  wgmma_scores<HDP>(s, q_s, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  const int c0 = 2 * (threadIdx.x & 3);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = c0 + 8 * (i >> 2) + (i & 1);
    float x = __fmul_rn(s[i], scale);
    if (QUANT) x = __fmul_rn(x, ks[col]);  // k dequant: the score column
    if (mask && (kv0 + col >= kv_end || kv0 + col > qpos[(i >> 1) & 1]))
      x = -INFINITY;
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float mb[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f((m[r] - m_new) * kLog2e);
    mb[r] = m_new * kLog2e;
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float p = exp2f(fmaf(s[i], kLog2e, -mb[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += p;
    if (QUANT) p = __fmul_rn(p, vs[c0 + 8 * (i >> 2) + (i & 1)]);  // v
    s[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = fmaf(l[r], alpha[r], rs[r]);
  }
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

  uint32_t a[4][4];  // P stays in registers
  pack_a(a, s);
  wgmma_fence();
  fence_regs(o);
  wgmma_accumulate<HDP>(o, a, v_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(a);
}

// grid (ceil(C / 64), H, B), kChunkThreads threads; the last query tiles,
// which see the most keys, launch first. Warpgroup 0 consumes, warpgroup
// 1 produces: it loads the CTA's Q rows once (cp.async, part of tile 0's
// arrival) and the K/V tiles up to kv_end, the last position the CTA's
// rows can see, through the ring. kTma: K5's bf16 cache by TMA from
// tm_k, tm_v (one thread expects the bytes, an arrival of its own), else
// every producer thread gathers 16-byte pieces with cp.async. Either way
// each producer thread waits for its own copies (Q's ride with tile 0)
// one tile behind, converts its int8 pieces to bf16, fences its writes
// for the tensor cores and arrives. The full barriers count the
// producer's 128 threads (and, with TMA, the expecting arrival), the
// empty ones the consumer's 4 warps.
template <int HDP, bool PAGED, bool QUANT, bool kTma>
__global__ void __launch_bounds__(kChunkThreads, 1)
decode_chunk_sm90(const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const bf16* __restrict__ q, const void* __restrict__ k,
                  const void* __restrict__ v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths,
                  bf16* __restrict__ out, int C, int H, int hd, int seq,
                  int n_blk, float scale) {
  using Lay = ChunkLayout<HDP, QUANT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* ring = q_s + Lay::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::kDataBytes);
  uint64_t* empty = full + kChunkStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int length = live_length<PAGED>(lengths, b, C, seq);
  const int q_base = length - C;  // position of chunk row 0
  const int row_last = min(q0 + kTile, C) - 1;
  const int kv_end = max(0, min(length, q_base + row_last + 1));
  const int n_kv = (kv_end + kTile - 1) / kTile;
  const int tid = threadIdx.x;

  // zero tiles: head-dim padding, rows past C and keys past kv_end read 0
  for (int i = tid * 16; i < Lay::kDataBytes; i += kChunkThreads * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  fence_async_shared();
  if (tid == 0) {
    for (int s = 0; s < kChunkStages; ++s) {
      mbar_init(&full[s], kTma ? 129 : 128);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // producer
    const int pt = tid - 128;
    const int nq = hd / 8;  // 16-byte bf16 pieces of a row
    for (int i = pt; i < kTile * nq; i += 128) {
      const int r = i / nq, c = i % nq;
      if (q0 + r < C)
        cp_async<16>(q_s + sw128_offset(r, 8 * c),
                     q + (((long long)b * C + q0 + r) * H + h) * hd + 8 * c);
    }
    const int rb = QUANT ? (hd % 16 == 0 ? 16 : 8) : 16;  // bytes a piece
    const int np = QUANT ? hd / rb : nq;                  // pieces a row
    const int8_t* k8 = static_cast<const int8_t*>(k);
    const int8_t* v8 = static_cast<const int8_t*>(v);
    const bf16* k16 = static_cast<const bf16*>(k);
    const bf16* v16 = static_cast<const bf16*>(v);

    // tile `it`'s copies have landed for this thread: convert, fence, arrive
    auto finish = [&](int it) {
      const int st = it % kChunkStages;
      uint8_t* stage = ring + st * Lay::kStageBytes;
      if (QUANT) {
        const int valid = min(kTile, kv_end - it * kTile);
        for (int side = 0; side < 2; ++side) {
          const int8_t* raw = reinterpret_cast<const int8_t*>(
              stage + 2 * Lay::kTileBytes + side * Lay::kRawBytes);
          uint8_t* tile = stage + side * Lay::kTileBytes;
          for (int i = pt; i < kTile * np; i += 128) {
            const int j = i / np, c = i % np;
            for (int u = 0; u < rb / 8; ++u) {  // 8 values -> one chunk
              uint4 w = make_uint4(0u, 0u, 0u, 0u);
              if (j < valid)
                w = int8x8_to_bf16(*reinterpret_cast<const uint2*>(
                    raw + j * HDP + c * rb + 8 * u));
              *reinterpret_cast<uint4*>(
                  tile + sw128_offset(j, c * rb + 8 * u)) = w;
            }
          }
        }
      }
      fence_async_shared();
      mbar_arrive(&full[st]);
    };

    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kChunkStages, kv0 = it * kTile;
      const int valid = min(kTile, kv_end - kv0);
      uint8_t* stage = ring + st * Lay::kStageBytes;
      mbar_wait(&empty[st], ((it / kChunkStages) & 1) ^ 1);
      // TMA only for a whole tile of live rows: the map covers all S
      // rows, so the tile the live length crosses is gathered instead,
      // with zeros past it (its expecting arrival then is a plain one)
      if (kTma && valid == kTile) {
        if (pt == 0) {
          mbar_expect_tx(&full[st], 2 * Lay::kTileBytes);
          for (int a = 0; a < HDP / kAtomCols; ++a) {
            tma_load_box(stage + a * kBoxBytes, &tm_k, &full[st],
                         a * kAtomCols, h, kv0, b);
            tma_load_box(stage + Lay::kTileBytes + a * kBoxBytes, &tm_v,
                         &full[st], a * kAtomCols, h, kv0, b);
          }
        }
      } else {
        if (kTma && pt == 0) mbar_arrive(&full[st]);
        for (int i = pt; i < kTile * np; i += 128) {
          const int j = i / np, c = i % np;
          const long long row =
              j < valid
                  ? kv_row<PAGED>(b, h, kv0 + j, H, seq, tables, n_blk)
                  : 0;
          if (QUANT) {
            if (j < valid) {
              uint8_t* raw = stage + 2 * Lay::kTileBytes + j * HDP + c * rb;
              const long long src = row * hd + c * rb;
              if (rb == 16) {
                cp_async<16>(raw, k8 + src);
                cp_async<16>(raw + Lay::kRawBytes, v8 + src);
              } else {
                cp_async<8>(raw, k8 + src);
                cp_async<8>(raw + Lay::kRawBytes, v8 + src);
              }
            }
          } else {
            uint8_t* kd = stage + sw128_offset(j, 8 * c);
            uint8_t* vd = kd + Lay::kTileBytes;
            if (j < valid) {
              cp_async<16>(kd, k16 + row * hd + 8 * c);
              cp_async<16>(vd, v16 + row * hd + 8 * c);
            } else {  // a key past kv_end: zeros, never the cache's row
              *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
              *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
            }
          }
        }
        if (QUANT && pt < kTile) {
          float* sc = reinterpret_cast<float*>(stage + 2 * Lay::kTileBytes +
                                               2 * Lay::kRawBytes);
          if (pt < valid) {
            const long long r =
                kv_row<PAGED>(b, h, kv0 + pt, H, seq, tables, n_blk);
            cp_async<4>(sc + pt, k_scale + r);
            cp_async<4>(sc + kTile + pt, v_scale + r);
          } else {
            sc[pt] = sc[kTile + pt] = 0.f;
          }
        }
      }
      cp_async_commit();
      if (it > 0) {
        cp_async_wait<1>();
        finish(it - 1);
      }
    }
    cp_async_wait<0>();
    if (n_kv > 0) finish(n_kv - 1);
  } else {  // consumer
    const int r_a = 16 * (tid >> 5) + ((tid & 31) >> 2);  // tile rows r_a, +8
    const int qpos[2] = {q_base + q0 + r_a, q_base + q0 + r_a + 8};
    float o[HDP / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    const int first_row = q_base + q0;  // the tile's smallest position
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kChunkStages, kv0 = it * kTile;
      uint8_t* stage = ring + st * Lay::kStageBytes;
      const float* sc = reinterpret_cast<const float*>(
          stage + 2 * Lay::kTileBytes + 2 * Lay::kRawBytes);
      mbar_wait(&full[st], (it / kChunkStages) & 1);
      const bool mask = kv0 + kTile > kv_end || kv0 + kTile - 1 > first_row;
      chunk_tile<HDP, QUANT>(o, m, l, qpos, smem_u32(q_s), smem_u32(stage),
                             smem_u32(stage + Lay::kTileBytes), sc,
                             sc + kTile, kv0, kv_end, mask, scale);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[st]);
    }
    const int c0 = 2 * (tid & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = q0 + r_a + 8 * r;
      if (c >= C) continue;
      const float div = l[r] == 0.f ? 1.f : l[r];
      bf16* orow = out + (((long long)b * C + c) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int d = c0 + 8 * j;
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / div,
                                    o[4 * j + 2 * r + 1] / div);
      }
    }
  }
}

// ==== host side ===============================================================

// Codes the wrapper raises on, beside CUDA's own and the tensor-map codes.
constexpr int kBadCombination = -1;  // no kernel takes these dtypes / sizes

template <typename K>
int opt_in(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *tables, *lengths;  // K5: lengths is the (1,) write index
  void* out;
  float* ws;
  int B, C, H, hd, seq, n_blk;
  float scale;
  int n_splits, keys;  // the split plan; n_splits 0: the chunk regime
  cudaStream_t stream;
};

template <typename TQ, typename TC, bool PAGED, int HDP, int R>
int launch_split(const Args& a) {
  auto kernel = decode_split_kernel<TQ, TC, PAGED, HDP, R>;
  constexpr int elem = sizeof(TC);
  constexpr int most = split_smem<HDP, R>(kMaxSplitKeys, HDP, elem);
  constexpr int cap = most < kSmemCap ? most : kSmemCap;
  const int smem = split_smem<HDP, R>(a.keys, a.hd, elem);
  if (smem > cap) return kBadCombination;  // the split's rows do not fit
  static const int set = opt_in(kernel, cap);
  if (set) return set;
  const long long rows = (long long)a.B * a.H * a.C;
  float* ws_ml = a.n_splits > 1 ? a.ws + rows * a.n_splits * a.hd : nullptr;
  const dim3 grid(a.n_splits, (a.C + R - 1) / R, a.B * a.H);
  kernel<<<grid, kSplitWarps * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k),
      static_cast<const TC*>(a.v), a.ks, a.vs, a.tables, a.lengths,
      static_cast<TQ*>(a.out), a.ws, ws_ml, a.C, a.H, a.hd,
      a.seq, a.n_blk, a.keys, a.scale);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc || a.n_splits == 1) return rc;
  decode_combine_kernel<TQ><<<(rows + 3) / 4, 128, 0, a.stream>>>(
      a.ws, ws_ml, static_cast<TQ*>(a.out), a.B, a.C, a.H, a.hd,
      a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

// K5's bf16 cache (B, H, S, hd) as a 4-D (hd, H, S, B) map, boxes of 64
// columns x 64 rows. It covers every row: the live length is a device
// value, so the kernel loads by TMA only tiles that lie below it.
int map_cache(CUtensorMap* map, const void* base, const Args& a) {
  const cuuint64_t dims[4] = {(cuuint64_t)a.hd, (cuuint64_t)a.H,
                              (cuuint64_t)a.seq, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)a.seq * a.hd * sizeof(bf16),
      (cuuint64_t)a.hd * sizeof(bf16),
      (cuuint64_t)a.H * a.seq * a.hd * sizeof(bf16)};
  const cuuint32_t box[4] = {kAtomCols, 1, kTile, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                strides, box);
}

template <int HDP, bool PAGED, bool QUANT>
int launch_chunk(const Args& a) {
  constexpr bool kTma = !PAGED && !QUANT;
  auto kernel = decode_chunk_sm90<HDP, PAGED, QUANT, kTma>;
  constexpr int smem = ChunkLayout<HDP, QUANT>::kSmem;
  static const int set = opt_in(kernel, smem);
  if (set) return set;
  CUtensorMap tk{}, tv{};
  if (kTma) {
    int rc = map_cache(&tk, a.k, a);
    if (!rc) rc = map_cache(&tv, a.v, a);
    if (rc) return rc;
  }
  const dim3 grid((a.C + kTile - 1) / kTile, a.H, a.B);
  kernel<<<grid, kChunkThreads, smem, a.stream>>>(
      tk, tv, static_cast<const bf16*>(a.q), a.k, a.v, a.ks, a.vs, a.tables,
      a.lengths, static_cast<bf16*>(a.out), a.C, a.H, a.hd,
      a.seq, a.n_blk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, bool PAGED>
int launch_split_hd(const Args& a) {
  if (a.C == 1)
    return a.hd <= 64 ? launch_split<TQ, TC, PAGED, 64, 1>(a)
                      : launch_split<TQ, TC, PAGED, 128, 1>(a);
  return a.hd <= 64 ? launch_split<TQ, TC, PAGED, 64, kRows>(a)
                    : launch_split<TQ, TC, PAGED, 128, kRows>(a);
}

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (cache only). n_splits 0
// asks for the tensor-core regime (bf16 q, bf16 or int8 cache, hd a
// multiple of 8), else the split-KV regime with n_splits splits of
// ``keys`` keys, which must cover the capacity (K5: S; K6: the table's
// width x block size): a key past the splits would never be read.
template <bool PAGED>
int dispatch(int q_dtype, int kv_dtype, const Args& a) {
  if (a.hd < 1 || a.hd > kMaxHd || a.C < 1) return kBadCombination;
  if (a.n_splits != 0) {
    const long long span = PAGED ? (long long)a.n_blk * a.seq : a.seq;
    if (a.n_splits < 0 || a.keys < kSplitWarps || a.keys % kSplitWarps ||
        a.keys > kMaxSplitKeys || (long long)a.n_splits * a.keys < span)
      return kBadCombination;
  }
  if (a.n_splits == 0) {
    if (q_dtype != 1 || a.hd % 8) return kBadCombination;
    const bool narrow = a.hd <= 64;
    if (kv_dtype == 1)
      return narrow ? launch_chunk<64, PAGED, false>(a)
                    : launch_chunk<128, PAGED, false>(a);
    if (kv_dtype == 2)
      return narrow ? launch_chunk<64, PAGED, true>(a)
                    : launch_chunk<128, PAGED, true>(a);
    return kBadCombination;
  }
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_split_hd<float, float, PAGED>(a);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_split_hd<bf16, bf16, PAGED>(a);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch_split_hd<float, int8_t, PAGED>(a);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_split_hd<bf16, int8_t, PAGED>(a);
  return kBadCombination;
}

}  // namespace

extern "C" {

// K5: contiguous cache; ``index`` (device, (1,) int32) is the chunk's
// first position, so every request's live length is index + C. ``ws``:
// the f32 workspace of the split regime when n_splits > 1; ``keys``: the
// keys of a split. Returns cudaGetLastError() after the launches, or a
// code of this file's.
int dtg_decode_attention(const void* q, const void* k, const void* v,
                         const float* k_scale, const float* v_scale,
                         void* out, float* ws, const int* index, int B,
                         int C, int H, int hd, int S, int q_dtype,
                         int kv_dtype, float scale, int n_splits, int keys,
                         cudaStream_t stream) {
  const Args a{q,   k,  v, k_scale, v_scale, nullptr, index,
               out, ws, B, C,       H,       hd,      S,     0,
               scale, n_splits, keys, stream};
  return dispatch<false>(q_dtype, kv_dtype, a);
}

// K6: block pool read through ``tables``; per-request ``lengths`` count
// the chunk (the kernels clamp each to >= 1).
int dtg_paged_decode_attention(const void* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* tables, const int* lengths,
                               void* out, float* ws, int B, int C, int H,
                               int hd, int block_size, int n_blk,
                               int q_dtype, int kv_dtype, float scale,
                               int n_splits, int keys,
                               cudaStream_t stream) {
  const Args a{q,   k,  v, k_scale, v_scale, tables, lengths,
               out, ws, B, C,       H,       hd,     block_size, n_blk,
               scale, n_splits, keys, stream};
  return dispatch<true>(q_dtype, kv_dtype, a);
}

}  // extern "C"
