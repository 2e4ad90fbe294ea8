// Decode attention for Hopper (sm_90a): a chunk of C query rows against a
// KV cache, read either contiguously (K5) or through a block table (K6).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K5  distributed_tensorflow_guide_tpu/ops/decode_attention.py
//       _decode_kernel (launcher decode_attention)
//   K6  distributed_tensorflow_guide_tpu/ops/decode_attention.py
//       _paged_decode_kernel (launcher paged_decode_attention)
// One templated kernel serves both: the PAGED parameter decides whether
// KV row p of request b lives at cache row (b, h, p) or at pool row
// (table[b, p / bs], h, p % bs).
//
// What bounds it: HBM bytes. Each call must read the live slice of the
// cache once (K and V rows up to the chunk's last position, plus the f32
// scale per row when the cache is int8), and reads and writes the q chunk
// once; the closed form is decode_kernel_hbm_bytes() in
// decode_attention.py. The arithmetic is 4 * C * L * hd flops per
// (batch, head), far below the card's ratio of flops to bytes at decode
// widths. What the design does about it:
//   * the KV loop stops at the live length (and, per CTA, at the last
//     position its query rows can see), so a step at position L reads
//     ~L rows, never max_len;
//   * scores, the online softmax (m, l) and the accumulator stay in
//     registers and shared memory; no score matrix reaches HBM;
//   * an int8 cache moves over the wire as int8: its per-row scales fold
//     into the score columns (k) and into the probability columns (v,
//     after l has been summed), never into a dequantised copy;
//   * the next KV tile is loaded into registers (16-byte loads) while the
//     current one is being used, so one tile's latency hides behind the
//     other's arithmetic.
// Not yet done (first version, correct before fast): no TMA, no wgmma, no
// split-KV. At 8 slots x 12 heads a decode step launches only 96 CTAs for
// 132 SMs; splitting the KV range across CTAs is the first fix.
//
// Layouts (row-major, contiguous):
//   q, out   (B, C, H, hd)                      query dtype (f32 or bf16)
//   K5 k, v  (B, H, S, hd)   scales (B, H, 1, S) f32 when int8
//   K6 k, v  (N, H, bs, hd)  scales (N, H, 1, bs) f32 when int8
//   tables   (B, n_blk) int32, lengths (B,) int32 (K6 only)
// Query row c of request b sits at position length - C + c; key p is
// visible to it when p <= that position (causal within the chunk, and
// every unwritten slot hidden).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // query rows per CTA, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;             // KV rows per tile, one per lane
constexpr int kMaxHd = 128;
constexpr int kAccPerLane = kMaxHd / 32;
// 16-byte vectors per thread per tile at the widest case (f32, hd 128)
constexpr int kMaxVec = kTileK * kMaxHd * 4 / 16 / kThreads;
constexpr float kNegInf = -1e30f;      // NEG_INF of the Pallas kernels

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
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
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      float2 f = __bfloat1622float2(p[e]);
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

// grid (ceil(C / kWarps), H, B), kThreads threads. ``seq`` is S for the
// contiguous cache and the block size for the pool.
template <typename TQ, typename TC, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                        const TC* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, int length_all,
                        TQ* __restrict__ out, int C, int H, int hd, int seq,
                        int n_blk, float scale) {
  __shared__ float k_s[kTileK][kMaxHd + 1];  // +1: conflict-free row reads
  __shared__ float v_s[kTileK][kMaxHd + 1];
  __shared__ float q_s[kWarps][kMaxHd];
  __shared__ float ks_s[kTileK];
  __shared__ float vs_s[kTileK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int c0 = blockIdx.x * kWarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = c0 + warp;
  const bool row_live = c < C;

  const int length = PAGED ? max(lengths[b], 1) : length_all;
  const int q_base = length - C;  // position of chunk row 0
  const int q_pos = q_base + c;
  const int c_last = min(c0 + kWarps, C) - 1;
  // the CTA reads no key past the last position its rows can see
  const int kv_end = max(0, min(length, q_base + c_last + 1));

  if (row_live) {
    const TQ* qr = q + (((long long)b * C + c) * H + h) * hd;
    for (int d = lane; d < hd; d += 32) q_s[warp][d] = to_float(qr[d]);
  }

  constexpr int kPerVec = Vec<TC>::kN;
  const int vec_per_row = hd / kPerVec;
  const int vec_per_tile = kTileK * vec_per_row;

  uint4 k_raw[kMaxVec];
  uint4 v_raw[kMaxVec];
  float ks_raw = 0.f, vs_raw = 0.f;

  // rows at or past kv_end are zero-filled, never read: whatever the
  // cache holds there (unwritten slots, another request's block) cannot
  // reach the output, not even as 0 * NaN
  auto load_tile = [&](int kv0) {
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      k_raw[i] = make_uint4(0u, 0u, 0u, 0u);
      v_raw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < vec_per_tile) {
        const int p = kv0 + idx / vec_per_row;
        if (p < kv_end) {
          const long long off =
              kv_row<PAGED>(b, h, p, H, seq, tables, n_blk) * hd +
              (idx % vec_per_row) * kPerVec;
          k_raw[i] = *reinterpret_cast<const uint4*>(k + off);
          v_raw[i] = *reinterpret_cast<const uint4*>(v + off);
        }
      }
    }
    if (QUANT && threadIdx.x < kTileK) {
      const int p = kv0 + threadIdx.x;
      ks_raw = vs_raw = 0.f;
      if (p < kv_end) {
        const long long r = kv_row<PAGED>(b, h, p, H, seq, tables, n_blk);
        ks_raw = k_scale[r];
        vs_raw = v_scale[r];
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < vec_per_tile) {
        const int j = idx / vec_per_row;
        const int d0 = (idx % vec_per_row) * kPerVec;
        float f[kPerVec];
        Vec<TC>::unpack(k_raw[i], f);
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) k_s[j][d0 + e] = f[e];
        Vec<TC>::unpack(v_raw[i], f);
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) v_s[j][d0 + e] = f[e];
      }
    }
    if (QUANT && threadIdx.x < kTileK) {
      ks_s[threadIdx.x] = ks_raw;
      vs_s[threadIdx.x] = vs_raw;
    }
  };

  float m = kNegInf;
  float l = 0.f;
  float acc[kAccPerLane];
#pragma unroll
  for (int t = 0; t < kAccPerLane; ++t) acc[t] = 0.f;

  if (kv_end > 0) load_tile(0);
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTileK) {
    __syncthreads();  // the previous tile is no longer being read
    store_tile();
    __syncthreads();
    if (kv0 + kTileK < kv_end) load_tile(kv0 + kTileK);  // in flight now
    if (row_live) {
      // lane j scores key kv0 + j
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += q_s[warp][d] * k_s[lane][d];
      s *= scale;
      if (QUANT) s *= ks_s[lane];  // k dequant folds into the score column
      if (kv0 + lane > q_pos) s = kNegInf;
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      float p = expf(s - m_new);
      if (s <= kNegInf * 0.5f) p = 0.f;
      l = l * alpha + warp_sum(p);
      m = m_new;
      if (QUANT) p *= vs_s[lane];  // v dequant, AFTER l summed the raw p
#pragma unroll
      for (int t = 0; t < kAccPerLane; ++t) acc[t] *= alpha;
      for (int j = 0; j < kTileK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int t = 0; t < kAccPerLane; ++t) {
          const int d = lane + 32 * t;
          if (d < hd) acc[t] += pj * v_s[j][d];
        }
      }
    }
  }

  if (row_live) {
    const float safe_l = (l == 0.f) ? 1.f : l;
    TQ* orow = out + (((long long)b * C + c) * H + h) * hd;
#pragma unroll
    for (int t = 0; t < kAccPerLane; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) orow[d] = from_float<TQ>(acc[t] / safe_l);
    }
  }
}

template <typename TQ, typename TC, bool PAGED, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* tables, const int* lengths,
           int length_all, void* out, int B, int C, int H, int hd, int seq,
           int n_blk, float scale, cudaStream_t stream) {
  const dim3 grid((C + kWarps - 1) / kWarps, H, B);
  decode_attention_kernel<TQ, TC, PAGED, QUANT><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), ks, vs, tables, lengths, length_all,
      static_cast<TQ*>(out), C, H, hd, seq, n_blk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(int q_dtype, int kv_dtype, const void* q, const void* k,
             const void* v, const float* ks, const float* vs,
             const int* tables, const int* lengths, int length_all,
             void* out, int B, int C, int H, int hd, int seq, int n_blk,
             float scale, cudaStream_t stream) {
  // dtype codes: 0 float32, 1 bfloat16, 2 int8 (cache only)
#define DTG_ARGS q, k, v, ks, vs, tables, lengths, length_all, out, B, C, H, \
                 hd, seq, n_blk, scale, stream
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, PAGED, false>(DTG_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, PAGED, false>(DTG_ARGS);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t, PAGED, true>(DTG_ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, PAGED, true>(DTG_ARGS);
#undef DTG_ARGS
  return -1;
}

}  // namespace

extern "C" {

// K5: contiguous cache; every request's live length is ``length``
// (the chunk's start index + C). Returns cudaGetLastError() after the
// launch, or -1 for an unsupported dtype pair.
int dtg_decode_attention(const void* q, const void* k, const void* v,
                         const float* k_scale, const float* v_scale,
                         void* out, int B, int C, int H, int hd, int S,
                         int length, int q_dtype, int kv_dtype, float scale,
                         cudaStream_t stream) {
  return dispatch<false>(q_dtype, kv_dtype, q, k, v, k_scale, v_scale,
                         nullptr, nullptr, length, out, B, C, H, hd, S, 0,
                         scale, stream);
}

// K6: block pool read through ``tables``; per-request ``lengths`` count
// the chunk (the kernel clamps each to >= 1).
int dtg_paged_decode_attention(const void* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* tables, const int* lengths,
                               void* out, int B, int C, int H, int hd,
                               int block_size, int n_blk, int q_dtype,
                               int kv_dtype, float scale,
                               cudaStream_t stream) {
  return dispatch<true>(q_dtype, kv_dtype, q, k, v, k_scale, v_scale,
                        tables, lengths, 0, out, B, C, H, hd, block_size,
                        n_blk, scale, stream);
}

}  // extern "C"
