// Flash attention for Hopper (sm_90a): the forward (K1), the two halves
// of the backward, dQ (K2) and dK/dV (K3), and the ring-attention carry
// step (K4).
//
// Replaces the four Pallas TPU kernels of the JAX package:
//   K1  distributed_tensorflow_guide_tpu/ops/flash_attention.py _fwd_kernel
//       (launcher _fwd_call)
//   K2  distributed_tensorflow_guide_tpu/ops/flash_attention.py
//       _bwd_dq_kernel (launcher _bwd_dq_call)
//   K3  distributed_tensorflow_guide_tpu/ops/flash_attention.py
//       _bwd_dkv_kernel (launcher _bwd_dkv_call)
//   K4  distributed_tensorflow_guide_tpu/ops/flash_attention.py
//       _carry_fwd_kernel (launcher flash_carry_step)
//
// K4 is K1 with its softmax state brought in and taken out: one ring visit
// merges the visiting KV shard into the un-normalised carry (m, l, acc) of
// the local query shard. It is the same kernel code as K1, instantiated
// with kCarry = true: the CTA loads its rows' m, l and acc where K1 starts
// from (-inf, 0, 0), walks the visiting shard's KV tiles (up to the
// diagonal when the visit is the aligned diagonal shard), and stores the
// carry back un-normalised, in place, where K1 divides by l and writes O
// and the LSE. At the ring's per-rank shape (S_loc = 1024, hd = 64, bf16)
// K4 is bound by bytes: the f32 acc is read and written once per visit,
// 2 x 4 bytes per element against 3 x 2 bytes of q, k and v.
//
// What bounds them: at the training path's shapes (S = 1024, hd = 64) K1
// is about even between bytes and operations and K2/K3 are bound by
// operations (4, 6 and 8 * hd flops per visible (query, key) pair against
// reading q, k, v (and dO) once and writing the outputs once;
// flash_kernel_bytes / flash_kernel_flops in flash_attention.py). What the
// design does about it:
//   * bf16 inputs (the training path) run every product on the tensor
//     cores (nvcuda::wmma, bf16 operands, f32 accumulation); f32 inputs run
//     scalar f32 FMAs, so that they keep f32's precision;
//   * no (S, S) score or probability matrix ever reaches device memory:
//     each CTA keeps one 64 x 64 tile of scores on chip, and the backward
//     recomputes P from the saved per-row LSE;
//   * the causal loops stop at the diagonal, so a causal call does about
//     half the work of a full one;
//   * every output tile is owned by exactly one CTA (K1, K2: a query tile;
//     K3: a key tile), so there are no atomics and the backward is
//     bitwise repeatable;
//   * K3 computes the transposed score tile (keys as rows) directly, so
//     P^T.dO and dS^T.Q read shared memory along rows, never down
//     columns;
//   * one definition of the masked score (masked_score) serves all three
//     kernels, so the backward masks exactly as the forward did.
// Not yet done (first version, correct before fast): the elementwise work
// between the products goes through shared memory, two lanes per row; the
// tile loads are not overlapped with the products (no cp.async / TMA
// pipeline); no wgmma, no warp specialisation.

// Layouts (row-major; element strides):
//   q, k, v      (B, S, H, hd) with strides (sb, ss, sh, 1), shared by all
//                three (they are usually column slices of one qkv tensor)
//   out, dO      (B, S, H, hd) contiguous
//   dq, dk, dv   (B, S, H, hd) contiguous
//   lse, delta   (B, H, S) float32 contiguous
//   m, l (K4)    (B, H, S) float32 contiguous, read and written in place
//   acc (K4)     (B, H, S, hd) float32 contiguous, un-normalised, in place
// dtypes: float32 or bfloat16 for q, k, v, out, dO and the gradients;
// accumulation in float32. head_dim: a multiple of 8 up to 128. Any S:
// rows and keys past S in the last tile are loaded as zeros and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // query rows and key rows per tile
constexpr int kThreads = 256;       // 16 x 16: (ty, tx)
constexpr int kPitchP = kTile + 1;  // row pitch of a score tile in smem
constexpr float kNegInf = -1e30f;   // NEG_INF of the Pallas kernels

// Rows [r0, r0 + kTile) of one (b, h) slice into dst[kTile][pitch]
// (16-byte loads). Rows at or past S are zero.
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* __restrict__ base,
                                          long long row_stride, int r0, int S,
                                          int hd) {
  const int vec_per_row = hd / 4;
  for (int idx = threadIdx.x; idx < kTile * vec_per_row; idx += kThreads) {
    const int r = idx / vec_per_row;
    const int d0 = (idx % vec_per_row) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      f = *reinterpret_cast<const float4*>(
          base + (long long)(r0 + r) * row_stride + d0);
    float* row = dst + r * pitch + d0;
    row[0] = f.x;
    row[1] = f.y;
    row[2] = f.z;
    row[3] = f.w;
  }
}

// Per-row f32 values (lse or delta) of rows [r0, r0 + kTile); 0 past S.
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int S) {
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    dst[threadIdx.x] = r < S ? src[r] : 0.f;
  }
}

// acc[i][j] = sum_d A[row i][d] * Bm[row j][d] for the thread's rows
// ty + 16 i of A and tx + 16 j of Bm. The pitch is odd (hd + 1), so the 16
// rows of Bm a half-warp reads fall in 16 different banks.
__device__ __forceinline__ void tile_dot(float acc[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ Bm,
                                         int pitch, int hd, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < hd; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * pitch + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * pitch + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The one definition of a masked score, shared by K1, K2 and K3
// (_masked_scores of the Pallas kernels, plus the ragged edge).
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              int qpos, int kpos, int S,
                                              bool causal) {
  float s = dot * scale;
  if (qpos >= S || kpos >= S || (causal && kpos > qpos)) s = kNegInf;
  return s;
}

// reductions over the 16 lanes (same ty) of a half-warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ==== float32 inputs: scalar FMAs ==========================================

// ---- K1 (and K4): forward --------------------------------------------------
// grid (ceil(S / kTile), H, B). The CTA owns query rows [q0, q0 + 64) and
// walks the KV tiles up to the last one its rows can see, carrying the
// online softmax (m, l) and the accumulator in registers. DPER = head-dim
// columns per thread (hd <= 16 * DPER). kCarry (K4): the state starts from
// and ends in m_io, l_io, acc_io, un-normalised; out and lse are unused.
template <int DPER, bool kCarry>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, float* __restrict__ m_io,
                 float* __restrict__ l_io, float* __restrict__ acc_io,
                 long long sb, long long ss, long long sh, int S, int H,
                 int hd, float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + kTile * pitch;
  float* v_s = k_s + kTile * pitch;
  float* p_s = v_s + kTile * pitch;  // kTile x kPitchP

  const int b = blockIdx.z, h = blockIdx.y;
  // longest causal rows first: they have the most KV tiles to walk
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long off = (long long)b * sb + (long long)h * sh;

  load_tile(q_s, pitch, q + off, ss, q0, S, hd);

  const long long rows = ((long long)b * H + h) * S;  // (B, H, S) offset
  float m[4], l[4], acc[4][DPER];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = kCarry && row < S;
    m[i] = in ? m_io[rows + row] : kNegInf;
    l[i] = in ? l_io[rows + row] : 0.f;
#pragma unroll
    for (int t = 0; t < DPER; ++t) {
      const int d = tx + 16 * t;
      acc[i][t] = (in && d < hd) ? acc_io[(rows + row) * hd + d] : 0.f;
    }
  }

  const int kv_end = causal ? min(S, q0 + kTile) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // the previous tile is no longer being read
    load_tile(k_s, pitch, k + off, ss, kv0, S, hd);
    load_tile(v_s, pitch, v + off, ss, kv0, S, hd);
    __syncthreads();
    float s[4][4];
    tile_dot(s, q_s, k_s, pitch, hd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], scale, qpos, kv0 + tx + 16 * j, S,
                               causal);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m_new);
        if (s[i][j] <= kNegInf * 0.5f) p = 0.f;
        s[i][j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DPER; ++t) acc[i][t] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty + 16 * i) * kPitchP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float vv[DPER];
#pragma unroll
      for (int t = 0; t < DPER; ++t) {
        const int d = tx + 16 * t;
        vv[t] = d < hd ? v_s[c * pitch + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kPitchP + c];
#pragma unroll
        for (int t = 0; t < DPER; ++t) acc[i][t] = fmaf(p, vv[t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    if (kCarry) {
#pragma unroll
      for (int t = 0; t < DPER; ++t) {
        const int d = tx + 16 * t;
        if (d < hd) acc_io[(rows + row) * hd + d] = acc[i][t];
      }
      if (tx == 0) {
        m_io[rows + row] = m[i];
        l_io[rows + row] = l[i];
      }
      continue;
    }
    const float safe_l = (l[i] == 0.f) ? 1.f : l[i];
    float* orow = out + (((long long)b * S + row) * H + h) * hd;
#pragma unroll
    for (int t = 0; t < DPER; ++t) {
      const int d = tx + 16 * t;
      if (d < hd) orow[d] = acc[i][t] / safe_l;
    }
    if (tx == 0) lse[rows + row] = m[i] + logf(safe_l);
  }
}

// ---- K2: backward dQ ------------------------------------------------------
// grid (ceil(S / kTile), H, B). The CTA owns query rows [q0, q0 + 64),
// walks the KV tiles they can see, recomputes P = exp(S - lse) and
// accumulates dQ = sum_j dS_j K_j in registers, dS = P (dO V^T - delta)
// scale.
template <int DPER>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                long long sb, long long ss, long long sh, int S, int H,
                int hd, float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = hd + 1;
  float* q_s = smem;
  float* do_s = q_s + kTile * pitch;
  float* k_s = do_s + kTile * pitch;
  float* v_s = k_s + kTile * pitch;
  float* ds_s = v_s + kTile * pitch;  // kTile x kPitchP
  float* lse_s = ds_s + kTile * kPitchP;
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long off = (long long)b * sb + (long long)h * sh;
  const long long off_c = ((long long)b * S * H + h) * hd;  // contiguous
  const long long rows = ((long long)b * H + h) * S;

  load_tile(q_s, pitch, q + off, ss, q0, S, hd);
  load_tile(do_s, pitch, dout + off_c, (long long)H * hd, q0, S, hd);
  load_rows(lse_s, lse + rows, q0, S);
  load_rows(dl_s, delta + rows, q0, S);

  float acc[4][DPER];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPER; ++t) acc[i][t] = 0.f;

  const int kv_end = causal ? min(S, q0 + kTile) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();
    load_tile(k_s, pitch, k + off, ss, kv0, S, hd);
    load_tile(v_s, pitch, v + off, ss, kv0, S, hd);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(s, q_s, k_s, pitch, hd, ty, tx);
    tile_dot(dp, do_s, v_s, pitch, hd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sm = masked_score(s[i][j], scale, q0 + r,
                                      kv0 + tx + 16 * j, S, causal);
        const float p = expf(sm - lse_s[r]);
        ds_s[r * kPitchP + tx + 16 * j] = p * (dp[i][j] - dl_s[r]) * scale;
      }
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float kk[DPER];
#pragma unroll
      for (int t = 0; t < DPER; ++t) {
        const int d = tx + 16 * t;
        kk[t] = d < hd ? k_s[c * pitch + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_s[(ty + 16 * i) * kPitchP + c];
#pragma unroll
        for (int t = 0; t < DPER; ++t) acc[i][t] = fmaf(ds, kk[t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    float* drow = dq + (((long long)b * S + row) * H + h) * hd;
#pragma unroll
    for (int t = 0; t < DPER; ++t) {
      const int d = tx + 16 * t;
      if (d < hd) drow[d] = acc[i][t];
    }
  }
}

// ---- K3: backward dK, dV --------------------------------------------------
// grid (ceil(S / kTile), H, B). The CTA owns key rows [kv0, kv0 + 64) and
// walks the query tiles that can see them. It builds the score tile with
// keys as rows (S^T), so dV = sum_i P^T dO and dK = sum_i dS^T Q read
// P^T, dS^T, dO and Q along rows of shared memory.
template <int DPER>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, long long sb, long long ss,
                 long long sh, int S, int H, int hd, float scale,
                 int causal) {
  extern __shared__ float smem[];
  const int pitch = hd + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * pitch;
  float* q_s = v_s + kTile * pitch;
  float* do_s = q_s + kTile * pitch;
  float* pt_s = do_s + kTile * pitch;  // kTile x kPitchP, keys as rows
  float* dst_s = pt_s + kTile * kPitchP;
  float* lse_s = dst_s + kTile * kPitchP;
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int kv0 = blockIdx.x * kTile;  // tile 0 sees the most query tiles
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long off = (long long)b * sb + (long long)h * sh;
  const long long off_c = ((long long)b * S * H + h) * hd;
  const long long rows = ((long long)b * H + h) * S;

  load_tile(k_s, pitch, k + off, ss, kv0, S, hd);
  load_tile(v_s, pitch, v + off, ss, kv0, S, hd);

  float dk_acc[4][DPER], dv_acc[4][DPER];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPER; ++t) dk_acc[i][t] = dv_acc[i][t] = 0.f;

  // the first query tile holding a row >= kv0 (rows below see none of
  // these keys under the causal mask)
  const int q_begin = causal ? (kv0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < S; q0 += kTile) {
    __syncthreads();
    load_tile(q_s, pitch, q + off, ss, q0, S, hd);
    load_tile(do_s, pitch, dout + off_c, (long long)H * hd, q0, S, hd);
    load_rows(lse_s, lse + rows, q0, S);
    load_rows(dl_s, delta + rows, q0, S);
    __syncthreads();
    float st[4][4], dpt[4][4];
    tile_dot(st, k_s, q_s, pitch, hd, ty, tx);   // keys x queries
    tile_dot(dpt, v_s, do_s, pitch, hd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;  // key row
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;  // query row
        const float sm =
            masked_score(st[i][j], scale, q0 + c, kv0 + r, S, causal);
        const float p = expf(sm - lse_s[c]);
        pt_s[r * kPitchP + c] = p;
        dst_s[r * kPitchP + c] = p * (dpt[i][j] - dl_s[c]) * scale;
      }
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float qq[DPER], dd[DPER];
#pragma unroll
      for (int t = 0; t < DPER; ++t) {
        const int d = tx + 16 * t;
        qq[t] = d < hd ? q_s[c * pitch + d] : 0.f;
        dd[t] = d < hd ? do_s[c * pitch + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = pt_s[(ty + 16 * i) * kPitchP + c];
        const float ds = dst_s[(ty + 16 * i) * kPitchP + c];
#pragma unroll
        for (int t = 0; t < DPER; ++t) {
          dv_acc[i][t] = fmaf(p, dd[t], dv_acc[i][t]);
          dk_acc[i][t] = fmaf(ds, qq[t], dk_acc[i][t]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kv0 + ty + 16 * i;
    if (row >= S) continue;
    const long long o = (((long long)b * S + row) * H + h) * hd;
#pragma unroll
    for (int t = 0; t < DPER; ++t) {
      const int d = tx + 16 * t;
      if (d < hd) {
        dk[o + d] = dk_acc[i][t];
        dv[o + d] = dv_acc[i][t];
      }
    }
  }
}

// ==== bf16 inputs: the products on the tensor cores ========================
//
// The same three functions for bf16 q, k, v, with every product a warp-wide
// nvcuda::wmma 16x16x16 (bf16 operands, f32 accumulation). A CTA of four
// warps owns 64 rows (16 per warp); tiles sit in shared memory as bf16,
// zero-padded to a head dim hdp that is a multiple of 16. The elementwise
// work between the products (mask, online softmax, dS) runs in f32 on a
// score tile staged in shared memory, two lanes per row. The operands of
// the second product of each kernel (P in K1 and K3, dS in K2 and K3) are
// rounded to bf16 on the way in, as flash attention does on tensor cores;
// the plain versions round at the same points. l sums the f32 P.

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kLdS = kTile + 4;  // f32 score tile pitch (multiple of 4)
constexpr int kLdP = kTile + 8;  // bf16 P / dS tile pitch (multiple of 8)

__device__ __forceinline__ int padded_hd(int hd) { return (hd + 15) & ~15; }

// Rows [r0, r0 + kTile) of one (b, h) slice into dst[kTile][ld] as bf16,
// copied in 16-byte vectors; rows past S and columns [hd, hdp) are zero.
__device__ __forceinline__ void load_tile_bf16(bf16* dst, int ld,
                                               const bf16* __restrict__ base,
                                               long long row_stride, int r0,
                                               int S, int hd, int hdp) {
  const int vec_per_row = hdp / 8;
  for (int idx = threadIdx.x; idx < kTile * vec_per_row; idx += blockDim.x) {
    const int r = idx / vec_per_row;
    const int d0 = (idx % vec_per_row) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S && d0 < hd)
      raw = *reinterpret_cast<const uint4*>(
          base + (long long)(r0 + r) * row_stride + d0);
    *reinterpret_cast<uint4*>(dst + r * ld + d0) = raw;
  }
}

// out[16][16 * 4] = A[16 rows][hdp] . B[64 rows][hdp]^T: the 16 x 64 score
// tile of one warp, stored row-major with pitch kLdS.
__device__ __forceinline__ void scores_tc(float* out, const bf16* a, int lda,
                                          const bf16* b, int ldb, int hdp) {
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
    for (int kk = 0; kk < hdp / 16; ++kk) {
      FragA fa;
      FragBc fb;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      wmma::load_matrix_sync(fb, b + n * 16 * ldb + kk * 16, ldb);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, kLdS, wmma::mem_row_major);
  }
}

// acc[n] += P[16][64] . V[64][16 n .. 16 n + 16) for the live n < hdp / 16.
template <int NF>
__device__ __forceinline__ void accumulate_tc(FragC (&acc)[NF], const bf16* p,
                                              const bf16* v, int ldv,
                                              int hdp) {
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    if (n * 16 >= hdp) break;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragA fa;
      FragBr fb;
      wmma::load_matrix_sync(fa, p + kk * 16, kLdP);
      wmma::load_matrix_sync(fb, v + kk * 16 * ldv + n * 16, ldv);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// The accumulators of one warp (16 rows) into rows [row0, row0 + 16) of a
// contiguous (B, S, H, hd) bf16 tensor, through f32 staging in shared
// memory (the fragment layout is opaque).
template <int NF>
__device__ __forceinline__ void store_rows_tc(FragC (&acc)[NF], float* stage,
                                              bf16* dst, int b, int h,
                                              int row0, int S, int H, int hd,
                                              int hdp) {
  const int lds = hdp + 4;
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    if (n * 16 >= hdp) break;
    wmma::store_matrix_sync(stage + n * 16, acc[n], lds, wmma::mem_row_major);
  }
  __syncwarp();
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * hd; i += 32) {
    const int r = i / hd, d = i % hd;
    if (row0 + r < S)
      dst[(((long long)b * S + row0 + r) * H + h) * hd + d] =
          __float2bfloat16(stage[r * lds + d]);
  }
  __syncwarp();
}

// ---- K1 (and K4) on the tensor cores --------------------------------------
// grid (ceil(S / kTile), H, B), kTcThreads. Each warp owns 16 query rows;
// its O accumulator lives in shared memory (f32) so that the online
// softmax can rescale it row by row. kCarry (K4): m, l and the accumulator
// start from and end in m_io, l_io, acc_io, un-normalised.
template <bool kCarry>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out,
             float* __restrict__ lse, float* __restrict__ m_io,
             float* __restrict__ l_io, float* __restrict__ acc_io,
             long long sb, long long ss, long long sh, int S, int H, int hd,
             float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hdp = padded_hd(hd);
  const int ld = hdp + 8, ldo = hdp + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTile * ld;
  bf16* v_s = k_s + kTile * ld;
  float* s_w = reinterpret_cast<float*>(v_s + kTile * ld) + warp * 16 * kLdS;
  bf16* p_w = reinterpret_cast<bf16*>(
                  reinterpret_cast<float*>(v_s + kTile * ld) +
                  kTcWarps * 16 * kLdS) + warp * 16 * kLdP;
  float* o_all = reinterpret_cast<float*>(
      reinterpret_cast<bf16*>(reinterpret_cast<float*>(v_s + kTile * ld) +
                              kTcWarps * 16 * kLdS) +
      kTcWarps * 16 * kLdP);
  float* o_w = o_all + warp * 16 * ldo;
  float* alpha_w = o_all + kTcWarps * 16 * ldo + warp * 16;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const long long off = (long long)b * sb + (long long)h * sh;
  const long long rows = ((long long)b * H + h) * S;  // (B, H, S) offset
  load_tile_bf16(q_s, ld, q + off, ss, q0, S, hd, hdp);
  for (int i = lane; i < 16 * ldo; i += 32) {
    const int rr = i / ldo, d = i % ldo, row = q0 + warp * 16 + rr;
    o_w[i] = (kCarry && row < S && d < hd) ? acc_io[(rows + row) * hd + d]
                                           : 0.f;
  }

  const int r = lane >> 1, half = lane & 1;  // two lanes per row
  const int qpos = q0 + warp * 16 + r;
  const bool carried = kCarry && qpos < S;
  float m = carried ? m_io[rows + qpos] : kNegInf;
  float l = carried ? l_io[rows + qpos] : 0.f;

  const int kv_end = causal ? min(S, q0 + kTile) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();
    load_tile_bf16(k_s, ld, k + off, ss, kv0, S, hd, hdp);
    load_tile_bf16(v_s, ld, v + off, ss, kv0, S, hd, hdp);
    __syncthreads();
    scores_tc(s_w, q_s + warp * 16 * ld, ld, k_s, ld, hdp);
    __syncwarp();
    float sv[32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      sv[j] = masked_score(s_w[r * kLdS + c], scale, qpos, kv0 + c, S,
                           causal);
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float p = expf(sv[j] - m_new);
      if (sv[j] <= kNegInf * 0.5f) p = 0.f;
      rs += p;
      p_w[r * kLdP + half * 32 + j] = __float2bfloat16(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_new;
    if (half == 0) alpha_w[r] = alpha;
    __syncwarp();
    for (int i = lane; i < 16 * hdp; i += 32) {
      const int rr = i / hdp, d = i % hdp;
      o_w[rr * ldo + d] *= alpha_w[rr];
    }
    __syncwarp();
    for (int n = 0; n < hdp / 16; ++n) {
      FragC c;
      wmma::load_matrix_sync(c, o_w + n * 16, ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragA fa;
        FragBr fb;
        wmma::load_matrix_sync(fa, p_w + kk * 16, kLdP);
        wmma::load_matrix_sync(fb, v_s + kk * 16 * ld + n * 16, ld);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(o_w + n * 16, c, ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qpos >= S) return;
  if (kCarry) {
    for (int d = half; d < hd; d += 2)
      acc_io[(rows + qpos) * hd + d] = o_w[r * ldo + d];
    if (half == 0) {
      m_io[rows + qpos] = m;
      l_io[rows + qpos] = l;
    }
    return;
  }
  const float safe_l = (l == 0.f) ? 1.f : l;
  bf16* orow = out + (((long long)b * S + qpos) * H + h) * hd;
  for (int d = half; d < hd; d += 2)
    orow[d] = __float2bfloat16(o_w[r * ldo + d] / safe_l);
  if (half == 0) lse[rows + qpos] = m + logf(safe_l);
}

// ---- K2 on the tensor cores -----------------------------------------------
// grid (ceil(S / kTile), H, B), kTcThreads. Each warp owns 16 query rows
// and keeps its dQ accumulators in registers for the whole KV walk.
template <int NF>
__global__ void __launch_bounds__(kTcThreads)
flash_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, long long sb, long long ss, long long sh,
            int S, int H, int hd, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hdp = padded_hd(hd);
  const int ld = hdp + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTile * ld;
  bf16* k_s = do_s + kTile * ld;
  bf16* v_s = k_s + kTile * ld;
  float* scratch = reinterpret_cast<float*>(v_s + kTile * ld);
  float* s_w = scratch + warp * 2 * 16 * kLdS;  // then dP, adjacent
  float* dp_w = s_w + 16 * kLdS;
  bf16* ds_w = reinterpret_cast<bf16*>(scratch + kTcWarps * 2 * 16 * kLdS) +
               warp * 16 * kLdP;
  float* lse_s = reinterpret_cast<float*>(
      reinterpret_cast<bf16*>(scratch + kTcWarps * 2 * 16 * kLdS) +
      kTcWarps * 16 * kLdP);
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const long long off = (long long)b * sb + (long long)h * sh;
  const long long off_c = ((long long)b * S * H + h) * hd;
  const long long rows = ((long long)b * H + h) * S;
  load_tile_bf16(q_s, ld, q + off, ss, q0, S, hd, hdp);
  load_tile_bf16(do_s, ld, dout + off_c, (long long)H * hd, q0, S, hd, hdp);
  load_rows(lse_s, lse + rows, q0, S);
  load_rows(dl_s, delta + rows, q0, S);

  FragC acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;

  const int kv_end = causal ? min(S, q0 + kTile) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();
    load_tile_bf16(k_s, ld, k + off, ss, kv0, S, hd, hdp);
    load_tile_bf16(v_s, ld, v + off, ss, kv0, S, hd, hdp);
    __syncthreads();
    scores_tc(s_w, q_s + warp * 16 * ld, ld, k_s, ld, hdp);
    scores_tc(dp_w, do_s + warp * 16 * ld, ld, v_s, ld, hdp);
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const float sm = masked_score(s_w[r * kLdS + c], scale, q0 + row,
                                    kv0 + c, S, causal);
      const float p = expf(sm - lse_s[row]);
      ds_w[r * kLdP + c] =
          __float2bfloat16(p * (dp_w[r * kLdS + c] - dl_s[row]) * scale);
    }
    __syncwarp();
    accumulate_tc(acc, ds_w, k_s, ld, hdp);
  }
  store_rows_tc(acc, s_w, dq, b, h, q0 + warp * 16, S, H, hd, hdp);
}

// ---- K3 on the tensor cores -----------------------------------------------
// grid (ceil(S / kTile), H, B), kTcThreads. Each warp owns 16 key rows,
// builds the transposed score tile (its keys x 64 queries) directly and
// keeps its dK and dV accumulators in registers.
template <int NF>
__global__ void __launch_bounds__(kTcThreads)
flash_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, long long sb,
             long long ss, long long sh, int S, int H, int hd, float scale,
             int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hdp = padded_hd(hd);
  const int ld = hdp + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile * ld;
  bf16* q_s = v_s + kTile * ld;
  bf16* do_s = q_s + kTile * ld;
  float* scratch = reinterpret_cast<float*>(do_s + kTile * ld);
  float* st_w = scratch + warp * 2 * 16 * kLdS;
  float* dpt_w = st_w + 16 * kLdS;
  bf16* pt_w = reinterpret_cast<bf16*>(scratch + kTcWarps * 2 * 16 * kLdS) +
               warp * 2 * 16 * kLdP;
  bf16* dst_w = pt_w + 16 * kLdP;
  float* lse_s = reinterpret_cast<float*>(
      reinterpret_cast<bf16*>(scratch + kTcWarps * 2 * 16 * kLdS) +
      kTcWarps * 2 * 16 * kLdP);
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int kv0 = blockIdx.x * kTile;
  const long long off = (long long)b * sb + (long long)h * sh;
  const long long off_c = ((long long)b * S * H + h) * hd;
  const long long rows = ((long long)b * H + h) * S;
  load_tile_bf16(k_s, ld, k + off, ss, kv0, S, hd, hdp);
  load_tile_bf16(v_s, ld, v + off, ss, kv0, S, hd, hdp);

  FragC dk_acc[NF], dv_acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  const int r = lane >> 1, half = lane & 1;
  const int kpos = kv0 + warp * 16 + r;

  const int q_begin = causal ? (kv0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < S; q0 += kTile) {
    __syncthreads();
    load_tile_bf16(q_s, ld, q + off, ss, q0, S, hd, hdp);
    load_tile_bf16(do_s, ld, dout + off_c, (long long)H * hd, q0, S, hd,
                   hdp);
    load_rows(lse_s, lse + rows, q0, S);
    load_rows(dl_s, delta + rows, q0, S);
    __syncthreads();
    scores_tc(st_w, k_s + warp * 16 * ld, ld, q_s, ld, hdp);
    scores_tc(dpt_w, v_s + warp * 16 * ld, ld, do_s, ld, hdp);
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;  // query row within the tile
      const float sm = masked_score(st_w[r * kLdS + c], scale, q0 + c, kpos,
                                    S, causal);
      const float p = expf(sm - lse_s[c]);
      pt_w[r * kLdP + c] = __float2bfloat16(p);
      dst_w[r * kLdP + c] =
          __float2bfloat16(p * (dpt_w[r * kLdS + c] - dl_s[c]) * scale);
    }
    __syncwarp();
    accumulate_tc(dv_acc, pt_w, do_s, ld, hdp);
    accumulate_tc(dk_acc, dst_w, q_s, ld, hdp);
  }
  store_rows_tc(dk_acc, st_w, dk, b, h, kv0 + warp * 16, S, H, hd, hdp);
  store_rows_tc(dv_acc, st_w, dv, b, h, kv0 + warp * 16, S, H, hd, hdp);
}

size_t fwd_tc_smem(int hd) {
  const int hdp = (hd + 15) & ~15;
  return 3 * kTile * (hdp + 8) * sizeof(bf16) +
         kTcWarps * 16 * kLdS * sizeof(float) +
         kTcWarps * 16 * kLdP * sizeof(bf16) +
         kTcWarps * 16 * (hdp + 4) * sizeof(float) + kTile * sizeof(float);
}
size_t dq_tc_smem(int hd) {
  const int hdp = (hd + 15) & ~15;
  return 4 * kTile * (hdp + 8) * sizeof(bf16) +
         kTcWarps * 2 * 16 * kLdS * sizeof(float) +
         kTcWarps * 16 * kLdP * sizeof(bf16) + 2 * kTile * sizeof(float);
}
size_t dkv_tc_smem(int hd) {
  const int hdp = (hd + 15) & ~15;
  return 4 * kTile * (hdp + 8) * sizeof(bf16) +
         kTcWarps * 2 * 16 * kLdS * sizeof(float) +
         kTcWarps * 2 * 16 * kLdP * sizeof(bf16) + 2 * kTile * sizeof(float);
}

// dynamic shared memory, in bytes, of each kernel at head dim hd
size_t fwd_smem(int hd) {
  return sizeof(float) * (3 * kTile * (hd + 1) + kTile * kPitchP);
}
size_t dq_smem(int hd) {
  return sizeof(float) * (4 * kTile * (hd + 1) + kTile * kPitchP + 2 * kTile);
}
size_t dkv_smem(int hd) {
  return sizeof(float) *
         (4 * kTile * (hd + 1) + 2 * kTile * kPitchP + 2 * kTile);
}

// Above 48 KB a kernel must opt in to its dynamic shared memory. The
// attribute is set for the most any head dim needs, once per kernel.
template <typename K>
int opt_in(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *out0, *out1;
  float* lse_out;
  float *m, *l, *acc;  // K4's carry
  long long sb, ss, sh;
  int B, S, H, hd;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DPER>
int launch_f32(int which, const Args& a) {
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  int rc = 0;
  if (which == 0) {
    static const int set =
        opt_in(flash_fwd_kernel<DPER, false>, fwd_smem(128));
    rc = set;
    if (rc) return rc;
    flash_fwd_kernel<DPER, false>
        <<<grid, kThreads, fwd_smem(a.hd), a.stream>>>(
            q, k, v, static_cast<float*>(a.out0), a.lse_out, nullptr,
            nullptr, nullptr, a.sb, a.ss, a.sh, a.S, a.H, a.hd, a.scale,
            a.causal);
  } else if (which == 3) {
    static const int set =
        opt_in(flash_fwd_kernel<DPER, true>, fwd_smem(128));
    rc = set;
    if (rc) return rc;
    flash_fwd_kernel<DPER, true>
        <<<grid, kThreads, fwd_smem(a.hd), a.stream>>>(
            q, k, v, nullptr, nullptr, a.m, a.l, a.acc, a.sb, a.ss, a.sh,
            a.S, a.H, a.hd, a.scale, a.causal);
  } else if (which == 1) {
    static const int set = opt_in(flash_dq_kernel<DPER>, dq_smem(128));
    rc = set;
    if (rc) return rc;
    flash_dq_kernel<DPER><<<grid, kThreads, dq_smem(a.hd), a.stream>>>(
        q, k, v, static_cast<const float*>(a.dout), a.lse_in, a.delta,
        static_cast<float*>(a.out0), a.sb, a.ss, a.sh, a.S, a.H, a.hd,
        a.scale, a.causal);
  } else {
    static const int set = opt_in(flash_dkv_kernel<DPER>, dkv_smem(128));
    rc = set;
    if (rc) return rc;
    flash_dkv_kernel<DPER><<<grid, kThreads, dkv_smem(a.hd), a.stream>>>(
        q, k, v, static_cast<const float*>(a.dout), a.lse_in, a.delta,
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.sb, a.ss,
        a.sh, a.S, a.H, a.hd, a.scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NF>
int launch_tc(int which, const Args& a) {
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  int rc = 0;
  if (which == 0) {
    static const int set = opt_in(flash_fwd_tc<false>, fwd_tc_smem(128));
    rc = set;
    if (rc) return rc;
    flash_fwd_tc<false><<<grid, kTcThreads, fwd_tc_smem(a.hd), a.stream>>>(
        q, k, v, static_cast<bf16*>(a.out0), a.lse_out, nullptr, nullptr,
        nullptr, a.sb, a.ss, a.sh, a.S, a.H, a.hd, a.scale, a.causal);
  } else if (which == 3) {
    static const int set = opt_in(flash_fwd_tc<true>, fwd_tc_smem(128));
    rc = set;
    if (rc) return rc;
    flash_fwd_tc<true><<<grid, kTcThreads, fwd_tc_smem(a.hd), a.stream>>>(
        q, k, v, nullptr, nullptr, a.m, a.l, a.acc, a.sb, a.ss, a.sh, a.S,
        a.H, a.hd, a.scale, a.causal);
  } else if (which == 1) {
    static const int set = opt_in(flash_dq_tc<NF>, dq_tc_smem(128));
    rc = set;
    if (rc) return rc;
    flash_dq_tc<NF><<<grid, kTcThreads, dq_tc_smem(a.hd), a.stream>>>(
        q, k, v, static_cast<const bf16*>(a.dout), a.lse_in, a.delta,
        static_cast<bf16*>(a.out0), a.sb, a.ss, a.sh, a.S, a.H, a.hd,
        a.scale, a.causal);
  } else {
    static const int set = opt_in(flash_dkv_tc<NF>, dkv_tc_smem(128));
    rc = set;
    if (rc) return rc;
    flash_dkv_tc<NF><<<grid, kTcThreads, dkv_tc_smem(a.hd), a.stream>>>(
        q, k, v, static_cast<const bf16*>(a.dout), a.lse_in, a.delta,
        static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.sb, a.ss,
        a.sh, a.S, a.H, a.hd, a.scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// which: 0 K1, 1 K2, 2 K3, 3 K4. dtype codes: 0 float32 (scalar FMAs),
// 1 bfloat16 (tensor cores).
// Returns -1 for what no instantiation takes (the Python wrapper checks
// before it calls).
int dispatch(int which, int dtype, const Args& a) {
  if (a.hd < 8 || a.hd > 128 || a.hd % 8) return -1;
  const bool narrow = a.hd <= 64;
  if (dtype == 0)
    return narrow ? launch_f32<4>(which, a) : launch_f32<8>(which, a);
  if (dtype == 1)
    return narrow ? launch_tc<4>(which, a) : launch_tc<8>(which, a);
  return -1;
}

}  // namespace

extern "C" {

// K1: out (B, S, H, hd) contiguous, lse (B, H, S) f32.
int dtg_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  float* lse, long long sb, long long ss, long long sh,
                  int B, int S, int H, int hd, float scale, int causal,
                  int dtype, cudaStream_t stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse,
         nullptr, nullptr, nullptr, sb, ss, sh, B, S, H, hd, scale, causal,
         stream};
  return dispatch(0, dtype, a);
}

// K2: dq (B, S, H, hd) contiguous.
int dtg_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, long long sb, long long ss, long long sh,
                     int B, int S, int H, int hd, float scale, int causal,
                     int dtype, cudaStream_t stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
         nullptr, nullptr, nullptr, sb, ss, sh, B, S, H, hd, scale, causal,
         stream};
  return dispatch(1, dtype, a);
}

// K3: dk, dv (B, S, H, hd) contiguous.
int dtg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, long long sb, long long ss,
                      long long sh, int B, int S, int H, int hd, float scale,
                      int causal, int dtype, cudaStream_t stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr,
         nullptr, nullptr, nullptr, sb, ss, sh, B, S, H, hd, scale, causal,
         stream};
  return dispatch(2, dtype, a);
}

// K4: one ring visit; m, l (B, H, S) f32 and acc (B, H, S, hd) f32 are
// read and written in place. diag: causal within the aligned shard.
int dtg_flash_carry(const void* q, const void* k, const void* v, float* m,
                    float* l, float* acc, long long sb, long long ss,
                    long long sh, int B, int S, int H, int hd, float scale,
                    int diag, int dtype, cudaStream_t stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         m, l, acc, sb, ss, sh, B, S, H, hd, scale, diag, stream};
  return dispatch(3, dtype, a);
}

}  // extern "C"
