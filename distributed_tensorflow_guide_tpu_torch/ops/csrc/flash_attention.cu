// Flash attention for Hopper (sm_90a): the forward (K1), the two halves
// of the backward, dQ (K2) and dK/dV (K3), and the ring-attention carry
// step (K4).
//
// Replaces the four Pallas TPU kernels of the JAX package
// (distributed_tensorflow_guide_tpu/ops/flash_attention.py):
//   K1  _fwd_kernel (launcher _fwd_call)     bf16: flash_fwd_sm90<HDP, false>
//                                            f32:  flash_fwd_kernel<D, false>
//   K2  _bwd_dq_kernel (_bwd_dq_call)        bf16: flash_dq_sm90<HDP>
//                                            f32:  flash_dq_kernel<D>
//   K3  _bwd_dkv_kernel (_bwd_dkv_call)      bf16: flash_dkv_sm90<HDP>
//                                            f32:  flash_dkv_kernel<D>
//   K4  _carry_fwd_kernel (flash_carry_step) bf16: flash_fwd_sm90<HDP, true>
//                                            f32:  flash_fwd_kernel<D, true>
//
// K4 is K1 with its softmax state brought in and taken out: one ring visit
// merges the visiting KV shard into the un-normalised carry (m, l, acc) of
// the local query shard. It is the same kernel code as K1, instantiated
// with kCarry = true: the CTA loads its rows' m, l and acc where K1 starts
// from (NEG_INF, 0, 0), walks the visiting shard's KV tiles (up to the
// diagonal when the visit is the aligned diagonal shard), and stores the
// carry back un-normalised, in place, where K1 divides by l and writes O
// and the LSE. One softmax update serves both, so the ring and the
// standalone forward cannot drift apart.
//
// What bounds them (flash_kernel_bytes / flash_kernel_flops in
// flash_attention.py; each input read once, each output written once;
// 3.35 TB/s and 989 TFLOP/s bf16). At the training path's shape (B=8,
// H=12, S=1024, hd=64, bf16, causal) K1 moves 50.7 MB (15.1 us) for 12.9
// GFLOP (13.0 us): bound by bytes, nearly even with the operations; a
// full call does twice the operations and is bound by them. K4 at the
// ring's per-rank shape (B=4, S_loc=1024) moves 44.8 MB (13.4 us), half
// of it the f32 acc read and written, for 12.9 GFLOP full and 6.4
// diagonal: bound by bytes. K2 and K3 are bound by operations: 6 * hd
// (K2: Q K^T, dO V^T, dS K) and 8 * hd (K3: K Q^T, V dO^T, P^T dO, dS^T Q)
// per visible pair against 4 * hd for K1; at the path's shape 19.4 GFLOP
// (19.6 us) and 25.8 GFLOP (26.1 us) against 64 and 76 MB (19 and 23 us).
//
// The bf16 kernels (flash_fwd_sm90, flash_dq_sm90, flash_dkv_sm90) share
// one design, which keeps every intermediate on chip and the tensor cores
// fed:
//   * a CTA owns 128 rows of its output (K1, K2, K4: queries; K3: keys):
//     two consumer warpgroups of 64 rows and a producer warpgroup that
//     hands its registers to them (setmaxnreg);
//   * the producer loads the CTA's own rows once (Q; K2: Q and dO; K3: K
//     and V) and streams the other side's 64-row tiles (K and V; K3: Q and
//     dO) by TMA through a ring of shared-memory stages (full / empty
//     mbarriers), from 4-D tensor maps over the strided q, k, v, so column
//     slices of the qkv projection are read in place; TMA's zero fill pads
//     the ragged rows and the head dim up to HDP = 64 or 128;
//   * every product is a wgmma with an f32 accumulator in registers:
//     scores (S = Q K^T, K2's dP = dO V^T, K3's S^T = K Q^T and
//     dP^T = V dO^T) read two K-major operands from 128-byte swizzled
//     shared memory through descriptors; accumulations (O += P V, dQ +=
//     dS K, dV += P^T dO, dK += dS^T Q) take their A straight from a score
//     accumulator, rounded to bf16 in registers, and B MN-major
//     (transposed by the hardware). Accumulators stay in registers for the
//     CTA's life;
//   * the elementwise work runs on the accumulator registers: the online
//     softmax (a row's max and sum are two shuffles within the quad that
//     holds it), P = exp2 of one FMA from the saved LSE in the backward,
//     dS = P (dP - delta) scale; only the tiles that cross the diagonal or
//     the ragged end are masked, with -inf, so a masked p is exactly 0. The
//     backward issues its two score products together and computes P
//     while the second runs;
//   * outputs (O, dQ, dK, dV as bf16; K4's f32 carry) leave through shared
//     memory by TMA stores of whole boxes, which clip rows past S and
//     columns past hd; stored from the registers they went out in 32-byte
//     pieces, and K4's store of the f32 acc took nearly as long as its
//     products;
//   * every output tile is owned by exactly one CTA (K2: a query tile; K3:
//     a key tile), so there are no atomics and the backward is bitwise
//     repeatable; no (S, S) matrix reaches device memory;
//   * the longest causal walks launch first (the tile index is the grid's
//     slowest dimension; K1, K2, K4: the last query tiles, K3: the first
//     key tiles).
// P (in P V and P^T dO) and dS are rounded to bf16 before their product,
// at the points where the plain versions round them.
// The f32 route (flash_*_kernel) runs scalar f32 FMAs, one CTA of 256
// threads per 64-row tile, so that f32 inputs keep f32's precision; one
// definition of the masked score (masked_score) serves it.

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

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;       // 16 x 16: (ty, tx)
constexpr int kPitchP = kTile + 1;  // row pitch of a score tile in smem

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

using bf16 = __nv_bfloat16;

// ==== bf16 forward (K1, K4): wgmma on register accumulators, TMA ==========
//
// One template, flash_fwd_sm90<HDP, kCarry>, serves K1 (kCarry = false)
// and K4 (kCarry = true); the design is in the note at the top of the
// file. Tiles sit in shared memory in the 128-byte swizzled layout that
// TMA writes and wgmma reads: boxes of 64 rows x 64 bf16 columns (128
// bytes), 16-byte chunk c of row r at chunk c ^ (r % 8).

constexpr int kCtaRows = 128;            // rows (queries; K3: keys) per CTA
constexpr int kWgRows = 64;              // rows per consumer warpgroup

// ---- TMA stores ----

// The inverse of tma_load_box: one bf16 box of a 4-D (hd, H, S, B) map
// from shared memory to device memory.
__device__ __forceinline__ void tma_store_bf16_box(const CUtensorMap* map,
                                                   const uint8_t* src,
                                                   int col, int h, int row,
                                                   int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(h), "r"(row), "r"(b)
      : "memory");
}
// One f32 box (32 columns, 64 rows) of a 3-D (hd, S, B * H) map from
// shared memory to device memory.
__device__ __forceinline__ void tma_store_f32_box(const CUtensorMap* map,
                                                  const uint8_t* src,
                                                  int col, int row,
                                                  int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// -inf for the entries of a score tile (the thread's rows qpos, keys
// from kv0) whose key is past S or, under the causal mask, past the
// row's query: masked_score's rule, on the accumulator layout (entry i
// in row (i >> 1) & 1, column 8 (i >> 2) + 2 (lane & 3) + (i & 1)).
__device__ __forceinline__ void mask_keys(float (&s)[32],
                                          const int (&qpos)[2], int kv0,
                                          int S, bool causal) {
  const int c0 = kv0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = c0 + 8 * (i >> 2) + (i & 1);
    if (col >= S || (causal && col > qpos[(i >> 1) & 1])) s[i] = -INFINITY;
  }
}

// One KV tile of kTile keys merged into a warpgroup's 64 rows. q_s, k_s,
// v_s: shared addresses of the warpgroup's Q and of the tile's K and V
// (HDP / 64 boxes each, 128-byte swizzled). The thread holds rows qpos[0]
// and qpos[1] = qpos[0] + 8; its accumulator entry i sits in row
// (i >> 1) & 1 at column 8 (i >> 2) + 2 (lane & 3) + (i & 1).
//
// The online softmax keeps m in the natural-log domain, as the carry
// stores it, and exponentiates in base 2 with the scale folded into one
// FMA. A masked score is -inf before the max, so its p is exactly 0, and
// a row whose m is still NEG_INF gets alpha = exp2(-huge) = 0 on its
// first live tile, never NaN. l sums the f32 P; P enters P V as bf16.
// Only a tile that crosses the diagonal or the ragged end is masked.
template <int HDP>
__device__ __forceinline__ void fwd_tile(float (&o)[HDP / 2], float (&m)[2],
                                         float (&l)[2], const int (&qpos)[2],
                                         uint32_t q_s, uint32_t k_s,
                                         uint32_t v_s, int kv0, int S,
                                         bool mask, bool causal,
                                         float scale) {
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
  wgmma_scores<HDP>(s, q_s, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  if (mask) mask_keys(s, qpos, kv0, S, causal);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mb[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale);
    alpha[r] = exp2f((m[r] - m_new) * kLog2e);
    mb[r] = m_new * kLog2e;
    m[r] = m_new;
  }
  const float sl2 = scale * kLog2e;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = exp2f(fmaf(s[i], sl2, -mb[(i >> 1) & 1]));
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * alpha[r] + rs[r];
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

// The thread's two rows, carried in (K4) or fresh (K1).
template <int HDP, bool kCarry>
__device__ __forceinline__ void fwd_open(float (&o)[HDP / 2], float (&m)[2],
                                         float (&l)[2], const int (&qpos)[2],
                                         const float* __restrict__ m_io,
                                         const float* __restrict__ l_io,
                                         const float* __restrict__ acc_io,
                                         long long rows, int S, int hd) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = kCarry && qpos[r] < S;
    m[r] = in ? m_io[rows + qpos[r]] : kNegInf;
    l[r] = in ? l_io[rows + qpos[r]] : 0.f;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      float2 v = make_float2(0.f, 0.f);
      if (in && c0 + 8 * j < hd)
        v = *reinterpret_cast<const float2*>(
            acc_io + (rows + qpos[r]) * hd + c0 + 8 * j);
      o[4 * j + 2 * r] = v.x;
      o[4 * j + 2 * r + 1] = v.y;
    }
  }
}

// Row `row` (0..63 within the warpgroup's box) of the thread's accumulator
// row r, divided by div, as bf16 into the 128-byte swizzled boxes of 64
// columns at w; the 8 rows a warp writes at once fall in different banks.
template <int HDP>
__device__ __forceinline__ void stage_row_bf16(const float (&o)[HDP / 2],
                                               int r, int row, float div,
                                               uint8_t* w) {
  const int q4 = threadIdx.x & 3;
  uint8_t* line = w + row * 128;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int chunk = (j % 8) ^ (row & 7);
    *reinterpret_cast<__nv_bfloat162*>(line + (j / 8) * kBoxBytes +
                                       chunk * 16 + 4 * q4) =
        __floats2bfloat162_rn(o[4 * j + 2 * r] / div,
                              o[4 * j + 2 * r + 1] / div);
  }
}

// Makes the warpgroup's staged rows visible to TMA (generic-proxy writes)
// once all 128 threads have written them; true for the one thread that
// then stores them.
__device__ __forceinline__ bool wg_staged() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
  return (threadIdx.x & 127) == 0;
}

// The n bf16 boxes of 64 columns at w to rows [r0, r0 + 64) of a 4-D
// (hd, H, S, B) map.
__device__ __forceinline__ void tma_store_rows_bf16(const CUtensorMap* map,
                                                    const uint8_t* w, int n,
                                                    int h, int r0, int b) {
  for (int a = 0; a < n; ++a)
    tma_store_bf16_box(map, w + a * kBoxBytes, a * kAtomCols, h, r0, b);
}

// Commits the thread's TMA stores and waits until they have read shared
// memory (it stays the CTA's until then).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The warpgroup's 64 rows out, through shared memory and one TMA store
// per box (a row-by-row store from the accumulator layout wrote 32-byte
// pieces and cost K4 nearly as much as its products). K4 stores the carry back
// un-normalised, in place: acc as f32 into c_s (boxes of 32 columns),
// m and l directly. K1 divides by l and writes O as bf16 into its own Q
// tile (free after the last product; boxes of 64 columns) and the
// natural-log LSE directly; a row with l = 0 gives 0 and m + log(1).
// Both boxes are 128-byte swizzled. TMA clips rows past S and columns
// past hd.
template <int HDP, bool kCarry>
__device__ __forceinline__ void fwd_close(const float (&o)[HDP / 2],
                                          const float (&m)[2],
                                          const float (&l)[2],
                                          const int (&qpos)[2], int r0,
                                          uint8_t* q_w, uint8_t* c_w,
                                          const CUtensorMap* tm_o,
                                          float* __restrict__ lse,
                                          float* __restrict__ m_io,
                                          float* __restrict__ l_io,
                                          long long rows, int b, int h,
                                          int S, int H) {
  const int q4 = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qpos[r] - r0;  // 0..63 within the warpgroup's box
    if (kCarry) {
      uint8_t* line = c_w + row * 128;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int chunk = (2 * (j % 4) + (q4 >> 1)) ^ (row & 7);
        *reinterpret_cast<float2*>(line + (j / 4) * kBoxBytes +
                                   chunk * 16 + 8 * (q4 & 1)) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      }
      if (q4 == 0 && qpos[r] < S) {
        m_io[rows + qpos[r]] = m[r];
        l_io[rows + qpos[r]] = l[r];
      }
    } else {
      const float safe_l = (l[r] == 0.f) ? 1.f : l[r];
      stage_row_bf16<HDP>(o, r, row, safe_l, q_w);
      if (q4 == 0 && qpos[r] < S) lse[rows + qpos[r]] = m[r] + logf(safe_l);
    }
  }
  if (wg_staged()) {
    if (kCarry) {
      for (int a = 0; a < HDP / 32; ++a)
        tma_store_f32_box(tm_o, c_w + a * kBoxBytes, a * 32, r0,
                          b * H + h);
    } else {
      tma_store_rows_bf16(tm_o, q_w, HDP / kAtomCols, h, r0, b);
    }
    tma_store_drain();
  }
}

constexpr int kStages = 2;         // tiles of the streamed side in flight
constexpr int kSm90Threads = 384;  // consumer warpgroups 0, 1; producer 2
// Registers per thread after the rebalancing: the producer warpgroup
// keeps few, the consumers take the rest of the CTA's pool, which is
// what the launch gave it (ptxas's count, 168 under these launch bounds,
// times kSm90Threads). setmaxnreg.inc would wait forever for registers the
// pool lacks, so the launcher checks the plan against the compiled count.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The ring's barriers, laid out full[kStages], empty[kStages], then one
// for the CTA's own rows: a full barrier completes on `arrivals`
// arrivals and its TMA bytes, an empty one on one arrival per consumer
// warp, the last on one arrival and its bytes. Then the CTA syncs.
__device__ __forceinline__ void init_ring(uint64_t* full, int arrivals) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], arrivals);
      mbar_init(&full[kStages + s], 8);
    }
    mbar_init(&full[2 * kStages], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// grid (H, B, ceil(S / kCtaRows)): the longest causal rows launch first.
// Warpgroup 2 is the producer: one thread loads Q once and streams the
// K/V tiles through a ring of kStages stages (full / empty mbarriers),
// with its registers given to the consumers (setmaxnreg). Warpgroups 0 and 1
// each own 64 query rows and walk every tile of the CTA, skipping the
// products of a tile none of their keys can see.
template <int HDP, bool kCarry>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o,
               float* __restrict__ lse, float* __restrict__ m_io,
               float* __restrict__ l_io, const float* __restrict__ acc_io,
               int S, int H, int hd, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  constexpr int kBoxes = HDP / kAtomCols;
  constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;  // one K or V tile
  uint8_t* q_s = smem;  // two warpgroups' rows
  uint8_t* k_s = q_s + 2 * kTileBytes;
  uint8_t* v_s = k_s + kStages * kTileBytes;
  uint8_t* c_s = v_s + kStages * kTileBytes;  // K4: the f32 carry out
  uint64_t* full = reinterpret_cast<uint64_t*>(
      c_s + (kCarry ? 2 * (HDP / 32) * kBoxBytes : 0));
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kCtaRows;
  const int kv_end = causal ? min(S, q0 + kCtaRows) : S;
  const int n_kv = (kv_end + kTile - 1) / kTile;
  init_ring(full, 1);

  if (threadIdx.x >= 256) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * kTileBytes);
      for (int w = 0; w < 2; ++w)
        for (int a = 0; a < kBoxes; ++a)
          tma_load_box(q_s + (w * kBoxes + a) * kBoxBytes, &tm_q, q_full,
                       a * kAtomCols, h, q0 + w * kWgRows, b);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        for (int a = 0; a < kBoxes; ++a) {
          tma_load_box(k_s + st * kTileBytes + a * kBoxBytes, &tm_k,
                       &full[st], a * kAtomCols, h, it * kTile, b);
          tma_load_box(v_s + st * kTileBytes + a * kBoxBytes, &tm_v,
                       &full[st], a * kAtomCols, h, it * kTile, b);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int r0 = q0 + wg * kWgRows;
    const long long rows = ((long long)b * H + h) * S;
    const int qpos[2] = {r0 + 16 * (t >> 5) + ((t & 31) >> 2),
                         r0 + 16 * (t >> 5) + ((t & 31) >> 2) + 8};
    float o[HDP / 2], m[2], l[2];
    fwd_open<HDP, kCarry>(o, m, l, qpos, m_io, l_io, acc_io, rows, S, hd);
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages, kv0 = it * kTile;
      mbar_wait(&full[st], (it / kStages) & 1);
      if (!(causal && kv0 > r0 + kWgRows - 1)) {  // a key is visible
        const bool mask =
            kv0 + kTile > S || (causal && kv0 + kTile - 1 > r0);
        fwd_tile<HDP>(o, m, l, qpos,
                      smem_u32(q_s + wg * kTileBytes),
                      smem_u32(k_s + st * kTileBytes),
                      smem_u32(v_s + st * kTileBytes), kv0, S, mask,
                      causal != 0, scale);
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    }
    fwd_close<HDP, kCarry>(o, m, l, qpos, r0, q_s + wg * kTileBytes,
                           c_s + wg * (HDP / 32) * kBoxBytes, &tm_o, lse,
                           m_io, l_io, rows, b, h, S, H);
  }
}

size_t fwd_sm90_smem(int hdp, bool carry) {
  return 1024 + (2 + 2 * kStages) * (hdp / kAtomCols) * kBoxBytes +
         (carry ? 2 * (hdp / 32) * kBoxBytes : 0) +
         (2 * kStages + 1) * sizeof(uint64_t);
}

// ==== bf16 backward (K2, K3): wgmma on register accumulators, TMA ==========
//
// flash_dq_sm90<HDP> (K2) and flash_dkv_sm90<HDP> (K3) are built like the
// forward: 384 threads, consumer warpgroups 0 and 1 of 64 rows each, a
// producer warpgroup that loads the CTA's own rows once and streams the
// other side's 64-row tiles through a kStages ring. Every product is a
// wgmma of the forward's two kinds: a score-like tile from two K-major
// operands in shared memory (wgmma_ss), and an accumulation whose A is a
// 64 x 64 score-like tile rounded to bf16 in registers (wgmma_rs, B read
// MN-major as the forward reads V). The elementwise work (mask, P, dS)
// runs on the accumulator registers; nothing between the products goes
// through shared memory.

// K2, one KV tile into a warpgroup's dQ. q_s, do_s: the warpgroup's Q and
// dO; k_s, v_s: the tile's K and V. lse2: the rows' LSE times log2(e);
// dl: their delta. S = Q K^T and dP = dO V^T are issued together; P is
// computed while dP is still running; dS = P (dP - delta) scale is rounded
// to bf16 in the A-operand layout and dQ += dS K.
template <int HDP>
__device__ __forceinline__ void dq_tile(float (&dq)[HDP / 2],
                                        const int (&qpos)[2],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], uint32_t q_s,
                                        uint32_t do_s, uint32_t k_s,
                                        uint32_t v_s, int kv0, int S,
                                        bool mask, bool causal, float scale) {
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
  wgmma_scores<HDP>(s, q_s, k_s);
  wgmma_commit();
  wgmma_scores<HDP>(dp, do_s, v_s);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(s);

  if (mask) mask_keys(s, qpos, kv0, S, causal);
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s[i] = exp2f(fmaf(s[i], sl2, -lse2[(i >> 1) & 1]));
  wgmma_wait<0>();
  fence_regs(dp);

  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = 8 * kk + 2 * t, r = t & 1;  // entries i, i + 1: row r
      a[kk][t] = pack_bf16(s[i] * (dp[i] - dl[r]) * scale,
                           s[i + 1] * (dp[i + 1] - dl[r]) * scale);
    }
  wgmma_fence();
  fence_regs(dq);
  wgmma_accumulate<HDP>(dq, a, k_s);  // K read as the forward reads V
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(a);
}

// grid (H, B, ceil(S / kCtaRows)): the longest causal rows launch first.
// The CTA owns 128 query rows; one producer thread loads their Q and dO
// once and streams the K/V tiles they can see through the ring. Each
// consumer thread reads the LSE and delta of its two rows once (0 past
// S, so a ragged row makes no inf - inf), keeps dQ in registers for the
// whole walk and skips the products of a tile none of its warpgroup's
// rows can see. dQ leaves as bf16 through the warpgroup's Q tile (free
// after its last product) by TMA store.
template <int HDP>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_dq,
              const float* __restrict__ lse,
              const float* __restrict__ delta, int S, int H, float scale,
              int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  constexpr int kBoxes = HDP / kAtomCols;
  constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;
  uint8_t* q_s = smem;  // two warpgroups' rows of Q, then of dO
  uint8_t* do_s = q_s + 2 * kTileBytes;
  uint8_t* k_s = do_s + 2 * kTileBytes;
  uint8_t* v_s = k_s + kStages * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kCtaRows;
  const int kv_end = causal ? min(S, q0 + kCtaRows) : S;
  const int n_kv = (kv_end + kTile - 1) / kTile;
  init_ring(full, 1);

  if (threadIdx.x >= 256) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 4 * kTileBytes);
      for (int w = 0; w < 2; ++w)
        for (int a = 0; a < kBoxes; ++a) {
          tma_load_box(q_s + (w * kBoxes + a) * kBoxBytes, &tm_q, q_full,
                       a * kAtomCols, h, q0 + w * kWgRows, b);
          tma_load_box(do_s + (w * kBoxes + a) * kBoxBytes, &tm_do, q_full,
                       a * kAtomCols, h, q0 + w * kWgRows, b);
        }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        for (int a = 0; a < kBoxes; ++a) {
          tma_load_box(k_s + st * kTileBytes + a * kBoxBytes, &tm_k,
                       &full[st], a * kAtomCols, h, it * kTile, b);
          tma_load_box(v_s + st * kTileBytes + a * kBoxBytes, &tm_v,
                       &full[st], a * kAtomCols, h, it * kTile, b);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int r0 = q0 + wg * kWgRows;
    const long long rows = ((long long)b * H + h) * S;
    const int qpos[2] = {r0 + 16 * (t >> 5) + ((t & 31) >> 2),
                         r0 + 16 * (t >> 5) + ((t & 31) >> 2) + 8};
    float lse2[2], dl[2], dq[HDP / 2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = qpos[r] < S;
      lse2[r] = in ? lse[rows + qpos[r]] * kLog2e : 0.f;
      dl[r] = in ? delta[rows + qpos[r]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages, kv0 = it * kTile;
      mbar_wait(&full[st], (it / kStages) & 1);
      if (!(causal && kv0 > r0 + kWgRows - 1)) {  // a key is visible
        const bool mask =
            kv0 + kTile > S || (causal && kv0 + kTile - 1 > r0);
        dq_tile<HDP>(dq, qpos, lse2, dl, smem_u32(q_s + wg * kTileBytes),
                     smem_u32(do_s + wg * kTileBytes),
                     smem_u32(k_s + st * kTileBytes),
                     smem_u32(v_s + st * kTileBytes), kv0, S, mask,
                     causal != 0, scale);
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    }
    uint8_t* q_w = q_s + wg * kTileBytes;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      stage_row_bf16<HDP>(dq, r, qpos[r] - r0, 1.f, q_w);
    if (wg_staged()) {
      tma_store_rows_bf16(&tm_dq, q_w, kBoxes, h, r0, b);
      tma_store_drain();
    }
  }
}

// K3, one query tile into a warpgroup's dK and dV, computed transposed
// (the warpgroup's keys as rows, the tile's queries as columns). k_s, v_s:
// the warpgroup's K and V; q_s, do_s: the tile's Q and dO; lse2, dl: the
// tile's 64 LSE (times log2(e)) and delta values in shared memory. The
// thread's column j of an accumulator entry is the same for its two rows,
// so it reads each value once. S^T = K Q^T and dP^T = V dO^T are issued
// together; P^T is computed while dP^T runs, rounded to bf16 and
// dV += P^T dO issued; then dS^T = P^T (dP^T - delta) scale, rounded, and
// dK += dS^T Q.
template <int HDP>
__device__ __forceinline__ void dkv_tile(float (&dk)[HDP / 2],
                                         float (&dv)[HDP / 2],
                                         const int (&kpos)[2], uint32_t k_s,
                                         uint32_t v_s, uint32_t q_s,
                                         uint32_t do_s,
                                         const float* __restrict__ lse2,
                                         const float* __restrict__ dl,
                                         int q0, int S, bool mask,
                                         bool causal, float scale) {
  const int c0 = 2 * (threadIdx.x & 3);
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
  wgmma_scores<HDP>(s, k_s, q_s);
  wgmma_commit();
  wgmma_scores<HDP>(dp, v_s, do_s);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(s);

  if (mask) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = q0 + c0 + 8 * (i >> 2) + (i & 1);  // a query
      if (col >= S || (causal && col < kpos[(i >> 1) & 1])) s[i] = -INFINITY;
    }
  }
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c0 + 8 * j);
    s[4 * j] = exp2f(fmaf(s[4 * j], sl2, -l2.x));
    s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2, -l2.y));
    s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2, -l2.x));
    s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2, -l2.y));
  }
  uint32_t ap[4][4];
  pack_a(ap, s);
  wgmma_fence();
  fence_regs(dv);
  wgmma_accumulate<HDP>(dv, ap, do_s);
  wgmma_commit();
  wgmma_wait<1>();  // S^T and dP^T done; dV may still run
  fence_regs(dp);

  uint32_t ads[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = 8 * kk + 2 * t;  // entries i, i + 1: two columns
      const float2 d = *reinterpret_cast<const float2*>(dl + c0 + 8 * (i >> 2));
      ads[kk][t] = pack_bf16(s[i] * (dp[i] - d.x) * scale,
                             s[i + 1] * (dp[i + 1] - d.y) * scale);
    }
  wgmma_fence();
  fence_regs(dk);
  wgmma_accumulate<HDP>(dk, ads, q_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(ap);
  fence_regs(ads);
}

// grid (H, B, ceil(S / kCtaRows)): the first key tiles, which the most
// query tiles see, launch first. The CTA owns 128 key rows; one producer
// thread loads their K and V once and streams the 64-row Q and dO tiles
// that can see them (under the causal mask, from the CTA's first key on).
// The tile's LSE (times log2(e)) and delta travel with it in the same
// stage: each lane of the producer warp reads two of each (0 past S) and
// arrives on the stage's full barrier, whose count is the warp's 32
// lanes, lane 0's arrival also expecting the TMA bytes. Each consumer
// warpgroup owns 64 keys, keeps dK and dV in registers and skips the
// products of a tile none of whose queries sees its keys. dK and dV leave
// as bf16 through the warpgroup's K and V tiles by TMA store.
template <int HDP>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_dk,
               const __grid_constant__ CUtensorMap tm_dv,
               const float* __restrict__ lse,
               const float* __restrict__ delta, int S, int H, float scale,
               int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  constexpr int kBoxes = HDP / kAtomCols;
  constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;
  uint8_t* k_s = smem;  // two warpgroups' keys of K, then of V
  uint8_t* v_s = k_s + 2 * kTileBytes;
  uint8_t* q_s = v_s + 2 * kTileBytes;
  uint8_t* do_s = q_s + kStages * kTileBytes;
  float* rows_s = reinterpret_cast<float*>(do_s + kStages * kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_s + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kCtaRows;
  const int q_begin = causal ? k0 : 0;
  const int n_q = (S - q_begin + kTile - 1) / kTile;
  const long long rows = ((long long)b * H + h) * S;
  init_ring(full, 32);  // the producer warp's lanes

  if (threadIdx.x >= 256) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 4 * kTileBytes);
        for (int w = 0; w < 2; ++w)
          for (int a = 0; a < kBoxes; ++a) {
            tma_load_box(k_s + (w * kBoxes + a) * kBoxBytes, &tm_k, kv_full,
                         a * kAtomCols, h, k0 + w * kWgRows, b);
            tma_load_box(v_s + (w * kBoxes + a) * kBoxBytes, &tm_v, kv_full,
                         a * kAtomCols, h, k0 + w * kWgRows, b);
          }
      }
      for (int it = 0; it < n_q; ++it) {
        const int st = it % kStages, q0 = q_begin + it * kTile;
        float l2[2], d[2];  // read before the wait: the loads overlap it
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = q0 + lane + 32 * u;
          l2[u] = r < S ? lse[rows + r] * kLog2e : 0.f;
          d[u] = r < S ? delta[rows + r] : 0.f;
        }
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        float* rs = rows_s + st * 2 * kTile;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          rs[lane + 32 * u] = l2[u];
          rs[kTile + lane + 32 * u] = d[u];
        }
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * kTileBytes);
          for (int a = 0; a < kBoxes; ++a) {
            tma_load_box(q_s + st * kTileBytes + a * kBoxBytes, &tm_q,
                         &full[st], a * kAtomCols, h, q0, b);
            tma_load_box(do_s + st * kTileBytes + a * kBoxBytes, &tm_do,
                         &full[st], a * kAtomCols, h, q0, b);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int c0 = k0 + wg * kWgRows;  // the warpgroup's first key
    const int kpos[2] = {c0 + 16 * (t >> 5) + ((t & 31) >> 2),
                         c0 + 16 * (t >> 5) + ((t & 31) >> 2) + 8};
    float dk[HDP / 2], dv[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_q; ++it) {
      const int st = it % kStages, q0 = q_begin + it * kTile;
      mbar_wait(&full[st], (it / kStages) & 1);
      if (!(causal && q0 + kTile - 1 < c0)) {  // a query sees a key
        const bool mask = q0 + kTile > S || (causal && q0 < c0 + kWgRows - 1);
        const float* rs = rows_s + st * 2 * kTile;
        dkv_tile<HDP>(dk, dv, kpos, smem_u32(k_s + wg * kTileBytes),
                      smem_u32(v_s + wg * kTileBytes),
                      smem_u32(q_s + st * kTileBytes),
                      smem_u32(do_s + st * kTileBytes), rs, rs + kTile, q0,
                      S, mask, causal != 0, scale);
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    }
    uint8_t* k_w = k_s + wg * kTileBytes;
    uint8_t* v_w = v_s + wg * kTileBytes;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      stage_row_bf16<HDP>(dk, r, kpos[r] - c0, 1.f, k_w);
      stage_row_bf16<HDP>(dv, r, kpos[r] - c0, 1.f, v_w);
    }
    if (wg_staged()) {
      tma_store_rows_bf16(&tm_dk, k_w, kBoxes, h, c0, b);
      tma_store_rows_bf16(&tm_dv, v_w, kBoxes, h, c0, b);
      tma_store_drain();
    }
  }
}

size_t dq_sm90_smem(int hdp) {
  return 1024 + (4 + 2 * kStages) * (hdp / kAtomCols) * kBoxBytes +
         (2 * kStages + 1) * sizeof(uint64_t);
}
size_t dkv_sm90_smem(int hdp) {
  return 1024 + (4 + 2 * kStages) * (hdp / kAtomCols) * kBoxBytes +
         kStages * 2 * kTile * sizeof(float) +
         (2 * kStages + 1) * sizeof(uint64_t);
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

// A 4-D bf16 map (hd, H, S, B) over base with the element strides
// (sh, ss, sb), boxes of 64 columns x 64 rows.
int map_bf16(CUtensorMap* map, const void* base, const Args& a,
             long long sb, long long ss, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)a.hd, (cuuint64_t)a.H,
                              (cuuint64_t)a.S, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * sizeof(bf16),
                                 (cuuint64_t)ss * sizeof(bf16),
                                 (cuuint64_t)sb * sizeof(bf16)};
  const cuuint32_t box[4] = {kAtomCols, 1, kTile, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                strides, box);
}

// A 3-D f32 map (hd, S, B * H) over a contiguous (B, H, S, hd) tensor,
// boxes of 32 columns (128 bytes) x 64 rows.
int map_f32(CUtensorMap* map, const void* base, const Args& a) {
  const cuuint64_t dims[3] = {(cuuint64_t)a.hd, (cuuint64_t)a.S,
                              (cuuint64_t)a.B * a.H};
  const cuuint64_t strides[2] = {(cuuint64_t)a.hd * sizeof(float),
                                 (cuuint64_t)a.S * a.hd * sizeof(float)};
  const cuuint32_t box[3] = {32, kTile, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims,
                strides, box);
}

// A contiguous (B, S, H, hd) bf16 tensor's map.
int map_bf16_contig(CUtensorMap* map, const void* base, const Args& a) {
  return map_bf16(map, base, a, (long long)a.S * a.H * a.hd,
                  (long long)a.H * a.hd, a.hd);
}

// Once per sm90 kernel: opts in to its shared memory and checks that the
// compiled register count holds the setmaxnreg plan (code 9003 if not).
template <typename K>
int sm90_ready(K kernel, size_t smem) {
  const int rc = opt_in(kernel, smem);
  if (rc) return rc;
  cudaFuncAttributes at;
  const int got = static_cast<int>(cudaFuncGetAttributes(&at, kernel));
  if (got) return got;
  const int plan = 128 * kProducerRegs + 256 * kConsumerRegs;
  return at.numRegs * kSm90Threads >= plan ? 0 : kRegisterPlanUnmet;
}

// The bf16 kernels: HDP = 64 or 128 columns. The tensor maps are built
// per call (a captured graph keeps the launch's copy of them).
template <int HDP, bool kCarry>
int launch_fwd_sm90(const Args& a) {  // K1 (kCarry false), K4
  static const int set = sm90_ready(flash_fwd_sm90<HDP, kCarry>,
                                    fwd_sm90_smem(HDP, kCarry));
  if (set) return set;
  CUtensorMap tq, tk, tv, to;
  int rc = map_bf16(&tq, a.q, a, a.sb, a.ss, a.sh);
  if (!rc) rc = map_bf16(&tk, a.k, a, a.sb, a.ss, a.sh);
  if (!rc) rc = map_bf16(&tv, a.v, a, a.sb, a.ss, a.sh);
  if (!rc)
    rc = kCarry ? map_f32(&to, a.acc, a) : map_bf16_contig(&to, a.out0, a);
  if (rc) return rc;
  const dim3 grid(a.H, a.B, (a.S + kCtaRows - 1) / kCtaRows);
  flash_fwd_sm90<HDP, kCarry>
      <<<grid, kSm90Threads, fwd_sm90_smem(HDP, kCarry), a.stream>>>(
          tq, tk, tv, to, a.lse_out, a.m, a.l, a.acc, a.S, a.H, a.hd,
          a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_dq_sm90(const Args& a) {  // K2
  static const int set = sm90_ready(flash_dq_sm90<HDP>, dq_sm90_smem(HDP));
  if (set) return set;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int rc = map_bf16(&tq, a.q, a, a.sb, a.ss, a.sh);
  if (!rc) rc = map_bf16(&tk, a.k, a, a.sb, a.ss, a.sh);
  if (!rc) rc = map_bf16(&tv, a.v, a, a.sb, a.ss, a.sh);
  if (!rc) rc = map_bf16_contig(&tdo, a.dout, a);
  if (!rc) rc = map_bf16_contig(&tdq, a.out0, a);
  if (rc) return rc;
  const dim3 grid(a.H, a.B, (a.S + kCtaRows - 1) / kCtaRows);
  flash_dq_sm90<HDP><<<grid, kSm90Threads, dq_sm90_smem(HDP), a.stream>>>(
      tq, tk, tv, tdo, tdq, a.lse_in, a.delta, a.S, a.H, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_dkv_sm90(const Args& a) {  // K3
  static const int set = sm90_ready(flash_dkv_sm90<HDP>, dkv_sm90_smem(HDP));
  if (set) return set;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int rc = map_bf16(&tq, a.q, a, a.sb, a.ss, a.sh);
  if (!rc) rc = map_bf16(&tk, a.k, a, a.sb, a.ss, a.sh);
  if (!rc) rc = map_bf16(&tv, a.v, a, a.sb, a.ss, a.sh);
  if (!rc) rc = map_bf16_contig(&tdo, a.dout, a);
  if (!rc) rc = map_bf16_contig(&tdk, a.out0, a);
  if (!rc) rc = map_bf16_contig(&tdv, a.out1, a);
  if (rc) return rc;
  const dim3 grid(a.H, a.B, (a.S + kCtaRows - 1) / kCtaRows);
  flash_dkv_sm90<HDP><<<grid, kSm90Threads, dkv_sm90_smem(HDP), a.stream>>>(
      tq, tk, tv, tdo, tdk, tdv, a.lse_in, a.delta, a.S, a.H, a.scale,
      a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_bf16(int which, const Args& a) {
  if (which == 0) return launch_fwd_sm90<HDP, false>(a);
  if (which == 1) return launch_dq_sm90<HDP>(a);
  if (which == 2) return launch_dkv_sm90<HDP>(a);
  return launch_fwd_sm90<HDP, true>(a);
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
    return narrow ? launch_bf16<64>(which, a) : launch_bf16<128>(which, a);
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
