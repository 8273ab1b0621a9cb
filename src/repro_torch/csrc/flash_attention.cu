// Exact softmax attention, online over key tiles (flash attention, forward),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) and, in the model, the pure-JAX
// `_flash_attention` scan of src/repro/models/attention.py.  For every
// query row i of every (batch, head):
//
//   s[i, j] = scale * (q[i] . k[j])
//   s[i, j] = -1e30 where causal and j > last(i)   (not -inf, as the
//             reference), last(i) = P - 1 for i < P, else i
//   out[i]  = sum_j exp(s[i, j] - m) v[j] / max(sum_j exp(s[i, j] - m), 1e-30)
//
// with the running max m and sum l carried over key tiles as the reference
// does (alpha = exp(m_prev - m_new)).  P is the prefix of full attention
// (paligemma's image patches and prompt, the JAX package's `prefix_len`):
// its rows see every key below P, the JAX mask (i >= j) | (i < P & j < P);
// P = 0 is the plain causal mask, with the same tiles and the same bits.
// The output is f32.  GQA: query head
// h reads key/value head h / (H / Hk).  q, k and v are read through their
// (batch, seq, head) strides with the head dimension contiguous, so the
// model's (B, S, H, D) layout and the TPU kernel's (BH, S, D) layout both
// come in without a copy; the output is a contiguous (B, S, H, Dv) f32.
// v may be narrower than q and k (Dv <= D: MLA's q and k carry 128 + 64
// columns, its v 128): V's tile loads Dv columns and zero-pads the rest in
// shared memory, as the head dimension is padded, so the accumulator's
// padded columns stay 0 and are never stored.
//
// What bounds it on the card: operations.  At the serving path's prefill
// (B = 4, S = 2048, 32 query heads over 4 KV heads, D = 128, bf16, causal)
// the work is 2 S (S + 1) D per head, 1.38e11 operations against 218 MB of
// q, k, v and the f32 output: 0.139 ms on the bf16 tensor cores, 0.065 ms
// for the bytes, 2.05 ms at the 67 TFLOP/s of f32 outside the tensor cores.
//
// bf16 inputs (the serving path) run on the tensor cores, `mma.sync`
// m16n8k16 bf16 -> f32 fed by `ldmatrix`, all as inline PTX (warp_mma.cuh,
// shared with the backward; no header beyond the toolkit's).  `mma.sync`
// rather than `wgmma`: it keeps the FA2 shape (one warp owns 16 query
// rows, the softmax runs on the accumulator fragments in registers, no
// warpgroup descriptors or async fences) and is the simpler kernel to
// get right; `wgmma` is the later step to the full rate.
//   - A block of 8 warps owns 128 query rows of one (batch, head), 16 per
//     warp.  The bf16 Q tile stays bf16 in shared memory; for D <= 128 each
//     warp keeps its Q fragments in registers for the whole key loop.
//   - K and V have their own bf16 buffers in a two-stage ring filled by
//     16-byte `cp.async`: V(j + 1) and K(j + 2) load while tile j is
//     multiplied, behind one `__syncthreads` per tile.  Rows are padded by
//     16 bytes, so the eight rows an `ldmatrix` reads fall in eight
//     different bank groups.
//   - Software-pipelined: one barrier per tile holds the block's warps in
//     step, so they would all reach the softmax together and leave the
//     tensor cores idle.  Instead each warp issues the products of the
//     next tile's scores before the current tile's softmax and P V, in one
//     straight-line block, and the compiler interleaves the two (the
//     softmax arithmetic runs while the tensor cores work).
//   - S = Q K^T on the tensor cores; the products of two bf16 values are
//     exact in f32, so the scores differ from the reference's only by the
//     order of the f32 sums and by where `scale` is applied (to s, after
//     the product, with log2(e) folded in for `exp2f`).
//   - P V without losing the f32 result: p is f32 in (0, 1], and rounding
//     it to bf16 costs up to 2^-9 of each term, which the 1e-4 check of
//     the serving path rejects.  So p = p_hi + p_lo, p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), and two products run against the bf16 V tile
//     (V is exact in bf16): p is carried to about 2^-17.  This costs 1.5x
//     the tensor-core work of a pure-bf16 kernel.  The row sum l is taken
//     from the unrounded f32 p.
//   - The running max and sum live on the accumulator fragments (rows
//     lane / 4 and lane / 4 + 8 of the warp's 16), reduced across the quad
//     of lanes that share a row by two xor shuffles.
//   - Causal: tiles wholly past the block's last visible key are never
//     loaded, a warp skips the products of a tile past all its rows' last
//     keys, and only tiles past the warp's first row's last key (or at the
//     ragged end) are masked, with -1e30.  With a prefix, last(i) is
//     nondecreasing in i, so a block's or a warp's first and last rows
//     bound these tests, and a block that straddles P takes both rules.  The longest query blocks, the last ones, are scheduled
//     first, so that the grid's tail is short.
//   - Any D in 1..256: the head dimension is zero-padded in shared memory
//     to 64, 128 or 256 (zero columns add nothing to a score, and padded
//     output columns are not written); V's tiles are padded past Dv, so
//     at MLA's D 192 / Dv 128 the P V products run over 256 columns, half
//     of them zeros.  Any S: rows past S load as zeros and are never
//     written; keys past S get p = 0.  Tiles load with
//     16-byte `cp.async` when D and every stride are multiples of 8 and the
//     pointers are 16-byte aligned, else element by element.
// The block takes 102 KB of shared memory at D = 128 (one block of 8
// warps per SM with the registers it needs, about 240 a thread), 135 KB at
// D = 256 with 32-key tiles; the launcher raises the block's limit first.
// What is left: `mma.sync` issues at well under the card's bf16 rate,
// which only `wgmma` reaches (the next step).
//
// f32 inputs (olmo-1b's f32 training, as the JAX launcher trains, and the
// reduced f32 checks) keep the first kernel, plain SIMT f32: a block of
// 256 threads owns 64 query rows, each thread a 4 x 4 block of scores and
// a 4 x (D/16) slice of the accumulator; 64-key tiles of K, then V, in one
// shared f32 buffer with a row stride of D + 1.  Its floor is the 2.05 ms
// f32 figure.
//
// Rounding: key 0 is valid for every query row, so after the first tile
// every row's max is a real score and exp(-1e30 - m) is 0 on every masked
// key, as in the reference.
//
// For training both routes also write, when given a non-null `lse`, each
// row's log-sum-exp of its scaled scores, lse[b, h, i] = m + log(l) in the
// natural log (B, H, S) f32, for the backward kernels of
// flash_attention_bwd.cu.  It is read off the finished m and l after the
// output is stored, so `out` has the same bits with or without it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

// The last key that query row `row` sees under the causal mask with a
// prefix of `prefix` rows of full attention.
__device__ __forceinline__ int last_key(int row, int prefix) {
  return row < prefix ? prefix - 1 : row;
}

// ---------------------------------------------------------------------------
// f32: plain SIMT
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 keys
constexpr int kPStride = kBK + 1;

// rows [row0, row0 + 64) of a (seq, cols) view with row stride `stride`,
// multiplied by `mul`, into dst[r * (D + 1) + d] for d < D; rows at or
// past S and columns at or past `cols` (<= D) are 0.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int row0,
                                              int S, int D, int cols,
                                              float mul) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * ld + d] = row < S && d < cols
                          ? src[static_cast<long long>(row) * stride + d] * mul
                          : 0.0f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// NC = columns of the accumulator per thread: D <= 16 * NC.
template <int NC>
__global__ void __launch_bounds__(kThreads)
    simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int S, int H, int Hk, int D, int Dv,
                Strides qs_, Strides ks_, Strides vs_, float scale,
                int causal, int prefix) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;             // kBQ x ld, the scaled queries
  float* kvs = qs + kBQ * ld;   // kBK x ld, K then V of the current tile
  float* ps = kvs + kBK * ld;   // kBQ x kPStride, p of the current tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // keys tx + 16 j; accumulator columns tx + 16 c
  const int ty = tid >> 4;  // rows ty * 4 + i
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + hk * ks_.h;
  const float* vb = v + b * vs_.b + hk * vs_.h;

  load_tile_f32(qs, qb, qs_.s, q0, S, D, D, scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // Causal: tiles starting past the block's last visible key are masked
  // for every row and skipped.
  const int k_end = causal ? min(S, last_key(q0 + kBQ - 1, prefix) + 1) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q is staged; the last tile's V and p are read
    load_tile_f32(kvs, kb, ks_.s, k0, S, D, D, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kvs[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > last_key(qpos, prefix)))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = kpos < S ? expf(s[i][j] - m_new) : 0.0f;
        ps[row * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // K is read and p is written
    load_tile_f32(kvs, vb, vs_.s, k0, S, D, Dv, 1.0f);
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < Dv) {
          const float vv = kvs[j * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + ((static_cast<long long>(b) * S + qpos) * H + h) * Dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv) orow[col] = acc[i][c] / den;
    }
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * H + h) * S + qpos] = m[i] + logf(den);
  }
}

template <int NC>
int launch_simt(const float* q, const float* k, const float* v, float* out,
                float* lse, int B, int S, int H, int Hk, int D, int Dv,
                Strides qs_,
                Strides ks_, Strides vs_, float scale, int causal,
                int prefix, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   ((kBQ + kBK) * (D + 1) + kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      simt_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  simt_kernel<NC><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, S, H, Hk, D, Dv, qs_, ks_, vs_, scale, causal,
      prefix);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;  // query rows per block, 16 per warp
constexpr int kRowPad = 8;            // bf16 per row: 16 bytes

template <int DP>  // the head dimension, zero-padded to 64, 128 or 256
struct Tc {
  static constexpr int kBK = DP > 128 ? 32 : 64;  // keys per tile
  static constexpr int kLd = DP + kRowPad;        // shared row stride
  static constexpr bool kQInRegs = DP <= 128;
  static constexpr int kSmem = (kTcBQ + 4 * kBK) * kLd * 2;  // Q, 2 x (K, V)
};

// Rows [row0, row0 + ROWS) of a (seq, D) bf16 view into a shared tile of
// row stride LD, zero past S and past D.  `vec`: 16-byte cp.async (D and
// the row stride multiples of 8, the base 16-byte aligned); else element by
// element, synchronously.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int row0,
                                               int S, int D, bool vec) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int row = row0 + r;
    __nv_bfloat16* d = dst + r * LD + c;
    if (vec) {
      const bool ok = row < S && c < D;
      const __nv_bfloat16* s =
          ok ? src + static_cast<long long>(row) * stride + c : src;
      cp_async16(smem_addr(d), s, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c + e;
        d[e] = (row < S && col < D)
                   ? src[static_cast<long long>(row) * stride + col]
                   : __float2bfloat16(0.0f);
      }
    }
  }
}

// S = Q K^T for one warp's 16 rows against a BK-key tile: f32 accumulators
// on the tensor cores.  `q_lane` / `k_lane`: this lane's ldmatrix row
// addresses in the Q tile and the K tile.
template <int DP, int BK, int LD, bool kQInRegs, int QN>
__device__ __forceinline__ void tile_scores(float (&s)[BK / 8][4],
                                            const uint32_t (&qf)[QN][4],
                                            uint32_t q_lane,
                                            uint32_t k_lane) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    if constexpr (kQInRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
    } else {
      ldmatrix_x4(a, q_lane + kk * 32);
    }
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      uint32_t kb[4];
      ldmatrix_x4(kb, k_lane + (jj * 16 * LD + kk * 16) * 2);
      mma_bf16(s[2 * jj], a, kb[0], kb[1]);
      mma_bf16(s[2 * jj + 1], a, kb[2], kb[3]);
    }
  }
}

// One key tile of one warp, software-pipelined: the products of the next
// tile's scores (`sn`, from `k_next`) are issued first, and the online
// softmax of this tile's scores (`s`) and its P V products (from `v_lane`)
// follow in the same straight-line block, so the warp's softmax
// arithmetic runs while the tensor cores work on the next tile.  kMask:
// the tile crosses the causal diagonal or the ragged end.
template <int DP, int BK, int LD, bool kQInRegs, bool kMask, int QN>
__device__ __forceinline__ void tile_step(
    float (&s)[BK / 8][4], float (&sn)[BK / 8][4], float (&acc)[DP / 8][4],
    float (&m)[2], float (&l)[2], const uint32_t (&qf)[QN][4], uint32_t q_lane,
    uint32_t k_next, uint32_t v_lane, float scale_log2, int k0, int S,
    int causal, int prefix, int row_a, int lane) {
  constexpr int NS = BK / 8;
  constexpr int NO = DP / 8;
  tile_scores<DP, BK, LD, kQInRegs>(sn, qf, q_lane, k_next);

  // Scale into the log2 domain, mask, and the row max over the quad.
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (kMask) {
        const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        x = (key >= S || (causal && key > last_key(row, prefix))) ? kNegInf
                                                                  : x;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - m[e >> 1]);
      s[j][e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }

  // O += (P_hi + P_lo) V: the score fragments of keys 16 kk .. 16 kk + 15
  // are the A fragment of this k-step.
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    uint32_t ph[4], pl[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int dd = 0; dd < NO / 2; ++dd) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, v_lane + (kk * 16 * LD + dd * 16) * 2);
      mma_bf16(acc[2 * dd], ph, vb[0], vb[1]);
      mma_bf16(acc[2 * dd], pl, vb[0], vb[1]);
      mma_bf16(acc[2 * dd + 1], ph, vb[2], vb[3]);
      mma_bf16(acc[2 * dd + 1], pl, vb[2], vb[3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
    tc_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int B, int S, int H, int Hk, int D,
              int Dv, Strides qs_, Strides ks_, Strides vs_, float scale_log2,
              int causal, int prefix, int vec_in) {
  using C = Tc<DP>;
  constexpr int BK = C::kBK;
  constexpr int LD = C::kLd;
  constexpr int NS = BK / 8;   // score n-tiles (8 keys each)
  constexpr int NO = DP / 8;   // output n-tiles (8 columns each)
  constexpr int KD = DP / 16;  // k-steps over the head dimension
  constexpr bool kQReg = C::kQInRegs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTcBQ * LD;   // [2][BK][LD]: K(j) in stage j % 2
  __nv_bfloat16* vs = ks + 2 * BK * LD;  // [2][BK][LD]: V(j) in stage j % 2

  const bool vec = vec_in != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Longest query blocks first: the last block under causal masking.
  const int bh = static_cast<int>(blockIdx.x % (H * B));
  const int nqb = (S + kTcBQ - 1) / kTcBQ;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / (H * B));
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qb * kTcBQ;
  const int hk = h / (H / Hk);
  const __nv_bfloat16* qg = q + b * qs_.b + h * qs_.h;
  const __nv_bfloat16* kg = k + b * ks_.b + hk * ks_.h;
  const __nv_bfloat16* vg = v + b * vs_.b + hk * vs_.h;

  const int k_end =
      causal ? min(S, last_key(q0 + kTcBQ - 1, prefix) + 1) : S;
  const int n_tiles = (k_end + BK - 1) / BK;

  // Q and K(0), then V(0) and K(1): tile j's V and tile j + 1's K arrive
  // together, one iteration ahead of their use.
  load_tile_bf16<kTcBQ, DP, LD>(qs, qg, qs_.s, q0, S, D, vec);
  load_tile_bf16<BK, DP, LD>(ks, kg, ks_.s, 0, S, D, vec);
  cp_async_commit();
  load_tile_bf16<BK, DP, LD>(vs, vg, vs_.s, 0, S, Dv, vec);
  if (n_tiles > 1)
    load_tile_bf16<BK, DP, LD>(ks + BK * LD, kg, ks_.s, BK, S, D, vec);
  cp_async_commit();
  cp_async_wait<1>();  // Q and K(0) are in
  __syncthreads();

  // This warp's rows: r0 = lane / 4 and r0 + 8 of its 16.
  const int wrow0 = q0 + warp * 16;
  const int row_a = wrow0 + (lane >> 2);
  // ldmatrix row addresses: A (Q) rows lane % 16, columns 8 (lane / 16);
  // B (K) keys lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) % 2);
  // B (V, transposed) keys lane % 16, columns 8 (lane / 16).
  const uint32_t q_lane =
      smem_addr(qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t k_lane = smem_addr(
      ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = smem_addr(vs + (lane & 15) * LD + (lane >> 4) * 8);
  constexpr uint32_t kStage = BK * LD * 2;  // bytes per ring stage

  uint32_t qf[kQReg ? KD : 1][4];
  if constexpr (kQReg) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 32);
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float s[NS][4], sn[NS][4];
  tile_scores<DP, BK, LD, kQReg>(s, qf, q_lane, k_lane);  // tile 0

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // V(t) and K(t + 1)
    __syncthreads();     // ... for every warp; stages of t - 1 are free
    if (t + 1 < n_tiles)
      load_tile_bf16<BK, DP, LD>(vs + ((t + 1) & 1) * BK * LD, vg, vs_.s,
                                 (t + 1) * BK, S, Dv, vec);
    if (t + 2 < n_tiles)
      load_tile_bf16<BK, DP, LD>(ks + (t & 1) * BK * LD, kg, ks_.s,
                                 (t + 2) * BK, S, D, vec);
    cp_async_commit();

    const int k0 = t * BK;
    // A warp whose rows' last keys all come before this tile's first key
    // is done: every later tile is masked for it too.
    if (causal && k0 > last_key(wrow0 + 15, prefix)) continue;
    const uint32_t k_next = k_lane + ((t + 1) & 1) * kStage;
    const uint32_t v_cur = v_lane + (t & 1) * kStage;
    // The next tile's scores are computed even past the last tile (on a
    // stale stage, never read), so that the step is one straight block.
    if (k0 + BK > S || (causal && k0 + BK - 1 > last_key(wrow0, prefix)))
      tile_step<DP, BK, LD, kQReg, true>(s, sn, acc, m, l, qf, q_lane,
                                         k_next, v_cur, scale_log2, k0, S,
                                         causal, prefix, row_a, lane);
    else
      tile_step<DP, BK, LD, kQReg, false>(s, sn, acc, m, l, qf, q_lane,
                                          k_next, v_cur, scale_log2, k0, S,
                                          causal, prefix, row_a, lane);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sn[j][e];
  }

  // l over the quad, then out = acc / max(l, 1e-30).
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
    l[r] = 1.0f / den[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    float* orow = out + ((static_cast<long long>(b) * S + row) * H + h) * Dv;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      const float x0 = acc[j][2 * r] * l[r];
      const float x1 = acc[j][2 * r + 1] * l[r];
      if (col + 1 < Dv && (Dv & 1) == 0) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < Dv) orow[col] = x0;
        if (col + 1 < Dv) orow[col + 1] = x1;
      }
    }
    // m is in the log2 domain of the scaled scores: back to the natural log.
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<long long>(b) * H + h) * S + row] =
          (m[r] + log2f(den[r])) * 0.6931471805599453f;
  }
}

template <int DP>
int launch_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
              const __nv_bfloat16* v, float* out, float* lse, int B, int S,
              int H, int Hk,
              int D, int Dv, Strides qs_, Strides ks_, Strides vs_,
              float scale, int causal, int prefix, int vec,
              cudaStream_t stream) {
  constexpr int smem = Tc<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block per (query block, batch, head), query blocks slowest.
  const long long nqb = (S + kTcBQ - 1) / kTcBQ;
  const unsigned grid = static_cast<unsigned>(nqb * H * B);
  tc_kernel<DP><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, out, lse, B, S, H, Hk, D, Dv, qs_, ks_, vs_, scale * kLog2e,
      causal, prefix, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k (B, S, Hk, D) and v (B, S, Hk, Dv), read through
// `strides`: nine element strides, (batch, seq, head) of q, then of k,
// then of v; the head dimension is contiguous.  out is a contiguous
// (B, S, H, Dv) f32.  1 <= Dv <= D <= 256, H % Hk == 0 and
// 0 <= prefix <= S (the Python binding checks them); `prefix` matters only
// when `causal`.  `lse`, when not null, is a contiguous (B, H, S) f32 that
// takes each row's log-sum-exp.  Returns the cudaError_t of the attribute
// call or the launch.
extern "C" int flash_attention_f32_launch(const float* q, const float* k,
                                          const float* v, float* out, int B,
                                          int S, int H, int Hk, int D, int Dv,
                                          const long long* strides,
                                          float scale, int causal,
                                          int prefix, float* lse,
                                          void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const Strides qs_{strides[0], strides[1], strides[2]};
  const Strides ks_{strides[3], strides[4], strides[5]};
  const Strides vs_{strides[6], strides[7], strides[8]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_simt<4>(q, k, v, out, lse, B, S, H, Hk, D, Dv, qs_,
                          ks_, vs_, scale, causal, prefix, st);
  if (D <= 128)
    return launch_simt<8>(q, k, v, out, lse, B, S, H, Hk, D, Dv, qs_,
                          ks_, vs_, scale, causal, prefix, st);
  return launch_simt<16>(q, k, v, out, lse, B, S, H, Hk, D, Dv, qs_,
                         ks_, vs_, scale, causal, prefix, st);
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, float* out, int B,
                                           int S, int H, int Hk, int D,
                                           int Dv, const long long* strides,
                                           float scale, int causal,
                                           int prefix, float* lse,
                                           void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const Strides qs_{strides[0], strides[1], strides[2]};
  const Strides ks_{strides[3], strides[4], strides[5]};
  const Strides vs_{strides[6], strides[7], strides[8]};
  bool vec = D % 8 == 0 && Dv % 8 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 8 == 0;
  vec = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_tc<64>(qb, kb, vb, out, lse, B, S, H, Hk, D, Dv, qs_,
                         ks_, vs_, scale, causal, prefix, vec, st);
  if (D <= 128)
    return launch_tc<128>(qb, kb, vb, out, lse, B, S, H, Hk, D, Dv, qs_,
                          ks_, vs_, scale, causal, prefix, vec, st);
  return launch_tc<256>(qb, kb, vb, out, lse, B, S, H, Hk, D, Dv, qs_,
                        ks_, vs_, scale, causal, prefix, vec, st);
}
