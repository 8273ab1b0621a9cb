// The backward of exact softmax attention (flash attention), for Hopper
// (sm_90a): dQ, dK and dV from q, k, v, the forward's f32 output O, its
// gradient dO and the forward's log-sum-exp (flash_attention.cu, `lse`).
//
// Replaces no TPU kernel: the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) has no backward, and the JAX
// package's training differentiates its pure-JAX `_flash_attention` scan
// (src/repro/models/attention.py).  The port's attention runs the forward
// kernel on the card, so its gradient is this kernel, called from the
// `torch.autograd.Function` in kernels/ops.py.  For every (batch, head) and
// every pair of a query row i and a key j that it sees:
//
//   p[i, j]  = exp(scale * (q[i] . k[j]) - lse[i])     (P recomputed)
//   dp[i, j] = dO[i] . v[j]
//   ds[i, j] = p[i, j] * (dp[i, j] - delta[i]),  delta[i] = dO[i] . O[i]
//   dV[j]   += p[i, j] dO[i]
//   dK[j]   += scale * ds[i, j] q[i]
//   dQ[i]   += scale * ds[i, j] k[j]
//
// The mask is the forward's: keys past S never count, and causal row i
// sees keys j <= last(i), last(i) = P - 1 for i < P (the prefix of full
// attention), else i.  GQA: query head h reads KV head h / (H / Hk), so
// dK and dV of a KV head sum over its H / Hk query heads.  The plain
// version of these equations is `ref.attention_bshd_bwd_ref`.
//
// Three launches, no atomics anywhere, so that two launches on the same
// inputs give the same bits:
//   1. delta: one warp a (b, i, h) row, dO . O.
//   2. dK and dV: one block owns a tile of keys of one KV head (16 a warp)
//      and loops, in a fixed order, over the query tiles of every query
//      head of its group that can see those keys.
//   3. dQ: one block owns a tile of query rows of one head (16 a warp) and
//      loops over the key tiles they see, in order.
// Each output element is summed by one thread in one order.
//
// Every product runs on the tensor cores with `mma.sync` (warp_mma.cuh):
// m16n8k16 bf16 -> f32 for bf16 inputs, m16n8k8 TF32 -> f32 for f32
// inputs.  A warp of the dK/dV pass owns 16 keys: it forms S^T = K Q^T and
// dP^T = V dO^T of a query tile in registers, P^T and dS^T on those
// accumulator fragments, and feeds them straight back as the A operands of
// dV += P^T dO and dK += dS^T Q (two neighbouring n8 C fragments are one
// m16n8k16 A fragment; for TF32 the k order of a step is permuted to match
// the C layout, and B's rows follow it).  A warp of the dQ pass owns 16
// query rows and does the same with S = Q K^T, dP = dO V^T and dQ += dS K.
//
// Operand precision, settled on the CPU first with a model of these
// roundings (tests/test_torch_flash_attention_bwd.py,
// `test_bf16_route_rounding_keeps_the_card_tolerance`), against the card
// check's 4e-3 of the largest |gradient| (one rounding of each gradient
// to bf16 takes up to 2^-8 of it):
//   - bf16: q, k and v are exact in bf16.  dO arrives in f32 and is split
//     into hi = bf16(x) and lo = bf16(x - hi), as are P and dS (the
//     forward's split of P).  One rounding of dO or of dS alone moves the
//     gradients by more than half of 4e-3 at S = 2048, D = 128; one of P
//     alone by three quarters of that half, on the first keys, where dV
//     and its own final rounding are largest.  The products: S 1, dP 2 (dO
//     hi, lo), dV 3 (P hi dO hi, P lo dO hi, P hi dO lo), dK 2, and in the
//     dQ pass S 1, dP 2, dQ 2: 6 D + 7 Dv columns of `mma` work a visible
//     pair, against 4 D + 3 Dv unsplit.
//   - f32 (olmo-1b's f32 training): 3xTF32, every operand split into big =
//     tf32(x) and small = tf32(x - big) and three products (small big, big
//     small, big big), as pairwise_argmin.cu: TF32 alone, 2^-11, cannot
//     hold the f32 check's 1e-4.
//
// Tiles, by the head dimension's class DC (128 or 256: one instance of
// each pass a class and route), run D and Dv in multiples of the MMA's k
// (16 bf16, 8 TF32) counted at run time, so D 80 runs 80 columns and at
// MLA's D 192 / Dv 128 the products of dO and the dV accumulators run 128
// wide.  At DC 256 two warps share each 16 keys (or rows), each holding
// half of the accumulators' columns and both computing S and dP.  bf16
// DC 128 takes 8 warps a block (128 keys, query tiles of 64; 128 rows, key
// tiles of 64); the other tiles are narrower, for shared memory (`Cfg`).
// Where a warp's column blocks fill its accumulators, the dV, dK and dQ
// loops carry no branch and load block d + 1's B fragments before block
// d's products; the two nt products of a pass share one k-loop, and below
// 8 n8 tiles the products with a lo operand sum apart, so that more mma
// chains run at once.  Shared tiles keep the inputs' type (bf16 rows
// padded by 16 bytes for `ldmatrix`, f32 rows by 4 floats so the fragment
// loads hit 32 banks); the query tiles of the dK/dV pass and the key tiles
// of the dQ pass are double-buffered and fill through 16-byte `cp.async`
// (lse and delta 4-byte) while the last tile is multiplied, one barrier a
// tile, when D, Dv and the strides are multiples of 16 bytes and the
// pointers 16-byte aligned; otherwise element by element (q, k and v come
// through their strides and may be views).  In the bf16 route dO's f32
// tile lands in a staging buffer and is split into its hi and lo tiles
// once a tile (a second barrier).  Causal: key blocks start at the first
// query tile that sees them, warps skip tiles with no visible pair, and
// only tiles that cross the diagonal, the prefix's edge or the ragged end
// are masked.
//
// Shared memory a block at D = Dv = 256: dK/dV 201,216 bytes (bf16) and
// 199,936 (f32); dQ 168,960 (bf16) and 199,680 (f32), all under the 227 KB
// (232,448 bytes) a block can have; the launcher raises each kernel's
// limit first.
//
// What bounds it on the card: operations.  The five products of the
// equations (q k, dO v, p^T dO, ds^T q and ds k) take 2 (3 D + 2 Dv)
// operations a visible pair; this kernel also recomputes q k and dO v in
// the dQ pass and pays for the splits above.  `mma.sync` issues well below
// the card's rate, which only `wgmma` reaches (later work, as for the
// forward).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ int last_key(int row, int prefix) {
  return row < prefix ? prefix - 1 : row;
}

__device__ __forceinline__ bool visible(int row, int key, int S, int causal,
                                        int prefix) {
  return row < S && key < S && (!causal || key <= last_key(row, prefix));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <bool kF32>
struct Elem {
  using T = __nv_bfloat16;
};
template <>
struct Elem<true> {
  using T = float;
};

// The tiles of one route (kF32: 3xTF32, else bf16) and head-dimension
// class DC.
template <bool kF32, int DC>
struct Cfg {
  using T = typename Elem<kF32>::T;
  // The MMA's k, which is also the columns one B load of the dV, dK and
  // dQ products covers (an x4 ldmatrix of bf16, an n8 tile of TF32).
  static constexpr int kK = kF32 ? 8 : 16;
  static constexpr int kLd = DC + (kF32 ? 4 : 8);  // shared row stride
  static constexpr int kLdb = kLd * static_cast<int>(sizeof(T));  // bytes
  // Warps that share a 16-key group of the dK/dV pass (or 16 rows of the
  // dQ pass), each holding a part of the accumulators' columns, and the
  // n8 tiles of an accumulator a warp holds.
  static constexpr int kSplit = DC > 128 ? 2 : 1;
  static constexpr int kAcc = DC / 8 / kSplit;
  // dK/dV: 16-key groups a block, query rows a tile
  static constexpr int kKeyWarps = DC > 128 || kF32 ? 4 : 8;
  static constexpr int kKeys = 16 * kKeyWarps;
  static constexpr int kKvThreads = 32 * kKeyWarps * kSplit;
  static constexpr int kBQ = kF32 ? 16 : DC > 128 ? 32 : 64;
  // dQ: 16-row groups a block, keys a tile
  static constexpr int kRowWarps = DC > 128 ? 4 : 8;
  static constexpr int kBR = 16 * kRowWarps;
  static constexpr int kQThreads = 32 * kRowWarps * kSplit;
  static constexpr int kBK = kF32 ? 16 : DC > 128 ? 32 : 64;
  // Shared bytes.  dK/dV: K, V; two stages of Q (and of dO in f32); bf16:
  // dO's hi and lo and two f32 staging tiles; two stages of lse and delta.
  static constexpr int kKvSmem =
      kF32 ? (2 * kKeys + 4 * kBQ) * kLd * 4 + 4 * kBQ * 4
           : (2 * kKeys + 4 * kBQ) * kLd * 2 + 2 * kBQ * DC * 4 +
                 4 * kBQ * 4;
  // dQ: Q and dO (bf16: hi and lo), two stages of K and of V.
  static constexpr int kQSmem =
      kF32 ? (2 * kBR + 4 * kBK) * kLd * 4 : (3 * kBR + 4 * kBK) * kLd * 2;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Rows [row0, row0 + ROWS) of a (seq, cols) view with row stride `stride`
// into a shared tile of row stride `ld`, columns [0, width) (a multiple of
// 16 bytes), zero past S and past `cols`.  `vec`: 16-byte cp.async (cols
// and the stride multiples of 16 bytes, the base 16-byte aligned); else
// element by element, synchronously.
template <typename T, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long stride, int row0, int S,
                                          int cols, int width, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int chunks = width / V;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += THREADS) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * V;
    const int row = row0 + r;
    T* d = dst + r * ld + c;
    if (vec) {
      const bool ok = row < S && c < cols;
      cp_async16(smem_addr(d),
                 ok ? src + static_cast<long long>(row) * stride + c : src,
                 ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int col = c + e;
        d[e] = row < S && col < cols
                   ? src[static_cast<long long>(row) * stride + col]
                   : from_f32<T>(0.0f);
      }
    }
  }
}

// ROWS f32 values of a (B, H, S) row from row0 by 4-byte cp.async, zero
// past S.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const bool ok = row0 + r < S;
    cp_async4(smem_addr(dst + r), ok ? src + row0 + r : src, ok ? 4 : 0);
  }
}

// Four f32 values into a bf16 hi tile and a bf16 lo tile at (r, c).
__device__ __forceinline__ void store_split(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int at,
                                            float x0, float x1, float x2,
                                            float x3) {
  uint2 h, l;
  split_bf16(x0, x1, h.x, l.x);
  split_bf16(x2, x3, h.y, l.y);
  *reinterpret_cast<uint2*>(hi + at) = h;
  *reinterpret_cast<uint2*>(lo + at) = l;
}

// An f32 staging tile (ROWS x width, row stride lds) into bf16 hi and lo
// tiles of row stride ld.
template <int ROWS, int THREADS>
__device__ __forceinline__ void split_rows(__nv_bfloat16* hi,
                                           __nv_bfloat16* lo, int ld,
                                           const float* src, int lds,
                                           int width) {
  const int chunks = width / 4;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += THREADS) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * lds + c);
    store_split(hi, lo, r * ld + c, x.x, x.y, x.z, x.w);
  }
}

// Rows of an f32 view straight from device memory into bf16 hi and lo
// tiles, zero past S and past `cols`; `vec`: float4 loads (cols and the
// stride multiples of 4, the base 16-byte aligned).
template <int ROWS, int THREADS>
__device__ __forceinline__ void split_rows_global(
    __nv_bfloat16* hi, __nv_bfloat16* lo, int ld, const float* src,
    long long stride, int row0, int S, int cols, int width, bool vec) {
  const int chunks = width / 4;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += THREADS) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 4;
    const int row = row0 + r;
    const float* s = src + static_cast<long long>(row) * stride + c;
    float x[4];
    if (vec && row < S && c < cols) {
      const float4 v = *reinterpret_cast<const float4*>(s);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = row < S && c + e < cols ? s[e] : 0.0f;
    }
    store_split(hi, lo, r * ld + c, x[0], x[1], x[2], x[3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
}

// ---------------------------------------------------------------------------
// Warp products.  nt: acc (16 x 8 NS) += A B^T, A 16 rows and B 8 NS rows
// of shared tiles, both k-contiguous, over k-steps [0, nk).  cn: acc
// (16 x columns) += A B, A the C fragments `c` (16 x 8 NS, the k index),
// B 8 NS rows of a shared tile, over the warp's column range.
// ---------------------------------------------------------------------------

// bf16, one k-step of each of the two nt products of a pass: x += A1 B1^T
// and y += A2 B2^T, where A2 (kLoA) or else B2 also has a lo tile whose
// products go to yl (the lo lo product is below the bf16 rounding).  a*,
// b*: the lane's ldmatrix addresses (bytes) of the tiles' rows.
template <int NS, int LDB>
__device__ __forceinline__ void nt_step_bf16(float (&x)[NS][4], uint32_t a1,
                                             uint32_t b1, int kk) {
  uint32_t a[4];
  ldmatrix_x4(a, a1 + kk * 32);
#pragma unroll
  for (int jj = 0; jj < NS / 2; ++jj) {
    uint32_t bb[4];
    ldmatrix_x4(bb, b1 + jj * 16 * LDB + kk * 32);
    mma_bf16(x[2 * jj], a, bb[0], bb[1]);
    mma_bf16(x[2 * jj + 1], a, bb[2], bb[3]);
  }
}

template <int NS, bool kLoA, int LDB>
__device__ __forceinline__ void nt_step_lo_bf16(float (&y)[NS][4],
                                                float (&yl)[NS][4],
                                                uint32_t a2, uint32_t a2_lo,
                                                uint32_t b2, uint32_t b2_lo,
                                                int kk) {
  uint32_t a[4], al[4];
  ldmatrix_x4(a, a2 + kk * 32);
  if constexpr (kLoA) ldmatrix_x4(al, a2_lo + kk * 32);
#pragma unroll
  for (int jj = 0; jj < NS / 2; ++jj) {
    const uint32_t off = jj * 16 * LDB + kk * 32;
    uint32_t bb[4];
    ldmatrix_x4(bb, b2 + off);
    if constexpr (kLoA) {
      mma_bf16(yl[2 * jj], al, bb[0], bb[1]);
      mma_bf16(yl[2 * jj + 1], al, bb[2], bb[3]);
    } else {
      uint32_t bl[4];
      ldmatrix_x4(bl, b2_lo + off);
      mma_bf16(yl[2 * jj], a, bl[0], bl[1]);
      mma_bf16(yl[2 * jj + 1], a, bl[2], bl[3]);
    }
    mma_bf16(y[2 * jj], a, bb[0], bb[1]);
    mma_bf16(y[2 * jj + 1], a, bb[2], bb[3]);
  }
}

// bf16, the two nt products of a pass, x over nk1 k-steps and y over nk2,
// in one loop over the steps they share (no branch in its body, so the
// two products' loads and mma chains interleave), then the rest of the
// longer one.
template <int NS, bool kLoA, int LDB>
__device__ __forceinline__ void nt2_bf16(float (&x)[NS][4], float (&y)[NS][4],
                                         uint32_t a1, uint32_t b1, int nk1,
                                         uint32_t a2, uint32_t a2_lo,
                                         uint32_t b2, uint32_t b2_lo,
                                         int nk2) {
  // Up to 4 n8 tiles, the lo products get their own accumulators (twice
  // the independent mma chains); 8 tiles have chains enough, and not the
  // registers.
  constexpr bool kSep = NS <= 4;
  float y_lo[NS][4];
  if constexpr (kSep) zero(y_lo);
  float (&yl)[NS][4] = kSep ? y_lo : y;
  const int nk = min(nk1, nk2);
#pragma unroll 1
  for (int kk = 0; kk < nk; ++kk) {
    nt_step_bf16<NS, LDB>(x, a1, b1, kk);
    nt_step_lo_bf16<NS, kLoA, LDB>(y, yl, a2, a2_lo, b2, b2_lo, kk);
  }
  for (int kk = nk; kk < nk1; ++kk) nt_step_bf16<NS, LDB>(x, a1, b1, kk);
  for (int kk = nk; kk < nk2; ++kk)
    nt_step_lo_bf16<NS, kLoA, LDB>(y, yl, a2, a2_lo, b2, b2_lo, kk);
  if constexpr (kSep) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] += y_lo[j][e];
  }
}

// bf16.  `c` split into hi and lo A fragments (keys or rows 16 kk .. 16 kk
// + 15 of the k index are C tiles 2 kk and 2 kk + 1); b, b_lo: the lane's
// transposed ldmatrix addresses of B's hi (and, NB == 2, lo) tile; column
// blocks of 16 [blk0, blk0 + nblk) into acc tiles 2 d and 2 d + 1.  Block d
// + 1's B fragments load before block d's products; kFull: nblk is every
// block the accumulators hold, so the loop has no branch.
template <int NS, int NACC, int NB, int LDB, bool kFull>
__device__ __forceinline__ void cn_bf16_cols(float (&acc)[NACC][4],
                                        const float (&c)[NS][4], uint32_t b,
                                        uint32_t b_lo, int blk0, int nblk) {
  constexpr int NBLK = NACC / 2;
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    uint32_t ah[4], al[4];
    split_bf16(c[2 * kk][0], c[2 * kk][1], ah[0], al[0]);
    split_bf16(c[2 * kk][2], c[2 * kk][3], ah[1], al[1]);
    split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], ah[2], al[2]);
    split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], ah[3], al[3]);
    const uint32_t row = kk * 16 * LDB + blk0 * 32;
    uint32_t bh[2][4], bl[2][4];
    if (kFull || nblk > 0) {
      ldmatrix_x4_trans(bh[0], b + row);
      if constexpr (NB == 2) ldmatrix_x4_trans(bl[0], b_lo + row);
    }
#pragma unroll
    for (int d = 0; d < NBLK; ++d) {
      if (kFull || d < nblk) {
        const int cur = d & 1;
        if (d + 1 < NBLK && (kFull || d + 1 < nblk)) {
          ldmatrix_x4_trans(bh[cur ^ 1], b + row + (d + 1) * 32);
          if constexpr (NB == 2)
            ldmatrix_x4_trans(bl[cur ^ 1], b_lo + row + (d + 1) * 32);
        }
        mma_bf16(acc[2 * d], al, bh[cur][0], bh[cur][1]);
        mma_bf16(acc[2 * d + 1], al, bh[cur][2], bh[cur][3]);
        if constexpr (NB == 2) {
          mma_bf16(acc[2 * d], ah, bl[cur][0], bl[cur][1]);
          mma_bf16(acc[2 * d + 1], ah, bl[cur][2], bl[cur][3]);
        }
        mma_bf16(acc[2 * d], ah, bh[cur][0], bh[cur][1]);
        mma_bf16(acc[2 * d + 1], ah, bh[cur][2], bh[cur][3]);
      }
    }
  }
}

template <int NS, int NACC, int NB, int LDB>
__device__ __forceinline__ void cn_bf16(float (&acc)[NACC][4],
                                        const float (&c)[NS][4], uint32_t b,
                                        uint32_t b_lo, int blk0, int nblk) {
  if (nblk == NACC / 2)
    cn_bf16_cols<NS, NACC, NB, LDB, true>(acc, c, b, b_lo, blk0, nblk);
  else
    cn_bf16_cols<NS, NACC, NB, LDB, false>(acc, c, b, b_lo, blk0, nblk);
}

// 3xTF32 one k-step of one nt product: the small terms (small big, big
// small) into xs, big big into x.  a: the lane's A element, tile + (row0 +
// g) LD + t; b: tile + g LD + t of B's first row.  Fragments as m16n8k8
// reads them: a = A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; b =
// B[n g][k t], B[g][t + 4].
template <int NS, int LD>
__device__ __forceinline__ void nt_step_tf32(float (&x)[NS][4],
                                             float (&xs)[NS][4],
                                             const float* a, const float* b,
                                             int kk) {
  uint32_t ab[4], as[4];
  split_tf32(a[8 * kk], ab[0], as[0]);
  split_tf32(a[8 * LD + 8 * kk], ab[1], as[1]);
  split_tf32(a[8 * kk + 4], ab[2], as[2]);
  split_tf32(a[8 * LD + 8 * kk + 4], ab[3], as[3]);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    uint32_t bb[2], bs[2];
    split_tf32(b[j * 8 * LD + 8 * kk], bb[0], bs[0]);
    split_tf32(b[j * 8 * LD + 8 * kk + 4], bb[1], bs[1]);
    mma_tf32(xs[j], as, bb[0], bb[1]);
    mma_tf32(xs[j], ab, bs[0], bs[1]);
    mma_tf32(x[j], ab, bb[0], bb[1]);
  }
}

// 3xTF32, the two nt products of a pass in one k-loop: x += A1 B1^T over
// nk1 k-steps, y += A2 B2^T over nk2, the small terms summed apart and
// added at the end.
template <int NS, int LD>
__device__ __forceinline__ void nt2_tf32(float (&x)[NS][4], float (&y)[NS][4],
                                         const float* a1, const float* b1,
                                         int nk1, const float* a2,
                                         const float* b2, int nk2) {
  float xs[NS][4], ys[NS][4];
  zero(xs);
  zero(ys);
  const int nk = min(nk1, nk2);
#pragma unroll 1
  for (int kk = 0; kk < nk; ++kk) {
    nt_step_tf32<NS, LD>(x, xs, a1, b1, kk);
    nt_step_tf32<NS, LD>(y, ys, a2, b2, kk);
  }
  for (int kk = nk; kk < nk1; ++kk) nt_step_tf32<NS, LD>(x, xs, a1, b1, kk);
  for (int kk = nk; kk < nk2; ++kk) nt_step_tf32<NS, LD>(y, ys, a2, b2, kk);
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[j][e] += xs[j][e];
      y[j][e] += ys[j][e];
    }
}

// 3xTF32.  C tile kk is k-step kk with its k order permuted: slot t is
// column 2 t and slot t + 4 column 2 t + 1 of the tile, so the lane's C
// values are its A values; B's rows follow (b0 from row 2 t, b1 from row
// 2 t + 1).  b: tile + 2 t LD + g of B's first row; n8 columns [n0, n0 +
// cnt), tile nn + 1's B values loaded before tile nn's products; kFull:
// cnt is every tile the accumulators hold.
template <int NS, int NACC, int LD, bool kFull>
__device__ __forceinline__ void cn_tf32_cols(float (&acc)[NACC][4],
                                        const float (&c)[NS][4],
                                        const float* b, int n0, int cnt) {
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(c[kk][0], ab[0], as[0]);
    split_tf32(c[kk][2], ab[1], as[1]);
    split_tf32(c[kk][1], ab[2], as[2]);
    split_tf32(c[kk][3], ab[3], as[3]);
    const float* p = b + 8 * kk * LD + n0 * 8;
    float y[2][2];
    if (kFull || cnt > 0) {
      y[0][0] = p[0];
      y[0][1] = p[LD];
    }
#pragma unroll
    for (int nn = 0; nn < NACC; ++nn) {
      if (kFull || nn < cnt) {
        const int cur = nn & 1;
        if (nn + 1 < NACC && (kFull || nn + 1 < cnt)) {
          y[cur ^ 1][0] = p[(nn + 1) * 8];
          y[cur ^ 1][1] = p[(nn + 1) * 8 + LD];
        }
        uint32_t bb[2], bs[2];
        split_tf32(y[cur][0], bb[0], bs[0]);
        split_tf32(y[cur][1], bb[1], bs[1]);
        mma_tf32(acc[nn], as, bb[0], bb[1]);
        mma_tf32(acc[nn], ab, bs[0], bs[1]);
        mma_tf32(acc[nn], ab, bb[0], bb[1]);
      }
    }
  }
}

// kFullPath: build the branch-free loop too (the f32 route's DC 128, for
// olmo-1b's training; DC 256 in f32 is tests only, and the build stays
// short).
template <int NS, int NACC, int LD, bool kFullPath>
__device__ __forceinline__ void cn_tf32(float (&acc)[NACC][4],
                                        const float (&c)[NS][4],
                                        const float* b, int n0, int cnt) {
  if (kFullPath && cnt == NACC)
    cn_tf32_cols<NS, NACC, LD, true>(acc, c, b, n0, cnt);
  else
    cn_tf32_cols<NS, NACC, LD, false>(acc, c, b, n0, cnt);
}

// This warp's share of `n` columns in blocks of `unit`: [blk0, blk0 + cnt).
__device__ __forceinline__ void col_part(int n, int unit, int parts, int part,
                                         int& blk0, int& cnt) {
  const int blocks = (n + unit - 1) / unit;
  const int per = (blocks + parts - 1) / parts;
  blk0 = part * per;
  cnt = max(0, min(per, blocks - blk0));
}

// Rows row_a and row_a + 8 of a warp's accumulator (n8 tiles from column
// c0, lane columns c0 + 8 a + 2 t + {0, 1}) times `mul` into out[row *
// rstride + col] for col < c_end (the end of the warp's columns) and rows
// < S.
template <typename T, int NACC>
__device__ __forceinline__ void store_acc(T* out, long long rstride,
                                          const float (&acc)[NACC][4],
                                          int row_a, int S, int c0, int t,
                                          int c_end, float mul) {
  const int col0 = c0 + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= S) continue;
    T* o = out + static_cast<long long>(row) * rstride;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      const int col = col0 + 8 * a;
      if (col < c_end) o[col] = from_f32<T>(acc[a][2 * h] * mul);
      if (col + 1 < c_end) o[col + 1] = from_f32<T>(acc[a][2 * h + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

constexpr int kDeltaThreads = 256;

__global__ void __launch_bounds__(kDeltaThreads)
    delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                 float* __restrict__ delta, int B, int S, int H, int Dv) {
  // rows in (b, i, h) order, the layout of out and dO
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kDeltaThreads / 32) +
                        threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * S * H) return;
  const int lane = threadIdx.x & 31;
  const float* o = out + row * Dv;
  const float* g = dout + row * Dv;
  float acc = 0.0f;
  for (int c = lane; c < Dv; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(~0u, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bi = row / H;
    const int i = static_cast<int>(bi % S);
    const long long b = bi / S;
    delta[(b * H + h) * S + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV: a block of kKeys keys of one KV head
// ---------------------------------------------------------------------------

// P^T and dS^T of a warp's 16 keys (key_a = its key of row g) against the
// tile's query rows q_a .. q_a + 8 NS - 1 (lse_s and delta_s theirs): s
// (scores) becomes p and dp becomes ds.  kMask: the tile crosses the
// diagonal, the prefix's edge or the ragged end.
template <bool kMask, int NS>
__device__ __forceinline__ void p_ds_keys(float (&s)[NS][4],
                                          float (&dp)[NS][4],
                                          const float* lse_s,
                                          const float* delta_s, int q_a,
                                          int key_a,
                                          float scale_log2, int S, int causal,
                                          int prefix, int t) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
    const float2 d = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lv = (e & 1) ? l.y : l.x;
      float p = exp2f(fmaf(s[j][e], scale_log2, -lv * kLog2e));
      if (kMask) {
        const int key = key_a + 8 * (e >> 1);
        const int row = q_a + 8 * j + 2 * t + (e & 1);
        p = visible(row, key, S, causal, prefix) ? p : 0.0f;
      }
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - ((e & 1) ? d.y : d.x));
    }
  }
}

template <bool kF32, int DC>
__global__ void __launch_bounds__(Cfg<kF32, DC>::kKvThreads, 1)
    dkv_kernel(const typename Elem<kF32>::T* __restrict__ q,
               const typename Elem<kF32>::T* __restrict__ k,
               const typename Elem<kF32>::T* __restrict__ v,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta,
               typename Elem<kF32>::T* __restrict__ dk,
               typename Elem<kF32>::T* __restrict__ dv, int B, int S, int H,
               int Hk, int D, int Dv, Strides qs_, Strides ks_, Strides vs_,
               float scale, float scale_log2, int causal, int prefix,
               int vec_in, int vec_do_in) {
  using C = Cfg<kF32, DC>;
  using T = typename C::T;
  constexpr int THREADS = C::kKvThreads;
  constexpr int LD = C::kLd;
  constexpr int BQ = C::kBQ;
  constexpr int NS = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // kKeys x LD
  T* vs = ks + C::kKeys * LD;              // kKeys x LD
  T* qs = vs + C::kKeys * LD;              // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;  // f32: [2][BQ][LD]; bf16: hi, lo [BQ][LD]
  float* stage = reinterpret_cast<float*>(dos + 2 * BQ * LD);
  // bf16: [2][BQ][DC] f32 dO before its split
  float* lse_s = kF32 ? stage : stage + 2 * BQ * DC;  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                     // [2][BQ]

  const bool vec = vec_in != 0;
  const bool vec_do = vec_do_in != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g4 = lane >> 2;
  const int t4 = lane & 3;
  const int kg = warp % C::kKeyWarps;  // this warp's 16 keys
  const int part = warp / C::kKeyWarps;  // its share of the columns
  // Key blocks in order, so that the first ones, which most query rows
  // see under the causal mask, start first.
  const int bhk = static_cast<int>(blockIdx.x % (Hk * B));
  const int kb = static_cast<int>(blockIdx.x / (Hk * B));
  const int hk = bhk % Hk;
  const int b = bhk / Hk;
  const int grp = H / Hk;
  const int k0 = kb * C::kKeys;
  const int kw = k0 + 16 * kg;  // this warp's first key
  const int width_k = round_up(D, C::kK);
  const int width_v = round_up(Dv, C::kK);

  load_rows<T, C::kKeys, THREADS>(ks, LD, k + b * ks_.b + hk * ks_.h, ks_.s,
                                  k0, S, D, width_k, vec);
  load_rows<T, C::kKeys, THREADS>(vs, LD, v + b * vs_.b + hk * vs_.h, vs_.s,
                                  k0, S, Dv, width_v, vec);

  // The first query row that sees key k0, the smallest of the block:
  // every row sees a key below the prefix, else rows from the key on.
  const int q_first = causal && k0 >= prefix ? k0 : 0;
  const int t_first = q_first / BQ * BQ;
  const int ntq = (S - t_first + BQ - 1) / BQ;  // query tiles a head
  const int n_tiles = grp * ntq;
  const long long o_row = static_cast<long long>(H) * Dv;  // dO row stride

  auto issue = [&](int u) {
    const int st = u & 1;
    const int hq = hk * grp + u / ntq;
    const int q0 = t_first + (u % ntq) * BQ;
    load_rows<T, BQ, THREADS>(qs + st * BQ * LD, LD,
                              q + b * qs_.b + hq * qs_.h, qs_.s, q0, S, D,
                              width_k, vec);
    const float* doh = dout + static_cast<long long>(b) * S * o_row +
                       static_cast<long long>(hq) * Dv;
    if constexpr (kF32)
      load_rows<float, BQ, THREADS>(dos + st * BQ * LD, LD, doh, o_row, q0,
                                    S, Dv, width_v, vec_do);
    else
      load_rows<float, BQ, THREADS>(stage + st * BQ * DC, DC, doh, o_row, q0,
                                    S, Dv, round_up(Dv, 16), vec_do);
    const long long lrow = (static_cast<long long>(b) * H + hq) * S;
    load_vec<BQ, THREADS>(lse_s + st * BQ, lse + lrow, q0, S);
    load_vec<BQ, THREADS>(delta_s + st * BQ, delta + lrow, q0, S);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  int blk_k, nblk_k, blk_v, nblk_v;  // the warp's accumulator columns
  col_part(D, C::kK, C::kSplit, part, blk_k, nblk_k);
  col_part(Dv, C::kK, C::kSplit, part, blk_v, nblk_v);
  float dk_acc[C::kAcc][4], dv_acc[C::kAcc][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int u = 0; u < n_tiles; ++u) {
    cp_async_wait<0>();
    __syncthreads();  // tile u is in; every warp is done with tile u - 1
    if (u + 1 < n_tiles) issue(u + 1);
    cp_async_commit();
    const int st = u & 1;
    const T* qt = qs + st * BQ * LD;
    const float* lt = lse_s + st * BQ;
    const float* dt = delta_s + st * BQ;
    if constexpr (!kF32) {
      split_rows<BQ, THREADS>(dos, dos + BQ * LD, LD, stage + st * BQ * DC,
                              DC, round_up(Dv, 16));
      __syncthreads();
    }
    const int qa = t_first + (u % ntq) * BQ;  // the tile's first row
    // Warps whose keys lie past S, or that no row of the tile sees, skip it.
    if (kw >= S || (causal && kw > last_key(min(qa + BQ, S) - 1, prefix)))
      continue;
    const bool mask = qa + BQ > S || kw + 16 > S ||
                      (causal && kw + 15 > last_key(qa, prefix));
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    if constexpr (kF32) {
      const float* dot = dos + st * BQ * LD;
      nt2_tf32<NS, LD>(s, dp, ks + (16 * kg + g4) * LD + t4,
                       qt + g4 * LD + t4, width_k / 8,
                       vs + (16 * kg + g4) * LD + t4, dot + g4 * LD + t4,
                       width_v / 8);
      if (mask)
        p_ds_keys<true>(s, dp, lt, dt, qa, kw + g4, scale_log2, S, causal,
                        prefix, t4);
      else
        p_ds_keys<false>(s, dp, lt, dt, qa, kw + g4, scale_log2, S, causal,
                         prefix, t4);
      cn_tf32<NS, C::kAcc, LD, DC <= 128>(dv_acc, s, dot + 2 * t4 * LD + g4,
                                          blk_v, nblk_v);
      cn_tf32<NS, C::kAcc, LD, DC <= 128>(dk_acc, dp, qt + 2 * t4 * LD + g4,
                                          blk_k, nblk_k);
    } else {
      constexpr int LDB = C::kLdb;
      const T* hi = dos;
      const T* lo = dos + BQ * LD;
      // ldmatrix lanes: A rows lane % 16, columns 8 (lane / 16); B rows
      // lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) % 2); B
      // transposed: rows lane % 16, columns 8 (lane / 16).
      const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
      const int b_off =
          ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
      nt2_bf16<NS, false, LDB>(s, dp, smem_addr(ks + 16 * kg * LD + a_off),
                               smem_addr(qt + b_off), width_k / 16,
                               smem_addr(vs + 16 * kg * LD + a_off), 0,
                               smem_addr(hi + b_off), smem_addr(lo + b_off),
                               width_v / 16);
      if (mask)
        p_ds_keys<true>(s, dp, lt, dt, qa, kw + g4, scale_log2, S, causal,
                        prefix, t4);
      else
        p_ds_keys<false>(s, dp, lt, dt, qa, kw + g4, scale_log2, S, causal,
                         prefix, t4);
      cn_bf16<NS, C::kAcc, 2, LDB>(dv_acc, s, smem_addr(hi + a_off),
                                   smem_addr(lo + a_off), blk_v, nblk_v);
      cn_bf16<NS, C::kAcc, 1, LDB>(dk_acc, dp, smem_addr(qt + a_off), 0,
                                   blk_k, nblk_k);
    }
  }

  const long long base = (static_cast<long long>(b) * S) * Hk + hk;
  store_acc<T, C::kAcc>(dk + base * D, static_cast<long long>(Hk) * D, dk_acc,
                        kw + g4, S, blk_k * C::kK, t4,
                        min(D, (blk_k + nblk_k) * C::kK), scale);
  store_acc<T, C::kAcc>(dv + base * Dv, static_cast<long long>(Hk) * Dv,
                        dv_acc, kw + g4, S, blk_v * C::kK, t4,
                        min(Dv, (blk_v + nblk_v) * C::kK), 1.0f);
}

// ---------------------------------------------------------------------------
// 3. dQ: a block of kBR query rows of one head
// ---------------------------------------------------------------------------

// P and dS of a warp's 16 rows (row_a = its row g, nl2 -lse log2(e) and
// dl delta of rows g and g + 8) against keys k0 .. k0 + 8 NS - 1.
template <bool kMask, int NS>
__device__ __forceinline__ void p_ds_rows(float (&s)[NS][4],
                                          float (&dp)[NS][4],
                                          const float (&nl2)[2],
                                          const float (&dl)[2], int row_a,
                                          int k0, float scale_log2, int S,
                                          int causal, int prefix, int t) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(fmaf(s[j][e], scale_log2, nl2[e >> 1]));
      if (kMask) {
        const int row = row_a + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        p = visible(row, key, S, causal, prefix) ? p : 0.0f;
      }
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
    }
  }
}

template <bool kF32, int DC>
__global__ void __launch_bounds__(Cfg<kF32, DC>::kQThreads, 1)
    dq_kernel(const typename Elem<kF32>::T* __restrict__ q,
              const typename Elem<kF32>::T* __restrict__ k,
              const typename Elem<kF32>::T* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta,
              typename Elem<kF32>::T* __restrict__ dq, int B, int S, int H,
              int Hk, int D, int Dv, Strides qs_, Strides ks_, Strides vs_,
              float scale, float scale_log2, int causal, int prefix,
              int vec_in, int vec_do_in) {
  using C = Cfg<kF32, DC>;
  using T = typename C::T;
  constexpr int THREADS = C::kQThreads;
  constexpr int LD = C::kLd;
  constexpr int BR = C::kBR;
  constexpr int BK = C::kBK;
  constexpr int NS = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);       // BR x LD
  T* dos = qs + BR * LD;                        // f32: BR x LD; bf16: hi, lo
  T* ks = dos + (kF32 ? 1 : 2) * BR * LD;       // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                     // [2][BK][LD]

  const bool vec = vec_in != 0;
  const bool vec_do = vec_do_in != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g4 = lane >> 2;
  const int t4 = lane & 3;
  const int rg = warp % C::kRowWarps;  // this warp's 16 rows
  const int part = warp / C::kRowWarps;  // its share of the columns
  // Longest query blocks first: the last block under causal masking.
  const int bh = static_cast<int>(blockIdx.x % (H * B));
  const int nqb = (S + BR - 1) / BR;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / (H * B));
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qb * BR;
  const int hk = h / (H / Hk);
  const int wrow = q0 + 16 * rg;  // this warp's first row
  const int width_k = round_up(D, C::kK);
  const int width_v = round_up(Dv, C::kK);
  const T* kg = k + b * ks_.b + hk * ks_.h;
  const T* vg = v + b * vs_.b + hk * vs_.h;
  const long long o_row = static_cast<long long>(H) * Dv;
  const float* doh = dout + static_cast<long long>(b) * S * o_row +
                     static_cast<long long>(h) * Dv;

  load_rows<T, BR, THREADS>(qs, LD, q + b * qs_.b + h * qs_.h, qs_.s, q0, S,
                            D, width_k, vec);
  if constexpr (kF32)
    load_rows<float, BR, THREADS>(dos, LD, doh, o_row, q0, S, Dv, width_v,
                                  vec_do);
  else
    split_rows_global<BR, THREADS>(dos, dos + BR * LD, LD, doh, o_row, q0, S,
                                   Dv, width_v, vec_do);
  float nl2[2], dl[2];  // -lse log2(e) and delta of rows g and g + 8
  const long long lrow = (static_cast<long long>(b) * H + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g4 + 8 * r;
    nl2[r] = row < S ? -lse[lrow + row] * kLog2e : 0.0f;
    dl[r] = row < S ? delta[lrow + row] : 0.0f;
  }

  const int k_end = causal ? min(S, last_key(q0 + BR - 1, prefix) + 1) : S;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto issue = [&](int t) {
    const int st = t & 1;
    load_rows<T, BK, THREADS>(ks + st * BK * LD, LD, kg, ks_.s, t * BK, S, D,
                              width_k, vec);
    load_rows<T, BK, THREADS>(vs + st * BK * LD, LD, vg, vs_.s, t * BK, S,
                              Dv, width_v, vec);
  };
  issue(0);
  cp_async_commit();

  int blk, nblk;  // the warp's dQ columns
  col_part(D, C::kK, C::kSplit, part, blk, nblk);
  float acc[C::kAcc][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < n_tiles) issue(t + 1);
    cp_async_commit();
    const int k0 = t * BK;
    if (wrow >= S) continue;
    // A warp whose rows' last keys all come before this tile is done.
    if (causal && k0 > last_key(min(wrow + 15, S - 1), prefix)) continue;
    const bool mask = wrow + 16 > S || k0 + BK > S ||
                      (causal && k0 + BK - 1 > last_key(wrow, prefix));
    const int st = t & 1;
    const T* kt = ks + st * BK * LD;
    const T* vt = vs + st * BK * LD;
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    if constexpr (kF32) {
      nt2_tf32<NS, LD>(s, dp, qs + (16 * rg + g4) * LD + t4,
                       kt + g4 * LD + t4, width_k / 8,
                       dos + (16 * rg + g4) * LD + t4, vt + g4 * LD + t4,
                       width_v / 8);
      if (mask)
        p_ds_rows<true>(s, dp, nl2, dl, wrow + g4, k0, scale_log2, S, causal,
                        prefix, t4);
      else
        p_ds_rows<false>(s, dp, nl2, dl, wrow + g4, k0, scale_log2, S,
                         causal, prefix, t4);
      cn_tf32<NS, C::kAcc, LD, DC <= 128>(acc, dp, kt + 2 * t4 * LD + g4, blk,
                                          nblk);
    } else {
      constexpr int LDB = C::kLdb;
      const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
      const int b_off =
          ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
      const T* hi = dos + 16 * rg * LD;
      nt2_bf16<NS, true, LDB>(s, dp, smem_addr(qs + 16 * rg * LD + a_off),
                              smem_addr(kt + b_off), width_k / 16,
                              smem_addr(hi + a_off),
                              smem_addr(hi + BR * LD + a_off),
                              smem_addr(vt + b_off), 0, width_v / 16);
      if (mask)
        p_ds_rows<true>(s, dp, nl2, dl, wrow + g4, k0, scale_log2, S, causal,
                        prefix, t4);
      else
        p_ds_rows<false>(s, dp, nl2, dl, wrow + g4, k0, scale_log2, S,
                         causal, prefix, t4);
      cn_bf16<NS, C::kAcc, 1, LDB>(acc, dp, smem_addr(kt + a_off), 0, blk,
                                   nblk);
    }
  }

  store_acc<T, C::kAcc>(dq + (static_cast<long long>(b) * S * H + h) * D,
                        static_cast<long long>(H) * D, acc, wrow + g4, S,
                        blk * C::kK, t4, min(D, (blk + nblk) * C::kK),
                        scale);
}

template <bool kF32, int DC>
int launch_passes(const typename Elem<kF32>::T* q,
                  const typename Elem<kF32>::T* k,
                  const typename Elem<kF32>::T* v, const float* dout,
                  const float* lse, const float* delta,
                  typename Elem<kF32>::T* dq, typename Elem<kF32>::T* dk,
                  typename Elem<kF32>::T* dv, int B, int S, int H, int Hk,
                  int D, int Dv, Strides qs_, Strides ks_, Strides vs_,
                  float scale, int causal, int prefix, int vec, int vec_do,
                  cudaStream_t stream) {
  using C = Cfg<kF32, DC>;
  static_assert(C::kKvSmem <= 232448 && C::kQSmem <= 232448,
                "a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<kF32, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<kF32, DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kQSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  const long long nkb = (S + C::kKeys - 1) / C::kKeys;
  dkv_kernel<kF32, DC>
      <<<static_cast<unsigned>(nkb * Hk * B), C::kKvThreads, C::kKvSmem,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hk, D, Dv,
                   qs_, ks_, vs_, scale, scale_log2, causal, prefix, vec,
                   vec_do);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nqb = (S + C::kBR - 1) / C::kBR;
  dq_kernel<kF32, DC>
      <<<static_cast<unsigned>(nqb * H * B), C::kQThreads, C::kQSmem,
         stream>>>(q, k, v, dout, lse, delta, dq, B, S, H, Hk, D, Dv, qs_,
                   ks_, vs_, scale, scale_log2, causal, prefix, vec, vec_do);
  return static_cast<int>(cudaGetLastError());
}

template <bool kF32>
int dispatch(const void* q, const void* k, const void* v, const float* out,
             const float* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int S, int H, int Hk, int D, int Dv,
             const long long* strides, float scale, int causal, int prefix,
             void* stream) {
  using T = typename Elem<kF32>::T;
  if (B <= 0 || S <= 0) return 0;
  const Strides qs_{strides[0], strides[1], strides[2]};
  const Strides ks_{strides[3], strides[4], strides[5]};
  const Strides vs_{strides[6], strides[7], strides[8]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads: D, Dv and every stride whole 16-byte chunks, the bases
  // 16-byte aligned (the forward's rule); dO is contiguous (B, S, H, Dv).
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  bool vec = D % V == 0 && Dv % V == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % V == 0;
  vec = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const bool vec_do =
      Dv % 4 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0;

  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned blocks = static_cast<unsigned>(
      (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32));
  delta_kernel<<<blocks, kDeltaThreads, 0, st>>>(out, dout, delta, B, S, H,
                                                 Dv);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  auto* dqt = static_cast<T*>(dq);
  auto* dkt = static_cast<T*>(dk);
  auto* dvt = static_cast<T*>(dv);
  if (D <= 128)
    return launch_passes<kF32, 128>(qt, kt, vt, dout, lse, delta, dqt, dkt,
                                    dvt, B, S, H, Hk, D, Dv, qs_, ks_, vs_,
                                    scale, causal, prefix, vec, vec_do, st);
  return launch_passes<kF32, 256>(qt, kt, vt, dout, lse, delta, dqt, dkt, dvt,
                                  B, S, H, Hk, D, Dv, qs_, ks_, vs_, scale,
                                  causal, prefix, vec, vec_do, st);
}

}  // namespace

// q (B, S, H, D), k (B, S, Hk, D) and v (B, S, Hk, Dv) read through
// `strides` (nine element strides: (batch, seq, head) of q, of k, of v;
// the head dimension contiguous); out and dout contiguous (B, S, H, Dv)
// f32; lse contiguous (B, H, S) f32 from the forward; delta a (B, H, S)
// f32 scratch.  dq (B, S, H, D), dk (B, S, Hk, D) and dv (B, S, Hk, Dv)
// are contiguous, of the inputs' type, and every element is written.
// 1 <= Dv <= D <= 256, H % Hk == 0, 0 <= prefix <= S (the Python binding
// checks them).  Returns the first non-zero cudaError_t of the three
// launches, or 0.
extern "C" int flash_attention_bwd_f32_launch(
    const void* q, const void* k, const void* v, const float* out,
    const float* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int Hk, int D, int Dv,
    const long long* strides, float scale, int causal, int prefix,
    void* stream) {
  return dispatch<true>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H,
                        Hk, D, Dv, strides, scale, causal, prefix, stream);
}

extern "C" int flash_attention_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const float* out,
    const float* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int Hk, int D, int Dv,
    const long long* strides, float scale, int causal, int prefix,
    void* stream) {
  return dispatch<false>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H,
                         Hk, D, Dv, strides, scale, causal, prefix, stream);
}
