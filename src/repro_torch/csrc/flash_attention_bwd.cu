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
// dK and dV of a KV head sum over its H / Hk query heads.
//
// Three launches, no atomics anywhere, so that two launches on the same
// inputs give the same bits:
//   1. delta: one warp a (b, i, h) row, dO . O.
//   2. dK and dV: one block owns 64 keys of one KV head and loops over the
//      query tiles of every query head of its group that can see those
//      keys, in a fixed order, accumulating in registers.
//   3. dQ: one block owns 64 (32 for D > 128) query rows of one head and
//      loops over the key tiles they see, in order.
// Each output element is summed by one thread in one order.
//
// A simple SIMT kernel in f32 arithmetic (bf16 inputs are widened as they
// load; the gradients are stored in the inputs' dtype).  Its tiles are the
// forward's f32 kernel's: 256 threads as 16 x 16, each a 4 x 4 (or 4 x 2)
// block of scores and a 4 x (D / 16) slice of an accumulator, every tile
// in shared memory in f32 with odd row strides.  What bounds it on the
// card: operations.  The five products (q k, dO v, p^T dO, ds^T q and
// ds k) take 2 (3 D + 2 Dv) operations a visible (i, j) pair; the dQ pass
// recomputes q k and dO v (seven products in all).  At olmo-1b's training
// shape, (8, 256, 16, 128) f32 causal, the five take 5.39e9 operations:
// 0.080 ms at the 67 TFLOP/s of f32.  This kernel issues one shared-memory
// load for every one to four fused multiply-adds, far below that rate; a
// tensor-core design (the forward's `mma.sync` tiles, 3xTF32 for f32) is
// later work.
//
// Shared memory: the dK/dV block holds K and V (64 rows), Q and dO of a
// query tile (BQ rows), and p and ds of the tile (64 x (BQ + 1)):
// 165.6 KB at D = Dv = 128 with BQ = 64, 214.3 KB at D = Dv = 256 with
// BQ = 32.  The dQ block holds Q and dO (BR rows), K and V of a key tile
// (64 rows) and ds (BR x 65).  The launcher raises each block's limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kKeys = 64;      // keys a dK/dV block owns, keys a dQ tile

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Rows [row0, row0 + R) of a (seq, cols) view with row stride `stride`
// into dst[r * ld + c] in f32 for c < W; rows at or past S and columns at
// or past `cols` are 0.
template <typename T, int R>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int row0, int S,
                                          int W, int cols) {
  for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
    const int r = idx / W;
    const int c = idx - r * W;
    const int row = row0 + r;
    dst[r * ld + c] =
        row < S && c < cols
            ? to_f32(src[static_cast<long long>(row) * stride + c])
            : 0.0f;
  }
}

// f32 vectors of R rows of a (B, H, S) array: rows past S are 0.
template <int R>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int S) {
  for (int r = threadIdx.x; r < R; r += kThreads)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.0f;
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                 float* __restrict__ delta, int B, int S, int H, int Dv) {
  // rows in (b, i, h) order, the layout of out and dO
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
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
// 2. dK and dV: a block of 64 keys of one KV head
// ---------------------------------------------------------------------------

// BQ query rows a tile (64, or 32 for D > 128); NK: accumulator columns
// a thread for dK and for dV (Dv <= D <= 16 NK).
template <typename T, int BQ, int NK>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int S, int H, int Hk,
               int D, int Dv, Strides qs_, Strides ks_, Strides vs_,
               float scale, int causal, int prefix) {
  constexpr int RQ = BQ / 16;  // query rows a thread: tx + 16 j
  constexpr int LP = BQ + 1;
  extern __shared__ float smem[];
  const int ldk = D + 1;
  const int ldv = Dv + 1;
  float* ks = smem;                  // kKeys x ldk
  float* vs = ks + kKeys * ldk;      // kKeys x ldv
  float* qs = vs + kKeys * ldv;      // BQ x ldk
  float* dos = qs + BQ * ldk;        // BQ x ldv
  float* ps = dos + BQ * ldv;        // kKeys x LP: p, key-major
  float* dss = ps + kKeys * LP;      // kKeys x LP: ds, key-major
  float* lse_s = dss + kKeys * LP;   // BQ
  float* delta_s = lse_s + BQ;       // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;  // keys ty * 4 + i
  const int k0 = blockIdx.x * kKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hk;

  load_rows<T, kKeys>(ks, ldk, k + b * ks_.b + hk * ks_.h, ks_.s, k0, S, D,
                      D);
  load_rows<T, kKeys>(vs, ldv, v + b * vs_.b + hk * vs_.h, vs_.s, k0, S, Dv,
                      Dv);

  float dk_acc[4][NK], dv_acc[4][NK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NK; ++c) dk_acc[i][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < NK; ++c) dv_acc[i][c] = 0.0f;
  }

  // The first query row that sees key k0 (the smallest of the block):
  // every row sees a key below the prefix, else rows from the key on.
  const int q_first = causal && k0 >= prefix ? k0 : 0;
  const int t_first = q_first / BQ * BQ;
  const long long o_row = static_cast<long long>(H) * Dv;  // dO row stride

  for (int hq = hk * g; hq < (hk + 1) * g; ++hq) {
    const T* qh = q + b * qs_.b + hq * qs_.h;
    const float* doh = dout + static_cast<long long>(b) * S * H * Dv +
                       static_cast<long long>(hq) * Dv;
    const float* lse_h = lse + (static_cast<long long>(b) * H + hq) * S;
    const float* delta_h = delta + (static_cast<long long>(b) * H + hq) * S;
    for (int q0 = t_first; q0 < S; q0 += BQ) {
      __syncthreads();  // the last tile's q, dO, p and ds are read
      load_rows<T, BQ>(qs, ldk, qh, qs_.s, q0, S, D, D);
      load_rows<float, BQ>(dos, ldv, doh, o_row, q0, S, Dv, Dv);
      load_vec<BQ>(lse_s, lse_h, q0, S);
      load_vec<BQ>(delta_s, delta_h, q0, S);
      __syncthreads();

      // s = k q^T and dp = v dO^T for keys ty * 4 + i, rows tx + 16 j.
      float s[4][RQ], dp[4][RQ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float a[4], bq[RQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ks[(ty * 4 + i) * ldk + d];
#pragma unroll
        for (int j = 0; j < RQ; ++j) bq[j] = qs[(tx + 16 * j) * ldk + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RQ; ++j) s[i][j] = fmaf(a[i], bq[j], s[i][j]);
      }
      for (int d = 0; d < Dv; ++d) {
        float a[4], bo[RQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = vs[(ty * 4 + i) * ldv + d];
#pragma unroll
        for (int j = 0; j < RQ; ++j) bo[j] = dos[(tx + 16 * j) * ldv + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RQ; ++j) dp[i][j] = fmaf(a[i], bo[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          const int r = tx + 16 * j;
          const float p = visible(q0 + r, key, S, causal, prefix)
                              ? expf(s[i][j] * scale - lse_s[r])
                              : 0.0f;
          ps[(ty * 4 + i) * LP + r] = p;
          dss[(ty * 4 + i) * LP + r] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();

      // dV += p dO and dK += ds q over the tile's rows, columns tx + 16 c.
      for (int r = 0; r < BQ; ++r) {
        float pr[4], dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = ps[(ty * 4 + i) * LP + r];
          dr[i] = dss[(ty * 4 + i) * LP + r];
        }
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          const int col = tx + 16 * c;
          if (col < Dv) {
            const float o = dos[r * ldv + col];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dv_acc[i][c] = fmaf(pr[i], o, dv_acc[i][c]);
          }
        }
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          const int col = tx + 16 * c;
          if (col < D) {
            const float x = qs[r * ldk + col];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dk_acc[i][c] = fmaf(dr[i], x, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
    const long long base = (static_cast<long long>(b) * S + key) * Hk + hk;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dk[base * D + col] = from_f32<T>(dk_acc[i][c] * scale);
    }
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv) dv[base * Dv + col] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: a block of BR query rows of one head
// ---------------------------------------------------------------------------

template <typename T, int BR, int NK>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int Hk, int D, int Dv,
              Strides qs_, Strides ks_, Strides vs_, float scale, int causal,
              int prefix) {
  constexpr int RR = BR / 16;  // rows a thread: ty * RR + i
  constexpr int LS = kKeys + 1;
  extern __shared__ float smem[];
  const int ldk = D + 1;
  const int ldv = Dv + 1;
  float* qs = smem;                 // BR x ldk
  float* dos = qs + BR * ldk;       // BR x ldv
  float* ks = dos + BR * ldv;       // kKeys x ldk
  float* vs = ks + kKeys * ldk;     // kKeys x ldv
  float* dss = vs + kKeys * ldv;    // BR x LS: ds, row-major
  float* lse_s = dss + BR * LS;     // BR
  float* delta_s = lse_s + BR;      // BR

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // keys tx + 16 j
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const T* kh = k + b * ks_.b + hk * ks_.h;
  const T* vh = v + b * vs_.b + hk * vs_.h;

  load_rows<T, BR>(qs, ldk, q + b * qs_.b + h * qs_.h, qs_.s, q0, S, D, D);
  load_rows<float, BR>(dos, ldv,
                       dout + static_cast<long long>(b) * S * H * Dv +
                           static_cast<long long>(h) * Dv,
                       static_cast<long long>(H) * Dv, q0, S, Dv, Dv);
  load_vec<BR>(lse_s, lse + (static_cast<long long>(b) * H + h) * S, q0, S);
  load_vec<BR>(delta_s, delta + (static_cast<long long>(b) * H + h) * S, q0,
               S);

  float acc[RR][NK];
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int c = 0; c < NK; ++c) acc[i][c] = 0.0f;

  const int k_end = causal ? min(S, last_key(q0 + BR - 1, prefix) + 1) : S;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // q and dO are staged; the last tile's K and ds read
    load_rows<T, kKeys>(ks, ldk, kh, ks_.s, k0, S, D, D);
    load_rows<T, kKeys>(vs, ldv, vh, vs_.s, k0, S, Dv, Dv);
    __syncthreads();

    float s[RR][4], dp[RR][4];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[RR], bk[4];
#pragma unroll
      for (int i = 0; i < RR; ++i) a[i] = qs[(ty * RR + i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
    for (int d = 0; d < Dv; ++d) {
      float a[RR], bv[4];
#pragma unroll
      for (int i = 0; i < RR; ++i) a[i] = dos[(ty * RR + i) * ldv + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = vs[(tx + 16 * j) * ldv + d];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], bv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const int r = ty * RR + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const float p = visible(q0 + r, k0 + key, S, causal, prefix)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.0f;
        dss[r * LS + key] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    // dQ += ds k over the tile's keys, columns tx + 16 c.
    for (int j = 0; j < kKeys; ++j) {
      float dr[RR];
#pragma unroll
      for (int i = 0; i < RR; ++i) dr[i] = dss[(ty * RR + i) * LS + j];
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float x = ks[j * ldk + col];
#pragma unroll
          for (int i = 0; i < RR; ++i) acc[i][c] = fmaf(dr[i], x, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const int row = q0 + ty * RR + i;
    if (row >= S) continue;
    T* drow = dq + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int col = tx + 16 * c;
      if (col < D) drow[col] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int BQ, int NK>
int launch_dkv(const T* q, const T* k, const T* v, const float* dout,
               const float* lse, const float* delta, T* dk, T* dv, int B,
               int S, int H, int Hk, int D, int Dv, Strides qs_, Strides ks_,
               Strides vs_, float scale, int causal, int prefix,
               cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   ((kKeys + BQ) * (D + 1 + Dv + 1) + 2 * kKeys * (BQ + 1) +
                    2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, BQ, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kKeys - 1) / kKeys, Hk, B);
  dkv_kernel<T, BQ, NK><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, Hk, D, Dv, qs_, ks_, vs_,
      scale, causal, prefix);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BR, int NK>
int launch_dq(const T* q, const T* k, const T* v, const float* dout,
              const float* lse, const float* delta, T* dq, int B, int S,
              int H, int Hk, int D, int Dv, Strides qs_, Strides ks_,
              Strides vs_, float scale, int causal, int prefix,
              cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   ((BR + kKeys) * (D + 1 + Dv + 1) + BR * (kKeys + 1) +
                    2 * BR);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, BR, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BR - 1) / BR, H, B);
  dq_kernel<T, BR, NK><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, Hk, D, Dv, qs_, ks_, vs_, scale,
      causal, prefix);
  return static_cast<int>(cudaGetLastError());
}

// The head dimension picks the tiles: D <= 64, 128 or 256 sets the
// accumulators' columns a thread (NK = 4, 8, 16; dV's too, since Dv <= D,
// its columns past Dv unused) and the query tile (64 rows up to D = 128,
// 32 above, for shared memory): one instance of each kernel a D class
// and dtype, which keeps the build short.
template <typename T, int NK>
int launch_all(const T* q, const T* k, const T* v, const float* out,
               const float* dout, const float* lse, float* delta, T* dq,
               T* dk, T* dv, int B, int S, int H, int Hk, int D, int Dv,
               Strides qs_, Strides ks_, Strides vs_, float scale,
               int causal, int prefix, cudaStream_t stream) {
  constexpr int BQ = NK > 8 ? 32 : 64;
  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<<<blocks, kThreads, 0, stream>>>(out, dout, delta, B, S, H,
                                                 Dv);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch_dkv<T, BQ, NK>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                              Hk, D, Dv, qs_, ks_, vs_, scale, causal, prefix,
                              stream);
  if (err) return err;
  return launch_dq<T, BQ, NK>(q, k, v, dout, lse, delta, dq, B, S, H, Hk, D,
                              Dv, qs_, ks_, vs_, scale, causal, prefix,
                              stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* out,
             const float* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int S, int H, int Hk, int D, int Dv,
             const long long* strides, float scale, int causal, int prefix,
             void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const Strides qs_{strides[0], strides[1], strides[2]};
  const Strides ks_{strides[3], strides[4], strides[5]};
  const Strides vs_{strides[6], strides[7], strides[8]};
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  auto* dqt = static_cast<T*>(dq);
  auto* dkt = static_cast<T*>(dk);
  auto* dvt = static_cast<T*>(dv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_all<T, 4>(qt, kt, vt, out, dout, lse, delta, dqt, dkt, dvt,
                            B, S, H, Hk, D, Dv, qs_, ks_, vs_, scale, causal,
                            prefix, st);
  if (D <= 128)
    return launch_all<T, 8>(qt, kt, vt, out, dout, lse, delta, dqt, dkt, dvt,
                            B, S, H, Hk, D, Dv, qs_, ks_, vs_, scale, causal,
                            prefix, st);
  return launch_all<T, 16>(qt, kt, vt, out, dout, lse, delta, dqt, dkt, dvt,
                           B, S, H, Hk, D, Dv, qs_, ks_, vs_, scale, causal,
                           prefix, st);
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
  return dispatch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H,
                         Hk, D, Dv, strides, scale, causal, prefix, stream);
}

extern "C" int flash_attention_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const float* out,
    const float* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int Hk, int D, int Dv,
    const long long* strides, float scale, int causal, int prefix,
    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 B, S, H, Hk, D, Dv, strides, scale, causal,
                                 prefix, stream);
}
