// Exact softmax attention, online over key tiles (flash attention, forward),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) and, in the model, the pure-JAX
// `_flash_attention` scan of src/repro/models/attention.py.  For every
// query row i of every (batch, head):
//
//   s[i, j] = (scale * q[i]) . k[j]          (q widened to f32, then scaled)
//   s[i, j] = -1e30 where causal and j > i   (not -inf, as the reference)
//   out[i]  = sum_j exp(s[i, j] - m) v[j] / max(sum_j exp(s[i, j] - m), 1e-30)
//
// with the running max m and sum l carried over key tiles exactly as the
// reference does (alpha = exp(m_prev - m_new)).  Inputs are f32 or bf16
// (widened with `__bfloat162float`), the output is f32.  GQA: query head h
// reads key/value head h / (H / Hk).  q, k and v are read through their
// (batch, seq, head) strides with the head dimension contiguous, so both
// the model's (B, S, H, D) layout and the TPU kernel's (BH, S, D) layout
// come in without a copy; the output is a contiguous (B, S, H, D) f32.
//
// What bounds it on the card: operations.  At the serving path's prefill
// (B = 4, S = 2048, 32 query heads over 4 KV heads, D = 128, causal) the
// work is 2 S (S + 1) D per head, 1.38e11 operations, against 218 MB of
// q, k, v and the f32 output: 0.139 ms on the bf16 tensor cores, 2.05 ms
// at the 67 TFLOP/s of f32 outside them, 0.065 ms for the bytes.  This
// first kernel is plain SIMT f32, so its own floor is the 2.05 ms:
//   - a block of 256 threads owns 64 query rows of one (batch, head); the
//     scaled q tile stays in shared memory for the whole key loop;
//   - key tiles of 64 rows: K goes into one shared buffer, each thread
//     computes a 4 x 4 block of scores (rows ty*4+i, keys tx+16j), the
//     row max and sum go through 16-lane shuffles, p goes to shared
//     memory; then V replaces K in the same buffer and each thread
//     updates a 4 x (D/16) block of the accumulator, kept in registers;
//   - shared rows have a stride of D + 1 floats (no bank conflicts for
//     even D), so with D = 128 a block takes 82.7 KB (two blocks per SM)
//     and with D = 256 148 KB; above 48 KB the launcher raises the
//     block's dynamic shared-memory limit first;
//   - key tiles wholly above the causal diagonal are never loaded;
//   - a ragged S is guarded: rows past S load zeros and are never
//     written, keys past S get p = 0.
// `mma.sync`/`wgmma` on the tensor cores, TMA and a pipelined K/V ring are
// later work.
//
// Rounding: the sums run in another order than the reference's; results
// agree with the plain versions to f32 rounding.  Key 0 is valid for every
// query row, so after the first tile every row's max is a real score and
// exp(-1e30 - m) is 0 on every masked key, as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 keys
constexpr int kPStride = kBK + 1;
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rows [row0, row0 + 64) of a (seq, D) view with row stride `stride`,
// widened and multiplied by `mul`, into dst[r * (D + 1) + d]; rows at or
// past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int row0, int S,
                                          int D, float mul) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * ld + d] =
        row < S ? widen(src[static_cast<long long>(row) * stride + d]) * mul
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

struct Strides {
  long long b, s, h;
};

// NC = columns of the accumulator per thread: D <= 16 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, float* __restrict__ out,
                           int S, int H, int Hk, int D, Strides qs_,
                           Strides ks_, Strides vs_, float scale, int causal) {
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
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + hk * ks_.h;
  const T* vb = v + b * vs_.b + hk * vs_.h;

  load_tile(qs, qb, qs_.s, q0, S, D, scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // Causal: tiles starting past the block's last row lie wholly above
  // the diagonal and are skipped.
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q is staged; the last tile's V and p are read
    load_tile(kvs, kb, ks_.s, k0, S, D, 1.0f);
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
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = kNegInf;
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
    load_tile(kvs, vb, vs_.s, k0, S, D, 1.0f);
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
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
    float* orow = out + ((static_cast<long long>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = acc[i][c] / den;
    }
  }
}

template <typename T, int NC>
int launch_nc(const T* q, const T* k, const T* v, float* out, int B, int S,
              int H, int Hk, int D, Strides qs_, Strides ks_, Strides vs_,
              float scale, int causal, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   ((kBQ + kBK) * (D + 1) + kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, Hk, D, qs_, ks_, vs_, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, float* out, int B, int S,
           int H, int Hk, int D, const long long* strides, float scale,
           int causal, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const Strides qs_{strides[0], strides[1], strides[2]};
  const Strides ks_{strides[3], strides[4], strides[5]};
  const Strides vs_{strides[6], strides[7], strides[8]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_nc<T, 4>(q, k, v, out, B, S, H, Hk, D, qs_, ks_, vs_,
                           scale, causal, st);
  if (D <= 128)
    return launch_nc<T, 8>(q, k, v, out, B, S, H, Hk, D, qs_, ks_, vs_,
                           scale, causal, st);
  return launch_nc<T, 16>(q, k, v, out, B, S, H, Hk, D, qs_, ks_, vs_, scale,
                          causal, st);
}

}  // namespace

// q (B, S, H, D), k and v (B, S, Hk, D), read through `strides`: nine
// element strides, (batch, seq, head) of q, then of k, then of v; the head
// dimension is contiguous.  out is a contiguous (B, S, H, D) f32.
// 1 <= D <= 256 and H % Hk == 0 (the Python binding checks both).  Returns
// the cudaError_t of the attribute call or the launch.
extern "C" int flash_attention_f32_launch(const float* q, const float* k,
                                          const float* v, float* out, int B,
                                          int S, int H, int Hk, int D,
                                          const long long* strides,
                                          float scale, int causal,
                                          void* stream) {
  return launch(q, k, v, out, B, S, H, Hk, D, strides, scale, causal, stream);
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, float* out, int B,
                                           int S, int H, int Hk, int D,
                                           const long long* strides,
                                           float scale, int causal,
                                           void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v), out, B, S, H, Hk, D,
                strides, scale, causal, stream);
}
