// Nearest center per point, min_c ||x - c||^2 and its argmin, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `pairwise_argmin_pallas`
// (src/repro/kernels/pairwise_argmin.py).  For every point x over the
// center slots c:
//
//   d2[x, c] = max((|x|^2 - 2 x.c) + |c|^2, 0)        (f32 accumulation)
//   min[x]   = min_c d2[x, c],  arg[x] = the smallest c attaining it
//
// Inputs are f32 or bf16 (widened to f32 when staged, as the TPU kernel's
// `astype(jnp.float32)`); outputs are f32 and int32.
//
// What bounds it on the card: operations.  At the k-means|| path's shapes
// (n = 311,029 points, 8,000 center slots, d = 74) it does 2 n k d =
// 3.7e11 f32 operations against about 97 MB of inputs and outputs, so the
// 67 TFLOP/s of f32 outside the tensor cores binds (5.5 ms), not the
// 3.35 TB/s of HBM (0.03 ms).  The design is a plain register-tiled
// product with the min/argmin fused into its epilogue, so the (n, k)
// distance matrix never leaves registers:
//   - a block of 256 threads owns 128 points and sweeps all center slots in
//     tiles of 128; each thread holds an 8 x 8 block of dot products
//     (points ty*4 + {0..3} and 64 + ty*4 + {0..3}, centers likewise with
//     tx), so its shared-memory reads are float4s that a half-warp takes
//     from 256 contiguous bytes;
//   - the coordinates go through shared memory 16 at a time, transposed
//     (coordinate-major, row stride 132 floats: float4-aligned, and the
//     transposing stores conflict at most two ways); a chunk past d is
//     zero-filled, so any d works;
//   - |x|^2 and |c|^2 are summed from the same staged chunks, one row per
//     thread (threads 0..127 the points, 128..255 the centers);
//   - after each center tile every thread folds its 64 distances into a
//     running (min, argmin) per point with a strict <, walking its centers
//     in increasing index; at the end the 16 threads that share a point
//     combine lexicographically on (d2, index) with warp shuffles.  So ties
//     go to the smallest index, and no atomics run: one input gives one
//     output, bit for bit, on every run.
// No library call computes x.c.  `wgmma` on the tensor cores (3xTF32 or a
// bf16 split) is later work.
//
// Rounding: the dot products sum over d in another order than the
// reference's matrix product, and nvcc may contract (|x|^2 - 2 x.c) into an
// FMA (2 x.c is exact, so that changes nothing).  Results agree with the
// plain version to f32 rounding of the expanded form.  Padded center slots
// sit at 1e17 in every coordinate: |c|^2 = d * 1e34 stays finite in f32
// because each coordinate is squared on its own.
//
// The wrapper (`ops.pairwise_argmin`) pads n and k to multiples of 128
// (rows with zeros, centers at 1e17), so the kernel has no ragged edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 128;         // points per block
constexpr int kTileK = 128;         // center slots per tile
constexpr int kChunk = 16;          // coordinates per shared-memory stage
constexpr int kThreads = 256;       // 16 x 16 threads, 8 x 8 products each
constexpr int kStride = kTileN + 4; // shared row stride in floats

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Local row (or column) of slot i in 0..7 of thread group g in 0..15.
__device__ __forceinline__ int slot(int g, int i) {
  return (i < 4 ? 0 : 64 - 4) + g * 4 + i;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pairwise_argmin_kernel(const T* __restrict__ x, const T* __restrict__ c,
                           float* __restrict__ min_out,
                           int* __restrict__ arg_out, int K, int D) {
  __shared__ __align__(16) float xs[kChunk][kStride];
  __shared__ __align__(16) float cs[kChunk][kStride];
  __shared__ float x_sq_s[kTileN];
  __shared__ float c_sq_s[kTileK];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // center group: the low 4 bits of the lane
  const int ty = tid >> 4;  // point group
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileN;

  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    arg[i] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += kTileK) {  // K % kTileK == 0
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    float sq = 0.0f;  // |row|^2 of point tid or center tid - 128

    for (int e0 = 0; e0 < D; e0 += kChunk) {
      __syncthreads();  // the previous chunk is no longer read
      for (int idx = tid; idx < kTileN * kChunk; idx += kThreads) {
        const int r = idx / kChunk;
        const int e = idx - r * kChunk;
        const int col = e0 + e;
        float xv = 0.0f;
        float cv = 0.0f;
        if (col < D) {
          xv = widen(x[(row0 + r) * D + col]);
          cv = widen(c[(static_cast<long long>(k0) + r) * D + col]);
        }
        xs[e][r] = xv;
        cs[e][r] = cv;
      }
      __syncthreads();

      const float* own = tid < kTileN ? &xs[0][tid] : &cs[0][tid - kTileN];
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const float v = own[e * kStride];
        sq = fmaf(v, v, sq);
      }

#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[e][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&xs[e][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&cs[e][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&cs[e][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    if (tid < kTileN) {
      x_sq_s[tid] = sq;
    } else {
      c_sq_s[tid - kTileN] = sq;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x_sq = x_sq_s[slot(ty, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // increasing center index
        const int col = slot(tx, j);
        const float v = fmaxf((x_sq - 2.0f * acc[i][j]) + c_sq_s[col], 0.0f);
        if (v < best[i]) {
          best[i] = v;
          arg[i] = k0 + col;
        }
      }
    }
  }

  // The 16 threads of a point group are lanes 0..15 or 16..31 of one warp.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = best[i];
    int a = arg[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oa = __shfl_xor_sync(0xffffffffu, a, o);
      if (ov < v || (ov == v && oa < a)) {
        v = ov;
        a = oa;
      }
    }
    if (tx == 0) {
      const long long row = row0 + slot(ty, i);
      min_out[row] = v;
      arg_out[row] = a;
    }
  }
}

template <typename T>
int launch(const T* x, const T* c, float* min_out, int* arg_out, int N,
           int K, int D, void* stream) {
  const int blocks = N / kTileN;  // N % kTileN == 0
  if (blocks > 0) {
    pairwise_argmin_kernel<T>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            x, c, min_out, arg_out, K, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Layouts (row-major): x (N, D), c (K, D); outputs min_out (N,) f32 and
// arg_out (N,) int32.  N % 128 == 0, K % 128 == 0 and K >= 128 (the Python
// binding checks all three).  Returns the launch's cudaError_t.
extern "C" int pairwise_argmin_f32_launch(const float* x, const float* c,
                                          float* min_out, int* arg_out,
                                          int N, int K, int D, void* stream) {
  return launch(x, c, min_out, arg_out, N, K, D, stream);
}

extern "C" int pairwise_argmin_bf16_launch(const void* x, const void* c,
                                           float* min_out, int* arg_out,
                                           int N, int K, int D,
                                           void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(c), min_out, arg_out, N, K,
                D, stream);
}
