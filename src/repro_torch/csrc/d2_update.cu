// Exact k-means++ D^2 maintenance for one new center, for Hopper (sm_90a).
//
// Replaces the TPU kernels `d2_update_pallas` and `d2_update_tiles_pallas`
// (src/repro/kernels/d2_update.py).  For every point x:
//
//   w'(x) = min(w(x), sum_e (x_e - center_e)^2)          (f32 accumulation)
//
// Points are f32 or bf16 (widened to f32 as they are read), w is f32.
//
// What bounds it on the card: bytes.  Each point reads d coordinates and
// one weight and writes one weight, against 2d + 1 operations: at
// n = 311,029 and d = 74 that is about 94.6 MB, 0.028 ms at 3.35 TB/s,
// against 0.0007 ms of f32 work.  So the design only has to stream the
// (n, d) rows at the memory rate, coalesced: one warp per row at a time,
// the lanes over the coordinates (consecutive lanes on consecutive
// addresses), a shuffle reduction, and each warp walks 32 rows so that
// lane j ends up holding row j's distance and the weights are read and
// written as one coalesced line per warp.  The center's d values are read
// by every warp and stay in L1.
//
// The `_tiles` variant runs one block per `tile` points (tile = blockDim)
// and adds the tile's sum of w' as an epilogue (warp shuffles, then one
// warp over the per-warp sums), as `tree_sep_update_tiles` does: the
// sample heap's refresh reads those sums instead of a second pass.
//
// Rounding: the squared differences are summed in another order than the
// reference's (a lane's strided partial sums, then a butterfly), so w'
// agrees with the plain version to f32 rounding.  No atomics: one input
// gives one output on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, bool kTiles>
__global__ void d2_update_kernel(const T* __restrict__ x,
                                 const T* __restrict__ center,
                                 const float* __restrict__ w,
                                 float* __restrict__ out,
                                 float* __restrict__ tile_sums, int n,
                                 int D) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base =
      static_cast<long long>(blockIdx.x) * blockDim.x + warp * 32;
  const long long left = n - base;
  const int rows = left < 32 ? (left > 0 ? static_cast<int>(left) : 0) : 32;

  float mine = 0.0f;  // the squared distance of row base + lane
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const T* row = x + (base + r) * D;
    float s = 0.0f;
    for (int e = lane; e < D; e += 32) {
      const float diff = widen(row[e]) - widen(center[e]);
      s = fmaf(diff, diff, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == r) mine = s;
  }

  const long long i = base + lane;
  float v = 0.0f;
  if (lane < rows) {
    v = fminf(__ldg(w + i), mine);
    out[i] = v;
  }
  if (kTiles) {  // n % tile == 0, so every lane holds a row
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      const int num_warps = blockDim.x >> 5;
      v = lane < num_warps ? warp_sums[lane] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) tile_sums[blockIdx.x] = v;
    }
  }
}

template <typename T>
int launch(const T* x, const T* center, const float* w, float* out,
           float* tile_sums, int n, int D, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_sums != nullptr) {
    const int blocks = n / tile;  // n % tile == 0
    if (blocks > 0) {
      d2_update_kernel<T, true>
          <<<blocks, tile, 0, s>>>(x, center, w, out, tile_sums, n, D);
    }
  } else {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    if (blocks > 0) {
      d2_update_kernel<T, false>
          <<<blocks, threads, 0, s>>>(x, center, w, out, nullptr, n, D);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Layouts (row-major): x (n, D), center (D,), w and out (n,).  The plain
// entries take any n; the `_tiles` entries need n % tile == 0 and tile a
// multiple of 32 in [32, 1024], and write n / tile sums (the Python binding
// checks both).  Each returns the launch's cudaError_t.
extern "C" int d2_update_f32_launch(const float* x, const float* center,
                                    const float* w, float* out, int n, int D,
                                    void* stream) {
  return launch(x, center, w, out, nullptr, n, D, 0, stream);
}

extern "C" int d2_update_bf16_launch(const void* x, const void* center,
                                     const float* w, float* out, int n,
                                     int D, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(center), w, out, nullptr,
                n, D, 0, stream);
}

extern "C" int d2_update_tiles_f32_launch(const float* x,
                                          const float* center,
                                          const float* w, float* out,
                                          float* tile_sums, int n, int D,
                                          int tile, void* stream) {
  return launch(x, center, w, out, tile_sums, n, D, tile, stream);
}

extern "C" int d2_update_tiles_bf16_launch(const void* x, const void* center,
                                           const float* w, float* out,
                                           float* tile_sums, int n, int D,
                                           int tile, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(center), w, out, tile_sums,
                n, D, tile, stream);
}
