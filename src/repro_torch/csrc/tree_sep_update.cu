// One tree's MULTITREEOPEN weight sweep, for Hopper (sm_90a).
//
// Replaces the TPU kernels `tree_sep_update_pallas` and
// `tree_sep_update_tiles_pallas` (src/repro/kernels/tree_sep_update.py).
// When a center x opens, every point y's tree distance to the center set can
// only improve through x, in closed form of the separation level:
//
//   sep   = 1 + #{h : lo(y,h) == lo(x,h) && hi(y,h) == hi(x,h)}
//   dist  = max(scale * (2^(1-sep) - 2^(1-H)), 0)
//   w'(y) = min(w(y), dist^2)
//
// What bounds it on the card: bytes.  Each point reads 2*(H-1) int32 codes
// and one f32 weight and writes one f32, about 8H + 8 bytes, against a few
// integer operations per code row.  So the design only has to stream the
// (H-1, n) code planes at the memory rate: one thread per point and a loop
// over the rows, so each row load of a warp is one coalesced 128-byte line.
// The center's code column (a strided column of the same planes, so no
// gather runs to extract it) is staged once per block in shared memory and
// read from there as a broadcast.
//
// The `_tiles` variant runs one block per `tile` points (tile = blockDim)
// and adds the tile's sum of w' as an epilogue (warp shuffles, then one warp
// over the per-warp sums): the coarse sample-heap refresh reads those sums
// instead of making a second pass over the weights.
//
// Bit-identity with the plain version: `scale` arrives rounded to f32 once,
// 2^(1-H) is an exact f32 power of two, exp2f of an integer is exact, and
// dist*dist is formed in f32, as the PyTorch expression does.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 64;  // H - 1 <= 59: the embedding caps H at 60

// Stage the center's (H-1,) code column into shared memory; every thread of
// the block reaches the barrier.
__device__ __forceinline__ void stage_center(const int* __restrict__ clo,
                                             const int* __restrict__ chi,
                                             long long c_stride, int h,
                                             int* c_lo, int* c_hi) {
  for (int r = threadIdx.x; r < h; r += blockDim.x) {
    c_lo[r] = clo[r * c_stride];
    c_hi[r] = chi[r * c_stride];
  }
  __syncthreads();
}

__device__ __forceinline__ float sweep_point(
    const int* __restrict__ lo, const int* __restrict__ hi, const int* c_lo,
    const int* c_hi, const float* __restrict__ w, int h, int n, int i,
    float scale, float floor_term) {
  int agree = 0;
  for (int r = 0; r < h; ++r) {
    const long long off = static_cast<long long>(r) * n + i;
    agree += (__ldg(lo + off) == c_lo[r]) & (__ldg(hi + off) == c_hi[r]);
  }
  const int sep = 1 + agree;
  float dist = scale * (exp2f(1.0f - static_cast<float>(sep)) - floor_term);
  dist = fmaxf(dist, 0.0f);
  return fminf(__ldg(w + i), dist * dist);
}

__global__ void sweep_kernel(const int* __restrict__ lo,
                             const int* __restrict__ hi,
                             const int* __restrict__ clo,
                             const int* __restrict__ chi, long long c_stride,
                             const float* __restrict__ w,
                             float* __restrict__ out, int h, int n,
                             float scale, float floor_term) {
  __shared__ int c_lo[kMaxRows];
  __shared__ int c_hi[kMaxRows];
  stage_center(clo, chi, c_stride, h, c_lo, c_hi);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = sweep_point(lo, hi, c_lo, c_hi, w, h, n, i, scale, floor_term);
  }
}

__global__ void sweep_tiles_kernel(const int* __restrict__ lo,
                                   const int* __restrict__ hi,
                                   const int* __restrict__ clo,
                                   const int* __restrict__ chi,
                                   long long c_stride,
                                   const float* __restrict__ w,
                                   float* __restrict__ out,
                                   float* __restrict__ tile_sums, int h,
                                   int n, float scale, float floor_term) {
  __shared__ int c_lo[kMaxRows];
  __shared__ int c_hi[kMaxRows];
  __shared__ float warp_sums[32];
  stage_center(clo, chi, c_stride, h, c_lo, c_hi);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n % tile == 0
  const float v = sweep_point(lo, hi, c_lo, c_hi, w, h, n, i, scale,
                              floor_term);
  out[i] = v;
  float s = v;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int num_warps = blockDim.x >> 5;
    s = lane < num_warps ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) tile_sums[blockIdx.x] = s;
  }
}

}  // namespace

// Plain sweep over n points; h <= 64.  Returns the launch's cudaError_t.
extern "C" int tree_sep_update_launch(const int* lo, const int* hi,
                                      const int* clo, const int* chi,
                                      long long c_stride, const float* w,
                                      float* out, int h, int n, float scale,
                                      float floor_term, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    sweep_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        lo, hi, clo, chi, c_stride, w, out, h, n, scale, floor_term);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sweep plus per-tile sums; n % tile == 0, tile a multiple of 32 <= 1024,
// h <= 64 (the Python binding checks all three).  Returns the launch's
// cudaError_t.
extern "C" int tree_sep_update_tiles_launch(
    const int* lo, const int* hi, const int* clo, const int* chi,
    long long c_stride, const float* w, float* out, float* tile_sums, int h,
    int n, int tile, float scale, float floor_term, void* stream) {
  const int blocks = n / tile;
  if (blocks > 0) {
    sweep_tiles_kernel<<<blocks, tile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        lo, hi, clo, chi, c_stride, w, out, tile_sums, h, n, scale,
        floor_term);
  }
  return static_cast<int>(cudaGetLastError());
}
