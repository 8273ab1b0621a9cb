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
// A lane axis, as the JAX package's `jax.vmap` gives the Pallas calls one:
// the grid is (blocks, lanes), and lane j sweeps its own (H-1, n) code
// planes at `lo + j * lane_stride` (a stride of 0 shares one copy of the
// codes across lanes, as `fit_batch(seeds)` does) with its own weights row
// w[j] and tile sums row sums[j].  Its center column is read from
// `clo + j * c_lane_stride + x[j] + r * c_row_stride`: with `x` (the opened
// point of each lane, on the card) the column is that point's column of the
// lane's own planes, so no gather runs and nothing syncs; without `x` it is
// the given column (the one-lane call of `ops.tree_sep_update`).  A lane's
// arithmetic is the one-lane launch's, element for element, so each lane's
// outputs are bit-identical to a launch of that lane alone.  Offsets are
// 64-bit: lanes x rows x n passes 2^31 at census size.
//
// Bit-identity with the plain version: `scale` arrives rounded to f32 once,
// 2^(1-H) is an exact f32 power of two, exp2f of an integer is exact, and
// dist*dist is formed in f32, as the PyTorch expression does.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 64;  // H - 1 <= 59: the embedding caps H at 60

// The launch's arguments; lane j's planes, weights and center column are
// offsets of these.
struct Sweep {
  const int* lo;            // (H-1, n) code planes of lane 0, row-major
  const int* hi;
  long long lane_stride;    // elements from one lane's planes to the next
  const int* clo;           // center column of lane 0 (or the planes)
  const int* chi;
  long long c_lane_stride;
  long long c_row_stride;
  const long long* x;       // (lanes,) opened point per lane, or null
  const float* w;           // (lanes, n)
  float* out;               // (lanes, n)
  float* tile_sums;         // (lanes, n / tile), the tiles entry only
  int h;
  int n;
  float scale;
  float floor_term;         // 2^(1-H)
};

// Stage lane j's (H-1,) center column into shared memory; every thread of
// the block reaches the barrier.
__device__ __forceinline__ void stage_center(const Sweep& s, int j,
                                             int* c_lo, int* c_hi) {
  const long long base =
      j * s.c_lane_stride + (s.x != nullptr ? s.x[j] : 0LL);
  for (int r = threadIdx.x; r < s.h; r += blockDim.x) {
    c_lo[r] = s.clo[base + r * s.c_row_stride];
    c_hi[r] = s.chi[base + r * s.c_row_stride];
  }
  __syncthreads();
}

// w'(i) of lane j.
__device__ __forceinline__ float sweep_point(const Sweep& s, int j,
                                             const int* c_lo, const int* c_hi,
                                             int i) {
  const int* __restrict__ lo = s.lo + j * s.lane_stride;
  const int* __restrict__ hi = s.hi + j * s.lane_stride;
  int agree = 0;
  for (int r = 0; r < s.h; ++r) {
    const long long off = static_cast<long long>(r) * s.n + i;
    agree += (__ldg(lo + off) == c_lo[r]) & (__ldg(hi + off) == c_hi[r]);
  }
  const int sep = 1 + agree;
  float dist =
      s.scale * (exp2f(1.0f - static_cast<float>(sep)) - s.floor_term);
  dist = fmaxf(dist, 0.0f);
  return fminf(__ldg(s.w + static_cast<long long>(j) * s.n + i), dist * dist);
}

__global__ void sweep_kernel(const Sweep s) {
  __shared__ int c_lo[kMaxRows];
  __shared__ int c_hi[kMaxRows];
  const int j = blockIdx.y;
  stage_center(s, j, c_lo, c_hi);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < s.n) {
    s.out[static_cast<long long>(j) * s.n + i] =
        sweep_point(s, j, c_lo, c_hi, i);
  }
}

__global__ void sweep_tiles_kernel(const Sweep s) {
  __shared__ int c_lo[kMaxRows];
  __shared__ int c_hi[kMaxRows];
  __shared__ float warp_sums[32];
  const int j = blockIdx.y;
  stage_center(s, j, c_lo, c_hi);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n % tile == 0
  const float v = sweep_point(s, j, c_lo, c_hi, i);
  s.out[static_cast<long long>(j) * s.n + i] = v;
  float sum = v;
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const int num_warps = blockDim.x >> 5;
    sum = lane < num_warps ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0)
      s.tile_sums[static_cast<long long>(j) * gridDim.x + blockIdx.x] = sum;
  }
}

Sweep make_sweep(const int* lo, const int* hi, long long lane_stride,
                 const int* clo, const int* chi, long long c_lane_stride,
                 long long c_row_stride, const long long* x, const float* w,
                 float* out, float* tile_sums, int h, int n, float scale,
                 float floor_term) {
  return Sweep{lo, hi, lane_stride, clo, chi, c_lane_stride, c_row_stride,
               x, w, out, tile_sums, h, n, scale, floor_term};
}

}  // namespace

// Plain sweep over n points of `lanes` lanes; h <= 64, 1 <= lanes <= 65535
// (the Python binding checks both).  Returns the launch's cudaError_t.
extern "C" int tree_sep_update_launch(
    const int* lo, const int* hi, long long lane_stride, const int* clo,
    const int* chi, long long c_lane_stride, long long c_row_stride,
    const long long* x, const float* w, float* out, int h, int n, int lanes,
    float scale, float floor_term, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0 && lanes > 0) {
    sweep_kernel<<<dim3(blocks, lanes), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        make_sweep(lo, hi, lane_stride, clo, chi, c_lane_stride,
                   c_row_stride, x, w, out, nullptr, h, n, scale,
                   floor_term));
  }
  return static_cast<int>(cudaGetLastError());
}

// Sweep plus per-tile sums; n % tile == 0, tile a multiple of 32 <= 1024,
// h <= 64, 1 <= lanes <= 65535 (the Python binding checks them).  Returns
// the launch's cudaError_t.
extern "C" int tree_sep_update_tiles_launch(
    const int* lo, const int* hi, long long lane_stride, const int* clo,
    const int* chi, long long c_lane_stride, long long c_row_stride,
    const long long* x, const float* w, float* out, float* tile_sums, int h,
    int n, int tile, int lanes, float scale, float floor_term, void* stream) {
  const int blocks = n / tile;
  if (blocks > 0 && lanes > 0) {
    sweep_tiles_kernel<<<dim3(blocks, lanes), tile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        make_sweep(lo, hi, lane_stride, clo, chi, c_lane_stride,
                   c_row_stride, x, w, out, tile_sums, h, n, scale,
                   floor_term));
  }
  return static_cast<int>(cudaGetLastError());
}
