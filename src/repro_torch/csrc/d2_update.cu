// Exact k-means++ D^2 maintenance for one new center, for Hopper (sm_90a).
//
// Replaces the TPU kernels `d2_update_pallas` and `d2_update_tiles_pallas`
// (src/repro/kernels/d2_update.py).  For every point x:
//
//   w'(x) = min(w(x), sum_e (x_e - center_e)^2)          (f32 accumulation)
//
// Points are f32 or bf16 (widened to f32 as they are read), w is f32.  The
// `_tiles` entry also returns the f32 sum of every `tile` of w', over the
// weights padded with zeros to a multiple of the tile (n_pad), as the JAX
// package's wrapper returns them.
//
// What bounds it on the card: bytes.  Each point reads d coordinates and one
// weight and writes one weight, against 3d + 1 operations: 4 (n d + d + 2n)
// bytes in f32 (x at 2 bytes an element in bf16).  At n = 311,029 and d = 74
// that is 94.6 MB, 0.0282 ms at 3.35 TB/s, against 0.001 ms of f32 work; at
// 2,458,285 x 68 (far beyond the 50 MB L2) 688 MB, 0.2055 ms.  So the kernel
// has to stream x at the memory rate.  The first kernel (one warp a row,
// 1,215 blocks) reached 0.41 of that; what the design does about each of
// its three limits:
//   - Whole waves.  The grid is persistent: as many blocks of 256 threads as
//     fit on the card at once (occupancy times SMs: 4 a SM at d = 74), or
//     fewer when n is small.  Block b walks a contiguous range of rows,
//     [U b / grid, U (b + 1) / grid) in units of 32 rows (U = ceil(n / 32)),
//     so every block ends within one unit of the others and no launch ends
//     in a nearly empty wave.
//   - Bytes in flight.  A block streams its rows through a ring of 2 stages
//     in shared memory, each up to 24 KB of x plus the chunk's weights,
//     filled by 1-D TMA bulk copies (`cp.async.bulk` with `mbarrier`
//     completion) that one thread issues as soon as a stage is free: up to
//     8 stages, some 150 KB, in flight a SM.  A chunk is R whole rows (R a
//     multiple of 32, R d elements <= 24 KB); a chunk starts on a multiple
//     of 32 rows, so it is 16-byte aligned whenever x is, for any d.  Wider
//     rows (more than 768 bytes) are streamed as R = 32 rows in 24 KB
//     pieces, so d has no limit.  Fewer, larger stages in more blocks beat
//     deeper rings (4 x 24 KB at 2 blocks a SM, or 8 x 12 KB) on the H100:
//     a block pays a chunk's fixed costs (a barrier, the reduction) per
//     stage, and more blocks overlap them.
//   - Reductions from shared memory.  Each row is reduced from the stage by
//     a group of G lanes (G in 1..32, a power of two: the smallest that
//     gives every thread a row and keeps the stage reads at most 2-way
//     bank-conflicted; G = 4 at d = 74 f32), each lane summing every G-th
//     coordinate against the center, which is staged once a block in shared
//     memory in f32 (d <= 4096; read through L1 beyond), then log2 G
//     shuffles.  The old loop's dependent shuffles per row and partial
//     loads at d = 74 are gone.
//   - w arrives in the same bulk copy as the chunk's last piece, and w' is
//     gathered in shared memory and written as one 16-byte store a thread.
// Any pointer alignment, any n and any d: a chunk is copied by TMA only
// where x and w are 16-byte aligned and the chunk's rows are a multiple of
// 8 (so its bytes are a multiple of 16); otherwise (an offset view such as
// big[1:], or the last ragged chunk) the block fills the stage, x and w,
// with guarded loads.
// Nothing falls back to another kernel or to the plain version.
//
// Tile sums (`_tiles`): the kernel writes the sum of each 32-row unit of w'
// (rows at and past n count 0 and are never read), and a second small
// kernel sums each tile's units (a tile is a multiple of 32 rows, at most
// 1024) with one warp a tile and writes w' = 0 past n.  Units and tiles are
// butterflies in a fixed order and nothing uses float atomics, so one input
// gives the same bits on every launch.  Nothing pads or copies x.
//
// Rounding: each row's squared differences are summed in another order
// than the plain version's (a lane's strided partial sums, then a
// butterfly), so w' agrees with it to f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kStageBytes = 24 * 1024;  // x bytes of one stage
constexpr int kUnit = 32;  // rows of a unit: blocks, chunks and tile sums
constexpr int kMaxRowsPerGroup = 4;  // rows a lane group reduces a chunk
constexpr int kMaxRows = 1024;  // rows of a chunk
constexpr int kMaxSharedCenter = 4096;  // d up to which the center is staged
// A chunk of wide rows (32 rows, one warp a row) fits the lane groups.
static_assert(kUnit <= kMaxRowsPerGroup * kWarps, "wide chunks");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D TMA: `bytes` (a multiple of 16) from 16-byte aligned global memory into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One launch's geometry: R rows a chunk, G lanes a row, whether x and w
// are 16-byte aligned (TMA), and whether the center is staged in shared
// memory (in f32, d <= kMaxSharedCenter) or read through L1.
struct Plan {
  int rows, group, bulk, center_smem;
};

// Shared memory of a block: kStages x (x area, w area), w' of two chunks,
// the center, then one mbarrier a stage.
__host__ __device__ inline int round128(int bytes) {
  return (bytes + 127) & ~127;
}
__host__ __device__ inline int stage_stride(int rows) {
  return kStageBytes + round128(rows * 4);
}
__host__ __device__ inline int center_area(const Plan& plan, int d) {
  return plan.center_smem ? round128(d * 4) : 0;
}
__host__ __device__ inline size_t smem_bytes(const Plan& plan, int d) {
  return static_cast<size_t>(kStages) * stage_stride(plan.rows) +
         2 * plan.rows * 4 + center_area(plan, d) + kStages * 8;
}

// A lane's share of one row within one piece: the squared differences of
// x_s[j] and its coordinate c[j] for j = j0, j0 + step, ... < e.  The center
// is f32 in shared memory (kShared) or T in global memory.
template <bool kShared, typename T, typename C>
__device__ __forceinline__ float row_part(const T* xs, const C* c, int j0,
                                          int e, int step, float a) {
#pragma unroll 4
  for (int j = j0; j < e; j += step) {
    float cj;
    if constexpr (kShared) {
      cj = c[j];
    } else {
      cj = widen(__ldg(c + j));
    }
    const float diff = widen(xs[j]) - cj;
    a = fmaf(diff, diff, a);
  }
  return a;
}

template <typename T, bool kTiles>
__global__ void __launch_bounds__(kThreads)
    d2_update_kernel(const T* __restrict__ x, const T* __restrict__ center,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ unit_sums, int n, int d, Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = plan.rows, G = plan.group;
  const int stride = stage_stride(R);
  float* wn = reinterpret_cast<float*>(smem + kStages * stride);
  float* cs = wn + 2 * R;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(cs) + center_area(plan, d));

  const int tid = threadIdx.x;
  const long long units = (n + kUnit - 1) / kUnit;
  const long long r0 = units * blockIdx.x / gridDim.x * kUnit;
  const long long r1 =
      min(units * (blockIdx.x + 1) / gridDim.x * kUnit, (long long)n);
  if (r0 >= r1) return;  // the whole block: no barrier is in use yet
  const int chunks = static_cast<int>((r1 - r0 + R - 1) / R);
  constexpr int kPieceElems = kStageBytes / sizeof(T);
  // Pieces of a chunk of `elems` elements (one when d = 0: w alone).
  auto pieces_of = [](long long elems) {
    return max(1, static_cast<int>((elems + kPieceElems - 1) / kPieceElems));
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (plan.center_smem)
    for (int j = tid; j < d; j += kThreads) cs[j] = widen(center[j]);
  __syncthreads();

  // The producer (thread 0): issue pieces in the consumers' order, up to
  // linear piece index `limit` - 1.  A piece that is not copied by TMA is
  // skipped here and filled by the whole block when it is consumed.
  int pk = 0, pp = 0, pi = 0;  // next chunk, its next piece, linear index
  auto issue_upto = [&](int limit) {
    while (pk < chunks && pi < limit) {
      const long long q = r0 + static_cast<long long>(pk) * R;
      const int rows = static_cast<int>(min(static_cast<long long>(R), r1 - q));
      const long long elems = static_cast<long long>(rows) * d;
      const int pieces = pieces_of(elems);
      if (plan.bulk && (rows & 7) == 0) {
        const int s = pi % kStages;
        unsigned char* st = smem + s * stride;
        const long long lo = static_cast<long long>(pp) * kPieceElems;
        const uint32_t xb = static_cast<uint32_t>(
            (min(lo + kPieceElems, elems) - lo) * sizeof(T));
        const bool with_w = pp == pieces - 1;
        const uint32_t wb = with_w ? rows * 4u : 0u;
        // The block's reads of this stage (and any guarded stores to it)
        // come before the async proxy writes it again.
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(&bars[s], xb + wb);
        bulk_load(st, x + q * d + lo, xb, &bars[s]);
        if (with_w) bulk_load(st + kStageBytes, w + q, wb, &bars[s]);
      }
      if (++pp == pieces) {
        pp = 0;
        ++pk;
      }
      ++pi;
    }
  };
  if (tid == 0) issue_upto(kStages);

  const int group = tid / G, sub = tid % G, groups = kThreads / G;
  uint32_t parity = 0;  // bit s: the phase of stage s's barrier to wait for
  int i = 0, buf = 0;   // linear piece index; which w' buffer
  for (int k = 0; k < chunks; ++k) {
    const long long q0 = r0 + static_cast<long long>(k) * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), r1 - q0));
    const long long elems = static_cast<long long>(rows) * d;
    const int pieces = pieces_of(elems);
    const bool bulk = plan.bulk && (rows & 7) == 0;
    const int per_group = (rows + groups - 1) / groups;  // rows a group reduces
    const T* xc = x + q0 * d;
    float acc[kMaxRowsPerGroup];
#pragma unroll
    for (int m = 0; m < kMaxRowsPerGroup; ++m) acc[m] = 0.0f;

    for (int p = 0; p < pieces; ++p, ++i) {
      const int s = i % kStages;
      unsigned char* st = smem + s * stride;
      const T* xs = reinterpret_cast<const T*>(st);
      float* ws = reinterpret_cast<float*>(st + kStageBytes);
      const long long lo = static_cast<long long>(p) * kPieceElems;
      const int len = static_cast<int>(min(lo + kPieceElems, elems) - lo);
      const bool last = p == pieces - 1;
      if (bulk) {
        mbar_wait(&bars[s], (parity >> s) & 1u);
        parity ^= 1u << s;
      } else {  // guarded fill: any alignment, any row count
        T* fill = reinterpret_cast<T*>(st);
#pragma unroll 4
        for (int j = tid; j < len; j += kThreads) fill[j] = xc[lo + j];
        if (last)
          for (int j = tid; j < rows; j += kThreads) ws[j] = w[q0 + j];
        __syncthreads();
      }

      // This piece's share of each of the group's rows.
#pragma unroll
      for (int m = 0; m < kMaxRowsPerGroup; ++m) {
        const int row = group + m * groups;
        if (m < per_group && row < rows) {
          const long long row_lo = static_cast<long long>(row) * d;
          const int b = static_cast<int>(max(row_lo, lo) - lo);
          const int e = static_cast<int>(min(row_lo + d, lo + len) - lo);
          const long long c_off = lo - row_lo;  // x_s[j]: coordinate j + c_off
          acc[m] = plan.center_smem
                       ? row_part<true>(xs, cs + c_off, b + sub, e, G, acc[m])
                       : row_part<false>(xs, center + c_off, b + sub, e, G,
                                         acc[m]);
        }
      }
      float* wbuf = wn + buf * R;
      if (last) {
#pragma unroll
        for (int m = 0; m < kMaxRowsPerGroup; ++m) {
          if (m >= per_group) break;  // uniform over the block
          const float v = warp_sum(acc[m], G);
          const int row = group + m * groups;
          if (sub == 0 && row < rows) wbuf[row] = fminf(ws[row], v);
        }
      }
      __syncthreads();  // stage s is free; w' of the chunk is complete
      if (tid == 0) issue_upto(i + 1 + kStages);
      if (!last) continue;

      float* dst = out + q0;
      if ((rows & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        for (int j = tid; j < rows / 4; j += kThreads)
          reinterpret_cast<float4*>(dst)[j] =
              reinterpret_cast<const float4*>(wbuf)[j];
      } else {
        for (int j = tid; j < rows; j += kThreads) dst[j] = wbuf[j];
      }
      if (kTiles) {  // one butterfly per 32-row unit; rows past n count 0
        const int warp = tid >> 5, lane = tid & 31;
        for (int u = warp; u * kUnit < rows; u += kWarps) {
          const int row = u * kUnit + lane;
          const float v = warp_sum(row < rows ? wbuf[row] : 0.0f, 32);
          if (lane == 0) unit_sums[q0 / kUnit + u] = v;
        }
      }
      buf ^= 1;
    }
  }
}

// Each tile's sum over its (at most 32) units, one warp a tile: the units
// are read together and summed by a butterfly, and w' = 0 past n.
__global__ void tile_sums_kernel(const float* __restrict__ unit_sums,
                                 float* __restrict__ out,
                                 float* __restrict__ tile_sums, int n,
                                 int n_pad, int tile) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int per = tile / kUnit;
  const int units = (n + kUnit - 1) / kUnit;
  if (warp < n_pad / tile) {
    const int u = warp * per + lane;
    const float v = warp_sum(lane < per && u < units ? unit_sums[u] : 0.0f, 32);
    if (lane == 0) tile_sums[warp] = v;
  }
  for (int j = n + t; j < n_pad; j += gridDim.x * blockDim.x) out[j] = 0.0f;
}

// Shared-memory bank conflicts of one load step: 32 / G rows of d elements
// of `es` bytes, G lanes each on consecutive elements; the most distinct
// 4-byte words that fall on one bank.
int conflict_ways(int d, int es, int G) {
  long long words[32];
  int count = 0;
  for (int r = 0; r < 32 / G; ++r)
    for (int s = 0; s < G; ++s) {
      const long long word = (static_cast<long long>(r) * d + s) * es / 4;
      bool seen = false;
      for (int j = 0; j < count; ++j) seen |= words[j] == word;
      if (!seen) words[count++] = word;
    }
  int worst = 0;
  for (int b = 0; b < 32; ++b) {
    int ways = 0;
    for (int j = 0; j < count; ++j) ways += words[j] % 32 == b;
    worst = ways > worst ? ways : worst;
  }
  return worst;
}

Plan make_plan(int d, int es, const void* x, const float* w) {
  Plan plan;
  const long long row_bytes = static_cast<long long>(d) * es;
  const long long fit = row_bytes > 0 ? kStageBytes / row_bytes : kMaxRows;
  if (fit < kUnit) {  // wide rows: 32 rows a chunk, streamed in pieces
    plan.rows = kUnit;
    plan.group = 32;
  } else {
    int rows = static_cast<int>(fit < kMaxRows ? fit : kMaxRows);
    rows -= rows % kUnit;
    int g = 1;
    while (g < 32 && g * rows < kThreads) g *= 2;
    while (g < 32 && conflict_ways(d, es, g) > 2) g *= 2;
    const int cap = kMaxRowsPerGroup * kThreads / g;
    plan.rows = rows < cap ? rows : cap - cap % kUnit;
    plan.group = g;
  }
  plan.center_smem = d <= kMaxSharedCenter;
  plan.bulk = d > 0 && ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  return plan;
}

template <typename T, bool kTiles>
cudaError_t launch_main(const T* x, const T* center, const float* w,
                        float* out, float* unit_sums, int n, int d,
                        cudaStream_t st) {
  auto kernel = d2_update_kernel<T, kTiles>;
  const Plan plan = make_plan(d, sizeof(T), x, w);
  const size_t smem = smem_bytes(plan, d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long units = (n + kUnit - 1) / kUnit;
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(units < slots ? units : slots);
  kernel<<<grid, kThreads, smem, st>>>(x, center, w, out, unit_sums, n, d,
                                       plan);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* center, const float* w, float* out,
           float* unit_sums, float* tile_sums, int n, int D, int tile,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (tile_sums == nullptr) {
    if (n > 0)
      err = launch_main<T, false>(x, center, w, out, nullptr, n, D, st);
    return static_cast<int>(err);
  }
  const int n_pad = (n + tile - 1) / tile * tile;
  if (n_pad == 0) return 0;
  err = launch_main<T, true>(x, center, w, out, unit_sums, n, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = n_pad / tile;
  tile_sums_kernel<<<(tiles + 7) / 8, 256, 0, st>>>(unit_sums, out,
                                                        tile_sums, n, n_pad,
                                                        tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Layouts (row-major): x (n, D), center (D,), w (n,), any alignment.  The
// plain entries write out (n,).  The `_tiles` entries take tile a multiple
// of 32 in [32, 1024] (the Python binding checks it) and any n, and write
// out (n_pad,) with zeros past n and tile_sums (n_pad / tile,), n_pad =
// ceil(n / tile) tile; unit_sums is scratch of ceil(n / 32) floats.  Each
// returns the cudaError_t of an attribute query or a launch.
extern "C" int d2_update_f32_launch(const float* x, const float* center,
                                    const float* w, float* out, int n, int D,
                                    void* stream) {
  return launch(x, center, w, out, nullptr, nullptr, n, D, 0, stream);
}

extern "C" int d2_update_bf16_launch(const void* x, const void* center,
                                     const float* w, float* out, int n,
                                     int D, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(center), w, out, nullptr,
                nullptr, n, D, 0, stream);
}

extern "C" int d2_update_tiles_f32_launch(const float* x,
                                          const float* center,
                                          const float* w, float* out,
                                          float* unit_sums, float* tile_sums,
                                          int n, int D, int tile,
                                          void* stream) {
  return launch(x, center, w, out, unit_sums, tile_sums, n, D, tile, stream);
}

extern "C" int d2_update_tiles_bf16_launch(const void* x, const void* center,
                                           const float* w, float* out,
                                           float* unit_sums,
                                           float* tile_sums, int n, int D,
                                           int tile, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(center), w, out, unit_sums,
                tile_sums, n, D, tile, stream);
}
