// Nearest center per point, min_c ||x - c||^2 and its argmin, on Hopper's
// tensor cores (sm_90a).
//
// Replaces the TPU kernel `pairwise_argmin_pallas`
// (src/repro/kernels/pairwise_argmin.py).  For every point x over the live
// center slots c:
//
//   d2[x, c] = max((|x|^2 - 2 x.c) + |c|^2, 0)        (f32 accumulation)
//   min[x]   = min_c d2[x, c],  arg[x] = the smallest c attaining it
//
// Inputs are f32 or bf16; outputs are f32 and int32.
//
// What bounds it on the card: operations.  At the k-means|| path's shapes
// (n = 311,029 points, 8,000 center slots, d = 74) x.c is 1.8e11
// multiply-adds against about 97 MB of inputs and outputs.  In f32 the
// product runs as 3xTF32 (below), three tensor-core products at 495
// TFLOP/s: 2.2 ms, where HBM needs 0.03 ms.  A bf16 product is one product
// at 989 TFLOP/s.  What the design does about it:
//   - x.c on the tensor cores with `mma.sync` m16n8k8 (TF32) or m16n8k16
//     (bf16), f32 accumulation.  f32 values are split once into
//     big = tf32(a) and small = tf32(a - big), both rounded to nearest,
//     ties away from zero (`cvt.rna`, written as its two integer
//     instructions), and the kernel accumulates small.big + big.small +
//     big.big (small.small, about 2^-22 relative, is dropped): f32
//     accuracy from TF32 products.  A bf16 x bf16 product is exact in f32,
//     so the bf16 route is the TPU kernel's `astype(float32)` product.
//     No library call computes x.c.
//   - A block of 256 threads (8 warps, 2 along the points by 4 along the
//     centers) owns 32 MT points and sweeps the center tiles of 128 slots;
//     at d = 74, MT = 4: 128 points and warps of 64 x 32 accumulators.
//     Smaller point tiles (MT = 2, 1) take a larger d.
//   - The point tile is loaded once per block with guarded loads (any n,
//     any row alignment: at d = 74 a row is 296 bytes, which neither a
//     16-byte `cp.async` nor TMA can read in place), split once (f32), and
//     stored in the MMA's own fragment order: one 16-byte shared load per
//     lane is the A operand's register quad, with no register moves, and
//     a warp's load is 512 contiguous bytes, free of bank conflicts.
//     |x|^2 is summed there, in f32 on the CUDA cores, from the unsplit
//     values.
//   - A small first kernel copies the swept center slots into rows of a
//     multiple of 128 bytes (zeros past d) and sums |c|^2 from the unsplit
//     values.  The main kernel streams 128-byte panels of 128 center rows,
//     with their |c|^2, through a 3-stage ring of 16-byte `cp.async`; the
//     slots stay in L2 (8,064 x 96 x 4 B = 3.1 MB).
//   - The k order inside one MMA step is permuted the same way for x and
//     c (slot t is coordinate 2t, slot t + 4 coordinate 2t + 1; for bf16
//     the pairs likewise), so a center fragment is one 8-byte shared load;
//     160-byte ring rows keep those free of bank conflicts.  The next
//     k-step's fragments are read while this one's products run.
//   - Live slots: an optional device int32 `count` is read by the kernels
//     themselves, with no host sync; they sweep slots 0 .. min(count, K-1),
//     the live slots and the first dead one (later slots of the last tile
//     get |c|^2 = +inf).  When every dead slot is the same far row (the
//     k-means|| picks and the wrapper's padding both are) that gives the
//     full sweep's outputs bit for bit.  A null pointer means all K slots.
//   - The epilogue adds the norms, clamps at 0 and keeps a running
//     (min, argmin) per row with a strict <, walking centers in increasing
//     index; the 4 lanes and then the 4 warps that share a row combine
//     lexicographically on (d2, index).  Ties go to the smallest index and
//     no atomics run: one input gives one output, bit for bit, on every
//     launch, whatever the count.
//
// Rounding: 3xTF32 and the tensor cores' f32 sums round differently from a
// plain f32 dot product; results agree with the plain version to f32
// rounding of the expanded form, and exactly where every partial sum is an
// f32 integer (|coordinate| <= 128, d <= 200).  Far slots sit at 1e17 in
// every coordinate: |c|^2 = d * 1e34 stays finite in f32.  Inputs are
// finite (the integer form of `cvt.rna` may turn a NaN into an infinity).
//
// Shared memory bounds d: the smallest point tile (32 rows) must fit
// beside the ring, so d <= 656 in f32 and d <= 2624 in bf16; the Python
// binding checks it, and the launch returns cudaErrorInvalidValue past it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsN = 4;                  // warps along the centers
constexpr int kNT = 4;                      // 8-center MMA tiles per warp
constexpr int kTileK = kWarpsN * kNT * 8;   // 128 center slots per tile
constexpr int kPanelBytes = 128;            // one center row's panel
constexpr int kKSteps = 4;                  // MMA k-steps per panel
constexpr int kRowBytes = kPanelBytes + 32;     // ring row: 40 words
constexpr int kRowU2 = kRowBytes / 8;
constexpr int kStages = 3;
constexpr int kStageBytes = kTileK * kRowBytes + kTileK * 4;  // + |c|^2
constexpr int kSmemMax = 232448;            // per block, sm_90

// Per route: coordinates per k-step, and the staged bytes of one 16-point
// MMA tile for one k-step (32 lanes x 16 bytes: f32 stores the big quads
// and then the small ones).
template <bool kF32>
struct Route {
  using Bits = float;
  static constexpr int kStep = 8;
  static constexpr int kTileStepBytes = 1024;
};

template <>
struct Route<false> {
  using Bits = unsigned short;  // bf16 bits
  static constexpr int kStep = 16;
  static constexpr int kTileStepBytes = 512;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// `cvt.rna.tf32.f32` for finite v: add half of TF32's last place to the
// magnitude bits and cut the 13 low bits (nvcc expands the instruction
// itself into a longer sequence with NaN checks).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a,
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         const uint2& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The last slot swept: min(count, K - 1), or K - 1 without a count.
__device__ __forceinline__ int last_slot(const int* count, int K) {
  return count == nullptr ? K - 1 : min(max(*count, 0), K - 1);
}

// A fixed-order sum over the warp (lane 0's result is the same every run).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (v, a) <- the lexicographic minimum of (v, a) and (ov, oa).
__device__ __forceinline__ void take_min(float& v, int& a, float ov, int oa) {
  if (ov < v || (ov == v && oa < a)) {
    v = ov;
    a = oa;
  }
}

// One warp per center row of the swept tiles: the row into c_pad (zeros
// from D to cols) and its |c|^2 from the unsplit values; a slot past the
// last swept one gets |c|^2 = +inf, so its distance is +inf and never wins
// (every swept tile holds a swept slot).
template <bool kF32>
__global__ void __launch_bounds__(kThreads)
    prep_centers_kernel(const typename Route<kF32>::Bits* __restrict__ c,
                        typename Route<kF32>::Bits* __restrict__ c_pad,
                        float* __restrict__ c_sq,
                        const int* __restrict__ count, int K, int D,
                        int cols) {
  using Bits = typename Route<kF32>::Bits;
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int last = last_slot(count, K);
  if (row >= (last / kTileK + 1) * kTileK) return;
  const Bits* src = c + static_cast<long long>(row) * D;
  Bits* dst = c_pad + static_cast<long long>(row) * cols;
  float sq = 0.0f;
  for (int col = lane; col < cols; col += 32) {
    const Bits v = col < D ? src[col] : Bits(0);
    dst[col] = v;
    const float f = widen(v);
    sq = fmaf(f, f, sq);
  }
  sq = warp_sum(sq);
  if (lane == 0) c_sq[row] = row <= last ? sq : __int_as_float(0x7f800000);
}

// Panel `panel` of center tile `tile` (and the tile's |c|^2) into a stage.
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const unsigned char* c_pad,
                                           const float* c_sq, int tile,
                                           int panel, int c_row_bytes,
                                           int tid) {
  constexpr int kChunks = kPanelBytes / 16;
  const unsigned char* src = c_pad +
                             static_cast<long long>(tile) * kTileK *
                                 c_row_bytes +
                             panel * kPanelBytes;
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(stage));
#pragma unroll
  for (int j = 0; j < kTileK * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kChunks;
    const int ch = i % kChunks;
    cp_async16(dst + r * kRowBytes + ch * 16,
               src + static_cast<long long>(r) * c_row_bytes + ch * 16);
  }
  if (tid < kTileK / 4) {
    cp_async16(dst + kTileK * kRowBytes + tid * 16,
               c_sq + tile * kTileK + tid * 4);
  }
}

// One k-step's fragments for a warp: its MT point tiles of 16 (from the
// staged point tile, k-step `ks`) and its kNT center tiles of 8 (from the
// ring stage, panel k-step `kk`), and the products into `acc`.
template <bool kF32, int MT>
struct Frags;

template <int MT>
struct Frags<true, MT> {  // 3xTF32
  uint4 ab[MT], as[MT];
  uint32_t bb[kNT][2], bs[kNT][2];

  __device__ __forceinline__ void load(const unsigned char* xs, int ksteps,
                                       const uint2* cb, int mt0, int wn,
                                       int lane, int ks, int kk) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const uint4* at = reinterpret_cast<const uint4*>(
          xs + ((mt0 + mi) * ksteps + ks) * Route<true>::kTileStepBytes);
      ab[mi] = at[lane];
      as[mi] = at[32 + lane];
    }
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const uint2 v = cb[(wn + ni * 8 + g) * kRowU2 + kk * 4 + t];
      bb[ni][0] = to_tf32(__uint_as_float(v.x));
      bb[ni][1] = to_tf32(__uint_as_float(v.y));
      bs[ni][0] = to_tf32(__uint_as_float(v.x) - __uint_as_float(bb[ni][0]));
      bs[ni][1] = to_tf32(__uint_as_float(v.y) - __uint_as_float(bb[ni][1]));
    }
  }

  // The small terms first; MT * kNT independent accumulators between the
  // three products of one.
  __device__ __forceinline__ void mma(float (&acc)[MT][kNT][4]) const {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_tf32(acc[mi][ni], as[mi], bb[ni]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_tf32(acc[mi][ni], ab[mi], bs[ni]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_tf32(acc[mi][ni], ab[mi], bb[ni]);
  }
};

template <int MT>
struct Frags<false, MT> {  // one bf16 product
  uint4 a[MT];
  uint2 b[kNT];

  __device__ __forceinline__ void load(const unsigned char* xs, int ksteps,
                                       const uint2* cb, int mt0, int wn,
                                       int lane, int ks, int kk) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      a[mi] = reinterpret_cast<const uint4*>(
          xs + ((mt0 + mi) * ksteps + ks) *
                   Route<false>::kTileStepBytes)[lane];
    }
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      b[ni] = cb[(wn + ni * 8 + (lane >> 2)) * kRowU2 + kk * 4 + (lane & 3)];
    }
  }

  __device__ __forceinline__ void mma(float (&acc)[MT][kNT][4]) const {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
};

template <bool kF32, int MT>
__host__ __device__ constexpr int smem_bytes(int ksteps) {
  return kStages * kStageBytes +
         2 * MT * ksteps * Route<kF32>::kTileStepBytes +
         32 * MT * (4 + 8 * kWarpsN);
}

// Where point r, coordinate col of the tile goes in the staged tile, in
// bytes: the MMA's A fragment order.  f32 (per 8-coordinate k-step): lane
// g * 4 + t holds (row g, coordinate 2t), (g + 8, 2t), (g, 2t + 1),
// (g + 8, 2t + 1), the big quads of a tile's 32 lanes and then the small
// ones.  bf16 (per 16-coordinate k-step): lane g * 4 + t holds the pairs
// (g, 4t..4t+1), (g + 8, 4t..4t+1), (g, 4t+2..4t+3), (g + 8, 4t+2..4t+3).
template <bool kF32>
__device__ __forceinline__ int staged_at(int r, int col, int ksteps) {
  const int tile = (r >> 4) * ksteps;
  const int g = r & 7;
  const int hi = (r >> 3) & 1;
  if constexpr (kF32) {
    const int q = col & 7;
    const int word = (g * 4 + (q >> 1)) * 4 + (q & 1) * 2 + hi;
    return (tile + (col >> 3)) * Route<true>::kTileStepBytes + word * 4;
  } else {
    const int q = col & 15;
    const int word = (g * 4 + (q >> 2)) * 4 + ((q >> 1) & 1) * 2 + hi;
    return (tile + (col >> 4)) * Route<false>::kTileStepBytes + word * 4 +
           (q & 1) * 2;
  }
}

template <bool kF32, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    pairwise_argmin_kernel(const typename Route<kF32>::Bits* __restrict__ x,
                           const unsigned char* __restrict__ c_pad,
                           const float* __restrict__ c_sq,
                           const int* __restrict__ count,
                           float* __restrict__ min_out,
                           int* __restrict__ arg_out, int N, int K, int D,
                           int ksteps) {
  using Bits = typename Route<kF32>::Bits;
  constexpr int BM = 32 * MT;  // points per block
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* xs = smem + kStages * kStageBytes;
  float* x_sq = reinterpret_cast<float*>(
      xs + BM / 16 * ksteps * Route<kF32>::kTileStepBytes);
  float* red_v = x_sq + BM;
  int* red_i = reinterpret_cast<int*>(red_v + kWarpsN * BM);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // MMA group: row (A, C) or column (B)
  const int t = lane & 3;   // thread in group
  const int wm = (warp / kWarpsN) * MT * 16;  // the warp's first point
  const int wn = (warp % kWarpsN) * kNT * 8;  // and first center in a tile
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;

  const int last = last_slot(count, K);
  const int panels = (ksteps + kKSteps - 1) / kKSteps;
  const int steps = (last / kTileK + 1) * panels;
  const int c_row_bytes = panels * kPanelBytes;

  // Start the ring, then stage the point tile while the copies fly.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_stage(ring + s * kStageBytes, c_pad, c_sq, s / panels,
                 s % panels, c_row_bytes, tid);
    }
    cp_async_commit();
  }

  // Warp w stages rows w, w + 8, ...: a 32-coordinate chunk of all its
  // rows at a time, so their loads are in flight together.
  constexpr int kRowsPerWarp = BM / kWarps;
  float sq[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) sq[j] = 0.0f;
  for (int col = lane; col < ksteps * Route<kF32>::kStep; col += 32) {
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * kWarps;
      const long long row = row0 + r;
      const Bits v = (row < N && col < D) ? x[row * D + col] : Bits(0);
      const float f = widen(v);
      sq[j] = fmaf(f, f, sq[j]);
      unsigned char* at = xs + staged_at<kF32>(r, col, ksteps);
      if constexpr (kF32) {
        const uint32_t big = to_tf32(f);
        *reinterpret_cast<uint32_t*>(at) = big;
        *reinterpret_cast<uint32_t*>(at + 512) =
            to_tf32(f - __uint_as_float(big));
      } else {
        *reinterpret_cast<unsigned short*>(at) = v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const float total = warp_sum(sq[j]);
    if (lane == 0) x_sq[warp + j * kWarps] = total;
  }
  __syncthreads();

  float xsq[MT][2];
  float best[MT][2];
  int arg[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xsq[mi][h] = x_sq[wm + mi * 16 + h * 8 + g];
      best[mi][h] = __int_as_float(0x7f800000);  // +inf
      arg[mi][h] = 0;
    }

  float acc[MT][kNT][4];
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed; the previous one is free
    const int next = step + kStages - 1;
    if (next < steps) {
      load_stage(ring + (next % kStages) * kStageBytes, c_pad, c_sq,
                 next / panels, next % panels, c_row_bytes, tid);
    }
    cp_async_commit();

    const int tile = step / panels;
    const int panel = step - tile * panels;
    const unsigned char* stage = ring + (step % kStages) * kStageBytes;
    const uint2* cb = reinterpret_cast<const uint2*>(stage);
    if (panel == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    }

    // A full panel runs its 4 k-steps straight, each step's fragments read
    // while the previous step's products run; the tail panel steps alone.
    const int k0 = panel * kKSteps;
    const int k_here = min(kKSteps, ksteps - k0);
    Frags<kF32, MT> f[2];
    if (k_here == kKSteps) {
      f[0].load(xs, ksteps, cb, wm / 16, wn, lane, k0, 0);
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        if (kk + 1 < kKSteps) {
          f[(kk + 1) & 1].load(xs, ksteps, cb, wm / 16, wn, lane,
                               k0 + kk + 1, kk + 1);
        }
        f[kk & 1].mma(acc);
      }
    } else {
      for (int kk = 0; kk < k_here; ++kk) {
        f[0].load(xs, ksteps, cb, wm / 16, wn, lane, k0 + kk, kk);
        f[0].mma(acc);
      }
    }

    if (panel == panels - 1) {  // the tile's distances are complete
      const float* cs = reinterpret_cast<const float*>(stage +
                                                       kTileK * kRowBytes);
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // increasing center index
          const int col = wn + ni * 8 + 2 * t + e;
          const int idx = tile * kTileK + col;
          const float c2 = cs[col];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // fmaf: -2 acc is exact, so this is (|x|^2 - 2 x.c) + |c|^2.
              const float v = fmaxf(
                  fmaf(-2.0f, acc[mi][ni][2 * h + e], xsq[mi][h]) + c2, 0.0f);
              if (v < best[mi][h]) {
                best[mi][h] = v;
                arg[mi][h] = idx;
              }
            }
        }
    }
  }
  cp_async_wait<0>();

  // The 4 lanes of a group share a row; then the 4 warps along the centers.
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[mi][h];
      int a = arg[mi][h];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oa = __shfl_xor_sync(0xffffffffu, a, o);
        take_min(v, a, ov, oa);
      }
      if (t == 0) {
        const int r = (warp % kWarpsN) * BM + wm + mi * 16 + h * 8 + g;
        red_v[r] = v;
        red_i[r] = a;
      }
    }
  __syncthreads();
  for (int r = tid; r < BM; r += kThreads) {
    float v = red_v[r];
    int a = red_i[r];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) {
      take_min(v, a, red_v[w * BM + r], red_i[w * BM + r]);
    }
    if (row0 + r < N) {
      min_out[row0 + r] = v;
      arg_out[row0 + r] = a;
    }
  }
}

template <bool kF32, int MT>
cudaError_t launch_main(const typename Route<kF32>::Bits* x,
                        const void* c_pad, const float* c_sq,
                        const int* count, float* min_out, int* arg_out,
                        int N, int K, int D, int ksteps,
                        cudaStream_t stream) {
  const int bytes = smem_bytes<kF32, MT>(ksteps);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_argmin_kernel<kF32, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (N + 32 * MT - 1) / (32 * MT);
  pairwise_argmin_kernel<kF32, MT><<<blocks, kThreads, bytes, stream>>>(
      x, static_cast<const unsigned char*>(c_pad), c_sq, count, min_out,
      arg_out, N, K, D, ksteps);
  return cudaGetLastError();
}

template <bool kF32>
int launch(const void* x_raw, const void* c_raw, void* c_pad, float* c_sq,
           const int* count, float* min_out, int* arg_out, int N, int K,
           int D, void* stream_raw) {
  using Bits = typename Route<kF32>::Bits;
  const auto* x = static_cast<const Bits*>(x_raw);
  const auto* c = static_cast<const Bits*>(c_raw);
  auto stream = static_cast<cudaStream_t>(stream_raw);
  const int ksteps = (D + Route<kF32>::kStep - 1) / Route<kF32>::kStep;
  const int panels = (ksteps + kKSteps - 1) / kKSteps;
  const int cols = panels * kPanelBytes / static_cast<int>(sizeof(Bits));
  if (D < 1 || K < kTileK || K % kTileK != 0 ||
      smem_bytes<kF32, 1>(ksteps) > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prep_centers_kernel<kF32><<<K * 32 / kThreads, kThreads, 0, stream>>>(
      c, static_cast<Bits*>(c_pad), c_sq, count, K, D, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || N == 0) return static_cast<int>(err);
  // The tallest point tile that fits at this d.
  if (smem_bytes<kF32, 4>(ksteps) <= kSmemMax) {
    err = launch_main<kF32, 4>(x, c_pad, c_sq, count, min_out, arg_out, N,
                               K, D, ksteps, stream);
  } else if (smem_bytes<kF32, 2>(ksteps) <= kSmemMax) {
    err = launch_main<kF32, 2>(x, c_pad, c_sq, count, min_out, arg_out, N,
                               K, D, ksteps, stream);
  } else {
    err = launch_main<kF32, 1>(x, c_pad, c_sq, count, min_out, arg_out, N,
                               K, D, ksteps, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

// Layouts (row-major): x (N, D), c (K, D); scratch c_pad (K, cols) in the
// input type, cols = D rounded up to 128 bytes, and c_sq (K,) f32; outputs
// min_out (N,) f32 and arg_out (N,) int32.  Any N >= 0; K a positive
// multiple of 128; count null or one device int32.  Returns the launches'
// cudaError_t.
extern "C" int pairwise_argmin_f32_launch(const void* x, const void* c,
                                          void* c_pad, float* c_sq,
                                          const int* count, float* min_out,
                                          int* arg_out, int N, int K, int D,
                                          void* stream) {
  return launch<true>(x, c, c_pad, c_sq, count, min_out, arg_out, N, K, D,
                      stream);
}

extern "C" int pairwise_argmin_bf16_launch(const void* x, const void* c,
                                           void* c_pad, float* c_sq,
                                           const int* count, float* min_out,
                                           int* arg_out, int N, int K, int D,
                                           void* stream) {
  return launch<false>(x, c, c_pad, c_sq, count, min_out, arg_out, N, K, D,
                       stream);
}
