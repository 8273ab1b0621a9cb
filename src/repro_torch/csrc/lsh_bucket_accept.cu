// Monotone-LSH nearest-bucket query, with or without the Algorithm-4
// acceptance epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernels `lsh_bucket_accept_pallas` (`_kernel_accept`)
// and `lsh_bucket_min_pallas` (`_kernel`, the same query without the
// epilogue: d2_min only), both in src/repro/kernels/lsh_bucket_min.py.  Both
// run the same query kernel; the finishing kernel's flag `kAccept` adds the
// epilogue, and each has its own `extern "C"` entry.  Per candidate b over the live center slots
// c < count:
//
//   collide[b,c] = OR_l (qlo[l,b] == clo[l,c] && qhi[l,b] == chi[l,c])
//   d2_min[b]    = min(MISS, min over colliding c of
//                        max(|q|^2 - 2 q.c + |c|^2, 0))
//   p[b]         = mtd2[b] > 0 ? d2_min[b] / max(c2 * mtd2[b], 1e-30) : 0
//                  (kAccept only)
//
// Slots at or past `count` (not yet opened, or padding) are never read:
// the same function as the TPU kernel's penalty row (0 live, MISS dead,
// max()ed into every colliding distance), without building the row.
//
// What bounds it on the card: at the main path's sizes (B <= 512
// candidates, 1,000 slots of which about 500 are live on average, d = 74,
// L = 15) the inputs are well under a megabyte, and the work is B count L
// key compares plus 2d flops per colliding pair: neither the memory rate
// nor the f32 rate binds.  A launch is bounded by its latency, that is by
// how many dependent steps one thread takes and how much of the card the
// grid reaches.  So the design spreads both axes over the card and keeps
// each thread's chain short:
//   - the grid covers candidates x slot chunks: a block of 4 warps takes 4
//     candidates (one a warp) against one chunk of 32 x `per_lane` slots,
//     with `per_lane` in 1..8 chosen at launch so that the grid holds at
//     least 2 x 132 blocks where the live slots allow it; B = 32 and
//     B = 512 both spread over the SMs;
//   - lanes run over consecutive slots and the keys are (L, K) row-major,
//     so each of a lane's 2L key reads coalesces across the warp (the
//     block's 4 warps read the same lines, from L1); the candidate's 2L
//     keys, coordinates and |q|^2 sit in the warp's shared memory;
//   - the distance is computed only for colliding slots, by the whole warp
//     at once (lanes over d, coalesced, reduced by xor shuffles), one
//     colliding slot after another;
//   - a warp-level min ends a chunk and goes to a (chunks, B) scratch; a
//     second small kernel takes the min over the chunks in a fixed order
//     and applies the epilogue.  Both are deterministic: the same inputs
//     give bit-identical outputs from launch to launch.  With no live slot
//     only the second runs (every lane a miss).
// No library call computes q.c.
//
// A lane axis, as the JAX package's `jax.vmap` gives the Pallas call one:
// with `lanes` (one int64 lane id per candidate) candidate b reads the
// center slots of lane lanes[b], at `clo + lanes[b] * ck_lane_stride` and
// `c + lanes[b] * c_lane_stride`, so the candidates of every lane of a
// round go in one launch, each lane's block at its own size; all lanes
// have the same live count, since their centers open in lockstep.  Without
// `lanes` every candidate reads lane 0 (the one-lane call).  A candidate's
// result is the min over the same colliding slots with the same warp sums
// whatever the grid, so it is bit-identical to a launch of its lane alone.
//
// The distance keeps the reference's expanded form and its order,
// (|q|^2 - 2 q.c) + |c|^2; the sums over d run in another order than the
// reference's, so results agree to f32 rounding.  Any B and any K: both
// edges are guarded, so nothing is padded.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;         // candidates per block, one warp each
constexpr int kMaxPerLane = 8;    // slots per lane in a chunk, at most
constexpr int kTargetBlocks = 264;  // 2 x 132 SMs
constexpr float kMiss = 3.0e38f;  // LSH_MISS

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float accept_p(float d2, float m, float c2) {
  return m > 0.0f ? d2 / fmaxf(c2 * m, 1e-30f) : 0.0f;
}

// Block (chunk, group): candidates 4 group .. 4 group + 3 against slots
// [chunk * 32 * per_lane, ...) below `count`; each candidate's min over
// the colliding ones goes to partial[chunk * B + b].
__global__ void __launch_bounds__(kWarps * 32)
    lsh_query_kernel(const int* __restrict__ qlo, const int* __restrict__ qhi,
                     const float* __restrict__ q,
                     const long long* __restrict__ lanes,
                     const int* __restrict__ clo_all,
                     const int* __restrict__ chi_all,
                     const float* __restrict__ c_all,
                     long long ck_lane_stride, long long c_lane_stride,
                     float* __restrict__ partial, int L, int B, int K, int D,
                     int count, int per_lane) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y * kWarps + warp;
  if (b >= B) return;  // whole warps only; no block-wide barrier follows
  const long long lane_b = lanes != nullptr ? lanes[b] : 0LL;
  const int* __restrict__ clo = clo_all + lane_b * ck_lane_stride;
  const int* __restrict__ chi = chi_all + lane_b * ck_lane_stride;
  const float* __restrict__ c = c_all + lane_b * c_lane_stride;
  float* q_s = smem + warp * (D + 2 * L);               // [D]
  int* qk_s = reinterpret_cast<int*>(q_s + D);          // [2][L]

  float q_part = 0.0f;
  for (int e = lane; e < D; e += 32) {
    const float x = q[static_cast<long long>(b) * D + e];
    q_s[e] = x;
    q_part = fmaf(x, x, q_part);
  }
  for (int l = lane; l < L; l += 32) {
    qk_s[l] = qlo[static_cast<long long>(l) * B + b];
    qk_s[L + l] = qhi[static_cast<long long>(l) * B + b];
  }
  __syncwarp();
  const float q_sq = warp_sum(q_part);

  const int chunk0 = blockIdx.x * 32 * per_lane;
  float best = kMiss;
  for (int i = 0; i < per_lane; ++i) {
    const int base = chunk0 + 32 * i;
    if (base >= count) break;
    const int slot = base + lane;
    bool collide = false;
    if (slot < count) {
      for (int l = 0; l < L; ++l) {
        const long long at = static_cast<long long>(l) * K + slot;
        collide |= (__ldg(clo + at) == qk_s[l]) &
                   (__ldg(chi + at) == qk_s[L + l]);
      }
    }
    unsigned hits = __ballot_sync(0xffffffffu, collide);
    while (hits) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const float* cj = c + static_cast<long long>(base + j) * D;
      float dot = 0.0f;
      float c_sq = 0.0f;
      for (int e = lane; e < D; e += 32) {
        const float x = __ldg(cj + e);
        dot = fmaf(q_s[e], x, dot);
        c_sq = fmaf(x, x, c_sq);
      }
      dot = warp_sum(dot);
      c_sq = warp_sum(c_sq);
      best = fminf(best, fmaxf((q_sq - 2.0f * dot) + c_sq, 0.0f));
    }
  }
  // Every lane holds the same best: the distances were warp-wide sums.
  if (lane == 0) partial[static_cast<long long>(blockIdx.x) * B + b] = best;
}

// One thread per candidate: the min over the chunks' partial mins, in
// chunk order, then the epilogue.  chunks == 0: every lane misses.
template <bool kAccept>
__global__ void lsh_finish_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ mtd2,
                                  float* __restrict__ d2_out,
                                  float* __restrict__ p_out, int B, int chunks,
                                  float c2) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float best = kMiss;
  for (int ch = 0; ch < chunks; ++ch)
    best = fminf(best, partial[static_cast<long long>(ch) * B + b]);
  d2_out[b] = best;
  if (kAccept) p_out[b] = accept_p(best, mtd2[b], c2);
}

// Slots per lane: the most (up to 8) that still leaves 264 blocks; 1 when
// even that cannot reach it.
int per_lane_for(int B, int count) {
  const long long groups = (B + kWarps - 1) / kWarps;
  int per = kMaxPerLane;
  while (per > 1) {
    const long long chunks = (count + 32LL * per - 1) / (32LL * per);
    if (chunks * groups >= kTargetBlocks) break;
    per >>= 1;
  }
  return per;
}

// The number of slot chunks of a launch at (B, count), at most
// ceil(count / 32): `partial` holds chunks x B floats.
int num_chunks(int B, int count) {
  if (B <= 0 || count <= 0) return 0;
  const int per = per_lane_for(B, count);
  return (count + 32 * per - 1) / (32 * per);
}

template <bool kAccept>
int launch(const int* qlo, const int* qhi, const float* q,
           const long long* lanes, const int* clo, const int* chi,
           const float* c, long long ck_lane_stride, long long c_lane_stride,
           const float* mtd2, float* partial, float* d2_out, float* p_out,
           int L, int B, int K, int D, int count, float c2, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = num_chunks(B, count);
  if (chunks >= 1) {
    const size_t smem = sizeof(float) * kWarps * (D + 2 * L);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          lsh_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(chunks, (B + kWarps - 1) / kWarps);
    lsh_query_kernel<<<grid, kWarps * 32, smem, st>>>(
        qlo, qhi, q, lanes, clo, chi, c, ck_lane_stride, c_lane_stride,
        partial, L, B, K, D, count, per_lane_for(B, count));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lsh_finish_kernel<kAccept><<<(B + 127) / 128, 128, 0, st>>>(
      partial, mtd2, d2_out, p_out, B, chunks, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Layouts (row-major): qlo/qhi (L, B), q (B, D), lanes (B,) int64 or null,
// lane l's clo/chi (L, K) at l * ck_lane_stride and c (K, D) at
// l * c_lane_stride, mtd2 (B,); outputs d2_out, p_out (B,); partial,
// scratch of at least ceil(count / 32) x B floats.  0 <= count <= K (the
// Python binding checks it).
// Each returns the cudaError_t of the attribute call or of a launch.
extern "C" int lsh_bucket_accept_launch(
    const int* qlo, const int* qhi, const float* q, const long long* lanes,
    const int* clo, const int* chi, const float* c, long long ck_lane_stride,
    long long c_lane_stride, const float* mtd2, float* partial,
    float* d2_out, float* p_out, int L, int B, int K, int D, int count,
    float c2, void* stream) {
  return launch<true>(qlo, qhi, q, lanes, clo, chi, c, ck_lane_stride,
                      c_lane_stride, mtd2, partial, d2_out, p_out, L, B, K,
                      D, count, c2, stream);
}

// The query alone (no mtd2, no p) of one lane: d2_out (B,).
extern "C" int lsh_bucket_min_launch(const int* qlo, const int* qhi,
                                     const float* q, const int* clo,
                                     const int* chi, const float* c,
                                     float* partial, float* d2_out, int L,
                                     int B, int K, int D, int count,
                                     void* stream) {
  return launch<false>(qlo, qhi, q, nullptr, clo, chi, c, 0, 0, nullptr,
                       partial, d2_out, nullptr, L, B, K, D, count, 0.0f,
                       stream);
}
