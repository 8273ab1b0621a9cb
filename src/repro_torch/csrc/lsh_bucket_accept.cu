// Monotone-LSH nearest-bucket query, with or without the Algorithm-4
// acceptance epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernels `lsh_bucket_accept_pallas` (`_kernel_accept`)
// and `lsh_bucket_min_pallas` (`_kernel`, the same query without the
// epilogue: d2_min only), both in src/repro/kernels/lsh_bucket_min.py.  One
// kernel template serves both: `kAccept` adds the epilogue, and each has
// its own `extern "C"` entry.  Per candidate b over the center slots c:
//
//   collide[b,c] = OR_l (qlo[l,b] == clo[l,c] && qhi[l,b] == chi[l,c])
//   val[b,c]     = max(collide ? max(|q|^2 - 2 q.c + |c|^2, 0) : MISS,
//                      penalty[c])
//   d2_min[b]    = min(MISS, min_c val[b,c])
//   p[b]         = mtd2[b] > 0 ? d2_min[b] / max(c2 * mtd2[b], 1e-30) : 0
//                  (kAccept only)
//
// The penalty row is 0 for live center slots and MISS for slots not yet
// opened or padded, so a collision with a dead slot turns into a miss.
//
// What bounds it on the card: at the main path's sizes (B <= 512
// candidates, K = 1024 slots, d = 74, L = 15) the inputs are well under a
// megabyte and the work is O(B K L) key compares plus 2d flops for each
// colliding pair, so neither the memory rate nor the f32 rate binds: a
// launch is bounded by its latency and by how few blocks B candidates make.
// The design is the simple one: one block per 8 candidates (one warp
// each), a loop over tiles of 32 center slots staged in shared memory
// (coordinates with an odd row stride, so the 32 lanes read 32 different
// banks), the key compare as an OR over the L tables, and the distance as
// an f32 FMA loop over d, evaluated only for the slots whose keys collide:
// a slot that shares no bucket yields MISS whatever its distance, as the
// reference's where() does.  A warp-level min ends the sweep and lane 0
// writes d2_min and, with kAccept, the acceptance probability.  No
// library call computes q.c.
//
// The distance keeps the reference's expanded form and its order,
// (|q|^2 - 2 q.c) + |c|^2; the sums over d run in another order than the
// reference's, so results agree to f32 rounding (exactly for small
// integer-valued coordinates).
//
// The wrappers (`ops.lsh_bucket_accept`, `ops.lsh_bucket_min`) pad B to a
// multiple of kWarps and K to a multiple of kTile, so the kernel has no
// ragged edge.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;         // candidates per block, one warp each
constexpr int kTile = 32;         // center slots per shared-memory tile
constexpr float kMiss = 3.0e38f;  // LSH_MISS

template <bool kAccept>
__global__ void lsh_query_kernel(
    const int* __restrict__ qlo, const int* __restrict__ qhi,
    const float* __restrict__ q, const int* __restrict__ clo,
    const int* __restrict__ chi, const float* __restrict__ c,
    const float* __restrict__ penalty, const float* __restrict__ mtd2,
    float* __restrict__ d2_out, float* __restrict__ p_out, int L, int B,
    int K, int D, float c2) {
  extern __shared__ float smem[];
  const int dp = D | 1;                       // odd row stride: no conflicts
  float* c_s = smem;                          // [kTile][dp]
  float* pen_s = c_s + kTile * dp;            // [kTile]
  float* q_s = pen_s + kTile;                 // [kWarps][D]
  int* ck_s = reinterpret_cast<int*>(q_s + kWarps * D);  // [2][L][kTile]
  int* qk_s = ck_s + 2 * L * kTile;           // [kWarps][2][L]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;   // B % kWarps == 0

  // Stage this warp's candidate: coordinates, |q|^2 and bucket keys.
  float q_part = 0.0f;
  for (int e = lane; e < D; e += 32) {
    const float v = q[static_cast<long long>(b) * D + e];
    q_s[warp * D + e] = v;
    q_part = fmaf(v, v, q_part);
  }
  for (int l = lane; l < L; l += 32) {
    qk_s[(warp * 2 + 0) * L + l] = qlo[static_cast<long long>(l) * B + b];
    qk_s[(warp * 2 + 1) * L + l] = qhi[static_cast<long long>(l) * B + b];
  }
  for (int o = 16; o > 0; o >>= 1)
    q_part += __shfl_xor_sync(0xffffffffu, q_part, o);
  const float q_sq = q_part;

  float best = kMiss;
  for (int k0 = 0; k0 < K; k0 += kTile) {     // K % kTile == 0
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
      const int j = idx / D;
      const int e = idx - j * D;
      c_s[j * dp + e] = c[static_cast<long long>(k0 + j) * D + e];
    }
    for (int idx = threadIdx.x; idx < 2 * L * kTile; idx += blockDim.x) {
      const int plane = idx / (L * kTile);
      const int rest = idx - plane * L * kTile;
      const int l = rest / kTile;
      const int j = rest - l * kTile;
      const int* keys = plane == 0 ? clo : chi;
      ck_s[idx] = keys[static_cast<long long>(l) * K + k0 + j];
    }
    if (threadIdx.x < kTile) pen_s[threadIdx.x] = penalty[k0 + threadIdx.x];
    __syncthreads();

    const int* my_qk = qk_s + warp * 2 * L;
    bool collide = false;
    for (int l = 0; l < L; ++l) {
      collide |= (my_qk[l] == ck_s[l * kTile + lane]) &
                 (my_qk[L + l] == ck_s[(L + l) * kTile + lane]);
    }
    float val = kMiss;
    if (collide) {
      const float* cj = c_s + lane * dp;
      const float* qw = q_s + warp * D;
      float dot = 0.0f;
      float c_sq = 0.0f;
      for (int e = 0; e < D; ++e) {
        dot = fmaf(qw[e], cj[e], dot);
        c_sq = fmaf(cj[e], cj[e], c_sq);
      }
      val = fmaxf((q_sq - 2.0f * dot) + c_sq, 0.0f);
    }
    best = fminf(best, fmaxf(val, pen_s[lane]));
  }

  for (int o = 16; o > 0; o >>= 1)
    best = fminf(best, __shfl_xor_sync(0xffffffffu, best, o));
  if (lane == 0) {
    d2_out[b] = best;
    if (kAccept) {
      const float m = mtd2[b];
      p_out[b] = m > 0.0f ? best / fmaxf(c2 * m, 1e-30f) : 0.0f;
    }
  }
}

template <bool kAccept>
int launch(const int* qlo, const int* qhi, const float* q, const int* clo,
           const int* chi, const float* c, const float* penalty,
           const float* mtd2, float* d2_out, float* p_out, int L, int B,
           int K, int D, float c2, void* stream) {
  const int dp = D | 1;
  const size_t smem = sizeof(float) * (kTile * dp + kTile + kWarps * D) +
                      sizeof(int) * (2 * L * kTile + kWarps * 2 * L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsh_query_kernel<kAccept>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = B / kWarps;
  if (blocks > 0) {
    lsh_query_kernel<kAccept><<<blocks, kWarps * 32, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        qlo, qhi, q, clo, chi, c, penalty, mtd2, d2_out, p_out, L, B, K, D,
        c2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Layouts (row-major): qlo/qhi (L, B), q (B, D), clo/chi (L, K), c (K, D),
// penalty (K,), mtd2 (B,); outputs d2_out, p_out (B,).  B % 8 == 0 and
// K % 32 == 0 (the Python binding checks both).  Each returns the
// cudaError_t of the attribute call or of the launch.
extern "C" int lsh_bucket_accept_launch(
    const int* qlo, const int* qhi, const float* q, const int* clo,
    const int* chi, const float* c, const float* penalty, const float* mtd2,
    float* d2_out, float* p_out, int L, int B, int K, int D, float c2,
    void* stream) {
  return launch<true>(qlo, qhi, q, clo, chi, c, penalty, mtd2, d2_out,
                      p_out, L, B, K, D, c2, stream);
}

// The query alone (no mtd2, no p): d2_out (B,).
extern "C" int lsh_bucket_min_launch(const int* qlo, const int* qhi,
                                     const float* q, const int* clo,
                                     const int* chi, const float* c,
                                     const float* penalty, float* d2_out,
                                     int L, int B, int K, int D,
                                     void* stream) {
  return launch<false>(qlo, qhi, q, clo, chi, c, penalty, nullptr, d2_out,
                       nullptr, L, B, K, D, 0.0f, stream);
}
