// Fused windowed descriptor match for Hopper (sm_90a).
//
// Replaces orb_slam3_comments_ghr_tpu/ops/pallas_match.py:window_match_tpu
// (kernel body `_kernel`). Per query row i (a local map point) and every
// target j (a frame feature): Hamming distance of the packed 256-bit
// descriptors, masked by |du| < r_i, |dv| < r_i, lo_i <= level_j <= hi_i and
// valid_j > 0 (f32, strict, as the TPU kernel compares); out: the best
// distance, its argmin (lowest index on ties) and the second best (the min
// over the other columns). A row without a candidate gives idx 0 and
// best = second = 1<<20.
//
// What bounds it on this card: the work is N x M x 8 XOR + popcount words
// (4096 x 1024 x 32 B on the tracking path) plus reading the whole target
// block once per group of query rows, from L2. No (N, M) matrix is written:
// the TPU unpacked descriptors to +-1 int8 for its matrix unit; here the
// packed words go straight to __popc, the window test runs first so most
// pairs cost four shared-memory reads and compares, and the top-2 lives in
// registers.
//
// Design: one warp per query row, WARPS rows per block. The block stages
// targets through shared memory in chunks of TM (descriptors transposed to
// [word][target] so a warp's 32 lanes read 32 consecutive words, free of
// bank conflicts), so any M fits. Each lane walks its strided targets in
// increasing index order and keeps a running (best, idx, second); a butterfly
// of warp shuffles then merges the 32 partial results: the smaller best wins
// and the lower index wins a tie, and the new second is
// min(loser.best, winner.second). Ragged N and M are masked in the kernel.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;      // query rows per block
constexpr int TM = 512;       // targets staged per chunk (24 KB of shared memory)
constexpr int BIG = 1 << 20;  // empty-row sentinel, as the TPU kernel's BIG

__device__ __forceinline__ void merge(int& best, int& idx, int& second,
                                      int o_best, int o_idx, int o_second) {
  const bool other_wins = o_best < best || (o_best == best && o_idx < idx);
  if (other_wins) {
    second = min(best, o_second);
    best = o_best;
    idx = o_idx;
  } else {
    second = min(second, o_best);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
window_match_kernel(const uint32_t* __restrict__ qdesc, const float* __restrict__ q_uv,
                    const float* __restrict__ q_radius, const float* __restrict__ q_lo,
                    const float* __restrict__ q_hi, const uint32_t* __restrict__ tdesc,
                    const float* __restrict__ t_xy, const float* __restrict__ t_level,
                    const float* __restrict__ t_valid, int n, int m,
                    int* __restrict__ out_idx, int* __restrict__ out_best,
                    int* __restrict__ out_second) {
  __shared__ uint32_t s_desc[8][TM];
  __shared__ float s_u[TM], s_v[TM], s_lvl[TM], s_ok[TM];

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool active = row < n;

  uint32_t q[8];
  float qu = 0.f, qv = 0.f, r = -1.f, lo = 0.f, hi = 0.f;
  if (active) {
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = qdesc[(size_t)row * 8 + k];
    qu = q_uv[2 * (size_t)row];
    qv = q_uv[2 * (size_t)row + 1];
    r = q_radius[row];
    lo = q_lo[row];
    hi = q_hi[row];
  }
  // |d| < r fails for every target when r <= 0 (or NaN): skip the row's work
  const bool searching = active && r > 0.f;

  int best = BIG, idx = INT_MAX, second = BIG;
  for (int base = 0; base < m; base += TM) {
    const int cnt = min(TM, m - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < cnt * 8; e += blockDim.x)
      s_desc[e & 7][e >> 3] = tdesc[(size_t)base * 8 + e];
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      s_u[j] = t_xy[2 * (size_t)(base + j)];
      s_v[j] = t_xy[2 * (size_t)(base + j) + 1];
      s_lvl[j] = t_level[base + j];
      s_ok[j] = t_valid[base + j];
    }
    __syncthreads();
    if (!searching) continue;
    for (int j = lane; j < cnt; j += 32) {
      const float lv = s_lvl[j];
      if (fabsf(qu - s_u[j]) < r && fabsf(qv - s_v[j]) < r && lv >= lo && lv <= hi &&
          s_ok[j] > 0.f) {
        int d = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) d += __popc(q[k] ^ s_desc[k][j]);
        // targets arrive in increasing index order: a tie keeps the lower idx
        if (d < best) {
          second = best;
          best = d;
          idx = base + j;
        } else if (d < second) {
          second = d;
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o_best = __shfl_xor_sync(0xffffffffu, best, off);
    const int o_idx = __shfl_xor_sync(0xffffffffu, idx, off);
    const int o_second = __shfl_xor_sync(0xffffffffu, second, off);
    merge(best, idx, second, o_best, o_idx, o_second);
  }
  if (active && lane == 0) {
    if (best >= BIG) idx = 0;  // argmin over an all-BIG row is column 0
    out_idx[row] = idx;
    out_best[row] = best;
    out_second[row] = second;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch never
// runs, and a later synchronize would not report it.
extern "C" int window_match_launch(const void* qdesc, const void* q_uv, const void* q_radius,
                                   const void* q_lo, const void* q_hi, const void* tdesc,
                                   const void* t_xy, const void* t_level, const void* t_valid,
                                   int n, int m, void* out_idx, void* out_best,
                                   void* out_second, void* stream) {
  if (n > 0) {
    const dim3 grid((n + WARPS - 1) / WARPS);
    window_match_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(qdesc), static_cast<const float*>(q_uv),
        static_cast<const float*>(q_radius), static_cast<const float*>(q_lo),
        static_cast<const float*>(q_hi), static_cast<const uint32_t*>(tdesc),
        static_cast<const float*>(t_xy), static_cast<const float*>(t_level),
        static_cast<const float*>(t_valid), n, m, static_cast<int*>(out_idx),
        static_cast<int*>(out_best), static_cast<int*>(out_second));
  }
  return static_cast<int>(cudaGetLastError());
}
