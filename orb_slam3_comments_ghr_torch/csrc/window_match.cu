// Fused windowed descriptor match for Hopper (sm_90a).
//
// Replaces orb_slam3_comments_ghr_tpu/ops/pallas_match.py:window_match_tpu
// (kernel body `_kernel`). Per query row i (a local map point) and every
// target j (a frame feature): Hamming distance of the packed 256-bit
// descriptors, masked by |du| < r_i, |dv| < r_i, lo_i <= level_j <= hi_i and
// valid_j > 0 (f32, strict, as the TPU kernel compares); out: the best
// distance, its argmin (lowest index on ties) and the second best (the min
// over the other columns, so it equals `best` when two targets tie). A row
// without a candidate gives idx 0 and best = second = 1<<20.
//
// What bounds it on this card. The function itself needs little: ~0.3 MB
// of inputs and outputs at 4096 x 1024, ~0.1 us at HBM rate, and 8 XOR +
// POPC + add for each pair inside a window (a spatial index, such as the
// grid below, tests no pair far apart). No (N, M) matrix is written. A
// launch pays latency instead: the launch itself, two global-memory round
// trips that cannot overlap (the query rows before the vote, the targets
// after it), and the dependent steps of building a grid and searching it,
// each issued by all warps of one SM. The design keeps each of them to one
// pass:
//
// 1. Block vote first. A block owns a contiguous run of rows. All of its
//    query rows are loaded at once into registers (a store to shared memory
//    would wait for its load), and the block votes with __syncthreads_or
//    whether any row searches (r > 0, u and v finite). A block with no such
//    row writes its empty rows and returns without reading a target. The
//    callers pad the local map to 4096 rows with radius -1 and keep the live
//    points at the front, so most blocks of a SLAM frame leave here.
// 2. Few, fat blocks. 16 warps; the launcher sizes the grid to about two
//    blocks per SM (8 to 128 rows each), so the target set is staged about
//    as many times as there are blocks in flight.
// 3. Staging without bank conflicts, asynchronously. Each thread loads its
//    targets' u, v, level and valid into registers, which the bounding box,
//    the sort and the scatter all read. Once those loads have landed, the
//    descriptors are copied as they lie, (M, 8) words, 32 B per target, by
//    one TMA bulk copy (cp.async.bulk, completing on an mbarrier) that one
//    thread issues; a pointer that is not 16-B aligned, e.g. a view with an
//    offset, goes by 4-B cp.async instead (handled here, not refused by the
//    wrapper). So they do not share the SM's memory path with the loads the
//    bounding box waits for, cost no thread an instruction per word, and
//    arrive during the sort. The copy writes the words in order, no bank
//    conflicts; a lane reads a target back as two 128-bit loads. The packed
//    records (u, v, level, valid) go into shared memory
//    as one float4 each, by 16-B stores, in the grid's order. A stage holds
//    TM = 1024 targets (53 KB) in dynamic shared memory, all of M =
//    n_features in one chunk, with room for two blocks per SM; larger M is
//    processed in chunks. A larger stage only sizes the per-thread arrays
//    for targets that no caller has.
// 4. A grid in shared memory prunes the targets. The grid covers the
//    bounding box of the chunk's live targets (finite u and v, valid > 0;
//    no other target can pass the test, so none goes into a cell), found by
//    a block reduction, with about one live target per cell (at most CELLS
//    cells). A counting sort (shared atomics, whose return values rank each
//    target in its cell, and a block scan) orders the targets by cell,
//    row-major, so the cells of one grid row in a window are one contiguous
//    run. Each warp then visits, per query row, only the cells that its
//    window overlaps, and splits each run across its lanes. Every candidate
//    still goes through the exact strict f32 test. The cell of a
//    coordinate, floor((x - x0) * inv) clamped to the grid with IEEE
//    round-to-nearest operations, is a non-decreasing function of x for any
//    positive finite inv; the query's cell range is that function at u - R
//    and u + R, where R is r rounded up by 2^-21 of itself and the sum and
//    difference are rounded outwards. A target passes |u - x| < r in f32
//    only if the real |u - x| < r (1 + 2^-23), so x lies in [u - R, u + R]
//    and its cell in the range: the grid removes only targets that cannot
//    pass, at any magnitude, with no extra cells of widening. r = 1e30
//    covers every cell.
// 5. A merge that does not depend on visiting order. Cells are visited out
//    of index order, and within a cell the order is that of the atomics, so
//    a lane takes (d, j) when d < best or (d == best and j < idx), and a
//    tie that does not win still lowers `second` to d. Each target goes to
//    one lane, so the warp's merge is three __reduce_min_sync: the best, the
//    lowest idx at the best, and the second as the winning lane's second
//    and every other lane's best; a row's results of several chunks merge
//    by the lane rule. The outputs are a function of the candidate set
//    alone: two launches give the same bits, idx included, and a launch can
//    be captured in a CUDA graph.
//
// Tensor cores were considered and not taken. mma.sync's b1 AND+POPC form
// (Hamming = popc(a) + popc(b) - 2 popc(a & b)), or a +-1 int8 product as
// the TPU ran, computes all N x M distances in ~0.1 us of tensor time at
// 4096 x 1024, but leaves the dense mask and the top-2 over 4M entries to
// the CUDA cores, which is the work the grid removes. A tracking or fuse
// window (r = 2.5-14 px on a 752x480 frame) holds one or two of the 1024
// features; only the 100-px box of the two-view init holds ~20 of them.

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 16;               // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = WARPS * 8;     // rows a block owns, at most
constexpr int MIN_ROWS = 8;             // and at least (while N has them)
constexpr int BLOCKS_PER_SM = 2;        // resident at once, and the grid's target size
constexpr int TM = 1024;                // targets staged per chunk: all of M = n_features
constexpr int CELLS = 1024;             // grid cells, at most
constexpr int CELLS_PER_THREAD = CELLS / THREADS;
constexpr int TARGETS_PER_THREAD = TM / THREADS;
constexpr int QWORDS_PER_THREAD = MAX_ROWS * 8 / THREADS;
constexpr int BYTES_PER_TARGET = 32 + 16 + 4;  // descriptor, packed record, index
constexpr int BIG = 1 << 20;            // empty-row sentinel, as the TPU kernel's BIG
static_assert(CELLS % THREADS == 0, "the scan gives each thread whole cells");
static_assert(TM % THREADS == 0 && MAX_ROWS <= THREADS && MAX_ROWS * 8 % THREADS == 0,
              "a thread per staged slot, row and query word");

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

__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

__device__ __forceinline__ bool searching(float u, float v, float r) {
  // |u - x| < r fails for every target when r <= 0 or NaN, or u or v is not finite
  return r > 0.f && finite(u) && finite(v);
}

// The grid cell of coordinate x along one axis: non-decreasing in x (IEEE
// round-to-nearest subtract and multiply, never contracted into an FMA).
// x may be +-inf; `inv` is finite and positive, so no NaN arises.
__device__ __forceinline__ int cell_of(float x, float x0, float inv, int g) {
  const float t = floorf(__fmul_rn(__fsub_rn(x, x0), inv));
  return static_cast<int>(fminf(fmaxf(t, 0.f), static_cast<float>(g - 1)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-B
// aligned) from global to shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t d = smem_addr(dst), b = smem_addr(bar);
  // order this block's earlier reads of dst before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

struct Grid {
  float x0, y0, inv_x, inv_y;
  int gx, gy, live;
};

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
window_match_kernel(const uint32_t* __restrict__ qdesc, const float* __restrict__ q_uv,
                    const float* __restrict__ q_radius, const float* __restrict__ q_lo,
                    const float* __restrict__ q_hi, const uint32_t* __restrict__ tdesc,
                    const float* __restrict__ t_xy, const float* __restrict__ t_level,
                    const float* __restrict__ t_valid, int n, int m, int rows_per_block,
                    int* __restrict__ out_idx, int* __restrict__ out_best,
                    int* __restrict__ out_second) {
  extern __shared__ uint4 smem[];
  const int tm = min(m, TM);
  uint4* s_desc = smem;                                       // [tm][2] uint4
  float4* s_rec = reinterpret_cast<float4*>(smem + 2 * tm);   // [tm], in cell order
  int* s_idx = reinterpret_cast<int*>(s_rec + tm);            // [tm], target of each record
  __shared__ int s_start[CELLS + 1];  // counts, then each cell's first record
  __shared__ float4 s_red[WARPS];     // per-warp bounding boxes
  __shared__ int s_red_n[WARPS];      // per-warp live counts, then scan sums
  __shared__ Grid s_grid;
  __shared__ uint64_t s_bar;           // the descriptors' bulk copy completes here
  __shared__ __align__(16) uint32_t s_qd[MAX_ROWS * 8];  // the block's query rows
  __shared__ float4 s_q[MAX_ROWS];         // u, v, r, lo
  __shared__ float s_qhi[MAX_ROWS];
  __shared__ int s_best[MAX_ROWS], s_idx_row[MAX_ROWS], s_second[MAX_ROWS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);

  // 1. the block's query rows, all loads in flight at once into registers
  // (a store to shared memory would wait for its load), and the vote: every
  // thread reaches it, a dead block reads no target
  uint32_t qw[QWORDS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < QWORDS_PER_THREAD; ++i) {
    const int e = tid + i * THREADS;
    qw[i] = e < rows * 8 ? qdesc[(size_t)row0 * 8 + e] : 0u;
  }
  float u = 0.f, v = 0.f, r = -1.f, lo = 0.f, hi = 0.f;
  if (tid < rows) {
    const int row = row0 + tid;
    u = q_uv[2 * (size_t)row];
    v = q_uv[2 * (size_t)row + 1];
    r = q_radius[row];
    lo = q_lo[row];
    hi = q_hi[row];
  }
  if (!__syncthreads_or(tid < rows && searching(u, v, r))) {
    if (tid < rows) {
      out_idx[row0 + tid] = 0;
      out_best[row0 + tid] = BIG;
      out_second[row0 + tid] = BIG;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < QWORDS_PER_THREAD; ++i) s_qd[tid + i * THREADS] = qw[i];
  if (tid < rows) {
    s_q[tid] = make_float4(u, v, r, lo);
    s_qhi[tid] = hi;
    s_best[tid] = BIG;
    s_idx_row[tid] = INT_MAX;
    s_second[tid] = BIG;
  }
  const bool desc16 = (reinterpret_cast<uintptr_t>(tdesc) & 15) == 0;
  if (desc16 && tid == 0) bar_init(&s_bar);
  uint32_t parity = 0;  // of the bulk copy's barrier phase, one phase per chunk

  for (int base = 0; base < m; base += TM) {
    const int cnt = min(TM, m - base);
    __syncthreads();  // the previous chunk is no longer read

    // 3. this thread's targets (j = tid + t * THREADS), held in registers
    // from here to the scatter; the bounding box and count of the live ones
    float tx[TARGETS_PER_THREAD], ty[TARGETS_PER_THREAD], tl[TARGETS_PER_THREAD],
        tv[TARGETS_PER_THREAD];
    bool live[TARGETS_PER_THREAD];
#pragma unroll
    for (int t = 0; t < TARGETS_PER_THREAD; ++t) {
      const int j = tid + t * THREADS;
      tx[t] = ty[t] = tl[t] = tv[t] = 0.f;
      if (j < cnt) {
        const size_t g = base + j;
        tx[t] = t_xy[2 * g];
        ty[t] = t_xy[2 * g + 1];
        tl[t] = t_level[g];
        tv[t] = t_valid[g];
      }
    }
    for (int c = tid; c <= CELLS; c += THREADS) s_start[c] = 0;
    float x_lo = INFINITY, x_hi = -INFINITY, y_lo = INFINITY, y_hi = -INFINITY;
    int n_live = 0;
#pragma unroll
    for (int t = 0; t < TARGETS_PER_THREAD; ++t) {
      live[t] = tid + t * THREADS < cnt && finite(tx[t]) && finite(ty[t]) && tv[t] > 0.f;
      if (live[t]) {
        x_lo = fminf(x_lo, tx[t]);
        x_hi = fmaxf(x_hi, tx[t]);
        y_lo = fminf(y_lo, ty[t]);
        y_hi = fmaxf(y_hi, ty[t]);
        ++n_live;
      }
    }
    // then the descriptors as they lie, asynchronously: issued once the
    // loads above have landed, so that those do not share the SM's memory
    // path with 32 B per target; they arrive during the sort below. One
    // thread issues one TMA bulk copy; a pointer that is not 16-B aligned
    // goes by 4-B cp.async
    if (desc16) {
      if (tid == 0) bulk_copy(s_desc, tdesc + (size_t)base * 8, cnt * 32u, &s_bar);
    } else {
      uint32_t* dst = reinterpret_cast<uint32_t*>(s_desc);
      const uint32_t* src = tdesc + (size_t)base * 8;
      for (int e = tid; e < cnt * 8; e += THREADS) cp_async4(dst + e, src + e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x_lo = fminf(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, off));
      x_hi = fmaxf(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, off));
      y_lo = fminf(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, off));
      y_hi = fmaxf(y_hi, __shfl_xor_sync(0xffffffffu, y_hi, off));
      n_live += __shfl_xor_sync(0xffffffffu, n_live, off);
    }
    if (lane == 0) {
      s_red[warp] = make_float4(x_lo, x_hi, y_lo, y_hi);
      s_red_n[warp] = n_live;
    }
    __syncthreads();
    if (warp == 0) {
      const float4 b = lane < WARPS ? s_red[lane] : make_float4(INFINITY, -INFINITY, INFINITY,
                                                                -INFINITY);
      x_lo = b.x;
      x_hi = b.y;
      y_lo = b.z;
      y_hi = b.w;
      n_live = lane < WARPS ? s_red_n[lane] : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x_lo = fminf(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, off));
        x_hi = fmaxf(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, off));
        y_lo = fminf(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, off));
        y_hi = fmaxf(y_hi, __shfl_xor_sync(0xffffffffu, y_hi, off));
        n_live += __shfl_xor_sync(0xffffffffu, n_live, off);
      }
      if (lane == 0) {
        // about one live target per cell, cells about square
        const int k = max(1, min(CELLS, n_live));
        const float w = x_hi - x_lo, h = y_hi - y_lo;  // >= 0, or +inf
        int gx = 1, gy = 1;
        // fast approximate division and square root: any positive finite
        // inverse cell size keeps cell_of monotone (fmaxf maps a 0 or NaN
        // quotient to 1e-30)
        if (w > 0.f && h > 0.f) {
          const float a = static_cast<float>(k) * __fdividef(w, h);
          const float fx = fminf(fmaxf(rintf(a * rsqrtf(a)), 1.f), static_cast<float>(k));
          gx = static_cast<int>(fx);
          gy = max(1, k / gx);
        } else if (w > 0.f) {
          gx = k;
        } else if (h > 0.f) {
          gy = k;
        }
        Grid grid;
        grid.x0 = x_lo;
        grid.y0 = y_lo;
        grid.inv_x =
            w > 0.f ? fminf(fmaxf(__fdividef(static_cast<float>(gx), w), 1e-30f), 1e30f) : 1.f;
        grid.inv_y =
            h > 0.f ? fminf(fmaxf(__fdividef(static_cast<float>(gy), h), 1e-30f), 1e30f) : 1.f;
        grid.gx = gx;
        grid.gy = gy;
        grid.live = n_live;
        s_grid = grid;
      }
    }
    __syncthreads();
    const Grid grid = s_grid;
    if (grid.live == 0) {  // nothing in this chunk can pass
      cp_async_wait_all();
      if (desc16) bar_wait(&s_bar, parity);
      parity ^= 1;
      continue;
    }

    // 4. counting sort of the live targets by cell: histogram (whose atomics
    // give each target its rank in its cell), scan, scatter
    int cell[TARGETS_PER_THREAD], rank[TARGETS_PER_THREAD];
#pragma unroll
    for (int t = 0; t < TARGETS_PER_THREAD; ++t) {
      cell[t] = cell_of(ty[t], grid.y0, grid.inv_y, grid.gy) * grid.gx +
                cell_of(tx[t], grid.x0, grid.inv_x, grid.gx);
      rank[t] = live[t] ? atomicAdd(&s_start[cell[t]], 1) : 0;
    }
    __syncthreads();
    {
      int v[CELLS_PER_THREAD];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < CELLS_PER_THREAD; ++i) {
        v[i] = s_start[tid * CELLS_PER_THREAD + i];  // 0 beyond the grid's cells
        sum += v[i];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) s_red_n[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int w = lane < WARPS ? s_red_n[lane] : 0;
        int wi = w;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, wi, off);
          if (lane >= off) wi += y;
        }
        if (lane < WARPS) s_red_n[lane] = wi - w;
      }
      __syncthreads();
      int run = s_red_n[warp] + incl - sum;
#pragma unroll
      for (int i = 0; i < CELLS_PER_THREAD; ++i) {
        s_start[tid * CELLS_PER_THREAD + i] = run;
        run += v[i];
      }
      if (tid == THREADS - 1) s_start[CELLS] = run;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TARGETS_PER_THREAD; ++t) {
      if (live[t]) {
        const int p = s_start[cell[t]] + rank[t];
        s_rec[p] = make_float4(tx[t], ty[t], tl[t], tv[t]);
        s_idx[p] = tid + t * THREADS;
      }
    }
    cp_async_wait_all();
    if (desc16) bar_wait(&s_bar, parity);
    parity ^= 1;
    __syncthreads();

    // 4. each warp searches its rows' windows; 5. and merges its lanes
    for (int k = warp; k < rows; k += WARPS) {
      const float4 qp = s_q[k];
      const float qu = qp.x, qv = qp.y, r = qp.z, lo = qp.w, hi = s_qhi[k];
      if (!searching(qu, qv, r)) continue;  // uniform over the warp
      const uint4 qa = reinterpret_cast<const uint4*>(s_qd)[2 * k];
      const uint4 qb = reinterpret_cast<const uint4*>(s_qd)[2 * k + 1];
      // the window, rounded outwards (see the note at the head)
      const float rr = __fmul_ru(r, 1.0f + 0x1p-21f);
      const int cx0 = cell_of(__fsub_rd(qu, rr), grid.x0, grid.inv_x, grid.gx);
      const int cx1 = cell_of(__fadd_ru(qu, rr), grid.x0, grid.inv_x, grid.gx);
      const int cy0 = cell_of(__fsub_rd(qv, rr), grid.y0, grid.inv_y, grid.gy);
      const int cy1 = cell_of(__fadd_ru(qv, rr), grid.y0, grid.inv_y, grid.gy);

      int best = BIG, idx = INT_MAX, second = BIG;
      for (int cy = cy0; cy <= cy1; ++cy) {
        const int c = cy * grid.gx;
        const int end = s_start[c + cx1 + 1];
        for (int p = s_start[c + cx0] + lane; p < end; p += 32) {
          const float4 t = s_rec[p];
          if (fabsf(qu - t.x) < r && fabsf(qv - t.y) < r && t.z >= lo && t.z <= hi &&
              t.w > 0.f) {
            const int j = s_idx[p];
            const uint4 a = s_desc[2 * j], b = s_desc[2 * j + 1];
            const int d = __popc(qa.x ^ a.x) + __popc(qa.y ^ a.y) + __popc(qa.z ^ a.z) +
                          __popc(qa.w ^ a.w) + __popc(qb.x ^ b.x) + __popc(qb.y ^ b.y) +
                          __popc(qb.z ^ b.z) + __popc(qb.w ^ b.w);
            merge(best, idx, second, d, base + j, BIG);
          }
        }
      }
      // the warp's merge: each target went to one lane, so the winning idx
      // sits in one lane, and every other lane's best is an other column
      const int w_best = __reduce_min_sync(0xffffffffu, best);
      const int w_idx = __reduce_min_sync(0xffffffffu, best == w_best ? idx : INT_MAX);
      second = __reduce_min_sync(0xffffffffu, idx == w_idx ? second : best);
      best = w_best;
      idx = w_idx;
      if (lane == 0) {  // with the earlier chunks' result for this row
        int b = s_best[k], i = s_idx_row[k], s2 = s_second[k];
        merge(b, i, s2, best, idx, second);
        s_best[k] = b;
        s_idx_row[k] = i;
        s_second[k] = s2;
      }
    }
  }
  __syncthreads();
  if (tid < rows) {
    const int best = s_best[tid];
    out_idx[row0 + tid] = best >= BIG ? 0 : s_idx_row[tid];  // argmin over an all-BIG row is column 0
    out_best[row0 + tid] = best;
    out_second[row0 + tid] = s_second[tid];
  }
}

constexpr int MAX_DEVICES = 64;
std::atomic<int> g_sms[MAX_DEVICES];  // SM count of each device once configured, else 0

}  // namespace

// Launches on `stream`, which belongs to `device`, and returns a cudaError_t
// as int: cudaGetLastError() after the launch (a refused launch never runs,
// and a later synchronize would not report it). Writes out_* for rows
// 0..n-1. The first call on a device reads its SM count and allows the
// kernel its dynamic shared memory.
extern "C" int window_match_launch(const void* qdesc, const void* q_uv, const void* q_radius,
                                   const void* q_lo, const void* q_hi, const void* tdesc,
                                   const void* t_xy, const void* t_level, const void* t_valid,
                                   int n, int m, void* out_idx, void* out_best,
                                   void* out_second, void* stream, int device) {
  if (n <= 0) return 0;
  if (device < 0 || device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);

  int sms = g_sms[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TM * BYTES_PER_TARGET);
    if (err == cudaSuccess) g_sms[device].store(sms, std::memory_order_relaxed);
  }
  if (err == cudaSuccess) {
    // about BLOCKS_PER_SM blocks per SM, each a contiguous run of rows
    const int rows_per_block =
        min(MAX_ROWS, max(MIN_ROWS, (n + sms * BLOCKS_PER_SM - 1) / (sms * BLOCKS_PER_SM)));
    const dim3 grid((n + rows_per_block - 1) / rows_per_block);
    const size_t smem = static_cast<size_t>(min(m, TM)) * BYTES_PER_TARGET;
    window_match_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(qdesc), static_cast<const float*>(q_uv),
        static_cast<const float*>(q_radius), static_cast<const float*>(q_lo),
        static_cast<const float*>(q_hi), static_cast<const uint32_t*>(tdesc),
        static_cast<const float*>(t_xy), static_cast<const float*>(t_level),
        static_cast<const float*>(t_valid), n, m, rows_per_block, static_cast<int*>(out_idx),
        static_cast<int*>(out_best), static_cast<int*>(out_second));
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
