// K2, the projection match: per projected map point, the first frame
// feature with the least Hamming distance inside its search window, the
// best and the second-best distance, found by a grid-indexed window search.
//
// Replaces the Pallas TPU kernel
//   multi_orbslam3_tpu/frontend/pallas_kernels.py::hamming_matrix
// where the JAX package's guided search (frontend/matcher.py::
// match_by_projection) masks its full N x M distance matrix. The mask: both
// valid, (du*du) + (dv*dv) <= r*r in float32 with each product and the sum
// rounded on its own (r: the row's radius) and |level_col - level_row| <=
// level_slack, exactly as the plain version (kernels.py,
// hamming_best_two_projection_ref) computes it. Results equal the plain
// version's bit for bit: idx is the first column with the row's least
// distance, second the least distance with that column taken out (equal to
// best when two columns tie), and a row with no unmasked pair gives
// (0, BIG, BIG). The validity match is in hamming_mma.cu, the stereo match
// in stereo_band.cu.
//
// What bounds it on an H100: the inputs' bytes, each read once (about
// 1.1 MB at 16,384 x 1,024), and the distances of the pairs inside the
// windows (a few thousand); a third of a microsecond of either. The earlier
// design here walked all m columns for every row and tested the radius of
// every (row, column) pair: over 97% of those tests fail, since a 4-px
// window holds about 0.1 of the frame's features and a 54-px one (15 px at
// level 7) about 26.
//
// Design: the pattern of stereo_band.cu, a position index of the columns
// rebuilt by every block in shared memory, in one launch:
// 1. Every thread issues all its loads at once, with clamped indices and no
//    branch: (u, v, level, valid) of its columns (SLOTS a thread, a
//    compile-time count chosen by m). A block owns up to 512 rows, one a
//    thread, as runs of 32 strided over the grid (warp w of block b: rows
//    32 (b + G w) ..; one block an SM where n allows at least 128 rows a
//    block): the landmarks that project into a frame are
//    mostly recent ones, with neighbouring indices, and the stride spreads
//    them over the blocks. Each thread reads its row's flag and, if valid,
//    its descriptor, position, radius and level while the column loads are
//    in flight. The main path's rows are mostly invalid (2-22% of the
//    map's landmarks project into the frame, PERF.md section 6), so the
//    block compacts its valid rows into shared memory (a ballot a warp)
//    and writes (0, BIG, BIG) for the others at once.
// 2. A valid column's cell is (floor(u / 16), floor(v / 16)) when |u| and |v|
//    are below 2^20 (the division by a power of two is exact); a column at a
//    larger, infinite or NaN position goes to one overflow list, which every
//    row visits (with an infinite radius the plain mask passes an infinite
//    position: inf <= inf). The block's least and largest cell keys fix the
//    grid over the valid columns' own bounding box, in cells of PG_CELL =
//    16 px: gx cells across, at most PG_MAX_CELLS in all; cells beyond it
//    go to the overflow list too. The kernel never needs the image size,
//    and undistorted features may lie outside the image.
// 3. A counting sort by cell, row-major: a histogram by shared atomics, a
//    block-wide scan, a scatter of (u, v, level, column) records counted
//    down from each cell's end. A row of cells is then one contiguous run.
//    The extractor emits a region's features together, so a warp's
//    columns often share a cell: the lanes that do (__match_any_sync)
//    make one atomic between them.
// 4. PG_LANES = 8 lanes a valid row, 64 rows at a time: each visits the
//    overflow list, then for each cell row from floor((v - |r|) / 16) - 1
//    to floor((v + |r|) / 16) + 1 the run of cells floor((u - |r|) / 16) - 1
//    .. floor((u + |r|) / 16) + 1. The spare cell on each side covers
//    rounding: with every magnitude below 2^20, a column that passes the
//    float32 test lies within a hair of the exact square u +- |r|, v +- |r|.
//    A row whose square is not finite or not below 2^20, or covers more
//    cells than the index has columns, walks every indexed column instead.
//    The main path's rows visit 13-50 columns on average at 16-px cells
//    (35-101 at 32 px; 6-30 at 8 px, with twice the runs), so 8 lanes take
//    a few each; they stride over the concatenated runs, so they stay
//    balanced across short runs. Each candidate is tested for its level,
//    then its radius (__fsub_rn / __fmul_rn / __fadd_rn: nvcc may not
//    contract the sum into an FMA, which would flip pairs within one ulp
//    of the radius), and only then is its descriptor read from global
//    memory (L2) and counted, PG_BATCH = 4 candidates' loads at once: a
//    row of a real frame has 1-10 candidates inside its window, and one L2
//    latency each in a chain cost more than the rest of its search.
// 5. Runs come in cell order, not column order, and the scatter's atomics
//    leave any order within a cell: the statistics compare (distance,
//    column) explicitly (stat_update_any_order) and the lane group merges
//    by shuffles under the same rule (stat_merge).
// 6. Shared memory holds a 16-byte record a column and the cell offsets.
//    Up to PG_MAX_M = 8,192 columns (every caller: the frame's 1,024
//    features, stereo_wide's 4,608) the match is one launch. A larger set
//    goes through in column chunks of PG_MAX_M, one launch each: every
//    launch after the first merges the row's statistics so far, read from
//    the outputs, with its own by stat_merge, so the order of the chunks
//    does not matter.
// The kernel reads nothing back to the host and allocates nothing: it runs
// inside the fused tracking step and replays from a CUDA graph.

#include <climits>

#include "match_core.cuh"

namespace {

using namespace mo3;

constexpr int PG_THREADS = 512;
constexpr int PG_WARPS = PG_THREADS / 32;
constexpr int PG_LANES = 8;                              // lanes a row
constexpr int PG_GROUPS = PG_THREADS / PG_LANES;         // rows searched at once
constexpr int PG_MIN_ROWS = 128;                         // rows a block, at least (grid cap)
constexpr int PG_BATCH = 4;                              // candidates whose loads fly together
constexpr int PG_MAX_M = 8192;
constexpr int PG_MAX_CELLS = 4096;
constexpr int PG_OFFSETS = PG_MAX_CELLS + 4;             // overflow, cells, end; int4s
constexpr float PG_INV_CELL = 0.0625f;                   // 1 / 16 px
constexpr float PG_LIMIT = 1048576.0f;                   // 2^20
constexpr int KEY_NONE = INT_MIN;                        // invalid column: not indexed
constexpr int KEY_OVER = INT_MAX;                        // overflow list
constexpr int PG_MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

static_assert(32 % PG_LANES == 0, "a lane group lies within one warp");


__host__ __device__ constexpr int pg_smem_bytes(int m) {
  return 16 * m + 4 * PG_OFFSETS;
}

__device__ __forceinline__ bool in_limit(float x) {
  return fabsf(x) < PG_LIMIT;                            // false for inf and NaN
}

// The block's least and largest value of x: every thread gets both.
__device__ __forceinline__ void block_min_max(int& lo, int& hi, int* s_lo, int* s_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = __reduce_min_sync(FULL, lane < PG_WARPS ? s_lo[lane] : INT_MAX);
  hi = __reduce_max_sync(FULL, lane < PG_WARPS ? s_hi[lane] : INT_MIN);
}

// PG_SLOTS columns a thread (SLOTS x PG_THREADS >= m). a.d2, a.uv2, a.valid2
// and a.lev2 point at the chunk's first column, col_base is its global
// index; with `seeded` the outputs hold the statistics of the columns
// before it.
template <int SLOTS>
__global__ void __launch_bounds__(PG_THREADS) proj_grid_kernel(MatchArgs a, int col_base,
                                                                bool seeded) {
  extern __shared__ __align__(16) unsigned char pg_smem[];
  float4* s_rec = reinterpret_cast<float4*>(pg_smem);                    // [m]
  int* s_off = reinterpret_cast<int*>(pg_smem + 16 * (size_t)a.m);     // [PG_OFFSETS]
  __shared__ int s_wlo[2][PG_WARPS], s_whi[2][PG_WARPS];
  __shared__ int s_scan[PG_WARPS];
  __shared__ int s_wrows[PG_WARPS];                    // valid rows a warp
  __shared__ uint4 s_rlo[PG_THREADS], s_rhi[PG_THREADS];   // the valid rows, compacted
  __shared__ float4 s_rpos[PG_THREADS];                // u, v, radius, level (as bits)
  __shared__ int s_rrow[PG_THREADS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % PG_LANES;                      // lane within the row's group
  const int m = a.m;

  // 1. every load at once: the columns' positions, then this block's rows
  float cu[SLOTS], cv[SLOTS];
  int clev[SLOTS];
  unsigned char cval[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {                  // clamped: no branch
    const int j = min(tid + k * PG_THREADS, m - 1);
    cval[k] = __ldg(a.valid2 + j);
    const float2 uv = __ldg(reinterpret_cast<const float2*>(a.uv2) + j);
    cu[k] = uv.x;
    cv[k] = uv.y;
    clev[k] = __ldg(a.lev2 + j);
  }
  // this thread's row: its flag, then its data if it is valid, while the
  // column loads are in flight; the valid rows' ranks within each warp.
  // Warp w of block b owns rows 32 (b + G w) .. + 31 (G blocks): the map's
  // visible landmarks come in runs of recent indices, and this spreads a
  // run over the blocks.
  const int row = 32 * (blockIdx.x + gridDim.x * warp) + lane;
  const bool rvalid = row < a.n && __ldg(a.valid1 + row);
  uint4 rlo = make_uint4(0u, 0u, 0u, 0u), rhi = rlo;
  float4 rpos = make_float4(0.f, 0.f, 0.f, 0.f);
  if (rvalid) {
    const uint4* p = reinterpret_cast<const uint4*>(a.d1 + (size_t)row * WORDS);
    rlo = __ldg(p);
    rhi = __ldg(p + 1);
    rpos = make_float4(__ldg(a.uv1 + 2 * (size_t)row), __ldg(a.uv1 + 2 * (size_t)row + 1),
                       a.radius ? __ldg(a.radius + row) : a.radius_scalar,
                       __int_as_float(__ldg(a.lev1 + row)));
  }
  const unsigned vmask = __ballot_sync(FULL, rvalid);
  if (lane == 0) s_wrows[warp] = __popc(vmask);
  for (int b = tid; b < PG_OFFSETS / 4; b += PG_THREADS)
    reinterpret_cast<int4*>(s_off)[b] = make_int4(0, 0, 0, 0);

  // 2. a valid column's cell keys; the block's bounding box of them
  int kx[SLOTS], ky[SLOTS];
  int xlo = INT_MAX, xhi = INT_MIN, ylo = INT_MAX, yhi = INT_MIN;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    kx[k] = KEY_NONE;
    ky[k] = 0;
    if (tid + k * PG_THREADS < m && cval[k]) {
      if (in_limit(cu[k]) && in_limit(cv[k])) {
        kx[k] = __float2int_rd(cu[k] * PG_INV_CELL);
        ky[k] = __float2int_rd(cv[k] * PG_INV_CELL);
        xlo = min(xlo, kx[k]);
        xhi = max(xhi, kx[k]);
        ylo = min(ylo, ky[k]);
        yhi = max(yhi, ky[k]);
      } else {
        kx[k] = KEY_OVER;
      }
    }
  }
  block_min_max(xlo, xhi, s_wlo[0], s_whi[0]);       // its barrier: s_off, s_wrows
  block_min_max(ylo, yhi, s_wlo[1], s_whi[1]);
  // the block's valid rows, compacted in ascending order; an invalid row's
  // result, (0, BIG, BIG), is written at once (a seeded launch keeps it)
  int n_rows = 0, rank = 0;
#pragma unroll
  for (int w = 0; w < PG_WARPS; ++w) {
    if (w < warp) rank += s_wrows[w];
    n_rows += s_wrows[w];
  }
  if (rvalid) {
    rank += __popc(vmask & ((1u << lane) - 1u));
    s_rlo[rank] = rlo;
    s_rhi[rank] = rhi;
    s_rpos[rank] = rpos;
    s_rrow[rank] = row;
  } else if (row < a.n && !seeded) {
    a.idx[row] = 0;
    a.best[row] = BIG;
    a.second[row] = BIG;
  }
  int gx = 0, gy = 0;
  if (xlo <= xhi) {
    gx = min(xhi - xlo + 1, PG_MAX_CELLS);
    gy = min(yhi - ylo + 1, PG_MAX_CELLS / gx);
  }
  const int cells = gx * gy;

  // 3a. histogram: bucket 0 is the overflow list, 1 + cy * gx + cx a cell.
  // Neighbouring columns tend to share a cell (the extractor emits a
  // region's features together), so the lanes of a warp that share one
  // add their count once (__match_any_sync), as the scatter does below.
  int cb[SLOTS];
  unsigned peers[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    cb[k] = -1;
    if (kx[k] != KEY_NONE) {
      cb[k] = 0;
      if (kx[k] != KEY_OVER) {
        const int cx = kx[k] - xlo, cy = ky[k] - ylo;
        if (cx < gx && cy < gy) cb[k] = 1 + cy * gx + cx;
      }
    }
    peers[k] = __match_any_sync(FULL, cb[k]);
    if (cb[k] >= 0 && lane == __ffs(peers[k]) - 1) atomicAdd(&s_off[cb[k]], __popc(peers[k]));
  }
  __syncthreads();

  // 3b. inclusive scan of the cells + 1 counts, in place; s_off[cells + 1]
  // = total. Each thread sums its run of buckets, each warp scans its
  // threads' sums, then every warp adds the totals of the warps before it.
  const int entries = cells + 1;
  const int chunk = (entries + PG_THREADS - 1) / PG_THREADS;
  const int e0 = min(entries, tid * chunk), e1 = min(entries, e0 + chunk);
  int sum = 0;
  for (int e = e0; e < e1; ++e) sum += s_off[e];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  int before = lane < warp ? s_scan[lane] : 0;      // totals of the earlier warps
  before = __reduce_add_sync(FULL, before);
  int run = before + incl - sum;
  for (int e = e0; e < e1; ++e) {
    run += s_off[e];
    s_off[e] = run;
  }
  if (tid == PG_THREADS - 1) s_off[entries] = before + incl;
  __syncthreads();

  // 3c. scatter: each column's slot counted down from its bucket's end, so
  // that s_off[b] ends as bucket b's start and s_off[b + 1] as its end; one
  // atomic a bucket a warp, each lane below it by its rank among its peers
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int leader = __ffs(peers[k]) - 1;
    int top = 0;
    if (cb[k] >= 0 && lane == leader) top = atomicSub(&s_off[cb[k]], __popc(peers[k]));
    top = __shfl_sync(FULL, top, leader);
    if (cb[k] >= 0) {
      const int pos = top - 1 - __popc(peers[k] & ((1u << lane) - 1u));
      s_rec[pos] = make_float4(cu[k], cv[k], __int_as_float(clev[k]),
                               __int_as_float(tid + k * PG_THREADS));
    }
  }
  __syncthreads();

  // 4. PG_LANES lanes a row, PG_GROUPS rows at a time: the overflow list,
  // then the cell rows of the row's square (or every indexed column). The
  // rounds are uniform over the block, so every lane of a warp reaches the
  // group's shuffles.
  const int ov_end = s_off[1];
  const int total = s_off[cells + 1];
  const uint4* d2 = reinterpret_cast<const uint4*>(a.d2);
  for (int k = tid / PG_LANES; k - tid / PG_LANES < n_rows; k += PG_GROUPS) {
    int best = BIG, idx = 0, second = BIG;
    const bool active = k < n_rows;
    if (active) {
      const uint4 qlo = s_rlo[k], qhi = s_rhi[k];
      const float4 q = s_rpos[k];
      const int qlev = __float_as_int(q.w);
      const float ar = fabsf(q.z);
      const float r2 = __fmul_rn(q.z, q.z);
      const float u0 = __fsub_rn(q.x, ar), u1 = __fadd_rn(q.x, ar);
      const float v0 = __fsub_rn(q.y, ar), v1 = __fadd_rn(q.y, ar);
      bool walk_all = !(in_limit(u0) && in_limit(u1) && in_limit(v0) && in_limit(v1));
      int cx0 = 0, cx1 = -1, cy0 = 0, cy1 = -1;
      if (!walk_all && cells > 0) {
        cx0 = max(0, __float2int_rd(u0 * PG_INV_CELL) - 1 - xlo);
        cx1 = min(gx - 1, __float2int_rd(u1 * PG_INV_CELL) + 1 - xlo);
        cy0 = max(0, __float2int_rd(v0 * PG_INV_CELL) - 1 - ylo);
        cy1 = min(gy - 1, __float2int_rd(v1 * PG_INV_CELL) + 1 - ylo);
        if (cx0 <= cx1 && cy0 <= cy1 &&
            (long long)(cx1 - cx0 + 1) * (cy1 - cy0 + 1) > total)
          walk_all = true;
      }
      // the candidates that pass wait in pj until PG_BATCH of them can
      // have their descriptors loaded at once: one L2 latency a batch
      int pj[PG_BATCH];
      int np = 0;
      auto flush = [&]() {
        uint4 lo[PG_BATCH], hi[PG_BATCH];
#pragma unroll
        for (int b = 0; b < PG_BATCH; ++b) {
          if (b < np) {
            lo[b] = __ldg(d2 + 2 * pj[b]);
            hi[b] = __ldg(d2 + 2 * pj[b] + 1);
          }
        }
#pragma unroll
        for (int b = 0; b < PG_BATCH; ++b)
          if (b < np)
            stat_update_any_order(best, idx, second, hamming256(qlo, qhi, lo[b], hi[b]),
                                  col_base + pj[b]);
        np = 0;
      };
      int seen = 0;                                   // candidates before this run
      auto visit = [&](int start, int len) {
        int j0 = sub - seen % PG_LANES;
        if (j0 < 0) j0 += PG_LANES;
        for (int t = j0; t < len; t += PG_LANES) {
          const float4 rec = s_rec[start + t];
          if (abs(__float_as_int(rec.z) - qlev) > a.level_slack) continue;
          const float du = __fsub_rn(q.x, rec.x);
          const float dv = __fsub_rn(q.y, rec.y);
          const float dd = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
          if (!(dd <= r2)) continue;
#pragma unroll
          for (int b = 0; b < PG_BATCH; ++b)
            if (b == np) pj[b] = __float_as_int(rec.w);
          if (++np == PG_BATCH) flush();
        }
        seen += len;
      };
      if (walk_all) {
        visit(0, total);
      } else {
        visit(0, ov_end);
        if (cx0 <= cx1) {
          for (int cy = cy0; cy <= cy1; ++cy) {
            const int s0 = s_off[1 + cy * gx + cx0];
            visit(s0, s_off[1 + cy * gx + cx1 + 1] - s0);
          }
        }
      }
      flush();
    }
    // the group's lanes hold disjoint columns of the same row
#pragma unroll
    for (int off = 1; off < PG_LANES; off <<= 1) {
      const int ob = __shfl_xor_sync(FULL, best, off);
      const int oi = __shfl_xor_sync(FULL, idx, off);
      const int os = __shfl_xor_sync(FULL, second, off);
      stat_merge(best, idx, second, ob, oi, os);
    }
    if (active && sub == 0) {
      const int r = s_rrow[k];
      if (seeded)   // the earlier chunks' columns
        stat_merge(best, idx, second, a.best[r], static_cast<int>(a.idx[r]), a.second[r]);
      a.idx[r] = idx;
      a.best[r] = best;
      a.second[r] = second;
    }
  }
}

int sm_count[PG_MAX_DEVICES] = {0};

// One block an SM while n allows PG_MIN_ROWS rows a block or more, up to
// PG_THREADS rows a block: every block builds the same index, so more
// blocks than SMs only share an SM's time.
template <int SLOTS>
void launch_proj_grid(const MatchArgs& a, int col_base, bool seeded, int sms, void* stream) {
  const int grid = max((a.n + PG_THREADS - 1) / PG_THREADS,
                       min(sms, (a.n + PG_MIN_ROWS - 1) / PG_MIN_ROWS));
  proj_grid_kernel<SLOTS><<<grid, PG_THREADS, pg_smem_bytes(a.m),
                            static_cast<cudaStream_t>(stream)>>>(a, col_base, seeded);
}

}  // namespace

// One chunk: columns col_base .. col_base + m - 1 of d2, uv2, valid2 and
// lev2 (m <= PG_MAX_M); seeded != 0 merges into the outputs, which then
// hold the result of the chunks before it.
extern "C" int mo3_hamming_best_two_projection(
    const int* d1, const float* uv1, const unsigned char* valid1,
    const float* radius, float radius_scalar, const int* lev1, int n,
    const int* d2, const float* uv2, const unsigned char* valid2,
    const int* lev2, int m, int col_base, int seeded, int level_slack,
    long long* idx, int* best, int* second, void* stream) {
  if (m < 1 || m > PG_MAX_M || n < 1 || col_base < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= PG_MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[dev] == 0) {
    for (auto kernel : {proj_grid_kernel<2>, proj_grid_kernel<4>, proj_grid_kernel<8>,
                        proj_grid_kernel<16>}) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 pg_smem_bytes(PG_MAX_M));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[dev] = sms;
  }
  MatchArgs a = {};
  a.d1 = d1; a.valid1 = valid1; a.n = n;
  a.d2 = d2 + (size_t)col_base * WORDS; a.valid2 = valid2 + col_base; a.m = m;
  a.uv1 = uv1; a.radius = radius; a.radius_scalar = radius_scalar; a.lev1 = lev1;
  a.uv2 = uv2 + 2 * (size_t)col_base; a.lev2 = lev2 + col_base; a.level_slack = level_slack;
  a.idx = idx; a.best = best; a.second = second;
  static_assert(16 * PG_THREADS == PG_MAX_M, "the widest instantiation holds PG_MAX_M");
  const bool seed = seeded != 0;
  const int sms = sm_count[dev];
  if (m <= 2 * PG_THREADS) launch_proj_grid<2>(a, col_base, seed, sms, stream);
  else if (m <= 4 * PG_THREADS) launch_proj_grid<4>(a, col_base, seed, sms, stream);
  else if (m <= 8 * PG_THREADS) launch_proj_grid<8>(a, col_base, seed, sms, stream);
  else launch_proj_grid<16>(a, col_base, seed, sms, stream);
  return static_cast<int>(cudaGetLastError());
}
