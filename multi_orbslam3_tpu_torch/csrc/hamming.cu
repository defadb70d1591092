// K2: packed 256-bit Hamming distance as fused matches, by __popc.
//
// Replaces the Pallas TPU kernel
//   multi_orbslam3_tpu/frontend/pallas_kernels.py::hamming_matrix
//   (kernel body _hamming_kernel) for the matchers, which reduce its
//   matrix to three numbers a row.
// dist[i, j] = sum over 8 words of popcount(d1[i, w] ^ d2[j, w]); the words
// are the int32 bit patterns of the JAX package's uint32 descriptor words.
// Every result equals the plain version exactly (integers and comparisons).
// The matrix itself is written by hamming_mma.cu, the stereo match is the
// row-band search of stereo_band.cu.
//
// Two entry points:
//   mo3_hamming_best_two_valid       masks by row and column validity and
//                                    keeps, per row, the first best column,
//                                    the best and the second-best distance,
//                                    and per column the first best row;
//   mo3_hamming_best_two_projection  masks by validity, a per-row radius
//                                    around a projected position and a
//                                    pyramid-level window, computed in the
//                                    kernel from per-row and per-column
//                                    vectors, and keeps the row results.
// Neither writes n x m.
//
// What bounds them on an H100. The least time is the larger of the inputs'
// bytes over 3.35 TB/s and the unmasked pairs' products at the int8 tensor
// rate (the same distances come from +-1 int8 vectors: 2 x 256 operations
// a pair). This __popc form is held to 16 popcounts a clock an SM, 8 a
// pair, far below that rate when every pair is unmasked; it is the default
// because the callers' masks are sparse: an invalid row or column costs
// nothing, and the projection variant tests radius and level first (a
// handful of float operations a pair) and counts bits only for the pairs
// that pass. hamming_mma.cu holds the same validity match with the 1-bit
// tensor-core product in place of __popc.
//
// Design: each block owns FT_ROWS rows, staged in
// shared memory (words, validity, and for the projection variant position,
// squared radius and level) and read as broadcasts, and walks ALL m
// columns, FT_THREADS at a time, one column a thread, held in registers
// (16-byte loads). A thread keeps the running (best, idx, second) of each
// of the block's rows over the columns it has seen, in registers; it sees
// its columns in ascending order, so "strictly less" keeps the first
// index. Nothing crosses blocks for the row results: at the end the
// threads' statistics merge by three warp reductions a row (redux.sync)
// and once through shared memory, under the first-index rule. A column's
// loads are started one step (its validity flag two steps) before its
// turn. The column argmin does cross
// blocks: a thread takes the minimum over the block's rows for its column
// in registers and offers one 64-bit (distance << 32 | row) key a column
// to an atomicMin, unless the key read along with the column's words was
// already lower. Rows without a valid entry are skipped by the whole
// block, and a block without any returns at once.
//
// The radius test repeats the plain version's float32 arithmetic,
// (dx*dx) + (dy*dy) <= r*r with each product and the sum rounded on its
// own: __fmul_rn / __fadd_rn keep nvcc from contracting them into an FMA,
// which would flip pairs within one ulp of the radius.
//
// Nothing is allocated here; the wrappers own outputs and scratch.

#include "match_core.cuh"


namespace {

using namespace mo3;

constexpr int FT_ROWS = 16;
constexpr int FT_THREADS = 256;
constexpr int FT_WARPS = FT_THREADS / 32;

// The mask a fused kernel applies besides validity.
constexpr int MASK_VALID = 0;    // none; also keeps the column argmin
constexpr int MASK_PROJ = 1;     // radius around a projection + level window

// One column of d2 as a thread holds it, with its position and level.
struct Column {
  uint4 lo, hi;
  float u, v;
  int lev;
  unsigned long long key_seen;   // the column's argmin key when it was loaded
};

template <int MASK>
__device__ __forceinline__ void load_column(const MatchArgs& a, int j, Column& c) {
  const uint4* q = reinterpret_cast<const uint4*>(a.d2 + (size_t)j * WORDS);
  c.lo = __ldg(q);
  c.hi = __ldg(q + 1);
  if (MASK != MASK_VALID) {
    const float2 uv = __ldg(reinterpret_cast<const float2*>(a.uv2) + j);
    c.u = uv.x;
    c.v = uv.y;
    c.lev = __ldg(a.lev2 + j);
  } else {
    c.key_seen = __ldcg(a.col_key + j);
  }
}

template <int MASK>
__global__ void __launch_bounds__(FT_THREADS, MASK != MASK_VALID ? 2 : 3) best_two_popc_kernel(MatchArgs a) {
  __shared__ uint4 s_lo[FT_ROWS];
  __shared__ uint4 s_hi[FT_ROWS];
  __shared__ int s_valid[FT_ROWS];
  // u, v, radius^2, level (as bits)
  __shared__ float4 s_proj[FT_ROWS];
  __shared__ int s_red[FT_ROWS][FT_WARPS][3];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * FT_ROWS;

  // 1. the block's rows
  int mine = 0;
  if (tid < FT_ROWS) {
    const int row = row0 + tid;
    mine = (row < a.n && a.valid1[row]) ? 1 : 0;
    s_valid[tid] = mine;
    if (mine) {
      const uint4* p = reinterpret_cast<const uint4*>(a.d1 + (size_t)row * WORDS);
      s_lo[tid] = p[0];
      s_hi[tid] = p[1];
      if (MASK != MASK_VALID) {
        const float r = a.radius ? a.radius[row] : a.radius_scalar;
        s_proj[tid] = make_float4(a.uv1[2 * (size_t)row], a.uv1[2 * (size_t)row + 1],
                                  __fmul_rn(r, r),
                                  __int_as_float(a.lev1[row]));
      }
    }
  }
  if (!__syncthreads_or(mine)) {
    // no valid row: (0, BIG, BIG) for each and nothing else
    if (tid < FT_ROWS && row0 + tid < a.n) {
      a.idx[row0 + tid] = 0;
      a.best[row0 + tid] = BIG;
      a.second[row0 + tid] = BIG;
    }
    return;
  }

  int best[FT_ROWS], idx[FT_ROWS], second[FT_ROWS];
#pragma unroll
  for (int r = 0; r < FT_ROWS; ++r) {
    best[r] = BIG;
    idx[r] = 0;
    second[r] = BIG;
  }

  // 2. all columns, one a thread at a time, in ascending order per thread.
  // The loads run ahead of the work: a column's validity flag is fetched
  // two steps early and its words one step early, so that a step waits for
  // one memory latency at most, also where few columns are valid.
  Column cur = {}, next = {};
  bool cur_valid = tid < a.m && a.valid2[tid];
  if (cur_valid) load_column<MASK>(a, tid, cur);
  bool next_valid = tid + FT_THREADS < a.m && a.valid2[tid + FT_THREADS];
  for (int j = tid; j < a.m; j += FT_THREADS) {
    if (next_valid) load_column<MASK>(a, j + FT_THREADS, next);
    const bool after_valid = j + 2 * FT_THREADS < a.m && a.valid2[j + 2 * FT_THREADS];
    if (cur_valid) {
      int col_best = BIG, col_row = 0;
#pragma unroll
      for (int r = 0; r < FT_ROWS; ++r) {
        if (!s_valid[r]) continue;              // uniform over the block
        if (MASK == MASK_PROJ) {
          const float4 p = s_proj[r];
          const float dx = __fsub_rn(p.x, cur.u);
          const float dy = __fsub_rn(p.y, cur.v);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          if (!(d2 <= p.z) || abs(cur.lev - __float_as_int(p.w)) > a.level_slack) continue;
        }
        const int d = hamming256(s_lo[r], s_hi[r], cur.lo, cur.hi);
        stat_update(best[r], idx[r], second[r], d, j);
        if (MASK == MASK_VALID && d < col_best) {            // rows ascend: first row wins
          col_best = d;
          col_row = row0 + r;
        }
      }
      if (MASK == MASK_VALID && col_best < BIG)
        col_key_offer(a.col_key, j, col_best, col_row, cur.key_seen);
    }
    cur = next;
    cur_valid = next_valid;
    next_valid = after_valid;
  }

  // 3. merge the threads' statistics: within a warp, then once across warps
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < FT_ROWS; ++r) {
    if (!s_valid[r]) continue;
    stat_warp_merge(best[r], idx[r], second[r]);
    if (lane == 0) {
      s_red[r][warp][0] = best[r];
      s_red[r][warp][1] = idx[r];
      s_red[r][warp][2] = second[r];
    }
  }
  __syncthreads();
  if (tid < FT_ROWS && row0 + tid < a.n) {
    int b = BIG, i = 0, s = BIG;
    if (s_valid[tid]) {
      for (int w = 0; w < FT_WARPS; ++w)
        stat_merge(b, i, s, s_red[tid][w][0], s_red[tid][w][1], s_red[tid][w][2]);
    }
    a.idx[row0 + tid] = i;
    a.best[row0 + tid] = b;
    a.second[row0 + tid] = s;
  }
}

template <int MASK>
int launch_best_two_popc(const MatchArgs& a, void* stream) {
  const int grid = (a.n + FT_ROWS - 1) / FT_ROWS;
  best_two_popc_kernel<MASK><<<grid, FT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mo3_hamming_best_two_valid(
    const int* d1, const unsigned char* valid1, int n, const int* d2,
    const unsigned char* valid2, int m, long long* idx, int* best, int* second,
    unsigned long long* col_key, void* stream) {
  MatchArgs a = {};
  a.d1 = d1; a.valid1 = valid1; a.n = n;
  a.d2 = d2; a.valid2 = valid2; a.m = m;
  a.idx = idx; a.best = best; a.second = second; a.col_key = col_key;
  return launch_best_two_popc<MASK_VALID>(a, stream);
}

extern "C" int mo3_hamming_best_two_projection(
    const int* d1, const float* uv1, const unsigned char* valid1,
    const float* radius, float radius_scalar, const int* lev1, int n,
    const int* d2, const float* uv2, const unsigned char* valid2,
    const int* lev2, int m, int level_slack, long long* idx, int* best,
    int* second, void* stream) {
  MatchArgs a = {};
  a.d1 = d1; a.valid1 = valid1; a.n = n;
  a.d2 = d2; a.valid2 = valid2; a.m = m;
  a.uv1 = uv1; a.radius = radius; a.radius_scalar = radius_scalar; a.lev1 = lev1;
  a.uv2 = uv2; a.lev2 = lev2; a.level_slack = level_slack;
  a.idx = idx; a.best = best; a.second = second;
  return launch_best_two_popc<MASK_PROJ>(a, stream);
}
