// K2, the stereo match: per left feature of a rectified pair, the first
// right feature with the least Hamming distance under the stereo mask, the
// best and the second-best distance, found by a row-band search.
//
// Replaces the Pallas TPU kernel
//   multi_orbslam3_tpu/frontend/pallas_kernels.py::hamming_matrix
// where the JAX package's stereo match (frontend/stereo.py::stereo_match)
// masks its full N x M distance matrix. The mask: both features valid,
// |vL - vR| <= tol[row] (the left feature's epipolar row tolerance),
// disp_min < uL - uR < disp_max and |levelL - levelR| <= level_slack, in
// float32 exactly as the plain version (kernels.py,
// hamming_best_two_stereo_ref) computes it: one rounded subtraction and a
// compare each. Results equal the plain version's bit for bit: idx is the
// first column with the row's least distance, second the least distance
// with that column taken out (equal to best when two columns tie), and a
// row with no unmasked pair gives (0, BIG, BIG).
//
// What bounds it on an H100: the inputs' bytes (about 110 KB at 1,024 x
// 1,024) and the few hundred pairs that pass the mask, a fraction of a
// microsecond of either; in practice a launch and a few dependent memory
// and barrier latencies, so the design keeps both few. The all-columns
// walk it replaces tested every one of the N x M masks and chained a
// global-memory latency per 256 columns.
//
// Design: upstream ORB-SLAM3's per-row index of right keypoints
// (Frame::ComputeStereoMatches), rebuilt by every block in shared memory,
// in one launch, with five barriers:
// 1. Every thread issues all its loads at once, with clamped indices and no
//    branch, so that the block waits for one memory latency, not a chain
//    (a validity flag is only read after the last load is issued): its
//    warp's left row (one warp a left row) and (u, v, level, valid) of its
//    right columns, 2, 4 or 8 a thread, a compile-time count chosen by m
//    (1,024 right features take 2: the prologue loads only those).
// 2. A valid column's key is floor(v) when |v| < 2^20; a column with a
//    larger, infinite or NaN v goes to an overflow bucket that every row
//    scans (the exact test then decides). Each warp's smallest and largest
//    key go to shared memory; after the first barrier one warp reduction
//    of the 16 pairs fixes the buckets: one an image row, at most
//    SB_MAX_BUCKETS, the rest to the overflow bucket.
// 3. A counting sort: a histogram by shared atomics, a block-wide scan (each
//    warp scans its run of buckets, then every warp adds the runs before
//    its own from the 16 warp totals), and a scatter of (u, v, level,
//    column) records into bucket order, each column's slot counted down
//    from its bucket's end, so that afterwards the offsets are the
//    buckets' starts.
// 4. One warp a left row scans the overflow bucket and the buckets of rows
//    floor(vL - tol) - 1 .. floor(vL + tol) + 1. The spare row on each side
//    covers rounding: with every magnitude below 2^20, a column that passes
//    |fl(vL - vR)| <= tol lies within one row of fl(vL -+ tol) (a right
//    feature a hair below image row 0 is one, tests/test_torch_k2_redesign.py).
//    A row whose band is not finite or not below 2^20 scans every bucket.
//    Each lane applies the exact tests to its candidates and, for the ones
//    that pass, reads the right descriptor from global memory (L2: a row
//    passes about one) and counts bits (__popc). Staging the whole right
//    set's descriptors in every block instead cost more than it saved: 32
//    bytes a column into each of the blocks at once (an H100 measurement,
//    PERF.md).
// 5. Bucket order is not column order, and within a bucket the scatter's
//    atomics leave any order: the statistics compare (distance, column)
//    explicitly (stat_update_any_order), and the lanes merge by three warp
//    reductions that take the lowest column among the best (redux.sync).
// 6. Shared memory holds a 16-byte record a right column and the bucket
//    offsets, 73,744 bytes at SB_MAX_M = 4,096 right features (a
//    KITTI-size frame). A larger right set goes through in column chunks of
//    at most SB_MAX_M, one launch each (the wrapper, kernels.py): each
//    chunk builds its own index from its own columns, reports global column
//    indices (col_base + local), and every launch after the first merges
//    the row's statistics so far, read from the outputs, with its own by
//    stat_merge, the same (distance, column) rule, so the result does not
//    depend on the order of the chunks. Up to SB_MAX_M it is one launch.
//
// Nothing is allocated here; the wrapper owns the outputs.

#include <climits>

#include "match_core.cuh"

namespace {

using namespace mo3;

constexpr int SB_THREADS = 512;
constexpr int SB_WARPS = SB_THREADS / 32;
constexpr int SB_ROWS = SB_WARPS;                        // left rows a block, one a warp
constexpr int SB_MAX_M = 4096;
constexpr int SB_MAX_BUCKETS = 2048;                     // image rows the index spans
constexpr int SB_OFFSETS = SB_MAX_BUCKETS + 4;           // overflow, buckets, end; int4s
constexpr float SB_V_LIMIT = 1048576.0f;                 // 2^20
constexpr int KEY_NONE = INT_MIN;                        // invalid column: not indexed
constexpr int KEY_OVER = INT_MAX;                        // overflow bucket
constexpr int SB_MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int sb_smem_bytes(int m) {
  return 16 * m + 4 * SB_OFFSETS;
}

struct LeftRow {
  uint4 lo, hi;
  float u, v, tol;
  int lev;
  int row;
  bool valid;
};

// SLOTS right columns a thread (SLOTS x SB_THREADS >= m): a compile-time
// count keeps the loads of the prologue to the columns there are.
// a.d2, a.uv2, a.valid2 and a.lev2 point at the chunk's first column,
// col_base is that column's global index; with `seeded` the outputs hold
// the statistics of the columns before it.
template <int SLOTS>
__global__ void __launch_bounds__(SB_THREADS) stereo_band_kernel(MatchArgs a, int col_base,
                                                                  bool seeded) {
  extern __shared__ __align__(16) unsigned char sb_smem[];
  float4* s_rec = reinterpret_cast<float4*>(sb_smem);                    // [m]
  int* s_off = reinterpret_cast<int*>(sb_smem + 16 * (size_t)a.m);     // [SB_OFFSETS]
  __shared__ int s_wmin[SB_WARPS], s_wmax[SB_WARPS];
  __shared__ int s_scan[SB_WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = a.m;

  // 1. every load at once: this warp's left row, the right columns' rows
  LeftRow L;
  L.row = blockIdx.x * SB_ROWS + warp;
  {
    const int r = min(L.row, a.n - 1);
    const uint4* p = reinterpret_cast<const uint4*>(a.d1 + (size_t)r * WORDS);
    L.lo = __ldg(p);
    L.hi = __ldg(p + 1);
    const float2 uv = __ldg(reinterpret_cast<const float2*>(a.uv1) + r);
    L.u = uv.x;
    L.v = uv.y;
    L.tol = __ldg(a.radius + r);
    L.lev = __ldg(a.lev1 + r);
    L.valid = __ldg(a.valid1 + r);
  }
  float cu[SLOTS], cv[SLOTS];
  int clev[SLOTS], ckey[SLOTS];
  unsigned char cval[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {                  // clamped: no branch
    const int j = min(tid + k * SB_THREADS, m - 1);
    cval[k] = __ldg(a.valid2 + j);
    const float2 uv = __ldg(reinterpret_cast<const float2*>(a.uv2) + j);
    cu[k] = uv.x;
    cv[k] = uv.y;
    clev[k] = __ldg(a.lev2 + j);
  }
  for (int b = tid; b < SB_OFFSETS / 4; b += SB_THREADS)
    reinterpret_cast<int4*>(s_off)[b] = make_int4(0, 0, 0, 0);

  // 2. a valid column's key: its image row; the block's least and largest
  int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    ckey[k] = KEY_NONE;
    if (tid + k * SB_THREADS < m && cval[k]) {
      if (fabsf(cv[k]) < SB_V_LIMIT) {              // false for inf and NaN
        ckey[k] = __float2int_rd(cv[k]);
        kmin = min(kmin, ckey[k]);
        kmax = max(kmax, ckey[k]);
      } else {
        ckey[k] = KEY_OVER;
      }
    }
  }
  kmin = __reduce_min_sync(FULL, kmin);
  kmax = __reduce_max_sync(FULL, kmax);
  if (lane == 0) {
    s_wmin[warp] = kmin;
    s_wmax[warp] = kmax;
  }
  __syncthreads();                                  // warp extremes; s_off zeroed
  kmin = __reduce_min_sync(FULL, lane < SB_WARPS ? s_wmin[lane] : INT_MAX);
  kmax = __reduce_max_sync(FULL, lane < SB_WARPS ? s_wmax[lane] : INT_MIN);
  const int base = kmin;
  const int nb = kmin <= kmax ? min(kmax - kmin + 1, SB_MAX_BUCKETS) : 0;

  // 3a. histogram: bucket 0 is the overflow, bucket 1 + (key - base) a row
  int cb[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    cb[k] = -1;
    if (ckey[k] != KEY_NONE) {
      cb[k] = 0;
      if (ckey[k] != KEY_OVER && ckey[k] - base < nb) cb[k] = 1 + ckey[k] - base;
      atomicAdd(&s_off[cb[k]], 1);
    }
  }
  __syncthreads();

  // 3b. inclusive scan of the nb + 1 counts, in place; s_off[nb + 1] = total.
  // Each thread sums its run of buckets, each warp scans its threads' sums,
  // then every warp adds the totals of the warps before it.
  const int entries = nb + 1;
  const int chunk = (entries + SB_THREADS - 1) / SB_THREADS;
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
  if (tid == SB_THREADS - 1) s_off[entries] = before + incl;
  __syncthreads();

  // 3c. scatter: each column's slot counted down from its bucket's end, so
  // that s_off[b] ends as bucket b's start and s_off[b + 1] as its end
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    if (cb[k] >= 0) {
      const int pos = atomicSub(&s_off[cb[k]], 1) - 1;
      s_rec[pos] = make_float4(cu[k], cv[k], __int_as_float(clev[k]),
                               __int_as_float(tid + k * SB_THREADS));
    }
  }
  __syncthreads();

  // 4. one warp a left row: the overflow bucket and the row band
  if (L.row >= a.n) return;
  int best = BIG, idx = 0, second = BIG;
  if (L.valid) {
    const int ov_end = s_off[1];
    int lo = 1, hi = nb;                            // every bucket
    const float lo_v = __fsub_rn(L.v, L.tol), hi_v = __fadd_rn(L.v, L.tol);
    if (nb == 0) {
      hi = 0;
    } else if (fabsf(lo_v) < SB_V_LIMIT && fabsf(hi_v) < SB_V_LIMIT) {
      lo = max(1, __float2int_rd(lo_v) - base);      // key floor(lo_v) - 1
      hi = min(nb, __float2int_rd(hi_v) - base + 2);  // key floor(hi_v) + 1
    }
    const int seg = hi >= lo ? s_off[lo] : 0;
    const int total = ov_end + (hi >= lo ? s_off[hi + 1] - seg : 0);
    const uint4* d2 = reinterpret_cast<const uint4*>(a.d2);
    for (int k = lane; k < total; k += 32) {
      const float4 rec = s_rec[k < ov_end ? k : seg + (k - ov_end)];
      const float dv = fabsf(__fsub_rn(L.v, rec.y));
      const float disp = __fsub_rn(L.u, rec.x);
      if (!(dv <= L.tol) || !(disp > a.disp_min) || !(disp < a.disp_max) ||
          abs(__float_as_int(rec.z) - L.lev) > a.level_slack) continue;
      const int j = __float_as_int(rec.w);
      const int d = hamming256(L.lo, L.hi, __ldg(d2 + 2 * j), __ldg(d2 + 2 * j + 1));
      stat_update_any_order(best, idx, second, d, col_base + j);
    }
    stat_warp_merge(best, idx, second);
  }
  if (lane == 0) {
    if (seeded)   // the earlier chunks' columns: (0, BIG, BIG) on an invalid row
      stat_merge(best, idx, second, a.best[L.row], static_cast<int>(a.idx[L.row]),
                 a.second[L.row]);
    a.idx[L.row] = idx;
    a.best[L.row] = best;
    a.second[L.row] = second;
  }
}

bool smem_ready[SB_MAX_DEVICES] = {false};

template <int SLOTS>
void launch_stereo_band(const MatchArgs& a, int col_base, bool seeded, void* stream) {
  stereo_band_kernel<SLOTS><<<(a.n + SB_ROWS - 1) / SB_ROWS, SB_THREADS, sb_smem_bytes(a.m),
                              static_cast<cudaStream_t>(stream)>>>(a, col_base, seeded);
}

}  // namespace

// One chunk: right columns col_base .. col_base + m - 1 of d2, uv2, valid2
// and lev2 (m <= SB_MAX_M); seeded != 0 merges into the outputs, which
// then hold the result of the chunks before it.
extern "C" int mo3_hamming_best_two_stereo(
    const int* d1, const float* uv1, const unsigned char* valid1,
    const float* row_tol, const int* lev1, int n, const int* d2,
    const float* uv2, const unsigned char* valid2, const int* lev2, int m,
    int col_base, int seeded, float disp_min, float disp_max, int level_slack,
    long long* idx, int* best, int* second, void* stream) {
  if (m < 1 || m > SB_MAX_M || n < 1 || col_base < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= SB_MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_ready[dev]) {
    for (auto kernel : {stereo_band_kernel<2>, stereo_band_kernel<4>, stereo_band_kernel<8>}) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 sb_smem_bytes(SB_MAX_M));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    smem_ready[dev] = true;
  }
  MatchArgs a = {};
  a.d1 = d1; a.valid1 = valid1; a.n = n;
  a.d2 = d2 + (size_t)col_base * WORDS; a.valid2 = valid2 + col_base; a.m = m;
  a.uv1 = uv1; a.radius = row_tol; a.lev1 = lev1;
  a.uv2 = uv2 + 2 * (size_t)col_base; a.lev2 = lev2 + col_base; a.level_slack = level_slack;
  a.disp_min = disp_min; a.disp_max = disp_max;
  a.idx = idx; a.best = best; a.second = second;
  static_assert(8 * SB_THREADS == SB_MAX_M, "the widest instantiation holds SB_MAX_M");
  const bool seed = seeded != 0;
  if (m <= 2 * SB_THREADS) launch_stereo_band<2>(a, col_base, seed, stream);
  else if (m <= 4 * SB_THREADS) launch_stereo_band<4>(a, col_base, seed, stream);
  else launch_stereo_band<8>(a, col_base, seed, stream);
  return static_cast<int>(cudaGetLastError());
}
