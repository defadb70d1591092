// Shared pieces of the Hamming kernels (hamming.cu: the projection match's
// grid-indexed window search; hamming_mma.cu: the matrix writer and the
// validity match's compacted tensor-core search; stereo_band.cu: the stereo
// row-band search): the argument block, the 256-bit distance by __popc, the
// 1-bit MMA, the running best/second statistics of a row and their merge,
// and the column-argmin key.
//
// Semantics (frontend/kernels.py, hamming_best_two_*_ref): a masked pair
// counts as BIG; idx is the first column with the row's minimum; second is
// the row's minimum with position idx taken out, so two columns that tie
// for best give second == best; a row with nothing unmasked gives
// (0, BIG, BIG). Every real distance is <= 256 < BIG, so a masked pair can
// simply be skipped: the statistics start at (BIG, 0, BIG).

#pragma once

#include <cuda_runtime.h>

namespace mo3 {

constexpr int BIG = 10000;
constexpr int WORDS = 8;

struct MatchArgs {
  // rows
  const int* d1;                 // (n, 8) descriptor words
  const unsigned char* valid1;   // (n,) bool
  int n;
  // columns
  const int* d2;                 // (m, 8)
  const unsigned char* valid2;   // (m,) bool
  int m;
  // projection and stereo variants: positions, levels and the row's
  // radius (stereo: its epipolar row tolerance)
  const float* uv1;              // (n, 2) position of each row
  const float* radius;           // (n,) per-row radius / tolerance, or null
  float radius_scalar;           // the radius of every row when radius is null
  const int* lev1;               // (n,) predicted level
  const float* uv2;              // (m, 2)
  const int* lev2;               // (m,)
  int level_slack;
  // stereo variant only: disp_min < u1 - u2 < disp_max
  float disp_min, disp_max;
  // per-row results
  long long* idx;                // (n,)
  int* best;                     // (n,)
  int* second;                   // (n,)
  // valid variant only: per-column (distance << 32 | row) keys, initialised
  // to (BIG << 32 | 0) before the search (hamming_mma.cu's pre-pass);
  // atomicMin leaves the first row with the column's minimum in the low word
  // whatever the order of the blocks
  unsigned long long* col_key;   // (m,)
};

__device__ __forceinline__ int hamming256(const uint4& alo, const uint4& ahi,
                                          const uint4& blo, const uint4& bhi) {
  return __popc(alo.x ^ blo.x) + __popc(alo.y ^ blo.y) + __popc(alo.z ^ blo.z) +
         __popc(alo.w ^ blo.w) + __popc(ahi.x ^ bhi.x) + __popc(ahi.y ^ bhi.y) +
         __popc(ahi.z ^ bhi.z) + __popc(ahi.w ^ bhi.w);
}

// popc(a & b) of a 16 x 256-bit A tile (row-major) and an 8 x 256-bit B
// tile (one descriptor a column), one k-step of the 1-bit tensor-core MMA.
// Fragments (lane = 4 g + tig): a[h] and a[2 + h] are words tig and 4 + tig
// of row 8 h + g; b0, b1 words tig and 4 + tig of column g; c[2 h] and
// c[2 h + 1] come out for row 8 h + g, columns 2 tig and 2 tig + 1.
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// One more column j (visited in ascending order by each thread) with
// distance d.
__device__ __forceinline__ void stat_update(int& best, int& idx, int& second,
                                            int d, int j) {
  if (d < best) {
    second = best;
    best = d;
    idx = j;
  } else {
    second = min(second, d);
  }
}

// One more column j with distance d, the columns arriving in any order:
// the lower distance wins, then the lower column, as in stat_merge. Two
// columns that tie for best still leave second == best.
__device__ __forceinline__ void stat_update_any_order(int& best, int& idx, int& second,
                                                      int d, int j) {
  if (d < best || (d == best && j < idx)) {
    second = best;
    best = d;
    idx = j;
  } else {
    second = min(second, d);
  }
}

// Merge the statistics (ob, oi, os) of a disjoint set of columns: the
// lower distance wins, then the lower column; the loser's best is one more
// candidate for second.
__device__ __forceinline__ void stat_merge(int& best, int& idx, int& second,
                                           int ob, int oi, int os) {
  const bool other_wins = (ob < best) || (ob == best && oi < idx);
  const int loser = other_wins ? best : ob;
  second = min(min(second, os), loser);
  if (other_wins) {
    best = ob;
    idx = oi;
  }
}

// Merge over the 32 lanes of a warp, which hold disjoint columns: every
// lane ends with the statistics of all 32 lanes' columns. Three integer
// warp reductions (redux.sync): the least best, the least index among
// the lanes that hold it, and for second the winner lane's second against
// every other lane's best (a lane's second is never below its best).
__device__ __forceinline__ void stat_warp_merge(int& best, int& idx, int& second) {
  const int b = __reduce_min_sync(0xffffffffu, best);
  if (b == BIG) return;                 // nothing unmasked in any lane
  const int i = __reduce_min_sync(0xffffffffu, best == b ? idx : 0x7fffffff);
  const bool winner = (best == b) && (idx == i);
  second = __reduce_min_sync(0xffffffffu, winner ? second : best);
  best = b;
  idx = i;
}

// Offer (d, row) to column j's key. `seen` is a value the key had at some
// earlier time (keys only fall): an offer that is not below it is dropped,
// which spares the atomic once the column has settled; a stale `seen`
// only costs a spare atomic. The atomic's result is not used, so the
// thread does not wait for it.
__device__ __forceinline__ void col_key_offer(unsigned long long* col_key, int j,
                                              int d, int row,
                                              unsigned long long seen) {
  const unsigned long long key =
      (static_cast<unsigned long long>(d) << 32) | static_cast<unsigned int>(row);
  if (key < seen) atomicMin(col_key + j, key);
}

}  // namespace mo3
