// K2 on the tensor cores: the Hamming matrix writer and the validity match.
//
// Both replace the Pallas TPU kernel
// multi_orbslam3_tpu/frontend/pallas_kernels.py::hamming_matrix (kernel body
// _hamming_kernel). The matrix: (n, 8) x (m, 8) int32 descriptor words ->
// the (n, m) int32 matrix of Hamming distances. The validity match
// (mo3_hamming_best_two_valid): per row the first column with the least
// distance among the valid pairs, the best and the second-best distance,
// and per column the first row with the least distance, without writing
// n x m; exact, as the plain version (kernels.py,
// hamming_best_two_valid_ref). The Hamming distance of two 256-bit
// descriptors is
//   popc(a) + popc(b) - 2 * popc(a & b),
// and popc(a & b) over 256 bits is exactly one k-step of
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc:
// one descriptor is one K = 256 fragment row. (The .xor.popc form, which
// would give the distance at once, is not offered for sm_90.)
//
// What bounds them on an H100. The matrix: its int32 output, 4 n m bytes
// at 3.35 TB/s (0.32 ms at 16,384^2); the products are 4-5x below that even
// at the int8 tensor rate (2 x 256 operations a pair, as +-1 int8 vectors
// would need). The validity match writes no n x m: it is bound by the
// products of the valid pairs where most pairs are valid, and by its
// inputs' bytes where few are (the loop closer's map x map masks hold
// about 4% of the landmarks). The tensor cores give 16 x 8 pairs an MMA;
// the CUDA cores are left with the epilogue, one add and a handful of
// compare/selects a pair.
//
// Design of the matrix writer (hamming_matrix_mma_kernel): a persistent
// grid, as many blocks as fit on the card, walks the 128 x 128 output
// tiles. A tile's 128 rows and 128 columns (4 KB each) are loaded one tile
// ahead into registers (one 16-byte half-row a thread, its popcount summed
// with the neighbour lane's) and staged in shared memory as half-rows, so
// that a fragment's 8 rows x 4 words are 32 consecutive words. Each of the
// 8 warps owns 16 rows of the tile: 16 MMAs give its 16 x 128 block of
// popc(a & b), the epilogue forms pa + pb - 2 c and writes it to the warp's
// own staging rows in shared memory (row stride 136 words: the 64-bit
// stores of a half-warp hit 32 distinct banks); then the warp writes each
// of its rows as one 512-byte run of 16-byte streaming stores
// (st.global.cs.v4: the matrix is not read back here, so it should not
// stay in L2). Stores are fire-and-forget, so one tile's stores drain
// while the next tile's loads and MMAs run. The ragged edge is handled in
// the kernel: rows and columns past n and m are loaded as zeros and never
// stored; when m is not a multiple of 4 the rows are not 16-byte aligned
// and every store is a 4-byte one.
//
// Design of the validity match: two launches, a pre-pass and the search.
// 1. The pre-pass (valid_compact_kernel) compacts the valid rows and the
//    valid columns into ascending index lists, one block each (rounds of
//    32,768 flags, 32 a thread in two 16-byte loads, a block-wide scan, the
//    indices staged at their ranks in shared memory and stored in order),
//    with their counts, into scratch that the wrapper
//    allocates; its other blocks initialise the column keys to
//    (BIG << 32 | 0), the row outputs to (0, BIG, BIG) (a row with nothing
//    valid) and the row tiles' split counters to 0. The host never reads a
//    count: the search reads them on the device.
// 2. The search (valid_compact_mma_kernel) is a persistent grid, as many
//    blocks as fit on the card, over work items (row tile, column split):
//    row tiles of VC_ROWS = 128 compacted rows (4 warps of 32 rows, two
//    m16 A fragments a warp, held in registers with their popcounts),
//    column splits of whole VC_CHUNK = 128-column stages of the compacted
//    column list. The number of splits is chosen on the device from the
//    counts, to fill the grid in as few waves as it can: at 1,024^2 with
//    75% valid that is 6 row tiles x 6 splits; where the rows alone fill
//    the card, one split. Blocks past the items exit at once.
// 3. A split's stages are staged in shared memory by cp.async, two buffers:
//    stage c + 1's copies are in flight while stage c's MMAs run; a
//    column's index is read one stage ahead of its copy. A thread computes
//    the popcount of the column it copied once the copy lands; a slot past
//    the list gets INVALID = BIG + 512, and so does a padded row: their
//    distances come out at BIG or above, which no statistic takes, with no
//    clamp in the loop.
// 4. Epilogue: a thread holds 2 columns x 4 rows of each 16 x 8 x 2 tile and
//    keeps per row the running (best, column, second) over its columns,
//    which it sees in ascending order (compacted positions ascend with the
//    original indices, which the statistics carry, so "strictly less"
//    keeps the first column); the 4 threads of a row group merge by
//    shuffles (stat_merge). With one split a row's result is written at
//    once. With several, each split writes its partial statistics to
//    scratch, and the last block to finish a row tile (a device counter,
//    with a fence) merges them under the (distance, column) rule and
//    writes the rows: no second launch.
// 5. The column argmin: a thread's least packed (distance << 8 | row in
//    tile) key over its 4 rows goes to shared memory with a plain store (a
//    row a row group); at the end of a stage the thread of each column
//    takes the least of its 32 and offers one 64-bit (distance << 32 |
//    row) key to a global atomicMin (col_key_offer, its key read a stage
//    ahead), which leaves the first row with the column's minimum whatever
//    the order. Shuffles and shared atomics in the loop would each add a
//    dependent latency a tile: at 1,024^2 one block an SM runs, and the
//    loop is bound by those chains, not by the tensor cores (an MMA-free
//    variant ran as fast, PERF.md section 6).
// The wrapper's device work a call: this pre-pass, this search, and the
// column keys' low words as int64 (kernels.py), three launches, as many as
// the earlier __popc walk needed (a fill of the keys, the walk, the low
// words).

#include <climits>
#include <cstdint>

#include "match_core.cuh"

namespace {

using namespace mo3;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------
// The validity match
// ---------------------------------------------------------------------

constexpr int VC_WARPS = 4;
constexpr int VC_THREADS = VC_WARPS * 32;
constexpr int VC_ROWS = VC_WARPS * 32;         // 128 compacted rows a tile: fits the key's 8 bits
constexpr int VC_CHUNK = VC_THREADS;           // columns a stage, one a thread
constexpr int VC_MAX_SPLITS = 8;               // column splits of one row tile (kernels.py)
// The popcount of a padded row or column: its distances come out at or
// above BIG (INVALID - 256 >= BIG), so no best, second or key takes them,
// with no clamp.
constexpr int INVALID = BIG + 512;
constexpr int NO_KEY = BIG << 8;
constexpr int NO_COL = 0x7fffffff;
constexpr int CP_THREADS = 1024;               // a pre-pass block
constexpr int CP_PER_THREAD = 32;              // flags a thread a round: two 16-byte loads
constexpr int CP_ROUND = CP_THREADS * CP_PER_THREAD;   // 32,768: the collab arena in one round
constexpr int CP_SMEM = 4 * CP_ROUND;          // a round's indices, staged
constexpr int CP_INIT_BLOCKS = 64;             // pre-pass blocks that initialise the outputs

// Scratch of the validity match, allocated by the wrapper (kernels.py).
struct ValidScratch {
  int* counts;        // [2] valid rows, valid columns
  int* row_list;      // [n] the valid rows, ascending
  int* col_list;      // [m] the valid columns, ascending
  int* tile_done;     // [ceil(n / VC_ROWS)] splits finished, a row tile
  int4* part;         // [n * VC_MAX_SPLITS] (best, position, second, -) of a split
};

// CP_PER_THREAD flags from i0 on (zeros past count), as bytes in 8 words.
struct Flags {
  uint4 lo, hi;
};

__device__ __forceinline__ unsigned flag_word(const Flags& f, int w) {
  const uint4& q = w < 4 ? f.lo : f.hi;
  const int k = w & 3;
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

__device__ __forceinline__ Flags load_flags(const unsigned char* flags, int i0, int count,
                                            bool vec) {
  Flags f = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (vec && i0 + CP_PER_THREAD <= count) {
    const uint4* q = reinterpret_cast<const uint4*>(flags + i0);
    f.lo = __ldg(q);
    f.hi = __ldg(q + 1);
  } else if (i0 < count) {
    unsigned w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    for (int k = 0; k < CP_PER_THREAD && i0 + k < count; ++k)
      if (flags[i0 + k]) w[k >> 2] |= 1u << (8 * (k & 3));
    f.lo = make_uint4(w[0], w[1], w[2], w[3]);
    f.hi = make_uint4(w[4], w[5], w[6], w[7]);
  }
  return f;
}

// One block: the ascending list of the indices i < count with flags[i] set,
// and their number. Flags are bytes 0 or 1 (torch.bool), so the popcount
// of a word counts its set flags. A round of CP_ROUND flags, 32 a thread
// in two 16-byte loads (the next round's issued before this one is
// worked): a block-wide scan of the threads' counts, the indices written at
// their ranks into shared memory (s_list, CP_SMEM bytes of dynamic shared
// memory), then copied out in order with coalesced stores.
__device__ void compact_flags(const unsigned char* flags, int count, int* list, int* total,
                              int* s_list) {
  __shared__ int s_warp[CP_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(flags) & 15) == 0;
  int base = 0;
  Flags cur = load_flags(flags, tid * CP_PER_THREAD, count, vec);
  for (int r = 0; r < count; r += CP_ROUND) {
    const Flags nxt = load_flags(flags, r + CP_ROUND + tid * CP_PER_THREAD, count, vec);
    int c = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) c += __popc(flag_word(cur, w));
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();                                   // s_warp
    int pos = __reduce_add_sync(FULL, lane < warp ? s_warp[lane] : 0) + incl - c;
    const int round_total = __reduce_add_sync(FULL, s_warp[lane]);
#pragma unroll
    for (int k = 0; k < CP_PER_THREAD; ++k)
      if ((flag_word(cur, k >> 2) >> (8 * (k & 3))) & 0xffu)
        s_list[pos++] = r + tid * CP_PER_THREAD + k;
    __syncthreads();                                   // s_list
    for (int i = tid; i < round_total; i += CP_THREADS) list[base + i] = s_list[i];
    base += round_total;
    cur = nxt;
    __syncthreads();                                   // s_list and s_warp free again
  }
  if (tid == 0) *total = base;
}

// Blocks 0 and 1 compact the rows and the columns; the others initialise
// the column keys, the row outputs and the row tiles' counters.
__global__ void __launch_bounds__(CP_THREADS) valid_compact_kernel(MatchArgs a, ValidScratch s,
                                                                    int tiles) {
  extern __shared__ int cp_smem[];
  if (blockIdx.x == 0) {
    compact_flags(a.valid1, a.n, s.row_list, s.counts, cp_smem);
    return;
  }
  if (blockIdx.x == 1) {
    compact_flags(a.valid2, a.m, s.col_list, s.counts + 1, cp_smem);
    return;
  }
  const int count = max(max(a.n, a.m), tiles);
  for (int i = (blockIdx.x - 2) * CP_THREADS + threadIdx.x; i < count;
       i += (gridDim.x - 2) * CP_THREADS) {
    if (i < a.m) a.col_key[i] = static_cast<unsigned long long>(BIG) << 32;
    if (i < a.n) {
      a.idx[i] = 0;
      a.best[i] = BIG;
      a.second[i] = BIG;
    }
    if (i < tiles) s.tile_done[i] = 0;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The number of column splits a row tile: the one that minimises stages a
// split x waves of the persistent grid (the fewest splits on a tie). Lane
// s - 1 of each warp prices s splits and one warp reduction picks: integer
// division is a long instruction sequence, and in a loop its chain cost
// each block about a microsecond before its first load.
__device__ __forceinline__ int choose_splits(int row_tiles, int chunks, int grid) {
  const int lane = threadIdx.x & 31;
  const int s = lane + 1;
  unsigned key = 0xffffffffu;
  if (s <= VC_MAX_SPLITS && s <= chunks) {
    const int cps = (chunks + s - 1) / s;
    const int items = row_tiles * ((chunks + cps - 1) / cps);
    // capped so that the key fits 32 bits; past 2^27 any choice is as good
    const long long cost = min((long long)cps * ((items + grid - 1) / grid), (1LL << 27) - 1);
    key = (static_cast<unsigned>(cost) << 4) | static_cast<unsigned>(s);
  }
  return static_cast<int>(__reduce_min_sync(FULL, key) & 0xfu);
}

__device__ __forceinline__ void stage_column(uint4* lo, uint4* hi, const int* d2, int j) {
  const int* src = d2 + (size_t)j * WORDS;
  cp_async16(lo, src);
  cp_async16(hi, src + 4);
}

__global__ void __launch_bounds__(VC_THREADS) valid_compact_mma_kernel(MatchArgs a,
                                                                        ValidScratch sc) {
  __shared__ uint4 s_lo[2][VC_CHUNK];    // words 0-3 of each staged column
  __shared__ uint4 s_hi[2][VC_CHUNK];    // words 4-7
  __shared__ __align__(16) int s_pb[VC_CHUNK];
  __shared__ __align__(16) int s_col[VC_CHUNK];   // the staged columns' own indices
  // per (warp, row group) the least (distance << 8 | row in tile) key of
  // each staged column over the group's 4 rows; the row stride of 136
  // words puts a half-warp's 64-bit stores on 32 distinct banks
  __shared__ __align__(16) int s_key[VC_WARPS * 8][VC_CHUNK + 8];
  __shared__ int s_row[VC_ROWS];         // the tile's rows (original index)
  __shared__ int s_last;

  const int nr = __ldcg(sc.counts), nc = __ldcg(sc.counts + 1);
  if (nr == 0 || nc == 0) return;        // the pre-pass wrote every output
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;               // row group of A and C, column of B
  const int tig = lane & 3;              // word of the fragment, column pair of C
  const int row_tiles = (nr + VC_ROWS - 1) / VC_ROWS;
  const int chunks = (nc + VC_CHUNK - 1) / VC_CHUNK;
  const int want = choose_splits(row_tiles, chunks, gridDim.x);
  const int cps = (chunks + want - 1) / want;        // stages a split
  const int splits = (chunks + cps - 1) / cps;
  const int items = row_tiles * splits;
  int* key_row = s_key[warp * 8 + g];

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int rt = item / splits, sp = item % splits;
    const int rpos0 = rt * VC_ROWS;
    const int c_begin = sp * cps, c_end = min(chunks, c_begin + cps);

    // every index of this item at once: the tile's rows (one a thread, and
    // the four rows of this thread's A fragments) and the first two
    // stages' columns; then the data they point at; only then their use,
    // so that the item waits for two memory latencies, not a chain
    const int row_self = rpos0 + tid < nr ? __ldcg(sc.row_list + rpos0 + tid) : -1;
    int frow[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = rpos0 + warp * 32 + f * 16 + h * 8 + g;
        frow[f][h] = p < nr ? __ldcg(sc.row_list + p) : -1;
      }
    const int p0 = c_begin * VC_CHUNK + tid;
    int j_cur = p0 < nc ? __ldcg(sc.col_list + p0) : -1;
    int j_next = c_begin + 1 < c_end && p0 + VC_CHUNK < nc
                     ? __ldcg(sc.col_list + p0 + VC_CHUNK) : -1;
    if (j_cur >= 0) stage_column(&s_lo[0][tid], &s_hi[0][tid], a.d2, j_cur);
    cp_async_commit();
    unsigned afr[2][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int* w = a.d1 + (size_t)max(frow[f][h], 0) * WORDS;
        afr[f][h] = frow[f][h] >= 0 ? static_cast<unsigned>(__ldg(w + tig)) : 0u;
        afr[f][2 + h] = frow[f][h] >= 0 ? static_cast<unsigned>(__ldg(w + 4 + tig)) : 0u;
      }
    unsigned long long seen_cur = j_cur >= 0 ? __ldcg(a.col_key + j_cur) : 0ull;
    unsigned long long seen_next = 0ull;
    s_row[tid] = row_self;
    int pa[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int pc = __popc(afr[f][h]) + __popc(afr[f][2 + h]);
        pc += __shfl_xor_sync(FULL, pc, 1);
        pc += __shfl_xor_sync(FULL, pc, 2);
        pa[f][h] = frow[f][h] >= 0 ? pc : INVALID;
      }
    // per row the running (best, column, second); columns are original
    // indices, which ascend with the compacted positions
    int best[2][2], idx[2][2], second[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        best[f][h] = BIG;
        idx[f][h] = 0;
        second[f][h] = BIG;
      }

    // the split's stages: stage c + 1's copies fly during stage c's MMAs
    for (int c = c_begin; c < c_end; ++c) {
      const int buf = (c - c_begin) & 1;
      const int j_after = j_next;
      if (c + 1 < c_end && j_after >= 0) {
        stage_column(&s_lo[buf ^ 1][tid], &s_hi[buf ^ 1][tid], a.d2, j_after);
        seen_next = __ldcg(a.col_key + j_after);
      }
      cp_async_commit();
      {
        const int pn = (c + 2) * VC_CHUNK + tid;
        j_next = c + 2 < c_end && pn < nc ? __ldcg(sc.col_list + pn) : -1;
      }
      cp_async_wait_one();                // this thread's copies of stage c
      int pb = INVALID;
      if (j_cur >= 0) {
        const uint4 lo = s_lo[buf][tid], hi = s_hi[buf][tid];
        pb = __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) +
             __popc(hi.x) + __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
      }
      s_pb[tid] = pb;
      s_col[tid] = j_cur >= 0 ? j_cur : NO_COL;
      __syncthreads();                    // stage c, its popcounts and indices are ready

      const unsigned* w_lo = reinterpret_cast<const unsigned*>(s_lo[buf]);
      const unsigned* w_hi = reinterpret_cast<const unsigned*>(s_hi[buf]);
#pragma unroll 4
      for (int t = 0; t < VC_CHUNK / 8; ++t) {
        // B fragment: column 8 t + g, words tig and 4 + tig
        const unsigned b0 = w_lo[(8 * t + g) * 4 + tig];
        const unsigned b1 = w_hi[(8 * t + g) * 4 + tig];
        // this thread's two columns of C: 8 t + 2 tig and the next
        const int ca = 8 * t + 2 * tig;
        const int2 pb2 = *reinterpret_cast<const int2*>(s_pb + ca);
        const int2 col2 = *reinterpret_cast<const int2*>(s_col + ca);
        int cf[2][4];
        mma_and_popc(cf[0], afr[0], b0, b1);
        mma_and_popc(cf[1], afr[1], b0, b1);
        int key_a = NO_KEY, key_b = NO_KEY;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // >= BIG for a padded row or column (INVALID popcount)
            const int da = pa[f][h] + pb2.x - 2 * cf[f][2 * h];
            const int db = pa[f][h] + pb2.y - 2 * cf[f][2 * h + 1];
            stat_update(best[f][h], idx[f][h], second[f][h], da, col2.x);
            stat_update(best[f][h], idx[f][h], second[f][h], db, col2.y);
            const int r = warp * 32 + f * 16 + h * 8 + g;   // rows ascend: first row wins
            key_a = min(key_a, (da << 8) | r);
            key_b = min(key_b, (db << 8) | r);
          }
        }
        *reinterpret_cast<int2*>(key_row + ca) = make_int2(key_a, key_b);
      }
      __syncthreads();                    // every warp is done with stage c
      // column tid: the least key over the tile's 32 row groups
      int key = NO_KEY;
#pragma unroll 8
      for (int q = 0; q < VC_WARPS * 8; ++q) key = min(key, s_key[q][tid]);
      if (key < NO_KEY && j_cur >= 0)
        col_key_offer(a.col_key, j_cur, key >> 8, s_row[key & 0xff], seen_cur);
      j_cur = j_after;
      seen_cur = seen_next;
    }

    // the 4 threads of a row group hold disjoint columns of the same rows
#pragma unroll
    for (int f = 0; f < 2; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int b = best[f][h], i = idx[f][h], s = second[f][h];
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const int ob = __shfl_xor_sync(FULL, b, off);
          const int oi = __shfl_xor_sync(FULL, i, off);
          const int os = __shfl_xor_sync(FULL, s, off);
          stat_merge(b, i, s, ob, oi, os);
        }
        const int r = warp * 32 + f * 16 + h * 8 + g;
        const int p = rpos0 + r;
        if (tig == 0 && p < nr) {
          if (splits == 1) {
            const int row = s_row[r];
            a.idx[row] = b < BIG ? i : 0;
            a.best[row] = min(b, BIG);
            a.second[row] = min(s, BIG);
          } else {
            sc.part[(size_t)p * VC_MAX_SPLITS + sp] = make_int4(b, i, s, 0);
          }
        }
      }
    }
    if (splits > 1) {
      // the last split of this row tile to finish merges the partials
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(sc.tile_done + rt, 1) == splits - 1;
      __syncthreads();
      if (s_last) {
        __threadfence();
        const int p = rpos0 + tid;
        if (p < nr) {
          // one partial at a time: loading all of them at once takes
          // registers the search loop then lacks (one block less an SM,
          // a fifth slower at 32,768^2)
          int b = BIG, i = 0, s = BIG;
          for (int q = 0; q < splits; ++q) {
            const int4 v = __ldcg(sc.part + (size_t)p * VC_MAX_SPLITS + q);
            stat_merge(b, i, s, v.x, v.y, v.z);
          }
          const int row = s_row[tid];
          a.idx[row] = b < BIG ? i : 0;
          a.best[row] = min(b, BIG);
          a.second[row] = min(s, BIG);
        }
      }
    }
    __syncthreads();                      // shared memory free for the next item
  }
}

// ---------------------------------------------------------------------
// The matrix writer
// ---------------------------------------------------------------------

constexpr int MX_TILE = 128;                     // rows and columns of a tile
constexpr int MX_WARPS = MX_TILE / 16;           // 16 rows a warp
constexpr int MX_THREADS = MX_WARPS * 32;        // one half-row of A and of B a thread
constexpr int MX_STRIDE = MX_TILE + 8;           // staging row stride, in words
constexpr int MX_MAX_DEVICES = 64;
// dynamic shared memory: A and B as half-rows with their popcounts, then
// the warps' staging rows
constexpr int MX_SMEM = 2 * MX_TILE * (2 * 16 + 4) + MX_WARPS * 16 * MX_STRIDE * 4;

// Half-row `half` (words 4 half .. 4 half + 3) of row r of a descriptor
// set, or zeros past its end.
__device__ __forceinline__ uint4 load_half_row(const int* d, int rows, int r, int half) {
  if (r >= rows) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(d + (size_t)r * WORDS) + half);
}

__device__ __forceinline__ void stage_half_row(uint4* lo, uint4* hi, int* pc, int r,
                                               int half, const uint4& v) {
  (half ? hi : lo)[r] = v;
  int c = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  c += __shfl_xor_sync(FULL, c, 1);          // the other half of the row
  if (half == 0) pc[r] = c;
}

__global__ void __launch_bounds__(MX_THREADS) hamming_matrix_mma_kernel(
    const int* __restrict__ d1, const int* __restrict__ d2, int* __restrict__ out,
    int n, int m) {
  extern __shared__ __align__(16) unsigned char mx_smem[];
  uint4* s_alo = reinterpret_cast<uint4*>(mx_smem);   // words 0-3 of the tile's rows
  uint4* s_ahi = s_alo + MX_TILE;                      // words 4-7
  uint4* s_blo = s_ahi + MX_TILE;                      // the same of its columns
  uint4* s_bhi = s_blo + MX_TILE;
  int* s_pa = reinterpret_cast<int*>(s_bhi + MX_TILE);  // popcounts
  int* s_pb = s_pa + MX_TILE;
  int* s_stage = s_pb + MX_TILE;                       // [MX_WARPS][16][MX_STRIDE]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int my_r = tid >> 1, my_half = tid & 1;  // the half-row this thread loads
  const int tiles_m = (m + MX_TILE - 1) / MX_TILE;
  const int tiles = ((n + MX_TILE - 1) / MX_TILE) * tiles_m;
  const bool vec = (m & 3) == 0;                 // rows are 16-byte aligned
  int* stage = s_stage + warp * 16 * MX_STRIDE;
  const unsigned* a_lo = reinterpret_cast<const unsigned*>(s_alo);
  const unsigned* a_hi = reinterpret_cast<const unsigned*>(s_ahi);
  const unsigned* b_lo = reinterpret_cast<const unsigned*>(s_blo);
  const unsigned* b_hi = reinterpret_cast<const unsigned*>(s_bhi);

  int tile = blockIdx.x;
  uint4 next_a = make_uint4(0u, 0u, 0u, 0u), next_b = next_a;
  if (tile < tiles) {
    next_a = load_half_row(d1, n, (tile / tiles_m) * MX_TILE + my_r, my_half);
    next_b = load_half_row(d2, m, (tile % tiles_m) * MX_TILE + my_r, my_half);
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int row0 = (tile / tiles_m) * MX_TILE;
    const int col0 = (tile % tiles_m) * MX_TILE;
    __syncthreads();                             // the last tile's fragments are read
    stage_half_row(s_alo, s_ahi, s_pa, my_r, my_half, next_a);
    stage_half_row(s_blo, s_bhi, s_pb, my_r, my_half, next_b);
    __syncthreads();                             // the tile is staged
    const int after = tile + gridDim.x;
    if (after < tiles) {                         // lands during this tile's work
      next_a = load_half_row(d1, n, (after / tiles_m) * MX_TILE + my_r, my_half);
      next_b = load_half_row(d2, m, (after % tiles_m) * MX_TILE + my_r, my_half);
    }

    // 16 MMAs: this warp's 16 rows against the tile's 128 columns
    const int ra = warp * 16 + g;
    unsigned a[4];
    a[0] = a_lo[ra * 4 + tig];
    a[1] = a_lo[(ra + 8) * 4 + tig];
    a[2] = a_hi[ra * 4 + tig];
    a[3] = a_hi[(ra + 8) * 4 + tig];
    const int pa0 = s_pa[ra], pa1 = s_pa[ra + 8];
#pragma unroll 4
    for (int t = 0; t < MX_TILE / 8; ++t) {
      const unsigned b0 = b_lo[(8 * t + g) * 4 + tig];
      const unsigned b1 = b_hi[(8 * t + g) * 4 + tig];
      const int2 pb = *reinterpret_cast<const int2*>(s_pb + 8 * t + 2 * tig);
      int c[4];
      mma_and_popc(c, a, b0, b1);
      const int col = 8 * t + 2 * tig;
      *reinterpret_cast<int2*>(stage + g * MX_STRIDE + col) =
          make_int2(pa0 + pb.x - 2 * c[0], pa0 + pb.y - 2 * c[1]);
      *reinterpret_cast<int2*>(stage + (g + 8) * MX_STRIDE + col) =
          make_int2(pa1 + pb.x - 2 * c[2], pa1 + pb.y - 2 * c[3]);
    }
    __syncwarp();

    // the warp's 16 rows, each one run of streaming stores
    const int cols = min(MX_TILE, m - col0);
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + warp * 16 + r;
      if (row >= n) break;
      int* dst = out + (size_t)row * m + col0;
      const int* src = stage + r * MX_STRIDE;
      if (vec) {
        if (4 * lane < cols)
          __stcs(reinterpret_cast<int4*>(dst) + lane,
                 *reinterpret_cast<const int4*>(src + 4 * lane));
      } else {
        for (int c = lane; c < cols; c += 32) __stcs(dst + c, src[c]);
      }
    }
    __syncwarp();                                // staging rows free for the next tile
  }
}

int matrix_grid_cap[MX_MAX_DEVICES] = {0};
int valid_grid_cap[MX_MAX_DEVICES] = {0};

}  // namespace

// The validity match: the pre-pass, then the search over as many blocks as
// fit on this device at once (at most the work items n allows).
extern "C" int mo3_hamming_best_two_valid(
    const int* d1, const unsigned char* valid1, int n, const int* d2,
    const unsigned char* valid2, int m, long long* idx, int* best, int* second,
    unsigned long long* col_key, int* counts, int* row_list, int* col_list,
    int* tile_done, int* part, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MX_MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (valid_grid_cap[dev] == 0) {
    err = cudaFuncSetAttribute(valid_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               CP_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, valid_compact_mma_kernel,
                                                        VC_THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    valid_grid_cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  MatchArgs a = {};
  a.d1 = d1; a.valid1 = valid1; a.n = n;
  a.d2 = d2; a.valid2 = valid2; a.m = m;
  a.idx = idx; a.best = best; a.second = second; a.col_key = col_key;
  ValidScratch s = {counts, row_list, col_list, tile_done, reinterpret_cast<int4*>(part)};
  const int tiles = (n + VC_ROWS - 1) / VC_ROWS;
  const int init = min(CP_INIT_BLOCKS, (max(max(n, m), tiles) + CP_THREADS - 1) / CP_THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  valid_compact_kernel<<<2 + init, CP_THREADS, CP_SMEM, st>>>(a, s, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as work items n and m allow, at most what fits at once
  const long long work = (long long)tiles * min(VC_MAX_SPLITS, (m + VC_CHUNK - 1) / VC_CHUNK);
  const int grid = static_cast<int>(work < valid_grid_cap[dev] ? work : valid_grid_cap[dev]);
  valid_compact_mma_kernel<<<grid, VC_THREADS, 0, st>>>(a, s);
  return static_cast<int>(cudaGetLastError());
}

// The persistent grid: as many blocks as fit on this device at once, the
// dynamic shared memory allowed once per device.
extern "C" int mo3_hamming_matrix(const int* d1, const int* d2, int* out, int n, int m,
                                  void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MX_MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (matrix_grid_cap[dev] == 0) {
    err = cudaFuncSetAttribute(hamming_matrix_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hamming_matrix_mma_kernel,
                                                        MX_THREADS, MX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    matrix_grid_cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (long long)((n + MX_TILE - 1) / MX_TILE) * ((m + MX_TILE - 1) / MX_TILE);
  const int grid = static_cast<int>(tiles < matrix_grid_cap[dev] ? tiles : matrix_grid_cap[dev]);
  hamming_matrix_mma_kernel<<<grid, MX_THREADS, MX_SMEM, static_cast<cudaStream_t>(stream)>>>(
      d1, d2, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
