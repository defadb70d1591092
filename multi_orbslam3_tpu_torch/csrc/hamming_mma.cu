// K2, tensor-core inner product: hamming_best_two_valid with the 1-bit MMA
// in place of __popc.
//
// Same function and same exact results as mo3_hamming_best_two_valid in
// hamming.cu (which replaces the Pallas TPU kernel
// multi_orbslam3_tpu/frontend/pallas_kernels.py::hamming_matrix for the
// matchers). The Hamming distance of two 256-bit descriptors is
//   popc(a) + popc(b) - 2 * popc(a & b),
// and popc(a & b) over 256 bits is exactly one k-step of
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc:
// one descriptor is one K = 256 fragment row. (The .xor.popc form, which
// would give the distance at once, is not offered for sm_90.)
//
// What bounds it on an H100: with the N x M write gone, the __popc kernel
// is bound by the popcount rate (16 a clock an SM, 8 a pair). Here a
// warp's MMA yields 16 x 8 pairs at once and the CUDA cores are left with
// the epilogue: one add and a handful of compare/selects a pair.
//
// Design: a block of TC_WARPS warps owns 16 rows a warp: their A
// fragment, popcounts and running (best, idx, second) stay in registers.
// The block walks all m columns in chunks of TC_CHUNK staged in shared
// memory: one thread a column loads the 8 words (16-byte loads) and stores
// them as two half-rows, so that the B fragment of 8 columns is 32
// consecutive words (no bank conflict), with the column's popcount beside
// them; an invalid row or column carries a popcount of INVALID, so its
// distances come out >= BIG and min(d, BIG) masks them. The next chunk's
// loads are started before the current chunk's MMAs and land while they
// run. A thread holds 2 rows x 2 columns of each C tile, in ascending
// column order, so the first-index rule holds as in hamming.cu; at the end
// the 4 threads of a row group merge by shuffles. The column argmin takes
// the minimum over a warp's 16 rows by shuffles across the 8 row groups,
// over the block's warps by a shared-memory atomicMin on a packed
// (distance << 8 | row in block) key, and offers one 64-bit key a column a
// chunk to the same global atomicMin as hamming.cu.

#include "match_core.cuh"

namespace {

using namespace mo3;

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_BLOCK_ROWS = TC_WARPS * 16;   // 128: fits the key's 8 bits
constexpr int TC_CHUNK = TC_THREADS;           // one column a thread
constexpr int INVALID = 1 << 20;
constexpr int NO_KEY = BIG << 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void mma_and_popc(int (&c)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

struct Column {
  uint4 lo, hi;
  int pb;
};

__device__ __forceinline__ Column load_column(const MatchArgs& p, int j) {
  Column c;
  c.lo = make_uint4(0u, 0u, 0u, 0u);
  c.hi = c.lo;
  c.pb = INVALID;
  if (j < p.m && p.valid2[j]) {
    const uint4* q = reinterpret_cast<const uint4*>(p.d2 + (size_t)j * WORDS);
    c.lo = __ldg(q);
    c.hi = __ldg(q + 1);
    c.pb = __popc(c.lo.x) + __popc(c.lo.y) + __popc(c.lo.z) + __popc(c.lo.w) +
           __popc(c.hi.x) + __popc(c.hi.y) + __popc(c.hi.z) + __popc(c.hi.w);
  }
  return c;
}

__global__ void __launch_bounds__(TC_THREADS) best_two_mma_kernel(MatchArgs p) {
  __shared__ uint4 s_lo[TC_CHUNK];      // words 0-3 of each staged column
  __shared__ uint4 s_hi[TC_CHUNK];      // words 4-7
  __shared__ int s_pb[TC_CHUNK];
  __shared__ int s_col[TC_CHUNK];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;       // row group of A and C, column of B
  const int tig = lane & 3;      // word of the fragment, column pair of C
  const int block_row0 = blockIdx.x * TC_BLOCK_ROWS;

  // A fragment: words tig and 4 + tig of rows g and g + 8 of the warp's tile
  unsigned a[4];
  int pa[2];
  bool any_valid = false;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = block_row0 + warp * 16 + half * 8 + g;
    const bool v = row < p.n && p.valid1[row];
    const unsigned lo = v ? static_cast<unsigned>(p.d1[(size_t)row * WORDS + tig]) : 0u;
    const unsigned hi = v ? static_cast<unsigned>(p.d1[(size_t)row * WORDS + 4 + tig]) : 0u;
    a[half] = lo;
    a[2 + half] = hi;
    int pc = __popc(lo) + __popc(hi);
    pc += __shfl_xor_sync(FULL, pc, 1);
    pc += __shfl_xor_sync(FULL, pc, 2);
    pa[half] = v ? pc : INVALID;
    any_valid |= v;
  }
  const bool warp_works = __any_sync(FULL, any_valid);

  int best[2] = {BIG, BIG}, idx[2] = {0, 0}, second[2] = {BIG, BIG};

  if (__syncthreads_or(warp_works)) {
    const unsigned* w_lo = reinterpret_cast<const unsigned*>(s_lo);
    const unsigned* w_hi = reinterpret_cast<const unsigned*>(s_hi);
    Column next = load_column(p, tid);
    for (int j0 = 0; j0 < p.m; j0 += TC_CHUNK) {
      s_lo[tid] = next.lo;
      s_hi[tid] = next.hi;
      s_pb[tid] = next.pb;
      s_col[tid] = NO_KEY;
      __syncthreads();                       // the chunk is staged
      if (j0 + TC_CHUNK < p.m) next = load_column(p, j0 + TC_CHUNK + tid);
      if (warp_works) {
        const int tiles = (min(TC_CHUNK, p.m - j0) + 7) / 8;
#pragma unroll 4
        for (int t = 0; t < tiles; ++t) {
          // B fragment: column 8 t + g, words tig and 4 + tig
          const unsigned b0 = w_lo[(8 * t + g) * 4 + tig];
          const unsigned b1 = w_hi[(8 * t + g) * 4 + tig];
          // this thread's two columns of C: 8 t + 2 tig and the next
          const int ca = 8 * t + 2 * tig;
          const int pb_a = s_pb[ca], pb_b = s_pb[ca + 1];
          int c[4];
          mma_and_popc(c, a, b0, b1);
          int key_a = NO_KEY, key_b = NO_KEY;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int da = min(pa[half] + pb_a - 2 * c[2 * half], BIG);
            const int db = min(pa[half] + pb_b - 2 * c[2 * half + 1], BIG);
            stat_update(best[half], idx[half], second[half], da, j0 + ca);
            stat_update(best[half], idx[half], second[half], db, j0 + ca + 1);
            const int r = warp * 16 + half * 8 + g;
            key_a = min(key_a, (da << 8) | r);
            key_b = min(key_b, (db << 8) | r);
          }
#pragma unroll
          for (int off = 4; off <= 16; off <<= 1) {
            key_a = min(key_a, __shfl_xor_sync(FULL, key_a, off));
            key_b = min(key_b, __shfl_xor_sync(FULL, key_b, off));
          }
          if (g == 0) {
            if (key_a < NO_KEY) atomicMin(&s_col[ca], key_a);
            if (key_b < NO_KEY) atomicMin(&s_col[ca + 1], key_b);
          }
        }
      }
      __syncthreads();                       // every warp is done with the chunk
      const int key = s_col[tid];
      if (key < NO_KEY)
        col_key_offer(p.col_key, j0 + tid, key >> 8, block_row0 + (key & 0xff),
                      __ldcg(p.col_key + j0 + tid));
    }
  }

  // the 4 threads of a row group hold disjoint columns of the same rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    int b = best[half], i = idx[half], s = second[half];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const int ob = __shfl_xor_sync(FULL, b, off);
      const int oi = __shfl_xor_sync(FULL, i, off);
      const int os = __shfl_xor_sync(FULL, s, off);
      stat_merge(b, i, s, ob, oi, os);
    }
    const int row = block_row0 + warp * 16 + half * 8 + g;
    if (tig == 0 && row < p.n) {
      p.idx[row] = i;
      p.best[row] = b;
      p.second[row] = s;
    }
  }
}

}  // namespace

extern "C" int mo3_hamming_best_two_valid_mma(
    const int* d1, const unsigned char* valid1, int n, const int* d2,
    const unsigned char* valid2, int m, long long* idx, int* best, int* second,
    unsigned long long* col_key, void* stream) {
  MatchArgs a = {};
  a.d1 = d1; a.valid1 = valid1; a.n = n;
  a.d2 = d2; a.valid2 = valid2; a.m = m;
  a.idx = idx; a.best = best; a.second = second; a.col_key = col_key;
  const int grid = (n + TC_BLOCK_ROWS - 1) / TC_BLOCK_ROWS;
  best_two_mma_kernel<<<grid, TC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
