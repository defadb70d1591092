// K2 on the tensor cores: the Hamming matrix writer, and
// hamming_best_two_valid with the 1-bit MMA in place of __popc.
//
// The matrix replaces the Pallas TPU kernel
// multi_orbslam3_tpu/frontend/pallas_kernels.py::hamming_matrix (kernel body
// _hamming_kernel): (n, 8) x (m, 8) int32 descriptor words -> the (n, m)
// int32 matrix of Hamming distances. The fused match has the same function
// and the same exact results as mo3_hamming_best_two_valid in hamming.cu.
// The Hamming distance of two 256-bit descriptors is
//   popc(a) + popc(b) - 2 * popc(a & b),
// and popc(a & b) over 256 bits is exactly one k-step of
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc:
// one descriptor is one K = 256 fragment row. (The .xor.popc form, which
// would give the distance at once, is not offered for sm_90.)
//
// What bounds them on an H100. The matrix: its int32 output, 4 n m bytes
// at 3.35 TB/s (0.32 ms at 16,384^2); the products are 4-5x below that even
// at the int8 tensor rate (2 x 256 operations a pair, as +-1 int8 vectors
// would need). The fused match writes no n x m and is bound by the products
// when most pairs are valid: a warp's MMA yields 16 x 8 pairs at once and
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
// Design of the fused match (best_two_mma_kernel): a block of TC_WARPS
// warps owns 16 rows a warp: their A
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
