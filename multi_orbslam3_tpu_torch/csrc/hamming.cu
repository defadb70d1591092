// K2: packed 256-bit Hamming distance matrix.
//
// Replaces the Pallas TPU kernel
//   multi_orbslam3_tpu/frontend/pallas_kernels.py::hamming_matrix
//   (kernel body _hamming_kernel).
// out[i, j] = sum over 8 words of popcount(d1[i, w] ^ d2[j, w]); the words
// are the int32 bit patterns of the JAX package's uint32 descriptor words.
// The result equals the plain version exactly (integer arithmetic only).
//
// What bounds it on an H100: the output. At the tracking shape (16,384 map
// points x 1,024 features) it reads 544 KB of descriptors and writes a
// 64 MiB int32 matrix, against 8 xor + 8 popc + 8 add per element, so it
// is bound by HBM write bandwidth.
//
// Design: each block owns a 64 x 64 output tile. The tile's 64 d1 rows
// (2 KB) are staged in shared memory and read as warp-wide broadcasts;
// each thread keeps one d2 row (its column) in registers and walks 16
// rows of the tile, so consecutive threads write consecutive columns and
// every store of a warp is one 128-byte transaction. The remedy for the
// write bound, a variant that applies the caller's mask and keeps only
// the best two per row without writing N x M, is later work. Nothing is
// allocated here; the wrapper owns the output tensor.

#include <cuda_runtime.h>

namespace {

constexpr int WORDS = 8;
constexpr int TILE_N = 64;
constexpr int TILE_M = 64;
constexpr int BLOCK_Y = 4;

__global__ void hamming_matrix_kernel(const int* __restrict__ d1,
                                      const int* __restrict__ d2,
                                      int* __restrict__ out, int n, int m) {
  __shared__ unsigned int s_a[TILE_N][WORDS];

  const int row0 = blockIdx.y * TILE_N;
  const int col = blockIdx.x * TILE_M + threadIdx.x;
  const int tid = threadIdx.y * TILE_M + threadIdx.x;

  for (int i = tid; i < TILE_N * WORDS; i += TILE_M * BLOCK_Y) {
    const int r = i / WORDS;
    const int wd = i % WORDS;
    s_a[r][wd] = (row0 + r < n)
                     ? static_cast<unsigned int>(d1[(size_t)(row0 + r) * WORDS + wd])
                     : 0u;
  }
  unsigned int b[WORDS];
#pragma unroll
  for (int wd = 0; wd < WORDS; ++wd)
    b[wd] = (col < m) ? static_cast<unsigned int>(d2[(size_t)col * WORDS + wd]) : 0u;
  __syncthreads();

  if (col >= m) return;
  for (int r = threadIdx.y; r < TILE_N; r += BLOCK_Y) {
    const int row = row0 + r;
    if (row >= n) break;
    int acc = 0;
#pragma unroll
    for (int wd = 0; wd < WORDS; ++wd) acc += __popc(s_a[r][wd] ^ b[wd]);
    out[(size_t)row * m + col] = acc;
  }
}

}  // namespace

extern "C" int mo3_hamming_matrix(const int* d1, const int* d2, int* out,
                                  int n, int m, void* stream) {
  const dim3 block(TILE_M, BLOCK_Y);
  const dim3 grid((m + TILE_M - 1) / TILE_M, (n + TILE_N - 1) / TILE_N);
  hamming_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      d1, d2, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
