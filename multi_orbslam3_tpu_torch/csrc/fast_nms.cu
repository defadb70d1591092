// K1: fused FAST-9/16 corner score + 3x3 non-maximum suppression, for all
// the levels of an image pyramid in one launch.
//
// Replaces the Pallas TPU kernel
//   multi_orbslam3_tpu/frontend/pallas_kernels.py::fast_score_nms
//   (kernel body _fast_nms_kernel).
// Each level's result equals fast.nms3x3(fast.fast_score(img, threshold))
// bit for bit: the arithmetic is float subtraction, negation, min and max
// only, and min/max are exact in any order.
//
// What bounds it on an H100: each level is read once and written once
// (the 8 levels of a 752x480 frame hold 1.12 M pixels, 8.9 MB both ways),
// which is microseconds of HBM time, so what a frame pays is the launches
// and the per-pixel work. One launch covers up to MAX_LEVELS levels (a
// pyramid, or both pyramids of a stereo frame): its grid is the tiles of
// all levels, end to end, and a block finds its level by a scan of the
// table. The wrapper (kernels.py) sends more levels in groups of at most
// MAX_LEVELS, one launch each, into one output buffer. The table (pointers, sizes,
// first tile of each level) travels by value as a kernel parameter, so
// the launch is safe on any stream and inside a CUDA graph capture.
//
// Per pixel: 16 differences to the centre, then the minimum over each of
// the 16 contiguous 9-pixel arcs by doubling (pairs, quads, octets, then
// one more pixel: 64 min for the bright side; the dark side is the same
// with max, since min(-d) = -max(d)), in place of 16 x 8 min a side. A
// pixel with fewer than 2 of its 4 compass pixels beyond the threshold on
// either side cannot hold a 9-arc (every 9-arc covers at least 2 of them)
// and scores 0 without the arc search. (Queueing the pixels that pass in
// shared memory, so that the search runs with every lane busy, was tried:
// it gained 7% on a rendered frame and lost 10% on noise, and was dropped.
// At these sizes a block's chain of load, barrier, score, barrier, NMS
// sets the time, not the arithmetic.)
//
// Design: each block owns a 32x32 output tile. The input tile plus a 4-px
// halo (3 px for the Bresenham circle, 1 px for the NMS neighbourhood) is
// staged in shared memory once, with out-of-image pixels read as 0 (the
// zero padding of fast._shift2d). Scores for the tile and its 1-px apron
// go to a second shared array, with the 3-px image border and everything
// outside the image zeroed BEFORE the NMS, so border scores never
// suppress interior corners. The NMS then reads only shared memory.
// Nothing is allocated here; the wrapper owns the output buffer.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int IN_DIM = TILE + 2 * HALO;  // 40
constexpr int SC_DIM = TILE + 2;          // 34
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int MAX_LEVELS = 16;

struct LevelTable {
  const float* in[MAX_LEVELS];
  float* out[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];
  int tile0[MAX_LEVELS + 1];   // first tile of each level; [n] = all tiles
  int n;
};

// max over the 16 arcs of the arc's minimum of d (bright side), and min
// over the arcs of the arc's maximum (the dark side's value, negated).
__device__ __forceinline__ void arc_extrema(const float (&d)[16], float& max_of_min,
                                            float& min_of_max) {
  float lo2[16], hi2[16], lo4[16], hi4[16], lo8[16], hi8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo2[k] = fminf(d[k], d[(k + 1) & 15]);
    hi2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo4[k] = fminf(lo2[k], lo2[(k + 2) & 15]);
    hi4[k] = fmaxf(hi2[k], hi2[(k + 2) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo8[k] = fminf(lo4[k], lo4[(k + 4) & 15]);
    hi8[k] = fmaxf(hi4[k], hi4[(k + 4) & 15]);
  }
  max_of_min = fminf(lo8[0], d[8]);
  min_of_max = fmaxf(hi8[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    max_of_min = fmaxf(max_of_min, fminf(lo8[k], d[(k + 8) & 15]));
    min_of_max = fminf(min_of_max, fmaxf(hi8[k], d[(k + 8) & 15]));
  }
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
fast_score_nms_levels_kernel(const LevelTable t, float threshold) {
  __shared__ float s_in[IN_DIM][IN_DIM + 1];
  __shared__ float s_sc[SC_DIM][SC_DIM + 1];
  // (dx, dy) of the radius-3 Bresenham circle in contiguous order
  // (fast._CIRCLE); compile-time, so each neighbour is a fixed offset
  constexpr int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int kCircleDy[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                                 -3, -3, -2, -1, 0, 1, 2, 3};

  int lv = 0;
  while (lv + 1 < t.n && static_cast<int>(blockIdx.x) >= t.tile0[lv + 1]) ++lv;
  const int tile = blockIdx.x - t.tile0[lv];
  const int h = t.h[lv], w = t.w[lv];
  const float* __restrict__ img = t.in[lv];
  float* __restrict__ out = t.out[lv];
  const int y0 = (tile / t.tiles_x[lv]) * TILE;
  const int x0 = (tile % t.tiles_x[lv]) * TILE;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int nthreads = BLOCK_X * BLOCK_Y;

  // 1. input tile + 4-px halo, zero outside the image
  for (int i = tid; i < IN_DIM * IN_DIM; i += nthreads) {
    const int r = i / IN_DIM;
    const int c = i % IN_DIM;
    const int gy = y0 - HALO + r;
    const int gx = x0 - HALO + c;
    s_in[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                     ? img[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();

  // 2. FAST score for the tile + 1-px apron
  for (int i = tid; i < SC_DIM * SC_DIM; i += nthreads) {
    const int r = i / SC_DIM;
    const int c = i % SC_DIM;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + c;
    float score = 0.0f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const int cy = r + (HALO - 1);
      const int cx = c + (HALO - 1);
      const float center = s_in[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = s_in[cy + kCircleDy[k]][cx + kCircleDx[k]] - center;
      int n_bright = 0, n_dark = 0;
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        n_bright += (d[k] > threshold) ? 1 : 0;
        n_dark += (-d[k] > threshold) ? 1 : 0;
      }
      if (n_bright >= 2 || n_dark >= 2) {
        float v_bright, min_of_max;
        arc_extrema(d, v_bright, min_of_max);
        const float sc = fmaxf(v_bright, -min_of_max);
        score = (sc > threshold) ? sc : 0.0f;
      }
    }
    s_sc[r][c] = score;
  }
  __syncthreads();

  // 3. 3x3 NMS: strictly greater than the earlier neighbours, >= the later
  for (int ty = threadIdx.y; ty < TILE; ty += BLOCK_Y) {
    const int gy = y0 + ty;
    const int gx = x0 + threadIdx.x;
    if (gy >= h || gx >= w) continue;
    const int r = ty + 1;
    const int c = threadIdx.x + 1;
    const float center = s_sc[r][c];
    const float earlier = fmaxf(fmaxf(s_sc[r - 1][c - 1], s_sc[r - 1][c]),
                                fmaxf(s_sc[r - 1][c + 1], s_sc[r][c - 1]));
    const float later = fmaxf(fmaxf(s_sc[r][c + 1], s_sc[r + 1][c - 1]),
                              fmaxf(s_sc[r + 1][c], s_sc[r + 1][c + 1]));
    const bool keep = (center > earlier) && (center >= later);
    out[(size_t)gy * w + gx] = keep ? center : 0.0f;
  }
}

}  // namespace

// in/out: n device pointers each, (h[i], w[i]) float32 row-major; n <= MAX_LEVELS.
// Returns the cudaError of the launch, or cudaErrorInvalidValue for a
// level count or size the table cannot hold.
extern "C" int mo3_fast_score_nms_levels(const void* const* in, void* const* out,
                                         const int* h, const int* w, int n,
                                         float threshold, void* stream) {
  if (n < 1 || n > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  LevelTable t = {};
  t.n = n;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (h[i] < 1 || w[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    t.in[i] = static_cast<const float*>(in[i]);
    t.out[i] = static_cast<float*>(out[i]);
    t.h[i] = h[i];
    t.w[i] = w[i];
    t.tiles_x[i] = (w[i] + TILE - 1) / TILE;
    t.tile0[i] = tiles;
    tiles += t.tiles_x[i] * ((h[i] + TILE - 1) / TILE);
  }
  t.tile0[n] = tiles;
  const dim3 block(BLOCK_X, BLOCK_Y);
  fast_score_nms_levels_kernel<<<tiles, block, 0, static_cast<cudaStream_t>(stream)>>>(
      t, threshold);
  return static_cast<int>(cudaGetLastError());
}
