// K1: fused FAST-9/16 corner score + 3x3 non-maximum suppression.
//
// Replaces the Pallas TPU kernel
//   multi_orbslam3_tpu/frontend/pallas_kernels.py::fast_score_nms
//   (kernel body _fast_nms_kernel).
// Result equals fast.nms3x3(fast.fast_score(img, threshold)) bit for bit:
// the arithmetic is float subtraction, negation, min and max only.
//
// What bounds it on an H100: one pyramid level is read once and written
// once (480x752 f32 = 1.4 MB each way at level 0), which is microseconds
// of HBM time; at these sizes the launch latency and the per-pixel work
// (16 differences, 2 x 16 arc minimums of 9, 8 NMS compares) dominate.
//
// Design: each block owns a 32x32 output tile. The input tile plus a 4-px
// halo (3 px for the Bresenham circle, 1 px for the NMS neighbourhood) is
// staged in shared memory once, with out-of-image pixels read as 0 (the
// zero padding of fast._shift2d). Scores for the tile and its 1-px apron
// go to a second shared array, with the 3-px image border and everything
// outside the image zeroed BEFORE the NMS, so border scores never
// suppress interior corners. The NMS then reads only shared memory.
// Nothing is allocated here; the wrapper owns the output tensor.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int IN_DIM = TILE + 2 * HALO;  // 40
constexpr int SC_DIM = TILE + 2;          // 34
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int ARC = 9;

// (dx, dy) of the radius-3 Bresenham circle in contiguous order
// (fast._CIRCLE).
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                                  -3, -3, -2, -1, 0, 1, 2, 3};

__global__ void fast_score_nms_kernel(const float* __restrict__ img,
                                      float* __restrict__ out, int h, int w,
                                      float threshold) {
  __shared__ float s_in[IN_DIM][IN_DIM + 1];
  __shared__ float s_sc[SC_DIM][SC_DIM + 1];

  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
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
      float v_bright = 0.0f, v_dark = 0.0f;
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        float mb = d[s];
        float md = -d[s];
#pragma unroll
        for (int k = 1; k < ARC; ++k) {
          mb = fminf(mb, d[(s + k) & 15]);
          md = fminf(md, -d[(s + k) & 15]);
        }
        v_bright = (s == 0) ? mb : fmaxf(v_bright, mb);
        v_dark = (s == 0) ? md : fmaxf(v_dark, md);
      }
      const float sc = fmaxf(v_bright, v_dark);
      score = (sc > threshold) ? sc : 0.0f;
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

extern "C" int mo3_fast_score_nms(const float* img, float* out, int h, int w,
                                  float threshold, void* stream) {
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  fast_score_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, threshold);
  return static_cast<int>(cudaGetLastError());
}
