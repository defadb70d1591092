// The motion-only pose optimisation of one pose, whole, in one launch:
// Gauss-Newton with light LM damping on one SE(3) pose, Huber-weighted
// reprojection residuals (two rows an observation, three with a stereo
// right-u), a fixed rounds x iters schedule and the inlier set
// re-classified after every round.
//
// It replaces no Pallas kernel. It is the port of the JAX package's jitted
// lax.fori_loop, multi_orbslam3_tpu/opt/pose_opt.py::pose_optimization,
// whose plain PyTorch version (opt/pose_opt.py::pose_optimization_ref)
// runs about 225 small launches an iteration.
//
// What bounds it on an H100: the latency of its rounds x iters dependent
// iterations, not bytes or flops. At the tracking call's shape (1,280
// stereo rows, 2 x 7) it reads about 40 KB once and does about 0.5 MFLOP
// an iteration, a fraction of a microsecond of either; each iteration is
// a block reduction, a 6 x 6 solve in one thread and two barriers. So the
// design is one launch of one block that keeps the observations on chip
// and waits for as few dependent latencies as it can:
//
// 1. Thread t owns rows t, t + 256, t + 512, ... It loads each once: its
//    first PO_PER rows (the block's first 2,048) into registers, the next
//    PO_SMEM_OBS rows of the block into shared memory; rows past both (m
//    above 8,192) are read again from global memory every pass, and their
//    inlier flag lives in the output. Every m takes this one launch.
// 2. Each iteration every thread computes its rows' residual, 6-column
//    Jacobian, Huber weight and the behind-camera and active masks, as
//    _residual_jac, stereo_rows and robust.huber_weight do, and sums the
//    21 upper-triangle terms of H and the 6 of b in float32, its rows in
//    index order. The block folds the 27 sums in a fixed order: a
//    shuffle tree in each warp (offsets 16, 8, 4, 2, 1), then the warps'
//    partials in warp order through shared memory. No atomics: a run
//    repeats bit for bit.
// 3. Thread 0 damps H (1e-3 diag + 1e-6 I), solves by LU with partial
//    pivoting (the first largest pivot), keeps T where dx is not finite,
//    else applies the left retraction exp(dx) T (Rodrigues with so3.exp's
//    small-angle branch, right_jacobian(-w) on the translation) and two
//    Newton steps of normalize_rotation, and hands T to the block through
//    shared memory.
// 4. After every round the block re-classifies the inliers (mask, chi2 at
//    or below its threshold, not behind); the last pass also writes the
//    inlier mask, their count (shared atomics on integers: exact) and
//    their chi2 (the fixed-order fold).
//
// Arithmetic: float32 throughout, precise sqrtf / sinf / cosf and IEEE
// division, built without fused multiply-adds (-fmad=false, kernels.py),
// so each product and sum rounds as a separate tensor op of the plain
// version does; opt/pose_opt.py::pose_opt_kernel_model repeats the
// kernel's order op for op.
//
// Nothing is allocated here and nothing is read back: the outputs are
// device tensors the wrapper owns, so a caller's step stays sync-free and
// capturable in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int PO_THREADS = 256;
constexpr int PO_WARPS = PO_THREADS / 32;
constexpr int PO_TERMS = 27;         // H's upper triangle (21), then b (6)
constexpr int PO_PER = 8;            // rows a thread keeps in registers
constexpr int PO_SMEM_OBS = 6144;    // rows past those, in shared memory
constexpr int PO_MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned MASKED_IN = 1u;   // the caller's mask
constexpr unsigned ACTIVE = 2u;      // in this round's inlier set
constexpr float CHI2_STEREO = 7.815f;

static_assert(PO_SMEM_OBS % PO_THREADS == 0, "rows stay strided by the block");

struct Obs {
  float x, y, z, u, v, ur, isig2;
  unsigned flags;
};

struct Args {
  const float* T_init;    // (4, 4)
  const float* cam;       // fx, fy, cx, cy
  const float* p_world;   // (m, 3)
  const float* uv;        // (m, 2)
  const float* isig2;     // (m,)
  const unsigned char* mask;
  const float* u_r;       // (m,) or null: no stereo rows
  int m, rounds, iters, n_smem;
  float chi2_th, bf;
  float* pose;            // (4, 4)
  unsigned char* inliers; // (m,)
  int* n_inliers;
  float* chi2;
};

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ __forceinline__ Obs load_obs(const Args& a, int i) {
  Obs o;
  o.x = __ldg(a.p_world + 3 * (size_t)i);
  o.y = __ldg(a.p_world + 3 * (size_t)i + 1);
  o.z = __ldg(a.p_world + 3 * (size_t)i + 2);
  o.u = __ldg(a.uv + 2 * (size_t)i);
  o.v = __ldg(a.uv + 2 * (size_t)i + 1);
  o.ur = a.u_r ? __ldg(a.u_r + i) : -1.0f;
  o.isig2 = __ldg(a.isig2 + i);
  o.flags = __ldg(a.mask + i) ? (MASKED_IN | ACTIVE) : 0u;
  return o;
}

// The residual rows of one observation at T, its chi2 and whether it lies
// behind the camera; with J, also the rows' Jacobians wrt the left
// perturbation (omega, v): (d residual / d p_c) [-hat(p_c) | I], written
// out without its zero products.
template <bool WITH_J>
__device__ __forceinline__ float residual(const Obs& o, const float (&T)[4][4], const Cam& c,
                                          bool stereo, float (&r)[3], float (&J)[3][6],
                                          bool& behind) {
  const float px = ((T[0][0] * o.x + T[0][1] * o.y) + T[0][2] * o.z) + T[0][3];
  const float py = ((T[1][0] * o.x + T[1][1] * o.y) + T[1][2] * o.z) + T[1][3];
  const float pz = ((T[2][0] * o.x + T[2][1] * o.y) + T[2][2] * o.z) + T[2][3];
  const float zs = fabsf(pz) < 1e-8f ? 1e-8f : pz;           // camera._safe_z
  const float iz = 1.0f / zs;
  r[0] = ((c.fx * px) * iz + c.cx) - o.u;
  r[1] = ((c.fy * py) * iz + c.cy) - o.v;
  float chi2 = r[0] * r[0] + r[1] * r[1];
  float h = 0.0f, k = 0.0f;
  if (stereo) {
    const float st = o.ur >= 0.0f ? 1.0f : 0.0f;
    const float zc = pz < 1e-6f ? 1e-6f : pz;                 // NaN stays NaN
    r[2] = st * ((((c.fx * px) / zc + c.cx) - c.bf / zc) - o.ur);
    chi2 = chi2 + r[2] * r[2];
    if (WITH_J) {
      h = st * (c.fx / zc);
      k = st * ((c.bf - c.fx * px) / (zc * zc));
    }
  }
  if (WITH_J) {
    const float iz2 = iz * iz;
    const float a = c.fx * iz, b = (-c.fx * px) * iz2;
    const float e = c.fy * iz, g = (-c.fy * py) * iz2;
    J[0][0] = b * py; J[0][1] = a * pz - b * px; J[0][2] = -(a * py);
    J[0][3] = a;      J[0][4] = 0.0f;            J[0][5] = b;
    J[1][0] = g * py - e * pz; J[1][1] = -(g * px); J[1][2] = e * px;
    J[1][3] = 0.0f;            J[1][4] = e;         J[1][5] = g;
    J[2][0] = k * py; J[2][1] = h * pz - k * px; J[2][2] = -(h * py);
    J[2][3] = h;      J[2][4] = 0.0f;            J[2][5] = k;
  }
  behind = pz <= 1e-3f;
  return chi2 * o.isig2;
}

__device__ __forceinline__ float threshold(const Obs& o, bool stereo, float chi2_th) {
  return stereo && o.ur >= 0.0f ? CHI2_STEREO : chi2_th;
}

// One observation's Gauss-Newton terms added to acc.
__device__ __forceinline__ void accumulate(const Obs& o, const float (&T)[4][4], const Cam& c,
                                           bool stereo, float chi2_th,
                                           float (&acc)[PO_TERMS]) {
  float r[3] = {0.0f, 0.0f, 0.0f}, J[3][6];
  bool behind;
  const float chi2 = residual<true>(o, T, c, stereo, r, J, behind);
  const float th = threshold(o, stereo, chi2_th);
  const float huber = chi2 <= th ? 1.0f : sqrtf(th / (chi2 < 1e-12f ? 1e-12f : chi2));
  const float w = ((o.flags & ACTIVE) && !behind) ? huber * o.isig2 : 0.0f;
  float Jw[3][6];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < 6; ++i) Jw[q][i] = J[q][i] * w;
  int t = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) {
      float s = Jw[0][i] * J[0][j] + Jw[1][i] * J[1][j];
      if (stereo) s = s + Jw[2][i] * J[2][j];
      acc[t] = acc[t] + s;
      ++t;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = Jw[0][i] * r[0] + Jw[1][i] * r[1];
    if (stereo) s = s + Jw[2][i] * r[2];
    acc[21 + i] = acc[21 + i] + s;
  }
}

// The inlier test of one observation at T: the new ACTIVE flag; on the last
// pass also its chi2 (for the total) through chi2_out.
__device__ __forceinline__ bool classify(const Obs& o, const float (&T)[4][4], const Cam& c,
                                         bool stereo, float chi2_th, float& chi2_out) {
  float r[3], J[3][6];
  bool behind;
  const float chi2 = residual<false>(o, T, c, stereo, r, J, behind);
  chi2_out = chi2;
  return (o.flags & MASKED_IN) && chi2 <= threshold(o, stereo, chi2_th) && !behind;
}

// The block's sum of N per-thread values: a shuffle tree in each warp,
// then the warps' partials in warp order by thread k < N; the sums land in
// out[] and are visible to warp 0 after its __syncwarp().
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*part)[N], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = v[k] + __shfl_down_sync(FULL, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) part[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x < N) {
    float s = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < PO_WARPS; ++w) s = s + part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncwarp();
}

// One damped Gauss-Newton step from the 27 sums, in one thread: T is
// replaced by normalize(exp(dx) T) where dx is finite.
__device__ void gn_step(const float* sums, float (&T)[4][4]) {
  float A[6][7];
  int t = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = sums[t];
      A[j][i] = sums[t];
      ++t;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = (A[i][i] + 1e-3f * A[i][i]) + 1e-6f;
    A[i][6] = -sums[21 + i];
  }
  // LU with partial pivoting on [H | -b]; the row swaps as selects keep A
  // in registers
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (i == p)
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          const float s = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = s;
        }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 7; ++j) A[i][j] = A[i][j] - l * A[k][j];
    }
  }
  float x[6];
  bool finite = true;
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * x[j];
    x[i] = s / A[i][i];
    finite = finite && isfinite(x[i]);
  }
  if (!finite) return;

  // se3.exp(dx): Rodrigues for the rotation, right_jacobian(-w) v for the
  // translation (so3's small-angle branch below theta 1e-4)
  const float W[3][3] = {{0.0f, -x[2], x[1]}, {x[2], 0.0f, -x[0]}, {-x[1], x[0], 0.0f}};
  const float th2 = (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2];
  const float th = sqrtf(th2 + 1e-16f);
  const bool small = th < 1e-4f;
  const float sn = sinf(th), cs = cosf(th);
  const float a = small ? 1.0f - th2 / 6.0f : sn / th;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - cs) / (th2 + 1e-8f);
  const float cc = small ? static_cast<float>(1.0 / 6.0) - th2 / 120.0f
                         : (th - sn) / (th2 * th + 1e-8f);
  float E[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Jr[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float WW = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j];
      const float I = i == j ? 1.0f : 0.0f;
      E[i][j] = (I + a * W[i][j]) + b * WW;
      Jr[j] = (I - b * (-W[i][j])) + cc * WW;        // hat(-w) = -hat(w)
    }
    E[i][3] = (Jr[0] * x[3] + Jr[1] * x[4]) + Jr[2] * x[5];
  }
  // exp(dx) T (rows 0-2; exp's last row is 0 0 0 1)
  float N[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      N[i][j] = ((E[i][0] * T[0][j] + E[i][1] * T[1][j]) + E[i][2] * T[2][j]) + E[i][3] * T[3][j];
  // normalize_rotation: R <- 1.5 R - 0.5 (R R^T) R, twice
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    float S[3][3], R[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        S[i][j] = (N[i][0] * N[j][0] + N[i][1] * N[j][1]) + N[i][2] * N[j][2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R[i][j] = 1.5f * N[i][j]
                  - 0.5f * ((S[i][0] * N[0][j] + S[i][1] * N[1][j]) + S[i][2] * N[2][j]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) N[i][j] = R[i][j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) T[i][j] = N[i][j];
  T[3][0] = T[3][1] = T[3][2] = 0.0f;
  T[3][3] = 1.0f;
}

__global__ void __launch_bounds__(PO_THREADS, 1) pose_opt_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char po_smem[];
  Obs* s_obs = reinterpret_cast<Obs*>(po_smem);            // [a.n_smem]
  __shared__ float s_part[PO_WARPS][PO_TERMS];
  __shared__ float s_sum[PO_TERMS];
  __shared__ float s_T[16];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int m = a.m;
  const int base_s = PO_PER * PO_THREADS, base_g = base_s + a.n_smem;
  const bool stereo = a.u_r != nullptr;
  const Cam c = {__ldg(a.cam), __ldg(a.cam + 1), __ldg(a.cam + 2), __ldg(a.cam + 3), a.bf};

  Obs reg[PO_PER];
#pragma unroll
  for (int k = 0; k < PO_PER; ++k) {
    const int i = k * PO_THREADS + tid;
    if (i < m) reg[k] = load_obs(a, i);
  }
  for (int j = tid; j < a.n_smem; j += PO_THREADS) s_obs[j] = load_obs(a, base_s + j);
  for (int i = base_g + tid; i < m; i += PO_THREADS) a.inliers[i] = a.mask[i];
  if (tid < 16) s_T[tid] = a.T_init[tid];
  if (tid == 0) s_count = 0;
  __syncthreads();
  float T[4][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i / 4][i % 4] = s_T[i];

  const int passes = a.rounds > 0 ? a.rounds : 1;
  for (int round = 0; round < passes; ++round) {
    const int iters = round < a.rounds ? a.iters : 0;
    for (int it = 0; it < iters; ++it) {
      float acc[PO_TERMS];
#pragma unroll
      for (int k = 0; k < PO_TERMS; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < PO_PER; ++k)
        if (k * PO_THREADS + tid < m) accumulate(reg[k], T, c, stereo, a.chi2_th, acc);
      for (int j = tid; j < a.n_smem; j += PO_THREADS)
        accumulate(s_obs[j], T, c, stereo, a.chi2_th, acc);
      for (int i = base_g + tid; i < m; i += PO_THREADS) {
        Obs o = load_obs(a, i);
        o.flags = (o.flags & MASKED_IN) | (a.inliers[i] ? ACTIVE : 0u);
        accumulate(o, T, c, stereo, a.chi2_th, acc);
      }
      block_sum<PO_TERMS>(acc, s_part, s_sum);
      if (tid == 0) {
        gn_step(s_sum, T);
#pragma unroll
        for (int i = 0; i < 16; ++i) s_T[i] = T[i / 4][i % 4];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 16; ++i) T[i / 4][i % 4] = s_T[i];
    }
    // re-classify; the last pass writes the outputs
    const bool last = round == passes - 1;
    float chi2_sum[1] = {0.0f};
    int count = 0;
    float chi2;
#pragma unroll
    for (int k = 0; k < PO_PER; ++k) {
      const int i = k * PO_THREADS + tid;
      if (i < m) {
        const bool in = classify(reg[k], T, c, stereo, a.chi2_th, chi2);
        reg[k].flags = (reg[k].flags & MASKED_IN) | (in ? ACTIVE : 0u);
        if (last) {
          a.inliers[i] = in;
          count += in;
          chi2_sum[0] = chi2_sum[0] + (in ? chi2 : 0.0f);
        }
      }
    }
    for (int j = tid; j < a.n_smem; j += PO_THREADS) {
      const bool in = classify(s_obs[j], T, c, stereo, a.chi2_th, chi2);
      s_obs[j].flags = (s_obs[j].flags & MASKED_IN) | (in ? ACTIVE : 0u);
      if (last) {
        a.inliers[base_s + j] = in;
        count += in;
        chi2_sum[0] = chi2_sum[0] + (in ? chi2 : 0.0f);
      }
    }
    for (int i = base_g + tid; i < m; i += PO_THREADS) {
      const bool in = classify(load_obs(a, i), T, c, stereo, a.chi2_th, chi2);
      a.inliers[i] = in;
      if (last) {
        count += in;
        chi2_sum[0] = chi2_sum[0] + (in ? chi2 : 0.0f);
      }
    }
    if (last) {
      atomicAdd(&s_count, count);
      block_sum<1>(chi2_sum, reinterpret_cast<float (*)[1]>(&s_part[0][0]), s_sum);
      if (tid == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) a.pose[i] = T[i / 4][i % 4];
        *a.n_inliers = s_count;
        *a.chi2 = s_sum[0];
      }
    }
  }
}

bool smem_ready[PO_MAX_DEVICES] = {false};

}  // namespace

extern "C" int mo3_pose_optimization(
    const float* T_init, const float* cam, const float* p_world, const float* uv,
    const float* isig2, const unsigned char* mask, const float* u_r, int m, int rounds,
    int iters, float chi2_th, float bf, float* pose, unsigned char* inliers, int* n_inliers,
    float* chi2, void* stream) {
  if (m < 0 || rounds < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= PO_MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_ready[dev]) {
    err = cudaFuncSetAttribute(pose_opt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PO_SMEM_OBS * static_cast<int>(sizeof(Obs)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_ready[dev] = true;
  }
  Args a = {};
  a.T_init = T_init; a.cam = cam; a.p_world = p_world; a.uv = uv; a.isig2 = isig2;
  a.mask = mask; a.u_r = u_r;
  a.m = m; a.rounds = rounds; a.iters = iters;
  a.chi2_th = chi2_th; a.bf = bf;
  a.pose = pose; a.inliers = inliers; a.n_inliers = n_inliers; a.chi2 = chi2;
  const int in_regs = PO_PER * PO_THREADS;
  a.n_smem = m > in_regs ? (m - in_regs < PO_SMEM_OBS ? m - in_regs : PO_SMEM_OBS) : 0;
  pose_opt_kernel<<<1, PO_THREADS, a.n_smem * sizeof(Obs), static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
