"""Motion-only pose optimisation (counterpart of
multi_orbslam3_tpu/opt/pose_opt.py): Gauss-Newton with light LM damping on
one SE(3) pose, Huber-weighted reprojection residuals over a fixed-size
masked observation batch, a fixed (rounds x iters) schedule with inlier
re-classification between rounds. Observations with a stereo right-u
measurement add a third residual row and take the 3-dof chi2 threshold.

Dispatch is by the tensors' device: CPU tensors take the plain version
(pose_optimization_ref), CUDA tensors one launch of csrc/pose_opt.cu
(frontend/kernels.pose_optimization), or raise. pose_opt_kernel_model is
the CPU model of that kernel's arithmetic, for the tests."""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3, so3
from multi_orbslam3_tpu_torch.opt import robust


class PoseOptResult(NamedTuple):
    pose: torch.Tensor       # (4, 4) optimized T_cw
    inliers: torch.Tensor    # (M,) bool final inlier classification
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # () float32 total inlier chi2


def point_jacobian_se3(p_c: torch.Tensor) -> torch.Tensor:
    """d p_c / d xi for a left perturbation xi = (omega, v): (..., 3, 6)."""
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(
        p_c.shape[:-1] + (3, 3))
    return torch.cat([-so3.hat(p_c), eye], dim=-1)


def stereo_rows(K: cam.PinholeK, p_c: torch.Tensor, u_r: torch.Tensor, bf):
    """The right-u residual (...,) and its Jacobian wrt p_c (..., 3):
    u_r_pred = fx x/z + cx - bf/z. Both are zeroed on monocular
    observations (u_r < 0), so they add no information."""
    st = (u_r >= 0).to(p_c.dtype)
    x = p_c[..., 0]
    z = torch.clamp(p_c[..., 2], min=1e-6)
    ur_pred = K.fx * x / z + K.cx - bf / z
    J_ur = st[..., None] * torch.stack(
        [K.fx / z, torch.zeros_like(z), (bf - K.fx * x) / (z * z)], dim=-1)
    return st * (ur_pred - u_r), J_ur


def projection_terms(K: cam.PinholeK, p_c: torch.Tensor, uv: torch.Tensor,
                     u_r=None, bf=0.0):
    """Residual (..., R) and d residual / d p_c (..., R, 3); R = 2, or 3
    when stereo right-u measurements are given."""
    r = cam.project(K, p_c) - uv
    Jproj = cam.project_jacobian(K, p_c)
    if u_r is not None:
        r_ur, J_ur = stereo_rows(K, p_c, u_r, bf)
        r = torch.cat([r, r_ur[..., None]], dim=-1)
        Jproj = torch.cat([Jproj, J_ur[..., None, :]], dim=-2)
    return r, Jproj


def _residual_jac(T: torch.Tensor, K: cam.PinholeK, p_w: torch.Tensor,
                  uv: torch.Tensor, u_r=None, bf=0.0):
    """Residuals (M, R), Jacobians (M, R, 6) and the behind-camera mask."""
    p_c = se3.apply(T, p_w)
    r, Jproj = projection_terms(K, p_c, uv, u_r, bf)
    return r, Jproj @ point_jacobian_se3(p_c), p_c[..., 2] <= 1e-3


def pose_optimization(T_init: torch.Tensor, K: cam.PinholeK,
                      p_world: torch.Tensor, uv_obs: torch.Tensor,
                      inv_sigma2: torch.Tensor, mask: torch.Tensor,
                      rounds: int = 4, iters: int = 10,
                      chi2_th: float = robust.CHI2_MONO,
                      u_r=None, bf=0.0) -> PoseOptResult:
    """p_world (M, 3), uv_obs (M, 2), inv_sigma2 (M,), mask (M,); u_r
    optional (M,) stereo right-u (-1 monocular), bf = baseline * fx (a
    number). CPU tensors: the plain version; CUDA tensors: the kernel."""
    tensors = (T_init, p_world, uv_obs, inv_sigma2, mask) + (() if u_r is None else (u_r,))
    if kernels._all_cpu(*tensors):
        return pose_optimization_ref(T_init, K, p_world, uv_obs, inv_sigma2, mask,
                                     rounds, iters, chi2_th, u_r, bf)
    dev = p_world.device
    cam4 = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
                        for v in K])
    pose, inliers, n_inliers, chi2 = kernels.pose_optimization(
        T_init.contiguous(), cam4, p_world.contiguous(), uv_obs.contiguous(),
        inv_sigma2.contiguous(), mask.contiguous(), rounds, iters, chi2_th,
        None if u_r is None else u_r.contiguous(), bf)
    return PoseOptResult(pose=pose, inliers=inliers, n_inliers=n_inliers, chi2=chi2)


def pose_optimization_ref(T_init: torch.Tensor, K: cam.PinholeK,
                          p_world: torch.Tensor, uv_obs: torch.Tensor,
                          inv_sigma2: torch.Tensor, mask: torch.Tensor,
                          rounds: int = 4, iters: int = 10,
                          chi2_th: float = robust.CHI2_MONO,
                          u_r=None, bf=0.0) -> PoseOptResult:
    """The plain version: the JAX package's loop, one tensor op at a time."""
    lm_lambda = 1e-3
    if u_r is not None:
        chi2_th = torch.where(u_r >= 0, robust.CHI2_STEREO, chi2_th)
    eye6 = torch.eye(6, dtype=T_init.dtype, device=T_init.device)

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    T, active = T_init, mask
    for _ in range(rounds):
        for _ in range(iters):
            r, J, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
            w = robust.huber_weight(chi2_of(r), chi2_th) * inv_sigma2
            w = torch.where(active & ~behind, w, 0.0)
            Jw = J * w[:, None, None]
            H = torch.einsum("mri,mrj->ij", Jw, J)
            b = torch.einsum("mri,mr->i", Jw, r)
            H = H + lm_lambda * torch.diag(torch.diagonal(H)) + 1e-6 * eye6
            dx = torch.linalg.solve_ex(H, -b)[0]
            T_new = se3.normalize(se3.retract(T, dx))
            T = torch.where(torch.isfinite(dx).all(), T_new, T)
        r, _, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
        active = mask & (chi2_of(r) <= chi2_th) & ~behind
    r, _, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
    chi2 = chi2_of(r)
    inliers = mask & (chi2 <= chi2_th) & ~behind
    return PoseOptResult(pose=T, inliers=inliers,
                         n_inliers=torch.sum(inliers.to(torch.int32)).to(torch.int32),
                         chi2=torch.sum(torch.where(inliers, chi2, 0.0)))


def _block_sum(terms: torch.Tensor, threads: int) -> torch.Tensor:
    """csrc/pose_opt.cu's block sum of (M, N) row terms -> (N,): thread t
    adds rows t, t + threads, ... in order from 0; each warp folds its
    lanes by the shuffle tree (offsets 16, 8, 4, 2, 1); the warp partials
    are added in warp order."""
    m, n = terms.shape
    per = -(-m // threads)
    pad = torch.zeros((per * threads, n), dtype=terms.dtype, device=terms.device)
    pad[:m] = terms
    acc = torch.zeros((threads, n), dtype=terms.dtype, device=terms.device)
    lanes = torch.arange(threads, device=terms.device)
    for k in range(per):
        live = (lanes + k * threads < m)[:, None]
        acc = torch.where(live, acc + pad[k * threads:(k + 1) * threads], acc)
    v = acc.reshape(threads // 32, 32, n)
    for off in (16, 8, 4, 2, 1):
        v = v[:, :off] + v[:, off:2 * off]
    s = v[0, 0]
    for w in range(1, threads // 32):
        s = s + v[w, 0]
    return s


def _gn_step_model(sums: torch.Tensor, T: torch.Tensor, f) -> torch.Tensor:
    """csrc/pose_opt.cu's gn_step, one 0-dim op at a time: damp, LU with
    partial pivoting (the first largest pivot), back substitution; T where
    dx is not finite, else normalize(exp(dx) T)."""
    s = list(sums.unbind(0))
    A = [[None] * 7 for _ in range(6)]
    t = 0
    for i in range(6):
        for j in range(i, 6):
            A[i][j] = A[j][i] = s[t]
            t += 1
    for i in range(6):
        A[i][i] = (A[i][i] + f(1e-3) * A[i][i]) + f(1e-6)
        A[i][6] = -s[21 + i]
    for k in range(6):
        p, best = k, torch.abs(A[k][k])
        for i in range(k + 1, 6):
            if bool(torch.abs(A[i][k]) > best):
                p, best = i, torch.abs(A[i][k])
        A[k], A[p] = A[p], A[k]
        for i in range(k + 1, 6):
            lk = A[i][k] / A[k][k]
            for j in range(k + 1, 7):
                A[i][j] = A[i][j] - lk * A[k][j]
    x = [None] * 6
    for i in range(5, -1, -1):
        acc = A[i][6]
        for j in range(i + 1, 6):
            acc = acc - A[i][j] * x[j]
        x[i] = acc / A[i][i]
    if not all(bool(torch.isfinite(v)) for v in x):
        return T
    zero, one = f(0.0), f(1.0)
    W = [[zero, -x[2], x[1]], [x[2], zero, -x[0]], [-x[1], x[0], zero]]
    th2 = (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]
    th = torch.sqrt(th2 + f(1e-16))
    sn, cs = torch.sin(th), torch.cos(th)
    if bool(th < f(1e-4)):
        a, b = one - th2 / f(6.0), f(0.5) - th2 / f(24.0)
        c = f(1.0 / 6.0) - th2 / f(120.0)
    else:
        a, b = sn / th, (one - cs) / (th2 + f(1e-8))
        c = (th - sn) / (th2 * th + f(1e-8))
    E = [[None] * 4 for _ in range(3)]
    for i in range(3):
        Jr = [None] * 3
        for j in range(3):
            WW = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j]
            eye = one if i == j else zero
            E[i][j] = (eye + a * W[i][j]) + b * WW
            Jr[j] = (eye - b * (-W[i][j])) + c * WW
        E[i][3] = (Jr[0] * x[3] + Jr[1] * x[4]) + Jr[2] * x[5]
    N = [[((E[i][0] * T[0, j] + E[i][1] * T[1, j]) + E[i][2] * T[2, j]) + E[i][3] * T[3, j]
          for j in range(4)] for i in range(3)]
    for _ in range(2):
        S = [[(N[i][0] * N[j][0] + N[i][1] * N[j][1]) + N[i][2] * N[j][2] for j in range(3)]
             for i in range(3)]
        R = [[f(1.5) * N[i][j]
              - f(0.5) * ((S[i][0] * N[0][j] + S[i][1] * N[1][j]) + S[i][2] * N[2][j])
              for j in range(3)] for i in range(3)]
        N = [R[i] + [N[i][3]] for i in range(3)]
    return torch.stack([torch.stack(row) for row in N]
                       + [torch.stack([zero, zero, zero, one])])


def pose_opt_kernel_model(T_init: torch.Tensor, K: cam.PinholeK,
                          p_world: torch.Tensor, uv_obs: torch.Tensor,
                          inv_sigma2: torch.Tensor, mask: torch.Tensor,
                          rounds: int = 4, iters: int = 10,
                          chi2_th: float = robust.CHI2_MONO, u_r=None, bf=0.0,
                          threads: int = kernels.POSE_THREADS) -> PoseOptResult:
    """CPU model of csrc/pose_opt.cu: the kernel's arithmetic op for op in
    float32, each product and sum rounded on its own (the kernel is built
    without fused multiply-adds), every division a true one (a tensor
    divisor: torch multiplies by the reciprocal of a Python number), its
    block sums in the kernel's order (_block_sum) and its solve and
    retraction one scalar op at a time (_gn_step_model). The residual
    rows and Jacobians are _residual_jac's with the zero products left
    out, the schedule pose_optimization_ref's. On the card, where torch's
    float32 ops round as the kernel's do and sin / cos are the same
    functions, it gives the kernel's result bit for bit; on the CPU sin
    and cos may differ in the last bit. No main path runs it."""
    dev = p_world.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    fx, fy, cx, cy = (torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
                      for v in K)
    m = p_world.shape[0]
    x, y, z = p_world.unbind(-1)
    u, v = uv_obs.unbind(-1)
    stereo = u_r is not None
    th = (torch.where(u_r >= 0, f(robust.CHI2_STEREO), f(chi2_th)) if stereo
          else f(chi2_th).expand(m))
    zero, one, bf_t = f(0.0), f(1.0), f(float(bf))

    def rows(T):
        px = ((T[0, 0] * x + T[0, 1] * y) + T[0, 2] * z) + T[0, 3]
        py = ((T[1, 0] * x + T[1, 1] * y) + T[1, 2] * z) + T[1, 3]
        pz = ((T[2, 0] * x + T[2, 1] * y) + T[2, 2] * z) + T[2, 3]
        iz = one / torch.where(torch.abs(pz) < f(1e-8), f(1e-8), pz)
        r = [((fx * px) * iz + cx) - u, ((fy * py) * iz + cy) - v]
        iz2 = iz * iz
        a, b = fx * iz, (-fx * px) * iz2
        e, g = fy * iz, (-fy * py) * iz2
        zm = torch.zeros_like(px)
        J = [[b * py, a * pz - b * px, -(a * py), a, zm, b],
             [g * py - e * pz, -(g * px), e * px, zm, e, g]]
        chi2 = r[0] * r[0] + r[1] * r[1]
        if stereo:
            st = torch.where(u_r >= 0, one, zero)
            zc = torch.where(pz < f(1e-6), f(1e-6), pz)
            r.append(st * ((((fx * px) / zc + cx) - bf_t / zc) - u_r))
            chi2 = chi2 + r[2] * r[2]
            h, k = st * (fx / zc), st * ((bf_t - fx * px) / (zc * zc))
            J.append([k * py, h * pz - k * px, -(h * py), h, zm, k])
        return r, J, chi2 * inv_sigma2, pz <= f(1e-3)

    def terms(T, active):
        r, J, chi2, behind = rows(T)
        huber = torch.where(chi2 <= th, one,
                            torch.sqrt(th / torch.where(chi2 < f(1e-12), f(1e-12), chi2)))
        w = torch.where(active & ~behind, huber * inv_sigma2, zero)
        Jw = [[Jq[i] * w for i in range(6)] for Jq in J]
        out = []
        for i in range(6):
            for j in range(i, 6):
                s = Jw[0][i] * J[0][j] + Jw[1][i] * J[1][j]
                out.append(s + Jw[2][i] * J[2][j] if stereo else s)
        for i in range(6):
            s = Jw[0][i] * r[0] + Jw[1][i] * r[1]
            out.append(s + Jw[2][i] * r[2] if stereo else s)
        return torch.stack(out, dim=-1)

    T, active = T_init.to(torch.float32), mask
    for rnd in range(max(rounds, 1)):
        for _ in range(iters if rnd < rounds else 0):
            T = _gn_step_model(_block_sum(terms(T, active), threads), T, f)
        _, _, chi2, behind = rows(T)
        active = mask & (chi2 <= th) & ~behind
    chi2_in = _block_sum(torch.where(active, chi2, zero)[:, None], threads)[0]
    return PoseOptResult(pose=T, inliers=active,
                         n_inliers=torch.sum(active.to(torch.int32)).to(torch.int32),
                         chi2=chi2_in)
