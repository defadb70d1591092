"""Visual-inertial windowed bundle adjustment (counterpart of
multi_orbslam3_tpu/opt/inertial_ba.py).

Each window keyframe carries a 15-dim state [xi_cam(6), v(3), bg(3),
ba(3)]; the reduced camera system is local_ba's dense-E Schur over 15-dim
camera blocks, with the preintegration factors and bias random-walk
factors between consecutive keyframes added to it. The visual Jacobians
are analytic; the 9-dim inertial residual is differentiated by forward-mode
autodiff at delta = 0.

The residual is written over a batch of keyframe pairs, and its Jacobian
is taken with one tangent per delta coordinate for all pairs at once
(``jacobian_at_zero``): the pairs are a batch axis of the function, not a
``vmap`` axis, and the whitening (a triangular solve with a factor that
does not depend on the delta) is applied to the residual and the Jacobian
afterwards, outside the differentiated function.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3, so3
from multi_orbslam3_tpu_torch.imu.preintegration import Preintegrated
from multi_orbslam3_tpu_torch.opt import robust
from multi_orbslam3_tpu_torch.opt.local_ba import (BAObservations, _add_diag_blocks,
                                                   _obs_terms, inv3x3)

D = 15  # per-KF state dim

# don't trust the IMU below this (rad / m/s / m): keeps the whitened
# information <= ~1e6 so float32 normal equations stay sane
INFO_FLOOR = 1e-3


class InertialBAResult(NamedTuple):
    poses: torch.Tensor       # (Kw, 4, 4) T_cw
    velocities: torch.Tensor  # (Kw, 3)
    bg: torch.Tensor          # (Kw, 3)
    ba: torch.Tensor          # (Kw, 3)
    points: torch.Tensor      # (Pw, 3)
    inliers: torch.Tensor     # (O,) visual inlier mask
    chi2: torch.Tensor


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", A, x)


def preint_residual(T_cw_i, T_cw_j, v_i, v_j, bg, ba, pre: Preintegrated,
                    g_w, T_bc) -> torch.Tensor:
    """Unwhitened 9-dim preintegration residual (rotation, velocity,
    position) between states i and j, over a batch of pairs (E, ...). The
    body pose is T_wb = (T_bc T_cw)^-1; bg/ba are the biases of state i."""
    T_wb_i = se3.inverse(T_bc @ T_cw_i)
    T_wb_j = se3.inverse(T_bc @ T_cw_j)
    RiT = se3.rotation(T_wb_i).transpose(-1, -2)
    Rj = se3.rotation(T_wb_j)
    p_i = se3.translation(T_wb_i)
    p_j = se3.translation(T_wb_j)
    dbg = bg - pre.bg
    dba = ba - pre.ba
    dt = pre.dT[..., None]
    dR = pre.dR @ so3.exp(_mv(pre.JRg, dbg))
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    r_R = so3.log(dR.transpose(-1, -2) @ RiT @ Rj)
    r_v = _mv(RiT, v_j - v_i - g_w * dt) - dV
    r_p = _mv(RiT, p_j - p_i - v_i * dt - 0.5 * g_w * dt * dt) - dP
    return torch.cat([r_R, r_v, r_p], dim=-1)


def jacobian_at_zero(fn: Callable, like: torch.Tensor, n: int) -> torch.Tensor:
    """d fn / d delta at delta = 0 for fn: (E, n) -> (E, m) whose row e
    depends on delta row e only: (E, m, n). One forward-mode pass per delta
    coordinate, all rows at once. Nothing in it is 0-d: forward AD of a
    0-d tensor combined with a Python float yields a float64 tangent."""
    E = like.shape[0]
    zero = torch.zeros((E, n), dtype=like.dtype, device=like.device)

    def column(t):
        return torch.func.jvp(fn, (zero,), (t.expand(E, n),))[1]

    J = torch.func.vmap(column)(torch.eye(n, dtype=like.dtype, device=like.device))
    return J.permute(1, 2, 0)


def whitening_factor(cov: torch.Tensor, floor: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of cov + diag(floor^2), (..., 9, 9)."""
    return torch.linalg.cholesky_ex(cov + torch.diag(floor ** 2))[0]


def whiten(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L^-1 x for a residual (..., 9) or a Jacobian (..., 9, n)."""
    if x.dim() == L.dim() - 1:
        return torch.linalg.solve_triangular(L, x[..., None], upper=False)[..., 0]
    return torch.linalg.solve_triangular(L, x, upper=False)


def _info_floor(like: torch.Tensor) -> torch.Tensor:
    return torch.full((9,), INFO_FLOOR, dtype=like.dtype, device=like.device)


def pair_terms(poses, v, bg, ba, preints: Preintegrated, g_w, T_bc,
               jacobians: bool = True):
    """Whitened residual (Kw-1, 9) of every consecutive pair (i, i+1) with
    the window preints[i+1], and its Jacobians wrt the two states' 15-dim
    deltas (Kw-1, 9, 15) each."""
    pre = Preintegrated(*(f[1:] for f in preints))
    Ti, Tj = poses[:-1], poses[1:]
    vi, vj = v[:-1], v[1:]
    bgi, bai = bg[:-1], ba[:-1]
    L = whitening_factor(pre.cov, _info_floor(poses))

    def res(d_i, d_j):
        return preint_residual(
            se3.retract(Ti, d_i[:, :6]), se3.retract(Tj, d_j[:, :6]),
            vi + d_i[:, 6:9], vj + d_j[:, 6:9], bgi + d_i[:, 9:12],
            bai + d_i[:, 12:15], pre, g_w, T_bc)

    zero = torch.zeros((Ti.shape[0], D), dtype=poses.dtype, device=poses.device)
    r = whiten(L, res(zero, zero))
    if not jacobians:
        return r, None, None
    Ji = jacobian_at_zero(lambda d: res(d, zero), zero, D)
    Jj = jacobian_at_zero(lambda d: res(zero, d), zero, D)
    return r, whiten(L, Ji), whiten(L, Jj)


def _diag_embed_blocks(S: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """S (Kw,D,Kw,D) + the block-diagonal of diag matrices of diag (Kw,D)."""
    return _add_diag_blocks(S, torch.diag_embed(diag))


def inertial_bundle_adjust(poses: torch.Tensor, velocities: torch.Tensor,
                           bg: torch.Tensor, ba: torch.Tensor,
                           fixed: torch.Tensor, points: torch.Tensor,
                           obs: BAObservations, preints: Preintegrated,
                           pair_valid: torch.Tensor, K: cam.PinholeK,
                           g_w: torch.Tensor, T_bc: torch.Tensor,
                           iters: int = 8,
                           chi2_th: float = robust.CHI2_MONO,
                           inertial_weight: float = 1.0,
                           gyro_walk2: float = (1.9e-5) ** 2,
                           acc_walk2: float = (3.0e-3) ** 2,
                           fix_points: bool = False,
                           point_fixed=None) -> InertialBAResult:
    """poses: (Kw,4,4) T_cw in temporal order; preints entry i holds the
    window KF[i-1] -> KF[i] (entry 0 unused); pair_valid: (Kw,) whether
    that window exists. Landmarks are eliminated via the dense-E Schur
    complement. fix_points holds every landmark at its input position;
    point_fixed (Pw,) holds some (their observations act as pose-only
    factors). Fixed keyframes clamp only their pose dims: velocity and
    biases stay free."""
    Kw = poses.shape[0]
    Pw = points.shape[0]
    dev, dt = poses.device, poses.dtype
    free = ~fixed
    kf = obs.kf.long()
    pt = obs.pt.long()
    eye3 = torch.eye(3, dtype=dt, device=dev)
    pv = pair_valid[1:]
    dts = torch.clamp(preints.dT[1:], min=1e-3)
    w_bg = torch.where(pv, 1.0 / (gyro_walk2 * dts), 0.0)
    w_ba = torch.where(pv, 1.0 / (acc_walk2 * dts), 0.0)
    w_in = torch.where(pv, inertial_weight, 0.0)
    ii = torch.arange(0, Kw - 1, device=dev)
    jj = ii + 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def energy(carry):
        poses_, v_, bg_, ba_, points_ = carry
        r, _, _, behind = _obs_terms(poses_, points_, obs, K)
        c2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        rho = torch.where(c2 <= chi2_th, c2,
                          2.0 * torch.sqrt(chi2_th * torch.clamp(c2, min=0.0))
                          - chi2_th)
        e_vis = torch.sum(torch.where(obs.valid & ~behind, rho, 0.0))
        r_in, _, _ = pair_terms(poses_, v_, bg_, ba_, preints, g_w, T_bc,
                                jacobians=False)
        e_in = torch.sum(torch.where(pv, torch.sum(r_in * r_in, -1), 0.0))
        e_rw = torch.sum(torch.where(
            pv,
            torch.sum((bg_[1:] - bg_[:-1]) ** 2, -1) / (gyro_walk2 * dts)
            + torch.sum((ba_[1:] - ba_[:-1]) ** 2, -1) / (acc_walk2 * dts),
            0.0))
        return e_vis + inertial_weight * e_in + e_rw

    def step(carry, lam):
        poses_, v_, bg_, ba_, points_ = carry
        # ---------------- visual part (analytic) ----------------
        r, J_cam6, J_pt, behind = _obs_terms(poses_, points_, obs, K)
        if point_fixed is not None:
            J_pt = J_pt * (~point_fixed)[pt].to(dt)[:, None, None]
        c2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        w = robust.huber_weight(c2, chi2_th) * obs.inv_sigma2
        w = torch.where(obs.valid & ~behind, w, 0.0)
        J_cam = torch.cat([J_cam6, zeros(*J_cam6.shape[:-1], D - 6)], dim=-1)
        Jc_w = J_cam * w[:, None, None]
        Jp_w = J_pt * w[:, None, None]
        Hcc = zeros(Kw, D, D).index_add(
            0, kf, torch.einsum("ori,orj->oij", J_cam, Jc_w))
        b_c = zeros(Kw, D).index_add(0, kf, torch.einsum("ori,or->oi", Jc_w, r))
        if not fix_points:
            Hpp = zeros(Pw, 3, 3).index_add(
                0, pt, torch.einsum("ori,orj->oij", J_pt, Jp_w))
            b_p = zeros(Pw, 3).index_add(
                0, pt, torch.einsum("ori,or->oi", Jp_w, r))
            E = zeros(Kw * Pw, D, 3).index_add(
                0, kf * Pw + pt, torch.einsum("ori,orj->oij", Jc_w, J_pt)
            ).reshape(Kw, Pw, D, 3)

        # ---------------- inertial pairs (autodiff) ----------------
        r_in, Ji, Jj = pair_terms(poses_, v_, bg_, ba_, preints, g_w, T_bc)
        Jiw = Ji * w_in[:, None, None]
        Jjw = Jj * w_in[:, None, None]
        # bias random walk between consecutive keyframes: information
        # 1 / (walk variance * dt) on the (bg, ba) diagonal blocks
        rw = torch.cat([zeros(Kw - 1, 9), w_bg[:, None].expand(-1, 3),
                        w_ba[:, None].expand(-1, 3)], dim=-1)          # (Kw-1, D)
        r_rw = torch.cat([zeros(Kw - 1, 9), bg_[1:] - bg_[:-1],
                          ba_[1:] - ba_[:-1]], dim=-1)
        H_ii = torch.einsum("eri,erj->eij", Ji, Jiw) + torch.diag_embed(rw)
        H_jj = torch.einsum("eri,erj->eij", Jj, Jjw) + torch.diag_embed(rw)
        H_ij = torch.einsum("eri,erj->eij", Ji, Jjw) - torch.diag_embed(rw)
        Hcc = Hcc.index_add(0, ii, H_ii).index_add(0, jj, H_jj)
        Hij = zeros(Kw, D, Kw, D)
        Hij[ii, :, jj, :] = H_ij                      # fresh tensor, distinct
        Hij[jj, :, ii, :] = H_ij.transpose(-1, -2)    # blocks: in place is safe
        b_c = b_c.index_add(0, ii, torch.einsum("eri,er->ei", Jiw, r_in) - rw * r_rw)
        b_c = b_c.index_add(0, jj, torch.einsum("eri,er->ei", Jjw, r_in) + rw * r_rw)

        # ---------------- Schur + solve ----------------
        if fix_points:
            S = Hij
        else:
            hpp_diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
            pt_seen = hpp_diag.sum(-1) > 1e-9
            Hpp_d = Hpp + lam * torch.clamp(hpp_diag.mean(-1), min=1e-3)[:, None, None] * eye3
            C_inv = inv3x3(torch.where(pt_seen[:, None, None], Hpp_d, eye3))
            EC = torch.einsum("kpab,pbc->kpac", E, C_inv)
            A = EC.permute(0, 2, 1, 3).reshape(Kw * D, Pw * 3)
            B = E.permute(0, 2, 1, 3).reshape(Kw * D, Pw * 3)
            S = Hij - (A @ B.T).reshape(Kw, D, Kw, D)
        # per-entry Marquardt damping: the state mixes pixel-scale visual
        # blocks with dt-scale velocity blocks
        diag = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        S = _add_diag_blocks(S, Hcc + torch.diag_embed(lam * diag + 1e-8))
        rhs = b_c if fix_points else b_c - torch.einsum("kpac,pc->ka", EC, b_p)
        fm = torch.cat([free.to(dt)[:, None].expand(-1, 6),
                        torch.ones((Kw, D - 6), dtype=dt, device=dev)], dim=-1)
        S = S * fm[:, :, None, None] * fm[None, None, :, :]
        S = _diag_embed_blocks(S, 1.0 - fm)
        rhs = rhs * fm
        Sf = S.reshape(Kw * D, Kw * D) + 1e-8 * torch.eye(Kw * D, dtype=dt, device=dev)
        # Jacobi equilibration: whitened inertial blocks and visual pixel
        # blocks put cond(S) beyond a float32 factorization
        d = torch.sqrt(torch.clamp(torch.diagonal(Sf), min=1e-12))
        Se = Sf / d[:, None] / d[None, :]
        dx = (torch.linalg.solve_ex(Se, -rhs.reshape(-1) / d)[0] / d).reshape(Kw, D)
        dx = dx * fm
        if fix_points:
            dp = torch.zeros_like(points_)
        else:
            Et_dx = torch.einsum("kpac,ka->pc", E, dx)
            dp = -torch.einsum("pab,pb->pa", C_inv, b_p + Et_dx)
            dp = torch.where(pt_seen[:, None], dp, 0.0)
        finite = torch.isfinite(dx).all() & torch.isfinite(dp).all()
        dx = torch.where(finite, dx, 0.0)
        dp = torch.where(finite, dp, 0.0)
        new_poses = se3.normalize(se3.retract(poses_, dx[:, :6]))
        return (new_poses, v_ + dx[:, 6:9], bg_ + dx[:, 9:12],
                ba_ + dx[:, 12:15], points_ + dp)

    carry = (poses, velocities, bg, ba, points)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    e_prev = energy(carry)
    for _ in range(iters):
        cand = step(carry, lam)
        e_new = energy(cand)
        accept = e_new < e_prev
        carry = tuple(torch.where(accept, a, b) for a, b in zip(cand, carry))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 5.0, max=1e2))
        e_prev = torch.where(accept, e_new, e_prev)

    poses_f, v_f, bg_f, ba_f, points_f = carry
    r, _, _, behind = _obs_terms(poses_f, points_f, obs, K)
    c2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    inliers = obs.valid & ~behind & (c2 <= chi2_th)
    n_in = torch.clamp(torch.sum(inliers.to(torch.int32)), min=1)
    return InertialBAResult(
        poses=poses_f, velocities=v_f, bg=bg_f, ba=ba_f, points=points_f,
        inliers=inliers, chi2=torch.sum(torch.where(inliers, c2, 0.0)) / n_in)
