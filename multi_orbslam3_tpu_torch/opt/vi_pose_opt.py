"""Per-frame visual-inertial pose optimisation (counterpart of
multi_orbslam3_tpu/opt/vi_pose_opt.py).

Every tracked frame fuses its Huber-weighted reprojection residuals with
the IMU preintegration factor from the previous frame and a bias
random-walk prior. The current frame carries a 15-dim state [xi_cam(6),
v(3), bg(3), ba(3)]; the previous state is held fixed. Visual Jacobians
are analytic (shared with pose_opt); the 9-dim inertial residual is
differentiated with forward-mode autodiff at delta = 0, as a batch of one
pair (see opt/inertial_ba.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3
from multi_orbslam3_tpu_torch.imu.preintegration import Preintegrated
from multi_orbslam3_tpu_torch.opt import robust
from multi_orbslam3_tpu_torch.opt.inertial_ba import (INFO_FLOOR, jacobian_at_zero,
                                                      preint_residual, whiten,
                                                      whitening_factor)
from multi_orbslam3_tpu_torch.opt.pose_opt import _residual_jac

D = 15


class VIPoseResult(NamedTuple):
    pose: torch.Tensor       # (4, 4) optimized T_cw
    velocity: torch.Tensor   # (3,) world-frame body velocity
    bg: torch.Tensor         # (3,)
    ba: torch.Tensor         # (3,)
    inliers: torch.Tensor    # (M,) final visual inlier mask
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # () inertial residual chi2 (diagnostic)


def inertial_terms(T_cw, v, bg, ba, T_prev_cw, v_prev, pre: Preintegrated,
                   g_w, T_bc, jacobian: bool = True):
    """Whitened 9-dim preintegration residual (prev -> cur) and its (9, 15)
    Jacobian wrt the current frame's delta; the previous state is fixed."""
    pre1 = Preintegrated(*(f[None] for f in pre))
    floor = torch.full((9,), INFO_FLOOR, dtype=T_cw.dtype, device=T_cw.device)
    L = whitening_factor(pre1.cov, floor)

    def res(d):
        return preint_residual(
            T_prev_cw[None], se3.retract(T_cw[None], d[:, :6]), v_prev[None],
            v[None] + d[:, 6:9], bg[None] + d[:, 9:12], ba[None] + d[:, 12:15],
            pre1, g_w, T_bc)

    zero = torch.zeros((1, D), dtype=T_cw.dtype, device=T_cw.device)
    r = whiten(L, res(zero))[0]
    if not jacobian:
        return r, None
    return r, whiten(L, jacobian_at_zero(res, zero, D))[0]


def pose_inertial_optimization(
        T_init: torch.Tensor, v_init: torch.Tensor,
        bg_init: torch.Tensor, ba_init: torch.Tensor,
        T_prev: torch.Tensor, v_prev: torch.Tensor,
        bg_prev: torch.Tensor, ba_prev: torch.Tensor,
        preint: Preintegrated,
        K: cam.PinholeK, p_world: torch.Tensor, uv_obs: torch.Tensor,
        inv_sigma2: torch.Tensor, mask: torch.Tensor,
        g_w: torch.Tensor, T_bc: torch.Tensor,
        rounds: int = 2, iters: int = 5,
        chi2_th: float = robust.CHI2_MONO,
        gyro_walk2: float = (1.9e-5) ** 2,
        acc_walk2: float = (3.0e-3) ** 2) -> VIPoseResult:
    """Optimize the current frame's [pose, velocity, biases] against the
    visual observations (as in pose_optimization) plus the preintegration
    factor from the fixed previous state and a bias random-walk prior
    anchored at the previous biases."""
    dev, dt = T_init.device, T_init.dtype
    lm_lambda = 1e-3
    dts = torch.clamp(preint.dT, min=1e-3)
    # the prior's information on the (bg, ba) diagonal
    w_prior = torch.cat([torch.zeros(9, dtype=dt, device=dev),
                         (1.0 / (gyro_walk2 * dts)).expand(3),
                         (1.0 / (acc_walk2 * dts)).expand(3)])
    zero9 = torch.zeros(9, dtype=dt, device=dev)
    eyeD = torch.eye(D, dtype=dt, device=dev)

    def visual_chi2(T):
        r, _, behind = _residual_jac(T, K, p_world, uv_obs)
        return torch.sum(r * r, dim=-1) * inv_sigma2, behind

    T, v, bg, ba, active = T_init, v_init, bg_init, ba_init, mask
    for _ in range(rounds):
        for _ in range(iters):
            # visual part (analytic, pose dims only)
            r, J6, behind = _residual_jac(T, K, p_world, uv_obs)
            c2 = torch.sum(r * r, dim=-1) * inv_sigma2
            w = robust.huber_weight(c2, chi2_th) * inv_sigma2
            w = torch.where(active & ~behind, w, 0.0)
            J6w = J6 * w[:, None, None]
            H_vis = torch.einsum("mri,mrj->ij", J6w, J6)
            b_vis = torch.einsum("mri,mr->i", J6w, r)
            # inertial factor (autodiff at delta = 0)
            r_in, J_in = inertial_terms(T, v, bg, ba, T_prev, v_prev, preint,
                                        g_w, T_bc)
            H = torch.nn.functional.pad(H_vis, (0, D - 6, 0, D - 6)) \
                + J_in.T @ J_in + torch.diag(w_prior)
            b = torch.nn.functional.pad(b_vis, (0, D - 6)) + J_in.T @ r_in \
                + w_prior * torch.cat([zero9, bg - bg_prev, ba - ba_prev])
            # damped solve with Jacobi equilibration (the state mixes
            # pixel-scale and m/s-scale blocks)
            Hd = H + lm_lambda * torch.diag(torch.diagonal(H)) + 1e-8 * eyeD
            d = torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12))
            He = Hd / d[:, None] / d[None, :]
            dx = torch.linalg.solve_ex(He, -b / d)[0] / d
            dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
            T = se3.normalize(se3.retract(T, dx[:6]))
            v, bg, ba = v + dx[6:9], bg + dx[9:12], ba + dx[12:15]
        c2, behind = visual_chi2(T)
        active = mask & (c2 <= chi2_th) & ~behind
    c2, behind = visual_chi2(T)
    inliers = mask & (c2 <= chi2_th) & ~behind
    r_in, _ = inertial_terms(T, v, bg, ba, T_prev, v_prev, preint, g_w, T_bc,
                             jacobian=False)
    return VIPoseResult(pose=T, velocity=v, bg=bg, ba=ba, inliers=inliers,
                        n_inliers=torch.sum(inliers.to(torch.int32)).to(torch.int32),
                        chi2=torch.sum(r_in * r_in))
