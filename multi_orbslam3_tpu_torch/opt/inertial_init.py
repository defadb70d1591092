"""Visual-inertial initialisation: gravity direction, scale, biases and
velocities from a visually tracked keyframe chain (counterpart of
multi_orbslam3_tpu/opt/inertial_init.py).

Poses stay fixed (visual odometry is trusted up to scale); the solver
estimates

    theta = [alpha, beta (gravity tilt), log s, bg(3), ba(3), v_0..K-1]

by Gauss-Newton on the 9-dim preintegration residuals between consecutive
keyframes, with the Jacobian of the whole residual stack wrt theta from
forward-mode autodiff (the problem has 9 + 3K parameters). The solves from
the scale seeds run one after the other.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.geometry import so3
from multi_orbslam3_tpu_torch.imu.preintegration import Preintegrated
from multi_orbslam3_tpu_torch.opt.inertial_ba import whiten, whitening_factor

SCALE_SEEDS = (0.25, 1.0, 4.0, 16.0, 64.0)


class InertialInitResult(NamedTuple):
    R_wg: torch.Tensor        # (3, 3) gravity-aligning rotation (g_w = R_wg g0)
    scale: torch.Tensor       # () map scale correction
    bg: torch.Tensor          # (3,)
    ba: torch.Tensor          # (3,)
    velocities: torch.Tensor  # (K, 3) world-frame body velocities
    chi2: torch.Tensor        # () mean residual chi2


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _tilt(alpha_beta: torch.Tensor) -> torch.Tensor:
    """exp([alpha, beta, 0]) as a batch of one (nothing 0-d under forward
    AD): (2,) -> (3, 3)."""
    w = torch.cat([alpha_beta, torch.zeros_like(alpha_beta[:1])])
    return so3.exp(w[None])[0]


def _raw_residuals(theta, R_wb, p_wb, preints: Preintegrated, G):
    """Unwhitened 9-dim residuals of the K-1 consecutive pairs: (K-1, 9)."""
    K = R_wb.shape[0]
    s = torch.exp(theta[2:3])
    bg = theta[3:6]
    ba = theta[6:9]
    v = theta[9:].reshape(K, 3)
    g_w = -G * _tilt(theta[0:2])[:, 2]        # R @ [0, 0, -1] * G
    pre = Preintegrated(*(f[1:] for f in preints))
    RiT = R_wb[:-1].transpose(-1, -2)
    dbg = bg - preints.bg[:-1]
    dba = ba - preints.ba[:-1]
    dt = pre.dT[:, None]
    pre_dR = pre.dR @ so3.exp(_mv(pre.JRg, dbg))
    pre_dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    pre_dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    r_R = so3.log(pre_dR.transpose(-1, -2) @ RiT @ R_wb[1:])
    r_v = _mv(RiT, v[1:] - v[:-1] - g_w * dt) - pre_dV
    r_p = _mv(RiT, s * (p_wb[1:] - p_wb[:-1]) - v[:-1] * dt
              - 0.5 * g_w * dt * dt) - pre_dP
    return torch.cat([r_R, r_v, r_p], dim=-1)


def _floor(floor, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([floor[0]] * 3 + [floor[1]] * 3 + [floor[2]] * 3,
                        dtype=like.dtype, device=like.device)


def residuals_and_jacobian(theta, R_wb, p_wb, preints: Preintegrated, G,
                           floor=(1e-3, 1e-3, 1e-3), jacobian: bool = True):
    """Whitened stacked residuals ((K-1)*9,) and their Jacobian wrt theta
    ((K-1)*9, 9+3K). `floor` is the (rot, vel, pos) visual-pose noise added
    to the preintegration covariance before whitening."""
    L = whitening_factor(preints.cov[1:], _floor(floor, theta))

    def raw(t):
        return _raw_residuals(t, R_wb, p_wb, preints, G)

    r = whiten(L, raw(theta)).reshape(-1)
    if not jacobian:
        return r, None
    J = torch.func.jacfwd(raw)(theta)                     # (K-1, 9, n_param)
    return r, whiten(L, J).reshape(-1, theta.shape[0])


def inertial_init(R_wb: torch.Tensor, p_wb: torch.Tensor,
                  preints: Preintegrated, G: float = 9.81,
                  prior_bg: float = 1e2, prior_ba: float = 1e5,
                  iters: int = 20, fix_scale: bool = False,
                  pose_sigma=(1e-3, 1e-3, 1e-3)) -> InertialInitResult:
    """R_wb/p_wb: (K, 3, 3)/(K, 3) world-from-body keyframe poses (visual,
    arbitrary scale). preints: stacked Preintegrated with leading axis K;
    entry i holds the window from KF i-1 to KF i (entry 0 unused)."""
    dev, dt = R_wb.device, R_wb.dtype
    K = R_wb.shape[0]
    n_param = 9 + 3 * K

    # gravity-direction seed from the accumulated velocity deltas:
    # sum_i R_i dV_i = v_K - v_0 - g*T ~ -g * total_time
    dirG = -torch.sum(_mv(R_wb[:-1], preints.dV[1:]), dim=0)
    dirG = dirG / (torch.linalg.norm(dirG) + 1e-9)
    g0 = torch.tensor([0.0, 0.0, -1.0], dtype=dt, device=dev)
    axis = torch.linalg.cross(g0, dirG)
    sin_a = torch.linalg.norm(axis)
    ang = torch.atan2(sin_a, torch.dot(g0, dirG))
    w_seed = axis / (sin_a + 1e-9) * ang      # only (x, y) enter the model

    # parameter prior weights (bias random-walk priors)
    prior = torch.zeros(n_param, dtype=dt, device=dev)
    prior[3:6] = prior_bg                      # fresh tensor: in place is safe
    prior[6:9] = prior_ba
    if fix_scale:
        prior[2] = 1e12
    H_prior = torch.diag(prior) + 1e-6 * torch.eye(n_param, dtype=dt, device=dev)
    dts = torch.clamp(preints.dT[1:], min=1e-3)
    v_unit = (p_wb[1:] - p_wb[:-1]) / dts[:, None]
    v_unit = torch.cat([v_unit[:1], v_unit], dim=0).reshape(-1)
    lo = torch.full((n_param,), -math.inf, dtype=dt, device=dev)
    hi = torch.full((n_param,), math.inf, dtype=dt, device=dev)
    lo[2], hi[2] = -4.0, 5.0

    def solve_from(s0: float):
        log_s0 = torch.full((1,), math.log(s0), dtype=dt, device=dev)
        theta = torch.cat([w_seed[:2], log_s0,
                           torch.zeros(6, dtype=dt, device=dev), s0 * v_unit])
        for _ in range(iters):
            r, J = residuals_and_jacobian(theta, R_wb, p_wb, preints, G,
                                          pose_sigma)
            H = J.T @ J + H_prior
            g = J.T @ r + prior * theta
            d = torch.linalg.solve_ex(H, -g)[0]
            theta = theta + torch.where(torch.isfinite(d), d, 0.0)
            # keep log-scale in a sane bracket (degenerate motions are
            # scale-flat; unbounded drift poisons the multi-start argmin)
            theta = torch.minimum(torch.maximum(theta, lo), hi)
        r, _ = residuals_and_jacobian(theta, R_wb, p_wb, preints, G,
                                      pose_sigma, jacobian=False)
        return theta, torch.mean(r * r)

    # multi-start over scale: the joint (scale, gravity, velocity) landscape
    # has local minima for gently excited trajectories
    seeds = (1.0,) if fix_scale else SCALE_SEEDS
    thetas, chi2s = zip(*(solve_from(s0) for s0 in seeds))
    thetas, chi2s = torch.stack(thetas), torch.stack(chi2s)
    best = torch.argmin(chi2s)
    theta = thetas[best]
    return InertialInitResult(
        R_wg=_tilt(theta[0:2]), scale=torch.exp(theta[2]), bg=theta[3:6],
        ba=theta[6:9], velocities=theta[9:].reshape(K, 3), chi2=chi2s[best])
