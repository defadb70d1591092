"""Motion-only pose optimisation (counterpart of
multi_orbslam3_tpu/opt/pose_opt.py): Gauss-Newton with light LM damping on
one SE(3) pose, Huber-weighted reprojection residuals over a fixed-size
masked observation batch, a fixed (rounds x iters) schedule with inlier
re-classification between rounds. Observations with a stereo right-u
measurement add a third residual row and take the 3-dof chi2 threshold."""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    optional (M,) stereo right-u (-1 monocular), bf = baseline * fx."""
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
