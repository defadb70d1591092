"""Motion-only pose optimisation (counterpart of
multi_orbslam3_tpu/opt/pose_opt.py): Gauss-Newton with light LM damping on
one SE(3) pose, Huber-weighted reprojection residuals over a fixed-size
masked observation batch, a fixed (rounds x iters) schedule with inlier
re-classification between rounds. Monocular edges only; stereo edges come
with the stereo port."""

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


def _residual_jac(T: torch.Tensor, K: cam.PinholeK, p_w: torch.Tensor,
                  uv: torch.Tensor):
    """Residuals (M, 2), Jacobians (M, 2, 6) and the behind-camera mask."""
    p_c = se3.apply(T, p_w)
    r = cam.project(K, p_c) - uv
    J = cam.project_jacobian(K, p_c) @ point_jacobian_se3(p_c)
    return r, J, p_c[..., 2] <= 1e-3


def pose_optimization(T_init: torch.Tensor, K: cam.PinholeK,
                      p_world: torch.Tensor, uv_obs: torch.Tensor,
                      inv_sigma2: torch.Tensor, mask: torch.Tensor,
                      rounds: int = 4, iters: int = 10,
                      chi2_th: float = robust.CHI2_MONO) -> PoseOptResult:
    """p_world (M, 3), uv_obs (M, 2), inv_sigma2 (M,), mask (M,)."""
    lm_lambda = 1e-3
    eye6 = torch.eye(6, dtype=T_init.dtype, device=T_init.device)

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    T, active = T_init, mask
    for _ in range(rounds):
        for _ in range(iters):
            r, J, behind = _residual_jac(T, K, p_world, uv_obs)
            w = robust.huber_weight(chi2_of(r), chi2_th) * inv_sigma2
            w = torch.where(active & ~behind, w, 0.0)
            Jw = J * w[:, None, None]
            H = torch.einsum("mri,mrj->ij", Jw, J)
            b = torch.einsum("mri,mr->i", Jw, r)
            H = H + lm_lambda * torch.diag(torch.diagonal(H)) + 1e-6 * eye6
            dx = torch.linalg.solve_ex(H, -b)[0]
            T_new = se3.normalize(se3.retract(T, dx))
            T = torch.where(torch.isfinite(dx).all(), T_new, T)
        r, _, behind = _residual_jac(T, K, p_world, uv_obs)
        active = mask & (chi2_of(r) <= chi2_th) & ~behind
    r, _, behind = _residual_jac(T, K, p_world, uv_obs)
    chi2 = chi2_of(r)
    inliers = mask & (chi2 <= chi2_th) & ~behind
    return PoseOptResult(pose=T, inliers=inliers,
                         n_inliers=torch.sum(inliers.to(torch.int32)).to(torch.int32),
                         chi2=torch.sum(torch.where(inliers, chi2, 0.0)))
