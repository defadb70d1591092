"""Batched RANSAC PnP for relocalization (counterpart of
multi_orbslam3_tpu/opt/pnp.py): a fixed batch of 6-point DLT pose
hypotheses, each one 12x12 SVD plus a Procrustes projection onto SO(3),
scored together by reprojection over every correspondence; the winner is
polished by the robust pose optimiser on its inlier set.

The JAX package draws each hypothesis with ``jax.random.choice(M, (6,),
replace=False, p=valid / sum(valid))``: six distinct valid
correspondences, uniformly. Here they come from the caller's
``torch.Generator`` as the initializer draws its samples (top-k of
uniform keys), so the hypotheses differ from JAX's; the outcome agrees.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3
from multi_orbslam3_tpu_torch.opt import pose_opt
from multi_orbslam3_tpu_torch.pipeline.initializer import (
    _null_vector, sample_hypotheses)


class PnPResult(NamedTuple):
    ok: torch.Tensor         # () bool
    pose: torch.Tensor       # (4, 4) T_cw
    inliers: torch.Tensor    # (M,) bool
    n_inliers: torch.Tensor  # () int32


def _dlt_pose(X: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 6, 3) world points + (..., 6, 3) unit-plane bearings ->
    (..., 4, 4) T_cw: linear DLT on P = [R | t], then Procrustes."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)       # (..., 6, 4)
    x, y = b[..., 0:1], b[..., 1:2]
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -x * Xh], dim=-1)                        # (..., 6, 12)
    r2 = torch.cat([z, Xh, -y * Xh], dim=-1)
    P = _null_vector(torch.cat([r1, r2], dim=-2)).reshape(X.shape[:-2] + (3, 4))
    # sign: most points in front of the camera (sign(0) = 0, as in JAX)
    depth = (Xh @ P[..., 2, :, None])[..., 0]
    front = torch.sum(torch.sign(depth), dim=-1) >= 0
    P = P * torch.where(front, 1.0, -1.0)[..., None, None]
    U, S, Vt = torch.linalg.svd(P[..., :3])
    d = torch.sign(torch.linalg.det(U @ Vt))
    one = torch.ones_like(d)
    R = U @ (torch.stack([one, one, d], dim=-1)[..., :, None] * Vt)
    scale = torch.sum(S, dim=-1) / 3.0 * d
    t = P[..., 3] / torch.clamp(torch.abs(scale), min=1e-12)[..., None] \
        * torch.sign(scale)[..., None]
    return se3.make(R, t)


def pnp_ransac(K: cam.PinholeK, pts3d: torch.Tensor, uv: torch.Tensor,
               valid: torch.Tensor, inv_sigma2: torch.Tensor,
               generator: torch.Generator, *, n_hyp: int = 256,
               inlier_px: float = 5.99 ** 0.5 * 2.0, min_inliers: int = 12,
               refine_rounds: int = 3, refine_iters: int = 8) -> PnPResult:
    """pts3d (M, 3) landmark positions, uv (M, 2) matched pixels, valid
    (M,) correspondence mask -> the RANSAC + Gauss-Newton pose."""
    b = cam.unproject(K, uv)
    idx = sample_hypotheses(valid, n_hyp, 6, generator)             # (H, 6)
    Ts = _dlt_pose(pts3d[idx], b[idx])                               # (H, 4, 4)
    p_c = torch.einsum("hij,mj->hmi", Ts[:, :3, :3], pts3d) + Ts[:, None, :3, 3]
    err2 = torch.sum((cam.project(K, p_c) - uv[None]) ** 2, dim=-1)
    inl = (err2 < inlier_px ** 2) & (p_c[..., 2] > 1e-3) & valid[None]
    # the best hypothesis, gathered without reading its index back
    best = torch.argmax(torch.sum(inl.to(torch.int32), dim=1)).reshape(1)
    res = pose_opt.pose_optimization(
        Ts.index_select(0, best)[0], K, pts3d, uv, inv_sigma2,
        inl.index_select(0, best)[0],
        rounds=refine_rounds, iters=refine_iters)
    return PnPResult(ok=res.n_inliers >= min_inliers, pose=res.pose,
                     inliers=res.inliers, n_inliers=res.n_inliers)
