"""Plain tracking for the reference: the fused step of a frame after its
features, from the map the port held when it ran the step. Two rounds of
guided projection matching (the dense projection-masked search), a
one-to-one assignment, motion-only pose optimisation with the stereo rows,
and the guarded prediction chain. A frozen copy of the port's plain
versions (pipeline/tracking.py, frontend/matcher.py, opt/pose_opt.py as of
this benchmark's first commit). Imports nothing of the port."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.reference import frontend as rf
from slambench.reference import geometry as geo

NO_MP = -1


class Track(NamedTuple):
    pose: torch.Tensor       # (4, 4) optimized T_cw
    feat_mp: torch.Tensor    # (N,) landmark slot per feature (NO_MP none)
    n_inliers: torch.Tensor
    n_matches: torch.Tensor


def scatter_rows(arr: torch.Tensor, idx: torch.Tensor, write: torch.Tensor, vals):
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]], dim=0)
    tgt = torch.where(write, idx.long(), n)
    shape = (tgt.shape[0],) + arr.shape[1:]
    if isinstance(vals, torch.Tensor):
        vals = vals.to(arr.dtype).expand(shape)
    else:
        vals = torch.full(shape, vals, dtype=arr.dtype, device=arr.device)
    return ext.index_put((tgt,), vals)[:n]


def level_inv_sigma2(level: torch.Tensor, scale_factor: float) -> torch.Tensor:
    return torch.pow(float(scale_factor), -2.0 * level.to(torch.float32))


def level_from_ratio(ratio, scale_factor: float, n_levels: int):
    log_sf = float(np.log(np.float32(scale_factor)))
    lv = torch.log(torch.clamp(ratio, min=1e-6)) / log_sf
    return torch.clamp(lv.to(torch.int32), 0, n_levels - 1)


def predict_levels(m, cam_center, scale_factor: float, n_levels: int):
    dist = torch.linalg.norm(m.mp_pos - cam_center[None, :], dim=-1)
    ratio = torch.clamp(m.mp_max_dist, min=1e-6) / torch.clamp(dist, min=1e-6)
    return level_from_ratio(ratio, scale_factor, n_levels)


def camera_center(T: torch.Tensor) -> torch.Tensor:
    return -(T[:3, :3].T @ T[:3, 3])


def resolve_duplicate_targets(idx, dist, n_targets: int):
    """Where several rows matched one target, keep the nearest, then the
    first such row."""
    n_rows = idx.shape[0]
    dev = idx.device
    tgt = torch.where(idx >= 0, idx, n_targets)
    best_per_tgt = torch.full((n_targets + 1,), rf.BIG, dtype=torch.int32, device=dev)
    best_per_tgt = best_per_tgt.scatter_reduce(0, tgt, dist, "amin", include_self=True)
    keep = (idx >= 0) & (dist <= best_per_tgt[tgt])
    rows = torch.arange(n_rows, device=dev)
    first_row = torch.full((n_targets + 1,), n_rows, dtype=torch.int64, device=dev)
    first_row = first_row.scatter_reduce(0, torch.where(keep, tgt, n_targets),
                                         rows, "amin", include_self=True)
    keep = keep & (first_row[tgt] == rows)
    return torch.where(keep, idx, -1), torch.where(keep, dist, rf.BIG)


def match_and_invert(m, T, feats, K, radius: float, width: int, height: int,
                     scale_factor: float, n_levels: int, level_slack: int):
    """Project every landmark into pose T, match it to the frame's features
    and return the (N,) feature -> landmark map."""
    p_c = geo.apply(T[None], m.mp_pos)
    uv_proj = geo.project(K, p_c)
    proj_valid = (m.mp_valid & (m.mp_map_id == m.active_map)
                  & (p_c[..., 2] > 0.1) & geo.in_image(uv_proj, width, height))
    pred_lv = predict_levels(m, camera_center(T), scale_factor, n_levels)
    r = radius * torch.pow(float(scale_factor), pred_lv.to(torch.float32))
    idx, best, second = rf.best_two_projection(
        m.mp_desc, uv_proj, proj_valid, r, pred_lv.to(torch.int32), feats.desc,
        feats.uv_und, feats.valid, feats.level.to(torch.int32), level_slack)
    ok = (best <= rf.TH_HIGH) & ((best <= 0.9 * second) | (second >= rf.BIG))
    idx, dist = torch.where(ok, idx, -1), torch.where(ok, best, rf.BIG)
    idx, dist = resolve_duplicate_targets(idx, dist, feats.uv.shape[0])
    rows = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    feat_mp = torch.full((feats.uv.shape[0],), NO_MP, dtype=torch.int32, device=idx.device)
    return scatter_rows(feat_mp, idx, idx >= 0, rows)


def point_jacobian_se3(p_c):
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(p_c.shape[:-1] + (3, 3))
    return torch.cat([-geo.hat(p_c), eye], dim=-1)


def stereo_rows(K, p_c, u_r, bf):
    st = (u_r >= 0).to(p_c.dtype)
    x = p_c[..., 0]
    z = torch.clamp(p_c[..., 2], min=1e-6)
    ur_pred = K.fx * x / z + K.cx - bf / z
    J_ur = st[..., None] * torch.stack(
        [K.fx / z, torch.zeros_like(z), (bf - K.fx * x) / (z * z)], dim=-1)
    return st * (ur_pred - u_r), J_ur


def _residual_jac(T, K, p_w, uv, u_r=None, bf=0.0):
    p_c = geo.apply(T, p_w)
    r = geo.project(K, p_c) - uv
    Jproj = geo.project_jacobian(K, p_c)
    if u_r is not None:
        r_ur, J_ur = stereo_rows(K, p_c, u_r, bf)
        r = torch.cat([r, r_ur[..., None]], dim=-1)
        Jproj = torch.cat([Jproj, J_ur[..., None, :]], dim=-2)
    return r, Jproj @ point_jacobian_se3(p_c), p_c[..., 2] <= 1e-3


def pose_optimization(T_init, K, p_world, uv_obs, inv_sigma2, mask, rounds: int,
                      iters: int, u_r=None, bf=0.0):
    """Gauss-Newton with light LM damping on one SE(3) pose, Huber weights,
    inlier re-classification between rounds; returns (pose, inliers)."""
    lm_lambda = 1e-3
    chi2_th = geo.CHI2_MONO
    if u_r is not None:
        chi2_th = torch.where(u_r >= 0, geo.CHI2_STEREO, chi2_th)
    eye6 = torch.eye(6, dtype=T_init.dtype, device=T_init.device)

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    T, active = T_init, mask
    for _ in range(rounds):
        for _ in range(iters):
            r, J, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
            w = geo.huber_weight(chi2_of(r), chi2_th) * inv_sigma2
            w = torch.where(active & ~behind, w, 0.0)
            Jw = J * w[:, None, None]
            H = torch.einsum("mri,mrj->ij", Jw, J)
            b = torch.einsum("mri,mr->i", Jw, r)
            H = H + lm_lambda * torch.diag(torch.diagonal(H)) + 1e-6 * eye6
            dx = torch.linalg.solve_ex(H, -b)[0]
            T_new = geo.normalize(geo.retract(T, dx))
            T = torch.where(torch.isfinite(dx).all(), T_new, T)
        r, _, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
        active = mask & (chi2_of(r) <= chi2_th) & ~behind
    r, _, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
    inliers = mask & (chi2_of(r) <= chi2_th) & ~behind
    return T, inliers


def _pose_from_assoc(m, feats, feat_mp, T_init, K, scale_factor, rounds, iters, u_r, bf):
    p_world = m.mp_pos[torch.where(feat_mp >= 0, feat_mp, 0).long()]
    mask = (feat_mp >= 0) & feats.valid
    T, inl = pose_optimization(T_init, K, p_world, feats.uv_und,
                               level_inv_sigma2(feats.level, scale_factor), mask,
                               rounds, iters, u_r, bf)
    return T, torch.where(inl, feat_mp, NO_MP), torch.sum(inl.to(torch.int32))


def track_frame(m, feats, T_pred, config, u_r=None, bf=0.0,
                radius_fine: float = 4.0, rounds: int = 2, iters: int = 7) -> Track:
    """Coarse match at the predicted pose, optimize, re-match finely at the
    optimized pose, optimize again."""
    c = config
    K = geo.intrinsics_from_config(c.camera, T_pred.device)
    kw = dict(width=c.camera.width, height=c.camera.height,
              scale_factor=c.orb.scale_factor, n_levels=c.orb.n_levels)
    feat_mp = match_and_invert(m, T_pred, feats, K, c.tracking.search_radius,
                               level_slack=2, **kw)
    n_matches = torch.sum((feat_mp >= 0).to(torch.int32))
    T1, feat_mp1, _ = _pose_from_assoc(m, feats, feat_mp, T_pred, K, c.orb.scale_factor,
                                       rounds, iters, u_r, bf)
    feat_mp2 = match_and_invert(m, T1, feats, K, radius_fine, level_slack=1, **kw)
    feat_mp2 = torch.where(feat_mp2 >= 0, feat_mp2, feat_mp1)
    T2, feat_mp_f, n2 = _pose_from_assoc(m, feats, feat_mp2, T1, K, c.orb.scale_factor,
                                         rounds, iters, u_r, bf)
    return Track(pose=T2, feat_mp=feat_mp_f, n_inliers=n2, n_matches=n_matches)


def chained_pose(config, tr: Track, T_pred: torch.Tensor) -> torch.Tensor:
    """The prediction chain's guard: a weak track keeps the prediction."""
    ok = tr.n_inliers >= config.tracking.min_matches_refkf
    return torch.where(ok, tr.pose, T_pred)
