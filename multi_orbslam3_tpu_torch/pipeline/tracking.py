"""Frame tracking: projection matching + pose optimisation (counterpart of
multi_orbslam3_tpu/pipeline/tracking.py).

``fused_step_chained`` (``fused_step_stereo_chained`` for a stereo pair) is
the per-frame device program of the pipelined frame loop: ORB extraction, two rounds of guided matching against the
whole map (kernel K2 inside ``match_by_projection``) with a pose
optimisation after each, and the guarded prediction chain. It launches
work and reads nothing back; the host reads one small ``packed`` tensor
per frame. The LOST/RECENTLY_LOST ladder and the keyframe decision stay on
the host (system.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multi_orbslam3_tpu_torch.frontend import extractor, matcher, stereo
from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.map.mapstate import NO_MP, MapState
from multi_orbslam3_tpu_torch.opt import pnp, pose_opt
from multi_orbslam3_tpu_torch.utils.timing import GLOBAL_TIMER


class TrackResult(NamedTuple):
    pose: torch.Tensor       # (4, 4) optimized T_cw
    feat_mp: torch.Tensor    # (N,) int32 landmark slot per feature (NO_MP none)
    n_inliers: torch.Tensor  # () int32
    n_matches: torch.Tensor  # () int32 pre-optimization matches
    visible: torch.Tensor    # (P,) bool landmarks in the frame's frustum
    # [pose(16), n_inliers, n_matches(, T_pred(16))] float32: everything the
    # host state machine reads, in one device->host transfer
    packed: Optional[torch.Tensor] = None


def level_inv_sigma2(level: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Per-keypoint information 1 / (scale^level)^2."""
    return torch.pow(float(scale_factor), -2.0 * level.to(torch.float32))


def predict_levels(m: MapState, cam_center: torch.Tensor,
                   scale_factor: float, n_levels: int) -> torch.Tensor:
    """Pyramid level a landmark should appear at, from its distance."""
    dist = torch.linalg.norm(m.mp_pos - cam_center[None, :], dim=-1)
    ratio = torch.clamp(m.mp_max_dist, min=1e-6) / torch.clamp(dist, min=1e-6)
    return level_from_ratio(ratio, scale_factor, n_levels)


def level_from_ratio(ratio: torch.Tensor, scale_factor: float,
                     n_levels: int) -> torch.Tensor:
    """int(log(ratio) / log(scale_factor)) clamped to the pyramid; the
    divisor is log taken in float32, as the JAX package computes it."""
    log_sf = float(np.log(np.float32(scale_factor)))
    lv = torch.log(torch.clamp(ratio, min=1e-6)) / log_sf
    return torch.clamp(lv.to(torch.int32), 0, n_levels - 1)


def camera_center(T: torch.Tensor) -> torch.Tensor:
    return -(T[:3, :3].T @ T[:3, 3])


def invert_matches(res: matcher.MatchResult, n_feat: int) -> torch.Tensor:
    """Landmark->feature matches into a (n_feat,) feature->landmark map
    (unmatched rows park in a sacrificial slot)."""
    rows = torch.arange(res.idx.shape[0], dtype=torch.int32, device=res.idx.device)
    feat_mp = torch.full((n_feat,), NO_MP, dtype=torch.int32, device=res.idx.device)
    return ms.scatter_rows(feat_mp, res.idx, res.idx >= 0, rows)


def _match_and_invert(m: MapState, T: torch.Tensor, feats: FrameFeatures,
                      K: cam.PinholeK, radius: float, width: int, height: int,
                      scale_factor: float, n_levels: int, level_slack: int):
    """Project all landmarks into pose T and match them to the frame's
    features; returns the (N,) feature->landmark map and the frustum mask."""
    p_c = se3.apply(T[None], m.mp_pos)
    uv_proj = cam.project(K, p_c)
    proj_valid = (m.mp_valid & (m.mp_map_id == m.active_map)
                  & (p_c[..., 2] > 0.1)
                  & cam.in_image(uv_proj, width, height))
    pred_lv = predict_levels(m, camera_center(T), scale_factor, n_levels)
    r = radius * torch.pow(float(scale_factor), pred_lv.to(torch.float32))
    res = matcher.match_by_projection(
        uv_proj, proj_valid, m.mp_desc, feats.uv_und, feats.valid, feats.desc,
        feats.level, r, pred_lv, max_dist=matcher.TH_HIGH, ratio=0.9,
        level_slack=level_slack)
    res = matcher.resolve_duplicate_targets(res, feats.n)
    return invert_matches(res, feats.n), proj_valid


def _pose_from_assoc(m: MapState, feats: FrameFeatures, feat_mp: torch.Tensor,
                     T_init: torch.Tensor, K: cam.PinholeK,
                     scale_factor: float, rounds: int = 4, iters: int = 10,
                     u_r=None, bf=0.0):
    p_world = m.mp_pos[torch.where(feat_mp >= 0, feat_mp, 0).long()]
    mask = (feat_mp >= 0) & feats.valid
    res = pose_opt.pose_optimization(
        T_init, K, p_world, feats.uv_und,
        level_inv_sigma2(feats.level, scale_factor), mask,
        rounds=rounds, iters=iters, u_r=u_r, bf=bf)
    return res.pose, torch.where(res.inliers, feat_mp, NO_MP), res.n_inliers


def track_frame(m: MapState, feats: FrameFeatures, T_pred: torch.Tensor,
                K: cam.PinholeK, *, width: int, height: int,
                scale_factor: float, n_levels: int,
                radius_coarse: float = 15.0, radius_fine: float = 4.0,
                opt_rounds: int = 2, opt_iters: int = 7,
                u_r=None, bf=0.0) -> TrackResult:
    """Coarse match at the predicted pose, optimize, re-match finely at the
    optimized pose, optimize again. u_r / bf: optional per-feature stereo
    right-u and baseline * fx, which add the stereo pose edges."""
    with GLOBAL_TIMER.stage("step.match"):
        feat_mp, _ = _match_and_invert(m, T_pred, feats, K, radius_coarse,
                                       width, height, scale_factor, n_levels,
                                       level_slack=2)
    n_matches = torch.sum((feat_mp >= 0).to(torch.int32)).to(torch.int32)
    with GLOBAL_TIMER.stage("step.pose_opt"):
        T1, feat_mp1, _ = _pose_from_assoc(m, feats, feat_mp, T_pred, K,
                                           scale_factor, opt_rounds, opt_iters,
                                           u_r, bf)
    with GLOBAL_TIMER.stage("step.match"):
        feat_mp2, visible = _match_and_invert(m, T1, feats, K, radius_fine,
                                              width, height, scale_factor,
                                              n_levels, level_slack=1)
    # keep round-1 inlier associations where round 2 found nothing
    feat_mp2 = torch.where(feat_mp2 >= 0, feat_mp2, feat_mp1)
    with GLOBAL_TIMER.stage("step.pose_opt"):
        T2, feat_mp_f, n2 = _pose_from_assoc(m, feats, feat_mp2, T1, K,
                                             scale_factor, opt_rounds, opt_iters,
                                             u_r, bf)
    return TrackResult(pose=T2, feat_mp=feat_mp_f, n_inliers=n2,
                       n_matches=n_matches, visible=visible)


def _track_config(m, feats, T_pred, config, u_r=None, bf=0.0):
    c = config
    K = extractor._camera_consts(c.camera, T_pred.device)[0]
    return track_frame(m, feats, T_pred, K, width=c.camera.width,
                       height=c.camera.height,
                       scale_factor=c.orb.scale_factor,
                       n_levels=c.orb.n_levels,
                       radius_coarse=c.tracking.search_radius, u_r=u_r, bf=bf)


def pack_result(pose, res, extra=None):
    """[pose(16), n_inliers, n_matches(, extra)] as one float32 vector."""
    parts = [pose.reshape(-1).float(),
             torch.stack([res.n_inliers.float(), res.n_matches.float()])]
    if extra is not None:
        parts.append(extra.reshape(-1).float())
    return torch.cat(parts)


def fused_step(config, m: MapState, img: torch.Tensor, T_pred: torch.Tensor):
    """Extract + track + landmark found/visible statistics (applied only
    when the track is healthy). Returns (feats, result, updated map)."""
    with GLOBAL_TIMER.stage("step.extract"):
        feats = extractor.extract_features(img, config)
    res = _track_config(m, feats, T_pred, config)
    m2 = ms.update_found_visible(m, res.feat_mp, res.visible)
    ok = res.n_inliers >= config.tracking.min_matches_refkf
    m2 = m._replace(mp_found=torch.where(ok, m2.mp_found, m.mp_found),
                    mp_visible=torch.where(ok, m2.mp_visible, m.mp_visible))
    return feats, res._replace(packed=pack_result(res.pose, res)), m2


def _chain(config, res: TrackResult, T_cur, T_vel, T_pred):
    """The guarded next state of the on-device prediction chain: the pose
    falls back to T_pred (and T_vel holds) when the track is weak.
    packed = [pose(16), n_inliers, n_matches, T_pred(16)].
    Returns (result, pose, T_vel_new)."""
    ok = res.n_inliers >= config.tracking.min_matches_refkf
    pose = torch.where(ok, res.pose, T_pred)
    T_cur_inv = torch.linalg.inv_ex(T_cur)[0]
    T_vel_new = torch.where(ok, res.pose @ T_cur_inv, T_vel)
    res = res._replace(pose=pose, packed=pack_result(pose, res, T_pred))
    return res, pose, T_vel_new


def fused_step_chained(config, m: MapState, img: torch.Tensor,
                       T_cur: torch.Tensor, T_vel: torch.Tensor):
    """Extract + track with the prediction chain on the device: T_pred =
    T_vel @ T_cur. Returns (feats, result, pose, T_vel_new)."""
    T_pred = T_vel @ T_cur
    with GLOBAL_TIMER.stage("step.extract"):
        feats = extractor.extract_features(img, config)
    res = _track_config(m, feats, T_pred, config)
    return (feats,) + _chain(config, res, T_cur, T_vel, T_pred)


def fused_step_stereo_chained(config, m: MapState, img_l: torch.Tensor,
                              img_r: torch.Tensor, T_cur: torch.Tensor,
                              T_vel: torch.Tensor):
    """Stereo twin of fused_step_chained: both extractions (K1 launched
    once for the two pyramids), the stereo match, tracking with the stereo
    rows, and the same chain and ``packed`` layout.
    Returns (feats, stereo depth, result, pose, T_vel_new)."""
    bf = config.camera.baseline * config.camera.fx
    T_pred = T_vel @ T_cur
    with GLOBAL_TIMER.stage("step.extract"):
        feats, feats_r = extractor.extract_features_pair(img_l, img_r, config)
    with GLOBAL_TIMER.stage("step.stereo"):
        sd = stereo.stereo_match(feats, feats_r, bf)
    res = _track_config(m, feats, T_pred, config, u_r=sd.u_right, bf=bf)
    return (feats, sd) + _chain(config, res, T_cur, T_vel, T_pred)


def extract_and_track(m: MapState, img: torch.Tensor, T_pred: torch.Tensor,
                      config) -> tuple:
    """Synchronous-loop step: (feats, result, updated map)."""
    return fused_step(config, m, img, T_pred)


def relocalize_candidate(m: MapState, cand_kf, feats: FrameFeatures,
                         K: cam.PinholeK, generator: torch.Generator,
                         scale_factor: float = 1.2) -> TrackResult:
    """Relocalization against a BoW candidate keyframe: mutual-match the
    frame to the candidate's landmark-bearing features (ratio 0.85), solve
    the pose from scratch with RANSAC PnP, and mark the candidate's
    landmarks visible. No motion-model or candidate-pose seed."""
    kf_mp_row = ms.take(m.kf_mp, cand_kf)
    res = matcher.match_mutual(
        feats.desc, feats.valid, ms.take(m.kf_desc, cand_kf),
        ms.take(m.kf_feat_valid, cand_kf) & (kf_mp_row >= 0),
        max_dist=matcher.TH_LOW, ratio=0.85, angle1=feats.angle,
        angle2=ms.take(m.kf_angle, cand_kf))
    feat_mp = torch.where(res.idx >= 0,
                          kf_mp_row[torch.where(res.idx >= 0, res.idx, 0)], NO_MP)
    n_matches = torch.sum((feat_mp >= 0).to(torch.int32)).to(torch.int32)
    sol = pnp.pnp_ransac(
        K, m.mp_pos[torch.where(feat_mp >= 0, feat_mp, 0).long()], feats.uv_und,
        (feat_mp >= 0) & feats.valid, level_inv_sigma2(feats.level, scale_factor),
        generator)
    visible = torch.zeros(m.max_mp, dtype=torch.bool, device=m.device)
    visible = ms.scatter_rows(visible, kf_mp_row, kf_mp_row >= 0, True)
    return TrackResult(pose=sol.pose, feat_mp=torch.where(sol.inliers, feat_mp, NO_MP),
                       n_inliers=torch.where(sol.ok, sol.n_inliers, 0).to(torch.int32),
                       n_matches=n_matches, visible=visible)


def track_reference_kf(m: MapState, ref_kf, feats: FrameFeatures,
                       T_init: torch.Tensor, K: cam.PinholeK,
                       scale_factor: float = 1.2) -> TrackResult:
    """Fallback when motion-model tracking fails: mutual-match the frame
    against the reference keyframe's features, inherit its landmark
    associations, optimize from the last pose."""
    kf_mp_row = ms.take(m.kf_mp, ref_kf)
    kf_feat_valid = ms.take(m.kf_feat_valid, ref_kf) & (kf_mp_row >= 0)
    res = matcher.match_mutual(feats.desc, feats.valid, ms.take(m.kf_desc, ref_kf),
                               kf_feat_valid, max_dist=matcher.TH_LOW,
                               ratio=0.8, angle1=feats.angle,
                               angle2=ms.take(m.kf_angle, ref_kf))
    feat_mp = torch.where(res.idx >= 0,
                          kf_mp_row[torch.where(res.idx >= 0, res.idx, 0)], NO_MP)
    n_matches = torch.sum((feat_mp >= 0).to(torch.int32)).to(torch.int32)
    T, feat_mp_in, n_in = _pose_from_assoc(m, feats, feat_mp, T_init, K,
                                           scale_factor)
    # visible = the landmarks this keyframe already associates
    visible = torch.zeros(m.max_mp, dtype=torch.bool, device=m.device)
    visible = ms.scatter_rows(visible, kf_mp_row, kf_mp_row >= 0, True)
    return TrackResult(pose=T, feat_mp=feat_mp_in, n_inliers=n_in,
                       n_matches=n_matches, visible=visible)
