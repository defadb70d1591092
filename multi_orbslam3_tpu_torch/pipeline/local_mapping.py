"""Local mapping: triangulation, fusion, landmark statistics and windowed
BA (counterpart of multi_orbslam3_tpu/pipeline/local_mapping.py).

``map_keyframe`` is the whole per-keyframe chain. Every size is fixed by
the configuration (neighbour budget, window, landmark cap) and validity is
carried in masks, so the chain launches device work without reading any
value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.frontend import matcher
from multi_orbslam3_tpu_torch.frontend.extractor import topk_stable
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3, so3, triangulation
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.map.mapstate import NO_MP, MapState
from multi_orbslam3_tpu_torch.opt import local_ba
from multi_orbslam3_tpu_torch.pipeline.tracking import (
    camera_center, invert_matches, level_from_ratio, level_inv_sigma2)
from multi_orbslam3_tpu_torch.utils.timing import GLOBAL_TIMER


class TriangulationOut(NamedTuple):
    map: MapState
    n_created: torch.Tensor


def triangulate_pair(m: MapState, kf_new, kf_nbr, K: cam.PinholeK,
                     enable) -> TriangulationOut:
    """Create landmarks from features unmatched in both keyframes: mutual
    descriptor match gated by the epipolar constraint of the known relative
    pose, then checked DLT triangulation. `enable` False makes it a no-op
    (a neighbour slot below the covisibility floor)."""
    kf_new = ms.as_index(kf_new, m.device)
    kf_nbr = ms.as_index(kf_nbr, m.device)
    take = ms.take
    free_new = take(m.kf_feat_valid, kf_new) & (take(m.kf_mp, kf_new) == NO_MP)
    free_nbr = take(m.kf_feat_valid, kf_nbr) & (take(m.kf_mp, kf_nbr) == NO_MP)
    desc_new = take(m.kf_desc, kf_new)
    res = matcher.match_mutual(
        desc_new, free_new, take(m.kf_desc, kf_nbr), free_nbr,
        max_dist=matcher.TH_LOW, ratio=0.8,
        angle1=take(m.kf_angle, kf_new), angle2=take(m.kf_angle, kf_nbr))

    T_new = take(m.kf_pose, kf_new)
    T_nbr = take(m.kf_pose, kf_nbr)
    K_new = ms.kf_intrinsics(m, kf_new, K)
    K_nbr = ms.kf_intrinsics(m, kf_nbr, K)
    T_rel = T_new @ se3.inverse(T_nbr)                   # nbr-cam -> new-cam
    E = so3.hat(se3.translation(T_rel)) @ se3.rotation(T_rel)
    idx_safe = torch.where(res.idx >= 0, res.idx, 0)
    uv_new = take(m.kf_uv, kf_new)
    uv_nbr = take(m.kf_uv, kf_nbr)[idx_safe]
    b_new = cam.unproject(K_new, uv_new)
    b_nbr = cam.unproject(K_nbr, uv_nbr)
    # Sampson error on the unit plane, threshold ~1.5 px
    Eb = b_nbr @ E.T
    Etb = b_new @ E
    num = torch.sum(b_new * Eb, dim=-1) ** 2
    den = Eb[:, 0] ** 2 + Eb[:, 1] ** 2 + Etb[:, 0] ** 2 + Etb[:, 1] ** 2
    f = (K_new.fx + K_new.fy) * 0.5
    epi_ok = num / (den + 1e-12) < (1.5 / f) ** 2

    N = uv_new.shape[0]
    p, tri_ok = triangulation.triangulate_and_check(
        T_new.expand(N, 4, 4), T_nbr.expand(N, 4, 4),
        b_new, b_nbr, K_new, uv_new, uv_nbr, K2=K_nbr)
    ok = (res.idx >= 0) & epi_ok & tri_ok & enable
    m2, _ = ms.add_mappoints(
        m, p, ok, desc_new, kf_new, kf_new,
        torch.arange(N, device=m.device), kf_nbr, idx_safe)
    return TriangulationOut(map=m2, n_created=torch.sum(ok.to(torch.int32)))


class KFProcessOut(NamedTuple):
    map: MapState
    n_created: torch.Tensor
    n_fused: torch.Tensor
    neighbors: torch.Tensor
    neighbor_ok: torch.Tensor


def process_new_keyframe(m: MapState, kf_new, K: cam.PinholeK, *,
                         n_neighbors: int = 8, width: int, height: int,
                         scale_factor: float = 1.2, n_levels: int = 8,
                         min_covis: int = 10) -> KFProcessOut:
    """Top-k covisible neighbours -> triangulation against each -> fusion
    -> landmark statistics refresh over the window."""
    kf_new = ms.as_index(kf_new, m.device)
    covis = torch.where(m.kf_valid, ms.covisibility_row(m, kf_new), -1)
    covis = ms.scatter_rows(covis, kf_new.reshape(1),
                            torch.ones(1, dtype=torch.bool, device=m.device), -1)
    vals, nbrs = topk_stable(covis, n_neighbors)
    nbr_ok = vals >= min_covis

    n_created = torch.zeros((), dtype=torch.int32, device=m.device)
    for j in range(n_neighbors):
        out = triangulate_pair(m, kf_new, nbrs[j], K, nbr_ok[j])
        m = out.map
        n_created = n_created + out.n_created
    fuse = fuse_into_keyframe(m, kf_new, K, width=width, height=height,
                              scale_factor=scale_factor, n_levels=n_levels)
    win = torch.cat([kf_new.reshape(1), nbrs])
    win_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=m.device), nbr_ok])
    m = ms.refresh_point_stats(fuse.map, win, win_ok, scale_factor=scale_factor,
                               n_levels=n_levels)
    return KFProcessOut(map=m, n_created=n_created, n_fused=fuse.n_fused,
                        neighbors=nbrs.to(torch.int32), neighbor_ok=nbr_ok)


class FuseOut(NamedTuple):
    map: MapState
    n_fused: torch.Tensor     # duplicate landmarks merged
    n_attached: torch.Tensor  # new associations written


def fuse_into_keyframe(m: MapState, kf, K: cam.PinholeK, *,
                       width: int, height: int, scale_factor: float = 1.2,
                       n_levels: int = 8, radius: float = 3.0,
                       max_dist: int = matcher.TH_LOW) -> FuseOut:
    """Project the map into keyframe `kf` and reconcile with its features:
    a feature bound to a different landmark merges the two (the one with
    more observations survives); an unbound feature attaches."""
    kf = ms.as_index(kf, m.device)
    take = ms.take
    T = take(m.kf_pose, kf)
    K = ms.kf_intrinsics(m, kf, K)
    p_c = se3.apply(T[None], m.mp_pos)
    uv_proj = cam.project(K, p_c)
    center = camera_center(T)
    dist = torch.linalg.norm(m.mp_pos - center[None, :], dim=-1)
    d_ok = (dist >= 0.8 * m.mp_min_dist) & (dist <= 1.2 * m.mp_max_dist)
    view = (m.mp_pos - center[None, :]) / torch.clamp(dist, min=1e-8)[:, None]
    angle_ok = torch.sum(view * m.mp_normal, dim=-1) > 0.5
    proj_valid = (m.mp_valid & (m.mp_map_id == m.active_map)
                  & (p_c[..., 2] > 0.05) & d_ok & angle_ok
                  & cam.in_image(uv_proj, width, height))
    ratio = torch.clamp(m.mp_max_dist, min=1e-6) / torch.clamp(dist, min=1e-6)
    pred_lv = level_from_ratio(ratio, scale_factor, n_levels)
    r = radius * torch.pow(float(scale_factor), pred_lv.to(torch.float32))
    res = matcher.match_by_projection(
        uv_proj, proj_valid, m.mp_desc, take(m.kf_uv, kf), take(m.kf_feat_valid, kf),
        take(m.kf_desc, kf), take(m.kf_level, kf), r, pred_lv,
        max_dist=max_dist, ratio=1.0, level_slack=1)
    res = matcher.resolve_duplicate_targets(res, m.n_feat)

    P = m.max_mp
    cand = invert_matches(res, m.n_feat)                 # (N,)
    existing = take(m.kf_mp, kf)

    # observation counts decide the survivor of a duplicate merge
    flat = m.kf_mp.reshape(-1)
    obs_w = ((flat >= 0) & m.kf_feat_valid.reshape(-1)
             & m.kf_valid.repeat_interleave(m.n_feat)).to(torch.int32)
    counts = torch.zeros(P + 1, dtype=torch.int32, device=m.device).index_add(
        0, torch.where(flat >= 0, flat, P).long(), obs_w)[:P]

    dup = (cand >= 0) & (existing >= 0) & (cand != existing)
    cand_safe = torch.where(cand >= 0, cand, 0).long()
    exist_safe = torch.where(existing >= 0, existing, 0).long()
    keep_cand = counts[cand_safe] >= counts[exist_safe]
    old = torch.where(dup, torch.where(keep_cand, exist_safe, cand_safe), -1)
    new = torch.where(dup, torch.where(keep_cand, cand_safe, exist_safe), -1)
    m = ms.replace_mappoint(m, old, new)

    row = take(m.kf_mp, kf)
    attach = (cand >= 0) & (row == NO_MP)
    kf_mp = ms.scatter_rows(m.kf_mp, kf.reshape(1),
                            torch.ones(1, dtype=torch.bool, device=m.device),
                            torch.where(attach, cand, row)[None])
    return FuseOut(map=m._replace(kf_mp=kf_mp),
                   n_fused=torch.sum(dup.to(torch.int32)),
                   n_attached=torch.sum(attach.to(torch.int32)))


def fixed_size_unique(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The `size` smallest distinct values of x in ascending order, padded
    with `fill` (``jnp.unique(x, size=size, fill_value=fill)``) without a
    data-dependent shape."""
    s = torch.sort(x.reshape(-1)).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]           # fresh tensor: in place is safe
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    out = torch.full((size,), fill, dtype=x.dtype, device=x.device)
    return ms.scatter_rows(out, rank, first & (rank < size), s)


class LocalBAOut(NamedTuple):
    map: MapState
    chi2: torch.Tensor
    n_window: torch.Tensor


def local_bundle_adjustment(m: MapState, kf_center, K: cam.PinholeK, *,
                            n_window: int = 16, n_fixed: int = 8,
                            n_points: int = 4096, scale_factor: float = 1.2,
                            iters: int = 8,
                            covis_threshold: int = 15,
                            bf: float = 0.0) -> LocalBAOut:
    """Windowed BA around `kf_center`: the top covisible keyframes are
    optimized, the next ring is fixed; window landmarks are every point
    those keyframes observe (capped). Results are written back; outlier
    observations are detached. bf = baseline * fx > 0 adds the stereo rows
    of the keyframes' right-u measurements (with bf = 0 the map holds none,
    and the rows are left out rather than computed as zeros)."""
    dev = m.device
    Kcap, N = m.kf_mp.shape
    kf_center = ms.as_index(kf_center, dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    covis = torch.where(m.kf_valid, ms.covisibility_row(m, kf_center), -1)
    covis = ms.scatter_rows(covis, kf_center.reshape(1), one, 1 << 20)
    order = torch.argsort(-covis, stable=True)           # descending
    win = order[:n_window]
    anchors = order[n_window:n_window + n_fixed]
    win_ok = covis[win] >= covis_threshold
    win_ok = torch.cat([one, win_ok[1:]])
    anchor_ok = covis[anchors] >= 1
    any_anchor = torch.any(anchor_ok)
    slots = torch.cat([win, anchors])
    slot_ok = torch.cat([win_ok, anchor_ok])
    fixed = torch.cat([torch.zeros(n_window, dtype=torch.bool, device=dev),
                       torch.ones(n_fixed, dtype=torch.bool, device=dev)])
    fixed = fixed | m.kf_pose_locked[slots] | ~slot_ok
    # gauge guard: fix the lowest-id valid window KF when no anchor exists
    oldest = torch.argmin(torch.where(win_ok, win, 1 << 20))
    fixed = ms.scatter_rows(fixed, oldest.reshape(1), one,
                            ms.take(fixed, oldest.reshape(1)) | ~any_anchor)

    Kw = n_window + n_fixed
    obs_mp = torch.where(slot_ok[:, None], m.kf_mp[slots], NO_MP)   # (Kw, N)
    pt_global = fixed_size_unique(obs_mp, n_points, NO_MP)         # -1 first
    pt_ok = pt_global >= 0
    lut = torch.full((m.max_mp,), -1, dtype=torch.int64, device=dev)
    lut = ms.scatter_rows(lut, pt_global, pt_ok,
                          torch.arange(n_points, device=dev))
    lut = torch.cat([lut, lut.new_full((1,), -1)])

    flat_mp = obs_mp.reshape(-1)
    local_pt = lut[torch.where(flat_mp >= 0, flat_mp, m.max_mp).long()]
    obs_valid = (flat_mp >= 0) & (local_pt >= 0) & m.kf_feat_valid[slots].reshape(-1)
    obs = local_ba.BAObservations(
        kf=torch.arange(Kw, device=dev).repeat_interleave(N),
        pt=torch.where(local_pt >= 0, local_pt, 0),
        uv=m.kf_uv[slots].reshape(-1, 2),
        inv_sigma2=level_inv_sigma2(m.kf_level[slots].reshape(-1), scale_factor),
        valid=obs_valid,
        u_r=m.kf_ur[slots].reshape(-1) if bf else None)
    poses0 = m.kf_pose[slots]
    points0 = m.mp_pos[torch.where(pt_ok, pt_global, 0).long()]
    K_slots = ms.kf_intrinsics(m, slots, K)
    K_obs = cam.PinholeK(*(f.repeat_interleave(N) for f in K_slots))
    res = local_ba.bundle_adjust(poses0, fixed, points0, obs, K_obs, iters=iters,
                                 bf=bf)

    kf_pose = ms.scatter_rows(m.kf_pose, slots, slot_ok & ~fixed, res.poses)
    mp_pos = ms.scatter_rows(m.mp_pos, pt_global, pt_ok, res.points)
    # detach outlier observations
    out_mask = obs_valid & ~res.inliers
    feat = torch.arange(N, device=dev).repeat(Kw)
    flat_idx = slots.repeat_interleave(N) * N + feat
    kf_mp = ms.scatter_rows(m.kf_mp.reshape(-1), flat_idx, out_mask,
                            NO_MP).reshape(Kcap, N)
    return LocalBAOut(map=m._replace(kf_pose=kf_pose, mp_pos=mp_pos, kf_mp=kf_mp),
                      chi2=res.chi2, n_window=torch.sum(win_ok.to(torch.int32)))


class MapKFOut(NamedTuple):
    map: MapState
    n_created: torch.Tensor
    n_fused: torch.Tensor
    chi2: torch.Tensor


def mapping_kwargs(config) -> dict:
    """map_keyframe's static arguments for a SystemConfig."""
    lm = config.local_mapping
    n_window = min(lm.local_ba_kfs, config.map.max_keyframes // 2)
    return dict(n_neighbors=lm.triangulation_neighbors,
                width=config.camera.width, height=config.camera.height,
                scale_factor=config.orb.scale_factor,
                n_levels=config.orb.n_levels, n_window=n_window,
                n_fixed=min(lm.local_ba_fixed_kfs,
                            config.map.max_keyframes - n_window),
                n_points=min(lm.local_ba_points, config.map.max_mappoints),
                iters=lm.local_ba_iters,
                covis_threshold=config.map.covis_threshold)


def map_keyframe(m: MapState, kf_new, K: cam.PinholeK, *,
                 n_neighbors: int, width: int, height: int,
                 scale_factor: float, n_levels: int,
                 n_window: int, n_fixed: int, n_points: int,
                 iters: int, covis_threshold: int = 15,
                 bf: float = 0.0) -> MapKFOut:
    """The whole per-keyframe mapping chain: triangulate/fuse/stats, then
    the windowed BA."""
    with GLOBAL_TIMER.stage("mapping.new_keyframe"):
        proc = process_new_keyframe(
            m, kf_new, K, n_neighbors=n_neighbors, width=width, height=height,
            scale_factor=scale_factor, n_levels=n_levels)
    with GLOBAL_TIMER.stage("mapping.local_ba"):
        out = local_bundle_adjustment(
            proc.map, kf_new, K, n_window=n_window, n_fixed=n_fixed,
            n_points=n_points, scale_factor=scale_factor, iters=iters,
            covis_threshold=covis_threshold, bf=bf)
    return MapKFOut(map=out.map, n_created=proc.n_created,
                    n_fused=proc.n_fused, chi2=out.chi2)
