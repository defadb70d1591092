"""Loop detection and correction (counterpart of
multi_orbslam3_tpu/pipeline/loop_closing.py).

- Detection: per keyframe, one fused place-recognition step (covisibility
  exclusion + BoW query + database insert) on the frame loop's stream;
  then host bookkeeping over a numpy copy of the scores (temporal
  consistency streak, near-miss retry, interval and same-map guards,
  N-best candidate groups).
- Verification cascade: descriptor matching of the two covisible regions'
  landmarks (kernel K2 at P x P), Sim3 RANSAC, two-way reprojection Sim3
  refinement, guided projection count.
- Correction: an Atlas merge when the candidate lives in another sub-map,
  the Sim3 essential-graph optimisation (spanning tree + strongest
  covisibility pairs + the loop edge), landmarks corrected through their
  reference keyframes, duplicate fusion, then a welding BA at the seam.

Random draws come from the closer's own ``torch.Generator`` (seeded 1234,
as the JAX closer's key), so hypotheses differ from JAX's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multi_orbslam3_tpu_torch.bow import database as dbm
from multi_orbslam3_tpu_torch.bow.vocabulary import Vocabulary
from multi_orbslam3_tpu_torch.frontend import matcher
from multi_orbslam3_tpu_torch.frontend.extractor import topk_stable
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3, sim3
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.map.mapstate import MapState
from multi_orbslam3_tpu_torch.opt import pose_graph, sim3_solve
from multi_orbslam3_tpu_torch.pipeline import local_mapping
from multi_orbslam3_tpu_torch.pipeline.tracking import camera_center, predict_levels
from multi_orbslam3_tpu_torch.utils.timing import GLOBAL_TIMER


class LoopMatch(NamedTuple):
    """Landmark correspondences between the current and the candidate
    keyframe's covisible regions."""
    cur_mp: torch.Tensor       # (P,) int32 current-side slot (-1 invalid)
    cand_mp: torch.Tensor      # (P,) int32 candidate-side slot
    valid: torch.Tensor        # (P,) bool
    cur_region: torch.Tensor   # (P,) bool current-side region mask
    cand_region: torch.Tensor  # (P,) bool candidate-side region mask


def _group(m: MapState, kf) -> torch.Tensor:
    """(K,) bool: keyframe kf and every keyframe sharing a landmark."""
    kf = ms.as_index(kf, m.device)
    return (ms.covisibility_row(m, kf) > 0) | (torch.arange(m.max_kf, device=m.device) == kf)


def match_loop_landmarks(m: MapState, kf_cur, kf_cand) -> LoopMatch:
    """Descriptor-match the landmarks of the two keyframes' covisible
    regions (shared landmarks dropped), mutual nearest neighbours with
    ratio 0.95 over the whole landmark table: K2 at P x P."""
    obs = ms.kf_mp_mask(m)                                    # (K, P)
    mp_cur = torch.any(obs & _group(m, kf_cur)[:, None], dim=0)
    mp_cand = torch.any(obs & _group(m, kf_cand)[:, None], dim=0)
    both = mp_cur & mp_cand
    mp_cur, mp_cand = mp_cur & ~both, mp_cand & ~both
    res = matcher.match_mutual(m.mp_desc, mp_cur, m.mp_desc, mp_cand,
                               max_dist=matcher.TH_LOW, ratio=0.95)
    valid = res.idx >= 0
    return LoopMatch(
        cur_mp=torch.where(valid, torch.arange(m.max_mp, device=m.device), -1).to(torch.int32),
        cand_mp=torch.where(valid, res.idx, -1).to(torch.int32), valid=valid,
        cur_region=mp_cur, cand_region=mp_cand)


def verify_loop(m: MapState, lm: LoopMatch, generator: torch.Generator,
                fix_scale: bool = False) -> sim3_solve.Sim3RansacResult:
    """Sim3 RANSAC on the matched pairs, p_cur ~ S(p_cand); the inlier
    threshold is 0.1 x the current side's spread (at least 1 mm). The
    8-inlier minimum is only the seed gate of the cascade."""
    p_cand = m.mp_pos[torch.where(lm.valid, lm.cand_mp, 0).long()]
    p_cur = m.mp_pos[torch.where(lm.valid, lm.cur_mp, 0).long()]
    n = torch.clamp(torch.sum(lm.valid), min=1)
    mean = torch.sum(torch.where(lm.valid[:, None], p_cur, 0.0), dim=0) / n
    var = torch.sum(torch.where(lm.valid[:, None], (p_cur - mean) ** 2, 0.0),
                    dim=0) / n
    th = torch.clamp(0.1 * torch.sqrt(torch.sum(var)), min=1e-3)
    return sim3_solve.sim3_ransac(p_cand, p_cur, lm.valid, generator, n_hyp=192,
                                  inlier_th=th, min_inliers=8, fix_scale=fix_scale)


def _pair_observations(m: MapState, kf, mp_idx: torch.Tensor):
    """The 2D observation of landmark mp_idx[b] in keyframe kf: (uv (B, 2),
    inv_sigma2 (B,), has (B,)); has is False where kf does not observe
    it."""
    kf = ms.as_index(kf, m.device)
    row = ms.take(m.kf_mp, kf)
    N = row.shape[0]
    lut = torch.full((m.max_mp,), -1, dtype=torch.int64, device=m.device)
    lut = ms.scatter_rows(lut, row, row >= 0, torch.arange(N, device=m.device))
    fi = torch.cat([lut, lut.new_full((1,), -1)])[
        torch.where(mp_idx >= 0, mp_idx, m.max_mp).long()]
    has = (fi >= 0) & (mp_idx >= 0)
    fi_s = torch.where(has, fi, 0)
    uv = ms.take(m.kf_uv, kf)[fi_s]
    lv = ms.take(m.kf_level, kf)[fi_s].to(torch.float32)
    return uv, torch.pow(1.2, -2.0 * lv), has


def guided_projection_count(m: MapState, kf_cur, S: sim3.Sim3,
                            cand_region: torch.Tensor, K: cam.PinholeK, *,
                            width: int, height: int, scale_factor: float = 1.2,
                            n_levels: int = 8, radius: float = 8.0) -> torch.Tensor:
    """Project the candidate region's landmarks into the current keyframe
    at its Sim3-corrected pose and count one-to-one descriptor matches
    (level gating off: scale predictions are unreliable across a loop)."""
    kf_cur = ms.as_index(kf_cur, m.device)
    S_corr = sim3.compose(sim3.from_se3(ms.take(m.kf_pose, kf_cur)), S)
    T = sim3.to_se3_scaled(S_corr)
    K = ms.kf_intrinsics(m, kf_cur, K)
    p_c = se3.apply(T[None], m.mp_pos)
    uv_proj = cam.project(K, p_c)
    ok = (cand_region & m.mp_valid & (p_c[..., 2] > 0.05)
          & cam.in_image(uv_proj, width, height))
    pred_lv = predict_levels(m, camera_center(T), scale_factor, n_levels)
    r = radius * torch.pow(float(scale_factor), pred_lv.to(torch.float32))
    res = matcher.match_by_projection(
        uv_proj, ok, m.mp_desc, ms.take(m.kf_uv, kf_cur),
        ms.take(m.kf_feat_valid, kf_cur), ms.take(m.kf_desc, kf_cur),
        ms.take(m.kf_level, kf_cur), r, pred_lv, max_dist=matcher.TH_HIGH,
        ratio=0.9, level_slack=n_levels)
    res = matcher.resolve_duplicate_targets(res, m.n_feat)
    return torch.sum((res.idx >= 0).to(torch.int32))


class CascadeResult(NamedTuple):
    ok: bool
    S: Optional[sim3.Sim3]          # p_cur ~ S(p_cand)
    lm: Optional[LoopMatch]
    inliers: Optional[torch.Tensor]
    n_proj: int


def verify_candidate_cascade(m: MapState, kf_cur: int, kf_cand: int,
                             generator: torch.Generator, K: cam.PinholeK, *,
                             width: int, height: int, scale_factor: float = 1.2,
                             n_levels: int = 8, fix_scale: bool = False,
                             min_proj_matches: int = 25) -> CascadeResult:
    """Sim3 RANSAC seed -> two-way reprojection refinement -> guided
    projection re-check, with host decisions between the stages."""
    lm = match_loop_landmarks(m, kf_cur, kf_cand)
    res = verify_loop(m, lm, generator, fix_scale=fix_scale)
    if not bool(res.ok):
        return CascadeResult(False, None, lm, None, 0)
    pair_ok = lm.valid & res.inliers
    p_cand = m.mp_pos[torch.where(pair_ok, lm.cand_mp, 0).long()]
    p_cur = m.mp_pos[torch.where(pair_ok, lm.cur_mp, 0).long()]
    uv_cur, is2_cur, has_cur = _pair_observations(
        m, kf_cur, torch.where(pair_ok, lm.cur_mp, -1))
    uv_cand, is2_cand, has_cand = _pair_observations(
        m, kf_cand, torch.where(pair_ok, lm.cand_mp, -1))
    S_ref, _, _ = sim3_solve.optimize_sim3_reprojection(
        res.S, ms.kf_intrinsics(m, kf_cur, K), m.kf_pose[kf_cur],
        m.kf_pose[kf_cand], p_cand, uv_cur, has_cur, p_cur, uv_cand, has_cand,
        is2_cur, is2_cand, fix_scale=fix_scale,
        K_cand=ms.kf_intrinsics(m, kf_cand, K))
    # too few pairs with a 2D observation: keep the 3D-3D estimate
    S_final = S_ref if int(torch.sum(has_cur | has_cand)) >= 10 else res.S
    n_proj = int(guided_projection_count(
        m, kf_cur, S_final, lm.cand_region, K, width=width, height=height,
        scale_factor=scale_factor, n_levels=n_levels))
    return CascadeResult(n_proj >= min_proj_matches, S_final, lm, res.inliers,
                         n_proj)


def nbest_candidates(m: MapState, scores_np: np.ndarray, n_best: int = 3,
                     min_score: float = 0.03):
    """Covisibility-group accumulated N-best selection: each raw candidate's
    score is summed over its covisible group; groups are deduplicated
    greedily and each contributes its best-scoring member. np.argsort
    keeps the JAX package's candidate order, ties included."""
    order = np.argsort(-scores_np)[:8]
    cands = []
    used = np.zeros(scores_np.shape[0], bool)
    for k in order:
        if scores_np[k] < min_score or used[k]:
            continue
        grp = ms.covisibility_row(m, int(k)).cpu().numpy() > 0
        grp[k] = True
        acc = float(scores_np[grp].sum())
        rep = int(np.argmax(np.where(grp, scores_np, -1.0)))
        cands.append((rep, acc, grp))
        used |= grp
        if len(cands) >= n_best:
            break
    cands.sort(key=lambda c: -c[1])
    return cands


def weld_after_merge(m: MapState, kf_cur, K: cam.PinholeK, *, width: int,
                     height: int, scale_factor: float = 1.2, n_levels: int = 8,
                     n_points: int = 4096, bf: float = 0.0) -> MapState:
    """Welding after a loop/merge correction: fuse duplicate landmarks into
    the seam keyframe, then a local BA centred on it (post-fusion
    covisibility spans both sides of the seam). bf = baseline * fx > 0 adds
    the stereo rows to that BA."""
    m = local_mapping.fuse_into_keyframe(
        m, kf_cur, K, width=width, height=height, scale_factor=scale_factor,
        n_levels=n_levels).map
    return local_mapping.local_bundle_adjustment(
        m, kf_cur, K, n_window=16, n_fixed=8, n_points=min(n_points, m.max_mp),
        scale_factor=scale_factor, iters=8, bf=bf).map


def correct_loop(m: MapState, kf_cur, kf_cand, S_loop: sim3.Sim3,
                 max_covis_edges: int = 256, iters: int = 10,
                 fix_scale: bool = False, yaw_only: bool = False,
                 covis_strong: int = 30) -> MapState:
    """Essential-graph correction. S_loop: p_cur ~ S_loop(p_cand), the
    current region's drift relative to the loop region. The loop edge pins
    the corrected current keyframe at S_cur o S_loop; the candidate and
    every invalid slot are fixed. yaw_only selects the 4-DoF graph."""
    K = m.max_kf
    dev = m.device
    kf_cur = ms.as_index(kf_cur, dev)
    kf_cand = ms.as_index(kf_cand, dev)
    S_nodes = sim3.stack(sim3.from_se3(m.kf_pose))                 # (K, 13)

    # spanning tree
    parent = m.kf_parent.long()
    tree_j = torch.clamp(parent, min=0)
    tree_ok = (parent >= 0) & m.kf_valid & m.kf_valid[tree_j]
    # strongest covisibility pairs (ties: lower flat index, as lax.top_k)
    W = torch.triu(ms.covisibility_matrix(m), diagonal=1)
    vals, idxs = topk_stable(W.reshape(-1), max_covis_edges)
    # the loop edge, measured at the corrected current pose
    S_cur_corr = sim3.compose(sim3.from_se3(ms.take(m.kf_pose, kf_cur)), S_loop)
    loop_meas = sim3.compose(S_cur_corr, sim3.inverse(
        sim3.from_se3(ms.take(m.kf_pose, kf_cand))))

    one = torch.ones(1, dtype=torch.bool, device=dev)
    edges = pose_graph.make_edges(
        S_nodes,
        torch.cat([torch.arange(K, device=dev), idxs // K, kf_cur.reshape(1)]),
        torch.cat([tree_j, idxs % K, kf_cand.reshape(1)]),
        torch.cat([torch.ones(K + max_covis_edges, device=dev),
                   torch.full((1,), 100.0, device=dev)]),
        torch.cat([tree_ok, vals >= covis_strong, one]))
    # overwrite the loop edge with the corrected measurement
    edges = edges._replace(S_ij=torch.cat([edges.S_ij[:-1],
                                           sim3.stack(loop_meas)[None]]))
    fixed = ms.scatter_rows(~m.kf_valid, kf_cand.reshape(1), one, True)
    S_opt = pose_graph.optimize_pose_graph(S_nodes, fixed, edges, iters=iters,
                                           fix_scale=fix_scale, yaw_only=yaw_only)

    kf_pose = torch.where(m.kf_valid[:, None, None],
                          sim3.to_se3_scaled(sim3.unstack(S_opt)), m.kf_pose)
    # landmarks through their reference keyframe: p' = S_new^-1(S_old(p))
    ref = torch.clamp(m.mp_ref_kf, 0, K - 1).long()
    p_cam = sim3.apply(sim3.unstack(S_nodes[ref]), m.mp_pos)
    p_corr = sim3.apply(sim3.inverse(sim3.unstack(S_opt[ref])), p_cam)
    mp_pos = torch.where((m.mp_valid & (m.mp_ref_kf >= 0))[:, None], p_corr, m.mp_pos)
    return m._replace(kf_pose=kf_pose, mp_pos=mp_pos)


def _pr_step(db: dbm.KeyframeDatabase, voc: Vocabulary, m: MapState, kf):
    """Per-keyframe place recognition: exclude the connected group (shared
    landmarks >= 15 per 1024 features, at least 3) and the keyframe
    itself, query the database, insert the keyframe. Launches device work
    and reads nothing back. Returns (scores (max_kf,), new db)."""
    kf = ms.as_index(kf, m.device)
    desc = ms.take(m.kf_desc, kf)
    fvalid = ms.take(m.kf_feat_valid, kf)
    thr = max(3, round(15 * m.n_feat / 1024))
    exclude = ((ms.covisibility_row(m, kf) >= thr)
               | (torch.arange(m.max_kf, device=m.device) == kf))
    scores = dbm.query(db, voc, desc, fvalid, exclude)
    db2, _ = dbm.add_keyframe_bow(db, voc, kf, desc, fvalid)
    return scores, db2


# a loop or merge is welded only on this many Sim3 RANSAC inlier pairs
# (upstream's Sim3Solver minimum, nBoWInliers); see LoopCloser._supported
MIN_SIM3_INLIERS = 15


class LoopCloser:
    """Host-side loop-closing controller: detection bookkeeping and
    correction dispatch, one per map."""

    def __init__(self, voc: Vocabulary, max_kf: int, consistency_hits: int = 3,
                 min_score: float = 0.03, min_interval_kfs: int = 10):
        self.voc = voc
        self.db = dbm.KeyframeDatabase.empty(max_kf, device=voc.device)
        self.consistency_hits = consistency_hits
        self.min_score = min_score
        self.min_interval_kfs = min_interval_kfs
        self._streak_cand = -1
        self._streak = 0
        self._last_loop_kf = -10**9
        self._gen = torch.Generator(device=voc.device)
        self._gen.manual_seed(1234)
        self.loops_closed = 0
        self.merges = 0
        # a candidate that passed Sim3 RANSAC but missed the projection
        # gate is retried directly on the next keyframes
        self._pending_cand = -1
        self._pending_tries = 0

    def on_keyframe(self, m: MapState, kf: int, K: cam.PinholeK, *,
                    width: int, height: int, fix_scale: bool = False,
                    yaw_only: bool = False, scale_factor: float = 1.2,
                    n_levels: int = 8, min_proj_matches: int = 25,
                    active_map_kfs: Optional[int] = None) -> MapState:
        """Process a freshly mapped keyframe: place recognition, temporal
        consistency, the verification cascade over the N-best candidate
        groups, correction and welding. Returns the (possibly corrected)
        map. Maps below 12 keyframes only register in the database. (The
        JAX closer also takes K=None for a 3D-3D-only path; its one caller
        always passes the camera, so that path is not ported.)"""
        scores, self.db = _pr_step(self.db, self.voc, m, kf)
        if active_map_kfs is not None and active_map_kfs < 12:
            self._streak = 0
            self._streak_cand = -1
            return m
        with GLOBAL_TIMER.stage("wait.scores"):
            scores_np = scores.cpu().numpy().copy()
        # the most recent keyframes always score high and are never loops
        scores_np[max(0, kf - 10):kf + 1] = 0.0
        best = int(np.argmax(scores_np))
        cascade_kw = dict(width=width, height=height, scale_factor=scale_factor,
                          n_levels=n_levels, fix_scale=fix_scale,
                          min_proj_matches=min_proj_matches)

        # continuity retry of the last keyframe's near-miss candidate
        if self._pending_cand >= 0 and \
                kf - self._last_loop_kf >= self.min_interval_kfs:
            cand_kf = self._pending_cand
            casc = verify_candidate_cascade(m, kf, cand_kf, self._gen, K, **cascade_kw)
            if casc.ok and self._supported(casc):
                self._pending_cand = -1
                return self._accept(m, kf, cand_kf, casc, K, width, height,
                                    scale_factor, n_levels, fix_scale, yaw_only)
            self._pending_tries -= 1
            if self._pending_tries <= 0:
                self._pending_cand = -1

        if kf - self._last_loop_kf < self.min_interval_kfs or \
                float(scores_np[best]) < self.min_score:
            self._streak = 0
            self._streak_cand = -1
            return m

        # temporal consistency: the same candidate region on consecutive KFs
        if self._streak_cand >= 0 and (
                best == self._streak_cand
                or int(ms.covisibility_row(m, best)[self._streak_cand]) > 0):
            self._streak += 1
        else:
            self._streak = 1
        self._streak_cand = best
        if self._streak < self.consistency_hits:
            return m

        for cand_kf, _, _ in nbest_candidates(m, scores_np, n_best=3,
                                              min_score=self.min_score):
            # a same-map candidate must be a real revisit (>= 5 s apart)
            if int(m.kf_map_id[cand_kf]) == int(m.active_map) and \
                    abs(float(m.kf_timestamp[kf]) - float(m.kf_timestamp[cand_kf])) < 5.0:
                continue
            casc = verify_candidate_cascade(m, kf, cand_kf, self._gen, K, **cascade_kw)
            if not (casc.ok and self._supported(casc)):
                if casc.S is not None and self._pending_cand < 0:
                    self._pending_cand = cand_kf
                    self._pending_tries = 3
                continue
            self._pending_cand = -1
            return self._accept(m, kf, cand_kf, casc, K, width, height,
                                scale_factor, n_levels, fix_scale, yaw_only)
        return m

    def _supported(self, casc: CascadeResult) -> bool:
        """A verified cascade is accepted only on at least MIN_SIM3_INLIERS
        landmark pairs of its Sim3 RANSAC (upstream's Sim3Solver minimum in
        LoopClosing::DetectCommonRegionsFromBoW, nBoWInliers = 15); the
        cascade itself seeds on 8. Its projection gate cannot catch a Sim3
        that a few pairs got wrong in scale: such an error scales the
        candidate region about the current camera and leaves its
        projections in place, in the current keyframe and its near
        neighbours alike. Unsupported, the candidate is retried on the next
        keyframes like a projection miss."""
        return int(torch.sum(casc.lm.valid & casc.inliers)) >= MIN_SIM3_INLIERS

    def _accept(self, m: MapState, kf: int, cand_kf: int, casc: CascadeResult,
                K, width: int, height: int, scale_factor: float, n_levels: int,
                fix_scale: bool, yaw_only: bool) -> MapState:
        """An accepted loop: Atlas merge when the candidate is in another
        sub-map (then an identity loop constraint distributes the residual),
        essential-graph correction, duplicate fusion, welding BA."""
        if int(m.kf_map_id[cand_kf]) != int(m.active_map):
            m = ms.merge_active_into(m, int(m.kf_map_id[cand_kf]), casc.S)
            self.merges += 1
            m = correct_loop(m, kf, cand_kf, sim3.identity(device=m.device),
                             fix_scale=fix_scale, yaw_only=yaw_only)
        else:
            m = correct_loop(m, kf, cand_kf, casc.S, fix_scale=fix_scale,
                             yaw_only=yaw_only)
        ok = casc.lm.valid & casc.inliers
        m = ms.replace_mappoint(m, torch.where(ok, casc.lm.cur_mp, -1),
                                torch.where(ok, casc.lm.cand_mp, -1))
        m = weld_after_merge(m, kf, K, width=width, height=height,
                             scale_factor=scale_factor, n_levels=n_levels)
        self._last_loop_kf = kf
        self._streak = 0
        self._streak_cand = -1
        self.loops_closed += 1
        return m
