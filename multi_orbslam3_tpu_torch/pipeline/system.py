"""Monocular SLAM system: host state machine over the device stages
(counterpart of multi_orbslam3_tpu/pipeline/system.py, ``MonoSlam``).

The two-view bootstrap, the fused extract+track step (synchronous and
pipelined loops), the LOST/RECENTLY_LOST ladder with the Atlas
reset/new-map rules, the keyframe decision, the deferred per-keyframe
mapping chain, relocalization (BoW query + RANSAC PnP), localization-only
mode, and loop closing with Atlas merges, run synchronously when a mapping
result is adopted, on the frame loop's stream.

All map state lives on ``device``. Per frame the host reads one small
``packed`` tensor (pose + counts); on a GPU it is copied into pinned memory
as soon as the frame's work is enqueued, and the pipelined loop reads it
one frame later, while the next frame runs.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.bow import database as dbm
from multi_orbslam3_tpu_torch.bow import vocabulary as vocm
from multi_orbslam3_tpu_torch.config import SystemConfig
from multi_orbslam3_tpu_torch.dataio import checkpoint as ckpt
from multi_orbslam3_tpu_torch.frontend import extractor, matcher
from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.pipeline import initializer, local_mapping, tracking
from multi_orbslam3_tpu_torch.pipeline.loop_closing import LoopCloser


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


class _HostCopy:
    """A device tensor's value on the host. On a GPU the copy is enqueued
    into pinned memory at once and waited for only when read."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class MonoSlam:
    """Single-agent monocular SLAM. With loop closing off (how the
    reference's collaborative clients run) the system still keeps a BoW
    database for relocalization.

    Random streams: the initializer's RANSAC draws from a generator
    re-seeded from the agent id for every attempt, relocalization's PnP
    from its own generator seeded from the agent id once, and the loop
    closer from its own; the JAX package splits one key between the first
    two. Draws differ from JAX's; outcomes agree.

    All state lives on ``device``. Left out, it is the CUDA device, and the
    constructor raises where there is none: the system runs on the CPU only
    when the caller asks for it with ``device="cpu"``."""

    def __init__(self, config: SystemConfig, agent_id: int = 0,
                 enable_loop_closing: bool = True, vocabulary=None,
                 device=None):
        self.cfg = config
        self.agent = agent_id
        self.device = devices.resolve(device, "MonoSlam")
        self.K = cam.intrinsics_from_config(config.camera, self.device)
        c = config.camera
        self._cam4 = self._upload(np.array([c.fx, c.fy, c.cx, c.cy], np.float32))
        self.m = ms.empty_map(config.map.max_keyframes,
                              config.map.max_mappoints,
                              config.orb.n_features, self.device)
        voc = vocabulary if vocabulary is not None else vocm.default_vocabulary(
            config.bow.branching, config.bow.levels, device=self.device)
        self.loop_closer = None
        self.reloc_voc = self.reloc_db = None
        if enable_loop_closing:
            self.loop_closer = LoopCloser(
                voc, config.map.max_keyframes,
                consistency_hits=config.loop.consistency_hits,
                min_score=config.loop.min_bow_score)
        else:
            self.reloc_voc = voc
            self.reloc_db = dbm.KeyframeDatabase.empty(config.map.max_keyframes,
                                                       device=self.device)
        self.state = TrackState.NOT_INITIALIZED
        # localization-only: track against a frozen map, never mutate it
        self.localization_only = False
        self.T_cur = np.eye(4, dtype=np.float32)
        self.T_vel = np.eye(4, dtype=np.float32)
        # deferred mapping: (future map, kf slot, n_created, n_fused, event);
        # defer_mapping False adopts every result synchronously
        # (deterministic runs for drills and tests)
        self._pending_map = None
        self.defer_mapping = True
        # pipelined loop: in-flight (feats, res, ts, host copy of packed)
        self._pipe: List[tuple] = []
        # frames in flight before the host state machine consumes one:
        # frame i is dispatched while the host finalizes frame i - 1
        self.pipeline_depth = 1
        self._T_cur_dev = None
        self._T_vel_dev = None
        self._m_stats = None
        self._refined_pose_np = None
        self.frame_log: List[Tuple[float, TrackState]] = []
        self.ref_kf = 0
        self.frames_since_kf = 0
        self.lost_count = 0
        self._ok_streak = 0
        self._tracked_at_kf = 0
        self._active_map_kfs = 0
        self._next_map_id = 0
        self.frame_id = -1
        self._init_feats: Optional[FrameFeatures] = None
        self._init_ts = 0.0
        # the initializer's RANSAC stream, seeded from the agent id and
        # re-seeded for every attempt (the JAX package reuses one key)
        self._rng_seed = agent_id + 7
        self._gen = torch.Generator(device=self.device)
        self._reloc_gen = torch.Generator(device=self.device)
        self._reloc_gen.manual_seed(agent_id + 7)
        # sequence-relative time (float32 on device cannot hold epoch time)
        self.ts_origin: Optional[float] = None
        self.trajectory: List[Tuple[float, np.ndarray]] = []
        self.stats = {"kf_inserted": 0, "mp_created": 0, "frames_tracked": 0,
                      "frames_lost": 0}

    # ------------------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without stalling the stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _rel_ts(self, timestamp: float) -> float:
        if self.ts_origin is None:
            self.ts_origin = float(timestamp)
        return float(timestamp) - self.ts_origin

    def to_device(self, img) -> torch.Tensor:
        """Start the host->device transfer of a frame as uint8; callers
        can prefetch the next frame while the current one computes."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        a = np.asarray(img)
        if a.dtype != np.uint8:
            a = np.clip(np.round(a), 0.0, 255.0).astype(np.uint8)
        return self._upload(a)

    def process_frame(self, img, timestamp: float) -> TrackState:
        return self._process_frame(img, self._rel_ts(timestamp))

    def _process_frame(self, img, timestamp: float) -> TrackState:
        img = self.to_device(img)
        self.frame_id += 1
        # a >4 s timestamp jump starts a new sub-map
        if self.trajectory and timestamp - self.trajectory[-1][0] > 4.0 \
                and self.state != TrackState.NOT_INITIALIZED:
            self._create_new_map()
        self._adopt_pending()
        if self.state == TrackState.NOT_INITIALIZED:
            self._try_initialize(extractor.extract_features(img, self.cfg),
                                 timestamp)
        else:
            self._pre_track(timestamp)
            T_pred = (self.T_vel @ self.T_cur).astype(np.float32)
            feats, res, m_stats = tracking.extract_and_track(
                self.m, img, self._upload(T_pred), self.cfg)
            self._m_stats = m_stats
            self._track_decide(feats, res, T_pred, timestamp,
                               _HostCopy(res.packed).numpy())
            self._m_stats = None
            self._post_track(timestamp)
        self.trajectory.append((timestamp, self.T_cur.copy()))
        self.frame_log.append((timestamp, self.state))
        return self.state

    # ------------------------------------------------------------------
    # Pipelined loop: dispatch frame i, then finalize frame i-1 on the host
    # while frame i runs. The prediction chain stays on the device.
    # ------------------------------------------------------------------
    def process_frame_pipelined(self, img, timestamp: float) -> TrackState:
        if self.state != TrackState.OK and not self._pipe:
            # bootstrap / relost path: synchronous until tracking is OK
            st = self.process_frame(img, timestamp)
            self._T_cur_dev = None
            return st
        ts = self._rel_ts(timestamp)
        img = self.to_device(img)
        self.frame_id += 1
        self._adopt_pending()
        if self._T_cur_dev is None:
            self._T_cur_dev = self._upload(self.T_cur)
            self._T_vel_dev = self._upload(self.T_vel)
        feats, res, pose_dev, tvel_dev = tracking.fused_step_chained(
            self.cfg, self.m, img, self._T_cur_dev, self._T_vel_dev)
        self._pipe.append((feats, res, ts, _HostCopy(res.packed)))
        self._T_cur_dev, self._T_vel_dev = pose_dev, tvel_dev
        while len(self._pipe) > self.pipeline_depth:
            self._finalize_frame(*self._pipe.pop(0))
        return self.state

    def finish(self) -> None:
        """Drain the pipelined loop (finalize all in-flight frames)."""
        while self._pipe:
            self._finalize_frame(*self._pipe.pop(0))
        self._T_cur_dev = None

    def _finalize_frame(self, feats: FrameFeatures, res, ts: float,
                        packed: _HostCopy) -> None:
        arr = packed.numpy()
        T_pred = arr[18:34].reshape(4, 4).astype(np.float32)
        # found/visible statistics go on the CURRENT map (a keyframe may
        # have been inserted since the step's snapshot)
        if int(arr[16]) >= self.cfg.tracking.min_matches_refkf:
            self.m = ms.update_found_visible(self.m, res.feat_mp, res.visible)
        self._m_stats = self.m
        self._track_decide(feats, res, T_pred, ts, arr)
        self._m_stats = None
        expected = arr[:16].reshape(4, 4)
        if self.state not in (TrackState.OK, TrackState.RECENTLY_LOST):
            # reset/new-map path: drop in-flight frames of the dead gauge
            self._pipe = []
            self._T_cur_dev = None
        elif not (np.allclose(self.T_cur, expected, atol=1e-5)
                  or np.allclose(self.T_cur, T_pred, atol=1e-5)):
            # a fallback moved the host pose off the device chain: resync
            self._T_cur_dev = self._upload(self.T_cur)
            self._T_vel_dev = self._upload(self.T_vel)
        self.trajectory.append((ts, self.T_cur.copy()))
        self.frame_log.append((ts, self.state))

    def _pre_track(self, ts: float) -> None:
        """Hook: update the motion model before prediction (the inertial
        subclass propagates the IMU state here)."""

    def _post_track(self, ts: float) -> None:
        """Hook: after the tracking decision (velocity re-anchoring)."""

    def _refine_pose(self, feats: FrameFeatures, res):
        """Hook: refine the visually optimized frame pose (the inertial
        subclass runs the visual-inertial pose optimisation here). A hook
        that returns another result may leave the host copy of its pose in
        ``_refined_pose_np``."""
        return res

    def _frame_ur(self):
        """Hook: per-feature stereo right-u of the current frame (None for
        monocular systems)."""
        return None

    def _bf(self) -> float:
        """Hook: baseline * fx (0 disables the stereo residual rows)."""
        return 0.0

    def _seed_depth_points(self, k: int, feats: FrameFeatures) -> None:
        """Hook: stereo / RGB-D systems create depth-seeded landmarks for
        the new keyframe here, before the mapping chain is dispatched."""

    def _track(self, feats: FrameFeatures, ts: float) -> None:
        """Non-fused tracking, for callers that already hold the features
        (the stereo and RGB-D synchronous loops)."""
        c = self.cfg
        T_pred = (self.T_vel @ self.T_cur).astype(np.float32)
        res = tracking.track_frame(
            self.m, feats, self._upload(T_pred), self.K,
            width=c.camera.width, height=c.camera.height,
            scale_factor=c.orb.scale_factor, n_levels=c.orb.n_levels,
            radius_coarse=c.tracking.search_radius,
            u_r=self._frame_ur(), bf=self._bf())
        packed = _HostCopy(tracking.pack_result(res.pose, res)).numpy()
        self._track_decide(feats, res, T_pred, ts, packed)

    # ------------------------------------------------------------------
    def _try_initialize(self, feats: FrameFeatures, ts: float) -> None:
        if self._init_feats is None:
            self._init_feats = feats
            self._init_ts = ts
            return
        f0 = self._init_feats
        res = matcher.match_mutual(f0.desc, f0.valid, feats.desc, feats.valid,
                                   max_dist=matcher.TH_LOW, ratio=0.9,
                                   angle1=f0.angle, angle2=feats.angle)
        if int(res.count) < self.cfg.tracking.init_min_matches:
            self._init_feats = feats   # restart from the newer frame
            self._init_ts = ts
            return
        matched = res.idx >= 0
        idx_safe = torch.where(matched, res.idx, 0)
        self._gen.manual_seed(self._rng_seed)
        init = initializer.initialize_two_view(
            self.K, f0.uv_und, feats.uv_und[idx_safe], matched, self._gen)
        if not bool(init.ok):
            return

        # scale gauge: median scene depth -> 1
        pts = init.points.cpu().numpy()
        ok = init.point_ok.cpu().numpy()
        med = float(np.median(pts[ok, 2])) if ok.any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        T1 = init.T_21.cpu().numpy().copy()
        T1[:3, 3] *= scale

        n = self.cfg.orb.n_features
        no_assoc = torch.full((n,), ms.NO_MP, dtype=torch.int32, device=self.device)
        eye = torch.eye(4, device=self.device)
        self.m, k0 = ms.add_keyframe(self.m, f0, eye, self._init_ts, no_assoc,
                                     -1, self.agent, cam4=self._cam4)
        self.m, k1 = ms.add_keyframe(self.m, feats, self._upload(T1), ts,
                                     no_assoc, k0, self.agent, cam4=self._cam4)
        self.m, slots = ms.add_mappoints(
            self.m, self._upload((pts * scale).astype(np.float32)),
            init.point_ok & matched, f0.desc, k0, k0,
            torch.arange(n, device=self.device), k1, idx_safe, self.agent)
        # polish with a 2-KF BA (the reference runs a global BA here)
        self.m = local_mapping.local_bundle_adjustment(
            self.m, k1, self.K, n_window=2, n_fixed=0,
            n_points=local_mapping.mapping_kwargs(self.cfg)["n_points"],
            scale_factor=self.cfg.orb.scale_factor, iters=10).map
        k0, k1 = int(k0), int(k1)
        for k in (k0, k1):
            if self.loop_closer is not None:
                self.m = self._loop_close(k)
            else:
                self.add_to_reloc_db(self.m, k)
        self.T_cur = self.m.kf_pose[k1].cpu().numpy()
        self.T_vel = np.eye(4, dtype=np.float32)
        self.ref_kf = k1
        self.frames_since_kf = 0
        self._active_map_kfs = 2
        self.state = TrackState.OK
        self.stats["kf_inserted"] += 2
        self.stats["mp_created"] += int(torch.sum(slots >= 0))

    def _track_decide(self, feats: FrameFeatures, res, T_pred: np.ndarray,
                      ts: float, packed: np.ndarray) -> None:
        """The state ladder over one tracked frame; `packed` is the host
        copy of res.packed (pose + counts)."""
        c = self.cfg
        n_in = int(packed[16])
        pose_np = packed[:16].reshape(4, 4).astype(np.float32)
        # LOST in localization-only mode: relocalize before trusting the
        # last pose, which is no motion prior, as the reference's
        # localization mode does (the JAX package tracks from it first and
        # can lock onto a wrong pose when the replay starts far from it)
        stale = self.localization_only and self.state == TrackState.LOST

        if stale:
            n_in, self._m_stats = 0, None
        elif n_in < c.tracking.min_matches_localmap:
            # fallback: descriptor tracking against the reference keyframe
            res2 = tracking.track_reference_kf(
                self.m, self.ref_kf, feats, self._upload(self.T_cur), self.K,
                scale_factor=c.orb.scale_factor)
            n2 = int(res2.n_inliers)
            if n2 >= c.tracking.min_matches_refkf:
                res, n_in, pose_np = res2, n2, None

        if n_in < c.tracking.min_matches_refkf and self.lost_count >= 2:
            res3 = self._relocalize(feats)
            if res3 is not None:
                res, n_in, pose_np = res3, int(res3.n_inliers), None

        if n_in >= c.tracking.min_matches_refkf:
            res2 = self._refine_pose(feats, res)
            if res2 is not res:
                res, pose_np = res2, self._refined_pose_np
                self._refined_pose_np = None
            T_new = pose_np if pose_np is not None else res.pose.cpu().numpy()
            self.T_vel = (np.eye(4, dtype=np.float32) if stale else
                          (T_new @ np.linalg.inv(self.T_cur)).astype(np.float32))
            self.T_cur = T_new
            self.state = TrackState.OK
            self.lost_count = 0
            self._ok_streak += 1
            self.frames_since_kf += 1
            self.stats["frames_tracked"] += 1
            # the decay baseline rises during the post-KF recovery window
            if self.frames_since_kf <= 3:
                self._tracked_at_kf = max(self._tracked_at_kf, n_in)
            if self._m_stats is not None:
                self.m = self._m_stats
            else:
                self.m = ms.update_found_visible(self.m, res.feat_mp, res.visible)
            if self._need_keyframe(n_in):
                self._insert_keyframe(feats, res.feat_mp, ts)
                self._tracked_at_kf = n_in
        else:
            # RECENTLY_LOST: hold the motion model for a few frames
            self.lost_count += 1
            self._ok_streak = 0
            self.stats["frames_lost"] += 1
            self.T_cur = T_pred
            self.state = (TrackState.RECENTLY_LOST
                          if self.lost_count < c.tracking.relost_timeout
                          else TrackState.LOST)
            if self.state == TrackState.LOST and not self.localization_only:
                # a mature map is kept and a fresh sub-map starts; an
                # immature one is discarded and rebuilt in place;
                # localization-only mode keeps relocalizing instead
                n_active = int(torch.sum(
                    self.m.kf_valid & (self.m.kf_map_id == self.m.active_map)))
                if n_active >= 10:
                    self._create_new_map()
                else:
                    self._reset_active_map()

    # ------------------------------------------------------------------
    def _create_new_map(self) -> None:
        """Start a fresh sub-map; existing ones stay in the arena."""
        self._adopt_pending(force=True)
        self._next_map_id = max(self._next_map_id, int(self.m.active_map)) + 1
        self.m = ms.switch_map(self.m, self._next_map_id)
        self._restart("maps_created")

    def _reset_active_map(self) -> None:
        """Discard the immature active sub-map and re-initialize in place."""
        self._adopt_pending(force=True)
        self.m = ms.erase_active_map(self.m)
        self._restart("map_resets")

    def _restart(self, counter: str) -> None:
        self.state = TrackState.NOT_INITIALIZED
        self._init_feats = None
        self.lost_count = 0
        self._active_map_kfs = 0
        self.T_vel = np.eye(4, dtype=np.float32)
        self.stats[counter] = self.stats.get(counter, 0) + 1

    # ------------------------------------------------------------------
    def add_to_reloc_db(self, m, k: int) -> None:
        """Register keyframe k's BoW vector in the database this system
        runs (the loop closer's, or the relocalization one)."""
        db, voc = self._reloc_database()
        db, _ = dbm.add_keyframe_bow(db, voc, k, m.kf_desc[k], m.kf_feat_valid[k])
        if self.loop_closer is not None:
            self.loop_closer.db = db
        else:
            self.reloc_db = db

    def _reloc_database(self):
        if self.loop_closer is not None:
            return self.loop_closer.db, self.loop_closer.voc
        return self.reloc_db, self.reloc_voc

    def _relocalize(self, feats: FrameFeatures):
        """Database-wide recovery: the best BoW candidate keyframe, the
        pose from scratch by RANSAC PnP, and candidate-pose-seeded
        tracking as the fallback. A candidate in another sub-map makes it
        the active one."""
        db, voc = self._reloc_database()
        scores = dbm.query(db, voc, feats.desc, feats.valid,
                           torch.zeros(self.m.max_kf, dtype=torch.bool,
                                       device=self.device)).cpu().numpy()
        best = int(np.argmax(scores))
        if float(scores[best]) < self.cfg.loop.min_bow_score:
            return None
        sf = self.cfg.orb.scale_factor
        need = self.cfg.tracking.min_matches_refkf
        res = tracking.relocalize_candidate(self.m, best, feats, self.K,
                                            self._reloc_gen, scale_factor=sf)
        if int(res.n_inliers) < need:
            res = tracking.track_reference_kf(self.m, best, feats,
                                              self.m.kf_pose[best], self.K,
                                              scale_factor=sf)
            if int(res.n_inliers) < need:
                return None
        self.stats["relocalizations"] = self.stats.get("relocalizations", 0) + 1
        self.ref_kf = best
        cand_map = int(self.m.kf_map_id[best])
        if cand_map != int(self.m.active_map):
            self.m = ms.switch_map(self.m, cand_map)
            self.stats["map_switches"] = self.stats.get("map_switches", 0) + 1
        return res

    # ------------------------------------------------------------------
    def activate_localization_mode(self, checkpoint_path: Optional[str] = None) -> None:
        """Switch to localization-only tracking: optionally load a frozen
        map from a checkpoint, rebuild the BoW database over the map's
        keyframes and start LOST, so the first frames relocalize."""
        if checkpoint_path is not None:
            self.m, _ = ckpt.load_map(checkpoint_path, self.device)
        self.localization_only = True
        n = int(self.m.n_kf)
        for k in np.nonzero(self.m.kf_valid[:n].cpu().numpy())[0]:
            self.add_to_reloc_db(self.m, int(k))
        self.state = TrackState.LOST
        self.lost_count = 10**6      # relocalize at once
        self._init_feats = None

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False

    def _need_keyframe(self, n_inliers: int) -> bool:
        """Insert when tracking decays below a fraction of what the last
        keyframe saw, or the maximum interval elapses; never within two
        frames of a recovery."""
        c = self.cfg.tracking
        if self.localization_only or self._ok_streak < 2:
            return False
        if self.frames_since_kf < max(1, c.kf_min_interval):
            return False
        if self.frames_since_kf >= c.kf_max_interval:
            return n_inliers > 15
        baseline = self._tracked_at_kf or n_inliers
        return n_inliers < c.kf_tracked_ratio * baseline and n_inliers > 15

    def _insert_keyframe(self, feats: FrameFeatures, feat_mp: torch.Tensor,
                         ts: float) -> None:
        m, k_new = ms.add_keyframe(self.m, feats, self._upload(self.T_cur), ts,
                                   feat_mp, self.ref_kf, self.agent,
                                   u_r=self._frame_ur(), cam4=self._cam4)
        k = int(k_new)
        if k < 0:   # capacity reached
            return
        self.m = m
        self._seed_depth_points(k, feats)
        # an immature map adopts its mapping results synchronously: a young
        # map whose triangulations lag starves tracking of landmarks
        self._active_map_kfs += 1
        self._dispatch_mapping(k, defer=self.defer_mapping
                               and self._active_map_kfs > 10)
        self.ref_kf = k
        self.frames_since_kf = 0
        self.stats["kf_inserted"] += 1

    def _dispatch_mapping(self, k: int, defer: bool = True) -> None:
        """Enqueue the per-keyframe mapping chain. On a GPU its result is
        adopted at a later frame, once an event recorded after the chain
        has completed; on the CPU adoption is synchronous."""
        if self._pending_map is not None:
            self._adopt_pending(force=True)
        out = local_mapping.map_keyframe(
            self.m, k, self.K, **local_mapping.mapping_kwargs(self.cfg),
            bf=self._bf())
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._pending_map = (out.map, k, out.n_created, out.n_fused, event)
        if not defer:
            self._adopt_pending(force=True)

    def _adopt_pending(self, force: bool = False) -> None:
        """Swap in the finished mapping result and run loop closing on its
        keyframe; without `force`, only once the device has finished it,
        so the frame loop never stalls on the mapping chain."""
        if self._pending_map is None:
            return
        m_new, k, n_created, n_fused, event = self._pending_map
        if not force and event is not None and not event.query():
            return
        self._pending_map = None
        self.m = m_new
        self.stats["mp_created"] += int(n_created)
        self.stats["mp_fused"] = self.stats.get("mp_fused", 0) + int(n_fused)
        if self.loop_closer is None:
            self.add_to_reloc_db(self.m, k)
            return
        loops = self.loop_closer.loops_closed
        before = self.m.kf_pose[k]          # maps are never written in place
        self.m = self._loop_close(k)
        if self.loop_closer.loops_closed > loops:
            # a correction or merge moved the map under the live tracker:
            # re-gauge T_cur through the corrected keyframe
            # (T_cur' = T_cur T_k^-1 T_k') and resync the device chain
            T_rel = self.T_cur @ np.linalg.inv(before.cpu().numpy())
            self.T_cur = (T_rel @ self.m.kf_pose[k].cpu().numpy()).astype(np.float32)
            self._T_cur_dev = None

    def _yaw_only(self) -> bool:
        """Hook: 4-DoF (yaw + translation) essential-graph corrections, for
        gravity-aligned maps once an inertial system knows gravity."""
        return False

    def _loop_close(self, k: int):
        """The loop-closing cascade on keyframe k, with full camera context."""
        c = self.cfg
        return self.loop_closer.on_keyframe(
            self.m, k, fix_scale=self._bf() > 0.0 or self._yaw_only(),
            yaw_only=self._yaw_only(),
            K=self.K, width=c.camera.width, height=c.camera.height,
            scale_factor=c.orb.scale_factor, n_levels=c.orb.n_levels,
            min_proj_matches=c.loop.min_proj_matches,
            active_map_kfs=self._active_map_kfs)

    # ------------------------------------------------------------------
    def keyframe_trajectory(self) -> List[Tuple[float, np.ndarray]]:
        """(timestamp, T_cw) per valid keyframe of the biggest sub-map,
        ordered by slot."""
        self._adopt_pending(force=True)
        n = int(self.m.n_kf)
        valid = self.m.kf_valid[:n].cpu().numpy()
        map_id = self.m.kf_map_id[:n].cpu().numpy()
        ts = self.m.kf_timestamp[:n].cpu().numpy()
        poses = self.m.kf_pose[:n].cpu().numpy()
        if valid.any():
            ids, counts = np.unique(map_id[valid], return_counts=True)
            biggest = int(ids[np.argmax(counts)])
        else:
            biggest = 0
        origin = self.ts_origin or 0.0
        return [(float(ts[i]) + origin, poses[i]) for i in range(n)
                if valid[i] and map_id[i] == biggest]
