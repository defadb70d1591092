"""Monocular-inertial SLAM system (counterpart of
multi_orbslam3_tpu/pipeline/inertial_system.py).

Extends MonoSlam through its hooks with the visual-inertial machinery:

- IMU samples between frames are preintegrated (fixed-capacity windows)
  and accumulated per keyframe interval;
- the camera-IMU extrinsics T_bc are threaded through prediction,
  per-frame optimisation, inertial initialisation and the window BA: the
  body pose is T_wb = (T_bc T_cw)^-1 everywhere;
- after enough keyframes and integration time, the inertial
  initialisation estimates gravity, scale and biases; the whole map is
  re-gauged so that gravity is world -z and scale is metric, after which
  ``inertial_ready`` is set;
- tracking prediction switches from the constant-velocity model to IMU
  state propagation, and every tracked frame runs the visual-inertial
  pose optimisation;
- the keyframe-window BA switches to the visual-inertial solver.

The preintegrated windows live on the device; their durations are
mirrored on the host (``kf_preint_dt``), so the decisions that only need
a duration read nothing back.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from multi_orbslam3_tpu_torch.config import SystemConfig
from multi_orbslam3_tpu_torch.geometry import se3, sim3
from multi_orbslam3_tpu_torch.imu import preintegration as pre
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.opt import inertial_ba, inertial_init, vi_pose_opt
from multi_orbslam3_tpu_torch.opt.local_ba import BAObservations
from multi_orbslam3_tpu_torch.pipeline.local_mapping import fixed_size_unique
from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam, TrackState
from multi_orbslam3_tpu_torch.pipeline.tracking import TrackResult, level_inv_sigma2


class _Window:
    """A preintegrated window on the device with its duration on the host."""

    __slots__ = ("p", "dt")

    def __init__(self, p: pre.Preintegrated, dt: float):
        self.p = p
        self.dt = dt

    def merged(self, other: "_Window") -> "_Window":
        return _Window(pre.merge_preintegrated(self.p, other.p),
                       self.dt + other.dt)


def _merge(a: Optional[_Window], b: _Window) -> _Window:
    return b if a is None else a.merged(b)


class MonoInertialSlam(MonoSlam):
    """sensor='imu_mono': process_frame_imu(img, ts, acc, gyro, dt). Runs on
    the CUDA device unless the caller passes ``device="cpu"``."""

    def __init__(self, config: SystemConfig, agent_id: int = 0,
                 enable_loop_closing: bool = True, vocabulary=None,
                 device=None):
        super().__init__(config, agent_id, enable_loop_closing, vocabulary,
                         device=device)
        self.calib = pre.ImuCalib.from_config(config.imu, self.device)
        self.T_bc = np.asarray(config.imu.T_bc, np.float32).reshape(4, 4)
        self.g_w = np.array([0.0, 0.0, -config.imu.gravity], np.float32)
        self._g_w_dev = self._upload(self.g_w)
        self.imu_initialized = False
        self.inertial_ready = False          # gate for the collaborative uplink
        self.bg = np.zeros(3, np.float32)
        self.ba_bias = np.zeros(3, np.float32)
        self.v_cur = np.zeros(3, np.float32)
        # per-keyframe inertial state (host mirrors, slot-indexed)
        mk = config.map.max_keyframes
        self.kf_velocity = np.zeros((mk, 3), np.float32)
        self.kf_preint: List[Optional[pre.Preintegrated]] = [None] * mk
        self.kf_preint_dt = np.zeros(mk, np.float64)
        self._accum: Optional[_Window] = None        # since the last keyframe
        self._frame_window: Optional[_Window] = None
        # rolling (timestamp, per-frame window) pairs, from which the
        # KF0 -> KF1 window is assembled at the two-view bootstrap
        self._frame_windows: List[tuple] = []
        # VI pose-opt anchoring: the state at the last tracked frame and the
        # preintegration accumulated since it (survives RECENTLY_LOST gaps)
        self._prev_state = None              # (T_cw, v, bg, ba)
        self._since_prev: Optional[_Window] = None
        self._v_fresh = False
        self._last_ok_ts: Optional[float] = None
        self._last_ok_T: Optional[np.ndarray] = None
        self._vi_ba_pending: Optional[int] = None
        self.pending_gauge = None
        self.mp_hold = None                  # set by the collaborative layer
        # scale observability needs integration time and excitation: wait
        # for a long enough keyframe chain, and refine once more later
        self._init_kf_count = 8
        self._min_init_time = 2.0
        self._refine_time = 4.0
        self._refined = False
        # the stereo / RGB-D inertial subclasses fix the scale: depth already
        # pins the metric gauge
        self._fix_scale = False

    # ------------------------------------------------------------------
    def _need_keyframe(self, n_inliers: int) -> bool:
        # before the IMU is initialized: a keyframe every 0.2 s; temporal
        # density is what makes gravity and scale observable
        if not self.imu_initialized and n_inliers > 15 and \
                self.frames_since_kf >= max(
                    1, int(round(0.2 * self.cfg.camera.fps))):
            return True
        return super()._need_keyframe(n_inliers)

    def _yaw_only(self) -> bool:
        """A gravity-aligned metric map after IMU init: loop corrections
        run the 4-DoF essential graph."""
        return self.imu_initialized

    # ------------------------------------------------------------------
    def _T_wb(self, T_cw: np.ndarray) -> np.ndarray:
        """World-from-body pose for a camera pose: T_wb = (T_bc T_cw)^-1."""
        return np.linalg.inv(self.T_bc @ T_cw).astype(np.float32)

    def _T_cw_from_wb(self, T_wb: np.ndarray) -> np.ndarray:
        return (np.linalg.inv(self.T_bc) @ np.linalg.inv(T_wb)).astype(np.float32)

    # ------------------------------------------------------------------
    def process_frame_imu(self, img, timestamp: float, acc: np.ndarray,
                          gyro: np.ndarray, dt: np.ndarray) -> TrackState:
        """acc/gyro: (S, 3) samples since the previous frame; dt: (S,)
        with zeros for padding."""
        t = self._rel_ts(timestamp)
        self._accumulate_imu(acc, gyro, dt)
        self._frame_windows.append((t, self._frame_window))
        if len(self._frame_windows) > 240:
            self._frame_windows.pop(0)
        return self._process_frame(img, t)

    def _accumulate_imu(self, acc: np.ndarray, gyro: np.ndarray,
                        dt: np.ndarray) -> None:
        """Preintegrate one inter-frame IMU window into the running
        accumulators (every frame entry point feeds through here). The
        samples and the biases go up in one transfer."""
        S_cap = self.cfg.imu.max_samples_per_frame
        dt = _pad_to(dt, S_cap)
        packed = np.concatenate([
            _pad_to(acc, S_cap).reshape(-1), _pad_to(gyro, S_cap).reshape(-1),
            dt, self.bg, self.ba_bias]).astype(np.float32)
        dev = self._upload(packed)
        n3 = 3 * S_cap
        window = _Window(pre.preintegrate(
            dev[:n3].reshape(S_cap, 3), dev[n3:2 * n3].reshape(S_cap, 3),
            dev[2 * n3:2 * n3 + S_cap], dev[-6:-3], dev[-3:], self.calib),
            float(np.sum(dt[dt > 0.0], dtype=np.float64)))
        self._accum = _merge(self._accum, window)
        self._since_prev = _merge(self._since_prev, window)
        self._frame_window = window

    # ------------------------------------------------------------------
    def _pre_track(self, ts: float) -> None:
        if self.imu_initialized and self._since_prev is not None:
            # IMU prediction replaces the constant-velocity model; the
            # window spans the time since the last tracked frame, so a
            # RECENTLY_LOST gap still propagates correctly
            T_wb = self._T_wb(self.T_cur)
            state = self._upload(np.concatenate(
                [T_wb[:3, :3].reshape(-1), self.v_cur, T_wb[:3, 3], self.bg,
                 self.ba_bias]).astype(np.float32))
            R2, v2, p2 = pre.predict_state(
                state[:9].reshape(3, 3), state[9:12], state[12:15],
                self._since_prev.p, self._g_w_dev, state[15:18], state[18:21])
            # one device->host transfer for the predicted state
            flat = torch.cat([R2.reshape(-1), v2, p2]).cpu().numpy()
            T_wb2 = np.eye(4, dtype=np.float32)
            T_wb2[:3, :3] = flat[:9].reshape(3, 3)
            T_wb2[:3, 3] = flat[12:15]
            T_pred = self._T_cw_from_wb(T_wb2)
            self.v_cur = flat[9:12].astype(np.float32)
            # feed the motion model with the IMU prediction
            self.T_vel = (T_pred @ np.linalg.inv(self.T_cur)).astype(np.float32)

    # ------------------------------------------------------------------
    def _refine_pose(self, feats, res):
        """Per-frame visual-inertial pose optimisation: fuse the
        preintegration factor from the last tracked frame's state with the
        frame's reprojection residuals."""
        if not self.imu_initialized or self._prev_state is None \
                or self._since_prev is None:
            return res
        T_prev, v_prev, bg_prev, ba_prev = self._prev_state
        state = self._upload(np.concatenate(
            [T_prev.reshape(-1), v_prev, bg_prev, ba_prev, self.v_cur,
             self.T_bc.reshape(-1)]).astype(np.float32))
        T_prev_d, v_prev_d = state[:16].reshape(4, 4), state[16:19]
        bg_d, ba_d, v_cur_d = state[19:22], state[22:25], state[25:28]
        feat_mp = res.feat_mp
        mp_safe = torch.where(feat_mp >= 0, feat_mp, 0).long()
        out = vi_pose_opt.pose_inertial_optimization(
            res.pose, v_cur_d, bg_d, ba_d, T_prev_d, v_prev_d, bg_d, ba_d,
            self._since_prev.p, self.K, self.m.mp_pos[mp_safe], feats.uv_und,
            level_inv_sigma2(feats.level, self.cfg.orb.scale_factor),
            (feat_mp >= 0) & feats.valid, self._g_w_dev,
            state[28:44].reshape(4, 4),
            gyro_walk2=self.calib.gyro_walk2, acc_walk2=self.calib.acc_walk2)
        # one packed transfer: pose + velocity + biases + inlier count
        flat = torch.cat([out.pose.reshape(-1), out.velocity, out.bg, out.ba,
                          out.n_inliers.float()[None]]).cpu().numpy()
        n_in = int(flat[25])
        pose = flat[:16].reshape(4, 4).astype(np.float32)
        if n_in < self.cfg.tracking.min_matches_refkf or \
                not np.all(np.isfinite(pose)):
            return res
        self.v_cur = flat[16:19].astype(np.float32)
        self.bg = flat[19:22].astype(np.float32)
        self.ba_bias = flat[22:25].astype(np.float32)
        self._refined_pose_np = pose     # _track_decide reuses the fetch
        return TrackResult(
            pose=out.pose, feat_mp=torch.where(out.inliers, feat_mp, ms.NO_MP),
            n_inliers=out.n_inliers, n_matches=res.n_matches,
            visible=res.visible)

    def _post_track(self, ts: float) -> None:
        # end-of-frame adoption: the VI window BA of a keyframe inserted at
        # this frame lands in the same frame (the per-frame VI chain is
        # tightly coupled to the BA-refreshed velocity and bias state)
        self._adopt_pending(force=True)
        if self.state == TrackState.OK:
            if self.imu_initialized and self._prev_state is None \
                    and not self._v_fresh:
                # first OK frame after a relocalization or new-map event
                # with no usable velocity: re-anchor from body-position
                # finite differences. Never at the IMU-init frame itself,
                # where _last_ok_T is in the pre-gauge frame.
                if self._last_ok_ts is not None and ts > self._last_ok_ts:
                    p0 = self._T_wb(self._last_ok_T)[:3, 3]
                    p1 = self._T_wb(self.T_cur)[:3, 3]
                    self.v_cur = ((p1 - p0) / (ts - self._last_ok_ts)).astype(
                        np.float32)
            self._v_fresh = False
            # anchor the next frame's VI optimisation on this state
            self._prev_state = (self.T_cur.copy(), self.v_cur.copy(),
                                self.bg.copy(), self.ba_bias.copy())
            self._since_prev = None
            self._last_ok_ts = ts
            self._last_ok_T = self.T_cur.copy()

    # ------------------------------------------------------------------
    def _try_initialize(self, feats, ts):
        super()._try_initialize(feats, ts)
        if self.state == TrackState.OK:
            # the two-view bootstrap created two keyframes outside
            # _insert_keyframe (at slots parent(ref_kf), ref_kf). The running
            # accumulator spans since the start of the stream, but the
            # bootstrap factor must span exactly the keyframe gap: rebuild
            # it from the per-frame windows.
            k1 = self.ref_kf
            stamps = self.m.kf_timestamp.cpu().numpy()
            k0 = int(self.m.kf_parent[k1])
            ts0, ts1 = float(stamps[k0]), float(stamps[k1])
            # kf_timestamp is float32 while frame labels are float64:
            # compare with a tolerance well under the frame period, or the
            # window at exactly ts0 leaks in and over-spans the factor
            eps = 1e-3
            win = None
            for t, w in self._frame_windows:
                if ts0 + eps < t <= ts1 + eps:
                    win = _merge(win, w)
            self._set_kf_window(k1, win)
            self._accum = None

    def _set_kf_window(self, k: int, w: Optional[_Window]) -> None:
        self.kf_preint[k] = None if w is None else w.p
        self.kf_preint_dt[k] = 0.0 if w is None else w.dt

    # ------------------------------------------------------------------
    def _insert_keyframe(self, feats, feat_mp, ts):
        prev_n = self.stats["kf_inserted"]
        super()._insert_keyframe(feats, feat_mp, ts)
        if self.stats["kf_inserted"] > prev_n:       # insertion succeeded
            # adopt the mapping chain here: the VI window BA consumes the
            # mapped keyframe's new landmarks
            self._adopt_pending(force=True)
            k = self.ref_kf
            self._set_kf_window(k, self._accum)
            self.kf_velocity[k] = self.v_cur
            self._accum = None
            if not self.imu_initialized:
                self._maybe_initialize_imu()
            else:
                self._vi_ba_pending = k
                self._adopt_pending(force=True)

    def _adopt_pending(self, force: bool = False) -> None:
        had = self._pending_map is not None
        super()._adopt_pending(force)
        adopted = had and self._pending_map is None
        k = self._vi_ba_pending
        if k is not None and (adopted or self._pending_map is None):
            self._vi_ba_pending = None
            if not self._refined:
                n = int(self.m.n_kf)
                total_t = float(sum(
                    self.kf_preint_dt[i] for i in range(1, n)
                    if self.kf_preint[i] is not None))
                if total_t > self._refine_time:
                    self._refined = True
                    self._maybe_initialize_imu(refine=True)
            if k >= 3:
                self._inertial_window_ba(k)

    # ------------------------------------------------------------------
    def _own_slots(self, k_last: Optional[int] = None):
        """(n_kf, valid own keyframe slots up to k_last, kf timestamps)."""
        n = int(self.m.n_kf)
        flat = torch.cat([self.m.kf_valid[:n].float(), self.m.kf_agent[:n].float(),
                          self.m.kf_timestamp[:n]]).cpu().numpy()
        valid, agent, ts = flat[:n] > 0, flat[n:2 * n], flat[2 * n:]
        own = [k for k in range(n) if valid[k] and agent[k] == self.agent
               and (k_last is None or k <= k_last)]
        return n, own, ts

    def _maybe_initialize_imu(self, refine: bool = False):
        n, own, _ = self._own_slots()
        if not refine and n < self._init_kf_count:
            return
        # valid own slots only; the surviving windows span between
        # consecutive valid own keyframes
        if len(own) < 2:
            return
        if any(self.kf_preint[k] is None for k in own[1:]):
            return
        total_t = float(sum(self.kf_preint_dt[k] for k in own[1:]))
        if not refine and total_t < self._min_init_time:
            return
        # body poses from camera poses through the extrinsics
        own_dev = self._upload(np.asarray(own, np.int64))
        T_bc = self._upload(self.T_bc)
        T_wb = se3.inverse(T_bc @ self.m.kf_pose[own_dev])
        stacked = pre.stack_preintegrated(
            [pre.empty_preintegrated(device=self.device)]
            + [self.kf_preint[k] for k in own[1:]])
        res = inertial_init.inertial_init(
            T_wb[:, :3, :3].contiguous(), T_wb[:, :3, 3].contiguous(), stacked,
            G=self.cfg.imu.gravity, fix_scale=self._fix_scale,
            # SLAM poses carry cm-level noise, far above IMU noise
            pose_sigma=(1e-2, 5e-2, 5e-2))
        # one transfer for everything the host keeps
        flat = torch.cat([res.chi2[None], res.scale[None], res.R_wg.reshape(-1),
                          res.bg, res.ba, res.velocities.reshape(-1)]).cpu().numpy()
        chi2, s = float(flat[0]), float(flat[1])
        if not np.isfinite(chi2) or chi2 > 1e3:
            return
        R_wg = flat[2:11].reshape(3, 3)
        # re-gauge the map: X_new = s * R_wg^T X_vis
        self._apply_map_gauge(sim3.Sim3(
            R=self._upload(np.ascontiguousarray(R_wg.T)),
            t=torch.zeros(3, device=self.device),
            s=torch.full((), s, device=self.device)))
        # the velocities from the init are metric already (the residual
        # scales positions, not velocities): the re-gauge only rotates them
        v = flat[17:].reshape(-1, 3)
        self.kf_velocity[own] = (R_wg.T @ v.T).T.astype(np.float32)
        self.v_cur = self.kf_velocity[own[-1]].copy()
        self._v_fresh = True
        self.bg = flat[11:14].astype(np.float32)
        self.ba_bias = flat[14:17].astype(np.float32)
        self.imu_initialized = True
        self.inertial_ready = True
        self.stats["imu_init_scale"] = s
        self.stats.setdefault("imu_init_frame", self.frame_id)
        self._inertial_window_ba(n - 1)

    def _apply_map_gauge(self, S: sim3.Sim3):
        """Transform every map entity by the similarity S (world re-gauge).
        The event is recorded for the collaborative uplink."""
        # a mapping chain dispatched against the pre-gauge map must be
        # adopted first, or it would overwrite the re-gauged map
        if self._pending_map is not None:
            self._adopt_pending(force=True)
        self.pending_gauge = (float(S.s), S.R.cpu().numpy().T.astype(np.float32))
        m = self.m
        S_inv = sim3.inverse(S)
        new_mp = sim3.apply(S, m.mp_pos)
        S_new = sim3.compose(sim3.from_se3(m.kf_pose), S_inv)
        new_pose = se3.make(S_new.R, S_new.t / S_new.s[..., None])
        # the live pose rides the same gauge change
        S_live = sim3.compose(sim3.from_se3(self._upload(self.T_cur)), S_inv)
        self.m = m._replace(
            mp_pos=torch.where(m.mp_valid[:, None], new_mp, m.mp_pos),
            kf_pose=torch.where(m.kf_valid[:, None, None], new_pose, m.kf_pose))
        self.T_cur = se3.make(S_live.R, S_live.t / S_live.s).cpu().numpy().astype(
            np.float32)
        self._T_cur_dev = None
        # the VI anchor state is now in the old gauge: drop it; the next
        # tracked frame re-establishes it
        self._prev_state = None

    # ------------------------------------------------------------------
    def _inertial_window_ba(self, k_last: int, window: int = 8,
                            n_anchor: int = 3):
        """Temporal-window visual-inertial BA: a sliding window over the
        most recent keyframes with a pose-fixed anchor prefix, so shared
        landmarks stay consistent with the map outside the window."""
        dev = self.device
        # valid own slots only: erasures leave holes in the slot range, and
        # a merged window on a survivor spans from the previous valid one
        _, own, ts = self._own_slots(k_last)
        slots = own[-(window + n_anchor):]
        Kw = len(slots)
        n_fixed_prefix = max(1, Kw - window)
        if Kw < 2:
            return
        empty = pre.empty_preintegrated(device=dev)
        preints = [empty]
        pair_valid = [False]
        for i, k in enumerate(slots[1:], start=1):
            p = self.kf_preint[k]
            gap = float(ts[k] - ts[slots[i - 1]])
            # the window must span exactly the gap to the previous valid
            # keyframe (a mismatch means a dropped or unmerged link)
            if p is None or not (abs(self.kf_preint_dt[k] - gap)
                                 < 0.25 * max(gap, 1e-3) + 0.01):
                preints.append(empty)
                pair_valid.append(False)
            else:
                preints.append(p)
                pair_valid.append(True)
        stacked = pre.stack_preintegrated(preints)
        m = self.m
        N = m.kf_mp.shape[1]
        host = np.concatenate([
            np.asarray(slots, np.float32), np.asarray(pair_valid, np.float32),
            self.kf_velocity[slots].reshape(-1), self.bg, self.ba_bias,
            self.T_bc.reshape(-1)]).astype(np.float32)
        up = self._upload(host)
        sl = up[:Kw].long()
        pv = up[Kw:2 * Kw] > 0
        o = 2 * Kw
        v0 = up[o:o + 3 * Kw].reshape(Kw, 3)
        bg0 = up[o + 3 * Kw:o + 3 * Kw + 3].expand(Kw, 3)
        ba0 = up[o + 3 * Kw + 3:o + 3 * Kw + 6].expand(Kw, 3)
        T_bc = up[o + 3 * Kw + 6:].reshape(4, 4)
        # window landmarks (ascending, NO_MP first, truncated to n_pts)
        obs_mp = m.kf_mp[sl]                       # (Kw, N)
        n_pts = self.cfg.local_mapping.local_ba_points
        uniq = fixed_size_unique(obs_mp, n_pts, ms.NO_MP)
        pt_ok = uniq >= 0
        lut = torch.full((m.max_mp,), -1, dtype=torch.int64, device=dev)
        lut = ms.scatter_rows(lut, uniq, pt_ok, torch.arange(n_pts, device=dev))
        lut = torch.cat([lut, lut.new_full((1,), -1)])
        flat_mp = obs_mp.reshape(-1)
        local_pt = lut[torch.where(flat_mp >= 0, flat_mp, m.max_mp).long()]
        obs = BAObservations(
            kf=torch.arange(Kw, device=dev).repeat_interleave(N),
            pt=torch.where(local_pt >= 0, local_pt, 0),
            uv=m.kf_uv[sl].reshape(-1, 2),
            inv_sigma2=level_inv_sigma2(m.kf_level[sl].reshape(-1),
                                        self.cfg.orb.scale_factor),
            valid=(flat_mp >= 0) & (local_pt >= 0)
            & m.kf_feat_valid[sl].reshape(-1))
        fixed = (torch.arange(Kw, device=dev) < n_fixed_prefix) \
            | m.kf_pose_locked[sl]
        # landmarks the collaborative layer holds (mp_hold) stay at their
        # authoritative positions; None for standalone systems
        pt_safe = torch.where(pt_ok, uniq, 0).long()
        pf_local = None
        if self.mp_hold is not None:
            pf_local = torch.as_tensor(self.mp_hold, device=dev)[pt_safe] | ~pt_ok
        res = inertial_ba.inertial_bundle_adjust(
            m.kf_pose[sl], v0, bg0, ba0, fixed, m.mp_pos[pt_safe], obs, stacked,
            pv, self.K, self._g_w_dev, T_bc, iters=6,
            gyro_walk2=self.calib.gyro_walk2, acc_walk2=self.calib.acc_walk2,
            point_fixed=pf_local)
        # one packed transfer for the finiteness gate and the host mirrors,
        # with the pre-BA pose of the window's last keyframe: the live-pose
        # update below must be relative
        flat = torch.cat([res.poses.reshape(-1), res.velocities.reshape(-1),
                          res.bg[-1], res.ba[-1],
                          m.kf_pose[sl[-1]].reshape(-1)]).cpu().numpy()
        n_pose = Kw * 16
        if not np.all(np.isfinite(flat[:n_pose + 3 * Kw])):
            return
        # write back
        all_rows = torch.ones(Kw, dtype=torch.bool, device=dev)
        self.m = m._replace(
            kf_pose=ms.scatter_rows(m.kf_pose, sl, all_rows, res.poses),
            mp_pos=ms.scatter_rows(m.mp_pos, uniq, pt_ok, res.points))
        v_old = self.kf_velocity[k_last].copy()
        self.kf_velocity[slots] = flat[n_pose:n_pose + 3 * Kw].reshape(Kw, 3)
        off = n_pose + 3 * Kw
        self.bg = flat[off:off + 3].astype(np.float32)
        self.ba_bias = flat[off + 3:off + 6].astype(np.float32)
        # relative live-state update through the window's last keyframe
        T_k_old = flat[off + 6:off + 22].reshape(4, 4).astype(np.float32)
        T_k_new = flat[:n_pose].reshape(Kw, 4, 4)[-1].astype(np.float32)
        T_rel = self.T_cur @ np.linalg.inv(T_k_old)
        self.T_cur = (T_rel @ T_k_new).astype(np.float32)
        self.v_cur = (self.v_cur + (self.kf_velocity[k_last] - v_old)).astype(
            np.float32)
        self._v_fresh = True
        self._T_cur_dev = None      # resync any pipelined device chain
        # refresh the VI anchor with the BA-refined state
        if self._prev_state is not None:
            self._prev_state = (self.T_cur.copy(), self.v_cur.copy(),
                                self.bg.copy(), self.ba_bias.copy())


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    x = np.asarray(x, np.float32)
    if x.shape[0] >= n:
        return x[:n]
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)
