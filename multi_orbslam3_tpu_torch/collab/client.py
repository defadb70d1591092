"""Collaborative client: MonoSlam (or MonoInertialSlam) with an uplink
outbox and a corrections inbox (counterpart of
multi_orbslam3_tpu/collab/client.py).

Loop closing stays off (the server owns place recognition). New and
changed keyframes and landmarks are drained into MapDelta envelopes under
per-cycle budgets; server corrections are applied only when pose-locked:
the server wins after optimization, the client wins for fresh odometry.

The map lives on the client's device. Each uplink build reads one host
snapshot of it (``host.fetch``: one synchronisation), and every downlink
correction is written back as a functional update of the map's tensors.

An inertial agent publishes nothing before its visual-inertial
initialisation, ships each keyframe's preintegration window and velocity
with it, and carries its velocities through every gauge change and
correction. A keyframe the server culls hands its window to the next own
keyframe (or to the running accumulator when it was the newest).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.collab import protocol
from multi_orbslam3_tpu_torch.collab.host import desc_words, fetch
from multi_orbslam3_tpu_torch.collab.transport import Transport
from multi_orbslam3_tpu_torch.config import SystemConfig
from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu_torch.imu import preintegration as pre
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.pipeline.inertial_system import MonoInertialSlam, _Window
from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam, TrackState


class CollabClient:
    """One agent. ``device=None`` is the CUDA device and raises where there
    is none; the CPU tests pass ``device="cpu"``."""

    def __init__(self, config: SystemConfig, agent_id: int,
                 transport: Transport, inertial: bool = False, device=None):
        self.device = devices.resolve(device, "CollabClient")
        self.cfg = config
        self.agent = agent_id
        self.transport = transport
        self.inertial = inertial
        self.slam = (MonoInertialSlam if inertial else MonoSlam)(
            config, agent_id, enable_loop_closing=False, device=self.device)
        c = config.camera
        self._cam4 = np.array([c.fx, c.fy, c.cx, c.cy], np.float32)
        self._sent_kf = 0               # slots < _sent_kf were sent in full
        self._sent_mp = 0
        self._sent_kf_pose = np.zeros((config.map.max_keyframes, 4, 4), np.float32)
        self._sent_mp_pos = np.zeros((config.map.max_mappoints, 3), np.float32)
        # foreign (other agents') entities from the server's vicinity
        # downlink: server slot -> local slot, and masks that keep them out
        # of the uplink
        self._foreign_kf = {}
        self._foreign_mp = {}
        self._is_foreign_kf = np.zeros(config.map.max_keyframes, bool)
        self._is_foreign_mp = np.zeros(config.map.max_mappoints, bool)
        # local slot -> server id, so uplinked keyframes can declare the
        # foreign landmarks they observe
        self._foreign_mp_rev = np.full(config.map.max_mappoints, -1, np.int32)
        # landmarks the server has locked: their positions are server-owned
        self._mp_locked_srv = np.zeros(config.map.max_mappoints, bool)
        self._seq = 0
        # cumulative server gauge applied to our frame ([s, R9, t3])
        self._gauge_applied = np.concatenate([[1.0], np.eye(3).reshape(9), np.zeros(3)])
        self._gauge_epoch_applied = 0
        # unacked deltas, resent after a few cycles without a cumulative ack
        self._outbox = {}               # seq -> (payload bytes, sent cycle)
        self._cycle = 0
        self._resend_after = 4
        self._deferred_down = []
        self._defer_count = 0
        self._last_sig = None
        self._old_poses = None
        self.stats = {"deltas_sent": 0, "corrections_applied": 0,
                      "foreign_kf": 0, "foreign_mp": 0, "resends": 0}

    # ------------------------------------------------------------------
    def process_frame(self, img, timestamp: float):
        return self.slam.process_frame(img, timestamp)

    def process_frame_imu(self, img, timestamp: float, acc: np.ndarray,
                          gyro: np.ndarray, dt: np.ndarray):
        return self.slam.process_frame_imu(img, timestamp, acc, gyro, dt)

    # ------------------------------------------------------------------
    def comm_cycle(self) -> None:
        """Ingest corrections, then publish a delta. Idle cycles (no
        keyframe, landmark, correction or gauge event since the last build)
        skip the build and its snapshot; every 8th cycle builds anyway."""
        self._cycle += 1
        self._ingest_corrections()
        sig = (self.slam.stats.get("kf_inserted", 0),
               self.slam.stats.get("mp_created", 0),
               self.slam.stats.get("mp_fused", 0),
               self.stats["corrections_applied"],
               self.stats.get("gauges_applied", 0),
               getattr(self.slam, "pending_gauge", None) is not None)
        dirty = sig != self._last_sig
        if not dirty and self._cycle % 8 != 0:
            self._resend_unacked()
            return
        self._last_sig = sig
        delta = self._build_delta()
        if delta is not None:
            payload = delta.to_bytes()
            self._outbox[delta.seq] = (payload, self._cycle)
            self.transport.send_up(self.agent, payload)
            self.stats["deltas_sent"] += 1
        self._resend_unacked()

    def _resend_unacked(self) -> None:
        for seq, (payload, sent_at) in list(self._outbox.items()):
            if self._cycle - sent_at >= self._resend_after:
                self.transport.send_up(self.agent, payload)
                self._outbox[seq] = (payload, self._cycle)
                self.stats["resends"] += 1

    # ------------------------------------------------------------------
    def _build_delta(self) -> Optional[protocol.MapDelta]:
        # an inertial agent publishes nothing before its visual-inertial
        # initialisation (the reference's GetInertialBA1 uplink gate)
        if self.inertial and not self.slam.inertial_ready:
            return None
        m = self.slam.m
        comm = self.cfg.comm
        snap = fetch(dict(
            n_kf=m.n_kf, n_mp=m.n_mp, kf_pose=m.kf_pose, kf_parent=m.kf_parent,
            kf_timestamp=m.kf_timestamp, locked=m.kf_pose_locked, kf_mp=m.kf_mp,
            mp_ref_kf=m.mp_ref_kf, mp_pos=m.mp_pos, mp_desc=m.mp_desc))
        gauge = getattr(self.slam, "pending_gauge", None)
        scale, R_gw = (1.0, None) if gauge is None else gauge
        if gauge is not None:
            self.slam.pending_gauge = None
            self._sent_kf_pose[:self._sent_kf] = snap["kf_pose"][:self._sent_kf]
            self._sent_mp_pos[:self._sent_mp] = snap["mp_pos"][:self._sent_mp]
        n_kf = int(snap["n_kf"])
        n_mp = int(snap["n_mp"])
        all_poses = snap["kf_pose"]
        kfs = kf_updates = mps = mp_updates = None

        # new OWN keyframes (foreign-ingested slots are the server's)
        own_new = [i for i in range(self._sent_kf, n_kf)
                   if not self._is_foreign_kf[i]][:comm.client_kf_bound]
        if own_new:
            ids = np.asarray(own_new, np.int64)
            poses = all_poses[ids]
            B = len(own_new)
            ids_d = torch.from_numpy(ids).to(self.device)
            rows = fetch(dict(uv=m.kf_uv[ids_d], desc=m.kf_desc[ids_d],
                              level=m.kf_level[ids_d], angle=m.kf_angle[ids_d],
                              fv=m.kf_feat_valid[ids_d]))
            # reference chain: the two previous OWN keyframes + the parent
            own_all = np.nonzero(~self._is_foreign_kf[:n_kf])[0]
            pos_in_own = np.searchsorted(own_all, ids)
            pred1 = np.where(pos_in_own >= 1, own_all[np.maximum(pos_in_own - 1, 0)], -1)
            pred2 = np.where(pos_in_own >= 2, own_all[np.maximum(pos_in_own - 2, 0)], -1)
            parent = snap["kf_parent"][ids]
            parent = np.where((parent >= 0) & ~self._is_foreign_kf[np.maximum(parent, 0)],
                              parent, -1)
            ref_ids = np.stack([pred1, pred2, parent], 1).astype(np.int32)
            T_rel = np.zeros((B, 3, 4, 4), np.float32)
            for b in range(B):
                for r in range(3):
                    rid = ref_ids[b, r]
                    if rid >= 0:
                        T_rel[b, r] = poses[b] @ np.linalg.inv(all_poses[rid])
            mp_raw = snap["kf_mp"][ids]
            # foreign associations travel under their SERVER identity
            is_f = (mp_raw >= 0) & self._is_foreign_mp[np.maximum(mp_raw, 0)]
            mp_server = np.where(is_f, self._foreign_mp_rev[np.maximum(mp_raw, 0)],
                                 -1).astype(np.int32)
            mp_local = np.where(is_f, -1, mp_raw)
            # the preintegration window since the previous own keyframe and
            # the body velocity travel with each keyframe
            imu_rows = None
            if self.inertial:
                imu_rows = np.zeros((B, pre.FLAT_DIM + 3), np.float32)
                for b, lid in enumerate(ids):
                    p = self.slam.kf_preint[int(lid)]
                    if p is not None:
                        imu_rows[b, :pre.FLAT_DIM] = pre.preint_to_flat(p)
                    imu_rows[b, pre.FLAT_DIM:] = self.slam.kf_velocity[int(lid)]
            kfs = protocol.KFPayload(
                agent=self.agent, local_id=ids.astype(np.int32),
                timestamp=snap["kf_timestamp"][ids], ref_ids=ref_ids, T_rel=T_rel,
                T_abs=poses, is_first=(ids == 0), uv=rows["uv"], desc=rows["desc"],
                level=rows["level"], angle=rows["angle"], feat_valid=rows["fv"],
                mp_local=mp_local, mp_server=mp_server, imu=imu_rows)
            self._sent_kf_pose[ids] = poses
            new_kf_hi = int(ids[-1]) + 1 if len(own_new) == comm.client_kf_bound else n_kf
        else:
            new_kf_hi = n_kf

        own_mp_new = [i for i in range(self._sent_mp, n_mp)
                      if not self._is_foreign_mp[i]][:comm.client_mp_bound]
        if own_mp_new:
            ids = np.asarray(own_mp_new, np.int64)
            ref_kf = snap["mp_ref_kf"][ids]
            # a foreign reference keyframe has no sender-local id
            ref_kf = np.where((ref_kf >= 0) & ~self._is_foreign_kf[np.maximum(ref_kf, 0)],
                              ref_kf, -1)
            pos_abs = snap["mp_pos"][ids]
            ref_safe = np.maximum(ref_kf, 0)
            # position in the reference keyframe's camera frame
            pos_rel = np.einsum("bij,bj->bi", all_poses[ref_safe][:, :3, :3], pos_abs) \
                + all_poses[ref_safe][:, :3, 3]
            mps = protocol.MPPayload(
                agent=self.agent, local_id=ids.astype(np.int32),
                ref_kf_local=ref_kf.astype(np.int32), pos_rel=pos_rel.astype(np.float32),
                pos_abs=pos_abs, desc=snap["mp_desc"][ids])
            self._sent_mp_pos[ids] = pos_abs
            new_mp_hi = int(ids[-1]) + 1 if len(own_mp_new) == comm.client_mp_bound else n_mp
        else:
            new_mp_hi = n_mp

        # pose updates for already-sent keyframes whose pose moved
        if self._sent_kf > 0:
            cur = all_poses[:self._sent_kf]
            moved = np.abs(cur - self._sent_kf_pose[:self._sent_kf]) \
                .reshape(self._sent_kf, -1).max(axis=1) > 1e-6
            moved = moved & ~snap["locked"][:self._sent_kf]   # never over a lock
            if moved.any():
                ids = np.nonzero(moved)[0].astype(np.int32)[:comm.client_kf_bound]
                # the CURRENT association rows travel along, so the server's
                # observation counts follow the client's fusion
                urows = snap["kf_mp"][ids]
                u_is_f = (urows >= 0) & self._is_foreign_mp[np.maximum(urows, 0)]
                u_server = np.where(u_is_f, self._foreign_mp_rev[np.maximum(urows, 0)],
                                    -1).astype(np.int32)
                urows = np.where(u_is_f, -1, urows)
                kf_updates = protocol.KFUpdatePayload(
                    agent=self.agent, local_id=ids, T_abs=cur[ids],
                    locked=np.zeros(len(ids), bool), mp_local=urows.astype(np.int32),
                    mp_server=u_server)
                self._sent_kf_pose[ids] = cur[ids]
        if self._sent_mp > 0:
            curp = snap["mp_pos"][:self._sent_mp]
            movedp = np.abs(curp - self._sent_mp_pos[:self._sent_mp]).max(axis=1) > 1e-6
            movedp = movedp & ~self._is_foreign_mp[:self._sent_mp] \
                & ~self._mp_locked_srv[:self._sent_mp]
            if movedp.any():
                ids = np.nonzero(movedp)[0].astype(np.int32)[:comm.client_mp_bound]
                mp_updates = protocol.MPUpdatePayload(
                    agent=self.agent, local_id=ids, pos_abs=curp[ids],
                    locked=np.zeros(len(ids), bool))
                self._sent_mp_pos[ids] = curp[ids]

        self._sent_kf = new_kf_hi
        self._sent_mp = new_mp_hi
        if kfs is None and mps is None and kf_updates is None \
                and mp_updates is None and gauge is None:
            return None
        self._seq += 1
        return protocol.MapDelta(
            agent=self.agent, seq=self._seq, kfs=kfs, kf_updates=kf_updates,
            mps=mps, mp_updates=mp_updates, closest_kf=self.slam.ref_kf,
            scale=scale, R_gw=R_gw, inertial=self.inertial,
            T_bc=self.slam.T_bc.astype(np.float32).copy() if self.inertial else None,
            cam=self._cam4.copy())

    # ------------------------------------------------------------------
    def _up(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        return self.slam._upload(a if a.flags.writeable else a.copy())

    def _ingest_corrections(self) -> None:
        """Apply the server downlink: locked updates only. After a batch of
        corrections the change it implies is propagated to every local
        entity the server did not correct (_propagate_correction)."""
        payloads = self._deferred_down + self.transport.poll_down(self.agent)
        self._deferred_down = []
        # weak tracking: hold the batch a few cycles until an OK streak
        # returns (bounded, so a weak tracker still converges)
        weak = self.slam.state != TrackState.OK or self.slam._ok_streak < 2
        if payloads and weak:
            self._defer_count += 1
            if self._defer_count <= 10:
                self._deferred_down = payloads
                return
        self._defer_count = 0
        if payloads:
            # fold in any in-flight mapping result first so its adoption
            # cannot overwrite the corrections
            self.slam._adopt_pending(force=True)
            snap = fetch(dict(locked=self.slam.m.kf_pose_locked,
                              pose=self.slam.m.kf_pose))
            self._locked_before = snap["locked"]
            self._old_poses = snap["pose"]
            self._corrected_now: set = set()
            self._mp_updated_now: set = set()
        for payload in payloads:
            try:
                delta = protocol.MapDelta.from_bytes(payload)
            except ValueError:
                self.stats["dropped_frames"] = self.stats.get("dropped_frames", 0) + 1
                continue
            if delta.ack_seq >= 0:
                for seq in [s for s in self._outbox if s <= delta.ack_seq]:
                    del self._outbox[seq]
            if delta.gauge_down is not None \
                    and delta.gauge_epoch > self._gauge_epoch_applied:
                self._apply_gauge_down(delta.gauge_down)
                self._gauge_epoch_applied = delta.gauge_epoch
            m = self.slam.m
            if delta.kf_updates is not None:
                ku = delta.kf_updates
                apply = np.asarray(ku.locked, bool)
                if apply.any():
                    ids = self._up(ku.local_id[apply].astype(np.int64))
                    m = m._replace(
                        kf_pose=m.kf_pose.index_put(
                            (ids,), self._up(ku.T_abs[apply].astype(np.float32))),
                        kf_pose_locked=m.kf_pose_locked.index_put(
                            (ids,), torch.ones((), dtype=torch.bool, device=self.device)))
                    self.stats["corrections_applied"] += int(apply.sum())
                    self._sent_kf_pose[ku.local_id[apply]] = ku.T_abs[apply]
                    self._corrected_now.update(int(i) for i in ku.local_id[apply])
            if delta.mp_updates is not None:
                mu = delta.mp_updates
                apply = np.asarray(mu.locked, bool)
                if apply.any():
                    m = m._replace(mp_pos=m.mp_pos.index_put(
                        (self._up(mu.local_id[apply].astype(np.int64)),),
                        self._up(mu.pos_abs[apply].astype(np.float32))))
                    self._sent_mp_pos[mu.local_id[apply]] = mu.pos_abs[apply]
                    self._mp_locked_srv[mu.local_id[apply]] = True
                    self._mp_updated_now.update(int(i) for i in mu.local_id[apply])
            if delta.erased_kf is not None:
                # keyframes the server culled
                n_kf = int(m.n_kf)
                for lid in delta.erased_kf:
                    lid = int(lid)
                    if lid != self.slam.ref_kf and 0 <= lid < n_kf:
                        self._merge_preint_over(lid, n_kf)
                        m = ms.erase_keyframe(m, lid)
            if delta.erased_mp is not None:
                # our landmarks the server culled: the local copy dies too,
                # or it would stay at the old gauge after a re-gauging
                n_mp = int(m.n_mp)
                slots = [int(s) for s in delta.erased_mp
                         if 0 <= int(s) < n_mp and not self._is_foreign_mp[int(s)]]
                if slots:
                    m = ms.erase_mappoints(m, self._up(np.asarray(slots, np.int32)))
                    self.stats["own_mp_erased"] = \
                        self.stats.get("own_mp_erased", 0) + len(slots)
            # revocations of foreign content the server culled
            if delta.foreign_erased_kf is not None:
                for sid in delta.foreign_erased_kf:
                    loc = self._foreign_kf.pop(int(sid), None)
                    if loc is not None and loc != self.slam.ref_kf:
                        m = ms.erase_keyframe(m, loc)
                        self._is_foreign_kf[loc] = False
                        self.stats["foreign_revoked_kf"] = \
                            self.stats.get("foreign_revoked_kf", 0) + 1
            if delta.foreign_erased_mp is not None:
                slots = []
                for sid in delta.foreign_erased_mp:
                    loc = self._foreign_mp.pop(int(sid), None)
                    if loc is not None:
                        slots.append(loc)
                        self._is_foreign_mp[loc] = False
                        self._foreign_mp_rev[loc] = -1
                if slots:
                    m = ms.erase_mappoints(m, self._up(np.asarray(slots, np.int32)))
                    self.stats["foreign_revoked_mp"] = \
                        self.stats.get("foreign_revoked_mp", 0) + len(slots)
            m = self._apply_foreign_updates(m, delta)
            m = self._ingest_foreign(m, delta)
            self.slam.m = m
        if payloads:
            # foreign copies and server-locked landmarks are authoritative
            self.slam.mp_hold = self._is_foreign_mp | self._mp_locked_srv
        if payloads and self._corrected_now:
            self._propagate_correction()

    # ------------------------------------------------------------------
    @staticmethod
    def _xf_poses(P: np.ndarray, R32, t32, s32) -> np.ndarray:
        """T' = T o X for the gauge X = (s, R, t), scale folded."""
        out = P.copy()
        out[..., :3, :3] = P[..., :3, :3] @ R32
        out[..., :3, 3] = (np.einsum("...ij,j->...i", P[..., :3, :3], t32)
                           + P[..., :3, 3]) / s32
        return out

    def _apply_gauge_down(self, g_total: np.ndarray) -> None:
        """Apply the server's exact cumulative merge gauge to the whole
        frame: the remainder X = applied^-1 o total moves every own entity,
        the live pose and the bookkeeping mirrors (poses T' = T o X,
        landmarks p' = X^-1(p))."""
        ga = self._gauge_applied
        sa, Ra, ta = float(ga[0]), ga[1:10].reshape(3, 3), ga[10:13]
        st_ = float(g_total[0])
        Rt = np.asarray(g_total[1:10]).reshape(3, 3)
        tt = np.asarray(g_total[10:13])
        s = st_ / sa
        R = Ra.T @ Rt
        t = (Ra.T @ (tt - ta)) / sa
        if abs(s - 1.0) < 1e-12 and np.allclose(R, np.eye(3), atol=1e-12) \
                and np.allclose(t, 0.0, atol=1e-12):
            self._gauge_applied = np.asarray(g_total, np.float64)
            return
        m = self.slam.m
        snap = fetch(dict(n_kf=m.n_kf, n_mp=m.n_mp, kf_valid=m.kf_valid,
                          mp_valid=m.mp_valid, kf_pose=m.kf_pose, mp_pos=m.mp_pos,
                          mn=m.mp_min_dist, mx=m.mp_max_dist, nrm=m.mp_normal))
        n_kf, n_mp = int(snap["n_kf"]), int(snap["n_mp"])
        own_kf = np.zeros(m.max_kf, bool)
        own_kf[:n_kf] = snap["kf_valid"][:n_kf]
        own_kf &= ~self._is_foreign_kf
        own_mp = np.zeros(m.max_mp, bool)
        own_mp[:n_mp] = snap["mp_valid"][:n_mp]
        own_mp &= ~self._is_foreign_mp
        R32, t32, s32 = R.astype(np.float32), t.astype(np.float32), np.float32(s)

        def xf_points(p):   # p' = X^-1(p) = (1/s) R^T (p - t)
            return ((p - t32) @ R32) / s32

        poses, mp = snap["kf_pose"], snap["mp_pos"]
        poses[own_kf] = self._xf_poses(poses[own_kf], R32, t32, s32)
        mp[own_mp] = xf_points(mp[own_mp])
        mn, mx, nrm = snap["mn"], snap["mx"], snap["nrm"]
        mn[own_mp] = mn[own_mp] / s32
        mx[own_mp] = mx[own_mp] / s32
        nrm[own_mp] = nrm[own_mp] @ R32             # n' = R^T n
        self.slam.m = m._replace(kf_pose=self._up(poses), mp_pos=self._up(mp),
                                 mp_min_dist=self._up(mn), mp_max_dist=self._up(mx),
                                 mp_normal=self._up(nrm))
        # live pose: a right-multiplication leaves T_vel invariant
        self.slam.T_cur = self._xf_poses(np.asarray(self.slam.T_cur)[None], R32, t32,
                                         s32)[0].astype(np.float32)
        if self.inertial:
            if self.slam._last_ok_T is not None:
                self.slam._last_ok_T = self._xf_poses(
                    np.asarray(self.slam._last_ok_T)[None], R32, t32, s32)[0].astype(
                        np.float32)
            # world-frame velocities: v' = (1/s) R^T v
            A = R32.T / s32
            self.slam.v_cur = (A @ self.slam.v_cur).astype(np.float32)
            self.slam.kf_velocity[:n_kf] = self.slam.kf_velocity[:n_kf] @ A.T
            self.slam._prev_state = None
            self.slam._v_fresh = True
        self.slam._T_cur_dev = None
        # bookkeeping mirrors follow, so no spurious updates go up
        sent_kf = np.zeros_like(own_kf)
        sent_kf[:self._sent_kf] = own_kf[:self._sent_kf]
        self._sent_kf_pose[sent_kf] = self._xf_poses(self._sent_kf_pose[sent_kf],
                                                     R32, t32, s32)
        sent_mp = np.zeros_like(own_mp)
        sent_mp[:self._sent_mp] = own_mp[:self._sent_mp]
        self._sent_mp_pos[sent_mp] = xf_points(self._sent_mp_pos[sent_mp])
        # the pre-batch snapshot feeds _propagate_correction
        if self._old_poses is not None:
            self._old_poses[own_kf] = self._xf_poses(self._old_poses[own_kf], R32, t32,
                                                     s32)
        self._gauge_applied = np.asarray(g_total, np.float64)
        self.stats["gauges_applied"] = self.stats.get("gauges_applied", 0) + 1

    # ------------------------------------------------------------------
    def _propagate_correction(self) -> None:
        """Carry this batch of exact server corrections to every own entity
        the server did not correct, by relative chaining through the
        nearest corrected keyframe: T_k' = T_k T_a^-1 T_a'; landmarks ride
        their reference keyframe (p' = T_ref'^-1 T_ref p)."""
        corr = np.asarray(sorted(self._corrected_now), np.int64)
        m = self.slam.m
        snap = fetch(dict(n_kf=m.n_kf, n_mp=m.n_mp, kf_pose=m.kf_pose,
                          kf_valid=m.kf_valid, mp_valid=m.mp_valid, mp_pos=m.mp_pos,
                          mp_ref_kf=m.mp_ref_kf))
        poses_new = snap["kf_pose"]
        poses_old = self._old_poses
        if np.allclose(poses_old[corr], poses_new[corr], atol=1e-7):
            return                          # refinement-free ack cycle
        n_kf, n_mp = int(snap["n_kf"]), int(snap["n_mp"])
        move_kf = np.zeros(m.max_kf, bool)
        move_kf[:n_kf] = snap["kf_valid"][:n_kf]
        move_kf &= ~self._locked_before
        move_kf[corr] = False
        move_kf &= ~self._is_foreign_kf
        inv_old_corr = {int(k): np.linalg.inv(poses_old[int(k)]) for k in corr}

        def nearest_anchor(k: int) -> int:
            i = np.searchsorted(corr, k)
            below = corr[i - 1] if i > 0 else None
            above = corr[i] if i < len(corr) else None
            if below is None:
                return int(above)
            if above is None:
                return int(below)
            return int(below if k - below <= above - k else above)

        for k in np.nonzero(move_kf)[0]:
            a = nearest_anchor(int(k))
            poses_new[k] = (poses_old[k] @ inv_old_corr[a] @ poses_new[a]).astype(np.float32)
        move_mp = np.zeros(m.max_mp, bool)
        move_mp[:n_mp] = snap["mp_valid"][:n_mp]
        move_mp[list(self._mp_updated_now)] = False
        move_mp &= ~self._is_foreign_mp
        mp = snap["mp_pos"]
        ref = snap["mp_ref_kf"]
        idx = np.nonzero(move_mp)[0]
        if len(idx):
            r = ref[idx]
            r_ok = (r >= 0) & (r < n_kf) & ~self._is_foreign_kf[
                np.clip(r, 0, len(self._is_foreign_kf) - 1)]
            idx, r = idx[r_ok], r[r_ok]
            if len(idx):
                A = np.einsum("kij,kjl->kil", np.linalg.inv(poses_new[r]), poses_old[r])
                xh = np.concatenate([mp[idx], np.ones((len(idx), 1))], 1)
                mp[idx] = np.einsum("kij,kj->ki", A, xh)[:, :3].astype(np.float32)
        self.slam.m = m._replace(kf_pose=self._up(poses_new), mp_pos=self._up(mp))
        # the live pose chains through the newest corrected keyframe; a
        # shared right-multiplication leaves T_vel invariant
        aN = int(corr[-1])
        chain = inv_old_corr[aN] @ poses_new[aN]
        self.slam.T_cur = (np.asarray(self.slam.T_cur) @ chain).astype(np.float32)
        self.slam._T_cur_dev = None
        if self.inertial:
            if self.slam._last_ok_T is not None:
                self.slam._last_ok_T = (np.asarray(self.slam._last_ok_T) @ chain).astype(
                    np.float32)
            # world-frame velocities follow the anchor's world change:
            # p' = T_a'^-1 T_a p, so v' = R_W v
            R_w = (np.linalg.inv(poses_new[aN]) @ poses_old[aN])[:3, :3].astype(np.float32)
            self.slam.v_cur = (R_w @ self.slam.v_cur).astype(np.float32)
            self.slam.kf_velocity[:n_kf] = self.slam.kf_velocity[:n_kf] @ R_w.T
            # v_cur is in the new gauge already: block _post_track's
            # finite-difference re-anchor, whose previous pose is in the old
            self.slam._prev_state = None
            self.slam._v_fresh = True

    # ------------------------------------------------------------------
    def _merge_preint_over(self, lid: int, n_kf: int) -> None:
        """A keyframe the server culled hands its preintegration window to
        the next own keyframe, so the inertial chain stays unbroken; when
        it was the newest own keyframe, the window folds into the running
        accumulator, which then spans from the previous survivor."""
        if not self.inertial or self.slam.kf_preint[lid] is None:
            return
        slam = self.slam
        win = _Window(slam.kf_preint[lid], float(slam.kf_preint_dt[lid]))
        slam._set_kf_window(lid, None)
        for succ in range(lid + 1, n_kf):
            if self._is_foreign_kf[succ]:
                continue
            if slam.kf_preint[succ] is not None:
                slam._set_kf_window(succ, win.merged(
                    _Window(slam.kf_preint[succ], float(slam.kf_preint_dt[succ]))))
            return
        slam._accum = win if slam._accum is None else win.merged(slam._accum)

    # ------------------------------------------------------------------
    def _apply_foreign_updates(self, m, delta: protocol.MapDelta):
        """Refresh foreign entities the server moved since shipping them."""
        fku = delta.foreign_kf_updates
        if fku is not None:
            locs, poses = [], []
            for b, sid in enumerate(fku.server_id):
                loc = self._foreign_kf.get(int(sid))
                if loc is not None:
                    locs.append(loc)
                    poses.append(fku.T_abs[b])
            if locs:
                m = m._replace(kf_pose=m.kf_pose.index_put(
                    (self._up(np.asarray(locs, np.int64)),),
                    self._up(np.stack(poses).astype(np.float32))))
        fmu = delta.foreign_mp_updates
        if fmu is not None:
            locs, pos = [], []
            for b, sid in enumerate(fmu.server_id):
                loc = self._foreign_mp.get(int(sid))
                if loc is not None:
                    locs.append(loc)
                    pos.append(fmu.pos_abs[b])
            if locs:
                m = m._replace(mp_pos=m.mp_pos.index_put(
                    (self._up(np.asarray(locs, np.int64)),),
                    self._up(np.stack(pos).astype(np.float32))))
        return m

    # ------------------------------------------------------------------
    def _ingest_foreign(self, m, delta: protocol.MapDelta):
        """Other agents' content from the vicinity downlink lands in this
        client's map, tagged with its owner and pose-locked, so tracking
        matches it like local landmarks and relocalization can query it."""
        dev = self.device
        fm = delta.foreign_mps
        if fm is not None:
            new = [b for b in range(fm.server_id.shape[0])
                   if int(fm.server_id[b]) not in self._foreign_mp]
            if new:
                idx = np.asarray(new)
                ref = np.full(len(new), self.slam.ref_kf, np.int32)
                m, slots = ms.add_mappoints_raw_padded(
                    m, self._up(fm.pos_abs[idx].astype(np.float32)),
                    torch.ones(len(new), dtype=torch.bool, device=dev),
                    desc_words(fm.desc[idx]).to(dev), self._up(ref),
                    int(fm.owner[idx[0]]))
                slots_np = slots.cpu().numpy()
                for i, b in enumerate(new):
                    s = int(slots_np[i])
                    if s >= 0:
                        self._foreign_mp[int(fm.server_id[b])] = s
                        self._is_foreign_mp[s] = True
                        self._foreign_mp_rev[s] = int(fm.server_id[b])
                        self.stats["foreign_mp"] += 1
        fk = delta.foreign_kfs
        if fk is not None:
            for b in range(fk.server_id.shape[0]):
                sid = int(fk.server_id[b])
                if sid in self._foreign_kf:
                    continue
                assoc = np.full(fk.mp_server.shape[1], ms.NO_MP, np.int32)
                for f, s in enumerate(fk.mp_server[b]):
                    if s >= 0:
                        loc = self._foreign_mp.get(int(s))
                        if loc is not None:
                            assoc[f] = loc
                n = fk.uv.shape[1]
                uv = self._up(fk.uv[b].astype(np.float32))
                feats = FrameFeatures(
                    uv=uv, uv_und=uv, response=torch.ones(n, device=dev),
                    level=self._up(fk.level[b].astype(np.int32)),
                    angle=self._up(fk.angle[b].astype(np.float32)),
                    desc=desc_words(fk.desc[b]).to(dev),
                    valid=self._up(fk.feat_valid[b].astype(bool)))
                cam_b = self._up(fk.cam[b].astype(np.float32)) if fk.cam is not None \
                    else None
                m, k = ms.add_keyframe(m, feats, self._up(fk.T_abs[b].astype(np.float32)),
                                       float(fk.timestamp[b]), self._up(assoc), -1,
                                       int(fk.owner[b]), cam4=cam_b)
                k_i = int(k)
                if k_i < 0:
                    continue
                # server-owned pose: locked against local refinement
                m = m._replace(kf_pose_locked=ms.scatter_rows(
                    m.kf_pose_locked, torch.full((1,), k_i, device=dev),
                    torch.ones(1, dtype=torch.bool, device=dev), True))
                self._foreign_kf[sid] = k_i
                self._is_foreign_kf[k_i] = True
                self.stats["foreign_kf"] += 1
                self.slam.add_to_reloc_db(m, k_i)
        return m
