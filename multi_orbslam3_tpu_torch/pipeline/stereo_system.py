"""Stereo / RGB-D SLAM systems (counterpart of
multi_orbslam3_tpu/pipeline/stereo_system.py).

These modes reuse the monocular tracking / mapping stack through
``MonoSlam``'s hooks and add:

- depth-seeded initialisation: the very first frame builds the map (no
  two-view bootstrap, metric scale for free);
- depth-seeded landmarks for close points when a keyframe is inserted;
- the stereo residual row in pose optimisation and local BA
  (``_frame_ur`` / ``_bf``), which pins metric scale continuously.

Triangulation still runs for far points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multi_orbslam3_tpu_torch.config import SystemConfig
from multi_orbslam3_tpu_torch.frontend import extractor, stereo
from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.pipeline import tracking
from multi_orbslam3_tpu_torch.pipeline.system import (MonoSlam, TrackState,
                                                      _HostCopy)
from multi_orbslam3_tpu_torch.utils.timing import GLOBAL_TIMER


class StereoSlam(MonoSlam):
    """sensor='stereo': process_frame_stereo(left, right, ts). Runs on the
    CUDA device unless the caller passes ``device="cpu"``."""

    def __init__(self, config: SystemConfig, agent_id: int = 0,
                 enable_loop_closing: bool = True, vocabulary=None,
                 device=None):
        super().__init__(config, agent_id, enable_loop_closing, vocabulary,
                         device=device)
        self._baseline_fx = float(config.camera.baseline * config.camera.fx)
        self._depth_th = config.camera.depth_threshold * config.camera.baseline
        self._cur_depth: Optional[stereo.StereoDepth] = None

    def _image_f32(self, img) -> torch.Tensor:
        """A frame as float32 on the device, unrounded: the synchronous
        stereo and RGB-D loops take the image as it is given (the pipelined
        loop ships uint8, as MonoSlam.to_device does)."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device, torch.float32)
        return self._upload(np.asarray(img, np.float32))

    # ------------------------------------------------------------------
    def process_frame_stereo(self, img_left, img_right,
                             timestamp: float) -> TrackState:
        with GLOBAL_TIMER.stage("frame", self.frame_id + 1):
            with GLOBAL_TIMER.stage("step"):
                with GLOBAL_TIMER.stage("step.extract"):
                    featsL, featsR = extractor.extract_features_pair(
                        self._image_f32(img_left), self._image_f32(img_right), self.cfg)
                with GLOBAL_TIMER.stage("step.stereo"):
                    self._cur_depth = stereo.stereo_match(featsL, featsR,
                                                          self._baseline_fx)
            return self._process_with_depth(featsL, timestamp)

    # ------------------------------------------------------------------
    def process_frame_stereo_pipelined(self, img_left, img_right,
                                       timestamp: float) -> TrackState:
        """Pipelined stereo loop (see MonoSlam.process_frame_pipelined):
        dispatch this frame's fused extract + match + track, finalize the
        previous frame's state machine while it computes. The frame's
        stereo depth travels through the pipe, so the keyframe hooks read
        the depth of the frame being finalized."""
        if self.state != TrackState.OK and not self._pipe:
            return self.process_frame_stereo(img_left, img_right, timestamp)
        with GLOBAL_TIMER.stage("frame", self.frame_id + 1):
            ts = self._rel_ts(timestamp)
            il = self.to_device(img_left)
            ir = self.to_device(img_right)
            self.frame_id += 1
            self._adopt_pending()
            if self._T_cur_dev is None:
                self._T_cur_dev = self._upload(self.T_cur)
                self._T_vel_dev = self._upload(self.T_vel)
            with GLOBAL_TIMER.stage("step"):
                feats, sd, res, pose_dev, tvel_dev = tracking.fused_step_stereo_chained(
                    self.cfg, self.m, il, ir, self._T_cur_dev, self._T_vel_dev)
            self._pipe.append((self.frame_id, feats, res, ts, _HostCopy(res.packed), sd))
            self._T_cur_dev, self._T_vel_dev = pose_dev, tvel_dev
            self._drain_pipe(self.pipeline_depth)
            return self.state

    def _finalize_frame(self, feats, res, ts, packed, sd=None) -> None:
        if sd is not None:
            self._cur_depth = sd     # what _frame_ur / _seed_depth_points read
        super()._finalize_frame(feats, res, ts, packed)

    # ------------------------------------------------------------------
    def _frame_ur(self):
        """Stereo right-u of the current frame: the third residual row in
        pose optimisation and local BA."""
        if self._cur_depth is None:
            return None
        return self._cur_depth.u_right

    def _bf(self) -> float:
        return self._baseline_fx

    # ------------------------------------------------------------------
    def _process_with_depth(self, feats: FrameFeatures,
                            timestamp: float) -> TrackState:
        timestamp = self._rel_ts(timestamp)
        self.frame_id += 1
        self._adopt_pending()
        if self.state == TrackState.NOT_INITIALIZED:
            self._depth_initialize(feats, timestamp)
        else:
            self._pre_track(timestamp)
            self._track(feats, timestamp)
            self._post_track(timestamp)
        self.trajectory.append((timestamp, self.T_cur.copy()))
        self.frame_log.append((timestamp, self.state))
        return self.state

    # ------------------------------------------------------------------
    def _depth_initialize(self, feats: FrameFeatures, ts: float) -> None:
        """The first frame with enough depth is the map."""
        sd = self._cur_depth
        ok = sd.valid & feats.valid & (sd.depth > 0.1)
        if int(torch.sum(ok)) < 50:
            return
        n = feats.n
        no = torch.full((n,), ms.NO_MP, dtype=torch.int32, device=self.device)
        self.m, k0 = ms.add_keyframe(
            self.m, feats, torch.eye(4, device=self.device), ts, no, -1,
            self.agent, u_r=sd.u_right, cam4=self._cam4)
        # back-project with depth
        pts = cam.unproject(self.K, feats.uv_und) * sd.depth[:, None]
        idx = torch.arange(n, device=self.device)
        self.m, slots = ms.add_mappoints(self.m, pts, ok, feats.desc,
                                         k0, k0, idx, k0, idx, self.agent)
        k0 = int(k0)
        if self.loop_closer is not None:
            self.m = self._loop_close(k0)
        self.T_cur = np.eye(4, dtype=np.float32)
        self.T_vel = np.eye(4, dtype=np.float32)
        self.ref_kf = k0
        self.frames_since_kf = 0
        self.state = TrackState.OK
        self.stats["kf_inserted"] += 1
        self.stats["mp_created"] += int(torch.sum(slots >= 0))

    # ------------------------------------------------------------------
    def _seed_depth_points(self, k: int, feats: FrameFeatures) -> None:
        """Depth-seeded close points for the new keyframe's unmatched
        features, before the mapping chain is dispatched, so that its
        triangulation and BA window see them. No host gate on the count:
        an all-false mask is a no-op."""
        if self._cur_depth is None:
            return
        sd = self._cur_depth
        free = self.m.kf_feat_valid[k] & (self.m.kf_mp[k] == ms.NO_MP)
        close = sd.valid & free & (sd.depth > 0.1) & (sd.depth < self._depth_th)
        T = self._upload(self.T_cur)
        p_cam = cam.unproject(self.K, self.m.kf_uv[k]) * sd.depth[:, None]
        pts_w = (p_cam - T[:3, 3][None, :]) @ T[:3, :3]    # = R^T (p_cam - t)
        idx = torch.arange(feats.n, device=self.device)
        self.m, slots = ms.add_mappoints(
            self.m, pts_w, close, self.m.kf_desc[k], k, k, idx, k, idx, self.agent)
        self.stats["mp_created"] += int(torch.sum(slots >= 0))


class RGBDSlam(StereoSlam):
    """sensor='rgbd': process_frame_rgbd(gray, depth, ts); the depth image
    becomes a virtual right coordinate."""

    def process_frame_rgbd(self, img, depth, timestamp: float) -> TrackState:
        with GLOBAL_TIMER.stage("frame", self.frame_id + 1):
            with GLOBAL_TIMER.stage("step"):
                with GLOBAL_TIMER.stage("step.extract"):
                    feats = extractor.extract_features(self._image_f32(img), self.cfg)
                with GLOBAL_TIMER.stage("step.stereo"):
                    depth_dev = self._image_f32(depth)
                    self._cur_depth = stereo.rgbd_depth(feats, depth_dev,
                                                        self._baseline_fx)
            return self._process_with_depth(feats, timestamp)
