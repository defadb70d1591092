"""Stereo-inertial and RGB-D-inertial SLAM systems (counterpart of
multi_orbslam3_tpu/pipeline/stereo_inertial_system.py).

A composition of the two ported systems through MonoSlam's hooks:
StereoSlam supplies depth-seeded initialisation and landmarks and the
stereo residual row; MonoInertialSlam supplies IMU preintegration and
prediction, the per-frame visual-inertial pose optimisation, the staged
inertial initialisation and the temporal-window VI bundle adjustment.

Stereo-specific inertial behaviour: the scale is fixed (depth already pins
the metric gauge, so the initialisation estimates only gravity direction
and biases, and the map re-gauge is a pure rotation), and fewer keyframes
and less integration time are needed before the IMU is trusted.
"""

from __future__ import annotations

import numpy as np

from multi_orbslam3_tpu_torch.config import SystemConfig
from multi_orbslam3_tpu_torch.pipeline.inertial_system import MonoInertialSlam
from multi_orbslam3_tpu_torch.pipeline.stereo_system import RGBDSlam, StereoSlam
from multi_orbslam3_tpu_torch.pipeline.system import TrackState


class StereoInertialSlam(MonoInertialSlam, StereoSlam):
    """sensor='imu_stereo': process_frame_stereo_imu(left, right, ts, acc,
    gyro, dt). Runs on the CUDA device unless the caller passes
    ``device="cpu"``."""

    def __init__(self, config: SystemConfig, agent_id: int = 0,
                 enable_loop_closing: bool = True, vocabulary=None,
                 device=None):
        super().__init__(config, agent_id, enable_loop_closing, vocabulary,
                         device=device)
        self._fix_scale = True
        # metric scale from depth: gravity and biases become observable fast
        self._init_kf_count = 5
        self._min_init_time = 1.0
        self._refine_time = 3.0

    # ------------------------------------------------------------------
    def process_frame_stereo_imu(self, img_left, img_right, timestamp: float,
                                 acc: np.ndarray, gyro: np.ndarray,
                                 dt: np.ndarray) -> TrackState:
        """acc/gyro: (S, 3) IMU samples since the previous frame; dt: (S,)
        with zeros for padding."""
        self._accumulate_imu(acc, gyro, dt)
        return self.process_frame_stereo(img_left, img_right, timestamp)

    # ------------------------------------------------------------------
    def _depth_initialize(self, feats, ts) -> None:
        super()._depth_initialize(feats, ts)
        if self.state == TrackState.OK:
            # the inertial chain starts at the first keyframe: whatever was
            # integrated before the map existed is not a KF -> KF window
            self._accum = None
            self._since_prev = None
            k0 = self.ref_kf
            self._set_kf_window(k0, None)
            self.kf_velocity[k0] = 0.0


class RGBDInertialSlam(StereoInertialSlam, RGBDSlam):
    """sensor='imu_rgbd': process_frame_rgbd_imu(gray, depth, ts, acc, gyro,
    dt). Depth becomes virtual-right stereo and the stereo-inertial
    machinery applies unchanged."""

    def process_frame_rgbd_imu(self, img, depth, timestamp: float,
                               acc: np.ndarray, gyro: np.ndarray,
                               dt: np.ndarray) -> TrackState:
        self._accumulate_imu(acc, gyro, dt)
        return self.process_frame_rgbd(img, depth, timestamp)
