"""EuRoC MAV dataset loader (ASL directory format).

Replaces the reference's rosbag playback (ros/launch/client_and_server
.launch plays EuRoC bags into /cam0/image_raw). Reads the standard
mav0/cam0/data.csv + mav0/imu0/data.csv layout; images are decoded lazily
per frame. Grayscale decoding uses a minimal PGM/PNG path so no OpenCV
dependency is needed (EuRoC ships 8-bit grayscale PNG).
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _read_png_gray(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale PNG via PIL."""
    from PIL import Image  # noqa: WPS433
    return np.asarray(Image.open(path).convert("L"), np.float32)


class EurocSequence:
    """Iterates (timestamp_s, gray_image) with optional per-frame IMU
    batches, mirroring the reference's mono-inertial grabber sync
    (ros/src/MonoInertialNode.cc SyncWithImu)."""

    def __init__(self, root: str, cam: str = "cam0", imu: bool = False,
                 max_frames: Optional[int] = None):
        mav = os.path.join(root, "mav0")
        cam_dir = os.path.join(mav, cam)
        self.data_dir = os.path.join(cam_dir, "data")
        self.frames: List[Tuple[float, str]] = []
        self.frames_ns: List[int] = []      # exact keys (float64 loses ns)
        with open(os.path.join(cam_dir, "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                self.frames.append((int(row[0]) * 1e-9, row[1].strip()))
                self.frames_ns.append(int(row[0]))
        if max_frames:
            self.frames = self.frames[:max_frames]
            self.frames_ns = self.frames_ns[:max_frames]
        self.imu: Optional[np.ndarray] = None
        if imu:
            imu_rows = []
            with open(os.path.join(mav, "imu0", "data.csv")) as f:
                for row in csv.reader(f):
                    if not row or row[0].startswith("#"):
                        continue
                    imu_rows.append([float(x) for x in row])
            arr = np.asarray(imu_rows)
            arr[:, 0] *= 1e-9
            self.imu = arr  # (t, gx, gy, gz, ax, ay, az)

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self) -> Iterator:
        prev_t = None
        for t, name in self.frames:
            img = _read_png_gray(os.path.join(self.data_dir, name))
            if self.imu is None:
                yield t, img
            else:
                if prev_t is None:
                    batch = np.zeros((0, 7))
                else:
                    sel = (self.imu[:, 0] > prev_t) & (self.imu[:, 0] <= t)
                    batch = self.imu[sel]
                dt = np.diff(batch[:, 0], prepend=prev_t or t)
                yield t, img, batch[:, 4:7], batch[:, 1:4], dt
            prev_t = t


def available(root: str) -> bool:
    return os.path.isdir(os.path.join(root, "mav0", "cam0", "data"))


# ---------------------------------------------------------------------------
# Stereo: paired cam0/cam1 with on-the-fly rectification from sensor.yaml.
# ---------------------------------------------------------------------------

def read_camera_yaml(path: str):
    """EuRoC mav0/camN/sensor.yaml -> (K 3x3, dist (5,), T_BS 4x4,
    (width, height)). T_BS maps sensor->body: p_B = T_BS @ p_S."""
    import yaml
    with open(path) as f:
        y = yaml.safe_load(f)
    fu, fv, cu, cv = y["intrinsics"]
    K = np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1.0]])
    d = list(y["distortion_coefficients"])
    while len(d) < 5:
        d.append(0.0)
    T_BS = np.asarray(y["T_BS"]["data"], np.float64).reshape(4, 4)
    w, h = y["resolution"]
    return K, tuple(d[:5]), T_BS, (int(w), int(h))


class EurocStereoSequence:
    """Iterates (timestamp_s, rect_left, rect_right) — cam0/cam1 paired by
    timestamp and rectified to a row-aligned pair (the reference consumes
    pre-rectified stereo built from the same calibration: ORB-SLAM3
    EuRoC.yaml LEFT/RIGHT R,P). Exposes ``K_new`` and ``baseline`` so the
    caller builds the SystemConfig from the RECTIFIED geometry. Optional
    per-frame IMU batches as in EurocSequence."""

    def __init__(self, root: str, imu: bool = False,
                 max_frames: Optional[int] = None):
        from multi_orbslam3_tpu_torch.dataio import rectify
        mav = os.path.join(root, "mav0")
        K0, D0, T_B_c0, (w, h) = read_camera_yaml(
            os.path.join(mav, "cam0", "sensor.yaml"))
        K1, D1, T_B_c1, _ = read_camera_yaml(
            os.path.join(mav, "cam1", "sensor.yaml"))
        T_10 = np.linalg.inv(T_B_c1) @ T_B_c0       # cam1-from-cam0
        self.maps = rectify.rectify_pair(K0, D0, K1, D1, T_10, w, h)
        self.K_new = self.maps.K_new
        self.baseline = self.maps.baseline
        self.width, self.height = w, h
        # rectified-left-from-body: T_rect_B = R0 o (cam0-from-body)
        T_rect_c0 = np.eye(4)
        T_rect_c0[:3, :3] = self.maps.R0
        self.T_rect_body = T_rect_c0 @ np.linalg.inv(T_B_c0)

        self._left = EurocSequence(root, cam="cam0", imu=imu,
                                   max_frames=max_frames)
        right_frames = {}
        cam1_dir = os.path.join(mav, "cam1")
        with open(os.path.join(cam1_dir, "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                right_frames[int(row[0])] = row[1].strip()
        self._right_dir = os.path.join(cam1_dir, "data")
        self._right = right_frames

    def __len__(self) -> int:
        return len(self._left)

    def __iter__(self) -> Iterator:
        from multi_orbslam3_tpu_torch.dataio import rectify
        for key, item in zip(self._left.frames_ns, self._left):
            t = item[0]
            name_r = self._right.get(key)
            if name_r is None:     # unsynchronized frame: skip
                continue
            left = rectify.remap(item[1], self.maps.map0)
            right = rectify.remap(
                _read_png_gray(os.path.join(self._right_dir, name_r)),
                self.maps.map1)
            yield (t, left, right) + tuple(item[2:])
