"""Synthetic textured-point-world sequence generator (the port's own copy
of multi_orbslam3_tpu/dataio/synthetic.py; numpy only, the same sequences
from the same seeds).

Stands in for EuRoC rosbags (no dataset ships with this machine): a random
3D landmark field where each landmark carries a fixed random texture patch;
frames are rendered by splatting patches at projected positions. This gives
FAST corners at stable world points with distinctive BRIEF descriptors, so
the full tracking/mapping/loop pipeline can run end-to-end with known
ground-truth trajectories for ATE evaluation.

Also generates synthetic IMU measurements consistent with the trajectory
(for the inertial pipeline) and supports multi-agent trajectories through a
shared world (for collaborative merge tests).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

PATCH = 9  # landmark texture patch size (odd)


@dataclasses.dataclass
class SyntheticSequence:
    images: np.ndarray      # (F, H, W) float32 in [0, 255]
    T_cw: np.ndarray        # (F, 4, 4) ground-truth camera-from-world poses
    timestamps: np.ndarray  # (F,)
    points: np.ndarray      # (P, 3) world landmarks
    # IMU (present when imu=True): samples between frame i-1 and i
    imu_acc: Optional[np.ndarray] = None   # (F, S, 3) body-frame accel
    imu_gyro: Optional[np.ndarray] = None  # (F, S, 3) body-frame gyro
    imu_t: Optional[np.ndarray] = None     # (F, S)
    images_right: Optional[np.ndarray] = None  # (F, H, W) stereo right
    depths: Optional[np.ndarray] = None        # (F, H, W) RGBD depth maps


def _look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-from-world pose with +z forward (pinhole convention)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=1)  # columns: camera axes in world
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ eye
    return T


def circular_pose_at(i: float, radius: float = 4.0, arc_rate: float = 0.04,
                     height: float = 0.0, phase: float = 0.0,
                     center_dist: float = 8.0) -> np.ndarray:
    a = phase + arc_rate * i
    eye = np.array([radius * np.sin(a), height + 0.2 * np.sin(3 * a),
                    radius * np.cos(a) - center_dist])
    target = np.array([0.0, 0.0, center_dist * 0.5])
    return _look_at(eye, target, np.array([0.0, -1.0, 0.0]))


def circular_trajectory(n_frames: int, radius: float = 4.0,
                        arc: float = 1.5 * np.pi, height: float = 0.0,
                        phase: float = 0.0,
                        center_dist: float = 8.0) -> np.ndarray:
    """Camera orbits looking at the landmark field center; returns (F, 4, 4)
    T_cw poses. `phase` offsets the start angle (per-agent trajectories)."""
    rate = arc / max(1, n_frames - 1)
    return np.stack([circular_pose_at(i, radius, rate, height, phase,
                                      center_dist) for i in range(n_frames)])


def forward_pose_at(i: float, speed: float = 0.08, lateral: float = 0.4,
                    phase: float = 0.0, sway_freq: float = 0.08) -> np.ndarray:
    """Analytic smooth pose at (possibly fractional) frame index i — the
    closed form lets IMU synthesis sample at sensor rate. Raising
    `lateral`/`sway_freq` adds the acceleration excitation that makes
    visual-inertial scale observable (accel ~ lateral * (20*sway_freq)^2)."""
    eye = np.array([lateral * np.sin(sway_freq * i + phase),
                    0.15 * np.sin(0.05 * i + phase), speed * i - 6.0])
    target = eye + np.array([0.15 * np.sin(0.03 * i), 0.0, 4.0])
    return _look_at(eye, target, np.array([0.0, -1.0, 0.0]))


def forward_trajectory(n_frames: int, speed: float = 0.08,
                       lateral: float = 0.4, phase: float = 0.0,
                       sway_freq: float = 0.08) -> np.ndarray:
    """Gentle forward motion with lateral sway — the easy tracking case."""
    return np.stack([forward_pose_at(i, speed, lateral, phase, sway_freq)
                     for i in range(n_frames)])


def make_world(n_points: int, seed: int,
               extent: float = 6.0, depth_center: float = 4.0,
               depth_spread: float = 3.0) -> tuple[np.ndarray, np.ndarray]:
    """Landmarks in a slab in front of the origin + per-landmark texture."""
    rng = np.random.RandomState(seed)
    pts = np.stack([
        rng.uniform(-extent, extent, n_points),
        rng.uniform(-extent * 0.6, extent * 0.6, n_points),
        depth_center + rng.uniform(-depth_spread, depth_spread, n_points),
    ], axis=1)
    patches = rng.uniform(40.0, 255.0, (n_points, PATCH, PATCH)).astype(np.float32)
    # carve a strong corner structure into each patch so FAST fires reliably
    patches[:, : PATCH // 2, : PATCH // 2] *= 0.15
    return pts, patches


def render_frame(points: np.ndarray, patches: np.ndarray, T_cw: np.ndarray,
                 K: np.ndarray, width: int, height: int,
                 background: float = 12.0, noise_std: float = 2.0,
                 rng: Optional[np.random.RandomState] = None,
                 with_depth: bool = False, kb: Optional[tuple] = None):
    """Splat landmark patches at projected positions. Nearest landmarks are
    drawn last (painter's algorithm) so occlusion is roughly consistent.
    With with_depth=True also returns a per-pixel depth map (0 = no data).
    kb: Kannala-Brandt k1..k4 — render through the equidistant fisheye
    model instead of the pinhole (TUM-VI-style sequences)."""
    img = np.full((height, width), background, np.float32)
    dep = np.zeros((height, width), np.float32) if with_depth else None
    pc = points @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    vis = z > 0.3
    if kb is not None:
        r = np.sqrt(pc[:, 0] ** 2 + pc[:, 1] ** 2) + 1e-9
        theta = np.arctan2(r, z)
        t2 = theta * theta
        theta_d = theta * (1.0 + kb[0] * t2 + kb[1] * t2 ** 2
                           + kb[2] * t2 ** 3 + kb[3] * t2 ** 4)
        s = theta_d / r
        u = K[0, 0] * s * pc[:, 0] + K[0, 2]
        v = K[1, 1] * s * pc[:, 1] + K[1, 2]
    else:
        u = K[0, 0] * pc[:, 0] / np.maximum(z, 1e-6) + K[0, 2]
        v = K[1, 1] * pc[:, 1] / np.maximum(z, 1e-6) + K[1, 2]
    half = PATCH // 2
    vis &= (u > half + 1) & (u < width - half - 2) & \
           (v > half + 1) & (v < height - half - 2)
    order = np.argsort(-z)  # far to near
    for i in order:
        if not vis[i]:
            continue
        ui, vi = int(round(u[i])), int(round(v[i]))
        img[vi - half: vi + half + 1, ui - half: ui + half + 1] = patches[i]
        if with_depth:
            dep[vi - half: vi + half + 1, ui - half: ui + half + 1] = z[i]
    if noise_std > 0:
        rng = rng or np.random.RandomState(0)
        img = img + rng.randn(height, width).astype(np.float32) * noise_std
    img = np.clip(img, 0.0, 255.0)
    return (img, dep) if with_depth else img


def _intrinsics(cam_cfg) -> np.ndarray:
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy
    return K


def make_sequence(config, n_frames: int = 60, n_points: int = 600,
                  seed: int = 0, trajectory: str = "forward",
                  phase: float = 0.0, imu: bool = False,
                  fps: float = 20.0, lateral: float = 0.4,
                  sway_freq: float = 0.08,
                  arc: float = 1.5 * np.pi) -> SyntheticSequence:
    cam = config.camera
    K = _intrinsics(cam)
    points, patches = make_world(n_points, seed)
    if trajectory == "forward":
        T_cw = forward_trajectory(n_frames, phase=phase, lateral=lateral,
                                  sway_freq=sway_freq)
    elif trajectory == "circle":
        # arc > 2*pi produces self-overlap (loop-closure drills)
        T_cw = circular_trajectory(n_frames, phase=phase, arc=arc)
    else:
        raise ValueError(trajectory)
    rng = np.random.RandomState(seed + 1)
    kb = tuple(cam.kb) if getattr(cam, "model", "pinhole") == "kb8" else None
    images, depths = [], []
    for i in range(n_frames):
        img, dep = render_frame(points, patches, T_cw[i], K, cam.width,
                                cam.height, rng=rng, with_depth=True, kb=kb)
        images.append(img)
        depths.append(dep)
    images = np.stack(images)
    depths = np.stack(depths)
    images_right = None
    if cam.baseline > 0:
        # right camera: shifted by -baseline along the camera x axis
        T_shift = np.eye(4, dtype=np.float64)
        T_shift[0, 3] = -cam.baseline
        images_right = np.stack([
            render_frame(points, patches, T_shift @ T_cw[i], K, cam.width,
                         cam.height, rng=rng)
            for i in range(n_frames)])
    ts = np.arange(n_frames) / fps
    seq = SyntheticSequence(images=images, T_cw=T_cw.astype(np.float32),
                            timestamps=ts, points=points.astype(np.float32),
                            images_right=images_right, depths=depths)
    if imu:
        if trajectory == "forward":
            pose_at = lambda i: forward_pose_at(  # noqa: E731
                i, phase=phase, lateral=lateral, sway_freq=sway_freq)
        else:
            arc_rate = 1.5 * np.pi / max(1, n_frames - 1)
            pose_at = lambda i: circular_pose_at(  # noqa: E731
                i, arc_rate=arc_rate, phase=phase)
        seq = _add_imu(seq, config, fps, pose_at)
    return seq


def _add_imu(seq: SyntheticSequence, config, fps: float,
             pose_at) -> SyntheticSequence:
    """Generate body-frame gyro/accel by sampling the ANALYTIC trajectory
    at sensor rate (central differences at IMU dt — O(dt^2) accurate, so
    preintegration residuals are tiny). The body frame is related to the
    camera by config.imu.T_bc (reference include/ImuTypes.h:71 Tbc):
    T_wb(t) = (T_bc @ T_cw(t))^-1."""
    imu_cfg = config.imu
    S = int(round(imu_cfg.rate_hz / fps))
    F = seq.T_cw.shape[0]
    g_w = np.array([0.0, 0.0, -imu_cfg.gravity])
    dt = 1.0 / imu_cfg.rate_hz
    frames_per_s = fps
    T_bc = np.asarray(imu_cfg.T_bc, np.float64).reshape(4, 4)
    acc_list = np.zeros((F, S, 3), np.float32)
    gyr_list = np.zeros((F, S, 3), np.float32)
    t_list = np.zeros((F, S), np.float32)

    def T_wb_at(t_abs: float) -> np.ndarray:
        return np.linalg.inv(T_bc @ pose_at(t_abs * frames_per_s))

    for i in range(1, F):
        t0 = seq.timestamps[i - 1]
        for s in range(S):
            t = t0 + (s + 0.5) * dt      # sample mid-interval
            Tm = T_wb_at(t - dt)
            Tc = T_wb_at(t)
            Tp = T_wb_at(t + dt)
            R = Tc[:3, :3]
            # gyro: average of the two one-step rotations
            dR = Tm[:3, :3].T @ Tp[:3, :3]
            cos_t = np.clip((np.trace(dR) - 1) / 2, -1, 1)
            th = np.arccos(cos_t)
            if th < 1e-10:
                w = np.zeros(3)
            else:
                w = th / (2 * np.sin(th)) * np.array(
                    [dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                     dR[1, 0] - dR[0, 1]])
            omega_b = w / (2 * dt)
            a_w = (Tp[:3, 3] - 2 * Tc[:3, 3] + Tm[:3, 3]) / (dt * dt)
            acc_list[i, s] = R.T @ (a_w - g_w)
            gyr_list[i, s] = omega_b
            t_list[i, s] = t0 + (s + 1) * dt
    return dataclasses.replace(seq, imu_acc=acc_list, imu_gyro=gyr_list,
                               imu_t=t_list)
