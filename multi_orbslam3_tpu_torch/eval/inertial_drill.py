"""The full-arena inertial GBA drill (the arena of the JAX package's
tests/test_full_inertial_gba.py, built from the port's own modules).

A single-agent inertial arena of F keyframes on a circular arc whose poses
and landmarks carry a self-consistent accumulated yaw drift (0.35 degrees
a keyframe about the trajectory's centroid; landmarks ride their first
observing keyframe), with observations rendered from the TRUE geometry
(+0.5 px noise) and preintegration windows built exactly from the true
motion (dR = R_i^T R_j, dV = R_i^T (v_j - v_i - g dt), dP = R_i^T (p_j -
p_i - v_i dt - 0.5 g dt^2)). Vision alone sees a consistent drifted map;
the IMU chain, metric and gravity-aligned, observes the bend. The joint
solve (CollabServer.run_full_inertial_ba) must recover most of the drift,
the windowed pass (run_inertial_refinement) must not.
"""

from __future__ import annotations

import numpy as np
import torch

from multi_orbslam3_tpu_torch import config as cfg
from multi_orbslam3_tpu_torch.collab.server import CollabServer
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
from multi_orbslam3_tpu_torch.dataio import synthetic
from multi_orbslam3_tpu_torch.eval import ate
from multi_orbslam3_tpu_torch.imu import preintegration as pre


def drill_config() -> cfg.SystemConfig:
    """The drill's config: 320x240, 128 features, 64 keyframes."""
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        orb=cfg.ORBConfig(n_features=128, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                          max_obs_per_kf=128),
        local_mapping=cfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                             local_ba_points=1024))


def build_drifted_arena(c: cfg.SystemConfig, F: int = 56, n_pts: int = 800, seed: int = 11,
                        yaw_drift_per_kf: float = np.deg2rad(0.35), device=None):
    """(server, T_gt (F, 4, 4), seq): a CollabServer (device=None: the
    card) holding the drifted arena with true-motion preintegration rows."""
    rng = np.random.RandomState(seed)
    seq = synthetic.make_sequence(c, n_frames=F, n_points=n_pts, seed=seed,
                                  trajectory="circle", imu=True, arc=1.2 * np.pi)
    K = np.array([[c.camera.fx, 0, c.camera.cx], [0, c.camera.fy, c.camera.cy],
                  [0, 0, 1.0]])
    T_gt = np.asarray(seq.T_cw, np.float64)
    pts_w, _ = synthetic.make_world(n_pts, seed)
    pivot = ate.camera_centers(T_gt).mean(0)

    def warp(i):
        th = yaw_drift_per_kf * i
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                      [0, 0, 1.0]])
        W = np.eye(4)
        W[:3, :3] = R
        W[:3, 3] = pivot - R @ pivot
        return W

    T_drift = np.stack([T_gt[i] @ np.linalg.inv(warp(i)) for i in range(F)])
    N = c.orb.n_features
    kf_uv = np.zeros((F, N, 2), np.float32)
    kf_mp = np.full((F, N), -1, np.int32)
    feat_ok = np.zeros((F, N), bool)
    mp_ref = np.full(n_pts, -1, np.int32)
    # each landmark's reference keyframe is the first that sees it
    for i in range(F):
        pc = pts_w @ T_gt[i, :3, :3].T + T_gt[i, :3, 3]
        uv = pc @ K.T
        z = uv[:, 2]
        uv = uv[:, :2] / np.maximum(z[:, None], 1e-6)
        vis = (z > 0.2) & (uv[:, 0] >= 4) & (uv[:, 0] < c.camera.width - 4) \
            & (uv[:, 1] >= 4) & (uv[:, 1] < c.camera.height - 4)
        cand = np.nonzero(vis)[0]
        rng.shuffle(cand)
        cand = cand[:N]
        mp_ref[cand[mp_ref[cand] < 0]] = i
        kf_mp[i, :len(cand)] = cand
        feat_ok[i, :len(cand)] = True
    # drifted landmark positions: p' = T'_ref^-1 (T_ref p)
    ref_ok = mp_ref >= 0
    ref_safe = np.maximum(mp_ref, 0)
    x_cam = np.einsum("kij,kj->ki", T_gt[ref_safe][:, :3, :3], pts_w) \
        + T_gt[ref_safe][:, :3, 3]
    inv_d = np.linalg.inv(T_drift[ref_safe])
    p_drift = np.einsum("kij,kj->ki", inv_d[:, :3, :3], x_cam) + inv_d[:, :3, 3]
    p_drift = np.where(ref_ok[:, None], p_drift, 0.0)
    # observations from the true geometry
    for i in range(F):
        sel = kf_mp[i] >= 0
        j = kf_mp[i][sel]
        pc = pts_w[j] @ T_gt[i, :3, :3].T + T_gt[i, :3, 3]
        uv = pc @ K.T
        kf_uv[i][sel] = (uv[:, :2] / np.maximum(uv[:, 2:3], 1e-6)
                         + rng.normal(0.0, 0.5, (len(j), 2))).astype(np.float32)

    server = CollabServer(c, InProcessTransport(), n_agents=1, device=device)
    m, up = server.m, server._up
    ts = np.asarray(seq.timestamps, np.float64)
    ts = (ts - ts[0]).astype(np.float32)

    def put(arr, n, vals):      # the first n rows of arr replaced by vals
        return torch.cat([up(np.asarray(vals).astype(_np_dtype(arr))), arr[n:]])
    m = m._replace(
        kf_pose=put(m.kf_pose, F, T_drift), kf_valid=put(m.kf_valid, F, np.ones(F, bool)),
        kf_timestamp=put(m.kf_timestamp, F, ts), kf_agent=put(m.kf_agent, F, np.zeros(F)),
        kf_parent=put(m.kf_parent, F, np.arange(-1, F - 1)),
        kf_uv=put(m.kf_uv, F, kf_uv), kf_feat_valid=put(m.kf_feat_valid, F, feat_ok),
        kf_mp=put(m.kf_mp, F, kf_mp), mp_pos=put(m.mp_pos, n_pts, p_drift),
        mp_valid=put(m.mp_valid, n_pts, ref_ok), mp_ref_kf=put(m.mp_ref_kf, n_pts, mp_ref),
        mp_agent=put(m.mp_agent, n_pts, np.zeros(n_pts)),
        n_kf=up(np.asarray(F, np.int32)), n_mp=up(np.asarray(n_pts, np.int32)))
    server.m = m
    server.kf_map[:F] = 0
    server.mp_map[:n_pts] = 0
    server.kf_local[:F] = np.arange(F)
    book = server.agents[0]
    book.inertial = True
    book.map_id = 0
    book.last_kf_slot = F - 1
    book.kf_l2s = {i: i for i in range(F)}
    # true-motion windows with realistic covariances (T_bc = identity)
    centers = ate.camera_centers(T_gt)
    g_vec = np.array([0.0, 0.0, -float(c.imu.gravity)])
    ts64 = np.asarray(ts, np.float64)
    dt_f = np.diff(ts64)
    R_wb = np.linalg.inv(T_gt)[:, :3, :3]
    vel = np.gradient(centers, axis=0) / np.gradient(ts64)[:, None]
    cov = np.diag([1e-4] * 3 + [2.5e-3] * 3 + [1e-3] * 3)
    for i in range(1, F):
        dt = float(dt_f[i - 1])
        Ri = R_wb[i - 1]
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
        p = pre.empty_preintegrated()._replace(
            dR=f32(Ri.T @ R_wb[i]), dV=f32(Ri.T @ (vel[i] - vel[i - 1] - g_vec * dt)),
            dP=f32(Ri.T @ (centers[i] - centers[i - 1] - vel[i - 1] * dt
                           - 0.5 * g_vec * dt * dt)),
            dT=f32(dt), cov=f32(cov))
        server.kf_imu[i, :pre.FLAT_DIM] = pre.preint_to_flat(p)
        server.kf_imu[i, pre.FLAT_DIM:] = vel[i]
    server.kf_imu[0, pre.FLAT_DIM:] = vel[0]
    return server, T_gt, seq


def _np_dtype(t: torch.Tensor):
    return {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_,
            torch.int64: np.int64}[t.dtype]


def arena_ate(server: CollabServer, T_gt: np.ndarray) -> float:
    """Keyframe ATE of the arena's first len(T_gt) slots, without scale."""
    F = len(T_gt)
    est = ate.camera_centers(server.m.kf_pose[:F].cpu().numpy())
    return float(ate.ate_rmse(est, ate.camera_centers(T_gt), with_scale=False))
