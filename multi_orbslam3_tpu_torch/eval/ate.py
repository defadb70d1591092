"""Absolute trajectory error with Umeyama alignment (the port's own copy of
multi_orbslam3_tpu/eval/ate.py; numpy only).

The reference repo evaluates externally (SURVEY.md §4: trajectories saved
to CSV, compared with ORB-SLAM3's evaluation scripts). We build the
evaluation in: Sim3 Umeyama alignment (monocular trajectories have free
scale) + RMSE over aligned positions. Pure numpy — this runs on saved
trajectories, not in the hot path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray,
                  with_scale: bool = True) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity aligning src -> dst: returns (s, R, t) with
    dst ~ s R src + t. src/dst: (N, 3)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / src.shape[0]
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12)) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray,
             with_scale: bool = True) -> float:
    """RMSE of aligned positions; est/gt: (N, 3) camera centers in matching
    order (caller associates by timestamp)."""
    s, R, t = umeyama_align(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = aligned - gt_pos
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def camera_centers(T_cw: np.ndarray) -> np.ndarray:
    """(N, 4, 4) camera-from-world poses -> (N, 3) camera centers."""
    R = T_cw[:, :3, :3]
    t = T_cw[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)
