"""Stereo rectification (Fusiello/Bouguet construction).

The reference consumes pre-rectified stereo: its EuRoC stereo config
carries LEFT/RIGHT rectification rotations R and projections P computed
offline (ORB-SLAM3's EuRoC.yaml convention; the stereo matcher in
Frame.cc:785-965 assumes row-aligned epipolar lines). This module builds
those maps from raw calibration so the TPU pipeline can ingest
unrectified EuRoC cam0/cam1 directly:

- ``rectify_pair(K0, D0, K1, D1, T_10)`` -> RectifyMaps with the new
  common intrinsics K_new, the rectifying rotations, the rectified
  baseline, and precomputed inverse-sample grids;
- ``remap(img, map_xy)`` — bilinear resampling (pure numpy; host-side
  preprocessing, one per frame before features are extracted on device).

Construction: the rectifying rotation takes the left camera's x-axis to
the baseline direction (so the right camera lies exactly along +x of the
rectified left frame), the y-axis to the mean optical-axis cross product
— both cameras rotate to a COMMON orientation, after which a pixel's row
in the left image equals its row in the right image (the property the
stereo matcher needs).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class RectifyMaps:
    K_new: np.ndarray        # (3,3) shared rectified intrinsics
    R0: np.ndarray           # (3,3) rectifying rotation, left
    R1: np.ndarray           # (3,3) rectifying rotation, right
    baseline: float          # rectified baseline (m)
    map0: np.ndarray         # (H,W,2) sample coords into raw left
    map1: np.ndarray         # (H,W,2) sample coords into raw right


def _radtan_distort(x: np.ndarray, y: np.ndarray,
                    D: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Apply radial-tangential distortion to normalized coords."""
    k1, k2, p1, p2, k3 = D
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _build_map(K_raw: np.ndarray, D: np.ndarray, R_rect: np.ndarray,
               K_new: np.ndarray, width: int, height: int) -> np.ndarray:
    """Inverse map: for each rectified pixel, the raw-image sample point.
    rectified pixel -> K_new^-1 -> rotate by R_rect^T into the raw camera
    -> distort -> K_raw."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    rays = np.stack([x, y, np.ones_like(x)], -1)          # (H,W,3)
    rays_raw = rays @ R_rect                               # R_rect^T applied
    xn = rays_raw[..., 0] / rays_raw[..., 2]
    yn = rays_raw[..., 1] / rays_raw[..., 2]
    xd, yd = _radtan_distort(xn, yn, np.asarray(D, np.float64))
    mx = K_raw[0, 0] * xd + K_raw[0, 2]
    my = K_raw[1, 1] * yd + K_raw[1, 2]
    return np.stack([mx, my], -1).astype(np.float32)


def rectify_pair(K0: np.ndarray, D0, K1: np.ndarray, D1,
                 T_10: np.ndarray, width: int, height: int,
                 scale_f: float = 1.0) -> RectifyMaps:
    """T_10: cam1-from-cam0 (right-from-left) extrinsics. Returns maps so
    that remap(left, map0) / remap(right, map1) form a row-aligned pair
    with shared intrinsics K_new and pure +x baseline."""
    T_10 = np.asarray(T_10, np.float64)
    R_10, t_10 = T_10[:3, :3], T_10[:3, 3]
    # camera-1 center in camera-0 coordinates = -R^T t
    c1_in_0 = -R_10.T @ t_10
    b = np.linalg.norm(c1_in_0)
    # rectified x-axis: along the baseline
    e1 = c1_in_0 / b
    # rectified y-axis: orthogonal to x and to the mean optical axis
    z_mean = np.array([0.0, 0.0, 1.0]) + R_10.T @ np.array([0.0, 0.0, 1.0])
    e2 = np.cross(z_mean, e1)
    e2 /= np.linalg.norm(e2)
    # right-handed: z = x × y ... with y chosen so z points forward
    e3 = np.cross(e1, e2)
    if e3[2] < 0:
        e2, e3 = -e2, -e3
    R_common = np.stack([e1, e2, e3])      # rows = new axes in cam0 coords
    R0 = R_common                          # cam0 -> rect
    R1 = R_common @ R_10.T                 # cam1 -> rect
    f = scale_f * (K0[0, 0] + K0[1, 1] + K1[0, 0] + K1[1, 1]) / 4.0
    K_new = np.array([[f, 0.0, width / 2.0],
                      [0.0, f, height / 2.0],
                      [0.0, 0.0, 1.0]])
    return RectifyMaps(
        K_new=K_new, R0=R0, R1=R1, baseline=float(b),
        map0=_build_map(np.asarray(K0, np.float64), D0, R0, K_new,
                        width, height),
        map1=_build_map(np.asarray(K1, np.float64), D1, R1, K_new,
                        width, height))


def remap(img: np.ndarray, map_xy: np.ndarray) -> np.ndarray:
    """Bilinear resample img (H,W) at map_xy (H',W',2); out-of-bounds -> 0."""
    H, W = img.shape
    mx = map_xy[..., 0]
    my = map_xy[..., 1]
    x0 = np.floor(mx).astype(np.int64)
    y0 = np.floor(my).astype(np.int64)
    fx = (mx - x0).astype(img.dtype if img.dtype.kind == "f" else np.float32)
    fy = (my - y0).astype(fx.dtype)
    ok = (x0 >= 0) & (x0 < W - 1) & (y0 >= 0) & (y0 < H - 1)
    x0c = np.clip(x0, 0, W - 2)
    y0c = np.clip(y0, 0, H - 2)
    im = img.astype(fx.dtype)
    v = (im[y0c, x0c] * (1 - fx) * (1 - fy)
         + im[y0c, x0c + 1] * fx * (1 - fy)
         + im[y0c + 1, x0c] * (1 - fx) * fy
         + im[y0c + 1, x0c + 1] * fx * fy)
    return np.where(ok, v, 0.0).astype(np.float32)
