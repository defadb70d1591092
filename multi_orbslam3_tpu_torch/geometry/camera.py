"""Camera models: pinhole (+ radtan distortion) and Kannala-Brandt fisheye
(counterpart of multi_orbslam3_tpu/geometry/camera.py). Batched over
leading axes; PinholeK fields are tensors (scalars or per-row)."""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


class PinholeK(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


def intrinsics_from_config(cam_cfg, device=None) -> PinholeK:
    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)
    return PinholeK(f32(cam_cfg.fx), f32(cam_cfg.fy), f32(cam_cfg.cx),
                    f32(cam_cfg.cy))


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)


def project(K: PinholeK, p_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels (no distortion:
    keypoints are undistorted once at extraction)."""
    inv_z = 1.0 / _safe_z(p_cam[..., 2])
    u = K.fx * p_cam[..., 0] * inv_z + K.cx
    v = K.fy * p_cam[..., 1] * inv_z + K.cy
    return torch.stack([u, v], dim=-1)


def project_jacobian(K: PinholeK, p_cam: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(p_cam): (..., 2, 3)."""
    x, y = p_cam[..., 0], p_cam[..., 1]
    inv_z = 1.0 / _safe_z(p_cam[..., 2])
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row_u = torch.stack([K.fx * inv_z, zero, -K.fx * x * inv_z2], dim=-1)
    row_v = torch.stack([zero, K.fy * inv_z, -K.fy * y * inv_z2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def unproject(K: PinholeK, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels -> (..., 3) unit-depth bearing (x, y, 1)."""
    x = (uv[..., 0] - K.cx) / K.fx
    y = (uv[..., 1] - K.cy) / K.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def in_image(uv: torch.Tensor, width: int, height: int,
             margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= margin) & (uv[..., 0] < width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < height - margin))


def radtan_distort(norm_xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """(..., 2) normalized coords -> distorted; dist = (k1, k2, p1, p2, k3)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = norm_xy[..., 0], norm_xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort(norm_xy: torch.Tensor, dist: torch.Tensor,
                     iters: int = 5) -> torch.Tensor:
    """Fixed-point inverse of radtan_distort."""
    x = norm_xy
    for _ in range(iters):
        x = norm_xy - (radtan_distort(x, dist) - x)
    return x


def undistort_pixels(K: PinholeK, uv: torch.Tensor,
                     dist: torch.Tensor) -> torch.Tensor:
    norm = torch.stack([(uv[..., 0] - K.cx) / K.fx,
                        (uv[..., 1] - K.cy) / K.fy], dim=-1)
    und = radtan_undistort(norm, dist)
    return torch.stack([und[..., 0] * K.fx + K.cx,
                        und[..., 1] * K.fy + K.cy], dim=-1)


def _kb_poly(kb: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    return (1.0 + kb[..., 0] * t2 + kb[..., 1] * t2 ** 2
            + kb[..., 2] * t2 ** 3 + kb[..., 3] * t2 ** 4)


def kb8_project(K: PinholeK, kb: torch.Tensor, p_cam: torch.Tensor) -> torch.Tensor:
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    r = torch.sqrt(x * x + y * y) + _EPS
    theta = torch.atan2(r, z)
    scale = theta * _kb_poly(kb, theta * theta) / r
    return torch.stack([K.fx * scale * x + K.cx, K.fy * scale * y + K.cy], dim=-1)


def kb8_unproject(K: PinholeK, kb: torch.Tensor, uv: torch.Tensor,
                  iters: int = 8) -> torch.Tensor:
    """Newton inversion of the theta polynomial -> bearing (x, y, 1)."""
    mx = (uv[..., 0] - K.cx) / K.fx
    my = (uv[..., 1] - K.cy) / K.fy
    theta_d = torch.sqrt(mx * mx + my * my) + _EPS
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * _kb_poly(kb, t2) - theta_d
        df = (1.0 + 3.0 * kb[..., 0] * t2 + 5.0 * kb[..., 1] * t2 ** 2
              + 7.0 * kb[..., 2] * t2 ** 3 + 9.0 * kb[..., 3] * t2 ** 4)
        theta = theta - f / (df + _EPS)
    scale = torch.tan(theta) / theta_d
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jacobian(K: PinholeK, kb: torch.Tensor,
                         p_cam: torch.Tensor) -> torch.Tensor:
    """Analytic d(uv)/d(p_cam) of kb8_project: (..., 2, 3)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2) + _EPS
    theta = torch.atan2(r, z)
    t2 = theta * theta
    poly = _kb_poly(kb, t2)
    dpoly = (3.0 * kb[..., 0] * t2 + 5.0 * kb[..., 1] * t2 ** 2
             + 7.0 * kb[..., 2] * t2 ** 3 + 9.0 * kb[..., 3] * t2 ** 4 + 1.0)
    theta_d = theta * poly
    norm2 = r2 + z * z
    dth_dx = x * z / (norm2 * r)
    dth_dy = y * z / (norm2 * r)
    dth_dz = -r / norm2
    s = theta_d / r
    ds_dx = (dpoly * dth_dx * r - theta_d * x / r) / r2
    ds_dy = (dpoly * dth_dy * r - theta_d * y / r) / r2
    ds_dz = dpoly * dth_dz / r
    du = torch.stack([K.fx * (s + x * ds_dx), K.fx * x * ds_dy,
                      K.fx * x * ds_dz], dim=-1)
    dv = torch.stack([K.fy * y * ds_dx, K.fy * (s + y * ds_dy),
                      K.fy * y * ds_dz], dim=-1)
    return torch.stack([du, dv], dim=-2)
