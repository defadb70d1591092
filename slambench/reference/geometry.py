"""Plain geometry for the reference: SO(3), SE(3), the pinhole camera and
the Huber weight. A frozen copy of the port's plain versions
(geometry/so3.py, se3.py, camera.py, opt/robust.py as of this benchmark's
first commit), so that a later change to the port cannot move the
yardstick. Imports nothing of the port."""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8
_SMALL = 1e-4


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < _SMALL
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jr(w): d exp(w + dw) = exp(w) exp(Jr dw). (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < _SMALL
    W = hat(w)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    return _eye3_like(W) - b[..., None, None] * W + c[..., None, None] * (W @ W)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) (two Newton steps of the
    polar decomposition, as the JAX package does)."""
    for _ in range(2):
        R = 1.5 * R - 0.5 * (R @ R.transpose(-1, -2)) @ R
    return R



def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # the [0, 0, 0, 1] row is cut from an identity made on the device: a
    # host constant (or a scalar assignment) would copy and stall the stream
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", rotation(T), p) + translation(T)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) tangent (omega, v) -> (..., 4, 4)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    Jl = right_jacobian(-w)
    return make(so3_exp(w), torch.einsum("...ij,...j->...i", Jl, v))


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction used by all optimizers: exp(xi) * T."""
    return compose(se3_exp(xi), T)


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthogonalize the rotation block (float32 drift control)."""
    return make(normalize_rotation(rotation(T)), translation(T))


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


CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside, delta/|e| outside."""
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
